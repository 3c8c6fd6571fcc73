"""Step wrappers with a late-bound profiler hook.

The port's twin of ``ProfiledStep`` in ``repro/obs/jaxprof.py``: every
device step of :class:`~repro_torch.backend.TorchBackend` is wrapped in a
:class:`ProfiledStep` that looks its profiler up at call time (the service
attaches its observability after the backend is built). The profiler
itself (compile or capture time apart from steady-state time, CUDA events
on the card) is not ported yet: :class:`StepProfiler` is its type and calls
each step straight through. A step hands itself only to a profiler of that
type; any other object the hook returns (such as the JAX package's
``JaxProfiler``, which lowers a step with ``jax.jit``) is never called, and
the step runs directly.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional

__all__ = ["StepProfiler", "ProfiledStep"]


class StepProfiler:
    """The port's step profiler: ``enabled`` and the ``on_batch_start`` /
    ``on_batch_end`` hooks of the service's profiler contract. It records
    nothing yet (``steps`` stays empty) and runs every step as it is."""

    def __init__(self, registry=None, enabled: bool = True):
        self.registry = registry
        self.enabled = enabled
        self.steps: Dict[str, dict] = {}

    def _call(self, step: "ProfiledStep", *args):
        return step.fn(*args)

    def on_batch_start(self, batch_index: int) -> None:
        pass

    def on_batch_end(self, batch_index: int) -> None:
        pass

    def snapshot(self) -> dict:
        return {"steps": dict(sorted(self.steps.items())), "captured_dirs": []}

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)


class ProfiledStep:
    """Transparent callable wrapper around one device step. ``profiler_get``
    is a zero-argument closure resolving to the current profiler (or None)
    at call time; ``subs`` are a fused step's per-component cost shares."""

    __slots__ = ("name", "fn", "_profiler_get", "subs")

    def __init__(self, name: str, fn: Callable,
                 profiler_get: Callable[[], Optional[object]],
                 subs: Optional[Dict[str, float]] = None):
        self.name = name
        self.fn = fn
        self._profiler_get = profiler_get
        self.subs = dict(subs) if subs else None

    def __call__(self, *args):
        prof = self._profiler_get()
        if isinstance(prof, StepProfiler) and prof.enabled:
            return prof._call(self, *args)
        return self.fn(*args)
