"""Step profiling for the port's streaming backend.

Twin of ``repro/obs/jaxprof.py``. Every device step that
:class:`~repro_torch.backend.TorchBackend` drives (the storage update, the
fused maintain megastep, and each pattern's list / init-store / unit-refresh
step) is wrapped in a :class:`ProfiledStep`, which looks its profiler up at
call time (the service attaches its observability after the backend is
built) and hands itself to a :class:`StepProfiler`:

- eager PyTorch has no ahead-of-time lowering, so the split is the
  reference's pre-AOT heuristic: the **first** call of each wrapper is
  booked as its compile (the kernel build or module load, allocator growth
  and one execution), every later call as a steady execution, and
  :attr:`StepProfile.heuristic` is ``True`` on every record; a rebuilt
  wrapper under the same step name (a store resize, a restore, the
  candidate-cap fallback) warms up again into the same :class:`StepProfile`;
- a step whose arguments lie on a card is timed by a pair of CUDA events on
  the current stream around the call, read after the end event
  synchronizes, which waits for the step as ``block_until_ready`` does; a
  step on the CPU by ``time.perf_counter`` after the call returns;
- each warm-up records the bytes of the step's arguments and outputs and the
  output bytes that share storage with an argument (``memory``; every
  storage counted once); there is no compiler cost model, so ``cost`` stays
  ``None``, and no temporary-buffer figure;
- a ``torch.profiler`` window can be armed over chosen batches
  (:meth:`StepProfiler.arm_capture`): the service calls
  :meth:`~StepProfiler.on_batch_start` / :meth:`~StepProfiler.on_batch_end`
  around every micro-batch, and the window writes a Chrome trace;
- device→host transfer bytes flow through the backend's ``_pull`` into the
  ``host_transfer_bytes_total`` counter, profiler on or off.

The registry counters are the reference's without its ``jax_`` prefix,
labelled by ``step``: ``step_compile_seconds_total``,
``step_compiles_total``, ``step_execute_seconds_total``,
``step_execute_calls_total``, and the gauges ``step_output_size_in_bytes``
and ``step_alias_size_in_bytes``. A step hands itself only to a profiler of
this type; any other object the hook returns (such as the JAX package's
``JaxProfiler``, which lowers a step with ``jax.jit``) is never called, and
the step runs directly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["StepProfile", "ProfiledStep", "StepProfiler", "tensor_bytes"]

_MEM_GAUGES = ("output_size_in_bytes", "alias_size_in_bytes")


@dataclasses.dataclass
class StepProfile:
    """Accumulated compile/execute accounting for one named step (the
    reference's fields, so both packages export one schema).

    One record per step *name*: rebuilt wrappers of the same logical step
    (cap fallback, store resize) increment :attr:`compiles` and fold their
    warm-up time into :attr:`compile_seconds`.
    """

    name: str
    compiles: int = 0
    compile_seconds: float = 0.0
    calls: int = 0
    execute_seconds: float = 0.0
    last_execute_s: float = 0.0
    #: no compiler cost model in eager PyTorch: always None
    cost: Optional[dict] = None
    #: the latest warm-up's argument / output / alias bytes
    memory: Optional[dict] = None
    #: the first call of a wrapper is booked as its compile (always True)
    heuristic: bool = False
    #: sub-attribution shares for fused steps: {component: share} summing
    #: to 1.0 (the megastep's per-pattern Eq. 11 cost shares); None for
    #: unfused steps.
    subs: Optional[Dict[str, float]] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _storages(tree, out: Dict[tuple, int]) -> Dict[tuple, int]:
    """Every tensor storage reachable from ``tree`` (tensors, tuples, lists,
    dicts, dataclasses; anything else is skipped) as {key: bytes}."""
    if isinstance(tree, torch.Tensor):
        st = tree.untyped_storage()
        out[(str(tree.device), st.data_ptr())] = st.nbytes()
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _storages(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _storages(x, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _storages(getattr(tree, f.name), out)
    return out


def tensor_bytes(tree) -> int:
    """Bytes of the tensor storages reachable from ``tree``, each storage
    counted once: how ``memory``'s sizes are measured."""
    return sum(_storages(tree, {}).values())


def _on_card(storages: Dict[tuple, int]) -> bool:
    return any(dev.startswith("cuda") for dev, _ in storages)


class ProfiledStep:
    """Transparent callable wrapper around one device step.

    ``profiler_get`` is a zero-argument closure resolving to the current
    profiler (or None) at call time; ``subs`` are a fused step's
    per-component cost shares. The warm-up flag lives on the wrapper, so a
    rebuilt wrapper under the same name warms up again.
    """

    __slots__ = ("name", "fn", "_profiler_get", "_warm", "_cuda", "subs")

    def __init__(self, name: str, fn: Callable,
                 profiler_get: Callable[[], Optional[object]],
                 subs: Optional[Dict[str, float]] = None):
        self.name = name
        self.fn = fn
        self._profiler_get = profiler_get
        self._warm = False      # first profiled call already accounted
        self._cuda = False      # arguments on a card: time with CUDA events
        self.subs = dict(subs) if subs else None

    def __call__(self, *args):
        prof = self._profiler_get()
        if isinstance(prof, StepProfiler) and prof.enabled:
            return prof._call(self, *args)
        return self.fn(*args)


class StepProfiler:
    """Per-service step profiler: step records + optional trace window.

    ``enabled=False`` turns every :class:`ProfiledStep` into a plain
    passthrough (zero accounting, no synchronize).
    """

    def __init__(self, registry=None, enabled: bool = True):
        self.registry = registry
        self.enabled = enabled
        self.steps: Dict[str, StepProfile] = {}
        # torch.profiler window state
        self._capture_logdir: Optional[str] = None
        self._capture_start = 0
        self._capture_len = 0
        self._capture = None    # the running torch.profiler.profile
        self.captured_dirs: List[str] = []
        #: windows that were armed and ended without a trace, with the reason
        self.capture_failures: List[dict] = []

    # ----------------------------------------------------------- step timing
    def _record(self, name: str, kind: str, seconds: float) -> None:
        if self.registry is None:
            return
        self.registry.counter(
            f"step_{kind}_seconds_total", f"total {kind} seconds per device step",
            labels=("step",)).labels(step=name).inc(seconds)
        self.registry.counter(
            "step_compiles_total" if kind == "compile" else "step_execute_calls_total",
            f"{kind} count per device step",
            labels=("step",)).labels(step=name).inc()

    def _record_memory(self, name: str, memory: dict) -> None:
        if self.registry is None:
            return
        for f in _MEM_GAUGES:
            self.registry.gauge(
                f"step_{f}", f"{f} of the step's latest warm-up",
                labels=("step",)).labels(step=name).set(memory[f])

    @staticmethod
    def _timed(step: ProfiledStep, args):
        """``(outputs, seconds)`` of one call that has finished on its device."""
        if step._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step.fn(*args)
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        out = step.fn(*args)
        return out, time.perf_counter() - t0

    def _call(self, step: ProfiledStep, *args):
        rec = self.steps.get(step.name)
        if rec is None:
            rec = self.steps[step.name] = StepProfile(step.name)
        if step.subs is not None:
            rec.subs = dict(step.subs)
        if not step._warm:
            # the heuristic split: the first call pays the build, allocator
            # growth and one execution; all of it is booked as its compile
            step._warm = True
            rec.heuristic = True
            arg_st = _storages(args, {})
            step._cuda = _on_card(arg_st)
            out, dt = self._timed(step, args)
            out_st = _storages(out, {})
            rec.memory = {
                "argument_size_in_bytes": sum(arg_st.values()),
                "output_size_in_bytes": sum(out_st.values()),
                "alias_size_in_bytes": sum(b for k, b in out_st.items() if k in arg_st)}
            rec.compiles += 1
            rec.compile_seconds += dt
            self._record(step.name, "compile", dt)
            self._record_memory(step.name, rec.memory)
            return out
        out, dt = self._timed(step, args)
        rec.calls += 1
        rec.execute_seconds += dt
        rec.last_execute_s = dt
        self._record(step.name, "execute", dt)
        return out

    # ------------------------------------------------------- capture windows
    def arm_capture(self, logdir: str, start_batch: int = 0, n_batches: int = 1) -> None:
        """Capture a ``torch.profiler`` trace for batches
        ``[start_batch, start_batch + n_batches)`` of the next run."""
        self._capture_logdir = logdir
        self._capture_start = int(start_batch)
        self._capture_len = max(1, int(n_batches))

    def _fail_capture(self, error: BaseException) -> None:
        self.capture_failures.append({
            "logdir": self._capture_logdir, "start_batch": self._capture_start,
            "n_batches": self._capture_len, "error": f"{type(error).__name__}: {error}"})
        self._capture = None
        self._capture_logdir = None

    def on_batch_start(self, batch_index: int) -> None:
        if (self._capture_logdir is None or self._capture is not None
                or batch_index != self._capture_start):
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            # a second session would stop the running one and trace nothing
            if torch.autograd.profiler._is_profiler_enabled:
                raise RuntimeError("another torch.profiler session is running")
            os.makedirs(self._capture_logdir, exist_ok=True)
            cap = profile(activities=activities)
            cap.start()
        except (OSError, RuntimeError) as e:
            self._fail_capture(e)
            return
        self._capture = cap

    def on_batch_end(self, batch_index: int) -> None:
        if self._capture is None:
            return
        if batch_index < self._capture_start + self._capture_len - 1:
            return
        last = self._capture_start + self._capture_len - 1
        path = os.path.join(self._capture_logdir,
                            f"batches_{self._capture_start}-{last}.pt.trace.json")
        try:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._capture.stop()
            self._capture.export_chrome_trace(path)
            if not os.path.isfile(path):
                raise OSError(f"no trace at {path}")
        except (OSError, RuntimeError) as e:
            self._fail_capture(e)
            return
        self.captured_dirs.append(self._capture_logdir)
        self._capture = None
        self._capture_logdir = None

    # --------------------------------------------------------------- exports
    def snapshot(self) -> dict:
        """The step records and captured trace directories (the reference's
        keys), the failed capture windows, and a window still armed (not
        yet started, or running) under ``capture_pending``."""
        pending = None
        if self._capture_logdir is not None:
            pending = {"logdir": self._capture_logdir, "start_batch": self._capture_start,
                       "n_batches": self._capture_len, "running": self._capture is not None}
        return {
            "steps": {name: rec.as_dict() for name, rec in sorted(self.steps.items())},
            "captured_dirs": list(self.captured_dirs),
            "capture_failures": list(self.capture_failures),
            "capture_pending": pending,
        }

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
