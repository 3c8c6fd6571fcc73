"""Match-delta subscriptions — results leave the service incrementally too.

Copy of ``repro/stream/sinks.py``.

Every committed micro-batch produces one :class:`BatchEvent` per
registered pattern. Sinks subscribe to the service and receive events as
they commit; a sink that sets ``wants_matches`` makes the service
materialize the *decompressed* new/removed match rows for its patterns
(otherwise only count deltas and reports travel, keeping the hot path
compressed end to end — the same discipline as the paper's VCBC story).

Sinks are also the *trigger* of the lazy device→host contract: on the
device backend (:class:`~repro_torch.backend.TorchBackend`) the running
match sets live on the card (:class:`~repro_torch.sharded.MatchStore`),
and only a ``wants_matches`` sink (or an explicit
``backend.materialize(name)`` call) pulls a table to host — the pull is byte-accounted in ``BatchMetrics.host_bytes``.
Count-delta sinks ride entirely on the device count reduction: a
count-only batch moves scalars, never match state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BatchEvent", "Sink", "CountDeltaSink", "MatchDeltaSink", "CallbackSink"]


@dataclasses.dataclass(frozen=True)
class BatchEvent:
    """One (micro-batch, pattern) result delta."""

    batch_index: int
    lo: int                     # watermark range (lo, hi] of the batch
    hi: int
    pattern: str
    count_before: int
    count_after: int
    n_ops: int                  # journal ops in the window
    net_add: int                # netted inserts / deletes actually applied
    net_delete: int
    latency_s: float
    overflow: int = 0           # device-cap overflow (sharded backend)
    added: Optional[np.ndarray] = None    # [k, |V(p)|] decompressed new matches
    removed: Optional[np.ndarray] = None  # [k, |V(p)|] decompressed dead matches

    @property
    def count_delta(self) -> int:
        return self.count_after - self.count_before


class Sink:
    """Subscription base. Override :meth:`emit`; set ``wants_matches``
    to request decompressed added/removed rows on events."""

    wants_matches: bool = False

    def __init__(self, patterns: Optional[Sequence[str]] = None):
        self._patterns = set(patterns) if patterns is not None else None

    def accepts(self, pattern: str) -> bool:
        return self._patterns is None or pattern in self._patterns

    def emit(self, event: BatchEvent) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class CountDeltaSink(Sink):
    """Accumulates per-pattern count deltas; the cheapest subscription."""

    def __init__(self, patterns: Optional[Sequence[str]] = None):
        super().__init__(patterns)
        self.events: List[Tuple[str, int, int]] = []  # (pattern, hi, delta)
        self.totals: dict = {}

    def emit(self, event: BatchEvent) -> None:
        self.events.append((event.pattern, event.hi, event.count_delta))
        self.totals[event.pattern] = self.totals.get(event.pattern, 0) + event.count_delta


class MatchDeltaSink(Sink):
    """Collects the decompressed new/removed match rows per batch."""

    wants_matches = True

    def __init__(self, patterns: Optional[Sequence[str]] = None):
        super().__init__(patterns)
        self.added: List[Tuple[str, int, np.ndarray]] = []    # (pattern, hi, rows)
        self.removed: List[Tuple[str, int, np.ndarray]] = []

    def emit(self, event: BatchEvent) -> None:
        if event.added is not None and event.added.shape[0]:
            self.added.append((event.pattern, event.hi, event.added))
        if event.removed is not None and event.removed.shape[0]:
            self.removed.append((event.pattern, event.hi, event.removed))

    def added_rows(self, pattern: str) -> np.ndarray:
        rows = [r for p, _, r in self.added if p == pattern]
        return np.concatenate(rows, axis=0) if rows else np.empty((0, 0), np.int64)

    def removed_rows(self, pattern: str) -> np.ndarray:
        rows = [r for p, _, r in self.removed if p == pattern]
        return np.concatenate(rows, axis=0) if rows else np.empty((0, 0), np.int64)


class CallbackSink(Sink):
    """Adapts a plain callable; ``wants_matches`` is per-instance."""

    def __init__(self, fn: Callable[[BatchEvent], None],
                 patterns: Optional[Sequence[str]] = None,
                 wants_matches: bool = False):
        super().__init__(patterns)
        self._fn = fn
        self.wants_matches = bool(wants_matches)

    def emit(self, event: BatchEvent) -> None:
        self._fn(event)
