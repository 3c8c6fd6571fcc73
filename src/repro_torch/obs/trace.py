"""Low-overhead hierarchical span tracer for the streaming service.

Host copy (pure Python) of ``repro/obs/trace.py``, whole. A *span* is a
named, timed region with attached counters and child spans; the service
opens one root span per micro-batch and nests the stage spans under it::

    batch                      (n_ops, watermark, cache/host counters)
    ├── shared_delta           (decode + Alg.4 candidates, once per batch)
    ├── storage_update         (Φ(d') edge apply; device diag on sharded)
    ├── maintain_mega          (the fused device step, every pattern)
    ├── maintain  ×P           (one per pattern: patch/store counters)
    │   └── materialize        (device→host pull, when matches wanted)
    └── sinks                  (delivery callbacks)

Disabled tracing is the default and costs one attribute read per
``span()`` call: the tracer hands back a process-wide no-op span, so
instrumented code needs no ``if tracer.enabled`` guards.

Exports: :meth:`Tracer.to_jsonl` (one JSON object per span, flat with
``span_id``/``parent_id`` links) and :meth:`Tracer.to_chrome_trace`
(Chrome trace-event JSON, for Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import json
import time
from typing import Dict, Iterator, List, Optional

__all__ = ["Span", "NULL_SPAN", "Tracer"]


class Span:
    """One timed region. Use via ``with tracer.span(name, **attrs):``.

    ``attrs`` are static annotations (pattern name, batch index);
    ``counters`` accumulate via :meth:`add` and are what the span-tree
    tests reconcile against registry deltas.
    """

    __slots__ = ("name", "attrs", "counters", "children",
                 "t0_ns", "dur_ns", "span_id", "parent_id")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, object]):
        self.name = name
        self.attrs = attrs
        self.counters: Dict[str, float] = {}
        self.children: List["Span"] = []
        self.t0_ns = 0
        self.dur_ns = 0
        self.span_id = span_id
        self.parent_id = parent_id

    # ------------------------------------------------------------ annotation
    def add(self, key: str, n: float = 1.0) -> None:
        """Accumulate a counter on this span."""
        self.counters[key] = self.counters.get(key, 0.0) + n

    def set(self, **attrs: object) -> None:
        self.attrs.update(attrs)

    # ----------------------------------------------------------- introspection
    @property
    def dur_s(self) -> float:
        return self.dur_ns / 1e9

    def child(self, name: str) -> Optional["Span"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def skeleton(self) -> tuple:
        """Nested name structure — what the shape tests compare."""
        return (self.name, tuple(c.skeleton() for c in self.children))

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, dur={self.dur_ns / 1e6:.3f}ms, "
                f"children={[c.name for c in self.children]})")


class _NullSpan:
    """No-op stand-in handed out while tracing is disabled.

    A single shared instance; every method is a cheap no-op so call
    sites never branch on ``tracer.enabled``.
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, key: str, n: float = 1.0) -> None:
        pass

    def set(self, **attrs: object) -> None:
        pass


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager binding a live span to the tracer's open stack."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._stack.append(self._span)
        self._span.t0_ns = time.perf_counter_ns()
        return self._span

    def __exit__(self, *exc) -> bool:
        sp = self._span
        sp.dur_ns = time.perf_counter_ns() - sp.t0_ns
        stack = self._tracer._stack
        # Pop to (and including) our span even if an exception skipped
        # inner __exit__s — the tree stays consistent under errors.
        while stack:
            top = stack.pop()
            if top is sp:
                break
        if stack:
            stack[-1].children.append(sp)
        else:
            self._tracer._finish_root(sp)
        return False


class Tracer:
    """Span factory + completed-root store.

    ``enabled=False`` (the default) short-circuits :meth:`span` to the
    shared :data:`NULL_SPAN`.  Completed root spans accumulate in
    :attr:`roots`, bounded by ``max_roots`` (oldest dropped first;
    drops counted in :attr:`dropped_roots`).
    """

    def __init__(self, enabled: bool = False, max_roots: int = 100_000):
        self.enabled = enabled
        self.max_roots = max_roots
        self.roots: List[Span] = []
        self.dropped_roots = 0
        self._stack: List[Span] = []
        self._next_id = 1
        # One wall-clock anchor so perf_counter spans map to epoch time
        # in exports (Chrome traces want a shared timeline).
        self._epoch_ns = time.time_ns()
        self._perf0_ns = time.perf_counter_ns()

    def span(self, name: str, **attrs: object):
        if not self.enabled:
            return NULL_SPAN
        parent_id = self._stack[-1].span_id if self._stack else None
        sp = Span(name, self._next_id, parent_id, attrs)
        self._next_id += 1
        return _SpanCtx(self, sp)

    def _finish_root(self, sp: Span) -> None:
        self.roots.append(sp)
        if len(self.roots) > self.max_roots:
            drop = len(self.roots) - self.max_roots
            del self.roots[:drop]
            self.dropped_roots += drop

    # ------------------------------------------------------------- lifecycle
    def clear(self) -> None:
        self.roots.clear()
        self._stack.clear()
        self.dropped_roots = 0

    def drain(self) -> List[Span]:
        """Return and forget all completed roots."""
        out = self.roots
        self.roots = []
        return out

    # --------------------------------------------------------------- exports
    def _wall_us(self, t_ns: int) -> float:
        return (self._epoch_ns + (t_ns - self._perf0_ns)) / 1e3

    def to_jsonl(self, path: str) -> int:
        """One JSON object per span (depth-first), flat with
        ``span_id``/``parent_id`` links. Returns the span count."""
        n = 0
        with open(path, "w") as f:
            for root in self.roots:
                for sp in root.walk():
                    rec = {
                        "name": sp.name,
                        "span_id": sp.span_id,
                        "parent_id": sp.parent_id,
                        "ts_us": self._wall_us(sp.t0_ns),
                        "dur_us": sp.dur_ns / 1e3,
                        "attrs": sp.attrs,
                        "counters": sp.counters,
                    }
                    f.write(json.dumps(rec) + "\n")
                    n += 1
        return n

    def to_chrome_trace(self, path: str, pid: int = 1, tid: int = 1) -> int:
        """Chrome trace-event export (Perfetto-loadable).

        Complete events (``ph="X"``) with microsecond ``ts``/``dur``;
        span attrs and counters travel in ``args``. Returns the event
        count."""
        events = []
        for root in self.roots:
            for sp in root.walk():
                args = dict(sp.attrs)
                args.update(sp.counters)
                events.append({
                    "name": sp.name,
                    "cat": "stream",
                    "ph": "X",
                    "ts": self._wall_us(sp.t0_ns),
                    "dur": sp.dur_ns / 1e3,
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(events)
