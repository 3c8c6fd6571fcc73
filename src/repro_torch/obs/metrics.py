"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

Host copy (pure Python) of ``repro/obs/metrics.py``, whole. One
:class:`MetricsRegistry` per streaming service, so two services never share
counters; named, labeled instruments exposed as Prometheus text
(:meth:`MetricsRegistry.to_prometheus`) and JSON snapshots
(:meth:`MetricsRegistry.snapshot`).

Design constraints (this sits on the per-batch hot path):

- instrument lookup is one dict ``get``; updates are one float add —
  no locks, no string formatting until exposition time;
- instruments are created lazily and idempotently: calling
  ``registry.counter("x")`` twice returns the same object (the first
  call's ``help``/``buckets`` win), so call sites don't need a shared
  catalog module;
- exposition is deterministic (sorted instrument names, sorted label
  values) so golden tests can compare exact text.

:class:`ProbeView` keeps the ``PROBE["key"]`` / ``reset_probe()`` surface
alive on top of a registry (see :mod:`repro_torch.stream.scheduler`).
"""

from __future__ import annotations

import json
import math
import time
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ProbeView",
    "DEFAULT_LATENCY_BUCKETS",
]

# Seconds-scale latency buckets: 100µs .. 30s, roughly ×3 per step.
# Fixed (never adaptive) so histograms from different runs are mergeable.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(label_names: Sequence[str], kv: Mapping[str, str]) -> _LabelKey:
    if set(kv) != set(label_names):
        raise ValueError(
            f"labels {sorted(kv)} do not match declared {sorted(label_names)}")
    return tuple((n, str(kv[n])) for n in label_names)


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{n}="{_escape(v)}"' for n, v in key)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class _Instrument:
    """Shared shell: a name, help text, label schema, per-labelset cells."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)

    def _cells(self) -> Iterator[Tuple[_LabelKey, object]]:  # pragma: no cover
        raise NotImplementedError


class Counter(_Instrument):
    """Monotone counter. ``inc(n)`` with n ≥ 0; reads via :attr:`value`."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        super().__init__(name, help, labels)
        self._vals: Dict[_LabelKey, float] = {}

    def labels(self, **kv: str) -> "_BoundCounter":
        return _BoundCounter(self, _label_key(self.label_names, kv))

    def inc(self, n: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(f"counter {self.name} requires labels()")
        self._inc((), n)

    def _inc(self, key: _LabelKey, n: float) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self._vals[key] = self._vals.get(key, 0.0) + n

    @property
    def value(self) -> float:
        return self._vals.get((), 0.0)

    def value_for(self, **kv: str) -> float:
        return self._vals.get(_label_key(self.label_names, kv), 0.0)

    def _cells(self):
        return iter(sorted(self._vals.items()))


class _BoundCounter:
    __slots__ = ("_c", "_key")

    def __init__(self, c: Counter, key: _LabelKey):
        self._c, self._key = c, key

    def inc(self, n: float = 1.0) -> None:
        self._c._inc(self._key, n)

    @property
    def value(self) -> float:
        return self._c._vals.get(self._key, 0.0)


class Gauge(_Instrument):
    """Point-in-time value; ``set`` / ``inc`` / ``dec``."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        super().__init__(name, help, labels)
        self._vals: Dict[_LabelKey, float] = {}

    def labels(self, **kv: str) -> "_BoundGauge":
        return _BoundGauge(self, _label_key(self.label_names, kv))

    def set(self, v: float) -> None:
        if self.label_names:
            raise ValueError(f"gauge {self.name} requires labels()")
        self._vals[()] = float(v)

    def inc(self, n: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(f"gauge {self.name} requires labels()")
        self._vals[()] = self._vals.get((), 0.0) + n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._vals.get((), 0.0)

    def value_for(self, **kv: str) -> float:
        return self._vals.get(_label_key(self.label_names, kv), 0.0)

    def _cells(self):
        return iter(sorted(self._vals.items()))


class _BoundGauge:
    __slots__ = ("_g", "_key")

    def __init__(self, g: Gauge, key: _LabelKey):
        self._g, self._key = g, key

    def set(self, v: float) -> None:
        self._g._vals[self._key] = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._g._vals[self._key] = self._g._vals.get(self._key, 0.0) + n

    @property
    def value(self) -> float:
        return self._g._vals.get(self._key, 0.0)


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 for the implicit +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Instrument):
    """Fixed-bucket histogram (cumulative-on-exposition, raw per-bucket
    counts internally). Buckets are ascending upper bounds; +Inf is
    implicit."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labels)
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name} buckets must be ascending")
        self.buckets = bs
        self._cells_by_key: Dict[_LabelKey, _HistCell] = {}

    def labels(self, **kv: str) -> "_BoundHistogram":
        return _BoundHistogram(self, _label_key(self.label_names, kv))

    def observe(self, v: float) -> None:
        if self.label_names:
            raise ValueError(f"histogram {self.name} requires labels()")
        self._observe((), v)

    def _observe(self, key: _LabelKey, v: float) -> None:
        cell = self._cells_by_key.get(key)
        if cell is None:
            cell = self._cells_by_key[key] = _HistCell(len(self.buckets))
        v = float(v)
        # First bucket whose upper bound >= v; linear scan is fine for
        # ~12 buckets and avoids bisect import on the hot path.
        i = 0
        n = len(self.buckets)
        while i < n and v > self.buckets[i]:
            i += 1
        cell.counts[i] += 1
        cell.sum += v
        cell.count += 1

    def cell(self, **kv: str) -> Optional[_HistCell]:
        key = _label_key(self.label_names, kv) if kv else ()
        return self._cells_by_key.get(key)

    def _cells(self):
        return iter(sorted(self._cells_by_key.items()))


class _BoundHistogram:
    __slots__ = ("_h", "_key")

    def __init__(self, h: Histogram, key: _LabelKey):
        self._h, self._key = h, key

    def observe(self, v: float) -> None:
        self._h._observe(self._key, v)


class MetricsRegistry:
    """Named instrument store with lazy, idempotent creation.

    ``registry.counter(name)`` returns the existing instrument when one
    with that name is already registered (first declaration's metadata
    wins); asking for the same name with a *different kind* is a bug and
    raises.
    """

    def __init__(self):
        self._instruments: Dict[str, _Instrument] = {}

    # ------------------------------------------------------------- factories
    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> Histogram:
        inst = self._instruments.get(name)
        if inst is None:
            inst = Histogram(name, help, labels, buckets)
            self._instruments[name] = inst
        elif not isinstance(inst, Histogram):
            raise TypeError(f"{name} is a {inst.kind}, not a histogram")
        return inst

    def _get_or_make(self, cls, name: str, help: str, labels: Sequence[str]):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, labels)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"{name} is a {inst.kind}, not a {cls.kind}")
        return inst

    # -------------------------------------------------------------- accessors
    def get(self, name: str) -> Optional[_Instrument]:
        return self._instruments.get(name)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def reset(self) -> None:
        """Drop every instrument. Explicit, whole-registry semantics —
        the per-service replacement for the old ``reset_probe()``."""
        self._instruments.clear()

    # ------------------------------------------------------------- exposition
    def to_prometheus(self) -> str:
        """Prometheus text exposition format, deterministically ordered."""
        out: List[str] = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if inst.help:
                out.append(f"# HELP {name} {inst.help}")
            out.append(f"# TYPE {name} {inst.kind}")
            if isinstance(inst, Histogram):
                for key, cell in inst._cells():
                    cum = 0
                    for ub, c in zip(inst.buckets, cell.counts):
                        cum += c
                        lk = key + (("le", _fmt_value(ub)),)
                        out.append(f"{name}_bucket{_fmt_labels(lk)} {cum}")
                    cum += cell.counts[-1]
                    lk = key + (("le", "+Inf"),)
                    out.append(f"{name}_bucket{_fmt_labels(lk)} {cum}")
                    out.append(f"{name}_sum{_fmt_labels(key)} {_fmt_value(cell.sum)}")
                    out.append(f"{name}_count{_fmt_labels(key)} {cell.count}")
            else:
                for key, v in inst._cells():
                    out.append(f"{name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able snapshot: name → {type, help, values}."""
        snap: Dict[str, dict] = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            entry: Dict[str, object] = {"type": inst.kind, "help": inst.help}
            if isinstance(inst, Histogram):
                cells = {}
                for key, cell in inst._cells():
                    cells[_fmt_labels(key) or "{}"] = {
                        "buckets": list(inst.buckets),
                        "counts": list(cell.counts),
                        "sum": cell.sum,
                        "count": cell.count,
                    }
                entry["values"] = cells
            else:
                entry["values"] = {
                    (_fmt_labels(key) or "{}"): v for key, v in inst._cells()
                }
            snap[name] = entry
        return snap

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"generated_unix_s": time.time(),
                       "metrics": self.snapshot()}, f, indent=2, sort_keys=True)

    def save_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())


class ProbeView:
    """Dict-shaped deprecation shim over registry counters.

    Preserves the historical ``stream.scheduler.PROBE`` surface —
    ``PROBE["k"] += 1``, ``PROBE["k"]``, ``reset_probe()`` — while the
    actual storage is a :class:`MetricsRegistry` counter per key.  Keys
    are a *fixed* set (reads and writes of unknown keys raise
    ``KeyError``, matching the old literal-dict behavior where every
    consumer indexed the seeded keys).

    Reset semantics are explicit: :meth:`reset` zeroes exactly the
    probe-backed counters of the backing registry and nothing else.
    Note the view is still process-global when reached via
    ``stream.scheduler.PROBE`` — per-service isolation comes from each
    ``ListingService`` owning its *own* registry; the global view only
    aggregates (it is kept for legacy tests/scripts and will be removed
    once callers migrate to ``service.obs.metrics``).
    """

    def __init__(self, registry: MetricsRegistry, keys: Sequence[str],
                 prefix: str = "probe_"):
        self._registry = registry
        self._prefix = prefix
        self._keys = tuple(keys)
        self._counters = {
            k: registry.counter(prefix + k, f"legacy PROBE counter {k!r}")
            for k in self._keys
        }

    def _check(self, key: str) -> str:
        if key not in self._counters:
            raise KeyError(key)
        return key

    def __getitem__(self, key: str) -> int:
        return int(self._counters[self._check(key)].value)

    def __setitem__(self, key: str, value: int) -> None:
        # `PROBE[k] += n` desugars to a read then this write; counters
        # are monotone so only forward writes are representable.
        self._check(key)
        cur = self._counters[key].value
        delta = float(value) - cur
        if delta < 0:
            raise ValueError(
                f"PROBE[{key!r}] is monotone between resets; use reset_probe()")
        if delta:
            self._counters[key]._inc((), delta)

    def _inc(self, key: str, n: int = 1) -> None:
        self._counters[self._check(key)]._inc((), float(n))

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: object) -> bool:
        return key in self._counters

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def values(self):
        return [self[k] for k in self._keys]

    def copy(self) -> Dict[str, int]:
        return dict(self.items())

    def reset(self) -> None:
        for c in self._counters.values():
            c._vals.clear()

    def __repr__(self) -> str:  # debugging convenience
        return f"ProbeView({dict(self.items())!r})"
