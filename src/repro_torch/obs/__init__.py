"""Observability for the port's streaming backend: a metrics registry, a
span tracer and the step-profiler hook, as ``repro/obs/__init__.py``
defines them.

- :mod:`repro_torch.obs.metrics` — counters, gauges, histograms, with
  Prometheus-text and JSON exposition (copy of ``repro/obs/metrics.py``);
- :mod:`repro_torch.obs.trace` — the hierarchical span tracer, with JSONL
  and Chrome trace-event export (copy of ``repro/obs/trace.py``);
- :mod:`repro_torch.obs.prof` — step profiling (twin of
  ``repro/obs/jaxprof.py``): the first call of each wrapped device step
  apart from its steady calls, CUDA-event step times on the card, argument /
  output / alias bytes, optional ``torch.profiler`` windows.

One :class:`Observability` per service; the default has the registry and
the step profiler on and span tracing off. The profiler keeps the attribute
name ``jaxprof`` that the service contract reads
(``obs.jaxprof.on_batch_start``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from .metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
                      ProbeView)
from .prof import ProfiledStep, StepProfile, StepProfiler
from .trace import NULL_SPAN, Span, Tracer

__all__ = ["Observability", "MetricsRegistry", "Counter", "Gauge", "Histogram", "ProbeView",
           "DEFAULT_LATENCY_BUCKETS", "Tracer", "Span", "NULL_SPAN", "StepProfiler",
           "ProfiledStep", "StepProfile"]


class Observability:
    """One service's metrics registry + span tracer + step profiler.

    ``Observability()``          — registry and profiler on, tracing off
    ``Observability.full()``     — everything on (span tracing included)
    ``Observability.disabled()`` — the profiler off too (still safe to call)
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 jaxprof: Optional[StepProfiler] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.jaxprof = (jaxprof if jaxprof is not None
                        else StepProfiler(self.metrics, enabled=True))
        #: per-pattern CompiledPlan dumps (latest wins across swaps)
        self.plans: Dict[str, dict] = {}

    def record_plan(self, name: str, dump: dict) -> None:
        """Remember a pattern's latest ``CompiledPlan.to_json()``."""
        self.plans[name] = dump

    @classmethod
    def full(cls) -> "Observability":
        return cls(tracer=Tracer(enabled=True))

    @classmethod
    def disabled(cls) -> "Observability":
        obs = cls()
        obs.jaxprof.enabled = False
        return obs

    def export(self, dir_path: str, prefix: str = "obs") -> Dict[str, str]:
        """Write every artifact into ``dir_path``; returns name → path: the
        metrics as JSON and Prometheus text always, the spans (JSONL and
        Chrome trace-event JSON) when any were recorded, the step profile
        (``{prefix}_prof.json``) once any step ran profiled, and the plan
        dumps."""
        os.makedirs(dir_path, exist_ok=True)
        out: Dict[str, str] = {}
        p = os.path.join(dir_path, f"{prefix}_metrics.json")
        self.metrics.save_json(p)
        out["metrics_json"] = p
        p = os.path.join(dir_path, f"{prefix}_metrics.prom")
        self.metrics.save_prometheus(p)
        out["metrics_prom"] = p
        if self.tracer.roots:
            p = os.path.join(dir_path, f"{prefix}_trace.jsonl")
            self.tracer.to_jsonl(p)
            out["trace_jsonl"] = p
            p = os.path.join(dir_path, f"{prefix}_trace_chrome.json")
            self.tracer.to_chrome_trace(p)
            out["trace_chrome"] = p
        if self.jaxprof.steps:
            p = os.path.join(dir_path, f"{prefix}_prof.json")
            self.jaxprof.save_json(p)
            out["prof_json"] = p
        if self.plans:
            p = os.path.join(dir_path, f"{prefix}_plans.json")
            with open(p, "w") as f:
                json.dump(self.plans, f, indent=2, sort_keys=True)
                f.write("\n")
            out["plans_json"] = p
        return out
