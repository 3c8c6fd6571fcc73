"""repro_torch.stream — continuous dynamic-update subgraph listing.

Host copy of ``repro.stream``, exporting the same names with
:class:`~repro_torch.backend.TorchBackend` in place of ``ShardedBackend``::

    journal   append-only edge-op log: sequence numbers, watermarks,
              add/delete netting, replay, truncation
    scheduler cost-model-driven micro-batching + the per-batch
              SharedDelta (netted update, Φ(d'), stats, seed cache)
              computed once and shared by all registered patterns
    service   ListingService over the host backend or the device backend
              (``backend="sharded"``, a TorchBackend on the card):
              ingest() / advance() / counts() / audits / metrics
    sinks     incremental result delivery: count deltas, decompressed
              match deltas, callbacks
    plan_manager  drift-triggered online join-tree re-optimization:
              recompile from live stats, hot-swap at a committed watermark

Every ``ListingService`` owns a :class:`repro_torch.obs.Observability`
(``obs=`` constructor hook): a metrics registry, a span tracer (off by
default) and the step-profiler hook.
"""

from ..obs import Observability
from .journal import JournalEntry, UpdateJournal
from .plan_manager import PlanManager, SwapEvent
from .scheduler import (PROBE, PROBE_METRIC_NAMES, BatchScheduler, SharedDelta,
                        compute_shared_delta, probe_inc, reset_probe)
from .service import (BatchMetrics, HostBackend, ListingService, PatternMeta, PatternReport,
                      StreamBackend)
from .sinks import BatchEvent, CallbackSink, CountDeltaSink, MatchDeltaSink, Sink

__all__ = [
    "JournalEntry",
    "UpdateJournal",
    "PlanManager",
    "SwapEvent",
    "Observability",
    "PROBE",
    "PROBE_METRIC_NAMES",
    "probe_inc",
    "reset_probe",
    "BatchScheduler",
    "SharedDelta",
    "compute_shared_delta",
    "BatchMetrics",
    "HostBackend",
    "ListingService",
    "PatternMeta",
    "PatternReport",
    "TorchBackend",
    "StreamBackend",
    "BatchEvent",
    "CallbackSink",
    "CountDeltaSink",
    "MatchDeltaSink",
    "Sink",
]


def __getattr__(name):
    # TorchBackend is loaded on first use: repro_torch.backend imports this
    # package, so importing it here would be circular.
    if name == "TorchBackend":
        from ..backend import TorchBackend

        return TorchBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
