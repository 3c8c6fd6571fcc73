"""The streaming service's pieces that the port's device backend needs:
the per-batch :class:`~repro_torch.stream.scheduler.SharedDelta` and the
work counters (copies from ``repro/stream/scheduler.py``)."""

from .scheduler import PROBE, PROBE_METRIC_NAMES, SharedDelta, probe_inc, reset_probe

__all__ = ["PROBE", "PROBE_METRIC_NAMES", "SharedDelta", "probe_inc", "reset_probe"]
