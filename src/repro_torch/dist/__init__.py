"""Host-side NP-storage management of the port: straggler detection,
rebalancing away from slow partitions and elastic repartitioning, copies
from ``repro/dist/straggler.py`` and ``repro/dist/elastic.py`` on the
port's :mod:`repro_torch.core.storage`.

The JAX package's ``repro/dist`` also holds the device engine and its
``shard_map`` steps; their twins are :mod:`repro_torch.engine`,
:mod:`repro_torch.sharded` and :mod:`repro_torch.mesh`.
"""

from .elastic import repartition_delta, repartition_storage
from .straggler import StragglerMonitor, apply_rebalance, rebalance_plan

__all__ = ["StragglerMonitor", "rebalance_plan", "apply_rebalance", "repartition_delta", "repartition_storage"]
