"""Host-side NP-storage management of the port: straggler detection,
rebalancing away from slow partitions and elastic repartitioning, copies
from ``repro/dist/straggler.py`` and ``repro/dist/elastic.py`` on the
port's :mod:`repro_torch.core.storage`; and the collectives for ragged
exchange and gradient compression (:mod:`.collectives`,
:mod:`.compression`), twins of ``repro/dist/collectives.py`` and
``repro/dist/compression.py`` on a mesh of :mod:`repro_torch.mesh`.

The JAX package's ``repro/dist`` also holds the device engine and its
``shard_map`` steps; their twins are :mod:`repro_torch.engine`,
:mod:`repro_torch.sharded` and :mod:`repro_torch.mesh`.
"""

from .collectives import bucketed_all_to_all, ring_all_reduce, routed_exchange
from .compression import butterfly_compressed_all_reduce, ef_compress, ef_residual_init
from .elastic import repartition_delta, repartition_storage
from .straggler import StragglerMonitor, apply_rebalance, rebalance_plan

__all__ = ["StragglerMonitor", "rebalance_plan", "apply_rebalance", "repartition_delta",
           "repartition_storage", "bucketed_all_to_all", "routed_exchange", "ring_all_reduce",
           "ef_residual_init", "ef_compress", "butterfly_compressed_all_reduce"]
