"""Click-log generator for DLRM (skewed sparse ids, synthetic CTR labels).

Copy of ``repro/data/recsys.py`` ``click_batches``: the same NumPy draws
in the same order, so one seed gives the JAX package's stream bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["click_batches"]


def click_batches(n_dense: int, n_sparse: int, rows: int, batch: int,
                  *, multi_hot: int = 1, seed: int = 0):
    """Infinite iterator of ``(dense [batch, n_dense] float32, ids [batch,
    n_sparse, multi_hot] int32, labels [batch] float32)``.

    The ids are ``u**4 · rows`` for uniform ``u``: heavily skewed toward
    row 0 (about 3.2 % of a field's lookups land there at 1,000,000 rows).
    A label is 1 with probability ``sigmoid(dense[:, 0] / 2 + 0.3 ·
    [ids[:, 0, 0] % 7 == 0])``."""
    rng = np.random.default_rng(seed)
    while True:
        dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
        u = rng.random(size=(batch, n_sparse, multi_hot))
        ids = np.minimum((u ** 4 * rows).astype(np.int32), rows - 1)
        logits = dense[:, 0] * 0.5 + (ids[:, 0, 0] % 7 == 0) * 0.3
        labels = (rng.random(batch) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
        yield dense, ids, labels
