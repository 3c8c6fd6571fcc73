"""Deterministic synthetic LM token streams (Zipfian unigram marginals).

Copy of ``repro/data/tokens.py``: the same NumPy draws, so one seed gives
the JAX package's stream bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["token_batches"]


def token_batches(vocab: int, batch: int, seq: int, *, seed: int = 0, zipf_a: float = 1.2):
    """Infinite iterator of ``(tokens, labels)`` int32 arrays ``[batch,
    seq]``: each row is ``seq + 1`` draws of a Zipf(``zipf_a``) law over the
    vocabulary, the labels the tokens shifted by one."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs).astype(np.int32)
        yield toks[:, :-1], toks[:, 1:]
