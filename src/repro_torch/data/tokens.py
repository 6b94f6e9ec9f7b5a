"""Deterministic synthetic token generators (the container has no corpus).

Two generators with genuinely different statistics so data-dependent paths (MoE
routing balance, combiner reduction ratios) see realistic skew:

* :func:`zipf_tokens` — i.i.d. Zipf-distributed ids: heavy head, long tail.  This is
  the LM analogue of the paper's power-law graph keys (a few hot vertices receive
  most messages), so shuffle combiners see the same high-duplication regime.
* :func:`markov_tokens` — a k-state token-class Markov chain, giving local sequence
  structure (loss actually decreases when a model trains on it).
"""
from __future__ import annotations

import numpy as np


def zipf_tokens(rng: np.random.Generator, shape: tuple[int, ...], vocab: int,
                alpha: float = 1.3) -> np.ndarray:
    """Zipf(alpha) over [0, vocab) via inverse-CDF on a precomputed table."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    cdf = np.cumsum(w) / np.sum(w)
    u = rng.random(shape)
    return np.searchsorted(cdf, u).astype(np.int32)


def markov_tokens(rng: np.random.Generator, shape: tuple[int, ...], vocab: int,
                  classes: int = 16, stickiness: float = 0.8) -> np.ndarray:
    """Token-class Markov chain: class transitions are sticky, ids uniform in class."""
    b, s = shape
    per = max(1, vocab // classes)
    trans = np.full((classes, classes), (1 - stickiness) / (classes - 1))
    np.fill_diagonal(trans, stickiness)
    cdf = np.cumsum(trans, axis=1)
    state = rng.integers(0, classes, size=b)
    out = np.empty((b, s), np.int32)
    for t in range(s):
        u = rng.random(b)
        state = np.array([np.searchsorted(cdf[st], uu) for st, uu in zip(state, u)])
        out[:, t] = (state * per + rng.integers(0, per, size=b)) % vocab
    return out
