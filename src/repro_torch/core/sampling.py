"""SAMP: partition-aware sampling (paper §4.1, Figure 4) and the random baseline.

The estimation target is the combiner's **data-reduction ratio**
``r = |COMB(msgs)| / |msgs|`` over the union of all workers' buffers.  Random tuple
sampling is biased upward at low rates: a sparse sample rarely contains two messages
with the same key, so it estimates r ~= 1 even when the true ratio is ~0.18 (Fig. 5).

Partition-aware sampling divides the *destination key space* into ``S = round(1/rate)``
groups using the shuffle's own partition function (consistent hashing), picks one group
``j``, and samples **every** message whose key falls in group ``j`` — across all
workers.  Within the sampled group, per-key duplication is observed exactly, so the
estimate is unbiased over the randomness of the hash and of ``j``.
"""
from __future__ import annotations

import numpy as np

from .messages import Combiner, Msgs, PartFn, splitmix64

# Bounded retries for the empty-pooled-sample fallback: how many *additional*
# hash groups a worker samples when its primary group holds no messages.
SAMPLE_FALLBACK_RETRIES = 3


def num_groups_for_rate(rate: float) -> int:
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"rate must be in (0,1]: {rate}")
    return max(1, int(round(1.0 / rate)))


def group_of(keys: np.ndarray, num_groups: int, seed: int = 0x5A11) -> np.ndarray:
    """Consistent-hash group of each message's destination key (Figure 4)."""
    return (splitmix64(keys, seed=seed) % np.uint64(num_groups)).astype(np.int64)


def partition_aware_sample(msgs: Msgs, rate: float, part_fn: PartFn | None = None,
                           *, seed: int = 0, attempt: int = 0) -> Msgs:
    """SAMP(msgs, rate, partFunc): all messages of one randomly chosen hash group.

    ``part_fn`` is accepted for signature fidelity with the paper (the grouping must
    be consistent with the shuffle's partitioning so that a group is closed under
    destinations); the consistent hash already guarantees that for hash partitioning.

    ``attempt`` rotates the chosen group deterministically (attempt 0 is the
    primary draw; attempts 1..k visit *distinct* further groups) — the
    empty-group fallback's knob.
    """
    del part_fn  # grouping is by destination key; closed under any key-based partFunc
    s = num_groups_for_rate(rate)
    j = int(splitmix64(np.asarray([seed], dtype=np.int64), seed=0xC0FFEE)[0] % np.uint64(s))
    j = (j + attempt) % s
    grp = group_of(msgs.keys, s)
    return msgs.take(np.nonzero(grp == j)[0])


def sample_with_fallback(msgs: Msgs, rate: float, part_fn: PartFn | None = None,
                         *, seed: int = 0,
                         max_retries: int = SAMPLE_FALLBACK_RETRIES) -> list[Msgs]:
    """Primary group sample plus fallback-group samples while it stays empty.

    Returns ``[s_0]`` when the primary draw holds messages, else
    ``[s_0(empty), s_1, ..., s_k]`` stopping at the first non-empty attempt,
    after ``max_retries``, or once every group has been visited (attempts
    rotate through the ``S`` hash groups, so more than ``S - 1`` retries
    would re-scan groups already known empty).  The pooled estimator
    (:func:`estimate_reduction_ratio_with_fallback`) uses attempt *k* only when
    the pooled attempt *k-1* is empty across **all** workers — and a pooled
    attempt is empty exactly when every worker's local draw was empty, so every
    worker shipped attempt *k* too: the fallback group is always complete
    cluster-wide and the cluster-sample unbiasedness argument is unchanged.
    """
    out = [partition_aware_sample(msgs, rate, seed=seed, attempt=0)]
    attempt = 0
    retries = min(max_retries, num_groups_for_rate(rate) - 1)
    while out[-1].n == 0 and attempt < retries:
        attempt += 1
        out.append(partition_aware_sample(msgs, rate, seed=seed, attempt=attempt))
    return out


def random_sample(msgs: Msgs, rate: float, *, seed: int = 0) -> Msgs:
    """The naive baseline: uniform tuple sampling."""
    rng = np.random.default_rng(seed)
    mask = rng.random(msgs.n) < rate
    return msgs.take(np.nonzero(mask)[0])


def reduction_ratio(msgs: Msgs, combiner: Combiner) -> float:
    """|COMB(msgs)| / |msgs| — 1.0 means the combiner removes nothing."""
    if msgs.n == 0:
        return 1.0
    return combiner(msgs).n / msgs.n


def estimate_reduction_ratio(samples: list[Msgs], combiner: Combiner) -> float:
    """Estimator used by $COMPUTE_EFF_COST: pool all workers' samples (they were
    drawn from the same destination group, so cross-worker duplicates are visible),
    combine, and report the ratio."""
    pooled = Msgs.concat(samples)
    return reduction_ratio(pooled, combiner)


def estimate_reduction_ratio_with_fallback(
        sample_lists: list[list[Msgs]], combiner: Combiner) -> tuple[float, int]:
    """Pooled estimation over per-worker fallback sample lists.

    Attempt 0 is the primary group; if it pooled empty — the case the old
    estimator silently reported as ``r̂ = 1.0``, rejecting combine stages that
    a single unlucky hash group said nothing about — later attempts are tried
    in order.  Returns ``(ratio, attempts_used)``: ``attempts_used`` is 0 on
    the primary group and positive when a fallback group produced the
    estimate (recorded in the EFF/COST decision so the fallback is visible in
    ``ShuffleResult.decisions``).  Only when every attempt is empty does it
    give up and report 1.0.
    """
    depth = max((len(sl) for sl in sample_lists), default=0)
    for attempt in range(depth):
        pooled = Msgs.concat(
            [sl[attempt] for sl in sample_lists if len(sl) > attempt])
        if pooled.n:
            return reduction_ratio(pooled, combiner), attempt
    return 1.0, max(0, depth - 1)
