"""$COMPUTE_EFF_COST — the adaptive decision at the heart of network-aware shuffling.

At each hierarchy level the template asks: *if the workers in this group shuffle and
combine locally first, does the data reduction pay for the extra local transfer?*

    EFF  = time saved on every boundary the removed bytes would still have crossed
         = (1 - r̂) · B_group · Σ_{levels above} 1/bw
    COST = time of the local exchange itself + the combine compute
         = B_group/ bw_level · (1 - 1/g)  +  B_group / combine_throughput

where ``r̂`` is the reduction ratio estimated from the partition-aware sample, ``B_group``
the total bytes held by the group's workers, and ``g`` the group size (a ``1/g`` of the
data stays local during the exchange).  The stage executes iff ``EFF > COST`` — the
same rule as Figure 3, lines 5/15.
"""
from __future__ import annotations

import dataclasses

from .messages import Combiner, Msgs
from .sampling import (estimate_reduction_ratio,
                       estimate_reduction_ratio_with_fallback)
from .topology import NetworkTopology


@dataclasses.dataclass(frozen=True)
class EffCost:
    eff: float
    cost: float
    reduction_ratio: float
    group_bytes: float = 0.0
    # ^ the B_group the verdict was computed from — carried so the resilience
    #   layer can re-evaluate EFF/COST against a *degraded* topology (plan
    #   repair) without re-sampling; 0.0 on trivially-rejected stages.
    sample_attempts: int = 0
    # ^ how many fallback hash groups the r̂ estimator had to visit because
    #   the primary pooled sample was empty (0 = primary group sufficed).
    recv_imbalance: float = 1.0
    # ^ the ledger-observed per-destination recv-byte imbalance (max/mean)
    #   folded into the EFF term — 1.0 when the coupling is off (balance mode
    #   "off") or no imbalance has been observed.

    @property
    def beneficial(self) -> bool:
        return self.eff > self.cost


def reduction_drift(baseline: float, observed: float, *,
                    tolerance: float = 0.15) -> bool:
    """Has the data's reduction ratio drifted from what the plan was compiled on?

    The plan cache replays EFF/COST verdicts frozen from sampled statistics; those
    verdicts are only as good as r̂.  Every cached execution measures the *actual*
    ratio of each beneficial stage (combined bytes / exchanged bytes) for free —
    the combine ran anyway — and a deviation beyond ``tolerance`` (absolute, on a
    quantity in [0, 1]) means the workload changed underneath the plan: the entry
    must be invalidated and the next shuffle re-sampled.
    """
    return abs(baseline - observed) > tolerance


def compute_eff_cost(
    topology: NetworkTopology,
    level_name: str,
    samples: list[Msgs],
    group_bytes: int,
    group_size: int,
    combiner: Combiner | None,
    recv_imbalance: float = 1.0,
) -> EffCost:
    """Evaluate one hierarchical stage from pooled partition-aware samples.

    ``samples`` come from every worker in the shuffle (the sampling server pools
    them), so duplication *across* workers — exactly what the local combine will
    remove — is visible in the estimate.  Each entry is either a plain ``Msgs``
    (one group sample) or a fallback list from
    :func:`repro_torch.core.sampling.sample_with_fallback`; in the latter case an
    empty pooled primary group falls back to the next group instead of
    reporting the stage-rejecting ``r̂ = 1.0``, and the attempt count is
    recorded on the verdict.

    ``recv_imbalance`` is the skew-aware EFF/COST coupling (balance mode
    ``"auto"``): the ledger's observed per-destination recv-byte imbalance,
    pricing the BSP tail a hot destination puts on the levels above — see
    :func:`eff_cost_from_ratio`.
    """
    if combiner is None or group_size <= 1:
        return EffCost(eff=0.0, cost=0.0, reduction_ratio=1.0)
    if samples and isinstance(samples[0], list):
        r_hat, attempts = estimate_reduction_ratio_with_fallback(samples, combiner)
    else:
        r_hat, attempts = estimate_reduction_ratio(samples, combiner), 0
    ec = eff_cost_from_ratio(topology, level_name, r_hat, group_bytes, group_size,
                             recv_imbalance=recv_imbalance)
    if attempts:
        ec = dataclasses.replace(ec, sample_attempts=attempts)
    return ec


def eff_cost_from_ratio(
    topology: NetworkTopology,
    level_name: str,
    r_hat: float,
    group_bytes: float,
    group_size: int,
    recv_imbalance: float = 1.0,
) -> EffCost:
    """The EFF/COST formula alone, decoupled from sampling.

    Used by fresh instantiation (with a freshly sampled r̂) and by plan repair
    (with the ratio a cached plan already validated) — so a repaired verdict is
    exactly what instantiation would compute on the degraded topology, minus
    the sampling pass.

    ``recv_imbalance`` folds destination skew into the BSP tail term of EFF:
    epoch time is gated on the slowest worker, so when received bytes pile
    ``imb ×`` the mean onto one hot destination, every byte a local combine
    removes shortens that tail proportionally — the savings on the boundaries
    above scale by the imbalance, making combining *more* beneficial exactly
    when a hot receiver is the shuffle's critical path.
    """
    li = topology.level_index(level_name)
    lv = topology.levels[li]
    saved_per_byte = topology.cost_per_byte_above(li)
    imb = max(1.0, float(recv_imbalance))
    eff = (1.0 - r_hat) * group_bytes * saved_per_byte * imb
    exchange_frac = 1.0 - 1.0 / group_size
    cost = (group_bytes * exchange_frac) / lv.bw_bytes_per_s \
        + group_bytes / lv.combine_bytes_per_s + lv.latency_s
    return EffCost(eff=eff, cost=cost, reduction_ratio=r_hat,
                   group_bytes=float(group_bytes), recv_imbalance=imb)
