"""Carry a shuffle's state across from the JAX package into the port.

TeShu has no weights: the state a deployment carries is its cached
:class:`~repro_torch.core.plancache.CompiledPlan` (the frozen instantiation:
levels, EFF/COST verdicts, neighbor lists, skew verdict, chunking policy)
and the input buffers (``Msgs`` per worker).  These functions rebuild both
as the port's own types from any object with the same fields -- duck
typing, so this module imports nothing of the reference package -- and
copy every array, so the result shares no memory with its source.
"""
from __future__ import annotations

import numpy as np

from .adaptive import EffCost
from .messages import Msgs
from .plancache import CompiledPlan, LevelDecision
from .skew import HeavyHitterSketch, SkewDecision
from .streaming import ChunkPlan


def _eff_cost(ec) -> EffCost:
    return EffCost(eff=float(ec.eff), cost=float(ec.cost),
                   reduction_ratio=float(ec.reduction_ratio),
                   group_bytes=float(ec.group_bytes),
                   sample_attempts=int(ec.sample_attempts),
                   recv_imbalance=float(ec.recv_imbalance))


def _sketch(sk) -> HeavyHitterSketch:
    return HeavyHitterSketch(
        int(sk.capacity), {int(k): int(c) for k, c in sk.counts.items()},
        total=int(sk.total), error_bound=int(sk.error_bound))


def _skew(dec) -> SkewDecision | None:
    if dec is None:
        return None
    return SkewDecision(
        ndst=int(dec.ndst), threshold=float(dec.threshold),
        est_imbalance=float(dec.est_imbalance),
        est_balanced_imbalance=float(dec.est_balanced_imbalance),
        top_share=float(dec.top_share),
        splits=tuple((int(k), tuple(int(s) for s in slots))
                     for k, slots in dec.splits),
        sketch=_sketch(dec.sketch))


def _level(ld) -> LevelDecision:
    return LevelDecision(
        level=str(ld.level), eff_cost=_eff_cost(ld.eff_cost),
        nbrs={int(w): tuple(int(n) for n in nb) for w, nb in ld.nbrs.items()},
        baseline_r=float(ld.baseline_r))


def plan_from_reference(plan) -> CompiledPlan:
    """The port's ``CompiledPlan`` equal to a JAX-package one (any object
    with a CompiledPlan's fields)."""
    stream = plan.stream
    return CompiledPlan(
        key=plan.key, template_id=str(plan.template_id),
        srcs=tuple(int(w) for w in plan.srcs),
        dsts=tuple(int(w) for w in plan.dsts),
        levels=tuple(_level(ld) for ld in plan.levels),
        skew=_skew(plan.skew),
        baseline_imbalance=(None if plan.baseline_imbalance is None
                            else float(plan.baseline_imbalance)),
        stream=(None if stream is None else ChunkPlan(
            chunk_bytes=int(stream.chunk_bytes),
            max_inflight=int(stream.max_inflight))))


def msgs_from_reference(bufs: dict) -> dict[int, Msgs]:
    """The port's per-worker ``Msgs`` for a buffer dict of the JAX package
    (any objects with ``keys`` and ``vals`` arrays)."""
    return {int(w): Msgs(np.array(m.keys, dtype=np.int64),
                         np.array(m.vals, dtype=np.float64))
            for w, m in bufs.items()}
