"""Plan repair: re-instantiate only the affected levels of a CompiledPlan.

A failure scenario changes the world under a compiled plan in one of two ways:

* **link degradation** — surviving links carry the load, so a boundary's
  effective bandwidth drops (``topology.degrade_links``).  The plan's neighbor
  lists are still exactly right (membership is placement, not bandwidth), but
  every EFF/COST verdict at or below the degraded boundary may flip: EFF grows
  with the cost of the boundaries *above* a stage, COST with the stage's own.
* **participant loss** — a dead worker that is excised rather than restarted
  shrinks the worker set, which edits exactly the neighbor groups it belonged
  to (and proportionally shrinks the bytes the verdicts were computed from).

Full re-instantiation would re-run neighbor discovery, sampling, and the
sampling-server rendezvous for *every* level.  Repair instead re-derives only
the affected levels, reusing the plan's validated reduction ratios — the exact
numbers instantiation would estimate, minus the sampling pass — and stores the
result under the degraded topology's fingerprint in the :class:`PlanCache`.
Repeated failures in the same scenario (the common case: a flapping link, a
rack-level brownout) then hit the cache directly and pay nothing at all.
"""
from __future__ import annotations

import dataclasses

from ..adaptive import eff_cost_from_ratio
from ..messages import PartFn
from ..plancache import CompiledPlan, LevelDecision, PlanCache, \
    split_topology_tag
from ..skew import estimate_slot_loads, plan_rebalance
from ..tenancy import DEFAULT_TENANT
from ..topology import Level, NetworkTopology


def _levels_from_fingerprint(fp: tuple) -> tuple[Level, ...]:
    """A topology fingerprint is ``tuple(astuple(level) ...)`` — invertible."""
    return tuple(Level(*t) for t in fp)


def changed_level_indices(old_fp: tuple, new_fp: tuple) -> set[int]:
    if len(old_fp) != len(new_fp):
        raise ValueError("topologies have different depths; not repairable")
    return {i for i, (a, b) in enumerate(zip(old_fp, new_fp)) if a != b}


def repair_plan(
    plan: CompiledPlan,
    new_key: tuple,
    new_topology: NetworkTopology,
    *,
    new_srcs=None,
    new_dsts=None,
    part_fn: PartFn | None = None,
) -> tuple[CompiledPlan, list[str]]:
    """Rebuild ``plan`` for ``new_topology`` (and optionally fewer workers).

    Returns the repaired plan plus the names of the levels whose decision was
    actually re-derived — everything else is carried over untouched.  Raises
    ``ValueError`` when the topologies are structurally incompatible (different
    depth or level names), i.e. when only full re-instantiation can help.

    A skew-instantiated plan carries the frozen heavy-hitter sketch; when the
    destination set shrinks (a dead worker excised) the hot-key splits are
    **re-targeted** by re-running :func:`repro_torch.core.skew.plan_rebalance` from
    that sketch against the surviving destinations — every share and owner is
    a live worker again, and no re-sampling happens.  ``part_fn`` (the
    shuffle's own partition function) is required for that re-derivation;
    link-degradation repairs keep the splits untouched (membership is
    placement, not bandwidth).
    """
    old_fp, _ = split_topology_tag(plan.key[1])
    new_fp = new_topology.fingerprint()
    changed = changed_level_indices(old_fp, new_fp)
    old_levels = _levels_from_fingerprint(old_fp)
    for old, new in zip(old_levels, new_topology.levels):
        if old.name != new.name:
            raise ValueError(f"level mismatch {old.name!r} != {new.name!r}")
    new_srcs = plan.srcs if new_srcs is None else tuple(new_srcs)
    new_dsts = plan.dsts if new_dsts is None else tuple(new_dsts)
    removed = set(plan.srcs) - set(new_srcs)
    scale = len(new_srcs) / max(1, len(plan.srcs))

    repaired_levels: list[str] = []
    out: list[LevelDecision] = []
    for ld in plan.levels:
        li = new_topology.level_index(ld.level)
        ec, nbrs = ld.eff_cost, ld.nbrs
        group_hit = removed and any(
            w in removed for members in nbrs.values() for w in members)
        cost_hit = li in changed                    # the stage's own exchange
        eff_hit = any(j > li for j in changed)      # boundaries the savings cross
        if group_hit:
            nbrs = {}
            for w, members in ld.nbrs.items():
                if w in removed:
                    continue
                kept = tuple(m for m in members if m not in removed)
                if kept:
                    nbrs[w] = kept
        if (cost_hit or eff_hit or group_hit) and ec.group_bytes > 0:
            # carry the frozen hot-destination factor: a repaired verdict must
            # be exactly what instantiation computed, minus the sampling pass
            ec = eff_cost_from_ratio(
                new_topology, ld.level, ec.reduction_ratio,
                ec.group_bytes * scale, new_topology.levels[li].group_size,
                recv_imbalance=ec.recv_imbalance)
        if cost_hit or eff_hit or group_hit:
            repaired_levels.append(ld.level)
        out.append(LevelDecision(level=ld.level, eff_cost=ec, nbrs=nbrs,
                                 baseline_r=ld.baseline_r))

    skew = plan.skew
    baseline = plan.baseline_imbalance
    if skew is not None and new_dsts != plan.dsts:
        if part_fn is None:
            raise ValueError(
                "repairing a skew-instantiated plan onto a different "
                "destination set requires the shuffle's part_fn")
        ndst = len(new_dsts)
        skew = plan_rebalance(
            skew.sketch, estimate_slot_loads(skew.sketch, part_fn, ndst),
            part_fn, ndst, threshold=skew.threshold)
        repaired_levels.append("rebalance")
        # the old run's measured imbalance described the lost-worker layout;
        # the re-targeted estimate is the only baseline that still applies
        baseline = skew.est_balanced_imbalance

    repaired = CompiledPlan(key=new_key, template_id=plan.template_id,
                            srcs=new_srcs, dsts=new_dsts, levels=tuple(out),
                            skew=skew, baseline_imbalance=baseline,
                            stream=plan.stream)
    return repaired, repaired_levels


def _signature_shrinks_to(big_sig: tuple, small_sig: tuple) -> bool:
    """Does ``small_sig`` describe a participant-subset of ``big_sig``'s workload?

    A stats signature is ``(part, comb, rate, balance, skew_threshold, widths,
    key_bucket, skew_bucket, stream, counts)`` with ``counts`` — the per-worker
    (wid, log2-bucket) tuple — kept last by contract: losing workers keeps every other element
    equal (the survivors' distribution shape is the distribution shape), so
    only ``counts`` may shrink, and it must shrink to a sub-multiset.
    """
    if big_sig[:-1] != small_sig[:-1]:
        return False
    return set(small_sig[-1]) <= set(big_sig[-1])


def try_repair(cache: PlanCache, key: tuple, topology: NetworkTopology,
               part_fn: PartFn | None = None,
               tenant: str = DEFAULT_TENANT,
               tracer=None) -> CompiledPlan | None:
    """On a cache miss, try to derive the missing plan from a cached relative.

    ``key`` is the (missed) full plan key ``(template, topology-tag, srcs,
    dsts, signature)``.  Candidates must match the template and differ only by
    topology (link degradation or elastic growth/shrink, same signature), by
    elastic epoch alone (same physical layout — the plan is *re-keyed*, no
    level re-derived), or by a participant superset (worker loss, signature
    minus the lost workers' count entries).  Candidates come from ``tenant``'s
    namespace alone — repair never adapts (or leaks) another tenant's plans.
    On success the repaired plan is cached under ``key`` in the same
    namespace — so the *next* identical failure scenario is a plain cache
    hit — and the cache's ``repairs`` counter increments.
    """
    template_id, tag, srcs, dsts, signature = key
    fingerprint, _epoch = split_topology_tag(tag)
    sp = tracer.span("plan_repair", tenant=tenant, template=template_id) \
        if tracer is not None and tracer.enabled else None
    for cand_key, plan in reversed(cache.scan(tenant)):  # MRU candidates first
        c_template, c_tag, c_srcs, c_dsts, c_sig = cand_key
        c_fp, _c_epoch = split_topology_tag(c_tag)
        if c_template != template_id:
            continue
        if (c_fp == fingerprint and c_tag != tag and c_sig == signature
                and (c_srcs, c_dsts) == (srcs, dsts)):
            # epoch re-key: same physical layout under a different elastic
            # epoch — the plan is exactly right, only its key went stale
            repaired = dataclasses.replace(plan, key=key)
            cache.put(key, repaired, repaired=True, tenant=tenant)
            if sp is not None:
                sp.end(outcome="repaired", levels=[], case="epoch_rekey")
            return repaired
        if (c_sig == signature and c_fp != fingerprint
                and (c_srcs, c_dsts) == (srcs, dsts)):
            kwargs = {}                          # topology-change case
        elif (c_fp == fingerprint and set(srcs) < set(c_srcs)
              and set(dsts) <= set(c_dsts)
              and _signature_shrinks_to(c_sig, signature)):
            kwargs = {"new_srcs": srcs, "new_dsts": dsts}   # lost-worker case
        else:
            continue
        try:
            repaired, levels = repair_plan(plan, key, topology,
                                           part_fn=part_fn, **kwargs)
        except ValueError:
            continue
        cache.put(key, repaired, repaired=True, tenant=tenant)
        if sp is not None:
            if kwargs:
                case = "lost_worker"
            elif fingerprint[-1][1] != c_fp[-1][1]:
                # outermost group_size differs: the worker set itself grew
                # or shrank (elastic re-instantiation), not just link speeds
                case = "grown_topology"
            else:
                case = "degraded_topology"
            sp.end(outcome="repaired", levels=list(levels), case=case)
        return repaired
    if sp is not None:
        sp.end(outcome="no_candidate")
    return None
