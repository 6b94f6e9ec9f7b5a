"""torchplan's programs against jaxplan's, on one JAX-package plan.

Each case instantiates a plan on the JAX package's threaded path, lowers it
with ``jaxplan.lower_plan`` and, after :func:`plan_from_reference`, with
``torchplan.lower_plan``.  The routing tables must be equal.  The stacked
inputs then go through the traced ``_replay_impl`` / ``_two_level_impl``
(jitted under ``jax.enable_x64``) and through torchplan's counterparts on the
CPU: the alive rows (keys, owners, float64 payloads) must be bit-identical in
physical order and every flow-count matrix equal.  The kernel plane's
``kernel_global_stage`` is held against jaxplan's (Pallas, interpret mode) at
rtol 1e-5.

Skew-rebalanced plans: ``_skew_slot`` is held to jaxplan's exactly, the
frozen scatter tables and the skew programs likewise, and ``plan_decline``
to jaxplan's on every converted plan of a grid (hand-built two_level and
width-changed skew plans included).  The batched program (members laid end
to end, the member index as the most significant sort key) is held to
jaxplan's vmapped program member by member.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conformance import ALL_TEMPLATES, make_bufs, service_for, workers_for
from repro.core import (HASH_PART, MAX, MIN, SUM, datacenter, jaxplan,
                        range_part)

torch = pytest.importorskip("torch")

from repro_torch.core import convert, torchplan  # noqa: E402
from repro_torch.core import messages as port_messages  # noqa: E402

CPU = torch.device("cpu")


# the skewed workload: Zipf(1.2) over 500 keys, where balance="auto"
# triggers a hot-key rebalance on the 8-worker fabrics
SKEWED = dict(n=8000, key_space=500, width=1)


def _reference_plan(template, workload, comb, part_fn=HASH_PART, *,
                    topo=None, balance="off", **bufs_kw):
    ws = workers_for(template)
    bufs = make_bufs(ws, workload, **bufs_kw)
    svc = service_for("threaded", topo=topo)
    svc.shuffle(template, {w: m.copy() for w, m in bufs.items()}, ws, ws,
                comb_fn=comb, part_fn=part_fn, balance=balance)
    (_, plan), = svc.plan_cache.scan()
    return plan, bufs


def _specs(plan, comb, part):
    name = comb.name if comb is not None else None
    common = dict(template=plan.template_id, comb=name, part=part,
                  initial_comb=(plan.template_id == "network_aware"
                                and comb is not None),
                  ns=len(plan.srcs), ndst=len(plan.dsts),
                  skew=bool(plan.skew is not None and plan.skew.triggered))
    return jaxplan._PlanSpec(**common), torchplan._PlanSpec(**common)


def _stacked(plan, bufs, low):
    per_w = [bufs[w] for w in plan.srcs]
    keys = np.concatenate([m.keys for m in per_w])
    vals = np.concatenate([m.vals for m in per_w])
    owner = np.concatenate([np.full(m.n, low.src_pos[w], np.int32)
                            for w, m in zip(plan.srcs, per_w)])
    return keys, vals, owner


def _assert_tables_equal(jl, tl):
    for f in ("gsize", "slot_map", "rank_map", "active", "global_rank"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f), f)
    for f in ("src_pos", "dst_pos", "levels_staged", "bruck_flows"):
        assert getattr(tl, f) == getattr(jl, f), f
    for f in ("skew_hot", "skew_share", "skew_len"):
        if getattr(jl, f) is None:
            assert getattr(tl, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f), f)


def _run_jax(jspec, jlow, keys, vals, owner):
    kind, shared = jaxplan._program_inputs(jspec, jlow)
    impl = jaxplan._two_level_impl if kind == "two_level" \
        else jaxplan._replay_impl
    with jax.enable_x64(True):
        out = jax.jit(impl, static_argnums=0)(
            jspec, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(owner),
            *shared)
        return [np.asarray(a) for a in out]


def _run_torch(tspec, tlow, keys, vals, owner):
    out = torchplan._run_program(
        tspec, tlow, torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(owner.astype(np.int64)), CPU)
    return [a.numpy() for a in out]


def _check_case(template, workload, comb, part_fn=HASH_PART, **plan_kw):
    plan, bufs = _reference_plan(template, workload, comb, part_fn, **plan_kw)
    port_plan = convert.plan_from_reference(plan)
    jlow, tlow = jaxplan.lower_plan(plan), torchplan.lower_plan(port_plan)
    assert jlow is not None and tlow is not None
    _assert_tables_equal(jlow, tlow)
    part = torchplan._part_spec(part_fn)
    jspec, tspec = _specs(plan, comb, part)
    keys, vals, owner = _stacked(plan, bufs, jlow)
    j = _run_jax(jspec, jlow, keys, vals, owner)
    t = _run_torch(tspec, tlow, keys, vals, owner)
    jk, jv, jo, ja = j[:4]
    tk, tv, to, ta = t[:4]
    np.testing.assert_array_equal(ta, ja)                 # same live rows
    np.testing.assert_array_equal(tk[ta], jk[ja])
    np.testing.assert_array_equal(to[ta], jo[ja])
    np.testing.assert_array_equal(tv[ta].view(np.int64),  # bit for bit
                                  jv[ja].view(np.int64))
    assert len(t) == len(j)
    for tc, jc in zip(t[4:], j[4:]):                      # flow counts
        np.testing.assert_array_equal(tc, jc.astype(np.int64))


@pytest.mark.parametrize("workload", ["uniform", "zipf"])
@pytest.mark.parametrize("template", ALL_TEMPLATES)
def test_programs_match_jax(template, workload):
    _check_case(template, workload, SUM)


@pytest.mark.parametrize("comb", [None, MIN, MAX], ids=["concat", "min", "max"])
@pytest.mark.parametrize("template", ["network_aware", "coordinated",
                                      "two_level"])
def test_programs_match_jax_combiners(template, comb):
    _check_case(template, "zipf", comb)


@pytest.mark.parametrize("template", ["vanilla_pull", "network_aware"])
def test_programs_match_jax_range_part(template):
    _check_case(template, "uniform", SUM, part_fn=range_part(64))


@pytest.mark.parametrize("part_fn", [HASH_PART, range_part(37)],
                         ids=["hash", "range"])
@pytest.mark.parametrize("ndst", [1, 4, 8])
def test_kernel_global_stage_matches_jax(part_fn, ndst):
    """The payload plane: PART as a permutation, COMB over the compacted
    (destination, key) segments, float32 accumulation on both sides."""
    rng = np.random.default_rng(ndst)
    keys = rng.integers(0, 37, 600).astype(np.int64)
    vals = rng.standard_normal((600, 3))
    expect = jaxplan.kernel_global_stage(part_fn, keys, vals, ndst)
    port_fn = (port_messages.HASH_PART if part_fn.name == "hash"
               else port_messages.range_part(37))
    got = torchplan.kernel_global_stage(port_fn, torch.from_numpy(keys),
                                        torch.from_numpy(vals), ndst)
    assert len(got) == len(expect) == ndst
    for (gk, gv), (ek, ev) in zip(got, expect):
        assert gk.dtype == np.int64 and gv.dtype == np.float64
        np.testing.assert_array_equal(gk, ek)
        np.testing.assert_allclose(gv, ev, rtol=1e-5, atol=1e-5)


def test_convert_carries_every_plan_field():
    """A plan with a triggered skew verdict (the richest plan the JAX package
    freezes) crosses over field for field, sharing no memory."""
    ws = list(range(8))
    bufs = make_bufs(ws, "zipf", n=8000, key_space=500, width=1)
    svc = service_for("threaded", topo=datacenter(4, 2, 1))
    svc.shuffle("vanilla_push", {w: m.copy() for w, m in bufs.items()}, ws, ws,
                comb_fn=SUM, balance="auto")
    (_, plan), = svc.plan_cache.scan()
    assert plan.skew is not None and plan.skew.triggered
    port = convert.plan_from_reference(plan)
    assert port.key == plan.key and port.template_id == plan.template_id
    assert (port.srcs, port.dsts) == (plan.srcs, plan.dsts)
    assert port.baseline_imbalance == plan.baseline_imbalance
    assert port.stream == plan.stream is None
    for pl, rl in zip(port.levels, plan.levels, strict=True):
        assert dataclasses.asdict(pl) == dataclasses.asdict(rl)
    ps, rs = port.skew, plan.skew
    for f in ("ndst", "threshold", "est_imbalance", "est_balanced_imbalance",
              "top_share", "splits"):
        assert getattr(ps, f) == getattr(rs, f), f
    for f in ("capacity", "counts", "total", "error_bound"):
        assert getattr(ps.sketch, f) == getattr(rs.sketch, f), f
    # the converted plan replays on the port as on the reference: no
    # decline, and the frozen scatter tables are the reference's
    assert torchplan.plan_decline(port) is jaxplan.plan_decline(plan) is None
    _assert_tables_equal(jaxplan.lower_plan(plan), torchplan.lower_plan(port))
    msgs = convert.msgs_from_reference(bufs)
    for w, m in bufs.items():
        assert type(msgs[w]) is port_messages.Msgs
        np.testing.assert_array_equal(msgs[w].keys, m.keys)
        np.testing.assert_array_equal(msgs[w].vals, m.vals)
        assert not np.shares_memory(msgs[w].vals, m.vals)


# ---------------------------------------------------------------------------
# skew-rebalanced plans
# ---------------------------------------------------------------------------

def _skew_slot_inputs(seed, n, ns, nhot, max_share, dead=0.0, at_ns=0.0,
                      hot_rows=True):
    """Seeded inputs of one _skew_slot case: keys over a small space (so
    same-(owner, key) runs are long), owners in [0, ns) with a share at
    ``ns``, a dead-row share, and ``nhot`` sorted hot keys whose share
    counts run over 1..max_share."""
    rng = np.random.default_rng(seed)
    space = 3 * nhot + 5
    hot = np.sort(rng.choice(space, size=nhot, replace=False)).astype(np.int64)
    if hot_rows:
        keys = rng.integers(0, space, n).astype(np.int64)
    else:                                   # no row carries a hot key
        cold = np.setdiff1d(np.arange(space), hot)
        keys = rng.choice(cold, size=n).astype(np.int64)
    owner = rng.integers(0, ns, n).astype(np.int32)
    owner[rng.random(n) < at_ns] = ns
    alive = rng.random(n) >= dead
    base = rng.integers(0, 8, n).astype(np.int32)
    share_len = (np.arange(nhot) % max_share + 1).astype(np.int32)
    share = np.zeros((nhot, max_share), np.int32)
    for i, m in enumerate(share_len):
        share[i, :m] = rng.choice(8, size=m, replace=False)
    return keys, owner, alive, base, hot, share, share_len


SKEW_SLOT_CASES = {
    "shares 1..5": dict(n=3000, ns=8, nhot=10, max_share=5),
    "dead rows": dict(n=3000, ns=8, nhot=6, max_share=4, dead=0.3),
    "owners at ns": dict(n=2000, ns=5, nhot=4, max_share=3, at_ns=0.2,
                         dead=0.1),
    "one row": dict(n=1, ns=4, nhot=2, max_share=2),
    "no hot row": dict(n=500, ns=4, nhot=3, max_share=3, hot_rows=False),
    "one hot key": dict(n=1000, ns=40, nhot=1, max_share=5),
}


@pytest.mark.parametrize("case", sorted(SKEW_SLOT_CASES))
def test_skew_slot_matches_jax(case):
    keys, owner, alive, base, hot, share, share_len = _skew_slot_inputs(
        sum(map(ord, case)), **SKEW_SLOT_CASES[case])
    ns = SKEW_SLOT_CASES[case]["ns"]
    with jax.enable_x64(True):
        expect = np.asarray(jaxplan._skew_slot(
            jnp.asarray(keys), jnp.asarray(owner), jnp.asarray(alive),
            jnp.asarray(base), ns, jnp.asarray(hot), jnp.asarray(share),
            jnp.asarray(share_len)))
    t = torch.from_numpy
    got = torchplan._skew_slot(
        t(keys), t(owner.astype(np.int64)), t(alive), t(base.astype(np.int64)),
        ns, t(hot), t(share.astype(np.int64)), t(share_len.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), expect.astype(np.int64))
    if SKEW_SLOT_CASES[case].get("hot_rows", True) and case != "one row":
        assert (got.numpy() != base).any()        # else the case is vacuous


@pytest.mark.parametrize("template", ["vanilla_push", "vanilla_pull",
                                      "coordinated", "bruck", "network_aware"])
def test_skew_programs_match_jax(template):
    """A triggered rebalance's program (the frozen scatter at the global
    exchange) against jaxplan's, alive rows bit for bit."""
    plan, _ = _reference_plan(template, "zipf", SUM, topo=datacenter(4, 2, 1),
                              balance="auto", **SKEWED)
    assert plan.skew is not None and plan.skew.triggered
    _check_case(template, "zipf", SUM, topo=datacenter(4, 2, 1),
                balance="auto", **SKEWED)


def _decline_grid():
    """(name, reference plan) over templates x fabrics x {uniform, skewed},
    plus hand-built plans the registry never makes."""
    fabrics = {"dc421": datacenter(4, 2, 1),
               "dc222": datacenter(2, 2, 2, oversubscription=4.0),
               "dc181": datacenter(1, 8, 1, oversubscription=4.0)}
    plans = []
    for fname, topo in fabrics.items():
        for template in ALL_TEMPLATES:
            for workload, kw in (("uniform", {}), ("skewed", SKEWED)):
                if template == "two_level" and fname != "dc222":
                    continue                  # needs its square sub-grid
                plan, _ = _reference_plan(
                    template, "zipf" if kw else "uniform", SUM, topo=topo,
                    balance="auto", **kw)
                plans.append((f"{fname}-{template}-{workload}", plan))
    skewed = dict(plans)["dc222-vanilla_push-skewed"]
    assert skewed.skew.triggered
    plans.append(("two_level with a skew verdict", dataclasses.replace(
        skewed, template_id="two_level", srcs=skewed.srcs[:4],
        dsts=skewed.dsts[:4])))
    plans.append(("skew aimed at another width", dataclasses.replace(
        skewed, skew=dataclasses.replace(skewed.skew, ndst=4))))
    plans.append(("bruck off its ring", dataclasses.replace(
        dict(plans)["dc222-bruck-uniform"], dsts=tuple(range(4)))))
    return plans


def test_plan_decline_matches_jax():
    seen = set()
    for name, plan in _decline_grid():
        port_plan = convert.plan_from_reference(plan)
        expect = jaxplan.plan_decline(plan)
        assert torchplan.plan_decline(port_plan) == expect, name
        assert (torchplan.lower_plan(port_plan) is None) == (expect is not None)
        seen.add(expect)
    # the grid reaches every skew code and the plain replay
    assert {None, "skew_shape_mismatch", "skew_group_collision",
            "ring_mismatch"} <= seen, seen


# ---------------------------------------------------------------------------
# batched programs
# ---------------------------------------------------------------------------

def _member_bufs(plan, workload, nb, **kw):
    """``nb`` members' inputs on one plan's sources: the same row counts per
    worker, other keys and payloads."""
    ws = list(plan.srcs)
    out = []
    for i in range(nb):
        bufs = make_bufs(ws, workload, seed=100 + i, **kw)
        out.append(bufs)
    return out


@pytest.mark.parametrize("template,skewed", [
    ("vanilla_push", False), ("network_aware", False), ("coordinated", False),
    ("bruck", False), ("two_level", False), ("vanilla_push", True)],
    ids=["vanilla_push", "network_aware", "coordinated", "bruck", "two_level",
         "vanilla_push-skewed"])
def test_batched_program_matches_jax_vmap(template, skewed):
    """Three members laid end to end, the member index the most significant
    sort key: each member's alive rows and flow counts equal jaxplan's
    vmapped program's, member by member."""
    kw = dict(topo=datacenter(4, 2, 1), balance="auto", **SKEWED) \
        if skewed else {}
    plan, _ = _reference_plan(template, "zipf", SUM, **kw)
    assert bool(plan.skew is not None and plan.skew.triggered) == skewed
    port_plan = convert.plan_from_reference(plan)
    jlow, tlow = jaxplan.lower_plan(plan), torchplan.lower_plan(port_plan)
    jspec, tspec = _specs(plan, SUM, ("hash",))
    bkw = {k: v for k, v in SKEWED.items()} if skewed else {}
    members = [_stacked(plan, b, jlow)
               for b in _member_bufs(plan, "zipf", 3, **bkw)]
    keys, vals, owner = (np.stack([m[i] for m in members]) for i in range(3))
    kind, shared = jaxplan._program_inputs(jspec, jlow)
    impl = jaxplan._two_level_impl if kind == "two_level" \
        else jaxplan._replay_impl
    with jax.enable_x64(True):
        tables = [jnp.asarray(a) for a in shared]
        out = jax.jit(jax.vmap(lambda k, v, o: impl(jspec, k, v, o, *tables)))(
            jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(owner))
        j = [np.asarray(a) for a in out]
    nb, n = keys.shape
    member = torch.arange(nb).repeat_interleave(n)
    t = torchplan._run_program(
        tspec, tlow, torch.from_numpy(keys.reshape(-1)),
        torch.from_numpy(vals.reshape(nb * n, -1)),
        torch.from_numpy(owner.reshape(-1).astype(np.int64)), CPU,
        member=member, nb=nb)
    t = [a.numpy() for a in t]
    for i in range(nb):
        blk = slice(i * n, (i + 1) * n)
        jk, jv, jo, ja = (a[i] for a in j[:4])
        tk, tv, to, ta = (a[blk] for a in t[:4])
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tk[ta], jk[ja])
        np.testing.assert_array_equal(to[ta], jo[ja])
        np.testing.assert_array_equal(tv[ta].view(np.int64),
                                      jv[ja].view(np.int64))
        for tc, jc in zip(t[4:], j[4:]):
            np.testing.assert_array_equal(tc[i], jc[i].astype(np.int64))
