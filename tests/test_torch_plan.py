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


def _reference_plan(template, workload, comb, part_fn=HASH_PART):
    ws = workers_for(template)
    bufs = make_bufs(ws, workload)
    svc = service_for("threaded")
    svc.shuffle(template, {w: m.copy() for w, m in bufs.items()}, ws, ws,
                comb_fn=comb, part_fn=part_fn)
    (_, plan), = svc.plan_cache.scan()
    return plan, bufs


def _specs(plan, comb, part):
    name = comb.name if comb is not None else None
    common = dict(template=plan.template_id, comb=name, part=part,
                  initial_comb=(plan.template_id == "network_aware"
                                and comb is not None),
                  ns=len(plan.srcs), ndst=len(plan.dsts))
    return jaxplan._PlanSpec(skew=False, **common), torchplan._PlanSpec(**common)


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


def _check_case(template, workload, comb, part_fn=HASH_PART):
    plan, bufs = _reference_plan(template, workload, comb, part_fn)
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
    # the converted plan declines on the port with the explicit code
    assert torchplan.plan_decline(port) == torchplan.NOT_PORTED
    msgs = convert.msgs_from_reference(bufs)
    for w, m in bufs.items():
        assert type(msgs[w]) is port_messages.Msgs
        np.testing.assert_array_equal(msgs[w].keys, m.keys)
        np.testing.assert_array_equal(msgs[w].vals, m.vals)
        assert not np.shares_memory(msgs[w].vals, m.vals)
