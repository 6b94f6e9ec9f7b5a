"""Skew-rebalanced hits and batched multi-tenant dispatch on the port's
service, against the JAX package's executors.

Skewed hits: Zipf(1.2) keys over 500 keys with ``balance="auto"`` trigger a
hot-key rebalance.  The port's hit (``device="cpu"``, ``executor="torch"``)
must give the bytes of the JAX package's threaded and vectorized replays and
the vectorized replay's ledger stats.  Where jaxplan declines the plan
(``skew_group_collision`` on a one-rack fabric), the port declines with the
same code and its vectorized rung gives the same bytes.

Batched dispatch restates ``test_batched_dispatch_matches_serial`` and
``test_batch_member_declines_with_its_own_reason`` of ``tests/
test_jaxplan.py`` on the port: four same-signature submissions run as one
batch, each member byte-identical to its serial replay (and to the JAX
package's threaded run), the per-tenant byte lanes equal to serial, the cost
lanes within 1e-9, and the batch's modelled time strictly below four serial
hits'.
"""
import dataclasses
import math

import pytest

from conformance import (WORKERS, assert_identical, assert_stats_identical,
                         copy_bufs, make_bufs, service_for, workers_for)
from repro.core import MAX, MIN, SUM, datacenter, jaxplan

torch = pytest.importorskip("torch")

import repro_torch.core as port  # noqa: E402
from repro_torch.core import torchplan  # noqa: E402

SKEWED = dict(n=8000, key_space=500, width=1)
REBALANCEABLE = ("vanilla_push", "vanilla_pull", "coordinated", "bruck",
                 "network_aware")


def _port_topology(fabric):
    return {"dc421": port.datacenter(4, 2, 1),
            "dc181": port.datacenter(1, 8, 1, oversubscription=4.0)}[fabric]


def _ref_topology(fabric):
    return {"dc421": datacenter(4, 2, 1),
            "dc181": datacenter(1, 8, 1, oversubscription=4.0)}[fabric]


def _skewed_hits(template, fabric):
    """(threaded hit, vectorized hit, its plan, port hit) on one fabric."""
    ws = list(range(8))
    bufs = make_bufs(ws, "zipf", **SKEWED)
    out = []
    for executor in ("threaded", "vectorized"):
        sv = service_for(executor, topo=_ref_topology(fabric))
        out.append([sv.shuffle(template, copy_bufs(bufs), ws, ws,
                               comb_fn=SUM, balance="auto")
                    for _ in range(2)][1])
    (_, plan), = sv.plan_cache.scan()
    sv = port.TeShuService(_port_topology(fabric), device="cpu")
    hit = [sv.shuffle(template, port.msgs_from_reference(bufs), ws, ws,
                      comb_fn=port.SUM, balance="auto") for _ in range(2)][1]
    return out[0], out[1], plan, hit


@pytest.mark.parametrize("fabric,template",
                         [("dc421", t) for t in REBALANCEABLE]
                         + [("dc181", "network_aware")])
def test_skewed_hit_matches_the_reference(fabric, template):
    th, vec, plan, hit = _skewed_hits(template, fabric)
    assert plan.skew is not None and plan.skew.triggered
    assert dict(hit.decisions)["rebalance"].triggered
    assert hit.cached
    code = jaxplan.plan_decline(plan)
    if code is None:
        assert hit.engine == "torch" and hit.fallback_reason is None
    else:                     # the reference's code, then its vectorized rung
        assert hit.engine == "vectorized" and hit.fallback_reason == code
    assert_identical(hit.bufs, th.bufs)
    assert_identical(hit.bufs, vec.bufs)
    assert_stats_identical(hit.stats, vec.stats)
    if fabric == "dc181":
        assert code == "skew_group_collision"        # else the case is vacuous


@pytest.mark.parametrize("comb", ["min", "max"])
def test_skewed_hit_other_combiners(comb):
    ref_comb, port_comb = {"min": (MIN, port.MIN), "max": (MAX, port.MAX)}[comb]
    ws = list(range(8))
    bufs = make_bufs(ws, "zipf", **SKEWED)
    vec_sv = service_for("vectorized", topo=datacenter(4, 2, 1))
    ref = [vec_sv.shuffle("vanilla_push", copy_bufs(bufs), ws, ws,
                          comb_fn=ref_comb, balance="auto")
           for _ in range(2)][1]
    sv = port.TeShuService(port.datacenter(4, 2, 1), device="cpu")
    hit = [sv.shuffle("vanilla_push", port.msgs_from_reference(bufs), ws, ws,
                      comb_fn=port_comb, balance="auto") for _ in range(2)][1]
    assert dict(hit.decisions)["rebalance"].triggered
    assert hit.engine == "torch" and hit.fallback_reason is None
    assert_identical(hit.bufs, ref.bufs)
    assert_stats_identical(hit.stats, ref.stats)


def test_kernel_plane_stays_off_for_a_skewed_hit():
    """The plane routes by the base partFunc and would undo the scatter: a
    skewed SUM hit keeps exact payloads with the plane forced on."""
    th, _, _, _ = _skewed_hits("vanilla_push", "dc421")
    ws = list(range(8))
    bufs = make_bufs(ws, "zipf", **SKEWED)
    sv = port.TeShuService(port.datacenter(4, 2, 1), device="cpu")
    prev = torchplan.set_kernel_plane(True)
    try:
        hit = [sv.shuffle("vanilla_push", port.msgs_from_reference(bufs), ws,
                          ws, comb_fn=port.SUM, balance="auto")
               for _ in range(2)][1]
    finally:
        torchplan.set_kernel_plane(prev)
    assert hit.engine == "torch"
    assert_identical(hit.bufs, th.bufs)


# ---------------------------------------------------------------------------
# batched multi-tenant dispatch
# ---------------------------------------------------------------------------

def _batch_cluster():
    cl = port.TeShuCluster(port.datacenter(2, 2, 2, oversubscription=4.0),
                           device="cpu")
    return cl, [cl.tenant(f"t{i}") for i in range(4)]


@pytest.fixture
def folds(monkeypatch):
    """Counts the replay's calls of the ordered fold (on the CPU its plain
    version runs, which no launch counter sees)."""
    calls = []
    fold = torchplan.kernel_ops.segmented_fold

    def counted(*a, **kw):
        calls.append(1)
        return fold(*a, **kw)
    monkeypatch.setattr(torchplan.kernel_ops, "segmented_fold", counted)
    return calls


def _batch_run(batched, template, ws, bufs, folds, **kw):
    """Four tenants warm a plan each (two serial shuffles), then either
    submit once each into one admission pass or shuffle once each."""
    cl, tenants = _batch_cluster()
    for t in tenants:
        for _ in range(2):
            t.shuffle(template, port.msgs_from_reference(bufs), ws, ws, **kw)
    snap0 = cl.cluster.ledger.snapshot()
    folds0 = len(folds)
    if batched:
        tickets = [t.submit(template, port.msgs_from_reference(bufs), ws, ws,
                            **kw) for t in tenants]
        results = cl.run_pending()
        out = [results[tk] for tk in tickets]
    else:
        out = [t.shuffle(template, port.msgs_from_reference(bufs), ws, ws,
                         **kw) for t in tenants]
    return cl, out, snap0, cl.cluster.ledger.snapshot(), len(folds) - folds0


BATCH_CASES = {
    "vanilla_push": ("vanilla_push", WORKERS, "zipf", {}, {}),
    "vanilla_pull": ("vanilla_pull", WORKERS, "uniform", {}, {}),
    "coordinated": ("coordinated", WORKERS, "zipf", {}, {}),
    "bruck": ("bruck", WORKERS, "zipf", {}, {}),
    "network_aware": ("network_aware", WORKERS, "zipf", {}, {}),
    "two_level (square grid)": ("two_level", workers_for("two_level"), "zipf",
                                {}, {}),
    "vanilla_push, skew-triggered": ("vanilla_push", WORKERS, "zipf",
                                     dict(n=3000, key_space=500, width=1),
                                     dict(balance="auto")),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_batched_dispatch_matches_serial(case, folds):
    """Four same-signature submissions run as ONE batched program: outputs
    byte-identical to serial (and to the JAX package's threaded run), the
    per-tenant byte lanes split exactly as serial (cost lanes to the ulp),
    one program's folds for the whole batch, and the shared epoch makes the
    batch's modelled cost strictly cheaper than four serial hits."""
    template, ws, workload, bkw, kw = BATCH_CASES[case]
    bufs = make_bufs(ws, workload, **bkw)
    kw = dict(comb_fn=port.SUM, **kw)
    _, serial, s0, s1, serial_folds = _batch_run(False, template, ws, bufs,
                                                 folds, **kw)
    clb, batch, b0, b1, batch_folds = _batch_run(True, template, ws, bufs,
                                                 folds, **kw)
    (entry,) = clb.last_schedule()["batches"]
    assert entry["template"] == template and entry["size"] == 4
    th_sv = service_for("threaded")
    ref = [th_sv.shuffle(template, copy_bufs(bufs), ws, ws, comb_fn=SUM,
                         balance=kw.get("balance", "off"))
           for _ in range(2)][1]
    for r_s, r_b in zip(serial, batch):
        assert r_s.engine == "torch" and not r_s.batched
        assert r_b.engine == "torch" and r_b.batched and r_b.cached
        assert r_b.fallback_reason is None
        assert_identical(r_b.bufs, r_s.bufs)
        assert_identical(r_b.bufs, ref.bufs)
        assert r_b.observed == r_s.observed
    if "skew" in case:
        assert all(dict(r.decisions)["rebalance"].triggered for r in batch)
    for lane, exact in (("bytes_per_tenant", True), ("cost_per_tenant", False)):
        ds = {k: s1[lane][k] - s0[lane].get(k, 0) for k in s1[lane]}
        db = {k: b1[lane][k] - b0[lane].get(k, 0) for k in b1[lane]}
        assert set(ds) == set(db)
        for k in ds:
            if exact:
                assert ds[k] == db[k], (lane, k, ds[k], db[k])
            else:                               # running float sum: ulp noise
                assert math.isclose(ds[k], db[k], rel_tol=1e-9,
                                    abs_tol=1e-18), (lane, k, ds[k], db[k])
    assert (b1["modelled_time_s"] - b0["modelled_time_s"]) \
        < (s1["modelled_time_s"] - s0["modelled_time_s"])
    assert batch_folds * 4 == serial_folds > 0  # one program for the batch
    assert not torchplan._BATCH_SLOTS


def test_batch_member_declines_with_its_own_reason():
    """A submission that cannot join the batch (here: a partFunc with no
    tensor form) runs solo and reports its OWN reason code -- not a
    batch-level code, and not another member's."""
    mod = port.PartFn("mod", lambda keys, ndst: keys % ndst)
    cl, tenants = _batch_cluster()
    bufs = make_bufs(WORKERS, "uniform")
    for t in tenants[:3]:
        for _ in range(2):
            t.shuffle("vanilla_push", port.msgs_from_reference(bufs), WORKERS,
                      WORKERS, comb_fn=port.SUM)
    for _ in range(2):
        tenants[3].shuffle("vanilla_push", port.msgs_from_reference(bufs),
                           WORKERS, WORKERS, part_fn=mod, comb_fn=port.SUM)
    tickets = [t.submit("vanilla_push", port.msgs_from_reference(bufs),
                        WORKERS, WORKERS, comb_fn=port.SUM)
               for t in tenants[:3]]
    odd_ticket = tenants[3].submit("vanilla_push",
                                   port.msgs_from_reference(bufs), WORKERS,
                                   WORKERS, part_fn=mod, comb_fn=port.SUM)
    results = cl.run_pending()
    (entry,) = cl.last_schedule()["batches"]
    assert entry["size"] == 3                   # the odd one never joined
    for tk in tickets:
        assert results[tk].engine == "torch" and results[tk].batched
    odd = results[odd_ticket]
    assert odd.engine == "vectorized" and not odd.batched
    assert odd.fallback_reason == "unsupported_part_fn"
    assert not torchplan._BATCH_SLOTS


def test_replanned_member_runs_solo_and_releases_its_slot(monkeypatch):
    """A member whose cached plan is replaced between the batch probe and
    its replay runs solo on its new plan; its slice is abandoned at the end
    of the pass, so the shared epoch barrier still closes exactly once."""
    cl, tenants = _batch_cluster()
    bufs = make_bufs(WORKERS, "zipf")
    kw = dict(comb_fn=port.SUM)
    for t in tenants:
        for _ in range(2):
            serial = t.shuffle("vanilla_push", port.msgs_from_reference(bufs),
                               WORKERS, WORKERS, **kw)
    prepare = torchplan.prepare_batch
    replaced = []

    def prepare_then_replan(cluster, members, *, device):
        handle = prepare(cluster, members, device=device)
        # tenant t3's plan is re-made (a copy under the same key) after the
        # probe: its replay sees another plan than the one the batch ran
        space = cl.plan_cache._spaces["t3"]
        (key, plan), = space.plans.items()
        space.plans[key] = dataclasses.replace(plan)
        replaced.append(key)
        return handle

    monkeypatch.setattr(torchplan, "prepare_batch", prepare_then_replan)
    epochs = []
    advance = cl.cluster.ledger.advance_epoch

    def counted():
        epochs.append(1)
        advance()
    monkeypatch.setattr(cl.cluster.ledger, "advance_epoch", counted)
    tickets = [t.submit("vanilla_push", port.msgs_from_reference(bufs),
                        WORKERS, WORKERS, **kw) for t in tenants]
    results = cl.run_pending()
    assert replaced
    (entry,) = cl.last_schedule()["batches"]
    assert entry["size"] == 4
    out = [results[tk] for tk in tickets]
    for r in out[:3]:
        assert r.engine == "torch" and r.batched
    assert out[3].engine == "torch" and not out[3].batched
    assert out[3].fallback_reason is None
    for r in out:
        assert_identical(r.bufs, serial.bufs)
    assert not torchplan._BATCH_SLOTS           # the stale slice was abandoned
    # the solo replay's own barrier, plus the batch's one shared barrier
    assert len(epochs) == 2
