"""The port's shuffle service as a whole, against the JAX package's executors.

The port's cluster (``device="cpu"``, ``executor="torch"``) runs each cell as
a fresh instantiation and a cache-hit replay.  Its outputs must be
byte-identical to the JAX package's threaded run (``execution="fresh"``) and
to its vectorized executor, and its ledger stats identical to the reference
run of the same kind (fresh against fresh, hit against the reference's cached
replay).  The grid is the six templates x {uniform, zipf} x {fresh, hit},
plus a combiner sweep over {sum, min, max, concat} x {hash, range}, all with
the kernel plane off (its default on the CPU).  One SUM cell runs with the
kernel plane forced on, at rtol 1e-5.  A triggered skew plan replays on the
torch executor with the reference's bytes and charges, and same-signature
submissions run as one batched dispatch with each member's serial bytes
(``tests/test_torch_batch.py`` holds both across templates).
"""
import numpy as np
import pytest

from conformance import (ALL_TEMPLATES, WORKLOADS, assert_identical,
                         assert_stats_identical, copy_bufs, make_bufs,
                         make_topology, service_for, workers_for)
from repro.core import MAX, MIN, SUM, TeShuService, datacenter, range_part

torch = pytest.importorskip("torch")

import repro_torch.core as port  # noqa: E402
from repro_torch.core import torchplan, vectorized  # noqa: E402

COMBS = {"sum": (SUM, port.SUM), "min": (MIN, port.MIN),
         "max": (MAX, port.MAX), "concat": (None, None)}


def _port_service(**kw):
    kw.setdefault("device", "cpu")
    return port.TeShuService(port.datacenter(2, 2, 2, oversubscription=4.0),
                             **kw)


def _port_part(part_fn):
    if part_fn is None:
        return port.HASH_PART
    return port.range_part(int(part_fn.name[len("range["):-1]))


def _cell(template, workload, comb, part_fn=None, **bufs_kw):
    """(reference fresh, reference vectorized (fresh, hit), port (fresh,
    hit)) for one matrix cell."""
    ref_comb, port_comb = COMBS[comb]
    ws = workers_for(template)
    bufs = make_bufs(ws, workload, **bufs_kw)
    kw = {} if part_fn is None else {"part_fn": part_fn}
    fresh_sv = TeShuService(make_topology(), execution="fresh")
    ref_fresh = fresh_sv.shuffle(template, copy_bufs(bufs), ws, ws,
                                 comb_fn=ref_comb, **kw)
    # the reference replay of a hit: vectorized where it vectorizes, the
    # threaded plan replay (its own fallback) elsewhere
    vec_sv = service_for("vectorized")
    vec = [vec_sv.shuffle(template, copy_bufs(bufs), ws, ws,
                          comb_fn=ref_comb, **kw) for _ in range(2)]
    sv = _port_service()
    pkw = {"part_fn": _port_part(part_fn)}
    got = [sv.shuffle(template, port.msgs_from_reference(bufs), ws, ws,
                      comb_fn=port_comb, **pkw) for _ in range(2)]
    return ref_fresh, vec, got


def _assert_cell(template, workload, comb, part_fn=None):
    ref_fresh, (vec_fresh, vec_hit), (fresh, hit) = _cell(
        template, workload, comb, part_fn)
    assert not fresh.cached and fresh.engine == "threaded"
    assert hit.cached and hit.engine == "torch"
    assert hit.fallback_reason is None and not hit.vectorized
    for got in (fresh, hit):
        assert_identical(got.bufs, ref_fresh.bufs)
        assert_identical(got.bufs, vec_hit.bufs)
        for m in got.bufs.values():
            assert m.keys.dtype == np.int64 and m.vals.dtype == np.float64
    assert_stats_identical(fresh.stats, vec_fresh.stats)
    assert_stats_identical(hit.stats, vec_hit.stats)
    assert hit.observed == vec_hit.observed
    assert [(lv, ec.beneficial) for lv, ec in hit.decisions] == \
        [(lv, ec.beneficial) for lv, ec in vec_hit.decisions]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("template", ALL_TEMPLATES)
def test_port_matrix_byte_identity(template, workload):
    _assert_cell(template, workload, "sum")


@pytest.mark.parametrize("comb", ["min", "max", "concat"])
@pytest.mark.parametrize("template", ALL_TEMPLATES)
def test_port_matrix_combiners(template, comb):
    _assert_cell(template, "zipf", comb)


@pytest.mark.parametrize("comb", ["sum", "min", "max", "concat"])
@pytest.mark.parametrize("template", ["vanilla_push", "coordinated",
                                      "network_aware", "bruck"])
def test_port_matrix_range_part(template, comb):
    _assert_cell(template, "uniform", comb, part_fn=range_part(64))


def test_kernel_plane_cell():
    """The payload plane forced on (plain PART/COMB on the CPU): same keys
    per destination and the same charges; float32-accumulated payloads."""
    ws = workers_for("network_aware")
    bufs = make_bufs(ws, "zipf")
    vec_sv = service_for("vectorized")
    ref = [vec_sv.shuffle("network_aware", copy_bufs(bufs), ws, ws,
                          comb_fn=SUM) for _ in range(2)][1]
    sv = _port_service()
    prev = torchplan.set_kernel_plane(True)
    try:
        hit = [sv.shuffle("network_aware", port.msgs_from_reference(bufs), ws,
                          ws, comb_fn=port.SUM) for _ in range(2)][1]
    finally:
        torchplan.set_kernel_plane(prev)
    assert hit.engine == "torch" and hit.fallback_reason is None
    assert set(hit.bufs) == set(ref.bufs)
    for d in ref.bufs:
        np.testing.assert_array_equal(hit.bufs[d].keys, ref.bufs[d].keys)
        assert hit.bufs[d].vals.dtype == np.float64
        np.testing.assert_allclose(hit.bufs[d].vals, ref.bufs[d].vals,
                                   rtol=1e-5, atol=1e-5)
    assert_stats_identical(hit.stats, ref.stats)


def test_kernel_plane_is_off_on_the_cpu_by_default():
    assert torchplan.kernel_plane_enabled("cpu") is False
    assert torchplan.kernel_plane_enabled("cuda") is True
    prev = torchplan.set_kernel_plane(False)
    try:
        assert torchplan.kernel_plane_enabled("cuda") is False
    finally:
        torchplan.set_kernel_plane(prev)


def test_skew_plan_declines_not_ported():
    """A triggered hot-key rebalance, which earlier slices declined with
    ``"not_ported"``: the torch rung now replays it, with the threaded
    reference's bytes and the vectorized replay's charges."""
    ws = list(range(8))
    bufs = make_bufs(ws, "zipf", n=8000, key_space=500, width=1)
    vec_sv = service_for("vectorized", topo=datacenter(4, 2, 1))
    ref = [vec_sv.shuffle("vanilla_push", copy_bufs(bufs), ws, ws,
                          comb_fn=SUM, balance="auto") for _ in range(2)][1]
    th_sv = service_for("threaded", topo=datacenter(4, 2, 1))
    th = [th_sv.shuffle("vanilla_push", copy_bufs(bufs), ws, ws,
                        comb_fn=SUM, balance="auto") for _ in range(2)][1]
    sv = port.TeShuService(port.datacenter(4, 2, 1), device="cpu")
    hit = [sv.shuffle("vanilla_push", port.msgs_from_reference(bufs), ws, ws,
                      comb_fn=port.SUM, balance="auto") for _ in range(2)][1]
    assert dict(hit.decisions)["rebalance"].triggered
    assert hit.cached and hit.engine == "torch"
    assert hit.fallback_reason is None
    assert_identical(hit.bufs, th.bufs)
    assert_identical(hit.bufs, ref.bufs)
    assert_stats_identical(hit.stats, ref.stats)


def test_batched_submissions_decline_not_ported():
    """Same-signature submissions, which earlier slices declined with
    ``"not_ported"``: they now run as ONE batched dispatch, each member
    with its serial bytes; a lone submission in the same pass replays solo,
    and every slice is consumed."""
    ws = workers_for("vanilla_push")
    bufs = make_bufs(ws, "zipf")
    cl = port.TeShuCluster(port.datacenter(2, 2, 2, oversubscription=4.0),
                           device="cpu")
    tenants = [cl.tenant(f"t{i}") for i in range(4)]
    serial = []
    for t in tenants:
        for _ in range(2):
            r = t.shuffle("vanilla_push", port.msgs_from_reference(bufs), ws,
                          ws, comb_fn=port.SUM)
        serial.append(r)
        assert r.engine == "torch"
    for _ in range(2):                              # a plan of its own
        tenants[3].shuffle("vanilla_pull", port.msgs_from_reference(bufs), ws,
                           ws, comb_fn=port.SUM)
    tickets = [t.submit("vanilla_push", port.msgs_from_reference(bufs), ws,
                        ws, comb_fn=port.SUM) for t in tenants[:3]]
    lone = tenants[3].submit("vanilla_pull", port.msgs_from_reference(bufs),
                             ws, ws, comb_fn=port.SUM)
    results = cl.run_pending()
    (entry,) = cl.last_schedule()["batches"]
    assert entry["size"] == 3 and entry["template"] == "vanilla_push"
    assert entry["tenants"] == ["t0", "t1", "t2"]
    for tk, ref in zip(tickets, serial):
        r = results[tk]
        assert r.engine == "torch" and r.batched
        assert r.fallback_reason is None
        assert_identical(r.bufs, ref.bufs)
    assert results[lone].engine == "torch" and not results[lone].batched
    assert results[lone].fallback_reason is None
    assert not torchplan._BATCH_SLOTS               # every slice consumed
    again = tenants[0].shuffle("vanilla_push", port.msgs_from_reference(bufs),
                               ws, ws, comb_fn=port.SUM)
    assert again.engine == "torch" and not again.batched


def test_cuda_comb_backend_on_cpu_tensors():
    """The opt-in "cuda" combine backend of the vectorized executor, asked
    to run on the CPU (the kernel's plain version): float32 accuracy."""
    ws = workers_for("vanilla_push")
    bufs = make_bufs(ws, "zipf")
    ref_sv = _port_service(executor="vectorized")
    ref = [ref_sv.shuffle("vanilla_push", port.msgs_from_reference(bufs), ws,
                          ws, comb_fn=port.SUM) for _ in range(2)][1]
    prev = vectorized.set_comb_backend("cuda", device="cpu")
    try:
        sv = _port_service(executor="vectorized")
        hit = [sv.shuffle("vanilla_push", port.msgs_from_reference(bufs), ws,
                          ws, comb_fn=port.SUM) for _ in range(2)][1]
    finally:
        vectorized.set_comb_backend(prev)
    assert hit.engine == "vectorized"
    for d in ref.bufs:
        np.testing.assert_array_equal(hit.bufs[d].keys, ref.bufs[d].keys)
        np.testing.assert_allclose(hit.bufs[d].vals, ref.bufs[d].vals,
                                   rtol=1e-5, atol=1e-5)


def test_tracing_records_the_device_replay():
    sv = _port_service(tracing=True)
    ws = workers_for("vanilla_pull")
    bufs = make_bufs(ws, "uniform")
    for _ in range(2):
        res = sv.shuffle("vanilla_pull", port.msgs_from_reference(bufs), ws,
                         ws, comb_fn=port.SUM)
    names = {s["name"] for s in sv.spans(None)}
    assert {"lower", "exec", "device_replay"} <= names
    assert res.engine == "torch"
    fams = sv.metrics()
    assert "teshu_shuffles_total" in fams

