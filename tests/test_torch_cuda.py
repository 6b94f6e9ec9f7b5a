"""The port on the card: each kernel against its plain version, the
service's replay through the shuffle kernels, and the LM's serving path
through the attention kernels and, for a MoE model, the grouped matmul, for
an xLSTM model the sLSTM recurrence; DeepSeek-V2's latent attention (tensor
ops) against the same module on the CPU.  Every test here is marked
``cuda`` and skips on a host without a CUDA device; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no jax, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest

from conformance import (ALL_TEMPLATES, assert_identical,
                         assert_stats_identical, copy_bufs, make_bufs,
                         service_for, workers_for)
from repro.core import SUM

torch = pytest.importorskip("torch")

import repro_torch.core as port  # noqa: E402
from repro_torch.core import torchplan  # noqa: E402
from repro_torch.kernels._build import (decode_kernel_ran,  # noqa: E402
                                        flash_kernel_ran)
from repro_torch.kernels import SHUFFLE_KERNELS, ref  # noqa: E402
from repro_torch.kernels.combine import segment_combine  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fold import segmented_fold  # noqa: E402
from repro_torch.kernels.gmm import gmm  # noqa: E402
from repro_torch.kernels.partition import partition_permute  # noqa: E402
from repro_torch.kernels.slstm import launch as slstm_launch  # noqa: E402
from repro_torch.kernels.slstm import slstm_scan  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SPECIALS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0])


def _f32(a) -> np.ndarray:
    return a.float().cpu().numpy()


def _slots(rng, n, num_out, kind):
    if kind == "perm":
        return rng.choice(num_out, size=n, replace=False).astype(np.int32)
    return rng.integers(-1, num_out + 3, n).astype(np.int32)


def _port_service(**kw):
    return port.TeShuService(port.datacenter(2, 2, 2, oversubscription=4.0),
                             **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,num_out,kind", [
    (300, 64, 300, "perm"), (128, 100, 520, "perm"), (700, 37, 64, "collide"),
    (100_000, 8, 100_000, "perm"), (100_000, 8, 999, "collide")])
def test_part_kernel_matches_plain(cuda, n, d, num_out, kind, dtype):
    rng = np.random.default_rng(n + d)
    slots = torch.from_numpy(_slots(rng, n, num_out, kind)).to(cuda)
    vals = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                            ).to(TORCH[dtype]).to(cuda)
    before = partition_permute.launches
    got = partition_permute(slots, vals, num_out=num_out,
                            unique_slots=kind == "perm")
    assert partition_permute.launches == before + 1
    plain = ref.partition_permute_ref(slots, vals, num_out=num_out)
    torch.cuda.synchronize()
    if kind == "perm":
        assert torch.equal(got, plain)
    else:
        np.testing.assert_allclose(_f32(got), _f32(plain),
                                   **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,segs,layout", [
    (300, 64, 16, "unsorted"), (1024, 130, 7, "unsorted"),
    (257, 8, 40, "sorted"), (100_000, 8, 3000, "sorted")])
def test_comb_kernel_matches_plain(cuda, n, d, segs, layout, dtype):
    rng = np.random.default_rng(n + segs)
    ids = rng.integers(-1, segs + 2, n).astype(np.int32)
    if layout == "sorted":
        ids = np.sort(rng.integers(0, segs, n)).astype(np.int32)
    vals = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                            ).to(TORCH[dtype]).to(cuda)
    ids = torch.from_numpy(ids).to(cuda)
    got = segment_combine(ids, vals, num_segments=segs)
    plain = ref.segment_combine_ref(ids, vals, num_segments=segs)
    torch.cuda.synchronize()
    tol = dict(TOL[dtype])
    if n > 10_000:       # long float32 sums in two orders
        tol = dict(rtol=1e-4, atol=1e-3) if dtype == "float32" else tol
    np.testing.assert_allclose(_f32(got), _f32(plain), **tol)


# PART with unique slots builds the inverse of the slots and gathers every
# output row; a row that receives nothing is written as zeros.  Before each
# call a freed buffer of NaN lies where the caching allocator places out,
# so a row the kernel skips shows (out gets no memset).  kind: "perm" a
# permutation into num_out >= n slots; "partial" unique slots with -1 and
# >= num_out dropped (every 7th row -1)
PART_GATHER_CASES = {
    "a permutation, n off the gather's 1,024-unit blocks": (100_003, 8,
                                                            100_003, "perm"),
    "partial: num_out > n": (5000, 8, 9000, "partial"),
    "partial: num_out < n": (9000, 8, 5000, "partial"),
    "partial, d 1": (4000, 1, 6000, "partial"),
    "partial, d 5": (4000, 5, 3000, "partial"),
    "partial, d 33": (4000, 33, 6000, "partial"),
    "partial, d 300": (1000, 300, 1500, "partial"),
    "partial, vals one element off 16 bytes": (5000, 8, 9000, "offset"),
}


def _unique_slots(rng, n, num_out, kind):
    if kind == "perm":
        return rng.permutation(n).astype(np.int32)
    s = rng.choice(max(num_out, n) + n // 4, size=n,
                   replace=False).astype(np.int32)
    s[::7] = -1
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PART_GATHER_CASES))
def test_part_gather_is_exact(cuda, case, dtype):
    n, d, num_out, kind = PART_GATHER_CASES[case]
    rng = np.random.default_rng(n + d)
    slots = torch.from_numpy(_unique_slots(rng, n, num_out, kind)).to(cuda)
    host = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                            ).to(TORCH[dtype])
    if kind == "offset":       # the vector path is off
        buf = torch.empty(n * d + 1, dtype=TORCH[dtype], device=cuda)
        vals = buf[1:].view(n, d)
        vals.copy_(host)
        assert vals.data_ptr() % 16 != 0 and vals.is_contiguous()
    else:
        vals = host.to(cuda)
    junk = torch.full((num_out, d), float("nan"), dtype=TORCH[dtype],
                      device=cuda)
    del junk
    got = partition_permute(slots, vals, num_out=num_out, unique_slots=True)
    plain = ref.partition_permute_ref(slots, vals, num_out=num_out)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    hit = torch.zeros(num_out, dtype=torch.bool, device=cuda)
    ok = (slots >= 0) & (slots < num_out)
    hit[slots[ok].long()] = True
    if kind != "perm":
        assert bool((~hit).any()) and int((~ok).sum()) > n // 7
    assert bool((got[~hit] == 0).all())


U32 = 2.0 ** -24


def _comb_bound(ids, vals, segs, dtype):
    """The exact float64 sums and, per element, how far a float32 sum in
    any order may lie from them (len_seg * 2^-24 * sum|v|), plus one bf16
    rounding of the result (2^-8) for a bfloat16 output."""
    v = vals.astype(np.float64)
    ok = (ids >= 0) & (ids < segs)
    i, v = ids[ok], v[ok]
    lens = np.bincount(i, minlength=segs)[:, None]
    cols = range(v.shape[1])
    exact = np.stack([np.bincount(i, v[:, c], minlength=segs) for c in cols],
                     1).reshape(segs, v.shape[1])
    absum = np.stack([np.bincount(i, np.abs(v[:, c]), minlength=segs)
                      for c in cols], 1).reshape(segs, v.shape[1])
    tol = lens * U32 * absum
    if dtype == "bfloat16":
        tol = tol + 2.0 ** -8 * (np.abs(exact) + tol)
    return exact, tol


def _comb_ids(rng, n, share, long):
    """Sorted, compacted ids: a segment starts at each row with probability
    ``share``; no start inside each ``[a, b)`` of ``long``, one at a and
    at b."""
    start = rng.random(n) < share
    for a, b in long:
        start[a:b] = False
        start[a] = True
        start[b:b + 1] = True
    start[:1] = True
    return (np.cumsum(start) - 1).astype(np.int32)


# COMB's layouts: (n, d, the share of random segment starts, long segments
# [a, b) as multiples of the kernel's tile rows R plus rows, the layout).
# "sorted" is the replay's; "unsorted" shuffles the rows and sets every
# 11th id to -1 and every 13th past the last segment (both dropped)
COMB_CASES = {
    "a segment across one tile boundary": (
        3000, 8, 0.1, [((1, -100), (1, 50))], "sorted"),
    "a segment across several tile boundaries": (
        (6, 17), 8, 0.1, [((2, -10), (5, 3))], "sorted"),
    "a 200,000-row segment": (260_000, 8, 0.1, [((0, 1000), (0, 201_000))],
                              "sorted"),
    "unsorted ids with drops": (50_000, 8, 0.1, [], "unsorted"),
    "d 1": (50_000, 1, 0.1, [((1, -30), (3, 30))], "sorted"),
    "d 3": (50_000, 3, 0.1, [((1, -30), (3, 30))], "sorted"),
    "d 4": (50_000, 4, 0.1, [((1, -30), (3, 30))], "sorted"),
    "d 5": (50_000, 5, 0.1, [((1, -30), (3, 30))], "sorted"),
    "d 300": (5000, 300, 0.1, [((2, -5), (5, 3))], "sorted"),
    "d 300, unsorted": (5000, 300, 0.1, [], "unsorted"),
    "vals one element off 16 bytes, d 8": (50_000, 8, 0.1,
                                           [((1, -30), (3, 30))], "offset"),
    "vals one element off 16 bytes, d 5": (50_000, 5, 0.1,
                                           [((1, -30), (3, 30))], "offset"),
    "n = 0": (0, 8, 0.1, [], "sorted"),
    "S = 0 (every id dropped)": (3000, 8, 0.1, [], "none"),
}


def _comb_case(name, dtype, cuda):
    from repro_torch.kernels.combine import tile_rows
    n, d, share, long, layout = COMB_CASES[name]
    rows = tile_rows(d, TORCH[dtype])
    at = (lambda x: x if isinstance(x, int) else x[0] * rows + x[1])
    n = at(n)
    long = [(at(a), at(b)) for a, b in long]
    rng = np.random.default_rng(n + d)
    ids = _comb_ids(rng, n, share, long) if n else np.zeros(0, np.int32)
    segs = int(ids.max()) + 1 if n else 0
    vals = rng.standard_normal((n, d)).astype(np.float32)
    if layout == "unsorted":
        perm = rng.permutation(n)
        ids, vals = ids[perm], vals[perm]
        ids[::11] = -1
        ids[5::13] = segs + 3
    if layout == "none":
        segs = 0
    vals = torch.from_numpy(vals).to(TORCH[dtype])
    vals_np = vals.float().numpy()
    if layout == "offset":
        buf = torch.empty(n * d + 1, dtype=TORCH[dtype], device=cuda)
        v = buf[1:].view(n, d)
        v.copy_(vals)
        assert v.data_ptr() % 16 != 0 and v.is_contiguous()
    else:
        v = vals.to(cuda)
    return torch.from_numpy(ids).to(cuda), v, segs, ids, vals_np, rows, long


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(COMB_CASES))
def test_comb_kernel_within_the_summation_bound(cuda, case, dtype):
    """COMB against the exact float64 sums, each element within the
    float32 summation bound; the long segments cross the tile boundaries
    they are named for."""
    ids, v, segs, ids_np, vals_np, rows, long = _comb_case(case, dtype, cuda)
    for a, b in long:
        assert a // rows < (b - 1) // rows, (a, b, rows)
    if "several" in case:
        assert (long[0][1] - 1) // rows - long[0][0] // rows >= 3
    before = segment_combine.launches
    got = segment_combine(ids, v, num_segments=segs)
    assert segment_combine.launches == before + 1
    torch.cuda.synchronize()
    assert got.shape == (segs, v.shape[1]) and got.dtype == TORCH[dtype]
    exact, tol = _comb_bound(ids_np, vals_np, segs, dtype)
    err = np.abs(got.double().cpu().numpy() - exact)
    assert (err <= tol).all(), float((err / np.maximum(tol, 1e-30)).max())


@pytest.mark.cuda
def test_comb_kernel_on_two_streams_at_once(cuda):
    """COMB launched on two streams of one device at once, each with its
    stream's own tile counter: every result within the bound, both
    counters left zeroed."""
    from repro_torch.kernels import fold as fold_mod
    cases = ["a 200,000-row segment", "unsorted ids with drops"]
    inputs = [_comb_case(c, "float32", cuda) for c in cases]
    bounds = [_comb_bound(x[3], x[4], x[2], "float32") for x in inputs]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    got = []
    for _ in range(4):
        for i, st in enumerate(streams):
            ids, v, segs = inputs[i][:3]
            with torch.cuda.stream(st):
                got.append((i, segment_combine(ids, v, num_segments=segs)))
    torch.cuda.synchronize()
    for i, g in got:
        exact, tol = bounds[i]
        assert (np.abs(g.double().cpu().numpy() - exact) <= tol).all(), i
    counters = [fold_mod._stream_state(cuda, st.cuda_stream)[0]
                for st in streams]
    assert [c.tolist() for c in counters] == [[0, 0], [0, 0]]


# the fold's layouts: (n, d, the start rows, the share of random starts,
# long segments [a, b) with no start inside).  At d 8 a tile is 512 rows, at
# d 5 800, at d 1 1,024, at d 33 96; a width above 256 is cut into chunks
FOLD_CASES = {
    "random starts, d 5": (50_000, 5, [], 0.05, []),
    "a segment across one tile boundary": (3000, 8, [400, 700, 1500], 0.0,
                                           []),
    # a tile's last segment that ends at most 64 rows into the next tile is
    # folded in the tile's own stage; one row more takes a stage of its own
    "a segment that ends 64 rows into the next tile": (
        3000, 8, [100, 576, 1200], 0.0, []),
    "a segment that ends 65 rows into the next tile": (
        3000, 8, [100, 577, 1200], 0.0, []),
    "one segment over many tiles and stages": (
        260_000, 8, [1000], 0.02, [(1000, 201_000)]),
    "starts at a tile's first and last rows": (
        2048, 8, [100, 511, 512, 1023, 1024, 1535, 1536, 2047], 0.0, []),
    "n off the tile": (512 * 7 + 37, 8, [3000], 0.01, [(3000, 3621)]),
    "n = 1": (1, 8, [], 0.0, []),
    "d 1": (20_000, 1, [5000], 0.02, [(5000, 12_000)]),
    "d 5": (20_000, 5, [5000], 0.02, [(5000, 12_000)]),
    "d 8": (20_000, 8, [5000], 0.02, [(5000, 12_000)]),
    "d 33": (20_000, 33, [5000], 0.02, [(5000, 12_000)]),
    "d 300 (column chunks)": (3000, 300, [500], 0.02, [(500, 2200)]),
    "every row a start": (5000, 8, [], 1.0, []),
    "no start but row 0": (30_000, 5, [], 0.0, []),
    "vals and is_start 8 and 1 bytes off their allocations": (
        10_001, 5, [4000], 0.03, [(4000, 9000)]),
}


def _fold_case(name):
    n, d, starts, share, long = FOLD_CASES[name]
    rng = np.random.default_rng(17)
    vals = rng.standard_normal((n, d))
    mask = rng.random((n, d)) < 0.05
    is_start = rng.random(n) < share
    for a, b in long:       # specials only near the end of a long segment,
        is_start[a:b] = False           # so that most of it stays finite
        mask[a:max(a, b - 2000)] = False
    is_start[starts] = True
    vals[mask] = rng.choice(SPECIALS, int(mask.sum()))
    return is_start, vals


def _same_bits(got, plain):
    """Bit-identical; a NaN matches any NaN (IEEE leaves the payload of an
    arithmetic NaN unspecified, and torch's elementwise kernels and this
    one may produce different ones)."""
    return (got.view(torch.int64) == plain.view(torch.int64)) \
        | (got.isnan() & plain.isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FOLD_CASES))
@pytest.mark.parametrize("comb", ["sum", "min", "max"])
def test_fold_kernel_is_bit_identical(cuda, comb, case):
    is_start, vals = _fold_case(case)
    n, d = vals.shape
    if case.startswith("vals and is_start"):
        vbuf = torch.empty(n * d + 1, dtype=torch.float64, device=cuda)
        sbuf = torch.empty(n + 1, dtype=torch.bool, device=cuda)
        v = vbuf[1:].view(n, d)
        s = sbuf[1:]
        v.copy_(torch.from_numpy(vals))
        s.copy_(torch.from_numpy(is_start))
        assert v.data_ptr() % 16 == 8 and v.is_contiguous()
    else:
        v = torch.from_numpy(vals).to(cuda)
        s = torch.from_numpy(is_start).to(cuda)
    before = segmented_fold.launches
    got = segmented_fold(comb, s, v)
    assert segmented_fold.launches == before + 1
    # the plain version on a CPU copy: its loop takes one step per row of
    # the longest segment, which the card would take far longer over
    plain = ref.segmented_fold_ref(comb, s.cpu(), v.cpu())
    torch.cuda.synchronize()
    same = _same_bits(got.cpu(), plain)
    assert bool(same.all()), int((~same).sum())


@pytest.mark.cuda
def test_fold_kernel_leaves_its_tile_counter_zeroed(cuda):
    """Every launch hands the next one a zeroed tile counter: launches back
    to back on one stream give the plain version's bits each time.  (That a
    call is one device kernel is read from a profiler trace by
    chip_smoke.py.)"""
    from repro_torch.kernels import fold as fold_mod
    is_start, vals = _fold_case("one segment over many tiles and stages")
    v = torch.from_numpy(vals).to(cuda)
    s = torch.from_numpy(is_start).to(cuda)
    counter, _ = fold_mod._stream_state(
        v.device, torch.cuda.current_stream(v.device).cuda_stream)
    got = [segmented_fold(op, s, v) for op in ("max", "sum", "max")]
    torch.cuda.synchronize()
    assert counter.tolist() == [0, 0]
    plain = {op: ref.segmented_fold_ref(op, s.cpu(), v.cpu())
             for op in ("max", "sum")}
    for op, g in zip(("max", "sum", "max"), got):
        assert bool(_same_bits(g.cpu(), plain[op]).all()), op


@pytest.mark.cuda
def test_fold_kernel_on_two_streams_at_once(cuda):
    """Folds launched on two streams of one device run at the same time,
    each with its stream's own tile counter: every result keeps the plain
    version's bits, and both counters are left zeroed."""
    from repro_torch.kernels import fold as fold_mod
    is_start, vals = _fold_case("one segment over many tiles and stages")
    v = torch.from_numpy(vals).to(cuda)
    s = torch.from_numpy(is_start).to(cuda)
    plain = {op: ref.segmented_fold_ref(op, s.cpu(), v.cpu())
             for op in ("sum", "max")}
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    got = []
    for _ in range(4):      # each launch takes about a millisecond
        for st, op in zip(streams, ("sum", "max")):
            with torch.cuda.stream(st):
                got.append((op, segmented_fold(op, s, v)))
    torch.cuda.synchronize()
    for i, (op, g) in enumerate(got):
        same = _same_bits(g.cpu(), plain[op])
        assert bool(same.all()), (i, op, int((~same).sum()))
    counters = [fold_mod._stream_state(cuda, st.cuda_stream)[0]
                for st in streams]
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert [c.tolist() for c in counters] == [[0, 0], [0, 0]]


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        partition_permute(torch.zeros(4, dtype=torch.int64, device=cuda),
                          torch.ones((4, 2), device=cuda), num_out=4)
    with pytest.raises(TypeError):
        segment_combine(torch.zeros(4, dtype=torch.int32, device=cuda),
                        torch.ones((4, 2), dtype=torch.float64, device=cuda),
                        num_segments=1)
    with pytest.raises(ValueError):     # a row wider than COMB's stage
        segment_combine(torch.zeros(4, dtype=torch.int32, device=cuda),
                        torch.ones((4, 20_000), device=cuda), num_segments=1)
    with pytest.raises(ValueError):
        segmented_fold("sum", torch.ones(4, dtype=torch.bool, device=cuda),
                       torch.ones((2, 4), dtype=torch.float64,
                                  device=cuda).t())


@pytest.mark.cuda
@pytest.mark.parametrize("template", ALL_TEMPLATES)
def test_card_replay_is_byte_identical(cuda, template):
    """On the card with the kernel plane off: the exact plane's bytes and
    charges, through the fold kernel."""
    ws = workers_for(template)
    bufs = make_bufs(ws, "zipf")
    vec_sv = service_for("vectorized")
    ref = [vec_sv.shuffle(template, copy_bufs(bufs), ws, ws, comb_fn=SUM)
           for _ in range(2)][1]
    sv = _port_service(device="cuda")
    prev = torchplan.set_kernel_plane(False)
    try:
        hit = [sv.shuffle(template, port.msgs_from_reference(bufs), ws, ws,
                          comb_fn=port.SUM) for _ in range(2)][1]
    finally:
        torchplan.set_kernel_plane(prev)
    assert hit.engine == "torch" and hit.fallback_reason is None
    assert_identical(hit.bufs, ref.bufs)
    assert_stats_identical(hit.stats, ref.stats)


@pytest.mark.cuda
def test_card_kernel_plane_is_on_by_default(cuda):
    ws = workers_for("network_aware")
    bufs = make_bufs(ws, "zipf")
    vec_sv = service_for("vectorized")
    ref = [vec_sv.shuffle("network_aware", copy_bufs(bufs), ws, ws,
                          comb_fn=SUM) for _ in range(2)][1]
    sv = _port_service(device="cuda")
    sv.shuffle("network_aware", port.msgs_from_reference(bufs), ws, ws,
               comb_fn=port.SUM)
    before = [k.launches for k in SHUFFLE_KERNELS]
    hit = sv.shuffle("network_aware", port.msgs_from_reference(bufs), ws, ws,
                     comb_fn=port.SUM)
    assert all(k.launches > b for k, b in zip(SHUFFLE_KERNELS, before))
    assert hit.engine == "torch"
    for d in ref.bufs:
        np.testing.assert_array_equal(hit.bufs[d].keys, ref.bufs[d].keys)
        np.testing.assert_allclose(hit.bufs[d].vals, ref.bufs[d].vals,
                                   rtol=1e-5, atol=1e-5)


def _skewed_hit(device):
    ws = list(range(8))
    bufs = make_bufs(ws, "zipf", n=8000, key_space=500, width=1)
    sv = port.TeShuService(port.datacenter(4, 2, 1), device=device)
    return [sv.shuffle("vanilla_push", port.msgs_from_reference(bufs), ws, ws,
                       comb_fn=port.SUM, balance="auto") for _ in range(2)][1]


@pytest.mark.cuda
def test_card_skewed_hit_matches_the_cpu(cuda):
    """A triggered hot-key rebalance on the card (the frozen scatter, the
    fold kernel, the owner merge): the CPU replay's bytes and charges."""
    prev = torchplan.set_kernel_plane(False)
    try:
        before = segmented_fold.launches
        hit = _skewed_hit("cuda")
        assert segmented_fold.launches > before
        cpu = _skewed_hit("cpu")
    finally:
        torchplan.set_kernel_plane(prev)
    assert dict(hit.decisions)["rebalance"].triggered
    assert hit.engine == "torch" and hit.fallback_reason is None
    assert_identical(hit.bufs, cpu.bufs)
    assert_stats_identical(hit.stats, cpu.stats)


def _batched_pass(device):
    ws = workers_for("network_aware")
    bufs = make_bufs(ws, "zipf")
    cl = port.TeShuCluster(port.datacenter(2, 2, 2, oversubscription=4.0),
                           device=device)
    tenants = [cl.tenant(f"t{i}") for i in range(4)]
    for t in tenants:
        for _ in range(2):
            t.shuffle("network_aware", port.msgs_from_reference(bufs), ws, ws,
                      comb_fn=port.SUM)
    tickets = [t.submit("network_aware", port.msgs_from_reference(bufs), ws,
                        ws, comb_fn=port.SUM) for t in tenants]
    results = cl.run_pending()
    return cl, [results[tk] for tk in tickets]


@pytest.mark.cuda
def test_card_batched_pass_matches_the_cpu(cuda):
    """Four tenants' same-signature submissions as one batched program on
    the card: each member's bytes and charges as on the CPU."""
    prev = torchplan.set_kernel_plane(False)
    try:
        before = segmented_fold.launches
        cl, got = _batched_pass("cuda")
        assert segmented_fold.launches > before
        _, cpu = _batched_pass("cpu")
    finally:
        torchplan.set_kernel_plane(prev)
    (entry,) = cl.last_schedule()["batches"]
    assert entry["size"] == 4
    for r, c in zip(got, cpu):
        assert r.engine == "torch" and r.batched and r.fallback_reason is None
        assert_identical(r.bufs, c.bufs)
        assert_stats_identical(r.stats, c.stats)
    assert not torchplan._BATCH_SLOTS


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

def _attn_close(got, plain, tol):
    """float32 math on both sides, in other orders: float32 outputs agree
    to rounding; a bfloat16 output holds each element within its own bound
    of the plain value (``ref.attention_tolerance``: one bf16 rounding on
    each side, plus the flash kernel's rounding of P to bf16 where it takes
    the tensor cores)."""
    g, p = got.float().cpu(), plain.float().cpu()
    if got.dtype == torch.float32:
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5, atol=1e-5)
    else:
        share = ((g - p).abs() / tol.float().cpu()).max()
        assert float(share) <= 1.0, f"{float(share)} of the bound"


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype).to(dev)


# q_scale 4 gives scores of std 4 (a sharp softmax), where S rounded to
# bf16 would move the output far past the bound
@pytest.mark.cuda
@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("bfloat16", "bfloat16"),
                                      ("float32", "bfloat16")])
@pytest.mark.parametrize("bhq,bhkv,sq,skv,d,causal", [
    (4, 4, 64, 64, 16, True), (8, 4, 100, 100, 32, True),
    (8, 2, 37, 150, 64, True), (6, 1, 130, 130, 128, True),
    (4, 2, 77, 200, 128, False), (2, 2, 1, 65, 64, True),
    # the wgmma kernel's edges (bf16 at D 64 and 128; 128-row tiles):
    (3, 3, 192, 192, 64, True),       # group 1, on the 64 tile, off 128
    (10, 2, 200, 333, 128, True),     # group 5, off both, q_offset 133
    (32, 2, 100, 300, 64, True),      # group 16, q_offset 200
    (32, 2, 256, 320, 128, True),     # group 16, q_offset 64
    (5, 1, 1, 300, 128, True),        # one query row
    (5, 1, 130, 260, 64, False),      # non-causal, Skv > Sq
    (4, 2, 300, 130, 128, False)])    # non-causal, Sq > Skv
def test_flash_kernel_matches_plain(cuda, bhq, bhkv, sq, skv, d, causal,
                                    qdt, kvdt, q_scale):
    rng = np.random.default_rng(bhq * sq + skv + d)
    q = _randn(rng, (bhq, sq, d), TORCH[qdt], cuda) * q_scale
    k = _randn(rng, (bhkv, skv, d), TORCH[kvdt], cuda)
    v = _randn(rng, (bhkv, skv, d), TORCH[kvdt], cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    _attn_close(got, plain, ref.flash_attention_tolerance(q, k, v, plain,
                                                          causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("bfloat16", "bfloat16"),
                                      ("float32", "bfloat16")])
@pytest.mark.parametrize("b,h,kvh,t,d,valid", [
    (2, 4, 4, 64, 16, 1), (2, 8, 2, 300, 32, 150), (3, 5, 1, 129, 64, 129),
    (4, 40, 8, 2048, 128, 1056), (1, 48, 1, 700, 128, 513),
    (2, 4, 2, 5000, 128, 4999),
    # decode_tma's shapes (bf16): MoE (g 16), MQA (g 48), d 64 MHA (g 1),
    # g 24 at d 64 (two row groups), a tail inside the last tile
    (4, 64, 4, 2048, 128, 1056), (3, 48, 1, 300, 128, 300),
    (4, 32, 32, 2048, 64, 1056), (2, 24, 1, 1000, 64, 999),
    (1, 8, 1, 4100, 128, 4097),
    # 132 pairs fill the card: one split each, 60-64 tiles a block
    (33, 20, 4, 4096, 128, 3900), (33, 64, 4, 4096, 64, 4096)])
def test_decode_kernel_matches_plain(cuda, b, h, kvh, t, d, valid, qdt, kvdt,
                                     q_scale):
    rng = np.random.default_rng(b * h + t + valid)
    q = _randn(rng, (b, h, d), TORCH[qdt], cuda) * q_scale
    k = _randn(rng, (b, t, kvh, d), TORCH[kvdt], cuda)
    v = _randn(rng, (b, t, kvh, d), TORCH[kvdt], cuda)
    k[:, valid:] = float("nan")          # an unwritten tail must not leak
    v[:, valid:] = float("nan")
    before = decode_attention.launches
    got = decode_attention(q, k, v, valid)
    assert decode_attention.launches == before + 1
    plain = ref.decode_attention_ref(q, k[:, :valid], v[:, :valid], valid)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    kv = (k[:, :valid], v[:, :valid])
    _attn_close(got, plain,
                ref.decode_attention_tolerance(q, *kv, valid, plain))


def _decode_case(rng, b, h, kvh, t, d, valid, dev):
    """bf16 q and cache with a NaN tail past ``valid``, and the plain
    version's output and tolerance on the valid positions."""
    bf16 = torch.bfloat16
    q = _randn(rng, (b, h, d), bf16, dev)
    k, v = (_randn(rng, (b, t, kvh, d), bf16, dev) for _ in range(2))
    k[:, valid:] = float("nan")
    v[:, valid:] = float("nan")
    kv = (k[:, :valid], v[:, :valid])
    plain = ref.decode_attention_ref(q, *kv, valid)
    return q, k, v, plain, ref.decode_attention_tolerance(q, *kv, valid, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,t,d,valid", [
    (4, 40, 8, 2048, 128, 1056), (4, 64, 4, 2048, 128, 1056),
    (4, 32, 32, 2048, 64, 1056), (3, 48, 1, 300, 128, 1)])
def test_decode_valid_len_on_the_device(cuda, b, h, kvh, t, d, valid):
    """A 0-dim int32 valid_len on the card gives the int path's output bit
    for bit, and one launch."""
    rng = np.random.default_rng(41 + d + valid)
    q, k, v, plain, tol = _decode_case(rng, b, h, kvh, t, d, valid, cuda)
    got = decode_attention(q, k, v, valid)
    before = decode_attention.launches
    dev = decode_attention(q, k, v, torch.tensor(valid, dtype=torch.int32,
                                                 device=cuda))
    assert decode_attention.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(dev.view(torch.int16), got.view(torch.int16))
    _attn_close(got, plain, tol)


@pytest.mark.cuda
def test_decode_back_to_back_launches_reset_the_counters(cuda):
    """Launches on one cache with other lengths, one after another: each
    merges its own splits (the last block of a pair resets its counter)."""
    rng = np.random.default_rng(43)
    bf16 = torch.bfloat16
    q = _randn(rng, (4, 40, 128), bf16, cuda)
    k, v = (_randn(rng, (4, 2048, 8, 128), bf16, cuda) for _ in range(2))
    outs = {}
    for valid in (1056, 700, 2048, 1056, 65, 700):
        outs.setdefault(valid, []).append(decode_attention(q, k, v, valid))
    torch.cuda.synchronize()
    for valid, got in outs.items():
        kv = (k[:, :valid], v[:, :valid])
        plain = ref.decode_attention_ref(q, *kv, valid)
        _attn_close(got[0], plain,
                    ref.decode_attention_tolerance(q, *kv, valid, plain))
        for again in got[1:]:
            assert torch.equal(again.view(torch.int16), got[0].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,kvh,t,d,valid,window", [
    (4, 40, 8, 2048, 128, 1056, 0), (4, 25, 5, 4160, 64, 4128, 1024),
    (3, 48, 1, 300, 128, 1, 0), (2, 24, 1, 1000, 64, 999, 37),
    (33, 20, 4, 4096, 128, 3900, 0), (4, 64, 4, 2048, 128, 130, 70)])
def test_decode_lse_route_matches_plain(cuda, b, h, kvh, t, d, valid, window,
                                        qdt):
    """``return_lse=True`` on both kernels (bf16 q: ``decode_tma``, one or
    several splits; float32 q: ``decode_split``): one launch, the float32
    output within ``1e-5 (1 + |plain|)`` of the plain version's and the
    log-sum-exp within ``ref.lse_tolerance``; the cache's NaN tail is not
    read."""
    import math
    rng = np.random.default_rng(b + h + valid + window)
    q = _randn(rng, (b, h, d), TORCH[qdt], cuda)
    k, v = (_randn(rng, (b, t, kvh, d), torch.bfloat16, cuda)
            for _ in range(2))
    k[:, valid:] = float("nan")
    v[:, valid:] = float("nan")
    before = decode_attention.launches
    out, lse = decode_attention(q, k, v, valid, window=window,
                                return_lse=True)
    assert decode_attention.launches == before + 1
    kv = (k[:, :valid], v[:, :valid])
    p_out, p_lse = ref.decode_attention_ref(q, *kv, valid, window=window,
                                            return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (b, h)
    _attn_close(out, p_out, ref.decode_attention_tolerance(
        q, *kv, valid, p_out, window=window))
    tol = ref.lse_tolerance(p_lse, min(valid, window) if window else valid, d)
    assert bool(((lse - p_lse).abs() <= tol).all())
    assert not bool(((lse / math.log(2) - p_lse).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 300])
def test_decode_blocks_merged_match_one_launch(cuda, window):
    """A cache cut into the 16 blocks of ``T`` that model 16 gives its
    ranks: each block on the log-sum-exp route (``block_window``; the
    blocks past ``valid_len`` or left of the window return zeros and
    ``-inf`` with no launch), merged by ``merge_blocks``, within
    ``ref.attention_tolerance`` of one whole launch."""
    from repro_torch.kernels.decode_attention import (block_window,
                                                      merge_blocks)
    rng = np.random.default_rng(53 + window)
    b, h, kvh, t, d, valid = 4, 40, 8, 2048, 128, 1056
    q = _randn(rng, (b, h, d), torch.bfloat16, cuda)
    k, v = (_randn(rng, (b, t, kvh, d), torch.bfloat16, cuda)
            for _ in range(2))
    n = t // 16
    outs, lses, before = [], [], decode_attention.launches
    plan = [block_window(valid, i * n, n, window) for i in range(16)]
    for i, (v_r, w_r) in enumerate(plan):
        o, lse = decode_attention(q, k[:, i * n:(i + 1) * n].contiguous(),
                                  v[:, i * n:(i + 1) * n].contiguous(), v_r,
                                  window=w_r, return_lse=True)
        outs.append(o)
        lses.append(lse)
    assert decode_attention.launches - before == sum(r > 0 for r, _ in plan)
    got = merge_blocks(torch.stack(outs), torch.stack(lses))
    whole = decode_attention(q, k, v, valid, window=window)
    a = ref.decode_attention_ref(q.float(), k, v.abs(), valid, window=window)
    share = ((got - whole.float()).abs()
             / ref.attention_tolerance(whole, a)).max()
    assert float(share) <= 1.0, f"{float(share)} of the bound"


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [0, -3, 2049])
def test_decode_valid_len_outside_the_cache_gives_nan(cuda, bad):
    """A device valid_len outside [1, T] is not clamped: every row is NaN,
    and the next launch is right."""
    rng = np.random.default_rng(47)
    q, k, v, plain, tol = _decode_case(rng, 4, 40, 8, 2048, 128, 1056, cuda)
    got = decode_attention(q, k, v, torch.tensor(bad, dtype=torch.int32,
                                                 device=cuda))
    torch.cuda.synchronize()
    assert bool(torch.isnan(got).all())
    _attn_close(decode_attention(q, k, v, 1056), plain, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,qdt,kvdt,h,kvh,kernels", [
    (128, "bfloat16", "bfloat16", 40, 8, ("decode_tma",)),
    (64, "bfloat16", "bfloat16", 8, 8, ("decode_tma",)),
    (128, "bfloat16", "bfloat16", 48, 1, ("decode_tma",)),
    (128, "float32", "bfloat16", 40, 8, ("decode_split", "decode_combine")),
    (32, "bfloat16", "bfloat16", 40, 8, ("decode_split", "decode_combine"))])
def test_decode_kernel_is_chosen_by_dtype_and_width(cuda, d, qdt, kvdt, h,
                                                    kvh, kernels):
    """bf16 at d 64 and 128 runs decode_tma, one device kernel a call;
    anything else decode_split and decode_combine (with several splits)."""
    rng = np.random.default_rng(d + h)
    q = _randn(rng, (4, h, d), TORCH[qdt], cuda)
    k, v = (_randn(rng, (4, 2048, kvh, d), TORCH[kvdt], cuda) for _ in range(2))
    decode_attention(q, k, v, 1056)      # the buffers exist before the trace
    assert decode_kernel_ran(lambda: decode_attention(q, k, v, 1056)) == kernels


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["flash: last kv tile dropped",
                                   "decode: last split dropped"])
def test_attention_check_rejects_planted_faults(cuda, fault):
    """The bound of ``_attn_close`` fails a kernel that skips work: the
    kernel itself, called on the inputs without their last tile (flash) or
    last split (decode: positions 1024..1055 of the serving shape)."""
    rng = np.random.default_rng(23)
    bf16 = torch.bfloat16
    if fault.startswith("flash"):
        q = _randn(rng, (8, 200, 128), bf16, cuda)
        k, v = (_randn(rng, (2, 256, 128), bf16, cuda) for _ in range(2))
        plain = ref.flash_attention_ref(q, k, v, causal=False)
        tol = ref.flash_attention_tolerance(q, k, v, plain, causal=False)
        got = flash_attention(q, k[:, :-64].contiguous(),
                              v[:, :-64].contiguous(), causal=False)
    else:
        q = _randn(rng, (4, 40, 128), bf16, cuda)
        k, v = (_randn(rng, (4, 2048, 8, 128), bf16, cuda) for _ in range(2))
        plain = ref.decode_attention_ref(q, k, v, 1056)
        tol = ref.decode_attention_tolerance(q, k, v, 1056, plain)
        got = decode_attention(q, k, v, 1024)
    with pytest.raises(AssertionError, match="of the bound"):
        _attn_close(got, plain, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,qdt,kvdt,kernel", [
    (128, "bfloat16", "bfloat16", "flash_wgmma"),
    (64, "bfloat16", "bfloat16", "flash_wgmma"),
    (32, "bfloat16", "bfloat16", "flash_mma"),
    (16, "bfloat16", "bfloat16", "flash_mma"),
    (128, "float32", "bfloat16", "flash_fwd"),
    (64, "bfloat16", "float32", "flash_fwd")])
def test_flash_kernel_is_chosen_by_dtype_and_width(cuda, d, qdt, kvdt,
                                                   kernel):
    rng = np.random.default_rng(d)
    q = _randn(rng, (4, 130, d), TORCH[qdt], cuda)
    k, v = (_randn(rng, (2, 200, d), TORCH[kvdt], cuda) for _ in range(2))
    assert flash_kernel_ran(lambda: flash_attention(q, k, v)) == kernel


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_check_rejects_dropped_tile(cuda, d):
    """On the wgmma kernel: the right call holds the bound, and the same
    call on k and v without their last 64 rows (half its last 128-row
    tile) fails it."""
    rng = np.random.default_rng(29 + d)
    bf16 = torch.bfloat16
    q = _randn(rng, (10, 300, d), bf16, cuda)
    k, v = (_randn(rng, (2, 512, d), bf16, cuda) for _ in range(2))
    plain = ref.flash_attention_ref(q, k, v, causal=False)
    tol = ref.flash_attention_tolerance(q, k, v, plain, causal=False)
    _attn_close(flash_attention(q, k, v, causal=False), plain, tol)
    cut = flash_attention(q, k[:, :-64].contiguous(), v[:, :-64].contiguous(),
                          causal=False)
    with pytest.raises(AssertionError, match="of the bound"):
        _attn_close(cut, plain, tol)


# sliding windows: every flash kernel (flash_fwd for a float32 operand,
# flash_mma at D 16 / 32, flash_wgmma at D 64 / 128) at windows on and off
# its tiles (64 rows; 128 for wgmma), of one row, and at least Skv
@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [("bfloat16", "bfloat16"),
                                      ("float32", "bfloat16")])
@pytest.mark.parametrize("window", [1, 63, 64, 65, 127, 128, 129, 200, 1000])
@pytest.mark.parametrize("bhq,bhkv,sq,skv,d,causal", [
    (10, 2, 300, 300, 64, True),      # Hymba's group 5, off the tiles
    (10, 2, 200, 520, 64, True),      # an appended prefill (q_offset 320)
    (4, 4, 256, 256, 128, True),      # on the 128 tile
    (8, 4, 190, 190, 32, True),       # flash_mma
    (4, 2, 130, 300, 16, True),       # flash_mma, q_offset 170
    (5, 1, 130, 260, 64, False)])     # non-causal: the lower edge only
def test_flash_window_kernel_matches_plain(cuda, bhq, bhkv, sq, skv, d,
                                           causal, window, qdt, kvdt):
    rng = np.random.default_rng(bhq * sq + skv + d + window)
    q = _randn(rng, (bhq, sq, d), TORCH[qdt], cuda)
    k = _randn(rng, (bhkv, skv, d), TORCH[kvdt], cuda)
    v = _randn(rng, (bhkv, skv, d), TORCH[kvdt], cuda)
    got = flash_attention(q, k, v, causal=causal, window=window)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _attn_close(got, plain, ref.flash_attention_tolerance(
        q, k, v, plain, causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("d,qdt", [(64, "bfloat16"), (128, "bfloat16"),
                                   (32, "bfloat16"), (64, "float32")])
def test_flash_window_of_skv_or_more_is_no_window(cuda, d, qdt):
    """A window at least Skv masks nothing: the output equals the
    unwindowed call's bit for bit, on each kernel."""
    rng = np.random.default_rng(53 + d)
    q = _randn(rng, (10, 333, d), TORCH[qdt], cuda)
    k, v = (_randn(rng, (2, 400, d), torch.bfloat16, cuda) for _ in range(2))
    want = flash_attention(q, k, v)
    for window in (400, 401, 1 << 20):
        assert torch.equal(flash_attention(q, k, v, window=window), want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 32])
def test_flash_window_one_tile_wider_fails_the_check(cuda, d):
    """The kernel run with the window one tile (128 rows) wider than the
    plain version's falls outside the bound."""
    rng = np.random.default_rng(59 + d)
    bf16 = torch.bfloat16
    q = _randn(rng, (10, 1024, d), bf16, cuda)
    k, v = (_randn(rng, (2, 1024, d), bf16, cuda) for _ in range(2))
    plain = ref.flash_attention_ref(q, k, v, window=256)
    tol = ref.flash_attention_tolerance(q, k, v, plain, window=256)
    _attn_close(flash_attention(q, k, v, window=256), plain, tol)
    with pytest.raises(AssertionError, match="of the bound"):
        _attn_close(flash_attention(q, k, v, window=256 + 128), plain, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("window", [1, 2, 63, 64, 65, 128, 1000, 1024, 4000])
@pytest.mark.parametrize("b,h,kvh,t,d,valid", [
    (4, 25, 5, 4160, 64, 4128),       # Hymba's step
    (2, 40, 8, 2048, 128, 1056),
    (3, 8, 1, 300, 128, 300),
    (2, 4, 2, 700, 32, 513)])         # decode_split whatever the dtype
def test_decode_window_kernel_matches_plain(cuda, b, h, kvh, t, d, valid,
                                            window, qdt):
    """decode_tma (bf16 at d 64 / 128) and decode_split with a window: the
    cache left of the window is NaN, so a position read there shows."""
    rng = np.random.default_rng(b * h + t + valid + window)
    bf16 = torch.bfloat16
    q = _randn(rng, (b, h, d), TORCH[qdt], cuda)
    k, v = (_randn(rng, (b, t, kvh, d), bf16, cuda) for _ in range(2))
    lo = max(0, valid - window)
    for x in (k, v):
        x[:, valid:] = float("nan")
        x[:, :lo] = float("nan")
    got = decode_attention(q, k, v, valid, window=window)
    kv = (k[:, lo:valid], v[:, lo:valid])
    plain = ref.decode_attention_ref(q, *kv, valid - lo)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _attn_close(got, plain, ref.decode_attention_tolerance(
        q, *kv, valid - lo, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("valid,window", [
    (4128, 1024), (4160, 1024), (1100, 1024), (65, 1), (4128, 4128),
    (3000, 5000), (64, 64)])
def test_decode_window_follows_the_split_plan(cuda, valid, window):
    """Hymba's step shape at windows whose first tile the plan
    (``split_plan``) cuts at other places: the mirror covers ``[valid -
    window, valid)`` once, the kernel matches the plain version, and a
    ``valid_len`` on the device gives the int's output bit for bit."""
    from repro_torch.kernels.decode_attention import _sm_count, split_plan
    b, h, kvh, t, d = 4, 25, 5, 4160, 64
    grid, runs = split_plan(b * kvh, valid, t, _sm_count(0), window)
    lo = max(0, valid - window)
    assert runs[0][0] == lo and runs[-1][1] == valid
    assert all(a[1] == c[0] and a[0] < a[1] for a, c in zip(runs, runs[1:]))
    assert len(runs) <= grid
    rng = np.random.default_rng(valid + window)
    bf16 = torch.bfloat16
    q = _randn(rng, (b, h, d), bf16, cuda)
    k, v = (_randn(rng, (b, t, kvh, d), bf16, cuda) for _ in range(2))
    got = decode_attention(q, k, v, valid, window=window)
    on_dev = decode_attention(q, k, v, torch.tensor(
        valid, dtype=torch.int32, device=cuda), window=window)
    plain = ref.decode_attention_ref(q, k, v, valid, window=window)
    torch.cuda.synchronize()
    assert torch.equal(on_dev.view(torch.int16), got.view(torch.int16))
    _attn_close(got, plain, ref.decode_attention_tolerance(
        q, k, v, valid, plain, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 32])
def test_decode_window_one_tile_wider_fails_the_check(cuda, d):
    """At Hymba's step (d 64: decode_tma; d 32: decode_split), the kernel
    with the window one 64-position tile wider than the plain version's
    falls outside the bound."""
    rng = np.random.default_rng(61)
    bf16 = torch.bfloat16
    q = _randn(rng, (4, 25, d), bf16, cuda)
    k, v = (_randn(rng, (4, 4160, 5, d), bf16, cuda) for _ in range(2))
    plain = ref.decode_attention_ref(q, k, v, 4128, window=1024)
    tol = ref.decode_attention_tolerance(q, k, v, 4128, plain, window=1024)
    _attn_close(decode_attention(q, k, v, 4128, window=1024), plain, tol)
    with pytest.raises(AssertionError, match="of the bound"):
        _attn_close(decode_attention(q, k, v, 4128, window=1024 + 64),
                    plain, tol)


@pytest.mark.cuda
def test_attention_wrappers_refuse_what_they_do_not_take(cuda):
    q = torch.ones((2, 8, 24), device=cuda)
    with pytest.raises(ValueError):            # head width not compiled
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q.half()[..., :16].contiguous(),
                        q[..., :16].contiguous(), q[..., :16].contiguous())
    with pytest.raises(ValueError):            # not contiguous
        flash_attention(q[..., :16], q[..., :16], q[..., :16])
    c = torch.ones((2, 8, 1, 16), device=cuda)
    with pytest.raises(ValueError):            # valid_len past the cache
        decode_attention(torch.ones((2, 2, 16), device=cuda), c, c, 9)
    with pytest.raises(TypeError):
        decode_attention(torch.ones((2, 2, 16), device=cuda), c.double(),
                         c.double(), 3)


@pytest.mark.cuda
def test_card_smoke_serve_matches_plain(cuda):
    """The qwen2.5-14b smoke config served on the card through the kernels,
    against the same run on their plain versions (teacher-forced on the
    kernel run's tokens): exact launch counts, the same first tokens, and
    logits within float32 rounding (the smoke config computes in float32
    over a bfloat16 cache)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cfg = get_config("qwen2.5-14b", smoke=True)
    params = lm.init_lm(cfg, seed=0, device=cuda)
    kw = dict(batch=3, prompt_len=70, gen_len=6, max_len=128, device=cuda,
              params=params)
    for k in KERNELS:
        k.launches = 0
    gen, stats = serve("qwen2.5-14b", **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    assert counts == {"partition_permute": 0, "segment_combine": 0,
                      "segmented_fold": 0, "flash_attention": cfg.n_layers,
                      "decode_attention": cfg.n_layers * 6, "gmm": 0,
                      "slstm_scan": 0}
    plain_gen, plain = serve("qwen2.5-14b", use_kernel=False, forced=gen, **kw)
    assert all(k.launches == counts[k.__name__] for k in KERNELS)
    np.testing.assert_array_equal(plain_gen[:, 0], gen[:, 0])
    for a, b in zip(stats.logits, plain.logits):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


def _embeds_run(params, embeds, gen_len, max_len, use_kernel, forced=None):
    """A prefill of ``embeds`` into a fresh cache, then ``gen_len`` greedy
    steps from tokens (``forced [B, gen_len]``'s where given): the tokens
    (numpy) and every step's last-position logits."""
    from repro_torch.models import lm
    dev = embeds.device
    cache = lm.init_cache(params.cfg, embeds.shape[0], max_len, device=dev)
    logits, cache, _ = lm.forward(params, embeds=embeds, cache=cache,
                                  use_kernel=use_kernel)
    out, toks = [logits[:, -1]], []
    for i in range(gen_len):
        toks.append(out[-1].argmax(-1)[:, None].to(torch.int32))
        step = toks[-1] if forced is None else \
            torch.from_numpy(forced[:, i:i + 1]).to(dev)
        logits, cache = lm.serve_step(params, cache, tokens=step,
                                      use_kernel=use_kernel)
        out.append(logits[:, -1])
    return torch.cat(toks, dim=1).cpu().numpy(), out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-34b", "pixtral-12b",
                                  "musicgen-large", "llama3-405b",
                                  "qwen1.5-110b"])
def test_card_smoke_dense_serve_matches_plain(cuda, arch):
    """The other dense smoke configs (Granite's MQA and GELU MLP, Qwen1.5's
    biases) served on the card as qwen2.5-14b is above; Pixtral and
    MusicGen also from their stub frontends' embeddings (a prefill into a
    fresh cache, then greedy steps from tokens), with the same counts and
    bounds."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve import serve
    from repro_torch.models import frontends, lm

    cfg = get_config(arch, smoke=True)
    params = lm.init_lm(cfg, seed=0, device=cuda)
    kw = dict(batch=3, prompt_len=70, gen_len=6, max_len=128, device=cuda,
              params=params)

    def served(use_kernel, forced=None):
        gen, stats = serve(arch, use_kernel=use_kernel, forced=forced, **kw)
        return gen, stats.logits
    runs = [served]
    if cfg.modality != "text":
        gen = torch.Generator(device=cuda).manual_seed(0)
        if cfg.modality == "vlm":
            front = frontends.init_patch_frontend(gen, cfg, 48)
            embeds = frontends.patch_embed(front, torch.randn(
                (3, 70, 48), generator=gen, device=cuda))
        else:
            front = frontends.init_frame_frontend(gen, cfg, 4)
            embeds = frontends.frame_embed(front, torch.randint(
                0, cfg.vocab, (3, 70, 4), generator=gen, device=cuda))
        runs.append(lambda use_kernel, forced=None: _embeds_run(
            params, embeds, 6, 128, use_kernel, forced))
    for run in runs:
        for k in KERNELS:
            k.launches = 0
        with torch.no_grad():
            gen_tok, logits = run(True)
        counts = {k.__name__: k.launches for k in KERNELS}
        assert counts == {"partition_permute": 0, "segment_combine": 0,
                          "segmented_fold": 0,
                          "flash_attention": cfg.n_layers,
                          "decode_attention": cfg.n_layers * 6, "gmm": 0,
                          "slstm_scan": 0}
        with torch.no_grad():
            plain_tok, plain = run(False, gen_tok)
        assert all(k.launches == counts[k.__name__] for k in KERNELS)
        np.testing.assert_array_equal(plain_tok[:, 0], gen_tok[:, 0])
        for a, b in zip(logits, plain):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the grouped matmul
# ---------------------------------------------------------------------------

def _gmm_share(got, plain, tol) -> float:
    """Largest share of ``ref.gmm_tolerance`` used; where the bound is 0
    (a zero row of x) the kernel must give exactly 0."""
    diff = (got.float() - plain.float()).abs()
    assert bool((diff[tol == 0] == 0).all())
    return float((diff / tol.clamp_min(1e-38)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups,tiles,d,f,block_n,kind", [
    # block_n a multiple of 128: the bf16 kernel's compute path
    (4, 8, 128, 256, 128, "random"), (4, 12, 640, 384, 128, "capacity layout"),
    (4, 6, 1416, 1536, 128, "shuffled"), (3, 8, 520, 1416, 256, "shuffled"),
    # any other: the swapped path, 16, 32 or 64 tokens a block
    (5, 12, 64, 48, 16, "shuffled"), (6, 9, 96, 40, 32, "gaps"),
    (3, 5, 1024, 136, 64, "shuffled"), (5, 10, 1416, 264, 48, "shuffled"),
    (8, 16, 256, 1536, 16, "capacity layout")])
def test_gmm_kernel_matches_plain(cuda, groups, tiles, d, f, block_n, kind,
                                  dtype):
    """Both bf16 paths (and the float32 kernel) against the plain version:
    repeated and shuffled ids, groups with no tile, d off the 64-deep
    stage (1416, 520) and f off the 128- and 256-column blocks, each
    element within ``ref.gmm_tolerance``."""
    rng = np.random.default_rng(groups * tiles + d + f)
    x = _randn(rng, (tiles * block_n, d), TORCH[dtype], cuda)
    w = _randn(rng, (groups, d, f), TORCH[dtype], cuda) / d ** 0.5
    if kind == "capacity layout":      # the MoE path: experts in order
        ids = np.repeat(np.arange(groups), tiles // groups)
        x[block_n // 2:block_n] = 0    # a half-empty tile, as padding
    elif kind == "shuffled":
        ids = rng.permutation(np.concatenate([
            np.arange(groups), rng.integers(0, groups, tiles - groups)]))
    elif kind == "gaps":               # only the odd groups
        ids = 2 * rng.integers(0, groups // 2, tiles) + 1
    else:
        ids = rng.integers(0, groups, tiles)
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    before = gmm.launches
    got = gmm(x, w, ids, block_n=block_n)
    assert gmm.launches == before + 1
    plain = ref.gmm_ref(x, w, ids, block_n=block_n)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (tiles * block_n, f)
    tol = ref.gmm_tolerance(x, w, ids, plain, block_n=block_n)
    assert _gmm_share(got, plain, tol) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["prefill (block_n 128)",
                                   "decode (block_n 16)",
                                   "block_n 64"])
@pytest.mark.parametrize("fault", ["one tile reads the next expert",
                                   "reduction drops its last 512 of d"])
def test_gmm_check_rejects_planted_faults(cuda, fault, shape):
    """The kernel itself, given the next expert's id for one tile or the
    inputs without their last 512 columns of d, falls outside the bound
    by more than 10x, on the compute path (the prefill's layout: 3 tiles
    an expert) and on the swapped one."""
    rng = np.random.default_rng(29)
    bf16 = torch.bfloat16
    g, d = 4, 2048
    tiles, f, bn = {"prefill (block_n 128)": (12, 512, 128),
                    "decode (block_n 16)": (4, 1536, 16),
                    "block_n 64": (8, 256, 64)}[shape]
    x = _randn(rng, (tiles * bn, d), bf16, cuda)
    w = _randn(rng, (g, d, f), bf16, cuda) / d ** 0.5
    ids = torch.arange(tiles, dtype=torch.int32, device=cuda) * g // tiles
    plain = ref.gmm_ref(x, w, ids, block_n=bn)
    tol = ref.gmm_tolerance(x, w, ids, plain, block_n=bn)
    if fault.startswith("one tile"):
        bad = ids.clone()
        bad[3] = (bad[3] + 1) % g
        got = gmm(x, w, bad, block_n=bn)
    else:
        got = gmm(x[:, :-512].contiguous(), w[:, :-512].contiguous(), ids,
                  block_n=bn)
    torch.cuda.synchronize()
    assert _gmm_share(got, plain, tol) > 10.0


@pytest.mark.cuda
def test_gmm_wrapper_refuses_what_it_does_not_take(cuda):
    x = torch.ones((32, 12), dtype=torch.bfloat16, device=cuda)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm(x, torch.ones((1, 12, 8), dtype=torch.bfloat16, device=cuda),
            ids, block_n=16)
    with pytest.raises(TypeError):
        gmm(x, torch.ones((1, 12, 8), device=cuda), ids, block_n=16)
    with pytest.raises(ValueError):                 # not contiguous
        gmm(torch.ones((32, 16), device=cuda)[:, :8],
            torch.ones((1, 8, 8), device=cuda), ids, block_n=16)
    # an id out of range: NaN rows, not a read past w
    got = gmm(torch.ones((32, 8), device=cuda),
              torch.ones((1, 8, 8), device=cuda),
              torch.tensor([0, 1], dtype=torch.int32, device=cuda), block_n=16)
    assert bool(got[:16].eq(8).all()) and bool(got[16:].isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
def test_card_smoke_moe_serve_matches_plain(cuda, arch):
    """A MoE smoke config served on the card, every routed and shared expert
    made distinct: each MoE layer launches gmm three times per expert stack
    in the prefill and in each decode step, the attention kernels run only
    for GQA (DeepSeek-V2's MLA and its dense layer 0 launch none), and the
    run agrees with the plain versions' (teacher-forced) to float32
    rounding."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cfg = get_config(arch, smoke=True)
    params = lm.init_lm(cfg, seed=0, device=cuda)
    moe_layers = [b.moe for b in params.blocks if hasattr(b, "moe")]
    stacks = [st for m in moe_layers for st in (m.experts, m.shared)
              if st is not None]
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for stack in stacks:
            for w in (stack.w_gate, stack.w_up, stack.w_down):
                w.copy_(torch.randn(w.shape, generator=gen, device=cuda)
                        / w.shape[1] ** 0.5)
    kw = dict(batch=3, prompt_len=70, gen_len=6, max_len=128, device=cuda,
              params=params)
    for k in KERNELS:
        k.launches = 0
    got, stats = serve(arch, **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    gqa = 0 if cfg.mla is not None else cfg.n_layers
    assert counts == {**{k.__name__: 0 for k in KERNELS},
                      "flash_attention": gqa, "decode_attention": gqa * 6,
                      "gmm": 3 * len(stacks) * 7}
    plain_gen, plain = serve(arch, use_kernel=False, forced=got, **kw)
    assert all(k.launches == counts[k.__name__] for k in KERNELS)
    np.testing.assert_array_equal(plain_gen[:, 0], got[:, 0])
    for a, b in zip(stats.logits, plain.logits):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_mla_matches_the_cpu(cuda, dtype):
    """The SMOKE MLA module on the card against the same module on the CPU:
    without a cache, a prefill into a cache and two decode steps (the
    absorbed form).  float32 without a cache to 2e-5; through the bf16
    cache to 2e-3 (a float32 difference in the last bit can flip one
    rounding of the latent); bf16 to 2e-2, as the attention cases."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("deepseek-v2-236b", smoke=True),
                              dtype=dtype)
    host = layers.MLA(cfg, device="cpu",
                      gen=torch.Generator().manual_seed(0))
    card = layers.MLA(cfg, device=cuda)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 33, cfg.d_model)).astype(
        np.float32)).to(TORCH[dtype])
    pos = torch.arange(33).expand(2, 33)
    tol, cached = TOL[dtype], TOL[dtype] if dtype == "bfloat16" else \
        dict(rtol=2e-3, atol=2e-3)
    want, _ = host(x, pos)
    got, _ = card(x.to(cuda), pos.to(cuda))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    hc = layers.init_mla_cache(cfg, 2, 48, device="cpu")
    cc = layers.init_mla_cache(cfg, 2, 48, device=cuda)
    for sl in (slice(0, 31), slice(31, 32), slice(32, 33)):
        want, _ = host(x[:, sl], pos[:, sl], cache=hc)
        got, _ = card(x[:, sl].to(cuda), pos[:, sl].to(cuda), cache=cc)
        np.testing.assert_allclose(_f32(got), _f32(want), **cached)
    assert cc["len"] == hc["len"] == 33
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(_f32(cc[name]), _f32(hc[name]),
                                   rtol=2 ** -7, atol=2 ** -7)


# ---------------------------------------------------------------------------
# the sLSTM recurrence
# ---------------------------------------------------------------------------

def _slstm_inputs(b, s, d, dtype, dev, seed=0):
    """xw ~ N(0, 1), w_rec at the model's scale 0.02, a bias of scale 0.3
    (so that every rounding of the pre-activation is exercised) and a
    random state (n in [1, 3))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = TORCH[dtype]

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(t)
    st = {"c": 0.5 * torch.randn((b, d), generator=gen, device=dev),
          "n": 1 + 2 * torch.rand((b, d), generator=gen, device=dev),
          "h": 0.3 * torch.randn((b, d), generator=gen, device=dev),
          "m": torch.randn((b, d), generator=gen, device=dev) - 1}
    return randn(b, s, 4 * d), randn(d, 4 * d, scale=0.02), \
        randn(4 * d, scale=0.3), st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 1024])
@pytest.mark.parametrize("s", [1, 37, 4096])
@pytest.mark.parametrize("b", [1, 8])
def test_slstm_kernel_matches_plain(cuda, b, s, d, dtype):
    """Every element of hs and of the final state within
    ``ref.slstm_tolerance`` of the plain scan; one launch; the state given
    is left as it was.  S up to 4,096 at B 1 and 8: a missing or misplaced
    barrier between steps shows as a wrong h read by some block."""
    xw, w, bias, st = _slstm_inputs(b, s, d, dtype, cuda, seed=b + s + d)
    before = {k: v.clone() for k, v in st.items()}
    n = slstm_scan.launches
    hs, fin = slstm_scan(xw, w, bias, st)
    assert slstm_scan.launches == n + 1
    plain, pfin = ref.slstm_scan_ref(xw, w, bias, st)
    tol, tol_st = ref.slstm_tolerance(xw, w, bias, st)
    torch.cuda.synchronize()
    assert hs.shape == (b, s, d) and hs.dtype == torch.float32
    assert bool(torch.isfinite(hs).all())
    worst = float(((hs - plain).abs() / tol).max())
    assert worst <= 1.0, f"hs off by {worst} of the bound"
    for k in ref.SLSTM_STATE:
        assert bool(((fin[k] - pfin[k]).abs() <= tol_st[k]).all()), k
        assert torch.equal(st[k], before[k])


@pytest.mark.cuda
def test_slstm_kernel_fails_the_check_without_its_product(cuda):
    """The check's planted fault: the plain scan with the recurrent
    product left out of step S/2 falls outside the bound by 10x or more
    at the served shape (B 4, S 4,096, d 1,024, bf16)."""
    xw, w, bias, st = _slstm_inputs(4, 4096, 1024, "bfloat16", cuda)
    hs, _ = slstm_scan(xw, w, bias, st)
    bad, _ = ref.slstm_scan_ref(xw, w, bias, st, drop_rec_at=2048)
    tol, _ = ref.slstm_tolerance(xw, w, bias, st)
    assert float(((hs - bad).abs() / tol).max()) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("s, state", [(1, "random"), (4096, "zero"),
                                      (4096, "random")])
def test_slstm_kernel_fails_the_check_with_a_bfloat16_sum(cuda, s, state):
    """The check's lower-precision control: the plain scan with the
    recurrent product summed in bf16 (``bf16_sum``) falls outside the bound
    by 10x or more at the served width (B 4, d 1,024, bf16), at the
    prefill's length and at a decode step (from a zero state step 0's
    product is 0 in both, so a decode step starts from a random one); the
    kernel meets it."""
    xw, w, bias, st = _slstm_inputs(4, s, 1024, "bfloat16", cuda)
    if state == "zero":
        st = {k: torch.zeros_like(v) for k, v in st.items()}
        st["m"].fill_(-1e30)
    hs, _ = slstm_scan(xw, w, bias, st)
    plain, _ = ref.slstm_scan_ref(xw, w, bias, st)
    bad, _ = ref.slstm_scan_ref(xw, w, bias, st, bf16_sum=True)
    tol, _ = ref.slstm_tolerance(xw, w, bias, st)
    assert float(((hs - plain).abs() / tol).max()) <= 1.0
    assert float(((hs - bad).abs() / tol).max()) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("units", [8, 16])
@pytest.mark.parametrize("s", [1, 4096])
def test_slstm_kernel_matches_plain_at_units(cuda, s, units):
    """The tensor-core path at 8 and 16 units a block (128 and 64 blocks)
    at the served width (B 4, d 1,024, bf16): every element of hs and of
    the final state within ``ref.slstm_tolerance``."""
    from repro_torch.kernels import _build
    xw, w, bias, st = _slstm_inputs(4, s, 1024, "bfloat16", cuda, seed=units)
    hs, fin = slstm_launch(_build.library("slstm"), xw, w, bias, st, units)
    plain, pfin = ref.slstm_scan_ref(xw, w, bias, st)
    tol, tol_st = ref.slstm_tolerance(xw, w, bias, st)
    torch.cuda.synchronize()
    worst = float(((hs - plain).abs() / tol).max())
    assert worst <= 1.0, f"hs off by {worst} of the bound"
    for k in ref.SLSTM_STATE:
        assert bool(((fin[k] - pfin[k]).abs() <= tol_st[k]).all()), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_training_loop_graphed_is_the_loop(cuda, dtype, monkeypatch):
    """The sLSTM recurrence under autograd (``ref._SLSTMScan``) at the
    served width (B 4, d 1,024) over 600 steps, its blocks of 128 captured
    and replayed as CUDA graphs (``ref._blocks``), against the same blocks
    run as they are on the card: ``hs``, the final state and every
    gradient bit for bit; each call replays its graph for the blocks after
    the first (three forward, three backward; a tail of 88 steps run as
    it is)."""
    xw, w, bias, st = _slstm_inputs(4, 600, 1024, dtype, cuda, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    weights = [torch.randn((4, 600, 1024), generator=gen, device=cuda)] + [
        torch.randn((4, 1024), generator=gen, device=cuda)
        for _ in ref.SLSTM_STATE]
    replays = []
    real_replay = torch.cuda.CUDAGraph.replay

    def counted(self):
        replays.append(1)
        return real_replay(self)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)

    def run():
        ins = [x.clone().requires_grad_(True) for x in (xw, w, bias)] + [
            st[k].clone().requires_grad_(True) for k in ref.SLSTM_STATE]
        hs, fin = ref.slstm_scan_ref(*ins[:3], dict(zip(ref.SLSTM_STATE,
                                                         ins[3:])))
        loss = (hs * weights[0]).sum() + sum(
            (fin[k] * x).sum() for k, x in zip(ref.SLSTM_STATE, weights[1:]))
        return [hs, *fin.values(), *torch.autograd.grad(loss, ins)]
    graphed = run()
    assert len(replays) == 6, len(replays)

    def eager(fn, statics, n, load, store):
        for i in range(n):
            load(i)
            store(i, fn())
    monkeypatch.setattr(ref, "_blocks", eager)
    plain = run()
    torch.cuda.synchronize()
    assert len(replays) == 6
    for got, want in zip(graphed, plain):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_kernel_two_calls_are_bit_identical(cuda, dtype):
    """The sum's order is fixed (each warp's k-steps in order, then the
    warps' partial sums in order), so two calls on the same inputs give
    the same bits, hs and state."""
    d = 1024 if dtype == "bfloat16" else 64
    xw, w, bias, st = _slstm_inputs(4, 512, d, dtype, cuda, seed=3)
    hs, fin = slstm_scan(xw, w, bias, st)
    hs2, fin2 = slstm_scan(xw, w, bias, st)
    assert torch.equal(hs, hs2)
    assert all(torch.equal(fin[k], fin2[k]) for k in ref.SLSTM_STATE)


@pytest.mark.cuda
def test_slstm_kernel_one_thousand_decode_calls_on_one_flag_buffer(cuda):
    """1,000 decode steps in a row (S 1 and S 2 calls, alternating, on one
    stream's flags), each from the last one's state and each held against
    the plain step from the same state: a flag left by an earlier call that
    showed a step of a later one would let a block read h before it was
    written."""
    xw, w, bias, st = _slstm_inputs(4, 2, 1024, "bfloat16", cuda, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    worst = 0.0
    for i in range(1000):
        x = (torch.randn(xw[:, :1 + i % 2].shape, generator=gen,
                         device=cuda)).bfloat16()
        hs, fin = slstm_scan(x, w, bias, st)
        plain, _ = ref.slstm_scan_ref(x, w, bias, st)
        tol, _ = ref.slstm_tolerance(x, w, bias, st)
        worst = max(worst, float(((hs - plain).abs() / tol).max()))
        st = fin
    assert worst <= 1.0, f"a decode call off by {worst} of the bound"


@pytest.mark.cuda
def test_slstm_grid_that_cannot_be_resident_raises(cuda):
    """4,096 blocks of one unit each cannot all be resident at once: the
    launcher raises before launching."""
    from repro_torch.kernels import _build
    xw, w, bias, st = _slstm_inputs(1, 2, 4096, "bfloat16", cuda)
    with pytest.raises(RuntimeError, match="co-resident"):
        slstm_launch(_build.library("slstm"), xw, w, bias, st, 1)


@pytest.mark.cuda
def test_slstm_kernel_refuses_what_it_does_not_take(cuda):
    xw, w, bias, st = _slstm_inputs(9, 3, 64, "float32", cuda)
    with pytest.raises(ValueError, match="B <= 8"):
        slstm_scan(xw, w, bias, st)
    xw, w, bias, st = _slstm_inputs(2, 3, 60, "float32", cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        slstm_scan(xw, w, bias, st)
    xw, w, bias, st = _slstm_inputs(2, 3, 64, "float32", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        slstm_scan(xw.transpose(0, 1).contiguous().transpose(0, 1), w, bias,
                   st)
    with pytest.raises(TypeError):
        slstm_scan(xw.double(), w.double(), bias.double(), st)
    from repro_torch.kernels import _build
    with pytest.raises(RuntimeError, match="CUDA error"):  # 3 does not divide d
        slstm_launch(_build.library("slstm"), xw, w, bias, st, 3)


@pytest.mark.cuda
def test_card_smoke_xlstm_serve_matches_plain(cuda):
    """The xlstm-350m smoke config (an mLSTM and an sLSTM block) served on
    the card: the sLSTM kernel launches once in the prefill and once a
    decode step, and the run agrees with the plain versions'
    (teacher-forced) to float32 rounding."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cfg = get_config("xlstm-350m", smoke=True)
    params = lm.init_lm(cfg, seed=0, device=cuda)
    kw = dict(batch=3, prompt_len=70, gen_len=6, max_len=128, device=cuda,
              params=params)
    for k in KERNELS:
        k.launches = 0
    gen, stats = serve("xlstm-350m", **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    n_slstm = sum(lm.is_slstm(cfg, i) for i in range(cfg.n_layers))
    assert counts == {**{k.__name__: 0 for k in KERNELS},
                      "slstm_scan": n_slstm * 7}
    plain_gen, plain = serve("xlstm-350m", use_kernel=False, forced=gen, **kw)
    assert all(k.launches == counts[k.__name__] for k in KERNELS)
    np.testing.assert_array_equal(plain_gen[:, 0], gen[:, 0])
    for a, b in zip(stats.logits, plain.logits):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: no kernel under autograd, the SMOKE run against the CPU's
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "gmm", "slstm_scan"])
def test_lm_kernel_wrappers_raise_under_autograd(cuda, kernel):
    """A kernel has no backward: a launch that autograd would record raises
    (naming the kernel), and counts nothing; under no_grad it launches."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).bfloat16()
    if kernel == "flash_attention":
        args = (randn(8, 64, 64), randn(4, 64, 64), randn(4, 64, 64))
        fn, kw = flash_attention, {}
    elif kernel == "decode_attention":
        args = (randn(2, 8, 64), randn(2, 64, 4, 64), randn(2, 64, 4, 64), 64)
        fn, kw = decode_attention, {}
    elif kernel == "gmm":
        args = (randn(256, 64), randn(2, 64, 32),
                torch.tensor([0, 1], dtype=torch.int32, device=cuda))
        fn, kw = gmm, {"block_n": 128}
    else:
        state = {k: torch.zeros((2, 64), device=cuda) for k in ref.SLSTM_STATE}
        args = (randn(2, 5, 256), randn(64, 256), randn(256), state)
        fn, kw = slstm_scan, {}
    first = args[0].clone().requires_grad_(True)
    before = getattr(fn, "launches", 0)
    with pytest.raises(RuntimeError, match=kernel):
        fn(first, *args[1:], **kw)
    assert getattr(fn, "launches", 0) == before
    with torch.no_grad():
        fn(first, *args[1:], **kw)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_micro", [1, 2])
def test_card_smoke_train_matches_the_cpu(cuda, n_micro):
    """The SMOKE ``train()`` on the card against the same run on the CPU:
    the same initial weights, data and steps (float32; TF32 off), no kernel
    launched.  The moments are held as the CPU run holds them to the JAX
    package's (m within 1e-4 and v within 2e-4 of the tensor's largest),
    and each tensor's displacement from the initial weights to the CPU
    run's: ``1 - cos`` within 1e-3 and the norm ratio within 1e-2 of 1 per
    tensor, 1e-5 and 1e-4 over all tensors together (a run that skipped
    an update, or took it with the wrong sign, misses by far)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import LM_KERNELS, MOE_KERNELS
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cpu", cuda):
            model = lm.init_lm(get_config("qwen2.5-14b", smoke=True), seed=5,
                               device="cpu").to(dev)
            before = [k.launches for k in LM_KERNELS + MOE_KERNELS]
            runs[str(dev)] = train("qwen2.5-14b", steps=4, global_batch=4,
                                   seq_len=32, n_micro=n_micro, device=dev,
                                   params=model)
            assert [k.launches for k in LM_KERNELS + MOE_KERNELS] == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cpu, card = runs["cpu"], runs[str(cuda)]
    for a, b in zip(cpu["history"], card["history"]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-5)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-4)
    for k, rel in (("m", 1e-4), ("v", 2e-4)):
        for n, w in cpu["opt_state"][k].items():
            t = card["opt_state"][k][n].cpu()
            assert float((t - w).abs().max()) <= rel * float(
                w.abs().max()) + 1e-12, (k, n)
    start = {n: p.detach() for n, p in lm.init_lm(
        get_config("qwen2.5-14b", smoke=True), seed=5,
        device="cpu").named_parameters()}
    worst = [0.0, 0.0]
    dot = na2 = nb2 = 0.0
    for (n, p), (_, q) in zip(cpu["params"].named_parameters(),
                              card["params"].named_parameters()):
        a = (q.detach().cpu() - start[n]).double().flatten()
        b = (p.detach() - start[n]).double().flatten()
        ab, na, nb = float(a @ b), float(a.norm()), float(b.norm())
        dot, na2, nb2 = dot + ab, na2 + na * na, nb2 + nb * nb
        assert na > 0 and nb > 0, n
        worst = [max(worst[0], 1 - ab / (na * nb)),
                 max(worst[1], abs(na / nb - 1))]
    assert worst[0] <= 1e-3 and worst[1] <= 1e-2, worst
    assert 1 - dot / (na2 * nb2) ** 0.5 <= 1e-5, (dot, na2, nb2)
    assert abs((na2 / nb2) ** 0.5 - 1) <= 1e-4, (na2, nb2)
    assert dataclasses.asdict(card["params"].cfg) == dataclasses.asdict(
        cpu["params"].cfg)


@pytest.mark.cuda
def test_card_restart_from_checkpoint_equals_uninterrupted_run(cuda, tmp_path):
    import shutil
    from repro_torch.launch.train import train
    kw = dict(smoke=True, steps=6, global_batch=4, seq_len=16, n_micro=2,
              ckpt_every=3, device=cuda, seed=3)
    full = train("qwen2.5-14b", ckpt_dir=str(tmp_path / "a"), **kw)
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    resumed = train("qwen2.5-14b", ckpt_dir=str(tmp_path / "b"), **kw)
    losses = [h["loss"] for h in resumed["history"]]
    want = [h["loss"] for h in full["history"][3:]]
    assert losses == pytest.approx(want, rel=1e-6)
    for (n, p), (_, q) in zip(full["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert float((p - q).abs().max()) <= 1e-6, n


# ---------------------------------------------------------------------------
# the mesh: one NCCL rank on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A NCCL world of one rank (a file store) for the module, and
    ``elastic_mesh(1, model_parallel=1)`` over it: the mesh the
    reference's ``serve`` builds on one device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    import torch.distributed as dist

    from repro_torch.launch.mesh import elastic_mesh
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield elastic_mesh(1, model_parallel=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
def test_card_mesh_moe_serve_matches_gspmd(nccl_mesh, arch):
    """A MoE smoke config (``dispatch="teshu2"``) served over the one-rank
    NCCL mesh, teacher-forced with the gspmd run's tokens on the same
    weights: the same rows in the same layout, so the same logits bit for
    bit and the same launches (gmm three a MoE layer a forward for each
    expert stack)."""
    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cuda = torch.device("cuda", 0)
    cfg = get_config(arch, smoke=True)
    assert cfg.moe.dispatch == "teshu2"
    params = lm.init_lm(cfg, seed=0, device=cuda, mesh=nccl_mesh)
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for b in params.blocks:
            if hasattr(b, "moe"):
                for w in (b.moe.experts.w_gate, b.moe.experts.w_up,
                          b.moe.experts.w_down):
                    w.copy_(torch.randn(w.shape, generator=gen, device=cuda)
                            / w.shape[1] ** 0.5)
    kw = dict(batch=3, prompt_len=70, gen_len=6, max_len=128, device=cuda,
              params=params)
    for k in KERNELS:
        k.launches = 0
    want, gspmd = serve(arch, **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    for k in KERNELS:
        k.launches = 0
    meshops.reset_counts()
    got, ep = serve(arch, mesh=nccl_mesh, forced=want, **kw)
    assert {k.__name__: k.launches for k in KERNELS} == counts
    assert counts["gmm"] > 0 and meshops.COUNTS["all_to_all"] > 0
    np.testing.assert_array_equal(got, want)
    for a, b in zip(ep.logits, gspmd.logits):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
def test_card_mesh_train_matches_the_cpu(nccl_mesh, arch):
    """SMOKE ``train(mesh=...)`` over the one-rank NCCL mesh (the model's
    ``teshu2`` dispatch, its exchanges through NCCL) against ``train()``
    on the CPU without a mesh (on one rank the EP dispatch routes the
    gspmd branch's tokens in the same groups): the same initial weights,
    data and steps (float32; TF32 off), no LM kernel launched, the
    collectives made.  Held as the dense card test holds its run: losses
    to 1e-5, gradient norms to 1e-4, the moments within 1e-4 (m) and 2e-4
    (v) of the tensor's largest, each tensor's displacement within 1e-3
    (``1 - cos``) and 1e-2 (norm ratio)."""
    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.kernels import LM_KERNELS, MOE_KERNELS
    from repro_torch.launch.train import train
    from repro_torch.models import lm

    cuda = torch.device("cuda", 0)
    cfg = get_config(arch, smoke=True)
    kw = dict(steps=4, global_batch=4, seq_len=32, n_micro=2)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = train(arch, device="cpu", params=lm.init_lm(
            cfg, seed=5, device="cpu"), **kw)
        before = [k.launches for k in LM_KERNELS + MOE_KERNELS]
        meshops.reset_counts()
        card = train(arch, device=cuda, mesh=nccl_mesh, params=lm.init_lm(
            cfg, seed=5, device="cpu", mesh=nccl_mesh).to(cuda), **kw)
        assert [k.launches for k in LM_KERNELS + MOE_KERNELS] == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    layers = sum(1 for b in card["params"].blocks if hasattr(b, "moe"))
    # a step of 2 microbatches: per MoE layer and microbatch the two
    # exchanges and their adjoints, the all-gather's adjoint (no remat)
    assert meshops.COUNTS["all_to_all"] == 4 * 2 * 4 * layers
    assert meshops.COUNTS["reduce_scatter"] == 4 * 2 * layers
    for a, b in zip(cpu["history"], card["history"]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-5)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-4)
    for k, rel in (("m", 1e-4), ("v", 2e-4)):
        for n, w in cpu["opt_state"][k].items():
            t = card["opt_state"][k][n].cpu()
            assert float((t - w).abs().max()) <= rel * float(
                w.abs().max()) + 1e-12, (k, n)
    start = dict(lm.init_lm(cfg, seed=5, device="cpu").named_parameters())
    for (n, p), (_, q) in zip(cpu["params"].named_parameters(),
                              card["params"].named_parameters()):
        a = (q.detach().cpu() - start[n].detach()).double().flatten()
        b = (p.detach() - start[n].detach()).double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        assert na > 0 and nb > 0, n
        assert 1 - float(a @ b) / (na * nb) <= 1e-3, n
        assert abs(na / nb - 1) <= 1e-2, n


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
def test_card_mesh_placed_moe_models_match_the_cpu(nccl_mesh, arch):
    """A SMOKE MoE model placed on the one-rank NCCL mesh by its specs
    (``init_lm(..., mesh=)``): every leaf's spec recorded, most naming an
    axis, none held in part and none gathered (every axis has size 1), so
    the collectives of one microbatch's training forward and backward are
    the dispatch's alone (per MoE layer an all-gather and its
    reduce-scatter); its loss and every gradient through the ``teshu2``
    dispatch on the card against the same weights' on the CPU without a
    mesh (float32, TF32 off): the loss to 1e-5, each gradient within 1e-4
    of its leaf's largest element."""
    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.models import lm

    cuda = torch.device("cuda", 0)
    cfg = get_config(arch, smoke=True)
    cpu = lm.init_lm(cfg, seed=7, device="cpu").requires_grad_(True)
    card = lm.init_lm(cfg, seed=7, device="cpu",
                      mesh=nccl_mesh).to(cuda).requires_grad_(True)
    names = [n for n, _ in cpu.named_parameters()]
    assert sorted(card.specs) == sorted(names)
    assert sum(1 for s in card.specs.values() if any(s)) > len(names) // 2
    assert not card._split and not card._gathers(nccl_mesh)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
             for k in ("tokens", "labels")}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = lm.train_loss(cpu, batch)
        gw = torch.autograd.grad(want, list(cpu.parameters()))
        meshops.reset_counts()
        got = lm.train_loss(card, {k: v.to(cuda) for k, v in batch.items()},
                            mesh=nccl_mesh)
        gg = torch.autograd.grad(got, list(card.parameters()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    layers = sum(1 for b in card.blocks if hasattr(b, "moe"))
    assert meshops.COUNTS["all_gather"] == layers
    assert meshops.COUNTS["reduce_scatter"] == layers
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for n, a, b in zip(names, gw, gg):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * float(
            a.abs().max()) + 1e-12, n


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_card_mesh_mixer_serve_matches_mesh_free(nccl_mesh, arch):
    """A SMOKE Hymba or xLSTM model served mesh-free, then placed on the
    one-rank NCCL mesh (``lm.place``) and served with ``serve(mesh=...)``,
    teacher-forced on the mesh-free tokens: on a ``model`` of 1 every
    tensor-parallel leaf (Hymba's Mamba channels and attention heads, the
    xLSTM projections) is whole, so no product is gathered or summed and
    the logits are bit for bit, the launches equal (Hymba's flash and
    decode, xLSTM's ``slstm_scan``), and the serve loop's token all-gather
    is the only collective."""
    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import shardings
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cuda = torch.device("cuda", 0)
    cfg = get_config(arch, smoke=True)
    params = lm.init_lm(cfg, seed=0, device=cuda)
    kw = dict(batch=3, prompt_len=70, gen_len=6, max_len=128, device=cuda,
              params=params)
    for k in KERNELS:
        k.launches = 0
    want, free = serve(arch, **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    lm.place(params, nccl_mesh)
    assert shardings.mixer_split(cfg, nccl_mesh) and not params._split
    for k in KERNELS:
        k.launches = 0
    meshops.reset_counts()
    got, tp = serve(arch, mesh=nccl_mesh, forced=want, **kw)
    assert {k.__name__: k.launches for k in KERNELS} == counts
    used = ("slstm_scan",) if cfg.family == "ssm" else ("flash_attention",
                                                         "decode_attention")
    assert all(counts[k] > 0 for k in used), counts
    assert dict(meshops.COUNTS) == {k: int(k == "all_gather")
                                    for k in meshops.KINDS}
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tp.logits, free.logits):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_card_mesh_placed_mixer_models_match_the_cpu(nccl_mesh, arch):
    """A SMOKE Hymba or xLSTM model placed on the one-rank NCCL mesh by its
    specs (``init_lm(..., mesh=)``): no leaf held in part or gathered, and
    the mixers' gathers and sums skipped (a ``model`` of 1), so one
    microbatch's training forward and backward make no all-gather,
    reduce-scatter or all-to-all; its loss and every gradient on the card
    against the same weights' on the CPU without a mesh (float32, TF32
    off): the loss to 1e-5, each gradient within 1e-4 of its leaf's
    largest element."""
    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.models import lm

    cuda = torch.device("cuda", 0)
    cfg = get_config(arch, smoke=True)
    cpu = lm.init_lm(cfg, seed=7, device="cpu").requires_grad_(True)
    card = lm.init_lm(cfg, seed=7, device="cpu",
                      mesh=nccl_mesh).to(cuda).requires_grad_(True)
    names = [n for n, _ in cpu.named_parameters()]
    assert sorted(card.specs) == sorted(names)
    assert not card._split and not card._gathers(nccl_mesh)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
             for k in ("tokens", "labels")}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = lm.train_loss(cpu, batch)
        gw = torch.autograd.grad(want, list(cpu.parameters()))
        meshops.reset_counts()
        got = lm.train_loss(card, {k: v.to(cuda) for k, v in batch.items()},
                            mesh=nccl_mesh)
        gg = torch.autograd.grad(got, list(card.parameters()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert all(meshops.COUNTS[k] == 0 for k in
               ("all_gather", "reduce_scatter", "all_to_all")), meshops.COUNTS
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for n, a, b in zip(names, gw, gg):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * float(
            a.abs().max()) + 1e-12, n


@pytest.mark.cuda
def test_card_meshops_at_one_rank(nccl_mesh):
    """Each collective on CUDA tensors over the one-rank groups gives its
    plain meaning bit for bit; a CPU tensor on the NCCL mesh raises."""
    from repro_torch.core import meshops

    cuda = torch.device("cuda", 0)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((7, 5), generator=gen, device=cuda)
    x4 = torch.randn((2, 4, 3), generator=gen, device=cuda)
    for shift in (1, -1, 3):
        assert torch.equal(meshops.ring_exchange(x, nccl_mesh, "model",
                                                 shift), x)
    for axes in ("model", ("data", "model"), ("model", "data")):
        for sp, ct in ((0, 0), (1, 1), (0, 2)):
            assert torch.equal(meshops.all_to_all_axis(x4, nccl_mesh, axes,
                                                       sp, ct), x4)
    assert torch.equal(meshops.two_level_all_to_all(
        x4[None, None], nccl_mesh, "data", "model"), x4[None, None])
    assert torch.equal(meshops.flat_psum(x, nccl_mesh, ("data", "model")), x)
    assert torch.equal(meshops.hier_psum(x, nccl_mesh, "data", "model"), x)
    scale = x.abs().max() / 127.0 + 1e-12
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    assert torch.equal(meshops.hier_psum(x, nccl_mesh, "data", "model",
                                         compress_outer=True),
                       codes.to(x.dtype) * scale)
    got = meshops.grad_sync({"w": x, "n": {"b": x4}}, nccl_mesh,
                            inner_axis="data", outer_axis="model")
    assert torch.equal(got["w"], x) and torch.equal(got["n"]["b"], x4)
    with pytest.raises(ValueError, match="cpu tensor on a cuda mesh"):
        meshops.flat_psum(x.cpu(), nccl_mesh, ("data",))


@pytest.mark.cuda
def test_card_hash32_matches_the_cpu(cuda):
    from repro_torch.core import meshops

    keys = torch.cat([
        torch.tensor([0, 1, -1, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32),
        torch.randint(-2 ** 31, 2 ** 31, (100_000,), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(4)
                      ).to(torch.int32)])
    for seed in (0, -1):
        assert torch.equal(meshops.hash32(keys.to(cuda), seed).cpu(),
                           meshops.hash32(keys, seed))
    with pytest.raises(OverflowError):
        meshops.hash32(keys.to(cuda), seed=1)
    q, s = meshops.quantize_int8(keys[:1000].to(cuda).float())
    qc, sc = meshops.quantize_int8(keys[:1000].float())
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
