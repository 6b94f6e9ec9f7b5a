"""The port on the card: each kernel against its plain version, and the
service's replay through the kernels.  Every test here is marked ``cuda`` and
skips on a host without a CUDA device; on the card run

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
from repro_torch.kernels import KERNELS, ref  # noqa: E402
from repro_torch.kernels.combine import segment_combine  # noqa: E402
from repro_torch.kernels.fold import segmented_fold  # noqa: E402
from repro_torch.kernels.partition import partition_permute  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("comb", ["sum", "min", "max"])
def test_fold_kernel_is_bit_identical(cuda, comb):
    rng = np.random.default_rng(17)
    n, d = 50_000, 5
    vals = rng.standard_normal((n, d))
    mask = rng.random((n, d)) < 0.05
    vals[mask] = rng.choice(SPECIALS, int(mask.sum()))
    is_start = rng.random(n) < 0.05
    v, s = torch.from_numpy(vals).to(cuda), torch.from_numpy(is_start).to(cuda)
    before = segmented_fold.launches
    got = segmented_fold(comb, s, v)
    assert segmented_fold.launches == before + 1
    plain = ref.segmented_fold_ref(comb, s, v)
    torch.cuda.synchronize()
    # bit-identical; a NaN matches any NaN (IEEE leaves the payload of an
    # arithmetic NaN unspecified, and torch's elementwise kernels and this
    # one may produce different ones)
    same = (got.view(torch.int64) == plain.view(torch.int64)) \
        | (got.isnan() & plain.isnan())
    assert bool(same.all()), int((~same).sum())


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        partition_permute(torch.zeros(4, dtype=torch.int64, device=cuda),
                          torch.ones((4, 2), device=cuda), num_out=4)
    with pytest.raises(TypeError):
        segment_combine(torch.zeros(4, dtype=torch.int32, device=cuda),
                        torch.ones((4, 2), dtype=torch.float64, device=cuda),
                        num_segments=1)
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
    before = [k.launches for k in KERNELS]
    hit = sv.shuffle("network_aware", port.msgs_from_reference(bufs), ws, ws,
                     comb_fn=port.SUM)
    assert all(k.launches > b for k, b in zip(KERNELS, before))
    assert hit.engine == "torch"
    for d in ref.bufs:
        np.testing.assert_array_equal(hit.bufs[d].keys, ref.bufs[d].keys)
        np.testing.assert_allclose(hit.bufs[d].vals, ref.bufs[d].vals,
                                   rtol=1e-5, atol=1e-5)
