"""The port's kernels on the CPU, held against the JAX package.

On a CPU tensor each wrapper of :mod:`repro_torch.kernels` takes its plain
PyTorch version, so these tests pin the function each CUDA kernel must
compute: PART and COMB against the Pallas kernels (interpret mode, as
``test_kernels.py`` runs them) and the jnp oracles, the ordered fold against
the traced ``jaxplan._combine`` and ``messages.Combiner``, and the partFunc
slots against ``PartFn.assign``.  Inputs are made from numpy seeds and handed
to both frameworks.  The kernels themselves are held against these plain
versions on the card by ``chip_smoke.py`` and by the ``cuda``-marked tests.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import jaxplan
from repro.core.messages import HASH_PART, MAX, MIN, SUM, Msgs, range_part
from repro.kernels import ref as jref
from repro.kernels.combine import segment_combine as pallas_combine
from repro.kernels.partition import partition_permute as pallas_part

torch = pytest.importorskip("torch")

from repro_torch.core import torchplan  # noqa: E402
from repro_torch.core.messages import COMBINERS as PORT_COMBINERS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.combine import segment_combine  # noqa: E402
from repro_torch.kernels.fold import segmented_fold  # noqa: E402
from repro_torch.kernels.partition import partition_permute  # noqa: E402

# the tolerances of test_kernels.py: float32 accumulation in both kernels
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(x: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16 rounds to nearest even in
    both, so the two inputs hold identical bits)."""
    return (jnp.asarray(x, jnp.float32).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# PART
# ---------------------------------------------------------------------------

def _slots(rng, n, num_out, kind):
    if kind == "perm":                      # a permutation into num_out >= n
        return rng.choice(num_out, size=n, replace=False).astype(np.int32)
    if kind == "partial":     # unique slots, -1 and >= num_out dropped
        s = rng.choice(num_out + n // 4, size=n, replace=False).astype(np.int32)
        s[::7] = -1
        return s
    # collisions, the -1 drop id and ids >= num_out (dropped too)
    return rng.integers(-1, num_out + 3, n).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,num_out,kind", [
    (300, 64, 300, "perm"),
    (128, 100, 520, "perm"),                # ragged d, sparse output rows
    (700, 37, 64, "collide"),               # ragged d, heavy collisions
    (5, 3, 9, "collide"),
    (200, 8, 500, "partial"),               # unique slots with drops
])
def test_part_plain_matches_pallas(n, d, num_out, kind, dtype):
    rng = np.random.default_rng(n + d)
    slots = _slots(rng, n, num_out, kind)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    jv, tv = _both(vals, dtype)
    got = ops.part(torch.from_numpy(slots), tv, num_out=num_out,
                   unique_slots=kind != "collide")
    assert got.dtype == TORCH[dtype] and got.shape == (num_out, d)
    pallas = pallas_part(jnp.asarray(slots), jv, num_out=num_out,
                         interpret=True)
    oracle = jref.partition_permute_ref(jnp.asarray(slots), jv,
                                        num_out=num_out)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


def test_part_permutation_is_exact():
    """Unique slots move rows whole: no arithmetic touches the payload."""
    n = 64
    perm = np.random.default_rng(2).permutation(n).astype(np.int32)
    vals = torch.arange(n * 8, dtype=torch.float32).reshape(n, 8)
    out = partition_permute(torch.from_numpy(perm), vals, num_out=n,
                            unique_slots=True)
    assert torch.equal(out[torch.from_numpy(perm).long()], vals)


# ---------------------------------------------------------------------------
# COMB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,segs,layout", [
    (300, 64, 16, "unsorted"),
    (1024, 130, 7, "unsorted"),             # ragged d
    (64, 512, 33, "unsorted"),
    (257, 8, 40, "sorted"),                 # the replay's compacted layout
])
def test_comb_plain_matches_pallas(n, d, segs, layout, dtype):
    rng = np.random.default_rng(n + segs)
    ids = rng.integers(-1, segs + 2, n).astype(np.int32)   # -1 and >= S drop
    if layout == "sorted":
        ids = np.sort(rng.integers(0, segs, n)).astype(np.int32)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    jv, tv = _both(vals, dtype)
    got = ops.combine(torch.from_numpy(ids), tv, num_segments=segs)
    assert got.dtype == TORCH[dtype] and got.shape == (segs, d)
    pallas = pallas_combine(jnp.asarray(ids), jv, num_segments=segs,
                            interpret=True)
    oracle = jref.segment_combine_ref(jnp.asarray(ids), jv, num_segments=segs)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


# ---------------------------------------------------------------------------
# the ordered fold
# ---------------------------------------------------------------------------

SPECIALS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0])


def _fold_inputs(seed, n=400, d=3, nkeys=12, nowners=4, special=0.0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, nkeys, n).astype(np.int64)
    owner = rng.integers(0, nowners, n).astype(np.int32)
    vals = rng.standard_normal((n, d))
    if special:
        mask = rng.random((n, d)) < special
        vals[mask] = rng.choice(SPECIALS, int(mask.sum()))
    alive = rng.random(n) < 0.9
    participate = np.repeat(rng.random(nowners) < 0.75, 1)[owner]
    return keys, vals, owner, alive, participate


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64).view(np.int64)


def _run_both_combines(comb, keys, vals, owner, alive, participate, nowners):
    with jax.enable_x64(True):
        jk, jv, jo, ja = (np.asarray(a) for a in jax.jit(
            jaxplan._combine, static_argnums=(0, 6))(
                comb, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(owner),
                jnp.asarray(alive), jnp.asarray(participate), nowners))
    tk, tv, to, ta = (a.numpy() for a in torchplan._combine(
        comb, torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(owner.astype(np.int64)), torch.from_numpy(alive),
        torch.from_numpy(participate), nowners))
    return (jk, jv, jo, ja), (tk, tv, to, ta)


@pytest.mark.parametrize("comb", ["sum", "min", "max"])
@pytest.mark.parametrize("special", [0.0, 0.2], ids=["finite", "nan_inf_zero"])
def test_fold_matches_traced_combine(comb, special):
    """torchplan._combine (the plain fold on the CPU) against the traced
    jaxplan._combine: same sort, same alive rows, same running fold at every
    row, bit for bit.  The one exception is a MIN/MAX tie between 0.0 and
    -0.0: XLA orders -0.0 below 0.0, numpy (the reference executors) lets
    the later operand win; there the port must give numpy's bits."""
    keys, vals, owner, alive, part = _fold_inputs(3, special=special)
    (jk, jv, jo, ja), (tk, tv, to, ta) = _run_both_combines(
        comb, keys, vals, owner, alive, part, 4)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ta, ja)
    same = _bits(tv) == _bits(jv)
    if comb == "sum":
        assert same.all()
    else:
        # every difference is a signed-zero tie, equal in value
        assert ((tv == 0) & (jv == 0))[~same].all()
    # and the numpy executors' fold decides: each live row against Combiner
    _assert_matches_combiner(comb, tk, tv, to, ta, keys, vals, owner, alive,
                             part)


def _assert_matches_combiner(comb, tk, tv, to, ta, keys, vals, owner, alive,
                             part):
    for w in range(4):
        rows = alive & (owner == w)
        live = ta & (to == w)
        if not rows.any() or not part[rows].all():
            continue                            # a non-participating owner
        expect = {"sum": SUM, "min": MIN, "max": MAX}[comb](
            Msgs(keys[rows], vals[rows]))
        np.testing.assert_array_equal(tk[live], expect.keys)
        np.testing.assert_array_equal(_bits(tv[live]), _bits(expect.vals))


@pytest.mark.parametrize("comb", ["sum", "min", "max"])
def test_fold_signed_zero_and_nan_follow_numpy(comb):
    """Segments built only of ±0.0 and NaN: the plain fold's segment ends are
    bit-identical to both packages' Combiner (numpy: NaN propagates from
    either side; on a tie the later operand wins)."""
    rng = np.random.default_rng(5)
    n = 240
    seg = np.sort(rng.integers(0, 30, n)).astype(np.int64)
    vals = rng.choice(np.array([0.0, -0.0, 0.0, -0.0, np.nan]), (n, 2))
    is_start = np.r_[True, seg[1:] != seg[:-1]]
    out = ops.segmented_fold(comb, torch.from_numpy(is_start),
                             torch.from_numpy(vals)).numpy()
    ends = np.r_[is_start[1:], True]
    for combiner in ({"sum": SUM, "min": MIN, "max": MAX}[comb],
                     PORT_COMBINERS[comb]):
        expect = combiner(Msgs(seg, vals))
        np.testing.assert_array_equal(seg[ends], expect.keys)
        np.testing.assert_array_equal(_bits(out[ends]), _bits(expect.vals))


def test_fold_plain_is_a_left_fold():
    """The vectorised loop over segment positions equals a row-by-row left
    fold (its definition), including the implicit segment start at row 0."""
    rng = np.random.default_rng(9)
    vals = rng.standard_normal((90, 2))
    is_start = rng.random(90) < 0.2
    is_start[0] = False
    out = ref.segmented_fold_ref("sum", torch.from_numpy(is_start),
                                 torch.from_numpy(vals)).numpy()
    acc = vals[0].copy()
    for r in range(90):
        acc = vals[r].copy() if (r == 0 or is_start[r]) else acc + vals[r]
        np.testing.assert_array_equal(out[r], acc)


@pytest.mark.parametrize("comb,ufunc", [("sum", np.add), ("min", np.minimum),
                                        ("max", np.maximum)])
def test_fold_plain_long_segments_match_numpy(comb, ufunc):
    """The plain fold over segments tens of thousands of rows long: at every
    row bit for bit numpy's sequential ``ufunc.accumulate`` of its segment,
    and at the segment ends both packages' Combiner.  This is the contract
    the card tests hold the kernel to on long segments."""
    rng = np.random.default_rng(23)
    lens = np.array([30_000, 1, 45_000, 7, 20_000])
    n = int(lens.sum())
    # magnitudes over six decades: a reordered sum would round differently
    vals = rng.standard_normal((n, 3)) * 10.0 ** rng.integers(-3, 4, (n, 1))
    starts = np.r_[0, np.cumsum(lens)[:-1]]
    is_start = np.zeros(n, dtype=bool)
    is_start[starts] = True
    out = ref.segmented_fold_ref(comb, torch.from_numpy(is_start),
                                 torch.from_numpy(vals)).numpy()
    for a, ln in zip(starts, lens):
        np.testing.assert_array_equal(
            _bits(out[a:a + ln]), _bits(ufunc.accumulate(vals[a:a + ln], axis=0)))
    keys = np.repeat(np.arange(len(lens)), lens)
    for combiner in ({"sum": SUM, "min": MIN, "max": MAX}[comb],
                     PORT_COMBINERS[comb]):
        expect = combiner(Msgs(keys, vals))
        np.testing.assert_array_equal(_bits(out[starts + lens - 1]),
                                      _bits(expect.vals))


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = (partition_permute.launches, segment_combine.launches,
              segmented_fold.launches)
    v32 = torch.ones((4, 2))
    ops.part(torch.arange(4, dtype=torch.int32), v32, num_out=4)
    ops.combine(torch.zeros(4, dtype=torch.int32), v32, num_segments=1)
    ops.segmented_fold("sum", torch.ones(4, dtype=torch.bool),
                       torch.ones((4, 2), dtype=torch.float64))
    assert (partition_permute.launches, segment_combine.launches,
            segmented_fold.launches) == before


def test_other_devices_and_bad_inputs_raise():
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError):
        partition_permute(torch.empty(4, dtype=torch.int32, device="meta"),
                          meta, num_out=4)
    with pytest.raises(ValueError):
        segment_combine(torch.zeros(3, dtype=torch.int32), torch.ones((4, 2)),
                        num_segments=1)
    with pytest.raises(TypeError):
        segmented_fold("sum", torch.ones(4, dtype=torch.bool),
                       torch.ones((4, 2)))                  # float32 vals
    with pytest.raises(ValueError):
        segmented_fold("prod", torch.ones(4, dtype=torch.bool),
                       torch.ones((4, 2), dtype=torch.float64))


# ---------------------------------------------------------------------------
# partFunc slots (the traced _slot_of)
# ---------------------------------------------------------------------------

EDGE_KEYS = np.array([0, 1, -1, 2**31, -(2**31), 2**62, -(2**62),
                      np.iinfo(np.int64).max, np.iinfo(np.int64).min,
                      0x9E3779B97F4A7C15 - 2**64], dtype=np.int64)


@pytest.mark.parametrize("ndst", [1, 2, 3, 7, 8, 40, 2**31 - 1])
def test_hash_slot_is_bit_identical(ndst):
    rng = np.random.default_rng(ndst)
    keys = np.concatenate([EDGE_KEYS, rng.integers(
        np.iinfo(np.int64).min, np.iinfo(np.int64).max, 2000,
        dtype=np.int64)])
    got = torchplan._slot_of(("hash",), torch.from_numpy(keys), ndst)
    np.testing.assert_array_equal(got.numpy(), HASH_PART.assign(keys, ndst))
    z = torchplan._splitmix64(torch.from_numpy(keys)).numpy()
    from repro.core.messages import splitmix64
    np.testing.assert_array_equal(z.view(np.uint64), splitmix64(keys))


def test_slot_with_per_row_counts():
    """The level loop asks each row for its own group size."""
    rng = np.random.default_rng(4)
    keys = rng.integers(-10**12, 10**12, 500).astype(np.int64)
    g = rng.integers(1, 9, 500).astype(np.int64)
    for part, fn in ((("hash",), HASH_PART), (("range", 1000),
                                              range_part(1000))):
        got = torchplan._slot_of(part, torch.from_numpy(keys),
                                 torch.from_numpy(g)).numpy()
        expect = np.array([fn.assign(keys[i:i + 1], int(g[i]))[0]
                           for i in range(500)])
        np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("key_space,ndst", [(64, 8), (1000, 7), (5, 8)])
def test_range_slot_is_identical(key_space, ndst):
    keys = np.concatenate([np.arange(-3, key_space + 5, dtype=np.int64),
                           EDGE_KEYS])
    got = torchplan._slot_of(("range", key_space), torch.from_numpy(keys),
                             ndst)
    np.testing.assert_array_equal(got.numpy(),
                                  range_part(key_space).assign(keys, ndst))



def test_an_edited_header_rebuilds(tmp_path, monkeypatch):
    """A library's name hashes its source and every ``csrc/*.cuh`` header,
    so an edited or added header gives every kernel a new library, and an
    edit to another source does not."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = {n: _build._target(n) for n in _build.SOURCES}
    assert all(p.parent == _build.BUILD_DIR for p in first.values())
    assert _build._target("gmm") == first["gmm"]
    other = csrc / "fold.cu"
    other.write_text(other.read_text() + "// an edit\n")
    assert _build._target("gmm") == first["gmm"]
    assert _build._target("fold") != first["fold"]
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "// an edit\n")
    edited = {n: _build._target(n) for n in _build.SOURCES}
    assert all(edited[n] != first[n] for n in ("gmm", "partition"))
    (csrc / "more.cuh").write_text("#pragma once\n")
    assert _build._target("gmm") not in (first["gmm"], edited["gmm"])
