"""The port's attention on the CPU, held against the JAX package.

On a CPU tensor the flash and decode wrappers of :mod:`repro_torch.kernels`
take their plain PyTorch versions, so these tests pin the function each CUDA
kernel must compute: against the Pallas kernels (interpret mode, as
``test_kernels.py`` runs them) and the jnp oracles of ``repro.kernels.ref``,
on the same numpy-made inputs.  The sweep covers the GQA group (1, 2, 4 and
MQA), lengths off the tile, ``Sq < Skv``, causal and not, float32 and
bfloat16 (and float32 queries over a bfloat16 cache), and ``valid_len`` 1,
mid-cache and ``T``.  The kernels themselves are held against these plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import blocked_attention as jblocked
from repro.models import layers as jlayers

torch = pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.kernels import LM_KERNELS, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    _split_plan_host, decode_attention, split_plan)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import blocked_attention as blocked  # noqa: E402
from repro_torch.models import layers  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# float32: both sides are float32 softmaxes in other orders (tiled online
# softmax against a whole-row one).  bfloat16: both round a float32 result
# to bfloat16 once, so they may differ by one bfloat16 step (2^-8 relative)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _both(x: np.ndarray, dtype: str):
    """The same values in both frameworks (identical bits in bfloat16)."""
    return (jnp.asarray(x, jnp.float32).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # bhq, bhkv, sq, skv, d, causal
    (2, 2, 64, 64, 16, True),         # group 1
    (4, 2, 100, 100, 32, True),       # group 2, off the 128 tile
    (8, 2, 37, 150, 16, True),        # group 4, Sq < Skv (end-aligned)
    (6, 1, 130, 130, 16, True),       # MQA, one row past the tile
    (4, 2, 77, 200, 32, False),       # non-causal, Sq < Skv
    (3, 1, 1, 65, 16, True),          # one query row at the end
    # D 64, the card's wgmma kernel's width, at its 128-row tiles' edges
    (4, 2, 130, 200, 64, True),       # Sq, Skv off the tile, q_offset 70
    (5, 1, 40, 104, 64, True),        # group 5, q_offset 64
    (16, 1, 1, 129, 64, True),        # group 16, one row, Skv one past
    (5, 1, 70, 150, 64, False),       # non-causal, Skv > Sq
    (3, 1, 140, 70, 128, False),      # D 128, non-causal, Sq > Skv
]


@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("bfloat16", "bfloat16"),
                                      ("float32", "bfloat16")])
@pytest.mark.parametrize("bhq,bhkv,sq,skv,d,causal", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(bhq, bhkv, sq, skv, d, causal,
                                            qdt, kvdt):
    rng = np.random.default_rng(bhq * 1000 + sq + skv)
    jq, tq = _both(rng.standard_normal((bhq, sq, d)).astype(np.float32), qdt)
    jk, tk = _both(rng.standard_normal((bhkv, skv, d)).astype(np.float32), kvdt)
    jv, tv = _both(rng.standard_normal((bhkv, skv, d)).astype(np.float32), kvdt)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == before       # the plain version ran
    assert got.dtype == TORCH[qdt] and got.shape == (bhq, sq, d)
    pallas = pallas_flash(jq, jk, jv, causal=causal, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[qdt])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[qdt])
    np.testing.assert_array_equal(
        _f32(ops.attention(tq, tk, tv, causal=causal, use_kernel=False)),
        _f32(got))


def test_flash_scale_is_passed_through():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 20, 16)).astype(np.float32)
    jx, tx = _both(x, "float32")
    got = flash_attention(tx, tx[:2], tx[:2], scale=0.3)
    want = jref.flash_attention_ref(jx, jx[:2], jx[:2], scale=0.3)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


def test_flash_refuses_bad_shapes():
    q = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError):                  # causal needs Sq <= Skv
        flash_attention(q, q[:2, :4], q[:2, :4])
    with pytest.raises(ValueError):                  # 4 q heads over 3 kv
        flash_attention(q, q[:3], q[:3])
    with pytest.raises(ValueError):                  # no keys
        flash_attention(q, q[:2, :0], q[:2, :0], causal=False)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # b, h, kvh, t, d, valid
    (2, 4, 4, 64, 16, 1),             # group 1, only the newest position
    (2, 4, 2, 100, 16, 37),           # group 2, mid-cache, T off the tile
    (1, 8, 2, 600, 32, 513),          # group 4, past one 512 tile
    (2, 6, 1, 130, 16, 130),          # MQA, the whole cache
]


@pytest.mark.parametrize("qdt,kvdt", [("float32", "float32"),
                                      ("bfloat16", "bfloat16"),
                                      ("float32", "bfloat16")])
@pytest.mark.parametrize("b,h,kvh,t,d,valid", DECODE_CASES)
def test_decode_plain_matches_pallas_and_ref(b, h, kvh, t, d, valid, qdt,
                                             kvdt):
    rng = np.random.default_rng(b * 100 + t + valid)
    jq, tq = _both(rng.standard_normal((b, h, d)).astype(np.float32), qdt)
    jk, tk = _both(rng.standard_normal((b, t, kvh, d)).astype(np.float32), kvdt)
    jv, tv = _both(rng.standard_normal((b, t, kvh, d)).astype(np.float32), kvdt)
    before = decode_attention.launches
    got = decode_attention(tq, tk, tv, valid)
    assert decode_attention.launches == before
    assert got.dtype == TORCH[qdt] and got.shape == (b, h, d)
    pallas = pallas_decode(jq, jk, jv, jnp.int32(valid), interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, valid)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[qdt])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[qdt])
    np.testing.assert_array_equal(
        _f32(ops.decode_attention(tq, tk, tv, valid, use_kernel=False)),
        _f32(got))


def test_decode_ignores_the_cache_tail():
    """Finite junk past ``valid_len`` never reaches the output (the kernel
    also keeps a NaN tail out, ``tests/test_torch_cuda.py``; the plain
    version, like the reference, multiplies it by a zero weight)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    clean = decode_attention(q, k, v, 25)
    k[:, 25:], v[:, 25:] = 1e4, -3e4
    torch.testing.assert_close(decode_attention(q, k, v, 25), clean)


def test_decode_refuses_bad_lengths():
    q, c = torch.zeros((2, 4, 16)), torch.zeros((2, 8, 2, 16))
    for bad in (0, 9):
        with pytest.raises(ValueError):
            decode_attention(q, c, c, bad)
    with pytest.raises(ValueError):                  # 4 q heads over 3 kv
        c3 = torch.zeros((2, 8, 3, 16))
        decode_attention(q, c3, c3, 2)


@pytest.mark.parametrize("pairs,valid,t,sms,want", [
    # the serving decode (Qwen2.5-14B, 32 pairs): 4 splits, 128 blocks
    (32, 1056, 2048, 132, (4, [0, 256, 512, 768, 1056])),
    # decode_32k: the 1,024 pairs fill the card, one split each
    (1024, 32768, 32768, 132, (1, [0, 32768])),
    (32, 1, 2048, 132, (4, [0, 1])),
    # few pairs: never a split that starts past valid
    (4, 100, 2048, 132, (32, [0, 64, 100])),
    # the MoE decode (Qwen3-MoE, 16 pairs): 7 splits of 2 tiles, one of 3
    (16, 1056, 2048, 132, (8, [0, 128, 256, 384, 512, 640, 768, 896, 1056])),
    # MQA at batch 4: 17 splits of one tile
    (4, 1056, 2048, 132, (32, [64 * i for i in range(17)] + [1056])),
])
def test_decode_split_plan(pairs, valid, t, sms, want):
    grid, runs = split_plan(pairs, valid, t, sms)
    assert (grid, [a for a, _ in runs] + [runs[-1][1]]) == want
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))


@settings(max_examples=300, deadline=None)
@given(pairs=st.integers(1, 65535), t=st.integers(1, 1 << 20),
       frac=st.floats(0.0, 1.0), sms=st.integers(1, 528))
def test_decode_split_plan_covers_valid_once(pairs, t, frac, sms):
    """Over any shape and SM count the working splits of the in-kernel rule
    cover ``[0, valid)`` exactly once, in order, each starting on a tile
    below ``valid``, and are no more than the grid holds."""
    valid = max(1, min(t, round(frac * t)))
    grid, runs = split_plan(pairs, valid, t, sms)
    assert 1 <= grid <= max(1, -(-t // 64)) and 1 <= len(runs) <= grid
    assert runs[0][0] == 0 and runs[-1][1] == valid
    for (a, b), (c, _) in zip(runs, runs[1:]):
        assert b == c
    for a, b in runs:
        assert a % 64 == 0 and a < b <= valid


def test_decode_takes_a_valid_len_tensor_on_the_cpu():
    """A 0-dim int32 valid_len gives the int path's result, and is checked
    as an int is."""
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.standard_normal((2, 6, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 90, 2, 32)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    for valid in (1, 45, 90):
        assert torch.equal(
            decode_attention(q, k, v, torch.tensor(valid, dtype=torch.int32)),
            decode_attention(q, k, v, valid))
    with pytest.raises(ValueError):
        decode_attention(q, k, v, torch.tensor(91, dtype=torch.int32))


# ---------------------------------------------------------------------------
# sliding windows: the plain versions, the blocked and fused attention
# ---------------------------------------------------------------------------

def _bshd(rng, b, s, h, d):
    return rng.standard_normal((b, s, h, d)).astype(np.float32)


@pytest.mark.parametrize("window", [1, 5, 9, 16, 33, 64, 200])
@pytest.mark.parametrize("sq,skv,h,kvh", [(64, 64, 4, 2), (20, 70, 6, 3),
                                          (1, 50, 4, 1), (37, 37, 5, 1)])
def test_flash_plain_window_matches_reference_sdpa(window, sq, skv, h, kvh):
    """``ref.flash_attention_ref`` with a window, end-aligned queries, and
    the flash wrapper on the CPU, against the reference's ``_sdpa_fused``
    at ``q_offset = Skv - Sq``."""
    rng = np.random.default_rng(window + sq + skv)
    q, k, v = _bshd(rng, 2, sq, h, 16), _bshd(rng, 2, skv, kvh, 16), \
        _bshd(rng, 2, skv, kvh, 16)
    want = jlayers._sdpa_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, q_offset=skv - sq,
                               valid_len=None)
    flat = [torch.from_numpy(x).transpose(1, 2).reshape(-1, x.shape[1], 16)
            .contiguous() for x in (q, k, v)]
    for got in (ref.flash_attention_ref(*flat, window=window),
                flash_attention(*flat, window=window)):
        got = got.reshape(2, h, sq, 16).transpose(1, 2)
        np.testing.assert_allclose(_f32(got), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("window", [1, 5, 9, 16, 33, 1000])
@pytest.mark.parametrize("valid", [1, 37, 60])
def test_decode_plain_window_matches_reference_sdpa(window, valid):
    """``ref.decode_attention_ref`` with a window against the reference's
    ``_sdpa_fused`` for one query row at ``q_offset = valid - 1``."""
    rng = np.random.default_rng(window * 7 + valid)
    q, k, v = _bshd(rng, 3, 1, 6, 16), _bshd(rng, 3, 60, 2, 16), \
        _bshd(rng, 3, 60, 2, 16)
    want = jlayers._sdpa_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, q_offset=valid - 1,
                               valid_len=valid)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for got in (ref.decode_attention_ref(tq[:, 0], tk, tv, valid,
                                         window=window),
                decode_attention(tq[:, 0], tk, tv, valid, window=window)):
        np.testing.assert_allclose(_f32(got), np.asarray(want)[:, 0],
                                   **TOL["float32"])


def test_window_zero_leaves_the_plain_versions_unchanged():
    """``window=0`` is no window, and a window at least as long as the
    keys masks nothing: both bit for bit today's output."""
    rng = np.random.default_rng(71)
    q = torch.from_numpy(rng.standard_normal((6, 40, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 50, 16)).astype(np.float32))
    base = ref.flash_attention_ref(q, k, k)
    assert torch.equal(ref.flash_attention_ref(q, k, k, window=0), base)
    assert torch.equal(ref.flash_attention_ref(q, k, k, window=50), base)
    kc = k.reshape(2, 50, 1, 16)
    qd = q[:, 0].reshape(2, 3, 16).contiguous()
    dbase = ref.decode_attention_ref(qd, kc, kc, 31)
    assert torch.equal(ref.decode_attention_ref(qd, kc, kc, 31, window=31),
                       dbase)


def test_flash_plain_works_through_query_blocks(monkeypatch):
    """Above ``FLASH_REF_LOGITS`` the plain flash takes query blocks: the
    same rows as one pass, with and without a window."""
    rng = np.random.default_rng(73)
    q = torch.from_numpy(rng.standard_normal((4, 90, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 120, 16)).astype(np.float32))
    whole = [ref.flash_attention_ref(q, k, k, window=w) for w in (0, 17)]
    monkeypatch.setattr(ref, "FLASH_REF_LOGITS", 4 * 120 * 7)
    for w, want in zip((0, 17), whole):
        np.testing.assert_allclose(ref.flash_attention_ref(q, k, k, window=w),
                                   want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("window,block_kv", [(5, 8), (9, 32), (16, 16),
                                             (33, 8)])
def test_blocked_window_matches_reference(window, block_kv):
    """The port's blocked attention against the reference's, with the
    window's kv-block restriction at several alignments (the cases of
    ``test_models_math.py``), and both against the fused attention."""
    rng = np.random.default_rng(20 + window)
    q, k, v = _bshd(rng, 1, 64, 4, 16), _bshd(rng, 1, 64, 2, 16), \
        _bshd(rng, 1, 64, 2, 16)
    want = jblocked.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      window=window, block_q=16,
                                      block_kv=block_kv)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = blocked.blocked_attention(tq, tk, tv, causal=True, window=window,
                                    block_q=16, block_kv=block_kv)
    fused = layers._sdpa_fused(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_f32(got), _f32(fused), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, q_offset=20),
    dict(causal=True, window=9, q_offset=20),
    dict(causal=True, q_offset=20, valid_len=60),
    dict(causal=True, window=5, q_offset=20, valid_len=60),
    dict(causal=False, window=16, valid_len=60),
])
def test_blocked_and_fused_match_reference(kw):
    """``blocked_attention`` and ``_sdpa_fused`` with ``dk != dv`` (24 vs
    16), query offset, window and cache length, each against the
    reference's own."""
    rng = np.random.default_rng(6)
    q, k = _bshd(rng, 2, 50, 8, 16), _bshd(rng, 2, 70, 2, 16)
    v = _bshd(rng, 2, 70, 2, 24)
    full = {"window": 0, "q_offset": 0, "valid_len": None, **kw}
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want_b = jblocked.blocked_attention(jq, jk, jv, block_q=16, block_kv=32,
                                        **kw)
    want_f = jlayers._sdpa_fused(jq, jk, jv, **full)
    got_b = blocked.blocked_attention(tq, tk, tv, block_q=16, block_kv=32,
                                      **kw)
    got_f = layers._sdpa_fused(tq, tk, tv, **full)
    np.testing.assert_allclose(_f32(got_b), np.asarray(want_b), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_f32(got_f), np.asarray(want_f), rtol=1e-5,
                               atol=1e-6)


def test_attend_dispatches_as_the_reference(monkeypatch):
    """``_attend`` takes the fused path under the logits budget and the
    blocked one over it (a single row always fused), as the reference's
    ``_attend``; both give its result."""
    rng = np.random.default_rng(8)
    q, k = _bshd(rng, 2, 30, 4, 16), _bshd(rng, 2, 30, 2, 16)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    want = jlayers._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                           window=7)
    seen = []
    real = blocked.blocked_attention
    monkeypatch.setattr(layers, "blocked_attention",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    for budget, blocked_calls in ((1 << 27, 0), (100, 1)):
        monkeypatch.setattr(blocked, "_FUSED_LOGITS_BUDGET", budget)
        got = layers._attend(tq, tk, tk, window=7)
        assert len(seen) == blocked_calls
        np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    layers._attend(tq[:, :1], tk, tk, q_offset=29)      # one row: fused
    assert len(seen) == 1


@pytest.mark.parametrize("pairs,valid,t,window,want", [
    # Hymba's step (20 pairs, T 4,160): the window's 17 tiles in 6 splits
    (20, 4128, 4160, 1024, (6, [3104, 3200, 3392, 3584, 3776, 3968, 4128])),
    (20, 4128, 4160, 1, (6, [4127, 4128])),
    # a window past the start: the plan of no window
    (32, 1056, 2048, 5000, (4, [0, 256, 512, 768, 1056])),
])
def test_decode_split_plan_with_window(pairs, valid, t, window, want):
    grid, runs = split_plan(pairs, valid, t, 132, window)
    assert (grid, [a for a, _ in runs] + [runs[-1][1]]) == want


@settings(max_examples=300, deadline=None)
@given(pairs=st.integers(1, 65535), t=st.integers(1, 1 << 20),
       frac=st.floats(0.0, 1.0), wfrac=st.floats(0.0, 1.2),
       sms=st.integers(1, 528))
def test_decode_split_plan_covers_the_window_once(pairs, t, frac, wfrac, sms):
    """With any window the working splits cover ``[valid - window, valid)``
    exactly once, in order, each past the first starting on a tile, and
    ``decode_split``'s host plan starts every split below ``valid``."""
    valid = max(1, min(t, round(frac * t)))
    window = max(1, round(wfrac * valid))
    grid, runs = split_plan(pairs, valid, t, sms, window)
    assert 1 <= len(runs) <= grid
    assert runs[0][0] == max(0, valid - window) and runs[-1][1] == valid
    for (a, b), (c, _) in zip(runs, runs[1:]):
        assert b == c and c % 64 == 0
    assert all(a < b for a, b in runs)
    per, splits = _split_plan_host(pairs, valid, sms, window)
    first = max(0, valid - window) // 64
    assert (first + (splits - 1) * per) * 64 < valid <= \
        (first + splits * per) * 64


# ---------------------------------------------------------------------------
# the wrappers' dispatch
# ---------------------------------------------------------------------------

def test_lm_kernels_are_the_attention_wrappers():
    assert LM_KERNELS == (flash_attention, decode_attention)


def test_wrappers_refuse_other_devices():
    """Tensors on two devices raise; a meta tensor (the dry run's) is
    checked as a card tensor is, so what the card refuses raises on meta
    too, and what it takes gives an empty meta result of the kernel's
    shape without a launch."""
    q = torch.zeros((2, 8, 16), device="meta")
    with pytest.raises(ValueError):                  # devices disagree
        flash_attention(torch.zeros((2, 8, 16)), q, q)
    q24 = torch.zeros((2, 8, 24), device="meta")
    with pytest.raises(ValueError, match="head width 24 not compiled"):
        flash_attention(q24, q24, q24)
    c = torch.zeros((2, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(torch.zeros((2, 4, 16), device="meta"),
                         c.transpose(1, 2).contiguous().transpose(1, 2),
                         c, 3)
    launches = flash_attention.launches, decode_attention.launches
    out = flash_attention(q, q, q)
    assert out.is_meta and out.shape == q.shape
    out = decode_attention(torch.zeros((2, 4, 16), device="meta"), c, c, 3)
    assert out.is_meta and out.shape == (2, 4, 16)
    assert (flash_attention.launches, decode_attention.launches) == launches


def test_plain_versions_match_on_mixed_inputs():
    """ops.attention / ops.decode_attention with and without use_kernel are
    one function on the CPU."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((4, 12, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32))
    assert torch.equal(ops.attention(q, k, k), ref.flash_attention_ref(q, k, k))
    qd = q[:, 0].reshape(2, 2, 32).contiguous()
    kc = k.reshape(2, 12, 1, 32).to(torch.bfloat16)
    assert torch.equal(ops.decode_attention(qd, kc, kc, 7),
                       ref.decode_attention_ref(qd, kc, kc, 7))


# ---------------------------------------------------------------------------
# the bound the card holds the kernels to (ref.*_tolerance)
# ---------------------------------------------------------------------------

def _emulated_flash(q, k, v, *, causal=True, rounds="p", acc_tile=None,
                    drop=None):
    """Plain flash in float64 with one departure of a kernel: ``rounds``
    "p" (P to bf16 for P V, as the tensor-core path does) or "s" (S and P
    to bf16); ``acc_tile`` keys per step of an output accumulator kept in
    bf16; ``drop`` "last" (the last 64 keys) or "diagonal" (the diagonal
    64-tile of every q tile past the first)."""
    bhq, sq, d = q.shape
    g, skv = bhq // k.shape[0], k.shape[1]
    kk, vv = (x.repeat_interleave(g, 0).double() for x in (k, v))
    s = torch.einsum("bqd,bkd->bqk", q.double(), kk) * d ** -0.5
    if rounds == "s":
        s = s.to(torch.bfloat16).double()
    rows = torch.arange(sq)[:, None] + (skv - sq)
    cols = torch.arange(skv)[None]
    keep = cols <= rows if causal else torch.ones(sq, skv, dtype=torch.bool)
    if drop == "last":
        keep = keep & (cols < skv - 64)
    elif drop == "diagonal":
        keep = keep & ((cols // 64 < rows // 64) | (rows < 64))
    s = torch.where(keep[None], s, ref.MASKED)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    p = p.to(torch.bfloat16).double()
    if acc_tile is None:
        o = torch.einsum("bqk,bkd->bqd", p, vv)
    else:
        o = torch.zeros(bhq, sq, d, dtype=torch.float64)
        for t in range(0, skv, acc_tile):
            o = (o + torch.einsum("bqk,bkd->bqd", p[..., t:t + acc_tile],
                                  vv[:, t:t + acc_tile])
                 ).to(torch.bfloat16).double()
    return (o / l).to(q.dtype)


def _share(got, plain, tol) -> float:
    return float(((got.float() - plain.float()).abs() / tol).max())


def _flash_inputs(scale, causal=True):
    rng = np.random.default_rng(int(scale) + 2 * causal)
    bf16 = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((8, 512, 128)).astype(
        np.float32) * scale).to(bf16)
    k, v = (torch.from_numpy(rng.standard_normal((2, 512, 128)).astype(
        np.float32)).to(bf16) for _ in range(2))
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    return q, k, v, plain, ref.flash_attention_tolerance(q, k, v, plain,
                                                          causal=causal)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_flash_bound_admits_the_tensor_core_rounding(scale):
    """float64 math with P rounded to bf16, as the tensor-core kernel
    computes, stays inside the bound the card holds it to."""
    q, k, v, plain, tol = _flash_inputs(scale)
    assert _share(_emulated_flash(q, k, v), plain, tol) <= 1.0


@pytest.mark.parametrize("fault,scale,kw", [
    ("last kv tile dropped", 1.0, dict(causal=False, drop="last")),
    ("diagonal tile dropped", 1.0, dict(drop="diagonal")),
    ("S rounded to bf16", 4.0, dict(rounds="s")),
    ("P V accumulated in bf16", 4.0, dict(acc_tile=16)),
])
def test_flash_bound_rejects_planted_faults(fault, scale, kw):
    q, k, v, plain, tol = _flash_inputs(scale, kw.get("causal", True))
    assert _share(_emulated_flash(q, k, v, **kw), plain, tol) > 1.0, fault


@pytest.mark.parametrize("fault,cut,round_s", [
    ("no fault: float64 math", 0, False),
    ("last split dropped", 32, False),
    ("newest position dropped", 1, False),
    ("S rounded to bf16", 0, True),
])
def test_decode_bound_separates_faults(fault, cut, round_s):
    rng = np.random.default_rng(29)
    bf16 = torch.bfloat16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(bf16) for shape in ((4, 40, 128), (4, 1100, 8, 128),
                                            (4, 1100, 8, 128)))
    plain = ref.decode_attention_ref(q, k, v, 1056)
    tol = ref.decode_attention_tolerance(q, k, v, 1056, plain)
    n = 1056 - cut
    s = torch.einsum("bkgd,btkd->bkgt", q.double().reshape(4, 8, 5, 128),
                     k[:, :n].double()) * 128 ** -0.5
    if round_s:
        s = s.to(bf16).double()
    got = torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, -1),
                       v[:, :n].double()).reshape(4, 40, 128).to(bf16)
    assert (_share(got, plain, tol) <= 1.0) == (fault.startswith("no")), fault
