"""The port's MoE serving path on the CPU, held against the JAX package.

Each ported piece meets its JAX counterpart on the same inputs, made from a
seed with numpy: the grouped matmul (``gmm`` and its plain version against
the Pallas kernel in interpret mode and ``ref.gmm_ref``), ``route_and_pad``,
the router, the capacity buffers, the combine, the MoE block with and
without shared experts, the LM's forward, prefill and decode, and
``serve()`` end to end on the qwen3-moe-235b-a22b SMOKE config.  The
reference's ``init_moe`` repeats one matrix over all experts, so a kernel
that read the wrong expert would still agree: every expert is jittered
from numpy after ``lm.init_lm``.

Tolerances.  The grouped matmul is held per element to
``ref.gmm_tolerance`` (``2 d 2^-24 (|x| @ |w|)``, two float32 sums of the
same products in other orders, plus ``2^-7 |plain|`` for the roundings of a
bfloat16 output).  The MoE block in bfloat16 equals the reference bit for bit (the
same roundings in the same order: float32 matmuls rounded once, the silu
chain of ``jax.nn.silu``, the combine's slot-order adds); in float32 it
agrees to 2e-5 (float32 sums in other orders, as the dense layers of
``test_torch_lm.py``).  Logits through the bfloat16 KV cache are held to
rtol 2e-3, atol 2e-3, as there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.kernels import ref as jref
from repro.kernels.gmm import gmm as jgmm
from repro.kernels.gmm import route_and_pad as jroute_and_pad
from repro.launch.serve import serve as ref_serve
from repro.models import lm as jlm
from repro.models import moe as jmoe

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import KERNELS, ops, ref  # noqa: E402
from repro_torch.kernels.gmm import gmm, route_and_pad  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.convert import (_copy_into,  # noqa: E402
                                        cache_from_reference,
                                        lm_params_from_reference, to_tensor)

ARCH = "qwen3-moe-235b-a22b"
LAYER = dict(rtol=2e-5, atol=2e-5)
CACHED = dict(rtol=2e-3, atol=2e-3)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _cfgs(dtype="float32", num_shared=0, capacity_factor=None, **kw):
    """(reference cfg, port cfg): the SMOKE config with these changes."""
    out = []
    for get in (ref_config, get_config):
        c = get(ARCH, smoke=True)
        m = dataclasses.replace(
            c.moe, num_shared=num_shared,
            capacity_factor=capacity_factor or c.moe.capacity_factor)
        out.append(dataclasses.replace(c, dtype=dtype, moe=m, **kw))
    return tuple(out)


def _jitter_experts(tree, rng):
    """Every expert of a stacked ``[..., E, d_in, d_out]`` leaf made
    distinct: half a standard deviation of numpy noise on each."""
    for name, a in tree.items():
        f = np.asarray(a, np.float32)
        tree[name] = (f + 0.5 * f.std() * rng.standard_normal(f.shape)
                      ).astype(a.dtype)


def _reference_params(cfg, seed: int) -> dict:
    """``lm.init_lm`` weights as numpy, norm weights and every expert
    jittered so that each array (and each expert) is exercised."""
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)

    def jitter(a, base):
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    params["final_norm"] = jitter(params["final_norm"], 1.0)
    for blocks in [params["blocks"]] + [params[k] for k in ("block0",)
                                        if k in params]:
        for name in ("ln1", "ln2"):
            blocks[name] = jitter(blocks[name], 1.0)
        if "moe" in blocks:
            for sub in ("experts", "shared"):
                if sub in blocks["moe"]:
                    _jitter_experts(blocks["moe"][sub], rng)
    return params


_CACHE: dict = {}


def _pair(num_shared: int = 0):
    """(reference cfg, port cfg, reference params, port model), float32."""
    if num_shared not in _CACHE:
        rcfg, pcfg = _cfgs(num_shared=num_shared)
        params = _reference_params(rcfg, seed=11 + num_shared)
        _CACHE[num_shared] = (rcfg, pcfg, params, lm_params_from_reference(
            pcfg, params, device="cpu"))
    return _CACHE[num_shared]


def _moe_pair(dtype: str, num_shared: int, capacity_factor=None, seed=1):
    """A reference ``init_moe`` tree with jittered experts and the port's
    MoE block holding the same arrays."""
    rcfg, pcfg = _cfgs(dtype, num_shared, capacity_factor)
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(seed),
                                                    rcfg))
    rng = np.random.default_rng(seed)
    for sub in ("experts", "shared"):
        if sub in params:
            _jitter_experts(params[sub], rng)
    block = moe.MoE(pcfg, device="cpu")
    with torch.no_grad():
        _copy_into(block, params, set(), "")
    return rcfg, pcfg, params, block


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the grouped matmul
# ---------------------------------------------------------------------------

def _group_ids(rng, kind: str, groups: int, tiles: int) -> np.ndarray:
    if kind == "random":            # the reference's sweep: repeats, gaps
        return rng.integers(0, groups, tiles).astype(np.int32)
    if kind == "shuffled":          # every group, some repeated, shuffled
        ids = np.concatenate([np.arange(groups),
                              rng.integers(0, groups, tiles - groups)])
        return rng.permutation(ids).astype(np.int32)
    # only the odd groups have tiles
    return (2 * rng.integers(0, groups // 2, tiles) + 1).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups,tiles,d,f,block_n,kind", [
    (4, 8, 128, 256, 128, "random"), (7, 7, 256, 128, 128, "random"),
    (5, 12, 64, 48, 16, "shuffled"), (6, 9, 96, 40, 32, "groups with no tile"),
    (3, 5, 128, 64, 64, "shuffled")])
def test_gmm_matches_reference(groups, tiles, d, f, block_n, kind, dtype):
    """The port's ``gmm`` (a CPU tensor: its plain version) and
    ``gmm_ref`` against the Pallas kernel (interpret mode) and the JAX
    oracle, each element within ``ref.gmm_tolerance``."""
    rng = np.random.default_rng(groups * tiles + d)
    x = jnp.asarray(rng.standard_normal((tiles * block_n, d)), JNP[dtype])
    w = jnp.asarray(rng.standard_normal((groups, d, f)), JNP[dtype])
    ids = jnp.asarray(_group_ids(rng, kind, groups, tiles))
    want = jgmm(x, w, ids, block_n=block_n, interpret=True)
    oracle = jref.gmm_ref(x, w, ids, block_n=block_n)
    xt, wt, it = _t(x), _t(w), _t(ids)
    before = [k.launches for k in KERNELS]
    got = gmm(xt, wt, it, block_n=block_n)
    plain = ref.gmm_ref(xt, wt, it, block_n=block_n)
    assert [k.launches for k in KERNELS] == before     # no kernel on a CPU
    assert got.dtype == xt.dtype and got.shape == (tiles * block_n, f)
    assert torch.equal(got, plain)
    assert torch.equal(ops.grouped_matmul(xt, wt, it, block_n=block_n,
                                          use_kernel=False), plain)
    tol = _np(ref.gmm_tolerance(xt, wt, it, plain, block_n=block_n))
    for theirs in (want, oracle):
        assert (np.abs(_np(got) - _np(theirs)) <= tol).all()


@pytest.mark.parametrize("fault", ["one tile reads the next expert",
                                   "reduction drops its last 512 of d"])
def test_gmm_tolerance_rejects_planted_faults(fault):
    """The bound is tight enough to fail the two faults ``chip_smoke.py``
    plants in the kernel, by more than 10x."""
    rng = np.random.default_rng(5)
    g, tiles, d, f, bn = 4, 6, 2048, 64, 16
    x = torch.from_numpy(rng.standard_normal((tiles * bn, d))).bfloat16()
    w = torch.from_numpy(rng.standard_normal((g, d, f)) / d ** 0.5).bfloat16()
    ids = torch.from_numpy(rng.integers(0, g, tiles).astype(np.int32))
    plain = ref.gmm_ref(x, w, ids, block_n=bn)
    tol = ref.gmm_tolerance(x, w, ids, plain, block_n=bn)
    if fault.startswith("one tile"):
        bad = ids.clone()
        bad[2] = (bad[2] + 1) % g
        got = ref.gmm_ref(x, w, bad, block_n=bn)
    else:
        got = ref.gmm_ref(x[:, :-512].contiguous(),
                          w[:, :-512].contiguous(), ids, block_n=bn)
    share = float(((got.float() - plain.float()).abs() / tol).max())
    assert share > 10.0, share


def test_gmm_refuses_what_it_does_not_take():
    x, w = torch.ones((32, 8)), torch.ones((2, 8, 4))
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        gmm(x, w, ids, block_n=8)
    with pytest.raises(ValueError, match="one group id per tile"):
        gmm(x, w, ids[:1], block_n=16)
    with pytest.raises(ValueError, match="G, d, f"):
        gmm(x, torch.ones((2, 9, 4)), ids, block_n=16)
    with pytest.raises(TypeError, match="int32 or int64"):
        gmm(x, w, ids.float(), block_n=16)
    with pytest.raises(ValueError, match="lie in"):
        gmm(x, w, torch.tensor([0, 2], dtype=torch.int32), block_n=16)
    with pytest.raises(ValueError):      # on meta, what the card refuses
        gmm(x.to("meta", torch.bfloat16), w.to("meta", torch.bfloat16),
            ids.to("meta"), block_n=16)   # f = 4: bf16 rows of 8 bytes


@pytest.mark.parametrize("n,experts,block_n,tiles,skew", [
    (500, 4, 128, 2, False), (300, 8, 16, 1, True), (64, 5, 16, 2, True),
    (1, 3, 16, 1, False)])
def test_route_and_pad_matches(n, experts, block_n, tiles, skew):
    """Rows, tile group ids and the valid mask equal the reference's,
    rows over an expert's capacity dropped."""
    rng = np.random.default_rng(n + experts)
    p = np.arange(1, experts + 1, dtype=np.float64) ** (-3.0 if skew else 0)
    eids = rng.choice(experts, n, p=p / p.sum()).astype(np.int32)
    want = jroute_and_pad(jnp.asarray(eids), experts, block_n,
                          capacity_tiles=tiles)
    got = route_and_pad(torch.from_numpy(eids), experts, block_n,
                        capacity_tiles=tiles)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dropped = n - int(got[2].sum())
    assert dropped == sum(max(0, int(c) - tiles * block_n)
                          for c in np.bincount(eids, minlength=experts))
    assert dropped > 0 or not skew


def test_route_and_pad_refuses_ids_out_of_range():
    with pytest.raises(ValueError, match="lie in"):
        route_and_pad(torch.tensor([0, 4], dtype=torch.int32), 4, 16,
                      capacity_tiles=1)


# ---------------------------------------------------------------------------
# the MoE block, piece by piece
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches(dtype):
    rcfg, pcfg, params, block = _moe_pair(dtype, 0)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (40, rcfg.d_model)), JNP[dtype])
    eids, weights, aux = jmoe._route(params["router"], x, rcfg.moe)
    peids, pweights, paux = moe._route(block.router, _t(x), pcfg.moe)
    assert peids.dtype == torch.int32 and pweights.dtype == torch.float32
    np.testing.assert_array_equal(peids.numpy(), np.asarray(eids))
    np.testing.assert_allclose(pweights.numpy(), np.asarray(weights),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(paux), float(aux), rtol=1e-6)


def test_route_breaks_ties_like_top_k():
    """Equal router scores: ``lax.top_k`` takes the lower index first (and
    ``torch.topk`` need not); the port's order is the reference's."""
    rcfg, pcfg = _cfgs()
    m = dataclasses.replace(rcfg.moe, top_k=3)
    rng = np.random.default_rng(3)
    cols = rng.standard_normal((rcfg.d_model, 3)).astype(np.float32)
    router = cols[:, [0, 1, 1, 2, 1, 0, 2, 1]]        # 8 experts, 3 columns
    x = rng.standard_normal((16, rcfg.d_model)).astype(np.float32)
    eids, _, _ = jmoe._route(jnp.asarray(router), jnp.asarray(x), m)
    peids, _, _ = moe._route(torch.from_numpy(router), torch.from_numpy(x), m)
    np.testing.assert_array_equal(peids.numpy(), np.asarray(eids))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
def test_build_buffers_matches(dtype, padded):
    """The reference's layout (``cap_pad = cap``) exactly; padded, the same
    rows at ``e * cap_pad + p`` and zeros in the pad."""
    rcfg, pcfg = _cfgs(dtype)
    m = rcfg.moe
    rng = np.random.default_rng(4)
    t, cap = 40, 8                           # 80 assignments: some drop
    x = jnp.asarray(rng.standard_normal((t, rcfg.d_model)), JNP[dtype])
    eids = rng.integers(0, m.num_experts, (t, m.top_k)).astype(np.int32)
    w = rng.random((t, m.top_k)).astype(np.float32)
    buf, wbuf, (slot, keep, tok) = jmoe._build_buffers(
        x, jnp.asarray(eids), jnp.asarray(w), m.num_experts, cap)
    cap_pad = 16 if padded else cap
    pbuf, pwbuf, (pslot, pkeep, ptok) = moe._build_buffers(
        _t(x), torch.from_numpy(eids), torch.from_numpy(w), m.num_experts,
        cap, cap_pad)
    assert pbuf.shape == (m.num_experts, cap_pad, rcfg.d_model)
    np.testing.assert_array_equal(_np(pbuf[:, :cap]), _np(buf))
    np.testing.assert_array_equal(pwbuf[:, :cap].numpy(), np.asarray(wbuf))
    assert not pbuf[:, cap:].any() and not pwbuf[:, cap:].any()
    np.testing.assert_array_equal(pkeep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(tok))
    e, p = np.divmod(np.asarray(slot), cap)
    np.testing.assert_array_equal(pslot.numpy(), np.where(
        np.asarray(keep), e * cap_pad + p, m.num_experts * cap_pad))
    assert not np.asarray(keep).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_matches(dtype):
    """Bit for bit: the weighted outputs promoted to float32, cast back,
    and added in slot order into zeros."""
    rcfg, _ = _cfgs(dtype)
    m = rcfg.moe
    rng = np.random.default_rng(6)
    t, cap, d = 40, 8, rcfg.d_model
    x = jnp.asarray(rng.standard_normal((t, d)), JNP[dtype])
    eids = jnp.asarray(rng.integers(0, m.num_experts, (t, m.top_k)),
                       jnp.int32)
    w = jnp.asarray(rng.random((t, m.top_k)), jnp.float32)
    buf, wbuf, meta = jmoe._build_buffers(x, eids, w, m.num_experts, cap)
    out_buf = jnp.asarray(rng.standard_normal(buf.shape), JNP[dtype])
    want = jmoe._combine(out_buf, wbuf, meta, t, d)
    pmeta = tuple(_t(a) for a in meta)
    got = moe._combine(_t(out_buf), _t(wbuf), pmeta, t, d)
    assert got.dtype == _t(out_buf).dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_shared", [0, 1, 2])
@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_ffn_matches(dtype, num_shared, capacity_factor):
    """The block as a whole, its buffers padded past the reference's
    capacity (``cap_pad > cap``); at capacity factor 0.5 tokens drop."""
    rcfg, pcfg, params, block = _moe_pair(dtype, num_shared, capacity_factor)
    rng = np.random.default_rng(7)
    b, s = 4, 10
    cap = moe._capacity(b * s, pcfg.moe)
    assert moe.buffer_layout(cap)[1] > cap
    x = jnp.asarray(rng.standard_normal((b, s, rcfg.d_model)), JNP[dtype])
    want, aux = jmoe.moe_ffn(params, rcfg, x)
    got, paux = moe.moe_ffn(block, pcfg, _t(x))
    assert got.dtype == _t(x).dtype and got.shape == (b, s, rcfg.d_model)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    np.testing.assert_allclose(float(paux), float(aux), rtol=1e-5)
    eids, _, _ = moe._route(block.router, _t(x).reshape(b * s, -1), pcfg.moe)
    load = torch.bincount(eids.reshape(-1).long(), minlength=8)
    assert bool((load > cap).any()) == (capacity_factor < 1)


def test_buffer_layout_covers_every_capacity():
    """Every capacity the block can ask for: the pad stays under one tile,
    and past 64 the tile is the kernel's 128-row compute block."""
    for cap in range(8, 2049):
        block_n, cap_pad = moe.buffer_layout(cap)
        assert block_n % 16 == 0 and cap_pad % block_n == 0, cap
        assert 0 <= cap_pad - cap < block_n, cap
        assert (block_n == 128) == (cap > 64), cap


def _layout_upto_64(cap: int) -> tuple[int, int]:
    """The buffer layout before the 128-row tile: block_n 64 at most."""
    block_n = 16 if cap <= 16 else 32 if cap <= 32 else 64
    return block_n, -(-cap // block_n) * block_n


@pytest.mark.parametrize("num_shared", [0, 1])
def test_moe_ffn_output_does_not_depend_on_the_padding(monkeypatch,
                                                       num_shared):
    """bf16, capacity 152: padded to 192 (block_n 64) or to 256 (block_n
    128), the block's output is the same bits, and the reference's bits
    without shared experts (Qwen3-MoE's layout).  A shared expert runs
    one float32 matmul over all 300 tokens, where XLA's and torch's CPU
    matmuls sum in other orders (a third of the float32 products differ
    in their last bits), so a few bf16 outputs round one step apart:
    held to the bf16 tolerance of ``test_torch_cuda.py`` there."""
    rcfg, pcfg, params, block = _moe_pair("bfloat16", num_shared)
    rng = np.random.default_rng(8)
    b, s = 4, 75
    cap = moe._capacity(b * s, pcfg.moe)
    assert cap == 152 and moe.buffer_layout(cap) == (128, 256)
    assert _layout_upto_64(cap) == (64, 192)
    x = jnp.asarray(rng.standard_normal((b, s, rcfg.d_model)), jnp.bfloat16)
    want, _ = jmoe.moe_ffn(params, rcfg, x)
    got, _ = moe.moe_ffn(block, pcfg, _t(x))
    monkeypatch.setattr(moe, "buffer_layout", _layout_upto_64)
    old, _ = moe.moe_ffn(block, pcfg, _t(x))
    assert got.dtype == old.dtype == torch.bfloat16
    assert torch.equal(got, old)
    if num_shared:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# the LM: conversion, forward, prefill and decode, serve()
# ---------------------------------------------------------------------------

def test_configs_are_copies():
    for smoke in (True, False):
        r, p = ref_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        assert repr(r) == repr(p) and r.num_params() == p.num_params()


@pytest.mark.parametrize("num_shared", [0, 1])
def test_convert_copies_every_expert(num_shared):
    rcfg, pcfg, params, model = _pair(num_shared)
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in model.parameters())
    stack = params["blocks"]["moe"]["experts"]
    first = 1 if num_shared else 0
    for i in range(first, rcfg.n_layers):
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                _np(getattr(model.blocks[i].moe.experts, name)),
                stack[name][i - first])
    assert not np.array_equal(stack["w_up"][0, 0], stack["w_up"][0, 1])
    if num_shared:
        assert not hasattr(model.blocks[0], "moe")
        np.testing.assert_array_equal(_np(model.blocks[0].mlp.w_up),
                                      params["block0"]["mlp"]["w_up"])
        np.testing.assert_array_equal(
            _np(model.blocks[1].moe.shared.w_down),
            params["blocks"]["moe"]["shared"]["w_down"][0])


@pytest.mark.parametrize("num_shared", [0, 1])
def test_forward_matches(num_shared):
    rcfg, pcfg, params, model = _pair(num_shared)
    toks = _tokens(rcfg, 2, 11)
    got, cache, aux = lm.forward(model, tokens=torch.from_numpy(toks))
    want, _, jaux = jlm.forward(params, rcfg, tokens=jnp.asarray(toks))
    assert cache is None and got.shape == (2, 11, rcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("num_shared", [0, 1])
def test_prefill_then_decode_matches(num_shared):
    """Prefill into an empty cache, then two decode steps (the decode
    step's four tokens fill a 16-row padded buffer): logits and the whole
    cache against the reference's."""
    rcfg, pcfg, params, model = _pair(num_shared)
    b, s, max_len = 2, 7, 16
    toks = _tokens(rcfg, b, s + 2, seed=4)
    jcache = jlm.init_cache(rcfg, b, max_len)
    pcache = lm.init_cache(pcfg, b, max_len, device="cpu")
    want, jcache, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, :s]),
                                  cache=jcache)
    got, pcache, _ = lm.forward(model, tokens=torch.from_numpy(toks[:, :s]),
                                cache=pcache)
    np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    for i in range(s, s + 2):
        want, jcache = jlm.serve_step(params, rcfg, jcache,
                                      tokens=jnp.asarray(toks[:, i:i + 1]))
        got, pcache = lm.serve_step(model, pcache,
                                    tokens=torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    theirs = cache_from_reference(pcfg, jcache, device="cpu")
    assert pcache["pos"] == theirs["pos"] == s + 2
    assert len(pcache["layers"]) == len(theirs["layers"]) == rcfg.n_layers
    for mine, ref_layer in zip(pcache["layers"], theirs["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(mine[name]), _np(ref_layer[name]),
                                       rtol=2 ** -7, atol=2 ** -7)


def test_serve_emits_the_reference_tokens():
    rcfg, pcfg, params, model = _pair()
    kw = dict(batch=2, prompt_len=8, gen_len=5, max_len=32, seed=0)
    want, _ = ref_serve(ARCH, params=params, **kw)
    before = [k.launches for k in KERNELS]
    got, stats = serve(ARCH, device="cpu", params=model, **kw)
    assert [k.launches for k in KERNELS] == before      # plain versions ran
    assert got.dtype == np.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    assert stats.tokens == 10 and len(stats.logits) == 6


def test_swapped_experts_fail_the_comparison():
    """Two experts swapped in conversion: the forward no longer matches
    (what the jitter is for: the reference's own init repeats one expert)."""
    rcfg, pcfg, params, _ = _pair()
    swapped = jax.tree.map(lambda a: a, params)
    for name, a in swapped["blocks"]["moe"]["experts"].items():
        a = a.copy()
        a[:, [0, 1]] = a[:, [1, 0]]
        swapped["blocks"]["moe"]["experts"][name] = a
    model = lm_params_from_reference(pcfg, swapped, device="cpu")
    toks = _tokens(rcfg, 2, 11)
    got, _, _ = lm.forward(model, tokens=torch.from_numpy(toks))
    want, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks))
    assert not np.allclose(_np(got), _np(want), **LAYER)


def test_serve_takes_the_config_from_params(monkeypatch):
    """A model cut in depth gets a cache of its own depth, and a model of
    another arch is refused."""
    _, pcfg = _cfgs()
    cut = lm.init_lm(dataclasses.replace(pcfg, n_layers=1), seed=3,
                     device="cpu")
    depths = []
    real = lm.init_cache

    def spy(cfg, *a, **kw):
        depths.append(cfg.n_layers)
        return real(cfg, *a, **kw)
    monkeypatch.setattr(lm, "init_cache", spy)
    gen, _ = serve(ARCH, device="cpu", params=cut, batch=1, prompt_len=4,
                   gen_len=2, max_len=8)
    assert depths == [1] and gen.shape == (1, 2)
    with pytest.raises(ValueError, match="not 'qwen2.5-14b'"):
        serve("qwen2.5-14b", device="cpu", params=cut, batch=1,
              prompt_len=4, gen_len=2, max_len=8)


def test_init_moe_keeps_the_reference_distributions():
    """One draw per projection, repeated over the experts (as the
    reference's ``init_moe``): router std 0.02, projections 1/sqrt(d_in)."""
    _, pcfg = _cfgs()
    model = lm.init_lm(pcfg, seed=5, device="cpu")
    m = model.blocks[1].moe
    assert torch.equal(m.experts.w_gate[0], m.experts.w_gate[7])
    assert m.experts.w_gate.stride(0) > 0            # a copy, not a view
    assert abs(float(m.router.std()) / 0.02 - 1) < 0.1
    assert abs(float(m.experts.w_up[0].std()) * 64 ** 0.5 - 1) < 0.1
    assert abs(float(m.experts.w_down[0].std()) * 32 ** 0.5 - 1) < 0.15
