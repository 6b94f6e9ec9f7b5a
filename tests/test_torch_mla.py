"""The port's DeepSeek-V2 serving path on the CPU, held against the JAX package.

Multi-head latent attention (``layers.MLA``) meets the reference's
``mla_attention`` on the same inputs, made from a seed with numpy: without
a cache, a fresh prefill into a cache, a prefill appended in chunks, decode
steps (the absorbed form) and the cache's contents, on the fused and on the
blocked plain attention.  The port's two forms are held to each other on
one cache.  The deepseek-v2-236b SMOKE model (MLA, a dense layer 0, two
shared experts beside the routed ones) is built, converted, run forward,
prefilled and decoded, and served end to end.  The reference's ``init_mla``
sets both norms to ones and its ``init_moe`` repeats one matrix over the
experts, so the norms and every expert, routed and shared, are jittered
from numpy first.

Tolerances.  float32 without a cache: 2e-5 (float32 sums in other orders,
as the dense layers of ``test_torch_lm.py``).  Through the bfloat16 cache:
rtol 2e-3, atol 2e-3, as there (a float32 difference in the last bit can
flip one rounding of the latent).  bfloat16 models: one bfloat16 step,
rtol and atol 2^-7 (both sides round the same operations to bfloat16; a
rounding that flips moves an element by a step).  The absorbed decode
against the materialised form on one cache: 2e-5 in float32; in bfloat16,
where the materialised form rounds ``k_nope``, ``v`` and its output to
bfloat16 and the absorbed one stays float32, 2^-6 relative to the largest
output (two steps) -- a control without the absorbed scores' rope term
must miss it by 10x.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch.serve import serve as ref_serve
from repro.models import blocked_attention as jblocked
from repro.models import layers as jlayers
from repro.models import lm as jlm

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import KERNELS  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import blocked_attention as blocked  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.convert import (_copy_into,  # noqa: E402
                                        cache_from_reference,
                                        lm_params_from_reference)

ARCH = "deepseek-v2-236b"
LAYER = dict(rtol=2e-5, atol=2e-5)
CACHED = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
TOL = {"float32": (LAYER, CACHED), "bfloat16": (BF16, BF16)}
DTYPES = ["float32", "bfloat16"]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _cfgs(dtype="float32"):
    """(reference cfg, port cfg): the SMOKE config in ``dtype``."""
    return tuple(dataclasses.replace(get(ARCH, smoke=True), dtype=dtype)
                 for get in (ref_config, get_config))


def _jitter(a, base, rng):
    return (base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)


def _jitter_experts(tree, rng):
    """Every expert of a stacked ``[..., E, d_in, d_out]`` leaf made
    distinct: half a standard deviation of numpy noise on each."""
    for name, a in tree.items():
        f = np.asarray(a, np.float32)
        tree[name] = (f + 0.5 * f.std() * rng.standard_normal(f.shape)
                      ).astype(a.dtype)


def _mla_pair(dtype: str, seed: int = 1):
    """A reference ``init_mla`` tree with jittered norms, and the port's
    MLA module holding the same arrays."""
    rcfg, pcfg = _cfgs(dtype)
    params = jax.tree.map(np.asarray,
                          jlayers.init_mla(jax.random.key(seed), rcfg))
    rng = np.random.default_rng(seed)
    for name in ("q_a_norm", "kv_a_norm"):
        params[name] = _jitter(params[name], 1.0, rng)
    mod = layers.MLA(pcfg, device="cpu")
    done: set = set()
    with torch.no_grad():
        _copy_into(mod, params, done, "")
    assert done == {id(p) for p in mod.parameters()}
    return rcfg, pcfg, params, mod


def _x(dtype, b, s, seed=0):
    x = np.random.default_rng(seed).standard_normal((b, s, 64)).astype(
        np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _pos(b, start, s):
    p = np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s))
    return jnp.asarray(p), torch.from_numpy(p.copy())


# ---------------------------------------------------------------------------
# the MLA module against mla_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 37])
def test_mla_without_cache_matches(dtype, s):
    rcfg, _, params, mod = _mla_pair(dtype)
    jx, tx = _x(dtype, 2, s)
    jp, tp = _pos(2, 0, s)
    want, jcache = jlayers.mla_attention(params, rcfg, jx, jp)
    got, cache = mod(tx, tp)
    assert jcache is None and cache is None
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, s, 64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype][0])


def _run_chunks(rcfg, params, mod, dtype, chunks, steps=0, max_len=64):
    """Chunks of a prompt, then ``steps`` single tokens, through both
    caches: each call's outputs compared; returns both caches."""
    b = 2
    jx, tx = _x(dtype, b, sum(chunks) + steps, seed=3)
    jcache = jlayers.init_mla_cache(rcfg, b, max_len)
    pcache = layers.init_mla_cache(rcfg, b, max_len, device="cpu")
    start = 0
    for n in list(chunks) + [1] * steps:
        jp, tp = _pos(b, start, n)
        sl = slice(start, start + n)
        want, jcache = jlayers.mla_attention(params, rcfg, jx[:, sl], jp,
                                             cache=jcache)
        got, out_cache = mod(tx[:, sl], tp, cache=pcache)
        assert out_cache is pcache                       # updated in place
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype][1])
        start += n
    return jcache, pcache


def _same_cache(pcache, jcache, n):
    assert pcache["len"] == int(jcache["len"]) == n
    for name in ("latent", "k_rope"):
        assert pcache[name].dtype == torch.bfloat16        # whatever the model
        np.testing.assert_allclose(_np(pcache[name]), _np(jcache[name]),
                                   rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_cached_prefill_matches(dtype):
    rcfg, _, params, mod = _mla_pair(dtype)
    jcache, pcache = _run_chunks(rcfg, params, mod, dtype, [37])
    _same_cache(pcache, jcache, 37)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_appended_prefill_matches(dtype):
    """Chunks of 13 and 24 on one cache: the second chunk's queries sit at
    rows 13..36 of the materialised form."""
    rcfg, _, params, mod = _mla_pair(dtype)
    jcache, pcache = _run_chunks(rcfg, params, mod, dtype, [13, 24])
    _same_cache(pcache, jcache, 37)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_steps_match(dtype):
    """Three single-token steps after a prefill (the absorbed form)."""
    rcfg, _, params, mod = _mla_pair(dtype)
    jcache, pcache = _run_chunks(rcfg, params, mod, dtype, [20], steps=3)
    _same_cache(pcache, jcache, 23)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_blocked_path_matches(dtype, monkeypatch):
    """The fused budget lowered in both packages, and the blocks shrunk to
    16 queries by 32 keys: every prefill takes the blocked attention (a
    spy counts it), with several query and kv blocks."""
    for mod_ in (jblocked, blocked):
        monkeypatch.setattr(mod_, "_FUSED_LOGITS_BUDGET", 100)
        monkeypatch.setattr(mod_, "DEFAULT_BLOCK_Q", 16)
        monkeypatch.setattr(mod_, "DEFAULT_BLOCK_KV", 32)
    seen = []
    real = blocked.blocked_attention
    monkeypatch.setattr(layers, "blocked_attention",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    rcfg, _, params, mod = _mla_pair(dtype)
    jx, tx = _x(dtype, 2, 45)
    jp, tp = _pos(2, 0, 45)
    want, _ = jlayers.mla_attention(params, rcfg, jx, jp)
    got, _ = mod(tx, tp)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype][0])
    jcache, pcache = _run_chunks(rcfg, params, mod, dtype, [13, 40],
                                 steps=2)
    _same_cache(pcache, jcache, 55)
    assert len(seen) == 3             # no cache, then both chunks


def test_mla_cache_overflow_raises():
    rcfg, _, _, mod = _mla_pair("float32")
    cache = layers.init_mla_cache(rcfg, 1, 8, device="cpu")
    _, tx = _x("float32", 1, 9)
    _, tp = _pos(1, 0, 9)
    with pytest.raises(ValueError, match="cache full"):
        mod(tx, tp, cache=cache)
    assert cache["len"] == 0


# ---------------------------------------------------------------------------
# the port's two forms on one cache
# ---------------------------------------------------------------------------

def _two_forms(dtype, drop_rope=False):
    """A 30-position prefill, then the step at position 30 through the
    absorbed form (the module's decode) and through the materialised form
    on the same cache rows, each cast to the model's dtype and through
    ``wo``; with ``drop_rope`` the absorbed form is given a zero rope
    query (its scores without their rope term)."""
    rcfg, _, _, mod = _mla_pair(dtype)
    _, tx = _x(dtype, 2, 31, seed=5)
    _, tp = _pos(2, 0, 31)
    cache = layers.init_mla_cache(rcfg, 2, 48, device="cpu")
    mod(tx[:, :30], tp[:, :30], cache=cache)
    absorbed, _ = mod(tx[:, 30:], tp[:, 30:], cache=cache)
    q_nope, q_rope, _, _ = mod.project(tx[:, 30:], tp[:, 30:])
    rows = cache["latent"][:, :31], cache["k_rope"][:, :31]
    mat = layers.mla_materialized(mod, q_nope, q_rope, *rows, q_offset=30,
                                  valid_len=31)
    if drop_rope:
        absorbed = layers.mla_absorbed_decode(
            mod, q_nope, torch.zeros_like(q_rope), *rows,
            valid_len=31).to(tx.dtype) @ mod.wo
    return absorbed, mat.to(tx.dtype) @ mod.wo


FORMS_TOL = {"float32": 2e-5, "bfloat16": 2 ** -6}   # of the largest output


@pytest.mark.parametrize("dtype", DTYPES)
def test_absorbed_decode_matches_the_materialised_form(dtype):
    absorbed, mat = _two_forms(dtype)
    limit = FORMS_TOL[dtype] * float(mat.float().abs().max())
    assert float((absorbed.float() - mat.float()).abs().max()) <= limit
    control, _ = _two_forms(dtype, drop_rope=True)
    assert float((control.float() - mat.float()).abs().max()) > 10 * limit


def test_absorbed_form_masks_the_rows_past_valid_len():
    """Rows at and past ``valid_len`` do not move the absorbed output (their
    probabilities are exactly 0; a NaN there would still reach it, as in
    the reference, which is why the module reads only the written rows)."""
    rcfg, _, _, mod = _mla_pair("float32")
    _, tx = _x("float32", 2, 9, seed=2)
    _, tp = _pos(2, 0, 9)
    q_nope, q_rope, latent, k_rope = mod.project(tx, tp)
    want = layers.mla_absorbed_decode(mod, q_nope[:, 6:7], q_rope[:, 6:7],
                                      latent[:, :7], k_rope[:, :7],
                                      valid_len=7)
    latent, k_rope = latent.clone(), k_rope.clone()
    latent[:, 7:], k_rope[:, 7:] = 1e4, -1e4
    got = layers.mla_absorbed_decode(mod, q_nope[:, 6:7], q_rope[:, 6:7],
                                     latent, k_rope, valid_len=7)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the deepseek-v2-236b SMOKE model
# ---------------------------------------------------------------------------

def _reference_params(cfg, seed: int) -> dict:
    """``lm.init_lm`` weights as numpy: every norm (the blocks', MLA's two,
    the final one) and every expert, routed and shared, jittered."""
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    params["final_norm"] = _jitter(params["final_norm"], 1.0, rng)
    for blocks in (params["block0"], params["blocks"]):
        for name in ("ln1", "ln2"):
            blocks[name] = _jitter(blocks[name], 1.0, rng)
        for name in ("q_a_norm", "kv_a_norm"):
            blocks["attn"][name] = _jitter(blocks["attn"][name], 1.0, rng)
        for sub in ("experts", "shared"):
            if "moe" in blocks:
                _jitter_experts(blocks["moe"][sub], rng)
    return params


_CACHE: dict = {}


def _pair():
    """(reference cfg, port cfg, reference params, port model), float32."""
    if not _CACHE:
        rcfg, pcfg = _cfgs()
        params = _reference_params(rcfg, seed=21)
        _CACHE["pair"] = (rcfg, pcfg, params,
                          lm_params_from_reference(pcfg, params, device="cpu"))
    return _CACHE["pair"]


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_configs_are_copies():
    for smoke in (True, False):
        r, p = ref_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        assert repr(r) == repr(p) and r.num_params() == p.num_params()


@pytest.mark.parametrize("smoke", [True, False])
def test_deepseek_model_builds(smoke, monkeypatch):
    """Layer 0 keeps a dense FFN of width ``d_ff``, every other layer MLA
    and a MoE FFN with two shared experts; the parameter count is the
    config's formula plus the norms (two a block, MLA's two, the final
    one) and the routers.  The full-width model is built on the meta
    device (no memory), at the 9 of 60 layers the card serves."""
    cfg = get_config(ARCH, smoke=smoke)
    if not smoke:
        cfg = dataclasses.replace(cfg, n_layers=9)
        monkeypatch.setattr(lm, "check_device",
                            lambda device: torch.device("meta"))
    model = lm.LM(cfg, device="cpu")
    m = cfg.mla
    assert isinstance(model.blocks[0].attn, layers.MLA)
    assert not hasattr(model.blocks[0], "moe")
    assert model.blocks[0].mlp.w_up.shape == (cfg.d_model, cfg.d_ff)
    for block in list(model.blocks)[1:]:
        assert not hasattr(block, "mlp")
        assert isinstance(block.attn, layers.MLA)
        assert block.moe.shared.w_gate.shape == (
            cfg.moe.num_shared, cfg.d_model, cfg.moe.d_ff_expert)
        assert block.moe.experts.w_down.shape == (
            cfg.moe.num_experts, cfg.moe.d_ff_expert, cfg.d_model)
    attn = model.blocks[1].attn
    assert attn.wkv_b.shape == (m.kv_lora_rank, cfg.n_heads * (
        m.nope_head_dim + m.v_head_dim))
    assert attn.wq_b.shape == (m.q_lora_rank, cfg.n_heads * (
        m.nope_head_dim + m.rope_head_dim))
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.num_params() + cfg.n_layers * (
        2 * cfg.d_model + m.q_lora_rank + m.kv_lora_rank) + cfg.d_model \
        + (cfg.n_layers - 1) * cfg.d_model * cfg.moe.num_experts
    if not smoke:
        assert n == 33_163_494_400


def test_convert_copies_every_array():
    rcfg, pcfg, params, model = _pair()
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in model.parameters())
    blocks = params["blocks"]
    for i in range(1, rcfg.n_layers):
        for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
            np.testing.assert_array_equal(
                _np(getattr(model.blocks[i].attn, name)),
                blocks["attn"][name][i - 1])
        for name in ("q_a_norm", "kv_a_norm"):
            np.testing.assert_array_equal(
                _np(getattr(model.blocks[i].attn, name).weight),
                blocks["attn"][name][i - 1])
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                _np(getattr(model.blocks[i].moe.shared, name)),
                blocks["moe"]["shared"][name][i - 1])
    np.testing.assert_array_equal(_np(model.blocks[0].attn.wkv_b),
                                  params["block0"]["attn"]["wkv_b"])
    np.testing.assert_array_equal(_np(model.blocks[0].mlp.w_down),
                                  params["block0"]["mlp"]["w_down"])
    shared = blocks["moe"]["shared"]["w_up"]
    assert not np.array_equal(shared[0, 0], shared[0, 1])


def test_convert_refuses_a_missing_or_extra_array():
    rcfg, pcfg, params, _ = _pair()
    missing = jax.tree.map(lambda a: a, params)
    del missing["blocks"]["attn"]["kv_a_norm"]
    with pytest.raises(KeyError, match="kv_a_norm"):
        lm_params_from_reference(pcfg, missing, device="cpu")
    extra = jax.tree.map(lambda a: a, params)
    extra["block0"]["attn"]["wk"] = extra["block0"]["attn"]["wkv_a"]
    with pytest.raises(KeyError, match="wk"):
        lm_params_from_reference(pcfg, extra, device="cpu")


def test_forward_matches():
    rcfg, pcfg, params, model = _pair()
    toks = _tokens(rcfg, 2, 11)
    got, cache, aux = lm.forward(model, tokens=torch.from_numpy(toks))
    want, _, jaux = jlm.forward(params, rcfg, tokens=jnp.asarray(toks))
    assert cache is None and got.shape == (2, 11, rcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_prefill_then_decode_matches():
    """Prefill into an empty cache, an appended chunk, then two decode
    steps: logits and the whole cache (through ``cache_from_reference``)
    against the reference's."""
    rcfg, pcfg, params, model = _pair()
    b, max_len = 2, 24
    toks = _tokens(rcfg, b, 14, seed=4)
    jcache = jlm.init_cache(rcfg, b, max_len)
    pcache = lm.init_cache(pcfg, b, max_len, device="cpu")
    for sl in (slice(0, 7), slice(7, 12), slice(12, 13), slice(13, 14)):
        want, jcache, _ = jlm.forward(params, rcfg,
                                      tokens=jnp.asarray(toks[:, sl]),
                                      cache=jcache)
        got, pcache, _ = lm.forward(model, tokens=torch.from_numpy(
            toks[:, sl]), cache=pcache)
        np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    theirs = cache_from_reference(pcfg, jcache, device="cpu")
    assert pcache["pos"] == theirs["pos"] == 14
    assert len(pcache["layers"]) == len(theirs["layers"]) == rcfg.n_layers
    for mine, ref_layer in zip(pcache["layers"], theirs["layers"]):
        assert set(mine) == set(ref_layer) == {"latent", "k_rope", "len"}
        assert mine["len"] == ref_layer["len"] == 14
        for name in ("latent", "k_rope"):
            assert ref_layer[name].dtype == mine[name].dtype == torch.bfloat16
            np.testing.assert_allclose(_np(mine[name]), _np(ref_layer[name]),
                                       rtol=2 ** -7, atol=2 ** -7)


def test_decode_from_a_converted_cache_matches():
    """A reference cache carried into the port decodes as the reference."""
    rcfg, pcfg, params, model = _pair()
    toks = _tokens(rcfg, 2, 10, seed=6)
    jcache = jlm.init_cache(rcfg, 2, 16)
    _, jcache, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, :9]),
                               cache=jcache)
    pcache = cache_from_reference(pcfg, jcache, device="cpu")
    want, _ = jlm.serve_step(params, rcfg, jcache,
                             tokens=jnp.asarray(toks[:, 9:]))
    got, _ = lm.serve_step(model, pcache, tokens=torch.from_numpy(toks[:, 9:]))
    np.testing.assert_allclose(_np(got), _np(want), **CACHED)


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


def test_swapped_heads_fail_the_comparison():
    """Heads 0 and 1 of ``wkv_b`` swapped in conversion: the forward no
    longer matches (a head taken in the wrong order still gives finite
    numbers)."""
    rcfg, pcfg, params, _ = _pair()
    swapped = jax.tree.map(lambda a: a, params)
    w = swapped["blocks"]["attn"]["wkv_b"]
    n, r = w.shape[:2]
    heads = w.reshape(n, r, rcfg.n_heads, -1).copy()
    heads[:, :, [0, 1]] = heads[:, :, [1, 0]]
    swapped["blocks"]["attn"]["wkv_b"] = heads.reshape(w.shape)
    model = lm_params_from_reference(pcfg, swapped, device="cpu")
    toks = _tokens(rcfg, 2, 11)
    got, _, _ = lm.forward(model, tokens=torch.from_numpy(toks))
    want, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks))
    assert np.isfinite(_np(got)).all()
    assert not np.allclose(_np(got), _np(want), **LAYER)


def test_init_mla_keeps_the_reference_distributions():
    """``dense_init``'s scales (1/sqrt(d_in)) and norms of ones."""
    _, pcfg = _cfgs()
    model = lm.init_lm(pcfg, seed=5, device="cpu")
    attn = model.blocks[1].attn
    for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        w = getattr(attn, name)
        assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.1, name
    assert bool((attn.q_a_norm.weight == 1).all())
    assert bool((attn.kv_a_norm.weight == 1).all())
