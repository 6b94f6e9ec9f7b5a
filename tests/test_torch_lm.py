"""The port's LM serving path on the CPU, held against the JAX package.

For the SMOKE configs of the six dense archs (qwen2.5-14b with QKV bias,
granite-34b with MQA and a GELU MLP, llama3-405b, qwen1.5-110b, and the
backbones of pixtral-12b and musicgen-large, served from tokens), the
reference's ``lm.init_lm`` weights, with nonzero biases and norm weights
set from numpy, are carried into the port by
:mod:`repro_torch.models.convert`.  Each ported piece is compared with its
JAX counterpart on the same inputs: RMSNorm, RoPE, the MLP, attention
without a cache, prefill into a cache (logits and cache contents), a decode
step, the whole forward, and ``serve()`` end to end.

Tolerances.  The smoke configs compute in float32, and the two frameworks
order their float32 sums differently: single layers agree to 2e-5.  Paths
through the KV cache round keys and values to bfloat16 on both sides, where
a float32 difference in the last bit can flip one rounding (2^-8 relative),
so logits through a cache are held to rtol 2e-3, atol 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch.serve import serve as ref_serve
from repro.models import layers as jlayers
from repro.models import lm as jlm

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import LM_KERNELS  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        lm_params_from_reference)

DENSE = ["qwen2.5-14b", "granite-34b", "llama3-405b", "qwen1.5-110b",
         "pixtral-12b", "musicgen-large"]
LAYER = dict(rtol=2e-5, atol=2e-5)
CACHED = dict(rtol=2e-3, atol=2e-3)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _reference_params(cfg, seed: int) -> dict:
    """``lm.init_lm`` weights as numpy, with the zero biases and unit norm
    weights replaced by random values so that every array is exercised."""
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)

    def jitter(a, base):
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    blocks = params["blocks"]
    for name in ("ln1", "ln2"):
        blocks[name] = jitter(blocks[name], 1.0)
    params["final_norm"] = jitter(params["final_norm"], 1.0)
    for name in ("bq", "bk", "bv"):
        if name in blocks["attn"]:
            blocks["attn"][name] = jitter(blocks["attn"][name], 0.0)
    return params


_CACHE: dict = {}


def _pair(arch: str):
    """(reference cfg, port cfg, reference params, port model), made once
    per arch."""
    if arch not in _CACHE:
        rcfg, pcfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
        params = _reference_params(rcfg, seed=DENSE.index(arch))
        _CACHE[arch] = (rcfg, pcfg, params,
                        lm_params_from_reference(pcfg, params, device="cpu"))
    return _CACHE[arch]


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _layer0(params) -> dict:
    return jax.tree.map(lambda a: a[0], params["blocks"])


# ---------------------------------------------------------------------------
# configs and conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_configs_are_copies(arch):
    for smoke in (True, False):
        r, p = ref_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        assert type(p).__module__ == "repro_torch.models.config"
        assert repr(r) == repr(p)
        assert r.num_params() == p.num_params()


@pytest.mark.parametrize("arch", DENSE)
def test_convert_copies_every_array(arch):
    rcfg, pcfg, params, model = _pair(arch)
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in model.parameters())
    np.testing.assert_array_equal(_np(model.blocks[1].attn.wq),
                                  params["blocks"]["attn"]["wq"][1])
    np.testing.assert_array_equal(_np(model.unembed), params["unembed"])
    assert model.blocks[0].mlp.w_gate is None or pcfg.gated_mlp


def test_convert_keeps_bfloat16_bits():
    from repro_torch.models.convert import to_tensor
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = to_tensor(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))


def test_convert_refuses_a_missing_array():
    rcfg, pcfg, params, _ = _pair("qwen2.5-14b")
    short = dict(params, blocks=dict(params["blocks"]))
    del short["blocks"]["ln2"]
    with pytest.raises(KeyError, match="ln2"):
        lm_params_from_reference(pcfg, short, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    # bfloat16: float32 statistics, cast, then the bfloat16 weight
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    got = layers.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(w).to(torch.bfloat16))
    np.testing.assert_allclose(_np(got), _np(jlayers.rms_norm(xb, wb)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.array([np.arange(7), np.arange(100, 107)], np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(layers.rope_freqs(16, theta)),
                               _np(jlayers.rope_freqs(16, theta)), rtol=1e-6)


@pytest.mark.parametrize("arch", DENSE)
def test_mlp_matches(arch):
    rcfg, pcfg, params, model = _pair(arch)
    x = np.random.default_rng(2).standard_normal((2, 5, rcfg.d_model)
                                                 ).astype(np.float32)
    got = model.blocks[0].mlp(torch.from_numpy(x))
    want = jlayers.mlp(_layer0(params)["mlp"], jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


@pytest.mark.parametrize("arch", DENSE)
def test_attention_without_cache_matches(arch):
    rcfg, pcfg, params, model = _pair(arch)
    b, s = 2, 9
    x = np.random.default_rng(3).standard_normal((b, s, rcfg.d_model)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    got, _ = model.blocks[0].attn(torch.from_numpy(x), torch.from_numpy(pos))
    want, _ = jlayers.attention(_layer0(params)["attn"], rcfg, jnp.asarray(x),
                                jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


# ---------------------------------------------------------------------------
# the LM: forward, prefill into a cache, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches(arch):
    rcfg, pcfg, params, model = _pair(arch)
    toks = _tokens(rcfg, 2, 11)
    got, cache, _ = lm.forward(model, tokens=torch.from_numpy(toks))
    want, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks))
    assert cache is None and got.shape == (2, 11, rcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches(arch):
    """Prefill into an empty cache (the flash slot on the cache's own bf16
    rows), then two decode steps (the decode slot): logits and the whole
    cache against the reference's."""
    rcfg, pcfg, params, model = _pair(arch)
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
        assert got.shape == (b, 1, rcfg.vocab)
        np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    ref_cache = cache_from_reference(pcfg, jcache, device="cpu")
    assert pcache["pos"] == ref_cache["pos"] == s + 2
    for mine, theirs in zip(pcache["layers"], ref_cache["layers"]):
        assert mine["len"] == theirs["len"] == s + 2
        assert mine["k"].dtype == torch.bfloat16           # trap: bf16 cache
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(mine[name]), _np(theirs[name]),
                                       rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_stepwise_decode(arch):
    """Prefill-then-decode equals token-by-token decode (as
    ``test_arch_smoke.py`` checks the reference)."""
    _, pcfg, _, model = _pair(arch)
    toks = torch.from_numpy(_tokens(pcfg, 1, 8, seed=3))
    cache = lm.init_cache(pcfg, 1, 16, device="cpu")
    lm.forward(model, tokens=toks[:, :7], cache=cache)
    logits_a, _ = lm.serve_step(model, cache, tokens=toks[:, 7:8])
    cache = lm.init_cache(pcfg, 1, 16, device="cpu")
    for i in range(8):
        logits_b, cache = lm.serve_step(model, cache, tokens=toks[:, i:i + 1])
    np.testing.assert_allclose(_np(logits_a), _np(logits_b), rtol=2e-2,
                               atol=2e-3)


def test_prefill_append_takes_the_flash_slot():
    """A prefill appended to a non-empty cache goes to the flash slot over
    the cache's rows (end-aligned), never to the fused plain attention,
    and gives the logits of feeding the same tokens one by one and the
    reference's forward with a cache over the same two chunks."""
    rcfg, pcfg, params, model = _pair("qwen2.5-14b")
    toks = _tokens(pcfg, 2, 9, seed=5)
    cache = lm.init_cache(pcfg, 2, 16, device="cpu")
    lm.forward(model, tokens=torch.from_numpy(toks[:, :4]), cache=cache)
    fused, flash, seen = layers._sdpa_fused, layers.kops.attention, []
    layers._sdpa_fused = lambda *a, **k: seen.append("fused") or fused(*a, **k)
    layers.kops.attention = lambda *a, **k: seen.append("flash") or flash(*a, **k)
    try:
        got, _, _ = lm.forward(model, tokens=torch.from_numpy(toks[:, 4:]),
                               cache=cache)
    finally:
        layers._sdpa_fused, layers.kops.attention = fused, flash
    assert seen == ["flash"] * pcfg.n_layers
    step = lm.init_cache(pcfg, 2, 16, device="cpu")
    want = [lm.serve_step(model, step, tokens=torch.from_numpy(toks[:, i:i + 1]))[0]
            for i in range(9)]
    np.testing.assert_allclose(_np(got), _np(torch.cat(want[4:], 1)),
                               rtol=2e-3, atol=2e-3)
    jcache = jlm.init_cache(rcfg, 2, 16)
    _, jcache, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, :4]),
                               cache=jcache)
    ref_logits, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, 4:]),
                                   cache=jcache)
    np.testing.assert_allclose(_np(got), _np(ref_logits), **CACHED)


@pytest.mark.parametrize("window", [0, 5])
def test_attention_appended_prefill_matches_reference(window):
    """One attention layer over a cache in two chunks (7, then 6 appended)
    and a decoded token, with and without a sliding window: each output
    and the cache's rows against the reference's ``attention`` with the
    same cache and ``window``."""
    rcfg, pcfg, params, model = _pair("qwen2.5-14b")
    attn = model.blocks[0].attn
    b, chunks = 2, (slice(0, 7), slice(7, 13), slice(13, 14))
    x = np.random.default_rng(9).standard_normal((b, 14, rcfg.d_model)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(14), (b, 14)).astype(np.int32)
    jcache = jlayers.init_attention_cache(rcfg, b, 16)
    pcache = layers.init_attention_cache(pcfg, b, 16, device="cpu")
    attn.window = window
    try:
        for sl in chunks:
            want, jcache = jlayers.attention(
                _layer0(params)["attn"], rcfg, jnp.asarray(x[:, sl]),
                jnp.asarray(pos[:, sl]), cache=jcache, window=window)
            got, pcache = attn(torch.from_numpy(x[:, sl]),
                               torch.from_numpy(pos[:, sl]), cache=pcache)
            np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    finally:
        attn.window = 0
    assert pcache["len"] == int(jcache["len"]) == 14
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(pcache[name]), _np(jcache[name]),
                                   rtol=2 ** -7, atol=2 ** -7)


def test_cache_overflow_raises():
    _, pcfg, _, model = _pair("qwen2.5-14b")
    cache = lm.init_cache(pcfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="cache full"):
        lm.forward(model, tokens=torch.zeros((1, 5), dtype=torch.int32),
                   cache=cache)


def test_moe_model_builds():
    """qwen3-moe-235b-a22b (MoE without MLA) builds: every layer routed,
    128 experts stacked per projection at full width (checked on the SMOKE
    config's 8)."""
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    model = lm.LM(cfg, device="cpu")
    assert len(model.blocks) == cfg.n_layers
    for block in model.blocks:
        assert not hasattr(block, "mlp")
        assert block.moe.experts.w_gate.shape == (
            cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
        assert block.moe.router.shape == (cfg.d_model, cfg.moe.num_experts)
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params() \
        + cfg.n_layers * (2 * cfg.d_model + cfg.d_model * cfg.moe.num_experts) \
        + cfg.d_model


def test_init_lm_is_seeded():
    cfg = get_config("qwen2.5-14b", smoke=True)
    a, b = (lm.init_lm(cfg, seed=7, device="cpu") for _ in range(2))
    c = lm.init_lm(cfg, seed=8, device="cpu")
    assert torch.equal(a.blocks[1].mlp.w_up, b.blocks[1].mlp.w_up)
    assert not torch.equal(a.blocks[1].mlp.w_up, c.blocks[1].mlp.w_up)
    # dense_init: std 1/sqrt(d_in); embed_init: std 0.02
    assert abs(float(a.blocks[0].attn.wq.std()) * 64 ** 0.5 - 1) < 0.1
    assert abs(float(a.embed.std()) / 0.02 - 1) < 0.1
    assert float(a.blocks[0].attn.bq.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# serve() end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_serve_emits_the_reference_tokens(arch):
    rcfg, pcfg, params, model = _pair(arch)
    kw = dict(batch=2, prompt_len=8, gen_len=5, max_len=32, seed=0)
    want, _ = ref_serve(arch, params=params, **kw)
    counts = [k.launches for k in LM_KERNELS]
    got, stats = serve(arch, device="cpu", params=model, **kw)
    assert [k.launches for k in LM_KERNELS] == counts   # plain versions ran
    assert got.dtype == np.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    assert stats.tokens == 10 and len(stats.logits) == 6
    # the prefill's last-position logits against the reference's
    jcache = jlm.init_cache(rcfg, 2, 32)
    prompts = np.random.default_rng(0).integers(0, rcfg.vocab, (2, 8)
                                                ).astype(np.int32)
    ref_logits, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(prompts),
                                   cache=jcache)
    np.testing.assert_allclose(_np(stats.logits[0]), _np(ref_logits[:, -1]),
                               **CACHED)


def test_serve_forced_tokens_replay_the_logits():
    """Teacher-forcing a run on its own tokens reproduces its logits: the
    yardstick ``chip_smoke.py`` uses to hold the kernels' run against the
    plain versions'."""
    _, _, _, model = _pair("qwen2.5-14b")
    kw = dict(batch=2, prompt_len=6, gen_len=4, max_len=16, device="cpu",
              params=model)
    gen, stats = serve("qwen2.5-14b", **kw)
    again, forced = serve("qwen2.5-14b", forced=gen, use_kernel=False, **kw)
    np.testing.assert_array_equal(again, gen)
    for a, b in zip(stats.logits, forced.logits):
        assert torch.equal(a, b)


def test_serve_checks_lengths():
    with pytest.raises(ValueError, match="max_len"):
        serve("qwen2.5-14b", device="cpu", prompt_len=30, gen_len=4,
              max_len=32)
