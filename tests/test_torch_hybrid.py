"""The port's Hymba (hybrid) path on the CPU, held against the JAX package.

The Mamba (S6) head of :mod:`repro_torch.models.hybrid` against
``repro.models.hybrid.mamba_forward`` (chunked and decode), the mixer
(attention with a sliding window beside the Mamba head) against
``hymba_mixer``, and the hymba-1.5b SMOKE model (2 layers, window 8, layer 0
global) against the reference's ``lm`` on weights carried over by
:mod:`repro_torch.models.convert`: its forward, a prefill into a cache, an
appended prefill and decode steps, and ``serve()``'s tokens.  Inputs are
made with numpy from a seed.

Tolerances.  Both sides compute in float32 with their sums in other orders:
the scan is held at rtol 1e-4, atol 1e-6, as ``test_models_math.py`` holds
the reference's chunked scan to its own single chunk; single layers at
2e-5; logits through the bfloat16 KV cache at 2e-3, where one rounding of a
key to bfloat16 may go the other way (as ``test_torch_lm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch.serve import serve as ref_serve
from repro.models import hybrid as jhybrid
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import SSMConfig as JSSMConfig

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import LM_KERNELS  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import hybrid, layers, lm  # noqa: E402
from repro_torch.models.config import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        lm_params_from_reference, to_tensor)

ARCH = "hymba-1.5b"
SCAN = dict(rtol=1e-4, atol=1e-6)
LAYER = dict(rtol=2e-5, atol=2e-5)
CACHED = dict(rtol=2e-3, atol=2e-3)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _mamba_pair(seed: int = 4):
    """A float32 Mamba head of width 32 (di 64, n 8, K 4) in both packages,
    the port's holding the reference's ``init_mamba`` arrays."""
    kw = dict(name="h", family="hybrid", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=2, d_head=8, d_ff=64, vocab=64, dtype="float32",
              remat=False)
    rcfg = JModelConfig(**kw, ssm=JSSMConfig(state_dim=8, conv_dim=4,
                                             expand=2))
    pcfg = ModelConfig(**kw, ssm=SSMConfig(state_dim=8, conv_dim=4, expand=2))
    p = jax.tree.map(np.asarray, jhybrid.init_mamba(jax.random.key(seed), rcfg))
    rng = np.random.default_rng(seed)
    # a spread of step sizes, so that the decays are not all near 1
    p["dt_bias"] = (rng.standard_normal(1) - 1.0).astype(np.float32)
    m = hybrid.Mamba(pcfg, device="cpu")
    with torch.no_grad():
        for name, a in p.items():
            getattr(m, name).copy_(to_tensor(a, "cpu"))
    return rcfg, pcfg, p, m


def _state(rng, b, rcfg):
    di = rcfg.d_model * rcfg.ssm.expand
    return {"conv": rng.standard_normal(
                (b, rcfg.ssm.conv_dim - 1, di)).astype(np.float32),
            "ssm": 0.5 * rng.standard_normal(
                (b, di, rcfg.ssm.state_dim)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the Mamba head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 32, 128])
def test_mamba_forward_matches(chunk, with_state):
    """S 53 (off every chunk), from zeros or from a carried state: the
    output and the new conv tail and scan state."""
    rcfg, pcfg, p, m = _mamba_pair()
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 53, 32)).astype(np.float32)
    st = _state(rng, 2, rcfg) if with_state else None
    want, wst = jhybrid.mamba_forward(p, rcfg, jnp.asarray(x), state=st,
                                      chunk=chunk)
    got, gst = hybrid.mamba_forward(
        m, pcfg, torch.from_numpy(x), chunk=chunk,
        state=None if st is None else {k: torch.from_numpy(v)
                                       for k, v in st.items()})
    np.testing.assert_allclose(_np(got), _np(want), **SCAN)
    np.testing.assert_allclose(_np(gst["ssm"]), _np(wst["ssm"]), **SCAN)
    np.testing.assert_array_equal(_np(gst["conv"]), _np(wst["conv"]))
    assert gst["ssm"].dtype == torch.float32


def test_mamba_decode_step_matches():
    """The fast path (one token with a state) against the reference's, and
    against the port's own chunked pass over the whole sequence."""
    rcfg, pcfg, p, m = _mamba_pair(seed=6)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 21, 32)).astype(np.float32)
    _, wst = jhybrid.mamba_forward(p, rcfg, jnp.asarray(x[:, :20]), chunk=8)
    full, _ = hybrid.mamba_forward(m, pcfg, torch.from_numpy(x), chunk=8)
    _, gst = hybrid.mamba_forward(m, pcfg, torch.from_numpy(x[:, :20]), chunk=8)
    want, wnext = jhybrid.mamba_forward(p, rcfg, jnp.asarray(x[:, 20:]),
                                        state=wst)
    got, gnext = hybrid.mamba_forward(m, pcfg, torch.from_numpy(x[:, 20:]),
                                      state=gst)
    np.testing.assert_allclose(_np(got), _np(want), **SCAN)
    np.testing.assert_allclose(_np(gnext["ssm"]), _np(wnext["ssm"]), **SCAN)
    np.testing.assert_allclose(_np(got), _np(full[:, 20:]), **SCAN)


def test_scan_matches_the_recurrence():
    """The log-depth scan gives ``h_t = a_t h_{t-1} + b_t`` from 0, at
    lengths on and off a power of two."""
    g = torch.Generator().manual_seed(3)
    for n in (1, 5, 16, 37):
        a = torch.rand((2, n, 3, 4), generator=g)
        b = torch.randn((2, n, 3, 4), generator=g)
        h, want = torch.zeros((2, 3, 4)), []
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        np.testing.assert_allclose(hybrid._scan(a.clone(), b.clone()).numpy(),
                                   torch.stack(want, 1).numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_causal_conv_matches_bit_for_bit():
    """The K products summed in the reference's order, with and without a
    tail from the past."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for st in (None, tail):
        want, wtail = jhybrid._causal_conv(
            jnp.asarray(x), jnp.asarray(w), None if st is None else jnp.asarray(st))
        got, gtail = hybrid._causal_conv(
            torch.from_numpy(x), torch.from_numpy(w),
            None if st is None else torch.from_numpy(st))
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(gtail), _np(wtail))


# ---------------------------------------------------------------------------
# the SMOKE model: mixer, forward, caches, serve
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def _pair():
    """(reference cfg, port cfg, reference params, port model) of the
    hymba-1.5b SMOKE config, norms and scales jittered from numpy."""
    if not _CACHE:
        rcfg, pcfg = ref_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
        params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(1), rcfg))
        rng = np.random.default_rng(1)
        for layer in params["layers"]:
            for tree, names in ((layer, ("ln1", "ln2")), (layer["mixer"], (
                    "attn_scale", "mamba_scale", "attn_norm", "mamba_norm"))):
                for name in names:
                    tree[name] = (1.0 + 0.1 * rng.standard_normal(
                        tree[name].shape)).astype(tree[name].dtype)
        _CACHE["pair"] = (rcfg, pcfg, params,
                          lm_params_from_reference(pcfg, params, device="cpu"))
    return _CACHE["pair"]


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def test_hybrid_model_builds():
    """hymba-1.5b builds at its SMOKE width: a mixer in every layer, the
    window off in the global layers, and as many parameters as the
    reference's ``init_lm`` has leaf elements; float32 ``log_a`` and
    ``d_skip`` in a bfloat16 model."""
    rcfg, pcfg = ref_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    model = lm.LM(pcfg, device="cpu")
    ref_leaves = jax.tree.leaves(jax.eval_shape(
        lambda: jlm.init_lm(jax.random.key(0), rcfg)))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(x.shape)) for x in ref_leaves)
    windows = [b.mixer.attn.window for b in model.blocks]
    assert windows == [0 if i in pcfg.global_attn_layers else 8
                       for i in range(pcfg.n_layers)]
    full = get_config(ARCH)
    assert [lm.layer_window(full, i) for i in (0, 1, 15, 30, 31)] == \
        [0, 1024, 0, 1024, 0]
    bf = lm.LM(ModelConfig(**{**pcfg.__dict__, "dtype": "bfloat16"}),
               device="cpu")
    mamba = bf.blocks[0].mixer.mamba
    assert mamba.log_a.dtype == mamba.d_skip.dtype == torch.float32
    assert mamba.w_in.dtype == mamba.dt_bias.dtype == torch.bfloat16


def test_hymba_mixer_matches_with_window_and_cache():
    """Layer 1's mixer (window 8) over a prompt of 13 into a cache, then a
    decoded token: outputs and the cache against ``hymba_mixer``'s."""
    rcfg, pcfg, params, model = _pair()
    mixer, rp = model.blocks[1].mixer, params["layers"][1]["mixer"]
    assert mixer.attn.window == 8
    b, s = 2, 13
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s + 1, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 1), (b, s + 1)).astype(np.int32)
    one = jlm.init_cache(rcfg, b, 32)["layers"][1]
    pcache = lm.init_cache(pcfg, b, 32, device="cpu")["layers"][1]
    for sl in (slice(0, s), slice(s, s + 1)):
        want, one = jhybrid.hymba_mixer(rp, rcfg, jnp.asarray(x[:, sl]),
                                        jnp.asarray(pos[:, sl]), window=8,
                                        cache=one)
        got, pcache = mixer(torch.from_numpy(x[:, sl]),
                            torch.from_numpy(pos[:, sl]), cache=pcache)
        np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    np.testing.assert_allclose(_np(pcache["ssm"]["ssm"]),
                               _np(one["ssm"]["ssm"]), **CACHED)
    assert pcache["attn"]["len"] == int(one["attn"]["len"]) == s + 1


def test_hymba_mixer_without_cache_matches():
    rcfg, pcfg, params, model = _pair()
    x = np.random.default_rng(6).standard_normal((2, 19, rcfg.d_model)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(19), (2, 19)).astype(np.int32)
    for i in range(rcfg.n_layers):
        window = model.blocks[i].mixer.attn.window
        want, _ = jhybrid.hymba_mixer(params["layers"][i]["mixer"], rcfg,
                                      jnp.asarray(x), jnp.asarray(pos),
                                      window=window)
        for use_kernel in (True, False):
            got, _ = model.blocks[i].mixer(torch.from_numpy(x),
                                           torch.from_numpy(pos),
                                           use_kernel=use_kernel)
            np.testing.assert_allclose(_np(got), _np(want), **LAYER)


def test_hymba_forward_matches():
    rcfg, pcfg, params, model = _pair()
    toks = _tokens(rcfg, 2, 23)
    got, cache, _ = lm.forward(model, tokens=torch.from_numpy(toks))
    want, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks))
    assert cache is None and got.shape == (2, 23, rcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


def test_hymba_prefill_then_decode_matches():
    """A prefill of 18 (past the window of 8) into a cache, then three
    decode steps: logits and the whole cache against the reference's."""
    rcfg, pcfg, params, model = _pair()
    b, s, max_len = 2, 18, 32
    toks = _tokens(rcfg, b, s + 3, seed=4)
    jcache = jlm.init_cache(rcfg, b, max_len)
    pcache = lm.init_cache(pcfg, b, max_len, device="cpu")
    want, jcache, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, :s]),
                                  cache=jcache)
    got, pcache, _ = lm.forward(model, tokens=torch.from_numpy(toks[:, :s]),
                                cache=pcache)
    np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    for i in range(s, s + 3):
        want, jcache = jlm.serve_step(params, rcfg, jcache,
                                      tokens=jnp.asarray(toks[:, i:i + 1]))
        got, pcache = lm.serve_step(model, pcache,
                                    tokens=torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    ref_cache = cache_from_reference(pcfg, jax.tree.map(np.asarray, jcache),
                                     device="cpu")
    assert pcache["pos"] == ref_cache["pos"] == s + 3
    for mine, theirs in zip(pcache["layers"], ref_cache["layers"]):
        assert mine["attn"]["len"] == theirs["attn"]["len"] == s + 3
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(mine["attn"][name]),
                                       _np(theirs["attn"][name]),
                                       rtol=2 ** -7, atol=2 ** -7)
        assert mine["ssm"]["ssm"].dtype == torch.float32
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(_np(mine["ssm"][name]),
                                       _np(theirs["ssm"][name]), **CACHED)


def test_hymba_appended_prefill_matches():
    """A prefill in two chunks (11, then 12 appended on the flash slot)
    gives one prefill's logits, and the reference's forward with a cache
    over the same two chunks; the appended chunk never reaches the fused
    plain attention."""
    rcfg, pcfg, params, model = _pair()
    b, s1, s2 = 2, 11, 12
    toks = _tokens(rcfg, b, s1 + s2, seed=7)
    whole = lm.init_cache(pcfg, b, 32, device="cpu")
    one, _, _ = lm.forward(model, tokens=torch.from_numpy(toks), cache=whole)
    calls = []
    fused = layers._sdpa_fused
    layers._sdpa_fused = lambda *a, **k: calls.append(1) or fused(*a, **k)
    try:
        cache = lm.init_cache(pcfg, b, 32, device="cpu")
        lm.forward(model, tokens=torch.from_numpy(toks[:, :s1]), cache=cache)
        two, _, _ = lm.forward(model, tokens=torch.from_numpy(toks[:, s1:]),
                               cache=cache)
    finally:
        layers._sdpa_fused = fused
    assert not calls
    jcache = jlm.init_cache(rcfg, b, 32)
    _, jcache, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, :s1]),
                               cache=jcache)
    want, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, s1:]),
                             cache=jcache)
    np.testing.assert_allclose(_np(two), _np(want), **CACHED)
    np.testing.assert_allclose(_np(two), _np(one[:, s1:]), **CACHED)


def test_hymba_serve_emits_the_reference_tokens():
    """``serve()`` on the CPU: the reference's tokens from 20-token prompts
    (the window of 8 live), on the plain versions."""
    rcfg, pcfg, params, model = _pair()
    kw = dict(batch=2, prompt_len=20, gen_len=6, max_len=32, seed=0)
    want, _ = ref_serve(ARCH, params=params, **kw)
    counts = [k.launches for k in LM_KERNELS]
    got, stats = serve(ARCH, device="cpu", params=model, **kw)
    assert [k.launches for k in LM_KERNELS] == counts
    np.testing.assert_array_equal(got, want)
    assert stats.tokens == 12 and len(stats.logits) == 7


def test_hymba_serve_default_weights_run():
    """``serve("hymba-1.5b", smoke=True, device="cpu")`` with its own
    seeded weights: tokens in the vocabulary, finite logits, and the same
    tokens from a second run."""
    kw = dict(smoke=True, device="cpu", batch=2, prompt_len=12, gen_len=4,
              max_len=24)
    a, sa = serve(ARCH, **kw)
    b, _ = serve(ARCH, **kw)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 4) and ((a >= 0) & (a < 256)).all()
    assert all(bool(torch.isfinite(x).all()) for x in sa.logits)
