"""The port's xLSTM path on the CPU, held against the JAX package.

The mLSTM forms of :mod:`repro_torch.models.ssm` (parallel, chunkwise with
and without a carried state, the recurrent step) against
``repro.models.ssm``'s, the chunkwise form also against a loop of the
port's own step; ``slstm_forward`` in float32 and bfloat16; and the
xlstm-350m SMOKE model (one mLSTM and one sLSTM block) against the
reference's ``lm`` on weights carried over by
:mod:`repro_torch.models.convert`: its forward, a prefill into a cache and
the cache's contents, a prefill appended in two chunks, decode steps, and
``serve()``'s tokens.  Inputs are made with numpy from a seed.  With zero
biases the forget gates are ``sigmoid(~N(0, 1))`` and the state forgets
within a few tokens, so every module test and the cached model tests also
run with the forget gates' biases at +4 (``b_ifo[h:2h]``, sLSTM's
``b[2d:3d]``): the state then carries across chunk boundaries and
appended prefills.

Tolerances.  float32 throughout but for the bfloat16 sLSTM cases; both
packages sum in other orders (cumsums, einsums, matmuls) and the chunkwise
form takes exponentials of long differences, so modules are held at rtol
1e-4, atol 1e-5, as ``test_models_math.py`` holds the reference's chunkwise
form to its own recurrence, and the SMOKE model's logits (two blocks,
unembedding) at 2e-4.  The bfloat16 sLSTM's recurrence ``hs`` is held to
the reference's ``lax.scan`` within ``ref.slstm_tolerance`` (a few bfloat16
steps of each gate carried through the cell: XLA skips the rounding of the
last ``+ b`` inside its scan, which the port keeps), and its output, cast,
normed and projected in bfloat16, at 2^-6 relative and 2^-6 absolute (two
bfloat16 steps at unit scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch.serve import serve as ref_serve
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import SSMConfig as JSSMConfig

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import KERNELS, ref  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.models.config import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        lm_params_from_reference, to_tensor)

ARCH = "xlstm-350m"
MOD = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(rtol=2e-4, atol=2e-4)
BF16_OUT = dict(rtol=2.0 ** -6, atol=2.0 ** -6)
FORGET_BIAS = [0.0, 4.0]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _cfgs(dtype: str = "float32", d: int = 32, h: int = 4):
    kw = dict(name="t", family="ssm", n_layers=1, d_model=d, n_heads=h,
              n_kv_heads=h, d_head=d // h, d_ff=0, vocab=64, dtype=dtype,
              remat=False)
    return JModelConfig(**kw, ssm=JSSMConfig()), ModelConfig(**kw,
                                                             ssm=SSMConfig())


def _forget(tree: dict, kind: str, bias: float, cfg) -> dict:
    """The forget gates' biases set to ``bias`` (numpy leaves)."""
    if bias:
        if kind == "mlstm":
            h = cfg.n_heads
            tree["b_ifo"] = tree["b_ifo"].copy()
            tree["b_ifo"][h:2 * h] = bias
        else:
            d = cfg.d_model
            tree["b"] = tree["b"].copy()
            tree["b"][2 * d:3 * d] = bias
    return tree


def _module(kind: str, rcfg, pcfg, seed: int, bias: float = 0.0):
    """(reference params, the port's module holding them) for ``kind``
    (mlstm or slstm)."""
    init = jssm.init_mlstm if kind == "mlstm" else jssm.init_slstm
    p = jax.tree.map(np.asarray, init(jax.random.key(seed), rcfg))
    p = _forget(p, kind, bias, rcfg)
    m = (ssm.MLSTM if kind == "mlstm" else ssm.SLSTM)(pcfg, device="cpu")
    with torch.no_grad():
        for name, a in p.items():
            getattr(m, name).copy_(to_tensor(a, "cpu"))
    return p, m


def _x(rng, shape, dtype="float32") -> tuple[np.ndarray, torch.Tensor]:
    """numpy input (rounded to ``dtype``) for the reference and the same
    values for the port."""
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return (np.asarray(jnp.asarray(x, jnp.bfloat16)) if dtype == "bfloat16"
            else x), t


def _mlstm_state(rng, b: int, cfg) -> dict:
    h, dh = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    return {"C": 0.3 * rng.standard_normal((b, h, dh, dh)).astype(np.float32),
            "n": 0.3 * rng.standard_normal((b, h, dh)).astype(np.float32),
            "m": rng.standard_normal((b, h)).astype(np.float32) - 1.0}


def _slstm_state(rng, b: int, d: int) -> dict:
    return {"c": 0.5 * rng.standard_normal((b, d)).astype(np.float32),
            "n": rng.uniform(1.0, 3.0, (b, d)).astype(np.float32),
            "h": 0.3 * rng.standard_normal((b, d)).astype(np.float32),
            "m": rng.standard_normal((b, d)).astype(np.float32) - 1.0}


def _torch_state(st) -> dict | None:
    return None if st is None else {k: torch.from_numpy(v.copy())
                                    for k, v in st.items()}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", FORGET_BIAS)
def test_mlstm_parallel_matches(bias):
    rcfg, pcfg = _cfgs()
    p, m = _module("mlstm", rcfg, pcfg, 0, bias)
    xn, xt = _x(np.random.default_rng(1), (2, 29, 32))
    want = jssm.mlstm_parallel(p, rcfg, jnp.asarray(xn))
    got = ssm.mlstm_parallel(m, pcfg, xt)
    np.testing.assert_allclose(_np(got), _np(want), **MOD)


@pytest.mark.parametrize("bias", FORGET_BIAS)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk,s", [(4, 53), (16, 53), (37, 53), (64, 53),
                                     (256, 300)])
def test_mlstm_chunked_matches(chunk, s, with_state, bias):
    """Chunks 4 / 16 / 37 over 53 positions leave a ragged tail, as does 256
    over 300; from zeros or from a carried state: the output and the new
    (C, n, m)."""
    rcfg, pcfg = _cfgs()
    p, m = _module("mlstm", rcfg, pcfg, 2, bias)
    rng = np.random.default_rng(chunk + s)
    xn, xt = _x(rng, (2, s, 32))
    st = _mlstm_state(rng, 2, rcfg) if with_state else None
    want, wst = jssm.mlstm_chunked(p, rcfg, jnp.asarray(xn), st, chunk=chunk)
    got, gst = ssm.mlstm_chunked(m, pcfg, xt, _torch_state(st), chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **MOD)
    for k in ("C", "n", "m"):
        assert gst[k].dtype == torch.float32
        np.testing.assert_allclose(_np(gst[k]), _np(wst[k]), **MOD)


@pytest.mark.parametrize("bias", FORGET_BIAS)
def test_mlstm_chunked_matches_its_own_steps(bias):
    """The chunkwise form (chunks of 8 over 37, from a state) against a
    loop of the port's ``mlstm_step``: the outputs and the final state."""
    rcfg, pcfg = _cfgs()
    _, m = _module("mlstm", rcfg, pcfg, 3, bias)
    rng = np.random.default_rng(3)
    _, xt = _x(rng, (2, 37, 32))
    st0 = _mlstm_state(rng, 2, rcfg)
    got, gst = ssm.mlstm_chunked(m, pcfg, xt, _torch_state(st0), chunk=8)
    st, outs = _torch_state(st0), []
    for t in range(37):
        o, st = ssm.mlstm_step(m, pcfg, xt[:, t:t + 1], st)
        outs.append(o)
    np.testing.assert_allclose(_np(got), _np(torch.cat(outs, 1)), **MOD)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(_np(gst[k]), _np(st[k]), **MOD)


@pytest.mark.parametrize("bias", FORGET_BIAS)
def test_mlstm_step_matches(bias):
    """Three steps from a random state against the reference's."""
    rcfg, pcfg = _cfgs()
    p, m = _module("mlstm", rcfg, pcfg, 4, bias)
    rng = np.random.default_rng(4)
    wst = _mlstm_state(rng, 3, rcfg)
    gst = _torch_state(wst)
    for _ in range(3):
        xn, xt = _x(rng, (3, 1, 32))
        want, wst = jssm.mlstm_step(p, rcfg, jnp.asarray(xn), wst)
        got, gst = ssm.mlstm_step(m, pcfg, xt, gst)
        np.testing.assert_allclose(_np(got), _np(want), **MOD)
        for k in ("C", "n", "m"):
            np.testing.assert_allclose(_np(gst[k]), _np(wst[k]), **MOD)
    with pytest.raises(ValueError, match="one token"):
        ssm.mlstm_step(m, pcfg, torch.zeros((1, 2, 32)), gst)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _ref_scan(p, x, st):
    """The reference's recurrence alone: ``lax.scan`` of ``_slstm_cell``
    over ``x``, returning its float32 ``hs`` and final state."""
    def step(carry, x_t):
        return jssm._slstm_cell(p, x_t, carry)
    st, hs = jax.lax.scan(step, st, jnp.asarray(x).transpose(1, 0, 2))
    return hs.transpose(1, 0, 2), st


@pytest.mark.parametrize("bias", FORGET_BIAS)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_matches(dtype, s, with_state, bias):
    """``slstm_forward`` against the reference's: the output and the final
    state; the recurrence's ``hs`` against the reference's scan."""
    rcfg, pcfg = _cfgs(dtype, d=64)
    p, m = _module("slstm", rcfg, pcfg, 5, bias)
    rng = np.random.default_rng(s + 7 * with_state)
    xn, xt = _x(rng, (2, s, 64), dtype)
    st = _slstm_state(rng, 2, 64) if with_state else None
    want, wst = jssm.slstm_forward(p, rcfg, jnp.asarray(xn), st)
    got, gst = ssm.slstm_forward(m, pcfg, xt, _torch_state(st))
    assert got.dtype == getattr(torch, dtype)
    state = _torch_state(st) or ssm.init_slstm_state(pcfg, 2, device="cpu")
    xw = xt @ m.w_in
    hs, _ = ref.slstm_scan_ref(xw, m.w_rec, m.b, state)
    wst0 = st if st is not None else jax.tree.map(
        np.asarray, jssm.init_slstm_state(rcfg, 2))
    whs, _ = _ref_scan(p, xn, wst0)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **MOD)
        np.testing.assert_allclose(_np(hs), _np(whs), **MOD)
        for k in ref.SLSTM_STATE:
            np.testing.assert_allclose(_np(gst[k]), _np(wst[k]), **MOD)
        return
    tol, tol_st = ref.slstm_tolerance(xw, m.w_rec, m.b, state,
                                      skipped_rounding=True)
    assert (hs - torch.from_numpy(_np(whs))).abs().le(tol).all()
    for k in ref.SLSTM_STATE:
        assert (gst[k] - torch.from_numpy(_np(wst[k]))).abs().le(
            tol_st[k]).all(), k
    np.testing.assert_allclose(_np(got), _np(want), **BF16_OUT)


def _scan_inputs(dtype, b=3, s=24, d=64, seed=9):
    rng = np.random.default_rng(seed)
    t = getattr(torch, dtype)
    xw = torch.from_numpy(rng.standard_normal((b, s, 4 * d)).astype(
        np.float32)).to(t)
    w = torch.from_numpy((0.02 * rng.standard_normal((d, 4 * d))).astype(
        np.float32)).to(t)
    bias = torch.from_numpy(0.3 * rng.standard_normal(4 * d).astype(
        np.float32)).to(t)
    return xw, w, bias, _torch_state(_slstm_state(rng, b, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_tolerance_fails_a_dropped_recurrent_product(dtype):
    """The planted fault of the card's checks (the recurrent product left
    out of step S/2) falls outside ``slstm_tolerance`` by 10x or more, and
    the plain scan meets it against itself."""
    xw, w, bias, st = _scan_inputs(dtype)
    hs, fin = ref.slstm_scan_ref(xw, w, bias, st)
    tol, tol_st = ref.slstm_tolerance(xw, w, bias, st)
    assert tol.shape == hs.shape and bool((tol > 0).all())
    assert set(tol_st) == set(fin)
    bad, _ = ref.slstm_scan_ref(xw, w, bias, st, drop_rec_at=xw.shape[1] // 2)
    assert torch.equal(bad[:, :xw.shape[1] // 2], hs[:, :xw.shape[1] // 2])
    assert float(((bad - hs).abs() / tol).max()) >= 10


def _reordered_scan(xw, w, bias, st):
    """The plain scan with the recurrent product summed in float32 in
    another order (8-row partial sums, added last to first), as the kernel
    sums it in its own order."""
    dt, wf = xw.dtype, w.float()
    st = {k: v.float() for k, v in st.items()}
    hs = []
    for t in range(xw.shape[1]):
        hq = st["h"].to(dt).float()
        part = torch.einsum("bcv,cvn->bcn", hq.reshape(hq.shape[0], -1, 8),
                            wf.reshape(-1, 8, wf.shape[1]))
        rec = part.flip(1).sum(1).to(dt)
        st = ref.slstm_cell(((xw[:, t] + rec) + bias).float(), st)
        hs.append(st["h"])
    return torch.stack(hs, dim=1)


@pytest.mark.parametrize("state", ["zero", "random"])
@pytest.mark.parametrize("s", [1, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_tolerance_fails_a_bfloat16_sum(dtype, s, state):
    """A recurrent product summed in bfloat16 (the planted ``bf16_sum``)
    falls outside ``slstm_tolerance`` by 10x or more wherever the runs
    start from one ``h`` (from a zero state the product is 0 at step 0, so
    S 1 has nothing to catch there); the same product summed in float32 in
    another order meets it."""
    xw, w, bias, st = _scan_inputs(dtype, s=s)
    if state == "zero":
        st = {k: torch.zeros_like(v) for k, v in st.items()}
        st["m"].fill_(-1e30)
    hs, _ = ref.slstm_scan_ref(xw, w, bias, st)
    tol, _ = ref.slstm_tolerance(xw, w, bias, st)
    assert bool(((_reordered_scan(xw, w, bias, st) - hs).abs() <= tol).all())
    bad, _ = ref.slstm_scan_ref(xw, w, bias, st, bf16_sum=True)
    if state == "zero" and s == 1:
        assert torch.equal(bad, hs)
    else:
        assert float(((bad - hs).abs() / tol).max()) >= 10


def test_slstm_scan_takes_the_plain_version_on_the_cpu():
    """The wrapper on CPU tensors is the plain scan (and counts no
    launch); it leaves the state as it is and refuses what the kernel does
    not take."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.slstm import slstm_scan
    xw, w, bias, st = _scan_inputs("float32", b=2, s=5)
    before = {k: v.clone() for k, v in st.items()}
    n = slstm_scan.launches
    got, fin = ops.slstm_scan(xw, w, bias, st)
    want, wfin = ref.slstm_scan_ref(xw, w, bias, st)
    assert slstm_scan.launches == n
    assert torch.equal(got, want) and all(torch.equal(fin[k], wfin[k])
                                          for k in fin)
    assert all(torch.equal(st[k], before[k]) for k in st)
    with pytest.raises(TypeError, match="one dtype"):
        slstm_scan(xw, w.bfloat16(), bias, st)
    with pytest.raises(ValueError, match="4d"):
        slstm_scan(xw[..., :-1], w, bias, st)
    with pytest.raises(ValueError, match="state"):
        slstm_scan(xw, w, bias, {k: v for k, v in st.items() if k != "m"})


# ---------------------------------------------------------------------------
# the SMOKE model: forward, caches, serve
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def _pair(bias: float = 0.0):
    """(reference cfg, port cfg, reference params, port model) of the
    xlstm-350m SMOKE config (layer 0 mLSTM, layer 1 sLSTM), norms jittered
    from numpy, the forget gates' biases at ``bias``."""
    if bias not in _CACHE:
        rcfg, pcfg = ref_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
        params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(1), rcfg))
        rng = np.random.default_rng(1)
        for layer in params["layers"]:
            kind = "slstm" if "slstm" in layer else "mlstm"
            layer["ln1"] = (1 + 0.1 * rng.standard_normal(
                layer["ln1"].shape)).astype(layer["ln1"].dtype)
            layer[kind]["norm"] = (1 + 0.1 * rng.standard_normal(
                layer[kind]["norm"].shape)).astype(np.float32)
            _forget(layer[kind], kind, bias, rcfg)
        _CACHE[bias] = (rcfg, pcfg, params,
                        lm_params_from_reference(pcfg, params, device="cpu"))
    return _CACHE[bias]


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def test_xlstm_model_builds():
    """xlstm-350m builds at its SMOKE width with the reference's layout
    (layer 0 mLSTM, layer 1 sLSTM; no ``ln2``, no MLP) and as many
    parameters as the reference's ``init_lm`` has leaf elements; at full
    size layers 7, 15 and 23 of 24 are sLSTM."""
    rcfg, pcfg = ref_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    model = lm.LM(pcfg, device="cpu")
    ref_leaves = jax.tree.leaves(jax.eval_shape(
        lambda: jlm.init_lm(jax.random.key(0), rcfg)))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(x.shape)) for x in ref_leaves)
    assert hasattr(model.blocks[0], "mlstm") and hasattr(model.blocks[1],
                                                         "slstm")
    assert not any(hasattr(b, n) for b in model.blocks
                   for n in ("ln2", "mlp", "attn", "moe"))
    full = get_config(ARCH)
    assert [i for i in range(full.n_layers) if lm.is_slstm(full, i)] == \
        [7, 15, 23] == [i for i in range(full.n_layers)
                        if jlm._is_slstm(ref_config(ARCH), i)]


def test_eight_layer_xlstm_has_slstm_at_layer_seven():
    """A tiny 8-layer xLSTM (slstm_every 8): layer 7 alone is sLSTM, in the
    port's model and its cache as in the reference's."""
    kw = dict(name="x8", family="ssm", n_layers=8, d_model=16, n_heads=2,
              n_kv_heads=2, d_head=8, d_ff=0, vocab=32, dtype="float32",
              remat=False, scan_layers=False)
    rcfg = JModelConfig(**kw, ssm=JSSMConfig(slstm_every=8))
    pcfg = ModelConfig(**kw, ssm=SSMConfig(slstm_every=8))
    model = lm.LM(pcfg, device="cpu")
    kinds = ["slstm" if hasattr(b, "slstm") else "mlstm"
             for b in model.blocks]
    assert kinds == ["mlstm"] * 7 + ["slstm"]
    params = jlm.init_lm(jax.random.key(0), rcfg)
    assert ["slstm" if "slstm" in t else "mlstm"
            for t in params["layers"]] == kinds
    cache = lm.init_cache(pcfg, 2, 4, device="cpu")
    assert [set(c["state"]) for c in cache["layers"]] == \
        [{"C", "n", "m"}] * 7 + [{"c", "n", "h", "m"}]


def test_xlstm_forward_matches():
    rcfg, pcfg, params, model = _pair()
    toks = _tokens(rcfg, 2, 23)
    got, cache, _ = lm.forward(model, tokens=torch.from_numpy(toks))
    want, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks))
    assert cache is None and got.shape == (2, 23, rcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL)


@pytest.mark.parametrize("bias", FORGET_BIAS)
def test_xlstm_prefill_then_decode_matches(bias):
    """A prefill of 18 into a cache, then three decode steps: logits and
    the whole cache (every layer's float32 state) against the
    reference's."""
    rcfg, pcfg, params, model = _pair(bias)
    b, s = 2, 18
    toks = _tokens(rcfg, b, s + 3, seed=4)
    jcache = jlm.init_cache(rcfg, b, 32)
    pcache = lm.init_cache(pcfg, b, 32, device="cpu")
    state_ids = [id(v) for c in pcache["layers"] for v in c["state"].values()]
    want, jcache, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, :s]),
                                  cache=jcache)
    got, pcache, _ = lm.forward(model, tokens=torch.from_numpy(toks[:, :s]),
                                cache=pcache)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL)
    for i in range(s, s + 3):
        want, jcache = jlm.serve_step(params, rcfg, jcache,
                                      tokens=jnp.asarray(toks[:, i:i + 1]))
        got, pcache = lm.serve_step(model, pcache,
                                    tokens=torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(_np(got), _np(want), **MODEL)
    # the state was updated in place
    assert [id(v) for c in pcache["layers"]
            for v in c["state"].values()] == state_ids
    ref_cache = cache_from_reference(pcfg, jax.tree.map(np.asarray, jcache),
                                     device="cpu")
    assert pcache["pos"] == ref_cache["pos"] == s + 3
    for mine, theirs in zip(pcache["layers"], ref_cache["layers"]):
        assert set(mine["state"]) == set(theirs["state"])
        for k, v in mine["state"].items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(_np(v), _np(theirs["state"][k]),
                                       **MODEL)


@pytest.mark.parametrize("bias", FORGET_BIAS)
def test_xlstm_appended_prefill_matches(bias):
    """A prefill in two chunks (11, then 12 from the cached state) gives
    one prefill's logits and the reference's forward with a cache over
    the same two chunks, at every position of the second chunk."""
    rcfg, pcfg, params, model = _pair(bias)
    b, s1, s2 = 2, 11, 12
    toks = _tokens(rcfg, b, s1 + s2, seed=7)
    one, _, _ = lm.forward(model, tokens=torch.from_numpy(toks),
                           cache=lm.init_cache(pcfg, b, 32, device="cpu"))
    cache = lm.init_cache(pcfg, b, 32, device="cpu")
    lm.forward(model, tokens=torch.from_numpy(toks[:, :s1]), cache=cache)
    two, _, _ = lm.forward(model, tokens=torch.from_numpy(toks[:, s1:]),
                           cache=cache)
    jcache = jlm.init_cache(rcfg, b, 32)
    _, jcache, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, :s1]),
                               cache=jcache)
    want, _, _ = jlm.forward(params, rcfg, tokens=jnp.asarray(toks[:, s1:]),
                             cache=jcache)
    np.testing.assert_allclose(_np(two), _np(want), **MODEL)
    np.testing.assert_allclose(_np(two), _np(one[:, s1:]), **MODEL)


def test_xlstm_serve_emits_the_reference_tokens():
    """``serve()`` on the CPU: the reference's tokens, on the plain
    versions (no kernel launch counted)."""
    rcfg, pcfg, params, model = _pair()
    kw = dict(batch=2, prompt_len=20, gen_len=6, max_len=32, seed=0)
    want, _ = ref_serve(ARCH, params=params, **kw)
    counts = [k.launches for k in KERNELS]
    got, stats = serve(ARCH, device="cpu", params=model, **kw)
    assert [k.launches for k in KERNELS] == counts
    np.testing.assert_array_equal(got, want)
    assert stats.tokens == 12 and len(stats.logits) == 7


def test_xlstm_serve_default_weights_run():
    """``serve("xlstm-350m", smoke=True, device="cpu")`` with its own
    seeded weights: tokens in the vocabulary, finite logits, and the same
    tokens from a second run."""
    kw = dict(smoke=True, device="cpu", batch=2, prompt_len=12, gen_len=4,
              max_len=24)
    a, sa = serve(ARCH, **kw)
    b, _ = serve(ARCH, **kw)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 4) and ((a >= 0) & (a < 256)).all()
    assert all(bool(torch.isfinite(x).all()) for x in sa.logits)
