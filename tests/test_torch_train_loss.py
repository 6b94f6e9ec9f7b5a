"""The port's training objective and its gradients on the CPU, held against
the JAX package's, for every architecture.

For each entry of ``ARCHS`` at SMOKE (pixtral-12b and musicgen-large fed
embeddings, Hymba and xLSTM included), the reference's ``lm.init_lm``
weights, every array jittered from numpy (so that norms, biases and the
experts of a MoE stack differ), are carried into the port; one batch (two
masked labels) goes through ``jax.value_and_grad(lm.train_loss)`` and
through the port's ``lm.train_loss`` and autograd.  The counterpart of the
reference's ``test_smoke_forward_and_train_step``.

Tolerances.  The SMOKE configs compute in float32, and the two frameworks
order their float32 sums differently: the loss to rtol 1e-5, and every
gradient element within 2e-5 of the largest |element| of its parameter's
reference gradient (the largest such difference seen is 2.8e-6).  A
parameter the loss reaches in the reference must get a nonzero gradient.
In bfloat16 (the dense models, ``dataclasses.replace(cfg,
dtype="bfloat16")``) a rounding may fall either way in each framework:
the loss to rtol 2e-4 and each gradient to a relative norm error of 6e-2
(at most 1.7e-5 and 3.3e-2 seen, the latter the key bias's gradient, which
is small: a bias added to every key shifts each query's logits by nearly
one constant).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS, get_config as ref_config
from repro.models import frontends as jfront
from repro.models import hybrid as jhybrid
from repro.models import lm as jlm

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import frontends, hybrid, layers, lm  # noqa: E402
from repro_torch.models.convert import (lm_params_from_reference,  # noqa: E402
                                        named_from_reference, to_tensor)

F32_LOSS, F32_GRAD = 1e-5, 2e-5
BF16_LOSS, BF16_GRAD = 2e-4, 6e-2


def jittered(params: dict, seed: int) -> dict:
    """Every leaf plus normal noise: 0.1 for a vector, 0.1 of the leaf's
    std for a matrix (a MoE stack's repeated experts become distinct)."""
    rng = np.random.default_rng(seed)

    def j(a):
        a = np.asarray(a)
        s = 0.1 if a.ndim <= 1 else 0.1 * float(np.std(a.astype(np.float32)))
        return (a.astype(np.float32)
                + s * rng.standard_normal(a.shape)).astype(a.dtype)
    return jax.tree.map(j, params)


def batch_for(cfg, seed: int, b: int = 2, s: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out["labels"][0, :2] = -1                   # masked positions
    if cfg.modality == "text":
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    else:
        out["embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def reference_and_port(arch: str, dtype: str | None = None, seed: int = 0,
                       s: int = 24, **changes):
    """``(ref loss, ref grads keyed as the port's, port loss, port grads,
    model)`` for one batch of 2 x ``s`` tokens; ``changes`` replace fields
    of both SMOKE configs (``dtype`` too)."""
    if dtype:
        changes["dtype"] = dtype
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), **changes)
    pcfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    params = jittered(jax.tree.map(np.asarray, jlm.init_lm(
        jax.random.key(seed), rcfg)), seed + 1)
    batch = batch_for(rcfg, seed + 2, s=s)
    jl, jg = jax.value_and_grad(lambda p: jlm.train_loss(
        p, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, params))
    model = lm_params_from_reference(pcfg, params, device="cpu")
    model.requires_grad_(True)
    loss = lm.train_loss(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return (float(jl), named_from_reference(model, jax.tree.map(np.asarray, jg)),
            loss.detach(), dict(zip(named, grads)), model)


def held_to_reference(jl, want, loss, got) -> None:
    """The loss to ``F32_LOSS``, every gradient element within
    ``F32_GRAD`` of its parameter's largest reference element, and a
    gradient wherever the reference's reaches."""
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert float(loss) == pytest.approx(jl, rel=F32_LOSS)
    assert list(got) == list(want)
    for name, g in got.items():
        w = want[name].float()
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        scale = float(w.abs().max())
        if scale > 0:                   # the reference's gradient reaches it
            assert float(g.abs().max()) > 0, f"{name} got no gradient"
        assert float((g.float() - w).abs().max()) <= F32_GRAD * scale, name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_reference(arch):
    jl, want, loss, got, model = reference_and_port(arch)
    held_to_reference(jl, want, loss, got)
    # only the token table of an embeddings-fed model goes without
    zero = [n for n, g in got.items() if float(g.abs().max()) == 0]
    assert zero == (["embed"] if model.cfg.modality != "text" else [])


@pytest.mark.parametrize("arch, s, changes", [
    # three Mamba chunks of 128 carried, a ragged tail of 44; the window
    # of 8 crossed in the windowed layer
    ("hymba-1.5b", 300, {}),
    # three mLSTM chunks of 256, a ragged tail of 88; 600 sLSTM steps
    ("xlstm-350m", 600, {}),
    # capacity factor 0.5: 128 tokens, 256 assignments over 8 experts of
    # 24 slots, so that tokens are dropped
    ("deepseek-v2-236b", 64, {"capacity": 0.5}),
], ids=["hymba-1.5b-S300", "xlstm-350m-S600", "deepseek-v2-236b-drops"])
def test_train_loss_and_gradients_across_the_mixers_chunks(arch, s, changes,
                                                           monkeypatch):
    """The training loss and every gradient against the reference's at
    lengths that cross the mixers' chunks (and, for DeepSeek-V2, with
    capacity drops, counted through the port's buffer builder)."""
    from repro_torch.models import moe
    kw = {}
    if "capacity" in changes:
        kw["moe"] = dataclasses.replace(
            get_config(arch, smoke=True).moe,
            capacity_factor=changes["capacity"])
    dropped = []
    real = moe._build_buffers

    def counted(*a, **k):
        out = real(*a, **k)
        dropped.append(int((~out[2][1]).sum()))
        return out
    monkeypatch.setattr(moe, "_build_buffers", counted)
    jl, want, loss, got, _ = reference_and_port(arch, s=s, **kw)
    held_to_reference(jl, want, loss, got)
    if kw:
        assert dropped and all(n > 0 for n in dropped), dropped


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-34b"])
def test_dense_train_loss_and_gradients_in_bf16(arch):
    jl, want, loss, got, _ = reference_and_port(arch, dtype="bfloat16")
    assert float(loss) == pytest.approx(jl, rel=BF16_LOSS)
    for name, g in got.items():
        assert g.dtype == torch.bfloat16, name
        w = want[name].float()
        err = float((g.float() - w).norm() / w.norm())
        assert err <= BF16_GRAD, (name, err)


def test_a_dropped_gradient_fails_the_comparison():
    """The control: a parameter cut from the graph (its attention output
    detached in one layer) misses the bound."""
    jl, want, _, _, model = reference_and_port("qwen2.5-14b")
    attn = model.blocks[1].attn
    orig = type(attn).forward

    def detached(self, *a, **k):
        out, cache = orig(self, *a, **k)
        return (out.detach() if self is attn else out), cache
    type(attn).forward = detached
    try:
        batch = batch_for(ref_config("qwen2.5-14b", smoke=True), 2)
        loss = lm.train_loss(model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        g = torch.autograd.grad(loss, [attn.wq], allow_unused=True,
                                materialize_grads=True)[0]
    finally:
        type(attn).forward = orig
    w = want["blocks.1.attn.wq"]
    assert float((g - w).abs().max()) > 100 * F32_GRAD * float(w.abs().max())


def test_embeds_forward_matches_reference():
    """``forward(embeds=...)`` (and ``serve_step``'s) against the
    reference's, for the vlm backbone."""
    rcfg, pcfg = ref_config("pixtral-12b", smoke=True), get_config(
        "pixtral-12b", smoke=True)
    params = jittered(jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(3),
                                                           rcfg)), 4)
    emb = batch_for(rcfg, 5)["embeds"]
    want, _, _ = jlm.forward(params, rcfg, embeds=jnp.asarray(emb))
    model = lm_params_from_reference(pcfg, params, device="cpu")
    got, _, aux = lm.forward(model, embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert float(aux) == 0.0
    cache = lm.init_cache(pcfg, 2, 32, device="cpu")
    jcache = jlm.init_cache(rcfg, 2, 32)
    _, jcache, _ = jlm.forward(params, rcfg, embeds=jnp.asarray(emb),
                               cache=jcache)
    _, cache, _ = lm.forward(model, embeds=torch.from_numpy(emb), cache=cache)
    step = emb[:, :1] * 0.5
    jstep, _ = jlm.serve_step(params, rcfg, jcache, embeds=jnp.asarray(step))
    pstep, _ = lm.serve_step(model, cache, embeds=torch.from_numpy(step))
    np.testing.assert_allclose(pstep.numpy(), np.asarray(jstep), rtol=2e-3,
                               atol=2e-3)          # through the bf16 cache
    with pytest.raises(ValueError, match="tokens or embeds"):
        lm.forward(model)


def test_training_forward_equals_the_plain_forward():
    """``train=True`` without remat is the ``use_kernel=False`` forward;
    with ``cfg.remat`` (each block under ``torch.utils.checkpoint``) the
    loss and gradients are the same bits."""
    cfg = get_config("qwen2.5-14b", smoke=True)
    model = lm.init_lm(cfg, seed=1, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    plain, _, _ = lm.forward(model, tokens=tokens, use_kernel=False)
    trained, _, _ = lm.forward(model, tokens=tokens, train=True)
    assert torch.equal(plain, trained)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    model.requires_grad_(True)
    out = []
    for remat in (False, True):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss = lm.train_loss(model, batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    with pytest.raises(ValueError, match="no cache"):
        lm.forward(model, tokens=tokens, train=True,
                   cache=lm.init_cache(cfg, 2, 16, device="cpu"))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
def test_moe_training_forward_is_the_plain_forward(arch):
    """An MoE model's training forward runs the ``use_kernel=False`` path
    (the grouped matmul's plain version over the padded capacity buffers,
    routed and shared): the same logits and router loss; with remat the
    same loss and gradients, and every expert stack gets a gradient."""
    cfg = get_config(arch, smoke=True)
    model = lm.init_lm(cfg, seed=2, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    plain, _, aux = lm.forward(model, tokens=tokens, use_kernel=False)
    trained, _, taux = lm.forward(model, tokens=tokens, train=True)
    assert torch.equal(plain, trained) and torch.equal(aux, taux)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    model.requires_grad_(True)
    out = []
    for remat in (False, True):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss = lm.train_loss(model, batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    names = [n for n, _ in model.named_parameters()]
    experts = [g for n, g in zip(names, out[0][1]) if ".experts." in n
               or ".shared." in n]
    assert experts and all(bool(g.abs().max() > 0) for g in experts)


def _scan_out_of_place(a, b):
    """The Mamba training scan before ``hybrid._Scan``: the log-depth steps
    out of place, differentiated by autograd step by step."""
    off, n = 1, a.shape[1]
    while off < n:
        b = torch.cat([b[:, :off], b[:, off:] + b[:, :-off] * a[:, off:]],
                      dim=1)
        if 2 * off < n:
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


@pytest.mark.parametrize("chunk", [8, 16, 128])
def test_hymba_scan_out_of_place_is_the_in_place_scan(chunk):
    """The Mamba scan under autograd (``hybrid._Scan``) against the serving
    form (in place) and the out-of-place steps it replaced: the same
    operator in the same order, bit for bit, for the scan alone and the
    whole mixer's output; its gradients (the reverse recurrence) against
    autograd of the out-of-place steps within float32's rounding."""
    g = torch.Generator().manual_seed(chunk)
    a = torch.rand((2, chunk, 6, 4), generator=g)
    b = torch.randn((2, chunk, 6, 4), generator=g)
    want = hybrid._scan(a.clone(), b.clone())
    ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    got = hybrid._scan(ag, bg)
    old = _scan_out_of_place(ag, bg)
    assert got.grad_fn is not None and torch.equal(got, want)
    assert torch.equal(old, want)
    w = torch.randn(got.shape, generator=g)
    new_g = torch.autograd.grad((got * w).sum(), [ag, bg])
    old_g = torch.autograd.grad((old * w).sum(), [ag, bg])
    for x, y in zip(new_g, old_g):
        assert float((x - y).abs().max()) <= F32_GRAD * float(y.abs().max())
    assert float(new_g[0][:, 0].abs().max()) == 0.0     # h_{-1} is 0

    cfg = get_config("hymba-1.5b", smoke=True)
    model = lm.init_lm(cfg, seed=2, device="cpu")
    mamba = model.blocks[0].mixer.mamba
    x = torch.randn((2, 37, cfg.d_model), generator=g)
    want, st = hybrid.mamba_forward(mamba, cfg, x, chunk=chunk)
    model.requires_grad_(True)
    got, st2 = hybrid.mamba_forward(mamba, cfg, x, chunk=chunk)
    assert got.grad_fn is not None
    assert torch.equal(got, want) and torch.equal(st["ssm"], st2["ssm"])


@pytest.mark.parametrize("block", [8, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_scan_under_autograd_is_the_loop(dtype, block, monkeypatch):
    """The sLSTM recurrence under autograd (``ref._SLSTMScan``) against
    the plain loop of ``slstm_pre`` and ``slstm_cell``: its outputs and
    final state bit for bit; in float32 its gradients (the reverse loop)
    against autograd of the loop for every input, the state included,
    within float32's rounding.  (In bf16 each backward step rounds ``dh``
    to bf16 on both sides, and the two orders of float32 work before it
    round some elements apart: the forward alone is held.)  Over 37
    steps in blocks of 8 (four blocks carried and a tail of 5, the loops'
    block structure on the card) and of 128 (one block of all 37)."""
    from repro_torch.kernels import ref
    monkeypatch.setattr(ref, "SLSTM_BLOCK", block)
    g = torch.Generator().manual_seed(5)
    dt = getattr(torch, dtype)
    b_, s, d = 3, 37, 16
    xw = torch.randn((b_, s, 4 * d), generator=g).to(dt).requires_grad_(True)
    w = (0.3 * torch.randn((d, 4 * d), generator=g)).to(dt).requires_grad_(
        True)
    bias = (0.5 * torch.randn(4 * d, generator=g)).to(dt).requires_grad_(True)
    st = {"c": torch.randn((b_, d), generator=g),
          "n": 1 + torch.rand((b_, d), generator=g),
          "h": torch.randn((b_, d), generator=g),
          "m": torch.randn((b_, d), generator=g)}
    st = {k: v.requires_grad_(True) for k, v in st.items()}
    hs, fin = ref.slstm_scan_ref(xw, w, bias, st)
    assert hs.grad_fn is not None

    loop, h = dict(st), []
    for t in range(s):
        loop = ref.slstm_cell(ref.slstm_pre(xw[:, t], loop["h"], w.float(),
                                            bias), loop)
        h.append(loop["h"])
    want = torch.stack(h, dim=1)
    assert torch.equal(hs, want)
    assert all(torch.equal(fin[k], loop[k]) for k in ref.SLSTM_STATE)
    if dtype == "bfloat16":
        return
    weights = [torch.randn(want.shape, generator=g)] + [
        torch.randn((b_, d), generator=g) for _ in ref.SLSTM_STATE]
    inputs = [xw, w, bias] + [st[k] for k in ref.SLSTM_STATE]

    def loss(out, last):
        return (out * weights[0]).sum() + sum(
            (last[k] * x).sum() for k, x in zip(ref.SLSTM_STATE, weights[1:]))
    got = torch.autograd.grad(loss(hs, fin), inputs)
    ref_g = torch.autograd.grad(loss(want, loop), inputs)
    for x, y in zip(got, ref_g):
        assert float((x - y).abs().max()) <= 2e-6 * float(y.abs().max())


def test_hymba_mamba_gradients_match_reference():
    """The S6 head's input gradient and its parameters' against
    ``jax.grad`` of the reference's ``mamba_forward``, at chunks 8 (several
    chunks carried) and 128."""
    rcfg, pcfg = ref_config("hymba-1.5b", smoke=True), get_config(
        "hymba-1.5b", smoke=True)
    params = jittered(jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(6),
                                                           rcfg)), 7)
    p = params["layers"][0]["mixer"]["mamba"]
    x = np.random.default_rng(8).standard_normal((2, 37, rcfg.d_model)
                                                 ).astype(np.float32)
    model = lm_params_from_reference(pcfg, params, device="cpu")
    mamba = model.blocks[0].mixer.mamba
    mamba.requires_grad_(True)
    for chunk in (8, 128):
        def jloss(pp, xx):
            out, _ = jhybrid.mamba_forward(pp, rcfg, xx, chunk=chunk)
            return jnp.sum(out ** 2)
        (jgp, jgx) = jax.grad(jloss, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        out, _ = hybrid.mamba_forward(mamba, pcfg, xt, chunk=chunk)
        names = [n for n, _ in mamba.named_parameters()]
        grads = torch.autograd.grad((out ** 2).sum(), [xt] + [
            getattr(mamba, n) for n in names])
        pairs = [(grads[0], jgx)] + [(g, jgp[n]) for n, g in zip(names,
                                                                 grads[1:])]
        for got, want in pairs:
            w = np.array(want)
            assert float((got - torch.from_numpy(w)).abs().max()) <= \
                F32_GRAD * float(np.abs(w).max())


def test_frontends_match_reference():
    cfg, rcfg = get_config("musicgen-large", smoke=True), ref_config(
        "musicgen-large", smoke=True)
    rng = np.random.default_rng(9)
    ref_patch = jfront.init_patch_frontend(jax.random.key(0), rcfg, 48)
    ref_frame = jfront.init_frame_frontend(jax.random.key(1), rcfg, 3)
    patches = rng.standard_normal((2, 5, 48)).astype(np.float32)
    codes = rng.integers(0, cfg.vocab, (2, 5, 3)).astype(np.int32)
    port_patch = {"proj": to_tensor(ref_patch["proj"], "cpu")}
    port_frame = {"tables": [to_tensor(t, "cpu") for t in ref_frame["tables"]]}
    np.testing.assert_allclose(
        frontends.patch_embed(port_patch, torch.from_numpy(patches)).numpy(),
        np.asarray(jfront.patch_embed(ref_patch, jnp.asarray(patches))),
        rtol=1e-6, atol=1e-6)
    assert np.array_equal(
        frontends.frame_embed(port_frame, torch.from_numpy(codes)).numpy(),
        np.asarray(jfront.frame_embed(ref_frame, jnp.asarray(codes))))
    # the port's own draws: the reference's shapes, dtypes and scales
    g = torch.Generator().manual_seed(0)
    own = frontends.init_patch_frontend(g, cfg, 48)["proj"]
    tables = frontends.init_frame_frontend(g, cfg, 3)["tables"]
    assert own.shape == (48, cfg.d_model) and len(tables) == 3
    assert abs(float(own.std()) - 48 ** -0.5) < 0.02
    assert all(t.shape == (cfg.vocab, cfg.d_model) for t in tables)
    assert abs(float(tables[0].std()) - 0.02) < 2e-3


# chip_smoke.py's GRAD_BOUND and FAMILY_BOUNDS: the card's check of bf16
# gradients against their float32 copy's at full width, by family.
# "norm_one" bounds the one-element leaves' norm ratio (the norm's bound
# where a family sets none)
CARD_GRAD_BOUND = {"cos": 3e-3, "norm": 5e-2, "loss": 2e-4}
CARD_BOUNDS = {"qwen2.5-14b": CARD_GRAD_BOUND,
               "hymba-1.5b": dict(CARD_GRAD_BOUND, norm_one=9.0),
               "xlstm-350m": CARD_GRAD_BOUND,
               "deepseek-v2-236b": dict(CARD_GRAD_BOUND, cos=2e-2)}
# each family's own mixer, whose output the second control detaches: an
# attribute (a method or a module-level function) returning (out, state)
MIXERS = {"qwen2.5-14b": (layers.Attention, "forward"),
          "hymba-1.5b": (hybrid, "mamba_forward"),
          "xlstm-350m": (lm, "slstm_forward"),
          "deepseek-v2-236b": (layers.MLA, "forward")}


def _detached(owner, name: str):
    """``(owner.name, a stand-in for it whose first output is
    detached)``."""
    orig = getattr(owner, name)

    def detached(*a, **k):
        out, rest = orig(*a, **k)
        return out.detach(), rest
    return orig, detached


@contextlib.contextmanager
def routing_held(model, tokens):
    """The port's router made to choose, at every call, the experts the
    bf16 ``model``'s one MoE layer chooses for ``tokens`` (a recorded
    forward); each token's weights its own probabilities at them, as
    ``chip_smoke.py``'s check holds them.  No-op for a model without
    experts."""
    from repro_torch.models import moe
    if model.cfg.moe is None:
        yield
        return
    calls, real = [], moe._route

    def record(router_w, x_flat, m):
        out = real(router_w, x_flat, m)
        calls.append(out[0])
        return out
    moe._route = record
    try:
        with torch.no_grad():
            lm.forward(model, tokens=tokens, train=True)
    finally:
        moe._route = real
    assert len(calls) == 1, len(calls)

    def route(router_w, x_flat, m):
        probs = torch.softmax((x_flat @ router_w).float(), dim=-1)
        eids = calls[0]
        weights = probs.gather(1, eids.long())
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
        f = (eids[:, :1] == torch.arange(m.num_experts)).float().mean(0)
        return eids, weights, m.num_experts * (f * probs.mean(0)).sum()
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def card_check(arch: str, seed: int, dtypes: tuple, bound: dict) -> None:
    """The card's gradient check at SMOKE width on the CPU: a bf16 model
    (norms and biases jittered) copied into ``dtypes[0]`` and
    ``dtypes[1]``, one batch of 2 x 512 Markov tokens, a MoE model's
    routing held to the bf16 model's; the loss and every gradient of the
    first against the second's by ``1 - cos`` and ``|norm ratio - 1|``
    per parameter (one-element leaves apart, as ``norm_one``) and the
    loss's relative difference, each under a third of ``bound``; the
    labels shifted one position and the family's mixer detached must
    each miss it by 10x."""
    from repro_torch.data import DataConfig, SyntheticLMDataset

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    bf = lm.init_lm(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in bf.named_parameters():
            if p.dim() == 1:                    # norms and biases
                p.add_((0.1 * torch.randn(p.shape, generator=g)).to(p.dtype))

    def copy(dtype):
        out = lm.LM(dataclasses.replace(cfg, dtype=dtype), device="cpu")
        with torch.no_grad():
            for (_, p), (_, q) in zip(bf.named_parameters(),
                                      out.named_parameters()):
                q.copy_(p)
        return out
    low, high = copy(dtypes[0]), copy(dtypes[1])
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=512, global_batch=2, seed=seed)).batch_at(
            0).items()}
    held_routing = routing_held(bf, batch["tokens"])
    with held_routing:
        def grads(model, b):
            model.requires_grad_(True)
            loss = lm.train_loss(model, b)
            return float(loss), torch.autograd.grad(
                loss, list(model.parameters()), allow_unused=True,
                materialize_grads=True)

        lf, gf = grads(high, batch)

        def errors(b):
            lb, gb = grads(low, b)
            err = {"cos": 0.0, "norm": 0.0, "norm_one": 0.0,
                   "loss": abs(lb - lf) / abs(lf)}
            for x, y in zip(gb, gf):
                key = "norm_one" if y.numel() == 1 else "norm"
                x, y = x.double().flatten(), y.double().flatten()
                nx, ny = float(x.norm()), float(y.norm())
                err["cos"] = max(err["cos"], 1.0 if nx == 0 or ny == 0
                                 else 1 - float(x @ y) / (nx * ny))
                err[key] = max(err[key], abs(nx / ny - 1) if ny
                               else float(nx > 0))
            return err

        lim = dict(bound)
        lim.setdefault("norm_one", lim["norm"])

        def miss(err):
            return max(err[k] / lim[k] for k in err)

        held = errors(batch)
        assert all(held[k] <= lim[k] / 3 for k in held), held
        shifted = errors(dict(batch, labels=torch.roll(batch["labels"], 1,
                                                       1)))
        assert miss(shifted) >= 10, shifted
        owner, name = MIXERS[arch]
        orig, detached = _detached(owner, name)
        setattr(owner, name, detached)
        try:
            dropped = errors(batch)
        finally:
            setattr(owner, name, orig)
        assert miss(dropped) >= 10, dropped


@pytest.mark.parametrize("arch", list(MIXERS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_gradients_against_float32_sit_well_inside_the_card_bound(
        seed, arch):
    """The basis of the card's bf16 gradient check (``card_check``): the
    bf16 model's gradients against its float32 copy's over 2 x 512 Markov
    tokens: for Hymba two Mamba chunks of 128 carried and the window of 8
    crossed, for xLSTM two mLSTM chunks of 256 and 512 sLSTM steps, for
    DeepSeek-V2 MLA, the dense layer 0 and a routed layer with shared
    experts.  The worst seen over seeds 0-2 (1 - cos, norm, loss):
    Qwen2.5-14B 4.4e-4, 1.1e-2, 8.9e-6; Hymba 3.7e-4, 4.7e-3, 1.7e-5, and
    2.9 for its one-element ``dt_bias`` (a gradient of 6.0e-8 summed over
    every position and channel, against 2.3e-7 in bf16); xLSTM 7.2e-4,
    6.3e-3, 1.3e-5; DeepSeek-V2 5.9e-3 with each copy routing its own
    tokens (its routed experts), 1.2e-2, 1.8e-5, and with the routing held
    (as here) 4.3e-4, 6.8e-3, 1.7e-5.  Each family's bf16
    bound (``CARD_BOUNDS``: GRAD_BOUND but Hymba's one-element leaves and
    DeepSeek-V2's cosine) was set from these before the card ran.  The
    card holds DeepSeek-V2's (routing held, as here) and Qwen2.5-14B's;
    at full width Hymba's and xLSTM's bf16 spreads pass theirs (on the
    CPU too: xLSTM 1 - cos 1-6e-2 a leaf, as the JAX package's own bf16
    gradients), so the card logs them and holds float32 against float64
    instead (the next test)."""
    card_check(arch, seed, ("bfloat16", "float32"), CARD_BOUNDS[arch])


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_gradients_against_float64_sit_well_inside_the_card_bound(
        seed, arch):
    """The basis of the card's check of Hymba and xLSTM: the float32
    copy's gradients against a float64 copy's (the same bf16 weights)
    within GRAD_BOUND, the controls missing it by 10x.  On the CPU at
    full width (Hymba 2 layers, 1 x 2,048; xLSTM 8 layers, 1 x 1,024;
    seeds 0-2) the worst spreads sit 480x and more under it: 1 - cos
    1.1e-8, norm 1.0e-4 (xLSTM's ``b_ifo``), one-element 4.9e-6 (Hymba's
    ``dt_bias``), loss 1.7e-7."""
    card_check(arch, seed, ("float32", "float64"), CARD_GRAD_BOUND)
