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
from repro_torch.models import frontends, hybrid, lm  # noqa: E402
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


def reference_and_port(arch: str, dtype: str | None = None, seed: int = 0):
    """``(ref loss, ref grads keyed as the port's, port loss, port grads,
    model)`` for one batch."""
    rcfg, pcfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype:
        rcfg = dataclasses.replace(rcfg, dtype=dtype)
        pcfg = dataclasses.replace(pcfg, dtype=dtype)
    params = jittered(jax.tree.map(np.asarray, jlm.init_lm(
        jax.random.key(seed), rcfg)), seed + 1)
    batch = batch_for(rcfg, seed + 2)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_reference(arch):
    jl, want, loss, got, model = reference_and_port(arch)
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
    # only the token table of an embeddings-fed model goes without
    zero = [n for n, g in got.items() if float(g.abs().max()) == 0]
    assert zero == (["embed"] if model.cfg.modality != "text" else [])


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


@pytest.mark.parametrize("chunk", [8, 16, 128])
def test_hymba_scan_out_of_place_is_the_in_place_scan(chunk):
    """The Mamba scan under autograd (out of place) against the serving
    form (in place): the same operator in the same order, bit for bit, for
    the scan alone and the whole mixer's output."""
    g = torch.Generator().manual_seed(chunk)
    a = torch.rand((2, chunk, 6, 4), generator=g)
    b = torch.randn((2, chunk, 6, 4), generator=g)
    want = hybrid._scan(a.clone(), b.clone())
    got = hybrid._scan(a.clone().requires_grad_(True), b.clone())
    assert got.grad_fn is not None and torch.equal(got, want)

    cfg = get_config("hymba-1.5b", smoke=True)
    model = lm.init_lm(cfg, seed=2, device="cpu")
    mamba = model.blocks[0].mixer.mamba
    x = torch.randn((2, 37, cfg.d_model), generator=g)
    want, st = hybrid.mamba_forward(mamba, cfg, x, chunk=chunk)
    model.requires_grad_(True)
    got, st2 = hybrid.mamba_forward(mamba, cfg, x, chunk=chunk)
    assert got.grad_fn is not None
    assert torch.equal(got, want) and torch.equal(st["ssm"], st2["ssm"])


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


# chip_smoke.py's GRAD_BOUND: the card's check of bf16 gradients against
# their float32 copy's at full width
CARD_GRAD_BOUND = {"cos": 3e-3, "norm": 5e-2, "loss": 2e-4}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_gradients_against_float32_sit_well_inside_the_card_bound(seed):
    """The basis of the card's gradient check, on the CPU at SMOKE width:
    the bf16 model's loss and gradients against its float32 copy's (the
    same weights, norms and biases jittered), by the card check's
    measures (1 - cosine and |norm ratio - 1| per parameter, the loss's
    relative difference) over 2 x 512 Markov tokens.  The card's bound is
    4.5-22x the worst seen here (4.4e-4, 1.1e-2, 8.9e-6 over seeds 0-2);
    this holds each under a third of it.  The control (labels shifted one
    position) must miss it by 10x."""
    import copy
    from repro_torch.data import DataConfig, SyntheticLMDataset

    cfg = dataclasses.replace(get_config("qwen2.5-14b", smoke=True),
                              dtype="bfloat16")
    bf = lm.init_lm(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in bf.named_parameters():
            if p.dim() == 1:                    # norms and biases
                p.add_((0.1 * torch.randn(p.shape, generator=g)).bfloat16())
    f32 = copy.deepcopy(bf).float()
    f32.cfg = dataclasses.replace(cfg, dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=512, global_batch=2, seed=seed)).batch_at(
            0).items()}

    def grads(model, b):
        model.requires_grad_(True)
        loss = lm.train_loss(model, b)
        return float(loss), torch.autograd.grad(loss, list(model.parameters()))

    def errors(b):
        (lb, gb), (lf, gf) = grads(bf, b), grads(f32, batch)
        cos = norm = 0.0
        for x, y in zip(gb, gf):
            x, y = x.double().flatten(), y.double().flatten()
            cos = max(cos, 1 - float(x @ y / (x.norm() * y.norm())))
            norm = max(norm, abs(float(x.norm() / y.norm()) - 1))
        return {"cos": cos, "norm": norm, "loss": abs(lb - lf) / abs(lf)}

    held = errors(batch)
    assert all(held[k] <= CARD_GRAD_BOUND[k] / 3 for k in held), held
    shifted = errors(dict(batch, labels=torch.roll(batch["labels"], 1, 1)))
    assert max(shifted[k] / CARD_GRAD_BOUND[k] for k in shifted) >= 10, shifted
