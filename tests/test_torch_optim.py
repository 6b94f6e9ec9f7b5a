"""The port's optimizer on the CPU, held against the JAX package's.

``repro_torch.optim`` (AdamW, the cosine schedule, global-norm clipping,
microbatch accumulation) against ``repro.optim`` on the same parameters,
gradients and state, made with numpy from a seed.  The update math is
float32 in both, written in the same order; XLA and torch may still
contract or order a float32 chain differently, so each updated element is
held within one ulp of its dtype (the parameter's, or the moment's); the
factored second moment's float32 means within one ulp per term summed.  The
decay mask is held leaf by leaf for every architecture through the
converter's mapping of the reference's parameter tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS, get_config as ref_config
from repro.models import lm as jlm
from repro.optim import accumulate as jacc
from repro.optim import adamw as jadamw

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import (lm_params_from_reference,  # noqa: E402
                                        named_from_reference)
from repro_torch.optim import (AdamWConfig, adamw_update,  # noqa: E402
                               clip_by_global_norm, cosine_schedule,
                               global_norm, init_opt_state, microbatch_grads)
from repro_torch.optim.adamw import _decay_mask  # noqa: E402

SHAPES = {"w": (8, 16), "ln1": (16,), "stack": (3, 8, 16), "bq": (16,),
          "emb": (32, 8), "s": (1, 16)}


def _ulps(got: torch.Tensor, want: np.ndarray, slack=0.0) -> float:
    """The largest ``|got - want| - slack`` in units of the spacing of
    ``got``'s dtype at ``want``."""
    dt = got.dtype
    w = torch.from_numpy(np.array(want, np.float32)).to(dt).float()
    g = got.float()
    bits = 7 if dt == torch.bfloat16 else 23
    tiny = torch.finfo(dt).tiny
    spacing = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=tiny)))
                         - bits)
    return float((((g - w).abs() - slack).clamp(min=0) / spacing).max())


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def _tree(seed: int, dtype: str, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}, dtype


def _jax(tree, dtype):
    return {k: jnp.asarray(v, jnp.dtype(dtype)) for k, v in tree.items()}


def _torch(tree, dtype):
    # copies: the update writes in place, and jax may alias numpy's memory
    return {k: torch.tensor(v).to(getattr(torch, dtype))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# schedule, norm, clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 1), (1, 6), (100, 10_000)])
def test_cosine_schedule_matches_reference(warmup, total):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
               min_lr_frac=0.1)
    steps = sorted({0, 1, warmup, (warmup + total) // 2, total, total + 5})
    for step in steps:
        got = cosine_schedule(AdamWConfig(**cfg), torch.tensor(step,
                                                               dtype=torch.int32))
        want = jadamw.cosine_schedule(jadamw.AdamWConfig(**cfg),
                                      jnp.int32(step))
        assert got.dtype == torch.float32
        assert float(got) == float(want), (step, float(got), float(want))


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(cosine_schedule(cfg, torch.tensor(0))) == 0.0
    assert float(cosine_schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(cosine_schedule(cfg, torch.tensor(100))) == pytest.approx(0.1)
    assert 0.1 < float(cosine_schedule(cfg, torch.tensor(55))) < 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype):
    tree, _ = _tree(0, dtype, scale=0.5)
    norm = global_norm(_torch(tree, dtype))
    jnorm = jadamw.global_norm(_jax(tree, dtype))
    # float32 sums of squares, each leaf's then their sum: the summation
    # order within a leaf differs (rtol 1e-6)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for max_norm in (0.5, 1e9):           # clipped, and a scale of 1
        got, gn = clip_by_global_norm(_torch(tree, dtype), max_norm)
        want, wn = jadamw.clip_by_global_norm(_jax(tree, dtype), max_norm)
        assert float(gn) == pytest.approx(float(wn), rel=1e-6)
        for k in tree:
            assert got[k].dtype == getattr(torch, dtype)   # cast back
            assert _ulps(got[k], _np(want[k])) <= 1.0, k


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(90 + 160))
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


# ---------------------------------------------------------------------------
# the decay mask, leaf by leaf, for every architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_reference_for_every_leaf(arch):
    rcfg, pcfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), rcfg))
    mask = jadamw._decay_mask(params)
    # the reference's one scalar per (stacked) leaf, broadcast to its shape
    # so that the converter can unstack it into the port's layers
    spread = jax.tree.map(lambda m, p: np.broadcast_to(np.asarray(m), p.shape),
                          mask, params)
    model = lm_params_from_reference(pcfg, params, device="cpu")
    want = named_from_reference(model, spread)
    got = _decay_mask(dict(model.named_parameters()))
    assert list(got) == list(want)
    for name, m in want.items():
        vals = torch.unique(m)
        assert len(vals) == 1, name
        assert got[name] == bool(vals[0] == 1.0), (name, got[name])
    assert any(got.values()) and not all(got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_decays_as_the_reference_for_every_leaf(arch):
    """Zero gradients leave only the decay: ``adamw_update`` applies the
    mask it computes itself, as the reference's does, to every converted
    leaf (the update is float32 in both: within one ulp)."""
    rcfg, pcfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(1), rcfg))
    params = jax.tree.map(lambda p: p + np.float32(0.5).astype(p.dtype),
                          params)                  # no zero leaf left
    cfg = dict(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=1,
               grad_clip=1e9)
    jp = jax.tree.map(jnp.asarray, params)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    want, _, _ = jadamw.adamw_update(jadamw.AdamWConfig(**cfg), jp, zeros,
                                     jadamw.init_opt_state(jp))
    model = lm_params_from_reference(pcfg, params, device="cpu")
    tp = {n: p.detach().clone() for n, p in model.named_parameters()}
    before = {n: p.clone() for n, p in tp.items()}
    got, _, _ = adamw_update(AdamWConfig(**cfg), tp,
                             {n: torch.zeros_like(p) for n, p in tp.items()},
                             init_opt_state(tp))
    want = named_from_reference(model, jax.tree.map(np.asarray, want))
    moved = 0
    for n, p in got.items():
        assert _ulps(p, want[n].float().numpy()) <= 1.0, n
        moved += not torch.equal(p, before[n])
    assert 0 < moved < len(got)


# ---------------------------------------------------------------------------
# adamw_update
# ---------------------------------------------------------------------------

UPDATE_CASES = [("float32", "float32", False), ("bfloat16", "float32", False),
                ("float32", "bfloat16", False), ("bfloat16", "bfloat16", False),
                ("float32", "float32", True), ("bfloat16", "float32", True)]


@pytest.mark.parametrize("pdt,mdt,factored", UPDATE_CASES)
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_reference(pdt, mdt, factored, steps):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               grad_clip=1.0, moment_dtype=mdt, factored_v=factored)
    p0, _ = _tree(1, pdt)
    jp = _jax(p0, pdt)
    tp = _torch(p0, pdt)
    jst = jadamw.init_opt_state(jp, mdt, factored)
    tst = init_opt_state(tp, mdt, factored)
    for i in range(steps):
        prev = {k: torch.from_numpy(_np(v)) for k, v in jp.items()}
        g, _ = _tree(10 + i, pdt, scale=0.3)
        jp, jst, jm = jadamw.adamw_update(jadamw.AdamWConfig(**cfg), jp,
                                          _jax(g, pdt), jst)
        tp, tst, tm = adamw_update(AdamWConfig(**cfg), tp, _torch(g, pdt),
                                   tst)
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        for k in p0:
            assert tp[k].dtype == getattr(torch, pdt)
            # a factored leaf's update carries its means' reordering (n
            # float32 ulps, n the longer mean) on top of the cast's ulp
            slack = 0.0
            if factored and len(SHAPES[k]) >= 2:
                slack = max(SHAPES[k][-2:]) * 2.0 ** -23 * (
                    torch.from_numpy(_np(jp[k])) - prev[k]).abs()
            assert _ulps(tp[k], _np(jp[k]), slack) <= 1.0, (i, k)
            assert _ulps(tst["m"][k], _np(jst["m"][k])) <= 1.0, (i, k)
            v = tst["v"][k]
            if isinstance(v, dict):
                assert len(SHAPES[k]) >= 2
                # r and c are float32 means, of the last and the second
                # last axis: a sum of n terms, which XLA and torch order
                # differently, off by at most n ulps
                for f, n in (("r", SHAPES[k][-1]), ("c", SHAPES[k][-2])):
                    assert _ulps(v[f], _np(jst["v"][k][f])) <= n, (i, k, f)
            else:
                assert _ulps(v, _np(jst["v"][k])) <= 1.0, (i, k)


def test_adamw_update_is_in_place_and_slices_large_leaves(monkeypatch):
    """The update writes into the given tensors; a leaf larger than one
    slice, and a transposed one, give the unsliced result bit for bit."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(3)
    base = {"w": rng.standard_normal((40, 24)).astype(np.float32),
            "t": rng.standard_normal((24, 40)).astype(np.float32)}
    grads = {k: 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in base.items()}
    out = []
    for chunk in (1 << 25, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        params = {"w": torch.from_numpy(base["w"]).bfloat16(),
                  "t": torch.from_numpy(base["t"].T.copy()).bfloat16().t()}
        ids = {k: p.data_ptr() for k, p in params.items()}
        state = init_opt_state(params)
        assert state["m"]["t"].stride() == params["t"].stride()
        g = {k: torch.from_numpy(v).bfloat16() for k, v in grads.items()}
        new, st, _ = adamw_update(AdamWConfig(lr=1e-2, warmup_steps=0),
                                  params, g, state)
        assert new is params and st is state and not g
        assert {k: p.data_ptr() for k, p in new.items()} == ids
        out.append({k: p.clone() for k, p in new.items()})
    for k in base:
        assert torch.equal(out[0][k], out[1][k])
    # moments in another layout than their parameter's are refused
    state = init_opt_state(params)
    state["m"]["t"] = state["m"]["t"].contiguous()
    with pytest.raises(ValueError, match="layout"):
        adamw_update(AdamWConfig(), params, {k: torch.zeros_like(p)
                                             for k, p in params.items()},
                     state)


def test_adamw_decay_mask_skips_norms():
    params = {"w": torch.ones((4, 4)), "ln1": torch.ones((4,))}
    grads = {"w": torch.zeros((4, 4)), "ln1": torch.zeros((4,))}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                      total_steps=1, grad_clip=1e9)
    p2, _, _ = adamw_update(cfg, params, grads, init_opt_state(params))
    assert float((p2["ln1"] - 1.0).abs().max()) == 0.0     # no decay on norms
    assert float((p2["w"] - 1.0).abs().max()) > 0.0        # decay on matrices


# ---------------------------------------------------------------------------
# microbatch_grads
# ---------------------------------------------------------------------------

def _quad_loss_jax(p, b):
    # float32 math on the parameters' values: the only roundings to the
    # parameters' dtype are the gradients' own
    x, w, v = (t.astype(jnp.float32) for t in (b["x"], p["w"], p["v"]))
    return jnp.mean((x @ w) ** 2) + jnp.sum(v * jnp.mean(x, 0))


def _quad_loss_torch(p, b):
    x, w, v = b["x"].float(), p["w"].float(), p["v"].float()
    return ((x @ w) ** 2).mean() + (v * x.mean(0)).sum()


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_microbatch_grads_match_reference(pdt, adt, n_micro):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    v = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    jl, jg = jacc.microbatch_grads(
        _quad_loss_jax, {"w": jnp.asarray(w, pdt), "v": jnp.asarray(v, pdt)},
        {"x": jnp.asarray(x, pdt)}, n_micro, accum_dtype=adt)
    params = {"w": torch.from_numpy(w).to(getattr(torch, pdt)),
              "v": torch.from_numpy(v).to(getattr(torch, pdt))}
    for p in params.values():
        p.requires_grad_(True)
    tl, tg = microbatch_grads(_quad_loss_torch, params,
                              {"x": torch.from_numpy(x).to(getattr(torch, pdt))},
                              n_micro, accum_dtype=adt)
    want_dt = pdt if n_micro <= 1 else adt
    assert tl.dtype == torch.float32 and not tl.requires_grad
    # the float32 loss: the matmul's sums may be ordered differently
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    for k in ("w", "v"):
        assert tg[k].dtype == getattr(torch, want_dt)
        # one ulp of the accumulation dtype, plus the backward's own float32
        # reordering (1e-6 of the largest gradient) in float32
        want = _np(jg[k])
        if want_dt == "float32":
            np.testing.assert_allclose(tg[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        else:
            assert _ulps(tg[k], want) <= 1.0, k


def test_microbatch_grads_match_full_batch():
    rng = np.random.default_rng(0)
    w = {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))}
    w["w"].requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))

    def loss(p, batch):
        return ((batch["x"] @ p["w"]) ** 2).mean()

    l1, g1 = microbatch_grads(loss, w, {"x": x}, 1)
    l4, g4 = microbatch_grads(loss, w, {"x": x}, 4)
    assert float(l1) == pytest.approx(float(l4), rel=1e-6)
    np.testing.assert_allclose(g1["w"], g4["w"], rtol=1e-5)


def test_unused_parameter_gets_zeros_as_under_jax_grad():
    p = {"a": torch.ones(3, requires_grad=True),
         "b": torch.ones(2, requires_grad=True)}
    _, g = microbatch_grads(lambda q, b: (q["a"] * b["x"]).sum(), p,
                            {"x": torch.arange(6.0).reshape(2, 3)}, 2)
    assert torch.equal(g["b"], torch.zeros(2))
    assert torch.equal(g["a"], torch.tensor([1.5, 2.5, 3.5]))
