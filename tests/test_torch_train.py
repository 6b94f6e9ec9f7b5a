"""The port's training steps and loop on the CPU, held against the JAX
package's.

``make_train_step`` from the same weights, AdamW state and batches as the
reference's jitted step; ``train()`` at SMOKE for qwen2.5-14b at
``n_micro`` 1 and 2 against the reference's ``train()`` (the same initial
weights, carried by ``convert``; the same synthetic data); a run resumed
from a checkpoint against the uninterrupted run; a model fresh from
``train()`` served as the same weights loaded anew; and the command line.

Tolerances.  The losses agree to rtol 1e-5 per step in a step test and
1e-4 over ``train()``'s steps, the gradient norms to 1e-5 and 1e-3.  The
parameters after an AdamW step are held per element to the bound the
gradients' own tolerance implies: the update ``m^/(sqrt(v^) + eps)`` moves
by at most ``2 e / (sqrt(v^) - e)`` for gradients off by ``e`` (``m^`` is a
weighted mean of the gradients and ``sqrt(v^)`` a weighted norm of them), so
an element whose gradient lies within ``e`` of 0 may take either sign and
move by up to ``2 lr``; such elements are counted apart and must stay few
(under 5e-4 of all, about twice the 2.4e-4 measured).  An element that has
had no gradient at all in the reference (an embedding row no batch used)
moves by its decay alone, and is held to the rounding.  Over ``train()``'s
steps each tensor's displacement from the initial weights is held to the
reference's: ``1 - cos`` within 1e-4 and the norm ratio within 1e-3 of 1
per tensor (at most 5.7e-6 and 2.7e-4 measured, both the key bias's), and
over all tensors together within 1e-6 and 1e-5.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch import steps as jsteps
from repro.launch.train import train as ref_train
from repro.models import lm as jlm
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import init_opt_state as ref_init_opt_state

torch = pytest.importorskip("torch")

from test_torch_train_loss import F32_GRAD, batch_for, jittered  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import (lm_params_from_reference,  # noqa: E402
                                        named_from_reference,
                                        opt_state_from_reference)
from repro_torch.optim import AdamWConfig  # noqa: E402

ARCH = "qwen2.5-14b"


def _ref_params(seed: int = 0, jitter: bool = True, arch: str = ARCH
                ) -> dict:
    p = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed),
                                             ref_config(arch, smoke=True)))
    return jittered(p, seed + 1) if jitter else p


def displacement_errors(start: dict, got: dict, want: dict) -> dict:
    """``{"tensor": (worst 1 - cos, worst |norm ratio - 1|), "all": (the
    same over every tensor together)}`` of the displacements ``got -
    start`` against ``want - start``, in float64.  A tensor that did not
    move, in either run, counts as a miss of 1."""
    worst, dot, na2, nb2 = [0.0, 0.0], 0.0, 0.0, 0.0
    for n, s in start.items():
        a = (got[n].detach().cpu() - s).double().flatten()
        b = (want[n].detach().cpu() - s).double().flatten()
        ab, na, nb = float(a @ b), float(a.norm()), float(b.norm())
        dot, na2, nb2 = dot + ab, na2 + na * na, nb2 + nb * nb
        cos = ab / (na * nb) if na and nb else 0.0
        ratio = na / nb if nb else 0.0
        worst = [max(worst[0], 1 - cos), max(worst[1], abs(ratio - 1))]
    return {"tensor": tuple(worst),
            "all": (1 - dot / (na2 * nb2) ** 0.5, abs((na2 / nb2) ** 0.5 - 1))}


def _spacing(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30))) - 23)


# the families' steps: the dense arch at n_micro 1 and 2, Hymba, xLSTM and
# DeepSeek-V2, the last on its recipe's bf16 moments and accumulation
STEP_CASES = [(ARCH, 1, "float32"), (ARCH, 2, "float32"),
              ("hymba-1.5b", 2, "float32"), ("xlstm-350m", 1, "float32"),
              ("deepseek-v2-236b", 2, "bfloat16")]


@pytest.mark.parametrize("arch, n_micro, state_dtype", STEP_CASES,
                         ids=[f"{a}-{n}" for a, n, _ in STEP_CASES])
def test_make_train_step_two_steps_match_reference(arch, n_micro,
                                                   state_dtype):
    """Two steps of ``make_train_step`` against the reference's jitted
    step.  With bf16 moments and accumulation each side rounds its
    accumulated gradient and both moments to bf16, so that on top of the
    float32 bound a gradient may sit one rounding of each of its two
    accumulated pieces and of their sum apart (``2^-7 |g|``, 3 x 2^-8
    rounded up), and the update ``m^ / (sqrt(v^) + eps)``, whose size
    Adam holds near 1 in these first steps, one rounding of ``m`` and of
    ``v`` (``(2^-8 + 2^-9) |update|``, bounded by ``2^-7 x 2``)."""
    rcfg, pcfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params = _ref_params(arch=arch)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4,
                moment_dtype=state_dtype)
    jstep = jax.jit(jsteps.make_train_step(rcfg, RefAdamW(**ocfg), (),
                                           jsteps.Recipe(
                                               n_micro=n_micro,
                                               moment_dtype=state_dtype,
                                               accum_dtype=state_dtype)))
    pstep = steps.make_train_step(pcfg, AdamWConfig(**ocfg), steps.Recipe(
        n_micro=n_micro, moment_dtype=state_dtype, accum_dtype=state_dtype))
    model = lm_params_from_reference(pcfg, params, device="cpu")
    model.requires_grad_(True)
    jp = jax.tree.map(jnp.asarray, params)
    jo = ref_init_opt_state(params, state_dtype)
    ost = opt_state_from_reference(model, jax.tree.map(np.asarray, jo))
    assert ost["m"]["unembed"].stride() == model.unembed.stride()
    assert all(t.dtype == getattr(torch, state_dtype)
               for k in ("m", "v") for t in ost[k].values())
    bf16 = state_dtype == "bfloat16"
    bound = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    capped = total = 0
    for i in range(2):
        b = batch_for(rcfg, 10 + i, b=4)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jg = jax.grad(lambda p: jlm.train_loss(p, rcfg, jb))(jp)
        g = named_from_reference(model, jax.tree.map(np.asarray, jg))
        jp, jo, jm = jstep(jp, jo, jb)
        _, ost, pm = pstep(model, ost, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert float(pm["lr"]) == float(jm["lr"])
        lr = float(jm["lr"])
        scale = min(1.0, 1.0 / float(jm["grad_norm"]))   # the clip's
        v_hat = named_from_reference(model, jax.tree.map(
            lambda a: np.asarray(a, np.float32), jo["v"]))
        want = named_from_reference(model, jax.tree.map(np.asarray, jp))
        for n, p in model.named_parameters():
            e = F32_GRAD * float(g[n].abs().max()) * scale
            if bf16:
                e = e + 2.0 ** -7 * g[n].abs() * scale
            root = (v_hat[n] / (1 - 0.95 ** (i + 1))).sqrt()
            move = (2 * e / (root - e).clamp(min=1e-30)).clamp(max=2.0)
            move = torch.where(v_hat[n] == 0, 0.0, move)   # no gradient yet
            if bf16:
                move = torch.where(move == 2.0, move, move + 2.0 ** -6)
            bound[n] += lr * move
            diff = (p.detach() - want[n]).abs()
            assert bool((diff <= bound[n] + 2 * _spacing(want[n])).all()), n
            capped += int((move == 2.0).sum())
            total += p.numel()
    assert int(ost["step"]) == int(jo["step"]) == 2
    # the elements whose gradient is within its tolerance of 0: few
    assert capped < 5e-4 * total, (capped, total)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_history_matches_reference(n_micro):
    kw = dict(smoke=True, steps=4, global_batch=4, seq_len=32,
              n_micro=n_micro)
    ref = ref_train(ARCH, **kw)
    model = lm_params_from_reference(get_config(ARCH, smoke=True),
                                     _ref_params(jitter=False), device="cpu")
    out = train(ARCH, device="cpu", params=model, **kw)
    assert out["params"] is model
    assert len(out["history"]) == len(ref["history"]) == 4
    for a, b in zip(ref["history"], out["history"]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-3)
        assert b["lr"] == a["lr"]
        assert b["seconds"] > 0
    # the final weights: each tensor's displacement from the initial ones
    want = named_from_reference(model, jax.tree.map(np.asarray,
                                                    ref["params"]))
    start = named_from_reference(model, _ref_params(jitter=False))
    worst = displacement_errors(start, dict(model.named_parameters()), want)
    assert worst["tensor"][0] <= 1e-4 and worst["tensor"][1] <= 1e-3, worst
    assert worst["all"][0] <= 1e-6 and worst["all"][1] <= 1e-5, worst
    m = opt_state_from_reference(model, jax.tree.map(np.asarray,
                                                     ref["opt_state"]))
    assert int(out["opt_state"]["step"]) == int(m["step"]) == 4
    # the moments: m is linear in the gradients, v quadratic
    for k, rel in (("m", 1e-4), ("v", 2e-4)):
        for n, t in out["opt_state"][k].items():
            w = m[k][n]
            assert float((t - w).abs().max()) <= rel * float(
                w.abs().max()) + 1e-12, (k, n)
    assert out["plan_cache"] == ref["plan_cache"]
    assert len(out["manager"]._records) == len(ref["manager"]._records) == 8


def _snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_restart_from_checkpoint_equals_uninterrupted_run(tmp_path):
    """6 steps with a checkpoint every 3; a second run in a directory that
    holds only the step-3 checkpoint restores it, replays the data from
    step 3, and gives steps 4-6's losses and the final weights and
    moments bit for bit."""
    import shutil
    kw = dict(smoke=True, steps=6, global_batch=4, seq_len=16, n_micro=2,
              ckpt_every=3, device="cpu", seed=3)
    full = train(ARCH, ckpt_dir=str(tmp_path / "a"), **kw)
    assert sorted(p.name for p in (tmp_path / "a").glob("step_*")) == [
        "step_00000003", "step_00000006"]
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    resumed = train(ARCH, ckpt_dir=str(tmp_path / "b"), **kw)
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in full["history"][3:]]
    a, b = _snapshot(full["params"]), _snapshot(resumed["params"])
    assert all(torch.equal(a[n], b[n]) for n in a)
    for k in ("m", "v"):
        assert all(torch.equal(full["opt_state"][k][n],
                               resumed["opt_state"][k][n]) for n in a)
    assert int(resumed["opt_state"]["step"]) == 6
    # the journal of the resumed run holds its own steps
    journal = (tmp_path / "b" / "shuffle_journal.jsonl").read_text()
    assert journal.count("train_step") == 6


def test_a_trained_model_serves_like_the_same_weights_loaded_fresh():
    out = train(ARCH, smoke=True, steps=2, global_batch=2, seq_len=16,
                device="cpu", seed=1)
    model = out["params"]
    assert all(p.requires_grad for p in model.parameters())
    fresh = lm.LM(model.cfg, device="cpu")
    with torch.no_grad():
        for (_, p), (_, q) in zip(model.named_parameters(),
                                  fresh.named_parameters()):
            q.copy_(p)
    kw = dict(batch=2, prompt_len=8, gen_len=4, max_len=16, device="cpu")
    gen, stats = serve(ARCH, params=model, **kw)
    want, want_stats = serve(ARCH, params=fresh, **kw)
    assert np.array_equal(gen, want)
    assert all(t.grad_fn is None for t in stats.logits)       # no graph
    assert all(torch.equal(a, b) for a, b in zip(stats.logits,
                                                 want_stats.logits))


def test_train_step_runs_no_kernel_wrapper():
    """On the CPU a wrapper would run its plain version, so count the
    calls: the training step never reaches the kernels' wrappers (a plain
    call through ``ops`` with ``use_kernel=False`` does not count)."""
    from repro_torch.kernels import ops
    calls = []
    names = ("flash_attention", "decode_attention_kernel", "gmm",
             "slstm_scan_kernel")
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, lambda *a, _n=n, **k: calls.append(_n) or
                saved[_n](*a, **k))
    try:
        for arch in ("qwen2.5-14b", "qwen3-moe-235b-a22b", "xlstm-350m",
                     "hymba-1.5b"):
            train(arch, smoke=True, steps=1, global_batch=2, seq_len=8,
                  device="cpu")
        assert calls == []
        lm.forward(lm.init_lm(get_config("qwen2.5-14b", smoke=True),
                              device="cpu"), tokens=torch.zeros((1, 4),
                                                                dtype=torch.int32))
        assert calls == ["flash_attention"] * 2   # the serving path does
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)


def test_recipes_and_step_builders():
    from repro_torch.models.config import SHAPES
    assert steps.recipe_for("qwen2.5-14b", SHAPES["train_4k"]) == \
        steps.Recipe(n_micro=2)
    assert steps.recipe_for("qwen2.5-14b", SHAPES["decode_32k"]) == \
        steps.Recipe()
    assert {k: dataclasses.asdict(v) for k, v in steps._TRAIN_RECIPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jsteps._TRAIN_RECIPES.items()}
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    new = steps._with_recipe(cfg, steps.Recipe(remat=True, dispatch="gspmd"))
    assert new.remat and new.moe.dispatch == "gspmd"
    assert steps._with_recipe(cfg, steps.Recipe()) is cfg


# Both packages keep the KV cache in bf16 whatever the model's dtype, so a
# key or value whose float32 value lies near a bf16 boundary may round to
# either side in the two runs (their float32 sums differ in order); that
# moves a logit by far less than this (at most 1.4e-4 in the prefill's and
# 1.5e-4 in the serve step's logits over seeds 0-39 on the CPU)
STEP_RTOL = STEP_ATOL = 2e-3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefill_and_serve_steps_match_reference(seed):
    """The serving path's step builders against the reference's, from the
    same weights (carried by ``lm_params_from_reference``) and the same
    numpy tokens: ``make_prefill_step``'s last logits and its cache
    position, then one ``make_serve_step`` on each package's own cache,
    within ``STEP_RTOL`` / ``STEP_ATOL``.  No cacheless forward is compared:
    it keeps k and v in float32 where both step builders attend over the
    cache's bf16 rows, so it differs from them by that rounding and not by
    a fault."""
    from repro.models.config import SHAPES as RSHAPES

    from repro_torch.models.config import SHAPES
    rcfg, pcfg = ref_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=16,
                                global_batch=2)
    rshape = dataclasses.replace(RSHAPES["prefill_32k"], seq_len=16,
                                 global_batch=2)
    params = _ref_params(seed)
    model = lm_params_from_reference(pcfg, params, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(seed).integers(
        0, pcfg.vocab, (2, 8)).astype(np.int32)
    last, cache = steps.make_prefill_step(pcfg, shape)(
        model, {"tokens": torch.from_numpy(toks)})
    rlast, rcache = jsteps.make_prefill_step(rcfg, rshape, ())(
        jp, {"tokens": jnp.asarray(toks)})
    assert last.shape == (2, 1, pcfg.vocab) and cache["pos"] == 8
    np.testing.assert_allclose(last.float().numpy(),
                               np.asarray(rlast, np.float32),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    nxt, cache = steps.make_serve_step(pcfg)(
        model, cache, {"tokens": torch.from_numpy(toks[:, :1])})
    rnxt, _ = jsteps.make_serve_step(rcfg, ())(
        jp, rcache, {"tokens": jnp.asarray(toks[:, :1])})
    assert nxt.shape == (2, 1, pcfg.vocab) and cache["pos"] == 9
    np.testing.assert_allclose(nxt.float().numpy(),
                               np.asarray(rnxt, np.float32),
                               rtol=STEP_RTOL, atol=STEP_ATOL)


def test_command_line_trains_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "16"], capture_output=True, text=True, check=True)
    assert out.stdout.count("[train] step=") == 3
    assert "[train] done: first loss" in out.stdout
