"""The port's expert-parallel MoE dispatch (``teshu`` / ``teshu2``) and
serving over a mesh on the CPU, held against the JAX package.

Both sides run on a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh with
the EP axes ``("pod", "model")`` (``mesh_ranks.py``): the reference's
``moe_ffn`` under ``jax.jit`` and ``serve(mesh=make_mesh(...))`` in one
subprocess over 8 forced host devices, the port's per-rank ``moe_ffn`` and
``serve(mesh=...)`` in one spawn of 8 gloo ranks, each rank holding its
rows of the batch and its 2 of the 8 experts.  Served over the mesh, the
port's model (SMOKE Qwen3-MoE and DeepSeek-V2) is placed by the
reference's sharding rules: each rank holds its shard of every leaf and
gathers it whole right before use, so its logits are bit for bit those of
the same run with every leaf but the routed experts replicated, and its
bytes are the reference's per device.  The weights are the
reference's ``init_moe`` with every expert jittered from numpy (its own
init repeats one matrix over the experts, so a dispatch to the wrong rank
would still agree), the same arrays on both sides.

Tolerances.  float32 within ``LAYER`` (``test_torch_moe.py``: float32
matmuls summing in other orders).  bfloat16 within :func:`_bf16_bound`:
``ref.gmm_tolerance``'s reasoning carried through the block.  Each of the
three products sums the same float32 products in another order (the
reference's einsum over ``[e_local, ep * cap]`` rows, the port's grouped
matmul over ``[e_local, ep * cap_pad]``), so its bf16 output may round a
step apart (``2^-7`` of it, plus ``2 d 2^-24 (|x| @ |w|)``); a step in
``gate`` or ``up`` moves ``h = silu(gate) * up`` by at most ``2^-6 (|gate|
+ 2 |silu(gate)|) |up|`` through its chain of bf16 roundings, and that
reaches ``w_down``'s output through ``|w_down|``; the combine rounds each
weighted term and the sum once more (``2^-7`` of the terms' magnitudes).
The reference runs with ``--xla_allow_excess_precision=false``: under
``jax.jit`` XLA otherwise keeps the router's bf16 matmul in float32 and
routes other tokens than the same code run op by op, the written order
the port follows (4,425 of 16,384 elements apart at this size).  At
capacity factor 1.0 each
``model`` slice keeps its own capacity and drops other tokens than gspmd
would: the port must match the reference's EP result, which differs from
the gspmd branch's.  A control with the two-level stages' axes swapped
sends each expert's tokens to another rank's experts and must fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mesh_ranks
from repro.configs import get_config as ref_config
from repro.models import config as rconfig
from repro.models import lm as jlm
from repro.models import moe as jmoe

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import config as pconfig  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
ARCHS = ("deepseek-v2-236b",)            # served beside ARCH
LAYER = dict(rtol=2e-5, atol=2e-5)
CACHED = dict(rtol=2e-3, atol=2e-3)
CASES = [(f"{d}-{dt}-{cf}", d, dt, cf) for d in ("teshu", "teshu2")
         for dt in ("float32", "bfloat16") for cf in (8.0, 1.0)]
SERVE = dict(batch=8, prompt_len=12, gen_len=5, max_len=32, seed=0)
B, S, D = 8, 64, 32


def _flatten(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}|{k}"))
        else:
            out[f"{prefix}|{k}"] = np.asarray(v, np.float32)
    return out


def _jitter(tree, rng):
    for name, a in tree.items():
        f = np.asarray(a, np.float32)
        tree[name] = (f + 0.5 * f.std() * rng.standard_normal(f.shape)
                      ).astype(np.float32)


def _case_inputs(nm, dispatch, dtype, cf) -> dict:
    """The block's weights and x, rounded to ``dtype`` and held as
    float32 (exact), for both sides."""
    seed = sum(map(ord, nm))
    cfg = mesh_ranks.moe_config(rconfig, dispatch, dtype, cf)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jmoe.init_moe(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    _jitter(p["experts"], rng)
    p["x"] = rng.standard_normal((B, S, D))
    dt = jnp.dtype(dtype)
    return {k: np.asarray(jnp.asarray(v, dt).astype(jnp.float32))
            for k, v in _flatten(p, nm).items()}


def _serve_params(arch: str = ARCH) -> dict:
    cfg = ref_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(11), cfg))
    _jitter(params["blocks"]["moe"]["experts"], np.random.default_rng(11))
    return params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = tmp / "inputs.npz"
    data = {}
    for case in CASES:
        data.update(_case_inputs(*case))
    params = _serve_params()
    data.update(_flatten(params, "serve"))
    for a in ARCHS:
        data.update(_flatten(_serve_params(a), f"serve-{a}"))
    np.savez(inputs, **data)
    proc = mesh_ranks.start_reference(
        "reference_moe", dict(inputs=str(inputs), out=str(tmp / "ref.npz"),
                              cases=CASES, serve_kw=SERVE, arch=ARCH,
                              archs=ARCHS),
        devices=8, xla_flags="--xla_allow_excess_precision=false")
    try:
        ranks = mesh_ranks.run_ranks("moe", tmp, (str(inputs), CASES, SERVE,
                                                  ARCH, ARCHS), timeout=180)
    finally:
        mesh_ranks.finish(proc, timeout=300)
    return dict(ranks=ranks, ref=dict(np.load(tmp / "ref.npz")), data=data,
                params=params)


def _rows(ranks, key: str) -> np.ndarray:
    """The batch from the ranks' rows: rank ``r`` holds the rows of its
    ``(pod, data)`` index ``r // 2``, the same on both ``model`` ranks."""
    for r in range(0, 8, 2):
        np.testing.assert_array_equal(ranks[r][key], ranks[r + 1][key])
    return np.concatenate([ranks[r][key] for r in range(0, 8, 2)])


def _bf16_bound(data: dict, nm: str, cfg) -> np.ndarray:
    """Per element of the bf16 block output, the bound of the module
    docstring, from the tokens' routing (the port's ``_route``, the
    reference's op by op) and float64 products of the bf16 values; every
    assignment counted, kept or dropped."""
    x = data[f"{nm}|x"].reshape(-1, D).astype(np.float64)
    wg, wu, wd = (data[f"{nm}|experts|{k}"].astype(np.float64)
                  for k in ("w_gate", "w_up", "w_down"))
    eids, weights, _ = moe._route(
        torch.from_numpy(data[f"{nm}|router"]).to(torch.bfloat16),
        torch.from_numpy(data[f"{nm}|x"]).to(torch.bfloat16).reshape(-1, D),
        cfg.moe)
    eids, weights = eids.long().numpy(), weights.double().numpy()
    f = wg.shape[-1]
    prop = np.zeros_like(x)
    terms = np.zeros_like(x)
    for j in range(eids.shape[1]):
        e, w = eids[:, j], weights[:, j, None]
        g = np.einsum("td,tdf->tf", x, wg[e])
        u = np.einsum("td,tdf->tf", x, wu[e])
        sg = g / (1 + np.exp(-g))
        h = sg * u
        y = np.einsum("tf,tfd->td", h, wd[e])
        dh = 2.0 ** -6 * (np.abs(g) + 2 * np.abs(sg)) * np.abs(u) + \
            2 * D * 2.0 ** -24 * np.einsum("td,tdf->tf", np.abs(x),
                                          np.abs(wg[e]) + np.abs(wu[e]))
        dy = np.einsum("tf,tfd->td", dh, np.abs(wd[e])) + 2.0 ** -7 * \
            np.abs(y) + 2 * f * 2.0 ** -24 * np.einsum(
                "tf,tfd->td", np.abs(h), np.abs(wd[e]))
        prop += w * dy
        terms += np.abs(w * y)
    return (prop + 2.0 ** -7 * terms).reshape(B, S, D)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ep_dispatch_matches_reference(runs, case):
    nm, dispatch, dtype, cf = case
    got = _rows(runs["ranks"], f"{nm}|y")
    want = runs["ref"][f"{nm}|y"]
    assert got.shape == want.shape == (B, S, D)
    if dtype == "bfloat16":
        cfg = mesh_ranks.moe_config(pconfig, dispatch, dtype, cf)
        assert np.all(np.abs(got - want) <= _bf16_bound(runs["data"], nm,
                                                        cfg))
    else:
        np.testing.assert_allclose(got, want, **LAYER)
    for res in runs["ranks"]:
        np.testing.assert_allclose(float(res[f"{nm}|aux"]),
                                   float(runs["ref"][f"{nm}|aux"]), rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ep_follows_the_reference_not_gspmd(runs, case):
    """The gspmd branch of the port on the whole batch: equal to the EP
    result without drops, not with them (at capacity factor 1.0 each
    ``model`` slice of 64 tokens keeps 24 a expert, the whole batch of
    512 keeps 136)."""
    nm, dispatch, dtype, cf = case
    cfg = mesh_ranks.moe_config(pconfig, dispatch, dtype, cf)
    data = runs["data"]
    block = moe.MoE(cfg, device="cpu")
    with torch.no_grad():
        block.router.copy_(torch.from_numpy(data[f"{nm}|router"]))
        for k in ("w_gate", "w_up", "w_down"):
            getattr(block.experts, k).copy_(torch.from_numpy(
                data[f"{nm}|experts|{k}"]))
    x = torch.from_numpy(data[f"{nm}|x"]).to(getattr(torch, dtype))
    y, _ = moe.moe_ffn(block, cfg, x)
    gspmd = y.float().numpy()
    ep = _rows(runs["ranks"], f"{nm}|y")
    if dtype == "float32":
        assert np.allclose(gspmd, ep, **LAYER) == (cf > 1)
    else:
        assert np.all(np.abs(gspmd - ep) <= _bf16_bound(data, nm, cfg)) \
            == (cf > 1)


def test_swapped_two_level_axes_fail(runs):
    """The two-level stages over ``("model", "pod")`` in place of
    ``("pod", "model")``: each expert block reaches another rank."""
    nm = "teshu2-float32-8.0"
    got = _rows(runs["ranks"], f"{nm}|swapped")
    want = runs["ref"][f"{nm}|y"]
    assert np.isfinite(got).all()
    assert not np.allclose(got, want, **LAYER)
    assert np.abs(got - want).max() > 100 * (2e-5 + 2e-5 * np.abs(want).max())


def test_serve_over_the_mesh_emits_the_reference_tokens(runs):
    """SMOKE Qwen3-MoE (``dispatch="teshu2"``) on 8 ranks: every rank
    returns the whole batch's tokens, the reference's; each rank's logits
    are its own rows, within ``CACHED`` of the reference's (through the
    bf16 KV cache)."""
    want = runs["ref"]["serve|tokens"]
    assert want.shape == (SERVE["batch"], SERVE["gen_len"])
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res["serve|tokens"], want)
    ranks = runs["ranks"]
    for r in range(0, 8, 2):
        np.testing.assert_array_equal(ranks[r]["serve|logits"],
                                      ranks[r + 1]["serve|logits"])
    got = np.concatenate([ranks[r]["serve|logits"] for r in range(0, 8, 2)],
                         axis=1)
    assert got.shape == (SERVE["gen_len"] + 1, SERVE["batch"], 256)
    np.testing.assert_allclose(got, runs["ref"]["serve|logits"], **CACHED)


def test_convert_keeps_the_rank_expert_slice(runs):
    """Rank (pod, data, model) holds experts ``[2 i, 2 i + 2)``, ``i = 2
    pod + model`` (the reference's ``P(("pod", "model"), None, "data")``:
    the expert axis over the EP axes), and of each its half of ``f`` by
    its ``data`` coordinate."""
    full = runs["params"]["blocks"]["moe"]["experts"]["w_up"][0]
    f = full.shape[-1] // 2
    for r, res in enumerate(runs["ranks"]):
        pod, data, model = np.unravel_index(r, mesh_ranks.MESH)
        i = 2 * pod + model
        np.testing.assert_array_equal(res["serve|w_up"], full[
            2 * i:2 * i + 2, :, data * f:(data + 1) * f])


def test_init_lm_under_a_mesh_is_the_slice_of_the_full_init(runs):
    """Each rank of ``init_lm(..., mesh=)`` holds its shard of the mesh-free
    init of every leaf; the leaves held in part are every matrix and the
    per-layer norms (``model``-split), not the router."""
    for r, res in enumerate(runs["ranks"]):
        pod, _, model = np.unravel_index(r, mesh_ranks.MESH)
        assert res["init|slice"].tolist() == [2 * (2 * pod + model), 2]
        assert bool(res["init|same"])
        split = set(res["init|split"].tolist())
        assert "blocks.0.moe.router" not in split
        assert {"embed", "unembed", "blocks.0.attn.wq", "blocks.0.ln1.weight",
                "blocks.0.moe.experts.w_up"} <= split


def test_the_teshu_dispatch_needs_the_mesh():
    cfg = mesh_ranks.moe_config(pconfig, "teshu2", "float32", 8.0)
    block = moe.MoE(cfg, device="cpu",
                    gen=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs the mesh"):
        moe.moe_ffn(block, cfg, torch.zeros(1, 4, D),
                    mesh_axes=("pod", "model"))


def test_the_training_forward_under_a_mesh_has_a_gradient(tmp_path):
    """On a one-rank gloo world (``elastic_mesh(1, model_parallel=1)``),
    SMOKE Qwen3-MoE's ``teshu2`` dispatch in the training forward: a
    finite loss that reaches every parameter, the router and the experts
    through the exchange among them (``test_torch_train_mesh.py`` holds the
    gradients on 8 ranks to the reference)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.models import lm
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = elastic_mesh(1, model_parallel=1, device_type="cpu")
        model = lm.init_lm(get_config(ARCH, smoke=True), seed=0,
                           device="cpu", mesh=mesh).requires_grad_(True)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, 256, (2, 12)))
                 for k in ("tokens", "labels")}
        meshops.reset_counts()
        loss = lm.train_loss(model, batch, mesh=mesh)
        assert loss.requires_grad and bool(torch.isfinite(loss))
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        assert meshops.COUNTS["all_to_all"] == 2 * 2 * 2   # 2 MoE layers
        assert meshops.COUNTS["reduce_scatter"] == 2
    finally:
        dist.destroy_process_group()
    for n, g in zip(named, grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, n


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_serve_emits_the_reference_tokens(runs, arch):
    """SMOKE DeepSeek-V2 (MLA, shared experts, the dense layer 0) served
    placed over the mesh, as ``test_serve_over_the_mesh_emits_the_reference
    _tokens`` holds Qwen3-MoE: the reference's tokens on every rank, each
    rank's logits within ``CACHED`` of the reference's rows."""
    key = f"serve-{arch}"
    want = runs["ref"][f"{key}|tokens"]
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res[f"{key}|tokens"], want)
    ranks = runs["ranks"]
    got = np.concatenate([ranks[r][f"{key}|logits"] for r in range(0, 8, 2)],
                         axis=1)
    np.testing.assert_allclose(got, runs["ref"][f"{key}|logits"], **CACHED)


@pytest.mark.parametrize("mesh", ["2x2x2", "2x4x1"])
@pytest.mark.parametrize("arch", (ARCH,) + ARCHS)
def test_placement_changes_no_logit(runs, arch, mesh):
    """Every leaf but the routed experts replicated (a monkeypatched
    ``shardings.leaf_spec``) in place of placed; the routed experts,
    placed in both runs, the only leaves held in part there.  On ``(2, 4,
    1)`` (``model`` 1) the same tokens and the same logits bit for bit on
    every rank.  On ``(2, 2, 2)`` the placed run splits its dense work
    over ``model`` (each row-parallel product summed over ``model`` in
    another order than one matmul): the same tokens, the logits within
    ``CACHED`` (through the bf16 cache)."""
    flat = mesh == "2x4x1"
    key = "serve" if arch == ARCH else f"serve-{arch}"
    placed = f"flat-placed-{arch}" if flat else key
    repl = f"flat-repl-{arch}" if flat else f"repl-{arch}"
    cfg = get_config(arch, smoke=True)
    experts = 3 * sum(1 for i in range(cfg.n_layers)
                      if not lm.is_dense_layer(cfg, i))
    for res in runs["ranks"]:
        assert int(res[f"{repl}|placed"]) == experts
        np.testing.assert_array_equal(res[f"{repl}|tokens"],
                                      res[f"{placed}|tokens"])
        if flat:
            np.testing.assert_array_equal(res[f"{repl}|logits"],
                                          res[f"{placed}|logits"])
        else:
            np.testing.assert_allclose(res[f"{repl}|logits"],
                                       res[f"{placed}|logits"], **CACHED)


@pytest.mark.parametrize("arch", (ARCH,) + ARCHS)
def test_rank_bytes_are_the_reference_per_device_bytes(runs, arch):
    """Each rank's parameter bytes after ``lm_params_from_reference(...,
    mesh=)`` equal its device's after the reference's ``jax.device_put``
    of the same tree by ``param_specs``, the leaves of
    ``lost_layer_splits`` aside (the reference splits their stack over
    layers; each rank holds a per-layer leaf's ``model`` shard whole over
    ``data``: its bytes are the device's share of the stack times the
    dropped axis' size, 2)."""
    from types import SimpleNamespace

    from repro_torch.launch import shardings
    cfg = get_config(arch, smoke=True)
    mesh = SimpleNamespace(shape=dict(zip(mesh_ranks.AXES, mesh_ranks.MESH)))
    lost = shardings.lost_layer_splits(cfg, mesh)
    lost_paths = {shardings._path_str(n, cfg)[0] for n in lost}
    if arch == ARCH:
        assert lost and set(lost.values()) == {("data",)}
    ref = {k.split("|", 1)[1]: v for k, v in runs["ref"].items()
           if k.startswith(f"bytes-{arch}|")}
    for r, res in enumerate(runs["ranks"]):
        mine = {k.split("|", 1)[1]: int(v) for k, v in res.items()
                if k.startswith(f"bytes-{arch}|")}
        kept = sum(v for n, v in mine.items() if n not in lost)
        want = sum(int(v[r]) for p, v in ref.items() if p not in lost_paths)
        assert kept == want, (r, kept, want)
        for p in lost_paths:
            held = sum(v for n, v in mine.items()
                       if shardings._path_str(n, cfg)[0] == p)
            assert held == int(ref[p][r]) * 2, (p, held)     # data: 2
