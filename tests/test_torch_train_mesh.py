"""The port's training under a mesh on the CPU, held against the JAX
package's.

Both sides run on a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh with
the EP axes ``("pod", "model")`` (``mesh_train_ranks.py``): the reference
in one subprocess over 8 forced host devices, its steps jitted under ``with
mesh:`` with the parameters replicated (as ``test_distributed.py``'s
``test_train_step_under_mesh_runs_and_learns`` runs them), and the port in
one spawn of 8 gloo ranks, each holding its rows of the batch and its shard
of every parameter and moment by the reference's sharding rules (its 2 of
the 8 routed experts, half of each over ``data``), every leaf gathered
whole at use; the ranks write their gradients and weights gathered whole.
The weights are the
reference's ``init_lm`` with every array jittered from numpy (the experts
made distinct), the same arrays on both sides; two labels of the batch are
masked, in one rank's rows, so that the loss's count is the global one.

Cases: DeepSeek-V2 SMOKE (MLA, shared experts, the dense layer 0) and
Qwen3-MoE SMOKE, float32, on ``teshu`` and ``teshu2``, at capacity factor
8.0 (no drops) and 1.0 (drops: each ``model`` slice keeps its own
capacity, so the port follows the reference's EP result, not gspmd's), at
``n_micro`` 1; ``n_micro`` 2 only at ``teshu2`` and 8.0, to keep the
reference's compiles (one a case, all in its one subprocess) in the file's
time.  The ``n_micro`` 2 cases run again with ``remat`` on (each block
recomputed in the backward, its exchanges reissued), held to the same
reference gradients.  The gspmd dispatch routes a rank's own rows with
their own capacity and aux loss: training refuses it on the ``(2, 2, 2)``
mesh, and on ``(1, 1, 8)`` (one batch shard) it is held to the port's own
mesh-free gradient, aux included.

Tolerances, from ``test_torch_train_loss.py``: the loss to rtol 1e-5, and
each gradient element within 2e-5 of the largest |element| of its leaf's
reference gradient.  The parameters after a step are held to
``test_torch_train.py``'s bound.  Four planted faults must miss the
gradient bound by 10x: the experts' gradients not summed over ``data``,
the dispatch's all-gather's backward a slice of its gradient without the
sum over ``model``, a leaf gathered with its ``model`` shard taken as major
over ``data``, and a placed leaf's gradient reduce-scatter replaced by a
slice.

Placement against replication (every leaf but the routed experts
replicated): the loss bit for bit, and each rank's gradients before the
sums over ranks bit for bit; after them within ``2 (R - 1) 2^-24 sum_r
|g_r|`` (R = 8 ranks), the bound of two orders of one float32 sum: a
placed leaf is summed by its gather's reduce-scatter over the axes its
spec names and then over the rest, a replicated one in one all-reduce
over all eight ranks, and gloo adds those in another order.
"""
import dataclasses
import shutil

import numpy as np
import pytest

import mesh_ranks
import mesh_train_ranks as mtr

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from test_torch_train_loss import F32_GRAD, F32_LOSS, jittered  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import shardings, steps  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.convert import named_from_reference  # noqa: E402

CONTROL_FACTOR = 10


def _inputs() -> dict:
    data = {}
    for i, arch in enumerate(mtr.ARCHS):
        cfg = ref_config(arch, smoke=True)
        p = jittered(jax.tree.map(np.asarray, jlm.init_lm(
            jax.random.key(20 + i), cfg)), 30 + i)
        data.update(mtr.flat(p, f"p-{arch}"))
        rng = np.random.default_rng(40 + i)
        labels = rng.integers(0, cfg.vocab, (mtr.B, mtr.S)).astype(np.int32)
        labels[2, :3] = -1                 # in the rows of (pod, data) 1
        data[f"batch-{arch}|labels"] = labels
        data[f"batch-{arch}|tokens"] = rng.integers(
            0, cfg.vocab, (mtr.B, mtr.S)).astype(np.int32)
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    inputs = tmp / "inputs.npz"
    data = _inputs()
    np.savez(inputs, **data)
    proc = mtr.start_reference(str(inputs), str(tmp / "ref.npz"))
    try:
        ranks = mtr.run_ranks("train", tmp, 8, (str(inputs),), timeout=240)
        (tmp / "b").mkdir()
        shutil.copytree(tmp / "ckpt" / "step_00000003",
                        tmp / "b" / "step_00000003")
        small = mtr.run_ranks("resume", tmp, 4, (str(inputs),
                                                 str(tmp / "b")), timeout=120)
    finally:
        mesh_ranks.finish(proc, timeout=300)
    return dict(ranks=ranks, small=small, data=data, tmp=tmp,
                ref=dict(np.load(tmp / "ref.npz")))


def _standin(shape=mtr.MESH):
    """The mesh's axes and sizes, all the sharding rules read."""
    from types import SimpleNamespace
    axes = ("pod", "data", "model")[-len(shape):]
    return SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)


def _whole(ranks, key: str, name: str) -> np.ndarray:
    """Leaf ``name`` of ``key`` as the reference holds it (every rank
    writes it gathered whole): every replica must hold the same bits."""
    for res in ranks:
        np.testing.assert_array_equal(res[f"{key}|{name}"],
                                      ranks[0][f"{key}|{name}"])
    return ranks[0][f"{key}|{name}"]


def _ref_named(arch: str, tree: dict) -> dict:
    model = lm.LM(get_config(arch, smoke=True), device="cpu")
    return {n: t.numpy() for n, t in named_from_reference(model,
                                                          tree).items()}


def _miss(got: dict, want: dict) -> float:
    """The worst ratio of a gradient element's error to the bound
    ``F32_GRAD`` times its leaf's largest reference |element|."""
    return max(float(np.abs(got[n] - w).max())
               / (F32_GRAD * max(float(np.abs(w).max()), 1e-30))
               for n, w in want.items())


def _port_grads(runs, key: str, arch: str) -> dict:
    names = [n for n, _ in lm.LM(get_config(arch, smoke=True),
                                 device="cpu").named_parameters()]
    return {n: _whole(runs["ranks"], f"{key}|g", n) for n in names}


@pytest.mark.parametrize("case", mtr.CASES, ids=[c[0] for c in mtr.CASES])
def test_loss_and_gradients_match_reference(runs, case):
    nm, arch, _, _, _ = case
    want = _ref_named(arch, mesh_ranks.unflatten(runs["ref"], f"{nm}|g"))
    got = _port_grads(runs, nm, arch)
    for res in runs["ranks"]:
        assert float(res[f"{nm}|loss"]) == pytest.approx(
            float(runs["ref"][f"{nm}|loss"]), rel=F32_LOSS)
    for n, w in want.items():
        assert got[n].shape == w.shape and np.isfinite(got[n]).all(), n
        if np.abs(w).max() > 0:
            assert np.abs(got[n]).max() > 0, f"{n} got no gradient"
    assert _miss(got, want) <= 1.0, nm


@pytest.mark.parametrize("arch", mtr.ARCHS)
def test_capacity_one_drops_tokens(runs, arch):
    """At factor 1.0 the reference's gradients differ from its own at 8.0
    (tokens dropped), so those cases hold the port to the drops."""
    for d in ("teshu", "teshu2"):
        a, b = (_ref_named(arch, mesh_ranks.unflatten(
            runs["ref"], f"{arch}-{d}-{cf}-1|g")) for cf in (8.0, 1.0))
        assert _miss(b, a) > CONTROL_FACTOR, d


def _layout(case, remat: bool = False) -> dict:
    """The collectives of one case's microbatches.  Per MoE layer and
    microbatch: the dispatch and the return exchange (one all-to-all each
    flat, two on the two-level template), the all-gather over ``model``
    and the aux loss's ``pmean`` forward; under remat the two exchanges
    again in the block's recompute (which stops before the all-gather);
    their adjoints (the reverse exchanges, a reduce-scatter and a sum)
    backward.  Per microbatch the placed leaves' gathers, an all-gather
    a split dimension of size over 1 but for the axes the leaf's module
    consumes in place (``shardings.kept_axes``: a routed expert's EP axes,
    a tensor-parallel leaf's ``model``), a block's again in its recompute
    under remat, and a reduce-scatter each backward; the embedding's
    lookup in its ``d`` slice all-gathered over ``model`` (a
    reduce-scatter backward); an MLA layer's two down-projections'
    outputs all-gathered over ``model`` (again in the recompute under
    remat; a reduce-scatter each backward).  The tensor-parallel sums over
    ``model``, forward and backward: one a head-split attention
    (Qwen3-MoE's 4 heads on 2, DeepSeek-V2's MLA: counted at ``wo``), an
    MLP (DeepSeek-V2's layer 0) and a shared-expert stack, its
    forward's again in the recompute under remat but for the block's last
    (DeepSeek-V2's MLP; the recompute stops at the block's last saved
    tensor); the vocabulary-parallel loss's max (forward only), its sum
    of exponentials and its gold logit.  All-reduces besides: the count of
    unmasked labels a microbatch, the gradient sums (``steps.sum_plan``:
    each leaf over the axes its spec does not name, one buffer an axis
    set) and the loss."""
    _, arch, dispatch, _, n_micro = case
    cfg = mtr.moe_cfg(get_config(arch, smoke=True), dispatch, 8.0)
    mesh = _standin()
    whole = dict(lm.LM(cfg, device="meta").named_parameters())
    specs = shardings.param_specs(whole, mesh, cfg)
    top = blocks = 0
    kept = {n: shardings.kept_axes(n, spec, mesh, cfg)
            for n, spec in specs.items()}
    for n, spec in specs.items():
        k = sum(1 for e in shardings.gather_spec(spec, mesh, kept[n]) if e)
        if n.startswith("blocks."):
            blocks += k
        else:
            top += k
    local = {n: torch.empty(shardings.local_shape(specs[n], p.shape, mesh),
                            device="meta") for n, p in whole.items()}
    sums = len(steps.sum_plan(local, mesh,
                              shardings.split_leaves(specs, mesh)))
    layers = cfg.n_layers - (1 if cfg.moe.num_shared else 0)
    per = layers * n_micro
    a2a = 2 if dispatch == "teshu2" else 1
    tp = sum(1 for n, k in kept.items() if "model" in k and n.endswith(
        (".attn.wo", ".mlp.w_up", ".moe.shared.w_up")))
    mla = sum(1 for n, k in kept.items() if "model" in k and n.endswith(
        (".attn.wq_a", ".attn.wkv_a")))
    last = sum(1 for n, k in kept.items() if "model" in k and n.endswith(
        ".mlp.w_up"))                     # the block's last op: no recompute
    embed = int("model" in kept["embed"])
    vocab = int("model" in kept["unembed"])
    return dict(all_to_all=(3 if remat else 2) * 2 * a2a * per,
                all_gather=per + n_micro * (top + (2 if remat else 1)
                                            * (blocks + mla) + embed),
                all_reduce=n_micro + sums + 1 + 2 * per + n_micro * (
                    2 * tp + (tp - last if remat else 0) + 5 * vocab),
                reduce_scatter=per + n_micro * (top + blocks + mla + embed),
                send_recv=0)


@pytest.mark.parametrize("case", mtr.CASES, ids=[c[0] for c in mtr.CASES])
def test_collectives_follow_the_layout(runs, case):
    from repro_torch.core import meshops
    for res in runs["ranks"]:
        assert dict(zip(meshops.KINDS, res[f"{case[0]}|counts"].tolist())) \
            == _layout(case)


@pytest.mark.parametrize("case", mtr.REMAT_CASES,
                         ids=[c[0] for c in mtr.REMAT_CASES])
def test_remat_matches_reference_and_reissues_the_exchanges(runs, case):
    """With ``remat`` every rank recomputes each block in the backward and
    reissues its exchanges in the same order: the loss and gradients of
    the reference's case (remat changes no value), and the collectives of
    the layout with the recompute's exchanges."""
    from repro_torch.core import meshops
    nm, arch = case[0], case[1]
    want = _ref_named(arch, mesh_ranks.unflatten(runs["ref"], f"{nm}|g"))
    got = _port_grads(runs, f"remat-{nm}", arch)
    for res in runs["ranks"]:
        assert float(res[f"remat-{nm}|loss"]) == pytest.approx(
            float(runs["ref"][f"{nm}|loss"]), rel=F32_LOSS)
        assert dict(zip(meshops.KINDS, res[f"remat-{nm}|counts"].tolist())) \
            == _layout(case, remat=True)
    assert _miss(got, want) <= 1.0, nm


def test_gspmd_training_is_refused_over_several_batch_shards(runs):
    """The gspmd dispatch routes a rank's own rows with their own capacity
    and aux loss, where the reference's routes the global batch: on the
    ``(2, 2, 2)`` mesh, four batch shards, the training forward raises on
    every rank."""
    assert all(bool(res["gspmd|refused"]) for res in runs["ranks"])


@pytest.mark.parametrize("case", mtr.GSPMD_CASES,
                         ids=[c[0] for c in mtr.GSPMD_CASES])
def test_gspmd_on_one_batch_shard_is_the_mesh_free_gradient(runs, case):
    """On ``(1, 1, 8)`` every rank holds the whole batch and every expert:
    the global loss and each rank's summed gradients, the aux loss's
    share included (the aux over the number of ranks), against the port's
    own mesh-free loss and gradient of the batch, at capacity 8.0 and 1.0
    (the same drops: the same tokens routed together)."""
    from repro_torch.models.convert import lm_params_from_reference
    key, arch, cf = case
    cfg = mtr.moe_cfg(get_config(arch, smoke=True), "gspmd", cf)
    model = lm_params_from_reference(cfg, mesh_ranks.unflatten(
        runs["data"], f"p-{arch}"), device="cpu").requires_grad_(True)
    loss = lm.train_loss(model, {k: torch.from_numpy(
        runs["data"][f"batch-{arch}|{k}"]) for k in ("tokens", "labels")})
    named = dict(model.named_parameters())
    want = {n: t.numpy() for n, t in zip(
        named, torch.autograd.grad(loss, list(named.values())))}
    for res in runs["ranks"]:
        assert float(res[f"{key}|loss"]) == pytest.approx(
            float(loss.detach()), rel=F32_LOSS)
        assert _miss({n: res[f"{key}|g|{n}"] for n in want}, want) <= 1.0


@pytest.mark.parametrize("arch", mtr.ARCHS)
def test_gradients_match_the_mesh_free_global_batch(runs, arch):
    """At 8.0, the mesh's gradients against the port's own on the whole
    batch without a mesh.  The EP dispatch's aux loss is the mean of each
    ``model`` slice's own (E sum f_e P_e is not linear in the tokens), not
    the whole batch's, so both runs zero the aux loss here."""
    cfg = mtr.moe_cfg(get_config(arch, smoke=True), "teshu2", 8.0)
    from repro_torch.models.convert import lm_params_from_reference
    model = lm_params_from_reference(cfg, mesh_ranks.unflatten(
        runs["data"], f"p-{arch}"), device="cpu").requires_grad_(True)
    real = moe._route
    moe._route = lambda *a: (lambda e, w, aux: (e, w, aux * 0))(*real(*a))
    try:
        loss = lm.train_loss(model, {k: torch.from_numpy(
            runs["data"][f"batch-{arch}|{k}"]) for k in ("tokens", "labels")})
        named = dict(model.named_parameters())
        g = torch.autograd.grad(loss, list(named.values()))
    finally:
        moe._route = real
    want = {n: t.numpy() for n, t in zip(named, g)}
    got = _port_grads(runs, f"noaux-{arch}", arch)
    assert float(runs["ranks"][0][f"noaux-{arch}|loss"]) == pytest.approx(
        float(loss.detach()), rel=F32_LOSS)
    assert _miss(got, want) <= 1.0


def test_prefill_and_serve_steps_over_the_mesh(runs):
    """``make_prefill_step`` and ``make_serve_step`` with the mesh: each
    rank's rows' last logits and next step's logits against the same
    step builders on the whole batch without a mesh (capacity 8.0: the
    same tokens kept), within ``test_torch_train.py``'s step bound (both
    attend over the bf16 cache)."""
    from repro_torch.models.config import SHAPES
    from repro_torch.models.convert import lm_params_from_reference
    from test_torch_train import STEP_ATOL, STEP_RTOL
    arch = mtr.TRAIN["arch"]
    cfg = mtr.moe_cfg(get_config(arch, smoke=True), "teshu2", 8.0)
    model = lm_params_from_reference(cfg, mesh_ranks.unflatten(
        runs["data"], f"p-{arch}"), device="cpu")
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=mtr.S + 1,
                                global_batch=mtr.B)
    toks = torch.from_numpy(runs["data"][f"batch-{arch}|tokens"])
    last, cache = steps.make_prefill_step(cfg, shape)(model,
                                                      {"tokens": toks})
    nxt, _ = steps.make_serve_step(cfg)(model, cache,
                                        {"tokens": toks[:, :1]})
    per = mtr.B // 4                       # rows a (pod, data) group
    for r, res in enumerate(runs["ranks"]):
        rows = slice(r // 2 * per, (r // 2 + 1) * per)
        np.testing.assert_allclose(res["prefill|last"], last[rows].numpy(),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
        np.testing.assert_allclose(res["serve|next"], nxt[rows].numpy(),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("control", ["no_data_sum", "no_gather_sum",
                                     "model_major", "rs_slice"])
def test_planted_faults_miss_the_gradient_bound(runs, control):
    arch = mtr.CONTROL_CASE.split("-teshu")[0]
    want = _ref_named(arch, mesh_ranks.unflatten(
        runs["ref"], f"{mtr.CONTROL_CASE}|g"))
    # rank 0's leaves, gathered whole (a fault may leave the replicas
    # unequal)
    got = {n: runs["ranks"][0][f"{control}|g|{n}"] for n in want}
    held = _port_grads(runs, mtr.CONTROL_CASE, arch)
    assert _miss(held, want) <= 1.0
    assert _miss(got, want) >= CONTROL_FACTOR, control


def _spacing(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 23)


def test_three_steps_match_reference_and_learn(runs):
    """Three ``make_train_step`` steps (``lr`` 1e-2, ``n_micro`` 2) from
    the same weights on one batch: every rank's parameters within
    ``test_torch_train.py``'s bound of the reference's after each step, the
    loss and the gradient norm the reference's, and the loss falls."""
    ref, ranks, arch = runs["ref"], runs["ranks"], mtr.STEPS["arch"]
    names = [n for n, _ in lm.LM(get_config(arch, smoke=True),
                                 device="cpu").named_parameters()]
    bound = {n: 0.0 for n in names}
    capped = total = 0
    losses = []
    for i in range(mtr.STEPS["n"]):
        for res in ranks:
            assert float(res[f"step{i}|loss"]) == pytest.approx(
                float(ref[f"step{i}|loss"]), rel=F32_LOSS)
            assert float(res[f"step{i}|grad_norm"]) == pytest.approx(
                float(ref[f"step{i}|grad_norm"]), rel=1e-5)
            # the schedule's float32 cosine: XLA's and torch's may round
            # a step apart (one ulp seen at step 1)
            assert float(res[f"step{i}|lr"]) == pytest.approx(
                float(ref[f"step{i}|lr"]), rel=2 ** -23)
        losses.append(float(ref[f"step{i}|loss"]))
        lr = float(ref[f"step{i}|lr"])
        scale = min(1.0, 1.0 / float(ref[f"step{i}|grad_norm"]))
        g = _ref_named(arch, mesh_ranks.unflatten(ref, f"step{i}|g"))
        v = _ref_named(arch, mesh_ranks.unflatten(ref, f"step{i}|v"))
        want = _ref_named(arch, mesh_ranks.unflatten(ref, f"step{i}|p"))
        for n in names:
            e = F32_GRAD * float(np.abs(g[n]).max()) * scale
            root = np.sqrt(v[n] / (1 - 0.95 ** (i + 1)))
            move = np.minimum(2 * e / np.maximum(root - e, 1e-30), 2.0)
            move = np.where(v[n] == 0, 0.0, move)
            bound[n] = bound[n] + lr * move
            got = _whole(ranks, f"step{i}|p", n)
            assert (np.abs(got - want[n]) <= bound[n]
                    + 2 * _spacing(want[n])).all(), (i, n)
            capped += int((move == 2.0).sum())
            total += got.size
    assert capped < 5e-4 * total, (capped, total)
    assert losses[-1] < losses[0], losses


def test_train_over_the_mesh_is_the_step_on_the_pipeline_rows(runs):
    """``train(mesh=...)`` against a loop of ``make_train_step(...,
    mesh=mesh)`` on ``rank_rows`` of ``batch_at(n)``: the same losses,
    norms and weights bit for bit; and each rank's rows are the ones the
    reference's microbatch-major sharding hands its device."""
    for r, res in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(res["train|loss"], res["loop|loss"])
        for k in res:
            if k.startswith("train|p|"):
                np.testing.assert_array_equal(res[k],
                                              res["loop|p|" + k[8:]])
        for n in range(mtr.TRAIN["steps"]):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(
                    res[f"rows|{n}|{k}"], runs["ref"][f"rows|{n}|{r}|{k}"])
    losses = runs["ranks"][0]["train|loss"]
    assert np.isfinite(losses).all() and len(losses) == mtr.TRAIN["steps"]


def _block(spec, shape, coord: dict, sizes: dict) -> tuple:
    """The block of a leaf of ``shape`` at mesh coordinate ``coord`` by
    ``spec``: on each dimension the block of the index over its axes, the
    first axis major."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        k, i = 1, 0
        for a in axes:
            k, i = k * sizes[a], i * sizes[a] + int(coord[a])
        out.append(slice(i * n // k, (i + 1) * n // k))
    return tuple(out)


def test_checkpoint_restores_onto_a_mesh_of_another_ep_size(runs):
    """Saved on ``(2, 2, 2)`` (EP 4), restored onto ``(1, 2, 2)`` (EP 2):
    each rank's shards of the parameters and moments are the checkpoint's
    blocks by their specs bit for bit,
    and steps 3-5 resumed there (``n_micro`` 2, whose microbatches route
    the same groups of rows as the 8 ranks at ``n_micro`` 1) give the
    uninterrupted run's losses."""
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    arch = mtr.CKPT["arch"]
    model = lm.LM(get_config(arch, smoke=True), device="cpu")
    named = dict(model.named_parameters())
    target = {"params": named, "opt_state": {
        "m": named, "v": named, "step": torch.zeros((), dtype=torch.int32)}}
    saved, meta = restore_checkpoint(str(runs["tmp"] / "b"), 3, target)
    assert meta["step"] == 3
    mesh = _standin(mtr.SMALL)
    cfg = get_config(arch, smoke=True)
    for r, res in enumerate(runs["small"]):
        coord = dict(zip(mesh.axis_names,
                         np.unravel_index(r, mtr.SMALL)))
        first, count = res["expert_slice"].tolist()
        assert (first, count) == (4 * coord["model"], 4)
        assert int(res["restored|step"]) == 3
        for n in named:
            spec = shardings.leaf_spec(n, named[n].shape, mesh, cfg)
            for key, tree in (("p", saved["params"]),
                              ("m", saved["opt_state"]["m"]),
                              ("v", saved["opt_state"]["v"])):
                want = tree[n].numpy()
                np.testing.assert_array_equal(
                    res[f"restored|{key}|{n}"],
                    want[_block(spec, want.shape, coord, mesh.shape)])
    # only rank 0 journals: the 8-rank run's 6 steps, a start and an end
    journal = (runs["tmp"] / "ckpt" / "shuffle_journal.jsonl").read_text()
    assert journal.count("train_step") == 2 * mtr.CKPT["steps"]
    full = runs["ranks"][0]["ckpt|loss"]
    for res in runs["small"]:
        got = res["resumed|loss"]
        assert len(got) == 3
        assert got[0] == pytest.approx(full[3], rel=F32_LOSS)
        np.testing.assert_allclose(got, full[3:], rtol=1e-4)


@pytest.mark.parametrize("n_micro", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2), (4, 1), (1, 16)])
def test_clamp_n_micro_is_the_reference_rule(n_micro, shape):
    from types import SimpleNamespace

    from repro.models.config import SHAPES as RSHAPES

    from repro_torch.models.config import SHAPES
    axes = ("pod", "data", "model")[-len(shape):]
    mesh = SimpleNamespace(shape=dict(zip(axes, shape)))
    for b in (8, 12, 256):
        got = steps.clamp_n_micro(steps.Recipe(n_micro=n_micro),
                                  dataclasses.replace(SHAPES["train_4k"],
                                                      global_batch=b), mesh)
        want = jsteps.clamp_n_micro(jsteps.Recipe(n_micro=n_micro),
                                    dataclasses.replace(RSHAPES["train_4k"],
                                                        global_batch=b), mesh)
        assert got.n_micro == want.n_micro, (b, shape)


def test_rank_rows_refuse_a_batch_that_does_not_divide():
    """8 rows in 3 microbatches, or 2 microbatches of 4 rows over 8 batch
    shards: refused with a message."""
    from types import SimpleNamespace

    from repro_torch.data import rank_rows
    mesh = SimpleNamespace(shape={"pod": 2, "data": 4, "model": 2},
                           axis_size=lambda axes: 8, index=lambda axes: 0)
    x = np.arange(8 * 3).reshape(8, 3)
    for n in (3, 2):
        with pytest.raises(ValueError, match="does not divide"):
            rank_rows(x, mesh, n)
    np.testing.assert_array_equal(rank_rows(x, mesh, 1), x[:1])


@pytest.mark.parametrize("shape", mtr.PLACE_MESHES,
                         ids=["x".join(map(str, s)) for s in mtr.PLACE_MESHES])
@pytest.mark.parametrize("case", mtr.PLACE_CASES,
                         ids=[c[0] for c in mtr.PLACE_CASES])
def test_placement_changes_where_state_lives_not_what_is_computed(runs, case,
                                                                  shape):
    """Every leaf but the routed experts replicated (a monkeypatched
    ``shardings.leaf_spec``) against placed.  On ``(2, 4, 1)`` (``model``
    1) the same loss bit for bit and, on every rank, the same gradients
    before the sums over ranks (a placed leaf's as its gather's backward
    receives it) bit for bit; the routed experts, placed in both runs, the
    same after them; every other leaf after them within the bound of two
    orders of the sum over 8 ranks.  On ``(2, 2, 2)`` the placed run splits
    its dense work over ``model`` (each row-parallel product summed over
    ``model`` in another order than one matmul, and the split leaves'
    gradients before the sums are their shards): the loss to rtol
    ``F32_LOSS`` and each summed gradient within ``F32_GRAD`` of its
    leaf's largest replicated element."""
    key, arch = case
    ranks = runs["ranks"]
    placed, repl = (mtr.place_key(f"{t}-{arch}", shape)
                    for t in ("placed", "replicated"))
    names = [n for n, _ in lm.LM(get_config(arch, smoke=True),
                                 device="meta").named_parameters()]
    experts = [n for n in names if ".moe.experts." in n]
    for res in ranks:
        assert int(res[f"{repl}|split"]) == len(experts)
        assert int(res[f"{placed}|split"]) > 2 * len(experts)
    if tuple(shape) == mtr.MESH:
        for res in ranks:
            assert float(res[f"{placed}|loss"]) == pytest.approx(
                float(res[f"{repl}|loss"]), rel=F32_LOSS)
        want = {n: _whole(ranks, f"{repl}|g", n) for n in names}
        assert _miss({n: _whole(ranks, f"{placed}|g", n) for n in names},
                     want) <= 1.0
        return
    for res in ranks:
        assert float(res[f"{placed}|loss"]) == float(res[f"{repl}|loss"])
        for n in names:
            np.testing.assert_array_equal(res[f"{placed}|pre|{n}"],
                                          res[f"{repl}|pre|{n}"])
    for n in names:
        a, b = (_whole(ranks, f"{t}|g", n) for t in (placed, repl))
        if n in experts:
            np.testing.assert_array_equal(a, b)
            continue
        absum = sum(np.abs(res[f"{placed}|pre|{n}"]).astype(np.float64)
                    for res in ranks)
        assert (np.abs(a.astype(np.float64) - b) <= 2 * 7 * 2.0 ** -24
                * absum).all(), n


def test_train_holds_the_reference_per_device_bytes(runs):
    """``train(mesh=...)``'s parameters and float32 moments: each rank's
    bytes equal its device's after the reference's ``jax.device_put`` of
    the same trees by ``param_specs`` and ``opt_v_specs``, the leaves of
    ``lost_layer_splits`` aside (each held whole over ``data``, the
    stack's share times 2)."""
    arch = mtr.TRAIN["arch"]
    cfg = get_config(arch, smoke=True)
    lost = shardings.lost_layer_splits(cfg, _standin())
    assert lost and set(lost.values()) == {("data",)}
    ref = runs["ref"]
    for r, res in enumerate(runs["ranks"]):
        for k, pre in (("p", "bytes|p|"), ("m", "bytes|o|m/"),
                       ("v", "bytes|o|v/")):
            mine = {n[len(f"tbytes|{k}|"):]: int(v) for n, v in res.items()
                    if n.startswith(f"tbytes|{k}|")}
            paths = {}
            for n, v in mine.items():
                p = shardings._path_str(n, cfg)[0]
                paths[p] = paths.get(p, 0) + v
            lost_paths = {shardings._path_str(n, cfg)[0] for n in lost}
            assert sum(v for p, v in paths.items() if p not in lost_paths) \
                == sum(int(ref[pre + p][r]) for p in paths
                       if p not in lost_paths), (r, k)
            for p in lost_paths:
                assert paths[p] == 2 * int(ref[pre + p][r]), (r, k, p)


def _ref_cell_path(n: str, cfg) -> tuple[str, bool]:
    """The reference's path of a port stand-in (``params/<name>``,
    ``opt_state/m/<name>``, ``cache/layers/<i>/...``) and whether the
    reference stacks it over layers."""
    kind, _, rest = n.partition("/")
    if kind == "cache":
        _, i, sub = rest.split("/", 2)
        start = shardings._first_stacked(cfg)
        if not shardings._uniform_scan(cfg):
            return f"layers/{i}/{sub}", False
        return (f"block0/{sub}", False) if int(i) < start \
            else (f"blocks/{sub}", True)
    if kind == "batch" or rest == "step":
        return rest, False
    if kind == "opt_state":
        moment, _, rest = rest.partition("/")
        path, layers = shardings._path_str(rest, cfg)
        return f"{moment}/{path}", bool(layers)
    path, layers = shardings._path_str(rest, cfg)
    return path, bool(layers)


@pytest.mark.parametrize("shape", mtr.CELLS)
@pytest.mark.parametrize("arch", mtr.ARCHS)
def test_build_cell_stand_ins_match_the_reference(runs, arch, shape):
    """``steps.build_cell`` of a SMOKE cell on ``(2, 2, 2)``: every
    stand-in's global shape, dtype and local shape (a per-layer leaf's
    those of the reference's stacked leaf without the layer axis) equal to
    the reference ``build_cell``'s ``cell.args`` leaf and its
    ``sharding.shard_shape``, on every rank; every reference leaf but the
    cache's ``pos`` and ``len`` has a stand-in."""
    cfg = get_config(arch, smoke=True)
    kind = {"train": ("params", "opt_state", "batch"),
            "prefill": ("params", "batch"),
            "decode": ("params", "cache", "batch")}[
        shape.split("_")[0]]
    pre = f"cell|{arch}|{shape}|"
    ref = {k[len(pre):].rsplit("|", 1)[0] for k in runs["ref"]
           if k.startswith(pre)}
    seen = set()
    for res in runs["ranks"]:
        mine = {k[len(pre):].rsplit("|", 1)[0] for k in res
                if k.startswith(pre)}
        assert mine
        for n in sorted(mine):
            path, stacked = _ref_cell_path(n, cfg)
            rp = f"{kind.index(n.split('/')[0])}/{path}"
            seen.add(rp)
            g, loc, dt = (runs["ref"][f"{pre}{rp}|{f}"]
                          for f in ("global", "local", "dtype"))
            if stacked:
                g, loc = g[1:], loc[1:]
            assert res[f"{pre}{n}|global"].tolist() == g.tolist(), n
            assert res[f"{pre}{n}|local"].tolist() == loc.tolist(), n
            assert str(res[f"{pre}{n}|dtype"]) == str(dt), n
    assert ref - seen == {p for p in ref if p.rsplit("/", 1)[-1] in
                          ("pos", "len")}, sorted(ref - seen)


@pytest.mark.parametrize("shape", mtr.PLACE_MESHES,
                         ids=["x".join(map(str, s)) for s in mtr.PLACE_MESHES])
def test_factored_moment_under_placement(runs, shape):
    """One step (the ``STEPS`` step; on ``(2, 4, 1)`` at ``n_micro`` 1) with
    a factored second moment: the placed leaves' row and column means are
    local sums summed over the axes that split the dimension they reduce;
    against the same step with every leaf but the routed experts
    replicated (means taken whole), each factor within 1e-5 of its leaf's
    largest, every rank alike; each weight within ``1e-4 lr`` on
    ``(2, 4, 1)``, where both runs compute the same rows; on ``(2, 2, 2)``,
    where the placed run splits its dense work over ``model``, within
    ``test_three_steps_match_reference_and_learn``'s bound of one step
    from gradients ``2 F32_GRAD`` of their leaf's largest apart (the
    replicated run's gradients and factors giving the step's scale).  And
    ``named_from_reference(..., mesh=)`` gives each rank's shards of the
    reference's arrays."""
    from repro_torch.optim import AdamWConfig
    ranks = runs["ranks"]
    lr = mtr.STEPS["opt"]["lr"]
    placed, repl = (mtr.place_key(f"factored-{t}", shape)
                    for t in ("placed", "replicated"))
    keys = [k.split("|", 1)[1] for k in ranks[0]
            if k.startswith(f"{placed}|")]
    assert any(k.startswith(("r|", "c|")) for k in keys)
    tp = tuple(shape) == mtr.MESH
    if tp:
        b2t = 1 - AdamWConfig(**mtr.STEPS["opt"]).b2      # step 1's
        grads = {k[len(repl) + 3:]: _whole(ranks, repl, k[len(repl) + 1:])
                 for k in ranks[0] if k.startswith(f"{repl}|g|")}
        norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                           for g in grads.values()))
        scale = min(1.0, 1.0 / norm)
    for k in keys:
        a = _whole(ranks, placed, k)
        b = _whole(ranks, repl, k)
        if not k.startswith("p|"):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max() + 1e-30, k
        elif not tp:
            assert np.abs(a - b).max() <= 1e-4 * lr, k
        else:
            n = k[2:]
            g = grads[n].astype(np.float64) * scale
            e = 2 * F32_GRAD * float(np.abs(g).max())
            if f"r|{n}" in keys:          # the factored step's sqrt(v)
                r = _whole(ranks, repl, f"r|{n}").astype(np.float64)
                c = _whole(ranks, repl, f"c|{n}").astype(np.float64)
                root = np.sqrt(r[..., :, None] * c[..., None, :] / np.maximum(
                    r.mean(-1)[..., None, None], 1e-30) / b2t)
            else:
                root = np.abs(g)
            move = np.minimum(2 * e / np.maximum(root - e, 1e-30), 2.0)
            assert (np.abs(a - b) <= lr * move + 2 * _spacing(b)).all(), k
    if tp:
        assert all(bool(res["named|same"]) for res in ranks)
