"""The port's tensor parallelism over ``model`` on the CPU, held against
the JAX package.

The port's ranks along ``model`` split the dense work as the reference's
sharding rules do (``shardings.kept_axes``): an MLP's ``w_gate`` / ``w_up``
column-parallel and ``w_down`` row-parallel, a GQA layer's heads (its kv
heads too where ``model`` divides them, else each rank the one kv head its
q heads read, its cache every kv head of the rank's block of ``T``), the
embedding's ``d`` slice and the unembedding's vocabulary
slice, each row-parallel product ending in one sum over ``model``; an
MLA layer its ``h/m`` heads of ``wq_b`` / ``wkv_b`` (columns) and ``wo``
(rows) and its ``1/m`` of the down-projections ``wq_a`` / ``wkv_a``, whose
outputs it all-gathers, the latent cache the rank's block of ``T`` (a
decode step attends all heads over it and merges the blocks into the
rank's heads by their log-sum-exps); Hymba's
Mamba head its ``di/m`` channels (``w_in``'s columns computed and
all-gathered, the rank's own of ``x`` and ``z`` taken; ``w_bcdt``'s
partial product summed; ``w_out`` row-parallel; its state the rank's
channels) beside its attention split by heads; the xLSTM mixers their
in-projections' columns, all-gathered, the cores and states whole, and
``w_down``'s rows; a GQA layer whose heads do not divide ``model`` its
``1/m`` of the columns of ``wq`` / ``wk`` / ``wv`` (all-gathered, then
rotated) and of the rows of ``wo``, attending for its query rows (blocks
``r`` and ``2m - 1 - r`` of ``2m``, their outputs exchanged by an
all-to-all) or, in a decode step, over its block of the cache's ``T``,
the blocks merged by their log-sum-exps.  Eight SMOKE models (Qwen2.5-14B,
Granite-34B's MQA, Qwen3-MoE's GQA beside ``teshu2``, DeepSeek-V2's MLA,
shared experts and layer 0, Hymba-1.5B, xLSTM-350M, and the variants split
by positions: Qwen2.5-14B with 5 heads and 1 kv head, Hymba with 6 and 3,
``tp_ranks.VARIANTS``) run on 8 gloo ranks as ``(2, 2, 2)`` and
``(1, 2, 4)`` ``("pod", "data", "model")`` meshes (``tp_ranks.py``), and
the reference in one subprocess over 8 forced host devices, on the same
weights (``init_lm`` jittered from numpy) and batch (two labels masked).

Tolerances: the forward's logits within ``LAYER`` of
``test_torch_moe_ep.py`` (float32 matmuls summing in other orders: a
row-parallel product is summed over ``model`` in another order than one
matmul); served tokens equal and the last positions' logits within
``CACHED`` (through the bf16 cache), as are DeepSeek-V2's, Hymba's,
xLSTM's and the variants' logits of a prefill in two chunks on one cache;
the loss to rtol
``F32_LOSS`` and each summed gradient within ``F32_GRAD`` of its leaf's
largest reference element (``test_torch_train_mesh.py``'s bound).  Nineteen
planted faults must miss by 10x: the row-parallel sum skipped, the
replicated kv head taken as ``r % n_kv_heads``, the gold logit taken from
every rank, the column-split leaves' gradients summed over ``model``; in
MLA ``q_a_norm`` taken over the rank's columns before the gather, the
rank's ``wkv_b`` heads taken at the next rank's offset and ``wo``'s sum
skipped; in Hymba ``w_in``'s contiguous block taken as the rank's ``x``
and ``z``, ``w_bcdt``'s and ``w_out``'s sums skipped; in xLSTM the mLSTM
output normed over the rank's columns and the sLSTM ``w_down`` sum
skipped; split by positions, RoPE applied to a rank's columns before the
gather, a rank's query rows swapped with the next rank's, the decode's
blocks merged by a plain mean and each block given the layer's window;
with the caches split by ``T``, a KV-replication block written with the
rank's own kv head in every head, MLA's blocks merged by a plain mean and
rank ``r`` writing the rows of rank ``r + 1``'s block.
"""
from types import SimpleNamespace

import numpy as np
import pytest

import tp_ranks

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from test_torch_moe_ep import CACHED, LAYER  # noqa: E402
from test_torch_train_loss import F32_GRAD, F32_LOSS, jittered  # noqa: E402
from test_torch_train_mesh import _block  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.models import lm  # noqa: E402

AXES = ("pod", "data", "model")
CONTROL_FACTOR = 10
CASES = [(a, s) for s in tp_ranks.MESHES for a in tp_ranks.ARCHS]
IDS = [f"{a}-{tp_ranks.mesh_name(s)}" for a, s in CASES]


def _inputs() -> dict:
    data = {}
    for i, arch in enumerate(tp_ranks.ARCHS):
        cfg = tp_ranks.config(arch, ref_config)
        p = jittered(jax.tree.map(np.asarray, jlm.init_lm(
            jax.random.key(50 + i), cfg)), 60 + i)
        data.update(tp_ranks.flat_tree(p, f"p-{arch}"))
        rng = np.random.default_rng(70 + i)
        shape = (tp_ranks.B, tp_ranks.S)
        labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        labels[2, :3] = -1
        data[f"batch-{arch}|labels"] = labels
        data[f"batch-{arch}|tokens"] = rng.integers(
            0, cfg.vocab, shape).astype(np.int32)
        if arch != "qwen3-moe-235b-a22b":   # a reference cache of distinct
            cache = jax.tree.map(              # values in every array
                lambda a: rng.standard_normal(np.shape(a)).astype(np.float32)
                if np.ndim(a) >= 2 else np.asarray(a),
                jlm.init_cache(cfg, 2, 8))
            data.update(tp_ranks.flat_tree(cache, f"cache-{arch}"))
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import mesh_ranks
    tmp = tmp_path_factory.mktemp("tp")
    inputs = tmp / "inputs.npz"
    data = _inputs()
    np.savez(inputs, **data)
    proc = tp_ranks.start_reference(str(inputs), str(tmp / "ref.npz"))
    try:
        ranks = tp_ranks.run_ranks(tmp, str(inputs), timeout=300)
    finally:
        mesh_ranks.finish(proc, timeout=300)
    return dict(ranks=ranks, data=data, tmp=tmp,
                ref=dict(np.load(tmp / "ref.npz")))


def _standin(shape):
    return SimpleNamespace(shape=dict(zip(AXES, shape)), axis_names=AXES)


def _coord(rank: int, shape) -> dict:
    return dict(zip(AXES, map(int, np.unravel_index(rank, shape))))


def _rows(rank: int, shape) -> slice:
    """The batch rows of ``rank``: those of its ``(pod, data)`` index."""
    c = _coord(rank, shape)
    groups = shape[0] * shape[1]
    per = tp_ranks.B // groups
    i = c["pod"] * shape[1] + c["data"]
    return slice(i * per, (i + 1) * per)


def _miss(got: dict, want: dict) -> float:
    return max(float(np.abs(got[n] - w).max())
               / (F32_GRAD * max(float(np.abs(w).max()), 1e-30))
               for n, w in want.items())


def _logit_miss(got, want, tol=LAYER) -> float:
    return float((np.abs(got - want) / (tol["atol"] + tol["rtol"]
                                        * np.abs(want))).max())


def _grads(res, key: str, names) -> dict:
    return {n: res[f"{key}|g|{n}"] for n in names}


def _ref_grads(runs, arch: str, shape) -> dict:
    from repro_torch.models.convert import named_from_reference
    model = lm.LM(tp_ranks.config(arch, get_config), device="cpu")
    return {n: t.numpy() for n, t in named_from_reference(
        model, tp_ranks.unflat_tree(
            runs["ref"], f"{tp_ranks.ref_key(arch, shape)}|g")).items()}


_MIXER_TP = {".mamba.": ("w_in", "conv", "log_a", "w_out"),
             ".mlstm.": ("w_up", "wq", "wk", "wv", "w_ifo", "w_down"),
             ".slstm.": ("w_in", "w_down")}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16), (2, 2, 2),
                                   (1, 2, 4)])
def test_kept_axes_rule(arch, shape):
    """``shardings.kept_axes`` for every leaf of the full-width config: a
    routed expert keeps its EP axes (teshu / teshu2), ``model`` is kept by
    the MLP's and shared experts' matrices, the embedding and unembedding
    where their spec names it, by ``wq`` / ``wo`` where
    ``attention_split`` splits the heads and by ``wk`` / ``wv`` where it
    splits the kv heads too, and by MLA's ``wq_a``, ``wq_b``, ``wkv_a``,
    ``wkv_b`` and ``wo`` where ``mla_split`` splits its heads (``model``
    divides ``n_heads``: DeepSeek-V2's 128 on all four meshes), by Hymba's
    Mamba ``w_in``, ``conv``, ``log_a`` and ``w_out`` where
    ``mixer_split`` splits its channels (``model`` divides ``di``: 3,200
    on 16, 2 and 4) and by the xLSTM mixers' projections (``w_up``, ``wq``,
    ``wk``, ``wv``, ``w_ifo``, ``w_in``, ``w_down``) on every mesh; Hymba's
    attention splits as GQA does; where the heads do not divide ``model``
    (Qwen2.5-14B's 40 and Hymba's 25 on 16) the ``"positions"`` split
    keeps ``model`` for ``wq``, ``wk``, ``wv`` and ``wo`` alike (every
    width divides 16); nothing else keeps an axis (sLSTM's
    ``w_rec``, Mamba's ``w_bcdt`` and ``d_skip`` are gathered whole), and a
    leaf whose spec does not name ``model`` keeps none of it (xLSTM's
    ``w_ifo``, 12 columns, on 16)."""
    cfg = get_config(arch)
    axes = AXES[-len(shape):]
    mesh = SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
    split = shardings.attention_split(cfg, mesh)
    mla = shardings.mla_split(cfg, mesh)
    mixer = shardings.mixer_split(cfg, mesh)
    m = mesh.shape["model"]
    assert mixer == (cfg.family == "ssm" or (
        cfg.family == "hybrid" and cfg.d_model * cfg.ssm.expand % m == 0))
    if cfg.family in ("dense", "moe", "hybrid") and cfg.mla is None:
        want = "positions" if cfg.n_heads % m else "heads" \
            if cfg.n_kv_heads % m == 0 else "replicate" \
            if m % cfg.n_kv_heads == 0 else "positions"
        assert split == want
    else:
        assert split is None
    assert mla == (cfg.mla is not None and cfg.n_heads % m == 0)
    model = lm.LM(cfg, device="meta")
    for n, p in model.named_parameters():
        spec = shardings.leaf_spec(n, p.shape, mesh, cfg)
        kept = shardings.kept_axes(n, spec, mesh, cfg)
        named = {a for e in spec if e for a in
                 ((e,) if isinstance(e, str) else e)}
        assert set(kept) <= named, (n, spec, kept)
        if ".moe.experts." in n:
            assert kept == tuple(a for a in ("pod", "model") if a in named)
            continue
        leaf = n.rsplit(".", 1)[-1]
        tp = n in ("embed", "unembed") or ".mlp." in n or \
            ".moe.shared." in n or (
                ".attn." in n and leaf in ("wq", "wo") and split) or (
                ".attn." in n and leaf in ("wk", "wv")
            and split in ("heads", "positions")) \
            or (".attn." in n and mla and leaf in ("wq_a", "wq_b", "wkv_a",
                                                   "wkv_b", "wo")) \
            or (mixer and any(mod in n and leaf in names
                              for mod, names in _MIXER_TP.items()))
        assert kept == (("model",) if tp and "model" in named else ()), \
            (n, spec, kept)


@pytest.mark.parametrize("s,m", [(12, 2), (12, 4), (7, 2), (7, 4), (5, 4),
                                 (1, 2), (64, 2), (32768, 16), (4096, 16),
                                 (1000, 16)])
def test_position_blocks_cover_every_row_once(s, m):
    """``shardings.position_blocks``: rank ``r``'s blocks ``r`` and ``2m -
    1 - r`` of the ``2m`` cut at ``floor(i s / 2m)``; every row of ``s``
    falls to exactly one rank (none dropped where ``2m`` does not divide
    ``s``; ranks may hold none of a short sequence), and each rank attends
    for the same causal pairs where it does (within one block's rows
    elsewhere)."""
    blocks = shardings.position_blocks(s, m)
    assert len(blocks) == m
    rows = sorted(p for bl in blocks for a, e in bl for p in range(a, e))
    assert rows == list(range(s))
    pairs = [sum((e * (e + 1) - a * (a + 1)) // 2 for a, e in bl)
             for bl in blocks]
    if s % (2 * m) == 0:
        assert len(set(pairs)) == 1, pairs
    else:
        assert max(pairs) - min(pairs) <= 2 * (s // (2 * m) + 1) * s, pairs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_local_shapes(runs, case):
    """Each rank holds its spec's ``local_shape`` of every leaf (so ``h/m``
    q heads in ``wq``, ``f/m`` columns of each MLP, and in MLA ``h/m``
    heads in ``wq_b`` / ``wkv_b`` (columns) and ``wo`` (rows) and
    ``q_lora/m`` and ``(r + dr)/m`` columns of ``wq_a`` / ``wkv_a``), and
    its cache the kv heads of the stated layout: ``kvh/m`` where ``model``
    divides them, every kv head of its ``T / m`` rows under KV replication
    and where the layer splits by positions (the reference's
    ``cache_spec`` local shape); an MLA layer's ``latent`` and ``k_rope``
    their ``T / m`` rows (``k_rope``'s ``cache_spec`` local shape; the
    reference's spec splits the latent's ``r``, the same bytes); a Hymba
    layer's Mamba ``conv`` and ``ssm`` its ``di/m`` channels, the
    reference's ``cache_spec`` local shapes; an xLSTM layer's state
    whole."""
    from repro.launch.shardings import cache_spec as ref_cache_spec
    arch, shape = case
    cfg = tp_ranks.config(arch, get_config)
    mesh, m = _standin(shape), shape[-1]
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    whole = dict(lm.LM(cfg, device="meta").named_parameters())
    split = shardings.attention_split(cfg, mesh)
    for res in runs["ranks"]:
        for n, p in whole.items():
            spec = shardings.leaf_spec(n, p.shape, mesh, cfg)
            assert tuple(res[f"{key}|local|{n}"]) == shardings.local_shape(
                spec, p.shape, mesh), n
            if n.endswith(".mlp.w_up") or n.endswith(".moe.shared.w_up"):
                assert res[f"{key}|local|{n}"][-1] == p.shape[-1] // m, n
            if n.endswith(".attn.wq") and split:
                assert res[f"{key}|local|{n}"][-1] == \
                    cfg.n_heads * cfg.d_head // m
            if cfg.mla is not None and ".attn." in n:
                _assert_mla_local(cfg, m, n, res[f"{key}|local|{n}"])
            if cfg.family == "hybrid" and n.endswith(".mamba.conv"):
                assert res[f"{key}|local|{n}"][-1] == p.shape[-1] // m, n
        kvh = cfg.n_kv_heads // m if split == "heads" else cfg.n_kv_heads
        fresh = lm.init_cache(cfg, 1, 4, device="cpu")["layers"]
        for i in range(cfg.n_layers):
            got = {k.rsplit(f"|cache|{i}|", 1)[1]: v for k, v in res.items()
                   if k.startswith(f"{key}|cache|{i}|")}
            want = {k: list(t.shape) for k, t in tp_ranks._leaves(
                fresh[i]).items()}
            for k in ("k", "attn|k", "attn|v", "v"):
                if k in want:
                    want[k][2] = kvh
                    if split in ("positions", "replicate"):   # T by the
                        spec = tuple(ref_cache_spec(      # reference's spec
                            f"layers/{i}/k", (shape[0] * shape[1],
                                              *want[k][1:]), mesh, cfg))
                        assert spec[1] == "model", spec
                        want[k] = list(shardings.local_shape(
                            (None,) + spec[1:], want[k], mesh))
            for k in ("latent", "k_rope"):
                if k in want:                  # T by k_rope's spec
                    spec = tuple(ref_cache_spec(f"layers/{i}/k_rope", (
                        shape[0] * shape[1], want[k][1],
                        cfg.mla.rope_head_dim), mesh, cfg))
                    assert spec[1] == "model", spec
                    want[k][1] //= m
            for k in ("ssm|conv", "ssm|ssm"):
                if k in want:
                    want[k] = list(shardings.local_shape(tuple(ref_cache_spec(
                        f"layers/{i}/{k.replace('|', '/')}", tuple(want[k]),
                        mesh, cfg)), want[k], mesh))
            assert {k: v.tolist() for k, v in got.items()} == want, i
        assert f"{key}|cache|{cfg.n_layers}|" not in "".join(res)


def _assert_mla_local(cfg, m: int, name: str, local) -> None:
    """An MLA leaf's rank-local width over ``model``: ``h/m`` heads of
    ``dn + dr`` (``wq_b``), ``dn + dv`` (``wkv_b``) or ``dv`` rows
    (``wo``), ``q_lora/m`` (``wq_a``) and ``(r + dr)/m`` columns
    (``wkv_a``).  The norms are held by their specs and gathered whole
    before the layer runs."""
    a, h = cfg.mla, cfg.n_heads // m
    want = {"wq_a": (-1, a.q_lora_rank // m),
            "wq_b": (-1, h * (a.nope_head_dim + a.rope_head_dim)),
            "wkv_a": (-1, (a.kv_lora_rank + a.rope_head_dim) // m),
            "wkv_b": (-1, h * (a.nope_head_dim + a.v_head_dim)),
            "wo": (0, h * a.v_head_dim)}
    leaf = name.split(".attn.")[-1]
    if leaf in want:
        dim, width = want[leaf]
        assert local[dim] == width, (name, list(local), width)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_logits_match_reference(runs, case):
    """Each rank's logits of its rows, gathered whole over ``model``,
    within ``LAYER`` of the reference's unsharded forward; every rank of
    one ``(pod, data)`` group holds the same bits."""
    arch, shape = case
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    want = runs["ref"][f"{tp_ranks.ref_key(arch, shape)}|logits"]
    for r, res in enumerate(runs["ranks"]):
        got = res[f"{key}|logits"]
        np.testing.assert_array_equal(
            got, runs["ranks"][r - r % shape[-1]][f"{key}|logits"])
        np.testing.assert_allclose(got, want[_rows(r, shape)], **LAYER)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_serve_emits_the_reference_tokens(runs, case):
    """``serve(mesh=...)``: the reference's tokens on every rank, the last
    positions' logits (gathered over ``model`` before the argmax) within
    ``CACHED`` of the reference's rows."""
    arch, shape = case
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    rk = tp_ranks.ref_key(arch, shape)
    for r, res in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(res[f"{key}|tokens"],
                                      runs["ref"][f"{rk}|tokens"])
        np.testing.assert_allclose(
            res[f"{key}|serve_logits"],
            runs["ref"][f"{rk}|serve_logits"][:, _rows(r, shape)], **CACHED)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_and_gradients_match_reference(runs, case):
    """The global loss (the vocabulary-parallel cross-entropy's shares
    summed) to rtol ``F32_LOSS`` and every summed gradient, gathered whole,
    within ``F32_GRAD`` of the reference's ``jax.value_and_grad``; every
    rank alike."""
    arch, shape = case
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    rk = tp_ranks.ref_key(arch, shape)
    want = _ref_grads(runs, arch, shape)
    for res in runs["ranks"]:
        assert float(res[f"{key}|loss"]) == pytest.approx(
            float(runs["ref"][f"{rk}|loss"]), rel=F32_LOSS)
        got = _grads(res, key, want)
        for n, w in want.items():
            assert got[n].shape == w.shape, n
        assert _miss(got, want) <= 1.0, key


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] in tp_ranks.CHUNKED],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[0] in tp_ranks.CHUNKED])
def test_two_chunk_prefill_matches_reference(runs, case):
    """A prompt prefilled in two chunks (7, then 5) on one cache under the
    mesh: the KV-replication layers (Granite on both meshes, Qwen2.5-14B
    on ``(1, 2, 4)``) write every kv head of the rows that fall in the
    rank's block of ``T`` and read the blocks all-gathered in the second;
    DeepSeek-V2's second chunk runs the materialised form on the rank's
    heads over the cached latent's blocks all-gathered; Hymba's
    carries the rank's Mamba channels and its kv heads; xLSTM's the whole
    mLSTM and sLSTM states; the variants split by positions write each
    new row into the rank that holds it and read the cache's blocks
    all-gathered.  Every position's logits within ``CACHED`` of the
    reference's same two chunks."""
    arch, shape = case
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    want = runs["ref"][f"{tp_ranks.ref_key(arch, shape)}|chunked"]
    for r, res in enumerate(runs["ranks"]):
        np.testing.assert_allclose(res[f"{key}|chunked"],
                                   want[_rows(r, shape)], **CACHED)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] in tp_ranks.ODD_T],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[0] in tp_ranks.ODD_T])
def test_cache_whole_where_model_does_not_divide_t(runs, case):
    """A layer split by positions, under KV replication (Granite) or MLA's
    (DeepSeek-V2) over a cache of ``2 S + 1`` positions, which neither
    ``model`` 2 nor 4 divides: the rank holds all of ``T`` (as the
    reference's ``cache_spec`` keeps it whole there; under KV replication
    its one kv head) and decodes it whole.  Two chunks and three decode steps within ``CACHED`` of the
    same on a cache of ``2 S`` (``T`` split over ``model``, the blocks
    merged by their log-sum-exps), the chunks also of the reference's."""
    arch, shape = case
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    want = runs["ref"][f"{tp_ranks.ref_key(arch, shape)}|chunked"]
    for r, res in enumerate(runs["ranks"]):
        odd, even = res[f"{key}|odd_t"], res[f"{key}|even_t"]
        assert odd.shape == even.shape and odd.shape[1] == tp_ranks.S + 3
        np.testing.assert_allclose(odd, even, **CACHED)
        np.testing.assert_allclose(odd[:, :tp_ranks.S], want[_rows(r, shape)],
                                   **CACHED)


@pytest.mark.parametrize("fault", tp_ranks.FAULTS)
def test_planted_faults_miss(runs, fault):
    """Each fault misses its check by 10x where the unfaulted run meets
    it: the row-parallel sum skipped, the replicated kv head taken as
    ``r % n_kv_heads``, MLA's ``q_a_norm`` over the rank's columns, its
    ``wkv_b`` heads at the next rank's offset and its ``wo`` sum skipped,
    Hymba's ``w_in`` block taken as the rank's ``x`` and ``z`` and its
    ``w_bcdt`` and ``w_out`` sums skipped, the mLSTM output normed over
    the rank's columns and the sLSTM ``w_down`` sum skipped, RoPE on a
    rank's columns before the gather and a rank's query rows swapped with
    the next's (the forward's logits), the decode's blocks merged by a
    plain mean and each block given the layer's window, a KV-replication
    block written with the rank's own kv head in every head, MLA's blocks
    merged by a plain mean and rank ``r`` writing rank ``r + 1``'s rows
    (the served logits, within ``CACHED``), the gold logit taken from every rank (the
    loss) and the
    column-split leaves' gradients summed over ``model`` (the
    gradients)."""
    arch, shape = tp_ranks.FAULT_CASE[fault]
    rk = tp_ranks.ref_key(arch, shape)
    ref = runs["ref"]
    misses = []
    for r, res in enumerate(runs["ranks"]):
        if fault in tp_ranks.SERVE_FAULTS:
            misses.append(_logit_miss(
                res[f"{fault}|serve_logits"],
                ref[f"{rk}|serve_logits"][:, _rows(r, shape)], CACHED))
        elif fault in tp_ranks.LOGIT_FAULTS:
            misses.append(_logit_miss(res[f"{fault}|logits"],
                                      ref[f"{rk}|logits"][_rows(r, shape)]))
        elif fault == "gold_everywhere":
            want = float(ref[f"{rk}|loss"])
            misses.append(abs(float(res[f"{fault}|loss"]) - want)
                          / (F32_LOSS * abs(want)))
        else:
            want = _ref_grads(runs, arch, shape)
            misses.append(_miss(_grads(res, fault, want), want))
    assert max(misses) >= CONTROL_FACTOR, (fault, misses)


RESTORE_CASES = [(a, s) for a in tp_ranks.CKPT_ARCHS
                 for s in tp_ranks.RESTORE_MESHES]


@pytest.mark.parametrize("case", RESTORE_CASES, ids=[
    tp_ranks.mesh_name(s) if a == tp_ranks.CKPT_ARCHS[0]
    else f"{a}-{tp_ranks.mesh_name(s)}" for a, s in RESTORE_CASES])
def test_checkpoint_restores_onto_another_model_size(runs, case):
    """``train(mesh=...)`` on ``(2, 2, 2)`` saved at step 3 and restored
    onto ``shape``: each rank's parameters and moments are the checkpoint's
    blocks by their specs on ``shape`` bit for bit, and steps 3-5 resumed
    there give the uninterrupted run's losses (the first to
    ``F32_LOSS``).  Qwen2.5-14B, and DeepSeek-V2 with its MLA split over
    ``model`` 2, then 4, then 1."""
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    arch, shape = case
    cfg = get_config(arch, smoke=True)
    named = dict(lm.LM(cfg, device="cpu").named_parameters())
    target = {"params": named, "opt_state": {
        "m": named, "v": named, "step": torch.zeros((), dtype=torch.int32)}}
    saved, meta = restore_checkpoint(str(runs["tmp"] / f"tp_ckpt_{arch}"),
                                     3, target)
    assert meta["step"] == 3
    mesh = _standin(shape)
    name = f"{arch}|{tp_ranks.mesh_name(shape)}"
    for r, res in enumerate(runs["ranks"]):
        coord = _coord(r, shape)
        for n in named:
            spec = shardings.leaf_spec(n, named[n].shape, mesh, cfg)
            for key, tree in (("p", saved["params"]),
                              ("m", saved["opt_state"]["m"]),
                              ("v", saved["opt_state"]["v"])):
                want = tree[n].numpy()
                np.testing.assert_array_equal(
                    res[f"restored|{name}|{key}|{n}"],
                    want[_block(spec, want.shape, coord, mesh.shape)])
    full = runs["ranks"][0][f"{arch}|ckpt|loss"]
    for res in runs["ranks"]:
        got = res[f"resumed|{name}|loss"]
        assert len(got) == 3
        assert got[0] == pytest.approx(full[3], rel=F32_LOSS)
        np.testing.assert_allclose(got, full[3:], rtol=1e-4)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in tp_ranks.MLA],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[0] in tp_ranks.MLA])
def test_converted_cache_keeps_the_whole_latent(runs, case):
    """``convert.cache_from_reference(..., mesh=)`` of an MLA model: every
    rank's ``latent`` and ``k_rope`` of every layer are the reference
    cache's whole width (all of ``r`` and ``dr``) at the rows of its
    ``model`` block of ``T`` (8 positions: 4 a rank on model 2, 2 on 4),
    the bytes of the reference's own specs (which split ``r`` over
    ``model``); the blocks of one ``(pod, data)`` group's ``model`` ranks,
    in ``model`` order, are the reference's whole."""
    arch, shape = case
    cfg = get_config(arch, smoke=True)
    m = shape[-1]
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    for r, res in enumerate(runs["ranks"]):
        c = _coord(r, shape)["model"]
        for i in range(cfg.n_layers):
            for k in ("latent", "k_rope"):
                whole = runs["data"][f"cache-{arch}|block0|{k}"] if i == 0 \
                    else runs["data"][f"cache-{arch}|blocks|{k}"][i - 1]
                n = whole.shape[1] // m
                np.testing.assert_array_equal(
                    res[f"{key}|converted|{i}|{k}"],
                    whole[:, c * n:(c + 1) * n])
                if c == 0:
                    np.testing.assert_array_equal(np.concatenate(
                        [runs["ranks"][r + j][f"{key}|converted|{i}|{k}"]
                         for j in range(m)], axis=1), whole)


def _rank_kv(attn: dict, shape, c: int, kvh: int) -> dict:
    """The reference cache ``attn``'s ``k`` and ``v`` as ``model`` rank
    ``c`` of ``shape`` holds them: its ``model`` block of the kv heads
    where ``model`` divides them, else (KV replication) every kv head of
    its block of ``T``."""
    m = shape[-1]
    if kvh % m == 0:
        heads = slice(c * kvh // m, (c + 1) * kvh // m)
        return {k: attn[k][:, :, heads] for k in ("k", "v")}
    n = attn["k"].shape[1] // m
    return {k: attn[k][:, c * n:(c + 1) * n] for k in ("k", "v")}


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in tp_ranks.DENSE],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[0] in tp_ranks.DENSE])
def test_converted_cache_keeps_the_rank_heads(runs, case):
    """``convert.cache_from_reference(..., mesh=)``: each rank's ``k`` and
    ``v`` of every layer are the reference cache's kv heads of the stated
    layout: its ``model`` block of ``kvh / m`` heads, or under KV
    replication every kv head of its ``model`` block of ``T`` (8
    positions: 4 a rank on model 2, 2 on 4), as the reference's
    ``cache_spec`` splits ``T``."""
    arch, shape = case
    cfg = get_config(arch, smoke=True)
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    for r, res in enumerate(runs["ranks"]):
        c = _coord(r, shape)["model"]
        for i in range(cfg.n_layers):
            want = _rank_kv({k: runs["data"][f"cache-{arch}|blocks|{k}"][i]
                             for k in ("k", "v")}, shape, c, cfg.n_kv_heads)
            for k in ("k", "v"):
                np.testing.assert_array_equal(
                    res[f"{key}|converted|{i}|{k}"], want[k])


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in
                                  tp_ranks.HYBRID + tp_ranks.XLSTM],
                         ids=[i for c, i in zip(CASES, IDS) if c[0] in
                              tp_ranks.HYBRID + tp_ranks.XLSTM])
def test_converted_cache_keeps_the_rank_channels(runs, case):
    """``convert.cache_from_reference(..., mesh=)`` of a Hymba or xLSTM
    model: a Hymba layer's ``k`` and ``v`` are the reference cache's kv
    heads of the stated layout (the ``model`` block on ``(2, 2, 2)``,
    every kv head of the rank's block of ``T`` under KV replication on
    ``(1, 2, 4)``) and its ``conv`` and ``ssm`` the rank's ``model`` block
    of the ``di`` channels; an xLSTM layer's state is the reference's
    whole."""
    arch, shape = case
    cfg = get_config(arch, smoke=True)
    m = shape[-1]
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    layers = tp_ranks.unflat_tree(runs["data"], f"cache-{arch}")["layers"]
    for r, res in enumerate(runs["ranks"]):
        c = _coord(r, shape)["model"]
        for i, layer in enumerate(layers):
            got = {k.rsplit(f"|converted|{i}|", 1)[1]: v
                   for k, v in res.items()
                   if k.startswith(f"{key}|converted|{i}|")}
            if cfg.family == "ssm":
                want = {f"state|{k}": v for k, v in layer["state"].items()}
            else:
                n = cfg.d_model * cfg.ssm.expand // m
                ch = slice(c * n, (c + 1) * n)
                want = {f"attn|{k}": v for k, v in _rank_kv(
                    layer["attn"], shape, c, cfg.n_kv_heads).items()}
                want.update({"ssm|conv": layer["ssm"]["conv"][:, :, ch],
                             "ssm|ssm": layer["ssm"]["ssm"][:, ch]})
            assert set(got) == set(want), (i, sorted(got))
            for k, w in want.items():
                np.testing.assert_array_equal(got[k], w)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] in tp_ranks.POSITIONS],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[0] in tp_ranks.POSITIONS])
def test_converted_cache_keeps_the_rank_rows(runs, case):
    """``convert.cache_from_reference(..., mesh=)`` of a layer split by
    positions: each rank's ``k`` and ``v`` are the reference cache's every
    kv head at the rows of its ``model`` block of ``T`` (8 positions: 4 a
    rank on model 2, 2 on 4), as the reference's ``cache_spec`` splits
    ``T``; the Hymba variant's ``conv`` and ``ssm`` its ``model`` block of
    the ``di`` channels.  Back: the blocks of one ``(pod, data)`` group's
    ``model`` ranks, in ``model`` order, are the reference's whole ``k``
    and ``v``."""
    arch, shape = case
    cfg = tp_ranks.config(arch, get_config)
    m = shape[-1]
    key = f"{arch}|{tp_ranks.mesh_name(shape)}"
    layers = tp_ranks.unflat_tree(runs["data"], f"cache-{arch}")
    layers = layers["layers"] if "layers" in layers else [
        {k: v[i] for k, v in layers["blocks"].items()}
        for i in range(cfg.n_layers)]
    for r, res in enumerate(runs["ranks"]):
        c = _coord(r, shape)["model"]
        for i, layer in enumerate(layers):
            got = {k.rsplit(f"|converted|{i}|", 1)[1]: v
                   for k, v in res.items()
                   if k.startswith(f"{key}|converted|{i}|")}
            attn = layer.get("attn", layer)
            n = attn["k"].shape[1] // m
            want = {f"{'attn|' if 'attn' in layer else ''}{k}":
                    attn[k][:, c * n:(c + 1) * n] for k in ("k", "v")}
            if "ssm" in layer:
                di = cfg.d_model * cfg.ssm.expand // m
                want["ssm|conv"] = layer["ssm"]["conv"][:, :, c * di:
                                                        (c + 1) * di]
                want["ssm|ssm"] = layer["ssm"]["ssm"][:, c * di:(c + 1) * di]
            assert set(got) == set(want), (i, sorted(got))
            for k, w in want.items():
                np.testing.assert_array_equal(got[k], w)
    pre = "attn|" if cfg.family == "hybrid" else ""
    for first in range(0, len(runs["ranks"]), m):
        for i, layer in enumerate(layers):
            attn = layer.get("attn", layer)
            for k in ("k", "v"):
                np.testing.assert_array_equal(np.concatenate(
                    [runs["ranks"][first + j][f"{key}|converted|{i}|{pre}{k}"]
                     for j in range(m)], axis=1), attn[k])
