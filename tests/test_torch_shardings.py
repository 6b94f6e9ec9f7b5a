"""The port's sharding rules and placements, held against the JAX
package's leaf for leaf.

The reference's ``param_spec`` / ``batch_spec`` / ``cache_spec`` /
``opt_v_specs`` read only ``mesh.shape``, so both packages get a stand-in
whose ``shape`` is a dict; the reference's trees are ``jax.eval_shape`` of
its ``init_lm`` / ``init_cache`` at full width (no weights, no devices).
Every config at full width, on the meshes ``{data: 16, model: 16}``,
``{pod: 2, data: 16, model: 16}`` and ``(2, 2, 2)``, under both FSDP axis
settings.  The port keeps one leaf a layer where the reference stacks a
scanned group ``[L, ...]``: a per-layer leaf's spec must be the stacked
leaf's with the layer entry dropped, and the leaves whose dropped entry
names axes must be exactly ``lost_layer_splits``.  The port's ``LM`` built
on the meta device under a port mesh over a fake process group (rank 0 of
a world of the mesh's size) must hold each leaf's ``shard_shape`` of the
reference's spec; ``to_placements`` is checked on a ``(2, 2, 2)``
``DeviceMesh`` of that fake world against DTensor's own layout.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.launch import shardings as rsh
from repro.launch.shardings import _path_str as ref_path_str
from repro.models import lm as jlm

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.models import lm  # noqa: E402

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
FSDP = {"data": ("data",), "pod+data": ("pod", "data")}


def _standin(mesh: str):
    axes, shape = MESHES[mesh]
    return SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)


def _canon(e):
    """An entry as ``PartitionSpec`` keeps it: a tuple of one axis is that
    axis."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _norm(spec, ndim: int) -> tuple:
    """A spec with one entry a dimension (a ``PartitionSpec`` may stop
    short: its missing entries are None), entries canonical."""
    spec = tuple(_canon(e) for e in spec)
    return spec + (None,) * (ndim - len(spec))


def _canon_all(specs: dict) -> dict:
    return {n: tuple(_canon(e) for e in s) if isinstance(s, tuple)
            else {k: tuple(_canon(e) for e in v) for k, v in s.items()}
            for n, s in specs.items()}


@pytest.fixture
def fsdp(request):
    """Both packages' FSDP axes set to ``request.param``, restored after."""
    rsh.set_fsdp_axes(FSDP[request.param])
    shardings.set_fsdp_axes(FSDP[request.param])
    yield request.param
    rsh.set_fsdp_axes(("data",))
    shardings.set_fsdp_axes(("data",))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str) -> dict:
    """``{reference path: shape}`` of the full-width ``init_lm``."""
    cfg = ref_config(arch)
    sds = jax.eval_shape(lambda k: jlm.init_lm(k, cfg), jax.random.key(0))
    return {ref_path_str(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(sds)[0]}


def _tree(flat: dict) -> dict:
    """``{"a/b": v}`` -> ``{"a": {"b": v}}`` (a list index as a key)."""
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _ref_specs(arch: str, mesh: str) -> dict:
    """``{reference path: spec}`` of ``param_specs``."""
    shapes = _ref_params(arch)
    tree = _tree({k: jax.ShapeDtypeStruct(v, np.float32)
                  for k, v in shapes.items()})
    specs = rsh.param_specs(tree, _standin(mesh), ref_config(arch))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, rsh.P))[0]
    return {ref_path_str(p): _norm(s, len(shapes[ref_path_str(p)]))
            for p, s in flat}


@functools.lru_cache(maxsize=None)
def _port_whole(arch: str) -> dict:
    return {n: tuple(p.shape) for n, p in
            lm.LM(get_config(arch), device="meta").named_parameters()}


def _expected(arch: str, mesh: str) -> tuple[dict, dict]:
    """``({port name: the reference's spec, layer entry dropped}, {port
    name: the dropped entry, where it names axes})``, every reference
    path matched and every shape checked."""
    cfg, ref = get_config(arch), _ref_specs(arch, mesh)
    shapes = _ref_params(arch)
    want, lost, seen = {}, {}, set()
    for n, shape in _port_whole(arch).items():
        path, layers = shardings._path_str(n, cfg)
        seen.add(path)
        if layers:
            assert shapes[path] == (layers,) + shape, n
            want[n] = ref[path][1:]
            if ref[path][0] is not None:
                lost[n] = ref[path][0]
        else:
            assert shapes[path] == shape, n
            want[n] = ref[path]
    assert seen == set(shapes), sorted(set(shapes) - seen)
    return want, lost


@pytest.mark.parametrize("fsdp", list(FSDP), indirect=True)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_reference_stacked_specs(arch, mesh, fsdp):
    cfg = get_config(arch)
    want, lost = _expected(arch, mesh)
    got = shardings.param_specs(_port_whole(arch), _standin(mesh), cfg)
    assert _canon_all(got) == want
    assert {n: _canon(e) for n, e in shardings.lost_layer_splits(
        cfg, _standin(mesh)).items()} == lost
    for n in lost:                  # norms and biases: 1-D a layer
        assert len(_port_whole(arch)[n]) == 1, n


def test_lost_layer_splits_are_counted():
    """At full width the stacks split over layers where ``data`` (or
    ``pod x data``) divides the layer count: Qwen2.5-14B's 48 layers on
    16 data ranks lose ``ln1``, ``ln2`` and the three biases a layer;
    Qwen3-MoE's 94 divide by 2 only (the ``(2, 2, 2)`` mesh)."""
    cfg = get_config("qwen2.5-14b")
    lost = shardings.lost_layer_splits(cfg, _standin("16x16"))
    assert len(lost) == 5 * 48 and set(lost.values()) == {("data",)}
    assert shardings.lost_layer_splits(get_config("qwen3-moe-235b-a22b"),
                                       _standin("16x16")) == {}
    lost = shardings.lost_layer_splits(get_config("qwen3-moe-235b-a22b"),
                                       _standin("2x2x2"))
    assert len(lost) == 2 * 94
    # the reference's own example: blocks/ln1 [48, 5120] on (16, 16)
    ref = _ref_specs("qwen2.5-14b", "16x16")
    assert ref["blocks/ln1"] == ("data", "model")
    assert shardings.leaf_spec("blocks.0.ln1.weight", (5120,),
                               _standin("16x16"), cfg) == ("model",)


@pytest.fixture(scope="module")
def placed_shapes():
    """``{(arch, mesh): {name: local shape}}`` of the port's ``LM`` built
    on the meta device under a port mesh of each shape, rank 0 of a fake
    world of its size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    out = {}
    for mesh, (axes, shape) in MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        try:
            m = make_mesh(shape, axes, device_type="cpu")
            for arch in ARCHS:
                model = lm.LM(get_config(arch), device="meta", mesh=m)
                assert model.mesh_shape == dict(zip(axes, shape))
                out[(arch, mesh)] = {n: tuple(p.shape) for n, p in
                                     model.named_parameters()}
        finally:
            dist.destroy_process_group()
    return out


def _shard_shape(shape, spec, mesh) -> tuple:
    """``NamedSharding(mesh, spec).shard_shape(shape)``, each entry held
    by the reference's ``_fit``."""
    out = []
    for n, e in zip(shape, _norm(spec, len(shape))):
        assert rsh._fit(e, n, mesh) == e
        k = 1
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            k *= mesh.shape[a]
        out.append(n // k)
    return tuple(out)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_model_holds_the_reference_shard_shapes(placed_shapes, arch,
                                                     mesh):
    """Each leaf's local shape is the reference's ``shard_shape`` of its
    (stacked) leaf, without the layer axis."""
    cfg, ref = get_config(arch), _ref_specs(arch, mesh)
    shapes, m = _ref_params(arch), _standin(mesh)
    got = placed_shapes[(arch, mesh)]
    for n, whole in _port_whole(arch).items():
        path, layers = shardings._path_str(n, cfg)
        want = _shard_shape(shapes[path], ref[path], m)
        assert got[n] == (want[1:] if layers else want), n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [256, 32, 3, 1])
def test_batch_specs_are_the_reference(batch, mesh):
    tree = {"tokens": (batch, 64), "labels": (batch, 64),
            "embeds": (batch, 64, 8)}
    ref = rsh.batch_specs({k: jax.ShapeDtypeStruct(v, np.int32)
                           for k, v in tree.items()}, _standin(mesh))
    got = shardings.batch_specs(tree, _standin(mesh))
    assert _canon_all(got) == {k: _norm(ref[k], len(v))
                               for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _ref_cache(arch: str, batch: int, length: int) -> dict:
    cfg = ref_config(arch)
    sds = jax.eval_shape(lambda: jlm.init_cache(cfg, batch, length))
    return sds


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_are_the_reference(arch, mesh):
    """Every cache leaf of every layer, a decode batch of 128 x 32,768 and
    the long-context batch of 1 x 524,288: the reference's spec, a stacked
    cache's without its layer entry."""
    cfg, m = get_config(arch), _standin(mesh)
    for batch, length in ((128, 32768), (1, 524288)):
        ref = _ref_cache(arch, batch, length)
        rspecs = rsh.cache_specs(ref, m, ref_config(arch))
        flat = {ref_path_str(p): (_norm(s, len(leaf.shape)), leaf.shape)
                for (p, s), (_, leaf) in zip(
                    jax.tree_util.tree_flatten_with_path(
                        rspecs, is_leaf=lambda x: isinstance(x, rsh.P))[0],
                    jax.tree_util.tree_flatten_with_path(ref)[0])}
        cache = lm.init_cache(cfg, batch, length, device="meta")
        got = shardings.cache_specs(cache, m, cfg)
        assert got["pos"] == () and flat["pos"][0] == ()
        start = shardings._first_stacked(cfg)
        for i, layer in enumerate(got["layers"]):
            for sub, spec in _flatten(layer):
                t = _leaf(cache["layers"][i], sub)
                if not isinstance(t, torch.Tensor):      # len: an int
                    assert spec == ()
                    continue
                if not shardings._uniform_scan(cfg):
                    want, shape = flat[f"layers/{i}/{sub}"]
                elif i < start:
                    want, shape = flat[f"block0/{sub}"]
                else:
                    want, shape = flat[f"blocks/{sub}"]
                    want, shape = want[1:], shape[1:]
                assert tuple(t.shape) == tuple(shape), (i, sub)
                assert _norm(spec, len(shape)) == want, (i, sub)


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _leaf(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_v_specs_are_the_reference(arch, factored):
    """On ``(16, 16)``: the second moment's specs, plain and factored
    (``{"r", "c"}``), the stacked leaf's without the layer entry; a
    stacked 1-D leaf the reference factors across its layers has no
    per-layer factors (the port's moment stays whole: ``convert`` raises
    for it)."""
    cfg, mesh = get_config(arch), "16x16"
    shapes = _ref_params(arch)
    tree = _tree({k: jax.ShapeDtypeStruct(v, np.float32)
                  for k, v in shapes.items()})
    rspecs = rsh.param_specs(tree, _standin(mesh), ref_config(arch))
    rv = rsh.opt_v_specs(rspecs, tree, factored)
    flat = dict((ref_path_str(p), s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    rv, is_leaf=lambda x: isinstance(x, (rsh.P, dict))
                    and not (isinstance(x, dict) and set(x) - {"r", "c"}))[0])
    whole = _port_whole(arch)
    specs = shardings.param_specs(whole, _standin(mesh), cfg)
    got = _canon_all(shardings.opt_v_specs(specs, whole, factored))
    specs = _canon_all(specs)
    for n, shape in whole.items():
        path, layers = shardings._path_str(n, cfg)
        ref = flat[path]
        full = shapes[path]
        if isinstance(ref, dict):
            r = _norm(ref["r"], len(full) - 1)
            c = _norm(ref["c"], len(full) - 1)
            if layers and len(shape) == 1:          # the stacked 1-D case
                assert got[n] == specs[n], n
                continue
            if layers:
                r, c = r[1:], c[1:]
            assert got[n] == {"r": r, "c": c}, n
        else:
            want = _norm(ref, len(full))
            assert got[n] == (want[1:] if layers else want), n


@pytest.fixture
def fake_world():
    """A fake process group of 8 ranks (``rank`` set by the test) and the
    port mesh ``(2, 2, 2)`` over it; destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    def make(rank: int):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        return make_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


PLACEMENT_SPECS = [
    (("data", "model"), ("R", 0, 1)),
    (("model", ("data",)), ("R", 1, 0)),
    ((("pod", "model"), None, "data"), (0, 2, 0)),
    ((None, ("pod", "data")), (1, 1, "R")),
    ((("pod", "data", "model"),), (0, 0, 0)),
    ((None, None), ("R", "R", "R")),
]


@pytest.mark.parametrize("rank", [0, 5, 6])
@pytest.mark.parametrize("spec,want", PLACEMENT_SPECS,
                         ids=[str(s) for s, _ in PLACEMENT_SPECS])
def test_to_placements_on_a_device_mesh(fake_world, rank, spec, want):
    """``Shard(d)`` for an axis that splits dimension ``d``, ``Replicate``
    otherwise; DTensor's own layout of those placements (the global
    offset of this rank's block) is the port's ``shard_slices``, the
    first axis of a tuple the major one."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = fake_world(rank)
    got = shardings.to_placements(spec, mesh)
    assert got == tuple(Replicate() if w == "R" else Shard(w) for w in want)
    shape = (8, 16, 4)[:len(spec)]
    local, offset = compute_local_shape_and_global_offset(
        shape, mesh.device_mesh, got)
    sl = shardings.shard_slices(spec, shape, mesh)
    assert tuple(local) == tuple(s.stop - s.start for s in sl)
    assert tuple(offset) == tuple(s.start for s in sl)
    view = shardings.global_view(torch.empty(local, device="meta"), spec,
                                 mesh)
    assert tuple(view.shape) == shape and view.placements == got


@pytest.mark.parametrize("spec", [(("model", "pod"),), (("data", "pod"),
                                                         None),
                                  ("data", "data"), ("nope",)])
def test_to_placements_refuses_what_it_cannot_state(fake_world, spec):
    """A tuple out of mesh order is not reordered, an axis twice or one
    the mesh lacks raises."""
    mesh = fake_world(0)
    with pytest.raises((ValueError, KeyError)):
        shardings.to_placements(spec, mesh)


def test_gather_over_axes_of_size_one_is_the_leaf_itself():
    """On a one-rank mesh every spec's gather is empty: the leaf itself,
    no copy and no collective; ``shard`` keeps the whole tensor."""
    from repro_torch.core import meshops
    m = SimpleNamespace(shape={"data": 1, "model": 1},
                        axis_names=("data", "model"),
                        index=lambda axes: 0)
    x = torch.randn(4, 6).t()
    spec = shardings.leaf_spec("unembed", x.shape, m,
                               get_config("qwen2.5-14b", smoke=True))
    assert spec == (("data",), "model")
    assert shardings.gather_spec(spec, m) == (None, None)
    meshops.reset_counts()
    assert shardings.gather(x, shardings.gather_spec(spec, m), m) is x
    assert shardings.shard(x, spec, m) is x
    assert sum(meshops.COUNTS.values()) == 0


def test_shard_keeps_the_leaf_memory_order():
    """A transposed leaf's shard is transposed too (``unembed``), so the
    gathered leaf and the moments keep the whole leaf's layout."""
    m = SimpleNamespace(shape={"data": 2, "model": 2},
                        axis_names=("data", "model"),
                        index=lambda axes: 1)
    x = torch.arange(48.0).reshape(6, 8).t()          # [8, 6], transposed
    got = shardings.shard(x, (("data",), "model"), m)
    assert torch.equal(got, x[4:, 3:])
    assert got.stride(0) < got.stride(1)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_stand_ins_of_the_pipeline(fake_world, mesh):
    """``data.batch_specs``: the reference's stand-ins' shapes, dtypes
    (bfloat16 embeddings) and shard shapes, on the ``(2, 2, 2)`` world;
    the leading dimension's spec on each mesh."""
    from repro_torch.data import DataConfig, batch_specs
    m = fake_world(0)
    for modality in ("text", "vlm"):
        cfg = DataConfig(vocab=64, seq_len=16, global_batch=8,
                         modality=modality, d_model=32)
        got = batch_specs(cfg, m)
        assert set(got) == ({"labels", "tokens"} if modality == "text"
                            else {"labels", "embeds"})
        for k, t in got.items():
            want = (8, 16) if k != "embeds" else (8, 16, 32)
            assert tuple(t.shape) == want
            assert tuple(t.to_local().shape) == (2,) + want[1:]
            assert t.dtype == (torch.bfloat16 if k == "embeds"
                               else torch.int32)
    got = shardings.batch_specs({"x": (8, 3)}, _standin(mesh))
    want = rsh.batch_spec((8, 3), _standin(mesh))
    assert _norm(got["x"], 2) == _norm(want, 2)


def _block(spec, shape, coord: dict, sizes: dict) -> tuple:
    """The block of a leaf of ``shape`` at mesh coordinate ``coord``: on
    each dimension the block of the index over its axes, the first major."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        k, i = 1, 0
        for a in axes:
            k, i = k * sizes[a], i * sizes[a] + coord[a]
        out.append(slice(i * n // k, (i + 1) * n // k))
    return tuple(out)


@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen2.5-14b"])
def test_conversion_keeps_the_rank_shards(fake_world, arch):
    """``lm_params_from_reference`` and ``opt_state_from_reference(...,
    mesh=)`` on rank 5 of a fake ``(2, 2, 2)`` world (pod 1, data 0,
    model 1): every parameter and moment the block of the reference's
    array by its spec, a factored moment's ``r`` and ``c`` by theirs
    (xLSTM's per-layer leaves are the reference's own, so every 2-D leaf
    factors)."""
    from repro.optim import init_opt_state as ref_init_opt_state

    from repro_torch.models.convert import (lm_params_from_reference,
                                            opt_state_from_reference)
    mesh = fake_world(5)
    coord, sizes = {"pod": 1, "data": 0, "model": 1}, dict(mesh.shape)
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.eval_shape(lambda k: jlm.init_lm(k, ref_config(arch, smoke=True)),
                       jax.random.key(0)))
    factored = arch == "xlstm-350m"
    opt = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), jax.eval_shape(lambda p: ref_init_opt_state(
            p, factored_v=factored), params))
    model = lm_params_from_reference(cfg, params, device="cpu", mesh=mesh)
    state = opt_state_from_reference(model, opt, mesh=mesh)
    whole = _port_whole_smoke(arch)
    vspecs = shardings.opt_v_specs(model.specs, whole, factored)
    ref_p = lm_params_from_reference(cfg, params, device="cpu")
    ref_s = opt_state_from_reference(ref_p, opt)
    seen = 0
    for n, p in model.named_parameters():
        spec = model.specs[n]
        w = dict(ref_p.named_parameters())[n].detach().numpy()
        assert np.array_equal(p.detach().numpy(),
                              w[_block(spec, w.shape, coord, sizes)]), n
        for k in ("m", "v"):
            got, want = state[k][n], ref_s[k][n]
            if isinstance(want, dict):
                seen += 1
                for f in ("r", "c"):
                    a = want[f].numpy()
                    assert np.array_equal(got[f].numpy(), a[_block(
                        vspecs[n][f], a.shape, coord, sizes)]), (n, f)
            else:
                a = want.numpy()
                assert np.array_equal(got.numpy(), a[_block(
                    spec, a.shape, coord, sizes)]), (n, k)
    assert (seen > 0) == factored


@functools.lru_cache(maxsize=None)
def _port_whole_smoke(arch: str) -> dict:
    return {n: tuple(p.shape) for n, p in lm.LM(
        get_config(arch, smoke=True), device="meta").named_parameters()}
