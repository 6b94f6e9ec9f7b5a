"""The port's dry run: the per-op counter, the LM kernels' meta branch and
work formulas, the roofline, ``perf`` and ``report``, and each SMOKE
family's per-rank FLOPs against the JAX package's dry run.

The reference side (``repro.launch.steps.build_cell`` lowered and compiled
over 8 forced host devices, ``hlo_analysis.analyze_hlo``) runs in one
subprocess started with the module, the pattern of ``mesh_ranks.py``; the
port's cells run on meta stand-ins on rank 0 of a fake world.  Both on the
``(2, 4, 1)`` ``("pod", "data", "model")`` mesh, whose ``model`` axis is 1,
and on ``(2, 2, 2)``, where the dense, MoE and MLA families split their
dense work over ``model`` as XLA does (Hymba's mixer and the xLSTM mixers
run whole on each ``model`` rank: their ratios are printed, not held), at
a sequence of 64 and a batch of 8, the port on
its plain route (``use_kernel=False``: the route the reference's dry run
lowers, ``use_pallas=False``).  The port's MoE blocks pad each expert's
rows to the grouped matmul's tile (``moe.buffer_layout``) where the
reference's einsum takes the capacity: those rows' FLOPs are worked out
from the shapes and taken off before the comparison.  So are the sLSTM
weight gradients, which the port runs as matmuls and the reference's
compiled scan as elementwise products, which ``analyze_hlo`` does not count.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.gmm import gmm  # noqa: E402
from repro_torch.kernels.slstm import slstm_scan  # noqa: E402
from repro_torch.launch import dryrun, perf, report, roofline  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.op_analysis import OpCounter  # noqa: E402
from repro_torch.launch.steps import Recipe, build_cell  # noqa: E402
from repro_torch.models import blocked_attention as blocked  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
AXES = ("pod", "data", "model")
MESH = (2, 4, 1)
# model 2: every family splits its dense work over model as the reference's
# XLA does, but the xLSTM cores, which each model rank repeats whole (taken
# off by _xlstm_repeated_flops)
TP_MESH = (2, 2, 2)
TP_HELD = ("dense", "moe", "mla", "hybrid", "ssm", "mqa")
SEQ, BATCH = 64, 8
# "mqa": Granite-34B's one kv head, replicated over model (KV replication,
# its cache every kv head of a rank's block of T)
FAMILIES = {"dense": "qwen2.5-14b", "moe": "qwen3-moe-235b-a22b",
            "mla": "deepseek-v2-236b", "hybrid": "hymba-1.5b",
            "ssm": "xlstm-350m",
            "mqa": "granite-34b"}
KINDS = ("train", "prefill", "decode")
FLOP_TOL = 0.02
# SMOKE variants whose GQA attention splits over model by positions (the
# heads do not divide model 2, or the kv heads neither divide it nor are
# divided by it): tp_ranks.VARIANTS's, counted on TP_MESH in both packages
POSITION_VARIANTS = {
    "qwen2.5-14b-h5kv1": ("qwen2.5-14b", {"n_heads": 5, "n_kv_heads": 1}),
    "hymba-1.5b-h6kv3": ("hymba-1.5b", {"n_heads": 6, "n_kv_heads": 3})}

_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from repro.launch import steps
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_cell
    from repro.models.config import ShapeConfig
    base_config, base_recipe = steps.get_config, steps.recipe_for
    steps.get_config = lambda name, smoke=False: dataclasses.replace(
        base_config(VARIANTS.get(name, (name,))[0], smoke=smoke),
        **VARIANTS.get(name, (name, {}))[1])
    steps.recipe_for = lambda name, shape: base_recipe(
        VARIANTS.get(name, (name,))[0], shape)
    out_path, archs = sys.argv[1], sys.argv[2:]
    mesh = make_mesh(tuple(MESH), AXES)
    out = {}
    for arch in archs:
        for kind in ("train", "prefill", "decode"):
            cell = build_cell(arch, ShapeConfig(kind + "_s", SEQ, BATCH, kind),
                              mesh, smoke=True)
            with mesh:
                compiled = cell.lower().compile()
            out[arch + "|" + kind] = analyze_hlo(compiled.as_text(),
                                                 pod_size=8).flops
            with open(out_path, "w") as f:
                json.dump(out, f)
""")


@pytest.fixture(scope="module", autouse=True)
def reference_flops(tmp_path_factory):
    """The reference's per-chip FLOPs of every family's SMOKE cells on
    ``MESH`` and on ``TP_MESH`` (there also :data:`POSITION_VARIANTS`'s),
    from one subprocess a mesh started before
    the file's first test (the tests that read them wait for them):
    ``result(mesh)``."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = {}
    for mesh in (MESH, TP_MESH):
        out = tmp / f"flops_{'x'.join(map(str, mesh))}.json"
        script = f"MESH, AXES, SEQ, BATCH = {mesh}, {AXES}, {SEQ}, " \
            f"{BATCH}\nVARIANTS = {POSITION_VARIANTS!r}\n" + _REF_SCRIPT
        archs = list(FAMILIES.values()) + (
            list(POSITION_VARIANTS) if mesh == TP_MESH else [])
        procs[mesh] = out, subprocess.Popen(
            [sys.executable, "-c", script, str(out), *archs],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    def result(mesh=MESH) -> dict:
        out, proc = procs[mesh]
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        return json.loads(out.read_text())
    yield result
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture()
def fake8():
    with dryrun.fake_world(8):
        yield make_mesh(MESH, AXES, device_type="meta")


# ---------------------------------------------------------------------------
# the counter (tests/test_substrate.py's cases of the reference's analyzer)
# ---------------------------------------------------------------------------

def test_counter_scales_loops():
    w, c = torch.zeros(32, 32), torch.zeros(4, 32)
    with OpCounter() as counts:
        for _ in range(9):
            c = torch.tanh(c @ w)
    assert counts.flops == 2 * 4 * 32 * 32 * 9


def test_counter_dot_flops_batched():
    a, b = torch.zeros(3, 8, 16), torch.zeros(3, 16, 4)
    with OpCounter() as counts:
        torch.einsum("bij,bjk->bik", a, b)
    assert counts.flops == 2 * 3 * 8 * 4 * 16


def test_counter_bytes_of_elementwise_ops_and_views():
    """An elementwise op counts its inputs and its output; views and
    ``empty`` count nothing; a copy into a slice its source and the
    slice."""
    a, b = torch.zeros(10, 10), torch.zeros(10, 10)
    with OpCounter() as counts:
        a.view(100), a.t(), a[:5], a.reshape(5, 20), a.detach()
        torch.empty(1000)
    assert counts.hbm_bytes == 0
    with OpCounter() as counts:
        a + b
    assert counts.hbm_bytes == 3 * 400 and counts.flops == 0
    with OpCounter() as counts:
        a[:5] = b[5:]
    assert counts.hbm_bytes == 2 * 200


def test_counter_collectives_by_ring_factor_ici_and_dcn():
    """An all-gather and an all-to-all on groups of a fake world of 16:
    the ring factors' wire bytes, a group inside one 8-rank NVLink domain
    as ICI and one across two as DCN; a group of one rank moves nothing."""
    with dryrun.fake_world(16):
        inside = dist.new_group(list(range(8)))
        across = dist.new_group([0, 8])
        alone = dist.new_group([0])
        x = torch.empty(64, device="meta")
        with OpCounter(boundary=8) as counts:
            dist.all_gather_into_tensor(torch.empty(8 * 64, device="meta"),
                                        x, group=inside)
            dist.all_to_all_single(torch.empty(64, device="meta"), x,
                                   group=across)
            dist.all_reduce(x, group=alone)
        assert counts.ici_bytes == 8 * 64 * 4 * 7 / 8
        assert counts.dcn_bytes == 64 * 4 * 1 / 2
        assert counts.collective_count == 2
        assert counts.by_op == {("all-gather", "ici"): 8 * 64 * 4 * 7 / 8,
                                ("all-to-all", "dcn"): 64 * 4 / 2}


def test_counter_refuses_a_collective_without_a_ring_factor():
    """A ``c10d`` operation the counter has no ring factor for raises
    (here the list all-to-all), where counting it as nothing would drop it
    from the collective term; a barrier moves nothing.  The ICI/DCN line
    is the roofline's NVLink domain unless one is given."""
    assert OpCounter().boundary == roofline.NVLINK_DOMAIN
    with dryrun.fake_world(16):
        x = [torch.empty(4, device="meta") for _ in range(16)]
        with OpCounter() as counts:
            dist.barrier()
            with pytest.raises(NotImplementedError, match="alltoall_"):
                dist.all_to_all([torch.empty_like(t) for t in x], x)
        assert counts.collective_count == 0 and counts.by_op == {}


def test_counter_tracks_peak_memory():
    """Argument bytes from the arguments' storages, the step's peak live
    bytes from the storages its operations make, freed ones dropped."""
    x = torch.zeros(1000)                      # 4,000 bytes
    with OpCounter(args=(x,)) as counts:
        y = x * 2                              # +4,000
        z = y + 1                              # +4,000: 8,000 live
        del y                                  # 4,000
        w = z * 3                              # 8,000 live again
        del z, w
    assert counts.argument_bytes == 4000
    assert counts.peak_bytes == 8000 and counts.live_bytes == 0


# ---------------------------------------------------------------------------
# the LM kernels' meta branch and work formulas
# ---------------------------------------------------------------------------

def _bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / roofline.HBM_BW, flops / roofline.PEAK_FLOPS) * 1e3


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["flash", "decode", "gmm decode",
                                  "gmm prefill", "slstm"])
def test_kernel_meta_branch_and_bound(case):
    """Each wrapper on meta tensors at the shapes of PERF.md's kernel
    table: an empty meta result of the kernel's shape and dtype, no
    launch counted, and the work reported to the counter, whose bound
    (bytes at 3.35 TB/s or operations at 989 TFLOP/s) is the table's."""
    before = {k.__name__: k.launches for k in (flash_attention,
                                               decode_attention, gmm,
                                               slstm_scan)}
    with OpCounter() as counts:
        if case == "flash":
            out = flash_attention(_meta(160, 1024, 128), _meta(32, 1024, 128),
                                  _meta(32, 1024, 128))
            want, bound = ((160, 1024, 128), torch.bfloat16), 0.0435
            work_ = work.flash_work(160, 1024, 32, 1024, 128, 2, 2, True)
        elif case == "decode":
            k = _meta(4, 2048, 8, 128)
            out = decode_attention(_meta(4, 40, 128), k, k, 1056)
            want, bound = ((4, 40, 128), torch.bfloat16), 0.00519
            work_ = work.decode_work(4, 40, 8, 128, 1056, 2, 2)
        elif case.startswith("gmm"):
            n, bn = (2048, 16) if case == "gmm decode" else (49152, 128)
            out = gmm(_meta(n, 4096), _meta(128, 4096, 1536),
                      _meta(n // bn, dtype=torch.int32), block_n=bn,
                      group_tiles=n // bn // 128)
            want = ((n, 1536), torch.bfloat16)
            bound = 0.488 if case == "gmm decode" else 0.646
            work_ = work.gmm_work(n, 4096, 1536, 128, 2, 2)
        else:
            st = {k: _meta(4, 1024, dtype=torch.float32)
                  for k in kref.SLSTM_STATE}
            out, new = slstm_scan(_meta(4, 4096, 4096), _meta(1024, 4096),
                                  _meta(4096), st)
            assert all(t.shape == (4, 1024) and t.dtype == torch.float32
                       for t in new.values())
            want, bound = ((4, 4096, 1024), torch.float32), 0.139
            work_ = work.slstm_work(4, 4096, 1024, 2)
    assert (tuple(out.shape), out.dtype) == want and out.is_meta
    assert (counts.hbm_bytes, counts.flops) == work_
    assert len(counts.kernel_calls) == 1
    assert float(f"{_bound_ms(*work_):.3g}") == bound
    assert {k.__name__: k.launches for k in (
        flash_attention, decode_attention, gmm, slstm_scan)} == before


def test_kernel_meta_branch_validates():
    """A meta call is checked as a card call is: a head width the flash
    kernel was not built for, a non-contiguous decode cache and a bad
    gmm dtype raise; ``valid_len`` out of range too."""
    with pytest.raises(ValueError, match="head width"):
        flash_attention(_meta(4, 8, 48), _meta(4, 8, 48), _meta(4, 8, 48))
    k = _meta(2, 16, 2, 64).transpose(1, 2)
    with pytest.raises(ValueError):
        decode_attention(_meta(2, 4, 64), k, k, 4)
    with pytest.raises(TypeError):
        gmm(_meta(32, 16), _meta(2, 16, 16, dtype=torch.float16),
            _meta(2, dtype=torch.int32), block_n=16)
    with pytest.raises(ValueError, match="valid_len"):
        decode_attention(_meta(2, 4, 64), _meta(2, 16, 2, 64),
                         _meta(2, 16, 2, 64), 17)


def test_cpu_tensor_takes_the_plain_version_and_is_counted():
    """On a CPU tensor a wrapper runs its plain version: the counter sees
    the plain version's own operations and no kernel report."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((4, 8, 16), (2, 8, 16), (2, 8, 16)))
    with OpCounter() as counts:
        got = flash_attention(q, k, v)
    assert counts.kernel_calls == {}
    assert counts.flops == 2 * (2 * 4 * 8 * 8 * 16)      # QK^T and PV
    torch.testing.assert_close(got, kref.flash_attention_ref(q, k, v))


def test_meta_ids_take_the_capacity_layout():
    """``gmm_ref`` on meta ids runs one matmul a run of the layout its
    caller states (``group_tiles`` tiles a group, the MoE block's
    capacity layout); meta ids without a layout, or with one that does
    not match their count, raise, in ``gmm_ref`` and in the ``gmm``
    wrapper; the ordered fold on meta gives its shape."""
    x, w = _meta(64, 16, dtype=torch.float32), \
        _meta(2, 16, 8, dtype=torch.float32)
    with OpCounter() as counts:
        out = kref.gmm_ref(x, w, _meta(4, dtype=torch.int32), block_n=16,
                           group_tiles=2)
    assert out.shape == (64, 8) and out.is_meta
    assert counts.flops == 2 * 64 * 16 * 8
    assert counts.ops[("aten.mm", ((32, 16), (16, 8)), False)].calls == 2
    for tiles in (None, 1):
        with pytest.raises(ValueError, match="hold no values"):
            kref.gmm_ref(x, w, _meta(4, dtype=torch.int32), block_n=16,
                         group_tiles=tiles)
        with pytest.raises(ValueError, match="hold no values"):
            gmm(x, w, _meta(4, dtype=torch.int32), block_n=16,
                group_tiles=tiles)
    vals = _meta(10, 3, dtype=torch.float64)
    out = kref.segmented_fold_ref("sum", _meta(10, dtype=torch.bool), vals)
    assert out.shape == vals.shape and out.is_meta


# ---------------------------------------------------------------------------
# the repairs the cells need
# ---------------------------------------------------------------------------

def test_meta_mesh_and_meshops(fake8):
    """A meta mesh on a fake world: ``meshops`` takes meta tensors on it
    and gives the shapes a rank would get; a CPU tensor on it raises."""
    from repro_torch.core import meshops
    x = torch.empty(3, 5, device="meta")
    assert meshops.all_gather(x, fake8, "data").shape == (12, 5)
    assert meshops.all_to_all_axis(torch.empty(4, 2, device="meta"), fake8,
                                   "data").shape == (4, 2)
    assert meshops.psum(x, fake8, AXES).shape == (3, 5)
    with pytest.raises(ValueError, match="cpu tensor on a meta mesh"):
        meshops.psum(torch.zeros(3), fake8, "data")


def test_meta_mesh_refuses_a_real_world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="fake world"):
            make_mesh((1, 1), ("data", "model"), device_type="meta")
        with pytest.raises(RuntimeError, match="fake world"):
            with dryrun.fake_world(8):
                pass
    finally:
        dist.destroy_process_group()


def test_train_cell_leaves_require_grad_and_run(fake8):
    """A train cell's meta ``LM`` requires grad, and its step runs on the
    stand-ins' local tensors (the batch's rows of this rank, the moments
    laid out as their parameters)."""
    cell = build_cell("qwen2.5-14b", ShapeConfig("t", SEQ, BATCH, "train"),
                      fake8, smoke=True)
    assert all(p.requires_grad for p in cell.args[0].parameters())
    model, opt, batch = dryrun.local_args(cell)
    assert batch["tokens"].shape == (BATCH // 8, SEQ)
    assert opt["m"]["unembed"].stride() == model.unembed.stride()
    _, _, metrics = cell.fn(model, opt, batch)
    assert metrics["loss"].is_meta


def test_decode_cell_cache_in_the_port_layout(fake8):
    """A decode cell's cache: the batch split over ``("pod", "data")``
    only, filled to ``seq_len - 1`` positions."""
    cell = build_cell("qwen2.5-14b", ShapeConfig("d", SEQ, BATCH, "decode"),
                      fake8, smoke=True)
    _, cache, batch = dryrun.local_args(cell)
    cfg = cell.cfg
    layer = cache["layers"][0]
    assert layer["k"].shape == (1, SEQ, cfg.n_kv_heads, cfg.d_head)
    assert layer["len"] == SEQ - 1 and cache["pos"] == SEQ - 1


def test_one_rank_mesh_counts_the_mesh_free_dense_step():
    """A dense prefill and decode step on a one-rank meta mesh count the
    same ops as the mesh-free step (no gather, no collective): the card's
    mesh-free serving steps are held to the dry run's one-rank cells."""
    cfg = get_config("qwen2.5-14b", smoke=True)
    shape = ShapeConfig("p", SEQ, 2, "prefill")
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="meta")
        tables = []
        for m in (mesh, None):
            model = lm.LM(cfg, device="meta", mesh=m)
            toks = torch.empty((2, SEQ), dtype=torch.int32, device="meta")
            from repro_torch.launch.steps import make_prefill_step
            with OpCounter() as counts:
                make_prefill_step(cfg, shape, mesh=m)(model, {"tokens": toks})
            tables.append({k: (v.calls, v.flops, v.nbytes)
                           for k, v in counts.ops.items()})
    assert tables[0] == tables[1]


@pytest.mark.parametrize("arch,kind", [
    ("qwen2.5-14b", "prefill"), ("qwen2.5-14b", "decode"),
    ("qwen3-moe-235b-a22b", "prefill"), ("deepseek-v2-236b", "prefill"),
    ("qwen2.5-14b", "train")])
def test_meta_counts_equal_real_counts(tmp_path, arch, kind):
    """A SMOKE step counted on meta stand-ins on a one-rank meta mesh and
    on CPU tensors of real values on a one-rank gloo mesh, both on the
    plain route: the same ops, calls, FLOPs and bytes (the premise of
    ``chip_smoke.py``'s check on the card: nothing the step counts hangs
    on the data).  The train step as the card's: two microbatches, each
    block rematerialised."""
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig, init_opt_state
    shape = ShapeConfig(kind, 32, 4, kind)
    recipe = Recipe(n_micro=2, remat=True) if kind == "train" else None

    def table(counts):
        return {k: (v.calls, v.flops, v.nbytes)
                for k, v in counts.ops.items()}
    with dryrun.fake_world(1):
        mesh = elastic_mesh(1, model_parallel=1, device_type="meta")
        cell = build_cell(arch, shape, mesh, smoke=True, recipe=recipe,
                          use_kernel=False)
        meta = table(dryrun.count_cell(cell, dryrun.local_args(
            cell, cache_len=20)))
    cfg = cell.cfg
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32),
                                         dtype=np.int32))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        mesh = elastic_mesh(1, model_parallel=1, device_type="cpu")
        model = lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh)
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        if kind == "prefill":
            fn = make_prefill_step(cfg, shape, mesh=mesh, use_kernel=False)
            args = (model, batch)
        elif kind == "decode":
            cache = lm.init_cache(cfg, 4, 32, device="cpu")
            with torch.no_grad():
                lm.forward(model, tokens=toks[:, :20], cache=cache,
                           use_kernel=False, mesh=mesh)
            fn = make_serve_step(cfg, mesh=mesh, use_kernel=False)
            args = (model, cache, {"tokens": toks[:, 20:21].contiguous()})
        else:
            model.requires_grad_(True)
            params = dict(model.named_parameters())
            fn = make_train_step(cfg, AdamWConfig(lr=recipe.lr), recipe,
                                 mesh=mesh)
            args = (model, init_opt_state(params), batch)
        with OpCounter(args=args) as counts:
            fn(*args)
    finally:
        dist.destroy_process_group()
    real = table(counts)
    assert set(real) == set(meta), sorted(set(real) ^ set(meta))[:6]
    assert real == meta


# ---------------------------------------------------------------------------
# the blocked attention's tiles and scope
# ---------------------------------------------------------------------------

def test_block_defaults_change_the_tiles_and_keep_the_result():
    """``set_block_defaults`` changes the tiles a call that names none
    uses (the einsums' shapes inside the attention scope), and the output
    stays within the attention tests' tolerance of the reference's blocked
    attention at those tiles."""
    import jax.numpy as jnp
    from repro.models import blocked_attention as jblocked
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    try:
        blocked.set_block_defaults(16, 32)
        with OpCounter() as counts:
            got = blocked.blocked_attention(tq, tk, tk)
    finally:
        blocked.set_block_defaults(None, None)
    with OpCounter() as plain:
        blocked.blocked_attention(tq, tk, tk)
    shapes = {s for (n, s, _) in counts.ops if n == "aten.bmm"}
    # Q K^T of a block: [B KVH, g block_q, d] x [B KVH, d, block_kv]
    assert ((2, 2 * 16, 16), (2, 16, 32)) in shapes, shapes
    assert {s for (n, s, _) in plain.ops if n == "aten.bmm"} != shapes
    assert counts.flash_bytes > 0 and plain.flash_bytes > 0
    want = jblocked.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(k), block_q=16,
                                      block_kv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# against the reference's dry run
# ---------------------------------------------------------------------------

def _moe_padding_flops(cfg, mesh, tokens: int, passes: int) -> float:
    """FLOPs of the rows the port's MoE blocks pad to the grouped matmul's
    tile (``cap_pad - cap`` an expert and EP source, routed; ``t_pad - t``
    of the shared experts, at their ``f / m`` columns where ``model``
    splits them), each through the three expert matmuls,
    ``passes`` times (3 in training: forward, and the input and weight
    gradients), for one microbatch of ``tokens``.  Each ``model`` rank
    routes its own slice of the rank's ``tokens`` where ``model`` divides
    them (``moe._moe_ep``, as the reference's dispatch does), and its
    capacity is that slice's."""
    if cfg.moe is None:
        return 0.0
    m, d = cfg.moe, cfg.d_model
    ep = 1
    for a in ("pod", "model"):
        ep *= mesh.shape.get(a, 1)
    msize = mesh.shape.get("model", 1)
    routed = tokens // msize if tokens % msize == 0 and tokens >= msize \
        else tokens
    cap = moe._capacity(routed, m)
    _, cap_pad = moe.buffer_layout(cap)
    _, t_pad = moe.buffer_layout(tokens)
    n_moe = sum(not lm.is_dense_layer(cfg, i) for i in range(cfg.n_layers))
    routed = (m.num_experts // ep) * ep * (cap_pad - cap) * m.d_ff_expert
    shared_f = m.d_ff_expert // msize if m.d_ff_expert % msize == 0 \
        else m.d_ff_expert
    shared = m.num_shared * (t_pad - tokens) * shared_f
    return float(n_moe * (routed + shared) * 3 * 2 * d * passes)


def _slstm_weight_grad_flops(cfg, tokens: int, m: int = 1) -> float:
    """FLOPs of the sLSTM blocks' ``w_in`` and ``w_rec`` gradients, ``2
    tokens d 4d`` each (``w_in``'s on the rank's ``4d / m`` columns of a
    ``model`` axis of ``m``; ``w_rec`` is whole on every rank).  The
    reference's scan projects each step's input and state inside the loop;
    the transposed loop's per-step outer products (a contraction of size 1)
    compile to elementwise multiplies added into the gradients, not to
    ``dot``, so ``analyze_hlo`` counts none of them.  The port runs them
    as matmuls: ``x^T dgates`` over the sequence and one ``h^T dgates`` a
    step."""
    n_slstm = sum(lm.is_slstm(cfg, i) for i in range(cfg.n_layers))
    one = 2 * tokens * cfg.d_model * 4 * cfg.d_model
    return float(n_slstm * (one / m + one))


def _xlstm_repeated_flops(cfg, rows: int, kind: str, m: int) -> float:
    """The dot FLOPs a rank of an xLSTM model repeats on a ``model`` axis
    of ``m`` (its cores run whole on every rank) where the reference's XLA
    splits them ``m`` ways: ``(1 - 1/m)`` of the port's count of those
    dots on the rank's ``rows`` (``B``) of one cell (``S = SEQ``, one
    chunk of ``L = S`` positions; ``h`` heads of ``dh``; ``d`` the model
    width).  An mLSTM layer's chunk core: the scores and their product
    with v, ``4 B L^2 h dh``; C's and n's products with q and the state
    updates, ``4 B L h dh^2 + 4 B L h dh``.  Its decode step: C's and n's
    products with q, ``2 B h dh^2 + 2 B h dh`` (the update's outer
    product ``k v^T`` is elementwise).  An sLSTM layer's recurrence ``h @
    w_rec``: ``8 B d^2`` a step.  A train cell adds their backward: both
    operands' gradients of the scores and of their product with v, ``8 B
    L^2 h dh``; q's of C's and n's products, ``2 B L h dh^2 + 2 B L h
    dh`` (the zero starting state takes none, and the last chunk's state
    update reaches no loss); the recurrence's input gradient at every step
    but the first (the starting h takes none), ``8 B (S - 1) d^2``."""
    h, d = cfg.n_heads, cfg.d_model
    dh = 2 * d // h
    b, s = rows, SEQ
    n_s = sum(lm.is_slstm(cfg, i) for i in range(cfg.n_layers))
    n_m = cfg.n_layers - n_s
    if kind == "decode":
        mlstm, slstm = 2 * b * h * dh * (dh + 1), 8 * b * d * d
    else:
        mlstm = 4 * b * s * h * dh * (s + dh + 1)
        slstm = 8 * b * s * d * d
        if kind == "train":
            mlstm += 8 * b * s * s * h * dh + 2 * b * s * h * dh * (dh + 1)
            slstm += 8 * b * (s - 1) * d * d
    return float((1 - 1 / m) * (n_m * mlstm + n_s * slstm))


def _kv_repeated_flops(cfg, mesh, tokens: int, kind: str) -> float:
    """The dot FLOPs of the k and v projections that a rank repeats under
    KV replication (``shardings.attention_split``: ``"replicate"``), where
    each ``model`` rank computes the kv head its q heads read from the
    whole ``wk`` / ``wv`` (gathered whole, not kept) while the reference's
    XLA splits their columns ``m`` ways: ``(1 - 1/m)`` of ``2 tokens d (2
    kvh dh)`` a layer, three times that in a train cell (the input's and
    the weights' gradients).  Granite's one kv head is every kv head, so
    its cache write adds none; 0 under any other split."""
    from repro_torch.launch import shardings
    if shardings.attention_split(cfg, mesh) != "replicate":
        return 0.0
    m = mesh.shape["model"]
    one = 2 * tokens * cfg.d_model * 2 * cfg.n_kv_heads * cfg.d_head
    return float((1 - 1 / m) * cfg.n_layers * one
                 * (3 if kind == "train" else 1))


def _port_flops(mesh, arch, kind, **kw) -> float:
    return dryrun.run_cell(arch, ShapeConfig(f"{kind}_s", SEQ, BATCH, kind),
                           mesh, verbose=False, smoke=True, use_kernel=False,
                           **kw)["compute_s"] * roofline.PEAK_FLOPS


def _hold_flops(ref: dict, mesh, family: str, held: bool = True) -> dict:
    """Each kind's ``port / reference`` FLOPs a rank of ``family``'s SMOKE
    cells on ``mesh``, the MoE padding, the sLSTM weight gradients, the
    xLSTM cores' repeated work (:func:`_xlstm_repeated_flops`) and the
    k / v projections repeated under KV replication
    (:func:`_kv_repeated_flops`; both returned under ``repeated``) taken
    off: where ``held``, train and
    prefill within 2%; decode at most the reference's, short of it by no
    more than the attention over the cache rows the port does not read
    (none: the cache holds ``seq_len - 1`` positions and the step reads
    all ``seq_len``)."""
    from repro_torch.launch.steps import clamp_n_micro, recipe_for
    arch = FAMILIES[family]
    cfg = get_config(arch, smoke=True)
    rows = BATCH // (mesh.shape["pod"] * mesh.shape["data"])
    m = mesh.shape["model"]
    ratios, repeated = {}, {}
    for kind in KINDS:
        want = ref[f"{arch}|{kind}"]
        tokens = rows * (1 if kind == "decode" else SEQ)
        shape = ShapeConfig(f"{kind}_s", SEQ, BATCH, kind)
        n_micro = clamp_n_micro(recipe_for(arch, shape), shape,
                                mesh).n_micro if kind == "train" else 1
        pad = n_micro * _moe_padding_flops(cfg, mesh, tokens // n_micro,
                                           3 if kind == "train" else 1)
        if kind == "train":
            pad += _slstm_weight_grad_flops(cfg, tokens, m)
        if cfg.family == "ssm":
            repeated[kind] = _xlstm_repeated_flops(cfg, rows, kind, m)
            pad += repeated[kind]
        kv = _kv_repeated_flops(cfg, mesh, tokens, kind)
        if kv:
            repeated[kind] = kv
            pad += kv
        got = _port_flops(mesh, arch, kind) - pad
        ratios[kind] = got / want
        if not held:
            continue
        if kind == "decode":
            unread = 0           # valid = T
            gap = 4 * cfg.d_model * rows * unread * cfg.n_layers
            assert want - gap <= got <= want * (1 + 1e-9), (kind, got, want)
        else:
            assert abs(got - want) <= FLOP_TOL * want, (kind, got, want)
    if repeated:
        ratios["repeated"] = repeated
    return ratios


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flops_split_over_model_match_the_reference(reference_flops,
                                                    family):
    """On ``TP_MESH`` (``model`` 2), as :func:`test_flops_match_the
    _reference` holds ``(2, 4, 1)``: every family within 2% (the MLP, GQA
    heads (Hymba's too), MLA heads and down-projections, Hymba's Mamba
    channels, the xLSTM projections, the embedding and vocabulary split
    over ``model`` as the reference's XLA splits them), the xLSTM cores'
    repeated work taken off and printed beside the ratios (prefill and
    decode then equal the reference's to the FLOP), and Granite's (``mqa``:
    KV replication, its one kv head read by both ranks' q heads) k / v
    projections, which each rank computes whole, taken off alike.  MLA
    leaves no difference: dot for dot, XLA's per-device products of the
    absorbed decode (``wq_a`` / ``wkv_a`` on 24 of 48 columns, ``wq_b`` and
    ``wo`` on 2 of 4 heads, the scores and context over the whole latent
    for 2 heads, or over half of ``T`` or of ``r`` for all 4, the same
    FLOPs) are the port's (now all 4 heads over the rank's half of ``T``
    in a decode step), and the prefill's and training's as well.  The
    shared experts' padded rows are worked out at their ``f / m``
    columns (DeepSeek-V2's decode: ``2 x 14`` rows of ``16``)."""
    with dryrun.fake_world(8):
        mesh = make_mesh(TP_MESH, AXES, device_type="meta")
        ratios = _hold_flops(reference_flops(TP_MESH), mesh, family,
                             held=family in TP_HELD)
    repeated = ratios.pop("repeated", {})
    print(f"{family} on {TP_MESH}: port / reference FLOPs "
          + " ".join(f"{k} {v:.4f}" for k, v in ratios.items())
          + "".join(f"; {k} repeated {v:.0f}" for k, v in repeated.items()))
    assert all(np.isfinite(v) and v > 0 for v in ratios.values())


@pytest.fixture()
def position_variants(monkeypatch):
    """The port's ``steps`` building :data:`POSITION_VARIANTS`'s cells as
    the reference's subprocess does (config and recipe of the arch, the
    fields replaced)."""
    import dataclasses

    from repro_torch.launch import steps
    config, recipe = steps.get_config, steps.recipe_for
    monkeypatch.setattr(steps, "get_config", lambda name, smoke=False: (
        dataclasses.replace(config(POSITION_VARIANTS.get(name, (name,))[0],
                                   smoke=smoke),
                            **POSITION_VARIANTS.get(name, (name, {}))[1])))
    monkeypatch.setattr(steps, "recipe_for", lambda name, shape: recipe(
        POSITION_VARIANTS.get(name, (name,))[0], shape))
    return steps.get_config


def _xla_repeated_core(cfg, rows: int, m: int) -> float:
    """The attention core's FLOPs that the reference's XLA repeats on every
    ``model`` rank in the Hymba variant's train cell (6 heads, 3 kv heads,
    window 8): its per-chip count there is 69,828,608 on ``(2, 4, 1)`` (1
    row a chip, ``model`` 1), 79,265,792 on ``(2, 2, 2)`` and 98,140,160 on
    ``(1, 2, 4)`` (2 and 4 rows a chip; ``dev/reference_flops.py``), exactly ``(1 - 1/m)`` of the core
    (the fused ``[S, S]`` scores and their product with v, ``4 S^2 h dh``
    a row and layer, and twice that in the backward) on the chip's rows
    over the ``(2, 4, 1)`` count; its prefill and the Qwen2.5-14B
    variant's cells split the core evenly.  The port splits it by
    positions in every cell."""
    s, h, dh = SEQ, cfg.n_heads, cfg.d_head
    return (1 - 1 / m) * rows * cfg.n_layers * 3 * 4 * s * s * h * dh


@pytest.mark.parametrize("variant", list(POSITION_VARIANTS))
def test_flops_split_by_positions_match_the_reference(
        reference_flops, position_variants, variant):
    """On ``TP_MESH`` a variant whose attention splits by positions
    (``shardings.attention_split``): its projections' ``1/m`` of the
    columns, each rank's query rows (blocks ``r`` and ``2m - 1 - r``) over
    every key row on the plain route, its block of the cache's ``T`` in a
    decode step, ``wo``'s ``1/m`` of the rows: train and prefill within 2%
    of the reference's ``analyze_hlo``; decode at most the reference's and
    short of it by the attention over the blocks the rank does not read (a
    block wholly left of a sliding window: rank 0's 32 rows in the Hymba
    variant's windowed layer, whose window of 8 lies in rank 1's block;
    the merge's elementwise work counts no FLOP).  In the Hymba variant's
    train cell the reference's XLA repeats
    the attention core on both ``model`` ranks; that repeated work
    (:func:`_xla_repeated_core`) is taken off its count first."""
    cfg = position_variants(variant, smoke=True)
    with dryrun.fake_world(8):
        mesh = make_mesh(TP_MESH, AXES, device_type="meta")
        from repro_torch.launch import shardings
        assert shardings.attention_split(cfg, mesh) == "positions"
        ref = reference_flops(TP_MESH)
        ratios = {}
        rows = BATCH // (TP_MESH[0] * TP_MESH[1])
        for kind in KINDS:
            want = ref[f"{variant}|{kind}"]
            if cfg.family == "hybrid" and kind == "train":
                want -= _xla_repeated_core(cfg, rows, TP_MESH[-1])
            got = _port_flops(mesh, variant, kind)
            ratios[kind] = got / want
            if kind == "decode":
                from repro_torch.kernels.decode_attention import block_window
                n = SEQ // TP_MESH[-1]          # rank 0's block: [0, n)
                skipped = sum(block_window(SEQ, 0, n, lm.layer_window(
                    cfg, i))[0] == 0 for i in range(cfg.n_layers))
                gap = 4 * rows * cfg.n_heads * cfg.d_head * n * skipped
                assert want - gap <= got <= want * (1 + 1e-9), \
                    (kind, got, want, gap)
            else:
                assert abs(got - want) <= FLOP_TOL * want, (kind, got, want)
    print(f"{variant} on {TP_MESH}: port / reference FLOPs "
          + " ".join(f"{k} {v:.4f}" for k, v in ratios.items()))


def _attn_cache_bytes(cache: dict) -> int:
    """The bytes of a port cache's attention keys and values (an MLA
    layer's latent and rope key)."""
    n = 0
    for layer in cache["layers"]:
        sub = layer.get("attn", layer)
        n += sum(t.numel() * t.element_size() for k, t in sub.items()
                 if k in ("k", "v", "latent", "k_rope"))
    return n


def _ref_attn_cache_bytes(cfg, mesh, batch: int, seq: int) -> int:
    """The bytes a device holds of the reference's attention keys and
    values (an MLA layer's latent and rope key) by its ``cache_spec`` (per
    layer, ``layers/i/k``; bf16)."""
    from repro.launch.shardings import cache_spec
    from repro_torch.launch import shardings
    if cfg.mla is not None:
        leaves = {"latent": (batch, seq, cfg.mla.kv_lora_rank),
                  "k_rope": (batch, seq, cfg.mla.rope_head_dim)}
    else:
        whole = (batch, seq, cfg.n_kv_heads, cfg.d_head)
        leaves = {"k": whole, "v": whole}
    per = 0
    for i in range(cfg.n_layers):
        for name, whole in leaves.items():
            spec = tuple(cache_spec(f"layers/{i}/{name}", whole, mesh, cfg))
            per += 2 * int(np.prod(shardings.local_shape(spec, whole, mesh)))
    return per


@pytest.mark.parametrize("variant", list(POSITION_VARIANTS))
def test_cache_bytes_split_by_positions_equal_the_reference(
        position_variants, variant):
    """A decode cell's cache on ``TP_MESH`` (the dry run's own layout,
    ``dryrun.local_args``): each rank holds its batch rows and every kv
    head of its ``model`` block of ``T``, the reference's ``cache_spec``
    bytes exactly, half the bytes of the mesh's whole-``T`` cache."""
    cfg = position_variants(variant, smoke=True)
    with dryrun.fake_world(8):
        mesh = make_mesh(TP_MESH, AXES, device_type="meta")
        cell = build_cell(variant, ShapeConfig("d", SEQ, BATCH, "decode"),
                          mesh, smoke=True)
        _, cache, _ = dryrun.local_args(cell)
        got = _attn_cache_bytes(cache)
        rows = BATCH // (TP_MESH[0] * TP_MESH[1])
        whole = _attn_cache_bytes(lm.init_cache(cfg, rows, SEQ,
                                                device="meta"))
    assert got == _ref_attn_cache_bytes(cfg, mesh, BATCH, SEQ)
    assert got * TP_MESH[-1] == whole


# the configs whose caches split T over model on (16, 16): heads that do not
# divide 16 (the split by positions), kv heads fewer than 16 (KV
# replication: Pixtral 32 / 8, Llama-3 128 / 8, Qwen1.5 64 / 8, Qwen3-MoE
# 64 / 4, Granite 48 / 1) and MLA (DeepSeek-V2's latent and rope key)
DECODE_32K_SPLIT = ("qwen2.5-14b", "hymba-1.5b", "pixtral-12b", "llama3-405b",
                    "qwen1.5-110b", "qwen3-moe-235b-a22b", "granite-34b",
                    "deepseek-v2-236b")


@pytest.mark.parametrize("arch", DECODE_32K_SPLIT)
def test_decode_32k_cache_a_rank_is_the_reference_spec(arch):
    """At full width on ``(16, 16)``, ``decode_32k`` (128 sequences, 8 a
    rank, 32,768 positions): Qwen2.5-14B's 40 heads and Hymba's 25 do not
    divide 16, the other GQA configs' kv heads are fewer than 16 (KV
    replication), and DeepSeek-V2's MLA splits its heads, so each rank's
    cache holds every kv head (the whole latent and rope key) of its
    2,048 rows of ``T``: the reference's ``cache_spec`` bytes (for MLA, the
    latent's ``r`` split and the rope key's ``T``: the same bytes), 1/16 of
    every row's (no step is run: the caches are meta tensors)."""
    cfg = get_config(arch)
    shape = ShapeConfig("decode_32k", 32768, 128, "decode")
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="meta")
        rows = shape.global_batch // mesh.shape["data"]
        cache = lm.init_cache(cfg, rows, shape.seq_len, device="meta",
                              mesh=mesh)
        got = _attn_cache_bytes(cache)
        whole = _attn_cache_bytes(lm.init_cache(cfg, rows, shape.seq_len,
                                                device="meta"))
    assert got == _ref_attn_cache_bytes(cfg, mesh, shape.global_batch,
                                        shape.seq_len)
    assert got * 16 == whole
    print(f"{arch} decode_32k on (16, 16): {got / 1e9:.4f} GB of keys and "
          f"values a rank (every kv head of all T: {whole / 1e9:.4f} GB)")


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_mixer_kernels_take_the_split_mesh_inputs(family):
    """Hymba's and xLSTM's SMOKE prefill and decode cells on ``TP_MESH``
    with the kernels' meta branches (``use_kernel=True``), which check
    what the card's wrappers would: under the mixers' split each kernel
    of the path takes its inputs (sLSTM's all-gathered ``x @ w_in`` made
    contiguous; Hymba's heads of the rank) and is counted once a layer it
    serves."""
    from repro_torch.models import lm
    arch = FAMILIES[family]
    cfg = get_config(arch, smoke=True)
    n_slstm = sum(lm.is_slstm(cfg, i) for i in range(cfg.n_layers))
    with dryrun.fake_world(8):
        mesh = make_mesh(TP_MESH, AXES, device_type="meta")
        for kind, name in (("prefill", "flash_attention"),
                           ("decode", "decode_attention")):
            row = dryrun.run_cell(arch, ShapeConfig(f"{kind}_s", SEQ, BATCH,
                                                    kind), mesh, verbose=False,
                                  smoke=True)
            want = {"slstm_scan": n_slstm} if family == "ssm" \
                else {name: cfg.n_layers}
            assert row["kernels"] == want, (kind, row["kernels"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flops_match_the_reference(reference_flops, fake8, family):
    """Per-rank FLOPs of each family's SMOKE cells against the reference's
    ``analyze_hlo`` on ``(2, 4, 1)``, the MoE padding and the sLSTM weight
    gradients taken off: train and prefill within 2%; decode at most the
    reference's, short of it by no more than the attention over the cache
    rows the port does not read (none: the cache holds ``seq_len - 1``
    positions and the step reads all ``seq_len``)."""
    _hold_flops(reference_flops(), fake8, family)


def test_remat_control_misses(reference_flops, fake8):
    """The control: the dense train cell counted with the other remat
    setting than the reference's cell (the SMOKE configs keep remat off;
    on, every block's forward runs again in the backward) misses the
    reference's FLOPs by far more than the 2%."""
    arch = FAMILIES["dense"]
    assert not get_config(arch, smoke=True).remat
    want = reference_flops()[f"{arch}|train"]
    got = _port_flops(fake8, arch, "train", recipe=Recipe(remat=True))
    assert got > (1 + 5 * FLOP_TOL) * want, (got, want)


# ---------------------------------------------------------------------------
# roofline, report, perf and the command line
# ---------------------------------------------------------------------------

def _rows() -> list[dict]:
    base = {"arch": "a", "shape": "s", "mesh": "16x16", "chips": 256,
            "status": "ok", "memory_s_kernel": 0.1, "step_time_s": 1.0,
            "model_flops_ratio": 0.5, "hbm_gb": 12.3, "ici_gb": 1.0,
            "dcn_gb": 0.5, "collectives": 3}
    return [
        dict(base, compute_s=2.0, memory_s=0.5, collective_s=0.1,
             dominant="compute", mfu=0.4),
        dict(base, compute_s=0.01, memory_s=0.5, collective_s=0.1,
             memory_s_kernel=0.4, dominant="memory", mfu=0.01),
        dict(base, compute_s=0.01, memory_s=0.02, collective_s=3.0,
             dominant="collective", mfu=0.001),
        {"arch": "b", "shape": "long_500k", "mesh": "16x16", "status": "skip"},
        {"arch": "c", "shape": "s", "mesh": "16x16", "status": "fail",
         "error": "boom"},
        dict(base, compute_s=0.01, memory_s=0.5, collective_s=0.1,
             memory_s_kernel=0.1, dominant="memory", mfu=0.01)]


def test_report_renders_the_reference_table():
    """``render`` gives the reference's text on the same rows but for the
    kernel-traffic note, which speaks of the port."""
    from repro.launch import report as rreport
    rows = _rows()
    assert report.render(rows[:-1]) == rreport.render(rows[:-1])
    got, want = report.render(rows[-1:]), rreport.render(rows[-1:])
    assert "the plain attention's traffic; the flash kernel removes it" in got
    assert got.replace("the plain attention's traffic; the flash kernel "
                       "removes it", "XLA attention traffic; Pallas flash "
                       "kernel removes it") == want


def test_roofline_row_keys_and_h100_terms():
    from repro.launch import roofline as rroof

    class C:
        flops, hbm_bytes, ici_bytes, dcn_bytes = 989e12, 3.35e12, 450e9, 50e9
        collective_count, flash_bytes = 2, 0.0
        memory = {"total_gb": 1.0}
    cfg = get_config("qwen2.5-14b", smoke=True)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    mesh = type("M", (), {"shape": {"data": 16, "model": 16}})()
    roof = roofline.analyze(C(), arch="x", shape=shape, mesh=mesh, cfg=cfg)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == (1.0, 1.0,
                                                                  2.0)
    assert roof.dominant == "collective" and roof.chips == 256
    ref_row = rroof.Roofline("x", "t", "16x16", 256, 1, 1, 1, 1, 1).row()
    assert set(roof.row()) == set(ref_row)
    assert roofline.model_flops_for(cfg, shape) == \
        rroof.model_flops_for(cfg, shape)


def test_perf_and_dryrun_main_on_smoke(tmp_path, capsys):
    """``perf.run`` on a SMOKE cell with the tiles overridden prints the
    terms and the top ops; ``dryrun.main`` on SMOKE, two cells at a time
    in processes of their own, writes its rows, one a cell, skips what
    ``shape_applicable`` skips, exits 0 and reads back through
    ``report``."""
    row = perf.run("qwen2.5-14b", "prefill_32k", multi_pod=False,
                   recipe=Recipe(), top=5, smoke=True, block_q=256,
                   block_kv=512)
    out = capsys.readouterr().out
    assert "top traffic items" in out and row["status"] == "ok"
    assert len(row["top"]) == 5
    path = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "qwen2.5-14b", "--smoke", "--jobs", "2",
                        "--out", str(path)]) == 0
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["status"] for r in rows] == ["ok", "ok", "ok", "skip"]
    assert rows[2]["kernels"] == {"decode_attention": 2}
    text = report.render(rows)
    assert text.count("\n") == len(rows) + 1 and "skip" in text
    assert "0 failed" in capsys.readouterr().out


def test_full_width_cell_argument_bytes():
    """One full-width cell on ``(16, 16)`` under a fake world of 256: the
    counted argument bytes are its stand-ins' local bytes (the model's
    shards and the batch's rows), the flash kernel reported twice a
    layer: Qwen2.5-14B's 40 heads do not divide 16, so each rank attends
    for its two blocks of query rows (``shardings.position_blocks``)."""
    from torch.distributed.tensor import DTensor
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="meta")
        cell = build_cell("qwen2.5-14b", "prefill_32k", mesh)
        local = sum(p.numel() * p.element_size()
                    for p in cell.args[0].parameters())
        local += sum(t.to_local().numel() * t.element_size()
                     for t in cell.args[1].values() if isinstance(t, DTensor))
        counts = dryrun.count_cell(cell, dryrun.local_args(cell))
    assert counts.argument_bytes == local
    assert counts.kernel_calls == {"flash_attention": 2 * cell.cfg.n_layers}
