"""Runs the port's tensor parallelism over ``model`` on gloo ranks and the
reference over forced host devices, for ``test_torch_tp.py``.

The pattern of ``mesh_ranks.py``: the reference in one subprocess over 8
forced host devices, the port in one ``torch.multiprocessing`` spawn of 8
gloo ranks that meet through a file store and build both meshes of
:data:`MESHES` on one world.  Both read one ``.npz`` of numpy inputs made
from seeds and write their outputs to ``.npz`` files.  This module imports
neither jax nor torch at its top.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

from mesh_ranks import AXES, REPO, _reference_serve, unflatten
from mesh_train_ranks import _mesh_grads

# SMOKE variants (the same change of config on both sides) whose GQA
# attention splits over model by positions: Qwen2.5-14B with 5 heads and one
# kv head (80 q columns: 2.5 heads a rank on model 2, as 40 heads are on
# 16), Hymba with 6 heads and 3 kv heads (the heads divide 2, the kv heads
# neither divide it nor are divided by it; on 4 neither divides)
VARIANTS = {"qwen2.5-14b-h5kv1": ("qwen2.5-14b", dict(n_heads=5,
                                                      n_kv_heads=1)),
            "hymba-1.5b-h6kv3": ("hymba-1.5b", dict(n_heads=6,
                                                    n_kv_heads=3))}
# the dense family (GQA with 2 kv heads of 4; Granite's MQA: its one kv head
# replicated, its cache every kv head of a block of T), the MoE family's
# GQA beside teshu2, DeepSeek-V2 (its shared experts, layer 0 and MLA split:
# 4 heads, q_lora 48, r + dr 48, the latent cache a block of T), Hymba
# (the Mamba head's 128 channels split, its attention's 4 / 2 heads),
# xLSTM (an mLSTM and an sLSTM layer, their projections split) and the two
# variants split by positions
ARCHS = ("qwen2.5-14b", "granite-34b", "qwen3-moe-235b-a22b",
         "deepseek-v2-236b", "hymba-1.5b", "xlstm-350m", *VARIANTS)
DENSE = ARCHS[:2]
MLA = ARCHS[3:4]
HYBRID = ARCHS[4:5]
XLSTM = ARCHS[5:6]
POSITIONS = tuple(VARIANTS)
# the archs whose reference runs once (no EP axes), and those prefilled in
# two chunks
ONCE = DENSE + HYBRID + XLSTM + POSITIONS
CHUNKED = DENSE + MLA + HYBRID + XLSTM + POSITIONS
# the archs whose caches split T over model on both meshes, served again on
# a cache of a T that model does not divide (the rank then holds all of it)
ODD_T = ("granite-34b",) + MLA + POSITIONS
# model 2 (each rank 2 q heads, one kv head of its own) and model 4 (one q
# head; Qwen2.5-14B's 2 kv heads each shared by 2 ranks)
MESHES = ((2, 2, 2), (1, 2, 4))
B, S = 8, 12
CHUNK = 7                 # an MLA model's two-chunk prefill: 7, then 5
SERVE = dict(batch=8, prompt_len=12, gen_len=5, max_len=32, seed=0)
FAULTS = ("no_psum", "kv_head_mod", "gold_everywhere", "column_model_sum",
          "q_norm_local", "wkv_b_offset", "mla_no_sum", "mamba_xz_block",
          "bcdt_no_sum", "mamba_no_sum", "mlstm_norm_local", "slstm_no_sum",
          "rope_before_gather", "rows_swapped", "merge_mean",
          "block_window", "replicate_own_head", "mla_merge_mean",
          "rows_next_rank")
# the planted faults, each on the mesh and arch where it bites
FAULT_CASE = {"no_psum": ("qwen2.5-14b", (2, 2, 2)),
              "kv_head_mod": ("qwen2.5-14b", (1, 2, 4)),
              "gold_everywhere": ("qwen2.5-14b", (2, 2, 2)),
              "column_model_sum": ("qwen2.5-14b", (2, 2, 2)),
              "q_norm_local": ("deepseek-v2-236b", (1, 2, 4)),
              "wkv_b_offset": ("deepseek-v2-236b", (2, 2, 2)),
              "mla_no_sum": ("deepseek-v2-236b", (2, 2, 2)),
              "mamba_xz_block": ("hymba-1.5b", (2, 2, 2)),
              "bcdt_no_sum": ("hymba-1.5b", (2, 2, 2)),
              "mamba_no_sum": ("hymba-1.5b", (1, 2, 4)),
              "mlstm_norm_local": ("xlstm-350m", (1, 2, 4)),
              "slstm_no_sum": ("xlstm-350m", (2, 2, 2)),
              "rope_before_gather": ("qwen2.5-14b-h5kv1", (2, 2, 2)),
              "rows_swapped": ("qwen2.5-14b-h5kv1", (1, 2, 4)),
              "merge_mean": ("qwen2.5-14b-h5kv1", (2, 2, 2)),
              # a window's start inside a block of 8 rows (model 4)
              "block_window": ("hymba-1.5b-h6kv3", (1, 2, 4)),
              # KV replication with 2 kv heads over 4 ranks (T in blocks)
              "replicate_own_head": ("qwen2.5-14b", (1, 2, 4)),
              "mla_merge_mean": ("deepseek-v2-236b", (2, 2, 2)),
              "rows_next_rank": ("granite-34b", (2, 2, 2))}
# the faults read off the forward's logits, and those off the served
# logits of the decode steps (the others off the loss or the gradients)
LOGIT_FAULTS = ("no_psum", "kv_head_mod", "q_norm_local", "wkv_b_offset",
                "mla_no_sum", "mamba_xz_block", "bcdt_no_sum", "mamba_no_sum",
                "mlstm_norm_local", "slstm_no_sum", "rope_before_gather",
                "rows_swapped")
SERVE_FAULTS = ("merge_mean", "block_window", "replicate_own_head",
                "mla_merge_mean", "rows_next_rank")
# train(mesh=...) on (2, 2, 2) with a checkpoint every 3 steps; steps 3-5
# resumed from it on a mesh of another model size, for each arch of
# CKPT_ARCHS (DeepSeek-V2's MoE layers route one row a group on all three
# meshes: 2 rows a rank over model 2, 4 over 4, 1 over 1)
CKPT = dict(steps=6, global_batch=8, seq_len=16, lr=1e-2, seed=5,
            ckpt_every=3)
CKPT_ARCHS = ("qwen2.5-14b", "deepseek-v2-236b")
RESTORE_MESHES = ((1, 2, 4), (2, 4, 1))


def mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def base(key: str) -> str:
    """The arch of ``key`` (an arch, or a key of :data:`VARIANTS`)."""
    return VARIANTS.get(key, (key, None))[0]


def config(key: str, get_config):
    """``key``'s SMOKE config from ``get_config`` (either package's): the
    arch's, a variant's with its fields replaced."""
    arch, changes = VARIANTS.get(key, (key, {}))
    return dataclasses.replace(get_config(arch, smoke=True), **changes)


def flat_tree(tree, prefix: str) -> dict:
    """``flat`` of a tree whose lists (a hybrid's or an xLSTM's
    ``layers``) become dicts keyed by index (:func:`unflat_tree`'s
    inverse)."""
    from mesh_train_ranks import flat

    def dicts(t):
        if isinstance(t, (list, tuple)):
            return {str(i): dicts(v) for i, v in enumerate(t)}
        return {k: dicts(v) for k, v in t.items()} if isinstance(t, dict) \
            else t
    return flat(dicts(tree), prefix)


def unflat_tree(data: dict, prefix: str) -> dict:
    """``unflatten`` with each dict keyed ``"0"``, ``"1"``, ... a list."""
    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}
    return lists(unflatten(data, prefix))


# ---------------------------------------------------------------------------
# the reference: one subprocess over 8 forced host devices
# ---------------------------------------------------------------------------

def start_reference(inputs: str, out: str) -> subprocess.Popen:
    code = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        sys.path.insert(0, {str(REPO / "tests")!r})
        import tp_ranks
        tp_ranks.reference_tp({inputs!r}, {out!r})
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def reference_tp(inputs: str, out: str) -> None:
    """For each arch the reference's forward logits, its ``jax.value_and
    _grad`` of ``train_loss`` and its serving loop (``_reference_serve``),
    each jitted with the parameters unsharded; a MoE model's under each
    mesh of :data:`MESHES` with the mesh's EP axes (each ``model`` slice
    routes its own tokens, so its aux loss depends on the mesh), a dense
    model's once."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.mesh import make_mesh
    from repro.launch.shardings import ep_axes_for
    from repro.models import lm
    data = dict(np.load(inputs))
    res = {}
    for arch in ARCHS:
        cfg = config(arch, get_config)
        p = jax.tree.map(jnp.asarray, unflat_tree(data, f"p-{arch}"))
        batch = {k: jnp.asarray(data[f"batch-{arch}|{k}"])
                 for k in ("tokens", "labels")}
        for shape in (MESHES[:1] if arch in ONCE else MESHES):
            mesh = make_mesh(shape, AXES)
            ep = ep_axes_for(mesh) if arch not in ONCE else ()
            key = ref_key(arch, shape)
            with mesh:
                logits = jax.jit(lambda p, t: lm.forward(
                    p, cfg, tokens=t, ep_axes=ep)[0])(p, batch["tokens"])
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p, b: lm.train_loss(p, cfg, b, ep_axes=ep)))(
                        p, batch)
            res[f"{key}|logits"] = np.asarray(logits, np.float32)
            res[f"{key}|loss"] = np.asarray(loss)
            res.update(flat_tree(jax.tree.map(np.asarray, g), f"{key}|g"))
            gen, last = _reference_serve(base(arch), p, mesh, cfg=cfg,
                                         **SERVE)
            res[f"{key}|tokens"], res[f"{key}|serve_logits"] = gen, last
            if arch in CHUNKED:
                with mesh:
                    res[f"{key}|chunked"] = np.asarray(jax.jit(
                        lambda p, t: _two_chunks(lm, p, cfg, t, ep))(
                            p, batch["tokens"]), np.float32)
    np.savez(out, **res)


def _two_chunks(lm, params, cfg, tokens, ep):
    """The reference's logits of ``tokens`` prefilled into one cache in two
    chunks, ``[0, CHUNK)`` and ``[CHUNK, S)``."""
    import jax.numpy as jnp
    cache = lm.init_cache(cfg, tokens.shape[0], S)
    first, cache, _ = lm.forward(params, cfg, tokens=tokens[:, :CHUNK],
                                 cache=cache, ep_axes=ep)
    second, _, _ = lm.forward(params, cfg, tokens=tokens[:, CHUNK:],
                              cache=cache, ep_axes=ep)
    return jnp.concatenate([first, second], axis=1)


def ref_key(arch: str, shape) -> str:
    return arch if arch in ONCE else f"{arch}|{mesh_name(shape)}"


# ---------------------------------------------------------------------------
# the port: one spawn of 8 gloo ranks
# ---------------------------------------------------------------------------

def run_ranks(tmp: Path, inputs: str, timeout: float) -> list[dict]:
    """:func:`_tp_rank` on 8 gloo ranks (a file store under ``tmp``);
    each rank's outputs as a dict, in rank order."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(str(tmp), inputs), nprocs=8,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"tp ranks still running after {timeout} s")
    return [dict(np.load(tmp / f"tp_{r}.npz")) for r in range(8)]


def _rank_main(rank: int, tmp: str, inputs: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_tp",
                            rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=120))
    try:
        np.savez(f"{tmp}/tp_{rank}.npz", **_tp_rank(inputs))
    finally:
        dist.destroy_process_group()


def _rows(x: np.ndarray, mesh):
    import torch

    from repro_torch.data import rank_rows
    return torch.from_numpy(rank_rows(x, mesh))


def _tp_rank(inputs: str) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import hybrid, layers, lm, ssm
    from repro_torch.models.convert import (cache_from_reference,
                                            lm_params_from_reference)
    data = dict(np.load(inputs))
    res: dict = {"rank": np.array(dist.get_rank())}
    meshes = {s: make_mesh(s, AXES, device_type="cpu") for s in MESHES}

    def model_of(arch, mesh):
        return lm_params_from_reference(config(arch, get_config),
                                        unflat_tree(data, f"p-{arch}"),
                                        device="cpu", mesh=mesh)

    def batch_of(arch):
        return {k: data[f"batch-{arch}|{k}"] for k in ("tokens", "labels")}

    def forward(model, arch, mesh):
        with torch.no_grad():
            return lm.forward(model, tokens=_rows(batch_of(arch)["tokens"],
                                                  mesh), mesh=mesh)[0].numpy()

    def grads(model, arch, mesh):
        model.requires_grad_(True)
        return _mesh_grads(model, model.cfg, mesh, batch_of(arch), 1)

    def two_chunks(model, arch, mesh, max_len=S, steps=0):
        """The logits of the rows' tokens prefilled in two chunks into a
        cache of ``max_len``, then of ``steps`` decode steps fed the first
        tokens again."""
        tokens = _rows(batch_of(arch)["tokens"], mesh)
        cache = lm.init_cache(model.cfg, tokens.shape[0], max_len,
                              device="cpu", mesh=mesh, specs=model.specs)
        with torch.no_grad():
            out = [lm.forward(model, tokens=t, cache=cache, mesh=mesh)[0]
                   for t in (tokens[:, :CHUNK], tokens[:, CHUNK:])]
            out += [lm.serve_step(model, cache, tokens=tokens[:, i:i + 1],
                                  mesh=mesh)[0] for i in range(steps)]
        return torch.cat(out, dim=1).numpy()

    for shape, mesh in meshes.items():
        for arch in ARCHS:
            key = f"{arch}|{mesh_name(shape)}"
            model = model_of(arch, mesh)
            res.update({f"{key}|local|{n}": np.array(p.shape)
                        for n, p in model.named_parameters()})
            cache = lm.init_cache(model.cfg, 1, 4, device="cpu", mesh=mesh,
                                  specs=model.specs)
            for i, layer in enumerate(cache["layers"]):
                res.update({f"{key}|cache|{i}|{k}": np.array(v.shape)
                            for k, v in _leaves(layer).items()})
            if arch in DENSE + MLA + HYBRID + XLSTM + POSITIONS:
                conv = cache_from_reference(
                    model.cfg, unflat_tree(data, f"cache-{arch}"),
                    device="cpu", mesh=mesh, specs=model.specs)
                for i, layer in enumerate(conv["layers"]):
                    res.update({f"{key}|converted|{i}|{k}": v.numpy()
                                for k, v in _leaves(layer).items()})
            res[f"{key}|logits"] = forward(model, arch, mesh)
            if arch in CHUNKED:
                res[f"{key}|chunked"] = two_chunks(model, arch, mesh)
            if arch in ODD_T:       # T split over model, and T whole (odd)
                for tag, t in (("even_t", 2 * S), ("odd_t", 2 * S + 1)):
                    res[f"{key}|{tag}"] = two_chunks(model, arch, mesh, t, 3)
            gen, stats = serve(base(arch), device="cpu", params=model,
                               mesh=mesh, **SERVE)
            res[f"{key}|tokens"] = gen
            res[f"{key}|serve_logits"] = torch.stack(stats.logits).numpy()
            loss, g, _ = grads(model, arch, mesh)
            res[f"{key}|loss"] = np.array(loss)
            res.update({f"{key}|g|{n}": v for n, v in g.items()})

    # the planted faults
    for fault in FAULTS:
        arch, shape = FAULT_CASE[fault]
        mesh = meshes[shape]
        model = model_of(arch, mesh)
        real = (layers.tp_sum, shardings.kv_head_of, lm._gold_logit,
                shardings.split_leaves, layers.MLA._q_a, hybrid._x_and_z,
                hybrid.tp_sum, ssm._mlstm_out, ssm._down)
        at_positions = (layers._rotated_heads, layers._query_blocks,
                        layers.merge_blocks, layers.block_window)
        at_blocks = (layers._kv_rows, layers._merge_heads,
                     layers._block_slots)
        if fault in _MIXER_FAULTS:
            _plant_mixer_fault(fault, model.cfg, real)
        elif fault in _POSITION_FAULTS:
            _plant_position_fault(fault)
        elif fault in _BLOCK_FAULTS:
            _plant_block_fault(fault, at_blocks)
        elif fault == "no_psum":
            layers.tp_sum = lambda x, mesh_: x
        elif fault == "kv_head_mod":
            shardings.kv_head_of = lambda r, m, kvh: r % kvh
        elif fault == "gold_everywhere":
            def everywhere(logits, labels, mesh_):
                v = logits.shape[-1]
                gold = logits.gather(-1, (labels % v)[..., None])[..., 0]
                return layers.tp_sum(gold, mesh_)
            lm._gold_logit = everywhere
        elif fault == "column_model_sum":
            def column_sum(specs, mesh_):
                out = real[3](specs, mesh_)
                return {n: tuple(a for a in axes if a != "model")
                        if n.endswith((".w_gate", ".w_up", ".wq"))
                        else axes for n, axes in out.items()}
            shardings.split_leaves = column_sum
        elif fault == "q_norm_local":
            def local_norm(self, x, mesh_):     # normed before the gather
                y = x @ self.wq_a
                n, r = y.shape[-1], mesh_.coord("model")
                y = layers.rms_norm(y, self.q_a_norm.weight[r * n:(r + 1) * n],
                                    self.q_a_norm.eps)
                return meshops.all_gather(y, mesh_, "model", axis=y.dim() - 1)
            layers.MLA._q_a = local_norm
        elif fault == "wkv_b_offset":
            _next_rank_heads(model, model_of(arch, None), mesh)
        else:
            def no_mla_sum(x, mesh_):           # wo's sum skipped
                caller = sys._getframe(1).f_locals.get("self")
                return x if isinstance(caller, layers.MLA) \
                    else real[0](x, mesh_)
            layers.tp_sum = no_mla_sum
        try:
            res[f"{fault}|logits"] = forward(model, arch, mesh)
            if fault in SERVE_FAULTS:
                _, stats = serve(base(arch), device="cpu", params=model,
                                 mesh=mesh, **SERVE)
                res[f"{fault}|serve_logits"] = torch.stack(
                    stats.logits).numpy()
            elif fault not in LOGIT_FAULTS:
                loss, g, _ = grads(model, arch, mesh)
                res[f"{fault}|loss"] = np.array(loss)
                res.update({f"{fault}|g|{n}": v for n, v in g.items()})
        finally:
            (layers.tp_sum, shardings.kv_head_of, lm._gold_logit,
             shardings.split_leaves, layers.MLA._q_a, hybrid._x_and_z,
             hybrid.tp_sum, ssm._mlstm_out, ssm._down) = real
            (layers._rotated_heads, layers._query_blocks,
             layers.merge_blocks, layers.block_window) = at_positions
            (layers._kv_rows, layers._merge_heads,
             layers._block_slots) = at_blocks

    # a checkpoint of train(mesh=...) on (2, 2, 2) restored onto meshes of
    # another model size
    from repro_torch.launch.train import train
    tmp = Path(inputs).parent
    meshes.update({s: make_mesh(s, AXES, device_type="cpu")
                   for s in RESTORE_MESHES if s not in meshes})
    ck = {k: v for k, v in CKPT.items() if k != "steps"}
    for arch in CKPT_ARCHS:
        ckdir = tmp / f"tp_ckpt_{arch}"
        if dist.get_rank() == 0:
            shutil.rmtree(ckdir, ignore_errors=True)
        dist.barrier()
        out = train(arch, device="cpu", mesh=meshes[MESHES[0]], n_micro=1,
                    ckpt_dir=str(ckdir), params=model_of(
                        arch, meshes[MESHES[0]]).requires_grad_(True),
                    steps=CKPT["steps"], **ck)
        res[f"{arch}|ckpt|loss"] = np.array([h["loss"]
                                             for h in out["history"]])
        for shape in RESTORE_MESHES:
            mesh = meshes[shape]
            where = tmp / f"tp_restore_{mesh_name(shape)}"
            if dist.get_rank() == 0:
                shutil.rmtree(where, ignore_errors=True)
                where.mkdir()
                shutil.copytree(ckdir / "step_00000003",
                                where / "step_00000003")
            dist.barrier()
            name = f"{arch}|{mesh_name(shape)}"
            got = train(arch, device="cpu", mesh=mesh, n_micro=1,
                        ckpt_dir=str(where), params=model_of(arch, mesh),
                        steps=3, **ck)
            assert got["history"] == []
            res.update({f"restored|{name}|p|{n}": p.detach().numpy().copy()
                        for n, p in got["params"].named_parameters()})
            for k in ("m", "v"):
                res.update({f"restored|{name}|{k}|{n}": t.numpy()
                            for n, t in got["opt_state"][k].items()})
            got = train(arch, device="cpu", mesh=mesh, n_micro=1,
                        ckpt_dir=str(where), params=model_of(arch, mesh),
                        steps=CKPT["steps"], **ck)
            res[f"resumed|{name}|loss"] = np.array([h["loss"]
                                                   for h in got["history"]])
    return res


def _leaves(layer: dict, pre: str = "") -> dict:
    """``{"k": tensor, "ssm|conv": tensor, ...}`` of a port cache layer's
    tensors (its integers, ``len`` and a block's ``t0``, left out)."""
    out = {}
    for k, v in layer.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{pre}{k}|"))
        elif not isinstance(v, int):
            out[pre + k] = v
    return out


_POSITION_FAULTS = ("rope_before_gather", "rows_swapped", "merge_mean",
                    "block_window")


def _plant_position_fault(fault: str) -> None:
    """One of the ``"positions"`` split's planted faults, patched into
    ``layers`` (restored by the caller): ``rope_before_gather`` rotates
    each rank's block of columns as if it were one head, before the
    gather; ``rows_swapped`` gives rank ``r`` the query rows of rank ``r +
    1`` (the rows still put back as rank ``r``'s); ``merge_mean`` merges
    the decode's blocks by a plain mean; ``block_window`` passes each
    block the layer's window, not the window from its own first attended
    row."""
    from repro_torch.launch import shardings
    from repro_torch.models import layers
    if fault == "rope_before_gather":
        def rope_first(y, heads, positions, cfg, mesh):
            b, s = y.shape[:2]
            y = layers.apply_rope(y[:, :, None], positions,
                                  cfg.rope_theta)[:, :, 0]
            return layers.tp_gather(y, heads * cfg.d_head, mesh).reshape(
                b, s, heads, cfg.d_head)
        layers._rotated_heads = rope_first
    elif fault == "rows_swapped":
        def next_rows(s, mesh):
            m = mesh.shape["model"]
            return shardings.position_blocks(s, m)[
                (mesh.coord("model") + 1) % m]
        layers._query_blocks = next_rows
    elif fault == "merge_mean":
        layers.merge_blocks = lambda outs, lses: outs.mean(0)
    else:
        layers.block_window = lambda valid, offset, rows, window: (
            min(max(valid - offset, 0), rows), window)


_BLOCK_FAULTS = ("replicate_own_head", "mla_merge_mean", "rows_next_rank")


def _plant_block_fault(fault: str, real: tuple) -> None:
    """One of the faults of the caches split by ``T``, patched into
    ``layers`` (``real``: ``_kv_rows``, ``_merge_heads``,
    ``_block_slots``, restored by the caller): ``replicate_own_head``
    writes a KV-replication block with the rank's own kv head in every
    head; ``mla_merge_mean`` merges MLA's blocks by a plain mean of their
    contexts; ``rows_next_rank`` has rank ``r`` write into its block the
    rows of rank ``r + 1``'s."""
    from repro_torch.core import meshops
    from repro_torch.models import layers
    if fault == "replicate_own_head":
        def own_head(p, x, positions, k, v):
            n = p.cfg.n_kv_heads
            return (k.expand(-1, -1, n, -1), v.expand(-1, -1, n, -1))
        layers._kv_rows = own_head
    elif fault == "mla_merge_mean":
        def mean(ctx, lse, mesh):
            b, h, r = ctx.shape
            n = mesh.shape["model"]
            part = meshops.psum_scatter(ctx.transpose(0, 1).reshape(-1),
                                        mesh, ("model",))
            return (part.view(h // n, b, r) / n).transpose(0, 1)
        layers._merge_heads = mean
    else:
        def next_rank(cache, t, s, blocks=1):
            if "t0" not in cache:
                return real[2](cache, t, s, blocks)
            return real[2](dict(cache, t0=(cache["t0"] + t) % (t * blocks)),
                           t, s, blocks)
        layers._block_slots = next_rank


_MIXER_FAULTS = ("mamba_xz_block", "bcdt_no_sum", "mamba_no_sum",
                 "mlstm_norm_local", "slstm_no_sum")


def _plant_mixer_fault(fault: str, cfg, real: tuple) -> None:
    """One of the mixers' planted faults, patched into ``hybrid`` or
    ``ssm`` (``real`` the originals, restored by the caller):
    ``mamba_xz_block`` takes ``w_in``'s contiguous block of the rank as
    its ``x`` and ``z``; ``bcdt_no_sum`` and ``mamba_no_sum`` skip the sum
    of ``w_bcdt``'s ``[.., 2n + 1]`` and ``w_out``'s ``[.., d]`` partial
    products; ``mlstm_norm_local`` norms the mLSTM output over the rank's
    columns before ``w_down``; ``slstm_no_sum`` skips the sLSTM
    ``w_down`` sum."""
    import sys

    from repro_torch.models import hybrid, layers, ssm
    tp_sum = real[0]
    if fault == "mamba_xz_block":
        hybrid._x_and_z = lambda p, x, di, c, mesh: (x @ p.w_in).chunk(
            2, dim=-1)
    elif fault in ("bcdt_no_sum", "mamba_no_sum"):
        skip = 2 * cfg.ssm.state_dim + 1 if fault == "bcdt_no_sum" \
            else cfg.d_model
        hybrid.tp_sum = lambda x, mesh: x if x.shape[-1] == skip \
            else tp_sum(x, mesh)
    elif fault == "mlstm_norm_local":
        def local_norm(p, cfg_, out, zg, dtype, mesh=None):
            rows = p.w_down.shape[0]
            cols = slice(mesh.coord("model") * rows,
                         (mesh.coord("model") + 1) * rows)
            y = layers.rms_norm(out[..., cols].to(dtype), p.norm[cols],
                                cfg_.norm_eps) * ssm.silu(zg[..., cols])
            return tp_sum(y @ p.w_down, mesh)
        ssm._mlstm_out = local_norm
    else:
        def no_slstm_sum(w_down, y, mesh):
            if sys._getframe(1).f_code.co_name != "slstm_forward":
                return real[8](w_down, y, mesh)
            return layers.tp_block(y, w_down.shape[0], mesh) @ w_down
        ssm._down = no_slstm_sum


def _next_rank_heads(model, whole, mesh) -> None:
    """The planted fault ``wkv_b_offset``: each MLA layer's ``wkv_b`` shard
    replaced by the columns of the next ``model`` rank's heads (its own
    block of rows)."""
    from repro_torch.launch import shardings
    for i in range(len(model.blocks)):
        name = f"blocks.{i}.attn.wkv_b"
        p, w = model.get_parameter(name), whole.get_parameter(name)
        rows, cols = shardings.shard_slices(model.specs[name], w.shape, mesh)
        n = cols.stop - cols.start
        first = (cols.start + n) % w.shape[1]
        p.data = w[rows, first:first + n].clone()
