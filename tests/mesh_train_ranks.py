"""Runs the port's training over a mesh of gloo ranks and the reference's
over forced host devices, for ``test_torch_train_mesh.py``.

The pattern of ``mesh_ranks.py``: the reference in one subprocess over 8
forced host devices, under ``with mesh:`` on ``make_mesh((2, 2, 2),
("pod", "data", "model"))`` with replicated parameters, its steps jitted;
the port in one ``torch.multiprocessing`` spawn of 8 gloo ranks (and one of
4 for the restore onto a smaller mesh) that meet through a file store, its
parameters and moments placed by the sharding rules (each rank's results
gathered whole before they are written).
Both read one ``.npz`` of numpy inputs made from seeds and write their
outputs to ``.npz`` files.  This module imports neither jax nor torch at
its top.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

from mesh_ranks import AXES, MESH, REPO, expert_rows, unflatten

ARCHS = ("deepseek-v2-236b", "qwen3-moe-235b-a22b")
# 8 rows of 30 tokens: at n_micro 1 a rank routes 30 tokens (2 rows over
# 2 model slices), 7.5 assignments an expert, so that the capacity at
# factor 1.0 (8) drops some and at 8.0 (64) none
B, S = 8, 30
CASES = [(f"{a}-{d}-{cf}-{nm}", a, d, cf, nm) for a in ARCHS
         for d in ("teshu", "teshu2") for cf in (8.0, 1.0) for nm in (1,)] + \
    [(f"{a}-teshu2-8.0-2", a, "teshu2", 8.0, 2) for a in ARCHS]
CONTROL_CASE = "deepseek-v2-236b-teshu2-8.0-1"
# remat (on in the full configs): the n_micro 2 cases with each block
# recomputed in the backward, held to the same reference gradients
REMAT_CASES = [c for c in CASES if c[4] == 2]
# the gspmd dispatch routes a rank's own rows: refused over the (2, 2, 2)
# mesh's four batch shards, and on (1, 1, 8), one batch shard, held to the
# port's mesh-free gradient of the whole batch, its aux loss included
GSPMD_MESH = (1, 1, 8)
GSPMD_CASES = [(f"gspmd-{a}-{cf}", a, cf) for a in ARCHS for cf in (8.0, 1.0)]
# three steps of the reference's test_train_step_under_mesh_runs_and_learns
STEPS = dict(arch="deepseek-v2-236b", n=3, n_micro=2,
             opt=dict(lr=1e-2, warmup_steps=1, total_steps=10))
# train(mesh=...): its history against a loop of the step on the
# pipeline's rows, and the rows against the reference's sharding
TRAIN = dict(arch="qwen3-moe-235b-a22b", steps=3, global_batch=8,
             seq_len=16, n_micro=2, lr=1e-2, seed=4)
# the restore onto another mesh: 6 steps on (2, 2, 2) at n_micro 1 with a
# checkpoint every 3, and steps 3-5 resumed on (1, 2, 2) at n_micro 2,
# whose microbatches route the same 8 groups of rows
CKPT = dict(arch="qwen3-moe-235b-a22b", steps=6, global_batch=8,
            seq_len=16, lr=1e-2, seed=5, ckpt_every=3)
SMALL = (1, 2, 2)
# placement against replication: n_micro 1, teshu2, capacity 8.0, on the
# (2, 2, 2) mesh (model 2: the placed run splits its dense work over model,
# the replicated one runs it whole) and on (2, 4, 1) (model 1: the same
# arithmetic in both)
PLACE_CASES = [(f"{a}-teshu2-8.0-1", a) for a in ARCHS]
PLACE_MESHES = (MESH, (2, 4, 1))


def place_key(tag: str, shape) -> str:
    """The result key of a placement run: ``tag`` on the (2, 2, 2) mesh,
    ``tag@2x4x1`` on another."""
    return tag if tuple(shape) == MESH else \
        f"{tag}@{'x'.join(map(str, shape))}"
# build_cell's stand-ins of the SMOKE cells
CELLS = ("train_4k", "prefill_32k", "decode_32k")


def moe_cfg(cfg, dispatch: str, cf: float):
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch, capacity_factor=cf))


def flat(tree: dict, prefix: str) -> dict:
    """``{"prefix|a|b": array}`` of a nested dict (``unflatten``'s
    inverse)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}|{k}"))
        else:
            out[f"{prefix}|{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the reference: one subprocess over 8 forced host devices
# ---------------------------------------------------------------------------

def start_reference(inputs: str, out: str) -> subprocess.Popen:
    code = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        sys.path.insert(0, {str(REPO / "tests")!r})
        import mesh_train_ranks
        mesh_train_ranks.reference_train({inputs!r}, {out!r})
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def reference_train(inputs: str, out: str) -> None:
    """The loss and every gradient of each case (``microbatch_grads`` of
    ``lm.train_loss`` with the mesh's EP axes, jitted under the mesh), the
    three steps of ``make_train_step`` with each step's gradients, and the
    microbatch-major sharding of the pipeline's batches."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticLMDataset
    from repro.launch.mesh import make_mesh
    from repro.launch.shardings import (_path_str, ep_axes_for, opt_v_specs,
                                        param_specs, to_named)
    from repro.launch.steps import Recipe, build_cell, make_train_step
    from repro.models import lm
    from repro.optim import AdamWConfig, init_opt_state, microbatch_grads
    data = dict(np.load(inputs))
    mesh = make_mesh(MESH, AXES)
    ep = ep_axes_for(mesh)
    res = {}

    def grads_fn(cfg, n_micro):
        return jax.jit(lambda p, b: microbatch_grads(
            lambda pp, bb: lm.train_loss(pp, cfg, bb, ep_axes=ep), p, b,
            n_micro))

    def inputs_of(arch):
        p = jax.tree.map(jnp.asarray, unflatten(data, f"p-{arch}"))
        b = {k: jnp.asarray(data[f"batch-{arch}|{k}"])
             for k in ("tokens", "labels")}
        return p, b

    with mesh:
        for nm, arch, dispatch, cf, n_micro in CASES:
            cfg = moe_cfg(get_config(arch, smoke=True), dispatch, cf)
            p, b = inputs_of(arch)
            loss, g = grads_fn(cfg, n_micro)(p, b)
            res[f"{nm}|loss"] = np.asarray(loss)
            res.update(flat(jax.tree.map(np.asarray, g), f"{nm}|g"))
        cfg = get_config(STEPS["arch"], smoke=True)
        p, b = inputs_of(STEPS["arch"])
        o = init_opt_state(p)
        step = jax.jit(make_train_step(cfg, AdamWConfig(**STEPS["opt"]), ep,
                                       Recipe(n_micro=STEPS["n_micro"])))
        gfn = grads_fn(cfg, STEPS["n_micro"])
        for i in range(STEPS["n"]):
            _, g = gfn(p, b)
            p, o, m = step(p, o, b)
            res.update(flat(jax.tree.map(np.asarray, g), f"step{i}|g"))
            res.update(flat(jax.tree.map(np.asarray, p), f"step{i}|p"))
            res.update(flat(jax.tree.map(np.asarray, o["v"]), f"step{i}|v"))
            for k, v in m.items():
                res[f"step{i}|{k}"] = np.asarray(v)
        cfg = get_config(TRAIN["arch"], smoke=True)
        ds = SyntheticLMDataset(DataConfig(
            vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
            global_batch=TRAIN["global_batch"], seed=TRAIN["seed"]))
        nmi = TRAIN["n_micro"]
        spec = NamedSharding(mesh, P(None, ("pod", "data")))
        for n in range(TRAIN["steps"]):
            for k, x in ds.batch_at(n).items():
                arr = jax.device_put(
                    x.reshape(nmi, x.shape[0] // nmi, *x.shape[1:]), spec)
                for r, dev in enumerate(mesh.devices.flat):
                    shard = next(s for s in arr.addressable_shards
                                 if s.device == dev)
                    res[f"rows|{n}|{r}|{k}"] = np.asarray(
                        shard.data).reshape(-1, *x.shape[1:])
    # each device's bytes of the parameters and moments placed by the
    # sharding rules (train()'s float32 moments)
    devices = list(mesh.devices.flat)
    cfg = get_config(TRAIN["arch"], smoke=True)
    p = unflatten(data, f"p-{TRAIN['arch']}")
    specs = param_specs(p, mesh, cfg)
    o = init_opt_state(p)
    o_specs = {"m": specs, "v": opt_v_specs(specs, p, False), "step": P()}
    for key, tree, sp in (("p", p, specs), ("o", o, o_specs)):
        placed = jax.device_put(tree, to_named(sp, mesh))
        for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
            n = [0] * len(devices)
            for sh in leaf.addressable_shards:
                n[devices.index(sh.device)] += sh.data.nbytes
            res[f"bytes|{key}|{_path_str(path)}"] = np.array(n)
    # build_cell's stand-ins: global shape, dtype and shard shape
    for arch in ARCHS:
        for shape in CELLS:
            cell = build_cell(arch, shape, mesh, smoke=True)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    cell.args)[0]:
                key = f"cell|{arch}|{shape}|{_path_str(path)}"
                res[f"{key}|global"] = np.array(leaf.shape)
                res[f"{key}|local"] = np.array(
                    leaf.sharding.shard_shape(leaf.shape))
                res[f"{key}|dtype"] = np.array(str(leaf.dtype))
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the port: spawns of gloo ranks
# ---------------------------------------------------------------------------

def run_ranks(job: str, tmp: Path, world: int, args: tuple,
              timeout: float) -> list[dict]:
    """``job`` on ``world`` gloo ranks (a file store under ``tmp``); each
    rank's outputs as a dict, in rank order."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), job, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job} ranks still running after "
                               f"{timeout} s")
    return [dict(np.load(tmp / f"{job}_{r}.npz")) for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str, job: str, args: tuple):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{job}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = {"train": _train_rank, "resume": _resume_rank}[job](*args)
        np.savez(f"{tmp}/{job}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _whole(x, spec, mesh):
    from repro_torch.launch import shardings
    return shardings.gather(x, shardings.gather_spec(spec, mesh), mesh)


def _named(model, mesh=None) -> dict:
    """Every parameter whole (gathered over the mesh it is placed on)."""
    import torch
    with torch.no_grad():
        return {n: (p if mesh is None else _whole(p, model.specs[n], mesh))
                .detach().numpy().copy()
                for n, p in model.named_parameters()}


def _mesh_grads(model, cfg, mesh, batch: dict, n_micro: int,
                pre: dict | None = None):
    """This rank's summed gradients, gathered whole, the global loss of
    one step's microbatches (the step without its update) and the
    collectives the step made (counted before the gathering).  Given
    ``pre``, it receives each gradient before the sums over ranks: a
    placed leaf's as its gather's backward receives it (the whole leaf's),
    any other as the microbatches leave it."""
    import torch

    from repro_torch.core import meshops
    from repro_torch.data import rank_rows
    from repro_torch.launch import shardings, steps
    from repro_torch.models import lm
    from repro_torch.optim import microbatch_grads
    params = dict(model.named_parameters())
    rows = {k: torch.from_numpy(rank_rows(v, mesh, n_micro))
            for k, v in batch.items()}
    real, names = shardings.gather, {id(p): n for n, p in params.items()}

    def capture(x, spec, mesh_):
        y = real(x, spec, mesh_)
        if y is not x and y.requires_grad:
            y.register_hook(lambda g, n=names[id(x)]: pre.__setitem__(
                n, g.detach().clone() + pre.get(n, 0)))
        return y
    if pre is not None:
        shardings.gather = capture
    try:
        loss, grads = microbatch_grads(
            lambda p, b: lm.train_loss(model, b, mesh=mesh), params, rows,
            n_micro)
    finally:
        shardings.gather = real
    if pre is not None:
        for n, g in grads.items():
            pre.setdefault(n, g.clone())
    grads = steps.sum_grads(grads, mesh, shardings.split_leaves(model.specs,
                                                                mesh))
    loss = meshops.flat_psum(loss, mesh, mesh.axis_names)
    counts = np.array([meshops.COUNTS[k] for k in meshops.KINDS])
    with torch.no_grad():
        whole = {n: _whole(g, model.specs[n], mesh).numpy()
                 for n, g in grads.items()}
    return float(loss), whole, counts


def _model_major(real):
    """The planted fault: a leaf split over ``data`` and ``model`` (on two
    dimensions) gathered as one tile a rank over ``("model", "data")``
    and laid out as if ``data`` were the major axis."""
    import torch

    from repro_torch.core import meshops

    def gather(x, spec, mesh):
        if sorted(a for e in spec if e for a in e) != ["data", "model"] \
                or any(e and len(e) > 1 for e in spec):
            return real(x, spec, mesh)
        tiles = meshops.all_gather(x[None], mesh, ("model", "data"), axis=0)
        d, m = mesh.shape["data"], mesh.shape["model"]
        grid = tiles.reshape(d, m, *x.shape)
        dd, dm = spec.index(("data",)), spec.index(("model",))
        return torch.cat([torch.cat(list(grid[i]), dim=dm)
                          for i in range(d)], dim=dd)
    return gather


def _sliced_backward(ctx, g):
    """The planted fault: a placed leaf's gradient kept as this rank's
    block of it, not reduce-scattered (``shardings._Gather``'s
    backward)."""
    spec, mesh = ctx.args
    for d in reversed(range(len(spec))):
        if spec[d]:
            n = g.shape[d] // mesh.axis_size(spec[d])
            g = g.narrow(d, mesh.index(spec[d]) * n, n)
    return g.contiguous(), None, None


def _experts_sliced(real, model):
    """``shardings.gather`` whose gathers of a routed expert (over
    ``data``) take :func:`_sliced_backward`: the experts' gradient sum
    over ``data`` skipped."""
    from repro_torch.launch import shardings

    class Sliced(shardings._Gather):
        backward = staticmethod(_sliced_backward)
    experts = {id(p) for n, p in model.named_parameters()
               if ".moe.experts." in n}

    def gather(x, spec, mesh):
        if id(x) in experts and any(spec):
            return Sliced.apply(x, spec, mesh)
        return real(x, spec, mesh)
    return gather


def _train_rank(inputs: str) -> dict:
    import dataclasses
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.data import DataConfig, SyntheticLMDataset, rank_rows
    from repro_torch.launch import shardings, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import moe
    from repro_torch.models.convert import lm_params_from_reference
    from repro_torch.optim import AdamWConfig, init_opt_state
    data = dict(np.load(inputs))
    mesh = make_mesh(MESH, AXES, device_type="cpu")
    res: dict = {"rank": np.array(dist.get_rank()),
                 "expert_slice": np.array(expert_rows(
                     get_config(ARCHS[0], smoke=True), mesh))}

    def model_of(arch, cfg, on=mesh):
        m = lm_params_from_reference(cfg, unflatten(data, f"p-{arch}"),
                                     device="cpu", mesh=on)
        return m.requires_grad_(True)

    def batch_of(arch):
        return {k: data[f"batch-{arch}|{k}"] for k in ("tokens", "labels")}

    def run_case(key, arch, cfg, n_micro, on=mesh):
        meshops.reset_counts()
        loss, g, counts = _mesh_grads(model_of(arch, cfg, on), cfg, on,
                                      batch_of(arch), n_micro)
        res[f"{key}|counts"] = counts
        res[f"{key}|loss"] = np.array(loss)
        res.update({f"{key}|g|{n}": v for n, v in g.items()})

    # the cases' gradients, with the collectives each one made
    for nm, arch, dispatch, cf, n_micro in CASES:
        run_case(nm, arch, moe_cfg(get_config(arch, smoke=True), dispatch,
                                   cf), n_micro)
    for nm, arch, dispatch, cf, n_micro in REMAT_CASES:
        run_case(f"remat-{nm}", arch, dataclasses.replace(moe_cfg(
            get_config(arch, smoke=True), dispatch, cf), remat=True), n_micro)
    # gspmd: refused over several batch shards, trained on one
    cfg = moe_cfg(get_config(ARCHS[1], smoke=True), "gspmd", 8.0)
    try:
        _mesh_grads(model_of(ARCHS[1], cfg), cfg, mesh, batch_of(ARCHS[1]), 1)
        res["gspmd|refused"] = np.array(False)
    except NotImplementedError:
        res["gspmd|refused"] = np.array(True)
    one_shard = make_mesh(GSPMD_MESH, AXES, device_type="cpu")
    for key, arch, cf in GSPMD_CASES:
        run_case(key, arch, moe_cfg(get_config(arch, smoke=True), "gspmd",
                                    cf), 1, one_shard)
    # the same at 8.0 with the aux loss zeroed, against the mesh-free
    # gradient of the global batch
    real = moe._route
    moe._route = lambda *a: (lambda e, w, aux: (e, w, aux * 0))(*real(*a))
    try:
        for arch in ARCHS:
            cfg = moe_cfg(get_config(arch, smoke=True), "teshu2", 8.0)
            loss, g, _ = _mesh_grads(model_of(arch, cfg), cfg, mesh,
                                     batch_of(arch), 1)
            res[f"noaux-{arch}|loss"] = np.array(loss)
            res.update({f"noaux-{arch}|g|{n}": v for n, v in g.items()})
    finally:
        moe._route = real
    # placement against replication: every leaf but the routed experts
    # replicated (a monkeypatched leaf_spec), the gradients before and
    # after the sums over ranks
    real_spec = shardings.leaf_spec

    def replicated(name, shape, mesh_, cfg_):
        spec = real_spec(name, shape, mesh_, cfg_)
        return spec if ".moe.experts." in name else (None,) * len(spec)
    place_meshes = {s: mesh if s == MESH else make_mesh(s, AXES,
                                                        device_type="cpu")
                    for s in PLACE_MESHES}
    for shape, on in place_meshes.items():
        for key, arch in PLACE_CASES:
            cfg = moe_cfg(get_config(arch, smoke=True), "teshu2", 8.0)
            for tag in ("placed", "replicated"):
                if tag == "replicated":
                    shardings.leaf_spec = replicated
                try:
                    model = model_of(arch, cfg, on)
                finally:
                    shardings.leaf_spec = real_spec
                pre: dict = {}
                loss, g, _ = _mesh_grads(model, cfg, on, batch_of(arch), 1,
                                         pre=pre)
                k = place_key(f"{tag}-{arch}", shape)
                res[f"{k}|loss"] = np.array(loss)
                res[f"{k}|split"] = np.array(len(model._split))
                res.update({f"{k}|g|{n}": v for n, v in g.items()})
                res.update({f"{k}|pre|{n}": v.numpy()
                            for n, v in pre.items()})

    # the controls: the experts' sum over data skipped (their gather's
    # reduce-scatter a slice); the dispatch's all-gather's backward a slice
    # of the gradient without the sum over model; every placed leaf
    # gathered with model major over data; every placed leaf's
    # reduce-scatter a slice
    arch = CONTROL_CASE.split("-teshu")[0]
    cfg = get_config(arch, smoke=True)
    cfg = moe_cfg(cfg, "teshu2", 8.0)
    back = shardings._Gather.backward
    real_gather = shardings.gather
    ag_back = meshops._AllGather.backward

    def ag_sliced(ctx, g):
        mesh_, axes, axis = ctx.args
        grp = mesh_.group(axes)
        front = g.movedim(axis, 0)
        n = front.shape[0] // grp.size
        return (front[grp.index * n:(grp.index + 1) * n].movedim(0, axis)
                .contiguous(), None, None, None)
    for control in ("no_data_sum", "no_gather_sum", "model_major",
                    "rs_slice"):
        model = model_of(arch, cfg)
        if control == "no_data_sum":
            shardings.gather = _experts_sliced(real_gather, model)
        elif control == "no_gather_sum":
            meshops._AllGather.backward = staticmethod(ag_sliced)
        elif control == "model_major":
            shardings.gather = _model_major(real_gather)
        else:
            shardings._Gather.backward = staticmethod(_sliced_backward)
        try:
            _, g, _ = _mesh_grads(model, cfg, mesh, batch_of(arch), 1)
        finally:
            shardings._Gather.backward = staticmethod(back)
            shardings.gather = real_gather
            meshops._AllGather.backward = staticmethod(ag_back)
        res.update({f"{control}|g|{n}": v for n, v in g.items()})

    # the prefill and serve step builders over the mesh, at 8.0
    from repro_torch.models.config import SHAPES
    cfg = moe_cfg(get_config(TRAIN["arch"], smoke=True), "teshu2", 8.0)
    model = model_of(TRAIN["arch"], cfg).requires_grad_(False)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=S + 1,
                                global_batch=B)
    rows = {"tokens": torch.from_numpy(rank_rows(
        batch_of(TRAIN["arch"])["tokens"], mesh))}
    last, cache = steps.make_prefill_step(cfg, shape, mesh=mesh)(model, rows)
    nxt, _ = steps.make_serve_step(cfg, mesh=mesh)(
        model, cache, {"tokens": rows["tokens"][:, :1]})
    res["prefill|last"], res["serve|next"] = last.numpy(), nxt.numpy()

    # three steps of make_train_step (the reference test's)
    cfg = get_config(STEPS["arch"], smoke=True)
    model = model_of(STEPS["arch"], cfg)
    opt = init_opt_state(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, AdamWConfig(**STEPS["opt"]),
                                 steps.Recipe(n_micro=STEPS["n_micro"]),
                                 mesh=mesh)
    rows = {k: torch.from_numpy(rank_rows(v, mesh, STEPS["n_micro"]))
            for k, v in batch_of(STEPS["arch"]).items()}
    for i in range(STEPS["n"]):
        _, opt, m = step(model, opt, rows)
        res.update({f"step{i}|p|{n}": v
                    for n, v in _named(model, mesh).items()})
        for k, v in m.items():
            res[f"step{i}|{k}"] = np.array(float(v))

    # one step with a factored second moment, placed and with every leaf
    # but the routed experts replicated: the moments' factors (gathered
    # whole) and the weights; and named_from_reference's shards
    # (on (2, 4, 1) at n_micro 1: its 8 batch shards take no microbatch
    # of 4 rows), with the replicated run's gradients of the step
    from repro_torch.models.convert import named_from_reference
    for shape, on in place_meshes.items():
        n_micro = STEPS["n_micro"] if shape == MESH else 1
        for tag in ("placed", "replicated"):
            if tag == "replicated":
                shardings.leaf_spec = replicated
            try:
                model = model_of(STEPS["arch"], cfg, on)
            finally:
                shardings.leaf_spec = real_spec
            if tag == "placed" and shape == MESH:
                res["named|same"] = np.array(all(
                    torch.equal(t, p) for t, p in zip(named_from_reference(
                        model, unflatten(data, f"p-{STEPS['arch']}"),
                        mesh=on).values(), model.parameters())))
            key = place_key(f"factored-{tag}", shape)
            if tag == "replicated":
                _, g, _ = _mesh_grads(model, cfg, on,
                                      batch_of(STEPS["arch"]), n_micro)
                res.update({f"{key}|g|{n}": v for n, v in g.items()})
            opt = init_opt_state(dict(model.named_parameters()),
                                 factored_v=True)
            step = steps.make_train_step(
                cfg, AdamWConfig(**STEPS["opt"], factored_v=True),
                steps.Recipe(n_micro=n_micro, factored_v=True), mesh=on)
            _, opt, _ = step(model, opt, {
                k: torch.from_numpy(rank_rows(v, on, n_micro))
                for k, v in batch_of(STEPS["arch"]).items()})
            res.update({f"{key}|p|{n}": v
                        for n, v in _named(model, on).items()})
            vspecs = shardings.opt_v_specs(model.specs, {
                n: shardings.global_shape(model.specs[n], p.shape, on)
                for n, p in model.named_parameters()}, True)
            with torch.no_grad():
                for n, v in opt["v"].items():
                    for k, t in (v.items() if isinstance(v, dict) else ()):
                        res[f"{key}|{k}|{n}"] = _whole(
                            t, vspecs[n][k], on).numpy()

    # train(mesh=...) against a loop of the step on the pipeline's rows
    kw = {k: v for k, v in TRAIN.items() if k != "arch"}
    cfg = get_config(TRAIN["arch"], smoke=True)
    out = train(TRAIN["arch"], device="cpu", mesh=mesh,
                params=model_of(TRAIN["arch"], cfg), **kw)
    res["train|loss"] = np.array([h["loss"] for h in out["history"]])
    res["train|grad_norm"] = np.array([h["grad_norm"]
                                       for h in out["history"]])
    res.update({f"train|p|{n}": v
                for n, v in _named(out["params"], mesh).items()})
    # the rank's bytes of train()'s parameters and moments
    res.update({f"tbytes|{k}|{n}": np.array(t.numel() * t.element_size())
                for k, tree in (("p", dict(out["params"].named_parameters())),
                                ("m", out["opt_state"]["m"]),
                                ("v", out["opt_state"]["v"]))
                for n, t in tree.items()})
    model = model_of(TRAIN["arch"], cfg)
    ocfg = AdamWConfig(lr=TRAIN["lr"], total_steps=max(TRAIN["steps"], 2),
                       warmup_steps=max(1, TRAIN["steps"] // 10))
    opt = init_opt_state(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, ocfg, steps.Recipe(
        n_micro=TRAIN["n_micro"], lr=TRAIN["lr"]), mesh=mesh)
    ds = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
        global_batch=TRAIN["global_batch"], seed=TRAIN["seed"]))
    losses = []
    for n in range(TRAIN["steps"]):
        rows = {k: rank_rows(v, mesh, TRAIN["n_micro"])
                for k, v in ds.batch_at(n).items()}
        res.update({f"rows|{n}|{k}": v for k, v in rows.items()})
        _, opt, m = step(model, opt, {k: torch.from_numpy(v)
                                      for k, v in rows.items()})
        losses.append(float(m["loss"]))
    res["loop|loss"] = np.array(losses)
    res.update({f"loop|p|{n}": v for n, v in _named(model, mesh).items()})

    # the uninterrupted run that the restore onto (1, 2, 2) resumes
    ck = {k: v for k, v in CKPT.items() if k != "arch"}
    ckdir = Path(inputs).parent / "ckpt"
    if dist.get_rank() == 0:
        shutil.rmtree(ckdir, ignore_errors=True)
    dist.barrier()
    cfg = get_config(CKPT["arch"], smoke=True)
    out = train(CKPT["arch"], device="cpu", mesh=mesh, n_micro=1,
                ckpt_dir=str(ckdir), params=model_of(CKPT["arch"], cfg), **ck)
    res["ckpt|loss"] = np.array([h["loss"] for h in out["history"]])

    # build_cell's stand-ins: each one's global shape, dtype and local shape
    for arch in ARCHS:
        for shape in CELLS:
            cell = steps.build_cell(arch, shape, mesh, smoke=True)
            model, rest = cell.args[0], cell.args[1:]
            key = f"cell|{arch}|{shape}"
            for n, p in model.named_parameters():
                res[f"{key}|params/{n}|global"] = np.array(
                    shardings.global_view(p, model.specs[n], mesh).shape)
                res[f"{key}|params/{n}|local"] = np.array(p.shape)
                res[f"{key}|params/{n}|dtype"] = np.array(
                    str(p.dtype).removeprefix("torch."))
            names = {"train": ("opt_state", "batch"), "prefill": ("batch",),
                     "decode": ("cache", "batch")}[cell.shape.kind]
            for name, tree in zip(names, rest):
                for path, t in _leaves(tree, name):
                    res[f"{key}|{path}|global"] = np.array(t.shape)
                    res[f"{key}|{path}|local"] = np.array(
                        t.to_local().shape)
                    res[f"{key}|{path}|dtype"] = np.array(
                        str(t.dtype).removeprefix("torch."))
    return res


def _leaves(tree, prefix: str):
    """``(path, DTensor)`` of a tree of stand-ins (integer leaves, a
    cache's ``pos`` and ``len``, left out)."""
    import torch
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _resume_rank(inputs: str, ckdir: str) -> dict:
    """On a ``(1, 2, 2)`` mesh (EP 2): the restore of the 8-rank run's
    step-3 checkpoint (a run of no step), then the resumed steps 3-5."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.convert import lm_params_from_reference
    data = dict(np.load(inputs))
    mesh = make_mesh(SMALL, AXES, device_type="cpu")
    cfg = get_config(CKPT["arch"], smoke=True)
    ck = {k: v for k, v in CKPT.items() if k not in ("arch", "steps")}
    res = {"rank": np.array(dist.get_rank()),
           "expert_slice": np.array(expert_rows(cfg, mesh))}

    def fresh():                   # any weights: the restore overwrites
        return lm_params_from_reference(cfg, unflatten(
            data, f"p-{CKPT['arch']}"), device="cpu", mesh=mesh)
    out = train(CKPT["arch"], device="cpu", mesh=mesh, n_micro=2,
                ckpt_dir=ckdir, params=fresh(), steps=3, **ck)
    assert out["history"] == []
    res.update({f"restored|p|{n}": v
                for n, v in _named(out["params"]).items()})
    res.update({f"restored|m|{n}": v.numpy()
                for n, v in out["opt_state"]["m"].items()})
    res.update({f"restored|v|{n}": v.numpy()
                for n, v in out["opt_state"]["v"].items()})
    res["restored|step"] = np.array(int(out["opt_state"]["step"]))
    out = train(CKPT["arch"], device="cpu", mesh=mesh, n_micro=2,
                ckpt_dir=ckdir, params=fresh(), steps=CKPT["steps"], **ck)
    res["resumed|loss"] = np.array([h["loss"] for h in out["history"]])
    return res
