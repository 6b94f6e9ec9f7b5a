"""Runs the port over a mesh of gloo ranks and the reference over forced
host devices, for ``test_torch_meshops.py`` and ``test_torch_moe_ep.py``.

The reference side runs in one subprocess with
``--xla_force_host_platform_device_count`` set before jax is imported (jax
fixes its device count at first use), under ``shard_map`` on
``make_mesh((2, 2, 2), ("pod", "data", "model"))``; the port side in one
``torch.multiprocessing`` spawn of 8 gloo ranks that meet through a file
store.  Both read one ``.npz`` of numpy inputs made from a seed and write
their outputs to ``.npz`` files; every input is in-spec over all three
axes on its leading dimension, so every rank holds other data.  This
module imports neither jax nor torch at its top: the subprocess imports
jax, the ranks torch.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
AXES = ("pod", "data", "model")
MESH = (2, 2, 2)
FLAT_MESH = (2, 4, 1)                 # the same 8 ranks, model 1
WORLD = 8


def name(axes) -> str:
    return axes if isinstance(axes, str) else "+".join(axes)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def meshops_cases() -> list[tuple[str, str, dict, str]]:
    """``(name, op, arguments, input)`` for each collective case."""
    out = []
    for a in AXES:
        for s in (1, -1, 3):
            out.append((f"ring-{a}-{s}", "ring", dict(axis=a, shift=s), "x1"))
    for s in (1, -1, 3):                 # on an axis of 8: three perms
        out.append((f"ring8-{s}", "ring8", dict(shift=s), "x1"))
    for axes in ("pod", "data", "model", ("pod", "model"), ("model", "pod"),
                 AXES):
        for sp, ct in ((0, 0), (1, 1), (0, 1), (1, 0)):
            out.append((f"a2a-{name(axes)}-{sp}{ct}", "a2a",
                        dict(axes=axes, split=sp, concat=ct), "x8"))
    for outer, inner in (("pod", "model"), ("data", "model"),
                         ("model", "pod")):
        out.append((f"two_level-{outer}-{inner}", "two_level",
                    dict(outer=outer, inner=inner), "x22"))
    for inner, outer, comp in (("data", "pod", False), ("model", None, False),
                               ("data", "model", False),
                               ("data", "pod", True), ("model", "pod", True)):
        out.append((f"hier-{inner}-{outer}-{comp}", "hier",
                    dict(inner=inner, outer=outer, compress=comp), "xs"))
    for axes in (AXES, ("data",), ("pod", "model")):
        out.append((f"flat-{name(axes)}", "flat", dict(axes=axes), "xs"))
    for mode, comp in (("flat", False), ("hier", False), ("hier", True)):
        out.append((f"grad_sync-{mode}-{comp}", "grad_sync",
                    dict(mode=mode, compress=comp), "grads"))
    return out


def meshops_inputs(seed: int) -> dict[str, np.ndarray]:
    """Global inputs, the leading dimension split over the 8 ranks."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"x1": f32(8, 5, 3), "x8": f32(64, 8, 3), "x22": f32(16, 2, 5, 3),
            "xs": f32(8, 7, 5) * np.exp(f32(8, 7, 5)),   # 35: pads on 2
            "g_w": f32(8, 7, 5), "g_b": f32(8, 3)}


# ---------------------------------------------------------------------------
# the reference: one subprocess over forced host devices
# ---------------------------------------------------------------------------

def start_reference(func: str, args: dict, devices: int,
                    xla_flags: str = "") -> subprocess.Popen:
    """Start ``mesh_ranks.<func>(**args)`` in a subprocess that sees
    ``devices`` host devices (and ``xla_flags``); :func:`finish` waits for
    it."""
    code = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = \
            "--xla_force_host_platform_device_count={devices} {xla_flags}"
        sys.path.insert(0, {str(REPO / "tests")!r})
        import mesh_ranks
        mesh_ranks.{func}(**{args!r})
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc: subprocess.Popen, timeout: float) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"reference failed:\n{err[-4000:]}"
    return out


def _ref_mesh():
    from repro.launch.mesh import make_mesh
    return make_mesh(MESH, AXES)


def _shard(fn, mesh, x, spec_axes=AXES):
    import jax

    from repro.compat import P, shard_map
    spec = P(spec_axes)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                             check_vma=False))(x)


def reference_meshops(inputs: str, out: str) -> None:
    """Every case of :func:`meshops_cases` on the reference, and
    ``elastic_mesh(n, model_parallel, pod_size).shape`` over a grid."""
    import jax

    from repro.core import meshops
    from repro.launch.mesh import elastic_mesh, make_mesh
    data = dict(np.load(inputs))
    mesh, mesh8 = _ref_mesh(), make_mesh((8,), ("ring",))
    res = {}
    for nm, op, kw, inp in meshops_cases():
        if op == "ring":
            got = _shard(lambda x: meshops.ring_exchange(
                x, kw["axis"], kw["shift"]), mesh, data[inp])
        elif op == "ring8":
            got = _shard(lambda x: meshops.ring_exchange(
                x, "ring", kw["shift"]), mesh8, data[inp], "ring")
        elif op == "a2a":
            got = _shard(lambda x: meshops.all_to_all_axis(
                x, kw["axes"], kw["split"], kw["concat"]), mesh, data[inp])
        elif op == "two_level":
            got = _shard(lambda x: meshops.two_level_all_to_all(
                x, kw["outer"], kw["inner"]), mesh, data[inp])
        elif op == "hier":
            got = _shard(lambda x: meshops.hier_psum(
                x, kw["inner"], kw["outer"], compress_outer=kw["compress"]),
                mesh, data[inp])
        elif op == "flat":
            got = _shard(lambda x: meshops.flat_psum(x, kw["axes"]), mesh,
                         data[inp])
        else:
            got = _shard(lambda g: meshops.grad_sync(
                g, inner_axis="data", outer_axis="pod", mode=kw["mode"],
                compress_outer=kw["compress"]), mesh,
                {"w": data["g_w"], "n": {"b": data["g_b"]}})
            res[f"{nm}|w"] = np.asarray(got["w"])
            got = got["n"]["b"]
            nm = f"{nm}|n.b"
        res[nm] = np.asarray(got)
    np.savez(out, **res)
    shapes = []
    for mp in (1, 2, 4, 16):
        for ps in (8, 16, 256):
            for n in range(16, 65):
                try:
                    shape = list(elastic_mesh(n, model_parallel=mp,
                                              pod_size=ps).shape.items())
                except ValueError:
                    shape = "ValueError"
                shapes.append([n, mp, ps, shape])
    Path(out).with_suffix(".json").write_text(json.dumps(
        {"elastic": shapes, "devices": len(jax.devices())}))


def moe_config(pkg, dispatch: str, dtype: str, capacity_factor: float):
    """The 1-layer MoE config of ``test_distributed.py``'s dispatch test,
    from package ``pkg``'s ``models.config``."""
    return pkg.ModelConfig(
        name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
        n_kv_heads=2, d_head=16, d_ff=64, vocab=64, dtype=dtype,
        remat=False, moe=pkg.MoEConfig(num_experts=8, top_k=2,
                                       d_ff_expert=32, dispatch=dispatch,
                                       capacity_factor=capacity_factor))


def expert_rows(cfg, mesh) -> tuple[int, int]:
    """``(first, count)`` of the routed experts a rank holds: the expert
    axis of their spec's block."""
    from repro_torch.launch import shardings
    shape = (cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    spec = shardings.leaf_spec(f"blocks.{cfg.n_layers - 1}.moe.experts.w_up",
                               shape, mesh, cfg)
    rows = shardings.shard_slices(spec, shape, mesh)[0]
    return rows.start, rows.stop - rows.start


def unflatten(flat: dict, prefix: str) -> dict:
    """``{"a|b|c": v}`` -> ``{"a": {"b": {"c": v}}}`` for the keys under
    ``prefix|``."""
    tree: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "|"):
            continue
        *path, leaf = k[len(prefix) + 1:].split("|")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def reference_moe(inputs: str, out: str, cases: list, serve_kw: dict,
                  arch: str, archs: tuple = ()) -> None:
    """``moe_ffn`` on each case under ``jax.jit`` with the EP axes ``("pod",
    "model")``, and the serving loop over the mesh
    (:func:`_reference_serve`) for ``arch`` (under ``serve``) and each of
    ``archs`` (under ``serve-<arch>``); for each served model every
    device's bytes of each leaf placed by ``param_specs``
    (``bytes-<arch>|<path>``, one count a device)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.shardings import (_path_str, param_specs, to_named)
    from repro.models import config as rconfig
    from repro.models.moe import moe_ffn
    data = dict(np.load(inputs))
    mesh = _ref_mesh()
    res = {}
    for case in cases:
        nm, dispatch, dtype, cf = case
        cfg = moe_config(rconfig, dispatch, dtype, cf)
        dt = jnp.dtype(dtype)
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), unflatten(data, nm))
        x = jnp.asarray(data[f"{nm}|x"], dt)
        with mesh:
            y, aux = jax.jit(lambda p, x: moe_ffn(
                p, cfg, x, mesh_axes=("pod", "model")))(p, x)
        res[f"{nm}|y"] = np.asarray(y.astype(jnp.float32))
        res[f"{nm}|aux"] = np.asarray(aux)
    devices = list(mesh.devices.flat)
    for a, key in [(arch, "serve")] + [(a, f"serve-{a}") for a in archs]:
        params = unflatten(data, key)
        gen, logits = _reference_serve(a, params, mesh, **serve_kw)
        res[f"{key}|tokens"], res[f"{key}|logits"] = gen, logits
        placed = jax.device_put(params, to_named(param_specs(
            params, mesh, get_config(a, smoke=True)), mesh))
        for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
            n = [0] * len(devices)
            for sh in leaf.addressable_shards:
                n[devices.index(sh.device)] += sh.data.nbytes
            res[f"bytes-{a}|{_path_str(path)}"] = np.array(n)
    np.savez(out, **res)


def _reference_serve(arch: str, params: dict, mesh, *, batch: int,
                     prompt_len: int, gen_len: int, max_len: int, seed: int,
                     cfg=None):
    """``repro.launch.serve.serve``'s loop over ``mesh`` with its EP axes,
    the parameters left unsharded: ``(tokens, last-position logits of
    the prefill and of each step)``; ``cfg`` (default ``arch``'s SMOKE
    config) a config of the reference's.  ``serve`` itself places the stacked
    blocks by ``param_specs``, and on a ``(2, 2, 2)`` mesh its logits for
    the rows of the (pod, data) groups (0, 1) and (1, 0) then differ from
    its own unsharded forward, with or without the EP dispatch; each leaf
    placed alone leaves them unchanged (jax 0.9.0 on the CPU)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.shardings import ep_axes_for
    from repro.models import lm
    cfg = cfg or get_config(arch, smoke=True)
    ep = ep_axes_for(mesh)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    with mesh:
        prefill = jax.jit(lambda p, t: lm.forward(
            p, cfg, tokens=t, cache=lm.init_cache(cfg, batch, max_len),
            ep_axes=ep)[:2])
        decode = jax.jit(lambda p, c, t: lm.serve_step(p, cfg, c, tokens=t,
                                                       ep_axes=ep))
        logits, cache = prefill(params, jnp.asarray(prompts))
        out, seen = [], [np.asarray(logits[:, -1])]
        for _ in range(gen_len):
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            out.append(np.asarray(tok))
            logits, cache = decode(params, cache, tok)
            seen.append(np.asarray(logits[:, -1]))
    return np.concatenate(out, axis=1), np.stack(seen)


# ---------------------------------------------------------------------------
# the port: one spawn of 8 gloo ranks
# ---------------------------------------------------------------------------

def run_ranks(job: str, tmp: Path, args: tuple, timeout: float
              ) -> list[dict]:
    """``job`` on :data:`WORLD` gloo ranks (a file store under ``tmp``);
    each rank's outputs as a dict, in rank order."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(WORLD, str(tmp), job, args),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job} ranks still running after "
                               f"{timeout} s")
    return [dict(np.load(tmp / f"{job}_{r}.npz")) for r in range(WORLD)]


def _rank_main(rank: int, world: int, tmp: str, job: str, args: tuple):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{job}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = {"meshops": _meshops_rank, "moe": _moe_rank}[job](*args)
        np.savez(f"{tmp}/{job}_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _block(x: np.ndarray, rank: int):
    import torch
    n = x.shape[0] // WORLD
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))


def _meshops_rank(inputs: str) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.core import meshops
    from repro_torch.launch.mesh import Mesh, make_mesh
    data = dict(np.load(inputs))
    r = dist.get_rank()
    mesh = make_mesh(MESH, AXES, device_type="cpu")
    mesh8 = make_mesh((8,), ("ring",), device_type="cpu")
    res = {}
    for nm, op, kw, inp in meshops_cases():
        if op == "grad_sync":
            got = meshops.grad_sync(
                {"w": _block(data["g_w"], r), "n": {"b": _block(data["g_b"],
                                                                r)}},
                mesh, inner_axis="data", outer_axis="pod", mode=kw["mode"],
                compress_outer=kw["compress"])
            res[f"{nm}|w"], res[f"{nm}|n.b"] = got["w"], got["n"]["b"]
            continue
        x = _block(data[inp], r)
        if op == "ring":
            got = meshops.ring_exchange(x, mesh, kw["axis"], kw["shift"])
        elif op == "ring8":
            got = meshops.ring_exchange(x, mesh8, "ring", kw["shift"])
        elif op == "a2a":
            got = meshops.all_to_all_axis(x, mesh, kw["axes"], kw["split"],
                                          kw["concat"])
        elif op == "two_level":
            got = meshops.two_level_all_to_all(x, mesh, kw["outer"],
                                               kw["inner"])
        elif op == "hier":
            got = meshops.hier_psum(x, mesh, kw["inner"], kw["outer"],
                                    compress_outer=kw["compress"])
        else:
            got = meshops.flat_psum(x, mesh, kw["axes"])
        res[nm] = got
    res = {k: v.numpy() for k, v in res.items()}
    res["coord"] = np.array([mesh.coord(a) for a in AXES])
    res["index-pod+model"] = np.array(mesh.index(("pod", "model")))
    for axes in (("pod", "model"), ("model", "pod"), AXES):
        res[f"group-{name(axes)}"] = np.array(mesh.group(axes).ranks)
    # a mesh over the first 4 of the 8 ranks (jax.devices()[:4]): every
    # rank builds it, the 4 inside sum over its "model" axis
    sub = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    if r < 4:
        res["prefix"] = np.array([sub.coord("data"), sub.coord("model"),
                                  int(meshops.flat_psum(torch.tensor(r), sub,
                                                        ("model",)))])
    else:
        try:
            sub.coord("data")
            res["prefix"] = np.array([0, 0, 0])
        except RuntimeError:
            res["prefix"] = np.array([-1, -1, -1])
    refused = []
    try:                                  # a cuda mesh over a gloo world
        Mesh(np.arange(WORLD).reshape(MESH), AXES, "cuda")
    except ValueError:
        refused.append("cuda mesh")
    try:                                  # a tensor off the mesh's device
        meshops.flat_psum(torch.empty(3, device="meta"), mesh, AXES)
    except ValueError:
        refused.append("meta tensor")
    res["refused"] = np.array(refused)
    return res


def _local_bytes(model) -> dict:
    return {n: p.numel() * p.element_size()
            for n, p in model.named_parameters()}


def _moe_rank(inputs: str, cases: list, serve_kw: dict, arch: str,
              archs: tuple = ()) -> dict:
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import config as pconfig
    from repro_torch.models import lm, moe
    from repro_torch.models.convert import lm_params_from_reference
    data = dict(np.load(inputs))
    mesh = make_mesh(MESH, AXES, device_type="cpu")
    ep = ("pod", "model")
    rows = mesh.index(("pod", "data"))
    res = {"rank": np.array(dist.get_rank())}

    def block(nm, cfg, dtype):
        """A lone MoE block holding this rank's experts (the EP slice the
        dispatch needs) and the router whole."""
        first, n = expert_rows(cfg, mesh)
        tree = unflatten(data, nm)
        b = moe.MoE(cfg, device="cpu")
        with torch.no_grad():
            b.router.copy_(torch.from_numpy(tree["router"]))
            for k, v in tree["experts"].items():
                getattr(b.experts, k).data = torch.from_numpy(
                    np.ascontiguousarray(v[first:first + n]))
        return b

    for nm, dispatch, dtype, cf in cases:
        cfg = moe_config(pconfig, dispatch, dtype, cf)
        dt = getattr(torch, dtype)
        b = block(nm, cfg, dt)
        x = data[f"{nm}|x"]
        per = x.shape[0] // mesh.axis_size(("pod", "data"))
        xr = torch.from_numpy(x[rows * per:(rows + 1) * per]).to(dt)
        y, aux = moe.moe_ffn(b, cfg, xr, mesh=mesh, mesh_axes=ep)
        res[f"{nm}|y"], res[f"{nm}|aux"] = y.float().numpy(), aux.numpy()
        if dispatch == "teshu2" and dtype == "float32" and cf > 1:
            # the control: the two-level stages over swapped axes
            real = moe._ep_shuffle

            def swapped(t, mesh_, axes, two_level):
                return real(t, mesh_, axes[::-1], two_level)
            moe._ep_shuffle = swapped
            try:
                y, _ = moe.moe_ffn(b, cfg, xr, mesh=mesh, mesh_axes=ep)
            finally:
                moe._ep_shuffle = real
            res[f"{nm}|swapped"] = y.float().numpy()
    # serving over the mesh with the parameters placed by their specs; the
    # same with every leaf but the routed experts replicated
    real_spec = shardings.leaf_spec

    def replicated(name, shape, mesh_, cfg):
        spec = real_spec(name, shape, mesh_, cfg)
        return spec if ".moe.experts." in name else (None,) * len(spec)
    # and both again on (2, 4, 1), whose model axis of 1 splits no dense
    # work: the placed run computes the replicated one's rows
    flat_mesh = make_mesh(FLAT_MESH, AXES, device_type="cpu")
    for a, key in [(arch, "serve")] + [(a, f"serve-{a}") for a in archs]:
        pcfg = get_config(a, smoke=True)
        model = lm_params_from_reference(pcfg, unflatten(data, key),
                                         device="cpu", mesh=mesh)
        res.update({f"bytes-{a}|{n}": np.array(v)
                    for n, v in _local_bytes(model).items()})
        if key == "serve":
            res["serve|w_up"] = model.blocks[0].moe.experts.w_up.numpy()
        gen, stats = serve(a, device="cpu", params=model, mesh=mesh,
                           **serve_kw)
        res[f"{key}|tokens"] = gen
        res[f"{key}|logits"] = torch.stack(stats.logits).numpy()
        for on, tag in ((mesh, ""), (flat_mesh, "flat-")):
            if on is flat_mesh:
                model = lm_params_from_reference(
                    pcfg, unflatten(data, key), device="cpu", mesh=on)
                gen, stats = serve(a, device="cpu", params=model, mesh=on,
                                   **serve_kw)
                res[f"{tag}placed-{a}|tokens"] = gen
                res[f"{tag}placed-{a}|logits"] = torch.stack(
                    stats.logits).numpy()
            shardings.leaf_spec = replicated
            try:
                model = lm_params_from_reference(
                    pcfg, unflatten(data, key), device="cpu", mesh=on)
            finally:
                shardings.leaf_spec = real_spec
            res[f"{tag}repl-{a}|placed"] = np.array(len(model._split))
            gen, stats = serve(a, device="cpu", params=model, mesh=on,
                               **serve_kw)
            res[f"{tag}repl-{a}|tokens"] = gen
            res[f"{tag}repl-{a}|logits"] = torch.stack(stats.logits).numpy()
    # init_lm under the mesh: each leaf this rank's shard of the full init
    pcfg = get_config(arch, smoke=True)
    cut = dataclasses.replace(pcfg, n_layers=1)
    mine = lm.init_lm(cut, seed=3, device="cpu", mesh=mesh)
    full = dict(lm.init_lm(cut, seed=3, device="cpu").named_parameters())
    first, n = expert_rows(cut, mesh)
    res["init|slice"] = np.array([first, n])
    res["init|same"] = np.array(all(
        torch.equal(p, full[k][shardings.shard_slices(
            mine.specs[k], full[k].shape, mesh)])
        for k, p in mine.named_parameters()))
    res["init|split"] = np.array(sorted(mine._split))
    return res
