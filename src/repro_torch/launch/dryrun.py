"""Dry run: count every (arch x shape x mesh) cell's step on one rank.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's jitted step over 512 placeholder devices and reads the
compiled module.  Torch has no HLO: here each cell's step
(:func:`repro_torch.launch.steps.build_cell`) *runs*, once, on rank 0 of a
fake world (``torch.distributed``'s ``"fake"`` backend: collectives move
nothing) of 256 ranks (512 with ``--multi-pod`` or ``--both-meshes``), on
meta tensors (shapes and dtypes, no data: nothing is allocated on any
device), inside :class:`~repro_torch.launch.op_analysis.OpCounter`, and
the counts become the roofline terms (:mod:`repro_torch.launch.roofline`).
Per cell::

    cell = build_cell(arch, shape, mesh)          # meta stand-ins, placed
    args = local_args(cell)                       # each rank's own tensors
    with OpCounter(args=args) as counts:
        cell.fn(*args)
    row = analyze(counts, ...).row()

The step gets its stand-ins' local tensors: the model's leaves are the
rank's shards already; each ``DTensor`` stand-in gives its ``to_local()``
(the batch's rows are this rank's ``data.rank_rows``, whose order meta
tensors do not hold; the moments laid out as their parameters, as
``init_opt_state`` lays them out); a decode cell's cache is made in the
port's own layout (its batch split over ``("pod", "data")``, and the
rank's kv heads where its attention splits them over ``model``: ``kvh /
m``; every kv head of the rank's block of ``T`` under KV replication and
where the layer splits by positions, as the reference's stand-ins split
``T``; all of them where the layer runs whole; an MLA layer's latent and
rope key of the rank's block of ``T``, where the reference's split the
latent's ``r`` over ``model``: the same bytes), filled to ``seq_len - 1``
positions so that the step attends over ``seq_len`` (the decode's
gathers of ``q`` and its merges of the blocks are counted with the other
collectives).  A cell whose step raises is a failed cell.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod   # 2x16x16 mesh
    PYTHONPATH=src python -m repro_torch.launch.dryrun --out runs/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke       # SMOKE configs

Cells are counted ``--jobs`` at a time (default: the host's cores, at most
8), each in a process of its own with its own fake world; ``--jobs 1``
counts them one after another in this process.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.launch.roofline import NVLINK_DOMAIN, analyze
from repro_torch.launch.steps import build_cell
from repro_torch.models import lm


@contextlib.contextmanager
def fake_world(size: int):
    """Rank 0 of a fake world of ``size`` ranks for the block: one is made
    (and destroyed after) unless a fake world of at least ``size`` ranks
    is there; a real world refuses."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the dry run runs on a fake world, not on a "
                               f"{dist.get_backend()} one")
        if dist.get_world_size() >= size:
            yield
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _to_local(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.to_local()
    if isinstance(x, dict):
        return {k: _to_local(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_local(v) for v in x]
    return x


def _moments_like(model, moments: dict) -> dict:
    """Each moment laid out as its parameter (a factored ``{"r", "c"}``
    as it is)."""
    out = {}
    for n, t in moments.items():
        p = model.get_parameter(n)
        out[n] = torch.empty_like(p, dtype=t.dtype) \
            if isinstance(t, torch.Tensor) and t.shape == p.shape else t
    return out


def local_args(cell, *, cache_len: int | None = None) -> tuple:
    """This rank's arguments of ``cell.fn`` (see the module's docstring);
    a decode cell's cache holds ``cache_len`` positions (default
    ``seq_len - 1``)."""
    kind = cell.shape.kind
    model = cell.args[0]
    if kind == "train":
        opt = _to_local(cell.args[1])
        opt = dict(opt, m=_moments_like(model, opt["m"]),
                   v=_moments_like(model, opt["v"]))
        return model, opt, _to_local(cell.args[2])
    if kind == "prefill":
        return model, _to_local(cell.args[1])
    batch = _to_local(cell.args[2])
    rows = next(iter(batch.values())).shape[0]
    length = cell.shape.seq_len - 1 if cache_len is None else cache_len
    cache = lm.init_cache(cell.cfg, rows, cell.shape.seq_len, device="meta",
                          mesh=cell.mesh, specs=model.specs)
    cache["pos"] = length
    for layer in cache["layers"]:
        for sub in (layer, layer.get("attn", {})):
            if "len" in sub:
                sub["len"] = length
    return model, cache, batch


def count_cell(cell, args, *, boundary: int = NVLINK_DOMAIN) -> OpCounter:
    """``cell.fn(*args)`` once inside a fresh counter; the counter."""
    with OpCounter(boundary=boundary, args=args) as counts:
        out = cell.fn(*args)
        counts.output_bytes = counts.live_bytes
    del out
    return counts


def run_cell(arch: str, shape_name, mesh, *, verbose: bool = True,
             smoke: bool = False, recipe=None, use_kernel: bool = True,
             counts_out: list | None = None) -> dict:
    """The roofline row of one cell (``status`` ok), with ``trace_s`` (the
    seconds to build and run it) in place of the reference's ``lower_s``
    and ``compile_s`` and the memory a rank holds; ``counts_out`` (a list)
    gets the counter."""
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, smoke=smoke, recipe=recipe,
                      use_kernel=use_kernel)
    counts = count_cell(cell, local_args(cell))
    trace_s = time.time() - t0
    if counts_out is not None:
        counts_out.append(counts)
    roof = analyze(counts, arch=arch, shape=cell.shape, mesh=mesh,
                   cfg=cell.cfg)
    row = roof.row()
    row.update({"status": "ok", "trace_s": round(trace_s, 2),
                "memory": counts.memory, "kernels": counts.kernel_calls})
    if verbose:
        print(f"    memory: {counts.memory}")
        print(f"    counts: flops/rank={counts.flops:.3e} "
              f"bytes/rank={counts.hbm_bytes:.3e} kernels="
              f"{counts.kernel_calls}")
        print(f"    roofline: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"dominant={roof.dominant} mfu={roof.mfu:.3f}")
    return row


def _cell_job(arch: str, shape_name: str, multi_pod: bool,
              smoke: bool) -> tuple[dict, str, str | None]:
    """One cell in a process of its own: ``(row, its printed lines, the
    traceback if it failed)``."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), \
                fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="meta")
            return run_cell(arch, shape_name, mesh, smoke=smoke), \
                buf.getvalue(), None
    except Exception as e:
        return {"error": str(e)[:500]}, buf.getvalue(), \
            traceback.format_exc()


def _write(path: str | None, rows: list[dict]) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS, action="append", default=None,
                    help="this arch (repeat for several; default: all)")
    ap.add_argument("--shape", choices=tuple(SHAPES), action="append",
                    default=None,
                    help="this shape (repeat for several; default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 (pod,data,model) mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run every cell on single-pod AND multi-pod meshes")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's SMOKE config (the shapes unchanged)")
    ap.add_argument("--jobs", type=int, default=min(8, os.cpu_count() or 1),
                    help="cells counted at once, one process each (1: all "
                         "in this process)")
    ap.add_argument("--out", default=None, help="write JSON lines here")
    args = ap.parse_args(argv)

    archs = args.arch or list(ARCHS)
    shapes = args.shape or list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results, failures = [], []
    t_all = time.time()
    cells = []
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape_name in shapes:
                cells.append((arch, shape_name, multi_pod, mesh_name))
    pool = None
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(args.jobs, mp_context=multiprocessing
                                   .get_context("spawn"))
    try:
        jobs = {c: pool.submit(_cell_job, c[0], c[1], c[2], args.smoke)
                for c in cells if pool and shape_applicable(c[0], c[1])}
        for arch, shape_name, multi_pod, mesh_name in cells:
            if not shape_applicable(arch, shape_name):
                print(f"[skip] {arch} x {shape_name} (full attention at "
                      "500k)")
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": mesh_name, "status": "skip"})
                continue
            print(f"[cell] {arch} x {shape_name} on {mesh_name} ...",
                  flush=True)
            key = (arch, shape_name, multi_pod, mesh_name)
            row, printed, tb = jobs[key].result() if pool else _cell_job(
                arch, shape_name, multi_pod, args.smoke)
            print(printed, end="", flush=True)
            if tb is None:
                results.append(row)
            else:
                print(tb, file=sys.stderr, flush=True)
                failures.append((arch, shape_name, mesh_name,
                                 row["error"][:200]))
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": mesh_name, "status": "fail",
                                "error": row["error"]})
            _write(args.out, results)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    _write(args.out, results)             # the rows after the last cell too

    ok = sum(1 for r in results if r.get("status") == "ok")
    skip = sum(1 for r in results if r.get("status") == "skip")
    print(f"\n=== dry-run: {ok} ok, {skip} skipped, {len(failures)} failed "
          f"({time.time() - t_all:.1f} s) ===")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
