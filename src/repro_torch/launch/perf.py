"""Perf-iteration harness: count one cell with knob overrides, print the
roofline terms and the top byte (or FLOP) contributors.

Counterpart of ``repro.launch.perf``.  Where the reference lowers the cell
and walks its HLO, this runs the cell's step once on meta stand-ins under
the dry run's counter (:mod:`repro_torch.launch.dryrun`); an op of the
top list is its name and its inputs' shapes, with its calls, tagged
``[flash]`` inside the plain blocked attention (the counterpart of
``top_items``' ``flash_xla``).

    PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3-405b \\
        --shape train_4k [--multi-pod] [--n-micro 8] [--block-kv 4096] \\
        [--dispatch teshu] [--no-remat] [--top 12]

Each invocation = one hypothesis test: change a knob, count again, diff the
terms.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import Recipe, recipe_for


def run(arch: str, shape: str, *, multi_pod: bool, recipe: Recipe,
        block_q=None, block_kv=None, top: int = 12, label: str = "",
        smoke: bool = False) -> dict:
    from repro_torch.models.blocked_attention import set_block_defaults
    set_block_defaults(block_q, block_kv)
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="meta")
            out: list = []
            row = run_cell(arch, shape, mesh, verbose=False, smoke=smoke,
                           recipe=recipe, counts_out=out)
    finally:
        set_block_defaults(None, None)
    counts = out[0]
    print(f"\n=== {label or 'cell'}: {arch} x {shape} on {row['mesh']} ===")
    print(f"  compute    {row['compute_s']*1e3:12.1f} ms")
    print(f"  memory     {row['memory_s']*1e3:12.1f} ms   "
          f"(kernel-adjusted {row['memory_s_kernel']*1e3:.1f} ms)")
    print(f"  collective {row['collective_s']*1e3:12.1f} ms   "
          f"(ici {row['ici_gb']:.1f} GB, dcn {row['dcn_gb']:.2f} GB per rank)")
    print(f"  dominant={row['dominant']}  mfu={row['mfu']:.3f}  "
          f"model/counted flops={row['model_flops_ratio']:.3f}  "
          f"counted flops={counts.flops:.4e}  hbm={row['hbm_gb']:.1f} "
          f"GB/rank")
    print("  top traffic items:")
    for nbytes, calls, name, shapes, flash in counts.top(top):
        tag = " [flash]" if flash else ""
        print(f"    {nbytes/1e12:9.4f} TB x{calls:7d} {name:24s} "
              f"{str(shapes)[:60]}{tag}")
    row["top"] = [{"bytes": b, "calls": c, "op": n, "shapes": str(s),
                   "flash": f} for b, c, n, s, f in counts.top(top)]
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--shape", choices=tuple(SHAPES), required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--moment-dtype", default=None)
    ap.add_argument("--accum-dtype", default=None)
    ap.add_argument("--dispatch", default=None)
    ap.add_argument("--factored-v", action="store_true")
    ap.add_argument("--fsdp-pod", action="store_true",
                    help="extend parameter FSDP over the pod axis (ZeRO "
                         "across the network between nodes)")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--block-q", type=int, default=None)
    ap.add_argument("--block-kv", type=int, default=None)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--label", default="")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    base = recipe_for(args.arch, SHAPES[args.shape])
    changes = {}
    if args.n_micro is not None:
        changes["n_micro"] = args.n_micro
    if args.moment_dtype:
        changes["moment_dtype"] = args.moment_dtype
    if args.accum_dtype:
        changes["accum_dtype"] = args.accum_dtype
    if args.dispatch:
        changes["dispatch"] = args.dispatch
    if args.factored_v:
        changes["factored_v"] = True
    if args.no_remat:
        changes["remat"] = False
    recipe = dataclasses.replace(base, **changes)
    from repro_torch.launch.shardings import fsdp_axes, set_fsdp_axes
    before = fsdp_axes()
    if args.fsdp_pod:
        set_fsdp_axes(("pod", "data"))
    try:
        row = run(args.arch, args.shape, multi_pod=args.multi_pod,
                  recipe=recipe, block_q=args.block_q,
                  block_kv=args.block_kv, top=args.top, label=args.label)
    finally:
        set_fsdp_axes(before)
    if args.json_out:
        row["label"] = args.label
        row["recipe"] = dataclasses.asdict(recipe)
        row["block_q"], row["block_kv"] = args.block_q, args.block_kv
        with open(args.json_out, "a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
