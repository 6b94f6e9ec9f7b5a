"""Render the dry run's JSON lines into roofline tables, one a mesh.

Counterpart of ``repro.launch.report``: the same columns, for rows of
either package (``repro_torch.launch.dryrun --out`` or the reference's).

    PYTHONPATH=src python -m repro_torch.launch.report runs/dryrun.jsonl
"""
from __future__ import annotations

import json
import sys


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def bottleneck_note(r: dict) -> str:
    d = r["dominant"]
    if d == "compute":
        return "compute-bound: gains need flop cuts (remat policy, causal skip)"
    if d == "memory":
        if r.get("memory_s_kernel", r["memory_s"]) < 0.5 * r["memory_s"]:
            return "the plain attention's traffic; the flash kernel removes it"
        return "HBM streaming: fuse/reuse or cut activation traffic"
    return "collective-bound: reshard, overlap, or compress the dominant op"


def render(rows: list[dict]) -> str:
    out = []
    hdr = ("| arch | shape | mesh | compute | memory | mem(kernel) | "
           "collective | dominant | MFU | model/HLO | HBM GB | note |")
    sep = "|" + "---|" * 12
    out.append(hdr)
    out.append(sep)
    for r in rows:
        if r.get("status") == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"— | — | — | — | skip (full attention @500k) | | | | |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"FAIL | | | | | | | | {r.get('error','')[:40]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r.get('memory_s_kernel', r['memory_s']))} "
            f"| {fmt_s(r['collective_s'])} "
            f"| {r['dominant']} "
            f"| {r['mfu']:.3f} "
            f"| {r['model_flops_ratio']:.2f} "
            f"| {r.get('hbm_gb', 0):.1f} "
            f"| {bottleneck_note(r)} |")
    return "\n".join(out)


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "runs/dryrun_matrix.json"
    rows = [json.loads(l) for l in open(path)]
    by_mesh: dict[str, list] = {}
    for r in rows:
        by_mesh.setdefault(r["mesh"], []).append(r)
    for mesh, mrows in by_mesh.items():
        print(f"\n### Mesh {mesh}\n")
        print(render(mrows))


if __name__ == "__main__":
    main()
