"""Time the two served models' prefill and greedy decode on the card (a
development script: not part of the package or its tests).

    PYTHONPATH=src python dev/serve_timing.py [--repeats N] [--out FILE]
    PYTHONPATH=src python dev/serve_timing.py --arch deepseek-v2-236b:9 --mesh

It imports ``repro_torch`` from ``PYTHONPATH``, so the same script times
another checkout of the port (``PYTHONPATH=<checkout>/src``): run two
checkouts in turn in one call (A, B, B, A), since the decode loop is bound
by the host, which the card's machine shares.  It serves ``chip_smoke.py``'s
two configurations with random weights made on the card from seed 0:
Qwen2.5-14B at full width and depth, and Qwen3-MoE-235B-A22B at full width
with 12 of 94 layers (its experts as ``lm.init_lm`` makes them), each at
batch 4, 1,024-token prompts and 32 greedy tokens, after one warm-up
serve.  For each model and repeat it prints ``serve()``'s prefill seconds,
decode tokens/s and decode step ms, then their medians, with the card's
name and power limit.  ``--arch ARCH[:LAYERS]`` (repeatable) serves
those models instead, at full width with their depth cut to ``LAYERS``;
``--mesh`` serves them over a NCCL world of one rank
(``elastic_mesh(1, model_parallel=1)``, a file store under ``build/``),
each model made on that mesh (``serve(mesh=...)``, as ``chip_smoke.py``'s
EP serves).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import lm

SERVE = dict(batch=4, prompt_len=1024, gen_len=32, max_len=2048, seed=0)
MODELS = {"qwen2.5-14b": None, "qwen3-moe-235b-a22b": 12}   # arch: layers


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--arch", action="append", default=None,
                    metavar="ARCH[:LAYERS]")
    ap.add_argument("--mesh", action="store_true")
    args = ap.parse_args()
    models = MODELS if args.arch is None else {
        a.split(":")[0]: int(a.split(":")[1]) if ":" in a else None
        for a in args.arch}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import elastic_mesh
        store = Path(__file__).resolve().parents[1] / "build" / \
            "serve_timing_store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1, device_id=dev)
        mesh = elastic_mesh(1, model_parallel=1)
    try:
        lines = _time_models(models, dev, mesh, args.repeats)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            f.write(smi + "\n" + "\n".join(json.dumps(x) for x in lines) + "\n")


def _time_models(models: dict, dev, mesh, repeats: int) -> list:
    lines = []
    for arch, layers in models.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = lm.init_lm(cfg, seed=SERVE["seed"], device=dev, mesh=mesh)
        kw = dict(smoke=False, device=dev, params=params, mesh=mesh, **SERVE)
        serve(arch, **dict(kw, gen_len=2))          # warm (not counted)
        runs = []
        for _ in range(repeats):
            _, stats = serve(arch, **kw)
            runs.append(dict(prefill_s=stats.prefill_s,
                             decode_tokens_per_s=stats.tokens_per_s,
                             decode_step_ms=stats.decode_s / SERVE["gen_len"]
                             * 1e3))
        row = dict(arch=arch, layers=cfg.n_layers, mesh=mesh is not None,
                   runs=runs, median={key: statistics.median(
                       r[key] for r in runs) for key in runs[0]})
        print(json.dumps(row), flush=True)
        lines.append(row)
        del params, kw
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
