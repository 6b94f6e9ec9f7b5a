"""Time the two served models' prefill and greedy decode on the card (a
development script: not part of the package or its tests).

    PYTHONPATH=src python dev/serve_timing.py [--repeats N] [--out FILE]

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
name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import lm

SERVE = dict(batch=4, prompt_len=1024, gen_len=32, max_len=2048, seed=0)
MODELS = {"qwen2.5-14b": None, "qwen3-moe-235b-a22b": 12}   # arch: layers


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    lines = []
    for arch, layers in MODELS.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = lm.init_lm(cfg, seed=SERVE["seed"], device=dev)
        kw = dict(smoke=False, device=dev, params=params, **SERVE)
        serve(arch, **dict(kw, gen_len=2))          # warm (not counted)
        runs = []
        for _ in range(args.repeats):
            _, stats = serve(arch, **kw)
            runs.append(dict(prefill_s=stats.prefill_s,
                             decode_tokens_per_s=stats.tokens_per_s,
                             decode_step_ms=stats.decode_s / SERVE["gen_len"]
                             * 1e3))
        row = dict(arch=arch, layers=cfg.n_layers, runs=runs, median={
            key: statistics.median(r[key] for r in runs) for key in runs[0]})
        print(json.dumps(row), flush=True)
        lines.append(row)
        del params, kw
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write(smi + "\n" + "\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
