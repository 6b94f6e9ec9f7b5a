"""``chip_smoke.py``'s dense serve phases alone on the card.

This runs only ``dense_serve_phase`` for the models named (the five of
``DENSE_SERVE`` by default, at its depths; ``ARCH:LAYERS`` sets a depth,
``qwen2.5-14b`` serves the dense serving slice as the smoke run does),
each phase's seconds after it.  ``--kernels`` first runs the trace phase
and the attention kernels' checks and times (every flash and decode case,
the dense models' shapes among them); ``--profile DIR`` traces each
model's prefill and 4 decode steps as the smoke run's ``--profile`` does:

    PYTHONPATH=src python dev/serve_dense.py [granite-34b pixtral-12b:40 ...] [--kernels] [--profile DIR]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*",
                    default=[f"{a}:{n}" for a, n in cs.DENSE_SERVE.items()])
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--profile", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_dense: torch finds no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.nvidia_smi_line())
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"build: {time.perf_counter() - t0:.2f} s")
    if args.kernels:
        t0 = time.perf_counter()
        rows = cs.attention_phase(dev, cs.trace_phase(dev))
        cs.log(f"kernel rows: {json.dumps(rows)}")
        cs.log(f"attention phase: {time.perf_counter() - t0:.2f} s")
    for spec in args.archs:
        arch, _, layers = spec.partition(":")
        t0 = time.perf_counter()
        cs.dense_serve_phase(dev, args.profile, arch,
                             int(layers) if layers else None)
        torch.cuda.empty_cache()
        cs.log(f"dense serve phase {arch}: {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
