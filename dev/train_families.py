"""``chip_smoke.py``'s family training phases (7d) alone on the card.

This runs only ``family_train_phase`` for the families named (all three
by default: the gradient check, the steps and their checks, the ``family
train phase`` line), DeepSeek-V2 over its own one-rank NCCL mesh, each
phase's seconds after it.  ``--profile DIR`` traces one step of each as
the smoke run's ``--profile`` does (tracing Hymba's step takes minutes
more: it issues hundreds of thousands of operations):

    PYTHONPATH=src python dev/train_families.py [hymba-1.5b xlstm-350m deepseek-v2-236b] [--profile DIR]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", default=list(cs.FAMILY_TRAIN))
    ap.add_argument("--profile", type=Path, default=None)
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("train_families: torch finds no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.nvidia_smi_line())
    for arch in args.archs:
        t0 = time.perf_counter()
        if arch == cs.DEEPSEEK_ARCH:
            mesh, _ = cs.mesh_open(dev)
            try:
                cs.family_train_phase(dev, args.profile, arch, mesh)
            finally:
                dist.destroy_process_group()
        else:
            cs.family_train_phase(dev, args.profile, arch)
        torch.cuda.empty_cache()
        cs.log(f"family train phase {arch}: {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
