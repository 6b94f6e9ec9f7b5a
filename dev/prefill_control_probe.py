"""How far the dense serve phases' prefill control moves the logits, on
the CPU at a reduced width.

``chip_smoke.py`` holds each dense model's kernel run to its plain run
within ``LOGIT_TOL_STEPS`` bf16 steps at the largest logit, and its
prefill control (``_late_diagonal_flash``: each end-aligned row also sees
the position after it) must miss that at step 0.  This serves ``arch``'s
config with its depth and heads set here and its width cut (``d_model``
``--width``, ``d_ff`` twice that, a vocabulary of 16,384; bf16 weights
from seed 0) on the card's traffic (batch 2, ``--prompt`` tokens), plain,
then teacher-forced with the control and with the plain flash's S and P
rounded to bf16 (the phases' informational control), and prints each
one's step-0 and step-1 logit differences in bf16 steps:

    PYTHONPATH=src python dev/prefill_control_probe.py llama3-405b --layers 8 --heads 16 --kv-heads 1 --d-head 128 --width 2048
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--d-head", type=int, default=64)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    torch.set_num_threads(args.threads)
    cfg = dataclasses.replace(
        get_config(args.arch), n_layers=args.layers, d_model=args.width,
        n_heads=args.heads, n_kv_heads=args.kv_heads, d_head=args.d_head,
        d_ff=2 * args.width, vocab=16384, dtype="bfloat16")
    kw = dict(smoke=False, device="cpu", batch=2, prompt_len=args.prompt,
              gen_len=1, max_len=args.prompt + 8, seed=0,
              params=lm.init_lm(cfg, seed=0, device="cpu"))
    t0 = time.perf_counter()
    gen, plain = serve(args.arch, use_kernel=False, **kw)
    plain_logits = torch.stack(plain.logits).float()
    step = 2.0 ** (np.floor(np.log2(float(plain_logits.abs().max()))) - 7)
    out = {}
    for name, fns in ((cs.PREFILL_CONTROL, (cs._late_diagonal_flash,
                                            ref.decode_attention_ref)),
                      ("S and P in bf16", (cs._bf16_flash, cs._bf16_decode))):
        diffs = cs._control_diffs(serve, args.arch, kw, gen, plain_logits,
                                  *fns)
        out[name] = [d / step for d in diffs]
    print(json.dumps(dict(
        arch=args.arch, layers=args.layers, heads=args.heads,
        kv_heads=args.kv_heads, d_head=args.d_head, width=args.width,
        prompt=args.prompt, bf16_step=step, steps_over_plain=out,
        seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
