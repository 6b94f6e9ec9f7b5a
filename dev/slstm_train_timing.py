"""Time the sLSTM recurrence under autograd on the card, as training runs
it (``ref._SLSTMScan``: the forward loop keeping its states, the reverse
loop), with its blocks replayed as CUDA graphs (``ref._blocks``) and run
as they are, in turns (graphed, eager, eager, graphed) within one process
(a development script: not part of the package or its tests).

    PYTHONPATH=src python dev/slstm_train_timing.py [--rounds N] [--seq S]

Shapes are xlstm-350m's sLSTM layer at the training phase's traffic (B 4,
S 4,096, d 1,024, bf16), inputs made on the card from a seed as
``tests/test_torch_cuda.py``'s ``_slstm_inputs`` makes them, the outputs
weighted by unit normals into a loss.  Each run is the forward (wall time,
the card synchronised) and the backward of that loss; the graphed and
eager runs' outputs and gradients must be bit for bit the same.  Prints
one JSON object per run, then the medians and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import ref


def inputs(dev, b: int, s: int, d: int, seed: int = 0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)
    st = {"c": 0.5 * torch.randn((b, d), generator=gen, device=dev),
          "n": 1 + 2 * torch.rand((b, d), generator=gen, device=dev),
          "h": 0.3 * torch.randn((b, d), generator=gen, device=dev),
          "m": torch.randn((b, d), generator=gen, device=dev) - 1}
    weights = [torch.randn((b, s, d), generator=gen, device=dev)] + [
        torch.randn((b, d), generator=gen, device=dev)
        for _ in ref.SLSTM_STATE]
    return (randn(b, s, 4 * d), randn(d, 4 * d, scale=0.02),
            randn(4 * d, scale=0.3), st, weights)


def eager_blocks(fn, statics, n, load, store):
    for i in range(n):
        load(i)
        store(i, fn())


def run(xw, w, bias, st, weights) -> tuple[list, float, float]:
    """``(outputs and gradients, forward s, backward s)``."""
    ins = [x.clone().requires_grad_(True) for x in (xw, w, bias)] + [
        st[k].clone().requires_grad_(True) for k in ref.SLSTM_STATE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs, fin = ref.slstm_scan_ref(*ins[:3], dict(zip(ref.SLSTM_STATE,
                                                     ins[3:])))
    loss = (hs * weights[0]).sum() + sum(
        (fin[k] * x).sum() for k, x in zip(ref.SLSTM_STATE, weights[1:]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, ins)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return [hs.detach(), *(v.detach() for v in fin.values()), *grads], \
        t1 - t0, t2 - t1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("slstm_train_timing: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    args_in = inputs(dev, 4, args.seq, 1024)
    graphed_blocks = ref._blocks
    times: dict = {"graphed": [], "eager": []}
    outs = {}
    for _ in range(args.rounds):
        for mode in ("graphed", "eager", "eager", "graphed"):
            ref._blocks = graphed_blocks if mode == "graphed" \
                else eager_blocks
            out, fwd, bwd = run(*args_in)
            outs[mode] = out
            times[mode].append((fwd, bwd))
            print(json.dumps({"mode": mode, "forward_s": fwd,
                              "backward_s": bwd, "seq": args.seq}),
                  flush=True)
    ref._blocks = graphed_blocks
    same = all(torch.equal(a, b) for a, b in zip(outs["graphed"],
                                                  outs["eager"]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "bit_for_bit": same, "card": card,
        **{f"{m}_{part}_s": statistics.median(t[j] for t in times[m])
           for m in times for j, part in enumerate(("forward", "backward"))},
    }))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
