"""Time ``decode_attention`` on the card at the three shapes that
``chip_smoke.py`` times, beside SDPA, its bound and the host's cost of a
call (a development script: not part of the package or its tests).

    PYTHONPATH=src python dev/decode_timing.py [--rounds N] [--out FILE]
        [--blocks-per-sm 1,2]

It imports ``repro_torch`` from ``PYTHONPATH``, so the same script times
another checkout of the port (``PYTHONPATH=<checkout>/src``).  Shapes: the
Qwen2.5-14B serving step (q ``[4, 40, 128]`` over a ``[4, 2048, 8, 128]``
bf16 cache, ``valid_len`` 1,056), the Qwen3-MoE step (q ``[4, 64, 128]``
over ``[4, 2048, 4, 128]``) and one ``decode_32k`` layer (q ``[128, 40,
128]`` over ``[128, 32768, 8, 128]``, every position valid).  Each launch
is first held against the plain version (``ref.decode_attention_tolerance``,
on 16 sequences at most) and then timed in rounds, the kernel and SDPA in
turns (the order reversed every other round), each a median of 10
CUDA-event pairs with the 50 MB L2 flushed and the card spinning 2 ms
before each.  The host's cost of a call is the enqueue time of 200 calls
on one cache (``host_us``) and on 200 caches at other addresses
(``host_us_new_ptr``: a wrapper that encodes tensor maps per cache pays
that there).  With ``--blocks-per-sm`` the module's ``BLOCKS_PER_SM`` (the
split rule's target) is set to each value in turn.  With ``--sweep`` it
times instead the serving and MoE steps at ``valid_len`` 1 to 2,048 for
each ``--blocks-per-sm`` (a kernel's fixed cost, the cost of a tile and
of the merge), beside SDPA.  Prints one JSON object per shape and
setting, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

# the module (the package's own name decode_attention is the function)
mod = importlib.import_module("repro_torch.kernels.decode_attention")

SHAPES = {  # name: B, H, KVH, T, valid
    "serving": (4, 40, 8, 2048, 1056),
    "moe": (4, 64, 4, 2048, 1056),
    "32k": (128, 40, 8, 32768, 32768)}
HBM = 3.35e12
L2 = 50 * 2 ** 20


def _ms(fn, flush, reps=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(2_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _host_us(calls) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in calls:
        c()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / len(calls) * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--blocks-per-sm", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    scratch = torch.ones(2 * L2 // 4, device=dev)
    settings = ([None] if args.blocks_per_sm is None else
                [float(x) for x in args.blocks_per_sm.split(",")])
    lines = []
    if args.sweep:
        for name in ("serving", "moe"):
            b, h, kvh, t, _ = SHAPES[name]
            q = torch.randn((b, h, 128), device=dev, generator=gen).bfloat16()
            k, v = (torch.randn((b, t, kvh, 128), device=dev, generator=gen)
                    .bfloat16() for _ in range(2))
            for valid in (1, 64, 128, 256, 512, 1056, 2048):
                q4 = q.view(b, h, 1, 128)
                k4, v4 = (x[:, :valid].transpose(1, 2) for x in (k, v))
                row = dict(shape=name, valid=valid, sdpa_ms=_ms(
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, enable_gqa=True), scratch.sum))
                for bps in settings:
                    if bps is not None:
                        mod.BLOCKS_PER_SM = bps
                    row[f"ms_bps_{bps}"] = _ms(
                        lambda: mod.decode_attention(q, k, v, valid),
                        scratch.sum)
                print(json.dumps(row), flush=True)
                lines.append(row)
        SHAPES.clear()
    for name, (b, h, kvh, t, valid) in SHAPES.items():
        d = 128
        q = torch.randn((b, h, d), device=dev, generator=gen).bfloat16()
        k, v = (torch.randn((b, t, kvh, d), device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        n = min(b, 16)
        kv = (k[:n, :valid], v[:n, :valid])
        plain = ref.decode_attention_ref(q[:n], *kv, valid)
        tol = ref.decode_attention_tolerance(q[:n], *kv, valid, plain)
        nbytes = 2 * q.numel() * 2 + 2 * b * valid * kvh * d * 2
        sdpa = None
        if name != "32k":
            q4 = q.view(b, h, 1, d)
            k4, v4 = (x[:, :valid].transpose(1, 2) for x in (k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, enable_gqa=True)
        if name == "serving":
            numel = k.numel()
            buf = torch.empty(numel + 200 * 16, dtype=torch.bfloat16,
                              device=dev)
            views = [buf[16 * i:16 * i + numel].view(k.shape)
                     for i in range(200)]
        for bps in settings:
            if bps is not None:
                mod.BLOCKS_PER_SM = bps
            fn = lambda: mod.decode_attention(q, k, v, valid)  # noqa: E731
            got = fn()
            share = float(((got[:n].float() - plain.float()).abs()
                           / tol).max())
            ms, lib = [], []
            for r in range(args.rounds):
                order = [0, 1] if r % 2 == 0 else [1, 0]
                for i in order:
                    if i == 0:
                        ms.append(_ms(fn, scratch.sum))
                    elif sdpa is not None:
                        lib.append(_ms(sdpa, scratch.sum))
            row = dict(shape=name, q=[b, h, d], cache=[b, t, kvh, d],
                       valid=valid, blocks_per_sm=getattr(
                           mod, "BLOCKS_PER_SM", None),
                       bound_share=share, ms=ms, ms_median=statistics.median(ms),
                       sdpa_ms=lib or None,
                       bound_ms=nbytes / HBM * 1e3,
                       tb_per_s=nbytes / statistics.median(ms) / 1e9)
            if name == "serving":
                row["host_us"] = _host_us([fn] * 200)
                row["host_us_new_ptr"] = _host_us(
                    [lambda x=x: mod.decode_attention(q, x, x, valid)
                     for x in views])
            print(json.dumps(row), flush=True)
            lines.append(row)
        del q, k, v, plain, tol, kv
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write(smi + "\n" + "\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
