"""Time ``slstm_scan`` on the card beside its plain loop, and measure the
least time of one step's exchange of h and grid-wide barrier (a development
script: not part of the package or its tests).

    PYTHONPATH=src python dev/slstm_timing.py [--rounds N] [--units 4,8,16]
        [--profile DIR] [--serve DIR] [--host]

Shapes are xlstm-350m's sLSTM layer (d 1,024, bf16): the served prefill
(B 4, S 4,096, from a zero state) and a decode step (S 1, from a random
state), inputs made on the card from a seed (xw unit normal, w_rec at the
model's 0.02, the bias 0.3 N(0, 1)).  Every launch is first held to the
plain loop within ``ref.slstm_tolerance``, then timed in rounds, each a
median of 10 CUDA-event pairs after a 2 ms spin on the card.

The chain bound: the kernel is rebuilt from ``csrc/slstm.cu`` with the
step's product replaced by nothing (``kStepWork = false``: each step still
copies h_{t-1} from the exchange buffer, applies the cell and writes h_t,
then waits at the barrier) and timed at the same shape; S steps of that
are the least the recurrence could take with this exchange and barrier.
``build_probe`` makes that probe (``chip_smoke.py`` imports it for its
chain bound).  ``--units`` times the probe and the kernel at other block
widths (d / units blocks, launched directly).  ``--profile DIR`` writes torch.profiler tables of one
plain loop and one kernel call at the prefill shape cut to S 512.
``--serve DIR`` profiles xlstm-350m served as ``chip_smoke.py`` serves it
(full width and depth, random weights from seed 0, batch 4, 4,096-token
prompts): the prefill and 4 decode steps, on the kernels and on the plain
versions, each traced after an untraced run of the same work, with device
ms by kernel class, the ``xlstm.mlstm`` / ``xlstm.slstm`` ranges and the
idle share.  ``--host`` takes the host's microseconds of one decode-step
call (S 1) apart: the wrapper, the launcher without the wrapper's checks,
the bare C call on outputs made once (a cooperative launch), the C call
refused at its argument check (ctypes alone), and the outputs'
allocation.  Each profiler session stays open 50 ms before and after its
work (a session may otherwise lose device events at its edges).  Prints
one JSON object per row, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.slstm import default_units, launch, slstm_scan

D = 1024
SHAPES = {"prefill": (4, 4096, "zero"), "decode": (4, 1, "random")}
PROBE = ("constexpr bool kStepWork = true;",
         "constexpr bool kStepWork = false;")


def build_probe() -> ctypes.CDLL:
    """``csrc/slstm.cu`` with the step's product replaced by nothing
    (``kStepWork = false``), built with the package's flags into
    ``build/slstm_dev/`` and loaded: its launches, through
    :func:`repro_torch.kernels.slstm.launch`, time S exchanges of h and
    barriers."""
    old, new = PROBE
    text = (_build.CSRC / "slstm.cu").read_text()
    if old not in text:
        raise RuntimeError(f"{old!r} not in slstm.cu")
    outdir = _build.BUILD_DIR.parent / "slstm_dev"
    outdir.mkdir(parents=True, exist_ok=True)
    src, so = outdir / "barrier.cu", outdir / "barrier.so"
    src.write_text(text.replace(old, new))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the slstm probe: nvcc failed\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(so))


def _inputs(dev, b, s, state, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).bfloat16()
    f32 = dict(dtype=torch.float32, device=dev)
    if state == "zero":
        st = {k: torch.zeros((b, D), **f32) for k in "cnh"}
        st["m"] = torch.full((b, D), -1e30, **f32)
    else:
        st = {"c": 0.5 * torch.randn((b, D), generator=gen, **f32),
              "n": 1 + 2 * torch.rand((b, D), generator=gen, **f32),
              "h": 0.3 * torch.randn((b, D), generator=gen, **f32),
              "m": torch.randn((b, D), generator=gen, **f32) - 1}
    return randn((b, s, 4 * D)), randn((D, 4 * D), 0.02), randn((4 * D,), 0.3), st


def _ms(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _traced(fn):
    """``fn()`` under torch.profiler, the session padded 50 ms on each
    side: (the profile, fn's result, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.05)
    return prof, out, wall


def _profile(dev, out: Path) -> None:
    xw, w, bias, st = _inputs(dev, 4, 512, "zero")
    out.mkdir(parents=True, exist_ok=True)
    for name, fn in (("plain", lambda: ref.slstm_scan_ref(xw, w, bias, st)),
                     ("kernel", lambda: slstm_scan(xw, w, bias, st))):
        fn()
        prof, _, _ = _traced(fn)
        (out / f"slstm_{name}_S512.txt").write_text(
            prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
        print(json.dumps({"profile": name, "file": str(
            out / f"slstm_{name}_S512.txt")}), flush=True)


def _host(dev) -> None:
    xw, w, bias, st = _inputs(dev, 4, 1, "random")
    lib = _build.library("slstm")
    units = default_units(D, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    hs = torch.empty((4, 1, D), dtype=torch.float32, device=dev)
    out = torch.empty((4, 4, D), dtype=torch.float32, device=dev)
    hx = torch.empty((2, 4, D), dtype=xw.dtype, device=dev)
    launch(lib, xw, w, bias, st, units)          # argtypes set, warm
    f = lib.teshu_slstm_scan
    stream = _build.stream_of(xw)
    ptrs = [xw.data_ptr(), w.data_ptr(), bias.data_ptr(),
            *(st[k].data_ptr() for k in "cnhm"), hs.data_ptr(),
            *(o.data_ptr() for o in out), hx.data_ptr()]

    def us(fn, n=400) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6
    print(json.dumps(dict(
        host_us=dict(
            wrapper=us(lambda: slstm_scan(xw, w, bias, st)),
            launcher=us(lambda: launch(lib, xw, w, bias, st, units)),
            c_call=us(lambda: f(*ptrs, 4, 1, D, units, 1, stream)),
            c_call_refused=us(lambda: f(*ptrs, 0, 1, D, units, 1, stream)),
            three_empties=us(lambda: (
                torch.empty((4, 1, D), dtype=torch.float32, device=dev),
                torch.empty((4, 4, D), dtype=torch.float32, device=dev),
                torch.empty((2, 4, D), dtype=xw.dtype, device=dev))),
            stream_of=us(lambda: _build.stream_of(xw))))), flush=True)


def _kernel_class(name: str) -> str:
    if "slstm_scan" in name:
        return "slstm_scan"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "gemv",
                               "splitKreduce")):
        return "matmul"
    return "other"


def _serve_profile(dev, out: Path) -> None:
    """xlstm-350m's prefill and 4 decode steps under the profiler, on the
    kernels and on the plain versions."""
    import numpy as np
    from torch.autograd import DeviceType

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("xlstm-350m")
    params = lm.init_lm(cfg, seed=0, device=dev)
    b, s = 4, 4096
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    out.mkdir(parents=True, exist_ok=True)
    for use_kernel in (True, False):
        tag = "kernels" if use_kernel else "plain"

        def prefill():
            cache = lm.init_cache(cfg, b, s + 8, device=dev)
            logits, _, _ = lm.forward(params, tokens=tokens, cache=cache,
                                      use_kernel=use_kernel)
            return logits[:, -1].argmax(-1).to(torch.int32)[:, None], cache

        def steps(tok, cache):
            for _ in range(4):
                logits, _ = lm.serve_step(params, cache, tokens=tok,
                                          use_kernel=use_kernel)
                tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            return tok
        tok, cache = prefill()                      # untraced, the same work
        steps(tok, cache)
        for name, fn in (("prefill", prefill),
                         ("decode_4_steps", lambda: steps(tok, cache))):
            prof, _, wall = _traced(fn)
            (out / f"profile_xlstm_{tag}_{name}.txt").write_text(
                prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=30))
            busy: dict[str, float] = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA and e.name not in (
                        "Activity Buffer Request", "Command Buffer Full") \
                        and not e.name.startswith("xlstm."):
                    c = _kernel_class(e.name)
                    busy[c] = busy.get(c, 0.0) + e.device_time_total / 1e3
            ranges = {f"{e.key}_{k}_ms": getattr(e, f"{k}_time_total", 0.0)
                      / 1e3 for e in prof.key_averages()
                      if e.key.startswith("xlstm.")
                      for k in ("cpu", "device")}
            print(json.dumps(dict(
                serve=tag, phase=name, wall_ms=wall * 1e3,
                device_ms_by_class=busy,
                idle_share=1 - sum(busy.values()) / (wall * 1e3),
                ranges=ranges)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--units", default="",
                    help="other hidden units a block to time, e.g. 4,16")
    ap.add_argument("--profile", type=Path, default=None)
    ap.add_argument("--serve", type=Path, default=None)
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.host:
        _host(dev)
        return
    probe = build_probe()
    lib = _build.library("slstm")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    units = [default_units(D, sms)] + [int(u) for u in args.units.split(",")
                                       if u]
    for name, (b, s, state) in SHAPES.items():
        xw, w, bias, st = _inputs(dev, b, s, state)
        got, _ = slstm_scan(xw, w, bias, st)
        plain, _ = ref.slstm_scan_ref(xw, w, bias, st)
        tol, _ = ref.slstm_tolerance(xw, w, bias, st)
        share = float(((got - plain).abs() / tol).max())
        assert share <= 1.0, f"{name}: {share} of the bound"
        plain_ms = _ms(lambda: ref.slstm_scan_ref(xw, w, bias, st),
                       reps=3 if s > 1 else 10)
        for u in units:
            for r in range(args.rounds):
                ms = _ms(lambda: launch(lib, xw, w, bias, st, u))
                chain = _ms(lambda: launch(probe, xw, w, bias, st, u))
                print(json.dumps(dict(
                    shape=name, B=b, S=s, d=D, units=u, blocks=D // u,
                    round=r, ms=ms, us_per_step=ms / s * 1e3,
                    chain_bound_ms=chain, chain_us_per_step=chain / s * 1e3,
                    plain_ms=plain_ms, bound_share=share)), flush=True)
        del xw, w, bias, st, got, plain, tol
    if args.profile is not None:
        _profile(dev, args.profile)
    if args.serve is not None:
        _serve_profile(dev, args.serve)


if __name__ == "__main__":
    main()
