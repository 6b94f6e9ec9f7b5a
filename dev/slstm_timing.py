"""Time ``slstm_scan`` on the card beside its plain loop and the parent's
kernel, take one step apart, and measure the least time of one exchange
between two SMs (a development script: not part of the package or its
tests).

    PYTHONPATH=src python dev/slstm_timing.py [--rounds N] [--units 8,4]
        [--parent DIR] [--phases] [--pingpong] [--profile DIR]
        [--serve DIR] [--host]

Shapes are xlstm-350m's sLSTM layer (d 1,024, bf16): the served prefill
(B 4, S 4,096, from a zero state) and a decode step (S 1, from a random
state), inputs made on the card from a seed (xw unit normal, w_rec at the
model's 0.02, the bias 0.3 N(0, 1)).  Every launch is first held to the
plain loop within ``ref.slstm_tolerance``, then timed in rounds, each a
median of 10 CUDA-event pairs after a 2 ms spin on the card.

Variants are built from a source with one or more texts replaced
(``build_variants``; each replaced text must occur exactly once):
``kStepWork = false`` leaves the step's product out (the exchange alone:
each step still waits for the h_{t-1} it reads, loads it, applies the cell
and publishes h_t), ``kPhaseClock = true`` is the clock64 probe (thread 0
of each block sums the cycles of each phase of its steps: the wait for the
flags, the copy of h, the product, the cross-warp reduction, the cell, the
stores and the publication), ``STALE_HALF`` a planted fault (``chip_smoke.py``
imports these).  ``--parent DIR`` (a checkout of the parent, e.g. ``git
archive`` into ``build/parent``) builds the parent's kernel, launched
through the C interface its own ``slstm.cu`` declares (``parent_interface``:
the flags design, with a flag buffer and base of its own, or
the grid-barrier design before it; any other declaration raises), and times
it in turns with this one (parent, new, new, parent), with its exchange
probe and, with ``--phases``, its own clock64 probe (a flags parent the
shipped ``PHASE_PROBE``; a grid-barrier parent ``PARENT_PHASE_SUBS``: the
copy of h, the product, the reduction, the cell, the stores, the wait at
the grid barrier).  ``--pingpong`` bounces one flag between two blocks on
two SMs through L2 (``dev/slstm_pingpong.cu``): S times half its round
trip is the least time S dependent exchanges can take.  ``--units`` times
the kernel at other block widths (d / units blocks, launched directly).
``--profile DIR`` writes torch.profiler tables of one plain loop and one
kernel call at the prefill shape cut to S 512.  ``--serve DIR`` profiles
xlstm-350m served as ``chip_smoke.py`` serves it (full width and depth,
random weights from seed 0, batch 4, 4,096-token prompts): the prefill and
4 decode steps, on the kernels and on the plain versions, each traced
after an untraced run of the same work, with device ms by kernel class,
the ``xlstm.mlstm`` / ``xlstm.slstm`` ranges and the idle share.
``--host`` takes the host's microseconds of one decode-step call (S 1)
apart: the wrapper, the launcher without the wrapper's checks, the bare C
call on outputs made once (a cooperative launch), the C call refused at
its argument check (ctypes alone), and the outputs' allocation.  Each
profiler session stays open 50 ms before and after its work (a session may
otherwise lose device events at its edges).  Prints one JSON object per
row, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.slstm import (MAX_BLOCKS, FLAG_STRIDE, FlagBase,
                                       _flags, default_units, launch,
                                       slstm_scan)

D = 1024
SHAPES = {"prefill": (4, 4096, "zero"), "decode": (4, 1, "random")}
DEV = Path(__file__).resolve().parent
# the shipped source's probes, each one text replaced (each text occurs in
# csrc/slstm.cu exactly once: tests/test_torch_slstm_source.py)
PROBE = ("constexpr bool kStepWork = true;",
         "constexpr bool kStepWork = false;")
PHASE_PROBE = ("constexpr bool kPhaseClock = false;",
               "constexpr bool kPhaseClock = true;")
# variants of the shipped kernel, each with one lever taken back
VARIANTS = {
    "flags, CUDA cores": [("constexpr bool kTensorCores = true;",
                           "constexpr bool kTensorCores = false;")],
    "flags packed": [("constexpr int kFlagStride = 16;",
                      "constexpr int kFlagStride = 1;")],
}
# a planted fault: step t reads the half of the exchange buffer that step t
# writes, which holds h_{t-2} (at t = 1, whatever is there)
STALE_HALF = ("return a.hx + ((t - 1) & 1) * a.B * a.d;",
              "return a.hx + (t & 1) * a.B * a.d;")
# the phases kPhaseClock times, in the order of teshu_slstm_phase_cycles
PHASES = ("wait", "copy", "product", "reduction", "cell", "stores")

# the same clock64 probe of the parent's kernel (the grid-barrier design,
# texts of its csrc/slstm.cu): thread 0 of each block sums the
# cycles of each phase of its steps (xw's loads are issued in "copy")
PARENT_PHASES = ("copy", "product", "reduction", "cell", "stores", "barrier")


def _ph(k: int) -> str:
    return (f"{{ const long long q_ = clock64(); ph_[{k}] += q_ - pc_; "
            f"pc_ = q_; }}\n")


_READER = (
    'extern "C" int teshu_slstm_phases(void* out) {\n'
    "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
    "      out, teshu_slstm_phase_cycles, sizeof(teshu_slstm_phase_cycles)));\n"
    "}\n\n")
PARENT_PHASE_SUBS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ long long teshu_slstm_phase_cycles[1024][8];\n"),
    ("  for (int t = 0; t < S; ++t) {\n    float xv[4];\n",
     "  long long ph_[8] = {0, 0, 0, 0, 0, 0, 0, 0}, pc_ = clock64();\n"
     "  for (int t = 0; t < S; ++t) {\n    float xv[4];\n"),
    ("dst[i] = __ldcg(src + i);\n      __syncthreads();\n    }\n",
     "dst[i] = __ldcg(src + i);\n      __syncthreads();\n    }\n    "
     + _ph(0)),
    ("#pragma unroll\n        for (int cc = 0; cc < kCols; ++cc)\n"
     "#pragma unroll\n          for (int bb = 0; bb < kMaxB; ++bb)\n"
     "#pragma unroll\n            for (int off = 16;",
     "        " + _ph(1) +
     "#pragma unroll\n        for (int cc = 0; cc < kCols; ++cc)\n"
     "#pragma unroll\n          for (int bb = 0; bb < kMaxB; ++bb)\n"
     "#pragma unroll\n            for (int off = 16;"),
    ("    __syncthreads();\n    if (cell) {\n      float pre[4];\n",
     "    __syncthreads();\n    " + _ph(2)
     + "    if (cell) {\n      float pre[4];\n"),
    ("      h = __fmul_rn(o, __fdiv_rn(c, n));\n",
     "      h = __fmul_rn(o, __fdiv_rn(c, n));\n      " + _ph(3)),
    ("from_f<T>(h));\n    }\n",
     "from_f<T>(h));\n    }\n    " + _ph(4)),
    ("    if (t + 1 < S) grid.sync();\n",
     "    if (t + 1 < S) grid.sync();\n    " + _ph(5)),
    ("  if (cell) {\n    a.c1[b * d + j] = c;\n",
     "  if (tid == 0 && blockIdx.x < 1024)\n"
     "    for (int q = 0; q < 8; ++q)\n"
     "      teshu_slstm_phase_cycles[blockIdx.x][q] = ph_[q];\n"
     "  if (cell) {\n    a.c1[b * d + j] = c;\n"),
    ('extern "C" int teshu_slstm_scan(',
     _READER + 'extern "C" int teshu_slstm_scan('),
]


def replaced(text: str, subs, what: str) -> str:
    """``text`` with each (old, new) of ``subs`` replaced; each old text
    must occur in it exactly once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: {old!r} occurs {text.count(old)} "
                               f"times, not once")
        text = text.replace(old, new)
    return text


def build_variants(variants: dict) -> dict:
    """``{name: (source path, replacements)}`` -> ``{name: CDLL}``: each
    source with its texts replaced, built with the package's flags into
    ``build/slstm_dev/`` (one nvcc per variant, all started together) and
    loaded."""
    outdir = _build.BUILD_DIR.parent / "slstm_dev"
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (path, subs) in variants.items():
        slug = "".join(c if c.isalnum() else "_" for c in name)
        src, so = outdir / f"{slug}.cu", outdir / f"{slug}.so"
        src.write_text(replaced(Path(path).read_text(), subs, name))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(so), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"slstm variant {name}: nvcc failed\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def build_probe() -> ctypes.CDLL:
    """``csrc/slstm.cu`` with the step's product replaced by nothing
    (``kStepWork = false``), built and loaded: its launches, through
    :func:`repro_torch.kernels.slstm.launch`, time S exchanges of h (each
    step still waits for every block's h_{t-1}, loads it, applies the cell
    and publishes h_t)."""
    return build_variants({"exchange": (_build.CSRC / "slstm.cu",
                                        [PROBE])})["exchange"]


# the parameters of teshu_slstm_scan, one letter each (p a pointer, i an
# int, u a 64-bit unsigned): the flags design (its flag buffer, their count
# and the call's base) and the older grid-barrier design
INTERFACES = {"p" * 14 + "iu" + "i" * 5 + "p": "flags",
              "p" * 13 + "i" * 5 + "p": "barrier"}
# a parent library's own flags: {(id of the library, device): (buffer,
# FlagBase)}
_PARENT_FLAGS: dict = {}


@functools.cache
def parent_interface(source) -> str:
    """``"flags"`` or ``"barrier"``: the C interface of the
    ``teshu_slstm_scan`` that ``source`` (a parent's ``slstm.cu``)
    declares, read from its parameter list once a file (a launch's timing
    must not read it).  A source without the declaration, or with another
    list, raises with the file and the declaration."""
    text = Path(source).read_text()
    decl = re.search(r'extern "C" int teshu_slstm_scan\(([^)]*)\)', text)
    if decl is None:
        raise RuntimeError(f"{source}: no teshu_slstm_scan declaration")

    def kind(param: str) -> str:
        return "p" if "*" in param else "u" if "long long" in param else \
            "i" if param.split()[0] == "int" else "?"
    sig = "".join(kind(q) for q in decl.group(1).split(","))
    if sig not in INTERFACES:
        raise RuntimeError(f"{source}: teshu_slstm_scan has an interface "
                           f"this script does not launch: "
                           f"{' '.join(decl.group(0).split())}")
    return INTERFACES[sig]


def parent_units(source, units: int) -> int:
    """The hidden units a block the parent's kernel runs at beside the
    shipped one's ``units``: the same for a flags parent (its kernel takes
    the same block widths, so the two are timed at one grid), 8 for the
    grid-barrier design (its wrapper's choice at d 1,024 on 132 SMs)."""
    return units if parent_interface(source) == "flags" else 8


def parent_launch(lib, xw, w_rec, b, state, units: int, source):
    """One launch of the parent's ``teshu_slstm_scan`` from ``lib``
    (built from ``source``, the parent's ``slstm.cu``) through the C
    interface ``source`` declares (:func:`parent_interface`).  The flags
    design takes the arguments of ``kernels.slstm.launch``, with a flag
    buffer and base of ``lib``'s own, zeroed once (the shipped launches
    advance the stream's base, not these); the grid-barrier design the
    exchange buffer as its only scratch."""
    if parent_interface(source) == "flags":
        key = (id(lib), xw.device)
        if key not in _PARENT_FLAGS:
            _PARENT_FLAGS[key] = (torch.zeros(MAX_BLOCKS * FLAG_STRIDE,
                                              dtype=torch.int64,
                                              device=xw.device), FlagBase())
        return launch(lib, xw, w_rec, b, state, units,
                      flags=_PARENT_FLAGS[key])
    f = lib.teshu_slstm_scan
    if f.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * 13 + [i32] * 5 + [p]
        f.restype = ctypes.c_int
    bsz, s, _ = xw.shape
    d = w_rec.shape[0]
    hs = torch.empty((bsz, s, d), dtype=torch.float32, device=xw.device)
    out = torch.empty((4, bsz, d), dtype=torch.float32, device=xw.device)
    hx = torch.empty((2, bsz, d), dtype=xw.dtype, device=xw.device)
    _build.check(f(xw.data_ptr(), w_rec.data_ptr(), b.data_ptr(),
                   *(state[k].data_ptr() for k in "cnhm"), hs.data_ptr(),
                   *(o.data_ptr() for o in out), hx.data_ptr(), bsz, s, d,
                   units, int(xw.dtype == torch.bfloat16),
                   _build.stream_of(xw)), "parent slstm_scan")
    return hs, dict(zip("cnhm", out))


def phase_split(lib, run, names, blocks: int, s: int) -> dict:
    """Cycles a step of each phase, from one ``run()`` of a kernel built
    with its clock64 probe: the mean over the ``blocks`` blocks' thread 0
    and the largest, each divided by the ``s`` steps."""
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (1024 * 8))()
    _build.check(lib.teshu_slstm_phases(ctypes.byref(buf)), "phases")
    cyc = torch.tensor(list(buf), dtype=torch.float64).view(1024, 8)
    cyc = cyc[:blocks, :len(names)] / s
    return dict(mean={n: float(cyc[:, i].mean()) for i, n in
                      enumerate(names)},
                max={n: float(cyc[:, i].max()) for i, n in
                     enumerate(names)},
                total_mean=float(cyc.sum(1).mean()))


def pingpong(dev, rounds: int = 100_000) -> dict:
    """One flag bounced between two blocks on two SMs through L2
    (``dev/slstm_pingpong.cu``): the round trip and its half, in ns (CUDA
    events over ``rounds`` round trips) and in block 0's cycles."""
    lib = build_variants({"pingpong": (DEV / "slstm_pingpong.cu", [])}
                         )["pingpong"]
    f = lib.slstm_pingpong
    f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p]
    f.restype = ctypes.c_int
    flags = torch.empty(32, dtype=torch.int64, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = _ms(lambda: _build.check(f(flags.data_ptr(), rounds,
                                    cycles.data_ptr(), stream), "pingpong"),
             reps=5)
    rt_ns = ms * 1e6 / rounds
    return dict(rounds=rounds, round_trip_ns=rt_ns, one_way_ns=rt_ns / 2,
                round_trip_cycles=float(cycles[0]) / rounds)


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
        dev).multi_processor_count, xw.dtype)
    hs = torch.empty((4, 1, D), dtype=torch.float32, device=dev)
    out = torch.empty((4, 4, D), dtype=torch.float32, device=dev)
    hx = torch.empty((2, 4, D), dtype=xw.dtype, device=dev)
    launch(lib, xw, w, bias, st, units)          # argtypes set, warm
    f = lib.teshu_slstm_scan
    stream = _build.stream_of(xw)
    flags, fb = _flags(xw.device, stream)
    ptrs = [xw.data_ptr(), w.data_ptr(), bias.data_ptr(),
            *(st[k].data_ptr() for k in "cnhm"), hs.data_ptr(),
            *(o.data_ptr() for o in out), hx.data_ptr(), flags.data_ptr(),
            flags.numel()]

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
            c_call=us(lambda: f(*ptrs, fb.take(1), 4, 1, D, units, 1,
                                stream)),
            c_call_refused=us(lambda: f(*ptrs, fb.take(1), 0, 1, D, units,
                                        1, stream)),
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
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent: its kernel timed beside")
    ap.add_argument("--phases", action="store_true",
                    help="the clock64 split of a step at the served prefill")
    ap.add_argument("--pingpong", action="store_true",
                    help="a flag's round trip between two SMs")
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
    shipped = _build.CSRC / "slstm.cu"
    variants = {"exchange": (shipped, [PROBE])}
    variants.update({k: (shipped, v) for k, v in VARIANTS.items()})
    if args.phases:
        variants["phases"] = (shipped, [PHASE_PROBE])
    if args.parent is not None:
        psrc = args.parent / "src" / "repro_torch" / "kernels" / "csrc" / \
            "slstm.cu"
        flags = parent_interface(psrc) == "flags"
        variants["parent"] = (psrc, [])
        variants["parent exchange"] = (psrc, [PROBE])
        if args.phases:
            variants["parent phases"] = (
                psrc, [PHASE_PROBE] if flags else PARENT_PHASE_SUBS)
    libs = build_variants(variants)
    lib = _build.library("slstm")
    if args.pingpong:
        print(json.dumps(dict(pingpong=pingpong(dev))), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    units = [default_units(D, sms, torch.bfloat16)] + [
        int(u) for u in args.units.split(",") if u]
    for name, (b, s, state) in SHAPES.items():
        xw, w, bias, st = _inputs(dev, b, s, state)
        plain, _ = ref.slstm_scan_ref(xw, w, bias, st)
        tol, _ = ref.slstm_tolerance(xw, w, bias, st)

        def share(hs):
            return float(((hs - plain).abs() / tol).nan_to_num(
                nan=float("inf")).max())
        got, _ = slstm_scan(xw, w, bias, st)
        assert share(got) <= 1.0, f"{name}: {share(got)} of the bound"
        plain_ms = _ms(lambda: ref.slstm_scan_ref(xw, w, bias, st),
                       reps=3 if s > 1 else 10)
        par = None
        if "parent" in libs:
            pu = parent_units(psrc, units[0])

            def par():
                return parent_launch(libs["parent"], xw, w, bias, st, pu,
                                     psrc)
            assert share(par()[0]) <= 1.0, f"{name}: the parent off"
        for u in units:
            for r in range(args.rounds):
                # in turns: parent, new, new, parent
                p0 = _ms(par) if par else None
                ms = _ms(lambda: launch(lib, xw, w, bias, st, u))
                ms2 = _ms(lambda: launch(lib, xw, w, bias, st, u))
                p1 = _ms(par) if par else None
                exch = _ms(lambda: launch(libs["exchange"], xw, w, bias, st,
                                          u))
                row = dict(shape=name, B=b, S=s, d=D, units=u, blocks=D // u,
                           round=r, ms=[ms, ms2], us_per_step=ms / s * 1e3,
                           exchange_probe_ms=exch, plain_ms=plain_ms,
                           bound_share=share(launch(lib, xw, w, bias, st,
                                                    u)[0]))
                if par:
                    row.update(parent_ms=[p0, p1], parent_units=pu,
                               parent_exchange_probe_ms=_ms(
                                   lambda: parent_launch(
                                       libs["parent exchange"], xw, w, bias,
                                       st, pu, psrc)))
                for v in VARIANTS:    # each lever taken back, in turns
                    lib_v = libs[v]
                    row[f"{v}: ms"] = [
                        _ms(lambda: launch(lib_v, xw, w, bias, st, u)),
                        _ms(lambda: launch(lib, xw, w, bias, st, u))]
                    row[f"{v}: bound_share"] = share(
                        launch(lib_v, xw, w, bias, st, u)[0])
                print(json.dumps(row), flush=True)
        for u in units if name == "prefill" and "phases" in libs else ():
            print(json.dumps(dict(phases="shipped", units=u, S=s,
                                  cycles_a_step=phase_split(
                                      libs["phases"], lambda: launch(
                                          libs["phases"], xw, w, bias, st, u),
                                      PHASES, D // u, s))), flush=True)
        if name == "prefill" and "parent phases" in libs:
            print(json.dumps(dict(phases="parent", units=pu, S=s,
                                  cycles_a_step=phase_split(
                                      libs["parent phases"],
                                      lambda: parent_launch(
                                          libs["parent phases"], xw, w, bias,
                                          st, pu, psrc),
                                      PHASES if flags else PARENT_PHASES,
                                      D // pu, s))),
                  flush=True)
        del xw, w, bias, st, got, plain, tol
    if args.profile is not None:
        _profile(dev, args.profile)
    if args.serve is not None:
        _serve_profile(dev, args.serve)


if __name__ == "__main__":
    main()
