"""Time variants of the ``decode_tma`` kernel against the shipped one on the
card (a development script: not part of the package or its tests).

    PYTHONPATH=src python dev/decode_variants.py [--out FILE]

This script rebuilds the decode library from
``src/repro_torch/kernels/csrc/decode_attention.cu`` with one piece of the
source replaced, so that alternatives stay measurable without a switch in
the kernel.  Each replaced text must occur exactly once in the source;
after an edit of the kernel, bring the texts here up to date:

- ``one set``: one set of consumer warps takes every tile (the shipped
  kernel gives a single row group two sets that take the tiles in turn);
- ``shared carveout``: the launch also asks for the largest shared-memory
  carveout;
- ``merge unrolled 8``: the last block's merge loads 8 splits at a time;
- ``fenced counter``: a ``__threadfence`` by every thread before the
  counter and after it in the last block, with a plain ``atomicAdd``, in
  place of the shipped barrier and one thread's acquire-release add;
- ``288 threads``: launch bounds of 288 threads (8 consumer warps and the
  producer) instead of 416, which lets the compiler give a thread more
  registers; a launch of 3 row groups (g > 32) would fail, so it is timed
  at one row group only.

Probes (their outputs are not the function's, so they are timed but not
checked) cut the kernel short to show where a launch's time goes:

- ``probe: empty``: every block returns once it has its split (the launch,
  the grid and the timing's own floor);
- ``probe: no merge``: blocks return after their last tile (no merge of
  the warps or splits, no output);
- ``probe: no P V``: the tiles' P V is skipped (loads, S and the softmax
  stay).

Every variant is first held against the plain version at each shape
(``ref.decode_attention_tolerance``), then timed in rounds, the variants
and SDPA one after the other in each round (the order reversed every other
round), each a median of 10 CUDA-event pairs with the 50 MB L2 flushed and
a 2 ms spin before each, at the Qwen2.5-14B and Qwen3-MoE decode steps at
``valid_len`` 64 and 1,056 and at one ``decode_32k`` layer.  Prints one
JSON object per shape, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref

mod = importlib.import_module("repro_torch.kernels.decode_attention")

VARIANTS = {
    "shipped": [],
    "one set": [("  const int warps = kSlices * groups * (groups == 1 ? 2 : 1);\n",
                 "  const int warps = kSlices * groups;\n")],
    "shared carveout": [(
        "    if (e != cudaSuccess) return static_cast<int>(e);\n    ready = true;\n"
        "  }\n  // one row group",
        "    if (e != cudaSuccess) return static_cast<int>(e);\n"
        "    cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
        "    ready = true;\n  }\n  // one row group")],
    "merge unrolled 8": [("#pragma unroll 4\n    for (int sp = 0; sp < splits; ++sp) {",
                          "#pragma unroll 8\n    for (int sp = 0; sp < splits; ++sp) {")],
    "probe: empty": [("  if (split >= splits) return;\n",
                      "  if (split >= splits || splits > 0) return;\n")],
    "probe: no merge": [("  float* my_ml = ml_s + warp * kRows * 2;\n",
                         "  if (splits > 0) return;\n"
                         "  float* my_ml = ml_s + warp * kRows * 2;\n")],
    "probe: no P V": [("      for (int p = nlo; p < nv; ++p) {\n",
                       "      for (int p = nlo; p < nv * 0; ++p) {\n")],
    "fenced counter": [
        ("  named_barrier(1, cthreads);\n  if (ctid == 0) {\n    int done;\n"
         "    asm volatile(\"atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\\n\"\n"
         "                 : \"=r\"(done) : \"l\"(&counters[pair]) : \"memory\");\n",
         "  __threadfence();\n  named_barrier(1, cthreads);\n  if (ctid == 0) {\n"
         "    const int done = atomicAdd(&counters[pair], 1);\n"),
        ("  if (!*last_flag) return;\n",
         "  if (!*last_flag) return;\n  __threadfence();\n")],
    "288 threads": [("__global__ void __launch_bounds__(kMaxTmaThreads, 1)\ndecode_tma(",
                     "__global__ void __launch_bounds__(288, 1)\ndecode_tma(")],
}
SHAPES = {  # name: B, H, KVH, T, valid
    "serving, valid 64": (4, 40, 8, 2048, 64),
    "serving": (4, 40, 8, 2048, 1056),
    "moe, valid 64": (4, 64, 4, 2048, 64),
    "moe": (4, 64, 4, 2048, 1056),
    "32k": (128, 40, 8, 32768, 32768)}
L2 = 50 * 2 ** 20


def variant_source(name: str) -> str:
    src = (_build.CSRC / "decode_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the text to replace occurs "
                               f"{src.count(old)} times in the source")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """Compile every variant (one nvcc each, all at once) and load them."""
    out_dir = _build.BUILD_DIR / "decode_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(VARIANTS):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(variant_source(name))
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log}")
        f = ctypes.CDLL(str(so)).teshu_decode_attention_tma
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        f.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64,
                      i64, i64, i64, ctypes.c_float, p]
        f.restype = ctypes.c_int
        libs[name] = f
    return libs


def _launch(f, q, k, v, valid):
    """What the wrapper does for decode_tma, with the variant's entry."""
    b, h, d = q.shape
    _, t, kvh, _ = k.shape
    g, pairs = h // kvh, b * kvh
    grid = mod.grid_splits(pairs, t, mod._sm_count(0))
    out = torch.empty_like(q)
    acc = torch.empty((pairs, grid, g, d), dtype=torch.float32, device=q.device)
    ml = torch.empty((pairs, grid, g, 2), dtype=torch.float32, device=q.device)
    cnt = mod._counters(q.device, pairs)
    _build.check(f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   acc.data_ptr(), ml.data_ptr(), cnt.data_ptr(), None, None,
                   valid, b, t, kvh, g, d, 0, grid, d ** -0.5,
                   _build.stream_of(q)),
                 "decode variant")
    return out


def _ms(fn, flush, reps=10):
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    scratch = torch.ones(2 * L2 // 4, device=dev)
    lines = []
    for shape, (b, h, kvh, t, valid) in SHAPES.items():
        q = torch.randn((b, h, 128), device=dev, generator=gen).bfloat16()
        k, v = (torch.randn((b, t, kvh, 128), device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        n = min(b, 16)
        kv = (k[:n, :valid], v[:n, :valid])
        plain = ref.decode_attention_ref(q[:n], *kv, valid)
        tol = ref.decode_attention_tolerance(q[:n], *kv, valid, plain)
        fns = {name: (lambda f=f: _launch(f, q, k, v, valid))
               for name, f in libs.items()}
        if shape != "32k":
            q4 = q.view(b, h, 1, 128)
            k4, v4 = (x[:, :valid].transpose(1, 2) for x in (k, v))
            fns["SDPA"] = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, enable_gqa=True)
        row = {"shape": shape, "share": {}, "ms": {}}
        for name in libs:
            got = fns[name]()
            if name.startswith("probe"):
                continue
            row["share"][name] = float(((got[:n].float() - plain.float())
                                        .abs() / tol).max())
            assert row["share"][name] <= 1.0, (shape, name, row["share"])
        times = {name: [] for name in fns}
        for r in range(args.rounds):
            order = list(fns) if r % 2 == 0 else list(fns)[::-1]
            for name in order:
                times[name].append(_ms(fns[name], scratch.sum))
        row["ms"] = {name: statistics.median(x) for name, x in times.items()}
        print(json.dumps(row), flush=True)
        lines.append(row)
        del q, k, v, plain, tol, kv, fns
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write(smi + "\n" + "\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
