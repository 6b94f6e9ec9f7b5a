"""Time variants of the ``flash_wgmma`` kernel against the shipped one on
the card (a development script: not part of the package or its tests).

    PYTHONPATH=src python dev/flash_schedules.py [--out FILE]

``src/repro_torch/kernels/csrc/flash_attention.cu`` keeps one consumer schedule: the two consumer
warpgroups take turns to issue their products (named barriers), and inside
a turn S of tile t goes out before PV of tile t - 1, so that the softmax of
tile t runs under PV.  This script rebuilds the flash library from that
source with one block of the kernel replaced, so that the alternatives stay
measurable without a switch in the kernel.  Each replaced text must occur
exactly once in the source; after an edit of the kernel, bring the texts
here up to date before timing:

- ``sequential``: S, softmax and PV of a tile in turn, no turns;
- ``intra``: S of tile t before PV of tile t - 1, no turns;
- ``turns, sequential``: turns around each product, the products in turn;
- ``global order``: the shipped schedule, the blocks ordered longest causal
  rows first over all heads (the shipped grid does so within each head);
- ``staged epilogue``: the shipped schedule, the output staged through the
  warpgroup's Q rows in shared memory for 16-byte stores.

Every variant is held against the plain version at each shape
(``ref.flash_attention_tolerance``) and then timed in rounds, the variants
and SDPA one after the other in each round (the order reversed every other
round), each a median of 10 CUDA-event pairs after a 2 ms spin, at the
Qwen2.5-14B prefill, the Qwen3-MoE prefill, a head-width-64 shape and
4,096 tokens (causal and not).  It prints one JSON object per shape, with
TFLOP/s (4 D operations per query-key pair the mask keeps), and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

from repro_torch.kernels import _build

# name -> [(text of the shipped source, its replacement)]; each text must
# occur exactly once
_NO_TURNS = [
    ("  auto turn_begin = [&] { named_barrier(1 + cw, 256); };\n",
     "  auto turn_begin = [&] {};\n"),
    ("  auto turn_end = [&](bool last) {\n"
     "    if (!(last && cw == 1)) named_barrier_arrive(2 - cw, 256);\n"
     "  };\n", "  auto turn_end = [&](bool) {};\n"),
    ("  if (cw == 1) named_barrier_arrive(1, 256);\n", ""),
]
_SEQUENTIAL_LOOP = """  mbar_wait(q_full, 0);
  float alpha[2];
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kWStages;
    const uint32_t ph = (t / kWStages) & 1;
    mbar_wait(&k_full[s], ph);
    turn_begin();
    issue_s(t);
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(sc);
    if (tid == 0) mbar_arrive(&k_empty[s]);
    softmax(t, alpha);
    rescale(alpha);
    pack();
    mbar_wait(&v_full[s], ph);
    turn_begin();
    issue_pv(t);
    turn_end(t + 1 == n_tiles);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pk);
    if (tid == 0) mbar_arrive(&v_empty[s]);
  }

"""
_LOOP_START = "  mbar_wait(q_full, 0);\n  float alpha[2];\n  mbar_wait(&k_full[0], 0);\n"
_EPILOGUE = "  bf16* ob = out + static_cast<int64_t>(bh) * sq * D;\n"
_STAGED = _EPILOGUE + """  {
    uint8_t* stage = smem + cw * 64 * 128;   // Q rows: no longer read
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const float den = l[h] == 0.0f ? 1.0f : l[h];
      const int r = 16 * (tid / 32) + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            stage + (j / 8) * kWBoxBytes + r * 128
            + ((j % 8) ^ (r % 8)) * 16 + c_lane * 2) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / den,
                                  o[4 * j + 2 * h + 1] / den);
    }
    named_barrier(3 + cw, 128);
    for (int idx = tid; idx < 64 * (D / 8); idx += 128) {
      const int r = idx / (D / 8), j = idx % (D / 8);
      const int row = q0 + 64 * cw + r;
      if (row < sq)
        *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(row) * D + 8 * j)
            = *reinterpret_cast<const uint4*>(
                stage + (j / 8) * kWBoxBytes + r * 128
                + ((j % 8) ^ (r % 8)) * 16);
    }
    return;
  }
"""


def _sequential_loop(src: str) -> str:
    """The shipped consumer loop (from the Q wait to the epilogue) replaced
    by the sequential one."""
    a, b = src.index(_LOOP_START), src.index(_EPILOGUE)
    return src[:a] + _SEQUENTIAL_LOOP + src[b:]


VARIANTS = {
    "shipped": [],
    "sequential": _NO_TURNS + [_sequential_loop],
    "intra": _NO_TURNS,
    "turns, sequential": [_sequential_loop],
    "global order": [(
        "  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kWBQ;\n"
        "  const int bh = blockIdx.y;\n",
        "  const int lin = blockIdx.x + gridDim.x * blockIdx.y;\n"
        "  const int q0 = (nq - 1 - lin / static_cast<int>(gridDim.y)) * kWBQ;\n"
        "  const int bh = lin % gridDim.y;\n")],
    "staged epilogue": [(_EPILOGUE, _STAGED)],
}
SHAPES = {  # name: (BHq, BHkv, S, D, causal), batch 4
    "qwen2.5-14b prefill": (160, 32, 1024, 128, True),
    "qwen3-moe prefill": (256, 16, 1024, 128, True),
    "d64 (25 q / 5 kv heads)": (100, 20, 1024, 64, True),
    # 4,096 tokens: a block walks up to 32 kv tiles (all 32 when not
    # causal), so block start, epilogue and the last wave weigh less
    "s4096 (10 q / 2 kv heads)": (40, 8, 4096, 128, True),
    "s4096 non-causal": (40, 8, 4096, 128, False),
}
BATCH = 4
ROUNDS = 4


def _ops(bhq: int, s: int, d: int, causal: bool) -> float:
    """4 D operations (QK^T and PV) per query-key pair the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4.0 * d * pairs * bhq


def variant_source(name: str) -> str:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for patch in VARIANTS[name]:
        if callable(patch):
            src = patch(src)
            continue
        old, new = patch
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the text to replace occurs "
                               f"{src.count(old)} times in the source")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """Compile every variant (one nvcc each, all at once) and load them."""
    out_dir = _build.BUILD_DIR / "flash_variants"
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
        f = ctypes.CDLL(str(so)).teshu_flash_attention
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i32, i32,
                      ctypes.c_float, i32, i64, p]
        f.restype = ctypes.c_int
        libs[name] = f
    return libs


def _time_ms(fn, reps: int = 10) -> float:
    import torch
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


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_schedules: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    results = []
    for shape, (bhq, bhkv, s, d, causal) in SHAPES.items():
        q, k, v = (torch.randn((n, s, d), device=dev, generator=gen,
                               dtype=torch.bfloat16)
                   for n in (bhq, bhkv, bhkv))
        out = torch.empty_like(q)
        st = torch.cuda.current_stream().cuda_stream

        def run(f):
            _build.check(f(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), bhq, bhkv, s, s, d, 1, 1,
                           d ** -0.5, int(causal), 0, st), "flash variant")
        plain = ref.flash_attention_ref(q, k, v, causal=causal)
        tol = ref.flash_attention_tolerance(q, k, v, plain, causal=causal)
        share = {}
        for name, f in libs.items():
            out.zero_()
            run(f)
            torch.cuda.synchronize()
            share[name] = float(((out.float() - plain.float()).abs()
                                 / tol).max())
            assert share[name] <= 1.0, (shape, name, share[name])
        del plain, tol
        q4, k4, v4 = (x.view(BATCH, -1, s, d) for x in (q, k, v))
        calls = {name: (lambda f=f: run(f)) for name, f in libs.items()}
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True)
        ms = {name: [] for name in calls}
        for r in range(ROUNDS):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                ms[name].append(_time_ms(calls[name]))
        med = {n: statistics.median(t) for n, t in ms.items()}
        ops = _ops(bhq, s, d, causal)
        row = dict(shape=shape, q=[bhq, s, d], kv=[bhkv, s, d],
                   causal=causal, ms=ms, median_ms=med,
                   tflop_per_s={n: ops / t / 1e9 for n, t in med.items()},
                   bound_share=share, card=smi)
        print(json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, out, q4, k4, v4
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
