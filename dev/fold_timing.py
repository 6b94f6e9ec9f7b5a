"""Time ``segmented_fold`` on the card on the layouts the shuffle hands it,
measure the card's dependent float64 add latency, and run the kernel's
design variants (a development script: not part of the package or its
tests).

    PYTHONPATH=src python dev/fold_timing.py [--rounds N] [--out FILE]
        [--layouts uniform,zipf,chain,hits] [--tdadd] [--variants]
        [--only "NAME;NAME"] [--sass FILE]

It imports ``repro_torch`` from ``PYTHONPATH``, so the same script times
another checkout of the port (``PYTHONPATH=<checkout>/src``; compare two
in turns: parent, new, new, parent).  Layouts, float64 of width d = 8 made
from a seed, n = 8M rows but for ``chain``:

- ``uniform``: segments of 1..64 rows (``chip_smoke.py``'s fold row);
- ``zipf``: the shuffle's global stage, rows sorted destination-major and
  key ascending over Zipf(0.9) keys of 1M (one hot key: 263,532 rows);
- ``chain``: the hot key alone, one segment of 263,532 rows (n = 263,532);
- ``hits``: the folds of one ``network_aware`` and one ``vanilla_push``
  cached-plan hit on the paper-40 deployment (40 workers x 200k rows of
  width 8), captured by wrapping the fold during the hit.

Every launch is first held bit for bit (NaN = NaN) against the plain
version on a CPU copy, then timed in rounds, each a median of 10 CUDA-event
pairs.  ``--tdadd`` times one thread's chain of 2^22 dependent DADDs with
CUDA events and ``clock64``: the latency that bounds a long segment's
fold.  ``--variants`` rebuilds ``csrc/fold.cu`` with other tile sizes,
stages, blocks per SM or consumer warps, or another text replaced
(``VARIANTS``, each a list of replacements; ``--only "name;name"`` picks
some) and times each
on the uniform, Zipf and chain layouts beside the shipped build; a
"probe" variant changes what the kernel computes (it is timed, not
checked), and the clock64 probe prints the cycles the busiest blocks'
producer and first consumer thread spend on each step.  ``--sass FILE``
writes the shipped library's SASS.  Prints one JSON object per layout,
variant and probe, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.fold import segmented_fold

HBM = 3.35e12
N, D = 8_000_000, 8
WORKERS, ROWS_PER_WORKER, KEYS, ALPHA = 40, 200_000, 1_000_000, 0.9
# the clock64 probe: cycles of the busiest blocks' producer (scan, wait
# for a free stage, store, fill) and consumer thread 0 (wait, walk)
CLOCK_SUBS = [
    ("#include <cstdint>\n", "#include <cstdint>\n#include <cstdio>\n"),
    ("    int64_t uses = 0, stored = 0;\n",
     "    int64_t uses = 0, stored = 0;\n"
     "    long long c_scan = 0, c_wait = 0, c_store = 0, c_fill = 0, c0;\n"),
    ("        const int64_t j = uses - kStages;  // the use the stage last held\n",
     "        c0 = clock64();\n"
     "        const int64_t j = uses - kStages;  // the use the stage last held\n"),
    ("      ++uses;\n      Meta m{item, kind, count, valid, 0, ra, rb};\n",
     "      if (uses >= kStages) c_wait += clock64() - c0;\n"
     "      c0 = clock64();\n"
     "      ++uses;\n      Meta m{item, kind, count, valid, 0, ra, rb};\n"),
    ("      cp_async_arrive(&full[s]);\n",
     "      cp_async_arrive(&full[s]);\n"
     "      c_fill += clock64() - c0;\n"),
    ("        scan(u, had, cur, umine, ufirst);\n",
     "        c0 = clock64();\n"
     "        scan(u, had, cur, umine, ufirst);\n"
     "        c_scan += clock64() - c0;\n"),
    ("        store_released();\n        if (ufirst < uvalid || ++u >= a.row_tiles) break;\n",
     "        c0 = clock64();\n"
     "        store_released();\n"
     "        c_store += clock64() - c0;\n"
     "        if (ufirst < uvalid || ++u >= a.row_tiles) break;\n"),
    ("    asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: \"memory\");\n",
     "    asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: \"memory\");\n"
     "    if (lane == 0 && c_scan + c_wait + c_store + c_fill > 1000000)\n"
     "      printf(\"probe block %d producer: stages %lld scan %lld wait %lld "
     "store %lld fill %lld\\n\", blockIdx.x, (long long)uses, c_scan, "
     "c_wait, c_store, c_fill);\n"),
    ("    double carry = 0.0;  // column ct of the last segment, while it runs on\n",
     "    double carry = 0.0;  // column ct of the last segment, while it runs on\n"
     "    long long c_wait = 0, c_work = 0, c1 = clock64();\n"),
    ("      mbar_wait(&full[s], static_cast<uint32_t>((uses / kStages) & 1));\n",
     "      mbar_wait(&full[s], static_cast<uint32_t>((uses / kStages) & 1));\n"
     "      { const long long t = clock64(); c_wait += t - c1; c1 = t; }\n"),
    ("      // the producer's bulk store reads what the generic stores wrote\n",
     "      { const long long t = clock64(); c_work += t - c1; c1 = t; }\n"
     "      // the producer's bulk store reads what the generic stores wrote\n"),
    ("      if (lane == 0) mbar_arrive(&empty[s]);\n    }\n",
     "      if (lane == 0) mbar_arrive(&empty[s]);\n    }\n"
     "    if (ct == 0 && c_work > 1000000)\n"
     "      printf(\"probe block %d consumer 0: wait %lld walk %lld\\n\", "
     "blockIdx.x, c_wait, c_work);\n"),
]

# the shipped design's constants, as csrc/fold.cu spells them
SHIPPED = {"kTileElems": "4096;  // doubles a stage holds: 32 KB",
           "kStages": "2;", "kBlocksPerSm": "2;", "kConsumerWarps": "8;"}


def _set(**values) -> list:
    """Replacements that give the shipped constants other values."""
    return [(f"constexpr int {k} = {SHIPPED[k]}", f"constexpr int {k} = {v};")
            for k, v in values.items()]


# name: replacements of texts of the shipped source.  A "probe" changes
# what the kernel computes and is timed but not checked.
VARIANTS = {
    "tile 2048": _set(kTileElems=2048),
    "tile 8192, 1 block/SM": _set(kTileElems=8192, kBlocksPerSm=1),
    "3 stages": _set(kStages=3),
    "tile 8192, 3 stages, 1 block/SM": _set(kTileElems=8192, kStages=3,
                                            kBlocksPerSm=1),
    "3 blocks/SM": _set(kBlocksPerSm=3),
    "4 stages, 1 block/SM": _set(kStages=4, kBlocksPerSm=1),
    "4 consumer warps": _set(kConsumerWarps=4),
    "rows read 8 ahead": [("constexpr int kBatch = 16;",
                           "constexpr int kBatch = 8;")],
    "consumer warps 2.. sleep while they wait": [
        ("      mbar_wait(&full[s], static_cast<uint32_t>((uses / kStages) & 1));\n",
         "      if (warp == 1) {\n"
         "        mbar_wait(&full[s], static_cast<uint32_t>((uses / kStages) & 1));\n"
         "      } else {\n"
         "        uint32_t ok = 0;\n"
         "        while (true) {\n"
         "          asm volatile(\"{\\n.reg .pred p;\\n\"\n"
         "              \"mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n\"\n"
         "              \"selp.u32 %0, 1, 0, p;\\n}\\n\" : \"=r\"(ok)\n"
         "              : \"r\"(smem_u32(&full[s])),\n"
         "                \"r\"(static_cast<uint32_t>((uses / kStages) & 1)) : \"memory\");\n"
         "          if (ok) break;\n"
         "          __nanosleep(256);\n"
         "        }\n"
         "      }\n")],
    "register cap of one block an SM": [
        ("__launch_bounds__(kThreads, kBlocksPerSm)",
         "__launch_bounds__(kThreads, 1)")],
    "probe: no stores of out": [
        ("        store_run(a.out + e, sv + i, len);\n", "")],
    "probe: the carry's walks do nothing": [
        ("    if (ct < dcur) carry = walk<OP, PITCH>(carry, sv + ct, pitch, 0, "
         "m.rb);\n", "")],
    "probe: a long segment's tiles are not scanned (right for chain only)": [
        ("        scan(u, had, cur, umine, ufirst);\n",
         "        ufirst = uvalid;\n")],
    "probe: clock64 spans, printed": CLOCK_SUBS,
}

TDADD_SRC = r"""
#include <cstdint>
// one thread: n dependent DADDs, unrolled 8; cycles by clock64 into out[1]
__global__ void chain(double* out, double x, double y, int64_t n) {
  double acc = x;
  const long long t0 = clock64();
#pragma unroll 8
  for (int64_t i = 0; i < n; ++i) acc = __dadd_rn(acc, y);
  const long long t1 = clock64();
  out[0] = acc;
  out[1] = static_cast<double>(t1 - t0);
}
extern "C" int chain_run(void* out, double x, double y, int64_t n,
                         void* stream) {
  chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), x, y, n);
  return static_cast<int>(cudaGetLastError());
}
"""


def _ms(fn, reps=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _same_bits(got, plain) -> bool:
    return bool(((got.view(torch.int64) == plain.view(torch.int64))
                 | (got.isnan() & plain.isnan())).all())


def _bound_ms(n, d) -> float:
    return (n + 16 * n * d) / HBM * 1e3


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def uniform_layout(dev, gen):
    lens = torch.randint(1, 65, (N,), device=dev, generator=gen)
    starts = torch.cumsum(lens, 0)
    starts = starts[starts < N]
    is_start = torch.zeros(N, dtype=torch.bool, device=dev)
    is_start[0] = True
    is_start[starts] = True
    vals = torch.randn((N, D), dtype=torch.float64, device=dev, generator=gen)
    return is_start, vals


def zipf_layout(dev, gen):
    """``chip_smoke.py``'s global-stage layout: sorted by (destination slot,
    key), a segment per (slot, key)."""
    from repro_torch.core import torchplan
    w = torch.arange(1, KEYS + 1, dtype=torch.float64, device=dev) ** -ALPHA
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(N, dtype=torch.float64, device=dev, generator=gen)
    keys = torch.searchsorted(cdf, u).clamp_(max=KEYS - 1)
    vals = torch.rand((N, D), dtype=torch.float32, device=dev, generator=gen)
    slot = torchplan._slot_of(("hash",), keys, WORKERS)
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(slot[order], stable=True).indices]
    sk, ss = keys[order], slot[order]
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = (sk[1:] != sk[:-1]) | (ss[1:] != ss[:-1])
    return head.contiguous(), vals[order].double().contiguous()


def hit_layouts(dev):
    """The fold calls of one cached-plan hit per template, captured."""
    import repro_torch.core as port
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    ranks = np.arange(1, KEYS + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -ALPHA)
    cdf /= cdf[-1]
    bufs = {w: port.Msgs(np.searchsorted(cdf, rng.random(ROWS_PER_WORKER))
                         .astype(np.int64), rng.random((ROWS_PER_WORKER, D)))
            for w in range(WORKERS)}
    topo = port.datacenter(4, 5, 2, intra_server_bw=12.5e9,
                           intra_rack_bw=1.25e9, oversubscription=10.0)
    ws = list(range(WORKERS))
    out = {}
    orig = ops.segmented_fold_kernel
    for template in ("network_aware", "vanilla_push"):
        client = port.TeShuCluster(topo, device=dev).tenant()
        client.shuffle(template, {w: m.copy() for w, m in bufs.items()}, ws,
                       ws, comb_fn=port.SUM)
        calls = []

        def capture(op, is_start, vals):
            calls.append((op, is_start.clone(), vals.clone()))
            return orig(op, is_start, vals)
        ops.segmented_fold_kernel = capture
        try:
            hit = client.shuffle(template, {w: m.copy() for w, m in
                                            bufs.items()}, ws, ws,
                                 comb_fn=port.SUM)
        finally:
            ops.segmented_fold_kernel = orig
        assert hit.cached and hit.engine == "torch", hit.engine
        for i, c in enumerate(calls):
            out[f"{template} fold {i + 1} of {len(calls)}"] = c
    return out


def _describe(is_start) -> dict:
    starts = is_start.clone()
    starts[0] = True
    idx = torch.nonzero(starts).flatten()
    lens = torch.diff(torch.cat([idx, idx.new_full((1,), is_start.numel())]))
    return dict(n=is_start.numel(), segments=int(lens.numel()),
                longest_segment=int(lens.max()))


# ---------------------------------------------------------------------------
# t_dadd and variants
# ---------------------------------------------------------------------------

def _nvcc_lib(name: str, src: Path) -> ctypes.CDLL:
    outdir = _build.BUILD_DIR.parent / "fold_dev"
    outdir.mkdir(parents=True, exist_ok=True)
    so = outdir / f"{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    f"-I{_build.CSRC}", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def tdadd(dev) -> list[dict]:
    outdir = _build.BUILD_DIR.parent / "fold_dev"
    outdir.mkdir(parents=True, exist_ok=True)
    src = outdir / "chain.cu"
    src.write_text(TDADD_SRC)
    lib = _nvcc_lib("chain", src)
    f = lib.chain_run
    f.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
                  ctypes.c_int64, ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = 1 << 22
    ms = _ms(lambda: _build.check(f(out.data_ptr(), 1.0, 1e-9, n, stream),
                                  "chain"), reps=5)
    cycles = float(out[1]) / n
    return [dict(probe="t_dadd", steps=n, ns=ms * 1e6 / n, cycles=cycles,
                 ghz=cycles / (ms * 1e6 / n))]


def variant_fns(dev, only=None) -> dict:
    """A launcher per variant, each built from ``csrc/fold.cu`` with its
    replacements (every replaced text must be in the source)."""
    fns = {}
    wanted = None if only is None else set(only)
    counter = torch.zeros(2, dtype=torch.int64, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    shipped = (_build.CSRC / "fold.cu").read_text()
    outdir = _build.BUILD_DIR.parent / "fold_dev"
    outdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, subs) in enumerate(VARIANTS.items()):
        if wanted is not None and name not in wanted:
            continue
        text = shipped
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in fold.cu")
            text = text.replace(old, new)
        src, so = outdir / f"variant{i}.cu", outdir / f"variant{i}.so"
        src.write_text(text)
        procs.append((name, so, subprocess.Popen(     # all nvcc at once
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-o", str(so), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        f = ctypes.CDLL(str(so)).teshu_segmented_fold
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int

        def run(op, s, v, f=f):
            o = torch.empty_like(v)
            _build.check(f(s.data_ptr(), v.data_ptr(), o.data_ptr(),
                           counter.data_ptr(), v.shape[0], v.shape[1],
                           ("sum", "min", "max").index(op), sms, stream),
                         "variant")
            return o
        fns[name] = run
    return fns


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--layouts", default="uniform,zipf,hits")
    ap.add_argument("--tdadd", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--only", default=None,
                    help="variant names to run, separated by ';' (default all)")
    ap.add_argument("--sass", default=None,
                    help="write the shipped fold library's SASS here")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    import repro_torch
    print(f"package: {os.path.dirname(repro_torch.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    lines = []

    def emit(row):
        print(json.dumps(row), flush=True)
        lines.append(row)

    if args.tdadd:
        for row in tdadd(dev):
            emit(row)
    wanted = args.layouts.split(",") if args.layouts else []
    layouts = {}
    if "uniform" in wanted:
        layouts["uniform"] = ("sum", *uniform_layout(dev, gen))
    if "zipf" in wanted:
        layouts["zipf"] = ("sum", *zipf_layout(dev, gen))
    if "chain" in wanted:     # the hot key alone: one segment
        s = torch.zeros(263_532, dtype=torch.bool, device=dev)
        layouts["chain"] = ("sum", s, torch.randn(
            (263_532, D), dtype=torch.float64, device=dev, generator=gen))
    if "hits" in wanted:
        layouts.update(hit_layouts(dev))
    fns = {"shipped": lambda op, s, v: segmented_fold(op, s, v)}
    if args.sass:
        segmented_fold("sum", torch.ones(2, dtype=torch.bool, device=dev),
                       torch.ones((2, 2), dtype=torch.float64, device=dev))
        cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
        Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass).write_text(subprocess.run(
            [str(cuobjdump), "--dump-sass", str(_build._target("fold"))],
            check=True, capture_output=True, text=True).stdout)
    if args.variants:
        fns.update(variant_fns(dev, None if args.only is None
                               else args.only.split(";")))
    for name, (op, s, v) in layouts.items():
        t0 = time.perf_counter()
        plain = ref.segmented_fold_ref(op, s.cpu(), v.cpu())
        check_s = time.perf_counter() - t0
        n, d = v.shape
        for fname, fn in fns.items():
            if fname != "shipped" and name not in ("uniform", "zipf", "chain"):
                continue
            exact = None if fname.startswith("probe") else _same_bits(
                fn(op, s, v).cpu(), plain)
            ms = [_ms(lambda: fn(op, s, v)) for _ in range(args.rounds)]
            emit(dict(layout=name, kernel=fname, op=op, d=d, **_describe(s),
                      bit_identical=exact, ms=ms,
                      ms_median=statistics.median(ms),
                      bound_ms=_bound_ms(n, d), plain_check_s=check_s))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            f.write(smi + "\n" + "\n".join(json.dumps(x) for x in lines)
                    + "\n")


if __name__ == "__main__":
    main()
