"""Time PART (``partition_permute``) and COMB (``segment_combine``) on the
card on the layouts the shuffle's global stage hands them, beside their
one-call yardsticks, and run the kernels' design variants and probes (a
development script: not part of the package or its tests).

    PYTHONPATH=src python dev/part_comb_timing.py [--rounds N] [--out FILE]
        [--variants] [--only "NAME;NAME"] [--parent DIR]

It imports ``repro_torch`` from ``PYTHONPATH``, so the same script times
another checkout of the port (``PYTHONPATH=<checkout>/src``; compare two
in turns: parent, new, new, parent).  Layouts, float32 of width d = 8 made
from a seed, n = 8M rows (``chip_smoke.py``'s):

- ``part``: a random permutation of the rows into ``num_out = n`` slots,
  as ``torchplan.kernel_global_stage`` passes PART (``unique_slots``);
- ``comb``: the global stage's segment ids: rows sorted destination-major
  and key ascending over Zipf(0.9) keys of 1M, 40 destinations, ids
  compacted to the (destination, key) pairs present (about 851,889
  segments, the longest about 263,532 rows);
- ``comb_unsorted``: the same ids and rows in a random row order.

Every launch is first checked (PART bit for bit against the plain version,
COMB within ``len_seg * 2^-24 * sum|v|`` of the exact float64 sums), then
timed in rounds, each a median of 10 CUDA-event pairs (the card spins
about 2 ms before each, so that the host's launch latency stays out of the
time).  ``index_copy_`` and
``index_add_`` on the same inputs are timed beside them.  ``--variants``
rebuilds ``csrc/partition.cu`` or ``csrc/combine.cu`` with texts replaced
(``VARIANTS``; every replaced text must be in the source; ``--only``
picks some): a variant "of the parent" is built from the source under
``--parent DIR`` (a checkout of the parent commit), so that the old
kernels' probes (the scatter without its memset, COMB without its atomics
or its scans) run in the same process.  A "probe" changes what the kernel
computes: it is timed, not checked.  Prints one JSON object per layout,
kernel and variant, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.combine import segment_combine
from repro_torch.kernels.partition import partition_permute

HBM = 3.35e12
U32 = 2.0 ** -24
N, D = 8_000_000, 8
WORKERS, KEYS, ALPHA = 40, 1_000_000, 0.9

PART_INV_RED = "atomicMax(inv + s[j], static_cast<int32_t>(i0 + j));"
# the gather's direct 16-byte stores, and the block's units staged in
# shared memory and written by one 1-D bulk store
PART_DIRECT = """#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int64_t e = base + k * kThreads;
    if (e < units) out[e] = v[k];
  }
"""
PART_BULK = """  if constexpr (sizeof(U) == 16) {
    __shared__ __align__(128) U staged[kThreads * kInFlight];
    const int64_t b0 = base - threadIdx.x;
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) staged[k * kThreads + threadIdx.x] = v[k];
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const int64_t count = units - b0 < kThreads * kInFlight
                                ? units - b0 : kThreads * kInFlight;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n" ::"l"(
              reinterpret_cast<uint64_t>(out + b0)),
          "r"(static_cast<uint32_t>(__cvta_generic_to_shared(staged))),
          "r"(static_cast<uint32_t>(count * sizeof(U))) : "memory");
      asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
    }
  } else {
""" + PART_DIRECT + "  }\n"

# an L2 access-policy window over inv on the stream while PART runs
PART_L2_WINDOW = [
    ("    cudaMemsetAsync(inv, 0xff, num_out * sizeof(int32_t), stream);  // -1\n",
     "    int dev = 0, most = 0;\n"
     "    cudaGetDevice(&dev);\n"
     "    cudaDeviceGetAttribute(&most, cudaDevAttrMaxPersistingL2CacheSize, dev);\n"
     "    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, most);\n"
     "    cudaStreamAttrValue w{};\n"
     "    w.accessPolicyWindow.base_ptr = inv;\n"
     "    w.accessPolicyWindow.num_bytes = num_out * sizeof(int32_t);\n"
     "    w.accessPolicyWindow.hitRatio = w.accessPolicyWindow.num_bytes > "
     "static_cast<size_t>(most) ? float(most) / w.accessPolicyWindow.num_bytes : 1.0f;\n"
     "    w.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;\n"
     "    w.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;\n"
     "    cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow, &w);\n"
     "    cudaMemsetAsync(inv, 0xff, num_out * sizeof(int32_t), stream);  // -1\n"),
    ("      gather<typename Bits<T>::type>(inv, vals, out, out_elems, d, stream);\n"
     "    return cudaGetLastError();\n",
     "      gather<typename Bits<T>::type>(inv, vals, out, out_elems, d, stream);\n"
     "    cudaStreamSynchronize(stream);\n"
     "    w.accessPolicyWindow.num_bytes = 0;\n"
     "    cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow, &w);\n"
     "    cudaCtxResetPersistingL2Cache();\n"
     "    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);\n"
     "    return cudaGetLastError();\n"),
]

# the device's L2 fetch granularity at 32 bytes (a sector) while PART runs
PART_FETCH_32 = [
    ("    cudaMemsetAsync(inv, 0xff, num_out * sizeof(int32_t), stream);  // -1\n",
     "    size_t fetch = 0;\n"
     "    cudaDeviceGetLimit(&fetch, cudaLimitMaxL2FetchGranularity);\n"
     "    cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, 32);\n"
     "    cudaMemsetAsync(inv, 0xff, num_out * sizeof(int32_t), stream);  // -1\n"),
    ("      gather<typename Bits<T>::type>(inv, vals, out, out_elems, d, stream);\n"
     "    return cudaGetLastError();\n",
     "      gather<typename Bits<T>::type>(inv, vals, out, out_elems, d, stream);\n"
     "    cudaStreamSynchronize(stream);\n"
     "    cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, fetch);\n"
     "    return cudaGetLastError();\n"),
]

PART_HINTS = [("? vals[src[k]] : U{};", "? __ldcs(vals + src[k]) : U{};")]
# another design for the main path: each row scattered to its slot, 4 bytes
# a lane (8 lanes a 32-byte row, as index_copy_ does), the rows that receive
# one marked in a bitmap, and the unmarked rows zeroed after
PART_SCATTER_KERNELS = ("""template <typename T>
__global__ void scatter_add(""", """__global__ void __launch_bounds__(kThreads)
    scatter_mark(const int32_t* __restrict__ slots,
                 const uint32_t* __restrict__ vals, uint32_t* __restrict__ out,
                 uint32_t* __restrict__ bits, int64_t n, int64_t wpr, int wshift,
                 int64_t num_out) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kInFlight) + threadIdx.x;
  int32_t s[kInFlight];
  uint32_t v[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int64_t e = base + k * kThreads;
    const int64_t row = wshift >= 0 ? e >> wshift : e / wpr;
    s[k] = e < n * wpr ? slots[row] : -1;
    v[k] = e < n * wpr ? vals[e] : 0u;
  }
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int64_t e = base + k * kThreads;
    if (s[k] < 0 || s[k] >= num_out) continue;
    const int64_t row = wshift >= 0 ? e >> wshift : e / wpr;
    const int64_t c = e - row * wpr;
    out[static_cast<int64_t>(s[k]) * wpr + c] = v[k];
    if (c == 0) atomicOr(bits + (s[k] >> 5), 1u << (s[k] & 31));
  }
}

__global__ void zero_unhit(const uint32_t* __restrict__ bits,
                           uint32_t* __restrict__ out, int64_t num_out,
                           int64_t wpr) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= num_out * wpr) return;
  const int64_t row = e / wpr;
  if (!((bits[row >> 5] >> (row & 31)) & 1u)) out[e] = 0u;
}

template <typename T>
__global__ void scatter_add(""")
PART_SCATTER_LAUNCH = ("""    auto* inv = static_cast<int32_t*>(scratch);
    if (out_elems == 0) return cudaGetLastError();
    cudaMemsetAsync(inv, 0xff, num_out * sizeof(int32_t), stream);  // -1
    if (n > 0)
      build_inverse<<<blocks_for((n + 3) / 4), kThreads, 0, stream>>>(
          slots, inv, n, num_out);
    if (vec)
      gather<uint4>(inv, vals, out, out_elems / V, d / V, stream);
    else
      gather<typename Bits<T>::type>(inv, vals, out, out_elems, d, stream);
""", """    auto* bits = static_cast<uint32_t*>(scratch);
    if (out_elems == 0) return cudaGetLastError();
    const int64_t wpr = d * static_cast<int64_t>(sizeof(T)) / 4;
    int wshift = -1;
    for (int b = 0; b < 40; ++b)
      if ((int64_t{1} << b) == wpr) wshift = b;
    cudaMemsetAsync(bits, 0, (num_out + 31) / 32 * 4, stream);
    if (n > 0)
      scatter_mark<<<blocks_for(n * wpr, kThreads * kInFlight), kThreads, 0,
                     stream>>>(slots, reinterpret_cast<const uint32_t*>(vals),
                               reinterpret_cast<uint32_t*>(out), bits, n, wpr,
                               wshift, num_out);
    zero_unhit<<<blocks_for(num_out * wpr), kThreads, 0, stream>>>(
        bits, reinterpret_cast<uint32_t*>(out), num_out, wpr);
""")

# the inverse built window by window of out's rows, each window's build
# in the same launch as the gather of the window before (builder blocks
# first, 2 an SM), so the build's L2-bound writes overlap the gather's
# DRAM-bound reads; kernel boundaries order each window's build before
# its gather
PART_OVERLAP_KERNELS = ("""template <typename U>
void gather(const int32_t* inv,""", """constexpr int64_t kWindows = 4;

template <typename U>
__global__ void __launch_bounds__(kThreads)
    build_and_gather(const int32_t* __restrict__ slots,
                     int32_t* __restrict__ inv, int64_t n, int64_t lo,
                     int64_t hi, unsigned builders, const U* __restrict__ vals,
                     U* __restrict__ out, int64_t ulo, int64_t uhi,
                     int64_t upr, int shift) {
  if (blockIdx.x < builders) {
    const int64_t quads = (n + 3) / 4;
    for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         q < quads; q += static_cast<int64_t>(builders) * kThreads) {
      const int64_t i0 = 4 * q;
      int32_t s[4];
      if (i0 + 4 <= n && (reinterpret_cast<uintptr_t>(slots + i0) & 15) == 0) {
        const int4 w = *reinterpret_cast<const int4*>(slots + i0);
        s[0] = w.x; s[1] = w.y; s[2] = w.z; s[3] = w.w;
      } else {
        for (int j = 0; j < 4; ++j) s[j] = i0 + j < n ? slots[i0 + j] : -1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s[j] >= lo && s[j] < hi)
          atomicMax(inv + s[j], static_cast<int32_t>(i0 + j));
    }
    return;
  }
  const int64_t base = ulo +
      static_cast<int64_t>(blockIdx.x - builders) * (kThreads * kInFlight) +
      threadIdx.x;
  int64_t src[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int64_t e = base + k * kThreads;
    const int64_t row = shift >= 0 ? e >> shift : e / upr;
    const int32_t from = e < uhi ? __ldg(inv + row) : -1;
    src[k] = from < 0 ? -1 : static_cast<int64_t>(from) * upr + (e - row * upr);
  }
  U v[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) v[k] = src[k] >= 0 ? vals[src[k]] : U{};
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int64_t e = base + k * kThreads;
    if (e < uhi) out[e] = v[k];
  }
}

template <typename U>
void windows(const int32_t* slots, int32_t* inv, int64_t n, int64_t num_out,
             const void* vals, void* out, int64_t upr, cudaStream_t stream) {
  int shift = -1;
  for (int b = 0; b < 62; ++b)
    if ((int64_t{1} << b) == upr) shift = b;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned builders = 2 * sms;
  const int64_t w = (num_out + kWindows - 1) / kWindows;
  const U* v = static_cast<const U*>(vals);
  U* o = static_cast<U*>(out);
  build_and_gather<U><<<builders, kThreads, 0, stream>>>(
      slots, inv, n, 0, w, builders, v, o, 0, 0, upr, shift);
  for (int64_t lo = 0; lo < num_out; lo += w) {
    const int64_t hi = lo + w < num_out ? lo + w : num_out;
    const int64_t next = hi + w < num_out ? hi + w : num_out;
    const unsigned nb = hi < next ? builders : 0;
    build_and_gather<U><<<nb + blocks_for((hi - lo) * upr, kThreads * kInFlight),
                          kThreads, 0, stream>>>(
        slots, inv, n, hi, next, nb, v, o, lo * upr, hi * upr, upr, shift);
  }
}

template <typename U>
void gather(const int32_t* inv,""")
PART_OVERLAP_LAUNCH = ("""    if (n > 0)
      build_inverse<<<blocks_for((n + 3) / 4), kThreads, 0, stream>>>(
          slots, inv, n, num_out);
    if (vec)
      gather<uint4>(inv, vals, out, out_elems / V, d / V, stream);
    else
      gather<typename Bits<T>::type>(inv, vals, out, out_elems, d, stream);
""", """    if (vec)
      windows<uint4>(slots, inv, n, num_out, vals, out, d / V, stream);
    else
      windows<typename Bits<T>::type>(slots, inv, n, num_out, vals, out, d,
                                      stream);
""")

PARENT_COMB_SCAN = """#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, v, off);
      if (lane - off >= start) v += y;
    }
"""
PARENT_COMB_ATOMIC = (
    "    if (tail && valid) atomicAdd(acc + static_cast<int64_t>(id) * d + c, v);\n")
PARENT_COMB_NO_ATOMIC = "    if (tail && valid && v == -1.25f) acc[0] = v;\n"


def _set(**values) -> list:
    """Replacements that give combine.cu's constants other values."""
    shipped = {"kStageBytes": "36864;  // vals a stage holds: 1,152 rows at d 8",
               "kStages": "3;", "kBlocksPerSm": "1;", "kConsumerWarps": "8;",
               "kChunk": "9;  // rows a consumer thread sums alone (odd)"}
    return [(f"constexpr int {k} = {shipped[k]}", f"constexpr int {k} = {v};")
            for k, v in values.items()]


# name: (kernel, source: "new" or "parent", replacements).  A "probe"
# changes what the kernel computes and is timed but not checked.
VARIANTS = {
    # PART
    "part: 4 units in flight": ("part", "new", [
        ("constexpr int kInFlight = 2;", "constexpr int kInFlight = 4;")]),
    "part: 8 units in flight": ("part", "new", [
        ("constexpr int kInFlight = 2;", "constexpr int kInFlight = 8;")]),
    "part: bulk stores": ("part", "new", [(PART_DIRECT, PART_BULK)]),
    "part: bulk stores, 4 units in flight": ("part", "new", [
        (PART_DIRECT, PART_BULK),
        ("constexpr int kInFlight = 2;", "constexpr int kInFlight = 4;")]),
    "part: evict-first loads of vals": ("part", "new", PART_HINTS),
    "part: the inverse by plain stores": ("part", "new", [
        (PART_INV_RED, "inv[s[j]] = static_cast<int32_t>(i0 + j);")]),
    "part: 4 windows, each inverse built under the last gather": (
        "part", "new", [PART_OVERLAP_KERNELS, PART_OVERLAP_LAUNCH]),
    "part: 2 windows, each inverse built under the last gather": (
        "part", "new", [PART_OVERLAP_KERNELS, PART_OVERLAP_LAUNCH,
                        ("constexpr int64_t kWindows = 4;",
                         "constexpr int64_t kWindows = 2;")]),
    "part: 8 windows, each inverse built under the last gather": (
        "part", "new", [PART_OVERLAP_KERNELS, PART_OVERLAP_LAUNCH,
                        ("constexpr int64_t kWindows = 4;",
                         "constexpr int64_t kWindows = 8;")]),
    "other design: a scatter, 4 bytes a lane, hit rows in a bitmap": (
        "part", "new", [PART_SCATTER_KERNELS, PART_SCATTER_LAUNCH]),
    "probe part: the inverse alone": ("part", "new", [
        ("    if (vec)\n      gather<uint4>(inv, vals, out, out_elems / V, d / V, "
         "stream);\n    else\n      gather<typename Bits<T>::type>(inv, vals, "
         "out, out_elems, d, stream);\n", "")]),
    "probe part: an identity inverse (sequential gather)": ("part", "new", [
        (PART_INV_RED, "inv[i0 + j] = static_cast<int32_t>(i0 + j);")]),
    "probe part: the parent's scatter without its memset": ("part", "parent", [
        ("  if (unique) {\n    cudaMemsetAsync(out, 0, out_elems * sizeof(T), "
         "stream);\n", "  if (unique) {\n")]),
    "part: L2 window on inv (stream synchronised)": ("part", "new",
                                                      PART_L2_WINDOW),
    "part: L2 fetch granularity 32 bytes (stream synchronised)": (
        "part", "new", PART_FETCH_32),
    # COMB
    "comb: chunk 13, 53,248-byte stages (1,664-row tiles)": (
        "comb", "new", _set(kChunk=13, kStageBytes=53248)),
    "comb: chunk 5, 20,480-byte stages (640-row tiles)": (
        "comb", "new", _set(kChunk=5, kStageBytes=20480)),
    "comb: 2 stages": ("comb", "new", _set(kStages=2)),
    "comb: 4 stages": ("comb", "new", _set(kStages=4)),
    "comb: 2 stages, 2 blocks/SM": ("comb", "new",
                                    _set(kStages=2, kBlocksPerSm=2)),
    "comb: each tile's ticket taken when its stage is filled": (
        "comb", "new", [
            ("    unsigned long long next = 0;\n"
             "    if (lane == 0) next = atomicAdd(a.counter, 1ull);\n"
             "    for (int64_t uses = 0;; ++uses) {\n"
             "      const unsigned long long t = __shfl_sync(~0u, next, 0);\n"
             "      if (lane == 0 && static_cast<int64_t>(t) < a.tiles)\n"
             "        next = atomicAdd(a.counter, 1ull);\n",
             "    for (int64_t uses = 0;; ++uses) {\n"
             "      unsigned long long t = 0;\n"
             "      if (lane == 0) t = atomicAdd(a.counter, 1ull);\n"
             "      t = __shfl_sync(~0u, t, 0);\n")]),
    "comb: 4 consumer warps (576-row tiles)": ("comb", "new",
                                               _set(kConsumerWarps=4)),
    "comb: scalar reductions": ("comb", "new", [
        ("  if (a.v4) {\n    red_v4(p, s);\n  } else {",
         "  {")]),
    "comb: registers loaded from global, no ring": ("comb", "new", [
        ("  const int32_t* ids = reinterpret_cast<const int32_t*>(stage + "
         "kValsBytes +\n                                                        "
         "m.shift_i);\n  const unsigned char* sv = stage + m.shift_v;\n",
         "  const int32_t* ids = a.ids + m.row0;\n"
         "  const unsigned char* sv = a.vals + m.row0 * a.d * a.esz;\n"),
        ("      uint32_t bytes = 0;\n      if (lane == 0)\n",
         "      uint32_t bytes = 0;\n      if (false)\n"),
        ("      if (more) {\n        stage_range(gi, li, stage + kValsBytes, "
         "lane, 0, &full[s], true);\n        stage_range(gv, lv, stage, lane, "
         "16, &full[s], true);\n      }\n", "")]),
    "probe comb: no reductions": ("comb", "new", [
        ("  if (id < 0 || id >= a.segments) return;", "  if (id != -7) return;")]),
    "probe comb: staging alone": ("comb", "new", [
        ("      consume<T, VEC>(a, m, smem + s * kSlotBytes, ct);\n", "")]),
    "probe comb: the parent without its atomics": ("comb", "parent", [
        (PARENT_COMB_ATOMIC, PARENT_COMB_NO_ATOMIC)]),
    "probe comb: the parent without its scans": ("comb", "parent", [
        (PARENT_COMB_SCAN, "")]),
    "probe comb: the parent's loads alone": ("comb", "parent", [
        (PARENT_COMB_SCAN, ""), (PARENT_COMB_ATOMIC, PARENT_COMB_NO_ATOMIC)]),
}


def _ms(fn, reps=10):
    """Median device ms of ``fn``; the card first spins about 2 ms, so that
    the host's launch latency is not timed with the kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


# ---------------------------------------------------------------------------
# layouts and checks
# ---------------------------------------------------------------------------

def layouts(dev) -> dict:
    from repro_torch.core import torchplan
    gen = torch.Generator(device=dev).manual_seed(1)
    vals = torch.rand((N, D), dtype=torch.float32, device=dev, generator=gen)
    perm = torch.randperm(N, device=dev, generator=gen).to(torch.int32)
    w = torch.arange(1, KEYS + 1, dtype=torch.float64, device=dev) ** -ALPHA
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(N, dtype=torch.float64, device=dev, generator=gen)
    keys = torch.searchsorted(cdf, u).clamp_(max=KEYS - 1)
    slot = torchplan._slot_of(("hash",), keys, WORKERS)
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(slot[order], stable=True).indices]
    sk, ss = keys[order], slot[order]
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = (sk[1:] != sk[:-1]) | (ss[1:] != ss[:-1])
    seg = torch.cumsum(head, 0) - 1
    routed = vals[order].contiguous()
    shuffle = torch.randperm(N, device=dev, generator=gen)
    return {"part": (perm, vals),
            "comb": (seg.to(torch.int32), routed),
            "comb_unsorted": (seg[shuffle].to(torch.int32),
                              routed[shuffle].contiguous())}


def comb_check(ids, vals, s_count):
    """A checker of COMB's output on these inputs: every element within
    len_seg * 2^-24 * sum|v| of the exact float64 sum (positive values)."""
    seg = ids.long()
    exact = torch.zeros((s_count, D), dtype=torch.float64, device=ids.device)
    exact.index_add_(0, seg, vals.double())
    lens = torch.bincount(seg, minlength=s_count).double()[:, None]
    tol = lens * U32 * exact

    def check(got) -> float:
        err = (got.double() - exact).abs()
        assert bool((err <= tol).all()), "COMB outside the f32 summation bound"
        return float(err.max())
    return check


# ---------------------------------------------------------------------------
# variants
# ---------------------------------------------------------------------------

def variant_fns(dev, parent: Path | None, only=None) -> dict:
    """A launcher per variant, each built from its source with its
    replacements (every replaced text must be in the source)."""
    from repro_torch.kernels.fold import _stream_state
    wanted = None if only is None else set(only)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter, sms = _stream_state(dev, stream)
    outdir = _build.BUILD_DIR.parent / "part_comb_dev"
    outdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, (kernel, base, subs)) in enumerate(VARIANTS.items()):
        if wanted is not None and name not in wanted:
            continue
        file = {"part": "partition.cu", "comb": "combine.cu"}[kernel]
        if base == "parent":
            if parent is None:
                continue
            csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
        else:
            csrc = _build.CSRC
        text = (csrc / file).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {csrc / file}")
            text = text.replace(old, new)
        src, so = outdir / f"variant{i}.cu", outdir / f"variant{i}.so"
        src.write_text(text)
        procs.append((name, kernel, base, so, subprocess.Popen(  # all at once
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, kernel, base, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:    # reported, and the others still run
            print(json.dumps(dict(variant=name, nvcc_failed=[
                x for x in log.splitlines() if "error" in x])), flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        if kernel == "part":
            f = lib.teshu_partition_permute
            f.argtypes = [p, p, p, p, i64, i64, i64, i32, i32, i32, p]
            f.restype = ctypes.c_int

            def run(slots, vals, f=f, base=base):
                n, d = vals.shape
                out = torch.empty_like(vals)
                scratch = out if base == "parent" else torch.empty(
                    n, dtype=torch.int32, device=vals.device)
                _build.check(f(slots.data_ptr(), vals.data_ptr(),
                               out.data_ptr(), scratch.data_ptr(), n, d, n, 0,
                               1, 1, stream), "variant")
                return out
        else:
            f = lib.teshu_segment_combine
            if base == "parent":
                f.argtypes = [p, p, p, p, i64, i64, i64, i32, p]
            else:
                f.argtypes = [p, p, p, p, p, i64, i64, i64, i32, i32, p]
            f.restype = ctypes.c_int

            def run(ids, vals, s_count, f=f, base=base):
                n, d = vals.shape
                out = torch.empty((s_count, d), dtype=vals.dtype,
                                  device=vals.device)
                args = [ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
                        out.data_ptr()]
                if base != "parent":
                    args.append(counter.data_ptr())
                args += [n, d, s_count, 0]
                if base != "parent":
                    args.append(sms)
                _build.check(f(*args, stream), "variant")
                return out
        fns[name] = (kernel, run)
    return fns


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--only", default=None,
                    help="variant names to run, separated by ';' (default all)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent, for the old kernels' probes")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    import repro_torch
    print(f"package: {os.path.dirname(repro_torch.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    lines = []

    def emit(row):
        print(json.dumps(row), flush=True)
        lines.append(row)

    lay = layouts(dev)
    perm, vals = lay["part"]
    part_bound = (4 * N + 8 * N * D) / HBM * 1e3
    plain = ref.partition_permute_ref(perm, vals, num_out=N)
    fns = {"shipped": lambda: partition_permute(perm, vals, num_out=N,
                                                unique_slots=True)}
    perm64, lib_out = perm.long(), torch.empty_like(vals)
    lib = {"index_copy_": lambda: lib_out.index_copy_(0, perm64, vals),
           "index_add_": lambda: lib_out.index_add_(0, perm64, vals),
           "yardstick: vals.sum(0), one read": lambda: vals.sum(0),
           "yardstick: lib_out.copy_(vals), a read and a write":
               lambda: lib_out.copy_(vals)}
    var = variant_fns(dev, args.parent, None if args.only is None
                      else args.only.split(";")) if args.variants else {}
    for name, (kernel, run) in var.items():
        if kernel == "part":
            fns[name] = (lambda run=run: run(perm, vals))
    fns["shipped, again"] = fns["shipped"]
    for name, fn in {**fns, **lib}.items():
        exact = None if name.startswith(("probe", "yardstick")) \
            or name == "index_add_" else bool(torch.equal(fn(), plain))
        if name not in lib:
            assert exact in (None, True), f"PART {name} differs from plain"
        ms = [_ms(fn) for _ in range(args.rounds)]
        emit(dict(layout="part", kernel=name, n=N, d=D, exact=exact, ms=ms,
                  ms_median=statistics.median(ms), bound_ms=part_bound))
    del plain, lib_out, perm64

    for layout in ("comb", "comb_unsorted"):
        ids, v = lay[layout]
        s_count = int(ids.max()) + 1
        check = comb_check(ids, v, s_count)
        bound = (4 * N + 4 * N * D + 4 * s_count * D) / HBM * 1e3
        acc = torch.empty((s_count, D), dtype=torch.float32, device=dev)
        ids64 = ids.long()
        fns = {"shipped": lambda: segment_combine(ids, v,
                                                  num_segments=s_count),
               "index_add_": lambda: acc.index_add_(0, ids64, v)}
        for name, (kernel, run) in var.items():
            if kernel == "comb":
                fns[name] = (lambda run=run: run(ids, v, s_count))
        fns["shipped, again"] = fns["shipped"]
        for name, fn in fns.items():
            err = None if name.startswith("probe") or name == "index_add_" \
                else check(fn())
            ms = [_ms(fn) for _ in range(args.rounds)]
            emit(dict(layout=layout, kernel=name, n=N, d=D, segments=s_count,
                      longest_segment=int(torch.bincount(ids64).max()),
                      max_abs_err=err, ms=ms, ms_median=statistics.median(ms),
                      bound_ms=bound))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            f.write(smi + "\n" + "\n".join(json.dumps(x) for x in lines)
                    + "\n")


if __name__ == "__main__":
    main()
