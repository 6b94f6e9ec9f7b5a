"""Cycles a row of one column walk in shared memory, the inner loop of
``csrc/fold.cu`` taken apart (a development script: not part of the
package or its tests).

    PYTHONPATH=src python dev/fold_walk_micro.py

One warp of one block, 8 lanes (the columns of a row of 8 float64) walk
the same 1,008 rows in place 200 times; ``clock64`` around the walks gives
cycles a row.  Each shape runs with the row pitch a compile-time constant
and as a kernel argument:

- ``add chain``: 16 values preloaded into registers, a dependent DADD a
  row and no memory access (the chain's floor);
- ``add chain, store after each add``: the same with every running value
  stored in shared memory right behind its add;
- ``add chain, stores two rows late``: stored after the next two adds;
- ``loads N ahead, stores two rows late``: the fold's walk: rows read N
  at a time into one of two register sets a batch ahead of their adds.

Prints one JSON object per shape and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build

SRC = r"""
#include <cstdint>
template <int PITCH>
__device__ __forceinline__ int P(int p) { return PITCH ? PITCH : p; }

// STORE 0: no stores; 1: each running value right after its add; 2: two
// rows late
template <int STORE, int PITCH>
__device__ __forceinline__ double chain(double acc, double* p, int pitch_rt,
                                        int n) {
  const int pitch = P<PITCH>(pitch_rt);
  double v[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) v[u] = p[u * pitch];
  double a1 = acc, a2 = acc;
  for (int r = 0; r + 16 <= n; r += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      acc = __dadd_rn(acc, v[u]);
      if (STORE == 1) p[(r + u) * pitch] = acc;
      if (STORE == 2) { p[(r + u) * pitch] = a2; a2 = a1; a1 = acc; }
    }
  }
  return acc + a2;
}

// the fold's walk (SUM): rows read KB ahead into two register sets, each
// running value stored two rows late; reads past the end hit padding
template <int KB, int PITCH>
__device__ __forceinline__ double walk(double acc, double* p, int pitch_rt,
                                       int n) {
  const int pitch = P<PITCH>(pitch_rt);
  double x[KB], y[KB];
  double s1 = acc, s2 = acc;
  int r = 0;
  auto step = [&](double v, int u) {
    acc = __dadd_rn(acc, v);
    p[max(r + u - 2, 0) * pitch] = s2;
    s2 = s1;
    s1 = acc;
  };
#pragma unroll
  for (int u = 0; u < KB; ++u) x[u] = p[u * pitch];
  while (true) {
#pragma unroll
    for (int u = 0; u < KB; ++u) y[u] = p[(r + KB + u) * pitch];
    if (r + KB > n) {
#pragma unroll
      for (int u = 0; u < KB; ++u) if (r + u < n) step(x[u], u);
      break;
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) step(x[u], u);
    r += KB;
#pragma unroll
    for (int u = 0; u < KB; ++u) x[u] = p[(r + KB + u) * pitch];
    if (r + KB > n) {
#pragma unroll
      for (int u = 0; u < KB; ++u) if (r + u < n) step(y[u], u);
      break;
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) step(y[u], u);
    r += KB;
  }
  if (n >= 2) p[(n - 2) * pitch] = s2;
  p[(n - 1) * pitch] = s1;
  return acc;
}

// MODE 0..2: chain<MODE>; 3: walk<8>; 4: walk<16>
template <int MODE, int PITCH>
__global__ void bench(double* out, long long* cyc, int pitch, int rows,
                      int reps) {
  extern __shared__ double sm[];
  for (int i = threadIdx.x; i < (rows + 64) * pitch; i += blockDim.x)
    sm[i] = 1e-3 * i;
  __syncthreads();
  if (threadIdx.x >= 8) return;
  double acc = 0.0;
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    double* p = sm + threadIdx.x;
    if (MODE <= 2) acc = chain<MODE, PITCH>(acc, p, pitch, rows);
    else if (MODE == 3) acc = walk<8, PITCH>(acc, p, pitch, rows);
    else acc = walk<16, PITCH>(acc, p, pitch, rows);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  cyc[threadIdx.x] = t1 - t0;
}

template <int MODE, int PITCH>
int launch(void* out, void* cyc, int pitch, int rows, int reps) {
  const int smem = (rows + 64) * pitch * 8;
  auto k = bench<MODE, PITCH>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<1, 256, smem>>>(static_cast<double*>(out),
                      static_cast<long long*>(cyc), pitch, rows, reps);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int run(int mode, int constant, void* out, void* cyc, int pitch,
                   int rows, int reps) {
  if (constant) {
    switch (mode) {
      case 0: return launch<0, 8>(out, cyc, pitch, rows, reps);
      case 1: return launch<1, 8>(out, cyc, pitch, rows, reps);
      case 2: return launch<2, 8>(out, cyc, pitch, rows, reps);
      case 3: return launch<3, 8>(out, cyc, pitch, rows, reps);
      default: return launch<4, 8>(out, cyc, pitch, rows, reps);
    }
  }
  switch (mode) {
    case 0: return launch<0, 0>(out, cyc, pitch, rows, reps);
    case 1: return launch<1, 0>(out, cyc, pitch, rows, reps);
    case 2: return launch<2, 0>(out, cyc, pitch, rows, reps);
    case 3: return launch<3, 0>(out, cyc, pitch, rows, reps);
    default: return launch<4, 0>(out, cyc, pitch, rows, reps);
  }
}
"""

SHAPES = ("add chain", "add chain, store after each add",
          "add chain, stores two rows late",
          "loads 8 ahead, stores two rows late",
          "loads 16 ahead, stores two rows late")


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    outdir = _build.BUILD_DIR.parent / "fold_dev"
    outdir.mkdir(parents=True, exist_ok=True)
    src, so = outdir / "walk_micro.cu", outdir / "walk_micro.so"
    src.write_text(SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    out = torch.zeros(8, dtype=torch.float64, device="cuda")
    cyc = torch.zeros(8, dtype=torch.int64, device="cuda")
    rows, reps = 1008, 200
    for constant in (1, 0):
        for mode, name in enumerate(SHAPES):
            _build.check(lib.run(mode, constant, ctypes.c_void_p(out.data_ptr()),
                                 ctypes.c_void_p(cyc.data_ptr()), 8, rows,
                                 reps), name)
            print(json.dumps(dict(
                shape=name, pitch="compile-time 8" if constant else "argument 8",
                rows=rows, cycles_per_row=int(cyc[0]) / (rows * reps))),
                flush=True)


if __name__ == "__main__":
    main()
