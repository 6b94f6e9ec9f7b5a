// The sLSTM recurrence: hs[:, t] = cell(xw[:, t] + h_{t-1} @ w_rec + b, state).
//
// Replaces the lax.scan over _slstm_cell in src/repro/models/ssm.py::
// slstm_forward (a traced scan, not a Pallas kernel).  The input product
// xw = x @ w_in is one large matmul done before the call; what is left is
// sequential: step t needs all of h_{t-1}, so the S steps form one chain.
// Per step: h_{t-1} cast to x's dtype, its product with w_rec [d, 4d]
// summed in float32 and rounded to x's dtype, xw_t + that rounded, + b
// rounded, then the cell in float32 (tanh, sigmoid, the two log-sigmoids,
// the stabiliser m, n floored at 1e-6): exactly ref.slstm_scan_ref's order.
//
// What bounds it on an H100: the chain.  The bytes (xw and hs once, w_rec
// once: about 210 MB at B 4, S 4,096, d 1,024 in bf16, 0.063 ms at 3.35
// TB/s) are far below S times the least time of one step, which is one
// exchange of h (B x d values, 8 KB) among the blocks and one grid-wide
// barrier, a few microseconds; the step's product (B x d x 4d, 17 MFLOP)
// spread over the blocks is about a microsecond.
//
// Design: one launch of persistent blocks, all co-resident (a cooperative
// launch; the host checks the occupancy first).  Block i owns the U = d / G
// hidden units [iU, iU + U) and keeps their 4U columns of w_rec (z, i, f,
// o) in shared memory for the whole call (64 KB at d 1,024, U 8, bf16), so
// w_rec is read from device memory once.  Each step:
// - the block copies h_{t-1} (x's dtype) from a double-buffered exchange
//   buffer in L2 (ld.global.cg: never a stale L1 line) into shared memory;
// - each warp takes kCols of the 4U columns, each lane a 16-byte slice of
//   k at a time, and sums h_{t-1}[b, :] . w_rec[:, col] for every b in
//   float32 registers, then across the warp by shuffles;
// - threads (u, b) apply the cell, keeping c, n, m in registers across
//   steps, and write h_t to hs (float32) and, in x's dtype, to the other
//   half of the exchange buffer (st.global.cg);
// - one grid.sync() orders the step's writes of h before the next step's
//   reads; the double buffer keeps a block's write of h_t off the half that
//   a slower block may still be reading for step t.
// xw's four values of a thread's next step are loaded before its product so
// that their latency hides behind it.  kStepWork = false leaves the product
// out (a probe of the exchange-and-barrier time: dev/slstm_timing.py).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr bool kStepWork = true;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;   // batch rows a launch takes
constexpr int kCols = 4;   // columns a warp sums in one pass over k
constexpr int kNotResident = -1;
constexpr int kTooMuchShared = -2;

using bf16 = __nv_bfloat16;

template <typename T>
struct Elems;  // values of T in 16 bytes
template <>
struct Elems<float> {
  static constexpr int n = 4;
};
template <>
struct Elems<bf16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T (round to nearest even), as a float
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ void store_cg(float* p, float x) { __stcg(p, x); }
__device__ __forceinline__ void store_cg(bf16* p, bf16 x) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(x));
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

template <typename T>
struct Args {
  const T* xw;     // [B, S, 4d]
  const T* w_rec;  // [d, 4d]
  const T* bias;   // [4d]
  const float *c0, *n0, *h0, *m0;  // [B, d]
  float* hs;                       // [B, S, d]
  float *c1, *n1, *h1, *m1;        // [B, d]
  T* hx;                           // [2, B, d]: the exchange of h
  int B, S, d, U;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    slstm_scan(const Args<T> a) {
  constexpr int V = Elems<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.U, d = a.d, B = a.B, S = a.S, d4 = 4 * d;
  T* w_s = reinterpret_cast<T*>(smem);  // [4U][d]: local column g U + u
  T* h_s = w_s + 4 * U * d;             // [B][d]
  float* rec_s = reinterpret_cast<float*>(h_s + B * d);  // [4U][kMaxB]
  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cg::grid_group grid = cg::this_grid();

  for (int i = tid; i < 4 * U * d; i += kThreads) {
    const int lc = i % (4 * U), k = i / (4 * U);
    const int col = (lc / U) * d + j0 + lc % U;
    w_s[lc * d + k] = a.w_rec[static_cast<int64_t>(k) * d4 + col];
  }
  for (int i = tid; i < B * d; i += kThreads) h_s[i] = from_f<T>(a.h0[i]);

  // the cell's thread for unit j0 + u of row b
  const bool cell = tid < U * B;
  const int u = cell ? tid % U : 0, b = cell ? tid / U : 0, j = j0 + u;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f, bias[4];
  if (cell) {
    c = a.c0[b * d + j];
    n = a.n0[b * d + j];
    m = a.m0[b * d + j];
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = to_f(a.bias[g * d + j]);
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    float xv[4];
    if (cell) {
      const T* x = a.xw + (static_cast<int64_t>(b) * S + t) * d4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g] = to_f(x[g * d]);
    }
    if (t > 0) {
      const uint4* src =
          reinterpret_cast<const uint4*>(a.hx + ((t - 1) & 1) * B * d);
      uint4* dst = reinterpret_cast<uint4*>(h_s);
      for (int i = tid; i < B * d / V; i += kThreads) dst[i] = __ldcg(src + i);
      __syncthreads();
    }
    if (kStepWork) {
      for (int c0 = warp * kCols; c0 < 4 * U; c0 += kWarps * kCols) {
        float acc[kCols][kMaxB];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
          for (int bb = 0; bb < kMaxB; ++bb) acc[cc][bb] = 0.f;
        for (int k = lane * V; k < d; k += 32 * V) {
          float wv[kCols][V];
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            if (c0 + cc < 4 * U) {
              unpack(*reinterpret_cast<const uint4*>(w_s + (c0 + cc) * d + k),
                     wv[cc]);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) wv[cc][v] = 0.f;
            }
          }
#pragma unroll
          for (int bb = 0; bb < kMaxB; ++bb) {
            if (bb < B) {
              float hv[V];
              unpack(*reinterpret_cast<const uint4*>(h_s + bb * d + k), hv);
#pragma unroll
              for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
                for (int v = 0; v < V; ++v)
                  acc[cc][bb] = fmaf(hv[v], wv[cc][v], acc[cc][bb]);
            }
          }
        }
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
          for (int bb = 0; bb < kMaxB; ++bb)
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[cc][bb] += __shfl_xor_sync(0xffffffffu, acc[cc][bb], off);
        if (lane == 0) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
            for (int bb = 0; bb < kMaxB; ++bb)
              if (c0 + cc < 4 * U && bb < B)
                rec_s[(c0 + cc) * kMaxB + bb] = acc[cc][bb];
        }
      }
    }
    __syncthreads();
    if (cell) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float p = kStepWork ? rec_s[(g * U + u) * kMaxB + b] : 0.f;
        const float s1 = rnd<T>(__fadd_rn(xv[g], rnd<T>(p)));
        pre[g] = rnd<T>(__fadd_rn(s1, bias[g]));
      }
      const float z = tanhf(pre[0]);
      const float log_i = -softplus(-pre[1]);
      const float log_f = -softplus(-pre[2]);
      const float o = sigmoid(pre[3]);
      const float fm = __fadd_rn(log_f, m);
      const float m_new = fmaxf(fm, log_i);
      const float i_s = expf(__fsub_rn(log_i, m_new));
      const float f_s = expf(__fsub_rn(fm, m_new));
      c = __fadd_rn(__fmul_rn(f_s, c), __fmul_rn(i_s, z));
      n = fmaxf(__fadd_rn(__fmul_rn(f_s, n), i_s), 1e-6f);
      m = m_new;
      h = __fmul_rn(o, __fdiv_rn(c, n));
      a.hs[(static_cast<int64_t>(b) * S + t) * d + j] = h;
      store_cg(a.hx + (t & 1) * B * d + b * d + j, from_f<T>(h));
    }
    if (t + 1 < S) grid.sync();
  }
  if (cell) {
    a.c1[b * d + j] = c;
    a.n1[b * d + j] = n;
    a.h1[b * d + j] = h;
    a.m1[b * d + j] = m;
  }
}

// How many blocks of slstm_scan<T> with smem bytes of shared memory the
// card dev holds at once (0 without cooperative launches), or
// kTooMuchShared.  The runtime's answers are kept per (device, type, smem):
// the attribute queries and the occupancy call cost more host time than the
// launch itself, and a decode step makes one call per sLSTM layer.
template <typename T>
int resident_blocks(int dev, size_t smem, cudaError_t* err) {
  struct Seen {
    int dev;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  static std::vector<int> opted_in;  // devices whose smem limit was raised
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen)
    if (s.dev == dev && s.smem == smem) return s.blocks;
  int most = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  int blocks = kTooMuchShared;
  if (e == cudaSuccess && smem <= static_cast<size_t>(most)) {
    auto kernel = slstm_scan<T>;
    bool opted = false;
    for (int o : opted_in) opted |= o == dev;
    // raised once to the card's most, so that every smem below it launches
    if (!opted) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e == cudaSuccess) opted_in.push_back(dev);
    }
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    blocks = coop ? per_sm * sms : 0;
  }
  if (e != cudaSuccess) {
    *err = e;
    return 0;
  }
  seen.push_back({dev, smem, blocks});
  return blocks;
}

template <typename T>
int launch(const Args<T>& a, void* stream) {
  const int grid = a.d / a.U;
  const size_t smem = (static_cast<size_t>(4 * a.U + a.B) * a.d) * sizeof(T) +
                      static_cast<size_t>(4 * a.U) * kMaxB * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = resident_blocks<T>(dev, smem, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks == kTooMuchShared) return kTooMuchShared;
  if (blocks < grid) return kNotResident;
  Args<T> args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(slstm_scan<T>),
                                  dim3(grid), dim3(kThreads), params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The sLSTM scan of xw [B, S, 4d] (bf16 when is_bf16, else float32; w_rec
// and b of the same type) from the float32 state (c0, n0, h0, m0 [B, d]) to
// hs [B, S, d] and the final state (c1, n1, h1, m1), float32.  hx: scratch
// of 2 B d values of x's type.  units: hidden units a block owns (divides
// d; d / units blocks).  Returns 0, a cudaError_t, or -1 when the grid
// cannot be co-resident, -2 when a block's shared memory exceeds the card's.
extern "C" int teshu_slstm_scan(const void* xw, const void* w_rec,
                                const void* bias, const float* c0,
                                const float* n0, const float* h0,
                                const float* m0, float* hs, float* c1,
                                float* n1, float* h1, float* m1, void* hx,
                                int B, int S, int d, int units, int is_bf16,
                                void* stream) {
  if (B < 1 || B > kMaxB || S < 1 || d < 8 || d % 8 != 0 || units < 1 ||
      d % units != 0 || units * B > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    Args<bf16> a{static_cast<const bf16*>(xw), static_cast<const bf16*>(w_rec),
                 static_cast<const bf16*>(bias), c0, n0, h0, m0, hs, c1, n1,
                 h1, m1, static_cast<bf16*>(hx), B, S, d, units};
    return launch(a, stream);
  }
  Args<float> a{static_cast<const float*>(xw),
                static_cast<const float*>(w_rec),
                static_cast<const float*>(bias), c0, n0, h0, m0, hs, c1, n1,
                h1, m1, static_cast<float*>(hx), B, S, d, units};
  return launch(a, stream);
}
