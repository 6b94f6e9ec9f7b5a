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
// TB/s) and the product (B x d x 4d a step, 17 MFLOP) are far below S
// times the least time of one step, which is one exchange of h (B x d
// values, 8 KB) among the blocks: a value published by one SM and seen by
// another through L2 (dev/slstm_timing.py --pingpong times that trip).
//
// Design: one launch of persistent blocks, all co-resident (a cooperative
// launch; the host checks the occupancy first: blocks that wait for each
// other must all run).  Block i owns the U = d / G hidden units [iU, iU +
// U) and their 4U columns of w_rec (z, i, f, o), read from device memory
// once.  Each step:
// - the exchange, with no grid barrier: block i writes its slice of h_t,
//   in x's dtype, to one half of a two-half exchange buffer (st.global.cg)
//   and, once all its cells have, thread 0 publishes the step on the
//   block's own flag (st.release.gpu: flags[i kFlagStride] = base + t + 1,
//   each flag on a 128-byte line of its own).  A reader polls the flags of
//   the blocks whose slices it needs with acquire loads, a lane a flag,
//   and reads those slices from L2 (ld.global.cg) once they show the step:
//   a warp starts its part of the product as soon as its sources have
//   published, whatever the other blocks do.  Why two halves are enough:
//   block j writes h_{t+1} only after it has seen every block's flag for
//   h_t, and every block published h_t only after it had read all of
//   h_{t-1}; so h_{t+1} never overwrites a half (the one that held h_{t-1})
//   that some block still reads.  The wrapper raises base by S + 1 a call,
//   so that no flag left by an earlier call shows a step of this one,
//   without a memset;
// - bf16 with U a multiple of 4 (slstm_scan_mma, the served path): the
//   step's product on the tensor cores, mma.sync m16n8k16 with the block's 4U
//   gate columns as M (U / 4 tiles of 16), the batch padded to N 8 and K
//   split over the 8 warps (d / 128 k-steps of 16 each at d 1,024; at 16
//   units a block, the served width, a warp reads the slices of 8 blocks).
//   Each warp keeps its A fragments of w_rec in registers for the whole
//   call: w_rec is loaded once, by 16-byte cp.async into a padded shared
//   layout ([k][4U + 8]: conflict-free ldmatrix.trans rows), then into
//   registers.  Each lane loads its B fragments (pairs of h values)
//   straight from the exchange buffer.  The warps' partial sums meet in
//   shared memory, padded batch rows dropped, and are added in the warps'
//   order: the sum's order is fixed, so two calls give the same bits.  The
//   float32 accumulation of mma.sync is held to ref.slstm_tolerance like
//   any other order of the sum;
// - otherwise (float32, whose product on tensor cores would be TF32, or U
//   not a multiple of 4: slstm_scan_simd): w_rec's columns stay in shared
//   memory, h_{t-1} is copied there once every block's flag shows it, and each
//   warp sums kCols columns on the CUDA cores (16-byte slices of k a lane,
//   then across the warp by shuffles);
// - threads (u, b) apply the cell, keeping c, n, m in registers across
//   steps, write h_t to the exchange buffer, publish the step, and only
//   then write h_t to hs (float32), so that the publication waits for no
//   hs write.
// xw's values of a thread's next step are loaded a step ahead.
// kStepWork = false leaves the product out (a probe of the exchange alone),
// kPhaseClock = true times each phase of a step, kTensorCores = false gives
// bf16 the CUDA-core path (dev/slstm_timing.py's probes and variants).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

// the clock64 probe's cycles: thread 0 of block i sums each phase of its
// steps into [i][phase] (wait, copy, product, reduction, cell, stores)
__device__ long long teshu_slstm_phase_cycles[1024][8];

namespace {

constexpr bool kStepWork = true;
constexpr bool kPhaseClock = false;
constexpr bool kTensorCores = true;  // bf16's product on mma.sync
constexpr int kFlagStride = 16;      // u64 from one block's flag to the next
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;   // batch rows a launch takes
constexpr int kCols = 4;   // columns a warp sums in one pass over k (simd)
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

// 32 bits of the exchange buffer from L2 (never a stale L1 line); volatile,
// so that the exchange probe (kStepWork = false) still loads h
__device__ __forceinline__ uint32_t load_cg(const void* p) {
  uint32_t v;
  asm volatile("ld.global.cg.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* flag,
                                        unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(flag), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* flag) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(flag)
               : "memory");
  return v;
}

// flag shows step `want` (or a later one)
__device__ __forceinline__ bool shows(unsigned long long flag,
                                      unsigned long long want) {
  return static_cast<long long>(flag - want) >= 0;
}

// the first n threads of the block (n a multiple of 32) wait for each other
__device__ __forceinline__ void sync_first(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(Bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// four 8 x 8 bf16 matrices of shared memory, transposed: the A fragment of
// mma.sync m16n8k16 from a [k][m] layout
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// gate g's activation of its pre-activation x: z = tanh, log_i and log_f
// (log-sigmoids), o = sigmoid
__device__ __forceinline__ float activation(int g, float x) {
  if (g == 0) return tanhf(x);
  if (g == 3) return sigmoid(x);
  return -softplus(-x);
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
  unsigned long long* flags;  // block i's last published step at i kFlagStride
  unsigned long long base;         // this call's steps publish base + t + 1
  int B, S, d, U;
};

// the half of the exchange buffer that holds h_{t-1} at step t (t >= 1)
template <typename T>
__device__ __forceinline__ const T* prev_half(const Args<T>& a, int t) {
  return a.hx + ((t - 1) & 1) * a.B * a.d;
}

// the half that step t writes h_t to
template <typename T>
__device__ __forceinline__ T* this_half(const Args<T>& a, int t) {
  return a.hx + (t & 1) * a.B * a.d;
}

// h_t of the block's cells (threads [0, cells)) is in the exchange buffer:
// publish step t on the block's flag.  The release orders every write the
// publishing thread has seen before it, the other cells' among them.
template <typename T>
__device__ __forceinline__ void publish_step(const Args<T>& a, int cells,
                                             int t) {
  const int n = (cells + 31) / 32 * 32;
  if (static_cast<int>(threadIdx.x) < n) sync_first(n);
  if (threadIdx.x == 0 && t + 1 < a.S)
    publish(a.flags + blockIdx.x * kFlagStride, a.base + t + 1);
}

// One thread's (unit j, row b) of the cell: its state c, n, m and its last
// h, the bias of its four gates, and xw's values of this step and (as
// loaded: nothing waits for them before their step) of the next.
template <typename T>
struct Cell {
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f, bias[4], xv[4];
  T xn[4];

  __device__ void init(const Args<T>& a, int b, int j) {
    c = a.c0[b * a.d + j];
    n = a.n0[b * a.d + j];
    m = a.m0[b * a.d + j];
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = to_f(a.bias[g * a.d + j]);
    load_x(a, b, j, 0);
#pragma unroll
    for (int g = 0; g < 4; ++g) xv[g] = to_f(xn[g]);
  }

  // xw's values of step t into xn (a step ahead of their use)
  __device__ __forceinline__ void load_x(const Args<T>& a, int b, int j,
                                         int t) {
    if (t >= a.S) return;
    const T* x = a.xw + (static_cast<int64_t>(b) * a.S + t) * 4 * a.d + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) xn[g] = x[g * a.d];
  }

  // the step from rec[g], the float32 products of z, i, f, o: the
  // pre-activations in slstm_scan_ref's rounding order, then the cell
  __device__ __forceinline__ void step(const float (&rec)[4]) {
    float act[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float s1 = rnd<T>(__fadd_rn(xv[g], rnd<T>(rec[g])));
      act[g] = activation(g, rnd<T>(__fadd_rn(s1, bias[g])));
    }
    update(act[0], act[1], act[2], act[3]);
#pragma unroll
    for (int g = 0; g < 4; ++g) xv[g] = to_f(xn[g]);
  }

  // the state and h from the four gates' activations
  __device__ __forceinline__ void update(float z, float log_i, float log_f,
                                         float o) {
    const float fm = __fadd_rn(log_f, m);
    const float m_new = fmaxf(fm, log_i);
    const float i_s = expf(__fsub_rn(log_i, m_new));
    const float f_s = expf(__fsub_rn(fm, m_new));
    c = __fadd_rn(__fmul_rn(f_s, c), __fmul_rn(i_s, z));
    n = fmaxf(__fadd_rn(__fmul_rn(f_s, n), i_s), 1e-6f);
    m = m_new;
    h = __fmul_rn(o, __fdiv_rn(c, n));
  }

  // h_t into the exchange buffer, for the other blocks
  __device__ __forceinline__ void share(const Args<T>& a, int b, int j,
                                       int t) {
    store_cg(this_half(a, t) + b * a.d + j, from_f<T>(h));
  }

  // h_t into hs (after the step is published: the publication waits for
  // no write but the exchange buffer's)
  __device__ __forceinline__ void output(const Args<T>& a, int b, int j,
                                        int t) {
    a.hs[(static_cast<int64_t>(b) * a.S + t) * a.d + j] = h;
  }

  __device__ void finish(const Args<T>& a, int b, int j) {
    a.c1[b * a.d + j] = c;
    a.n1[b * a.d + j] = n;
    a.h1[b * a.d + j] = h;
    a.m1[b * a.d + j] = m;
  }
};

// the clock64 probe: phase k of the step ends now
struct Clock {
  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}, last = 0;
  __device__ __forceinline__ void start() {
    if constexpr (kPhaseClock) last = clock64();
  }
  __device__ __forceinline__ void mark(int k) {
    if constexpr (kPhaseClock) {
      const long long now = clock64();
      ph[k] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void save() {
    if constexpr (kPhaseClock)
      if (threadIdx.x == 0 && blockIdx.x < 1024)
        for (int k = 0; k < 8; ++k)
          teshu_slstm_phase_cycles[blockIdx.x][k] = ph[k];
  }
};

// The tensor-core path (bf16): U = 4 MT units a block, at most KS k-steps
// of 16 a warp (d <= 128 KS).  Shared memory: w_rec's staging [d][4U + 8]
// bf16 for the preload, then the warps' partial sums [kWarps][4U][8].
template <int MT, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_scan_mma(const Args<bf16> a) {
  constexpr int U = 4 * MT, RS = 4 * U + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w_t = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem);
  const int d = a.d, B = a.B, S = a.S, d4 = 4 * d;
  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nks = d / 16;
  const int ks0 = warp * nks / kWarps, ks1 = (warp + 1) * nks / kWarps;
  // the blocks whose slices of h this warp's k range reads; lane l polls
  // source src0 + l
  const int src0 = 16 * ks0 / U, nsrc = (16 * ks1 + U - 1) / U - src0;

  // w_rec's 4U columns, coalesced: consecutive threads take consecutive
  // 16-byte (U = 4: 8-byte) pieces of a row's four gate strips
  {
    constexpr int CB = U % 8 == 0 ? 8 : 4;  // bf16 values a piece
    constexpr int CPS = U / CB;             // pieces a gate strip
    for (int i = tid; i < d * 4 * CPS; i += kThreads) {
      const int c = i % CPS, gk = i / CPS, gg = gk & 3, k = gk >> 2;
      cp_async<CB * 2>(w_t + k * RS + gg * U + c * CB,
                       a.w_rec + static_cast<int64_t>(k) * d4 + gg * d + j0 +
                           c * CB);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  uint32_t wa[MT][KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    if (ks0 + ks < ks1) {
      const int k = 16 * (ks0 + ks) + (lane >> 4) * 8 + (lane & 7);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_trans(wa[mt][ks],
                      w_t + k * RS + 16 * mt + ((lane >> 3) & 1) * 8);
    }
  __syncthreads();  // the staging is read: red takes its place

  const int ub = U * B;
  const bool cell = tid < ub;
  const int u = cell ? tid % U : 0, b = cell ? tid / U : 0, j = j0 + u;
  Cell<bf16> st;
  if (cell) st.init(a, b, j);
  Clock clk;
  clk.start();

  for (int t = 0; t < S; ++t) {
    if (cell) st.load_x(a, b, j, t + 1);
    // the wait: this warp's sources have published h_{t-1}
    if (t > 0 && ks1 > ks0) {
      const unsigned long long want = a.base + t;
      bool ok;
      do {
        ok = true;
        for (int s = lane; s < nsrc; s += 32)
          ok &= shows(load_acquire(a.flags + (src0 + s) * kFlagStride),
                      want);
      } while (!__all_sync(0xffffffffu, ok));
      __syncwarp();
    }
    clk.mark(0);
    // the copy: B fragments, h[g][16 ks + 2 tq, + 1] and [.. + 8, + 9]
    uint32_t hb[KS][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      hb[ks][0] = hb[ks][1] = 0u;
      if (ks0 + ks < ks1 && g < B) {
        const int k = 16 * (ks0 + ks) + 2 * tq;
        if (t == 0) {
          const float* h0 = a.h0 + g * d + k;
          __nv_bfloat162 p0 = __floats2bfloat162_rn(h0[0], h0[1]);
          __nv_bfloat162 p1 = __floats2bfloat162_rn(h0[8], h0[9]);
          hb[ks][0] = *reinterpret_cast<uint32_t*>(&p0);
          hb[ks][1] = *reinterpret_cast<uint32_t*>(&p1);
        } else {
          const bf16* h = prev_half(a, t) + g * d + k;
          hb[ks][0] = load_cg(h);
          hb[ks][1] = load_cg(h + 8);
        }
      }
    }
    clk.mark(1);
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
    if (kStepWork) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        if (ks0 + ks < ks1)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16(acc[mt], wa[mt][ks], hb[ks][0], hb[ks][1]);
    } else {  // the probe still waits for h: + 0 or - 0 from each load
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        acc[0][0] += __uint_as_float((hb[ks][0] | hb[ks][1]) & 0x80000000u);
    }
    clk.mark(2);
    // the warps' partial sums: rows 16 mt + g (+ 8) of the 4U columns,
    // batch rows 2 tq, 2 tq + 1 (those below B)
    if (2 * tq < B) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* r = red + (warp * 4 * U + 16 * mt + g) * 8 + 2 * tq;
        *reinterpret_cast<float2*>(r) = make_float2(acc[mt][0], acc[mt][1]);
        *reinterpret_cast<float2*>(r + 64) =
            make_float2(acc[mt][2], acc[mt][3]);
      }
    }
    __syncthreads();
    float rec[4] = {0.f, 0.f, 0.f, 0.f};
    if (cell) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
          rec[gg] = __fadd_rn(rec[gg], red[(w * 4 * U + gg * U + u) * 8 + b]);
    }
    clk.mark(3);
    if (cell) st.step(rec);
    clk.mark(4);
    if (cell) st.share(a, b, j, t);
    publish_step(a, ub, t);
    if (cell) st.output(a, b, j, t);
    __syncthreads();  // red read: the next step may write it
    clk.mark(5);
  }
  if (cell) st.finish(a, b, j);
  clk.save();
}

// The CUDA-core path: any type and U.  Shared memory: w_rec's 4U columns
// [4U][d], h_{t-1} [B][d], the products [4U][kMaxB].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    slstm_scan_simd(const Args<T> a) {
  constexpr int V = Elems<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.U, d = a.d, B = a.B, S = a.S, d4 = 4 * d;
  const int G = d / U;
  T* w_s = reinterpret_cast<T*>(smem);  // [4U][d]: local column g U + u
  T* h_s = w_s + 4 * U * d;             // [B][d]
  float* rec_s = reinterpret_cast<float*>(h_s + B * d);  // [4U][kMaxB]
  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < 4 * U * d; i += kThreads) {
    const int lc = i % (4 * U), k = i / (4 * U);
    const int col = (lc / U) * d + j0 + lc % U;
    w_s[lc * d + k] = a.w_rec[static_cast<int64_t>(k) * d4 + col];
  }
  for (int i = tid; i < B * d; i += kThreads) h_s[i] = from_f<T>(a.h0[i]);

  const bool cell = tid < U * B;
  const int u = cell ? tid % U : 0, b = cell ? tid / U : 0, j = j0 + u;
  Cell<T> st;
  if (cell) st.init(a, b, j);
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    if (cell) st.load_x(a, b, j, t + 1);
    if (t > 0) {
      const unsigned long long want = a.base + t;
      for (int s = tid; s < G; s += kThreads)
        while (!shows(load_acquire(a.flags + s * kFlagStride), want)) {
        }
      __syncthreads();
      const uint4* src = reinterpret_cast<const uint4*>(prev_half(a, t));
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
            if (bb < B)
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
      float rec[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        rec[g] = kStepWork ? rec_s[(g * U + u) * kMaxB + b] : 0.f;
      st.step(rec);
      st.share(a, b, j, t);
    }
    // the next step's writes of h_s and rec_s come after its barriers, which
    // every cell passes only once it has read them
    publish_step(a, U * B, t);
    if (cell) st.output(a, b, j, t);
  }
  if (cell) st.finish(a, b, j);
}

// How many blocks of `kernel` with smem bytes of shared memory the card
// dev holds at once (0 without cooperative launches), or kTooMuchShared.
// The runtime's answers are kept per (device, kernel, smem): the attribute
// queries and the occupancy call cost more host time than the launch
// itself, and a decode step makes one call per sLSTM layer.
int resident_blocks(const void* kernel, int dev, size_t smem,
                    cudaError_t* err) {
  struct Seen {
    const void* kernel;
    int dev;
    size_t smem;
    int blocks;
  };
  struct Opted {
    const void* kernel;
    int dev;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  static std::vector<Opted> opted_in;  // kernels whose smem limit was raised
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen)
    if (s.kernel == kernel && s.dev == dev && s.smem == smem) return s.blocks;
  int most = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  int blocks = kTooMuchShared;
  if (e == cudaSuccess && smem <= static_cast<size_t>(most)) {
    bool opted = false;
    for (const Opted& o : opted_in) opted |= o.kernel == kernel && o.dev == dev;
    // raised once to the card's most, so that every smem below it launches
    if (!opted) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e == cudaSuccess) opted_in.push_back({kernel, dev});
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
  seen.push_back({kernel, dev, smem, blocks});
  return blocks;
}

template <typename T>
int launch(const void* kernel, const Args<T>& a, size_t smem, int n_flags,
           void* stream) {
  const int grid = a.d / a.U;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = resident_blocks(kernel, dev, smem, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks == kTooMuchShared) return kTooMuchShared;
  if (blocks < grid) return kNotResident;
  if (grid * kFlagStride > n_flags)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), params,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simd(const Args<T>& a, int n_flags, void* stream) {
  const size_t smem = (static_cast<size_t>(4 * a.U + a.B) * a.d) * sizeof(T) +
                      static_cast<size_t>(4 * a.U) * kMaxB * sizeof(float);
  return launch(reinterpret_cast<const void*>(slstm_scan_simd<T>), a, smem,
                n_flags, stream);
}

template <int MT, int KS>
int launch_mma(const Args<bf16>& a, int n_flags, void* stream) {
  constexpr int U = 4 * MT;
  const size_t stage = static_cast<size_t>(a.d) * (4 * U + 8) * sizeof(bf16);
  const size_t partial =
      static_cast<size_t>(kWarps) * 4 * U * 8 * sizeof(float);
  return launch(reinterpret_cast<const void*>(slstm_scan_mma<MT, KS>), a,
                stage > partial ? stage : partial, n_flags, stream);
}

// the tensor-core path for U units a block at width d, where it has one
template <int MT>
int launch_mma_ks(const Args<bf16>& a, int n_flags, void* stream) {
  const int ks = (a.d / 16 + kWarps - 1) / kWarps;  // k-steps a warp
  if (ks <= 2) return launch_mma<MT, 2>(a, n_flags, stream);
  return launch_mma<MT, 8>(a, n_flags, stream);
}

}  // namespace

// The sLSTM scan of xw [B, S, 4d] (bf16 when is_bf16, else float32; w_rec
// and b of the same type) from the float32 state (c0, n0, h0, m0 [B, d]) to
// hs [B, S, d] and the final state (c1, n1, h1, m1), float32.  hx: scratch
// of 2 B d values of x's type.  flags: n_flags u64 kept from call to call
// (zeroed once); base: larger by at least the last call's S + 1 than the
// last call's on these flags (0 the first time).  units: hidden units a
// block owns (divides d; d / units blocks, at most n_flags / kFlagStride).
// Returns 0, a cudaError_t, or -1 when the grid cannot be co-resident, -2
// when a block's shared memory exceeds the card's.
extern "C" int teshu_slstm_scan(const void* xw, const void* w_rec,
                                const void* bias, const float* c0,
                                const float* n0, const float* h0,
                                const float* m0, float* hs, float* c1,
                                float* n1, float* h1, float* m1, void* hx,
                                void* flags, int n_flags,
                                unsigned long long base, int B, int S, int d,
                                int units, int is_bf16, void* stream) {
  if (B < 1 || B > kMaxB || S < 1 || d < 8 || d % 8 != 0 || units < 1 ||
      d % units != 0 || units * B > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* fl = static_cast<unsigned long long*>(flags);
  if (is_bf16) {
    Args<bf16> a{static_cast<const bf16*>(xw), static_cast<const bf16*>(w_rec),
                 static_cast<const bf16*>(bias), c0, n0, h0, m0, hs, c1, n1,
                 h1, m1, static_cast<bf16*>(hx), fl, base, B, S, d, units};
    if (kTensorCores && d % 16 == 0 && d <= 128 * 8) {
      if (units == 4) return launch_mma_ks<1>(a, n_flags, stream);
      if (units == 8) return launch_mma_ks<2>(a, n_flags, stream);
      if (units == 16) return launch_mma_ks<4>(a, n_flags, stream);
    }
    return launch_simd(a, n_flags, stream);
  }
  Args<float> a{static_cast<const float*>(xw),
                static_cast<const float*>(w_rec),
                static_cast<const float*>(bias), c0, n0, h0, m0, hs, c1, n1,
                h1, m1, static_cast<float*>(hx), fl, base, B, S, d, units};
  return launch_simd(a, n_flags, stream);
}

// The clock64 probe's cycles (teshu_slstm_phase_cycles, 1024 x 8 int64)
// into out: zeros unless the kernel was built with kPhaseClock = true.
extern "C" int teshu_slstm_phases(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, teshu_slstm_phase_cycles, sizeof(teshu_slstm_phase_cycles)));
}
