// Grouped matmul: out[n, f] with row tile i (rows [i * block_n, (i + 1) *
// block_n)) of x[n, d] times w[gids[i]], w[G, d, f]; float32 accumulation,
// the output in x's dtype.
//
// Replaces src/repro/kernels/gmm.py::gmm (_gmm_kernel): the MoE expert FFN
// after the tokens are sorted by expert and padded per expert to a multiple
// of block_n.  The TPU kernel walks a (row tile, f block, d block) grid in
// order and carries the float32 sum in VMEM across the d axis, with the
// group ids scalar-prefetched to pick each tile's weight block; here the d
// loop runs inside one block per (row tile, 128 output columns), and the
// block reads its own group id.  Any order of ids is taken: repeated ids,
// groups with no tile.  An id outside [0, G) fills its tile with NaN (the
// kernel cannot raise without a synchronise; the wrapper's CPU path raises).
//
// What bounds it on an H100: bytes at the serving shapes.  Qwen3-MoE's
// prefill (128 experts of d 4096 x f 1536, 384 padded rows each) moves
// 2.17 GB (1.61 GB of expert weights, x and the output) for 0.62 TFLOP:
// 0.65 ms of bytes against 0.63 ms of bf16 tensor-core operations; a
// decode step's launch (16 padded rows per expert) moves 1.63 GB for 0.026
// TFLOP: 0.49 ms, bytes.
//
// Design:
// - bf16 x and w (the serving path): gmm_mma, 4 warps on the tensor cores
//   with mma.sync m16n8k16 (bf16 in, float32 accumulate).  A block owns BM
//   rows (64, 32 or 16: the largest that divides block_n, so that the rows
//   share one group) and 128 columns; the x and w[g] tiles of 32 reduction
//   steps arrive by cp.async in 3 stages, rows padded by 16 bytes so that
//   ldmatrix reads hit distinct banks.  Warps split the block 4 x 1
//   (BM 64), 2 x 2 (32) or 1 x 4 (16).  Row tiles of one expert are
//   neighbours in blockIdx.x, so they run together and share w[g]'s tiles
//   through L2.  d and f must be multiples of 8 (16-byte rows); a ragged
//   last reduction or column tile is zero-filled and masked.
// - float32 x and w (the smoke configs): gmm_f32, float32 FMAs on the CUDA
//   cores, 16 rows x 64 columns per block of 16 x 16 threads, any d and f.
//
// wgmma, TMA and a persistent schedule are a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBN = 128;           // output columns per block (mma path)
constexpr int kBK = 32;            // reduction depth per stage
constexpr int kStages = 3;
constexpr int kThreads = 128;      // 4 warps
constexpr int kALd = kBK + 8;      // bf16 per shared row of the x tile: 5 units
constexpr int kBLd = kBN + 8;      // bf16 per shared row of the w tile: 17 units

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one stage: the x tile [BM][kBK] and the w[g] tile [kBK][kBN] of reduction
// steps [k0, k0 + kBK); columns past d or f are zero-filled
template <int BM>
__device__ __forceinline__ void fetch_stage(
    const __nv_bfloat16* __restrict__ xb, const __nv_bfloat16* __restrict__ wg,
    int d, int f, int n0, int k0, __nv_bfloat16* as, __nv_bfloat16* bs) {
  constexpr int kAUnits = kBK / 8;               // 16-byte units per x row
  for (int i = threadIdx.x; i < BM * kAUnits; i += kThreads) {
    const int r = i / kAUnits;
    const int c = (i % kAUnits) * 8;
    const bool ok = k0 + c < d;
    cp_async16(as + r * kALd + c,
               xb + static_cast<int64_t>(r) * d + (ok ? k0 + c : 0),
               ok ? 16 : 0);
  }
  constexpr int kBUnits = kBN / 8;               // 16-byte units per w row
  for (int i = threadIdx.x; i < kBK * kBUnits; i += kThreads) {
    const int r = i / kBUnits;
    const int c = (i % kBUnits) * 8;
    const bool ok = k0 + r < d && n0 + c < f;
    cp_async16(bs + r * kBLd + c,
               wg + (ok ? static_cast<int64_t>(k0 + r) * f + n0 + c : 0),
               ok ? 16 : 0);
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
gmm_mma(const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ w, const int* __restrict__ gids,
        __nv_bfloat16* __restrict__ out, int d, int f, int groups,
        int block_n) {
  constexpr int kWM = BM / 16;          // warps along the rows
  constexpr int kWN = 4 / kWM;          // warps along the columns
  constexpr int kSpan = kBN / kWN;      // columns per warp
  constexpr int kNT = kSpan / 8;        // n8 tiles per warp
  __shared__ __align__(16) __nv_bfloat16 as[kStages][BM * kALd];
  __shared__ __align__(16) __nv_bfloat16 bs[kStages][kBK * kBLd];

  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * kBN;
  const int g = gids[m0 / block_n];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kWN;
  const int wn = warp % kWN;
  const int gr = lane >> 2;           // the fragment row of this lane
  const int tc = lane & 3;            // its column pair
  const int lr = lane & 7;            // ldmatrix: row within a matrix
  const int lm = lane >> 3;           // ldmatrix: which of the 4 matrices

  if (g < 0 || g >= groups) {         // the whole block: no barrier passed
    const __nv_bfloat16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int col = n0 + i % kBN;
      if (col < f) out[(m0 + i / kBN) * f + col] = nan;
    }
    return;
  }
  const __nv_bfloat16* xb = x + m0 * d;
  const __nv_bfloat16* wg = w + static_cast<int64_t>(g) * d * f;

  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  const int n_k = (d + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) fetch_stage<BM>(xb, wg, d, f, n0, s * kBK, as[s], bs[s]);
    cp_async_commit();
  }
  for (int t = 0; t < n_k; ++t) {
    cp_async_wait<kStages - 2>();     // stage t has landed
    __syncthreads();                  // ... for every thread; t - 1 is free
    const int nxt = t + kStages - 1;
    if (nxt < n_k)
      fetch_stage<BM>(xb, wg, d, f, n0, nxt * kBK, as[nxt % kStages],
                      bs[nxt % kStages]);
    cp_async_commit();
    const __nv_bfloat16* a_s = as[t % kStages];
    const __nv_bfloat16* b_s = bs[t % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned af[4];
      ldsm_x4(af, a_s + (wm * 16 + lr + 8 * (lm & 1)) * kALd + kk * 16
                      + 8 * (lm >> 1));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, b_s + (kk * 16 + lr + 8 * (lm & 1)) * kBLd
                             + wn * kSpan + np * 16 + 8 * (lm >> 1));
        mma_bf16(acc[2 * np], af, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = m0 + wm * 16 + gr + 8 * h;
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int col = n0 + wn * kSpan + i * 8 + 2 * tc;
      if (col < f)
        *reinterpret_cast<__nv_bfloat162*>(out + row * f + col) =
            __floats2bfloat162_rn(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  }
}

template <int BM>
int launch_mma(const void* x, const void* w, const int* gids, void* out,
               int64_t n, int64_t d, int64_t f, int64_t groups,
               int64_t block_n, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(n / BM),
                  static_cast<unsigned>((f + kBN - 1) / kBN));
  gmm_mma<BM><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), gids,
      static_cast<__nv_bfloat16*>(out), static_cast<int>(d),
      static_cast<int>(f), static_cast<int>(groups),
      static_cast<int>(block_n));
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// float32 path
// ---------------------------------------------------------------------------

constexpr int kFM = 16;            // rows per block (divides every block_n)
constexpr int kFN = 64;            // columns per block
constexpr int kFK = 32;            // reduction depth per tile

__global__ void __launch_bounds__(256)
gmm_f32(const float* __restrict__ x, const float* __restrict__ w,
        const int* __restrict__ gids, float* __restrict__ out, int d, int f,
        int groups, int block_n) {
  __shared__ float xs[kFM][kFK + 1];
  __shared__ float ws[kFK][kFN + 1];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kFM;
  const int n0 = blockIdx.y * kFN;
  const int g = gids[m0 / block_n];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;    // the thread's row
  if (g < 0 || g >= groups) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < f) out[(m0 + ty) * f + col] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const float* xb = x + m0 * d;
  const float* wg = w + static_cast<int64_t>(g) * d * f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < d; k0 += kFK) {
    for (int i = threadIdx.x; i < kFM * kFK; i += 256) {
      const int r = i / kFK, c = i % kFK;
      xs[r][c] = k0 + c < d ? xb[static_cast<int64_t>(r) * d + k0 + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < kFK * kFN; i += 256) {
      const int r = i / kFN, c = i % kFN;
      ws[r][c] = k0 + r < d && n0 + c < f
                     ? wg[static_cast<int64_t>(k0 + r) * f + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFK; ++k) {
      const float a = xs[ty][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, ws[k][tx + 16 * j], acc[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col < f) out[(m0 + ty) * f + col] = acc[j];
  }
}

}  // namespace

// x [n, d], w [groups, d, f], gids [n / block_n] int32, out [n, f]; all
// contiguous, x, w and out 16-byte aligned; block_n a positive multiple of
// 16 dividing n; dtype 0 = float32 (any d, f), 1 = bfloat16 (d and f
// multiples of 8).  Returns a cudaError_t.
extern "C" int teshu_gmm(const void* x, const void* w, const int* gids,
                         void* out, int64_t n, int64_t d, int64_t f,
                         int64_t groups, int64_t block_n, int dtype,
                         void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 || groups <= 0 || block_n <= 0 ||
      block_n % 16 != 0 || n % block_n != 0 || d > INT32_MAX ||
      f > INT32_MAX || (f + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(static_cast<unsigned>(n / kFM),
                    static_cast<unsigned>((f + kFN - 1) / kFN));
    gmm_f32<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), gids,
        static_cast<float*>(out), static_cast<int>(d), static_cast<int>(f),
        static_cast<int>(groups), static_cast<int>(block_n));
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || d % 8 != 0 || f % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_n % 64 == 0)
    return launch_mma<64>(x, w, gids, out, n, d, f, groups, block_n, st);
  if (block_n % 32 == 0)
    return launch_mma<32>(x, w, gids, out, n, d, f, groups, block_n, st);
  return launch_mma<16>(x, w, gids, out, n, d, f, groups, block_n, st);
}
