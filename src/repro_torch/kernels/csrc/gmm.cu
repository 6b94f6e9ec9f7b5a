// Grouped matmul: out[n, f] with row tile i (rows [i * block_n, (i + 1) *
// block_n)) of x[n, d] times w[gids[i]], w[G, d, f]; float32 accumulation,
// the output in x's dtype.
//
// Replaces src/repro/kernels/gmm.py::gmm (_gmm_kernel): the MoE expert FFN
// after the tokens are sorted by expert and padded per expert to a multiple
// of block_n.  The TPU kernel walks a (row tile, f block, d block) grid in
// order and carries the float32 sum in VMEM across the d axis, with the
// group ids scalar-prefetched to pick each tile's weight block; here the d
// loop runs inside one block per (rows, output columns), and the block reads
// its own group id.  Any order of ids is taken: repeated ids, groups with no
// tile.  An id outside [0, G) fills its tile with NaN (the kernel cannot
// raise without a synchronise; the wrapper's CPU path raises).
//
// What bounds it on an H100: Qwen3-MoE's prefill (128 experts of d 4096 x f
// 1536, 384 padded rows each) moves 2.17 GB (1.61 GB of expert weights, x
// and the output) for 0.62 TFLOP: 0.65 ms of bytes against 0.63 ms of bf16
// tensor-core operations, both; a decode step's launch (16 padded rows per
// expert) moves 1.63 GB for 0.026 TFLOP: 0.49 ms, bytes.
//
// Design, bf16 x and w (the serving path): TMA loads into a ring of
// shared-memory stages, one thread of a producer warp issuing them, mbarriers
// (full: the bytes landed; empty: the consumers are done with the stage), and
// consumer warpgroups running wgmma.mma_async (bf16 in, float32 accumulate)
// straight from the swizzled stages (csrc/hopper.cuh).  A stage holds 64
// reduction steps (128 bytes of bf16, the swizzle's row).  x is a 2-D map
// [n, d] and w a 3-D map [G, d, f], so a box never crosses an expert and the
// ragged ends of d and f read zeros; output columns past f are not stored.
// d and f must be multiples of 8 (16-byte strides).  wgmma takes 64 rows of
// its A operand, hence two paths by block_n:
// - block_n a multiple of 128 (the MoE prefill, operations and bytes):
//   gmm_wgmma.  A block owns 128 rows of one expert and 256 columns: a
//   producer warpgroup (one thread issues, the warpgroup gives its registers
//   up with setmaxnreg) and two consumer warpgroups, each one m64n256k16
//   product per k16 step, x K-major (A) and w[g] MN-major (B, transposed),
//   in 4 stages of 48 KB.  The blocks of one 128-row tile are neighbours in
//   the launch order (columns fastest), and those of one expert run in the
//   same wave, so the 3 row tiles of an expert share each w[g] box through
//   L2 and the 6 column blocks of a row tile its x box.  Not persistent, no
//   cluster multicast: one block a SM, the grid in launch order.  The
//   accumulator goes through shared memory (the drained ring) to coalesced
//   16-byte stores.
// - any other block_n, a multiple of 16 (the decode step, bytes: stream the
//   experts): gmm_wgmma_t with the operands swapped, out^T = w[g]^T x^T.
//   The 64-row M of wgmma runs over f (two m64 products: 128 columns of f a
//   block, A = w[g]'s MN-major box, transposed) and N over the tile's NT
//   tokens (B = x's K-major box), NT the largest of 64, 32, 16 dividing
//   block_n, so a block's rows share one group.  6 / 5 / 4 stages (NT 16 /
//   32 / 64) keep 96-108 KB of TMA in flight per block, two blocks a SM.
//   The accumulator is transposed back through shared memory.
// float32 x and w (the smoke configs): gmm_f32, float32 FMAs on the CUDA
// cores, 16 rows x 64 columns per block of 16 x 16 threads, any d and f.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBK = 64;                  // reduction steps per stage
constexpr int kBox = 64;                 // bf16 along a box's 128-byte row
constexpr int kBoxBytes = kBox * kBK * 2;  // one 64 x 64 box of w: 8 KB
// descriptor byte offsets (hopper.cuh): K-major tiles, and w[g]'s MN-major
// boxes, side by side one box apart
constexpr uint32_t kKLbo = 16, kKSbo = 1024;
constexpr uint32_t kMnLbo = kBoxBytes, kMnSbo = 1024;
constexpr int kKStepK = 32;              // bytes a k16 step moves, K-major
constexpr int kKStepMn = 16 * 128;       // ... and MN-major

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t{1023});
}

__device__ void fill_nan(bf16* out, int64_t m0, int rows, int n0, int cols,
                         int f) {
  const bf16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int col = n0 + i % cols;
    if (col < f) out[(m0 + i / cols) * f + col] = nan;
  }
}

// ---------------------------------------------------------------------------
// block_n % 128 == 0: 128 rows x 256 columns a block
// ---------------------------------------------------------------------------

constexpr int kCM = 128;
constexpr int kCN = 256;
constexpr int kCStages = 4;
constexpr int kCThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kCXBytes = kCM * kBK * 2;  // 16 KB
constexpr int kCStageBytes = kCXBytes + (kCN / kBox) * kBoxBytes;  // 48 KB
constexpr int kCOutLd = kCN + 8;         // bf16 per staged output row
constexpr size_t kCSmem = 1024 + kCStages * kCStageBytes
                          + 2 * kCStages * sizeof(uint64_t);
static_assert(kCM * kCOutLd * 2 <= kCStages * kCStageBytes, "staging");

__global__ void __launch_bounds__(kCThreads, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap tx,
          const __grid_constant__ CUtensorMap tw,
          const int* __restrict__ gids, bf16* __restrict__ out, int d, int f,
          int groups, int block_n, int col_blocks) {
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / col_blocks) * kCM;
  const int n0 = static_cast<int>(blockIdx.x % col_blocks) * kCN;
  const int g = gids[m0 / block_n];
  if (g < 0 || g >= groups) {           // the whole block: no barrier passed
    fill_nan(out, m0, kCM, n0, kCN, f);
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kCStages * kCStageBytes);
  uint64_t* empty = full + kCStages;
  if (threadIdx.x == 0) {
    tma_prefetch(&tx);
    tma_prefetch(&tw);
    for (int s = 0; s < kCStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);          // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int n_k = (d + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {                        // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % kCStages;
        if (t >= kCStages) mbar_wait(&empty[s], (t / kCStages - 1) & 1);
        uint8_t* st = smem + s * kCStageBytes;
        mbar_arrive_expect_tx(&full[s], kCStageBytes);
        tma_load_2d(st, &tx, &full[s], t * kBK, static_cast<int>(m0));
#pragma unroll
        for (int c = 0; c < kCN / kBox; ++c)
          tma_load_3d(st + kCXBytes + c * kBoxBytes, &tw, &full[s],
                      n0 + c * kBox, t * kBK, g);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();                // consumers: rows 64 (wg - 1) ..
  const int cw = wg - 1;
  float acc[kCN / 2];
#pragma unroll
  for (int i = 0; i < kCN / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kCStages;
    mbar_wait(&full[s], (t / kCStages) & 1);
    const uint8_t* st = smem + s * kCStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n256<0, 1>(
          acc, desc_sw128(st + cw * (kCXBytes / 2) + kk * kKStepK, kKLbo,
                          kKSbo),
          desc_sw128(st + kCXBytes + kk * kKStepMn, kMnLbo, kMnSbo));
    wgmma_commit();
    wgmma_wait<1>();                    // stage t - 1's products are done
    if (t > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(t - 1) % kCStages]);
  }
  wgmma_wait<0>();

  // the epilogue: both consumers are done with the ring, which now stages
  // the 128 x 256 bf16 tile for 16-byte stores
  named_barrier(1, 2 * 128);
  bf16* tile = reinterpret_cast<bf16*>(smem);
  const int lane = threadIdx.x % 32;
  const int r0 = cw * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kCN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(tile + r0 * kCOutLd + col) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r0 + 8) * kCOutLd + col) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_barrier(1, 2 * 128);
  constexpr int kChunks = kCN / 8;      // 16-byte chunks per row
  for (int i = threadIdx.x - 128; i < kCM * kChunks; i += 2 * 128) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (n0 + c < f)
      *reinterpret_cast<uint4*>(out + (m0 + r) * f + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kCOutLd + c);
  }
}

// ---------------------------------------------------------------------------
// any other block_n: out^T = w[g]^T x^T, 128 columns of f x NT tokens a block
// ---------------------------------------------------------------------------

constexpr int kSF = 128;                 // columns of f per block
constexpr int kSThreads = 160;           // a consumer warpgroup + producer warp
constexpr int kSWBytes = (kSF / kBox) * kBoxBytes;  // 16 KB

template <int NT>
struct Swap {
  static constexpr int kStages = NT == 16 ? 6 : NT == 32 ? 5 : 4;
  static constexpr int kXBytes = NT * kBK * 2;
  static constexpr int kStageBytes = kSWBytes + kXBytes;
  static constexpr int kOutLd = kSF + 8;  // bf16 per staged token row
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes
                                  + 2 * kStages * sizeof(uint64_t);
  static_assert(NT * kOutLd * 2 <= kStages * kStageBytes, "staging");
};

template <int NT>
__global__ void __launch_bounds__(kSThreads)
gmm_wgmma_t(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw,
            const int* __restrict__ gids, bf16* __restrict__ out, int d,
            int f, int groups, int block_n, int col_blocks) {
  using C = Swap<NT>;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / col_blocks) * NT;
  const int n0 = static_cast<int>(blockIdx.x % col_blocks) * kSF;
  const int g = gids[m0 / block_n];
  if (g < 0 || g >= groups) {
    fill_nan(out, m0, NT, n0, kSF, f);
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages *
                                               C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  if (threadIdx.x == 0) {
    tma_prefetch(&tx);
    tma_prefetch(&tw);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int n_k = (d + kBK - 1) / kBK;

  if (threadIdx.x >= 128) {             // the producer warp
    if (threadIdx.x == 128) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % C::kStages;
        if (t >= C::kStages) mbar_wait(&empty[s], (t / C::kStages - 1) & 1);
        uint8_t* st = smem + s * C::kStageBytes;
        mbar_arrive_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
        for (int c = 0; c < kSF / kBox; ++c)
          tma_load_3d(st + c * kBoxBytes, &tw, &full[s], n0 + c * kBox,
                      t * kBK, g);
        tma_load_2d(st + kSWBytes, &tx, &full[s], t * kBK,
                    static_cast<int>(m0));
      }
    }
    return;
  }

  float acc[kSF / 64][NT / 2];
#pragma unroll
  for (int p = 0; p < kSF / 64; ++p)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[p][i] = 0.0f;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % C::kStages;
    mbar_wait(&full[s], (t / C::kStages) & 1);
    const uint8_t* st = smem + s * C::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t b = desc_sw128(st + kSWBytes + kk * kKStepK, kKLbo,
                                    kKSbo);
#pragma unroll
      for (int p = 0; p < kSF / 64; ++p) {
        const uint64_t a = desc_sw128(st + p * kBoxBytes + kk * kKStepMn,
                                      kMnLbo, kMnSbo);
        if constexpr (NT == 16) wgmma_m64n16<1, 0>(acc[p], a, b);
        else if constexpr (NT == 32) wgmma_m64n32<1, 0>(acc[p], a, b);
        else wgmma_m64n64<1, 0>(acc[p], a, b);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (t > 0 && threadIdx.x == 0) mbar_arrive(&empty[(t - 1) % C::kStages]);
  }
  wgmma_wait<0>();

  // transpose through the drained ring: the tile as [token][f]
  named_barrier(1, 128);
  bf16* tile = reinterpret_cast<bf16*>(smem);
  const int lane = threadIdx.x % 32;
  const int f0 = (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int p = 0; p < kSF / 64; ++p)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      const int tok = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const int fc = p * 64 + f0 + 8 * ((i / 2) % 2);
      tile[tok * C::kOutLd + fc] = __float2bfloat16_rn(acc[p][i]);
    }
  named_barrier(1, 128);
  constexpr int kChunks = kSF / 8;
  for (int i = threadIdx.x; i < NT * kChunks; i += 128) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (n0 + c < f)
      *reinterpret_cast<uint4*>(out + (m0 + r) * f + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * C::kOutLd + c);
  }
}

// the two maps: x [n, d] in boxes of 64 x rows, w [G, d, f] in 64 x 64
bool make_maps(CUtensorMap* mx, CUtensorMap* mw, const void* x, const void* w,
               int64_t n, int64_t d, int64_t f, int64_t groups,
               uint32_t rows) {
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(d),
                            static_cast<cuuint64_t>(n)};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t xb[2] = {kBK, rows};
  const cuuint64_t wd[3] = {static_cast<cuuint64_t>(f),
                            static_cast<cuuint64_t>(d),
                            static_cast<cuuint64_t>(groups)};
  const cuuint64_t ws[2] = {static_cast<cuuint64_t>(f) * 2,
                            static_cast<cuuint64_t>(d * f) * 2};
  const cuuint32_t wb[3] = {kBox, kBK, 1};
  return bf16_map(mx, x, 2, xd, xs, xb) && bf16_map(mw, w, 3, wd, ws, wb);
}

template <typename K>
int launch(K kernel, size_t smem, int threads, uint32_t rows, int64_t cols,
           const void* x, const void* w, const int* gids, void* out,
           int64_t n, int64_t d, int64_t f, int64_t groups, int64_t block_n,
           cudaStream_t st) {
  CUtensorMap mx, mw;
  if (!make_maps(&mx, &mw, x, w, n, d, f, groups, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t col_blocks = (f + cols - 1) / cols;
  const int64_t blocks = n / rows * col_blocks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      mx, mw, gids, static_cast<bf16*>(out), static_cast<int>(d),
      static_cast<int>(f), static_cast<int>(groups),
      static_cast<int>(block_n), static_cast<int>(col_blocks));
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_swapped(const void* x, const void* w, const int* gids, void* out,
                   int64_t n, int64_t d, int64_t f, int64_t groups,
                   int64_t block_n, cudaStream_t st) {
  return launch(gmm_wgmma_t<NT>, Swap<NT>::kSmem, kSThreads, NT, kSF, x, w,
                gids, out, n, d, f, groups, block_n, st);
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
      block_n % 16 != 0 || n % block_n != 0 || n > INT32_MAX ||
      d > INT32_MAX || f > INT32_MAX || groups > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((f + kFN - 1) / kFN > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
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
  if (block_n % kCM == 0)
    return launch(gmm_wgmma, kCSmem, kCThreads, kCM, kCN, x, w, gids, out, n,
                  d, f, groups, block_n, st);
  if (block_n % 64 == 0)
    return launch_swapped<64>(x, w, gids, out, n, d, f, groups, block_n, st);
  if (block_n % 32 == 0)
    return launch_swapped<32>(x, w, gids, out, n, d, f, groups, block_n, st);
  return launch_swapped<16>(x, w, gids, out, n, d, f, groups, block_n, st);
}
