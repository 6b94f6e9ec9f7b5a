// Decode attention: one new token per sequence against a KV cache.
// q [B, H, d] x k, v [B, T, KVH, d] -> out [B, H, d], positions >= valid_len
// masked with -1e30 (as the reference), q head h reading kv head h / g
// (g = H / KVH).
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel): per (batch, kv head) the g query rows of the GQA group
// are one row block streamed against the cache with an online softmax, and
// tiles past valid_len are skipped.  The math is float32 and the output has
// q's dtype.
//
// A sliding window (window > 0) keeps positions [valid_len - window,
// valid_len), the reference's mask (rows - cols) < window for the row
// valid_len - 1 (repro/models/layers.py::_sdpa_fused).  Both kernels then
// plan their splits over the window's tiles only, from the tile of its
// first position on, and mask the positions left of it in that tile.
//
// What bounds it on an H100: bytes.  Every valid cache position is read
// once (K and V, KVH * d values each) and the work per byte is g FMAs, far
// below the card's balance point.  At the serving decode (batch 4, 8 kv
// heads, d = 128, about 1,056 valid positions, bf16) a layer is 17.4 MB,
// about 5.2 us at 3.35 TB/s; at decode_32k (batch 128, T = 32,768) 17.2 GB,
// about 5.1 ms.
//
// Two kernels, chosen by dtype and head width only:
//
// - bf16 q and cache at d 64 or 128 with g <= 48 (every served model):
//   decode_tma, on Hopper's TMA (csrc/hopper.cuh), one launch.  Its grid,
//   (splits, B * KVH), depends on the shapes and the SM count only, and
//   valid_len is read on the device (a pointer, as the reference's
//   scalar-prefetch len_ref) or passed by value.  Each block works out the
//   split plan from valid_len itself: the valid 64-position tiles of a
//   (batch, kv head) pair are cut into min(tiles, splits) runs of nearly
//   equal length (split s takes tiles [s * tiles / n, (s + 1) * tiles /
//   n)), and a block with no run exits.  One producer warp streams the
//   block's K and V tiles through a ring of 4 stages with full and empty
//   mbarriers, each tile two (d 128) or one 4-D TMA box of 64 columns x 64
//   positions with the 128-byte swizzle; positions past T arrive as zeros,
//   positions in [valid_len, T) as whatever the cache holds, so S is masked
//   there and P V never reads them.  Consumer warps come in row groups of
//   16 q rows (8 when g <= 8), four warps a group, each warp owning 16
//   positions of a tile; with one row group (g <= 16) two such sets of
//   warps take the tiles in turn (the sets divide the 4 stages, so a set
//   never waits on a stage's barrier a phase ahead).  A warp computes S^T =
//   K q^T on the tensor cores (mma.sync m16n8k16, K from shared memory by
//   ldmatrix as the 16-row A operand, the group's q rows, staged once in
//   shared memory and zero-padded, as the 8-column B operand; bf16
//   products are exact in float32), its own online softmax in float32 (P
//   never rounded), P through a warp-private shared buffer, and P V on the
//   CUDA cores in float32 with each lane owning d / 32 columns for all of
//   the warp's rows, so each V element is read from shared memory once.
//   At the end the warps of a row group merge through shared memory (the
//   ring, free by then) in a fixed order.  With one split the block writes
//   the output; with more, each block writes a float32 partial (acc, m,
//   l), and the last block of its pair to finish (a per-pair counter
//   bumped by an acquire-release atomic after a block barrier; the last
//   block resets it to 0 for the next launch) merges the partials in
//   split order and writes the output, so the result does not depend on
//   which block finished last.
//   A valid_len outside [1, T] read from the device gives NaN rows.  On
//   the H100 the serving shape takes about 17 us, of which about 5 us is
//   the launch's own floor and 3 us the merge; decode_32k runs at about
//   3.1 TB/s (PERF.md).
// - anything else (a float32 q or cache, other head widths): decode_split,
//   with the split plan made on the host.  Block (split, b * KVH + kvh)
//   streams its own run of 64-position tiles and keeps a float32 partial
//   (m, l, acc) per query row; decode_combine merges the splits
//   (flash-decoding).  With one split the first kernel writes the output
//   itself.  The K and V tiles arrive by cp.async in their own dtype, 16
//   bytes per copy, in two stages; cache rows are padded by 16 bytes in
//   shared memory, so 16-byte reads of consecutive rows hit distinct banks.
//   One thread per (row, position) forms a score from 16-byte reads, one
//   warp per row does the softmax update, and one thread per (row, 8
//   columns) keeps its accumulator in registers across tiles.  Positions
//   past valid_len, and left of a window, are copied as zeros and masked;
//   decode_combine merges whatever positions the splits covered.
//
// The log-sum-exp route (both kernels): given an lse pointer, each (batch,
// q head) row also gets the natural log of the sum of exp(scale q.k) over
// the positions it attended (from the same float32 max and sum as its
// output; decode_tma works in base 2 and converts before it writes), and
// the output is written in float32 rather than in q's dtype.  A caller
// that splits a cache into blocks launches each block on this route and
// merges the blocks' outputs by their LSE (models/layers.py), with no
// rounding of a block's output between.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // cache positions per tile
constexpr int kMaxJobs = 4;            // (row, 8 columns) jobs per thread
constexpr float kMasked = -1e30f;
constexpr int kMaxSmem = 232448;       // what one H100 block may opt in to

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes as float32: 4 float32 values or 8 bfloat16 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 consecutive values of a cache row held in shared memory, from column 8 c8
template <typename T>
__device__ __forceinline__ void load8(const uint4* row, int c8, float* out) {
  if constexpr (sizeof(T) == 2) {
    load16(reinterpret_cast<const T*>(row + c8), out);
  } else {
    load16(reinterpret_cast<const T*>(row + 2 * c8), out);
    load16(reinterpret_cast<const T*>(row + 2 * c8 + 1), out + 4);
  }
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16-byte units per cache row in shared memory: the row plus one of padding
__host__ __device__ inline int row_units(int64_t d, int64_t elem_bytes) {
  return static_cast<int>(d * elem_bytes / 16 + 1);
}

// shared memory of one block, in bytes
__host__ __device__ inline int64_t smem_bytes(int64_t g, int64_t d,
                                              int64_t elem_bytes) {
  return 16 * 4 * kTile * static_cast<int64_t>(row_units(d, elem_bytes))
         + 4 * (g * d                // q rows
                + g * kTile          // scores, then probabilities
                + 3 * g);            // m, l, alpha
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_split(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, TQ* __restrict__ out,
             float* __restrict__ out_f32, float* __restrict__ part_acc,
             float* __restrict__ part_ml, float* __restrict__ lse,
             int t_len, int kvh_count, int g, int d, int valid, int first,
             int tiles_per_split, float scale) {
  constexpr int kVec = 16 / sizeof(TKV);          // cache values per unit
  const int chunks = d / kVec;                    // 16-byte units per row
  const int rs = row_units(d, sizeof(TKV));       // padded row, in units
  extern __shared__ uint4 smem[];
  uint4* stages = smem;                           // [2][K, V][kTile][rs]
  float* qs = reinterpret_cast<float*>(stages + 4 * kTile * rs);  // [g][d]
  float* ss = qs + g * d;                         // [g][kTile]
  float* m_s = ss + g * kTile;                    // [g]
  float* l_s = m_s + g;                           // [g]
  float* a_s = l_s + g;                           // [g]

  const int split = blockIdx.x;
  const int num_splits = gridDim.x;
  const int bk = blockIdx.y;                      // b * KVH + kvh
  const int b = bk / kvh_count;
  const int kvh = bk % kvh_count;
  const int tid = threadIdx.x;
  const int gd = g * d;
  const int c8n = d / 8;                          // 8-column jobs per row
  const int jobs = g * c8n;

  // q [B, H, d] with H = KVH * g: this group's rows start at (bk * g) * d
  const TQ* qb = q + static_cast<int64_t>(bk) * gd;
  for (int i = tid; i < gd; i += kThreads) qs[i] = to_f32(qb[i]);
  for (int r = tid; r < g; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.0f;
  }

  const int64_t pos_stride = static_cast<int64_t>(kvh_count) * d;
  const int64_t head0 = (static_cast<int64_t>(b) * t_len * kvh_count + kvh) * d;
  const TKV* kb = k + head0;
  const TKV* vb = v + head0;
  // positions [first, valid) are attended; the splits run over the tiles
  // from first's on
  const int t_begin = (first / kTile + split * tiles_per_split) * kTile;
  const int t_end = min(valid, t_begin + tiles_per_split * kTile);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;

  // tile t (positions t_begin + t * kTile ...) into stage st, K then V
  auto fetch = [&](int t, int st) {
    const int t0 = t_begin + t * kTile;
    for (int i = tid; i < 2 * kTile * chunks; i += kThreads) {
      const int which = i / (kTile * chunks);
      const int rem = i - which * kTile * chunks;
      const int p = rem / chunks;
      const int c = rem - p * chunks;
      const bool ok = t0 + p < t_end && t0 + p >= first;   // else zeros
      const TKV* src = (which ? vb : kb)
          + static_cast<int64_t>(ok ? t0 + p : t_begin) * pos_stride + c * kVec;
      cp_async16(stages + ((st * 2 + which) * kTile + p) * rs + c, src,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[kMaxJobs][8];
#pragma unroll
  for (int j = 0; j < kMaxJobs; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.0f;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  fetch(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      fetch(t + 1, st ^ 1);      // its stage was released at the end of t - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();             // tile t (and, at t = 0, q) visible to all
    const uint4* ks = stages + (st * 2) * kTile * rs;
    const uint4* vs = ks + kTile * rs;
    const int t0 = t_begin + t * kTile;

    for (int i = tid; i < g * kTile; i += kThreads) {
      const int r = i / kTile;
      const int p = i - r * kTile;
      const float* qr = qs + r * d;
      const uint4* kr = ks + p * rs;
      float s0 = 0.0f, s1 = 0.0f;
      for (int c = 0; c < chunks; ++c) {
        float kx[kVec], qx[kVec];
        load16(reinterpret_cast<const TKV*>(kr + c), kx);
#pragma unroll
        for (int e = 0; e < kVec; e += 4) load16(qr + c * kVec + e, qx + e);
#pragma unroll
        for (int e = 0; e < kVec; e += 2) {
          s0 = fmaf(qx[e], kx[e], s0);
          s1 = fmaf(qx[e + 1], kx[e + 1], s1);
        }
      }
      ss[i] = t0 + p < t_end && t0 + p >= first ? (s0 + s1) * scale : kMasked;
    }
    __syncthreads();

    for (int r = warp; r < g; r += kThreads / 32) {
      float* sr = ss + r * kTile;
      const float x0 = sr[lane];
      const float x1 = sr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_s[r], mx);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_s[r] - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxJobs; ++j) {
      const int job = tid + j * kThreads;
      if (job < jobs) {
        const int r = job / c8n;
        const int c8 = job - r * c8n;
        const float alpha = a_s[r];
        const float* pr = ss + r * kTile;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] *= alpha;
#pragma unroll 4
        for (int p = 0; p < kTile; ++p) {
          float vx[8];
          load8<TKV>(vs + p * rs, c8, vx);
          const float w = pr[p];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(w, vx[e], acc[j][e]);
        }
      }
    }
    __syncthreads();             // stage st and the scores are free again
  }

  const int64_t slot = static_cast<int64_t>(bk) * num_splits + split;
#pragma unroll
  for (int j = 0; j < kMaxJobs; ++j) {
    const int job = tid + j * kThreads;
    if (job >= jobs) continue;
    const int r = job / c8n;
    const int col = r * d + (job - r * c8n) * 8;
    if (num_splits == 1) {
      const float l = l_s[r];
      const float den = l == 0.0f ? 1.0f : l;
      const int64_t at = static_cast<int64_t>(bk) * gd + col;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (out_f32 != nullptr) out_f32[at + e] = acc[j][e] / den;
        else store(out + at + e, acc[j][e] / den);
      }
    } else {
      float* o = part_acc + slot * gd + col;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = acc[j][e];
    }
  }
  if (num_splits > 1) {
    for (int r = tid; r < g; r += kThreads) {
      part_ml[(slot * g + r) * 2] = m_s[r];
      part_ml[(slot * g + r) * 2 + 1] = l_s[r];
    }
  } else if (lse != nullptr) {   // natural units: the scores are scaled by e
    for (int r = tid; r < g; r += kThreads)
      lse[static_cast<int64_t>(bk) * g + r] = m_s[r] + logf(l_s[r]);
  }
}

// merge the splits of one (batch, kv head): rescale each partial to the
// common max and divide the summed accumulator by the summed l
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, TQ* __restrict__ out,
               float* __restrict__ out_f32, float* __restrict__ lse,
               int g, int d, int num_splits) {
  const int bk = blockIdx.x;
  const int gd = g * d;
  for (int i = threadIdx.x; i < gd; i += kThreads) {
    const int r = i / d;
    const int64_t slot0 = static_cast<int64_t>(bk) * num_splits;
    float mx = kMasked;
    for (int s = 0; s < num_splits; ++s)
      mx = fmaxf(mx, part_ml[((slot0 + s) * g + r) * 2]);
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < num_splits; ++s) {
      const float w = expf(part_ml[((slot0 + s) * g + r) * 2] - mx);
      l = fmaf(w, part_ml[((slot0 + s) * g + r) * 2 + 1], l);
      a = fmaf(w, part_acc[(slot0 + s) * gd + i], a);
    }
    const int64_t at = static_cast<int64_t>(bk) * gd + i;
    if (out_f32 != nullptr) out_f32[at] = a / (l == 0.0f ? 1.0f : l);
    else store(out + at, a / (l == 0.0f ? 1.0f : l));
    if (lse != nullptr && i == r * d)
      lse[static_cast<int64_t>(bk) * g + r] = mx + logf(l);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out,
           void* part_acc, void* part_ml, void* lse, int64_t batch,
           int64_t t_len, int64_t kvh, int64_t g, int64_t d, int64_t valid,
           int64_t first, int64_t tiles_per_split, int64_t num_splits,
           float scale, cudaStream_t st) {
  auto kern = decode_split<TQ, TKV>;
  static bool ready = false;   // per instantiation: allow > 48 KB once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const size_t smem = static_cast<size_t>(smem_bytes(g, d, sizeof(TKV)));
  const dim3 grid(static_cast<unsigned>(num_splits),
                  static_cast<unsigned>(batch * kvh));
  // the log-sum-exp route writes a float32 output
  TQ* out_q = lse != nullptr ? nullptr : static_cast<TQ*>(out);
  float* out_f = lse != nullptr ? static_cast<float*>(out) : nullptr;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), out_q, out_f,
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<float*>(lse), static_cast<int>(t_len), static_cast<int>(kvh), static_cast<int>(g),
      static_cast<int>(d), static_cast<int>(valid), static_cast<int>(first),
      static_cast<int>(tiles_per_split), scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || num_splits == 1) return static_cast<int>(e);
  decode_combine<TQ><<<static_cast<unsigned>(batch * kvh), kThreads, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      out_q, out_f, static_cast<float*>(lse), static_cast<int>(g),
      static_cast<int>(d), static_cast<int>(num_splits));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// decode_tma: bf16 at d 64 / 128, one launch, valid_len on the device
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTTile = 64;             // cache positions per tile
constexpr int kTStages = 4;            // K/V tiles in flight
constexpr int kSlice = 16;             // positions of a tile per consumer warp
constexpr int kSlices = kTTile / kSlice;       // consumer warps per tile and row group
constexpr int kBoxBytes = kTTile * 128;        // one 64-column box of a tile
constexpr int kMaxGroups = 3;          // row groups: g <= 48
constexpr int kMaxConsumers = kSlices * kMaxGroups;   // warps
constexpr int kMaxTmaThreads = 32 * (1 + kMaxConsumers);
constexpr float kLog2e = 1.4426950408889634f;

// N8: 8-row column tiles of S^T per warp, so 8 N8 q rows a row group
template <int D, int N8>
struct TTile {
  static constexpr int kRows = 8 * N8;
  static constexpr int kCols = D / 32;                 // output columns a lane
  static constexpr int kBoxes = D / 64;
  static constexpr int kBytes = kBoxes * kBoxBytes;    // one K or V tile
  static constexpr int kRing = kTStages * 2 * kBytes;
  static constexpr int kBarBytes = 4 * kTStages * 8 + 16;   // + the flag
  static constexpr int kPFloats = (kSlice + 1) * kRows;  // P, then alpha
  static constexpr int kQLd = D + 8;                   // bf16 per q row in smem
  static_assert(kMaxConsumers * kRows * D * 4 + 2 * kMaxGroups * kRows * 4
                    <= kRing,
                "the merge's staging and row sums must fit in the ring");
  // 1,024 of alignment, the ring, barriers and flag, then per warp P [16]
  // [rows] and alpha [rows], per warp (m, l) [rows], q [groups * rows][kQLd]
  static size_t smem(int warps, int groups) {
    return 1024 + kRing + kBarBytes
           + static_cast<size_t>(warps) * (kPFloats + 2 * kRows) * 4
           + static_cast<size_t>(groups) * kRows * kQLd * 2;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(hopper::smem_u32(p)));
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

constexpr float kLn2 = 0.6931471805599453f;

// 4 consecutive outputs a / den in float32, in one 16-byte store
__device__ __forceinline__ void store4(float* dst, float4 a, float den) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
}

// 4 consecutive outputs a / den, rounded to bf16, in one 8-byte store
__device__ __forceinline__ void store4(bf16* dst, float4 a, float den) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x / den, a.y / den);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z / den, a.w / den);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

template <int D, int N8>
__global__ void __launch_bounds__(kMaxTmaThreads, 1)
decode_tma(const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const bf16* __restrict__ q, bf16* __restrict__ out,
           float* __restrict__ out_f32, float* __restrict__ part_acc,
           float* __restrict__ part_ml, float* __restrict__ lse,
           int* __restrict__ counters, const int* __restrict__ valid_ptr,
           int valid_arg, int t_len, int kvh_count, int g, int window,
           float scale_log2) {
  using T = TTile<D, N8>;
  using namespace hopper;
  constexpr int kRows = T::kRows;
  constexpr int kCols = T::kCols;
  const int valid = valid_ptr != nullptr ? *valid_ptr : valid_arg;
  const int pair = blockIdx.y;                    // b * KVH + kvh
  const int split = blockIdx.x;
  const int gd = g * D;
  // the pair's output: bf16 rows, or float32 rows where out_f32 is given
  bf16* ob = out_f32 != nullptr ? nullptr : out + static_cast<int64_t>(pair) * gd;
  float* of = out_f32 != nullptr ? out_f32 + static_cast<int64_t>(pair) * gd : nullptr;
  if (valid < 1 || valid > t_len) {               // only from the device
    if (split == 0) {
      const float qnan = __int_as_float(0x7fc00000);
      for (int i = threadIdx.x; i < gd; i += blockDim.x) {
        if (of != nullptr) of[i] = qnan;
        else ob[i] = __float2bfloat16(qnan);
      }
      if (lse != nullptr)
        for (int i = threadIdx.x; i < g; i += blockDim.x)
          lse[static_cast<int64_t>(pair) * g + i] = qnan;
    }
    return;
  }
  // the attended positions [lo, valid): their tiles, from lo's on, are cut
  // into the splits; every block of the pair computes the same plan
  const int lo = window > 0 ? max(0, valid - window) : 0;
  const int first_tile = lo / kTTile;
  const int tiles = (valid + kTTile - 1) / kTTile - first_tile;
  const int splits = min(tiles, static_cast<int>(gridDim.x));
  if (split >= splits) return;
  const int tile0 = first_tile + split * tiles / splits;
  const int n_tiles = first_tile + (split + 1) * tiles / splits - tile0;
  const int b = pair / kvh_count;
  const int kvh = pair % kvh_count;

  // consumer warps: `sets` sets of `groups` row groups of kSlices warps;
  // set ws takes tiles ws, ws + sets, ..., row group rg q rows rg * kRows
  // .., warp ps of a row group positions 16 ps .. of each tile
  const int groups = (g + kRows - 1) / kRows;
  const int consumers = static_cast<int>(blockDim.x) / 32 - 1;
  const int per_set = kSlices * groups;
  const int sets = consumers / per_set;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* k_full = reinterpret_cast<uint64_t*>(ring + T::kRing);
  uint64_t* k_empty = k_full + kTStages;
  uint64_t* v_full = k_empty + kTStages;
  uint64_t* v_empty = v_full + kTStages;
  int* last_flag = reinterpret_cast<int*>(v_empty + kTStages);
  float* p_bufs = reinterpret_cast<float*>(ring + T::kRing + T::kBarBytes);
  float* ml_s = p_bufs + consumers * T::kPFloats;     // [warp][kRows][2]
  bf16* qs = reinterpret_cast<bf16*>(ml_s + consumers * 2 * kRows);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], per_set);    // one arrival per warp of a set
      mbar_init(&v_empty[s], per_set);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == consumers) {                        // the producer: one lane
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kTStages;
        const uint32_t ph = (i / kTStages - 1) & 1;
        const int pos = (tile0 + i) * kTTile;
        if (i >= kTStages) mbar_wait(&k_empty[s], ph);
        mbar_arrive_expect_tx(&k_full[s], T::kBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_4d(ring + (2 * s) * T::kBytes + x * kBoxBytes, &tk,
                      &k_full[s], 64 * x, kvh, pos, b);
        if (i >= kTStages) mbar_wait(&v_empty[s], ph);
        mbar_arrive_expect_tx(&v_full[s], T::kBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_4d(ring + (2 * s + 1) * T::kBytes + x * kBoxBytes, &tv,
                      &v_full[s], 64 * x, kvh, pos, b);
      }
    }
    return;
  }

  const int ws = warp / per_set;
  const int rg = (warp % per_set) / kSlices;
  const int ps = warp % kSlices;
  const int row0 = rg * kRows;
  const int ctid = threadIdx.x;                   // consumers: 0 .. cthreads
  const int cthreads = 32 * consumers;
  float* pw = p_bufs + warp * T::kPFloats;        // P [16][kRows]
  float* alpha_s = pw + kSlice * kRows;           // [kRows]

  // q rows of the pair into shared memory, zero past g
  const bf16* qp = q + static_cast<int64_t>(pair) * gd;
  for (int i = ctid; i < groups * kRows * (D / 8); i += cthreads) {
    const int r = i / (D / 8);
    const int c8 = i % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < g) val = *reinterpret_cast<const uint4*>(qp + r * D + 8 * c8);
    *reinterpret_cast<uint4*>(qs + r * T::kQLd + 8 * c8) = val;
  }
  named_barrier(1, cthreads);

  // this lane's softmax rows: 8 j + 2 (lane % 4) + e of the warp's rows
  float m[N8][2], l[N8][2];
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    m[j][0] = m[j][1] = kMasked;
    l[j][0] = l[j][1] = 0.0f;
  }
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;

  const int srow = ps * kSlice + (lane & 15);     // ldmatrix: this lane's K row
  // ldmatrix: this lane's q row (B operand: q^T, 8 rows of the group a
  // column tile) and 8-column half of a k-step
  const bf16* qrow = qs + (row0 + 8 * ((lane >> 4) & (N8 - 1)) + (lane & 7)) * T::kQLd
                     + 8 * ((lane >> 3) & 1);
  for (int i = ws; i < n_tiles; i += sets) {
    const int s = i % kTStages;
    const uint32_t ph = (i / kTStages) & 1;
    const int pos0 = (tile0 + i) * kTTile + ps * kSlice;
    // the slice's attended positions are [nlo, nv); none: nv = 0
    int nv = min(max(valid - pos0, 0), kSlice);
    const int nlo = min(max(lo - pos0, 0), nv);
    if (nlo == nv) nv = 0;
    float c[N8][4];
#pragma unroll
    for (int j = 0; j < N8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
    mbar_wait(&k_full[s], ph);
    if (nv > 0) {
      const uint8_t* kt = ring + (2 * s) * T::kBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int chunk = 2 * (kk % 4) + (lane >> 4);
        uint32_t a[4], bq[4];
        ldsm_x4(a, kt + (kk / 4) * kBoxBytes + srow * 128
                       + ((chunk ^ (srow & 7)) << 4));
        if constexpr (N8 == 2) {
          ldsm_x4(bq, qrow + 16 * kk);
          mma_bf16(c[0], a, bq[0], bq[1]);
          mma_bf16(c[N8 - 1], a, bq[2], bq[3]);
        } else {
          ldsm_x2(bq, qrow + 16 * kk);
          mma_bf16(c[0], a, bq[0], bq[1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[s]);

    if (nv > 0) {
      // c[j]: S^T at positions lane / 4 (0, 1) and lane / 4 + 8 (2, 3) of
      // the slice, q rows 8 j + 2 (lane % 4) + (0, 1)
      const bool ok0 = lane / 4 >= nlo && lane / 4 < nv;
      const bool ok1 = lane / 4 + 8 >= nlo && lane / 4 + 8 < nv;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x0 = ok0 ? c[j][e] * scale_log2 : kMasked;
          const float x1 = ok1 ? c[j][2 + e] * scale_log2 : kMasked;
          float mx = fmaxf(x0, x1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m[j][e], mx);
          const float p0 = ok0 ? exp2f(x0 - m_new) : 0.0f;
          const float p1 = ok1 ? exp2f(x1 - m_new) : 0.0f;
          float sum = p0 + p1;
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          const float alpha = exp2f(m[j][e] - m_new);
          l[j][e] = alpha * l[j][e] + sum;
          m[j][e] = m_new;
          const int r = 8 * j + 2 * (lane % 4) + e;
          pw[(lane / 4) * kRows + r] = p0;
          pw[(lane / 4 + 8) * kRows + r] = p1;
          if (lane < 4) alpha_s[r] = alpha;
        }
      }
    }
    __syncwarp();
    mbar_wait(&v_full[s], ph);
    if (nv > 0) {
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        const float4 a4 = reinterpret_cast<const float4*>(alpha_s)[r4];
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) acc[4 * r4 + e][cc] *= av[e];
      }
      const uint8_t* vt = ring + (2 * s + 1) * T::kBytes;
#pragma unroll 2
      for (int p = nlo; p < nv; ++p) {
        const int row = ps * kSlice + p;
        float vx[kCols];
        if constexpr (D == 128) {      // columns 4 lane .. 4 lane + 3
          const int chunk = (lane % 16) / 2;
          const uint2 u = *reinterpret_cast<const uint2*>(
              vt + (lane / 16) * kBoxBytes + row * 128
              + ((chunk ^ (row & 7)) << 4) + (lane % 2) * 8);
          vx[0] = bf16_lo(u.x); vx[1] = bf16_hi(u.x);
          vx[2] = bf16_lo(u.y); vx[3] = bf16_hi(u.y);
        } else {                       // columns 2 lane, 2 lane + 1
          const int chunk = lane / 4;
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
              vt + row * 128 + ((chunk ^ (row & 7)) << 4) + (lane % 4) * 4);
          vx[0] = bf16_lo(u); vx[1] = bf16_hi(u);
        }
        const float4* pr = reinterpret_cast<const float4*>(pw + p * kRows);
#pragma unroll
        for (int r4 = 0; r4 < kRows / 4; ++r4) {
          const float4 p4 = pr[r4];
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc)
              acc[4 * r4 + e][cc] = fmaf(pv[e], vx[cc], acc[4 * r4 + e][cc]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&v_empty[s]);
  }

  // merge the warps of each row group (every set, every slice), members
  // (w * groups + g0) * kSlices + ps of row group g0 for sets w, slices
  // ps: their (m, l) through ml_s; one thread per row then finds the
  // group's max M and sum L and turns each member's m into its factor
  // exp2(m - M); each warp stages its accumulator times its factor in the
  // ring (every tile has been consumed, so no load is in flight)
  float* my_ml = ml_s + warp * kRows * 2;
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + 2 * lane + e;
        my_ml[2 * r] = m[j][e];
        my_ml[2 * r + 1] = l[j][e];
      }
  }
  named_barrier(1, cthreads);
  const int members = kSlices * sets;
  auto member = [&](int g0, int w) {
    return ((w / kSlices) * groups + g0) * kSlices + w % kSlices;
  };
  float* row_ml = reinterpret_cast<float*>(ring + T::kRing) - 2 * kMaxGroups * kRows;
  for (int rr = ctid; rr < groups * kRows; rr += cthreads) {
    const int g0 = rr / kRows, r = rr % kRows;
    float mx = kMasked;
    for (int w = 0; w < members; ++w)
      mx = fmaxf(mx, ml_s[(member(g0, w) * kRows + r) * 2]);
    float lsum = 0.0f;
    for (int w = 0; w < members; ++w) {
      float* ml = ml_s + (member(g0, w) * kRows + r) * 2;
      ml[0] = exp2f(ml[0] - mx);
      lsum = fmaf(ml[1], ml[0], lsum);
    }
    row_ml[2 * rr] = mx;
    row_ml[2 * rr + 1] = lsum;
  }
  named_barrier(1, cthreads);
  float* red = reinterpret_cast<float*>(ring);    // [warp][kRows][D]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float f = my_ml[2 * r];
    float* dst = red + (warp * kRows + r) * D + lane * kCols;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) dst[cc] = acc[r][cc] * f;
  }
  named_barrier(1, cthreads);

  // 4 columns a thread: the members' sum, then the output (one split) or
  // this block's partial (acc, m, l)
  const int64_t slot = static_cast<int64_t>(pair) * gridDim.x + split;
  for (int i4 = ctid; i4 < gd / 4; i4 += cthreads) {
    const int row = 4 * i4 / D;
    const int col = 4 * i4 - row * D;
    const int g0 = row / kRows;
    const int r = row - g0 * kRows;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w = 0; w < members; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(
          red + (member(g0, w) * kRows + r) * D + col);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    const float mx = row_ml[2 * row], lsum = row_ml[2 * row + 1];
    if (splits == 1) {
      if (of != nullptr) store4(of + 4 * i4, a, lsum == 0.0f ? 1.0f : lsum);
      else store4(ob + 4 * i4, a, lsum == 0.0f ? 1.0f : lsum);
      if (lse != nullptr && col == 0)     // base 2 to natural
        lse[static_cast<int64_t>(pair) * g + row] = (mx + log2f(lsum)) * kLn2;
    } else {
      *reinterpret_cast<float4*>(part_acc + slot * gd + 4 * i4) = a;
      if (col == 0)
        *reinterpret_cast<float2*>(part_ml + (slot * g + row) * 2) =
            make_float2(mx, lsum);
    }
  }
  if (splits == 1) return;

  // the last block of the pair to finish merges every split's partial, 4
  // columns a thread, the splits in order with a running max.  The
  // barrier orders the block's partial stores before one thread's
  // acquire-release add on the counter, which publishes them at gpu scope
  // (and, in the last block, acquires the other blocks'); the barrier
  // after it hands that on to the block's other threads
  named_barrier(1, cthreads);
  if (ctid == 0) {
    int done;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(done) : "l"(&counters[pair]) : "memory");
    *last_flag = done == splits - 1;
    if (done == splits - 1) atomicExch(&counters[pair], 0);
  }
  named_barrier(1, cthreads);
  if (!*last_flag) return;
  const int64_t slot0 = static_cast<int64_t>(pair) * gridDim.x;
  for (int i4 = ctid; i4 < gd / 4; i4 += cthreads) {
    const int row = 4 * i4 / D;
    float mx = kMasked, lsum = 0.0f;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          part_ml + ((slot0 + sp) * g + row) * 2));
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          part_acc + (slot0 + sp) * gd + 4 * i4));
      const float m_new = fmaxf(mx, ml.x);
      const float f_old = exp2f(mx - m_new), f = exp2f(ml.x - m_new);
      lsum = fmaf(f, ml.y, lsum * f_old);
      a.x = fmaf(f, x.x, a.x * f_old);
      a.y = fmaf(f, x.y, a.y * f_old);
      a.z = fmaf(f, x.z, a.z * f_old);
      a.w = fmaf(f, x.w, a.w * f_old);
      mx = m_new;
    }
    if (of != nullptr) store4(of + 4 * i4, a, lsum == 0.0f ? 1.0f : lsum);
    else store4(ob + 4 * i4, a, lsum == 0.0f ? 1.0f : lsum);
    if (lse != nullptr && 4 * i4 == row * D)   // base 2 to natural
      lse[static_cast<int64_t>(pair) * g + row] = (mx + log2f(lsum)) * kLn2;
  }
}

// k or v [b, t, kvh, d] as a 4-D tensor map (innermost first: d, kvh, t,
// b) in boxes of 64 columns x 1 head x 64 positions x 1 sequence; encoded
// at every launch (it costs the host no measurable time: PERF.md)
bool cache_map(const void* base, int64_t b, int64_t t, int64_t kvh, int64_t d,
               CUtensorMap* map) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(kvh),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d * 2),
                                 static_cast<cuuint64_t>(kvh * d * 2),
                                 static_cast<cuuint64_t>(t * kvh * d * 2)};
  const cuuint32_t box[4] = {64, 1, kTTile, 1};
  return hopper::bf16_map(map, base, 4, dims, strides, box);
}

template <int D, int N8>
int launch_tma(const void* q, const void* k, const void* v, void* out,
               void* part_acc, void* part_ml, int* counters,
               const int* valid_ptr, void* lse, int64_t valid, int64_t batch,
               int64_t t_len, int64_t kvh, int64_t g, int64_t window,
               int64_t max_splits, float scale, cudaStream_t st) {
  using T = TTile<D, N8>;
  CUtensorMap mk, mv;
  if (!cache_map(k, batch, t_len, kvh, D, &mk) ||
      !cache_map(v, batch, t_len, kvh, D, &mv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = decode_tma<D, N8>;
  static bool ready = false;   // per instantiation: allow > 48 KB once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::smem(kMaxConsumers, kMaxGroups)));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  // one row group: two sets of warps take the tiles in turn; more: one
  // set.  The sets must divide the stages, so that every tile of a stage
  // goes to one set: a set then never waits on a stage's barrier ahead of
  // its last phase (a parity wait cannot tell the two apart)
  const int groups = static_cast<int>((g + T::kRows - 1) / T::kRows);
  const int warps = kSlices * groups * (groups == 1 ? 2 : 1);
  static_assert(kTStages % 2 == 0, "two sets must divide the stages");
  const dim3 grid(static_cast<unsigned>(max_splits),
                  static_cast<unsigned>(batch * kvh));
  kern<<<grid, 32 * (warps + 1), T::smem(warps, groups), st>>>(
      mk, mv, static_cast<const bf16*>(q),
      lse != nullptr ? nullptr : static_cast<bf16*>(out),   // float32 with
      lse != nullptr ? static_cast<float*>(out) : nullptr,  // the LSE
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<float*>(lse), counters, valid_ptr, static_cast<int>(valid), static_cast<int>(t_len),
      static_cast<int>(kvh), static_cast<int>(g), static_cast<int>(window),
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Whether one block takes a group of g rows of width d over a cache of
// kv_dtype (0 = float32, 1 = bfloat16): d a multiple of 8, at most
// kMaxJobs * 256 jobs of 8 columns, and the shared memory within the card's
// limit.  The wrapper asks before it launches.
extern "C" int teshu_decode_attention_fits(int64_t g, int64_t d, int kv_dtype) {
  const int64_t elem = kv_dtype == 1 ? 2 : 4;
  return d > 0 && d % 8 == 0 && g > 0 && g * d / 8 <= kMaxJobs * kThreads &&
         smem_bytes(g, d, elem) <= kMaxSmem;
}

// q [batch, kvh * g, d], k and v [batch, t_len, kvh, d], out like q, all
// contiguous and 16-byte aligned; lse, when not null, float32 [batch, kvh *
// g], and out then float32; 0 <= first < valid <= t_len, positions
// [first, valid) attended (first > 0: a sliding window).  With num_splits > 1,
// part_acc is float32 [batch * kvh, num_splits, g, d] and part_ml float32
// [batch * kvh, num_splits, g, 2]; with f = first / 64 the first tile, split
// s covers positions [(f + s * tiles_per_split) * 64, (f + (s + 1) *
// tiles_per_split) * 64) of [first, valid), and each split must start below
// valid.  dtypes 0 = float32, 1 = bfloat16 (q_dtype is also the output's).
// Returns a cudaError_t.
extern "C" int teshu_decode_attention(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, void* lse, int64_t batch, int64_t t_len, int64_t kvh,
    int64_t g, int64_t d, int64_t valid, int64_t first,
    int64_t tiles_per_split, int64_t num_splits, int q_dtype, int kv_dtype,
    float scale, void* stream) {
  if (valid < 1 || valid > t_len || first < 0 || first >= valid ||
      num_splits < 1 || tiles_per_split < 1 ||
      (first / kTile + (num_splits - 1) * tiles_per_split) * kTile >= valid ||
      batch * kvh > 65535 || !teshu_decode_attention_fits(g, d, kv_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, out, part_acc, part_ml, lse, batch, t_len,
                                kvh, g, d, valid, first, tiles_per_split, num_splits, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, out, part_acc, part_ml, lse, batch, t_len,
                                        kvh, g, d, valid, first, tiles_per_split, num_splits, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, out, part_acc, part_ml, lse, batch, t_len,
                                        kvh, g, d, valid, first, tiles_per_split, num_splits, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, part_acc, part_ml, lse, batch, t_len,
                                                kvh, g, d, valid, first, tiles_per_split, num_splits, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Whether decode_tma takes a group of g bf16 rows of width d: d 64 or 128,
// 1 <= g <= 48.  The wrapper asks before it chooses the kernel.
extern "C" int teshu_decode_attention_tma_fits(int64_t g, int64_t d) {
  return (d == 64 || d == 128) && g >= 1 && g <= 16 * kMaxGroups;
}

// decode_tma: bf16 q [batch, kvh * g, d], k and v [batch, t_len, kvh, d],
// out like q, all contiguous and 16-byte aligned; lse, when not null,
// float32 [batch, kvh * g], and out then float32.  valid_ptr, when not
// null, points at an int32 on the device that the kernel reads (outside
// [1, t_len] it writes NaN rows); otherwise valid (1 <= valid <= t_len) is
// the length; window 0 (none) or the sliding window's width.  The grid holds
// max_splits blocks per (batch, kv head) pair;
// with max_splits > 1, part_acc is float32 [batch * kvh, max_splits, g, d],
// part_ml float32 [batch * kvh, max_splits, g, 2] and counters int32
// [batch * kvh], all zero, which the kernel leaves zero.  Returns a
// cudaError_t.
extern "C" int teshu_decode_attention_tma(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, void* counters, const void* valid_ptr, void* lse,
    int64_t valid, int64_t batch, int64_t t_len, int64_t kvh, int64_t g,
    int64_t d, int64_t window, int64_t max_splits, float scale,
    void* stream) {
  if (batch < 1 || kvh < 1 || batch * kvh > 65535 || t_len < 1 ||
      window < 0 || window > (int64_t{1} << 30) ||
      t_len > (int64_t{1} << 30) || max_splits < 1 || max_splits > 65535 ||
      !teshu_decode_attention_tma_fits(g, d) ||
      (valid_ptr == nullptr && (valid < 1 || valid > t_len)) ||
      (max_splits > 1 && (part_acc == nullptr || part_ml == nullptr ||
                          counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto vp = static_cast<const int*>(valid_ptr);
  auto cnt = static_cast<int*>(counters);
  if (d == 128 && g <= 8)
    return launch_tma<128, 1>(q, k, v, out, part_acc, part_ml, cnt, vp, lse, valid, batch, t_len, kvh, g, window, max_splits, scale, st);
  if (d == 128)
    return launch_tma<128, 2>(q, k, v, out, part_acc, part_ml, cnt, vp, lse, valid, batch, t_len, kvh, g, window, max_splits, scale, st);
  if (g <= 8)
    return launch_tma<64, 1>(q, k, v, out, part_acc, part_ml, cnt, vp, lse, valid, batch, t_len, kvh, g, window, max_splits, scale, st);
  return launch_tma<64, 2>(q, k, v, out, part_acc, part_ml, cnt, vp, lse, valid, batch, t_len, kvh, g, window, max_splits, scale, st);
}
