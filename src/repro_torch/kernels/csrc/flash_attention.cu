// Prefill attention: out[BHq, Sq, D] = softmax(q k^T * scale) v, with an
// online softmax over kv tiles.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel): causal or not, GQA by reading kv row bh // group (no
// replication), queries end-aligned with the keys (q_offset = Skv - Sq),
// kv tiles strictly above the causal diagonal skipped, columns >= Skv masked
// with -1e30 (not -inf, as the reference), and the final divide guarded
// against l == 0.  A sliding window (window > 0: absolute row r sees columns
// c with r - c < window, the mask of repro/models/layers.py::_sdpa_fused)
// starts each block's walk at the kv tile of its first row's first visible
// column, so a block reads about window + its rows of keys, not all of them;
// columns left of a row's window inside that walk are masked.  A tile that
// is wholly masked for some row before any visible one scores -1e30
// everywhere, and the next tile's rescale (exp(-1e30 - m) = 0) removes what
// it added.  q and k/v may each be float32 or bfloat16; scores, the
// running (m, l) and the accumulator are float32; the output has q's dtype.
//
// What bounds it on an H100: operations.  At the serving prefill (batch 4,
// 1,024 tokens, 40 q heads over 8 kv heads, D = 128, causal) one layer is
// 43 GFLOP against 101 MB, so the card's bf16 tensor-core rate (989 TFLOP/s)
// bounds it at about 43 us, above the 30 us its bytes take.
//
// Three kernels, chosen by dtype and head width only:
//
// - bf16 q, k and v at D 64 or 128 (every served model): flash_wgmma, on
//   Hopper's TMA and wgmma (FlashAttention-3's shape; csrc/hopper.cuh).  A
//   block owns 128 query rows of one bh: a producer warpgroup (one thread
//   issues the TMA loads; the warpgroup gives its registers up with
//   setmaxnreg) and two consumer warpgroups of 64 rows each.  q, k and v
//   are 3-D maps [BH, S, D] in 64-wide boxes with the 128-byte swizzle, so
//   no box crosses a head and rows past Sq or Skv read zeros (their
//   columns are still masked: a zero key scores 0, not -1e30).  Q is
//   loaded once; K and V tiles of 128 kv rows come through a ring of 2
//   stages with their own full and empty mbarriers, so S = Q K^T can start
//   while V is still landing.  S is one m64n128 wgmma per k16 step, both
//   operands K-major from shared memory; the online softmax runs on the
//   accumulator fragments (a thread holds 2 rows; max and sum over the 4
//   lanes of a row; scale * log2(e) folded into exp2); P, rounded to bf16,
//   is the register A operand of O += P V (m64nD k16, V MN-major by its
//   transpose bit): an m64n128 accumulator's fragments are the A fragments
//   of its k16 steps.  A stage's K is released once S's wgmma is waited
//   for, its V once PV's is.  The two consumers take turns to issue their
//   products (named barriers), and within a turn S of tile t goes out
//   before PV of tile t - 1, so that the softmax of tile t runs under the
//   tensor cores' work.  Grid (ceil(Sq / 128), BHq), longest causal rows
//   first; one block a SM (160 KB of shared memory at D 128).
// - bf16 at D 16 or 32 (the smoke configs): flash_mma, 4 warps of 16 query
//   rows each, 64-row tiles, mma.sync m16n8k16 (bf16 in, float32
//   accumulate).  K and V tiles arrive by cp.async in two stages, rows
//   padded by 16 bytes so that ldmatrix reads hit distinct banks.  The
//   online softmax runs on the accumulator fragments and P goes straight
//   back as the A operand of P V, as above.
// - any float32 operand: flash_fwd, float32 FMAs on the CUDA cores.  256
//   threads, 64-row tiles staged in shared memory as float32 with rows
//   padded to D + 4 floats; thread (ty, tx) of a 16 x 16 grid owns score
//   rows ty + 16 i and columns tx + 16 j, P goes through shared memory for
//   P V.
//
// The rounding of P to bf16 is the one place the two tensor-core kernels
// depart from float32 math: at most 2^-9 of max|v| in the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block (flash_fwd, flash_mma)
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of (ty, tx)
constexpr float kMasked = -1e30f;
constexpr size_t kMaxSmem = 232448;   // what one H100 block may opt in to

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of a row as float32: 4 float32 values or 8 bfloat16 values
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

// rows [row0, row0 + 64) of a row-major [n, D] matrix into shared memory as
// float32 with row stride D + 4; rows >= n become zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int n,
                                          int row0, float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kLd = D + 4;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kVec;
    const int row = row0 + r;
    float vals[kVec];
    if (row < n) {
      load16(src + static_cast<int64_t>(row) * D + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.0f;
    }
    float* out = dst + r * kLd + c;
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

template <int D>
__host__ __device__ constexpr int kp_floats() {      // the K tile, or P once the scores are in
  return kBK * (D + 4) > kBQ * (kBK + 4) ? kBK * (D + 4) : kBQ * (kBK + 4);
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 4) + kp_floats<D>() + kBK * (D + 4));
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const TQ* __restrict__ q, const TKV* __restrict__ k,
          const TKV* __restrict__ v, TQ* __restrict__ out, int sq, int skv,
          int group, float scale, int causal, int window) {
  constexpr int kLd = D + 4;
  constexpr int kPLd = kBK + 4;
  constexpr int kDC = D / 16;                 // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);    // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;                     // [kBK][kLd]
  float* ps = ks;                                 // [kBQ][kPLd], after S
  float* vs = ks + kp_floats<D>();                // [kBK][kLd]

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y;
  const int64_t kvh = bh / group;
  const int q_offset = skv - sq;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const TQ* qb = q + static_cast<int64_t>(bh) * sq * D;
  const TKV* kb = k + kvh * skv * D;
  const TKV* vb = v + kvh * skv * D;
  load_tile<TQ, D>(qb, sq, q0, qs);

  int n_tiles = (skv + kBK - 1) / kBK;
  if (causal) {   // the block's last real row sees columns <= last
    const int last = min(q0 + kBQ, sq) - 1 + q_offset;
    n_tiles = min(n_tiles, last / kBK + 1);
  }
  // the block's first row sees columns >= its row - window + 1
  const int t_first = window > 0 ? max(0, q0 + q_offset - window + 1) / kBK : 0;

  float m[4], l[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_first; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the last tile's P and V are consumed
    load_tile<TKV, D>(kb, skv, k0, ks);
    load_tile<TKV, D>(vb, skv, k0, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each of the thread's 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i + q_offset;    // absolute causal row
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= skv || (causal && col > row) ||
            (window > 0 && row - col >= window))
          x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();                 // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPLd + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * kLd + tx * kDC;
        float vv[kDC];
        if constexpr (kDC % 4 == 0) {
#pragma unroll
          for (int c = 0; c < kDC; c += 4) {
            const float4 f = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = f.x; vv[c + 1] = f.y; vv[c + 2] = f.z; vv[c + 3] = f.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < kDC; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  TQ* ob = out + static_cast<int64_t>(bh) * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      store(ob + static_cast<int64_t>(row) * D + tx * kDC + c, acc[i][c] / den);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bhq, int64_t sq, int64_t skv, int64_t group, float scale,
           int causal, int window, cudaStream_t st) {
  static_assert(smem_bytes<D>() <= kMaxSmem, "tile too large");
  auto kern = flash_fwd<TQ, TKV, D>;
  static bool ready = false;   // per instantiation: allow > 48 KB once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<D>()));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bhq));
  kern<<<grid, kThreads, smem_bytes<D>(), st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out),
      static_cast<int>(sq), static_cast<int>(skv), static_cast<int>(group),
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;      // 4 warps x 16 query rows

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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {   // Q, 2 x (K, V)
  return sizeof(__nv_bfloat16) * 5 * 64 * (D + 8);
}

// rows [row0, row0 + 64) of a row-major bf16 [n, D] matrix into shared
// memory (row stride D + 8) by cp.async; rows >= n become zeros
template <int D>
__device__ __forceinline__ void fetch_tile(const __nv_bfloat16* src, int n,
                                           int row0, __nv_bfloat16* dst) {
  constexpr int kUnits = D / 8;
  for (int i = threadIdx.x; i < 64 * kUnits; i += kMmaThreads) {
    const int r = i / kUnits;
    const int c = (i % kUnits) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * (D + 8) + c,
               src + static_cast<int64_t>(ok ? row0 + r : 0) * D + c,
               ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
          int sq, int skv, int group, float scale, int causal, int window) {
  constexpr int kLd = D + 8;          // bf16 per shared row: an odd count
                                      // of 16-byte units, no bank conflicts
  constexpr int kKs = D / 16;         // k-steps of Q K^T
  constexpr int kDt = D / 8;          // n-tiles of the output
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [64][kLd]
  __nv_bfloat16* kvs = qs + 64 * kLd;          // [2 stages][K, V][64][kLd]

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y;
  const int64_t kvh = bh / group;
  const int q_offset = skv - sq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;           // the fragment row of this lane
  const int tc = lane & 3;            // its column pair
  const int lr = lane & 7;            // ldmatrix: row within a matrix
  const int lm = lane >> 3;           // ldmatrix: which of the 4 matrices

  const __nv_bfloat16* kb = k + kvh * skv * D;
  const __nv_bfloat16* vb = v + kvh * skv * D;
  int n_tiles = (skv + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, sq) - 1 + q_offset;
    n_tiles = min(n_tiles, last / kBK + 1);
  }
  const int t_first = window > 0 ? max(0, q0 + q_offset - window + 1) / kBK : 0;

  fetch_tile<D>(q + static_cast<int64_t>(bh) * sq * D, sq, q0, qs);
  fetch_tile<D>(kb, skv, t_first * kBK, kvs);
  fetch_tile<D>(vb, skv, t_first * kBK, kvs + 64 * kLd);
  cp_async_commit();

  unsigned qf[kKs][4];
  float o[kDt][4];
#pragma unroll
  for (int i = 0; i < kDt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + gr + q_offset;     // absolute causal rows
  const int row1 = row0 + 8;                           // of this lane's two

  for (int t = t_first; t < n_tiles; ++t) {
    const int st = (t - t_first) & 1;
    if (t + 1 < n_tiles) {     // its stage was released at the end of t - 1
      __nv_bfloat16* nxt = kvs + (st ^ 1) * 2 * 64 * kLd;
      fetch_tile<D>(kb, skv, (t + 1) * kBK, nxt);
      fetch_tile<D>(vb, skv, (t + 1) * kBK, nxt + 64 * kLd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == t_first) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + lr + 8 * (lm & 1)) * kLd
                            + kk * 16 + 8 * (lm >> 1));
    }
    const __nv_bfloat16* ks = kvs + st * 2 * 64 * kLd;
    const __nv_bfloat16* vs = ks + 64 * kLd;
    const int k0 = t * kBK;

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        ldsm_x4(b, ks + (16 * np + lr + 8 * (lm >> 1)) * kLd + kk * 16
                       + 8 * (lm & 1));
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask, then the online softmax of the lane's two rows (e < 2: row0)
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * tc + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[nt][e] * scale;
        if (col >= skv || (causal && col > row) ||
            (window > 0 && row - col >= window))
          x = kMasked;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < kDt; ++i) {
      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];
      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];
    }

    // O += P V: two n-tiles of P are one k-step of the A operand
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDt / 2; ++dp) {
        unsigned b[4];
        ldsm_x4_trans(b, vs + (16 * j + lr + 8 * (lm & 1)) * kLd + 16 * dp
                             + 8 * (lm >> 1));
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                  // stage st is free again
  }

  __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + gr + 8 * h;
    if (row >= sq) continue;
    const float den = l[h] == 0.0f ? 1.0f : l[h];
#pragma unroll
    for (int i = 0; i < kDt; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(o[i][2 * h] / den,
                                                        o[i][2 * h + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<int64_t>(row) * D + i * 8 + 2 * tc) = pair;
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int64_t bhq, int64_t sq, int64_t skv, int64_t group,
               float scale, int causal, int window, cudaStream_t st) {
  static_assert(mma_smem_bytes<D>() <= kMaxSmem, "tile too large");
  auto kern = flash_mma<D>;
  static bool ready = false;   // per instantiation: allow > 48 KB once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(mma_smem_bytes<D>()));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bhq));
  kern<<<grid, kMmaThreads, mma_smem_bytes<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<int>(sq), static_cast<int>(skv), static_cast<int>(group),
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16, D 64 or 128: TMA and wgmma
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWBQ = 128;            // query rows per block (2 x 64)
constexpr int kWBK = 128;            // kv rows per tile
constexpr int kWStages = 2;          // K / V tiles in flight
constexpr int kWThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kWBox = 64;            // bf16 along a box's 128-byte row
constexpr int kWBoxBytes = 128 * kWBox * 2;   // a box of 128 rows: 16 KB
// descriptor byte offsets (hopper.cuh): Q and K K-major; V MN-major, its
// two 64-column boxes (D 128) one box apart
constexpr uint32_t kKLbo = 16, kKSbo = 1024;
constexpr uint32_t kVLbo = kWBoxBytes, kVSbo = 1024;
constexpr int kKStep = 32;           // bytes a k16 step moves, K-major
constexpr int kVStep = 16 * 128;     // ... and MN-major (16 kv rows)
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WTile {
  static constexpr int kBoxes = D / kWBox;
  static constexpr int kBytes = kBoxes * kWBoxBytes;   // a Q, K or V tile
  static constexpr int kKOff = kBytes;                 // after Q
  static constexpr int kVOff = kKOff + kWStages * kBytes;
  static constexpr int kBarOff = kVOff + kWStages * kBytes;
  static constexpr size_t kSmem = 1024 + kBarOff
                                  + (1 + 4 * kWStages) * sizeof(uint64_t);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t{1023});
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
            int sq, int skv, int group, float scale_log2, int causal,
            int window) {
  using T = WTile<D>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ks = smem + T::kKOff;
  uint8_t* vs = smem + T::kVOff;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kWStages;
  uint64_t* v_full = k_empty + kWStages;
  uint64_t* v_empty = v_full + kWStages;

  const int nq = (sq + kWBQ - 1) / kWBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kWBQ;
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int q_offset = skv - sq;
  int t_end = (skv + kWBK - 1) / kWBK;
  if (causal) {   // the block's last real row sees columns <= last
    const int last = min(q0 + kWBQ, sq) - 1 + q_offset;
    t_end = min(t_end, last / kWBK + 1);
  }
  // the block walks kv tiles t_first .. t_end - 1, the producer and both
  // consumers alike: ring slot and mbarrier phase count from t_first
  const int t_first = window > 0 ? max(0, q0 + q_offset - window + 1) / kWBK : 0;
  const int n_tiles = t_end - t_first;

  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    mbar_init(q_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2);        // one arrival per consumer warpgroup
      mbar_init(&v_empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {                        // producer: one thread issues
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, T::kBytes);
#pragma unroll
      for (int b = 0; b < T::kBoxes; ++b)
        tma_load_3d(smem + b * kWBoxBytes, &tq, q_full, b * kWBox, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kWStages;
        const uint32_t ph = (i / kWStages - 1) & 1;
        const int row = (t_first + i) * kWBK;
        if (i >= kWStages) mbar_wait(&k_empty[s], ph);
        mbar_arrive_expect_tx(&k_full[s], T::kBytes);
#pragma unroll
        for (int b = 0; b < T::kBoxes; ++b)
          tma_load_3d(ks + s * T::kBytes + b * kWBoxBytes, &tk, &k_full[s],
                      b * kWBox, row, kvh);
        if (i >= kWStages) mbar_wait(&v_empty[s], ph);
        mbar_arrive_expect_tx(&v_full[s], T::kBytes);
#pragma unroll
        for (int b = 0; b < T::kBoxes; ++b)
          tma_load_3d(vs + s * T::kBytes + b * kWBoxBytes, &tv, &v_full[s],
                      b * kWBox, row, kvh);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();                // consumers: rows 64 (wg - 1) ..
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row_lo = q0 + 64 * cw + 16 * (tid / 32) + lane / 4;  // and + 8
  const int arow_lo = row_lo + q_offset;    // absolute causal rows
  const int arow_hi = arow_lo + 8;
  const int first_arow = q0 + 64 * cw + q_offset;
  const int c_lane = 2 * (lane % 4);
  const uint8_t* qw = smem + cw * 64 * 128;   // this warpgroup's 64 rows

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float sc[kWBK / 2];                   // S, then P, of one tile
#pragma unroll
  for (int i = 0; i < kWBK / 2; ++i) sc[i] = 0.0f;
  uint32_t pk[kWBK / 4];                // P as bf16 pairs: PV's A operand
  float m[2] = {kMasked, kMasked};      // running max, log2 domain
  float l[2] = {0.0f, 0.0f};            // this thread's share of the sum

  // i counts the block's tiles from t_first: ring slot i % kWStages
  auto issue_s = [&](int i) {           // sc = Q K_i^T
    const uint8_t* kt = ks + (i % kWStages) * T::kBytes;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kWBoxBytes + (kk % 4) * kKStep;
      wgmma_m64n128<0, 0>(sc, desc_sw128(qw + off, kKLbo, kKSbo),
                          desc_sw128(kt + off, kKLbo, kKSbo), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int i) {          // o += P V_i
    const uint8_t* vt = vs + (i % kWStages) * T::kBytes;
    fence_regs(o);
    fence_regs(pk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      const uint64_t dv = desc_sw128(vt + kk * kVStep, kVLbo, kVSbo);
      if constexpr (D == 64)
        wgmma_m64n64_rs<1>(o, pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                           pk[4 * kk + 3], dv);
      else
        wgmma_m64n128_rs<1>(o, pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                            pk[4 * kk + 3], dv);
    }
    wgmma_commit();
  };
  // the online softmax of the block's tile i on sc: masks, the running
  // max, P = 2^(s - m) in place, the running sums; alpha rescales what came
  // before.  A tile needs the mask where it reaches past Skv, above the
  // warpgroup's first row's diagonal, or left of its last row's window
  auto softmax = [&](int i_tile, float (&alpha)[2]) {
    const int k0 = (t_first + i_tile) * kWBK;
#pragma unroll
    for (int i = 0; i < kWBK / 2; ++i) sc[i] *= scale_log2;
    if (k0 + kWBK > skv || (causal && k0 + kWBK - 1 > first_arow) ||
        (window > 0 && k0 <= first_arow + 63 - window)) {
#pragma unroll
      for (int i = 0; i < kWBK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + c_lane + (i % 2);
        const int arow = (i / 2) % 2 ? arow_hi : arow_lo;
        if (col >= skv || (causal && col > arow) ||
            (window > 0 && arow - col >= window))
          sc[i] = kMasked;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kWBK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < kWBK / 2; ++i) {
      sc[i] = ex2(sc[i] - m[(i / 2) % 2]);
      sum[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
  };
  auto pack = [&] {
#pragma unroll
    for (int j = 0; j < kWBK / 4; ++j) pk[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
  };
  // the two warpgroups take turns to issue their products (named barriers
  // 1 and 2, one per warpgroup's turn), so that one's softmax runs under
  // the other's tensor-core work; consumer 0 goes first.  Each turn but
  // the first and last issues S of tile t and then PV of tile t - 1, and
  // the softmax of tile t runs under that PV.  Consumer 1 skips its last
  // hand-over, which no turn would take.
  auto turn_begin = [&] { named_barrier(1 + cw, 256); };
  auto turn_end = [&](bool last) {
    if (!(last && cw == 1)) named_barrier_arrive(2 - cw, 256);
  };
  if (cw == 1) named_barrier_arrive(1, 256);

  mbar_wait(q_full, 0);
  float alpha[2];
  mbar_wait(&k_full[0], 0);
  turn_begin();
  issue_s(0);
  turn_end(false);
  wgmma_wait<0>();
  fence_regs(sc);
  if (tid == 0) mbar_arrive(&k_empty[0]);
  softmax(0, alpha);                    // o is 0: nothing to rescale
  pack();
  for (int t = 1; t < n_tiles; ++t) {
    const int s = t % kWStages, sp = (t - 1) % kWStages;
    mbar_wait(&k_full[s], (t / kWStages) & 1);
    mbar_wait(&v_full[sp], ((t - 1) / kWStages) & 1);
    turn_begin();
    issue_s(t);
    issue_pv(t - 1);
    turn_end(false);
    wgmma_wait<1>();                    // S of tile t is in
    fence_regs(sc);
    if (tid == 0) mbar_arrive(&k_empty[s]);
    softmax(t, alpha);                  // under PV of tile t - 1
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pk);
    if (tid == 0) mbar_arrive(&v_empty[sp]);
    rescale(alpha);
    pack();
  }
  const int sl = (n_tiles - 1) % kWStages;
  mbar_wait(&v_full[sl], ((n_tiles - 1) / kWStages) & 1);
  turn_begin();
  issue_pv(n_tiles - 1);
  turn_end(true);
  wgmma_wait<0>();
  fence_regs(o);
  if (tid == 0) mbar_arrive(&v_empty[sl]);

  bf16* ob = out + static_cast<int64_t>(bh) * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row_lo + 8 * h;
    if (row >= sq) continue;
    const float den = l[h] == 0.0f ? 1.0f : l[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<int64_t>(row) * D + 8 * j + c_lane) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / den,
                                o[4 * j + 2 * h + 1] / den);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int64_t bhq, int64_t bhkv, int64_t sq, int64_t skv,
                 int64_t group, float scale, int causal, int window,
                 cudaStream_t st) {
  static_assert(WTile<D>::kSmem <= kMaxSmem, "tile too large");
  // q [bhq, sq, D], k and v [bhkv, skv, D]: 3-D maps, so that a box never
  // crosses a head and rows past sq or skv read zeros
  const cuuint32_t box[3] = {kWBox, kWBQ, 1};
  const cuuint64_t qd[3] = {D, static_cast<cuuint64_t>(sq),
                            static_cast<cuuint64_t>(bhq)};
  const cuuint64_t qst[2] = {D * 2, static_cast<cuuint64_t>(sq) * D * 2};
  const cuuint64_t kd[3] = {D, static_cast<cuuint64_t>(skv),
                            static_cast<cuuint64_t>(bhkv)};
  const cuuint64_t kst[2] = {D * 2, static_cast<cuuint64_t>(skv) * D * 2};
  CUtensorMap mq, mk, mv;
  if (!hopper::bf16_map(&mq, q, 3, qd, qst, box) ||
      !hopper::bf16_map(&mk, k, 3, kd, kst, box) ||
      !hopper::bf16_map(&mv, v, 3, kd, kst, box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_wgmma<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(WTile<D>::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((sq + kWBQ - 1) / kWBQ),
                  static_cast<unsigned>(bhq));
  kern<<<grid, kWThreads, WTile<D>::kSmem, st>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<int>(sq),
      static_cast<int>(skv), static_cast<int>(group), scale * kLog2e, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_dim(int64_t d, const void* q, const void* k, const void* v, void* out,
           int64_t bhq, int64_t sq, int64_t skv, int64_t group, float scale,
           int causal, int window, cudaStream_t st) {
  switch (d) {
    case 16: return launch<TQ, TKV, 16>(q, k, v, out, bhq, sq, skv, group, scale, causal, window, st);
    case 32: return launch<TQ, TKV, 32>(q, k, v, out, bhq, sq, skv, group, scale, causal, window, st);
    case 64: return launch<TQ, TKV, 64>(q, k, v, out, bhq, sq, skv, group, scale, causal, window, st);
    case 128: return launch<TQ, TKV, 128>(q, k, v, out, bhq, sq, skv, group, scale, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [bhq, sq, d], k and v [bhkv, skv, d], out [bhq, sq, d], all contiguous
// and 16-byte aligned; d in {16, 32, 64, 128}; dtypes 0 = float32,
// 1 = bfloat16 (q_dtype is also the output's); window 0 (none) or the
// sliding window's width.  Returns a cudaError_t.
extern "C" int teshu_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int64_t bhq,
                                     int64_t bhkv, int64_t sq, int64_t skv,
                                     int64_t d, int q_dtype, int kv_dtype,
                                     float scale, int causal, int64_t window,
                                     void* stream) {
  if (bhkv <= 0 || bhq % bhkv != 0 || bhq > 65535 || sq <= 0 || skv <= 0 ||
      window < 0 || window > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int win = static_cast<int>(window);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t group = bhq / bhkv;
  if (q_dtype == 0 && kv_dtype == 0)
    return by_dim<float, float>(d, q, k, v, out, bhq, sq, skv, group, scale, causal, win, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_dim<float, __nv_bfloat16>(d, q, k, v, out, bhq, sq, skv, group, scale, causal, win, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_dim<__nv_bfloat16, float>(d, q, k, v, out, bhq, sq, skv, group, scale, causal, win, st);
  if (q_dtype == 1 && kv_dtype == 1) {     // all bf16: the tensor cores
    switch (d) {
      case 16: return launch_mma<16>(q, k, v, out, bhq, sq, skv, group, scale, causal, win, st);
      case 32: return launch_mma<32>(q, k, v, out, bhq, sq, skv, group, scale, causal, win, st);
      case 64: return launch_wgmma<64>(q, k, v, out, bhq, bhkv, sq, skv, group, scale, causal, win, st);
      case 128: return launch_wgmma<128>(q, k, v, out, bhq, bhkv, sq, skv, group, scale, causal, win, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
