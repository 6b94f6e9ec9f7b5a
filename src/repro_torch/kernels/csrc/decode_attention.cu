// Decode attention: one new token per sequence against a KV cache.
// q [B, H, d] x k, v [B, T, KVH, d] -> out [B, H, d], positions >= valid_len
// masked with -1e30 (as the reference), q head h reading kv head h / g
// (g = H / KVH).
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel): per (batch, kv head) the g query rows of the GQA group
// are one row block streamed against the cache with an online softmax, and
// tiles past valid_len are skipped.  q and k/v may each be float32 or
// bfloat16; the math is float32 and the output has q's dtype.
//
// What bounds it on an H100: bytes.  Every valid cache position is read
// once (K and V, KVH * d values each) and the work per byte is g FMAs, far
// below the card's balance point.  At the serving decode (batch 4, 8 kv
// heads, d = 128, about 1,056 valid positions, bf16) a layer is 17.4 MB,
// about 5.2 us at 3.35 TB/s; at decode_32k (batch 128, T = 32,768) 17.2 GB,
// about 5.1 ms.
//
// Design.  (batch, kv head) pairs are few at small batch (32 at batch 4 on
// 132 SMs), so the valid positions are also split over blocks: block
// (split, b * KVH + kvh) streams its own run of 64-position tiles and keeps
// a float32 partial (m, l, acc) per query row; a second small kernel merges
// the splits (flash-decoding).  With one split the first kernel writes the
// output itself.  Inside a block, the K and V tiles arrive by cp.async in
// their own dtype, 16 bytes per copy, in two stages, so the next tile is in
// flight while this one is used.  Cache rows are padded by 16 bytes in
// shared memory, so 16-byte reads of consecutive rows hit distinct banks.
// One thread per (row, position) forms a score from 16-byte reads, one warp
// per row does the softmax update, and one thread per (row, 8 columns)
// keeps its accumulator in registers across tiles.  Shared-memory traffic
// is what held a first version of this kernel (float32 tiles, one value a
// read) to a third of the card's memory rate.  Positions past valid_len are
// copied as zeros and masked, so an unwritten cache tail (whatever it
// holds) cannot reach the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             int t_len, int kvh_count, int g, int d, int valid,
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
  const int t_begin = split * tiles_per_split * kTile;
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
      const bool ok = t0 + p < t_end;
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
      ss[i] = t0 + p < t_end ? (s0 + s1) * scale : kMasked;
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
      TQ* o = out + static_cast<int64_t>(bk) * gd + col;
#pragma unroll
      for (int e = 0; e < 8; ++e) store(o + e, acc[j][e] / den);
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
  }
}

// merge the splits of one (batch, kv head): rescale each partial to the
// common max and divide the summed accumulator by the summed l
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, TQ* __restrict__ out,
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
    store(out + static_cast<int64_t>(bk) * gd + i, a / (l == 0.0f ? 1.0f : l));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out,
           void* part_acc, void* part_ml, int64_t batch, int64_t t_len,
           int64_t kvh, int64_t g, int64_t d, int64_t valid,
           int64_t tiles_per_split, int64_t num_splits, float scale,
           cudaStream_t st) {
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
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int>(t_len), static_cast<int>(kvh), static_cast<int>(g),
      static_cast<int>(d), static_cast<int>(valid),
      static_cast<int>(tiles_per_split), scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || num_splits == 1) return static_cast<int>(e);
  decode_combine<TQ><<<static_cast<unsigned>(batch * kvh), kThreads, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<TQ*>(out), static_cast<int>(g), static_cast<int>(d),
      static_cast<int>(num_splits));
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
// contiguous and 16-byte aligned; 1 <= valid <= t_len.  With num_splits > 1,
// part_acc is float32 [batch * kvh, num_splits, g, d] and part_ml float32
// [batch * kvh, num_splits, g, 2]; split s covers positions
// [s * tiles_per_split * 64, (s + 1) * tiles_per_split * 64) of [0, valid),
// and each split must start below valid.  dtypes 0 = float32,
// 1 = bfloat16 (q_dtype is also the output's).  Returns a cudaError_t.
extern "C" int teshu_decode_attention(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, int64_t batch, int64_t t_len, int64_t kvh, int64_t g,
    int64_t d, int64_t valid, int64_t tiles_per_split, int64_t num_splits,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  if (valid < 1 || valid > t_len || num_splits < 1 || tiles_per_split < 1 ||
      (num_splits - 1) * tiles_per_split * kTile >= valid ||
      batch * kvh > 65535 || !teshu_decode_attention_fits(g, d, kv_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, out, part_acc, part_ml, batch, t_len,
                                kvh, g, d, valid, tiles_per_split, num_splits, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, out, part_acc, part_ml, batch, t_len,
                                        kvh, g, d, valid, tiles_per_split, num_splits, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, out, part_acc, part_ml, batch, t_len,
                                        kvh, g, d, valid, tiles_per_split, num_splits, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, part_acc, part_ml, batch, t_len,
                                                kvh, g, d, valid, tiles_per_split, num_splits, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
