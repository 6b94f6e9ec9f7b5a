// COMB for +: out[S, d] = per-segment row sums of vals [n, d] by seg_ids [n].
//
// Replaces src/repro/kernels/combine.py::segment_combine (_combine_kernel),
// which keeps a [num_segments, block_d] accumulator resident in VMEM and
// adds a one-hot [block_n, num_segments] matrix product per tile, so its
// work grows with n * S.  Here the work grows with n only: any S, ids in
// any order, ids outside [0, S) (the -1 drop id) dropped.  Sums accumulate
// in float32 (zeroed first: S * d * 4 bytes); the output has the input
// dtype.
//
// What bounds it on an H100: bytes.  Each input row is read once and each
// output row written once; the adds are a few per element.  With the
// replay's ids (sorted destination-major, compacted to the present
// (destination, key) pairs: 851,889 segments of 9.4 rows on average at 8M
// rows, the hottest of 263,532) the output (27 MB) fits in L2.
//
// Design: persistent blocks of one producer warp and kConsumerWarps
// consumer warps take tiles of rows in order from a counter on the device
// (the last block out resets it, so a call is one launch).
// - The producer stages each tile's ids and vals in a ring of kStages
//   stages in shared memory: the 16-byte-aligned body of each by one 1-D
//   bulk copy (cp.async.bulk), heads and tails by 4-byte cp.async (a bf16
//   off a 4-byte boundary by a 2-byte load and store), all completing on
//   the stage's mbarrier.  Each staged range sits at its source's address
//   modulo 16.
// - The consumers cut the tile into chunks of kChunk rows and the width
//   into groups of 4 columns; each thread takes a (chunk, group) unit, the
//   groups of one chunk on neighbouring lanes (kChunk is odd, so the
//   16-byte reads of a quarter warp hit distinct banks).  It sums the
//   chunk's runs of equal ids in float32 from shared memory: a run that
//   starts and ends inside the chunk is finished at once; the chunk's
//   first and last runs may go on in the neighbouring chunks.
// - Those are joined across the warp by a segmented scan over the lanes of
//   one group (a tree: log2 of the chunks a warp holds steps of shuffles),
//   so a run that spans the warp's rows, such as a tile of the hot key,
//   costs one reduction a warp and group, not one a row or a chunk.
// - Each finished run adds its sums to the zeroed float32 output with one
//   vector reduction per 4 columns (red.global.add.v4.f32, REDG...F32x4 in
//   the SASS) where d is a multiple of 4, else one scalar reduction per
//   column.
// Like a scalar float atomicAdd, the reductions flush float32 subnormals
// to zero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::bulk_load;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int kStageBytes = 36864;  // vals a stage holds: 1,152 rows at d 8
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 1;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = 32 + kConsumers;
constexpr int kChunk = 9;  // rows a consumer thread sums alone (odd)
constexpr int kMaxRows = kChunk * kConsumers;  // at most 4 columns a row
constexpr int kValsBytes = kStageBytes + 16;   // + the address modulo 16
constexpr int kIdsBytes = kMaxRows * 4 + 16;
constexpr int kSlotBytes = kValsBytes + kIdsBytes;
static_assert(kValsBytes % 16 == 0 && kIdsBytes % 16 == 0, "16-byte areas");

struct Args {
  const int32_t* ids;
  const unsigned char* vals;  // [n, d] of esz-byte elements
  float* acc;                 // [S, d], zeroed
  unsigned long long* counter;  // [0] tiles taken, [1] blocks finished
  int64_t n, d, segments, tiles;
  int rows;    // rows a tile
  int esz;     // bytes an element
  int groups;  // groups of 4 columns
  int v4;      // d % 4 == 0: one vector reduction a group
};

struct Meta {
  int64_t row0;
  int rows;     // < 0: no more tiles
  int shift_i;  // the staged ids and vals sit these bytes in
  int shift_v;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void red_v4(float* p, const float (&s)[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                   reinterpret_cast<uint64_t>(p)), "f"(s[0]), "f"(s[1]),
               "f"(s[2]), "f"(s[3]) : "memory");
}

__device__ __forceinline__ void red_f32(float* p, float x) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(p)), "f"(x) : "memory");
}

// Bytes [g, g + len) of global memory staged at sh + (g % 16): the body by
// one bulk copy (lane 0), the head's and the tail's pieces (under 16 bytes
// each) by the lanes [lane0, lane0 + 16): 4-byte pieces by cp.async, a
// 2-byte piece at either end (a bf16 off a 4-byte boundary) by a load and
// a store, which land before the lane's arrival.  Returns the body's
// bytes, for the barrier's expected count.
__device__ __forceinline__ uint32_t stage_range(const unsigned char* g,
                                                int64_t len,
                                                unsigned char* sh, int lane,
                                                int lane0, uint64_t* bar,
                                                bool issue) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const int shift = static_cast<int>(a & 15);
  unsigned char* dst = sh + shift;
  const int64_t head = len < ((16 - shift) & 15) ? len : ((16 - shift) & 15);
  const int64_t body = (len - head) & ~int64_t{15};
  if (!issue) return static_cast<uint32_t>(body);
  if (lane == 0 && body > 0)
    bulk_load(dst + head, g + head, static_cast<uint32_t>(body), bar);
  // piece p of the head (lanes lane0 ..) or of the tail (lanes lane0 + 8 ..)
  const int j = lane - lane0;
  if (j >= 0 && j < 16) {
    const int64_t from = j < 8 ? 0 : head + body;
    const int64_t to = j < 8 ? head : len;
    int64_t o = from;  // walk the pieces to the j % 8-th
    int p = 0;
    while (o < to) {
      const int64_t step = ((a + o) & 3) || to - o < 4 ? 2 : 4;
      if (p == (j & 7)) {
        if (step == 4) {
          cp_async4(dst + o, g + o);
        } else {
          *reinterpret_cast<uint16_t*>(dst + o) =
              *reinterpret_cast<const uint16_t*>(g + o);
        }
        break;
      }
      o += step;
      ++p;
    }
  }
  return static_cast<uint32_t>(body);
}

// One (chunk, group) unit's sums over rows [r0, r1) of a stage.
struct Unit {
  int32_t first, last;   // ids of the chunk's first and last runs
  bool single;           // one run only
  float head[4], tail[4];
};

template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const unsigned char* sv, const Args& a,
                                         int r, int g, float (&x)[4]) {
  if constexpr (VEC) {
    const float4 q = *reinterpret_cast<const float4*>(
        sv + (static_cast<int64_t>(r) * a.d + 4 * g) * 4);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    const T* p = reinterpret_cast<const T*>(sv) + static_cast<int64_t>(r) * a.d;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = 4 * g + j < a.d ? to_f32(p[4 * g + j]) : 0.0f;
  }
}

__device__ __forceinline__ void emit(const Args& a, int32_t id, int g,
                                     const float (&s)[4]) {
  if (id < 0 || id >= a.segments) return;  // the drop id, or out of range
  float* p = a.acc + static_cast<int64_t>(id) * a.d + 4 * g;
  if (a.v4) {
    red_v4(p, s);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * g + j < a.d) red_f32(p + j, s[j]);
  }
}

// Sums rows [r0, r1) (1..kChunk of them) of group g; runs that start and
// end inside go out at once.
template <typename T, bool VEC>
__device__ __forceinline__ Unit sum_chunk(const Args& a, const int32_t* ids,
                                          const unsigned char* sv, int r0,
                                          int r1, int g) {
  int32_t id[kChunk];
  float x[kChunk][4];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {  // every read before the adds
    const int r = r0 + i < r1 ? r0 + i : r1 - 1;
    id[i] = ids[r];
    load_row<T, VEC>(sv, a, r, g, x[i]);
  }
  Unit u{};
  float s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = x[0][j];
  int32_t cur = id[0];
  int runs = 1;
#pragma unroll
  for (int i = 1; i < kChunk; ++i) {
    if (r0 + i >= r1) break;
    if (id[i] != cur) {
      if (runs == 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) u.head[j] = s[j];
      } else {
        emit(a, cur, g, s);
      }
      ++runs;
      cur = id[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = x[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += x[i][j];
    }
  }
  if (runs == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) u.head[j] = s[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) u.tail[j] = s[j];
  u.first = id[0];
  u.last = cur;
  u.single = runs == 1;
  return u;
}

// The consumers' work on one staged tile.  Units (chunk k, group g) are
// u = k * groups + g, so lane l's previous chunk of its group sits on lane
// l - groups of the same warp when l >= groups.
template <typename T, bool VEC>
__device__ __forceinline__ void consume(const Args& a, const Meta& m,
                                        const unsigned char* stage, int ct) {
  const int32_t* ids = reinterpret_cast<const int32_t*>(stage + kValsBytes +
                                                        m.shift_i);
  const unsigned char* sv = stage + m.shift_v;
  const int lane = ct & 31;
  const int G = a.groups;
  const int units = (m.rows + kChunk - 1) / kChunk * G;
  for (int u0 = 0; u0 < units; u0 += kConsumers) {  // the same trips for all
    const int u = u0 + ct;
    const bool valid = u < units;
    const int k = valid ? u / G : 0;
    const int g = valid ? u - k * G : 0;
    Unit x{};
    if (valid) {
      const int r0 = k * kChunk;
      const int r1 = r0 + kChunk < m.rows ? r0 + kChunk : m.rows;
      x = sum_chunk<T, VEC>(a, ids, sv, r0, r1, g);
    }
    // join the runs that cross chunk boundaries: carry = the sum of the run
    // that reaches the end of my chunk, from the warp's chunks up to mine
    bool cont_in = false, cont_out = false;
    float carry[4], before[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) carry[j] = x.tail[j];
    if (G <= 16) {  // warp-uniform: two or more chunks of a group a warp
      const int32_t plast = __shfl_up_sync(~0u, x.last, G);
      const bool pvalid = __shfl_up_sync(~0u, valid, G);
      cont_in = valid && lane >= G && pvalid && plast == x.first;
      bool reset = !(x.single && cont_in);
      for (int off = G; off < 32; off <<= 1) {
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = __shfl_up_sync(~0u, carry[j], off);
        const bool yreset = __shfl_up_sync(~0u, reset, off);
        if (lane >= off && !reset) {
#pragma unroll
          for (int j = 0; j < 4; ++j) carry[j] += y[j];
          reset = yreset;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) before[j] = __shfl_up_sync(~0u, carry[j], G);
      const bool next_in = __shfl_down_sync(~0u, cont_in, G);
      cont_out = lane + G < 32 && next_in;
    }
    if (valid) {
      if (!x.single) {
        if (cont_in) {
#pragma unroll
          for (int j = 0; j < 4; ++j) x.head[j] += before[j];
        }
        emit(a, x.first, g, x.head);
        if (!cont_out) emit(a, x.last, g, x.tail);
      } else if (!cont_out) {
        emit(a, x.first, g, carry);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    segment_sum(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ Meta meta[kStages];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 64);  // 32 lanes' arrivals + 32 cp.async ones
      mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer -----------------------------------------------------
    // the next tile's ticket is taken while this one is staged
    unsigned long long next = 0;
    if (lane == 0) next = atomicAdd(a.counter, 1ull);
    for (int64_t uses = 0;; ++uses) {
      const unsigned long long t = __shfl_sync(~0u, next, 0);
      if (lane == 0 && static_cast<int64_t>(t) < a.tiles)
        next = atomicAdd(a.counter, 1ull);
      const int s = static_cast<int>(uses % kStages);
      if (uses >= kStages)  // the consumers released its last use
        mbar_wait(&empty[s], static_cast<uint32_t>((uses / kStages - 1) & 1));
      unsigned char* stage = smem + s * kSlotBytes;
      Meta m{0, -1, 0, 0};
      const bool more = static_cast<int64_t>(t) < a.tiles;
      if (more) {
        m.row0 = static_cast<int64_t>(t) * a.rows;
        const int64_t left = a.n - m.row0;
        m.rows = static_cast<int>(left < a.rows ? left : a.rows);
        m.shift_i = static_cast<int>(
            reinterpret_cast<uintptr_t>(a.ids + m.row0) & 15);
        m.shift_v = static_cast<int>(
            reinterpret_cast<uintptr_t>(a.vals + m.row0 * a.d * a.esz) & 15);
      }
      if (lane == 0) meta[s] = m;
      const unsigned char* gi =
          reinterpret_cast<const unsigned char*>(a.ids + m.row0);
      const unsigned char* gv = a.vals + m.row0 * a.d * a.esz;
      const int64_t li = more ? int64_t{4} * m.rows : 0;
      const int64_t lv = more ? m.rows * a.d * a.esz : 0;
      uint32_t bytes = 0;
      if (lane == 0)
        bytes = stage_range(gi, li, stage + kValsBytes, lane, 0, &full[s],
                            false) +
                stage_range(gv, lv, stage, lane, 16, &full[s], false);
      // lane 0 expects the bulk bytes before it issues the copies; the
      // others arrive after their 2-byte stores (lane 0 has none: its piece
      // is of the int32 ids)
      if (lane == 0) mbar_arrive_expect_tx(&full[s], bytes);
      if (more) {
        stage_range(gi, li, stage + kValsBytes, lane, 0, &full[s], true);
        stage_range(gv, lv, stage, lane, 16, &full[s], true);
      }
      if (lane != 0) mbar_arrive(&full[s]);
      cp_async_arrive(&full[s]);
      if (!more) break;
    }
  } else {
    // ---- consumers ----------------------------------------------------
    const int ct = threadIdx.x - 32;
    for (int64_t uses = 0;; ++uses) {
      const int s = static_cast<int>(uses % kStages);
      mbar_wait(&full[s], static_cast<uint32_t>((uses / kStages) & 1));
      const Meta m = meta[s];
      if (m.rows < 0) break;
      consume<T, VEC>(a, m, smem + s * kSlotBytes, ct);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // the last block out resets the counter for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long done;
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;\n"
                 : "=l"(done) : "l"(a.counter + 1) : "memory");
    if (done == gridDim.x - 1) {
      atomicExch(a.counter, 0ull);
      atomicExch(a.counter + 1, 0ull);
    }
  }
}

__global__ void cast_to_bf16(const float* __restrict__ acc,
                             __nv_bfloat16* __restrict__ out, int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) out[i] = __float2bfloat16(acc[i]);
}

template <typename T, bool VEC>
int launch(const Args& a, unsigned grid, cudaStream_t st) {
  constexpr size_t smem = static_cast<size_t>(kStages) * kSlotBytes;
  static bool ready = false;  // per instantiation: allow > 48 KB once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_sum<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  segment_sum<T, VEC><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows a tile holds at width d in esz-byte elements (0: a row is wider
// than a stage): chunks of kChunk rows, as many as give every (chunk,
// group) unit a consumer thread, and at most kStageBytes of vals.
extern "C" int64_t teshu_segment_combine_tile_rows(int64_t d, int esz) {
  if (d <= 0 || esz <= 0) return 0;
  const int64_t groups = (d + 3) / 4;
  int64_t rows = kChunk * (groups < kConsumers ? kConsumers / groups : 1);
  const int64_t fit = kStageBytes / (d * esz);
  rows = rows < fit ? rows : fit;
  return rows < kMaxRows ? rows : kMaxRows;
}

// dtype: 0 = float32 (acc is out), 1 = bfloat16 (acc is a float32 [S, d]
// scratch buffer, cast into out at the end).  counter: two zeroed uint64
// on the device, left zeroed by every launch and used by one stream only;
// sms: the device's multiprocessor count.
extern "C" int teshu_segment_combine(const void* seg_ids, const void* vals,
                                     void* out, void* acc, void* counter,
                                     int64_t n, int64_t d,
                                     int64_t num_segments, int dtype, int sms,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || d < 0 || n < 0 || num_segments < 0 ||
      counter == nullptr || sms <= 0 ||
      (reinterpret_cast<uintptr_t>(vals) & (dtype == 0 ? 3 : 1)) != 0 ||
      (reinterpret_cast<uintptr_t>(seg_ids) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(acc) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t out_elems = num_segments * d;
  float* f = static_cast<float*>(acc);
  cudaMemsetAsync(f, 0, out_elems * sizeof(float), st);
  const int esz = dtype == 0 ? 4 : 2;
  int err = static_cast<int>(cudaSuccess);
  if (n > 0 && d > 0) {
    Args a{};
    a.ids = static_cast<const int32_t*>(seg_ids);
    a.vals = static_cast<const unsigned char*>(vals);
    a.acc = f;
    a.counter = static_cast<unsigned long long*>(counter);
    a.n = n;
    a.d = d;
    a.segments = num_segments;
    a.rows = static_cast<int>(teshu_segment_combine_tile_rows(d, esz));
    if (a.rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
    a.tiles = (n + a.rows - 1) / a.rows;
    a.esz = esz;
    a.groups = static_cast<int>((d + 3) / 4);
    a.v4 = d % 4 == 0;
    const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
    const unsigned grid = static_cast<unsigned>(a.tiles < most ? a.tiles : most);
    const bool vec = dtype == 0 && d % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(vals) & 15) == 0;
    if (dtype == 1) err = launch<__nv_bfloat16, false>(a, grid, st);
    else if (vec) err = launch<float, true>(a, grid, st);
    else err = launch<float, false>(a, grid, st);
  }
  if (err != static_cast<int>(cudaSuccess)) return err;
  if (dtype == 1 && out_elems > 0)
    cast_to_bf16<<<static_cast<unsigned>((out_elems + 255) / 256), 256, 0,
                   st>>>(f, static_cast<__nv_bfloat16*>(out), out_elems);
  return static_cast<int>(cudaGetLastError());
}
