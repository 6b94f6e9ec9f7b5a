// COMB for +: out[S, d] = per-segment row sums of vals [n, d] by seg_ids [n].
//
// Replaces src/repro/kernels/combine.py::segment_combine (_combine_kernel),
// which keeps a [num_segments, block_d] accumulator resident in VMEM and
// adds a one-hot [block_n, num_segments] matrix product per tile, so its
// work grows with n * S.  Here the work grows with n only: any S, ids in
// any order, ids outside [0, S) (the -1 drop id) dropped.  Sums accumulate
// in float32; the output has the input dtype.
//
// Design: one warp per 32 consecutive rows.  A lane holds one row; the warp
// finds the runs of equal consecutive ids among its 32 lanes (a ballot of
// run heads), and for each column does a segmented inclusive scan with
// shuffles, so the last lane of each run holds the run's sum.  That lane
// adds it to the zeroed float32 accumulator with one atomicAdd per column.
// With ids sorted (the replay's global stage passes them destination-major,
// compacted to the present (destination, key) pairs) a run of up to 32 rows
// costs one or two atomics per column; a long run (a hot Zipf key) costs
// one per warp it spans.  Unsorted ids are just shorter runs.
//
// What bounds it on an H100: bytes.  Each input row is read once and each
// output row written once; the scan is a few shuffles per element.  The
// accumulator is zeroed first (S * d * 4 bytes), which the bound counts as
// the output write.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void segment_sum(const int32_t* __restrict__ ids,
                            const T* __restrict__ vals, float* __restrict__ acc,
                            int64_t n, int64_t d, int64_t num_segments) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp * 32 >= n) return;                    // whole warp past the end
  const int64_t row = warp * 32 + lane;
  int32_t id = row < n ? ids[row] : -1;
  const bool valid = row < n && id >= 0 && id < num_segments;
  if (!valid) id = -1;                           // dropped rows never write
  const int32_t prev = __shfl_up_sync(kFull, id, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != id);
  const unsigned upto = kFull >> (31 - lane);    // lanes 0..lane
  const int start = 31 - __clz(heads & upto);    // first lane of my run
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  for (int64_t c = 0; c < d; ++c) {
    float v = valid ? to_f32(vals[row * d + c]) : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, v, off);
      if (lane - off >= start) v += y;
    }
    if (tail && valid) atomicAdd(acc + static_cast<int64_t>(id) * d + c, v);
  }
}

__global__ void cast_to_bf16(const float* __restrict__ acc,
                             __nv_bfloat16* __restrict__ out, int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) out[i] = __float2bfloat16(acc[i]);
}

inline unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 = float32 (acc is out), 1 = bfloat16 (acc is a float32 [S, d]
// scratch buffer, cast into out at the end).
extern "C" int teshu_segment_combine(const void* seg_ids, const void* vals,
                                     void* out, void* acc, int64_t n, int64_t d,
                                     int64_t num_segments, int dtype,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t out_elems = num_segments * d;
  float* a = static_cast<float*>(acc);
  cudaMemsetAsync(a, 0, out_elems * sizeof(float), st);
  const auto* ids = static_cast<const int32_t*>(seg_ids);
  const int64_t threads = ((n + 31) / 32) * 32;
  if (dtype == 0) {
    if (n > 0)
      segment_sum<float><<<blocks_for(threads), kThreads, 0, st>>>(
          ids, static_cast<const float*>(vals), a, n, d, num_segments);
  } else if (dtype == 1) {
    if (n > 0)
      segment_sum<__nv_bfloat16><<<blocks_for(threads), kThreads, 0, st>>>(
          ids, static_cast<const __nv_bfloat16*>(vals), a, n, d, num_segments);
    if (out_elems > 0)
      cast_to_bf16<<<blocks_for(out_elems), kThreads, 0, st>>>(
          a, static_cast<__nv_bfloat16*>(out), out_elems);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
