// PART: scatter the rows of vals [n, d] into out [num_out, d] by slots [n].
//
// Replaces src/repro/kernels/partition.py::partition_permute
// (_partition_kernel), which restates the scatter as a one-hot permutation
// matmul on the TPU's MXU because the TPU has no data-dependent scatter.
// Hopper has one, so this is a direct row scatter: one thread per
// (row, 16-byte column chunk).  Rows whose slot lies outside [0, num_out)
// are dropped.
//
// What bounds it on an H100: bytes.  The work is a copy (no arithmetic
// worth counting): read slots and vals once, write out once.  The design
// keeps every thread on one 16-byte load and one 16-byte store where the
// width allows it (d a multiple of the chunk, 16-byte aligned pointers),
// so the copy runs at full transaction width.
//
// Two paths:
//   unique != 0: the caller guarantees no two rows share a slot (a
//     permutation, as the replay's global stage passes).  No atomics and no
//     scratch: out is zeroed (rows that receive nothing stay 0) and each row
//     is stored whole.
//   unique == 0: slots may collide and colliding rows sum.  Rows are added
//     with atomicAdd into a zeroed float32 accumulator (out itself for
//     float32; a scratch buffer for bfloat16, cast to out afterwards).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> struct Chunk;                       // elements per 16 bytes
template <> struct Chunk<float> { static constexpr int N = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int N = 8; };

template <typename T>
__global__ void scatter_unique(const int32_t* __restrict__ slots,
                               const T* __restrict__ vals, T* __restrict__ out,
                               int64_t n, int64_t d, int64_t num_out, int vec) {
  constexpr int V = Chunk<T>::N;
  const int64_t chunks = (d + V - 1) / V;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * chunks) return;
  const int64_t row = t / chunks;
  const int64_t c0 = (t - row * chunks) * V;
  const int32_t s = slots[row];
  if (s < 0 || s >= num_out) return;
  const T* src = vals + row * d + c0;
  T* dst = out + static_cast<int64_t>(s) * d + c0;
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    for (int j = 0; j < V && c0 + j < d; ++j) dst[j] = src[j];
  }
}

template <typename T>
__global__ void scatter_add(const int32_t* __restrict__ slots,
                            const T* __restrict__ vals, float* __restrict__ acc,
                            int64_t n, int64_t d, int64_t num_out) {
  constexpr int V = Chunk<T>::N;
  const int64_t chunks = (d + V - 1) / V;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * chunks) return;
  const int64_t row = t / chunks;
  const int64_t c0 = (t - row * chunks) * V;
  const int32_t s = slots[row];
  if (s < 0 || s >= num_out) return;
  const T* src = vals + row * d + c0;
  float* dst = acc + static_cast<int64_t>(s) * d + c0;
  for (int j = 0; j < V && c0 + j < d; ++j) atomicAdd(dst + j, to_f32(src[j]));
}

__global__ void cast_to_bf16(const float* __restrict__ acc,
                             __nv_bfloat16* __restrict__ out, int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) out[i] = __float2bfloat16(acc[i]);
}

inline unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T>
cudaError_t launch(const int32_t* slots, const T* vals, T* out, float* scratch,
                   int64_t n, int64_t d, int64_t num_out, int unique, int vec,
                   cudaStream_t stream) {
  constexpr int V = Chunk<T>::N;
  const int64_t work = n * ((d + V - 1) / V);
  const int64_t out_elems = num_out * d;
  if (unique) {
    cudaMemsetAsync(out, 0, out_elems * sizeof(T), stream);
    if (work > 0)
      scatter_unique<T><<<blocks_for(work), kThreads, 0, stream>>>(
          slots, vals, out, n, d, num_out, vec);
    return cudaGetLastError();
  }
  cudaMemsetAsync(scratch, 0, out_elems * sizeof(float), stream);
  if (work > 0)
    scatter_add<T><<<blocks_for(work), kThreads, 0, stream>>>(
        slots, vals, scratch, n, d, num_out);
  if (static_cast<void*>(scratch) != static_cast<void*>(out) && out_elems > 0)
    cast_to_bf16<<<blocks_for(out_elems), kThreads, 0, stream>>>(
        scratch, reinterpret_cast<__nv_bfloat16*>(out), out_elems);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  For float32 with unique == 0 the
// caller passes out as scratch; for bfloat16 a float32 [num_out, d] buffer.
extern "C" int teshu_partition_permute(const void* slots, const void* vals,
                                       void* out, void* scratch, int64_t n,
                                       int64_t d, int64_t num_out, int dtype,
                                       int unique, int vec, void* stream) {
  const auto* s = static_cast<const int32_t*>(slots);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(s, static_cast<const float*>(vals),
                         static_cast<float*>(out), static_cast<float*>(scratch),
                         n, d, num_out, unique, vec, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(s, static_cast<const __nv_bfloat16*>(vals),
                                 static_cast<__nv_bfloat16*>(out),
                                 static_cast<float*>(scratch), n, d, num_out,
                                 unique, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
