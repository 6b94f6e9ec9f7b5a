// PART: scatter the rows of vals [n, d] into out [num_out, d] by slots [n].
//
// Replaces src/repro/kernels/partition.py::partition_permute
// (_partition_kernel), which restates the scatter as a one-hot permutation
// matmul on the TPU's MXU because the TPU has no data-dependent scatter.
// Rows whose slot lies outside [0, num_out) are dropped.
//
// What bounds it on an H100: bytes.  The work is a copy (no arithmetic
// worth counting): read slots and vals once, write out once.
//
// Two paths:
//   unique != 0: the caller promises that no two rows share a slot (a
//     permutation, as the replay's global stage passes).  A scatter would
//     store each row to a random place (at d 8 in float32 a 32-byte row),
//     and rows that receive nothing would need a memset of all of out
//     first (256 MB at 8M rows).  So the scatter is turned around:
//     1. the inverse: inv[num_out] (int32: 32 MB at 8M rows) is set to -1,
//        then inv[slots[i]] = i for every slot in range, by a max reduction
//        (rows that share a slot despite the promise leave the last of
//        them);
//     2. a gather: each thread owns kInFlight 16-byte units of out (units
//        of neighbouring threads are neighbours in out), reads inv for all
//        of them, loads all of their source units (a 32-byte row is one
//        sector, loaded by two neighbouring lanes) and only then stores
//        them, as full coalesced lines.  A row whose inv is -1 is stored as
//        zeros, so out needs no memset.
//     What remains on an H100 is the random access itself: 8M random
//     4-byte writes build the inverse (about 0.15 ms at n 8M, the memset
//     included) and 8M random 32-byte reads feed the gather (about 0.35 ms
//     with its 256 MB of coalesced stores); the sequential traffic alone
//     takes 0.23 ms (dev/part_comb_timing.py's probes).
//   unique == 0: slots may collide and colliding rows sum.  Rows are added
//     with atomicAdd into a zeroed float32 accumulator (out itself for
//     float32; a scratch buffer for bfloat16, cast to out afterwards).
// Units are 16 bytes where the width allows it (d a multiple of the chunk,
// 16-byte aligned pointers), else one element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 2;  // units a thread loads before it stores one

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> struct Chunk;                       // elements per 16 bytes
template <> struct Chunk<float> { static constexpr int N = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int N = 8; };

// an element's bits: the unique path copies and never adds
template <typename T> struct Bits;
template <> struct Bits<float> { using type = unsigned int; };
template <> struct Bits<__nv_bfloat16> { using type = unsigned short; };

// inv[s] = i for every slot s in [0, num_out), 4 slots a thread (by a
// reduction: of rows that share a slot despite the promise, the last)
__global__ void build_inverse(const int32_t* __restrict__ slots,
                              int32_t* __restrict__ inv, int64_t n,
                              int64_t num_out) {
  const int64_t i0 =
      4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i0 >= n) return;
  int32_t s[4];
  if (i0 + 4 <= n && (reinterpret_cast<uintptr_t>(slots + i0) & 15) == 0) {
    const int4 q = *reinterpret_cast<const int4*>(slots + i0);
    s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = i0 + j < n ? slots[i0 + j] : -1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (s[j] >= 0 && s[j] < num_out)
      atomicMax(inv + s[j], static_cast<int32_t>(i0 + j));
}

// out unit e (row e / upr) is unit e % upr of source row inv[row], or zero
// when inv[row] is -1.  shift: log2(upr) when upr is a power of two, else -1.
template <typename U>
__global__ void __launch_bounds__(kThreads)
    gather_rows(const int32_t* __restrict__ inv, const U* __restrict__ vals,
                U* __restrict__ out, int64_t units, int64_t upr, int shift) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kInFlight) + threadIdx.x;
  int64_t src[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int64_t e = base + k * kThreads;
    int64_t row;
    if (shift >= 0) row = e >> shift;
    else if (units <= 0xffffffffll)
      row = static_cast<uint32_t>(e) / static_cast<uint32_t>(upr);
    else row = e / upr;
    const int32_t from = e < units ? __ldg(inv + row) : -1;
    src[k] = from < 0 ? -1 : static_cast<int64_t>(from) * upr + (e - row * upr);
  }
  U v[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) v[k] = src[k] >= 0 ? vals[src[k]] : U{};
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int64_t e = base + k * kThreads;
    if (e < units) out[e] = v[k];
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

inline unsigned blocks_for(int64_t threads, int64_t per_block = kThreads) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

template <typename U>
void gather(const int32_t* inv, const void* vals, void* out, int64_t units,
            int64_t upr, cudaStream_t stream) {
  int shift = -1;
  for (int b = 0; b < 62; ++b)
    if ((int64_t{1} << b) == upr) shift = b;
  gather_rows<U><<<blocks_for(units, kThreads * kInFlight), kThreads, 0,
                   stream>>>(inv, static_cast<const U*>(vals),
                             static_cast<U*>(out), units, upr, shift);
}

template <typename T>
cudaError_t launch(const int32_t* slots, const T* vals, T* out, void* scratch,
                   int64_t n, int64_t d, int64_t num_out, int unique, int vec,
                   cudaStream_t stream) {
  constexpr int V = Chunk<T>::N;
  const int64_t out_elems = num_out * d;
  if (unique) {
    auto* inv = static_cast<int32_t*>(scratch);
    if (out_elems == 0) return cudaGetLastError();
    cudaMemsetAsync(inv, 0xff, num_out * sizeof(int32_t), stream);  // -1
    if (n > 0)
      build_inverse<<<blocks_for((n + 3) / 4), kThreads, 0, stream>>>(
          slots, inv, n, num_out);
    if (vec)
      gather<uint4>(inv, vals, out, out_elems / V, d / V, stream);
    else
      gather<typename Bits<T>::type>(inv, vals, out, out_elems, d, stream);
    return cudaGetLastError();
  }
  const int64_t work = n * ((d + V - 1) / V);
  auto* acc = static_cast<float*>(scratch);
  cudaMemsetAsync(acc, 0, out_elems * sizeof(float), stream);
  if (work > 0)
    scatter_add<T><<<blocks_for(work), kThreads, 0, stream>>>(
        slots, vals, acc, n, d, num_out);
  if (static_cast<void*>(acc) != static_cast<void*>(out) && out_elems > 0)
    cast_to_bf16<<<blocks_for(out_elems), kThreads, 0, stream>>>(
        acc, reinterpret_cast<__nv_bfloat16*>(out), out_elems);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scratch: with unique != 0 an int32
// [num_out] buffer (the inverse); else the float32 [num_out, d]
// accumulator (out itself for float32).  vec != 0: d is a multiple of 16
// bytes and vals and out are 16-byte aligned.
extern "C" int teshu_partition_permute(const void* slots, const void* vals,
                                       void* out, void* scratch, int64_t n,
                                       int64_t d, int64_t num_out, int dtype,
                                       int unique, int vec, void* stream) {
  const auto* s = static_cast<const int32_t*>(slots);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(s, static_cast<const float*>(vals),
                         static_cast<float*>(out), scratch, n, d, num_out,
                         unique, vec, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(s, static_cast<const __nv_bfloat16*>(vals),
                                 static_cast<__nv_bfloat16*>(out), scratch, n,
                                 d, num_out, unique, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
