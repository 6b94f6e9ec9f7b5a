// The least time of one dependent exchange between two SMs: one flag
// bounced between two blocks through L2 (a development probe for
// dev/slstm_timing.py; not part of the package).
//
// Two blocks, each with more than half an SM's shared memory so that they
// land on two SMs.  Thread 0 of block 0 publishes round i on its flag with
// a release store and waits, with acquire loads, for block 1's flag to show
// i; block 1 answers each round the same way.  The two flags lie on
// separate 128-byte lines.  n rounds are n round trips, so half a round
// trip is one one-way trip: the least time of one step of a chain in which
// each step waits for a value another SM published (the sLSTM recurrence's
// exchange of h, before any data moves).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

constexpr int kSmem = 160 * 1024;

__global__ void pingpong(unsigned long long* flags, int n,
                         long long* cycles) {
  extern __shared__ unsigned char smem[];
  if (threadIdx.x != 0) return;
  smem[0] = 0;
  unsigned long long* mine = flags + blockIdx.x * 16;
  const unsigned long long* other = flags + (1 - blockIdx.x) * 16;
  const long long t0 = clock64();
  for (int i = 1; i <= n; ++i) {
    if (blockIdx.x == 0) store_release(mine, i);
    while (load_acquire(other) < static_cast<unsigned long long>(i)) {
    }
    if (blockIdx.x == 1) store_release(mine, i);
  }
  if (blockIdx.x == 0) cycles[0] = clock64() - t0;
}

}  // namespace

// n round trips of one flag between two blocks on two SMs.  flags: 32
// zeroed-here u64 of scratch; cycles: one int64, block 0's clock64 cycles
// over the n rounds.  Returns a cudaError_t.
extern "C" int slstm_pingpong(void* flags, int n, void* cycles,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      pingpong, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess) e = cudaMemsetAsync(flags, 0, 32 * 8, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  pingpong<<<2, 32, kSmem, s>>>(static_cast<unsigned long long*>(flags), n,
                                static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
