// The ordered segmented fold: float64 sum / min / max over segments.
//
// Replaces the lax.scan fold inside src/repro/core/jaxplan.py::_combine (a
// traced scan, not a Pallas kernel): every equal-key segment of the replay
// is folded left to right, seeded with its first row, which is exactly the
// sequential contract of repro.core.messages.Combiner (ufunc.at for SUM,
// np.minimum / np.maximum for MIN / MAX).  The result must be bit-identical
// to the numpy executors, so the sum may not be reordered: no tree, no
// atomics.
//
// Design: one thread per (segment, column).  Thread (r, c) exits unless a
// segment begins at row r (is_start[r], or r == 0); the survivors walk their
// segment strictly in row order and write the running value at every row
// (only segment-end rows are read by the replay, which kills the rest).
// Segments run in parallel; rows inside one run in sequence, so a hot Zipf
// key costs latency in proportion to its row count.  That is accepted: it
// is the price of the exact order.  To keep that walk from paying one
// memory round trip per row, a thread loads the next kUnroll rows' flags and
// values together (loads past the segment end are harmless reads of the next
// segment) and then folds them in order, stopping at the next segment start.
//
// MIN / MAX follow numpy, not CUDA's fmin / fmax (which drop NaN): a NaN in
// either operand propagates, and on a tie (0.0 against -0.0) the later row
// wins, as np.minimum / np.maximum give it.
//
// What bounds it on an H100: bytes (one read of vals and is_start, one
// write of out); the arithmetic is one float64 operation per element, far
// below the float64 peak.  A warp's column threads read one row's
// contiguous 8 * d bytes together.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int OP>
__device__ __forceinline__ double fold(double acc, double v) {
  if (OP == 0) return __dadd_rn(acc, v);
  if (OP == 1) return (acc < v || isnan(acc)) ? acc : v;
  return (acc > v || isnan(acc)) ? acc : v;
}

template <int OP>
__global__ void segmented_fold(const uint8_t* __restrict__ is_start,
                               const double* __restrict__ vals,
                               double* __restrict__ out, int64_t n, int64_t d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * d) return;
  const int64_t r0 = t / d;
  const int64_t c = t - r0 * d;
  if (r0 != 0 && !is_start[r0]) return;
  double acc = vals[r0 * d + c];
  out[r0 * d + c] = acc;
  for (int64_t r = r0 + 1; r < n; r += kUnroll) {
    bool stop[kUnroll];
    double v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + u;
      stop[u] = row >= n || is_start[row];
      v[u] = row < n ? vals[row * d + c] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (stop[u]) return;
      acc = fold<OP>(acc, v[u]);
      out[(r + u) * d + c] = acc;
    }
  }
}

}  // namespace

// op: 0 = sum, 1 = min, 2 = max.  is_start is a bool [n] (one byte each).
extern "C" int teshu_segmented_fold(const void* is_start, const void* vals,
                                    void* out, int64_t n, int64_t d, int op,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const uint8_t*>(is_start);
  const auto* v = static_cast<const double*>(vals);
  auto* o = static_cast<double*>(out);
  const int64_t threads = n * d;
  if (threads == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (op == 0) segmented_fold<0><<<blocks, kThreads, 0, st>>>(s, v, o, n, d);
  else if (op == 1) segmented_fold<1><<<blocks, kThreads, 0, st>>>(s, v, o, n, d);
  else if (op == 2) segmented_fold<2><<<blocks, kThreads, 0, st>>>(s, v, o, n, d);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
