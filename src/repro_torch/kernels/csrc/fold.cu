// The ordered segmented fold: float64 sum / min / max over segments.
//
// Replaces the lax.scan fold inside src/repro/core/jaxplan.py::_combine (a
// traced scan, not a Pallas kernel): every equal-key segment of the replay
// is folded left to right, seeded with its first row, which is exactly the
// sequential contract of repro.core.messages.Combiner (ufunc.at for SUM,
// np.minimum / np.maximum for MIN / MAX).  The result must be bit-identical
// to the numpy executors, so the sum may not be reordered: no tree, no
// atomics.  Row r of out holds the fold of its segment's rows up to r; a
// segment starts at every is_start row and at row 0.
//
// What bounds it on an H100: the bytes (one read of vals and is_start, one
// write of out) when segments are short; when one segment is long (a hot
// Zipf key: 263,532 rows in the shuffle's global stage) the chain of its
// dependent adds, one a row (about 8.4 cycles each), which no schedule may
// shorten.
//
// Design: persistent blocks of one producer warp and kConsumerWarps
// consumer warps take tiles of rows in row order from an atomic counter.
// - The producer reads the tile's is_start bytes (16-byte vectors one tile
//   ahead where it can), ballots them into 32 words of start bits and skips
//   a tile where no segment starts (its rows belong to a segment that an
//   earlier tile's block owns).  Otherwise it hands the consumers a stage
//   of a ring in shared memory: the list of the tile's starts, and its vals
//   from the first start on, copied by one 1-D bulk copy (cp.async.bulk;
//   the 16-byte-aligned body) and cp.async for an 8-byte head or tail, all
//   completing on the stage's mbarrier.
// - The consumers fold the (segment, column) pairs of the stage in place
//   in shared memory, each thread walking one pair in row order; the tile's
//   last segment, columns on threads 0..d-1, keeps its accumulators in
//   registers.  If it ends within kCarryRows of the next tile, those rows
//   come in the same stage.
// - If it runs on further, the same producer streams the next tiles' rows
//   up to their first start into the ring ahead of the adds (stages of kind
//   kCont), and threads 0..d-1 walk on through them: a long segment costs a
//   dependent op and a shared-memory read and store a row, never a DRAM
//   round trip.  While it walks, the block takes no new tile.
// - The producer stores each folded stage to out by bulk copies from shared
//   memory as soon as the consumers release it, and refills the stage once
//   those copies have read it.  Each row of vals is read once and each row
//   of out written once, by the block that folds it.
// A width above kConsumers is cut into column chunks of kConsumers (the
// counter's items are (row tile, chunk) pairs; a chunk's rows are copied
// one bulk copy a row).  The last block to finish resets the counter, so a
// call is one launch with no memset.
//
// MIN / MAX follow numpy, not CUDA's fmin / fmax (which drop NaN): a NaN in
// either operand propagates, and on a tie (0.0 against -0.0) the later row
// wins, as np.minimum / np.maximum give it.
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

constexpr int kTileElems = 4096;  // doubles a stage holds: 32 KB
constexpr int kStages = 2;
constexpr int kBlocksPerSm = 2;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;  // also the widest chunk
constexpr int kThreads = 32 + kConsumers;
constexpr int kMaxRows = 1024;                   // 32 words of start bits
constexpr int kBatch = 16;                       // rows read ahead of adds
constexpr int kFastPitch = 8;   // the shuffle's row width: its own walk code
// a tile's last segment that ends within kCarryRows of the next tile is
// folded in the tile's own stage (rows at most kFastPitch wide)
constexpr int kCarryRows = 64;
// a stage's values: the tile, the 8-byte shift, those rows, and 2 kBatch
// rows of padding that a walk may read (not use) past its last row
constexpr int kStageVals =
    kTileElems + 2 + (kCarryRows + 2 * kBatch) * kFastPitch;
constexpr int kStartsBytes = ((kMaxRows + 1) * 2 + 15) / 16 * 16;
constexpr int kStageBytes = kStageVals * 8 + kStartsBytes;
static_assert(kTileElems % 2 == 0 && kTileElems >= kConsumers + 1,
              "a stage holds at least one row of the widest chunk");

enum Kind : int { kEnd = 0, kOwned = 1, kCont = 2 };

struct Args {
  const uint8_t* is_start;
  const double* vals;
  double* out;
  unsigned long long* counter;  // [0] tickets taken, [1] blocks finished
  int64_t n, d;
  int64_t row_tiles, items;
  int rows, dc, pitch, nchunks;
};

struct Meta {
  int64_t item;
  int kind;
  int count;   // kOwned: the segments that start in the tile
  int valid;   // kOwned: where the tile's last segment ends (past the tile
               // when it ends within kCarryRows of the next one)
  int shift;   // 0 or 1: the stage's first element sits 8 bytes in
  int ra, rb;  // the rows the stage holds and the block folds
};

__host__ __device__ __forceinline__ int64_t lmin(int64_t x, int64_t y) {
  return x < y ? x : y;
}

template <int OP>
__device__ __forceinline__ double fold(double acc, double v) {
  if (OP == 0) return __dadd_rn(acc, v);
  if (OP == 1) return ((acc < v) | isnan(acc)) ? acc : v;
  return ((acc > v) | isnan(acc)) ? acc : v;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Folds rows [ra, rb) of one column onto acc in shared memory, in place:
// each element becomes the running value.  p0: the column's element of row
// 0, rows `pitch` apart (PITCH, when it is not 0).  What bounds a long walk
// is the chain of dependent adds (about 8 cycles each) and the shared-memory
// pipe (a load and a store a row), so the adds must not wait on either:
// - rows are read kBatch at a time into one of two register sets, a batch
//   ahead of their adds (with a compile-time PITCH the reads run past the
//   last row into the stage's padding; otherwise they are clamped to it);
// - each running value is stored two rows late, so that a store never
//   waits on the add just issued (the first two go to the first row, which
//   the third overwrites).
template <int OP, int PITCH>
__device__ __forceinline__ double walk(double acc, double* p0, int pitch_rt,
                                       int ra, int rb) {
  const int pitch = PITCH ? PITCH : pitch_rt;
  const int n = rb - ra;
  if (n <= 0) return acc;
  double* p = p0 + ra * pitch;
  auto row = [&](int i) { return p[(PITCH ? i : min(i, n - 1)) * pitch]; };
  double x[kBatch], y[kBatch];
  double s1 = acc, s2 = acc;  // the running values of the last two rows
  int r = 0;
  auto step = [&](double v, int u) {
    acc = fold<OP>(acc, v);
    p[max(r + u - 2, 0) * pitch] = s2;
    s2 = s1;
    s1 = acc;
  };
#pragma unroll
  for (int u = 0; u < kBatch; ++u) x[u] = row(u);
  while (true) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) y[u] = row(r + kBatch + u);
    if (r + kBatch > n) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (r + u < n) step(x[u], u);
      break;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) step(x[u], u);
    r += kBatch;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) x[u] = row(r + kBatch + u);
    if (r + kBatch > n) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (r + u < n) step(y[u], u);
      break;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) step(y[u], u);
    r += kBatch;
  }
  if (n >= 2) p[(n - 2) * pitch] = s2;
  p[(n - 1) * pitch] = s1;
  return acc;
}

// The consumers' work on one stage: the (segment, column) pairs that start
// in an owned tile, or the rows of a later tile that the last one runs on
// into (threads 0..d-1 keep its accumulators in `carry`).
template <int OP, int PITCH>
__device__ __forceinline__ void consume(const Meta& m, const uint16_t* st,
                                        double* sv, int pitch, int ct,
                                        int dcur, double& carry) {
  if (m.kind == kCont) {
    if (ct < dcur) carry = walk<OP, PITCH>(carry, sv + ct, pitch, 0, m.rb);
    return;
  }
  const int k = m.count;
  if (ct < dcur) {
    const int r = st[k - 1];
    carry = walk<OP, PITCH>(sv[r * pitch + ct], sv + ct, pitch, r + 1,
                            m.valid);
  }
  const int pairs = (k - 1) * dcur;
  for (int p = (ct + kConsumers - dcur) % kConsumers; p < pairs;
       p += kConsumers) {
    const int i = p / dcur, c = p - i * dcur;
    walk<OP, PITCH>(sv[st[i] * pitch + c], sv + c, pitch, st[i] + 1,
                    st[i + 1]);
  }
}

// The producer warp's read of a tile's is_start: lane w gets the start bits
// of rows 32 w .. 32 w + 31 (row 0 of the array always starts a segment);
// returns the number of starts, and the first in `first` (valid if none).
__device__ __forceinline__ int scan_starts(const Args& a, int64_t row0,
                                           int valid, int lane,
                                           uint32_t& mine, int& first) {
  uint8_t b[32];
#pragma unroll
  for (int w = 0; w < 32; ++w) {
    const int r = 32 * w + lane;
    b[w] = r < valid ? a.is_start[row0 + r] : 0;
  }
  mine = 0;
#pragma unroll
  for (int w = 0; w < 32; ++w) {
    const int r = 32 * w + lane;
    const uint32_t m =
        __ballot_sync(~0u, r < valid && (b[w] != 0 || row0 + r == 0));
    if (lane == w) mine = m;
  }
  first = static_cast<int>(__reduce_min_sync(
      ~0u, mine ? static_cast<unsigned>(32 * lane + __ffs(mine) - 1)
                : static_cast<unsigned>(valid)));
  return static_cast<int>(__reduce_add_sync(~0u, __popc(mine)));
}

// A full tile of 512 or 1,024 rows whose is_start bytes sit on a 16-byte
// boundary is read as 16-byte vectors, lane l holding rows [l B, l B + B),
// B = rows / 32: one load or two a lane, issued a tile ahead of its scan.
struct Flags {
  uint4 q0, q1;
};

__device__ __forceinline__ bool vector_flags(const Args& a, int64_t rt) {
  if (rt >= a.row_tiles || (a.rows != 512 && a.rows != 1024)) return false;
  const int64_t row0 = rt * a.rows;
  return row0 + a.rows <= a.n &&
         (reinterpret_cast<uintptr_t>(a.is_start + row0) & 15) == 0;
}

__device__ __forceinline__ Flags load_flags(const Args& a, int64_t rt,
                                            int lane) {
  const int b = a.rows / 32;
  const uint4* q = reinterpret_cast<const uint4*>(a.is_start + rt * a.rows +
                                                  lane * b);
  Flags f;
  f.q0 = __ldg(q);
  f.q1 = b == 32 ? __ldg(q + 1) : make_uint4(0, 0, 0, 0);
  return f;
}

// 4 flag bytes -> 4 bits (a byte that is not 0 is a start)
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((__vcmpne4(x, 0) & 0x01010101u) * 0x10204080u) >> 28;
}
__device__ __forceinline__ uint32_t bits16(uint4 q) {
  return nibble(q.x) | nibble(q.y) << 4 | nibble(q.z) << 8 |
         nibble(q.w) << 12;
}

// scan_starts for flags read by load_flags
__device__ __forceinline__ int scan_flags(const Args& a, int64_t row0,
                                          const Flags& f, int lane,
                                          uint32_t& mine, int& first) {
  if (a.rows == 1024) {
    mine = bits16(f.q0) | bits16(f.q1) << 16;
  } else {  // lanes 2w and 2w + 1 hold word w
    const uint32_t h = bits16(f.q0);
    const uint32_t lo = __shfl_sync(~0u, h, (2 * lane) & 31);
    const uint32_t hi = __shfl_sync(~0u, h, (2 * lane + 1) & 31);
    mine = lane < 16 ? lo | hi << 16 : 0u;
  }
  if (row0 == 0 && lane == 0) mine |= 1u;
  first = static_cast<int>(__reduce_min_sync(
      ~0u, mine ? static_cast<unsigned>(32 * lane + __ffs(mine) - 1)
                : static_cast<unsigned>(a.rows)));
  return static_cast<int>(__reduce_add_sync(~0u, __popc(mine)));
}

// Calls f(e, i, len) for the contiguous runs of rows [ra, rb) of an item:
// elements [e, e + len) of vals / out sit at [i, i + len) of the stage.
// Whole rows are one run (lane 0); a column chunk is a run a row, the rows
// spread over the lanes.
template <class F>
__device__ __forceinline__ void for_runs(const Args& a, const Meta& m,
                                         int lane, F f) {
  const int64_t rt = m.item / a.nchunks, c0 = (m.item % a.nchunks) * a.dc;
  const int64_t e0 = rt * a.rows * a.d + c0;
  if (a.nchunks == 1) {
    if (lane == 0 && m.rb > m.ra)
      f(e0 + m.ra * a.d, m.shift + m.ra * a.pitch,
        static_cast<int64_t>(m.rb - m.ra) * a.d);
  } else {
    const int64_t len = lmin(a.dc, a.d - c0);
    for (int r = m.ra + lane; r < m.rb; r += 32)
      f(e0 + r * a.d, m.shift + r * a.pitch, len);
  }
}

// A run's 16-byte-aligned body [head, head + body) goes by one bulk copy,
// an 8-byte head or tail element by itself.
struct Run {
  int head;
  int64_t body;
  bool tail;
};
__device__ __forceinline__ Run split(const double* g, int64_t len) {
  const int head = (reinterpret_cast<uintptr_t>(g) & 15) && len > 0 ? 1 : 0;
  const int64_t body = (len - head) & ~int64_t{1};
  return Run{head, body, head + body < len};
}

__device__ __forceinline__ void load_run(const double* g, double* sh,
                                         int64_t len, uint64_t* bar) {
  const Run r = split(g, len);
  if (r.head) cp_async8(sh, g);
  if (r.body > 0)
    bulk_load(sh + r.head, g + r.head, static_cast<uint32_t>(r.body * 8), bar);
  if (r.tail) cp_async8(sh + r.head + r.body, g + r.head + r.body);
}

__device__ __forceinline__ void store_run(double* g, const double* sh,
                                          int64_t len) {
  const Run r = split(g, len);
  if (r.head) g[0] = sh[0];
  if (r.body > 0)
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            reinterpret_cast<uint64_t>(g + r.head)),
        "r"(smem_u32(sh + r.head)), "r"(static_cast<uint32_t>(r.body * 8))
        : "memory");
  if (r.tail) g[r.head + r.body] = sh[r.head + r.body];
}

template <int OP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    segmented_fold(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ Meta meta[kStages];
  auto stage_vals = [&](int s) {
    return reinterpret_cast<double*>(smem + s * kStageBytes);
  };
  auto stage_starts = [&](int s) {
    return reinterpret_cast<uint16_t*>(smem + s * kStageBytes +
                                       kStageVals * 8);
  };
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
    // A stage is filled, folded in place by the consumers, then stored by
    // bulk copies from shared memory: as soon as the consumers release it
    // (looked at between the producer's other steps), or at the latest
    // when the stage is next filled, which waits until those copies have
    // read it.  Uses [stored, uses) hold values not yet stored.
    int64_t uses = 0, stored = 0;
    auto store = [&]() {
      const int s = static_cast<int>(stored % kStages);
      const Meta m = meta[s];
      double* sv = stage_vals(s);
      for_runs(a, m, lane, [&](int64_t e, int i, int64_t len) {
        store_run(a.out + e, sv + i, len);
      });
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      ++stored;
    };
    auto released = [&](int64_t j) {  // have the consumers done with use j?
      uint32_t done;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(&empty[j % kStages])),
            "r"(static_cast<uint32_t>((j / kStages) & 1))
          : "memory");
      return done != 0;
    };
    auto store_released = [&]() {
      while (stored < uses && released(stored)) store();
    };
    // hands the consumers one stage: rows [ra, rb) of item `item`
    auto emit = [&](int kind, int64_t item, int count, int valid,
                    uint32_t mine, int ra, int rb) {
      const int s = static_cast<int>(uses % kStages);
      if (uses >= kStages) {
        const int64_t j = uses - kStages;  // the use the stage last held
        while (stored <= j) {
          mbar_wait(&empty[stored % kStages],
                    static_cast<uint32_t>((stored / kStages) & 1));
          store();
        }
        // the copies of use j have read the stage; later ones may still run
        switch (stored - 1 - j) {
          case 0: asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); break;
          case 1: asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory"); break;
          default: asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory");
        }
        __syncwarp();
      }
      ++uses;
      Meta m{item, kind, count, valid, 0, ra, rb};
      if (kind != kEnd) {
        const int64_t rt = item / a.nchunks;
        const int64_t c0 = (item % a.nchunks) * a.dc;
        m.shift = static_cast<int>(
            (reinterpret_cast<uintptr_t>(a.vals + rt * a.rows * a.d + c0)
             >> 3) & 1);
      }
      if (lane == 0) meta[s] = m;
      if (kind == kOwned) {  // the start list, in row order, then valid
        uint16_t* st = stage_starts(s);
        int pos = __popc(mine);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(~0u, pos, o);
          if (lane >= o) pos += y;
        }
        pos -= __popc(mine);
        for (uint32_t b = mine; b; b &= b - 1)
          st[pos++] = static_cast<uint16_t>(32 * lane + __ffs(b) - 1);
        if (lane == 0) st[count] = static_cast<uint16_t>(valid);
      }
      // element (row, j) of the item sits at shift + row * pitch + j: every
      // element's address modulo 16 is its source's (and its target's)
      double* sv = stage_vals(s);
      uint32_t bytes = 0;
      if (kind != kEnd)
        for_runs(a, m, lane, [&](int64_t e, int, int64_t len) {
          bytes += static_cast<uint32_t>(split(a.vals + e, len).body * 8);
        });
      mbar_arrive_expect_tx(&full[s], bytes);
      if (kind != kEnd)
        for_runs(a, m, lane, [&](int64_t e, int i, int64_t len) {
          load_run(a.vals + e, sv + i, len, &full[s]);
        });
      cp_async_arrive(&full[s]);
    };
    // a tile's starts: from flags read a tile ahead where it can, else now
    auto scan = [&](int64_t rt, bool have, const Flags& f, uint32_t& mine,
                    int& first) {
      const int64_t row0 = rt * a.rows;
      if (have) return scan_flags(a, row0, f, lane, mine, first);
      return scan_starts(a, row0, static_cast<int>(lmin(a.rows, a.n - row0)),
                         lane, mine, first);
    };

    while (true) {
      unsigned long long t = 0;
      if (lane == 0) t = atomicAdd(a.counter, 1ull);
      t = __shfl_sync(~0u, t, 0);
      if (static_cast<int64_t>(t) >= a.items) break;
      const int64_t item = static_cast<int64_t>(t);
      const int64_t rt = item / a.nchunks, ch = item % a.nchunks;
      bool have = vector_flags(a, rt + 1);
      Flags next = have ? load_flags(a, rt + 1, lane) : Flags{};
      const int valid = static_cast<int>(lmin(a.rows, a.n - rt * a.rows));
      uint32_t mine;
      int first;
      const int count = scan(rt, false, next, mine, first);
      if (count == 0) continue;  // an earlier tile's block folds these rows
      // the tile's last segment runs on to the first start of a later tile
      int64_t u = rt + 1;
      int ufirst = 0, uvalid = 0;
      auto scan_next = [&]() {  // tile u, from flags read a tile ahead
        const bool had = have;
        const Flags cur = next;
        have = vector_flags(a, u + 1);
        if (have) next = load_flags(a, u + 1, lane);
        uvalid = static_cast<int>(lmin(a.rows, a.n - u * a.rows));
        uint32_t umine;
        scan(u, had, cur, umine, ufirst);
      };
      if (u < a.row_tiles) scan_next();
      // one that ends early in the next tile is folded in this stage
      const bool brief = ufirst > 0 && ufirst < uvalid &&
                         ufirst <= kCarryRows && a.nchunks == 1 &&
                         a.pitch <= kFastPitch;
      const int end = valid + (brief ? ufirst : 0);
      emit(kOwned, item, count, end, mine, first, end);
      store_released();
      if (brief) continue;
      // a longer one is walked on through stages of the later tiles' rows
      while (u < a.row_tiles && ufirst > 0) {
        emit(kCont, u * a.nchunks + ch, 0, 0, 0u, 0, ufirst);
        store_released();
        if (ufirst < uvalid || ++u >= a.row_tiles) break;
        scan_next();
      }
    }
    emit(kEnd, 0, 0, 0, 0u, 0, 0);
    // store what the last stages hold, then let every store land
    while (stored < uses - 1) {
      mbar_wait(&empty[stored % kStages],
                static_cast<uint32_t>((stored / kStages) & 1));
      store();
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else {
    // ---- consumers ----------------------------------------------------
    const int ct = threadIdx.x - 32;
    double carry = 0.0;  // column ct of the last segment, while it runs on
    for (int64_t uses = 0;; ++uses) {
      const int s = static_cast<int>(uses % kStages);
      mbar_wait(&full[s], static_cast<uint32_t>((uses / kStages) & 1));
      const Meta m = meta[s];
      if (m.kind == kEnd) break;
      const int64_t c0 = (m.item % a.nchunks) * a.dc;
      const int dcur = static_cast<int>(lmin(a.dc, a.d - c0));
      double* sv = stage_vals(s) + m.shift;
      const uint16_t* st = stage_starts(s);
      if (a.pitch == kFastPitch)  // the walk's offsets are immediates
        consume<OP, kFastPitch>(m, st, sv, kFastPitch, ct, dcur, carry);
      else
        consume<OP, 0>(m, st, sv, a.pitch, ct, dcur, carry);
      // the producer's bulk store reads what the generic stores wrote
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

template <int OP>
int launch(const Args& a, unsigned grid, cudaStream_t st) {
  constexpr size_t smem = static_cast<size_t>(kStages) * kStageBytes;
  static bool ready = false;  // per instantiation: allow > 48 KB once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        segmented_fold<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  segmented_fold<OP><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 = sum, 1 = min, 2 = max.  is_start is a bool [n] (one byte each);
// counter two zeroed uint64 on the device, left zeroed by every launch and
// used by one stream only (launches that overlap may not share it);
// sms the device's multiprocessor count.
extern "C" int teshu_segmented_fold(const void* is_start, const void* vals,
                                    void* out, void* counter, int64_t n,
                                    int64_t d, int op, int sms,
                                    void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  // out must sit at vals' address modulo 16: the stage's layout serves both
  if (op < 0 || op > 2 || counter == nullptr || sms <= 0 ||
      ((reinterpret_cast<uintptr_t>(vals) ^ reinterpret_cast<uintptr_t>(out))
       & 15) != 0 || (reinterpret_cast<uintptr_t>(vals) & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.is_start = static_cast<const uint8_t*>(is_start);
  a.vals = static_cast<const double*>(vals);
  a.out = static_cast<double*>(out);
  a.counter = static_cast<unsigned long long*>(counter);
  a.n = n;
  a.d = d;
  a.dc = static_cast<int>(d < kConsumers ? d : kConsumers);
  // a row pitch of the parity of d keeps shared and global addresses equal
  // modulo 16 on every row
  a.pitch = a.dc + static_cast<int>((a.dc ^ d) & 1);
  int rows = kTileElems / a.pitch;
  rows = rows < kMaxRows ? rows : kMaxRows;
  if (rows >= 32) rows -= rows % 32;
  a.rows = rows;
  a.nchunks = static_cast<int>((d + a.dc - 1) / a.dc);
  a.row_tiles = (n + rows - 1) / rows;
  a.items = a.row_tiles * a.nchunks;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(a.items < most ? a.items : most);
  auto st = static_cast<cudaStream_t>(stream);
  if (op == 0) return launch<0>(a, grid, st);
  if (op == 1) return launch<1>(a, grid, st);
  return launch<2>(a, grid, st);
}
