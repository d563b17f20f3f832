// Banded block substitution through the band LU factors, on a thread
// block cluster.
//
// Replaces the two Pallas TPU kernels of the reference package,
// lsafw_tpu/solver/band_pallas.py, and the XLA scans of its pivoted
// factors, lsafw_tpu/solver/band.py _solve_pivoted_real (:839) and
// _solve_pivoted (:1035):
//   band_fwd_kernel (K1), forward substitution:
//     pivot-free  <- _fwd_kernel / fwd_substitute_pallas
//       y_K = b_K - sum_{t<B} L[K,t] y_{K-B+t}, K ascending over rows_total;
//     pivoted     <- the forward half of _solve_pivoted[_real]
//       f = w[perm_K], y_K = L1inv_K f[:nb], w' = f[nb:] - L2_K y_K, and
//       the next right-hand-side block shifts in behind w'.
//   band_bwd_kernel (K2), backward substitution with the inverse diagonal:
//     pivot-free  <- _bwd_kernel / bwd_substitute_pallas
//       x_K = Dinv_K (y_K - sum_{t<B} U[K,B+1+t] x_{K+1+t}), K descending;
//     pivoted     <- the backward half of _solve_pivoted[_real]
//       x_K = Uinv_K (y_K - sum_{j=1..2B} U[K,j] x_{K+j}).
// One kernel serves both backward modes: S folded upper slots from slot
// s0 (B from B+1 pivot-free, 2B from 1 pivoted).
//
// Types: complex64 with one right-hand-side column (C64), and float32
// with m = 1 or 2 columns (R32x1, R32x2: a complex right-hand side on a
// real factor travels as two real columns).  A pivot-free band may be
// stored in bf16 (C64bf, R32x1bf, R32x2bf: the reference's at-rest band
// over its memory budget): its tiles land in shared memory as bf16 and
// are widened to float32 in the row dots; Dinv stays float32 /
// complex64, and a pivoted factor is never bf16.  Layouts are the
// factors' own, folded (see Design): the band is (rows_total, 2B+1, nb,
// nb), row-major, slot r of block row K holding block (K, K + r - B)
// pivot-free and block (K, K + r) pivoted (U rows), a bf16 complex entry
// being its (re, im) pair; L2 is (nblk, B, nb, nb), L1inv/Uinv/Dinv
// (nblk, nb, nb), perms (nblk, (B+1) nb) int64; vectors are (rows, nb, m)
// blocks.  The pivot-free lookahead rows past nblk take a zero
// right-hand side and Dinv = I.  One library is built per block size nb
// (BAND_NB, 128 or 256: the wrapper builds both, in parallel).
//
// Bound: every factor byte is read once per solve.  At the 43k cylinder
// shapes (B = 7, nb = 128, nblk = 384, complex64) the pivot-free K1 reads
// 359 MB of L, K2 as much of U plus 51 MB of Dinv; the pivoted forward
// reads L2 (352 MB) and L1inv (50 MB), the pivoted backward 2B U slots
// (705 MB) and Uinv (50 MB).  At 3.35 TB/s one pivot-free solve is
// bounded at about 0.23 ms and one pivoted solve at 0.35 ms; the float32
// factors at about half, and a bf16 band halves the band's bytes again.
// Two flops per byte (four per bf16 byte): bytes bound every mode.
//
// Design.  The recursion is serial in the block row K, but only a small
// carry window depends on the solution: all factor data is known before
// the solve starts.  Run in one thread block, the recursion streams each
// step's ~1 MB of band rows through one SM (about 28 GB/s on an H100:
// 0.8% of the bound).  Here one thread block cluster (16 blocks where the
// card can co-schedule them, else 8, ...) runs the whole recursion, one
// block per SM:
//   * each block owns a slice of every step's output rows (nb / C rows of
//     a block, B nb / C rows of the pivoted window update) and reads only
//     its slice of the factor rows, so a step's bytes spread over C SMs;
//   * the factor rows never wait on the recursion: a block's slices form
//     one stream of equal tiles (nb / C rows of one slot, of Dinv, L1inv
//     or of L2), which one producer thread copies with bulk asynchronous copies
//     (cp.async.bulk, completing on one mbarrier per tile) into a ring of
//     tiles that fills the block's shared memory, as far ahead of the
//     recursion as the ring holds (about three steps pivot-free at the
//     43k shapes).  The producer warp takes part in no barrier but the
//     cluster's: it refills after each step's barrier, while the other
//     warps go on.  The per-step right-hand-side, y and permutation slices
//     ride a second, double-buffered stream one step ahead;
//   * every block keeps a full copy of the carry window in its own shared
//     memory; a block writes its slice of new values into every block's
//     copy through distributed shared memory (map_shared_rank), and one
//     cluster barrier (release/acquire) per step publishes them.  The
//     window is a ring (pivot-free K1, both backward modes: step K writes
//     the one slot no block reads in step K) or double-buffered (pivoted
//     forward, whose window is rewritten each step).
//   * the factors are stored folded (solver/band.py fold_pivoted,
//     fold_pivot_free): U blocks premultiplied by their row's Dinv / Uinv,
//     L2 postmultiplied by L1inv.  So no step needs a whole intermediate
//     block before its own product: x_K = Dinv_K y_K - sum (Dinv U) x,
//     w' = f[nb:] - (L2 L1inv) f[:nb], and y_K = L1inv f[:nb] leaves the
//     recursion.
// A step is then: row dots over tiles already in shared memory (each warp
// takes up to eight rows of one tile, a shuffle sum over the lanes of a
// row), one shared-memory reduction, the broadcast, one cluster barrier.
// On an H100 a step takes 3-4 us against 0.3 us of its bytes at the HBM
// rate (5-14% of the byte bound at the 43k shapes).  The largest part is
// the row dots themselves, over data already in shared memory; the
// cluster barrier and the reduction with its broadcast come next
// (band_step_probe.py times each part; PERF.md has the split).
//
// The cluster size is the largest the card co-schedules with the mode's
// shared memory, chosen on a kernel's first launch for a window size and
// kept for the later ones.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

#ifndef BAND_NB
#define BAND_NB 128
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kNb = BAND_NB;  // block size this library's kernels take
static_assert(kNb == 128 || kNb == 256, "band_subst.cu is built for nb = 128 or 256");
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32 - 1;   // warps that compute; the last one copies
constexpr int kProducer = kWarps * 32;      // the thread that issues the copies
constexpr int kMaxTiles = 64;
constexpr int kMaxCluster = 16;  // blocks in the largest cluster tried (past 8: non-portable)
constexpr size_t kSmemMax = 232448;  // shared memory one H100 block may use

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float vsub(float a, float b) { return a - b; }
__device__ __forceinline__ float2 vsub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float shfl_xor(float v, int o) { return __shfl_xor_sync(0xffffffffu, v, o); }
__device__ __forceinline__ float2 shfl_xor(float2 v, int o) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, o), __shfl_xor_sync(0xffffffffu, v.y, o));
}

template <class V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = vadd(v, shfl_xor(v, off));
  return v;
}

// Mat: one stored factor entry; Vec: one right-hand-side entry (its m
// columns); Dense: the traits of the float32 tiles (Dinv) beside a band
// of these traits.  fma: acc += (the entries of one 16-byte load a, at
// 16-byte index p of a row) . (the matching entries of the shared-memory
// vector v).
struct C64 {
  using Mat = float2;
  using Vec = float2;
  using Dense = C64;
  static constexpr int kF4 = kNb / 2;  // 16-byte loads per factor row
  __device__ static Vec zero() { return make_float2(0.f, 0.f); }
  __device__ static void fma(const float4& a, const Vec* v, int p, Vec& acc) {
    const float4 x = reinterpret_cast<const float4*>(v)[p];
    acc.x += a.x * x.x - a.y * x.y + a.z * x.z - a.w * x.w;
    acc.y += a.x * x.y + a.y * x.x + a.z * x.w + a.w * x.z;
  }
};

struct R32x1 {
  using Mat = float;
  using Vec = float;
  using Dense = R32x1;
  static constexpr int kF4 = kNb / 4;
  __device__ static Vec zero() { return 0.f; }
  __device__ static void fma(const float4& a, const Vec* v, int p, Vec& acc) {
    const float4 x = reinterpret_cast<const float4*>(v)[p];
    acc += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
  }
};

struct R32x2 {
  using Mat = float;
  using Vec = float2;
  using Dense = R32x2;
  static constexpr int kF4 = kNb / 4;
  __device__ static Vec zero() { return make_float2(0.f, 0.f); }
  __device__ static void fma(const float4& a, const Vec* v, int p, Vec& acc) {
    const float4* w = reinterpret_cast<const float4*>(v);
    const float4 x0 = w[2 * p], x1 = w[2 * p + 1];  // entries 4p..4p+3, two columns each
    acc.x += a.x * x0.x + a.y * x0.z + a.z * x1.x + a.w * x1.z;
    acc.y += a.x * x0.y + a.y * x0.w + a.z * x1.y + a.w * x1.w;
  }
};

// The bf16 bands: a 16-byte load holds 4 complex or 8 real entries, two
// to a 32-bit word, the first in its low half; wide() widens them to
// float32 exactly (a bf16 value is the high half of a float32).
__device__ __forceinline__ float2 wide(float word) {
  const uint32_t u = __float_as_uint(word);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

struct C64bf {
  using Mat = uint32_t;  // one complex entry: bf16 (re, im)
  using Vec = float2;
  using Dense = C64;
  static constexpr int kF4 = kNb / 4;
  __device__ static Vec zero() { return make_float2(0.f, 0.f); }
  __device__ static void fma(const float4& a, const Vec* v, int p, Vec& acc) {
    const float4* w = reinterpret_cast<const float4*>(v);
    const float4 x0 = w[2 * p], x1 = w[2 * p + 1];  // entries 4p..4p+3
    const float2 e0 = wide(a.x), e1 = wide(a.y), e2 = wide(a.z), e3 = wide(a.w);
    acc.x += e0.x * x0.x - e0.y * x0.y + e1.x * x0.z - e1.y * x0.w +
             e2.x * x1.x - e2.y * x1.y + e3.x * x1.z - e3.y * x1.w;
    acc.y += e0.x * x0.y + e0.y * x0.x + e1.x * x0.w + e1.y * x0.z +
             e2.x * x1.y + e2.y * x1.x + e3.x * x1.w + e3.y * x1.z;
  }
};

struct R32x1bf {
  using Mat = uint16_t;  // bf16
  using Vec = float;
  using Dense = R32x1;
  static constexpr int kF4 = kNb / 8;
  __device__ static Vec zero() { return 0.f; }
  __device__ static void fma(const float4& a, const Vec* v, int p, Vec& acc) {
    const float4* w = reinterpret_cast<const float4*>(v);
    const float4 x0 = w[2 * p], x1 = w[2 * p + 1];  // entries 8p..8p+7
    const float2 e0 = wide(a.x), e1 = wide(a.y), e2 = wide(a.z), e3 = wide(a.w);
    acc += e0.x * x0.x + e0.y * x0.y + e1.x * x0.z + e1.y * x0.w +
           e2.x * x1.x + e2.y * x1.y + e3.x * x1.z + e3.y * x1.w;
  }
};

struct R32x2bf {
  using Mat = uint16_t;  // bf16
  using Vec = float2;
  using Dense = R32x2;
  static constexpr int kF4 = kNb / 8;
  __device__ static Vec zero() { return make_float2(0.f, 0.f); }
  __device__ static void fma(const float4& a, const Vec* v, int p, Vec& acc) {
    const float4* w = reinterpret_cast<const float4*>(v) + 4 * p;  // entries 8p..8p+7, two columns each
    const float2 e0 = wide(a.x), e1 = wide(a.y), e2 = wide(a.z), e3 = wide(a.w);
    const float4 x0 = w[0], x1 = w[1], x2 = w[2], x3 = w[3];
    acc.x += e0.x * x0.x + e0.y * x0.z + e1.x * x1.x + e1.y * x1.z +
             e2.x * x2.x + e2.y * x2.z + e3.x * x3.x + e3.y * x3.z;
    acc.y += e0.x * x0.y + e0.y * x0.w + e1.x * x1.y + e1.y * x1.w +
             e2.x * x2.y + e2.y * x2.w + e3.x * x3.y + e3.y * x3.w;
  }
};

// Rows a row-dot task takes, as a power of two: at least enough that each
// lane loads one 16-byte piece of its row, at most eight, and at most as
// many as keep a lane's loads within 16 registers of float4.
constexpr int lg2(int v) { return v <= 1 ? 0 : 1 + lg2(v / 2); }
template <class Tr>
struct Rpt {
  static constexpr int kMin = Tr::kF4 >= 32 ? 0 : lg2(32 / Tr::kF4);
  static constexpr int kMax = lg2(512 / Tr::kF4) < 3 ? lg2(512 / Tr::kF4) : 3;
};

// --- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// Arrive once and expect ``bytes`` of bulk copies (0: the phase completes).
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity ``parity`` to complete.  A copy that never
// lands traps (an error the launch reports) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{ .reg .pred p; mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 30)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One tile of the stream: where it is copied from, and its bytes (at most
// the ring's T: a bf16 band tile fills half of a slot sized for Dinv).
struct Tile {
  const void* src;
  uint32_t bytes;
};

// The ring of nt factor tile slots of T bytes; tile g of the stream sits in
// slot g % nt, its mbarrier completing for the (g / nt)-th time.
struct Ring {
  char* buf;
  uint32_t bars;   // shared address of nt mbarriers, one per slot
  uint32_t freed;  // mbarrier: the consumers are done with a group of tiles
  int nt;
  uint32_t T;
  __device__ const void* tile(int slot) const { return buf + (size_t)slot * T; }
  __device__ void wait(int slot, int fill) const { mbar_wait(bars + 8 * slot, fill & 1); }
  __device__ void issue(int slot, const Tile& t) const {  // the producer thread
    const uint32_t bar = bars + 8 * slot;
    mbar_expect(bar, t.bytes);
    bulk_copy(buf + (size_t)slot * T, t.src, t.bytes, bar);
  }
};

// A place in the tile stream: tile j of step K.
struct Walk {
  int K, j;
};

// The producer's walk over the tile stream, its next ring slot, and how
// many groups of tiles the consumers have freed so far.
struct Producer {
  Walk copy;
  int issued = 0, slot = 0, frees = 0;
  __device__ explicit Producer(Walk start) : copy(start) {}
  template <class SrcFn, class StepFn>
  __device__ void fill(const Ring& ring, int upto, SrcFn src, StepFn step) {
    for (; issued < upto; ++issued, step(copy)) {
      ring.issue(slot, src(copy));
      if (++slot == ring.nt) slot = 0;
    }
  }
};

// The threads that compute (every warp but the producer's) meet here.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWarps * 32) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// The end of a step: a cluster barrier (release/acquire) publishes the
// blocks' writes into each other's windows.  After it every consumer of
// the step's tiles is done with them, and the producer refills their
// slots; no consumer waits for the producer, which takes part in no other
// barrier.
template <class RefillFn>
__device__ __forceinline__ void publish(RefillFn refill, int consumed) {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  if (threadIdx.x == kProducer) refill(consumed);
}

// Row dots over tiles in shared memory.  Task q takes kRpt consecutive
// rows of one tile, rows_of(q) + r kNb for r < kRpt, each dotted with the
// shared-memory vector vec_of(q); row r's result goes to part[out_of(q, r)].
// Warp w takes tasks w, w + kWarps, ...: 32 / kRpt lanes per row, each
// lane loading its 16-byte pieces of the row before the products, then a
// shuffle sum over the row's lanes.  Lane 0 waits for the task's tile
// (ready(q)) for the whole warp.  Only the kRpt of Rpt<Tr>'s range are
// compiled (tile_dots takes no other).
template <class Tr, int kRpt, class ReadyFn, class RowFn, class VecFn, class OutFn>
__device__ __forceinline__ void row_dots(int ntasks, ReadyFn ready, RowFn rows_of, VecFn vec_of,
                                         OutFn out_of, typename Tr::Vec* part) {
  if constexpr (kRpt >= (1 << Rpt<Tr>::kMin) && kRpt <= (1 << Rpt<Tr>::kMax)) {
    using Vec = typename Tr::Vec;
    constexpr int kLpr = 32 / kRpt;          // lanes per row
    constexpr int kLoads = Tr::kF4 / kLpr;   // 16-byte loads per lane
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (warp >= kWarps) return;
    const int r = lane / kLpr, seg = lane % kLpr;
    for (int q = warp; q < ntasks; q += kWarps) {
      if (lane == 0) ready(q);
      __syncwarp();
      const float4* row = reinterpret_cast<const float4*>(rows_of(q) + r * kNb);
      float4 a[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) a[k] = row[seg + kLpr * k];
      const Vec* v = vec_of(q);
      Vec acc = Tr::zero();
#pragma unroll
      for (int k = 0; k < kLoads; ++k) Tr::fma(a[k], v, seg + kLpr * k, acc);
#pragma unroll
      for (int off = kLpr / 2; off > 0; off >>= 1) acc = vadd(acc, shfl_xor(acc, off));
      if (seg == 0) part[out_of(q, r)] = acc;
    }
  }
}

// The row dots of n consecutive tiles of the stream, from tile g0: row i of
// tile j goes to part[out_of(j, i)] with vector vec_of(j); a tile holds
// 2^lg_rc rows.  Tiles are taken nt at a time, in tasks of the fewest rows
// that still give each warp as few rounds as it can get; between groups
// the consumers free the group (``freed``) and the producer, once it sees
// that, refills its slots (midrefill(consumed) issues tiles up to
// consumed + nt; after the last group ``publish`` refills, unless ``more``
// tiles of the step follow in another call, which frees this group too).
template <class Tr, class VecFn, class OutFn, class RefillFn>
__device__ __forceinline__ void tile_dots(const Ring& ring, int g0, int n, int lg_rc, VecFn vec_of,
                                          OutFn out_of, RefillFn midrefill,
                                          typename Tr::Vec* part, bool more = false) {
  using Mat = typename Tr::Mat;
  for (int c0 = 0; c0 < n; c0 += ring.nt) {
    const int nc = min(ring.nt, n - c0);
    const int slot0 = (g0 + c0) % ring.nt, fill0 = (g0 + c0) / ring.nt;
    const int rows = nc << lg_rc;
    const int rounds = (rows + 8 * kWarps - 1) / (8 * kWarps);  // at 8 rows a task
    int lg_rpt = Rpt<Tr>::kMin;
    while (lg_rpt < Rpt<Tr>::kMax && lg_rpt < lg_rc &&
           ((rows >> lg_rpt) + kWarps - 1) / kWarps > rounds)
      ++lg_rpt;
    const int lg_tpt = lg_rc - lg_rpt;  // tasks per tile, as a power of two
    auto ready = [&](int q) {
      const int j = q >> lg_tpt;
      ring.wait(slot0 + j < ring.nt ? slot0 + j : slot0 + j - ring.nt,
                slot0 + j < ring.nt ? fill0 : fill0 + 1);
    };
    auto rows_of = [&](int q) {
      const int j = q >> lg_tpt, s = slot0 + j < ring.nt ? slot0 + j : slot0 + j - ring.nt;
      return static_cast<const Mat*>(ring.tile(s)) + ((q & ((1 << lg_tpt) - 1)) << lg_rpt) * kNb;
    };
    auto vec = [&](int q) { return vec_of(c0 + (q >> lg_tpt)); };
    auto out = [&](int q, int r) {
      return out_of(c0 + (q >> lg_tpt), ((q & ((1 << lg_tpt) - 1)) << lg_rpt) + r);
    };
    const int ntasks = rows >> lg_rpt;
    switch (lg_rpt) {
      case 0: row_dots<Tr, 1>(ntasks, ready, rows_of, vec, out, part); break;
      case 1: row_dots<Tr, 2>(ntasks, ready, rows_of, vec, out, part); break;
      case 2: row_dots<Tr, 4>(ntasks, ready, rows_of, vec, out, part); break;
      default: row_dots<Tr, 8>(ntasks, ready, rows_of, vec, out, part); break;
    }
    if (threadIdx.x < kWarps * 32) consumer_sync();
    if (c0 + nc < n || more) {
      if (threadIdx.x == 0) mbar_arrive(ring.freed);
      if (threadIdx.x == kProducer) midrefill(g0 + c0 + nc);
    }
  }
}

// One lane of each computing warp waits on a side buffer's mbarrier for
// its warp.
__device__ __forceinline__ void warp_wait(uint32_t bar, int parity) {
  if (threadIdx.x >= kWarps * 32) return;
  if ((threadIdx.x & 31) == 0) mbar_wait(bar, parity);
  __syncwarp();
}

// --- shared memory layout ----------------------------------------------------

struct FwdArgs {
  const void* band;      // pivot-free: (rows_total, 2B+1, nb, nb)
  const void* L2;        // pivoted: (nblk, B, nb, nb)
  const void* L1inv;     // pivoted: (nblk, nb, nb)
  const int64_t* perms;  // pivoted: (nblk, (B+1) nb)
  const void* b;         // (nblk, nb) blocks of Vec
  void* y;               // out: (rows_total, nb) pivot-free, (nblk, nb) pivoted
  int64_t rows_total;
  int64_t nblk;
  int B;
  int nt;  // tiles in the ring
};

struct BwdArgs {
  const void* band;  // (rows, 2B+1, nb, nb): the upper slots s0..s0+S-1
  const void* dinv;  // (nblk, nb, nb): Dinv pivot-free, Uinv pivoted
  const void* y;     // (nsteps, nb)
  void* x;           // out: (nblk, nb)
  int64_t nsteps;
  int64_t nblk;
  int R, s0, S;
  int nt;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~(size_t)127; }

// Offsets (bytes) of one block's shared memory: the mbarriers (nt tiles,
// two side buffers, freed), the tile ring, the two side buffers of per-step
// vector slices, then ``rest`` bytes of windows and partial sums.
struct Layout {
  size_t ring, side, rest, total;
  __host__ __device__ Layout(int nt, size_t tile, size_t side_bytes, size_t rest_bytes) {
    ring = align128(8 * (size_t)(nt + 3));
    side = ring + align128((size_t)nt * tile);
    rest = side + 2 * align128(side_bytes);
    total = rest + rest_bytes;
  }
};

// Per mode: the tile size, the side slice bytes per step and the window
// bytes, for a cluster of C blocks (host and device agree through these).
// A block's tile of one slot: nb / C rows of Tr's entries.  The ring's
// slots take the stream's largest tile: the band's in K1, Dinv's in K2.
template <class Tr>
__host__ __device__ inline size_t tile_bytes(int C) {
  return (size_t)(kNb / C) * kNb * sizeof(typename Tr::Mat);
}

template <class Tr>
__host__ __device__ inline void fwd_sizes(bool pivoted, int B, int C, size_t& side, size_t& rest) {
  const size_t v = sizeof(typename Tr::Vec);
  const int Rc = kNb / C, Rw = B * kNb / C;
  if (pivoted) {  // side: perm head, my perm tail, the fresh block; rest: 2 windows, f[:nb], part
    side = align128(kNb * 8) + align128((size_t)Rw * 8) + kNb * v;
    rest = v * (2 * (size_t)(B + 1) * kNb + kNb + (size_t)(Rc + Rw));
  } else {  // side: my b slice; rest: the window ring, part
    side = (size_t)Rc * v;
    rest = v * ((size_t)(B + 1) * kNb + (size_t)Rc * B);
  }
}

template <class Tr>
__host__ __device__ inline void bwd_sizes(int S, int C, size_t& side, size_t& rest) {
  const size_t v = sizeof(typename Tr::Vec);
  side = (size_t)kNb * v;  // y_K
  rest = v * ((size_t)(S + 1) * kNb + (size_t)(kNb / C) * (S + 1));  // the window ring, part
}

// The block's ring, side buffers and mbarriers; the producer thread, their
// only issuer, initialises the mbarriers.
struct Smem {
  Ring ring;
  char* side[2];
  uint32_t side_bar[2];
  char* rest;
  __device__ Smem(char* base, const Layout& L, int nt, uint32_t tile, size_t side_bytes) {
    const uint32_t bars = smem_addr(base);
    ring = Ring{base + L.ring, bars, bars + 8 * (nt + 2), nt, tile};
    side[0] = base + L.side;
    side[1] = base + L.side + align128(side_bytes);
    side_bar[0] = bars + 8 * nt;
    side_bar[1] = bars + 8 * (nt + 1);
    rest = base + L.rest;
    if (threadIdx.x == kProducer) {
      for (int i = 0; i < nt + 3; ++i) mbar_init(bars + 8 * i);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
};

// Pivot-free forward: the ring of B + 1 solution blocks; step K writes
// y_K into the slot of y_{K-B-1}.  Tile stream: slot t of row K is tile
// K B + t.
template <class Tr>
__device__ void fwd_pivot_free(const FwdArgs& a, char* base) {
  using Mat = typename Tr::Mat;
  using Vec = typename Tr::Vec;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int Rc = kNb / C, lg_rc = __ffs(Rc) - 1, r0 = rank * Rc, B = a.B, R = 2 * B + 1;
  const int ring = B + 1, rows = (int)a.rows_total, nblk = (int)a.nblk;
  const Mat* band = static_cast<const Mat*>(a.band);
  const Vec* b = static_cast<const Vec*>(a.b);
  Vec* y = static_cast<Vec*>(a.y);
  size_t side_bytes, rest_bytes;
  fwd_sizes<Tr>(false, B, C, side_bytes, rest_bytes);
  const Layout L(a.nt, tile_bytes<Tr>(C), side_bytes, rest_bytes);
  Smem sm(base, L, a.nt, tile_bytes<Tr>(C), side_bytes);
  Vec* win = reinterpret_cast<Vec*>(sm.rest);
  Vec* part = win + ring * kNb;
  const int ntiles = rows * B;
  const uint32_t T = (uint32_t)tile_bytes<Tr>(C);
  Producer prod(Walk{0, 0});
  auto src = [&](const Walk& w) {
    return Tile{band + (((int64_t)w.K * R + w.j) * kNb + r0) * kNb, T};
  };
  auto step = [&](Walk& w) {
    if (++w.j == B) w.j = 0, ++w.K;
  };
  auto refill = [&](int consumed) { prod.fill(sm.ring, min(ntiles, consumed + a.nt), src, step); };
  auto midrefill = [&](int consumed) {
    mbar_wait(sm.ring.freed, prod.frees++ & 1);
    refill(consumed);
  };
  auto side = [&](int K) {  // my slice of b_K into side buffer K % 2
    const uint32_t bar = sm.side_bar[K & 1];
    const uint32_t bytes = K < nblk ? Rc * sizeof(Vec) : 0;
    mbar_expect(bar, bytes);
    if (bytes) bulk_copy(sm.side[K & 1], b + (int64_t)K * kNb + r0, bytes, bar);
  };

  for (int e = threadIdx.x; e < ring * kNb; e += kThreads) win[e] = Tr::zero();
  if (threadIdx.x == kProducer) {
    refill(0);
    side(0);
  }
  cluster.sync();
  for (int K = 0; K < rows; ++K) {
    if (threadIdx.x == kProducer && K + 1 < rows) side(K + 1);
    const int base_slot = (K + 1) % ring;
    tile_dots<Tr>(
        sm.ring, K * B, B, lg_rc,
        [&](int t) {
          const int s = base_slot + t;
          return win + (s < ring ? s : s - ring) * kNb;
        },
        [&](int t, int i) { return i * B + t; }, midrefill, part);
    if (threadIdx.x < Rc * C) {
      const int i = threadIdx.x & (Rc - 1), dst = threadIdx.x >> lg_rc;
      Vec acc = Tr::zero();
      for (int t = 0; t < B; ++t) acc = vadd(acc, part[i * B + t]);
      warp_wait(sm.side_bar[K & 1], (K >> 1) & 1);
      const Vec bk = K < nblk ? reinterpret_cast<const Vec*>(sm.side[K & 1])[i] : Tr::zero();
      const Vec yk = vsub(bk, acc);
      if (dst == rank) y[(int64_t)K * kNb + r0 + i] = yk;
      *cluster.map_shared_rank(win + (K % ring) * kNb + r0 + i, dst) = yk;
    }
    publish(refill, (K + 1) * B);
  }
}

// Pivoted forward: the window of block rows K..K+B, double-buffered.
// Tile stream per step: my rows of L1inv_K, then my B tiles of (L2 L1inv)_K.
template <class Tr>
__device__ void fwd_pivoted(const FwdArgs& a, char* base) {
  using Mat = typename Tr::Mat;
  using Vec = typename Tr::Vec;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int B = a.B, W = (B + 1) * kNb, nblk = (int)a.nblk;
  const int Rc = kNb / C, lg_rc = __ffs(Rc) - 1, r0 = rank * Rc;  // my rows of y_K
  const int Rw = B * kNb / C, rw0 = rank * Rw;  // my rows of the window update
  const Mat* L2 = static_cast<const Mat*>(a.L2);
  const Mat* L1inv = static_cast<const Mat*>(a.L1inv);
  const Vec* b = static_cast<const Vec*>(a.b);
  Vec* y = static_cast<Vec*>(a.y);
  size_t side_bytes, rest_bytes;
  fwd_sizes<Tr>(true, B, C, side_bytes, rest_bytes);
  const Layout L(a.nt, tile_bytes<Tr>(C), side_bytes, rest_bytes);
  Smem sm(base, L, a.nt, tile_bytes<Tr>(C), side_bytes);
  Vec* wbuf[2] = {reinterpret_cast<Vec*>(sm.rest), reinterpret_cast<Vec*>(sm.rest) + W};
  Vec* ftop = wbuf[1] + W;  // the pivot rows f[:nb]
  Vec* part = ftop + kNb;    // my rows of y_K, then my rows of the window update
  const size_t tail_off = align128(kNb * 8), fresh_off = tail_off + align128((size_t)Rw * 8);
  const int per_step = B + 1;
  const int ntiles = nblk * per_step;
  const uint32_t T = (uint32_t)tile_bytes<Tr>(C);
  Producer prod(Walk{0, 0});
  auto src = [&](const Walk& w) {
    return Tile{w.j == 0 ? L1inv + ((int64_t)w.K * kNb + r0) * kNb
                         : L2 + ((int64_t)w.K * B * kNb + rw0 + (w.j - 1) * Rc) * kNb,
                T};
  };
  auto step = [&](Walk& w) {
    if (++w.j == per_step) w.j = 0, ++w.K;
  };
  auto refill = [&](int consumed) { prod.fill(sm.ring, min(ntiles, consumed + a.nt), src, step); };
  auto midrefill = [&](int consumed) {
    mbar_wait(sm.ring.freed, prod.frees++ & 1);
    refill(consumed);
  };
  auto side = [&](int K) {  // perm_K's head and my tail, and the block that shifts in
    char* s = sm.side[K & 1];
    const uint32_t bar = sm.side_bar[K & 1];
    const int fresh = K + B + 1;
    const uint32_t fresh_bytes = fresh < nblk ? kNb * sizeof(Vec) : 0;
    const int64_t* perm = a.perms + (int64_t)K * W;
    mbar_expect(bar, kNb * 8 + Rw * 8 + fresh_bytes);
    bulk_copy(s, perm, kNb * 8, bar);
    bulk_copy(s + tail_off, perm + kNb + rw0, Rw * 8, bar);
    if (fresh_bytes) bulk_copy(s + fresh_off, b + (int64_t)fresh * kNb, fresh_bytes, bar);
  };

  for (int e = threadIdx.x; e < W; e += kThreads)
    wbuf[0][e] = e / kNb < nblk ? b[e] : Tr::zero();
  if (threadIdx.x == kProducer) {
    refill(0);
    side(0);
  }
  cluster.sync();
  for (int K = 0; K < nblk; ++K) {
    if (threadIdx.x == kProducer && K + 1 < nblk) side(K + 1);
    const Vec* cw = wbuf[K & 1];
    Vec* nxt = wbuf[(K + 1) & 1];
    const char* s = sm.side[K & 1];
    const int64_t* head = reinterpret_cast<const int64_t*>(s);
    const int64_t* tail = reinterpret_cast<const int64_t*>(s + tail_off);
    const Vec* fresh = reinterpret_cast<const Vec*>(s + fresh_off);
    warp_wait(sm.side_bar[K & 1], (K >> 1) & 1);
    for (int j = threadIdx.x; j < kNb; j += kThreads) ftop[j] = cw[head[j]];
    if (threadIdx.x < kWarps * 32) consumer_sync();
    // my rows of y_K = L1inv_K f[:nb] (tile 0) and of the window update
    // w' = f[nb:] - (L2 L1inv)_K f[:nb] (tiles 1..B), all against f[:nb]
    const int g0 = K * per_step;
    tile_dots<Tr>(
        sm.ring, g0, per_step, lg_rc, [&](int) { return ftop; },
        [&](int j, int i) { return (j << lg_rc) + i; }, midrefill, part);
    if (threadIdx.x < Rc) y[(int64_t)K * kNb + r0 + threadIdx.x] = part[threadIdx.x];
    for (int e = threadIdx.x; e < Rw * C && threadIdx.x < kWarps * 32; e += kWarps * 32) {
      const int i = e % Rw, dst = e / Rw;
      *cluster.map_shared_rank(nxt + rw0 + i, dst) = vsub(cw[tail[i]], part[Rc + i]);
    }
    for (int j = threadIdx.x; j < kNb; j += kThreads)
      nxt[B * kNb + j] = K + B + 1 < nblk ? fresh[j] : Tr::zero();
    publish(refill, g0 + per_step);
  }
}

template <class Tr, bool kPivoted>
__global__ void __launch_bounds__(kThreads, 1) band_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  if constexpr (kPivoted) {
    fwd_pivoted<Tr>(a, smem);
  } else {
    fwd_pivot_free<Tr>(a, smem);
  }
}

// Backward, both modes: the ring of S + 1 solution blocks; step K writes
// x_K into the slot of x_{K+S+1}.  Rows at or past nblk (the pivot-free
// lookahead rows) take Dinv = I and are not written out.  Tile stream per
// step: my rows of the S folded slots, then my rows of Dinv_K where
// K < nblk.  A bf16 band's slots and the float32 Dinv are dotted in two
// calls of tile_dots, one per type.
template <class Tr>
__global__ void __launch_bounds__(kThreads, 1) band_bwd_kernel(BwdArgs a) {
  using Mat = typename Tr::Mat;
  using Vec = typename Tr::Vec;
  using Dense = typename Tr::Dense;
  extern __shared__ __align__(128) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int Rc = kNb / C, lg_rc = __ffs(Rc) - 1, r0 = rank * Rc, S = a.S, ring = S + 1;
  const int nsteps = (int)a.nsteps, nblk = (int)a.nblk;
  const Mat* band = static_cast<const Mat*>(a.band);
  const typename Dense::Mat* dinv = static_cast<const typename Dense::Mat*>(a.dinv);
  const Vec* y = static_cast<const Vec*>(a.y);
  Vec* x = static_cast<Vec*>(a.x);
  size_t side_bytes, rest_bytes;
  bwd_sizes<Tr>(S, C, side_bytes, rest_bytes);
  const Layout L(a.nt, tile_bytes<Dense>(C), side_bytes, rest_bytes);
  Smem sm(smem, L, a.nt, tile_bytes<Dense>(C), side_bytes);
  Vec* win = reinterpret_cast<Vec*>(sm.rest);
  Vec* part = win + ring * kNb;
  const int ntiles = (nsteps - nblk) * S + nblk * (S + 1);
  const uint32_t Tb = (uint32_t)tile_bytes<Tr>(C), Td = (uint32_t)tile_bytes<Dense>(C);
  Producer prod(Walk{nsteps - 1, 0});
  auto src = [&](const Walk& w) {
    return w.j < S ? Tile{band + (((int64_t)w.K * a.R + a.s0 + w.j) * kNb + r0) * kNb, Tb}
                   : Tile{dinv + ((int64_t)w.K * kNb + r0) * kNb, Td};
  };
  auto step = [&](Walk& w) {
    if (++w.j == S + (w.K < nblk)) w.j = 0, --w.K;
  };
  auto refill = [&](int consumed) { prod.fill(sm.ring, min(ntiles, consumed + a.nt), src, step); };
  auto midrefill = [&](int consumed) {
    mbar_wait(sm.ring.freed, prod.frees++ & 1);
    refill(consumed);
  };
  auto side = [&](int K) {  // y_K
    const uint32_t bar = sm.side_bar[K & 1];
    mbar_expect(bar, kNb * sizeof(Vec));
    bulk_copy(sm.side[K & 1], y + (int64_t)K * kNb, kNb * sizeof(Vec), bar);
  };

  for (int e = threadIdx.x; e < ring * kNb; e += kThreads) win[e] = Tr::zero();
  if (threadIdx.x == kProducer) {
    refill(0);
    side(nsteps - 1);
  }
  cluster.sync();
  int g = 0;  // the stream index of this step's first tile
  for (int K = nsteps - 1; K >= 0; --K) {
    // the side buffer of step K is K % 2, its fill (nsteps - 1 - K) / 2
    const int sb = K & 1, n = S + (K < nblk);
    const Vec* yk = reinterpret_cast<const Vec*>(sm.side[sb]);
    if (threadIdx.x == kProducer && K > 0) side(K - 1);
    warp_wait(sm.side_bar[sb], ((nsteps - 1 - K) >> 1) & 1);
    // my rows of Dinv_K y_K (the last tile, where K < nblk) less the S
    // folded slots times the window
    const int base_slot = (K + 1) % ring;
    auto vec = [&](int t) {
      const int s = base_slot + t;
      return t < S ? win + (s < ring ? s : s - ring) * kNb : yk;
    };
    auto out = [&](int t, int i) { return i * (S + 1) + t; };
    if constexpr (std::is_same<Tr, Dense>::value) {
      tile_dots<Tr>(sm.ring, g, n, lg_rc, vec, out, midrefill, part);
    } else {
      tile_dots<Tr>(sm.ring, g, S, lg_rc, vec, out, midrefill, part, K < nblk);
      if (K < nblk)
        tile_dots<Dense>(sm.ring, g + S, 1, lg_rc, [&](int) { return yk; },
                         [&](int, int i) { return i * (S + 1) + S; }, midrefill, part);
    }
    g += n;
    if (threadIdx.x < Rc * C) {
      const int i = threadIdx.x & (Rc - 1), dst = threadIdx.x >> lg_rc;
      Vec acc = Tr::zero();
      for (int t = 0; t < S; ++t) acc = vadd(acc, part[i * (S + 1) + t]);
      const Vec xk = vsub(K < nblk ? part[i * (S + 1) + S] : yk[r0 + i], acc);
      if (K < nblk && dst == rank) x[(int64_t)K * kNb + r0 + i] = xk;
      *cluster.map_shared_rank(win + (K % ring) * kNb + r0 + i, dst) = xk;
    }
    publish(refill, g);
  }
}

// A launch configuration: one cluster of ``c`` blocks with ``smem`` bytes
// of dynamic shared memory each.
struct Config {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  Config(int c, size_t smem, void* stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The cluster size, ring tiles and shared memory of one kernel on one
// device for one window size ``key`` (B forward, S backward): chosen on
// the first launch, kept for the later ones.
struct Choice {
  const void* fn;
  int device, key;
  int c, nt;
  size_t smem;
};
std::mutex g_choices_mu;
constexpr int kMaxChoices = 256;
Choice g_choices[kMaxChoices];
int g_nchoices = 0;

bool find_choice(Choice& ch) {
  std::lock_guard<std::mutex> lock(g_choices_mu);
  for (int i = 0; i < g_nchoices; ++i) {
    const Choice& k = g_choices[i];
    if (k.fn == ch.fn && k.device == ch.device && k.key == ch.key) {
      ch = k;
      return true;
    }
  }
  return false;
}

void keep_choice(const Choice& ch) {
  std::lock_guard<std::mutex> lock(g_choices_mu);
  if (g_nchoices < kMaxChoices) g_choices[g_nchoices++] = ch;
}

// The largest cluster of kMaxCluster, kMaxCluster / 2, ..., 1 blocks whose
// shared memory fits and that the card can co-schedule.  For each size c,
// sizes(c, side, rest) gives the mode's side and window bytes; the ring of
// tiles of Tr (its slot's type) takes what shared memory is left (at most
// kMaxTiles tiles).
template <class Tr, class SizesFn>
cudaError_t choose(SizesFn sizes, Choice& ch) {
  cudaError_t err = cudaFuncSetAttribute(ch.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ch.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (err != cudaSuccess) return err;
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    size_t side, rest;
    sizes(c, side, rest);
    const size_t tile = tile_bytes<Tr>(c);
    const size_t fixed = Layout(0, tile, side, rest).total;
    if (fixed + 8 * kMaxTiles + tile > kSmemMax) continue;
    int nt = (int)((kSmemMax - fixed - 8 * kMaxTiles) / tile);
    if (nt > kMaxTiles) nt = kMaxTiles;
    const size_t smem = Layout(nt, tile, side, rest).total;
    const Config k(c, smem, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, ch.fn, &k.cfg);
    if (err != cudaSuccess) return err;
    if (clusters > 0) {
      ch.c = c;
      ch.nt = nt;
      ch.smem = smem;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;  // no cluster fits: the window is too large
}

// Launch ``kernel`` as one cluster, of the size ``choose`` picks for it.
template <class Tr, class Args, class SizesFn>
int launch(void (*kernel)(Args), Args args, int key, SizesFn sizes, void* stream) {
  Choice ch = {reinterpret_cast<const void*>(kernel), 0, key, 0, 0, 0};
  cudaError_t err = cudaGetDevice(&ch.device);
  if (err != cudaSuccess) return (int)err;
  if (!find_choice(ch)) {
    err = choose<Tr>(sizes, ch);
    if (err != cudaSuccess) return (int)err;
    keep_choice(ch);
  }
  args.nt = ch.nt;
  const Config k(ch.c, ch.smem, stream);
  err = cudaLaunchKernelEx(&k.cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class Tr>
int fwd_typed(bool pivoted, const FwdArgs& a, void* stream) {
  auto sizes = [&](int c, size_t& side, size_t& rest) { fwd_sizes<Tr>(pivoted, a.B, c, side, rest); };
  if constexpr (std::is_same<Tr, typename Tr::Dense>::value) {
    if (pivoted) return launch<Tr>(band_fwd_kernel<Tr, true>, a, a.B, sizes, stream);
  } else {
    if (pivoted) return (int)cudaErrorInvalidValue;  // pivoted factors are never bf16
  }
  return launch<Tr>(band_fwd_kernel<Tr, false>, a, a.B, sizes, stream);
}

template <class Tr>
int bwd_typed(const BwdArgs& a, void* stream) {
  auto sizes = [&](int c, size_t& side, size_t& rest) { bwd_sizes<Tr>(a.S, c, side, rest); };
  return launch<typename Tr::Dense>(band_bwd_kernel<Tr>, a, a.S, sizes, stream);
}

// type: 0 complex64, 1 float32 with one column, 2 float32 with two columns;
// bf16: the band is stored in bf16.
template <template <class> class Fn, class Args>
int dispatch(int type, int bf16, const Args& a, void* stream, bool pivoted = false) {
  switch (type + 3 * (bf16 != 0)) {
    case 0: return Fn<C64>::run(a, stream, pivoted);
    case 1: return Fn<R32x1>::run(a, stream, pivoted);
    case 2: return Fn<R32x2>::run(a, stream, pivoted);
    case 3: return Fn<C64bf>::run(a, stream, pivoted);
    case 4: return Fn<R32x1bf>::run(a, stream, pivoted);
    case 5: return Fn<R32x2bf>::run(a, stream, pivoted);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Tr>
struct Fwd {
  static int run(const FwdArgs& a, void* stream, bool pivoted) { return fwd_typed<Tr>(pivoted, a, stream); }
};

template <class Tr>
struct Bwd {
  static int run(const BwdArgs& a, void* stream, bool) { return bwd_typed<Tr>(a, stream); }
};

}  // namespace

extern "C" int band_nb() { return kNb; }

extern "C" int band_fwd(int type, int bf16, const void* band, const void* b, void* y,
                        int64_t rows_total, int64_t nblk, int B, void* stream) {
  FwdArgs a = {band, nullptr, nullptr, nullptr, b, y, rows_total, nblk, B, 0};
  return dispatch<Fwd>(type, bf16, a, stream);
}

extern "C" int band_fwd_pivoted(int type, const void* L2, const void* L1inv, const void* perms,
                                const void* b, void* y, int64_t nblk, int B, void* stream) {
  FwdArgs a = {nullptr, L2, L1inv, static_cast<const int64_t*>(perms), b, y, nblk, nblk, B, 0};
  return dispatch<Fwd>(type, 0, a, stream, true);
}

extern "C" int band_bwd(int type, int bf16, const void* band, const void* dinv, const void* y,
                        void* x, int64_t nsteps, int64_t nblk, int R, int s0, int S, void* stream) {
  BwdArgs a = {band, dinv, y, x, nsteps, nblk, R, s0, S, 0};
  return dispatch<Bwd>(type, bf16, a, stream);
}
