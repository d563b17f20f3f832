// Gather (G), its two permutation forms, and the tiled CSR SpMV (S): the
// band-order permutations and the refinement matvecs of the banded Newton
// and shift-invert solves.
//
// G, gather_kernel, replaces the in-kernel gather probes of the reference
// repository, all of which compute y = x[idx] from a vector resident on
// the chip:
//   scripts/dev_pallas_gather.py   run_a (k_a)  1-D take
//                                  run_b (k_b)  row take + one-hot lane select
//                                  run_c (k_c)  take_along_axis on lanes
//   scripts/dev_pallas_gather2.py  pallas_two_pass (kernel)
//       y[m, l] = x2d[rowsel[m, lanesel[m, l]], lanesel[m, l]]
// Flat form (lanesel == nullptr): y[i] = x[idx[i]]; run_b's and run_c's
// (row, lane) pairs arrive as the flat index row * 128 + lane.  Two-pass
// form: idx is rowsel, both (count / width, width).  Templated on the
// element type (f32, f64, complex128).  On the TPU these probes lost to a
// block layout because Mosaic has no sublane gather and each index cost
// about 7 ns; on Hopper a gather is one load through the read-only cache
// per index.  The flat f64 form refills the CSR values of S.
//
// G's permutation forms carry a vector into and out of the band's order
// for the band substitution, each in one launch (the reference's
// lsafw_tpu/solver/band.py _permute_in :1314/:1611, the padded gathers of
// solve_pair :1218/:1505 and the [iperm] gathers :1235/:1330/:1340/:1529/
// :1625):
//   permute_in_kernel:  out[i] = cast(b[perm[i]]), 0 where perm[i] >= n,
//     b f64 or complex128 in the original order, out float32 or
//     complex64 in the band order; a complex b on a real factor leaves as
//     two real columns (out is then (slots, 2) float32, whose layout is
//     complex64's), a real b on a complex factor with a zero imaginary
//     part.  The cast rounds to nearest even, as torch's .to() does.
//   permute_out_kernel: out[i] = x[iperm[i]] widened to f64 / complex128,
//     two real columns merged into one complex value, or the real part
//     of a complex64 x alone.
// Bound: the permutation (4 bytes a slot), the b or x elements it reads
// and the output, about 1.2 MB for a complex vector of the 43k cylinder:
// 0.4 us at 3.35 TB/s, under the 2 us a launch takes.  A launch, not the
// bytes, sets their time; each replaces the five launches (zeros, copy,
// gather, cast, stack) into the band's order, or the two (cast, gather)
// out of it.
//
// S, csr_tiled_spmv_kernel, replaces the reference's BCSR refinement
// matvec (lsafw_tpu/ops/bcsr.py BCSROperator.matvec_permuted :388 and
// matvec :446, BCSRShiftedOp._reduce_all :587, matvec_pair_permuted
// :615, mass_pair_permuted :622, matvec_pair :638, mass_pair :646: XLA
// scans).  Storage is the RCM-permuted CSR of one pattern, f64 values
// (A and M of a shifted operator on one set of row pointers and columns):
//   vm == nullptr:   y = A x                       (Newton J x; M x alone)
//   vm != nullptr:   y = (A - sigma M) x, and ym = M x where ym != nullptr
// x is f64 or interleaved complex128; sums are f64; sigma is a kernel
// argument, so a sigma sweep refills nothing.  The original-order apply
// folds the permutation in: col holds the original column ids and
// out_idx = perm, so it reads x and writes y[perm[r]] in the original
// order in one launch; the permuted apply has col in permuted ids and
// out_idx == nullptr.
//
// Bound: S must read nnz * (4 + 8 [+ 8]) bytes of columns and values,
// the row pointers ((n + 1) * 8), its tiles, x once, the permutation
// (n * 4, original order) and write its outputs: for the shifted apply of
// the 43k cylinder (n = 43,671, nnz = 1,284,093) 27.6 MB, 8.2 us at
// 3.35 TB/s; the one-matrix applies 15.4 MB (f64 x) to 16.7 MB
// (complex128 x).  A few flops per 20 bytes: bytes bound it.
//
// Design.  One warp per row, a three-deep chain of dependent global loads
// per row (row pointers, then columns and values, then x) and about 43k
// rows in five waves of warps made latency, not bytes, set the time.
// Here a plan cuts the rows into tiles of whole rows with at most kCap
// nonzeros and kRowCap rows each, one block a tile, so sums
// need no atomics and keep a fixed order; the 43k cylinder's ~630 tiles
// of 44 KB (shifted) run in one wave at five blocks an SM.  The block's
// thread 0 issues bulk asynchronous copies (cp.async.bulk) of the tile
// into shared memory after one dependent global load (the tile bounds):
// columns, row pointers and output indices on one mbarrier, the values on
// a second.  A's and M's values stay two arrays, not one interleaved: each
// comes in one copy either way, and the mass apply copies M's alone.  The copies take the superset of each range whose ends are
// multiples of 4 entries (2 for the row pointers), 16-byte aligned; the
// wrapper checks that every array's storage reaches that far, and the
// kernel masks the rest.  Groups of kG lanes reduce one row each (about
// 29 nonzeros), each lane with its first kPer gathers of x in flight at
// once, the first round's issued before the values have landed; x (0.35
// to 0.7 MB at 43k) is gathered through L1 and L2.  A row longer than kCap
// is a tile of its own and is summed by the whole block from global
// memory.  On an H100 the cold shifted apply takes 16-18 us: the gathers
// cost 5-15% of it, and smaller tiles or four lanes a row were no faster
// (spmv_probe.py), nor was a persistent block with two tiles in flight
// (tried and dropped: PERF.md); a plain streaming kernel of as many bytes
// (G's f64 refill) reaches about 2 TB/s at this size, S 1.4-1.6 TB/s.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// G's device function: x[i] through the read-only data path.
template <typename T>
__device__ __forceinline__ T gather_at(const T* __restrict__ x, int64_t i) {
  return __ldg(x + i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
              const int32_t* __restrict__ lanesel, T* __restrict__ y, int64_t count,
              int width) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    int64_t src;
    if (lanesel == nullptr) {
      src = __ldg(idx + i);
    } else {
      const int64_t m = i / width;
      const int l = __ldg(lanesel + i);
      src = (int64_t)__ldg(idx + m * width + l) * width + l;
    }
    y[i] = gather_at(x, src);
  }
}

// --- G's permutation forms -------------------------------------------------

// WI doubles per b element (1: f64, 2: complex128), WO floats per output
// slot (1: one real column, 2: complex64 or two real columns).
template <int WI, int WO>
__global__ void __launch_bounds__(kThreads)
permute_in_kernel(const double* __restrict__ b, const int32_t* __restrict__ perm,
                  float* __restrict__ out, int64_t count, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    const int64_t src = __ldg(perm + i);
    double re = 0.0, im = 0.0;
    if (src < n) {
      if (WI == 2) {
        const double2 v = __ldg(reinterpret_cast<const double2*>(b) + src);
        re = v.x;
        im = v.y;
      } else {
        re = __ldg(b + src);
      }
    }
    if (WO == 2) {
      reinterpret_cast<float2*>(out)[i] = make_float2(__double2float_rn(re), __double2float_rn(im));
    } else {
      out[i] = __double2float_rn(re);
    }
  }
}

// WI floats per band-order slot, WO doubles per output element (1: f64,
// the real part where WI == 2; 2: complex128).
template <int WI, int WO>
__global__ void __launch_bounds__(kThreads)
permute_out_kernel(const float* __restrict__ x, const int32_t* __restrict__ iperm,
                   double* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t src = __ldg(iperm + i);
    if (WI == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(x) + src);
      if (WO == 2) {
        reinterpret_cast<double2*>(out)[i] = make_double2(v.x, v.y);
      } else {
        out[i] = v.x;
      }
    } else {
      out[i] = __ldg(x + src);
    }
  }
}

// --- S -------------------------------------------------------------------

constexpr int kCap = 2048;     // most nonzeros a tile holds in shared memory
constexpr int kRowCap = 256;   // most rows a tile holds
constexpr int kG = 8;          // lanes that reduce one row
constexpr int kPer = 6;        // x gathers a lane keeps in flight (a row of kG * kPer at once)
constexpr int kGroups = kThreads / kG;

__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ double2 zero_of(double2) { return make_double2(0.0, 0.0); }

__device__ __forceinline__ double madd(double acc, double a, double x) { return fma(a, x, acc); }
__device__ __forceinline__ double2 madd(double2 acc, double a, double2 x) {
  return make_double2(fma(a, x.x, acc.x), fma(a, x.y, acc.y));
}

__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double shfl_xor(double v, int o) { return __shfl_xor_sync(kFull, v, o); }
__device__ __forceinline__ double2 shfl_xor(double2 v, int o) {
  return make_double2(__shfl_xor_sync(kFull, v.x, o), __shfl_xor_sync(kFull, v.y, o));
}

// Sum over the kG lanes of a group (every lane of the warp takes part).
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1) v = add(v, shfl_xor(v, off));
  return v;
}

// a - sigma m (a real x has a real shift only; the wrapper refuses others)
__device__ __forceinline__ double shifted(double a, double m, double sr, double) {
  return a - sr * m;
}
__device__ __forceinline__ double2 shifted(double2 a, double2 m, double sr, double si) {
  return make_double2(a.x - (sr * m.x - si * m.y), a.y - (sr * m.y + si * m.x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the first phase of an mbarrier: lane 0 of each warp polls it
// with try_wait (which suspends the thread a while rather than spin), and
// its warp follows.  Every thread of the block polling it held the bulk
// copies off the shared memory for seconds.  A copy that never lands
// traps (an error the launch reports) instead of hanging the card.
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  if ((threadIdx.x & 31) == 0) {
    uint32_t done = 0;
    for (uint32_t tries = 0; !done; ++tries) {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
          "selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(bar)
          : "memory");
      if (tries == (1u << 26)) __trap();
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The superset [lo, hi) of the index range [a, b) whose ends are
// multiples of K entries: 16-byte aligned for K = 4 and 4- or 8-byte
// entries, and for K = 2 and 8-byte entries.
template <int K>
struct Span {
  int64_t lo, hi;
  __device__ Span(int64_t a, int64_t b) : lo(a & ~(int64_t)(K - 1)), hi((b + K - 1) & ~(int64_t)(K - 1)) {}
  __device__ uint32_t bytes(int elem) const { return (uint32_t)((hi - lo) * elem); }
};

struct Tiles {
  const int32_t* tile_row;  // (ntiles + 1,) first row of each tile
  const int64_t* tile_ptr;  // (ntiles + 1,) crow[tile_row]
  const int64_t* crow;
  const int32_t* col;
  const double* va;
  const double* vm;
  const int32_t* out_idx;  // (n,) or nullptr
};

template <typename T>
__device__ __forceinline__ void store(const Tiles& t, T* y, T* ym, int64_t o, T a, T m, double sr,
                                      double si) {
  if (t.vm == nullptr) {
    y[o] = a;
  } else {
    y[o] = shifted(a, m, sr, si);
    if (ym != nullptr) ym[o] = m;
  }
}

// A row longer than kCap: the whole block sums it from global memory.
template <typename T, bool kPair>
__device__ void long_row(const Tiles& t, const T* __restrict__ x, T* y, T* ym, int r, int64_t k0,
                         int64_t k1, double sr, double si) {
  __shared__ T part[2][kThreads / 32];
  T a = zero_of(T{}), m = zero_of(T{});
  for (int64_t k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const T xv = gather_at(x, (int64_t)__ldg(t.col + k));
    a = madd(a, __ldg(t.va + k), xv);
    if (kPair) m = madd(m, __ldg(t.vm + k), xv);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = add(a, shfl_xor(a, off));
    if (kPair) m = add(m, shfl_xor(m, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = a;
    part[1][warp] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = part[0][0];
    m = part[1][0];
    for (int w = 1; w < kThreads / 32; ++w) {
      a = add(a, part[0][w]);
      m = add(m, part[1][w]);
    }
    store(t, y, ym, t.out_idx == nullptr ? (int64_t)r : (int64_t)__ldg(t.out_idx + r), a, m, sr,
          si);
  }
}

template <typename T, bool kPair>
__global__ void __launch_bounds__(kThreads)
csr_tiled_spmv_kernel(const Tiles t, const T* __restrict__ x, T* __restrict__ y,
                      T* __restrict__ ym, double sr, double si) {
  __shared__ __align__(16) int32_t scol[kCap + 8];
  __shared__ __align__(16) double sva[kCap + 8];
  __shared__ __align__(16) double svm[kPair ? kCap + 8 : 2];
  __shared__ __align__(16) int64_t scrow[kRowCap + 4];
  __shared__ __align__(16) int32_t sout[kRowCap + 8];
  __shared__ __align__(8) uint64_t bars[2];  // the indices; the values

  const int r0 = __ldg(t.tile_row + blockIdx.x), r1 = __ldg(t.tile_row + blockIdx.x + 1);
  const int64_t k0 = __ldg(t.tile_ptr + blockIdx.x), k1 = __ldg(t.tile_ptr + blockIdx.x + 1);
  if (r1 - r0 > kRowCap) __trap();  // not a tile of the plan
  if (k1 - k0 > kCap) {  // one long row (the plan gives it a tile of its own)
    long_row<T, kPair>(t, x, y, ym, r0, k0, k1, sr, si);
    return;
  }
  const Span<4> cs(k0, k1);      // columns and values
  const Span<2> rs(r0, r1 + 1);  // row pointers
  const Span<4> os(r0, r1);      // output indices
  const uint32_t idx_bar = smem_addr(&bars[0]), val_bar = smem_addr(&bars[1]);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(idx_bar) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(val_bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const bool nz = k1 > k0, perm = t.out_idx != nullptr;
    const uint32_t idx_bytes = (nz ? cs.bytes(4) : 0) + rs.bytes(8) + (perm ? os.bytes(4) : 0);
    const uint32_t val_bytes = nz ? cs.bytes(8) * (kPair ? 2 : 1) : 0;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(idx_bar),
                 "r"(idx_bytes)
                 : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(val_bar),
                 "r"(val_bytes)
                 : "memory");
    if (nz) bulk_copy(scol, t.col + cs.lo, cs.bytes(4), idx_bar);
    bulk_copy(scrow, t.crow + rs.lo, rs.bytes(8), idx_bar);
    if (perm) bulk_copy(sout, t.out_idx + os.lo, os.bytes(4), idx_bar);
    if (nz) {
      bulk_copy(sva, t.va + cs.lo, cs.bytes(8), val_bar);
      if (kPair) bulk_copy(svm, t.vm + cs.lo, cs.bytes(8), val_bar);
    }
  }
  __syncthreads();  // the mbarriers are initialised
  mbar_wait0(idx_bar);

  // Each group of kG lanes takes one row a round: its lanes put their
  // first kPer gathers of x in flight (while the values still land, in
  // the first round), then multiply; longer rows finish in a loop.
  const int group = threadIdx.x / kG, sub = threadIdx.x % kG;
  for (int base = r0; base < r1; base += kGroups) {  // uniform across the block
    const int r = base + group;
    int s = 0, e = 0;
    if (r < r1) {
      s = (int)(scrow[r - rs.lo] - cs.lo);
      e = (int)(scrow[r + 1 - rs.lo] - cs.lo);
    }
    T xv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = s + sub + j * kG;
      xv[j] = k < e ? gather_at(x, (int64_t)scol[k]) : zero_of(T{});
    }
    if (base == r0) mbar_wait0(val_bar);
    T a = zero_of(T{}), m = zero_of(T{});
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = s + sub + j * kG;
      if (k < e) {
        a = madd(a, sva[k], xv[j]);
        if (kPair) m = madd(m, svm[k], xv[j]);
      }
    }
    for (int k = s + sub + kPer * kG; k < e; k += kG) {
      const T xk = gather_at(x, (int64_t)scol[k]);
      a = madd(a, sva[k], xk);
      if (kPair) m = madd(m, svm[k], xk);
    }
    a = group_sum(a);
    if (kPair) m = group_sum(m);
    if (sub == 0 && r < r1) {
      store(t, y, ym, t.out_idx == nullptr ? (int64_t)r : (int64_t)sout[r - os.lo], a, m, sr, si);
    }
  }
}

template <typename T>
int launch_gather(const void* x, const void* idx, const void* lanesel, void* y, int64_t count,
                  int width, void* stream) {
  if (count <= 0) return 0;
  int64_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks per SM
  gather_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const int32_t*)idx, (const int32_t*)lanesel, (T*)y, count, width);
  return (int)cudaGetLastError();
}

unsigned grid_for(int64_t count) {
  int64_t blocks = (count + kThreads - 1) / kThreads;
  return (unsigned)(blocks > 132 * 64 ? 132 * 64 : blocks);
}

template <typename T>
int launch_spmv(const Tiles& t, int64_t ntiles, const void* x, void* y, void* ym, double sr,
                double si, void* stream) {
  if (ntiles <= 0) return 0;
  if (t.vm == nullptr) {
    csr_tiled_spmv_kernel<T, false><<<(unsigned)ntiles, kThreads, 0, (cudaStream_t)stream>>>(
        t, (const T*)x, (T*)y, (T*)ym, sr, si);
  } else {
    csr_tiled_spmv_kernel<T, true><<<(unsigned)ntiles, kThreads, 0, (cudaStream_t)stream>>>(
        t, (const T*)x, (T*)y, (T*)ym, sr, si);
  }
  return (int)cudaGetLastError();
}

Tiles tiles_of(const void* tile_row, const void* tile_ptr, const void* crow, const void* col,
               const void* va, const void* vm, const void* out_idx) {
  return Tiles{(const int32_t*)tile_row, (const int64_t*)tile_ptr, (const int64_t*)crow,
               (const int32_t*)col, (const double*)va, (const double*)vm,
               (const int32_t*)out_idx};
}

}  // namespace

extern "C" int gather_f32(const void* x, const void* idx, const void* lanesel, void* y,
                          int64_t count, int width, void* stream) {
  return launch_gather<float>(x, idx, lanesel, y, count, width, stream);
}

extern "C" int gather_f64(const void* x, const void* idx, const void* lanesel, void* y,
                          int64_t count, int width, void* stream) {
  return launch_gather<double>(x, idx, lanesel, y, count, width, stream);
}

extern "C" int gather_c128(const void* x, const void* idx, const void* lanesel, void* y,
                           int64_t count, int width, void* stream) {
  return launch_gather<double2>(x, idx, lanesel, y, count, width, stream);
}

// wi: doubles per b element, wo: floats per output slot (1 or 2 each).
extern "C" int permute_in(const void* b, const void* perm, void* out, int64_t count, int64_t n,
                          int wi, int wo, void* stream) {
  if (count <= 0) return 0;
  const unsigned grid = grid_for(count);
  cudaStream_t s = (cudaStream_t)stream;
  const double* bb = (const double*)b;
  const int32_t* p = (const int32_t*)perm;
  float* o = (float*)out;
  if (wi == 2 && wo == 2) {
    permute_in_kernel<2, 2><<<grid, kThreads, 0, s>>>(bb, p, o, count, n);
  } else if (wi == 1 && wo == 2) {
    permute_in_kernel<1, 2><<<grid, kThreads, 0, s>>>(bb, p, o, count, n);
  } else if (wi == 1 && wo == 1) {
    permute_in_kernel<1, 1><<<grid, kThreads, 0, s>>>(bb, p, o, count, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// wi: floats per band-order slot, wo: doubles per output element.
extern "C" int permute_out(const void* x, const void* iperm, void* out, int64_t n, int wi, int wo,
                           void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xx = (const float*)x;
  const int32_t* p = (const int32_t*)iperm;
  double* o = (double*)out;
  if (wi == 2 && wo == 2) {
    permute_out_kernel<2, 2><<<grid, kThreads, 0, s>>>(xx, p, o, n);
  } else if (wi == 2 && wo == 1) {
    permute_out_kernel<2, 1><<<grid, kThreads, 0, s>>>(xx, p, o, n);
  } else if (wi == 1 && wo == 1) {
    permute_out_kernel<1, 1><<<grid, kThreads, 0, s>>>(xx, p, o, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int csr_spmv_f64(const void* tile_row, const void* tile_ptr, int64_t ntiles,
                            const void* crow, const void* col, const void* va, const void* vm,
                            const void* out_idx, const void* x, void* y, void* ym, double sr,
                            double si, void* stream) {
  return launch_spmv<double>(tiles_of(tile_row, tile_ptr, crow, col, va, vm, out_idx), ntiles,
                             x, y, ym, sr, si, stream);
}

extern "C" int csr_spmv_c128(const void* tile_row, const void* tile_ptr, int64_t ntiles,
                             const void* crow, const void* col, const void* va, const void* vm,
                             const void* out_idx, const void* x, void* y, void* ym, double sr,
                             double si, void* stream) {
  return launch_spmv<double2>(tiles_of(tile_row, tile_ptr, crow, col, va, vm, out_idx),
                              ntiles, x, y, ym, sr, si, stream);
}
