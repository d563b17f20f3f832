// Gather (G) and fused shifted CSR SpMV (S): the refinement matvecs of the
// banded Newton and shift-invert solves.
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
// element type (f32, f64, complex128); S gathers x through the same
// device function.  On the TPU these probes lost to a block layout because
// Mosaic has no sublane gather and each index cost about 7 ns; on Hopper a
// gather is one load through the read-only cache per index, so G is bound
// by the bytes of idx, y and the x lines it touches.
//
// S, csr_shifted_spmv_kernel, replaces the reference's BCSR refinement
// matvec (lsafw_tpu/ops/bcsr.py, BCSROperator.matvec_permuted and
// BCSRShiftedOp._reduce_all / mass_pair_permuted, XLA scans).  Storage is
// the RCM-permuted CSR of one pattern with the A and M values side by side
// (f64), so one pass over the column indices feeds both products:
//   vm == nullptr:   y = A x                       (Newton J x; M x alone)
//   vm != nullptr:   y = (A - sigma M) x, and ym = M x where ym != nullptr
// x is f64 or interleaved complex128, gathered per index by G's device
// function (16-byte loads for complex128); sums are f64; sigma is a kernel
// argument, so a sigma sweep refills nothing.
//
// Bound: S must read nnz * (4 + 8 [+ 8]) bytes of indices and values, the
// row pointers, x once and write its outputs: about 28.5 MB for the shifted
// apply of the 43k cylinder (1.28 M nonzeros), 8.5 us at 3.35 TB/s.  Its
// arithmetic is a few flops per 20 bytes, so bytes bound it.
//
// Design (simple and right first): one warp per row (about 29 nonzeros per
// row on the Taylor-Hood patterns), lanes striding over the row's
// nonzeros, then a shuffle reduction.  The RCM order keeps the columns of
// neighbouring rows close, and the whole x of a 43k problem (0.7 MB of
// complex128) stays in the 50 MB L2.

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

__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ double2 zero_of(double2) { return make_double2(0.0, 0.0); }

__device__ __forceinline__ double madd(double acc, double a, double x) { return fma(a, x, acc); }
__device__ __forceinline__ double2 madd(double2 acc, double a, double2 x) {
  return make_double2(fma(a, x.x, acc.x), fma(a, x.y, acc.y));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}
__device__ __forceinline__ double2 warp_sum(double2 v) {
  return make_double2(warp_sum(v.x), warp_sum(v.y));
}

// a - sigma m (a real x has a real shift only; the wrapper refuses others)
__device__ __forceinline__ double shifted(double a, double m, double sr, double) {
  return a - sr * m;
}
__device__ __forceinline__ double2 shifted(double2 a, double2 m, double sr, double si) {
  return make_double2(a.x - (sr * m.x - si * m.y), a.y - (sr * m.y + si * m.x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_shifted_spmv_kernel(const int64_t* __restrict__ crow, const int32_t* __restrict__ col,
                        const double* __restrict__ va, const double* __restrict__ vm,
                        const T* __restrict__ x, T* __restrict__ y, T* __restrict__ ym,
                        int64_t n, double sr, double si) {
  const int lane = threadIdx.x & 31;
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;  // uniform across the warp: one warp per row
  const int64_t s = __ldg(crow + row), e = __ldg(crow + row + 1);
  T a = zero_of(T{}), m = zero_of(T{});
  for (int64_t k = s + lane; k < e; k += 32) {
    const T xv = gather_at(x, (int64_t)__ldg(col + k));
    a = madd(a, __ldg(va + k), xv);
    if (vm != nullptr) m = madd(m, __ldg(vm + k), xv);
  }
  a = warp_sum(a);
  if (vm != nullptr) m = warp_sum(m);
  if (lane == 0) {
    if (vm == nullptr) {
      y[row] = a;
    } else {
      y[row] = shifted(a, m, sr, si);
      if (ym != nullptr) ym[row] = m;
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

template <typename T>
int launch_spmv(const void* crow, const void* col, const void* va, const void* vm, const void* x,
                void* y, void* ym, int64_t n, double sr, double si, void* stream) {
  if (n <= 0) return 0;
  const int rows_per_block = kThreads / 32;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  csr_shifted_spmv_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)crow, (const int32_t*)col, (const double*)va, (const double*)vm,
      (const T*)x, (T*)y, (T*)ym, n, sr, si);
  return (int)cudaGetLastError();
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

extern "C" int csr_spmv_f64(const void* crow, const void* col, const void* va, const void* vm,
                            const void* x, void* y, void* ym, int64_t n, double sr, double si,
                            void* stream) {
  return launch_spmv<double>(crow, col, va, vm, x, y, ym, n, sr, si, stream);
}

extern "C" int csr_spmv_c128(const void* crow, const void* col, const void* va, const void* vm,
                             const void* x, void* y, void* ym, int64_t n, double sr, double si,
                             void* stream) {
  return launch_spmv<double2>(crow, col, va, vm, x, y, ym, n, sr, si, stream);
}
