// Banded block substitution through a pivot-free complex band LU factor.
//
// Replaces the two Pallas TPU kernels of the reference package,
// lsafw_tpu/solver/band_pallas.py:
//   band_fwd_kernel  <- _fwd_kernel / fwd_substitute_pallas (K1)
//       y_K = b_K - sum_{t<B} L[K,t] y_{K-B+t}, K ascending
//   band_bwd_kernel  <- _bwd_kernel / bwd_substitute_pallas (K2)
//       x_K = Dinv_K (y_K - sum_{t<B} U[K,B+1+t] x_{K+1+t}), K descending
//
// Layout: the factored band is (rows_total, 2B+1, nb, nb) complex64,
// interleaved (re, im) float pairs, row-major; slot r of block row K is
// block (K, K + r - B): slots 0..B-1 hold L, slot B the diagonal, slots
// B+1..2B hold U.  Dinv is (nblk, nb, nb) complex64.  The right-hand side
// has nblk <= rows_total block rows; rows at or past nblk are zero on
// input and use Dinv = I (the B lookahead rows of the band), as in the
// Pallas wrapper solve_banded_pallas.
//
// Bound: each kernel must read the B band slots it uses once,
// rows_total * B * nb^2 * 8 bytes (359 MB at the 43k cylinder shapes
// B = 7, nb = 128, rows_total = 391), plus Dinv (51 MB) for K2.  At the
// H100's 3.35 TB/s one solve (K1 + K2) is bounded at about 0.23 ms.  The
// arithmetic is 8 flops per complex multiply-add on those bytes: 1 flop
// per byte, far below the card's balance point, so bytes bound it.
//
// Design (simple and right first): the recursion is serial in K, so one
// persistent thread block runs the whole substitution.  The carry window
// of solution blocks lives in shared memory as a ring of B + 1 blocks:
// step K reads the B previous solution blocks and writes its own block
// into the one slot that step does not read, so one __syncthreads() per
// step suffices in K1 (K2 needs a second one before its Dinv product,
// which reads the whole intermediate block).  Band rows stream from
// device memory: one warp per output row i, each lane loading 16 bytes
// (two complex values) at a time along the contiguous last axis j, then
// a warp-shuffle reduction.  A single block reaches only the bandwidth
// of one SM; spreading each step over a thread block cluster is later
// work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// sum_j A[i, j] * v[j] for one row of an nb x nb complex block; A row in
// global memory, v in shared memory; lanes stride over pairs of columns.
__device__ __forceinline__ void row_dot(const float4* __restrict__ a_row,
                                        const float4* v, int npairs, int lane,
                                        float2& acc) {
  for (int p = lane; p < npairs; p += 32) {
    const float4 a = __ldg(a_row + p);  // (re, im) of columns 2p, 2p+1
    const float4 x = v[p];
    acc.x += a.x * x.x - a.y * x.y + a.z * x.z - a.w * x.w;
    acc.y += a.x * x.y + a.y * x.x + a.z * x.w + a.w * x.z;
  }
}

__global__ void __launch_bounds__(kThreads)
band_fwd_kernel(const float2* __restrict__ band, const float2* __restrict__ b,
                float2* __restrict__ y, int64_t rows_total, int64_t nblk, int B,
                int nb) {
  extern __shared__ float4 smem[];
  float2* win = reinterpret_cast<float2*>(smem);  // (B + 1) ring slots of nb
  const int R = 2 * B + 1;
  const int ring = B + 1;
  const int npairs = nb / 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int e = threadIdx.x; e < ring * nb; e += blockDim.x) win[e] = make_float2(0.f, 0.f);
  __syncthreads();

  for (int64_t K = 0; K < rows_total; ++K) {
    const float2* row = band + K * R * nb * nb;
    float2* out = win + (K % ring) * nb;
    for (int i = warp; i < nb; i += nwarps) {
      float2 acc = make_float2(0.f, 0.f);
      for (int t = 0; t < B; ++t) {
        // y_{K-B+t} sits in ring slot (K + 1 + t) mod (B + 1)
        const float4* v = reinterpret_cast<const float4*>(win + ((K + 1 + t) % ring) * nb);
        row_dot(reinterpret_cast<const float4*>(row + (int64_t)(t * nb + i) * nb), v,
                npairs, lane, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const float2 bk = K < nblk ? b[K * nb + i] : make_float2(0.f, 0.f);
        const float2 yk = make_float2(bk.x - acc.x, bk.y - acc.y);
        out[i] = yk;  // the slot of y_{K-B-1}, which this step does not read
        y[K * nb + i] = yk;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
band_bwd_kernel(const float2* __restrict__ band, const float2* __restrict__ dinv,
                const float2* __restrict__ y, float2* __restrict__ x,
                int64_t rows_total, int64_t nblk, int B, int nb) {
  extern __shared__ float4 smem[];
  float2* win = reinterpret_cast<float2*>(smem);  // (B + 1) ring slots of nb
  float2* z = win + (B + 1) * nb;                 // y_K - U x, one block
  const int R = 2 * B + 1;
  const int ring = B + 1;
  const int npairs = nb / 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int e = threadIdx.x; e < ring * nb; e += blockDim.x) win[e] = make_float2(0.f, 0.f);
  __syncthreads();

  for (int64_t K = rows_total - 1; K >= 0; --K) {
    const float2* row = band + (K * R + B + 1) * nb * nb;
    for (int i = warp; i < nb; i += nwarps) {
      float2 acc = make_float2(0.f, 0.f);
      for (int t = 0; t < B; ++t) {
        // x_{K+1+t} sits in ring slot (K + 1 + t) mod (B + 1)
        const float4* v = reinterpret_cast<const float4*>(win + ((K + 1 + t) % ring) * nb);
        row_dot(reinterpret_cast<const float4*>(row + (int64_t)(t * nb + i) * nb), v,
                npairs, lane, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const float2 yk = y[K * nb + i];
        z[i] = make_float2(yk.x - acc.x, yk.y - acc.y);
      }
    }
    __syncthreads();
    float2* out = win + (K % ring) * nb;  // the slot of x_{K+B+1}, not read now
    if (K < nblk) {
      const float4* v = reinterpret_cast<const float4*>(z);
      for (int i = warp; i < nb; i += nwarps) {
        float2 acc = make_float2(0.f, 0.f);
        row_dot(reinterpret_cast<const float4*>(dinv + (K * nb + i) * nb), v, npairs,
                lane, acc);
        acc = warp_sum(acc);
        if (lane == 0) {
          out[i] = acc;
          x[K * nb + i] = acc;
        }
      }
    } else {
      for (int i = threadIdx.x; i < nb; i += blockDim.x) out[i] = z[i];  // Dinv = I
    }
    __syncthreads();
  }
}

int launch_config(const void* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  }
  return 0;
}

}  // namespace

extern "C" int band_fwd(const void* band, const void* b, void* y, int64_t rows_total,
                        int64_t nblk, int B, int nb, void* stream) {
  const size_t smem = (size_t)(B + 1) * nb * sizeof(float2);
  int err = launch_config((const void*)band_fwd_kernel, smem);
  if (err) return err;
  band_fwd_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)band, (const float2*)b, (float2*)y, rows_total, nblk, B, nb);
  return (int)cudaGetLastError();
}

extern "C" int band_bwd(const void* band, const void* dinv, const void* y, void* x,
                        int64_t rows_total, int64_t nblk, int B, int nb, void* stream) {
  const size_t smem = (size_t)(B + 2) * nb * sizeof(float2);
  int err = launch_config((const void*)band_bwd_kernel, smem);
  if (err) return err;
  band_bwd_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)band, (const float2*)dinv, (const float2*)y, (float2*)x, rows_total,
      nblk, B, nb);
  return (int)cudaGetLastError();
}
