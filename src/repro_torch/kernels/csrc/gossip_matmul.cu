// Dense push-sum mix Y = P @ X over the (n, D) client bank, accumulated in
// f32 and stored in the bank dtype.  P is the (n, n) f32 column-stochastic
// mixing matrix.
//
// Replaces the TPU kernel src/repro/kernels/gossip_matmul.py
// (gossip_matmul_pallas, _kernel).  The reference mixes at
// Precision.HIGHEST, so this is a true f32 product: SIMT FMAs, no TF32
// and no tensor cores.
//
// Bound: for the slice's n = 100 it is operations.  2 n^2 D flops against
// 2 n D elements moved is n / 4 flop per byte in f32 (25 at n = 100),
// just above the card's f32 balance point of 67 TFLOP/s / 3.35 TB/s = 20.
// The design keeps the FMA units fed from shared memory: a block owns a
// BM x BN tile of Y (BM = 128 rows covers every client for n <= 128, so X
// is read from device memory once), walks the n-long reduction in BK-deep
// slabs of P and X staged in shared memory, and each thread keeps an 8 x 8
// register tile of accumulators (64 FMAs per 16 shared-memory loads).
// Larger n loops over row tiles; the 1-D grid runs the row tiles of one
// column panel back to back so the panel is reused from L2.  Ragged n and
// D are masked at the tile edges.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gossip_matmul_kernel(const float* __restrict__ P, const T* __restrict__ X,
                     T* __restrict__ Y, int64_t n, int64_t D, int64_t m_tiles) {
  __shared__ float Ps[BK][BM];  // P slab, transposed: Ps[k][row]
  __shared__ float Xs[BK][BN];  // X slab: Xs[k][col]

  const int64_t m0 = (blockIdx.x % m_tiles) * BM;
  const int64_t d0 = (blockIdx.x / m_tiles) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column lane: cols tx + 16 j
  const int ty = tid / (BN / TN);  // row lane: rows ty + 16 i

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < n; k0 += BK) {
    // Stage P[m0:m0+BM, k0:k0+BK] (transposed) and X[k0:k0+BK, d0:d0+BN].
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int row = idx / BK, k = idx % BK;
      const int64_t gr = m0 + row, gk = k0 + k;
      Ps[k][row] = (gr < n && gk < n) ? P[gr * n + gk] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int k = idx / BN, col = idx % BN;
      const int64_t gk = k0 + k, gc = d0 + col;
      Xs[k][col] = (gk < n && gc < D) ? to_f32(X[gk * D + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Ps[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = m0 + ty + 16 * i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = d0 + tx + 16 * j;
      if (gc < D) Y[gr * D + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* P, const void* X, void* Y, int64_t n, int64_t D,
           cudaStream_t stream) {
  if (n > 0 && D > 0) {
    const int64_t m_tiles = (n + BM - 1) / BM;
    const int64_t d_tiles = (D + BN - 1) / BN;
    gossip_matmul_kernel<T><<<(unsigned)(m_tiles * d_tiles), THREADS, 0, stream>>>(
        (const float*)P, (const T*)X, (T*)Y, n, D, m_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 bank, 1 = bfloat16 bank.  Returns a cudaError_t.
extern "C" int gossip_matmul_launch(int dtype, const void* P, const void* X, void* Y,
                                    int64_t n, int64_t D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(P, X, Y, n, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(P, X, Y, n, D, s);
  return (int)cudaErrorInvalidValue;
}
