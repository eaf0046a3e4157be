// Sparse push-sum mix over receiver-side neighbor lists:
//
//     Y[i] = sum_l wgt[i, l] * X[idx[i, l]]      l = 0 .. k_max - 1
//
// accumulated in f32, one slot at a time in slot order, and stored in the
// bank dtype.  Pad slots carry weight 0 and add exactly 0.
//
// Replaces the TPU kernel src/repro/kernels/gossip_gather.py
// (gossip_gather_pallas, _kernel).  The slot order is the reference's own
// (acc = w_0 x_0, then acc += w_l x_l), and every multiply and add is an
// explicit round-to-nearest intrinsic so nvcc contracts nothing into an
// FMA: the result is bit for bit the slot loop of the plain version.
//
// Bound: bytes.  Each output element reads k_max input elements and does
// 2 k_max flops, well under the card's balance point.  One block owns one
// (receiver row, D chunk) pair: it stages its row's indices and weights in
// shared memory, then each thread walks the slot loop for its elements of
// the chunk, with neighbouring threads on neighbouring columns so every
// row read is coalesced.  The 1-D grid runs all receiver rows of one D
// chunk back to back, so the chunk of X (n rows by CHUNK columns) is read
// from device memory about once and served from L2 to the other readers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int CHUNK = THREADS * PER_THREAD;  // columns per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gossip_gather_kernel(const int32_t* __restrict__ idx, const float* __restrict__ wgt,
                     const T* __restrict__ X, T* __restrict__ Y, int64_t n,
                     int64_t k_max, int64_t D) {
  extern __shared__ unsigned char smem[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem);
  float* s_wgt = reinterpret_cast<float*>(smem + k_max * sizeof(int32_t));

  const int64_t row = blockIdx.x % n;
  const int64_t c0 = (blockIdx.x / n) * CHUNK;
  for (int64_t l = threadIdx.x; l < k_max; l += THREADS) {
    s_idx[l] = idx[row * k_max + l];
    s_wgt[l] = wgt[row * k_max + l];
  }
  __syncthreads();

  int64_t col[PER_THREAD];
  float acc[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    col[j] = c0 + threadIdx.x + (int64_t)j * THREADS;
    acc[j] = 0.0f;
  }
  for (int64_t l = 0; l < k_max; ++l) {
    const T* src = X + (int64_t)s_idx[l] * D;
    const float wl = s_wgt[l];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      if (col[j] < D) {
        const float term = __fmul_rn(wl, to_f32(src[col[j]]));
        acc[j] = (l == 0) ? term : __fadd_rn(acc[j], term);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    if (col[j] < D) Y[row * D + col[j]] = from_f32<T>(acc[j]);
}

template <typename T>
int launch(const void* idx, const void* wgt, const void* X, void* Y, int64_t n,
           int64_t k_max, int64_t D, cudaStream_t stream) {
  if (n > 0 && D > 0) {
    if (k_max < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)k_max * (sizeof(int32_t) + sizeof(float));
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(gossip_gather_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int64_t chunks = (D + CHUNK - 1) / CHUNK;
    gossip_gather_kernel<T><<<(unsigned)(n * chunks), THREADS, smem, stream>>>(
        (const int32_t*)idx, (const float*)wgt, (const T*)X, (T*)Y, n, k_max, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 bank, 1 = bfloat16 bank.  idx is int32, wgt float32,
// both (n, k_max) row-major.  Returns a cudaError_t.
extern "C" int gossip_gather_launch(int dtype, const void* idx, const void* wgt,
                                    const void* X, void* Y, int64_t n, int64_t k_max,
                                    int64_t D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(idx, wgt, X, Y, n, k_max, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(idx, wgt, X, Y, n, k_max, D, s);
  return (int)cudaErrorInvalidValue;
}
