// Fused DFedSGPSM inner-loop update over the (n, D) client bank
// (Algorithm 1 lines 9-11 plus the line-5 de-bias of the next step):
//
//     V' = alpha * V + G          (f32 momentum)
//     X' = X - eta * V'           (f32 math, stored in the bank dtype)
//     Z' = X' * (1 / w_row)       (f32 math, stored in the bank dtype)
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py
// (fused_update_bank_pallas, _bank_kernel; the single-row
// fused_update_pallas is the n = 1 case of the same launch).
//
// Bound: bytes.  Each element reads X, V, G and writes X', V', Z' once:
// 24 B per element in f32, 16 B with a bf16 bank, and does 5 flops, far
// below the card's ~20 flop/B balance point.  The design therefore only
// has to stream: the bank is treated as one flat array (rows are
// contiguous), every thread moves one 16-byte vector of the bank dtype
// per iteration of a grid-stride loop, and the row of each element (for
// its 1/w) is found from one division per vector, since a vector crosses
// at most one row boundary when D >= the vector width.  A ragged n*D
// ends in a scalar tail; D below the vector width, or an unaligned
// pointer, takes the scalar kernel.
//
// Rounding: every multiply and add is an explicit round-to-nearest
// intrinsic, so nothing is contracted into an FMA and the result is bit
// for bit that of the unfused PyTorch version (mul, add, mul, sub, mul).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Out3 { float x, v, z; };

__device__ __forceinline__ Out3 update(float x, float v, float g, float alpha,
                                       float eta, float winv) {
  Out3 o;
  o.v = __fadd_rn(__fmul_rn(alpha, v), g);
  o.x = __fsub_rn(x, __fmul_rn(eta, o.v));
  o.z = __fmul_rn(o.x, winv);
  return o;
}

// One element at flat index e: the scalar path (tails, tiny D, unaligned).
template <typename T>
__device__ __forceinline__ void one(const T* X, const float* V, const T* G,
                                    const float* w, T* Xo, float* Vo, T* Zo,
                                    float alpha, float eta, int64_t D, int64_t e) {
  const float winv = 1.0f / w[e / D];
  Out3 o = update(to_f32(X[e]), V[e], to_f32(G[e]), alpha, eta, winv);
  Xo[e] = from_f32<T>(o.x);
  Vo[e] = o.v;
  Zo[e] = from_f32<T>(o.z);
}

template <typename T>
__global__ void fused_update_scalar_kernel(const T* __restrict__ X,
                                           const float* __restrict__ V,
                                           const T* __restrict__ G,
                                           const float* __restrict__ w,
                                           T* __restrict__ Xo, float* __restrict__ Vo,
                                           T* __restrict__ Zo, float alpha, float eta,
                                           int64_t n, int64_t D) {
  const int64_t total = n * D;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x)
    one(X, V, G, w, Xo, Vo, Zo, alpha, eta, D, e);
}

// VEC elements of the bank dtype make one 16-byte vector; V (always f32)
// moves as VEC / 4 float4 vectors alongside.
template <typename T>
__global__ void fused_update_vec_kernel(const T* __restrict__ X,
                                        const float* __restrict__ V,
                                        const T* __restrict__ G,
                                        const float* __restrict__ w,
                                        T* __restrict__ Xo, float* __restrict__ Vo,
                                        T* __restrict__ Zo, float alpha, float eta,
                                        int64_t n, int64_t D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV4 = VEC / 4;
  const int64_t total = n * D;
  const int64_t nvec = total / VEC;
  for (int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; q < nvec;
       q += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e0 = q * VEC;
    const int64_t r0 = e0 / D;
    const int64_t next_row = (r0 + 1) * D;  // first flat index of row r0 + 1
    const float winv0 = 1.0f / w[r0];
    const float winv1 = (next_row < e0 + VEC) ? 1.0f / w[r0 + 1] : winv0;

    alignas(16) T xs[VEC];
    alignas(16) T gs[VEC];
    alignas(16) T xo[VEC];
    alignas(16) T zo[VEC];
    alignas(16) float vs[VEC];
    alignas(16) float vo[VEC];
    *reinterpret_cast<uint4*>(xs) = reinterpret_cast<const uint4*>(X)[q];
    *reinterpret_cast<uint4*>(gs) = reinterpret_cast<const uint4*>(G)[q];
#pragma unroll
    for (int j = 0; j < NV4; ++j)
      reinterpret_cast<float4*>(vs)[j] = reinterpret_cast<const float4*>(V)[q * NV4 + j];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float winv = (e0 + j < next_row) ? winv0 : winv1;
      Out3 o = update(to_f32(xs[j]), vs[j], to_f32(gs[j]), alpha, eta, winv);
      xo[j] = from_f32<T>(o.x);
      vo[j] = o.v;
      zo[j] = from_f32<T>(o.z);
    }
    reinterpret_cast<uint4*>(Xo)[q] = *reinterpret_cast<const uint4*>(xo);
    reinterpret_cast<uint4*>(Zo)[q] = *reinterpret_cast<const uint4*>(zo);
#pragma unroll
    for (int j = 0; j < NV4; ++j)
      reinterpret_cast<float4*>(Vo)[q * NV4 + j] = reinterpret_cast<const float4*>(vo)[j];
  }
  // Ragged tail of the flat array: fewer than VEC elements.
  const int64_t tail = nvec * VEC + blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && tail < total)
    one(X, V, G, w, Xo, Vo, Zo, alpha, eta, D, tail);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int grid_for(int64_t work, int threads) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 16;  // grid-stride beyond 16 blocks per SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
int launch(const void* X, const void* V, const void* G, const void* w, void* Xo,
           void* Vo, void* Zo, float alpha, float eta, int64_t n, int64_t D,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = 256;
  const bool vec = D >= VEC && aligned16(X) && aligned16(V) && aligned16(G) &&
                   aligned16(Xo) && aligned16(Vo) && aligned16(Zo);
  if (n * D > 0) {
    if (vec)
      fused_update_vec_kernel<T><<<grid_for(n * D / VEC, threads), threads, 0, stream>>>(
          (const T*)X, (const float*)V, (const T*)G, (const float*)w, (T*)Xo,
          (float*)Vo, (T*)Zo, alpha, eta, n, D);
    else
      fused_update_scalar_kernel<T><<<grid_for(n * D, threads), threads, 0, stream>>>(
          (const T*)X, (const float*)V, (const T*)G, (const float*)w, (T*)Xo,
          (float*)Vo, (T*)Zo, alpha, eta, n, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 bank, 1 = bfloat16 bank.  Returns a cudaError_t.
extern "C" int fused_update_bank_launch(int dtype, const void* X, const void* V,
                                        const void* G, const void* w, void* Xo,
                                        void* Vo, void* Zo, float alpha, float eta,
                                        int64_t n, int64_t D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(X, V, G, w, Xo, Vo, Zo, alpha, eta, n, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(X, V, G, w, Xo, Vo, Zo, alpha, eta, n, D, s);
  return (int)cudaErrorInvalidValue;
}
