// Flash attention (online softmax) with a causal mask, a sliding window and
// grouped-query heads: o[b,h] = softmax(mask(q[b,h] k[b,g]^T * hd^-0.5)) v[b,g]
// with kv head g = h / (H / KV), computed in f32 and stored in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, _kernel).  It computes the same function: scores
// scaled by hd^-0.5 (q is scaled in f32 before the product, as there),
// masked scores replaced by -1e30, a running max, denominator and f32
// accumulator over key tiles, the denominator clamped at 1e-20.
//
// Bound: operations.  4 hd FLOP per open (query, key) pair against
// (2 q + 2 kv reads + o) hd elements per row, so at S = 2048 the kernel
// does hundreds of FLOP per byte and the card's arithmetic, not its memory,
// is the limit: 989 TFLOP/s on the bf16 tensor cores, 67 TFLOP/s for the
// f32 SIMT arithmetic this first version uses (scores and P.V in f32 FMAs,
// for bf16 and f32 inputs alike, so it equals the plain version up to the
// order of its sums).
//
// Design, for the card rather than block by block from the TPU kernel:
// - One block per (b, h, 64-row query tile); a loop inside the block walks
//   the key tiles and replaces the TPU grid's sequential kj axis.  Blocks
//   are numbered so that the tiles with the most open keys start first.
// - The loop visits only key tiles that the causal and window masks leave
//   at least partly open; the TPU kernel sweeps all of them.  Every row meets
//   an open key in the first tile it visits or in a later one, so a row whose
//   first tiles are closed carries p = 1 on -1e30 scores exactly as the TPU
//   kernel does, and the first open score wipes them (alpha = 0).
// - Q (pre-scaled), the K and V tiles and the warp's probabilities live in
//   shared memory as f32: 211 KB at hd = 256, so the kernel takes dynamic
//   shared memory after cudaFuncSetAttribute and runs one block per SM.
// - Each of the 8 warps owns 8 query rows: a row's max and sum are warp
//   shuffles, and P needs only __syncwarp before P.V.  A lane owns 2 key
//   columns of the score tile and hd / 32 columns of the output rows.
// - K rows are padded by 4 floats so the float4 reads of 8 lanes hit 32
//   distinct banks; Q and P reads are warp-wide broadcasts.
// - The ragged S edge is masked here: keys at or past S are closed (and
//   staged as 0), rows at or past S are computed but not stored.
// - Inputs are read through their (b, h, s) strides with hd contiguous, so a
//   (B, S, H, hd) projection is attended as (B, H, S, hd) without a copy, and
//   GQA reads the shared kv head with no repeat.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BQ = 64, BK = 64, WARPS = 8, THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;  // query rows per warp
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout, in floats.
template <int HD>
struct Layout {
  static constexpr int QS = HD + 4, KS = HD + 4, VS = HD, PS = BK + 4;
  static constexpr int Q = 0, K = Q + BQ * QS, V = K + BK * KS, P = V + BK * VS;
  static constexpr size_t BYTES = sizeof(float) * (P + BQ * PS);
};

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, group, S, n_qt, causal, window;
  float scale;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(Args a) {
  using L = Layout<HD>;
  constexpr int CPL = HD / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::Q;
  float* Ks = smem + L::K;
  float* Vs = smem + L::V;
  float* Ps = smem + L::P;

  const int bh = blockIdx.x % (a.B * a.H);
  const int qt = a.n_qt - 1 - blockIdx.x / (a.B * a.H);  // longest rows first
  const int b = bh / a.H, h = bh % a.H, g = h / a.group;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Stage the query tile, scaled in f32 as the TPU kernel does.
#pragma unroll 4
  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    Qs[r * L::QS + d] = qi < a.S ? to_f32(qb[qi * a.q_ss + d]) * a.scale : 0.0f;
  }

  // Key tiles that the masks leave at least partly open for some row.
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_end = a.causal ? q_last + 1 : a.S;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_begin = k_begin / BK, kt_end = (k_end + BK - 1) / BK;

  float m[ROWS], l[ROWS], acc[ROWS][CPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K, V tile
#pragma unroll 8
    for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, ki = k0 + r;
      const bool in = ki < a.S;
      Ks[r * L::KS + d] = in ? to_f32(kb[ki * a.k_ss + d]) : 0.0f;
      Vs[r * L::VS + d] = in ? to_f32(vb[ki * a.v_ss + d]) : 0.0f;
    }
    __syncthreads();

    // Scores of this warp's rows against key columns lane and lane + 32.
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * L::KS + d);
      const float4 kc = *reinterpret_cast<const float4*>(Ks + (lane + 32) * L::KS + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + r) * L::QS + d);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kc.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kc.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kc.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kc.w, s[r][1]);
      }
    }

    // Mask, then the online softmax update of each row.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ki = k0 + lane + 32 * c;
        bool ok = ki < a.S;
        if (a.causal) ok = ok && ki <= qi;
        if (a.window > 0) ok = ok && (qi - ki < a.window);
        if (!ok) s[r][c] = NEG;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      Ps[(r0 + r) * L::PS + lane] = p0;
      Ps[(r0 + r) * L::PS + lane + 32] = p1;
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();

    // acc += P V over this tile's keys.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        p[r] = *reinterpret_cast<const float4*>(Ps + (r0 + r) * L::PS + kk);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float v0 = Vs[(kk + 0) * L::VS + lane + 32 * j];
        const float v1 = Vs[(kk + 1) * L::VS + lane + 32 * j];
        const float v2 = Vs[(kk + 2) * L::VS + lane + 32 * j];
        const float v3 = Vs[(kk + 3) * L::VS + lane + 32 * j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          acc[r][j] = fmaf(p[r].x, v0, acc[r][j]);
          acc[r][j] = fmaf(p[r].y, v1, acc[r][j]);
          acc[r][j] = fmaf(p[r].z, v2, acc[r][j]);
          acc[r][j] = fmaf(p[r].w, v3, acc[r][j]);
        }
      }
    }
    __syncwarp();  // P of this tile is read before the next tile writes it
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= a.S) continue;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      ob[qi * a.o_ss + lane + 32 * j] = from_f32<T>(acc[r][j] / den);
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Layout<HD>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (int64_t)a.n_qt * a.B * a.H;
  kernel<<<(unsigned)blocks, THREADS, Layout<HD>::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const Args& a, cudaStream_t stream) {
  if (hd == 64) return launch<T, 64>(a, stream);
  if (hd == 128) return launch<T, 128>(a, stream);
  if (hd == 256) return launch<T, 256>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v and o alike.  q and o are
// (B, H, S, hd), k and v (B, KV, S, hd), each given by its (b, head, s)
// element strides with hd contiguous.  hd is 64, 128 or 256; H is a multiple
// of KV.  Returns a cudaError_t.
extern "C" int flash_attention_launch(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    int64_t B, int64_t H, int64_t KV, int64_t S,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int causal, int64_t window, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || window < 0) return (int)cudaErrorInvalidValue;
  const int64_t n_qt = (S + BQ - 1) / BQ;
  if (n_qt * B * H > 0x7fffffff || S > 0x3fffffff) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, (int)B, (int)H, (int)(H / KV), (int)S, (int)n_qt,
         causal ? 1 : 0, (int)(window > S ? S : window),
         (float)(1.0 / std::sqrt((double)hd)),
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_hd<float>(hd, a, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}
