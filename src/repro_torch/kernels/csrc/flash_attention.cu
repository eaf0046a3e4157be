// Flash attention (online softmax) with a causal mask, a sliding window and
// grouped-query heads: o[b,h] = softmax(mask(q[b,h] k[b,g]^T * hd^-0.5)) v[b,g]
// with kv head g = h / (H / KV), stored in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, _kernel).  It computes the same function: masked
// scores replaced by -1e30, a running max, denominator and f32 accumulator
// over key tiles, the denominator clamped at 1e-20.
//
// Bound: operations.  4 hd FLOP per open (query, key) pair against
// (2 q + 2 kv reads + o) hd elements per row, so at S = 2048 the kernel does
// hundreds of FLOP per byte: the card's arithmetic, not its memory, is the
// limit, 989 TFLOP/s on the bf16 tensor cores.
//
// bf16 inputs: a warp-specialised tensor-core kernel (namespace tc).
// - Tiles.  One block per (b, h, 128-row query tile).  Blocks are numbered
//   in chunks of 8 (b, h) pairs and, within a chunk, so that the query tiles
//   with the most open keys start first: a chunk's K and V (at most 8 x 2 MB
//   at hd 256) stay in the 50 MB L2 while its blocks run.  Numbering all
//   heads of a query tile together, as the SIMT kernel does, spreads one
//   wave over every head, whose K and V (134 MB at B = 4, S = 2048 and 32 kv
//   heads of hd 128) do not fit in L2.  Three warpgroups: two
//   consumers, each owning 64 query rows, and one producer.  setmaxnreg
//   moves registers from the producer (24 a thread) to the consumers (240),
//   whose f32 output accumulator alone is hd / 2 registers (128 at hd 256).
// - Copies.  The producer's first thread loads the Q tile once and streams
//   64-row K and V tiles through a ring of STAGES slots by TMA; each slot
//   has a full mbarrier (the copies' bytes) and an empty one (one arrival
//   per consumer warp).  The tensor maps are 4-D, (hd, S, heads, B), built
//   on the host from the (b, head, s) strides, so the (B, S, H, hd)
//   projections' transposed views load with no copy and GQA reads the kv
//   head by index.  A box is 64 columns (128 bytes) wide, in the 128-byte
//   swizzle that the wgmma descriptors read; TMA zero-fills rows past S.
//   Shared memory at hd 256: Q 64 KB + 2 stages of K and V (32 KB each) =
//   192 KB; at hd 64, 80 and 128 the ring has 4 stages.
// - hd 80 (hubert-xlarge: 1280 / 16 heads) is no multiple of a 64-column
//   panel.  Its tiles are five 16-column panels (32 bytes a row) in the
//   32-byte swizzle, the largest swizzle whose atom divides 80, loaded by
//   five 16-column TMA boxes: S = Q K^T takes one k16 step a panel (5
//   steps), and O += P V is one m64n80k16 a step, reading V's five panels
//   MN-major.  Every read stays in wgmma's canonical layouts and nothing is
//   padded: Q 20 KB + 4 stages of K and V (10 KB each) = 100 KB.  The other
//   plan, hd 128's two 64-column panels with TMA zero-filling columns
//   80-127, keeps the 128-byte swizzle but needs P.V at n128 (48 of its
//   columns zeros, 1.3x the tensor work of the exact products and 1.6x the
//   shared memory), since an n80 or n16 product cannot read part of a
//   128-byte swizzle atom in the canonical MN-major layout.  The scale is
//   80^-0.5.
// - Products.  S = Q K^T is wgmma m64n64k16 with both operands in shared
//   memory, K-major.  O += P V is wgmma m64n{hd}k16 with P in registers: the
//   f32 score fragment is the A fragment's layout, so P is rounded to bf16
//   and packed in place, never staged; V is read MN-major through the
//   descriptor's transpose bit.  Products of bf16 values are exact and
//   summed in f32, as in the plain version; the one new rounding is P to
//   bf16 before P.V (relative 2^-8 at most), so the output differs from
//   the plain f32 softmax by at most 2^-8 sum_j p_j |v_j| / sum_j p_j, which
//   is under 2^-8 max|v| over the row's open keys (kernels/flash_attention.py
//   states the tolerance).
// - Softmax.  The scale hd^-0.5 is applied to the f32 scores, folded with
//   log2 e into the exponent of ex2 (one FMA a score on interior tiles).  A
//   row's max and sum reduce over the four lanes that hold it; the sum stays
//   per lane until the end; a warp whose rows kept their max skips the
//   rescaling of O.
// - Logsumexp.  Given an lse pointer (training), the epilogue also stores
//   each row's (m c + log2 l) ln 2 in f32, the natural logsumexp of its
//   masked, scaled scores (l sums the unrounded f32 p), which the backward
//   (flash_attention_bwd.cu) reads; serving passes null and stores none.
//   The mbarriers, TMA loads, wgmma wrappers and tensor maps are in
//   hopper.cuh, shared with the backward.
// - Masks.  The block visits only the key tiles that the causal and window
//   masks leave at least partly open for its 128 rows.  Each consumer then
//   sorts a tile for its own 64 rows: closed (no wgmma; it only releases the
//   slot), interior (open for every row: no mask arithmetic) or an edge
//   (the diagonal, the window's far edge, keys past S: masked).  A row whose
//   first tiles are closed to it carries p = 1 on -1e30 scores, and its
//   first open score wipes them (alpha = 0), as in the TPU kernel.  Rows at
//   or past S are computed but not stored.
//
// f32 inputs: the SIMT kernel (namespace simt) at hd 64, 80, 128 and 256,
// 64-row query tiles with Q,
// K, V and P staged in f32 shared memory and f32 FMAs (it stores m + log l
// as the row's logsumexp when asked).  It is the path of
// the f32 parity checks, which hold the kernel to the plain version within
// 2e-5: TF32 tensor cores would round every product to 10 mantissa bits,
// and nothing serves in f32.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

// The f32 SIMT kernel:
// - One block per (b, h, 64-row query tile), numbered so that the tiles with
//   the most open keys start first; a loop inside the block walks the key
//   tiles that the masks leave open.
// - Q (scaled by hd^-0.5 in f32 before the product), the K and V tiles and
//   the warp's probabilities live in shared memory as f32: 211 KB at
//   hd = 256, so one block runs per SM.
// - Each of the 8 warps owns 8 query rows: a row's max and sum are warp
//   shuffles, and P needs only __syncwarp before P.V.  A lane owns 2 key
//   columns of the score tile and output columns lane + 32 j, j <
//   ceil(hd / 32): hd / 32 of them at hd 64, 128 and 256; at hd 80 lanes
//   0-15 own 3 and lanes 16-31 own 2 (the third column, past hd, is
//   neither read from V nor stored).
// - K rows are padded by 4 floats so the float4 reads of 8 lanes hit 32
//   distinct banks; Q and P reads are warp-wide broadcasts.
// - Keys at or past S are closed (and staged as 0); rows at or past S are
//   computed but not stored.
namespace simt {

constexpr int BQ = 64, BK = 64, WARPS = 8, THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;  // query rows per warp
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
  float* lse;  // (B, H, S) or null
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
  constexpr int CPL = (HD + 31) / 32;  // output columns per lane, at most
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
        if (HD % 32 != 0 && lane + 32 * j >= HD) continue;
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
      if (HD % 32 == 0 || lane + 32 * j < HD)
        ob[qi * a.o_ss + lane + 32 * j] = from_f32<T>(acc[r][j] / den);
    if (a.lse != nullptr && lane == 0) a.lse[(int64_t)bh * a.S + qi] = m[r] + logf(l[r]);
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
  if (hd == 80) return launch<T, 80>(a, stream);
  if (hd == 128) return launch<T, 128>(a, stream);
  if (hd == 256) return launch<T, 256>(a, stream);
  return (int)cudaErrorInvalidValue;
}


}  // namespace simt

namespace tc {

using namespace hopper;

constexpr int BQ = 128, BK = 64, CONSUMERS = 2, THREADS = (CONSUMERS + 1) * 128;
constexpr int CHUNK = 8;          // (b, h) pairs whose blocks run together
constexpr float NEG = -1.0e30f;

// Shared memory, in bytes from a 1024-byte aligned base: Q as PANELS panels
// of 128 rows, then STAGES K tiles and STAGES V tiles, each PANELS panels of
// 64 rows, then the mbarriers (Q's, STAGES full, STAGES empty).  A panel is
// COLS columns, SW bytes a row in the SW-byte swizzle (hopper.cuh, Panels).
template <int HD>
struct Plan : Panels<HD> {
  using Panels<HD>::SW;
  using Panels<HD>::PANELS;
  static constexpr int STAGES = HD == 256 ? 2 : 4;
  static constexpr int Q_PANEL = BQ * SW, KV_PANEL = BK * SW;
  static constexpr int Q_BYTES = PANELS * Q_PANEL, KV_BYTES = PANELS * KV_PANEL;
  static constexpr int K = Q_BYTES, V = K + STAGES * KV_BYTES;
  static constexpr int BARS = V + STAGES * KV_BYTES;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

struct Args {
  void* o;
  float* lse;  // (B, H, S) or null
  int B, H, group, S, n_qt, causal, window;
  float scale_log2;  // hd^-0.5 log2(e)
  int64_t o_sb, o_sh, o_ss;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Args a) {
  using P = Plan<HD>;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + P::K, sV = base + P::V;
  const uint32_t bar_q = base + P::BARS;
  const auto full = [&](int st) { return bar_q + 8u * (1 + st); };
  const auto empty = [&](int st) { return bar_q + 8u * (1 + STAGES + st); };

  // Blocks run in chunks of CHUNK (b, h) pairs, the query tiles with the
  // most open keys first within a chunk; the chunk's K and V stay in L2.
  const int n_bh = a.B * a.H, chunk = blockIdx.x / (CHUNK * a.n_qt);
  const int pos = blockIdx.x % (CHUNK * a.n_qt), here = min(CHUNK, n_bh - chunk * CHUNK);
  const int bh = chunk * CHUNK + pos % here;
  const int qt = a.n_qt - 1 - pos / here;
  const int b = bh / a.H, h = bh % a.H, g = h / a.group;
  const int q0 = qt * BQ;
  // Key tiles that the masks leave at least partly open for some row.
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_end = a.causal ? q_last + 1 : a.S;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_begin = k_begin / BK, n_kt = (k_end + BK - 1) / BK - kt_begin;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(bar_q, P::Q_BYTES);
#pragma unroll
      for (int p = 0; p < P::PANELS; ++p)
        tma_load(sQ + p * P::Q_PANEL, &tq, bar_q, p * P::COLS, q0, h, b);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % STAGES, k0 = (kt_begin + i) * BK;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * P::KV_BYTES);
#pragma unroll
        for (int p = 0; p < P::PANELS; ++p) {
          const uint32_t off = st * P::KV_BYTES + p * P::KV_PANEL;
          tma_load(sK + off, &tk, full(st), p * P::COLS, k0, g, b);
          tma_load(sV + off, &tv, full(st), p * P::COLS, k0, g, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows qa .. qa + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = 16 * (t / 32) + lane / 4;  // this thread's rows: row, row + 8
    const int col = 2 * (lane % 4);            // and columns 8 j + col, + 1
    const int qa = q0 + 64 * wg;
    const float c = a.scale_log2;
    float o[HD / 2], s[32] = {};
    uint32_t pa[4][4];
    float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    const uint32_t sQw = sQ + 64 * wg * P::SW;
    mbar_wait(bar_q, 0);

    for (int i = 0; i < n_kt; ++i) {
      const int st = i % STAGES, k0 = (kt_begin + i) * BK;
      const bool closed = k0 >= a.S || (a.causal && k0 > qa + 63) ||
                          (a.window > 0 && qa - (k0 + BK - 1) >= a.window);
      const bool edge = k0 + BK > a.S || (a.causal && k0 + BK - 1 > qa) ||
                        (a.window > 0 && qa + 63 - k0 >= a.window);
      mbar_wait(full(st), (i / STAGES) & 1);
      if (!closed) {
        // S = Q K^T over hd in steps of 16 (32 bytes inside a panel row).
        const uint32_t sKs = sK + st * P::KV_BYTES;
        pin(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % P::STEPS) * 32, p = kk / P::STEPS;
          wgmma_ss_m64n64(s, panel_desc<P::SW>(sQw + p * P::Q_PANEL + off, 16, 8 * P::SW),
                          panel_desc<P::SW>(sKs + p * P::KV_PANEL + off, 16, 8 * P::SW),
                          kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        if (edge) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = qa + row + 8 * (e / 2), ki = k0 + 8 * j + col + (e % 2);
              bool ok = ki < a.S;
              if (a.causal) ok = ok && ki <= qi;
              if (a.window > 0) ok = ok && (qi - ki < a.window);
              if (!ok) s[4 * j + e] = NEG;
            }
        }

        // Online softmax: new row max over the four lanes of a row.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = ex2((m[r] - mx[r]) * c);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
        // p = 2^((s - m) c).  On an edge tile a row that has met no open key
        // yet has m = -1e30 and gets p = 1 on its masked keys, exactly
        // (s - m = 0); an interior tile's scores are all open, so m is a
        // score and one FMA computes the exponent.
        if (edge) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * j + e] = ex2((s[4 * j + e] - mx[e / 2]) * c);
        } else {
          const float mc[2] = {mx[0] * c, mx[1] * c};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -mc[e / 2]));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          l[0] += s[4 * j] + s[4 * j + 1];
          l[1] += s[4 * j + 2] + s[4 * j + 3];
        }
        // P as the A fragment of k-step kk: keys 16 kk .. 16 kk + 15.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            o[4 * j] *= alpha[0];
            o[4 * j + 1] *= alpha[0];
            o[4 * j + 2] *= alpha[1];
            o[4 * j + 3] *= alpha[1];
          }
        }

        // O += P V: 16 keys (16 panel rows) per step, V MN-major with its
        // panels KV_PANEL bytes apart.
        const uint32_t sVs = sV + st * P::KV_BYTES;
        pin(o);
        pin(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n<HD>(o, pa[kk],
                         panel_desc<P::SW>(sVs + kk * 16 * P::SW, P::KV_PANEL, 8 * P::SW));
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
        pin(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // Epilogue: the row sums over their four lanes, then o / max(l, 1e-20)
    // and, when asked, the row's logsumexp in natural-log units:
    // (m c + log2 l) ln 2, l the sum of the unrounded f32 p.
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.0f / fmaxf(l[r], 1e-20f);
      const int qi = qa + row + 8 * r;
      if (qi >= a.S) continue;
      if (a.lse != nullptr && col == 0)
        a.lse[(int64_t)bh * a.S + qi] = (m[r] * c + log2f(l[r])) * 0.69314718055994531f;
      __nv_bfloat16* orow = ob + qi * a.o_ss + col;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}


struct Launch {
  const void *q, *k, *v;
  int64_t KV;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

template <int HD>
int launch(const Launch& L, const Args& a, cudaStream_t stream) {
  constexpr int COLS = Plan<HD>::COLS;
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, L.q, HD, a.S, a.H, a.B, L.q_sb, L.q_sh, L.q_ss, BQ, COLS);
  if (e == 0) e = make_map(&mk, L.k, HD, a.S, L.KV, a.B, L.k_sb, L.k_sh, L.k_ss, BK, COLS);
  if (e == 0) e = make_map(&mv, L.v, HD, a.S, L.KV, a.B, L.v_sb, L.v_sh, L.v_ss, BK, COLS);
  if (e != 0) return e;
  const auto kernel = flash_attention_kernel<HD>;
  cudaError_t r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Plan<HD>::BYTES);
  if (r != cudaSuccess) return (int)r;
  const int64_t blocks = (int64_t)a.n_qt * a.B * a.H;
  kernel<<<(unsigned)blocks, THREADS, Plan<HD>::BYTES, stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

int launch_hd(int hd, const Launch& L, const Args& a, cudaStream_t stream) {
  if (hd == 64) return launch<64>(L, a, stream);
  if (hd == 80) return launch<80>(L, a, stream);
  if (hd == 128) return launch<128>(L, a, stream);
  if (hd == 256) return launch<256>(L, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel), for q, k, v and o alike.  q and o are (B, H, S, hd), k and v
// (B, KV, S, hd), each given by its (b, head, s) element strides with hd
// contiguous; for bf16, q, k and v start on 16 bytes and their strides are
// multiples of 8 elements (TMA).  hd is 64, 80, 128 or 256; H is a multiple of
// KV.  lse, when not null, is a contiguous f32 (B, H, S) that receives each
// row's logsumexp of its masked, scaled scores (natural log), which the
// backward reads.  Returns a cudaError_t.
extern "C" int flash_attention_launch(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t B, int64_t H, int64_t KV, int64_t S,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int causal, int64_t window, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (S > 0x3fffffff) return (int)cudaErrorInvalidValue;
  const int win = (int)(window > S ? S : window);
  const double scale = 1.0 / std::sqrt((double)hd);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const int64_t n_qt = (S + simt::BQ - 1) / simt::BQ;
    if (n_qt * B * H > 0x7fffffff) return (int)cudaErrorInvalidValue;
    simt::Args a{q, k, v, o, static_cast<float*>(lse), (int)B, (int)H, (int)(H / KV), (int)S, (int)n_qt,
                 causal ? 1 : 0, win, (float)scale,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
    return simt::launch_hd<float>(hd, a, s);
  }
  if (dtype == 1) {
    const int64_t n_qt = (S + tc::BQ - 1) / tc::BQ;
    if (n_qt * B * H > 0x7fffffff) return (int)cudaErrorInvalidValue;
    tc::Args a{o, static_cast<float*>(lse), (int)B, (int)H, (int)(H / KV), (int)S, (int)n_qt, causal ? 1 : 0, win,
               (float)(scale * 1.4426950408889634), o_sb, o_sh, o_ss};
    tc::Launch L{q, k, v, KV, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
    return tc::launch_hd(hd, L, a, s);
  }
  return (int)cudaErrorInvalidValue;
}
