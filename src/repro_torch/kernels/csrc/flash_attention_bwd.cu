// The backward of flash attention (csrc/flash_attention.cu): from q, k, v,
// the forward's output o, its logsumexp and the output's gradient dO, the
// gradients
//   dQ = dS K hd^-0.5,  dK = dS^T Q hd^-0.5,  dV = P^T dO,
// with P = exp(q k^T hd^-0.5 - lse) on the pairs that the causal and window
// masks leave open (0 elsewhere), lse each row's logsumexp over its open
// keys, D = rowsum(dO o) and dS = P (dO v^T - D).  Query head h reads kv
// head h / (H / KV); dK and dV of a kv head sum over its group of query
// heads.  Outputs are stored in the inputs' dtype.  No pass uses atomics:
// every output element is written once, from sums in a fixed order, so two
// calls on the same inputs give the same bits.
//
// The TPU package has no Pallas backward: its training path differentiates
// the plain attention (src/repro/models/attention.py, _dot_attn) with JAX.
// This is the gradient of the forward kernel's function
// (src/repro/kernels/flash_attention.py, flash_attention_pallas), which the
// port runs on every training step.
//
// Bound: operations.  The function needs 10 hd FLOP per open (query, key)
// pair (q k^T, dO v^T, P^T dO, dS^T q, dS k) against 8 hd-wide rows of
// bytes per row, so at S = 4096 it is far above the card's 295 FLOP a byte.
// The passes below recompute q k^T and dO v^T once more (14 hd FLOP a pair).
//
// bf16 at every head dim: tensor-core passes (namespace tc), fed by TMA.
// - lse.  The forward kernel stores each row's logsumexp (natural log,
//   f32, (B, H, S)); without it, the SIMT lse pass below computes it.
// - Prep pass (flash_bwd_prep_kernel): one warp a row computes
//   D = rowsum(dO o) in f32 and lse2 = lse log2(e), both stored in f32
//   rows padded to a multiple of 64 (zeros past S), so that a 64-row slice
//   of either is one aligned 256-byte bulk copy.
// - dK / dV pass (tc::flash_bwd_dkdv_kernel, FlashAttention-2's order):
//   one block per (b, kv head, 128-key tile, run of query heads).  Its
//   producer warp loads the K and V tiles once by TMA, then streams the
//   64-row Q and dO tiles of every query head of the run and every query
//   tile open to its keys, with their lse2 and D slices, through a ring of
//   STAGES slots (full and empty mbarriers, as the forward streams K and
//   V).  Two consumer warpgroups own 64 keys each and accumulate dK and dV
//   (hd / 2 + hd / 2 f32 registers a thread: 80 at hd 80) over all of it:
//     S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands in
//     shared memory, K-major); P^T = 2^(S^T c - lse2) with c = hd^-0.5
//     log2(e), masked on edge tiles; dS^T = P^T (dP^T - D);
//     dV += P^T dO and dK += dS^T Q (wgmma m64n{hd}k16, P^T and dS^T
//     rounded to bf16 in registers as the A fragment, the accumulator's
//     layout, dO and Q read MN-major through the descriptor's transpose
//     bit, as the forward reads V).
//   Each value is packed as soon as it is computed, so the f32 S^T and
//   dP^T tiles die while the A fragments fill.  glm4-9b has 2 kv heads: at
//   S = 4096 one block per (kv head, key tile) is 64 blocks for 132 SMs,
//   and the causal mask gives key tile 0 32x the work of the last.  So a
//   group's query heads are split into runs (the least divisor of the group
//   that gives a block per SM: 4 runs of 4 heads, 256 blocks at the
//   training shape; split_for), key tiles are numbered with the most open query
//   tiles first, and each run stores its f32 share of dK and dV, which
//   flash_bwd_group_sum_kernel adds in run order.  A group of one run
//   stores dK and dV directly.
// - dQ pass (tc::flash_bwd_dq_kernel), the forward's structure: one block
//   per (b, h, 128-row query tile), numbered as the forward's; Q and dO
//   loaded once by TMA, K and V streamed through the ring; per consumer
//   warpgroup (64 rows) S = Q K^T and dP = dO V^T (ss), dS = P (dP - D),
//   then dQ += dS K with dS in bf16 registers and K read MN-major.
// - hd 80 (hubert-xlarge: 1280 / 16 heads) is no multiple of a 64-column
//   panel.  As in the forward, every tile is five 16-column panels (32
//   bytes a row) in the 32-byte swizzle, each loaded by its own 16-column
//   TMA box (Panels<HD>).  A k16 step of S^T = K Q^T and dP^T = V dO^T is
//   one K-major panel, sw32_desc(panel, 16, 256); dV += P^T dO, dK += dS^T
//   Q and dQ += dS K read dO, Q and K MN-major across the five panels, one
//   m64n80k16 a k16 step, as the forward's P V reads V.  Shared memory:
//   K and V 40 KB and 4 stages of Q and dO 80 KB (dK / dV); Q and dO 40 KB
//   and 4 stages of K and V 80 KB (dQ).
// - hd 256 (gemma3-12b): a consumer warpgroup cannot own 64 keys over the
//   whole head dim (dK and dV alone would be 256 f32 registers a thread),
//   and 128-key K and V tiles with a 3-stage ring of Q and dO do not fit
//   227 KB at 512 bytes a row.  So both passes keep 64-row tiles (four
//   64-column panels, 32 KB) and split each tile's work two ways between
//   the consumer warpgroups, in two phases:
//     dK / dV pass, one block per (b, kv head, 64-key tile, run of query
//     heads): K and V loaded once (64 KB), Q and dO streamed through 2
//     stages (128 KB).  Warpgroup w computes S^T = K Q^T and dP^T = V dO^T
//     on queries 32 w .. 32 w + 31 (wgmma m64n32k16, both operands in
//     shared memory), forms P^T and dS^T as at hd 128 and stores them in
//     bf16 (the same rounding) into one 64 x 64 panel each, in the
//     128-byte swizzle the wgmma descriptors read; after a proxy fence and
//     a named barrier over the 256 consumer threads, warpgroup w owns hd
//     columns 128 w .. 128 w + 127: dV[:, half] += P^T dO[:, half] and
//     dK[:, half] += dS^T Q[:, half] (m64n128k16, A from shared memory,
//     dO and Q MN-major), 64 + 64 accumulator registers a thread.  The
//     staged panels alternate between 2 buffers over the open tiles, so a
//     warpgroup's stores never meet the other's reads of the tile before
//     and one barrier a tile suffices.  226 KB of shared memory.
//     dQ pass, one block per (b, h, 64-row query tile): Q and dO loaded
//     once, K and V streamed through 2 stages; warpgroup w computes S and
//     dP on keys 32 w .. 32 w + 31, stores dS in bf16, and after the
//     barrier owns dQ[:, 128 w ..] += dS K[:, half].  209 KB.
//   At gemma3-12b's shapes (B = 1, 8 kv heads, S = 2048 or 4096) the
//   64-key tiles give 256 or 512 dK / dV blocks: one run a group, no sum.
//   The alternative, each warpgroup computing the whole tile's S^T and dP^T
//   (or S and dP), twice the score products, and keeping P^T and dS^T (or
//   dS) in registers as the A fragments, as at hd 128, measured 10-12%
//   slower at gemma3-12b's shapes (PERF.md).
// - Masks as the forward's: a block visits only the tiles that the masks
//   leave partly open for one of its rows; each consumer sorts a tile for
//   its 64 rows into closed (no wgmma), interior (no mask arithmetic) or an
//   edge (the diagonal, the window's edge, rows or keys past S: masked
//   pairs get p = 0).
// - Roundings against the plain version (kernels/flash_attention.py,
//   backward_tolerance): products of bf16 values are exact and summed in
//   f32; P^T before P^T dO and dS before dS K and dS^T Q round to bf16
//   (relative 2^-8 each).
//
// f32 inputs (the f32 parity path, hd 64, 80, 128 and 256) run SIMT
// passes, f32 FMAs (every product exact):
// 1. lse and D: the prep pass computes D; without the forward's lse the
//    lse pass computes it first;
// 2. dK, dV: one block per (b, h, key tile) walks the query tiles open to
//    its keys, recomputes P and dS, and accumulates dV = P^T dO and
//    dK = dS^T (q hd^-0.5) in registers; with GQA groups above 1 the block
//    stores its head's share in f32 scratch, and
// 3. the group sum adds each kv head's shares in head order (group 1
//    stores dK and dV directly and skips it);
// 4. dQ: one block per (b, h, query tile) walks the open key tiles and
//    accumulates dS K hd^-0.5.
// Warps own rows of the tile that stays (keys in pass 2, queries in passes
// 1 and 4), lanes own 2 of the 64 columns of the tile that streams through
// shared memory, and ceil(hd / 32) columns of the accumulators (at hd 80
// lanes 0-15 own 3 and lanes 16-31 own 2, as the forward's SIMT kernel;
// the third column, past hd, is neither read nor stored).  Rows read by one
// lane each are padded by 4 floats, so the float4 reads of 8 lanes hit 32
// distinct banks; rows read by the whole warp are broadcasts.  At hd 256
// the tile that stays is 32 rows, so shared memory stays under 227 KB
// (the opt-in attribute is set above 48 KB) and the accumulators in
// registers.  Keys and queries at or past S are masked and staged as 0.
// Tile skipping: a block visits only the tiles that the masks leave at
// least partly open for one of its rows; inside a tile every pair is masked
// exactly, so the skipping changes no value.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int COLS = 64;  // columns of the streamed tile: 2 per lane
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dsum, *dk_part, *dv_part;  // f32 scratch
  int B, H, group, S, causal, window;
  float scale;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
};

__device__ __forceinline__ bool open_pair(const Args& a, int qi, int ki) {
  bool ok = qi < a.S && ki < a.S;
  if (a.causal) ok = ok && ki <= qi;
  if (a.window > 0) ok = ok && (qi - ki < a.window);
  return ok;
}

// Stage rows [r0, r0 + ROWS) of a (S, HD) slice with row stride ss into
// shared memory rows of stride LD, times mul, zero past S.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t ss, int r0, int S,
                                      float mul) {
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, ri = r0 + r;
    dst[r * LD + d] = ri < S ? to_f32(src[(int64_t)ri * ss + d]) * mul : 0.0f;
  }
}

// Dot products of this warp's NR rows (A, broadcast) with the lane's two
// columns (B rows lane and lane + 32, float4 reads): out[r][c].
template <int HD, int NR, int LDA, int LDB>
__device__ __forceinline__ void row_col_dots(const float* A, const float* Bm, int lane,
                                             float (&out)[NR][2]) {
#pragma unroll
  for (int r = 0; r < NR; ++r) out[r][0] = out[r][1] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 b0 = *reinterpret_cast<const float4*>(Bm + lane * LDB + d);
    const float4 b1 = *reinterpret_cast<const float4*>(Bm + (lane + 32) * LDB + d);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(A + r * LDA + d);
      out[r][0] = fmaf(x.x, b0.x, out[r][0]);
      out[r][0] = fmaf(x.y, b0.y, out[r][0]);
      out[r][0] = fmaf(x.z, b0.z, out[r][0]);
      out[r][0] = fmaf(x.w, b0.w, out[r][0]);
      out[r][1] = fmaf(x.x, b1.x, out[r][1]);
      out[r][1] = fmaf(x.y, b1.y, out[r][1]);
      out[r][1] = fmaf(x.z, b1.z, out[r][1]);
      out[r][1] = fmaf(x.w, b1.w, out[r][1]);
    }
  }
}

// Output columns a lane owns: lane + 32 j for j < CPL, at most; at hd 80
// lanes 0-15 own 3 and lanes 16-31 own 2 (the third column, past hd, is
// neither read nor stored), as the forward's SIMT kernel.
template <int HD>
__device__ __forceinline__ bool owns(int lane, int j) {
  return HD % 32 == 0 || lane + 32 * j < HD;
}

// acc[r][j] += sum_c W[r][c] Bm[c][lane + 32 j] over the tile's 64 columns:
// W rows are this warp's (broadcast float4), Bm columns the lane's.
template <int HD, int NR, int LDW, int LDB>
__device__ __forceinline__ void accumulate(const float* W, const float* Bm, int lane,
                                           float (&acc)[NR][(HD + 31) / 32]) {
  constexpr int CPL = (HD + 31) / 32;
#pragma unroll 2
  for (int c = 0; c < COLS; c += 4) {
    float4 w[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) w[r] = *reinterpret_cast<const float4*>(W + r * LDW + c);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (!owns<HD>(lane, j)) continue;
      const float b0 = Bm[(c + 0) * LDB + lane + 32 * j];
      const float b1 = Bm[(c + 1) * LDB + lane + 32 * j];
      const float b2 = Bm[(c + 2) * LDB + lane + 32 * j];
      const float b3 = Bm[(c + 3) * LDB + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        acc[r][j] = fmaf(w[r].x, b0, acc[r][j]);
        acc[r][j] = fmaf(w[r].y, b1, acc[r][j]);
        acc[r][j] = fmaf(w[r].z, b2, acc[r][j]);
        acc[r][j] = fmaf(w[r].w, b3, acc[r][j]);
      }
    }
  }
}

// Key tiles [kt_begin, kt_end) of width COLS at least partly open for some
// query row in [q0, q_last].
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int q_last, int& kt_begin,
                                          int& kt_end) {
  const int k_end = a.causal ? q_last + 1 : a.S;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kt_begin = k_begin / COLS;
  kt_end = (k_end + COLS - 1) / COLS;
}

// ---------------------------------------------------------------------------
// The lse pass, where the caller has no logsumexp from the forward: lse per
// query row.
// ---------------------------------------------------------------------------

template <int HD>
struct StatsLayout {
  static constexpr int BQ = 64, ROWS = BQ / WARPS, LD = HD + 4;
  static constexpr int Q = 0, K = Q + BQ * LD;
  static constexpr size_t BYTES = sizeof(float) * (K + COLS * LD);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_stats_kernel(Args a, int n_qt) {
  using L = StatsLayout<HD>;
  constexpr int ROWS = L::ROWS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::Q;
  float* Ks = smem + L::K;

  const int bh = blockIdx.x % (a.B * a.H);
  const int qt = n_qt - 1 - blockIdx.x / (a.B * a.H);  // longest rows first
  const int b = bh / a.H, h = bh % a.H, g = h / a.group;
  const int q0 = qt * L::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;

  stage<T, HD, L::BQ, L::LD>(Qs, qb, a.q_ss, q0, a.S, a.scale);
  int kt_begin, kt_end;
  key_tiles(a, q0, min(q0 + L::BQ, a.S) - 1, kt_begin, kt_end);

  float m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * COLS;
    __syncthreads();  // every warp is done with the previous K tile
    stage<T, HD, COLS, L::LD>(Ks, kb, a.k_ss, k0, a.S, 1.0f);
    __syncthreads();
    float s[ROWS][2];
    row_col_dots<HD, ROWS, L::LD, L::LD>(Qs + r0 * L::LD, Ks, lane, s);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (!open_pair(a, qi, k0 + lane + 32 * c)) s[r][c] = NEG;
      // As the forward: a row whose first tiles are closed carries p = 1 on
      // -1e30 scores until its first open score wipes them (alpha = 0).
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      l[r] = expf(m[r] - m_new) * l[r] +
             warp_sum(expf(s[r][0] - m_new) + expf(s[r][1] - m_new));
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + r0 + r;
    if (lane == 0 && qi < a.S) a.lse[(int64_t)bh * a.S + qi] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// SIMT pass: dK and dV of one query head's share, per key tile.
// ---------------------------------------------------------------------------

template <int HD>
struct KVLayout {
  static constexpr int BN = HD == 256 ? 32 : 64, ROWS = BN / WARPS;
  static constexpr int LD = HD + 4, LDP = COLS + 4;
  static constexpr int K = 0, V = K + BN * LD, Q = V + BN * LD, DO = Q + COLS * LD;
  static constexpr int P = DO + COLS * LD, DS = P + BN * LDP, LSE = DS + BN * LDP;
  static constexpr int DSUM = LSE + COLS;
  static constexpr size_t BYTES = sizeof(float) * (DSUM + COLS);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(Args a, int n_kt) {
  using L = KVLayout<HD>;
  constexpr int ROWS = L::ROWS, CPL = (HD + 31) / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float *Ks = smem + L::K, *Vs = smem + L::V, *Qs = smem + L::Q, *DOs = smem + L::DO;
  float *Ps = smem + L::P, *DSs = smem + L::DS, *lse = smem + L::LSE, *dsum = smem + L::DSUM;

  const int bh = blockIdx.x % (a.B * a.H);
  const int kt = blockIdx.x / (a.B * a.H);  // causal: the most open queries first
  const int b = bh / a.H, h = bh % a.H, g = h / a.group;
  const int k0 = kt * L::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  const T* db = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse_b = a.lse + (int64_t)bh * a.S;
  const float* dsum_b = a.dsum + (int64_t)bh * a.S;

  stage<T, HD, L::BN, L::LD>(Ks, kb, a.k_ss, k0, a.S, 1.0f);
  stage<T, HD, L::BN, L::LD>(Vs, vb, a.v_ss, k0, a.S, 1.0f);

  // Query tiles at least partly open for one of the keys [k0, k_last].
  const int k_last = min(k0 + L::BN, a.S) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window > 0 ? min(a.S, k_last + a.window) : a.S;
  const int qt_begin = q_begin / COLS, qt_end = (q_end + COLS - 1) / COLS;

  float dk[ROWS][CPL], dv[ROWS][CPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) dk[r][j] = dv[r][j] = 0.0f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * COLS;
    __syncthreads();  // every warp is done with the previous query tile
    stage<T, HD, COLS, L::LD>(Qs, qb, a.q_ss, q0, a.S, a.scale);
    stage<T, HD, COLS, L::LD>(DOs, db, a.do_ss, q0, a.S, 1.0f);
    if (threadIdx.x < COLS) {
      const int qi = q0 + threadIdx.x;
      lse[threadIdx.x] = qi < a.S ? lse_b[qi] : 0.0f;
      dsum[threadIdx.x] = qi < a.S ? dsum_b[qi] : 0.0f;
    }
    __syncthreads();
    float s[ROWS][2], dp[ROWS][2];
    row_col_dots<HD, ROWS, L::LD, L::LD>(Ks + r0 * L::LD, Qs, lane, s);
    row_col_dots<HD, ROWS, L::LD, L::LD>(Vs + r0 * L::LD, DOs, lane, dp);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int ki = k0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const float p = open_pair(a, q0 + col, ki) ? expf(s[r][c] - lse[col]) : 0.0f;
        Ps[(r0 + r) * L::LDP + col] = p;
        DSs[(r0 + r) * L::LDP + col] = p * (dp[r][c] - dsum[col]);
      }
    }
    __syncwarp();
    accumulate<HD, ROWS, L::LDP, L::LD>(Ps + r0 * L::LDP, DOs, lane, dv);
    accumulate<HD, ROWS, L::LDP, L::LD>(DSs + r0 * L::LDP, Qs, lane, dk);
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int ki = k0 + r0 + r;
    if (ki >= a.S) continue;
    if (a.group == 1) {  // the head's share is the whole gradient
      T* dkb = static_cast<T*>(a.dk) + b * a.dk_sb + g * a.dk_sh + (int64_t)ki * a.dk_ss;
      T* dvb = static_cast<T*>(a.dv) + b * a.dv_sb + g * a.dv_sh + (int64_t)ki * a.dv_ss;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (!owns<HD>(lane, j)) continue;
        dkb[lane + 32 * j] = from_f32<T>(dk[r][j]);
        dvb[lane + 32 * j] = from_f32<T>(dv[r][j]);
      }
    } else {
      const int64_t off = ((int64_t)bh * a.S + ki) * HD;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (!owns<HD>(lane, j)) continue;
        a.dk_part[off + lane + 32 * j] = dk[r][j];
        a.dv_part[off + lane + 32 * j] = dv[r][j];
      }
    }
  }
}

// dK and dV of each kv head = the sum of its `shares` f32 shares
// (B, KV, shares, S, hd), in share order: the SIMT passes' query heads, or
// the tensor-core pass's runs of heads.
template <typename T>
__global__ void flash_bwd_group_sum_kernel(Args a, int hd, int shares) {
  const int KV = a.H / a.group;
  const int64_t total = (int64_t)a.B * KV * a.S * hd;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int d = (int)(i % hd);
    const int64_t row = i / hd;
    const int s = (int)(row % a.S);
    const int bg = (int)(row / a.S), b = bg / KV, g = bg % KV;
    float sk = 0.0f, sv = 0.0f;
    for (int hh = 0; hh < shares; ++hh) {
      const int64_t off = (((int64_t)bg * shares + hh) * a.S + s) * hd + d;
      sk += a.dk_part[off];
      sv += a.dv_part[off];
    }
    static_cast<T*>(a.dk)[b * a.dk_sb + g * a.dk_sh + (int64_t)s * a.dk_ss + d] = from_f32<T>(sk);
    static_cast<T*>(a.dv)[b * a.dv_sb + g * a.dv_sh + (int64_t)s * a.dv_ss + d] = from_f32<T>(sv);
  }
}

// ---------------------------------------------------------------------------
// SIMT pass: dQ per query tile.
// ---------------------------------------------------------------------------

template <int HD>
struct QLayout {
  static constexpr int BQ = HD == 256 ? 32 : 64, ROWS = BQ / WARPS;
  static constexpr int LD = HD + 4, LDP = COLS + 4;
  static constexpr int Q = 0, DO = Q + BQ * LD, K = DO + BQ * LD, V = K + COLS * LD;
  static constexpr int DS = V + COLS * LD;
  static constexpr size_t BYTES = sizeof(float) * (DS + BQ * LDP);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(Args a, int n_qt) {
  using L = QLayout<HD>;
  constexpr int ROWS = L::ROWS, CPL = (HD + 31) / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float *Qs = smem + L::Q, *DOs = smem + L::DO, *Ks = smem + L::K, *Vs = smem + L::V;
  float* DSs = smem + L::DS;

  const int bh = blockIdx.x % (a.B * a.H);
  const int qt = n_qt - 1 - blockIdx.x / (a.B * a.H);  // longest rows first
  const int b = bh / a.H, h = bh % a.H, g = h / a.group;
  const int q0 = qt * L::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  const T* db = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;

  stage<T, HD, L::BQ, L::LD>(Qs, qb, a.q_ss, q0, a.S, a.scale);
  stage<T, HD, L::BQ, L::LD>(DOs, db, a.do_ss, q0, a.S, 1.0f);
  float lse[ROWS], dsum[ROWS], acc[ROWS][CPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + r0 + r;
    lse[r] = qi < a.S ? a.lse[(int64_t)bh * a.S + qi] : 0.0f;
    dsum[r] = qi < a.S ? a.dsum[(int64_t)bh * a.S + qi] : 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.0f;
  }
  int kt_begin, kt_end;
  key_tiles(a, q0, min(q0 + L::BQ, a.S) - 1, kt_begin, kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * COLS;
    __syncthreads();  // every warp is done with the previous K, V tile
    stage<T, HD, COLS, L::LD>(Ks, kb, a.k_ss, k0, a.S, 1.0f);
    stage<T, HD, COLS, L::LD>(Vs, vb, a.v_ss, k0, a.S, 1.0f);
    __syncthreads();
    float s[ROWS][2], dp[ROWS][2];
    row_col_dots<HD, ROWS, L::LD, L::LD>(Qs + r0 * L::LD, Ks, lane, s);
    row_col_dots<HD, ROWS, L::LD, L::LD>(DOs + r0 * L::LD, Vs, lane, dp);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const float p = open_pair(a, qi, k0 + col) ? expf(s[r][c] - lse[r]) : 0.0f;
        DSs[(r0 + r) * L::LDP + col] = p * (dp[r][c] - dsum[r]);
      }
    }
    __syncwarp();
    accumulate<HD, ROWS, L::LDP, L::LD>(DSs + r0 * L::LDP, Ks, lane, acc);
    __syncwarp();  // dS of this tile is read before the next tile writes it
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= a.S) continue;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (owns<HD>(lane, j))
        dqb[(int64_t)qi * a.dq_ss + lane + 32 * j] = from_f32<T>(acc[r][j] * a.scale);
  }
}


// ---------------------------------------------------------------------------
// The prep pass: D = rowsum(dO o) per query row, one warp a row, into rows
// of `ld` floats (zeros past S); with lse2 not null also lse log2(e).
// ---------------------------------------------------------------------------

struct PrepArgs {
  const void *o, *dout;
  const float* lse;  // (B, H, S), read when lse2 is not null
  float *dsum, *lse2;
  int B, H, S, ld, hd;
  int64_t o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_prep_kernel(PrepArgs a) {
  const int64_t w = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (int64_t)a.B * a.H * a.ld) return;
  const int bh = (int)(w / a.ld), qi = (int)(w % a.ld);
  const int b = bh / a.H, h = bh % a.H;
  float part = 0.0f;
  if (qi < a.S) {
    const T* orow = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh + (int64_t)qi * a.o_ss;
    const T* drow =
        static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh + (int64_t)qi * a.do_ss;
    for (int d = lane; d < a.hd; d += 32) part = fmaf(to_f32(drow[d]), to_f32(orow[d]), part);
  }
  part = warp_sum(part);
  if (lane == 0) {
    a.dsum[w] = qi < a.S ? part : 0.0f;
    if (a.lse2 != nullptr)
      a.lse2[w] = qi < a.S ? a.lse[(int64_t)bh * a.S + qi] * 1.4426950408889634f : 0.0f;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The group sum of each kv head's `shares` f32 shares of dK and dV.
template <typename T>
int group_sum(const Args& a, int hd, int shares, cudaStream_t stream) {
  const int64_t total = (int64_t)a.B * (a.H / a.group) * a.S * hd;
  const int64_t blocks = (total + 255) / 256;
  const unsigned grid = (unsigned)(blocks < (1 << 21) ? blocks : (1 << 21));
  flash_bwd_group_sum_kernel<T><<<grid, 256, 0, stream>>>(a, hd, shares);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_stats(const Args& a, cudaStream_t stream, int* launched) {
  const int n_qt = (a.S + StatsLayout<HD>::BQ - 1) / StatsLayout<HD>::BQ;
  if ((int64_t)a.B * a.H * n_qt > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_bwd_stats_kernel<T, HD>, StatsLayout<HD>::BYTES);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_stats_kernel<T, HD><<<(unsigned)((int64_t)a.B * a.H * n_qt), THREADS,
                                  StatsLayout<HD>::BYTES, stream>>>(a, n_qt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++*launched;
  return 0;
}

template <typename T>
int launch_stats_hd(int hd, const Args& a, cudaStream_t stream, int* launched) {
  if (hd == 64) return launch_stats<T, 64>(a, stream, launched);
  if (hd == 80) return launch_stats<T, 80>(a, stream, launched);
  if (hd == 128) return launch_stats<T, 128>(a, stream, launched);
  if (hd == 256) return launch_stats<T, 256>(a, stream, launched);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_prep(const PrepArgs& p, cudaStream_t stream, int* launched) {
  const int64_t rows = (int64_t)p.B * p.H * p.ld;
  const int64_t blocks = (rows * 32 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_bwd_prep_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  return 0;
}


// ---------------------------------------------------------------------------
// The tensor-core passes (bf16): hd 64, 80 and 128, then hd 256.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;


constexpr int CONSUMERS = 2, THREADS = (CONSUMERS + 1) * 128;
constexpr int BM = 64;              // rows of a consumer warpgroup and of a streamed tile
constexpr int BT = CONSUMERS * BM;  // rows of the tile a block keeps: 128
constexpr int CHUNK = 8;            // dQ: (b, h) pairs whose blocks run together

struct Params {
  const float *lse2, *dsum;  // (B, H, S_pad) f32, zeros past S
  void *dq, *dk, *dv;
  float *dk_part, *dv_part;  // (B, KV, split, S, hd) f32 when split > 1
  int B, H, KV, group, S, S_pad, causal, window, split, n_kt, n_qt;
  float scale, scale_log2;  // hd^-0.5 and hd^-0.5 log2(e)
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
};

// dK / dV shared memory, in bytes from a 1024-byte aligned base: K and V as
// PANELS panels of 128 rows each; STAGES Q tiles and STAGES dO tiles of
// PANELS panels of 64 rows; STAGES (lse2, D) slices of 64 floats each;
// the mbarriers (K and V's, STAGES full, STAGES empty).
template <int HD>
struct KVPlan : Panels<HD> {
  using Panels<HD>::SW;
  using Panels<HD>::PANELS;
  static constexpr int STAGES = HD == 128 ? 3 : 4;
  static constexpr int KV_PANEL = BT * SW, T_PANEL = BM * SW;
  static constexpr int KV_BYTES = PANELS * KV_PANEL, T_BYTES = PANELS * T_PANEL;
  static constexpr int K = 0, V = KV_BYTES, Q = 2 * KV_BYTES, DO = Q + STAGES * T_BYTES;
  static constexpr int VEC = DO + STAGES * T_BYTES, VEC_BYTES = 2 * BM * 4;
  static constexpr int BARS = VEC + STAGES * VEC_BYTES;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

// Whether the 64 x 64 block of keys [ka, ka + 63] and queries [qa, qa + 63]
// is closed to every pair, or has a masked pair (an edge).
__device__ __forceinline__ bool block_closed(const Params& a, int qa, int ka) {
  return ka >= a.S || (a.causal && qa + BM - 1 < ka) ||
         (a.window > 0 && qa - (ka + BM - 1) >= a.window);
}
__device__ __forceinline__ bool block_edge(const Params& a, int qa, int ka) {
  return ka + BM > a.S || qa + BM > a.S || (a.causal && ka + BM - 1 > qa) ||
         (a.window > 0 && qa + BM - 1 - ka >= a.window);
}
__device__ __forceinline__ bool pair_open(const Params& a, int qi, int ki) {
  bool ok = qi < a.S && ki < a.S;
  if (a.causal) ok = ok && ki <= qi;
  if (a.window > 0) ok = ok && (qi - ki < a.window);
  return ok;
}

template <int HD>
__device__ __forceinline__ void store_bf16_rows(void* out, int64_t sb, int64_t sh, int64_t ss,
                                                int b, int head, int r0, int S, int row,
                                                int col, const float (&acc)[HD / 2],
                                                float mul) {
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(out) + b * sb + head * sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ri = r0 + row + 8 * r;
    if (ri >= S) continue;
    __nv_bfloat16* orow = base + ri * ss + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const Params a) {
  using P = KVPlan<HD>;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + P::K, sV = base + P::V, sQ = base + P::Q, sDO = base + P::DO;
  const float* vec = reinterpret_cast<const float*>(smem_raw + (base - raw) + P::VEC);
  const uint32_t bar_kv = base + P::BARS;
  const auto full = [&](int st) { return bar_kv + 8u * (1 + st); };
  const auto empty = [&](int st) { return bar_kv + 8u * (1 + STAGES + st); };

  // Key tiles in order of open query tiles (the causal mask opens the most
  // to key tile 0); within one, every (b, kv head, run of heads).
  const int per_kt = a.B * a.KV * a.split;
  const int kt = blockIdx.x / per_kt, rest = blockIdx.x % per_kt;
  const int sp = rest % a.split, bg = rest / a.split;
  const int b = bg / a.KV, g = bg % a.KV;
  const int heads = a.group / a.split, h0 = g * a.group + sp * heads;
  const int k0 = kt * BT;
  // Query tiles at least partly open for one of the keys [k0, k_last].
  const int k_last = min(k0 + BT, a.S) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window > 0 ? min(a.S, k_last + a.window) : a.S;
  const int qt_begin = q_begin / BM, n_qt = (q_end + BM - 1) / BM - qt_begin;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
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
      mbar_expect_tx(bar_kv, 2 * P::KV_BYTES);
#pragma unroll
      for (int p = 0; p < P::PANELS; ++p) {
        tma_load(sK + p * P::KV_PANEL, &tk, bar_kv, p * P::COLS, k0, g, b);
        tma_load(sV + p * P::KV_PANEL, &tv, bar_kv, p * P::COLS, k0, g, b);
      }
      int i = 0;
      for (int hh = 0; hh < heads; ++hh) {
        const int h = h0 + hh;
        for (int t = 0; t < n_qt; ++t, ++i) {
          const int st = i % STAGES, q0 = (qt_begin + t) * BM;
          mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * P::T_BYTES + P::VEC_BYTES);
#pragma unroll
          for (int p = 0; p < P::PANELS; ++p) {
            const uint32_t off = st * P::T_BYTES + p * P::T_PANEL;
            tma_load(sQ + off, &tq, full(st), p * P::COLS, q0, h, b);
            tma_load(sDO + off, &tdo, full(st), p * P::COLS, q0, h, b);
          }
          const int64_t row = ((int64_t)b * a.H + h) * a.S_pad + q0;
          const uint32_t sv = base + P::VEC + st * P::VEC_BYTES;
          bulk_load(sv, a.lse2 + row, BM * 4, full(st));
          bulk_load(sv + BM * 4, a.dsum + row, BM * 4, full(st));
        }
      }
    }
  } else {
    // Consumer warpgroup wg: keys ka .. ka + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = 16 * (t / 32) + lane / 4;  // this thread's keys: row, row + 8
    const int col = 2 * (lane % 4);            // and queries 8 j + col, + 1
    const int ka = k0 + BM * wg;
    const float c = a.scale_log2;
    float dk[HD / 2], dv[HD / 2], s[32], dp[32];
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.0f;
    const uint32_t sKw = sK + BM * wg * P::SW, sVw = sV + BM * wg * P::SW;
    mbar_wait(bar_kv, 0);

    int i = 0;
    for (int hh = 0; hh < heads; ++hh) {
      for (int tt = 0; tt < n_qt; ++tt, ++i) {
        const int st = i % STAGES, q0 = (qt_begin + tt) * BM;
        const bool closed = block_closed(a, q0, ka), edge = block_edge(a, q0, ka);
        mbar_wait(full(st), (i / STAGES) & 1);
        if (!closed) {
          // S^T = K Q^T and dP^T = V dO^T over hd in steps of 16.
          const uint32_t sQs = sQ + st * P::T_BYTES, sDOs = sDO + st * P::T_BYTES;
          pin(s);
          pin(dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk % P::STEPS) * 32, p = kk / P::STEPS;
            wgmma_ss_m64n64(s, panel_desc<P::SW>(sKw + p * P::KV_PANEL + off, 16, 8 * P::SW),
                            panel_desc<P::SW>(sQs + p * P::T_PANEL + off, 16, 8 * P::SW),
                            kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk % P::STEPS) * 32, p = kk / P::STEPS;
            wgmma_ss_m64n64(dp, panel_desc<P::SW>(sVw + p * P::KV_PANEL + off, 16, 8 * P::SW),
                            panel_desc<P::SW>(sDOs + p * P::T_PANEL + off, 16, 8 * P::SW),
                            kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          pin(s);
          pin(dp);

          // P^T and dS^T, element (key ka + row + 8 (e / 2), query
          // q0 + 8 j + col + e % 2), packed as the A fragment of k-step
          // kk (queries 16 kk .. 16 kk + 15) as soon as computed.
          const float* lse2 = vec + st * (2 * BM);
          const float* dsum = lse2 + BM;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float pv[8], dv8[8];
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              const int j = 2 * kk + x / 4, e = x % 4, qc = 8 * j + col + (e % 2);
              float p = ex2(fmaf(s[4 * j + e], c, -lse2[qc]));
              if (edge && !pair_open(a, q0 + qc, ka + row + 8 * (e / 2))) p = 0.0f;
              pv[x] = p;
              dv8[x] = p * (dp[4 * j + e] - dsum[qc]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              pa[kk][r] = pack_bf16(pv[2 * r], pv[2 * r + 1]);
              da[kk][r] = pack_bf16(dv8[2 * r], dv8[2 * r + 1]);
            }
          }

          // dV += P^T dO and dK += dS^T Q: 16 queries (16 panel rows) per
          // step, dO and Q MN-major with their panels T_PANEL bytes apart.
          pin(dv);
          pin(dk);
          pin(pa);
          pin(da);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n<HD>(dv, pa[kk],
                           panel_desc<P::SW>(sDOs + kk * 16 * P::SW, P::T_PANEL, 8 * P::SW));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n<HD>(dk, da[kk],
                           panel_desc<P::SW>(sQs + kk * 16 * P::SW, P::T_PANEL, 8 * P::SW));
          wgmma_commit();
          wgmma_wait_all();
          pin(dv);
          pin(dk);
          pin(pa);
          pin(da);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
    }

    // Epilogue: dK hd^-0.5 and dV, in bf16 for a group of one run, else
    // this run's f32 share.
    if (a.split == 1) {
      store_bf16_rows<HD>(a.dk, a.dk_sb, a.dk_sh, a.dk_ss, b, g, ka, a.S, row, col, dk, a.scale);
      store_bf16_rows<HD>(a.dv, a.dv_sb, a.dv_sh, a.dv_ss, b, g, ka, a.S, row, col, dv, 1.0f);
    } else {
      const int64_t share = ((int64_t)bg * a.split + sp) * a.S;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ki = ka + row + 8 * r;
        if (ki >= a.S) continue;
        float* pk = a.dk_part + (share + ki) * HD + col;
        float* pv = a.dv_part + (share + ki) * HD + col;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          *reinterpret_cast<float2*>(pk + 8 * j) =
              make_float2(dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
          *reinterpret_cast<float2*>(pv + 8 * j) =
              make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// dQ shared memory, in bytes from a 1024-byte aligned base: Q and dO as
// PANELS panels of 128 rows each, then STAGES K tiles and STAGES V tiles
// of PANELS panels of 64 rows, then the mbarriers (Q and dO's, STAGES
// full, STAGES empty).
template <int HD>
struct QPlan : Panels<HD> {
  using Panels<HD>::SW;
  using Panels<HD>::PANELS;
  static constexpr int STAGES = 4;
  static constexpr int Q_PANEL = BT * SW, KV_PANEL = BM * SW;
  static constexpr int Q_BYTES = PANELS * Q_PANEL, KV_BYTES = PANELS * KV_PANEL;
  static constexpr int Q = 0, DO = Q_BYTES, K = 2 * Q_BYTES, V = K + STAGES * KV_BYTES;
  static constexpr int BARS = V + STAGES * KV_BYTES;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const Params a) {
  using P = QPlan<HD>;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + P::Q, sDO = base + P::DO, sK = base + P::K, sV = base + P::V;
  const uint32_t bar_q = base + P::BARS;
  const auto full = [&](int st) { return bar_q + 8u * (1 + st); };
  const auto empty = [&](int st) { return bar_q + 8u * (1 + STAGES + st); };

  // Numbered as the forward: chunks of CHUNK (b, h) pairs, the query tiles
  // with the most open keys first within a chunk.
  const int n_bh = a.B * a.H, chunk = blockIdx.x / (CHUNK * a.n_qt);
  const int pos = blockIdx.x % (CHUNK * a.n_qt), here = min(CHUNK, n_bh - chunk * CHUNK);
  const int bh = chunk * CHUNK + pos % here;
  const int qt = a.n_qt - 1 - pos / here;
  const int b = bh / a.H, h = bh % a.H, g = h / a.group;
  const int q0 = qt * BT;
  // Key tiles that the masks leave at least partly open for some row.
  const int q_last = min(q0 + BT, a.S) - 1;
  const int k_end = a.causal ? q_last + 1 : a.S;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_begin = k_begin / BM, n_kt = (k_end + BM - 1) / BM - kt_begin;

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(bar_q, 2 * P::Q_BYTES);
#pragma unroll
      for (int p = 0; p < P::PANELS; ++p) {
        tma_load(sQ + p * P::Q_PANEL, &tq, bar_q, p * P::COLS, q0, h, b);
        tma_load(sDO + p * P::Q_PANEL, &tdo, bar_q, p * P::COLS, q0, h, b);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % STAGES, k0 = (kt_begin + i) * BM;
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
    const int col = 2 * (lane % 4);            // and key columns 8 j + col, + 1
    const int qa = q0 + BM * wg;
    const float c = a.scale_log2;
    float dq[HD / 2], s[32], dp[32], lse2[2], dsum[2];
    uint32_t da[4][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qa + row + 8 * r;
      const int64_t at = (int64_t)bh * a.S_pad + qi;
      lse2[r] = qi < a.S ? a.lse2[at] : 0.0f;
      dsum[r] = qi < a.S ? a.dsum[at] : 0.0f;
    }
    const uint32_t sQw = sQ + BM * wg * P::SW, sDOw = sDO + BM * wg * P::SW;
    mbar_wait(bar_q, 0);

    for (int i = 0; i < n_kt; ++i) {
      const int st = i % STAGES, k0 = (kt_begin + i) * BM;
      const bool closed = block_closed(a, qa, k0), edge = block_edge(a, qa, k0);
      mbar_wait(full(st), (i / STAGES) & 1);
      if (!closed) {
        // S = Q K^T and dP = dO V^T over hd in steps of 16.
        const uint32_t sKs = sK + st * P::KV_BYTES, sVs = sV + st * P::KV_BYTES;
        pin(s);
        pin(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % P::STEPS) * 32, p = kk / P::STEPS;
          wgmma_ss_m64n64(s, panel_desc<P::SW>(sQw + p * P::Q_PANEL + off, 16, 8 * P::SW),
                          panel_desc<P::SW>(sKs + p * P::KV_PANEL + off, 16, 8 * P::SW),
                          kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % P::STEPS) * 32, p = kk / P::STEPS;
          wgmma_ss_m64n64(dp, panel_desc<P::SW>(sDOw + p * P::Q_PANEL + off, 16, 8 * P::SW),
                          panel_desc<P::SW>(sVs + p * P::KV_PANEL + off, 16, 8 * P::SW),
                          kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);
        pin(dp);

        // dS = P (dP - D), element (query qa + row + 8 (e / 2), key
        // k0 + 8 j + col + e % 2), packed as the A fragment of k-step kk.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float d8[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int j = 2 * kk + x / 4, e = x % 4, r = e / 2;
            float p = ex2(fmaf(s[4 * j + e], c, -lse2[r]));
            if (edge && !pair_open(a, qa + row + 8 * r, k0 + 8 * j + col + (e % 2))) p = 0.0f;
            d8[x] = p * (dp[4 * j + e] - dsum[r]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) da[kk][r] = pack_bf16(d8[2 * r], d8[2 * r + 1]);
        }

        // dQ += dS K: 16 keys per step, K MN-major.
        pin(dq);
        pin(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n<HD>(dq, da[kk],
                         panel_desc<P::SW>(sKs + kk * 16 * P::SW, P::KV_PANEL, 8 * P::SW));
        wgmma_commit();
        wgmma_wait_all();
        pin(dq);
        pin(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    store_bf16_rows<HD>(a.dq, a.dq_sb, a.dq_sh, a.dq_ss, b, h, qa, a.S, row, col, dq, a.scale);
  }
}

// ---------------------------------------------------------------------------
// hd 256: both passes with 64-row tiles and the work of a tile split
// between the two consumer warpgroups (see the note at the top).
// ---------------------------------------------------------------------------

// The hd 256 plan: a 64-row tile of hd 256 is four 64-column panels in the
// 128-byte swizzle, 8 KB each; a consumer accumulates one hd half (128
// columns: 64 f32 registers a thread) of dK and dV, or of dQ.
struct Wide {
  static constexpr int COLS = 64, PANELS = 4, PANEL = BM * 128;  // a panel: 8 KB
  static constexpr int TILE = PANELS * PANEL;                       // 32 KB
  static constexpr int HALF = 128, STAGES = 2;
  // Staged bf16 operands (P^T and dS^T, or dS), each one panel, in two
  // buffers that alternate over the tiles a block computes.
  static constexpr int XBUF = 2;
};

// dK / dV shared memory at hd 256, in bytes from a 1024-byte aligned base:
// K and V (a tile each); STAGES Q tiles and STAGES dO tiles; XBUF pairs of
// (P^T, dS^T) panels; STAGES (lse2, D) slices; the mbarriers.  226.0 KB.
struct KVPlan256 : Wide {
  static constexpr int K = 0, V = TILE, Q = 2 * TILE, DO = Q + STAGES * TILE;
  static constexpr int X = DO + STAGES * TILE, X_BYTES = 2 * PANEL;
  static constexpr int VEC = X + XBUF * X_BYTES, VEC_BYTES = 2 * BM * 4;
  static constexpr int BARS = VEC + STAGES * VEC_BYTES;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
  static_assert(BYTES <= 232448, "dK / dV plan above the 227 KB a block may use");
};

// dQ shared memory at hd 256: Q and dO (a tile each); STAGES K tiles and
// STAGES V tiles; XBUF dS panels; the mbarriers.  209.0 KB.
struct QPlan256 : Wide {
  static constexpr int Q = 0, DO = TILE, K = 2 * TILE, V = K + STAGES * TILE;
  static constexpr int X = V + STAGES * TILE, X_BYTES = PANEL;
  static constexpr int BARS = X + XBUF * X_BYTES;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
  static_assert(BYTES <= 232448, "dQ plan above the 227 KB a block may use");
};

template <>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel<256>(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo, const Params a) {
  using P = KVPlan256;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + P::K, sV = base + P::V, sQ = base + P::Q, sDO = base + P::DO;
  const float* vec = reinterpret_cast<const float*>(smem_raw + (base - raw) + P::VEC);
  const uint32_t bar_kv = base + P::BARS;
  const auto full = [&](int st) { return bar_kv + 8u * (1 + st); };
  const auto empty = [&](int st) { return bar_kv + 8u * (1 + STAGES + st); };

  // As at hd 128, with 64-key tiles.
  const int per_kt = a.B * a.KV * a.split;
  const int kt = blockIdx.x / per_kt, rest = blockIdx.x % per_kt;
  const int sp = rest % a.split, bg = rest / a.split;
  const int b = bg / a.KV, g = bg % a.KV;
  const int heads = a.group / a.split, h0 = g * a.group + sp * heads;
  const int k0 = kt * BM;
  const int k_last = min(k0 + BM, a.S) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window > 0 ? min(a.S, k_last + a.window) : a.S;
  const int qt_begin = q_begin / BM, n_qt = (q_end + BM - 1) / BM - qt_begin;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(bar_kv, 2 * P::TILE);
#pragma unroll
      for (int p = 0; p < P::PANELS; ++p) {
        tma_load(sK + p * P::PANEL, &tk, bar_kv, p * P::COLS, k0, g, b);
        tma_load(sV + p * P::PANEL, &tv, bar_kv, p * P::COLS, k0, g, b);
      }
      int i = 0;
      for (int hh = 0; hh < heads; ++hh) {
        const int h = h0 + hh;
        for (int t = 0; t < n_qt; ++t, ++i) {
          const int st = i % STAGES, q0 = (qt_begin + t) * BM;
          mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * P::TILE + P::VEC_BYTES);
#pragma unroll
          for (int p = 0; p < P::PANELS; ++p) {
            const uint32_t off = st * P::TILE + p * P::PANEL;
            tma_load(sQ + off, &tq, full(st), p * P::COLS, q0, h, b);
            tma_load(sDO + off, &tdo, full(st), p * P::COLS, q0, h, b);
          }
          const int64_t row = ((int64_t)b * a.H + h) * a.S_pad + q0;
          const uint32_t sv = base + P::VEC + st * P::VEC_BYTES;
          bulk_load(sv, a.lse2 + row, BM * 4, full(st));
          bulk_load(sv + BM * 4, a.dsum + row, BM * 4, full(st));
        }
      }
    }
  } else {
    // Consumer warpgroup wg: S^T and dP^T on queries 32 wg .. 32 wg + 31
    // of each tile, dK and dV on hd columns 128 wg .. 128 wg + 127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = 16 * (t / 32) + lane / 4;  // this thread's keys: row, row + 8
    const int col = 2 * (lane % 4);            // and queries 32 wg + 8 j + col, + 1
    const int qw = 32 * wg;
    const float c = a.scale_log2;
    float dk[P::HALF / 2], dv[P::HALF / 2], s[16], dp[16];
#pragma unroll
    for (int i = 0; i < P::HALF / 2; ++i) dk[i] = dv[i] = 0.0f;
    mbar_wait(bar_kv, 0);

    int i = 0, n_open = 0;
    for (int hh = 0; hh < heads; ++hh) {
      for (int tt = 0; tt < n_qt; ++tt, ++i) {
        const int st = i % STAGES, q0 = (qt_begin + tt) * BM;
        const bool closed = block_closed(a, q0, k0), edge = block_edge(a, q0, k0);
        mbar_wait(full(st), (i / STAGES) & 1);
        if (!closed) {  // the same for both warpgroups: both meet the barrier
          const uint32_t sQs = sQ + st * P::TILE, sDOs = sDO + st * P::TILE;
          const float* lse2 = vec + st * (2 * BM);
          const float* dsum = lse2 + BM;
          // P^T at sX, dS^T one panel on; the buffers alternate over the
          // open tiles, so one warpgroup's stores never meet the other's
          // reads of the tile before.
          const uint32_t sX = base + P::X + (n_open++ % P::XBUF) * P::X_BYTES;
          // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 32 queries.
          pin(s);
          pin(dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 256 / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32 + (kk / 4) * P::PANEL;
            wgmma_ss_m64n32(s, sw128_desc(sK + off, 16, 1024),
                            sw128_desc(sQs + off + qw * 128, 16, 1024), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < 256 / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32 + (kk / 4) * P::PANEL;
            wgmma_ss_m64n32(dp, sw128_desc(sV + off, 16, 1024),
                            sw128_desc(sDOs + off + qw * 128, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          pin(s);
          pin(dp);

          // P^T and dS^T, element (key k0 + row + 8 (e / 2), query
          // q0 + qw + 8 j + col + e % 2), rounded to bf16 into their panels.
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float pv[2], dv2[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int qc = qw + 8 * j + col + e, x = 4 * j + 2 * r + e;
                float p = ex2(fmaf(s[x], c, -lse2[qc]));
                if (edge && !pair_open(a, q0 + qc, k0 + row + 8 * r)) p = 0.0f;
                pv[e] = p;
                dv2[e] = p * (dp[x] - dsum[qc]);
              }
              const uint32_t at = sw128_offset(row + 8 * r, qw + 8 * j + col);
              st_shared_u32(sX + at, pack_bf16(pv[0], pv[1]));
              st_shared_u32(sX + P::PANEL + at, pack_bf16(dv2[0], dv2[1]));
            }
          }
          fence_async_shared();
          named_barrier(1, CONSUMERS * 128);  // both halves of P^T and dS^T stored

          // dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half]:
          // 16 queries a step, dO and Q MN-major from panel 2 wg.
          pin(dv);
          pin(dk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_m64n128_tb(
                dv, sw128_desc(sX + kk * 32, 16, 1024),
                sw128_desc(sDOs + 2 * wg * P::PANEL + kk * 16 * 128, P::PANEL, 1024));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_m64n128_tb(
                dk, sw128_desc(sX + P::PANEL + kk * 32, 16, 1024),
                sw128_desc(sQs + 2 * wg * P::PANEL + kk * 16 * 128, P::PANEL, 1024));
          wgmma_commit();
          wgmma_wait_all();
          pin(dv);
          pin(dk);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
    }

    // Epilogue: this warpgroup's hd half of dK hd^-0.5 and dV, in bf16 for a
    // group of one run, else this run's f32 share.
    const int hc = P::HALF * wg + col;
    if (a.split == 1) {
      store_bf16_rows<P::HALF>(a.dk, a.dk_sb, a.dk_sh, a.dk_ss, b, g, k0, a.S, row, hc, dk,
                               a.scale);
      store_bf16_rows<P::HALF>(a.dv, a.dv_sb, a.dv_sh, a.dv_ss, b, g, k0, a.S, row, hc, dv,
                               1.0f);
    } else {
      const int64_t share = ((int64_t)bg * a.split + sp) * a.S;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ki = k0 + row + 8 * r;
        if (ki >= a.S) continue;
        float* pk = a.dk_part + (share + ki) * 256 + hc;
        float* pv = a.dv_part + (share + ki) * 256 + hc;
#pragma unroll
        for (int j = 0; j < P::HALF / 8; ++j) {
          *reinterpret_cast<float2*>(pk + 8 * j) =
              make_float2(dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
          *reinterpret_cast<float2*>(pv + 8 * j) =
              make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel<256>(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const Params a) {
  using P = QPlan256;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + P::Q, sDO = base + P::DO, sK = base + P::K, sV = base + P::V;
  const uint32_t bar_q = base + P::BARS;
  const auto full = [&](int st) { return bar_q + 8u * (1 + st); };
  const auto empty = [&](int st) { return bar_q + 8u * (1 + STAGES + st); };

  // Numbered as at hd 128, with 64-row query tiles.
  const int n_bh = a.B * a.H, chunk = blockIdx.x / (CHUNK * a.n_qt);
  const int pos = blockIdx.x % (CHUNK * a.n_qt), here = min(CHUNK, n_bh - chunk * CHUNK);
  const int bh = chunk * CHUNK + pos % here;
  const int qt = a.n_qt - 1 - pos / here;
  const int b = bh / a.H, h = bh % a.H, g = h / a.group;
  const int q0 = qt * BM;
  const int q_last = min(q0 + BM, a.S) - 1;
  const int k_end = a.causal ? q_last + 1 : a.S;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_begin = k_begin / BM, n_kt = (k_end + BM - 1) / BM - kt_begin;

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(bar_q, 2 * P::TILE);
#pragma unroll
      for (int p = 0; p < P::PANELS; ++p) {
        tma_load(sQ + p * P::PANEL, &tq, bar_q, p * P::COLS, q0, h, b);
        tma_load(sDO + p * P::PANEL, &tdo, bar_q, p * P::COLS, q0, h, b);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % STAGES, k0 = (kt_begin + i) * BM;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * P::TILE);
#pragma unroll
        for (int p = 0; p < P::PANELS; ++p) {
          const uint32_t off = st * P::TILE + p * P::PANEL;
          tma_load(sK + off, &tk, full(st), p * P::COLS, k0, g, b);
          tma_load(sV + off, &tv, full(st), p * P::COLS, k0, g, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: S and dP on keys 32 wg .. 32 wg + 31 of each
    // tile, dQ on hd columns 128 wg .. 128 wg + 127, all 64 rows.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = 16 * (t / 32) + lane / 4;  // this thread's rows: row, row + 8
    const int col = 2 * (lane % 4);            // and keys 32 wg + 8 j + col, + 1
    const int kw = 32 * wg;
    const float c = a.scale_log2;
    float dq[P::HALF / 2], s[16], dp[16], lse2[2], dsum[2];
#pragma unroll
    for (int i = 0; i < P::HALF / 2; ++i) dq[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row + 8 * r;
      const int64_t at = (int64_t)bh * a.S_pad + qi;
      lse2[r] = qi < a.S ? a.lse2[at] : 0.0f;
      dsum[r] = qi < a.S ? a.dsum[at] : 0.0f;
    }
    mbar_wait(bar_q, 0);

    int n_open = 0;
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % STAGES, k0 = (kt_begin + i) * BM;
      const bool closed = block_closed(a, q0, k0), edge = block_edge(a, q0, k0);
      mbar_wait(full(st), (i / STAGES) & 1);
      if (!closed) {  // the same for both warpgroups: both meet the barrier
        const uint32_t sKs = sK + st * P::TILE, sVs = sV + st * P::TILE;
        const uint32_t sX = base + P::X + (n_open++ % P::XBUF) * P::X_BYTES;
        // S = Q K^T and dP = dO V^T, this warpgroup's 32 keys.
        pin(s);
        pin(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 256 / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32 + (kk / 4) * P::PANEL;
          wgmma_ss_m64n32(s, sw128_desc(sQ + off, 16, 1024),
                          sw128_desc(sKs + off + kw * 128, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < 256 / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32 + (kk / 4) * P::PANEL;
          wgmma_ss_m64n32(dp, sw128_desc(sDO + off, 16, 1024),
                          sw128_desc(sVs + off + kw * 128, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);
        pin(dp);

        // dS = P (dP - D), element (query q0 + row + 8 r, key
        // k0 + kw + 8 j + col + e), rounded to bf16 into its panel.
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float d2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kc = kw + 8 * j + col + e, x = 4 * j + 2 * r + e;
              float p = ex2(fmaf(s[x], c, -lse2[r]));
              if (edge && !pair_open(a, q0 + row + 8 * r, k0 + kc)) p = 0.0f;
              d2[e] = p * (dp[x] - dsum[r]);
            }
            st_shared_u32(sX + sw128_offset(row + 8 * r, kw + 8 * j + col),
                          pack_bf16(d2[0], d2[1]));
          }
        }
        fence_async_shared();
        named_barrier(1, CONSUMERS * 128);  // both halves of dS stored

        // dQ[:, half] += dS K[:, half]: 16 keys a step, K MN-major from
        // panel 2 wg.
        pin(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n128_tb(
              dq, sw128_desc(sX + kk * 32, 16, 1024),
              sw128_desc(sKs + 2 * wg * P::PANEL + kk * 16 * 128, P::PANEL, 1024));
        wgmma_commit();
        wgmma_wait_all();
        pin(dq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    store_bf16_rows<P::HALF>(a.dq, a.dq_sb, a.dq_sh, a.dq_ss, b, h, q0, a.S, row,
                             P::HALF * wg + col, dq, a.scale);
  }
}

// Rows of the key tile of a dK / dV block (and of the query tile of a dQ
// block): 128 at hd 64, 80 and 128, 64 at hd 256.
constexpr int tile_rows(int hd) { return hd == 256 ? BM : BT; }

// The runs a group of query heads is split into: the least divisor of the
// group that gives the dK / dV pass a block per SM (at glm4-9b's training
// shape 4 runs of 4 heads, 256 blocks; at gemma3-12b's, 8 kv heads of
// 64-key tiles, one run).  More runs balance the key tiles'
// unequal work better but write and sum more f32 shares, which cost more
// than they gain (measured at 2 and 4 blocks per SM).
int split_for(int64_t B, int64_t KV, int64_t group, int64_t S, int hd) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int rows = tile_rows(hd);
  const int64_t blocks = B * KV * ((S + rows - 1) / rows);
  for (int64_t d = 1; d < group; ++d)
    if (group % d == 0 && blocks * d >= sms) return (int)d;
  return (int)group;
}

struct Launch {
  const void *q, *k, *v, *dout;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss;
};

// The shared-memory plans of a head dim's dK / dV and dQ passes.
template <int HD>
struct Plans {
  using KV = KVPlan<HD>;
  using Q = QPlan<HD>;
};
template <>
struct Plans<256> {
  using KV = KVPlan256;
  using Q = QPlan256;
};

template <int HD>
int launch(const Launch& L, const Params& a, cudaStream_t stream, int* launched) {
  // Maps with boxes of 64 rows and of the kept tile's rows (128, or 64 at
  // hd 256), a panel wide: the dK / dV pass streams 64-row Q and dO tiles
  // against the kept K and V tiles, the dQ pass the other way.
  constexpr int COLS = Panels<HD>::COLS, KEEP = tile_rows(HD);
  constexpr int KV_BYTES = Plans<HD>::KV::BYTES, Q_BYTES = Plans<HD>::Q::BYTES;
  CUtensorMap q64, do64, k_keep, v_keep, q_keep, do_keep, k64, v64;
  const auto maps = [&](CUtensorMap* mq, CUtensorMap* mdo, CUtensorMap* mk, CUtensorMap* mv,
                        int rows) {
    int e = make_map(mq, L.q, HD, a.S, a.H, a.B, L.q_sb, L.q_sh, L.q_ss, rows, COLS);
    if (e == 0)
      e = make_map(mdo, L.dout, HD, a.S, a.H, a.B, L.do_sb, L.do_sh, L.do_ss, rows, COLS);
    if (e == 0) e = make_map(mk, L.k, HD, a.S, a.KV, a.B, L.k_sb, L.k_sh, L.k_ss, rows, COLS);
    if (e == 0) e = make_map(mv, L.v, HD, a.S, a.KV, a.B, L.v_sb, L.v_sh, L.v_ss, rows, COLS);
    return e;
  };
  int e = maps(&q64, &do64, &k64, &v64, BM);
  if (e == 0) e = maps(&q_keep, &do_keep, &k_keep, &v_keep, KEEP);
  if (e != 0) return e;
  const auto dkdv = flash_bwd_dkdv_kernel<HD>;
  const auto dq = flash_bwd_dq_kernel<HD>;
  cudaError_t r;
  if ((r = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                KV_BYTES)) != cudaSuccess ||
      (r = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_BYTES)) !=
          cudaSuccess)
    return (int)r;
  const int64_t kv_blocks = (int64_t)a.n_kt * a.B * a.KV * a.split;
  dkdv<<<(unsigned)kv_blocks, THREADS, KV_BYTES, stream>>>(q64, k_keep, v_keep, do64, a);
  if ((r = cudaGetLastError()) != cudaSuccess) return (int)r;
  ++*launched;
  if (a.split > 1) {
    Args s{};
    s.dk = a.dk, s.dv = a.dv, s.dk_part = a.dk_part, s.dv_part = a.dv_part;
    s.B = a.B, s.H = a.H, s.group = a.group, s.S = a.S;
    s.dk_sb = a.dk_sb, s.dk_sh = a.dk_sh, s.dk_ss = a.dk_ss;
    s.dv_sb = a.dv_sb, s.dv_sh = a.dv_sh, s.dv_ss = a.dv_ss;
    if ((e = group_sum<__nv_bfloat16>(s, HD, a.split, stream)) != 0) return e;
    ++*launched;
  }
  const int64_t q_blocks = (int64_t)a.n_qt * a.B * a.H;
  dq<<<(unsigned)q_blocks, THREADS, Q_BYTES, stream>>>(q_keep, k64, v64, do_keep, a);
  if ((r = cudaGetLastError()) != cudaSuccess) return (int)r;
  ++*launched;
  return 0;
}

}  // namespace tc

// The SIMT dK / dV pass, the group sum and the dQ pass.
template <typename T, int HD>
int launch_simt(const Args& a, cudaStream_t stream, int* launched) {
  const int64_t bh = (int64_t)a.B * a.H;
  const int n_kt = (a.S + KVLayout<HD>::BN - 1) / KVLayout<HD>::BN;
  const int n_qt = (a.S + QLayout<HD>::BQ - 1) / QLayout<HD>::BQ;
  if (bh * n_qt > 0x7fffffff || bh * n_kt > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = allow_smem(flash_bwd_dkdv_kernel<T, HD>, KVLayout<HD>::BYTES)) ||
      (e = allow_smem(flash_bwd_dq_kernel<T, HD>, QLayout<HD>::BYTES)))
    return (int)e;
  flash_bwd_dkdv_kernel<T, HD>
      <<<(unsigned)(bh * n_kt), THREADS, KVLayout<HD>::BYTES, stream>>>(a, n_kt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++*launched;
  if (a.group > 1) {
    const int r = group_sum<T>(a, HD, a.group, stream);
    if (r != 0) return r;
    ++*launched;
  }
  flash_bwd_dq_kernel<T, HD>
      <<<(unsigned)(bh * n_qt), THREADS, QLayout<HD>::BYTES, stream>>>(a, n_qt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++*launched;
  return 0;
}

// The SIMT passes: f32 at every head dim (64, 80, 128, 256).
int launch_simt_hd(int dtype, int hd, const Args& a, cudaStream_t stream, int* launched) {
  if (dtype == 0 && hd == 64) return launch_simt<float, 64>(a, stream, launched);
  if (dtype == 0 && hd == 80) return launch_simt<float, 80>(a, stream, launched);
  if (dtype == 0 && hd == 128) return launch_simt<float, 128>(a, stream, launched);
  if (dtype == 0 && hd == 256) return launch_simt<float, 256>(a, stream, launched);
  return (int)cudaErrorInvalidValue;
}

// bf16 runs the tensor-core passes at every head dim.
bool on_tensor_cores(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 80 || hd == 128 || hd == 256);
}

}  // namespace

// The f32 shares of dK and dV per kv head that the backward of this shape
// stores for its group sum (1: none, dK and dV stored directly): the
// tensor-core pass's runs of heads, or the SIMT passes' query heads.
extern "C" int64_t flash_attention_backward_shares(int dtype, int hd, int64_t B, int64_t H,
                                                   int64_t KV, int64_t S) {
  if (KV <= 0 || H % KV != 0) return 1;
  if (on_tensor_cores(dtype, hd)) return tc::split_for(B, KV, H / KV, S, hd);
  return H / KV;
}

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dO, dQ, dK and dV alike.
// q, o, dO and dQ are (B, H, S, hd), k, v, dK and dV (B, KV, S, hd), each
// given by its (b, head, s) element strides with hd contiguous; for bf16 at
// every hd (the tensor-core passes), q, k, v and dO start on 16 bytes
// and their strides are multiples of 8 elements (TMA).  lse is the
// forward's (B, H, S) f32 logsumexp, or null: then the lse pass writes it
// to lse_scratch (B H S f32).  vec is f32 scratch of 2 B H S_pad elements,
// S_pad = S rounded up to 64 (D, and lse log2(e) for the tensor-core
// passes).  dk_part and dv_part are f32 scratch of B KV shares S hd
// elements each, read when flash_attention_backward_shares is above 1 (may
// be null otherwise).  hd is 64, 80, 128 or 256; H is a multiple of KV.
// Launches the passes on the stream, counts them in *launched, and returns
// the cudaError_t of the first that fails.
extern "C" int flash_attention_backward_launch(
    int dtype, int hd, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse, void* lse_scratch,
    void* vec, void* dk_part, void* dv_part, int64_t B, int64_t H, int64_t KV, int64_t S,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
    int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
    int causal, int64_t window, void* stream, int* launched) {
  if (launched == nullptr) return (int)cudaErrorInvalidValue;
  *launched = 0;
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (S > 0x3fffffff || B * H > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (hd != 64 && hd != 80 && hd != 128 && hd != 256) return (int)cudaErrorInvalidValue;
  if (vec == nullptr || (lse == nullptr && lse_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t shares = flash_attention_backward_shares(dtype, hd, B, H, KV, S);
  if (shares > 1 && (dk_part == nullptr || dv_part == nullptr)) return (int)cudaErrorInvalidValue;
  const int win = (int)(window > S ? S : window);
  const double scale = 1.0 / std::sqrt((double)hd);
  float* lse_f = static_cast<float*>(lse != nullptr ? const_cast<void*>(lse) : lse_scratch);
  Args a{q, k, v, o, dout, dq, dk, dv, lse_f, static_cast<float*>(vec),
         static_cast<float*>(dk_part), static_cast<float*>(dv_part),
         (int)B, (int)H, (int)(H / KV), (int)S, causal ? 1 : 0, win, (float)scale,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
         do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  cudaStream_t st = (cudaStream_t)stream;
  const bool tensor_cores = on_tensor_cores(dtype, hd);
  int e;
  if (lse == nullptr) {  // the lse pass
    e = dtype == 0 ? launch_stats_hd<float>(hd, a, st, launched)
                   : launch_stats_hd<__nv_bfloat16>(hd, a, st, launched);
    if (e != 0) return e;
  }
  const int64_t ld = tensor_cores ? (S + 63) / 64 * 64 : S;
  PrepArgs p{o, dout, lse_f, static_cast<float*>(vec), nullptr, (int)B, (int)H, (int)S,
             (int)ld, hd, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss};
  if (!tensor_cores) {  // D alone
    e = dtype == 0 ? launch_prep<float>(p, st, launched)
                   : launch_prep<__nv_bfloat16>(p, st, launched);
    if (e != 0) return e;
    return launch_simt_hd(dtype, hd, a, st, launched);
  }
  // Tensor cores: lse2 in the first B H S_pad floats of vec, D after them.
  p.lse2 = static_cast<float*>(vec);
  p.dsum = static_cast<float*>(vec) + B * H * ld;
  if ((e = launch_prep<__nv_bfloat16>(p, st, launched)) != 0) return e;
  const int rows = tc::tile_rows(hd);
  const int64_t n_kt = (S + rows - 1) / rows, n_qt = n_kt;
  if (n_kt * B * KV * shares > 0x7fffffff || n_qt * B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  tc::Params t{p.lse2, p.dsum, dq, dk, dv, static_cast<float*>(dk_part),
               static_cast<float*>(dv_part), (int)B, (int)H, (int)KV, (int)(H / KV), (int)S,
               (int)ld, causal ? 1 : 0, win, (int)shares, (int)n_kt, (int)n_qt,
               (float)scale, (float)(scale * 1.4426950408889634),
               dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  tc::Launch L{q, k, v, dout, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
               do_sb, do_sh, do_ss};
  if (hd == 64) return tc::launch<64>(L, t, st, launched);
  if (hd == 80) return tc::launch<80>(L, t, st, launched);
  if (hd == 128) return tc::launch<128>(L, t, st, launched);
  return tc::launch<256>(L, t, st, launched);
}
