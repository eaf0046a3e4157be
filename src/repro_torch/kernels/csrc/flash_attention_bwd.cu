// The backward of flash attention (csrc/flash_attention.cu): from q, k, v,
// the forward's output o and the output's gradient dO, the gradients
//   dQ = dS K hd^-0.5,  dK = dS^T Q hd^-0.5,  dV = P^T dO,
// with P = exp(q k^T hd^-0.5 - lse) on the pairs that the causal and window
// masks leave open (0 elsewhere), lse each row's logsumexp over its open
// keys, D = rowsum(dO o) and dS = P (dO v^T - D).  Query head h reads kv
// head h / (H / KV); dK and dV of a kv head sum over its group of query
// heads.  Outputs are stored in the inputs' dtype.
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
//
// Design: a simple one that is right first, f32 SIMT arithmetic for both
// input types (bf16 values are widened to f32, so every product is exact
// and only the order of the f32 sums differs from the plain version; no
// tensor cores yet), in four launches with no atomics, so the result is
// deterministic:
// 1. stats: one block per (b, h, 64-row query tile) recomputes each row's
//    running max and sum over the open key tiles, as the forward does, and
//    stores lse = m + log(l) and D = rowsum(dO o) (f32 scratch, (B, H, S)).
// 2. dK, dV: one block per (b, h, key tile) walks the query tiles open to
//    its keys, recomputes P and dS, and accumulates dV = P^T dO and
//    dK = dS^T (q hd^-0.5) in registers.  Each query head is its own block
//    (glm4-9b has only 2 kv heads: a block per kv head would give 128
//    blocks at S = 4096 for 132 SMs); with GQA groups above 1 the block
//    stores its head's share in f32 scratch (B, H, S, hd), and
// 3. a reduction sums each kv head's group of shares in head order (group
//    1 stores dK and dV directly and skips it).
// 4. dQ: one block per (b, h, query tile) walks the open key tiles and
//    accumulates dS K hd^-0.5.
// Warps own rows of the tile that stays (keys in pass 2, queries in passes
// 1 and 4), lanes own 2 of the 64 columns of the tile that streams through
// shared memory, and hd / 32 columns of the accumulators.  Rows read by one
// lane each are padded by 4 floats, so the float4 reads of 8 lanes hit 32
// distinct banks; rows read by the whole warp are broadcasts.  At hd 256
// the tile that stays is 32 rows, so shared memory stays under 227 KB
// (the opt-in attribute is set above 48 KB) and the accumulators in
// registers.  Keys and queries at or past S are masked and staged as 0.
// Tile skipping: a block visits only the tiles that the masks leave at
// least partly open for one of its rows; inside a tile every pair is masked
// exactly, so the skipping changes no value.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

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

// acc[r][j] += sum_c W[r][c] Bm[c][lane + 32 j] over the tile's 64 columns:
// W rows are this warp's (broadcast float4), Bm columns the lane's.
template <int HD, int NR, int LDW, int LDB>
__device__ __forceinline__ void accumulate(const float* W, const float* Bm, int lane,
                                           float (&acc)[NR][HD / 32]) {
  constexpr int CPL = HD / 32;
#pragma unroll 2
  for (int c = 0; c < COLS; c += 4) {
    float4 w[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) w[r] = *reinterpret_cast<const float4*>(W + r * LDW + c);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
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
// Pass 1: lse and D per query row.
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
  const T* ob = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const T* db = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;

  // D = rowsum(dO o), one warp a row.
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + r0 + r;
    float part = 0.0f;
    if (qi < a.S)
      for (int d = lane; d < HD; d += 32)
        part = fmaf(to_f32(db[(int64_t)qi * a.do_ss + d]), to_f32(ob[(int64_t)qi * a.o_ss + d]),
                    part);
    part = warp_sum(part);
    if (lane == 0 && qi < a.S) a.dsum[(int64_t)bh * a.S + qi] = part;
  }

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
// Pass 2: dK and dV of one query head's share, per key tile.
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
  constexpr int ROWS = L::ROWS, CPL = HD / 32;
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
        dkb[lane + 32 * j] = from_f32<T>(dk[r][j]);
        dvb[lane + 32 * j] = from_f32<T>(dv[r][j]);
      }
    } else {
      const int64_t off = ((int64_t)bh * a.S + ki) * HD;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        a.dk_part[off + lane + 32 * j] = dk[r][j];
        a.dv_part[off + lane + 32 * j] = dv[r][j];
      }
    }
  }
}

// Pass 3: dK and dV of each kv head = the sum of its group's shares, in
// head order.
template <typename T>
__global__ void flash_bwd_group_sum_kernel(Args a, int hd) {
  const int KV = a.H / a.group;
  const int64_t total = (int64_t)a.B * KV * a.S * hd;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int d = (int)(i % hd);
    const int64_t row = i / hd;
    const int s = (int)(row % a.S);
    const int bg = (int)(row / a.S), b = bg / KV, g = bg % KV;
    float sk = 0.0f, sv = 0.0f;
    for (int hh = 0; hh < a.group; ++hh) {
      const int64_t off = (((int64_t)b * a.H + g * a.group + hh) * a.S + s) * hd + d;
      sk += a.dk_part[off];
      sv += a.dv_part[off];
    }
    static_cast<T*>(a.dk)[b * a.dk_sb + g * a.dk_sh + (int64_t)s * a.dk_ss + d] = from_f32<T>(sk);
    static_cast<T*>(a.dv)[b * a.dv_sb + g * a.dv_sh + (int64_t)s * a.dv_ss + d] = from_f32<T>(sv);
  }
}

// ---------------------------------------------------------------------------
// Pass 4: dQ per query tile.
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
  constexpr int ROWS = L::ROWS, CPL = HD / 32;
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
      dqb[(int64_t)qi * a.dq_ss + lane + 32 * j] = from_f32<T>(acc[r][j] * a.scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const int64_t bh = (int64_t)a.B * a.H;
  const int n_qt1 = (a.S + StatsLayout<HD>::BQ - 1) / StatsLayout<HD>::BQ;
  const int n_kt = (a.S + KVLayout<HD>::BN - 1) / KVLayout<HD>::BN;
  const int n_qt4 = (a.S + QLayout<HD>::BQ - 1) / QLayout<HD>::BQ;
  if (bh * n_qt4 > 0x7fffffff || bh * n_kt > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = allow_smem(flash_bwd_stats_kernel<T, HD>, StatsLayout<HD>::BYTES)) ||
      (e = allow_smem(flash_bwd_dkdv_kernel<T, HD>, KVLayout<HD>::BYTES)) ||
      (e = allow_smem(flash_bwd_dq_kernel<T, HD>, QLayout<HD>::BYTES)))
    return (int)e;
  flash_bwd_stats_kernel<T, HD>
      <<<(unsigned)(bh * n_qt1), THREADS, StatsLayout<HD>::BYTES, stream>>>(a, n_qt1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, HD>
      <<<(unsigned)(bh * n_kt), THREADS, KVLayout<HD>::BYTES, stream>>>(a, n_kt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (a.group > 1) {
    const int64_t total = (int64_t)a.B * (a.H / a.group) * a.S * HD;
    const int64_t blocks = (total + 255) / 256;
    const unsigned grid = (unsigned)(blocks < (1 << 21) ? blocks : (1 << 21));
    flash_bwd_group_sum_kernel<T><<<grid, 256, 0, stream>>>(a, HD);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  flash_bwd_dq_kernel<T, HD>
      <<<(unsigned)(bh * n_qt4), THREADS, QLayout<HD>::BYTES, stream>>>(a, n_qt4);
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

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dO, dQ, dK and dV alike.
// q, o, dO and dQ are (B, H, S, hd), k, v, dK and dV (B, KV, S, hd), each
// given by its (b, head, s) element strides with hd contiguous.  lse and
// dsum are f32 scratch of B H S elements; dk_part and dv_part f32 scratch
// of B H S hd elements each, read only when H > KV (may be null otherwise).
// hd is 64, 128 or 256; H is a multiple of KV.  Launches the four passes on
// the stream and returns a cudaError_t.
extern "C" int flash_attention_backward_launch(
    int dtype, int hd, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum, void* dk_part,
    void* dv_part, int64_t B, int64_t H, int64_t KV, int64_t S, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t do_sb, int64_t do_sh,
    int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, int64_t dk_sb, int64_t dk_sh,
    int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, int causal, int64_t window,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (S > 0x3fffffff || B * H > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (H > KV && (dk_part == nullptr || dv_part == nullptr)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, dq, dk, dv,
         static_cast<float*>(lse), static_cast<float*>(dsum),
         static_cast<float*>(dk_part), static_cast<float*>(dv_part),
         (int)B, (int)H, (int)(H / KV), (int)S, causal ? 1 : 0,
         (int)(window > S ? S : window), (float)(1.0 / std::sqrt((double)hd)),
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
         do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_hd<float>(hd, a, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}
