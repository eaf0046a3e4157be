// Dense push-sum mix Y = P @ X over the (n, D) client bank, accumulated in
// f32 and stored in the bank dtype.  P is the (n, n) f32 column-stochastic
// mixing matrix, or a row panel of it: m rows (m, n), whose Y is (m, D) —
// a row-sharded bank's local rows of the mix over the gathered bank.
//
// Replaces the TPU kernel src/repro/kernels/gossip_matmul.py
// (gossip_matmul_pallas, _kernel).  The reference mixes at
// Precision.HIGHEST, so this is a true f32 product: SIMT FMAs, no TF32
// and no tensor cores.  Every output sums its n products in ascending k,
// one fmaf each.
//
// Bound: for the slice's n = 100 it is operations.  2 n^2 D flops against
// 2 n D elements moved is n / 4 flop per byte in f32 (25 at n = 100),
// just above the card's f32 balance point of 67 TFLOP/s / 3.35 TB/s = 20;
// at n = 8 it is bytes.
//
// Resident kernel (n <= RESIDENT_MAX_N = 128):
// * Persistent blocks (as many as fit on the card) load P whole into
//   shared memory once (rows padded to n rounded up to 8, columns to n
//   rounded up to 4, zeros in the pads) and walk column panels of X of
//   192 columns (128 at n > 104, where a thread's tile of 6 columns would
//   no longer stay in registers), streamed through a ring of panels
//   (panel_ring.cuh): a producer warp fills each stage with one TMA bulk
//   copy per row, and the 8 consumer warps wait on its mbarrier.  The ring is 3 panels deep
//   where they fit, else 2, and 8 at n <= 32, where bytes bound the mix
//   and a panel is small.
// * The 8 consumer warps split the rows: warp w owns rows w + 8 i (i <
//   n_pad / 8, at most 16), lane t the columns t + 32 j (j < PANEL / 32),
//   so each thread keeps at most 13 x 6 or 16 x 4 accumulators.  Per 4-deep step of the
//   reduction a thread reads 24 X values (conflict-free) and, for each of
//   its rows, 4 values of P in one 16-byte read that the warp shares (a
//   broadcast): at n = 100, 13 rows x 24 = 312 FMAs per 37 shared-memory
//   wavefronts.  Rows' shifts repeat every 8 rows, so eight registers
//   locate every row of a stage.
// * The output is stored straight from the accumulators, each warp
//   writing 192 consecutive columns of a row (coalesced).
// A tile has at most 7 padding rows (4 at n = 100).
//
// Row panel (m != n, both at most 128): the resident kernel with P's m rows
// resident and the ring's stages of n rows, in panels of 128 columns, 2
// stages deep (what fits for every m and n up to 128); each output sums
// its n products in ascending k as the square mix does, so its rows
// equal the square mix's rows bit for bit.
//
// Tiled kernel (n > 128): one block per BM x BN tile of Y, the reduction
// in BK-deep slabs of P and X staged in shared memory, 8 x 8 accumulators
// a thread; the 1-D grid runs the row tiles of one column panel back to
// back so the panel is reused from L2.  Ragged n and D are masked at the
// tile edges.
#include "panel_ring.cuh"

namespace {

using panel::from_f32;
using panel::to_f32;

constexpr int RESIDENT_MAX_N = 128;
// Ring depth: 3 panels where they fit beside P, else 2, while the block is
// bound by its FMAs; at n <= DEEP_RING_MAX_N the mix is bound by bytes and
// a panel is small (n x 784 bytes in f32), so 8 panels keep enough copies
// in flight.
constexpr int DEEP_RING_MAX_N = 32;
// Panels of 192 columns (6 per lane) up to 13 rows a thread (n <= 104): 78
// accumulators.  Past that, 128 columns keep the tile in registers.
constexpr int WIDE_TM_MAX = 13;
constexpr int WARPS = 8;  // consumers; one more warp produces
constexpr int THREADS = (WARPS + 1) * 32;
constexpr int TILED_THREADS = 256;
constexpr int TM_MAX = RESIDENT_MAX_N / WARPS;  // rows per thread

// PANEL columns of X per panel, TN = PANEL / 32 per lane.
template <typename T, int TM, int STAGES, int PANEL>
__global__ void __launch_bounds__(THREADS)
mix_resident_kernel(const float* __restrict__ P, const T* __restrict__ X,
                    T* __restrict__ Y, int64_t m, int64_t n, int64_t D,
                    int64_t panels) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TN = PANEL / 32;
  constexpr int n_pad = TM * WARPS;
  const int kp = (int)((n + 3) & ~3);
  const int64_t rs = panel::row_stride(PANEL, sizeof(T));
  const int64_t stage_bytes = kp * rs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* Ps = reinterpret_cast<float*>(smem + panel::BARRIER_BYTES);  // Ps[row * kp + k]
  unsigned char* ring = reinterpret_cast<unsigned char*>(Ps + n_pad * kp);

  for (int i = threadIdx.x; i < n_pad * kp; i += THREADS) {
    const int r = i / kp, k = i % kp;
    Ps[i] = (r < m && k < n) ? P[r * n + k] : 0.0f;
  }
  // Rows n .. kp - 1 of every stage are the reduction's padding: zeros,
  // which no copy overwrites.
  for (int s = 0; s < STAGES; ++s)
    for (int64_t i = threadIdx.x; i < (kp - n) * rs / 16; i += THREADS)
      reinterpret_cast<uint4*>(ring + s * stage_bytes + n * rs)[i] = make_uint4(0, 0, 0, 0);
  panel::init_ring<STAGES>(bars, n, WARPS);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == WARPS) {
    panel::produce<T, STAGES>(ring, stage_bytes, bars, X, n, D, PANEL, panels, rs, lane);
    return;
  }
  // Row k of a stage starts at byte k * rs + shift(k).  A row is an even
  // number of bytes long, so shift(k + 8) = shift(k): eight shifts serve
  // every row.  (Padding rows are zero over their whole stride: any shift
  // reads 0.)
  int shifts[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) shifts[k] = panel::shift(X, k, D);
  int it = 0;
  for (int64_t p = blockIdx.x; p < panels; p += gridDim.x, ++it) {
    const int s = it % STAGES;
    panel::mbar_wait(bars + s, (uint32_t)((it / STAGES) & 1));
    if (panel::DIAG_SKIP_MIX) {
      __syncwarp();
      if (lane == 0) panel::mbar_arrive(bars + STAGES + s);
      continue;
    }
    const unsigned char* stage = ring + s * stage_bytes;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll 1  // unrolled twice it spilled and measured slower
    for (int k4 = 0; k4 < kp; k4 += 4) {
      float b[4][TN];
      const unsigned char* rows = stage + k4 * rs;
      const bool odd = k4 & 4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const T* xr = reinterpret_cast<const T*>(
            rows + kk * rs + (odd ? shifts[4 + kk] : shifts[kk]));
#pragma unroll
        for (int j = 0; j < TN; ++j) b[kk][j] = to_f32(xr[lane + 32 * j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(Ps + (warp + WARPS * i) * kp + k4);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a.x, b[0][j], acc[i][j]);
          acc[i][j] = fmaf(a.y, b[1][j], acc[i][j]);
          acc[i][j] = fmaf(a.z, b[2][j], acc[i][j]);
          acc[i][j] = fmaf(a.w, b[3][j], acc[i][j]);
        }
      }
    }

    const int64_t c0 = p * PANEL;
    const int pw = (int)panel::cols(PANEL, D, p);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = warp + WARPS * i;
      if (row >= m) continue;
      T* out = Y + row * D + c0;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (lane + 32 * j < pw) out[lane + 32 * j] = from_f32<T>(acc[i][j]);
    }
    __syncwarp();
    if (lane == 0) panel::mbar_arrive(bars + STAGES + s);
  }
}

constexpr int BM = 128, BN = 128, BK = 8, TILE_M = 8, TILE_N = 8;
static_assert((BM / TILE_M) * (BN / TILE_N) == TILED_THREADS, "one thread per 8 x 8 tile");

template <typename T>
__global__ void __launch_bounds__(TILED_THREADS)
mix_tiled_kernel(const float* __restrict__ P, const T* __restrict__ X,
                 T* __restrict__ Y, int64_t m, int64_t n, int64_t D, int64_t m_tiles) {
  __shared__ float Ps[BK][BM];  // P slab, transposed: Ps[k][row]
  __shared__ float Xs[BK][BN];  // X slab: Xs[k][col]

  const int64_t m0 = (blockIdx.x % m_tiles) * BM;
  const int64_t d0 = (blockIdx.x / m_tiles) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TILE_N);  // column lane: cols tx + 16 j
  const int ty = tid / (BN / TILE_N);  // row lane: rows ty + 16 i

  float acc[TILE_M][TILE_N];
#pragma unroll
  for (int i = 0; i < TILE_M; ++i)
#pragma unroll
    for (int j = 0; j < TILE_N; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < n; k0 += BK) {
    // Stage P[m0:m0+BM, k0:k0+BK] (transposed) and X[k0:k0+BK, d0:d0+BN].
#pragma unroll
    for (int r = 0; r < (BM * BK) / TILED_THREADS; ++r) {
      const int idx = tid + r * TILED_THREADS;
      const int row = idx / BK, k = idx % BK;
      const int64_t gr = m0 + row, gk = k0 + k;
      Ps[k][row] = (gr < m && gk < n) ? P[gr * n + gk] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / TILED_THREADS; ++r) {
      const int idx = tid + r * TILED_THREADS;
      const int k = idx / BN, col = idx % BN;
      const int64_t gk = k0 + k, gc = d0 + col;
      Xs[k][col] = (gk < n && gc < D) ? to_f32(X[gk * D + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TILE_M], b[TILE_N];
#pragma unroll
      for (int i = 0; i < TILE_M; ++i) a[i] = Ps[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TILE_N; ++j) b[j] = Xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TILE_M; ++i)
#pragma unroll
        for (int j = 0; j < TILE_N; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TILE_M; ++i) {
    const int64_t gr = m0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TILE_N; ++j) {
      const int64_t gc = d0 + tx + 16 * j;
      if (gc < D) Y[gr * D + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

// P's m rows (padded to 8) by n columns (padded to 4), and the ring's
// stages of n rows.
constexpr size_t resident_smem(int64_t m, int64_t n, int stages, int64_t panel,
                               size_t elem) {
  return (size_t)(panel::BARRIER_BYTES + ((m + 7) & ~7) * ((n + 3) & ~3) * 4 +
                  stages * ((n + 3) & ~3) * panel::row_stride(panel, elem));
}

constexpr bool fits(int64_t n, int stages, int64_t panel, size_t elem) {
  return resident_smem(n, n, stages, panel, elem) <= panel::SMEM_LIMIT;
}

// The resident kernel for n_pad = 8 TM rows: each thread's tile is TM x
// PANEL / 32.  Panels of 192 columns up to WIDE_TM_MAX rows a thread
// where two of them fit beside P, else 128; the ring as deep as fits, up to 3 panels (8 where the mix is bound
// by bytes).
template <typename T, int TM>
int launch_resident(const void* P, const void* X, void* Y, int64_t n, int64_t D,
                    cudaStream_t stream) {
  constexpr int64_t N = TM * WARPS;
  constexpr int PANEL = TM <= WIDE_TM_MAX && fits(N, 2, 192, sizeof(T)) ? 192 : 128;
  constexpr int STAGES = N <= DEEP_RING_MAX_N            ? 8
                         : fits(N, 3, PANEL, sizeof(T)) ? 3
                                                        : 2;
  static_assert(fits(N, STAGES, PANEL, sizeof(T)), "the resident kernel's shared memory");
  const size_t smem = resident_smem(n, n, STAGES, PANEL, sizeof(T));
  const int64_t panels = (D + PANEL - 1) / PANEL;
  int grid = 0;
  const int rc = panel::persistent_grid(mix_resident_kernel<T, TM, STAGES, PANEL>,
                                        THREADS, smem, panels, &grid);
  if (rc) return rc;
  mix_resident_kernel<T, TM, STAGES, PANEL><<<grid, THREADS, smem, stream>>>(
      (const float*)P, (const T*)X, (T*)Y, n, n, D, panels);
  return (int)cudaGetLastError();
}

// The row panel: TM = max(ceil(m / 8), ROWS_TM_MIN) rows a thread, panels
// of 128 columns in a 2-stage ring of n rows.
constexpr int ROWS_PANEL = 128;
constexpr int ROWS_STAGES = 2;
static_assert(fits(RESIDENT_MAX_N, ROWS_STAGES, ROWS_PANEL, sizeof(float)),
              "the row panel's shared memory");

template <typename T, int TM>
int launch_rows(const void* P, const void* X, void* Y, int64_t m, int64_t n, int64_t D,
                cudaStream_t stream) {
  // P's rows are padded to the kernel's TM * 8, which may exceed m.
  const size_t smem = resident_smem(TM * WARPS, n, ROWS_STAGES, ROWS_PANEL, sizeof(T));
  const int64_t panels = (D + ROWS_PANEL - 1) / ROWS_PANEL;
  int grid = 0;
  const int rc = panel::persistent_grid(
      mix_resident_kernel<T, TM, ROWS_STAGES, ROWS_PANEL>, THREADS, smem, panels, &grid);
  if (rc) return rc;
  mix_resident_kernel<T, TM, ROWS_STAGES, ROWS_PANEL><<<grid, THREADS, smem, stream>>>(
      (const float*)P, (const T*)X, (T*)Y, m, n, D, panels);
  return (int)cudaGetLastError();
}

// The row panel takes at least 3 rows a thread: nvcc 12.8 spills 8 bytes
// in the f32 instance at 2, and the extra rows of a smaller m are zero rows
// of P, which cost FMAs only.
constexpr int ROWS_TM_MIN = 3;

template <typename T, int TM = ROWS_TM_MIN>
int dispatch_rows(const void* P, const void* X, void* Y, int64_t m, int64_t n, int64_t D,
                  cudaStream_t stream) {
  if constexpr (TM > TM_MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if ((m + 7) / 8 <= TM) return launch_rows<T, TM>(P, X, Y, m, n, D, stream);
    return dispatch_rows<T, TM + 1>(P, X, Y, m, n, D, stream);
  }
}

template <typename T, int TM = 1>
int dispatch_resident(const void* P, const void* X, void* Y, int64_t n, int64_t D,
                      cudaStream_t stream) {
  if constexpr (TM > TM_MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if ((n + 7) / 8 == TM) return launch_resident<T, TM>(P, X, Y, n, D, stream);
    return dispatch_resident<T, TM + 1>(P, X, Y, n, D, stream);
  }
}

template <typename T>
int launch_tiled(const void* P, const void* X, void* Y, int64_t m, int64_t n, int64_t D,
                 cudaStream_t stream) {
  const int64_t m_tiles = (m + BM - 1) / BM;
  const int64_t d_tiles = (D + BN - 1) / BN;
  mix_tiled_kernel<T><<<(unsigned)(m_tiles * d_tiles), TILED_THREADS, 0, stream>>>(
      (const float*)P, (const T*)X, (T*)Y, m, n, D, m_tiles);
  return (int)cudaGetLastError();
}

// The square mix (m = n), or a row panel of it.
template <typename T>
int launch(const void* P, const void* X, void* Y, int64_t m, int64_t n, int64_t D,
           cudaStream_t stream) {
  if (m <= 0 || D <= 0) return (int)cudaGetLastError();
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (m == n && n <= RESIDENT_MAX_N) return dispatch_resident<T>(P, X, Y, n, D, stream);
  if (m <= RESIDENT_MAX_N && n <= RESIDENT_MAX_N)
    return dispatch_rows<T>(P, X, Y, m, n, D, stream);
  return launch_tiled<T>(P, X, Y, m, n, D, stream);
}

}  // namespace

// dtype: 0 = float32 bank, 1 = bfloat16 bank.  Y = P @ X with P (m, n)
// f32, X (n, D) and Y (m, D) in the bank dtype: m = n for the square mix,
// m < n for a row panel.  Returns a cudaError_t.
extern "C" int gossip_matmul_launch(int dtype, const void* P, const void* X, void* Y,
                                    int64_t m, int64_t n, int64_t D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(P, X, Y, m, n, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(P, X, Y, m, n, D, s);
  return (int)cudaErrorInvalidValue;
}
