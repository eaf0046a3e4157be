// Sparse push-sum mix over receiver-side neighbor lists:
//
//     Y[i] = sum_l wgt[i, l] * X[idx[i, l]]      l = 0 .. k_max - 1
//
// accumulated in f32, one slot at a time in slot order, and stored in the
// bank dtype.  Pad slots carry weight 0 and add exactly 0.  There are m
// receivers (rows of idx, wgt and Y) and n source rows (of X): m = n for
// the mix of a whole bank; m < n for a row-sharded bank's local receivers
// over the gathered bank, or over its own rows and their halo.
//
// Replaces the TPU kernel src/repro/kernels/gossip_gather.py
// (gossip_gather_pallas, _kernel).  The slot order is the reference's own
// (acc = w_0 x_0, then acc += w_l x_l), and every multiply and add is an
// explicit round-to-nearest intrinsic so nvcc contracts nothing into an
// FMA: the result is bit for bit the slot loop of the plain version.
//
// Bound: bytes.  Each output element reads k_max input elements and does
// 2 k_max flops, well under the card's balance point, and device memory
// has to supply X once and take Y once.  Reading each receiver's k_max
// source rows from device memory or L2 would move k_max times X through
// L2 (7.7 GB per mix at n = 100, k_max = 11, against 0.7 GB of X), so the
// panel kernel stages X instead:
//
// * Persistent blocks (as many as fit on the card) walk column panels of
//   C columns.  All n rows of a panel are copied into shared memory once,
//   through a ring of STAGES panels (panel_ring.cuh): one producer warp
//   fills each stage with one TMA bulk copy per row, whatever the rows'
//   alignment, so the next panels' copies run while this one is mixed and
//   the 16 consumer warps spend no instruction on them.
// * Each receiver row of the panel is one consumer warp's work (32 / C
//   rows per warp when C < 32): each lane owns C / 32 columns, walks the
//   slot loop reading its source rows from shared memory (a slot is one
//   broadcast 8-byte read: its source row's offset in the stage, and its
//   weight) and stores its columns coalesced.
// * C is the widest panel (a multiple of 32 up to 256; in bf16 also 16 or 8
//   columns) for which STAGES panels of n rows and the n * k_max slots fit
//   in shared memory.  At n = 100, k_max = 11 that is 160 columns in f32
//   and 256 in bf16, one block per SM.  f32 panels narrower than 32
//   columns lost to the row kernel at every shape timed (D = 199,210, n =
//   600 to 1280: 2.7x to 15.0x slower), so f32 takes none; bf16's narrow
//   panels were not timed and stay.
//
// Where not even the narrowest panel fits (n in the high hundreds to
// thousands, or very long lists), the launcher takes the row kernel: one
// block per (receiver row, 1024-column chunk), slot indices and weights in
// shared memory, source rows read through L2, all receiver rows of one
// chunk run back to back so the chunk is read from device memory about
// once.
#include "panel_ring.cuh"

namespace {

using panel::from_f32;
using panel::to_f32;

constexpr int STAGES = 3;
constexpr int WARPS = 16;                 // consumers; one more warp produces
constexpr int THREADS = (WARPS + 1) * 32;
constexpr int MAX_COLS = 256;  // widest panel: 8 columns per lane

// One receiver row of a panel, by the lanes of a warp that own it: lane
// col0 owns columns col0 + lanes * v (v < V).  FULL: the panel holds all
// its columns (every panel but the last), so no column is masked.
template <typename T, int V, bool FULL>
__device__ __forceinline__ void mix_row(const unsigned char* stage, const int2* sl,
                                        int64_t k_max, int col0, int lanes, int pw,
                                        T* out) {
  float acc[V];
  {
    const int2 s0 = sl[0];
    const T* src = reinterpret_cast<const T*>(stage + s0.x);
    const float w0 = __int_as_float(s0.y);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = col0 + v * lanes;
      if (FULL || col < pw) acc[v] = __fmul_rn(w0, to_f32(src[col]));
    }
  }
#pragma unroll 4
  for (int64_t l = 1; l < k_max; ++l) {
    const int2 s = sl[l];
    const T* src = reinterpret_cast<const T*>(stage + s.x);
    const float wl = __int_as_float(s.y);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = col0 + v * lanes;
      if (FULL || col < pw) acc[v] = __fadd_rn(acc[v], __fmul_rn(wl, to_f32(src[col])));
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int col = col0 + v * lanes;
    if (FULL || col < pw) out[col] = from_f32<T>(acc[v]);
  }
}

// V: columns per lane, C / 32 for panels of C >= 32 columns, else 1 (a
// row then takes C lanes and a warp 32 / C rows).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gather_panels_kernel(const int32_t* __restrict__ idx, const float* __restrict__ wgt,
                     const T* __restrict__ X, T* __restrict__ Y, int64_t m, int64_t n,
                     int64_t k_max, int64_t D, int64_t C, int64_t panels) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + panel::BARRIER_BYTES;
  const int64_t rs = panel::row_stride(C, sizeof(T));
  const int64_t stage_bytes = n * rs;
  // Each slot as (byte offset of its source row within a stage, weight):
  // the offset is the same in every panel.
  int2* slots = reinterpret_cast<int2*>(ring + STAGES * stage_bytes);
  for (int64_t i = threadIdx.x; i < m * k_max; i += THREADS)
    slots[i] = make_int2((int)(idx[i] * rs + panel::shift(X, idx[i], D)),
                         __float_as_int(wgt[i]));
  panel::init_ring<STAGES>(bars, n, WARPS);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == WARPS) {
    panel::produce<T, STAGES>(ring, stage_bytes, bars, X, n, D, C, panels, rs, lane);
    return;
  }
  const int lanes = C < 32 ? (int)C : 32;  // lanes per receiver row
  const int rows_per_warp = 32 / lanes;
  const int sub = lane / lanes, col0 = lane % lanes;

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
    const int64_t c0 = p * C;
    const int pw = (int)panel::cols(C, D, p);
    for (int64_t row = (int64_t)warp * rows_per_warp + sub; row < m;
         row += (int64_t)WARPS * rows_per_warp) {
      if (pw == C)
        mix_row<T, V, true>(stage, slots + row * k_max, k_max, col0, lanes, pw,
                            Y + row * D + c0);
      else
        mix_row<T, V, false>(stage, slots + row * k_max, k_max, col0, lanes, pw,
                             Y + row * D + c0);
    }
    __syncwarp();
    if (lane == 0) panel::mbar_arrive(bars + STAGES + s);
  }
}

constexpr int ROW_THREADS = 256;
constexpr int ROW_PER_THREAD = 4;
constexpr int ROW_CHUNK = ROW_THREADS * ROW_PER_THREAD;  // columns per block

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
gather_rows_kernel(const int32_t* __restrict__ idx, const float* __restrict__ wgt,
                   const T* __restrict__ X, T* __restrict__ Y, int64_t m,
                   int64_t k_max, int64_t D) {
  extern __shared__ unsigned char smem[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem);
  float* s_wgt = reinterpret_cast<float*>(smem + k_max * sizeof(int32_t));

  const int64_t row = blockIdx.x % m;
  const int64_t c0 = (blockIdx.x / m) * ROW_CHUNK;
  for (int64_t l = threadIdx.x; l < k_max; l += ROW_THREADS) {
    s_idx[l] = idx[row * k_max + l];
    s_wgt[l] = wgt[row * k_max + l];
  }
  __syncthreads();

  int64_t col[ROW_PER_THREAD];
  float acc[ROW_PER_THREAD];
#pragma unroll
  for (int j = 0; j < ROW_PER_THREAD; ++j) {
    col[j] = c0 + threadIdx.x + (int64_t)j * ROW_THREADS;
    acc[j] = 0.0f;
  }
  for (int64_t l = 0; l < k_max; ++l) {
    const T* src = X + (int64_t)s_idx[l] * D;
    const float wl = s_wgt[l];
#pragma unroll
    for (int j = 0; j < ROW_PER_THREAD; ++j) {
      if (col[j] < D) {
        const float term = __fmul_rn(wl, to_f32(src[col[j]]));
        acc[j] = (l == 0) ? term : __fadd_rn(acc[j], term);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < ROW_PER_THREAD; ++j)
    if (col[j] < D) Y[row * D + col[j]] = from_f32<T>(acc[j]);
}

// Shared memory of the panel kernel with panels of C columns: n source
// rows a stage, m receivers' slots.
size_t panel_smem(int64_t m, int64_t n, int64_t k_max, int64_t C, size_t elem) {
  return (size_t)(panel::BARRIER_BYTES + STAGES * n * panel::row_stride(C, elem) +
                  m * k_max * sizeof(int2));
}

// The panel width the panel kernel takes at (m, n, k_max), or 0 where not
// even the narrowest panel fits (32 columns in f32; 16 bytes a row in
// bf16): the row kernel's shapes.
int64_t panel_cols(int64_t m, int64_t n, int64_t k_max, size_t elem) {
  for (int64_t C = MAX_COLS; C >= 32; C -= 32)
    if (panel_smem(m, n, k_max, C, elem) <= panel::SMEM_LIMIT) return C;
  if (elem == sizeof(float)) return 0;
  for (int64_t C = 16; C * (int64_t)elem >= 16; C /= 2)
    if (panel_smem(m, n, k_max, C, elem) <= panel::SMEM_LIMIT) return C;
  return 0;
}

template <typename T, int V>
int launch_panels(const void* idx, const void* wgt, const void* X, void* Y, int64_t m,
                  int64_t n, int64_t k_max, int64_t D, int64_t C, cudaStream_t stream) {
  const size_t smem = panel_smem(m, n, k_max, C, sizeof(T));
  const int64_t panels = (D + C - 1) / C;
  int grid = 0;
  const int rc = panel::persistent_grid(gather_panels_kernel<T, V>, THREADS, smem, panels,
                                        &grid);
  if (rc) return rc;
  gather_panels_kernel<T, V><<<grid, THREADS, smem, stream>>>(
      (const int32_t*)idx, (const float*)wgt, (const T*)X, (T*)Y, m, n, k_max, D, C,
      panels);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* idx, const void* wgt, const void* X, void* Y, int64_t m, int64_t n,
           int64_t k_max, int64_t D, cudaStream_t stream) {
  if (m <= 0 || D <= 0) return (int)cudaGetLastError();
  if (k_max < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int64_t C = panel_cols(m, n, k_max, sizeof(T));
  if (C > 0) {
    switch (C >= 32 ? C / 32 : 1) {
      case 1: return launch_panels<T, 1>(idx, wgt, X, Y, m, n, k_max, D, C, stream);
      case 2: return launch_panels<T, 2>(idx, wgt, X, Y, m, n, k_max, D, C, stream);
      case 3: return launch_panels<T, 3>(idx, wgt, X, Y, m, n, k_max, D, C, stream);
      case 4: return launch_panels<T, 4>(idx, wgt, X, Y, m, n, k_max, D, C, stream);
      case 5: return launch_panels<T, 5>(idx, wgt, X, Y, m, n, k_max, D, C, stream);
      case 6: return launch_panels<T, 6>(idx, wgt, X, Y, m, n, k_max, D, C, stream);
      case 7: return launch_panels<T, 7>(idx, wgt, X, Y, m, n, k_max, D, C, stream);
      default: return launch_panels<T, 8>(idx, wgt, X, Y, m, n, k_max, D, C, stream);
    }
  }
  const size_t smem = (size_t)k_max * (sizeof(int32_t) + sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gather_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t chunks = (D + ROW_CHUNK - 1) / ROW_CHUNK;
  gather_rows_kernel<T><<<(unsigned)(m * chunks), ROW_THREADS, smem, stream>>>(
      (const int32_t*)idx, (const float*)wgt, (const T*)X, (T*)Y, m, k_max, D);
  return (int)cudaGetLastError();
}

size_t elem_size(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

}  // namespace

// dtype: 0 = float32 bank, 1 = bfloat16 bank.  m receivers over n source
// rows (m = n for the mix of a whole bank): idx is int32 and wgt float32,
// both (m, k_max) row-major, X is (n, D), Y is (m, D), every index in
// [0, n).  Returns a cudaError_t.
extern "C" int gossip_gather_launch(int dtype, const void* idx, const void* wgt,
                                    const void* X, void* Y, int64_t m, int64_t n,
                                    int64_t k_max, int64_t D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(idx, wgt, X, Y, m, n, k_max, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(idx, wgt, X, Y, m, n, k_max, D, s);
  return (int)cudaErrorInvalidValue;
}

// The panel width gossip_gather_launch takes at (m, n, k_max) for this
// dtype, or 0 where it takes the row kernel (-1 for an unknown dtype).
extern "C" int64_t gossip_gather_panel_cols(int dtype, int64_t m, int64_t n,
                                            int64_t k_max) {
  const size_t elem = elem_size(dtype);
  return elem ? panel_cols(m, n, k_max, elem) : -1;
}
