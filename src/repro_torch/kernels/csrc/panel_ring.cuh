// Column panels of the (n, D) client bank staged in shared memory for the
// two gossip mixes (gossip_gather.cu, gossip_matmul.cu): a ring of STAGES
// panels that one producer warp fills with TMA bulk copies while the
// consumer warps mix the panels that have landed.
//
// The flat bank's rows are not 16-byte aligned: row r starts at byte
// r * D * sizeof(T), and the main path's D = 1,756,426 is 2 (mod 4).  So
// no 2-D tensor map can describe the bank (its row stride must be a
// multiple of 16 bytes), and no 16-byte copy starts at every row's first
// column.  Instead each row's segment of a panel is one 1-D bulk copy
// (cp.async.bulk) of the whole 16-byte chunks that cover it, from the
// aligned address at or below its first column, and lands in shared
// memory at the same offset within its chunk: row r of a stage starts at
// byte r * rs (rs a multiple of 16, at least the panel's bytes plus 16),
// and its column c at byte r * rs + shift(r) + c * sizeof(T), shift(r)
// being the row's address modulo 16.  The parts of a chunk outside the bank
// (before its first byte when it does not start on 16 bytes, after its
// last) are never read: the columns there are copied element by element
// instead.  Bytes of a chunk that belong to a neighbouring row or column
// are copied and never used.  With panels of C columns and C * sizeof(T) a
// multiple of 16, shift(r) is the same in every panel.
//
// Each stage has a full mbarrier (one arrival per row, plus the bulk
// copies' bytes) and an empty one (one arrival per consumer warp).  A
// producer lane owns rows lane, lane + 32, ...: it waits until the stage
// is empty, copies its rows' edge columns, arrives on the full barrier
// with the bytes it expects and issues its rows' bulk copies.  The
// consumers wait on the full barrier, mix, and release the stage.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace panel {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory; its bytes complete on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bytes of a stage row holding C columns of T (C * sizeof(T) a multiple
// of 16): the columns, plus up to 15 bytes of shift, rounded up to 16.
__host__ __device__ constexpr int64_t row_stride(int64_t C, int64_t elem) {
  return C * elem + 16;
}

// Columns of panel p (C columns each) that lie inside the bank's D.
__device__ __forceinline__ int64_t cols(int64_t C, int64_t D, int64_t p) {
  return D - p * C < C ? D - p * C : C;
}

// The byte offset of row r's first column within its 16-byte chunk.
template <typename T>
__device__ __forceinline__ int shift(const T* X, int64_t r, int64_t D) {
  return (int)(((uintptr_t)X + (uintptr_t)(r * D) * sizeof(T)) & 15);
}

// Diagnosis builds (mix_diagnose.py) define one of these; the library
// defines neither.  PANEL_DIAG_COPY_ONLY: the consumers release each panel
// unread (the ring's copies alone).  PANEL_DIAG_COMPUTE_ONLY: the producer
// copies nothing and only arrives on each stage, so the consumers mix
// whatever the ring holds (the arithmetic and the stores alone).
#ifdef PANEL_DIAG_COPY_ONLY
constexpr bool DIAG_SKIP_MIX = true;
#else
constexpr bool DIAG_SKIP_MIX = false;
#endif
#ifdef PANEL_DIAG_COMPUTE_ONLY
constexpr bool DIAG_SKIP_COPY = true;
#else
constexpr bool DIAG_SKIP_COPY = false;
#endif

// The ring's barriers: STAGES full, then STAGES empty, at the start of
// the dynamic shared memory (BARRIER_BYTES, which keeps what follows
// 16-byte aligned).
constexpr int BARRIER_BYTES = 128;

template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* bars, int64_t n, int consumer_warps) {
  static_assert(2 * STAGES * 8 <= BARRIER_BYTES, "ring barriers");
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + s, (uint32_t)n);
      mbar_init(bars + STAGES + s, (uint32_t)consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// Producer lane `lane`: copy its rows of panel columns [c0, c0 + pw) of X
// into the stage at dst (row stride rs), arriving on `full` once per row.
template <typename T>
__device__ __forceinline__ void fill_stage(unsigned char* dst, const T* X, int64_t n,
                                           int64_t D, int64_t c0, int64_t pw, int64_t rs,
                                           uint64_t* full, int lane) {
  const uintptr_t x_lo = ((uintptr_t)X + 15) & ~(uintptr_t)15;
  const uintptr_t x_hi = (uintptr_t)(X + n * D) & ~(uintptr_t)15;
  for (int64_t r = lane; r < n; r += 32) {
    const uintptr_t g = (uintptr_t)(X + r * D + c0);
    const uintptr_t g_end = g + pw * sizeof(T);
    const uintptr_t a0 = g & ~(uintptr_t)15;
    uintptr_t lo = a0 > x_lo ? a0 : x_lo;
    uintptr_t hi = (g_end + 15) & ~(uintptr_t)15;
    hi = hi < x_hi ? hi : x_hi;
    if (hi <= lo) lo = hi = g_end;  // no whole chunk inside the bank
    unsigned char* row = dst + r * rs;  // holds the bytes from a0 on
    const uintptr_t head_end = lo < g_end ? lo : g_end;
    const uintptr_t tail = hi > g ? hi : g;
    for (uintptr_t e = g; e < head_end; e += sizeof(T))
      *reinterpret_cast<T*>(row + (e - a0)) = *reinterpret_cast<const T*>(e);
    for (uintptr_t e = tail; e < g_end; e += sizeof(T))
      *reinterpret_cast<T*>(row + (e - a0)) = *reinterpret_cast<const T*>(e);
    // Order the plain stores before the bulk copies that may later write
    // the same bytes of this stage.
    if (head_end > g || tail < g_end)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive_expect_tx(full, (uint32_t)(hi - lo));
    if (hi > lo) bulk_copy(row + (lo - a0), (const void*)lo, (uint32_t)(hi - lo), full);
  }
}

// The producer warp's loop: fill f of the ring copies panel blockIdx.x +
// f * gridDim.x into stage f % STAGES, once the consumers released that
// stage's previous panel (fill f - STAGES).
template <typename T, int STAGES>
__device__ __forceinline__ void produce(unsigned char* ring, int64_t stage_bytes,
                                        uint64_t* bars, const T* X, int64_t n, int64_t D,
                                        int64_t C, int64_t panels, int64_t rs, int lane) {
  int f = 0;
  for (int64_t p = blockIdx.x; p < panels; p += gridDim.x, ++f) {
    const int s = f % STAGES;
    if (f >= STAGES) mbar_wait(bars + STAGES + s, (uint32_t)((f / STAGES - 1) & 1));
    if (DIAG_SKIP_COPY) {
      for (int64_t r = lane; r < n; r += 32) mbar_arrive_expect_tx(bars + s, 0);
      continue;
    }
    fill_stage(ring + s * stage_bytes, X, n, D, p * C, cols(C, D, p), rs, bars + s, lane);
  }
}

// Persistent blocks for a kernel with this dynamic shared memory: as many
// as fit on the card at once, at most `work`.  Sets the kernel's dynamic
// shared memory limit first.  Returns a cudaError_t.
template <typename K>
int persistent_grid(K kernel, int threads, size_t smem, int64_t work, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t g = (int64_t)sms * per_sm;
  *grid = (int)(g < work ? g : work);
  return 0;
}

// Dynamic shared memory a block may opt into on sm_90 (227 KB).
constexpr size_t SMEM_LIMIT = 232448;

}  // namespace panel
