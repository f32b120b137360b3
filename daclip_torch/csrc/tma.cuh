// Hopper's asynchronous copy machinery for sm_90a, in inline PTX: the
// Tensor Memory Accelerator (TMA) loads a whole tile from device memory into
// shared memory, described by a tensor map, and reports its bytes to an
// mbarrier in shared memory; mbarriers also count the arrivals of threads,
// so a ring of stages needs one "full" barrier (the producer's expected
// bytes) and one "empty" barrier (the consumers' releases) a stage.
//
// Host side: `encode_rows` builds the tensor map of one head's (N, D)
// slices of a packed (B, N, H·D) bf16 tensor; `encode_boxes` that of 64 × 64
// boxes of a (B, rows, cols) bf16 tensor (row tiles, weights, spills);
// `encode_map` that of any bf16 tensor of up to five dimensions (the dual
// 1×1's rows and weights, the 3×3 conv's halo strips and weights). cuTensorMapEncodeTiled is a
// driver function; it is reached through cudaGetDriverEntryPoint, so the
// library links against the runtime alone (no -lcuda). Plain C interface,
// no PyTorch headers.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace daclip {
namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to every thread and to the TMA unit.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and announce `bytes` of copies that will complete on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of parity `parity` (the
// phase before the current one counts as complete, so a producer's first
// wait on an empty stage, parity 1, passes at once). A wait that lasts
// 2^36 clocks (tens of seconds) is a fault of the kernel, not a slow copy:
// it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 36)) __trap();
}

// -- TMA -------------------------------------------------------------------------
// Load the box at coordinates (c0, c1, c2) of the 3-D tensor map `map` (a
// __grid_constant__ kernel parameter) into shared memory at `dst`; its bytes
// complete on `bar`. Elements outside the tensor are filled with zeros.
__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 4-D tensor map, at coordinates (c0, c1, c2, c3); coordinates
// may be negative, and the box's elements outside the tensor are zeros.
__device__ __forceinline__ void load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Store the box at (c0, c1, c2) of the 3-D tensor map `map` from shared
// memory at `src`, in this thread's bulk group; the box's elements outside
// the tensor are not written.
__device__ __forceinline__ void store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Fetch a tensor map (a __grid_constant__ kernel parameter) into the TMA
// unit's cache ahead of its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// -- element path ------------------------------------------------------------------
// Two bf16 values in one 32-bit word, the first in the lower half.
__device__ __forceinline__ uint32_t pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Zero `bytes` (a multiple of 16) of shared memory at `dst`, thread t of
// `threads`.
__device__ __forceinline__ void zero_smem(unsigned char* dst, int bytes, int t, int threads) {
  for (int i = 16 * t; i < bytes; i += 16 * threads)
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(0u, 0u, 0u, 0u);
}

// -- named barriers ---------------------------------------------------------------
// Barrier `id` (1-15; 0 is __syncthreads') over `threads` threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- a ring of stages of run-time depth ------------------------------------------
// The barriers of a ring of `stages` stages at `bars`: full[s], then empty[s].
// Step `it` uses stage it % stages in round it / stages. A stage's "full"
// barrier completes on the producer's arrival and the copies' bytes; its
// "empty" barrier on one arrival of every consumer warp.
struct Ring {
  uint32_t bars;
  int stages;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
  __device__ __forceinline__ void init(int full_count, int empty_count) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), empty_count);
    }
  }
  __device__ __forceinline__ void wait_full(int it) const {
    mbar_wait(full(it % stages), (it / stages) & 1);
  }
  // the producer's wait: round 0 passes at once
  __device__ __forceinline__ void wait_empty(int it) const {
    mbar_wait(empty(it % stages), ((it / stages) & 1) ^ 1);
  }
  // a consumer warp is done with step it's stage
  __device__ __forceinline__ void release(int it) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(it % stages));
  }
};

// -- registers ---------------------------------------------------------------------
// Lower this warp's register count to R (the whole warpgroup, or a lone warp
// in its own warpgroup, executes it).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- host ------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a bf16 tensor of `rank` dimensions (innermost first, `dims`;
// `strides`: the rank − 1 outer strides in bytes) with boxes of `box`
// elements, in `swizzle`; elements of a box outside the tensor are zeros.
// The innermost dimension's bytes and every stride must be multiples of 16.
inline cudaError_t encode_map(CUtensorMap* map, const void* ptr, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a packed (B, N, H·D) bf16 tensor as (H·D, N, B) with boxes of
// (D, rows, 1): the box at (h·D, r0, b) is rows [r0, r0 + rows) of head h of
// batch element b, D·2 bytes a row, zeros past N (the next batch element is
// another coordinate, never read in its place). D = 32 takes the 64-byte
// swizzle, D = 64 the 128-byte one: the swizzle of a row is its width.
inline cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int B, int N, int H, int D,
                               int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)N * H * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  return encode_map(map, ptr, 3, dims, strides, box,
                    D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// The map of a (B, rows, cols) bf16 tensor (a matrix: B = 1) as (cols, rows,
// B) with boxes of (64, 64, 1) in the 128-byte swizzle: the box at (c0, r0,
// b) is rows [r0, r0 + 64) × columns [c0, c0 + 64) of batch element b, 128
// bytes a row, zeros past `rows` or `cols` (the next batch element is another
// coordinate, never read in its place). cols must be a multiple of 8.
inline cudaError_t encode_boxes(CUtensorMap* map, const void* ptr, long B, long rows, long cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace tma
}  // namespace daclip
