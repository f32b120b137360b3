// The bf16 flash kernels' Hopper tiles (forward `fwd_wgmma_kernel` in
// flash_attention.cu; backward `dq_wgmma_kernel` and `dkv_wgmma_kernel` in
// flash_attention_bwd.cu). A CTA holds a consumer warpgroup, which owns 64
// rows of one head (queries, or keys in dkv), and one producer warp. It
// loads the CTA's own rows once and then streams 64-row tiles of the other
// side through a ring of stages, each tile one TMA box of one head's (N, D)
// slice of a packed (B, N, H·D) tensor (tma.cuh `encode_rows`: D·2-byte rows
// in the swizzle of their width, zeros past N). A stage's "full" barrier
// completes on the producer's arrival and the copies' bytes; its "empty"
// barrier on one arrival of every consumer warp once the warpgroup's
// products that read it are done. Plain C interface, no PyTorch headers.
#pragma once

#include "mma.cuh"
#include "tma.cuh"

namespace daclip {
namespace flash_tiles {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;  // rows a consumer warpgroup owns
constexpr int COLS = 64;  // rows of a streamed tile

template <int D>
struct Tile {
  static constexpr int RB = 2 * D;             // bytes a row: the swizzle width
  static constexpr int BYTES = COLS * RB;      // one (64 × D) bf16 tile
};

// A CTA is the consumer warpgroup (warps 0-3) and the producer warp (4).
// With `minb` CTAs an SM, ptxas gives every thread 16,384 / (32 · w)
// registers (rounded down to 8), w the warps in each of the SM's four
// quarters, ceil(5·minb / 4): at most 128 at three CTAs, 168 at two.
// setmaxnreg gives the consumers no more (ptxas 12.9: after a consumer-side
// setmaxnreg.inc it still allotted the code within that count); one
// producer warp in place of a producer warpgroup fits three CTAs at 128
// registers where two fit. A kernel without setmaxnreg may get fewer (the
// forward at D = 32: 90, four CTAs an SM); only dkv's producer runs one,
// which keeps dkv<32> in 128 registers without a spill.
constexpr int THREADS_A_CTA = 160;

// This thread's warpgroup (0 the consumers, 1 the producer warp), taken
// from lane 0 by a shuffle so that the compiler sees it uniform across the
// warp: with the roles split on it the flash kernels ran 2.4-3.7% faster on
// the H100 than split on threadIdx.x / 32 (PERF.md).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
}

// The CTA's dynamic shared memory from its first 1024-byte boundary (the
// swizzle atoms and the wgmma descriptors assume it; launchers ask for
// 1024 bytes more).
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  return (tma::smem_addr(smem) + 1023u) & ~1023u;
}

// The barriers of a ring of STAGES stages at `bars`: full[s], then empty[s].
// Iteration `it` uses stage it % STAGES in round it / STAGES.
template <int STAGES>
struct Ring {
  uint32_t bars;
  static constexpr int BYTES = 16 * STAGES;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (STAGES + s); }
  __device__ __forceinline__ void init(int full_count, int empty_count) const {
    for (int s = 0; s < STAGES; ++s) {
      tma::mbar_init(full(s), full_count);
      tma::mbar_init(empty(s), empty_count);
    }
  }
  __device__ __forceinline__ void wait_full(int it) const {
    tma::mbar_wait(full(it % STAGES), (it / STAGES) & 1);
  }
  // the producer's wait: round 0 passes at once
  __device__ __forceinline__ void wait_empty(int it) const {
    tma::mbar_wait(empty(it % STAGES), ((it / STAGES) & 1) ^ 1);
  }
  // a consumer warp is done with iteration it's stage
  __device__ __forceinline__ void release(int it) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) tma::mbar_arrive(empty(it % STAGES));
  }
};

template <int J>
__device__ __forceinline__ void zero(float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// The A fragments of P (or dS) for the four k16 steps over a tile's 64
// columns, from its f32 accumulators (n8 tiles 2kk and 2kk + 1), in bf16.
__device__ __forceinline__ void pack_tile(uint32_t (&a)[COLS / 16][4],
                                          const float (&s)[COLS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < COLS / 16; ++kk) mma::pack_a(a[kk], s[2 * kk], s[2 * kk + 1]);
}

// Rows r and r + 8 (r = this lane's group) of a (16 × D) f32 accumulator,
// cast to bf16, to rows `row` and `row` + 8 of a packed tensor if below N.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 8][4],
                                           int row, int N, int HD) {
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < N)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * HD + 8 * j + c) =
          mma::pack_bf16(acc[j][0], acc[j][1]);
    if (row + 8 < N)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row + 8) * HD + 8 * j + c) =
          mma::pack_bf16(acc[j][2], acc[j][3]);
  }
}

// Host: raise a kernel's dynamic shared memory limit to `bytes`, once a
// device. Tag and ID name the kernel (its function type alone may be shared).
constexpr int MAX_DEVICES = 64;
template <class Tag, int ID, class Kernel>
inline cudaError_t smem_opt_in(Kernel kernel, int bytes) {
  static bool opted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace flash_tiles
}  // namespace daclip
