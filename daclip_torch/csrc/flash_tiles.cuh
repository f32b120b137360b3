// The bf16 tensor-core flash kernels' tiles (forward `fwd_mma_kernel` in
// flash_attention.cu; backward `dq_mma_kernel` and `dkv_mma_kernel` in
// flash_attention_bwd.cu): a CTA of 4 warps owns 64 rows of one head, 16 per
// warp, and streams 64-row tiles of the other side through a 3-stage cp.async
// ring. One head's (N, D) slice of a packed (B, N, H·D) tensor is copied into
// shared memory in 16-byte chunks, rows padded to D + 8 elements so that
// every ldmatrix is free of bank conflicts; rows past N are zero. Plain C
// interface, no PyTorch headers.
#pragma once

#include "mma.cuh"

namespace daclip {
namespace flash_tiles {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;    // the CTA's own rows: 16 per warp
constexpr int COLS = 64;    // rows of a streamed tile
constexpr int THREADS = 128;
constexpr int STAGES = 3;

template <int D>
struct Tile {
  static constexpr int LD = D + 8;                       // padded row, elements
  static constexpr size_t BYTES = (size_t)COLS * LD * 2;  // one (64 × D) bf16 tile
};

// Copy rows [r0, r0 + 64) of one head's (N, D) slice of a packed tensor into
// a padded shared tile; rows past N are zero.
template <int D>
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          int r0, int N, int HD) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < COLS * CH; e += THREADS) {
    const int r = e / CH, c = (e - r * CH) * 8;
    const bool ok = r0 + r < N;
    mma::cp_async16(dst + r * Tile<D>::LD + c, src + (size_t)(ok ? r0 + r : 0) * HD + c, ok);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
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

}  // namespace flash_tiles
}  // namespace daclip
