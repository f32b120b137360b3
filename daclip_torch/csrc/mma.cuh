// Tensor-core building blocks for sm_90a, in inline PTX: ldmatrix, the
// re-packing of an accumulator into an A operand (FlashAttention-2's register
// reuse), and the warpgroup's wgmma m64n64k16 / m64n32k16 with A in registers
// or in shared memory and B in shared memory, on tiles that TMA writes in the
// swizzle of their row width (64 or 128 bytes): their descriptors and the
// A and B transpose bits (K-major or MN-major). Plain C interface, no PyTorch
// headers.
//
// Accumulator layout: wgmma m64nNk16 gives warp w of the warpgroup rows
// 16w .. 16w + 15 of the 64, in the fragment layout of the warp's
// mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"), one n8
// tile at a time; for lane l, g = l / 4 (the "group"), t = l % 4:
//   C/D (16×8, f32): four floats,
//       c[0], c[1] = C[g][2t, 2t+1]       c[2], c[3] = C[g+8][2t, 2t+1]
//   A (16×16, bf16, registers): four 32-bit registers, each two consecutive
//     k of one row, the lower k in the lower half:
//       a[0] = A[g][2t, 2t+1]     a[1] = A[g+8][2t, 2t+1]
//       a[2] = A[g][2t+8, 2t+9]   a[3] = A[g+8][2t+8, 2t+9]
// So the accumulators of two neighbouring n8 tiles (columns 0-7 and 8-15)
// hold, lane for lane, the A operand of a k16 step over those 16 columns:
// `pack_a` rounds them to bf16 and re-packs them without leaving registers.
//
// ldmatrix .x4: lanes 8i..8i+7 give the row addresses (16 bytes each, 16-byte
// aligned) of 8×8 bf16 matrix i; lane l receives in r[i] the pair
// M_i[g][2t, 2t+1].
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace daclip {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `addr`: this lane's row address in the shared window (a 32-bit address)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two floats rounded to bf16 and packed, the first in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a k16 step from the accumulators of the two n8 tiles
// that cover its 16 k columns (c0: columns 0-7, c1: 8-15), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// -- wgmma (warpgroup products, sm_90a) ------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy shared-memory writes (plain stores)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma on TMA tiles ------------------------------------------------------------
// A tile of bf16 rows of RB bytes (RB = 64: D = 32; RB = 128: D = 64) as TMA
// writes it with the swizzle of its width (the 16-byte chunk c of row r at
// chunk c ^ (r % 8) for 128 bytes, c ^ (r / 2 % 4) for 64: address bits 4-6
// or 4-5 XOR bits 7-9 or 7-8), each tile 1024-byte aligned. As a K-major
// operand (rows = M or N, the row = K) its k16 step kk starts 32·kk bytes
// into the tile; as an MN-major one (rows = K, the row = N, one swizzle atom
// wide) its k16 step kk starts at row 16·kk. Either way 8-row groups are
// 8·RB bytes apart (the stride offset); the leading offset is unused with
// one atom across (bits 0-13: address / 16, 16-29: leading offset, 32-45:
// stride offset / 16, 62-63: layout, 1 = 128-byte swizzle, 2 = 64-byte).
template <int RB>
__device__ __forceinline__ uint64_t wgmma_desc_sw(uint32_t addr) {
  static_assert(RB == 64 || RB == 128, "rows of 64 or 128 bytes");
  constexpr uint64_t layout = RB == 64 ? 2 : 1;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * RB) >> 4) << 32) | (layout << 62);
}

// D (64 × 64, f32) = A (64 × 16, shared memory, `da`; TA 0: K-major, 1:
// MN-major, the operand of a product that contracts over a tile's rows) ·
// B (16 × 64, shared memory, `db`; TB 0: K-major, 1: MN-major) + D, or
// without the + D when `accumulate` is 0; d[j] is n8 tile j of this warp's
// 16 rows as an mma.sync C fragment.
template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB), "n"(TA));
}

// D (64 × N, f32) = A (64 × 16, registers: this warp's 16 rows as an
// mma.sync A fragment) · B (16 × N, shared memory, `db`; TB as above) + D, or
// without the + D when `accumulate` is 0; N = 32 or 64; d as above.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate = 1) {
  static_assert(N == 32 || N == 64, "wgmma_rs: N = 32 or 64");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(accumulate));
  }
}

// fence_acc for any number of n8 tiles, and for A fragments in registers.
template <int J>
__device__ __forceinline__ void fence_regs(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}
template <int J>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

}  // namespace mma
}  // namespace daclip
