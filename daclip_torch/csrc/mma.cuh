// Tensor-core building blocks for sm_90a, in inline PTX: the warp's bf16
// mma.sync m16n8k16 product with f32 accumulators, ldmatrix (plain and
// transposed), 16-byte cp.async with its commit/wait groups, the re-packing
// of an accumulator into an A operand (FlashAttention-2's register reuse),
// and the warpgroup's wgmma m64n64k16 with A in registers and B in shared
// memory. Plain C interface, no PyTorch headers.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), for lane l of the warp, g = l / 4 (the "group"), t = l % 4:
//   A (16×16, row-major, bf16): four 32-bit registers, each two consecutive
//     k of one row, the lower k in the lower half:
//       a[0] = A[g][2t, 2t+1]     a[1] = A[g+8][2t, 2t+1]
//       a[2] = A[g][2t+8, 2t+9]   a[3] = A[g+8][2t+8, 2t+9]
//   B (16×8, "col": B[k][n] with k contiguous, i.e. Bᵀ row-major): two
//     registers,  b[0] = B[2t, 2t+1][g]   b[1] = B[2t+8, 2t+9][g]
//   C/D (16×8, f32): four floats,
//       c[0], c[1] = C[g][2t, 2t+1]       c[2], c[3] = C[g+8][2t, 2t+1]
// So the accumulators of two neighbouring n8 tiles (columns 0-7 and 8-15)
// hold, lane for lane, the A operand of a k16 step over those 16 columns:
// `pack_a` rounds them to bf16 and re-packs them without leaving registers.
//
// ldmatrix .x4: lanes 8i..8i+7 give the row addresses (16 bytes each, 16-byte
// aligned) of 8×8 bf16 matrix i; lane l receives in r[i] the pair
// M_i[g][2t, 2t+1], or with .trans the pair M_i[2t, 2t+1][g] (the matrix
// transposed). Hence, for a tile stored row-major with row stride `ld`
// (elements) in shared memory:
//   - `ldsm_a`: A fragment of the 16×16 block at `p` (rows = M, cols = K);
//   - `ldsm_b`: B fragments of two n8 tiles from a block stored [n][k]
//     (k contiguous): 16 n-rows × 16 k at `p`, b01 for n 0-7, b23 for n 8-15;
//   - `ldsm_bt`: B fragments of two n8 tiles from a block stored [k][n]
//     (n contiguous): 16 k-rows × 16 n at `p`, through .trans.
// Rows padded so that their stride is an odd multiple of 16 bytes modulo 128
// make every ldmatrix free of bank conflicts.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace daclip {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D = A·B + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A fragment of the 16×16 bf16 block at p (row-major, row stride ld).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* p, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, p + (l & 15) * ld + (l >> 4) * 8);
}

// B fragments of two n8 tiles from the block at p stored [n][k] (row stride
// ld): r[0], r[1] for n 0-7, r[2], r[3] for n 8-15, k 0-15.
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], const __nv_bfloat16* p, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(r, p + ((l >> 4) * 8 + (l & 7)) * ld + ((l >> 3) & 1) * 8);
}

// B fragments of two n8 tiles from the block at p stored [k][n] (row stride
// ld): r[0], r[1] for n 0-7, r[2], r[3] for n 8-15, k 0-15.
__device__ __forceinline__ void ldsm_bt(uint32_t (&r)[4], const __nv_bfloat16* p, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4_trans(r, p + ((l & 7) + ((l >> 3) & 1) * 8) * ld + (l >> 4) * 8);
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

// 16-byte global → shared copy that bypasses L1; with `full` false it writes
// 16 zero bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

// The same for one 4-byte word (through L1: .cg takes 16 bytes only).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most `N` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- wgmma (warpgroup products, sm_90a) ------------------------------------------
// The shared-memory descriptor of an N-major bf16 B operand of 64 columns in
// the 128-byte swizzle: 8-row atoms of 64 n (128 B a row, k-row r's 16-byte
// chunk j stored at chunk j ^ (r % 8)), each atom 1024-byte aligned, `sbo`
// bytes between the two 8-row halves of a k16 step (bits 0-13: address / 16,
// 16-29: leading offset, unused with one 64-column atom, 32-45: sbo / 16,
// 62-63: layout, 1 = 128-byte swizzle).
__device__ __forceinline__ uint64_t wgmma_desc_b128(const void* p, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

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
// Make this thread's generic-proxy shared-memory writes (cp.async, stores)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 × 64, f32) += A (64 × 16, bf16, registers: this warp's 16 rows as an
// mma.sync A fragment) · B (16 × 64, bf16, shared memory, N-major, `desc`);
// d[j] is n8 tile j of this warp's 16 rows, laid out as an mma.sync C fragment.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace mma
}  // namespace daclip
