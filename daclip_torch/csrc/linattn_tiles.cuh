// Hopper tiles of the bf16 linear-attention kernels (forward `stats_tma_kernel`
// / `apply_tma_kernel` in linear_attention.cu; backward `pass1_tma_kernel` /
// `pass2_tma_kernel` / `wgrad_tma_kernel` in linear_attention_bwd.cu). A CTA
// is one warpgroup (4 warps, 128 threads) that owns a tile of 64 rows, 16 a
// warp, and walks a static range of tiles; every product is wgmma (mma.cuh)
// with f32 accumulators.
//
// - Boxes: a row tile of C channels is ⌈C/64⌉ boxes of 64 rows × 64 columns
//   (8 KB each, bf16, 1024-byte aligned) in the 128-byte swizzle, as TMA
//   writes them (tma.cuh `encode_boxes`: zeros past the rows of a batch
//   element and past C). A box is a K-major wgmma operand (its k16 step s
//   32·s bytes in) or an MN-major one (rows = k, step s 2048·s bytes in: the
//   transposed operand of a product that contracts over a tile's rows). The
//   weights W_qkv (C × 384) and W_out (128 × C) are boxes of the same shape;
//   one box serves both orientations (xn·W and dqkv·Wᵀ, a·W_out and
//   dy·W_outᵀ). `sw` addresses an element of a box tile from the threads.
// - The row ring: thread 0 issues a tile's boxes by TMA into a stage and
//   their bytes complete on the stage's mbarrier; every thread waits there.
//   A stage is refilled by thread 0 once the whole CTA is past a barrier
//   after its last read. `Ring` tracks the stages' phases.
// - Weights (`Weights`): loaded once a CTA by TMA (resident, issued with the
//   first tiles before the CTA's first barrier) where the kernel's boxes fit
//   in shared memory beside its tiles; else each product (or each group of
//   its k-blocks, or of its output chunks) loads its boxes into the region
//   before it runs.
// - Heads: the four 32 × 32 blocks of W_h (or dctx) as bf16 in the 64-byte
//   swizzle, the B operand of the per-head products on wgmma m64n32k16 with
//   A in registers (`head_products`).
// - The wgmma accumulator gives warp w rows 16w .. 16w + 15 in the layout of
//   mma.sync's C fragment (mma.cuh): a 64 × 128 product is 16 n8 tiles (64
//   floats a lane), the four 32-wide heads in tiles 4h .. 4h + 3; a row's
//   values lie on the four lanes of a quad, so a per-head or per-row
//   reduction is two xor-shuffles (`quad_sum`), a column's over the warp's
//   rows three (`add_col_sums`). The LayerNorms of x work on the box tile in
//   place (`ln_tile`); those of y (and the VJPs) on 64-column chunks of the
//   accumulators, each sweep over a row's chunks forming them again where C
//   > 64 (one chunk stays in registers at C ≤ 64, `KEEP`). The gains and
//   biases are read from copies in shared memory (`load_vec`).
// Plain C interface, no PyTorch headers.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace daclip {
namespace linattn {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;          // rows of a tile: 16 per warp
constexpr int THREADS = 128;      // one warpgroup
constexpr int HID = 128;          // heads · dim_head
constexpr int DH = 32;            // dim_head
constexpr int BOX = 8192;         // a 64 × 64 bf16 box
constexpr int HEAD_BLOCK = 2048;  // a 32 × 32 bf16 head block
constexpr int HEADS_BYTES = 4 * HEAD_BLOCK;
constexpr float LN_EPS = 1e-5f;
// dynamic shared memory a CTA may take on the H100, and at most for two
// CTAs an SM (228 KB an SM, 1 KB of it reserved a CTA); launchers ask for
// 1024 bytes more than a layout's offsets, to align its base
constexpr int SMEM_ONE = 232448;
constexpr int SMEM_TWO = 115712;
constexpr int SMEM_THREE = 76800;

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The CTA's dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's atoms and the wgmma descriptors assume it; launchers
// ask for 1024 bytes more).
__device__ __forceinline__ unsigned char* aligned(unsigned char* raw) {
  return raw + ((1024 - (mma::smem_u32(raw) & 1023)) & 1023);
}

// Byte offset of element (r, c) in a tile of 64-column boxes (the 16-byte
// chunk j of a 128-byte row r at chunk j ^ (r % 8)).
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (uint32_t)((c >> 6) * BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}
__device__ __forceinline__ __nv_bfloat162* pair_at(unsigned char* t, int r, int c) {
  return reinterpret_cast<__nv_bfloat162*>(t + sw(r, c));
}
// The same in a 32 × 32 head block (64-byte rows: chunk j of row r at
// chunk j ^ (r / 2 % 4)).
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return (uint32_t)(r * 64 + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) { return mma::wgmma_desc_sw<128>(addr); }

// Rows of the tile this lane holds in the accumulator layout: ra and ra + 8.
__device__ __forceinline__ int lane_row() {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int lane_col() { return 2 * (threadIdx.x & 3); }

template <int J>
__device__ __forceinline__ float (&sub8(float (&a)[J][4], int i))[8][4] {
  return *reinterpret_cast<float(*)[8][4]>(&a[8 * i]);
}
template <int J>
__device__ __forceinline__ float (&sub4(float (&a)[J][4], int i))[4][4] {
  return *reinterpret_cast<float(*)[4][4]>(&a[4 * i]);
}

// -- the row ring ------------------------------------------------------------------
// STAGES stages of `bytes` each at `base`, full barrier of stage s at bars + 8s.
// The CTA's tile `it` uses stage it % stages in round it / stages.
struct Ring {
  uint32_t base, bars;
  int stages, bytes;
  __device__ __forceinline__ uint32_t stage(int it) const { return base + (it % stages) * bytes; }
  __device__ __forceinline__ uint32_t full(int it) const { return bars + 8 * (it % stages); }
  __device__ __forceinline__ void wait(int it) const {
    tma::mbar_wait(full(it), (it / stages) & 1);
  }
};

// -- weights -------------------------------------------------------------------------
// The region of `slots` boxes at `base`; `key` names the group of boxes it
// holds (resident: all of the kernel's, from the start).
struct Weights {
  uint32_t base, bar, phase;
  int slots, key;
  bool resident, pending;  // pending: issued by issue_group, not yet waited for
  // the address of slot i
  __device__ __forceinline__ uint32_t slot(int i) const { return base + i * BOX; }
};

// Issue the `count` boxes of group `key` (the resident weights) from thread
// 0 as the kernel starts, before its first barrier; `wait_weights` waits for
// them before their first use. Every thread calls both.
template <class At>
__device__ __forceinline__ void issue_group(Weights& w, int key, int count, At at) {
  if (threadIdx.x == 0) {
    tma::mbar_expect_tx(w.bar, count * BOX);
    for (int i = 0; i < count; ++i) {
      const CUtensorMap* map;
      int col, row;
      at(i, map, col, row);
      tma::load_3d(w.slot(i), map, col, row, 0, w.bar);
    }
  }
  w.key = key;
  w.pending = true;
}
__device__ __forceinline__ void wait_weights(Weights& w) {
  if (w.pending) {
    tma::mbar_wait(w.bar, w.phase);
    w.phase ^= 1;
    w.pending = false;
  }
}

// Load the `count` boxes of group `key` into the region unless it holds them:
// box i from (map, col, row) = at(i, …). Every thread calls it; no product
// may still read the region (the caller has waited for its products).
template <class At>
__device__ __forceinline__ void load_group(Weights& w, int key, int count, At at) {
  if (w.key == key) return;
  __syncthreads();  // every thread is done with the region's last group
  if (threadIdx.x == 0) {
    tma::mbar_expect_tx(w.bar, count * BOX);
    for (int i = 0; i < count; ++i) {
      const CUtensorMap* map;
      int col, row;
      at(i, map, col, row);
      tma::load_3d(w.slot(i), map, col, row, 0, w.bar);
    }
  }
  tma::mbar_wait(w.bar, w.phase);
  w.phase ^= 1;
  w.key = key;
}

// -- products --------------------------------------------------------------------------
// acc (64 × 128) = A · B over k-blocks [kb0, kb1): A's k-block kb a K-major
// box at a(kb), B's box (kb, i) for output columns 64i .. 64i + 63 at
// b(kb, i), MN-major (TB 1: rows = k) or K-major (TB 0: rows = n). The first
// k-block overwrites when `first`. Issues and commits one group.
template <int TB, class A, class B>
__device__ __forceinline__ void gemm128(float (&acc)[16][4], int kb0, int kb1, A a, B b,
                                        bool first) {
  mma::wgmma_fence();
  for (int kb = kb0; kb < kb1; ++kb) {
    const uint32_t ab = a(kb), b0 = b(kb, 0), b1 = b(kb, 1);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int acc_on = !(first && kb == kb0 && s == 0);
      const uint64_t da = desc(ab + 32 * s);
      mma::wgmma_ss64<TB>(sub8(acc, 0), da, desc(b0 + (TB ? 2048 : 32) * s), acc_on);
      mma::wgmma_ss64<TB>(sub8(acc, 1), da, desc(b1 + (TB ? 2048 : 32) * s), acc_on);
    }
  }
  mma::wgmma_commit();
}

// acc (64 × 64) = A · B over K = 16·S (S k16 steps) with A in registers
// (frag[s]: k16 step s) and B's k16 step s at b(s), MN-major (TB 1) or
// K-major (TB 0) within its box. Issues and commits one group.
template <int TB, int S, class B>
__device__ __forceinline__ void gemm64_rs(float (&acc)[8][4], const uint32_t (&frag)[S][4], B b,
                                          bool first) {
  mma::wgmma_fence();
#pragma unroll
  for (int s = 0; s < S; ++s)
    mma::wgmma_rs<64, TB>(acc, frag[s], desc(b(s >> 2) + (TB ? 2048 : 32) * (s & 3)),
                          !(first && s == 0));
  mma::wgmma_commit();
}

// t[p] (64 × 64, p = 0, 1) = Aᵀ · B over a tile's 64 rows for the pair p of
// heads (columns 64p .. 64p + 63): A and B box tiles of 128 columns at `a`
// and `b`, both MN-major (rows = k). Issues and commits one group.
__device__ __forceinline__ void issue_pairs(float (&t)[2][8][4], uint32_t a, uint32_t b) {
  mma::wgmma_fence();
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      mma::wgmma_ss64<1, 1>(t[p], desc(a + p * BOX + 2048 * s), desc(b + p * BOX + 2048 * s), s);
  mma::wgmma_commit();
}
__device__ __forceinline__ void wait_pairs(float (&t)[2][8][4]) {
  mma::wgmma_wait<0>();
  mma::fence_regs(t[0]);
  mma::fence_regs(t[1]);
}
// Of pair p's product, this thread's element e of n8 tile j of the
// diagonal 32 × 32 block: warp w's rows lie in head 2p + w / 2, so its
// tiles 4(w / 2) .. + 3 are the block's (chosen without indexing by w).
__device__ __forceinline__ float diagonal(const float (&t)[2][8][4], int p, int j, int e) {
  return (threadIdx.x >> 5) & 2 ? t[p][4 + j][e] : t[p][j][e];
}

// diag[p] += the diagonal 32 × 32 blocks of the head pairs' Aᵀ · B
// (issue_pairs); the product goes to `t`.
__device__ __forceinline__ void add_pair_diagonals(float (&diag)[2][4][4], float (&t)[2][8][4],
                                                   uint32_t a, uint32_t b) {
  issue_pairs(t, a, b);
  wait_pairs(t);
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) diag[p][j][e] += diagonal(t, p, j, e);
}

// out (64 × 128: head h in n8 tiles 4h .. 4h + 3) = per head h, A_h (the
// head's two k16 steps frag[2h], frag[2h + 1]) · B_h, B_h the head's 32 × 32
// block at heads + 2048h, MN-major (TB 1: the block itself) or K-major
// (TB 0: its transpose). Issues, commits and waits.
template <int TB>
__device__ __forceinline__ void head_products(float (&out)[16][4], const uint32_t (&frag)[8][4],
                                              uint32_t heads) {
  mma::wgmma_fence();
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      mma::wgmma_rs<32, TB>(sub4(out, h), frag[2 * h + s],
                            mma::wgmma_desc_sw<64>(heads + h * HEAD_BLOCK + (TB ? 1024 : 32) * s),
                            s);
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
  mma::fence_regs(out);
}

// The product of head h alone (out: 16 × 32 a warp), as head_products.
template <int TB>
__device__ __forceinline__ void head_product(float (&out)[4][4], const uint32_t (&a0)[4],
                                             const uint32_t (&a1)[4], uint32_t blk) {
  mma::wgmma_fence();
  mma::wgmma_rs<32, TB>(out, a0, mma::wgmma_desc_sw<64>(blk), 0);
  mma::wgmma_rs<32, TB>(out, a1, mma::wgmma_desc_sw<64>(blk + (TB ? 1024 : 32)), 1);
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
  mma::fence_regs(out);
}

template <int J>
__device__ __forceinline__ void wait_all(float (&acc)[J][4]) {
  mma::wgmma_wait<0>();
  mma::fence_regs(acc);
}

// -- elementwise on tiles ---------------------------------------------------------------
// A row's sum over the four lanes of its quad.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Per-column sums of the warp's 16 rows, from each lane's sums over its two
// rows (p[j] for columns c0 + 8j + 2(l % 4) and the next), added to the
// warp's row `sums` of per-channel sums (C floats) by the lanes of group 0.
template <int NT>
__device__ __forceinline__ void add_col_sums(float* sums, float (&p)[NT][2], int C, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[j][e] += __shfl_xor_sync(0xffffffffu, p[j][e], o);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = c0 + 8 * j + 2 * lane;
      if (c < C) {
        float2* s = reinterpret_cast<float2*>(sums + c);
        const float2 v = *s;
        *s = make_float2(v.x + p[j][0], v.y + p[j][1]);
      }
    }
  }
}

// The LayerNorms' width cn ≤ C as the kernels take it. Rows laid out at C
// columns with zeros past cn (ops/linear_attention.py `_pad_operands`) sum
// to the same over C as over cn: a mean over C is scaled by `ratio` = C / cn;
// the zeros add (C − cn)·m² to a sum of (v − m)², which the prenorm's
// variance takes back out (`pad` = C − cn); the sums of y's LayerNorms are
// shifted by the row's first y, which their zeros would have added too, so
// at cn < C they are not shifted (`shift` 0, else 1). The three are kernel
// parameters, read as operands where they are used (each such kernel is at
// its register cap: a value formed from cn and held, or a sum started from
// it, spilled), and scale by __fmul_rn, which no FMA contracts; cn = C gives
// pad 0, ratio 1 and shift 1, which leave every result as it was, bit for
// bit.
struct LnWidth {
  float pad, ratio, shift;
};
inline LnWidth ln_width(int C, int cn) {
  return {(float)(C - cn), (float)C / (float)cn, cn == C ? 1.f : 0.f};
}

// The warp's rows (lane_row() and + 8, r < valid) of a box tile replaced by
// ChannelLN(row)·g rounded to bf16, the statistics in f32 over the quad's
// lanes, the two rows' loads interleaved; each row's mean and 1/std to
// mean_s / rstd_s when given. The LN is over the first cn ≤ C columns
// (`LnWidth`; x and g are zeros past cn). Rows past valid and columns past C
// are left as they are. g is best a copy in shared memory (`load_vec`).
__device__ __forceinline__ void ln_tile(unsigned char* xs, int C, LnWidth lw, int valid,
                                        const bf16* g, float* mean_s, float* rstd_s) {
  const int r = lane_row(), c0 = lane_col();
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
  for (int c = c0; c < C; c += 8) {
    const float2 a = __bfloat1622float2(*pair_at(xs, r, c));
    const float2 b = __bfloat1622float2(*pair_at(xs, r + 8, c));
    s0 += a.x + a.y;
    s1 += b.x + b.y;
  }
  const float m0 = __fmul_rn(quad_sum(s0) / C, lw.ratio);
  const float m1 = __fmul_rn(quad_sum(s1) / C, lw.ratio);
  float q0 = 0.f, q1 = 0.f;
#pragma unroll 8
  for (int c = c0; c < C; c += 8) {
    const float2 a = __bfloat1622float2(*pair_at(xs, r, c));
    const float2 b = __bfloat1622float2(*pair_at(xs, r + 8, c));
    q0 += (a.x - m0) * (a.x - m0) + (a.y - m0) * (a.y - m0);
    q1 += (b.x - m1) * (b.x - m1) + (b.y - m1) * (b.y - m1);
  }
  const float rs0 =
      1.f / sqrtf(__fmul_rn((quad_sum(q0) - lw.pad * m0 * m0) / C, lw.ratio) + LN_EPS);
  const float rs1 =
      1.f / sqrtf(__fmul_rn((quad_sum(q1) - lw.pad * m1 * m1) / C, lw.ratio) + LN_EPS);
  const bool w0 = r < valid, w1 = r + 8 < valid;
#pragma unroll 8
  for (int c = c0; c < C; c += 8) {
    const float2 gg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + c));
    __nv_bfloat162* pa = pair_at(xs, r, c);
    __nv_bfloat162* pb = pair_at(xs, r + 8, c);
    const float2 a = __bfloat1622float2(*pa), b = __bfloat1622float2(*pb);
    if (w0) *pa = __floats2bfloat162_rn((a.x - m0) * rs0 * gg.x, (a.y - m0) * rs0 * gg.y);
    if (w1) *pb = __floats2bfloat162_rn((b.x - m1) * rs1 * gg.x, (b.y - m1) * rs1 * gg.y);
  }
  if (mean_s != nullptr && (threadIdx.x & 3) == 0) {
    mean_s[r] = m0;
    rstd_s[r] = rs0;
    mean_s[r + 8] = m1;
    rstd_s[r + 8] = rs1;
  }
}

// A (C) bf16 vector (C a multiple of 8, src 16-byte aligned) into shared
// memory by the CTA's threads; the caller synchronises before reading it.
__device__ __forceinline__ void load_vec(bf16* dst, const bf16* __restrict__ src, int C) {
  for (int i = threadIdx.x; i < C / 8; i += THREADS)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}
constexpr int VEC = 512 * 2;  // one vector's bytes at C ≤ 512

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// The bf16 pairs of rows ra and ra + 8 (lane_row()) at columns c0 + 8j +
// 2(l % 4) of a (·, C) array with row 0 at `base`, for j < NT, all loads
// issued before any is used; 0 past C or past `valid` rows.
template <int NT>
__device__ __forceinline__ void ld_chunk(uint32_t (&q)[NT][2], const bf16* __restrict__ base,
                                         int C, int c0, int valid) {
  const int ra = lane_row(), c = c0 + lane_col();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      q[j][h] = c + 8 * j < C && ra + 8 * h < valid
                    ? __ldg(reinterpret_cast<const unsigned int*>(base + (size_t)(ra + 8 * h) * C +
                                                                  c + 8 * j))
                    : 0u;
}
// The same pairs from a box tile in shared memory (0 past C).
template <int NT>
__device__ __forceinline__ void ld_chunk_sw(uint32_t (&q)[NT][2], unsigned char* t, int C,
                                            int c0) {
  const int ra = lane_row(), c = c0 + lane_col();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      q[j][h] = c + 8 * j < C ? *reinterpret_cast<const uint32_t*>(pair_at(t, ra + 8 * h, c + 8 * j))
                              : 0u;
}

// Rows ra, ra + 8 of the warp's accumulator (NT n8 tiles), rounded to bf16,
// into a box tile at columns c0 .. c0 + 8·NT.
template <int NT>
__device__ __forceinline__ void store_tile(unsigned char* t, int c0, const float (&acc)[NT][4]) {
  const int r = lane_row(), c = c0 + lane_col();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *pair_at(t, r, c + 8 * j) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *pair_at(t, r + 8, c + 8 * j) = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}
// The accumulator (NT n8 tiles) from a box tile's columns c0 .. c0 + 8·NT.
template <int NT>
__device__ __forceinline__ void read_tile(float (&acc)[NT][4], unsigned char* t, int c0) {
  const int r = lane_row(), c = c0 + lane_col();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 lo = __bfloat1622float2(*pair_at(t, r, c + 8 * j));
    const float2 hi = __bfloat1622float2(*pair_at(t, r + 8, c + 8 * j));
    acc[j][0] = lo.x;
    acc[j][1] = lo.y;
    acc[j][2] = hi.x;
    acc[j][3] = hi.y;
  }
}

// Rows ra, ra + 8 (< valid) of the accumulator (NT n8 tiles) rounded to bf16
// into a (·, ld) bf16 array with row 0 at `dst`, columns c0 .. (< cols).
template <int NT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, int ld, int c0, int cols,
                                           int valid, const float (&acc)[NT][4]) {
  const int r = lane_row(), c = c0 + lane_col();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < valid && c + 8 * j < cols)
        *reinterpret_cast<uint32_t*>(dst + (size_t)(r + 8 * h) * ld + c + 8 * j) =
            mma::pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
}

// A fragments of the accumulator (NT n8 tiles), rounded to bf16: k16 step s
// covers its columns 16s .. 16s + 15.
template <int NT>
__device__ __forceinline__ void pack_rows(uint32_t (&a)[NT / 2][4], const float (&acc)[NT][4]) {
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) mma::pack_a(a[s], acc[2 * s], acc[2 * s + 1]);
}
// Rows ra, ra + 8 (< valid) of A fragments (k16 steps, 16 columns each) into
// a (·, ld) bf16 array with row 0 at `dst`, columns c0 .. (< cols; c0 and
// cols multiples of 16).
template <int S>
__device__ __forceinline__ void store_frags(bf16* __restrict__ dst, int ld, int c0, int cols,
                                            int valid, const uint32_t (&a)[S][4]) {
  const int r = lane_row(), c = c0 + lane_col();
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < valid && c0 + 16 * s < cols) {
        *reinterpret_cast<uint32_t*>(dst + (size_t)(r + 8 * h) * ld + c + 16 * s) = a[s][h];
        *reinterpret_cast<uint32_t*>(dst + (size_t)(r + 8 * h) * ld + c + 16 * s + 8) = a[s][h + 2];
      }
}

// + bias[c] on a 64-column chunk at c0 (columns past C untouched: they are
// 0 and never read).
__device__ __forceinline__ void add_bias(float (&acc)[8][4], const bf16* __restrict__ bias,
                                         int c0, int C) {
  const int c = c0 + lane_col();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + 8 * j < C) {
      const float2 b = ld_pair(bias + c + 8 * j);
      acc[j][0] += b.x;
      acc[j][1] += b.y;
      acc[j][2] += b.x;
      acc[j][3] += b.y;
    }
}

// The per-pixel softmax over each head's 32 columns of a 16 × 128 f32
// accumulator, in place (f32, not rounded): max and sum over a row's 8
// values in this lane, then across the quad; exponentials on the SFU
// (__expf), one reciprocal a row.
__device__ __forceinline__ void head_softmax(float (&acc)[16][4]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j)
        mx = fmaxf(mx, fmaxf(acc[j][2 * half], acc[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        acc[j][2 * half] = __expf(acc[j][2 * half] - mx);
        acc[j][2 * half + 1] = __expf(acc[j][2 * half + 1] - mx);
        sum += acc[j][2 * half] + acc[j][2 * half + 1];
      }
      const float inv = 1.f / quad_sum(sum);
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        acc[j][2 * half] *= inv;
        acc[j][2 * half + 1] *= inv;
      }
    }
  }
}

// The four 32 × 32 f32 head blocks at src (4·32·32, contiguous), which hold
// bf16 values, as bf16 head blocks at dst (64-byte swizzle). src 16-byte
// aligned; every load is issued before the first store.
__device__ __forceinline__ void load_heads(unsigned char* dst, const float* __restrict__ src) {
  constexpr int PER = 4 * DH * DH / 4 / THREADS;  // float4 a thread
  float4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = reinterpret_cast<const float4*>(src)[threadIdx.x + i * THREADS];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = 4 * (threadIdx.x + i * THREADS), h = e >> 10, r = (e >> 5) & 31, c = e & 31;
    unsigned char* blk = dst + h * HEAD_BLOCK;
    *reinterpret_cast<__nv_bfloat162*>(blk + sw64(r, c)) = __floats2bfloat162_rn(v[i].x, v[i].y);
    *reinterpret_cast<__nv_bfloat162*>(blk + sw64(r, c + 2)) = __floats2bfloat162_rn(v[i].z, v[i].w);
  }
}

// This thread's pair (row, column) of the diagonal 32 × 32 block of head
// pair p in out (4·32·32 f32: head, row, column): n8 tile j of its row half h.
__device__ __forceinline__ float2* pair_diagonal(float* out, int p, int j, int h) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int i = 16 * (warp & 1) + g + 8 * h;  // the warp's rows lie in head 2p + warp / 2
  return reinterpret_cast<float2*>(out + (2 * p + (warp >> 1)) * DH * DH + i * DH + 8 * j +
                                   lane_col());
}

// The diagonal 32 × 32 blocks of the head pairs (add_pair_diagonals) into
// out (4·32·32 f32: head, row, column).
__device__ __forceinline__ void store_pair_diagonals(float* __restrict__ out,
                                                     const float (&diag)[2][4][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *pair_diagonal(out, p, j, h) = make_float2(diag[p][j][2 * h], diag[p][j][2 * h + 1]);
}

// out (the CTA's partial, 4·32·32 f32 in device memory) = (first ? 0 : out)
// + the diagonal 32 × 32 blocks of the head pairs' Aᵀ · B (issue_pairs);
// each element is read and written by the one thread that owns it, the
// partial's previous values loaded while the products run. The product goes
// to `t`.
__device__ __forceinline__ void add_pair_diagonals_to(float* out, bool first,
                                                      float (&t)[2][8][4], uint32_t a,
                                                      uint32_t b) {
  issue_pairs(t, a, b);
  float2 prev[2][4][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        prev[p][j][h] = first ? make_float2(0.f, 0.f) : *pair_diagonal(out, p, j, h);
  wait_pairs(t);
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *pair_diagonal(out, p, j, h) = make_float2(prev[p][j][h].x + diagonal(t, p, j, 2 * h),
                                                   prev[p][j][h].y + diagonal(t, p, j, 2 * h + 1));
}

// The barriers' shared memory: the ring's stages, then the weights'.
constexpr int MAX_STAGES = 2;
constexpr int BAR_BYTES = 8 * (MAX_STAGES + 1);

// Host side: TMA reads 16-byte aligned global addresses, so every bf16
// pointer must be 16-byte aligned.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && ((uintptr_t)p & 15) != 0) return false;
  return true;
}

// Host side: the widths a launch takes. C is the rows' width (1 to 512; in
// bf16 a multiple of 8, a row's bytes a multiple of the 16 TMA steps in), cn
// the LayerNorms' width: C itself, or in bf16 the true width of rows that
// the caller laid out at the next multiple of 8 with zeros past it.
inline bool widths_ok(int C, int cn, int is_bf16) {
  if (C < 1 || C > 512 || cn < 1 || cn > C) return false;
  return is_bf16 ? C % 8 == 0 && cn > C - 8 : cn == C;
}

// A kernel's shared memory: `fixed` bytes of its own (tiles, heads, f32
// scratch, vectors: 1024-byte multiples first), a ring of `stages` stages
// of `stage_bytes`, the weight region, the barriers. The planner takes the
// first that fits of, for three CTAs an SM where the kernel's registers
// allow it (`three`): every weight box resident with 2 stages, then 1; for
// two: the same, then one stage and a region that holds the largest group a
// product loads at once (`group`); then the same for one CTA an SM, the
// region there at least `min_group` boxes.
struct Layout {
  int stages, stage_bytes, resident, slots, alias;
  int ring, weights, bars, bytes;  // offsets from the aligned base; bytes with slack
};

inline Layout plan(int fixed, int stage_bytes, int weight_boxes, int min_group, int group,
                   bool three = false) {
  Layout L{};
  auto make = [&](int stages, int slots) {
    L.stages = stages;
    L.stage_bytes = stage_bytes;
    L.slots = slots;
    L.resident = slots >= weight_boxes;
    L.ring = fixed;
    L.weights = L.ring + stages * stage_bytes;
    L.bars = L.weights + slots * BOX;
    L.bytes = L.bars + BAR_BYTES + 1024;
    return L.bytes;
  };
  if (three)
    for (int s : {2, 1})
      if (make(s, weight_boxes) <= SMEM_THREE) return L;
  for (int limit : {SMEM_TWO, SMEM_ONE}) {
    for (int s : {2, 1})
      if (make(s, weight_boxes) <= limit) return L;
    const int slots = (limit - make(1, 0)) / BOX;
    if (slots >= (limit == SMEM_TWO ? group : min_group)) {
      make(1, slots);
      return L;
    }
  }
  L.bytes = 0;  // does not fit
  return L;
}

}  // namespace linattn
}  // namespace daclip
