// Tensor-core tiles of the bf16 linear-attention kernels (forward
// `stats_mma_kernel` / `apply_mma_kernel` in linear_attention.cu; backward
// `pass1_mma_kernel` / `pass2_mma_kernel` / `wgrad_mma_kernel` in
// linear_attention_bwd.cu). A CTA of 4 warps owns a tile of 64 rows, 16 per
// warp; every product is mma.sync m16n8k16 (mma.cuh) with f32 accumulators.
//
// - Row tiles: rows of x (or xn, dy, qkv) are copied into shared memory as
//   bf16 by 16-byte cp.async, rows past the tile's valid count zero-filled;
//   a row of C elements is padded to C + 8, so its stride is an odd multiple
//   of 16 bytes modulo 128 and every ldmatrix is free of bank conflicts.
//   `ln_tile` turns the warp's own 16 rows into ChannelLN(x)·g in place, the
//   statistics in f32, rounded to bf16 once.
// - Weights: a block of at most 128 columns of W_qkv (C × 384) or W_out
//   (128 × C) is streamed in slices of 32 k through a cp.async ring (2
//   slices in flight, 4 for at most 64 columns), read as bf16 (never
//   converted to f32). `gemm_w` multiplies the warp's 16 rows, given as A
//   fragments from shared memory or from registers, by that block, in either
//   orientation: W stored [k][n] (B through ldmatrix.trans) or [n][k] (a
//   transposed use, as in dy·W_outᵀ and dqkv·W_qkvᵀ; B through ldmatrix).
//   One barrier a slice; `gemm_prime` starts a product's first copies while
//   the work before it runs.
// - A 16 × 128 accumulator (16 n8 tiles, 64 floats a lane) holds the four
//   32-wide heads in tiles 4h .. 4h + 3; a row's 32 head columns lie on the
//   four lanes of a quad, so a per-head or per-row reduction is two
//   xor-shuffles (`quad_sum`), a column's over the warp's rows three
//   (`add_col_sums`). The LayerNorms of y (and their VJPs) work in this layout on
//   f32 rows staged in shared memory, with a chunk's device-memory pairs
//   loaded at once (`ld_chunk`).
// Plain C interface, no PyTorch headers.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace daclip {
namespace linattn {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;       // rows of a tile: 16 per warp
constexpr int THREADS = 128;   // 4 warps
constexpr int HID = 128;       // heads · dim_head
constexpr int DH = 32;         // dim_head
constexpr int KS = 32;         // k of a streamed weight slice
constexpr int WLD = HID + 8;   // row of a [k][n] slice (and of a 128-wide row tile)
constexpr int WLDT = KS + 8;   // row of an [n][k] slice (and of a head's 32 × 32 block)
constexpr int STAGE = HID * WLDT;                     // elements of a ring stage (≥ KS·WLD)
constexpr size_t RING_BYTES = 2 * (size_t)STAGE * 2;  // the 2-stage ring
constexpr size_t HEADS_BYTES = 4 * DH * WLDT * 2;     // four padded 32 × 32 blocks
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ void zero(float (&acc)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Copy rows [t0, t0 + valid) of a (·, ld_src) bf16 array, columns [c0, c0 +
// cols), into a row tile of stride `ld`; rows past `valid` up to 64 are zero.
// cols and c0 are multiples of 8, the source 16-byte aligned. Commits nothing.
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst, int ld,
                                          const bf16* __restrict__ src, int ld_src, int t0,
                                          int valid, int c0, int cols) {
  const int ch = cols >> 3;
  for (int e = threadIdx.x; e < ROWS * ch; e += THREADS) {
    const int r = e / ch, c = (e - r * ch) * 8;
    const bool ok = r < valid;
    mma::cp_async16(dst + r * ld + c, src + (size_t)(t0 + (ok ? r : 0)) * ld_src + c0 + c, ok);
  }
}

// A row's sum over the four lanes of its quad, in the accumulator layout
// (lane l holds rows g = l / 4 and g + 8 of the warp's 16, columns 8j +
// 2(l % 4) and the next).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Per-column sums of the warp's 16 rows, from each lane's sums over its two
// rows (p[j] for columns c0 + 8j + 2(l % 4) and the next), added to the
// warp's row `sums` of per-channel sums (C floats) by the lanes of group 0.
// All columns' shuffles are in flight together.
__device__ __forceinline__ void add_col_sums(float* sums, float (&p)[16][2], int C, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[j][e] += __shfl_xor_sync(0xffffffffu, p[j][e], o);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + 2 * lane;
      if (c < C) {
        float2* s = reinterpret_cast<float2*>(sums + c);
        const float2 v = *s;
        *s = make_float2(v.x + p[j][0], v.y + p[j][1]);
      }
    }
  }
}

// The warp's rows warp·16 + g and + 8 (r < valid) of a bf16 row tile (stride
// C + 8, C a multiple of 32) replaced by ChannelLN(row)·g rounded to bf16,
// the statistics in f32 over the quad's lanes; each row's mean and 1/std to
// mean_s / rstd_s when given. Rows past valid are left as they are.
__device__ __forceinline__ void ln_tile(bf16* xs, int C, int valid, const bf16* __restrict__ g,
                                        float* mean_s, float* rstd_s) {
  const int lane = threadIdx.x & 31, ld = C + 8;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  auto at = [&](int h, int c) { return reinterpret_cast<__nv_bfloat162*>(xs + (r + 8 * h) * ld + c); };
  float mean[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll 4
    for (int c = c0; c < C; c += 8) {
      const float2 v = __bfloat1622float2(*at(h, c));
      s += v.x + v.y;
    }
    mean[h] = quad_sum(s) / C;
    float q = 0.f;
#pragma unroll 4
    for (int c = c0; c < C; c += 8) {
      const float2 v = __bfloat1622float2(*at(h, c));
      q += (v.x - mean[h]) * (v.x - mean[h]) + (v.y - mean[h]) * (v.y - mean[h]);
    }
    rs[h] = 1.f / sqrtf(quad_sum(q) / C + LN_EPS);
  }
#pragma unroll 4
  for (int c = c0; c < C; c += 8) {
    const float2 gg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + 8 * h < valid) {
        const float2 v = __bfloat1622float2(*at(h, c));
        *at(h, c) = __floats2bfloat162_rn((v.x - mean[h]) * rs[h] * gg.x,
                                          (v.y - mean[h]) * rs[h] * gg.y);
      }
    }
  }
  if (mean_s != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean_s[r + 8 * h] = mean[h];
      rstd_s[r + 8 * h] = rs[h];
    }
  }
}

// Mean and 1/std of the warp's rows warp·16 + g and + 8 of an f32 tile
// (stride ld, C columns), over the quad's lanes.
__device__ __forceinline__ void row_stats(const float* t, int ld, int C, float (&mean)[2],
                                          float (&rs)[2]) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* row = t + (r + 8 * h) * ld;
    float s = 0.f;
#pragma unroll 4
    for (int c = c0; c < C; c += 8) {
      const float2 v = *reinterpret_cast<const float2*>(row + c);
      s += v.x + v.y;
    }
    mean[h] = quad_sum(s) / C;
    float q = 0.f;
#pragma unroll 4
    for (int c = c0; c < C; c += 8) {
      const float2 v = *reinterpret_cast<const float2*>(row + c);
      q += (v.x - mean[h]) * (v.x - mean[h]) + (v.y - mean[h]) * (v.y - mean[h]);
    }
    rs[h] = 1.f / sqrtf(quad_sum(q) / C + LN_EPS);
  }
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// The bf16 pairs of rows ra and ra + 8 (ra = warp·16 + g) at columns c0 + 8j
// + 2(l % 4) of a (·, C) array with row 0 at `base`, for j < 16, all loads
// issued before any is used; 0 past C or past `valid` rows.
__device__ __forceinline__ void ld_chunk(uint32_t (&q)[16][2], const bf16* __restrict__ base,
                                         int C, int c0, int valid) {
  const int lane = threadIdx.x & 31;
  const int ra = (threadIdx.x >> 5) * 16 + (lane >> 2), c = c0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      q[j][h] = c + 8 * j < C && ra + 8 * h < valid
                    ? __ldg(reinterpret_cast<const unsigned int*>(base + (size_t)(ra + 8 * h) * C +
                                                                  c + 8 * j))
                    : 0u;
}

// The ring's geometry for a block of at most 128 columns: NS = 2 stages of
// STAGE elements, or, for at most 64 columns, NS = 4 stages of half that in
// the same bytes (twice as many slices in flight).
template <int NS>
struct Ring {
  static constexpr int STG = NS == 2 ? STAGE : STAGE / 2;  // elements of a stage
  static constexpr int KN_LD = NS == 2 ? WLD : 64 + 8;      // row of a [k][n] slice
};

// One 32-k slice of a weight block into a ring stage. NK false: W is [k][n]
// (row stride ldw), the slice is W[k0 .. k0+32)[c0 .. c0+ncols) stored
// [32][KN_LD]; NK true: W is [n][k], the slice is W[c0 .. c0+ncols)[k0 ..
// k0+32) stored [ncols][WLDT].
template <bool NK, int NS>
__device__ __forceinline__ void load_slice(bf16* __restrict__ ws, const bf16* __restrict__ W,
                                           int ldw, int k0, int c0, int ncols) {
  if constexpr (!NK) {
    const int ch = ncols >> 3;
    for (int e = threadIdx.x; e < KS * ch; e += THREADS) {
      const int r = e / ch, c = (e - r * ch) * 8;
      mma::cp_async16(ws + r * Ring<NS>::KN_LD + c, W + (size_t)(k0 + r) * ldw + c0 + c, true);
    }
  } else {
    for (int e = threadIdx.x; e < ncols * (KS / 8); e += THREADS) {
      const int r = e >> 2, c = (e & 3) * 8;
      mma::cp_async16(ws + r * WLDT + c, W + (size_t)(c0 + r) * ldw + k0 + c, true);
    }
  }
}

// The first NS - 1 slices of S into the ring, one commit group each.
template <bool NK, int NS>
__device__ __forceinline__ void prime_ring(bf16* ring, const bf16* __restrict__ W, int ldw,
                                           int c0, int ncols, int S) {
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < S) load_slice<NK, NS>(ring + i * Ring<NS>::STG, W, ldw, i * KS, c0, ncols);
    mma::cp_async_commit();
  }
}

// Start gemm_w's copies early (its first slices, for the same W, c0, ncols
// and K). The caller makes sure that no thread still reads the ring, and
// passes `primed` to the gemm_w call that follows.
template <bool NK>
__device__ __forceinline__ void gemm_prime(bf16* ring, const bf16* __restrict__ W, int ldw,
                                           int c0, int ncols, int K) {
  if (ncols <= 64)
    prime_ring<NK, 4>(ring, W, ldw, c0, ncols, K / KS);
  else
    prime_ring<NK, 2>(ring, W, ldw, c0, ncols, K / KS);
}

template <bool NK, int KFIX, int NS, typename AFrag>
__device__ __forceinline__ void gemm_ring(float (&acc)[16][4], AFrag afrag, int K,
                                          const bf16* __restrict__ W, int ldw, int c0,
                                          int ncols, bf16* ring, bool primed) {
  using G = Ring<NS>;
  zero(acc);
  const int S = (KFIX ? KFIX : K) / KS;
  if (!primed) {
    __syncthreads();
    prime_ring<NK, NS>(ring, W, ldw, c0, ncols, S);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    mma::cp_async_wait<NS - 2>();
    __syncthreads();  // slice s is in; every warp is done with slice s - 1
    if (s + NS - 1 < S)
      load_slice<NK, NS>(ring + ((s + NS - 1) % NS) * G::STG, W, ldw, (s + NS - 1) * KS, c0,
                         ncols);
    mma::cp_async_commit();
    const bf16* ws = ring + (s % NS) * G::STG;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t a[4];
      afrag(a, s * (KS / 16) + kk);
#pragma unroll
      for (int jp = 0; jp < (NS == 2 ? 8 : 4); ++jp) {
        if (16 * jp < ncols) {
          uint32_t b[4];
          if constexpr (NK)
            mma::ldsm_b(b, ws + 16 * jp * WLDT + 16 * kk, WLDT);
          else
            mma::ldsm_bt(b, ws + 16 * kk * G::KN_LD + 16 * jp, G::KN_LD);
          mma::mma_bf16(acc[2 * jp], a, b[0], b[1]);
          mma::mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// acc = A · W[:, c0 .. c0+ncols) for the warp's 16 rows (n8 tiles j with 8j
// < ncols; ncols a multiple of 32, at most 128), over K (a multiple of 32;
// KFIX, when not 0, is K as a constant, so that `afrag(a, kstep)` may index
// registers). `afrag(a, ks)` gives the A fragment of k16 step ks. W streams
// through the ring in 32-k slices, 2 in flight (4 for at most 64 columns),
// one barrier a slice. All threads of the CTA call it together; unless
// `primed` (gemm_prime ran) it starts with a barrier, so the ring and
// whatever the caller wrote before are free to use.
template <bool NK, int KFIX, typename AFrag>
__device__ __forceinline__ void gemm_w(float (&acc)[16][4], AFrag afrag, int K,
                                       const bf16* __restrict__ W, int ldw, int c0, int ncols,
                                       bf16* ring, bool primed = false) {
  if (ncols <= 64)
    gemm_ring<NK, KFIX, 4>(acc, afrag, K, W, ldw, c0, ncols, ring, primed);
  else
    gemm_ring<NK, KFIX, 2>(acc, afrag, K, W, ldw, c0, ncols, ring, primed);
}

// A-fragment sources for gemm_w: the warp's 16 rows of a bf16 row tile
// (tile row 0 at `base`, stride `ld`), or A fragments in registers (k16
// step s in r[s]; gemm_w's KFIX must then be 128, so that s is a constant).
struct SmemA {
  const bf16* base;
  int ld;
  __device__ __forceinline__ void operator()(uint32_t (&a)[4], int ks) const {
    mma::ldsm_a(a, base + (threadIdx.x >> 5) * 16 * ld + 16 * ks, ld);
  }
};
struct RegA {
  const uint32_t (&r)[8][4];
  __device__ __forceinline__ void operator()(uint32_t (&a)[4], int ks) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = r[ks][i];
  }
};

// A fragment of the 16 (m) × 16 (k) block at p of a tile stored [k][m] (row
// stride ld): the transposed operand of a product that contracts over the
// tile's rows (pᵀ·v, q_softᵀ·dattn, xnᵀ·dqkv).
__device__ __forceinline__ void ldsm_at(uint32_t (&a)[4], const bf16* p, int ld) {
  const int l = threadIdx.x & 31;
  mma::ldsm_x4_trans(a, p + ((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8);
}

// The four 32 × 32 f32 head blocks at src (4·32·32, contiguous), which hold
// bf16 values, as bf16 into dst (4 × 32 rows of stride WLDT).
// src 16-byte aligned; every load is issued before the first store.
__device__ __forceinline__ void load_heads(bf16* __restrict__ dst, const float* __restrict__ src) {
  constexpr int PER = 4 * DH * DH / 4 / THREADS;  // float4 a thread
  float4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = reinterpret_cast<const float4*>(src)[threadIdx.x + i * THREADS];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = 4 * (threadIdx.x + i * THREADS);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + (e >> 5) * WLDT + (e & 31));
    d[0] = __floats2bfloat162_rn(v[i].x, v[i].y);
    d[1] = __floats2bfloat162_rn(v[i].z, v[i].w);
  }
}

// out (16 × 32 of head h, n8 tiles 0-3) = A (the head's two k16 steps,
// a0 and a1) · B, where B is the head's 32 × 32 block at blk stored [k][n]
// (TRANS false: the block itself) or [n][k] (TRANS true: its transpose).
template <bool TRANS>
__device__ __forceinline__ void head_product(float (&out)[4][4], const uint32_t (&a0)[4],
                                             const uint32_t (&a1)[4], const bf16* blk) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t b[4];
      if constexpr (TRANS)
        mma::ldsm_b(b, blk + 16 * jp * WLDT + 16 * kk, WLDT);
      else
        mma::ldsm_bt(b, blk + 16 * kk * WLDT + 16 * jp, WLDT);
      mma::mma_bf16(out[2 * jp], kk ? a1 : a0, b[0], b[1]);
      mma::mma_bf16(out[2 * jp + 1], kk ? a1 : a0, b[2], b[3]);
    }
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

// Rows g and g + 8 (g = this lane's group) of the warp's 16 × 8·nt
// accumulator, rounded to bf16, into rows warp·16 + g (+8) of a bf16 tile of
// stride ld at column offset c0.
template <int NT>
__device__ __forceinline__ void store_tile(bf16* dst, int ld, const float (&acc)[NT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<uint32_t*>(dst + r * ld + 8 * j + c) = mma::pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(dst + (r + 8) * ld + 8 * j + c) =
        mma::pack_bf16(acc[j][2], acc[j][3]);
  }
}

// The warp's 16 × 128 accumulator from rows warp·16 + g (+8) of a bf16 tile.
__device__ __forceinline__ void read_tile(float (&acc)[16][4], const bf16* src, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + r * ld + 8 * j + c));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + (r + 8) * ld + 8 * j + c));
    acc[j][0] = lo.x;
    acc[j][1] = lo.y;
    acc[j][2] = hi.x;
    acc[j][3] = hi.y;
  }
}

// A fragments of the warp's 16 × 128 accumulator, rounded to bf16: k16 step
// s covers columns 16s .. 16s + 15.
__device__ __forceinline__ void pack_rows(uint32_t (&a)[8][4], const float (&acc)[16][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) mma::pack_a(a[s], acc[2 * s], acc[2 * s + 1]);
}

// Rows g and g + 8 of the warp's 16 × ncols f32 accumulator, + bias[c0 + col],
// into rows warp·16 + g (+8) of an f32 tile of stride ld at column c0.
__device__ __forceinline__ void store_f32(float* dst, int ld, int c0, int ncols,
                                          const float (&acc)[16][4],
                                          const bf16* __restrict__ bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (8 * j < ncols) {
      const int col = c0 + 8 * j + c;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        b0 = __bfloat162float(bias[col]);
        b1 = __bfloat162float(bias[col + 1]);
      }
      *reinterpret_cast<float2*>(dst + r * ld + col) = make_float2(acc[j][0] + b0, acc[j][1] + b1);
      *reinterpret_cast<float2*>(dst + (r + 8) * ld + col) =
          make_float2(acc[j][2] + b0, acc[j][3] + b1);
    }
  }
}

// Host side: the bf16 kernels copy x, dO, their spills and the weights by
// 16-byte cp.async, so every such pointer must be 16-byte aligned.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && ((uintptr_t)p & 15) != 0) return false;
  return true;
}

}  // namespace linattn
}  // namespace daclip
