// Residual(PreNorm(LinearAttention)) forward for the ConditionalUNet, Hopper.
//
// Replaces the Pallas TPU kernel `attn_wrap_v5` (daclip_tpu/ops/
// linear_attention.py:491; bodies `_kernel_stats_v5` :404 and
// `_kernel_apply_v5` :455). Math, per batch element, on x (n, C):
//   xn   = ChannelLN(x)·g_pre                         (rounded to T)
//   q,k,v = xn·W_qkv, 4 heads × 32
//   p    = exp(k − max_n k) (rounded), s = Σ_n p, ctx_h = p_hᵀ·v_h (f32)
//   W_h  = ctx_h · 32^-½ / (s·n)                      (rounded)
//   a    = softmax_head(q) (rounded) · W_h            (rounded)
//   out  = x + ChannelLN(a·W_out + b_out)·g_out       (f32 add, one cast)
// T is bf16 (production) or f32; every product accumulates in f32. The
// rounding points are the TPU kernel's (:423, :428, :439, :552, :473, :482).
//
// What bounds it on an H100: at 256², B=1, bf16 the L0 site (n=65536, C=64)
// must move x in, out out: 2·65536·64·2 B = 16.8 MB, ≈5 µs at 3.35 TB/s;
// this design reads x twice (25 MB, ≈7.5 µs). It computes 2·n·(512·C +
// 8192) ≈ 5.4 GFLOP (q, k, v and to_out 1024·C a row; ctx_h and a_h 4096
// multiply-adds a row each), ≈5.4 µs on the bf16 tensor cores. Both bounds
// are far under what a tile's chain of dependent steps takes (TMA wait, LN,
// products, column max, exponentials, a barrier between each): the kernels
// are latency-bound and hide it with the next tile's copies in flight and
// two or three CTAs an SM (stats and apply both fit three at C ≤ 64).
//
// Design: the TPU ran n in order and carried (m, s, ctx) in VMEM across grid
// steps. Here three launches:
//   stats   grid (parts, B): each CTA walks its `rows` rows in 64-row tiles,
//           keeps running (m, s) and only the 4 diagonal 32×32 ctx blocks
//           (the TPU computed 128×128 and masked 3/4 away), writes partials;
//   combine grid (128, B): rescales partials to the global max, folds in
//           32^-½/(s·n), rounds W; when a backward will follow it also
//           writes the combined diagonal ctx blocks, s and the max m that
//           ctx was taken against (linear_attention_bwd.cu needs all three);
//           a CTA's up to 16 warps split the parts (⌈parts / 8⌉ warps) and
//           add their sums in warp order;
//   apply   each CTA walks a run of `tiles` consecutive (batch element, tile)
//           pairs: LN again, q, per-pixel per-head softmax (the reference's
//           softmax; the TPU's block-global max at :469 can underflow a
//           head), ·W, ·W_out + b_out, LN, + x.
// The schedules are static, chosen in Python (ops/linear_attention.py:
// `_rows_per_part`, `_tiles_per_cta`): a CTA's sums run over the same rows
// in the same order every call, and no launch uses atomics, so the results
// repeat bit for bit. x is read twice (stats, apply) and written once; the
// (n, 384) qkv and the (n, 128) attention never leave shared memory.
//
// bf16 (`tc::stats_tma_kernel`, `tc::apply_tma_kernel`) runs on Hopper's
// machinery with the tiles of linattn_tiles.cuh: a CTA is one warpgroup of
// 128 threads; thread 0 brings each tile's x by TMA (64 × 64 boxes in the
// 128-byte swizzle from a 3-D map that zero-fills past n) into a ring of
// one or two stages on mbarriers (with two the next tile's copies run
// under this tile's work, with one under the SM's other CTAs'), and the
// weights' boxes once a CTA where they fit beside the tiles (every C but
// 384-512 in stats, C ≤ 128 in apply; else each product loads its group of
// boxes). The prenorm
// LN runs in place on the box tile (f32 statistics over the quad of lanes
// that holds a row, rounded once; its gain from a copy in shared memory);
// every projection is wgmma m64n64k16 with xn K-major and the weight boxes
// MN-major: stats v = xn·W_v (rounded to a box tile) and k = xn·W_k (f32),
// apply q = xn·W_q. Stats takes the tile's column max of k across the warp's
// rows by shuffles and across the warps through shared memory, p = exp(k −
// m) rounded over the stage's first two boxes once x is read, and each head
// pair's pᵀ·v on wgmma with both operands MN-major (the
// transpose bits) as a 64 × 64 block, whose two 32 × 32 diagonal blocks add
// to ctx in registers, rescaled by the running max. Apply runs the softmax
// on the accumulator (max and sum across the quad), re-packs q_soft as
// wgmma A fragments for a_h = q_soft_h·W_h (m64n32k16, A in registers, W_h
// resident as bf16 blocks in the 64-byte swizzle), then y = a·W_out + b_out
// in 64-column chunks (A in registers), the post-norm LN over each row's
// quad (sums shifted by the row's first value), ·g_out (+ x), bf16 pairs to
// device memory. At C ≤ 64 the one y chunk stays in registers (`KEEP`);
// above, each of the LN's two sweeps forms the chunks again. Exponentials of
// the softmaxes (not of the running rescale) run on the SFU (__expf).
// Resources (ptxas -v, sm_90a, CUDA 12.9; no spill, no stack): stats 168
// registers (raw x, xn) and 163 (qkv), three CTAs an SM at C ≤ 64 and over
// qkv; apply 168 (raw x, C ≤ 64: three CTAs an SM), 191 (raw x above), 155
// and 186 (xn), 139 (qkv); combine 32. Dynamic shared memory at C = 64
// (daclip_wrap_smem): stats 71,704 bytes, apply 61,464.
// f32 (`stats_kernel`, `apply_kernel`) stays scalar FMA in full f32, as the
// plain version computes (tensor cores would round the operands to TF32).
//
// The same three launches, templated on the input form (raw x with the
// prenorm, normalised xn, or a precomputed qkv) and on the residual, also
// replace the three other TPU kernels of this math:
//   daclip_linattn_fused_v4  `linear_attention_fused_v4` (:310; `_kernel_stats`
//       :246, `_kernel_apply` :282, W finalised in XLA between them at
//       :345-349, here by the combine launch): xn in, no prenorm, no residual;
//   `linear_attention_fused_pallas` (:199; `_kernel_fused` :119): the TPU
//       ran stats and output as two phases of one in-order grid; its function
//       is the v5 wrap's with prenorm and residual on and v4's with both off,
//       so its wrapper calls daclip_wrap_* or daclip_linattn_fused_v4;
//   daclip_linattn_core      `linear_attention_pallas` (:91; `_kernel` :34):
//       qkv (n, 384) in, the 128-wide attention out, before to_out; k and v
//       are read, not projected, and the apply launch ends after ·W.
// Each takes the reference's per-pixel, per-head q-softmax max, where the
// three TPU kernels take one max over the whole block (:80, :177, :292). The
// rounding points are the reference composition's in T (for f32 inputs the
// TPU kernels round p, v, q_soft and W to bf16 whatever the input type).
// Bounds at the path's shapes: as the wrap's; the core moves (n·384 +
// n·128)·2 bytes and does 2·n·(128·32·2) FLOP, bytes-bound.
#include <type_traits>

#include "common.cuh"
#include "linattn_tiles.cuh"
#include "tma.cuh"

namespace daclip {
namespace wrap {

constexpr int HID = 128;     // heads · dim_head
constexpr int DH = 32;       // dim_head
constexpr int TILE = 64;     // rows per tile
constexpr int NT = 256;      // threads per CTA (8 warps)
constexpr float LN_EPS = 1e-5f;

// Input forms of the forward launches.
enum Form : int {
  RAW_X = 0,  // raw x (n, C): ChannelLN·g_pre, then ·W_qkv (v5 wrap, v3 wrap)
  XN = 1,     // normalised xn (n, C): ·W_qkv (v4, v3 without prenorm)
  QKV = 2,    // qkv (n, 384) as given; the output is the 128-wide attention
};

// Load a tile of rows [t0, t0+valid) of x (row stride C) into xs as f32 and,
// with PRENORM, apply the ChannelLN·g, rounded to T. Rows past `valid` are
// zero.
template <typename T, bool PRENORM>
__device__ void load_tile(const T* __restrict__ xb, int t0, int valid, int C,
                          const T* __restrict__ g, float* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE; r += NT / 32) {
    float* row = xs + r * C;
    if (r < valid && !PRENORM) {
      const T* src = xb + (size_t)(t0 + r) * C;
      for (int c = lane; c < C; c += 32) row[c] = to_f(src[c]);
    } else if (r < valid) {
      const T* src = xb + (size_t)(t0 + r) * C;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) {
        float v = to_f(src[c]);
        row[c] = v;
        sum += v;
      }
      const float mean = warp_sum(sum) / C;
      float sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        float d = row[c] - mean;
        sq += d * d;
      }
      const float rs = 1.f / sqrtf(warp_sum(sq) / C + LN_EPS);
      for (int c = lane; c < C; c += 32)
        row[c] = round_t<T>((row[c] - mean) * rs * to_f(g[c]));
    } else {
      for (int c = lane; c < C; c += 32) row[c] = 0.f;
    }
  }
  __syncthreads();
}

// acc[i][j] = Σ_k A[(ty·8+i)·lda + k] · W[k·ldw + tx + 32j] for a 64-row tile,
// 32j < ncols ≤ 32·NC (a lane's columns at or past ncols hold garbage, its
// caller writes none of them). W (global, type T) is staged up to 32 rows at
// a time through ws as f32 (K a multiple of 16). Thread (ty, tx) = (warp, lane).
template <typename T, int NC>
__device__ void gemm_tile(const float* A, int lda, int K, const T* __restrict__ W,
                          int ldw, int ncols, float* ws, float (&acc)[8][NC]) {
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kn = min(32, K - k0);
    for (int e = threadIdx.x; e < kn * ncols; e += NT) {
      const int kk = e / ncols, c = e - kk * ncols;
      ws[e] = to_f(W[(size_t)(k0 + kk) * ldw + c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(ty * 8 + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (j * 32 < ncols) {
          const float w = ws[kk * ncols + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] += a[i] * w;
        }
      }
    }
    __syncthreads();
  }
}

// x is (n, C) per batch element in the form FORM; for QKV, C is 384.
template <typename T, int FORM>
__global__ void __launch_bounds__(NT)
stats_kernel(const T* __restrict__ x, const T* __restrict__ g_pre,
             const T* __restrict__ w_qkv, float* __restrict__ part_m,
             float* __restrict__ part_s, float* __restrict__ part_ctx, int n, int C,
             int rows) {
  extern __shared__ float smem[];
  constexpr bool PROJ = FORM != QKV;   // k, v from xn·W_qkv (else read)
  float* xs = smem;                    // [TILE][C]     xn        (PROJ only)
  float* ws = xs + (PROJ ? TILE * C : 0);    // [32][256] weights (PROJ only)
  float* kv = ws + (PROJ ? 32 * 2 * HID : 0);  // [TILE][256] k | v, then p | v
  float* m_run = kv + TILE * 2 * HID;  // [128]
  float* s_run = m_run + HID;          // [128]
  float* alpha = s_run + HID;          // [128]

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = part * rows, r1 = min(n, r0 + rows);
  const T* xb = x + (size_t)b * n * C;
  // this thread's 16 entries of the diagonal ctx blocks: head hh, row ci,
  // columns cj0 .. cj0+15
  const int hh = tid >> 6, ci = (tid & 63) >> 1, cj0 = (tid & 1) * 16;
  float ctx[16];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) ctx[jj] = 0.f;
  if (tid < HID) {
    m_run[tid] = -1e30f;
    s_run[tid] = 0.f;
  }

  for (int t0 = r0; t0 < r1; t0 += TILE) {
    const int valid = min(TILE, r1 - t0);
    if constexpr (!PROJ) {
      for (int e = tid; e < TILE * 2 * HID; e += NT) {
        const int r = e / (2 * HID), col = e - r * 2 * HID;
        kv[e] = r < valid ? to_f(xb[(size_t)(t0 + r) * C + HID + col])
                          : (col < HID ? -INFINITY : 0.f);
      }
    } else {
      load_tile<T, FORM == RAW_X>(xb, t0, valid, C, g_pre, xs);
      float acc[8][8];
      gemm_tile<T, 8>(xs, C, C, w_qkv + HID, 3 * HID, 2 * HID, ws, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp * 8 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = lane + 32 * j;
          float val = acc[i][j];
          if (col >= HID) val = round_t<T>(val);  // v is rounded, k stays f32
          if (r >= valid) val = col < HID ? -INFINITY : 0.f;
          kv[r * 2 * HID + col] = val;
        }
      }
    }
    __syncthreads();
    if (tid < HID) {
      float mt = -INFINITY;
      for (int r = 0; r < valid; ++r) mt = fmaxf(mt, kv[r * 2 * HID + tid]);
      const float mo = m_run[tid], mn = fmaxf(mo, mt);
      alpha[tid] = expf(mo - mn);
      m_run[tid] = mn;
    }
    __syncthreads();
    for (int e = tid; e < TILE * HID; e += NT) {
      const int r = e / HID, c = e - r * HID;
      float* kp = kv + r * 2 * HID + c;
      *kp = r < valid ? round_t<T>(expf(*kp - m_run[c])) : 0.f;
    }
    __syncthreads();
    if (tid < HID) {
      float ss = 0.f;
      for (int r = 0; r < valid; ++r) ss += kv[r * 2 * HID + tid];
      s_run[tid] = s_run[tid] * alpha[tid] + ss;
    }
    {
      const float a = alpha[hh * DH + ci];
      float add[16];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) add[jj] = 0.f;
      for (int r = 0; r < valid; ++r) {
        const float* kr = kv + r * 2 * HID;
        const float p = kr[hh * DH + ci];
        const float* vr = kr + HID + hh * DH + cj0;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) add[jj] += p * vr[jj];
      }
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) ctx[jj] = ctx[jj] * a + add[jj];
    }
    __syncthreads();
  }

  const size_t pb = (size_t)b * nparts + part;
  if (tid < HID) {
    part_m[pb * HID + tid] = m_run[tid];
    part_s[pb * HID + tid] = s_run[tid];
  }
  float* pc = part_ctx + pb * 4 * DH * DH + hh * DH * DH + ci * DH + cj0;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) pc[jj] = ctx[jj];
}

// The combine launch, one CTA of W ≤ 16 warps per (ctx row c, batch b), W =
// ⌈parts / 8⌉ (`combine_warps`): warp w takes parts w, w + W, … in order,
// lane j the row's column j; the warps' sums add in warp order, so the
// result repeats bit for bit. ctx_out, s_out and m_out are null when no
// backward will follow.
constexpr int COMBINE_WARPS = 16;
inline int combine_warps(int nparts) { return min(COMBINE_WARPS, (nparts + 7) / 8); }
template <typename T>
__global__ void __launch_bounds__(32 * COMBINE_WARPS)
combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
               const float* __restrict__ part_ctx, float* __restrict__ w_attn,
               float* __restrict__ ctx_out, float* __restrict__ s_out,
               float* __restrict__ m_out, int nparts, int n) {
  __shared__ float red_m[COMBINE_WARPS], red_s[COMBINE_WARPS], red_c[COMBINE_WARPS][DH];
  const int c = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, W = blockDim.x >> 5;
  const int hh = c / DH, i = c % DH;
  const float* pm = part_m + (size_t)b * nparts * HID;
  const float* ps = part_s + (size_t)b * nparts * HID;
  const float* pc = part_ctx + (size_t)b * nparts * 4 * DH * DH + hh * DH * DH + i * DH + lane;
  float mx = -INFINITY;
  for (int p = tid; p < nparts; p += 32 * W) mx = fmaxf(mx, pm[p * HID + c]);
  mx = warp_max(mx);
  if (lane == 0) red_m[warp] = mx;
  __syncthreads();
  float M = red_m[0];
  for (int w = 1; w < W; ++w) M = fmaxf(M, red_m[w]);
  float s = 0.f, acc = 0.f;
#pragma unroll 4
  for (int p = warp; p < nparts; p += W) {
    const float e = expf(pm[p * HID + c] - M);
    s += ps[p * HID + c] * e;
    acc += pc[(size_t)p * 4 * DH * DH] * e;
  }
  if (lane == 0) red_s[warp] = s;
  red_c[warp][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
  s = red_s[0];
  acc = red_c[0][lane];
  for (int w = 1; w < W; ++w) {
    s += red_s[w];
    acc += red_c[w][lane];
  }
  const float rowscale = 0.17677669529663687f / (s * (float)n);  // 32^-½ / (s·n)
  const size_t at = (size_t)b * 4 * DH * DH + hh * DH * DH + i * DH + lane;
  w_attn[at] = round_t<T>(acc * rowscale);
  if (ctx_out != nullptr) {
    ctx_out[at] = acc;
    if (lane == 0) {
      s_out[(size_t)b * HID + c] = s;
      m_out[(size_t)b * HID + c] = M;
    }
  }
}

// x is (n, C) per batch element in the form FORM; for QKV, C is 384 and out
// is the (n, 128) attention, else out is (n, C).
template <typename T, int FORM, bool RESIDUAL>
__global__ void __launch_bounds__(NT)
apply_kernel(const T* __restrict__ x, const T* __restrict__ g_pre,
             const T* __restrict__ w_qkv, const float* __restrict__ w_attn,
             const T* __restrict__ w_out, const T* __restrict__ b_out,
             const T* __restrict__ g_out, T* __restrict__ out, int n, int C) {
  extern __shared__ float smem[];
  constexpr bool PROJ = FORM != QKV;  // q from xn·W_q, then to_out and the LN
  float* xs = smem;                             // [TILE][C]   xn, then y (PROJ)
  float* ws = xs + (PROJ ? TILE * C : 0);       // [32][128]   weights    (PROJ)
  float* qs = ws + (PROJ ? 32 * HID : 0);       // [TILE][128] q, q_soft, then attn
  float* wa = qs + TILE * HID;                  // [4][32][32] W of this batch element

  const int b = blockIdx.y, t0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int valid = min(TILE, n - t0);
  const T* xb = x + (size_t)b * n * C;
  for (int e = tid; e < 4 * DH * DH; e += NT) wa[e] = w_attn[(size_t)b * 4 * DH * DH + e];
  if constexpr (!PROJ) {
    for (int e = tid; e < TILE * HID; e += NT) {
      const int r = e / HID, c = e - r * HID;
      qs[e] = r < valid ? to_f(xb[(size_t)(t0 + r) * C + c]) : 0.f;
    }
  } else {
    load_tile<T, FORM == RAW_X>(xb, t0, valid, C, g_pre, xs);  // ends in __syncthreads
    float acc[8][4];
    gemm_tile<T, 4>(xs, C, C, w_qkv, 3 * HID, HID, ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qs[(warp * 8 + i) * HID + lane + 32 * j] = acc[i][j];
  }
  __syncthreads();
  // softmax over each head's 32 channels, per pixel: one warp per (row, head)
  for (int p = warp; p < TILE * 4; p += NT / 32) {
    float* q = qs + (p >> 2) * HID + (p & 3) * DH;
    const float v = q[lane];
    const float e = expf(v - warp_max(v));
    q[lane] = round_t<T>(e / warp_sum(e));
  }
  __syncthreads();
  {
    // attn[r][h·32 + lane] = Σ_i q_soft[r][h·32 + i] · W_h[i][lane]
    float at[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h) at[i][h] = 0.f;
#pragma unroll 4
    for (int ii = 0; ii < DH; ++ii) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float w = wa[h * DH * DH + ii * DH + lane];
#pragma unroll
        for (int i = 0; i < 8; ++i) at[i][h] += qs[(warp * 8 + i) * HID + h * DH + ii] * w;
      }
    }
    if constexpr (!PROJ) {  // the attention is the output
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp * 8 + i;
        if (r < valid) {
          T* dst = out + ((size_t)b * n + t0 + r) * HID + lane;
#pragma unroll
          for (int h = 0; h < 4; ++h) dst[h * DH] = from_f<T>(at[i][h]);
        }
      }
      return;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h) qs[(warp * 8 + i) * HID + h * DH + lane] = round_t<T>(at[i][h]);
  }
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += HID) {
    const int ncols = min(HID, C - c0);
    float acc[8][4];
    gemm_tile<T, 4>(qs, HID, HID, w_out + c0, C, ncols, ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (lane + 32 * j < ncols) {
          const int col = c0 + lane + 32 * j;
          xs[(warp * 8 + i) * C + col] = acc[i][j] + to_f(b_out[col]);
        }
  }
  __syncthreads();
  for (int r = warp; r < valid; r += NT / 32) {
    const float* row = xs + r * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += row[c];
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      float d = row[c] - mean;
      sq += d * d;
    }
    const float rs = 1.f / sqrtf(warp_sum(sq) / C + LN_EPS);
    const T* src = xb + (size_t)(t0 + r) * C;
    T* dst = out + (size_t)b * n * C + (size_t)(t0 + r) * C;
    if constexpr (RESIDUAL) {
      for (int c = lane; c < C; c += 32)
        dst[c] = from_f<T>((row[c] - mean) * rs * to_f(g_out[c]) + to_f(src[c]));
    } else {
      for (int c = lane; c < C; c += 32)
        dst[c] = from_f<T>((row[c] - mean) * rs * to_f(g_out[c]));
    }
  }
}

// -- bf16: wgmma fed by TMA ----------------------------------------------------------
namespace tc {

using namespace linattn;

// Shared memory of stats_tma_kernel: projecting, v as a box tile of 128
// columns; the f32 column reductions (red [4][128], m_run, s_run, alpha
// [128]), g_pre; a stage holds the tile's x boxes (two at least: p takes the
// stage's first two once the projections have read it, as it does over
// qkv's k boxes), or its k and v boxes of qkv; the weights are W_v's and
// W_k's boxes. At C ≤ 64 and over qkv three CTAs fit an SM.
constexpr int STATS_F32 = 4096;
inline Layout stats_layout(int C, int form) {
  const int CB = (C + 63) / 64;
  const bool proj = form != QKV;
  return plan((proj ? 2 : 0) * BOX + STATS_F32 + VEC, (proj ? (CB < 2 ? 2 : CB) : 4) * BOX,
              proj ? 4 * CB : 0, 2, 2 * CB, true);
}

// The bf16 stats launch: as stats_kernel, each CTA walks its `rows` rows in
// 64-row tiles, x (or qkv's k and v) by TMA one tile ahead. v = xn·W_v
// (rounded, to a box tile) and k = xn·W_k (f32) on wgmma with the weights'
// boxes in shared memory; the tile's column max across the warp's rows by
// shuffles, across warps through shared memory; p = exp(k − m) rounded to a
// box tile; then pᵀ·v for the head pairs (0, 1) and (2, 3), A and B
// MN-major, of which the 32 × 32 diagonal blocks add to ctx, kept in
// registers across tiles (rescaled by the running max).
template <int FORM>
__global__ void __launch_bounds__(THREADS, 3)
stats_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const bf16* __restrict__ g_pre, float* __restrict__ part_m,
                 float* __restrict__ part_s, float* __restrict__ part_ctx, int n, int C,
                 LnWidth lw, int rows, Layout L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr bool PROJ = FORM != QKV;
  unsigned char* smem = aligned(smem_raw);
  const uint32_t base = mma::smem_u32(smem);
  const uint32_t vt = base;  // v: 2 boxes (projecting)
  float* red = reinterpret_cast<float*>(smem + (PROJ ? 2 : 0) * BOX);  // [4][128]
  float* m_run = red + 4 * HID;
  float* s_run = m_run + HID;
  float* alpha = s_run + HID;
  bf16* gs = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(red) + STATS_F32);  // g_pre
  const Ring ring{base + L.ring, base + L.bars, L.stages, L.stage_bytes};
  Weights w{base + L.weights, base + L.bars + 8 * MAX_STAGES, 0, L.slots, -1, L.resident != 0,
            false};

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2;
  const int ra = lane_row(), tq = lane_col();
  const int r0 = part * rows, r1 = min(n, r0 + rows);
  const int tiles = cdiv(r1 - r0, ROWS), CB = cdiv(C, 64);
  if (tid == 0) {
    tma::prefetch_map(&tx);
    if (PROJ) tma::prefetch_map(&tw);
    for (int s = 0; s < L.stages; ++s) tma::mbar_init(ring.full(s), 1);
    tma::mbar_init(w.bar, 1);
    tma::mbar_init_fence();
  }
  if (FORM == RAW_X) load_vec(gs, g_pre, C);
  auto issue = [&](int it) {  // thread 0: tile it into its stage
    if (it >= tiles) return;
    const uint32_t st = ring.stage(it), bar = ring.full(it);
    const int row = r0 + it * ROWS;
    if (PROJ) {
      tma::mbar_expect_tx(bar, CB * BOX);
      for (int cb = 0; cb < CB; ++cb) tma::load_3d(st + cb * BOX, &tx, 64 * cb, row, b, bar);
    } else {
      tma::mbar_expect_tx(bar, 4 * BOX);
      for (int i = 0; i < 4; ++i) tma::load_3d(st + i * BOX, &tx, HID + 64 * i, row, b, bar);
    }
  };
  if (tid == 0)
    for (int s = 0; s < L.stages; ++s) issue(s);
  // projection P (0: v, W_qkv columns 256 ..; 1: k, columns 128 ..): its box
  // (kb, i) resident in slot P·2CB + 2kb + i
  auto wcol = [](int P, int i) { return (P == 0 ? 2 * HID : HID) + 64 * i; };
  if (PROJ && w.resident)
    issue_group(w, 0, 4 * CB, [&](int i, const CUtensorMap*& map, int& col, int& row) {
      const int P = i / (2 * CB), r = i % (2 * CB);
      map = &tw;
      col = wcol(P, r & 1);
      row = 64 * (r >> 1);
    });
  __syncthreads();  // the barriers, g_pre
  auto project = [&](float (&acc)[16][4], int P, uint32_t xt) {
    const int kg = w.resident ? CB : min(CB, w.slots / 2);
    for (int kb0 = 0; kb0 < CB; kb0 += kg) {
      const int kb1 = min(CB, kb0 + kg);
      if (!w.resident)
        load_group(w, 64 * P + kb0, 2 * (kb1 - kb0),
                   [&](int i, const CUtensorMap*& map, int& col, int& row) {
                     map = &tw;
                     col = wcol(P, i & 1);
                     row = 64 * (kb0 + (i >> 1));
                   });
      gemm128<1>(
          acc, kb0, kb1, [&](int kb) { return xt + kb * BOX; },
          [&](int kb, int i) {
            return w.slot(w.resident ? P * 2 * CB + 2 * kb + i : 2 * (kb - kb0) + i);
          },
          kb0 == 0);
      wait_all(acc);
    }
  };

  float cx[2][4][4];  // the diagonal ctx blocks of head pairs (0, 1) and (2, 3), across tiles
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cx[p][j][e] = 0.f;
  m_run[tid] = -1e30f;  // THREADS == HID: thread c owns column c
  s_run[tid] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int t0 = r0 + it * ROWS, valid = min(ROWS, r1 - t0);
    const uint32_t st = ring.stage(it);
    unsigned char* xs = smem + (st - base);
    unsigned char* pt = xs;  // p: the stage's first 2 boxes
    float k[16][4];
    ring.wait(it);
    wait_weights(w);
    if constexpr (PROJ) {
      if (FORM == RAW_X) {
        ln_tile(xs, C, lw, valid, gs, nullptr, nullptr);
        mma::fence_proxy_async();  // wgmma reads xn through the async proxy
      }
      __syncthreads();  // xn is whole
      project(k, 0, st);
      store_tile<16>(smem + (vt - base), 0, k);  // v, rounded (rows past valid: xn = 0, so v = 0)
      project(k, 1, st);
      __syncthreads();  // every warp is done with xn: p takes its boxes
    } else {
      read_tile<16>(k, xs, 0);
      __syncthreads();  // every warp has read k: p takes its boxes
    }
    // the tile's column max of k: over the lane's two rows, the warp's 8 row
    // groups (shuffles), then the 4 warps (shared memory)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (ra >= valid) k[j][0] = k[j][1] = -INFINITY;
      if (ra + 8 >= valid) k[j][2] = k[j][3] = -INFINITY;
      float m0 = fmaxf(k[j][0], k[j][2]), m1 = fmaxf(k[j][1], k[j][3]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      if (g == 0) *reinterpret_cast<float2*>(red + warp * HID + 8 * j + tq) = make_float2(m0, m1);
    }
    __syncthreads();
    {
      const float mt = fmaxf(fmaxf(red[tid], red[HID + tid]), fmaxf(red[2 * HID + tid], red[3 * HID + tid]));
      const float mo = m_run[tid], mn = fmaxf(mo, mt);
      alpha[tid] = expf(mo - mn);
      m_run[tid] = mn;
    }
    __syncthreads();
    // p = exp(k − m), rounded, into pt; its column sums
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 mm = *reinterpret_cast<const float2*>(m_run + 8 * j + tq);
      float p[4];
      p[0] = ra < valid ? round_t<bf16>(__expf(k[j][0] - mm.x)) : 0.f;
      p[1] = ra < valid ? round_t<bf16>(__expf(k[j][1] - mm.y)) : 0.f;
      p[2] = ra + 8 < valid ? round_t<bf16>(__expf(k[j][2] - mm.x)) : 0.f;
      p[3] = ra + 8 < valid ? round_t<bf16>(__expf(k[j][3] - mm.y)) : 0.f;
      *pair_at(pt, ra, 8 * j + tq) = __floats2bfloat162_rn(p[0], p[1]);
      *pair_at(pt, ra + 8, 8 * j + tq) = __floats2bfloat162_rn(p[2], p[3]);
      float s0 = p[0] + p[2], s1 = p[1] + p[3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) *reinterpret_cast<float2*>(red + warp * HID + 8 * j + tq) = make_float2(s0, s1);
    }
    mma::fence_proxy_async();
    __syncthreads();
    s_run[tid] = s_run[tid] * alpha[tid] + ((red[tid] + red[HID + tid]) + (red[2 * HID + tid] + red[3 * HID + tid]));
    // ctx·alpha + pᵀ·v: row r of pair p is channel 64p + r
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float a0 = alpha[64 * p + ra], a1 = alpha[64 * p + ra + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cx[p][j][0] *= a0;
        cx[p][j][1] *= a0;
        cx[p][j][2] *= a1;
        cx[p][j][3] *= a1;
      }
    }
    {
      float t[2][8][4];
      add_pair_diagonals(cx, t, mma::smem_u32(pt), PROJ ? vt : st + 2 * BOX);
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0) issue(it + L.stages);
  }

  const size_t pb = (size_t)b * nparts + part;
  part_m[pb * HID + tid] = m_run[tid];
  part_s[pb * HID + tid] = s_run[tid];
  store_pair_diagonals(part_ctx + pb * 4 * DH * DH, cx);
}

// Shared memory of apply_tma_kernel: the four W_h blocks, g_pre, g_out and
// b_out; a stage holds the tile's x boxes (or qkv's q boxes); the weights
// are W_q's and W_out's boxes.
inline Layout apply_layout(int C, int form) {
  const int CB = (C + 63) / 64;
  const bool proj = form != QKV;
  return plan(HEADS_BYTES + 3 * VEC, (proj ? CB : 2) * BOX, proj ? 4 * CB : 0, 2, 2 * CB);
}

// The bf16 apply launch: each CTA walks `tiles` consecutive tiles of the
// B·⌈n/64⌉ (batch element, tile) pairs, x by TMA one tile ahead, W_h of the
// tile's batch element resident. Per tile: q = xn·W_q on wgmma, the
// per-pixel per-head softmax in the accumulator (max and sum across the
// quad), q_soft rounded and re-packed as A fragments for a_h = q_soft_h·W_h
// (wgmma m64n32k16, A in registers), a rounded and re-packed for y =
// a·W_out + b_out in 64-column chunks (A in registers), then the LN over each
// row's quad, ·g_out (+ x), written as bf16 pairs. KEEP (C ≤ 64): the one y
// chunk stays in registers; else each of the two sweeps over a row's chunks
// (the LN's row sums, the output) forms them again.
// Three CTAs an SM where KEEP or reading qkv (at most 168 registers), else
// one or two as the registers fall.
template <int FORM, bool RESIDUAL, bool KEEP>
__global__ void __launch_bounds__(THREADS, KEEP || FORM == QKV ? 3 : 1)
apply_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap to, const bf16* __restrict__ x,
                 const bf16* __restrict__ g_pre, const float* __restrict__ w_attn,
                 const bf16* __restrict__ b_out, const bf16* __restrict__ g_out,
                 bf16* __restrict__ out, int B, int n, int C, LnWidth lw, int tiles_per_cta,
                 Layout L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr bool PROJ = FORM != QKV;
  unsigned char* smem = aligned(smem_raw);
  const uint32_t base = mma::smem_u32(smem);
  unsigned char* heads = smem;  // W_h: 4 blocks
  bf16* gps = reinterpret_cast<bf16*>(smem + HEADS_BYTES);  // g_pre, g_out, b_out
  bf16* gos = gps + VEC / 2;
  bf16* bs = gos + VEC / 2;
  const Ring ring{base + L.ring, base + L.bars, L.stages, L.stage_bytes};
  Weights w{base + L.weights, base + L.bars + 8 * MAX_STAGES, 0, L.slots, -1, L.resident != 0,
            false};

  const int tid = threadIdx.x, ra = lane_row(), tq = lane_col();
  const int ntile = cdiv(n, ROWS), CB = cdiv(C, 64);
  const int f0 = blockIdx.x * tiles_per_cta, f1 = min(B * ntile, f0 + tiles_per_cta);
  const int tiles = f1 - f0;
  if (tid == 0) {
    tma::prefetch_map(&tx);
    if (PROJ) {
      tma::prefetch_map(&tw);
      tma::prefetch_map(&to);
    }
    for (int s = 0; s < L.stages; ++s) tma::mbar_init(ring.full(s), 1);
    tma::mbar_init(w.bar, 1);
    tma::mbar_init_fence();
  }
  if (FORM == RAW_X) load_vec(gps, g_pre, C);
  if (PROJ) {
    load_vec(gos, g_out, C);
    load_vec(bs, b_out, C);
  }
  auto issue = [&](int it) {  // thread 0: tile it into its stage
    if (it >= tiles) return;
    const int f = f0 + it, b = f / ntile, row = (f - b * ntile) * ROWS;
    const uint32_t st = ring.stage(it), bar = ring.full(it);
    const int nb = PROJ ? CB : 2;
    tma::mbar_expect_tx(bar, nb * BOX);
    for (int cb = 0; cb < nb; ++cb) tma::load_3d(st + cb * BOX, &tx, 64 * cb, row, b, bar);
  };
  if (tid == 0)
    for (int s = 0; s < L.stages; ++s) issue(s);
  // W_q's box (kb, i) resident in slot 2kb + i, W_out's (chunk j, rows 64rb)
  // in 2CB + 2j + rb
  auto at_resident = [&](int i, const CUtensorMap*& map, int& col, int& row) {
    if (i < 2 * CB) {
      map = &tw;
      col = 64 * (i & 1);
      row = 64 * (i >> 1);
    } else {
      map = &to;
      col = 64 * ((i - 2 * CB) >> 1);
      row = 64 * (i & 1);
    }
  };
  if (PROJ && w.resident) issue_group(w, 0, 4 * CB, at_resident);
  __syncthreads();  // the barriers, the vectors
  const int kg = w.resident ? CB : min(CB, w.slots / 2);  // k-blocks, or y chunks, a group

  int cur_b = -1;
  for (int it = 0; it < tiles; ++it) {
    const int f = f0 + it, b = f / ntile, t0 = (f - b * ntile) * ROWS;
    const int valid = min(ROWS, n - t0);
    const uint32_t st = ring.stage(it);
    unsigned char* xs = smem + (st - base);
    if (b != cur_b) {  // W_h of this batch element
      __syncthreads();  // every warp is done with the last one
      load_heads(heads, w_attn + (size_t)b * 4 * DH * DH);
      mma::fence_proxy_async();
      cur_b = b;
    }
    float acc[16][4];
    ring.wait(it);
    wait_weights(w);
    if constexpr (PROJ) {
      if (FORM == RAW_X) {
        ln_tile(xs, C, lw, valid, gps, nullptr, nullptr);
        mma::fence_proxy_async();
      }
      __syncthreads();  // xn (and W_h) whole
      for (int kb0 = 0; kb0 < CB; kb0 += kg) {  // q = xn·W_q
        const int kb1 = min(CB, kb0 + kg);
        if (!w.resident)
          load_group(w, kb0, 2 * (kb1 - kb0), [&](int i, const CUtensorMap*& map, int& col, int& row) {
            map = &tw;
            col = 64 * (i & 1);
            row = 64 * (kb0 + (i >> 1));
          });
        gemm128<1>(
            acc, kb0, kb1, [&](int kb) { return st + kb * BOX; },
            [&](int kb, int i) { return w.slot(w.resident ? 2 * kb + i : 2 * (kb - kb0) + i); },
            kb0 == 0);
        wait_all(acc);
      }
    } else {
      __syncthreads();  // W_h whole
      read_tile<16>(acc, xs, 0);
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0) issue(it + L.stages);
    head_softmax(acc);
    uint32_t qa[8][4];
    pack_rows<16>(qa, acc);  // q_soft, rounded
    head_products<1>(acc, qa, base);  // a_h = q_soft_h·W_h
    if constexpr (!PROJ) {  // the attention is the output
      store_rows<16>(out + ((size_t)b * n + t0) * HID, HID, 0, HID, valid, acc);
      continue;
    }
    pack_rows<16>(qa, acc);  // a, rounded
    // y chunk j = a·W_out[:, 64j ..] + b_out
    auto y_chunk = [&](int j, float (&y)[8][4]) {
      const int j0 = j / kg * kg;
      if (!w.resident)
        load_group(w, 64 + j0, 2 * min(kg, CB - j0),
                   [&](int i, const CUtensorMap*& map, int& col, int& row) {
                     map = &to;
                     col = 64 * (j0 + (i >> 1));
                     row = 64 * (i & 1);
                   });
      gemm64_rs<1, 8>(
          y, qa, [&](int kb) { return w.slot(w.resident ? 2 * CB + 2 * j + kb : 2 * (j - j0) + kb); },
          true);
      wait_all(y);
      add_bias(y, bs, 64 * j, C);
    };
    float y0[8][4];  // KEEP: the only chunk
    if constexpr (KEEP) y_chunk(0, y0);
    auto sweep = [&](auto&& body) {
      if constexpr (KEEP) {
        body(0, y0);
      } else {
        for (int j = 0; j < CB; ++j) {
          float t[8][4];
          y_chunk(j, t);
          body(j, t);
        }
      }
    };
    // the LN of y over each row's quad: sums of y − sh and (y − sh)² (sh: the
    // row's y at column 0, so that the sums stay small), then mean and 1/std
    float sh[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, mean[2], rs[2];
    sweep([&](int j, const float (&t)[8][4]) {
      if (j == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sh[h] = __fmul_rn(__shfl_sync(0xffffffffu, t[0][2 * h], (tid & 31) & ~3), lw.shift);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (64 * j + 8 * jj + tq < C)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d0 = t[jj][2 * h] - sh[h], d1 = t[jj][2 * h + 1] - sh[h];
            s1[h] += d0 + d1;
            s2[h] += d0 * d0 + d1 * d1;
          }
    });
    // over the LN's cn columns (`LnWidth`: y is 0 past cn, as W_out's
    // columns and b_out are there)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e1 = __fmul_rn(quad_sum(s1[h]) / C, lw.ratio);  // mean(y − sh)
      mean[h] = sh[h] + e1;
      rs[h] =
          1.f / sqrtf(fmaxf(__fmul_rn(quad_sum(s2[h]) / C, lw.ratio) - e1 * e1, 0.f) + LN_EPS);
    }
    const bf16* xt = x + ((size_t)b * n + t0) * C;
    bf16* ot = out + ((size_t)b * n + t0) * C;
    sweep([&](int j, const float (&t)[8][4]) {
      uint32_t xq[8][2];  // x's pairs, then the output's
      if constexpr (RESIDUAL) ld_chunk<8>(xq, xt, C, 64 * j, valid);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * j + 8 * jj + tq;
        if (c < C) {
          const float2 gg = ld_pair(gos + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float o0 = (t[jj][2 * h] - mean[h]) * rs[h] * gg.x;
            float o1 = (t[jj][2 * h + 1] - mean[h]) * rs[h] * gg.y;
            if constexpr (RESIDUAL) {
              const float2 xv = unpack(xq[jj][h]);
              o0 += xv.x;
              o1 += xv.y;
            }
            xq[jj][h] = mma::pack_bf16(o0, o1);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (64 * j + 8 * jj + tq < C && ra + 8 * h < valid)
            *reinterpret_cast<uint32_t*>(ot + (size_t)(ra + 8 * h) * C + 64 * j + 8 * jj + tq) =
                xq[jj][h];
    });
  }
}

}  // namespace tc

inline size_t stats_smem(int C, int form) {
  const size_t proj = form == QKV ? 0 : TILE * C + 32 * 2 * HID;
  return (proj + TILE * 2 * HID + 3 * HID) * sizeof(float);
}
inline size_t apply_smem(int C, int form) {
  const size_t proj = form == QKV ? 0 : TILE * C + 32 * HID;
  return (proj + TILE * HID + 4 * DH * DH) * sizeof(float);
}

template <typename T>
constexpr bool IS_BF16 = std::is_same<T, __nv_bfloat16>::value;

template <class K>
cudaError_t smem_opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int FORM>
int launch_stats(const void* x, const void* g, const void* w, void* pm, void* ps, void* pc,
                 int B, int n, int C, int cn, int rows, cudaStream_t st) {
  dim3 grid((n + rows - 1) / rows, B);
  if constexpr (IS_BF16<T>) {
    if (!linattn::aligned16({x, g, w})) return (int)cudaErrorMisalignedAddress;
    const linattn::Layout L = tc::stats_layout(C, FORM);
    if (L.bytes == 0) return (int)cudaErrorInvalidValue;
    CUtensorMap tx, tw;
    cudaError_t err = tma::encode_boxes(&tx, x, B, n, FORM == QKV ? 3 * HID : C);
    if (err == cudaSuccess) err = tma::encode_boxes(&tw, FORM == QKV ? x : w, 1, C, 3 * HID);
    auto kernel = tc::stats_tma_kernel<FORM>;
    if (err == cudaSuccess) err = smem_opt_in(kernel, L.bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, linattn::THREADS, L.bytes, st>>>(tx, tw, (const T*)g, (float*)pm, (float*)ps,
                                                    (float*)pc, n, C, linattn::ln_width(C, cn),
                                                    rows, L);
    return (int)cudaGetLastError();
  } else {
    const size_t smem = stats_smem(C, FORM);
    cudaError_t err = smem_opt_in(stats_kernel<T, FORM>, (int)smem);
    if (err != cudaSuccess) return (int)err;
    stats_kernel<T, FORM><<<grid, NT, smem, st>>>((const T*)x, (const T*)g, (const T*)w,
                                                  (float*)pm, (float*)ps, (float*)pc, n, C,
                                                  rows);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_combine(const void* pm, const void* ps, const void* pc, void* w_attn, void* ctx_out,
                   void* s_out, void* m_out, int B, int nparts, int n, cudaStream_t st) {
  combine_kernel<T><<<dim3(HID, B), 32 * combine_warps(nparts), 0, st>>>(
      (const float*)pm, (const float*)ps, (const float*)pc, (float*)w_attn, (float*)ctx_out,
      (float*)s_out, (float*)m_out, nparts, n);
  return (int)cudaGetLastError();
}

template <int FORM, bool RESIDUAL, bool KEEP>
int launch_apply_tma(const void* x, const void* g_pre, const void* w_qkv, const void* w_attn,
                     const void* w_out, const void* b_out, const void* g_out, void* out, int B,
                     int n, int C, int cn, int tiles, cudaStream_t st) {
  using linattn::bf16;
  const linattn::Layout L = tc::apply_layout(C, FORM);
  if (L.bytes == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, to;
  const bool proj = FORM != QKV;
  cudaError_t err = tma::encode_boxes(&tx, x, B, n, proj ? C : 3 * HID);
  if (err == cudaSuccess) err = tma::encode_boxes(&tw, proj ? w_qkv : x, 1, C, 3 * HID);
  if (err == cudaSuccess) err = tma::encode_boxes(&to, proj ? w_out : x, 1, HID, C);
  auto kernel = tc::apply_tma_kernel<FORM, RESIDUAL, KEEP>;
  if (err == cudaSuccess) err = smem_opt_in(kernel, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int total = B * ((n + TILE - 1) / TILE);
  kernel<<<(total + tiles - 1) / tiles, linattn::THREADS, L.bytes, st>>>(
      tx, tw, to, (const bf16*)x, (const bf16*)g_pre, (const float*)w_attn, (const bf16*)b_out,
      (const bf16*)g_out, (bf16*)out, B, n, C, linattn::ln_width(C, cn), tiles, L);
  return (int)cudaGetLastError();
}

template <typename T, int FORM, bool RESIDUAL>
int launch_apply(const void* x, const void* g_pre, const void* w_qkv, const void* w_attn,
                 const void* w_out, const void* b_out, const void* g_out, void* out, int B,
                 int n, int C, int cn, int tiles, cudaStream_t st) {
  if constexpr (IS_BF16<T>) {
    if (!linattn::aligned16({x, g_pre, w_qkv, w_out, b_out, g_out, out}))
      return (int)cudaErrorMisalignedAddress;
    if (tiles < 1) return (int)cudaErrorInvalidValue;
    return C <= 64 ? launch_apply_tma<FORM, RESIDUAL, true>(x, g_pre, w_qkv, w_attn, w_out, b_out,
                                                           g_out, out, B, n, C, cn, tiles, st)
                   : launch_apply_tma<FORM, RESIDUAL, false>(x, g_pre, w_qkv, w_attn, w_out,
                                                            b_out, g_out, out, B, n, C, cn, tiles,
                                                            st);
  } else {
    dim3 grid((n + TILE - 1) / TILE, B);
    const size_t smem = apply_smem(C, FORM);
    auto kernel = apply_kernel<T, FORM, RESIDUAL>;
    cudaError_t err = smem_opt_in(kernel, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NT, smem, st>>>((const T*)x, (const T*)g_pre, (const T*)w_qkv,
                                   (const float*)w_attn, (const T*)w_out, (const T*)b_out,
                                   (const T*)g_out, (T*)out, n, C);
    return (int)cudaGetLastError();
  }
}

// stats → combine → apply on one stream, no statistics kept: the forward of
// #5 and #7. part_* and w_attn are the caller's scratch, sized as for
// daclip_wrap_stats with ⌈n/rows⌉ parts.
template <typename T, int FORM, bool RESIDUAL>
int launch_forward(const void* x, const void* g_pre, const void* w_qkv, const void* w_out,
                   const void* b_out, const void* g_out, void* pm, void* ps, void* pc,
                   void* w_attn, void* out, int B, int n, int C, int cn, int rows, int tiles,
                   cudaStream_t st) {
  int err = launch_stats<T, FORM>(x, g_pre, w_qkv, pm, ps, pc, B, n, C, cn, rows, st);
  if (err) return err;
  err = launch_combine<T>(pm, ps, pc, w_attn, nullptr, nullptr, nullptr, B,
                          (n + rows - 1) / rows, n, st);
  if (err) return err;
  return launch_apply<T, FORM, RESIDUAL>(x, g_pre, w_qkv, w_attn, w_out, b_out, g_out, out, B,
                                         n, C, cn, tiles, st);
}

}  // namespace wrap
}  // namespace daclip

using namespace daclip::wrap;

// C: the rows' width, cn: the LayerNorms' (`daclip::linattn::widths_ok`).
extern "C" int daclip_wrap_stats(const void* x, const void* g_pre, const void* w_qkv,
                                 void* part_m, void* part_s, void* part_ctx, int B, int n,
                                 int C, int cn, int rows, int is_bf16, void* stream) {
  if (!daclip::linattn::widths_ok(C, cn, is_bf16) || rows % TILE || n < 1)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_stats<__nv_bfloat16, RAW_X>(x, g_pre, w_qkv, part_m, part_s,
                                                      part_ctx, B, n, C, cn, rows, st)
                 : launch_stats<float, RAW_X>(x, g_pre, w_qkv, part_m, part_s, part_ctx, B, n,
                                              C, cn, rows, st);
}

extern "C" int daclip_wrap_combine(const void* part_m, const void* part_s,
                                   const void* part_ctx, void* w_attn, void* ctx_out,
                                   void* s_out, void* m_out, int B, int nparts, int n,
                                   int is_bf16, void* stream) {
  if ((ctx_out == nullptr) != (s_out == nullptr) || (s_out == nullptr) != (m_out == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_combine<__nv_bfloat16>(part_m, part_s, part_ctx, w_attn, ctx_out,
                                                 s_out, m_out, B, nparts, n, st)
                 : launch_combine<float>(part_m, part_s, part_ctx, w_attn, ctx_out, s_out,
                                         m_out, B, nparts, n, st);
}

// `tiles`: the 64-row tiles of the B·⌈n/64⌉ each bf16 CTA walks (the f32
// kernel takes one a CTA and ignores it).
extern "C" int daclip_wrap_apply(const void* x, const void* g_pre, const void* w_qkv,
                                 const void* w_attn, const void* w_out, const void* b_out,
                                 const void* g_out, void* out, int B, int n, int C, int cn,
                                 int tiles, int is_bf16, void* stream) {
  if (!daclip::linattn::widths_ok(C, cn, is_bf16) || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_apply<__nv_bfloat16, RAW_X, true>(x, g_pre, w_qkv, w_attn, w_out,
                                                            b_out, g_out, out, B, n, C, cn, tiles,
                                                            st)
                 : launch_apply<float, RAW_X, true>(x, g_pre, w_qkv, w_attn, w_out, b_out,
                                                    g_out, out, B, n, C, cn, tiles, st);
}

// #5, linear_attention_fused_v4: xn (B, n, C) → ChannelLN(attn(xn)·W_out + b)·g
extern "C" int daclip_linattn_fused_v4(const void* xn, const void* w_qkv, const void* w_out,
                                       const void* b_out, const void* g_out, void* part_m,
                                       void* part_s, void* part_ctx, void* w_attn, void* out,
                                       int B, int n, int C, int cn, int rows, int tiles,
                                       int is_bf16, void* stream) {
  if (!daclip::linattn::widths_ok(C, cn, is_bf16) || rows % TILE || n < 1)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_forward<__nv_bfloat16, XN, false>(
                       xn, nullptr, w_qkv, w_out, b_out, g_out, part_m, part_s, part_ctx,
                       w_attn, out, B, n, C, cn, rows, tiles, st)
                 : launch_forward<float, XN, false>(xn, nullptr, w_qkv, w_out, b_out, g_out,
                                                    part_m, part_s, part_ctx, w_attn, out, B,
                                                    n, C, cn, rows, tiles, st);
}

// #7, linear_attention_pallas: qkv (B, n, 384) → the attention (B, n, 128)
extern "C" int daclip_linattn_core(const void* qkv, void* part_m, void* part_s, void* part_ctx,
                                   void* w_attn, void* out, int B, int n, int rows, int tiles,
                                   int is_bf16, void* stream) {
  if (rows % TILE || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_forward<__nv_bfloat16, QKV, false>(
                       qkv, nullptr, nullptr, nullptr, nullptr, nullptr, part_m, part_s,
                       part_ctx, w_attn, out, B, n, 3 * HID, 3 * HID, rows, tiles, st)
                 : launch_forward<float, QKV, false>(qkv, nullptr, nullptr, nullptr, nullptr,
                                                     nullptr, part_m, part_s, part_ctx, w_attn,
                                                     out, B, n, 3 * HID, 3 * HID, rows, tiles, st);
}

// The bf16 launches' dynamic shared memory in bytes at C: kernel 0 stats, 1
// apply, in input form `form` (0 raw x, 1 xn, 2 qkv); 0 if it does not fit.
extern "C" int daclip_wrap_smem(int kernel, int C, int form) {
  if (!daclip::linattn::widths_ok(C, C, 1) || form < 0 || form > 2) return 0;
  return kernel == 0 ? tc::stats_layout(C, form).bytes : tc::apply_layout(C, form).bytes;
}
