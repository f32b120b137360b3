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
// this design reads x twice (25 MB, ≈7.5 µs). It computes ≈5.4 GFLOP
// (2·n·(512·C + 12288)), ≈5.5 µs on the bf16 tensor cores, so the wrap is
// memory-bound there once its products run on the tensor cores.
//
// Two implementations of each launch: bf16 (`tc::stats_mma_kernel`,
// `tc::apply_mma_kernel`) does every product on mma.sync m16n8k16 with the
// tiles of linattn_tiles.cuh: 4 warps × 16 rows a 64-row tile, the tile's
// rows as bf16 in shared memory (the prenorm LN in f32, rounded once), the
// weights streamed as bf16 in 32-k slices through a cp.async ring, the
// per-head softmax and the LN over a row's quad of lanes and the column
// max/sum over the warp's lanes by shuffles, accumulators re-packed as A
// fragments for the next product (q_soft·W_h, a·W_out), ctx_h = p_hᵀ·v_h
// with A through ldmatrix.trans; the apply CTAs walk several tiles each, W_h
// resident. Exponentials of the softmaxes (not of the running rescale) run
// on the SFU (__expf).
// f32 (`stats_kernel`, `apply_kernel`) stays scalar FMA in full f32, as the
// plain version computes (tensor cores would round the operands to TF32).
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
//   apply   grid (⌈n/64⌉, B): LN again, q, per-pixel per-head softmax (the
//           reference's softmax; the TPU's block-global max at :469 can
//           underflow a head), ·W, ·W_out + b_out, LN, + x.
// x is read twice (stats, apply) and written once; the (n, 384) qkv and the
// (n, 128) attention never leave shared memory.
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
// j < ncols/32 (ncols a multiple of 32, ≤ 32·NC). W (global, type T) is staged
// 32 rows at a time through ws as f32. Thread (ty, tx) = (warp, lane).
template <typename T, int NC>
__device__ void gemm_tile(const float* A, int lda, int K, const T* __restrict__ W,
                          int ldw, int ncols, float* ws, float (&acc)[8][NC]) {
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    for (int e = threadIdx.x; e < 32 * ncols; e += NT) {
      const int kk = e / ncols, c = e - kk * ncols;
      ws[e] = to_f(W[(size_t)(k0 + kk) * ldw + c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
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

// One warp per (ctx row c, batch b): lane = column within the head block.
// ctx_out/s_out/m_out are null when no backward will follow.
template <typename T>
__global__ void __launch_bounds__(32)
combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
               const float* __restrict__ part_ctx, float* __restrict__ w_attn,
               float* __restrict__ ctx_out, float* __restrict__ s_out,
               float* __restrict__ m_out, int nparts, int n) {
  const int c = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int hh = c / DH, i = c % DH;
  const float* pm = part_m + (size_t)b * nparts * HID;
  const float* ps = part_s + (size_t)b * nparts * HID;
  const float* pc = part_ctx + (size_t)b * nparts * 4 * DH * DH;
  float M = -INFINITY;
  for (int p = lane; p < nparts; p += 32) M = fmaxf(M, pm[p * HID + c]);
  M = warp_max(M);
  float s = 0.f;
  for (int p = lane; p < nparts; p += 32) s += ps[p * HID + c] * expf(pm[p * HID + c] - M);
  s = warp_sum(s);
  float acc = 0.f;
  for (int p = 0; p < nparts; ++p)
    acc += pc[(size_t)p * 4 * DH * DH + hh * DH * DH + i * DH + lane] * expf(pm[p * HID + c] - M);
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
        if (j * 32 < ncols) {
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

// -- bf16: tensor cores --------------------------------------------------------
namespace tc {

using namespace linattn;

// Shared memory of stats_mma_kernel: ps, vs [64][WLD] bf16; red [4][128],
// m_run, s_run, alpha [128] f32; with the projection the ring and the row
// tile [64][C + 8] bf16.
inline size_t stats_smem(int C, int form) {
  const size_t base = 2 * ROWS * WLD * 2 + 7 * HID * 4;
  return base + (form == QKV ? 0 : RING_BYTES + (size_t)ROWS * (C + 8) * 2);
}

// The bf16 stats launch: as stats_kernel, each CTA walks its rows in 64-row
// tiles, 4 warps × 16 rows. v = xn·W_v (rounded) and k = xn·W_k (f32) on
// mma.sync, k in registers; the tile's column max across the warp's rows by
// shuffles, across warps through shared memory; p = exp(k − m) rounded into
// shared memory; then warp h computes ctx_h += p_hᵀ·v_h (A through
// ldmatrix.trans), the 32 × 32 block in registers across tiles.
template <int FORM>
__global__ void __launch_bounds__(THREADS)
stats_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g_pre,
                 const bf16* __restrict__ w_qkv, float* __restrict__ part_m,
                 float* __restrict__ part_s, float* __restrict__ part_ctx, int n, int C,
                 int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool PROJ = FORM != QKV;
  bf16* ps = reinterpret_cast<bf16*>(smem);  // [64][WLD] k (form QKV), then p
  bf16* vs = ps + ROWS * WLD;                // [64][WLD] v
  float* red = reinterpret_cast<float*>(vs + ROWS * WLD);  // [4][128]
  float* m_run = red + 4 * HID;
  float* s_run = m_run + HID;
  float* alpha = s_run + HID;
  bf16* ring = reinterpret_cast<bf16*>(alpha + HID);  // projection only
  bf16* xs = ring + 2 * STAGE;                        // [64][C + 8], projection only
  const int LDX = C + 8;

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = 2 * (lane & 3), ra = warp * 16 + g;
  const int r0 = part * rows, r1 = min(n, r0 + rows);
  const bf16* xb = x + (size_t)b * n * C;
  float cx[2][4][4];  // ctx of head `warp`: rows 16mi + g (+8), columns 8nj + tq (+1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cx[mi][j][e] = 0.f;
  m_run[tid] = -1e30f;  // THREADS == HID: thread c owns column c
  s_run[tid] = 0.f;

  for (int t0 = r0; t0 < r1; t0 += ROWS) {
    const int valid = min(ROWS, r1 - t0);
    float k[16][4];
    __syncthreads();  // the previous tile's ctx products are done with ps, vs
    if constexpr (PROJ) {
      gemm_prime<false>(ring, w_qkv, 3 * HID, 2 * HID, HID, C);  // W_v's copies first
      load_rows(xs, LDX, xb, C, t0, valid, 0, C);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
      if (FORM == RAW_X) ln_tile(xs, C, valid, g_pre, nullptr, nullptr);
      gemm_w<false, 0>(k, SmemA{xs, LDX}, C, w_qkv, 3 * HID, 2 * HID, HID, ring, true);
      __syncthreads();
      gemm_prime<false>(ring, w_qkv, 3 * HID, HID, HID, C);      // then W_k's
      store_tile<16>(vs, WLD, k);  // v, rounded; rows past valid are 0 (xn is)
      gemm_w<false, 0>(k, SmemA{xs, LDX}, C, w_qkv, 3 * HID, HID, HID, ring, true);
    } else {
      load_rows(ps, WLD, xb, 3 * HID, t0, valid, HID, HID);
      load_rows(vs, WLD, xb, 3 * HID, t0, valid, 2 * HID, HID);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
      read_tile(k, ps, WLD);
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
    // p = exp(k − m), rounded, into ps; its column sums
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 mm = *reinterpret_cast<const float2*>(m_run + 8 * j + tq);
      float p[4];
      p[0] = ra < valid ? round_t<bf16>(__expf(k[j][0] - mm.x)) : 0.f;
      p[1] = ra < valid ? round_t<bf16>(__expf(k[j][1] - mm.y)) : 0.f;
      p[2] = ra + 8 < valid ? round_t<bf16>(__expf(k[j][2] - mm.x)) : 0.f;
      p[3] = ra + 8 < valid ? round_t<bf16>(__expf(k[j][3] - mm.y)) : 0.f;
      *reinterpret_cast<uint32_t*>(ps + ra * WLD + 8 * j + tq) = mma::pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(ps + (ra + 8) * WLD + 8 * j + tq) = mma::pack_bf16(p[2], p[3]);
      float s0 = p[0] + p[2], s1 = p[1] + p[3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) *reinterpret_cast<float2*>(red + warp * HID + 8 * j + tq) = make_float2(s0, s1);
    }
    __syncthreads();
    s_run[tid] = s_run[tid] * alpha[tid] + ((red[tid] + red[HID + tid]) + (red[2 * HID + tid] + red[3 * HID + tid]));
    // ctx_h = ctx_h·alpha + p_hᵀ·v_h, h = warp
    const int h = warp;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float a0 = alpha[h * DH + 16 * mi + g], a1 = alpha[h * DH + 16 * mi + g + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cx[mi][j][0] *= a0;
        cx[mi][j][1] *= a0;
        cx[mi][j][2] *= a1;
        cx[mi][j][3] *= a1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t a[4];
        ldsm_at(a, ps + 16 * kk * WLD + h * DH + 16 * mi, WLD);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bb[4];
          mma::ldsm_bt(bb, vs + 16 * kk * WLD + h * DH + 16 * jp, WLD);
          mma::mma_bf16(cx[mi][2 * jp], a, bb[0], bb[1]);
          mma::mma_bf16(cx[mi][2 * jp + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  const size_t pb = (size_t)b * nparts + part;
  part_m[pb * HID + tid] = m_run[tid];
  part_s[pb * HID + tid] = s_run[tid];
  float* pc = part_ctx + pb * 4 * DH * DH + warp * DH * DH;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 16 * mi + g, c = 8 * j + tq;
      *reinterpret_cast<float2*>(pc + i * DH + c) = make_float2(cx[mi][j][0], cx[mi][j][1]);
      *reinterpret_cast<float2*>(pc + (i + 8) * DH + c) = make_float2(cx[mi][j][2], cx[mi][j][3]);
    }
}

// Shared memory of apply_mma_kernel: the four W_h blocks; with the projection
// the ring and the row tile, xn [64][C + 8] bf16 then y [64][C + 8] f32 in
// the same bytes; else the q tile [64][WLD] bf16.
inline size_t apply_smem(int C, int form) {
  return HEADS_BYTES + (form == QKV ? (size_t)ROWS * WLD * 2
                                    : RING_BYTES + (size_t)ROWS * (C + 8) * 4);
}

// The bf16 apply launch: each CTA walks `tiles` 64-row tiles, 4 warps × 16
// rows, W_h resident as bf16. Per tile: q = xn·W_q on mma.sync, the
// per-pixel per-head softmax in the accumulator (max and sum across the
// quad), q_soft rounded and re-packed as A fragments for a_h = q_soft_h·W_h,
// a rounded and re-packed for y = a·W_out + b_out in 128-column chunks
// staged in shared memory as f32, then the LN over each row's quad, ·g_out
// (+ x), written as bf16 pairs.
template <int FORM, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS, 2)
apply_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g_pre,
                 const bf16* __restrict__ w_qkv, const float* __restrict__ w_attn,
                 const bf16* __restrict__ w_out, const bf16* __restrict__ b_out,
                 const bf16* __restrict__ g_out, bf16* __restrict__ out, int n, int C,
                 int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool PROJ = FORM != QKV;
  bf16* wa = reinterpret_cast<bf16*>(smem);                  // [4][32][WLDT]
  bf16* ring = wa + 4 * DH * WLDT;                           // projection only
  bf16* xs = PROJ ? ring + 2 * STAGE : ring;                 // xn, or the q tile
  float* ys = reinterpret_cast<float*>(xs);                  // y, projection only
  const int LDX = C + 8, LDY = C + 8;

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = 2 * (lane & 3), ra = warp * 16 + g;
  const bf16* xb = x + (size_t)b * n * C;
  load_heads(wa, w_attn + (size_t)b * 4 * DH * DH);
  const int tile0 = blockIdx.x * tiles;
  for (int t0 = tile0 * ROWS; t0 < min(n, (tile0 + tiles) * ROWS); t0 += ROWS) {
    const int valid = min(ROWS, n - t0);
    float acc[16][4];
    __syncthreads();  // the previous tile is done with xs, ys and the ring
    if constexpr (PROJ) {
      gemm_prime<false>(ring, w_qkv, 3 * HID, 0, HID, C);  // W_q's copies start first
      load_rows(xs, LDX, xb, C, t0, valid, 0, C);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
      if (FORM == RAW_X) ln_tile(xs, C, valid, g_pre, nullptr, nullptr);
      gemm_w<false, 0>(acc, SmemA{xs, LDX}, C, w_qkv, 3 * HID, 0, HID, ring, true);
      __syncthreads();
      gemm_prime<false>(ring, w_out, C, 0, min(HID, C), HID);  // W_out's first slices
    } else {
      load_rows(xs, WLD, xb, 3 * HID, t0, valid, 0, HID);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
      read_tile(acc, xs, WLD);
    }
    head_softmax(acc);
    uint32_t qa[8][4];
    pack_rows(qa, acc);  // q_soft, rounded
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float o[4][4];
      head_product<false>(o, qa[2 * h], qa[2 * h + 1], wa + h * DH * WLDT);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * h + j][e] = o[j][e];
    }
    if constexpr (!PROJ) {  // the attention is the output
      bf16* ob = out + ((size_t)b * n + t0) * HID;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (ra < valid)
          *reinterpret_cast<uint32_t*>(ob + ra * HID + 8 * j + tq) =
              mma::pack_bf16(acc[j][0], acc[j][1]);
        if (ra + 8 < valid)
          *reinterpret_cast<uint32_t*>(ob + (ra + 8) * HID + 8 * j + tq) =
              mma::pack_bf16(acc[j][2], acc[j][3]);
      }
    } else {
      pack_rows(qa, acc);  // a, rounded
      for (int c0 = 0; c0 < C; c0 += HID) {
        const int ncols = min(HID, C - c0);
        gemm_w<false, HID>(acc, RegA{qa}, HID, w_out, C, c0, ncols, ring, c0 == 0);
        store_f32(ys, LDY, c0, ncols, acc, b_out);
      }
      __syncwarp();  // each warp reads back its own rows
      float mean[2], rs[2];
      row_stats(ys, LDY, C, mean, rs);
      for (int c0 = 0; c0 < C; c0 += HID) {
        uint32_t xq[16][2];  // x's pairs, then the output's
        if constexpr (RESIDUAL) ld_chunk(xq, xb + (size_t)t0 * C, C, c0, valid);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 8 * j + tq;
          if (c < C) {
            const float2 gg = ld_pair(g_out + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 v = *reinterpret_cast<const float2*>(ys + (ra + 8 * h) * LDY + c);
              float o0 = (v.x - mean[h]) * rs[h] * gg.x, o1 = (v.y - mean[h]) * rs[h] * gg.y;
              if constexpr (RESIDUAL) {
                const float2 xv = unpack(xq[j][h]);
                o0 += xv.x;
                o1 += xv.y;
              }
              xq[j][h] = mma::pack_bf16(o0, o1);
            }
          }
        }
        bf16* ob = out + ((size_t)b * n + t0) * C;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (c0 + 8 * j < C && ra + 8 * h < valid)
              *reinterpret_cast<uint32_t*>(ob + (ra + 8 * h) * C + c0 + 8 * j + tq) = xq[j][h];
      }
    }
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
constexpr long APPLY_CTAS = 4 * 2 * 132;

template <typename T, int FORM>
int launch_stats(const void* x, const void* g, const void* w, void* pm, void* ps,
                 void* pc, int B, int n, int C, int rows, cudaStream_t st) {
  dim3 grid((n + rows - 1) / rows, B);
  if constexpr (IS_BF16<T>) {
    if (!linattn::aligned16({x, g, w})) return (int)cudaErrorMisalignedAddress;
    const size_t smem = tc::stats_smem(C, FORM);
    auto kernel = tc::stats_mma_kernel<FORM>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, linattn::THREADS, smem, st>>>((const T*)x, (const T*)g, (const T*)w,
                                                 (float*)pm, (float*)ps, (float*)pc, n, C,
                                                 rows);
    return (int)cudaGetLastError();
  } else {
    const size_t smem = stats_smem(C, FORM);
    cudaError_t err = cudaFuncSetAttribute(
        stats_kernel<T, FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  combine_kernel<T><<<dim3(HID, B), 32, 0, st>>>((const float*)pm, (const float*)ps,
                                                 (const float*)pc, (float*)w_attn,
                                                 (float*)ctx_out, (float*)s_out,
                                                 (float*)m_out, nparts, n);
  return (int)cudaGetLastError();
}

template <typename T, int FORM, bool RESIDUAL>
int launch_apply(const void* x, const void* g_pre, const void* w_qkv, const void* w_attn,
                 const void* w_out, const void* b_out, const void* g_out, void* out, int B,
                 int n, int C, cudaStream_t st) {
  dim3 grid((n + TILE - 1) / TILE, B);
  if constexpr (IS_BF16<T>) {
    if (!linattn::aligned16({x, g_pre, w_qkv, w_out, b_out, g_out}))
      return (int)cudaErrorMisalignedAddress;
    const size_t smem = tc::apply_smem(C, FORM);
    auto kernel = tc::apply_mma_kernel<FORM, RESIDUAL>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // each CTA walks `tiles` tiles, so that B·CTAs is about four waves of
    // two CTAs on the 132 SMs
    const int n_tiles = (n + TILE - 1) / TILE;
    const int tiles = max(1, (int)(((long)n_tiles * B + APPLY_CTAS - 1) / APPLY_CTAS));
    grid.x = (n_tiles + tiles - 1) / tiles;
    kernel<<<grid, linattn::THREADS, smem, st>>>(
        (const T*)x, (const T*)g_pre, (const T*)w_qkv, (const float*)w_attn, (const T*)w_out,
        (const T*)b_out, (const T*)g_out, (T*)out, n, C, tiles);
    return (int)cudaGetLastError();
  } else {
    const size_t smem = apply_smem(C, FORM);
    auto kernel = apply_kernel<T, FORM, RESIDUAL>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
                   void* w_attn, void* out, int B, int n, int C, int rows, cudaStream_t st) {
  int err = launch_stats<T, FORM>(x, g_pre, w_qkv, pm, ps, pc, B, n, C, rows, st);
  if (err) return err;
  err = launch_combine<T>(pm, ps, pc, w_attn, nullptr, nullptr, nullptr, B,
                          (n + rows - 1) / rows, n, st);
  if (err) return err;
  return launch_apply<T, FORM, RESIDUAL>(x, g_pre, w_qkv, w_attn, w_out, b_out, g_out, out, B,
                                         n, C, st);
}

}  // namespace wrap
}  // namespace daclip

using namespace daclip::wrap;

extern "C" int daclip_wrap_stats(const void* x, const void* g_pre, const void* w_qkv,
                                 void* part_m, void* part_s, void* part_ctx, int B, int n,
                                 int C, int rows, int is_bf16, void* stream) {
  if (C % 32 || C > 512 || rows % TILE || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_stats<__nv_bfloat16, RAW_X>(x, g_pre, w_qkv, part_m, part_s,
                                                      part_ctx, B, n, C, rows, st)
                 : launch_stats<float, RAW_X>(x, g_pre, w_qkv, part_m, part_s, part_ctx, B, n,
                                              C, rows, st);
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

extern "C" int daclip_wrap_apply(const void* x, const void* g_pre, const void* w_qkv,
                                 const void* w_attn, const void* w_out, const void* b_out,
                                 const void* g_out, void* out, int B, int n, int C,
                                 int is_bf16, void* stream) {
  if (C % 32 || C > 512 || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_apply<__nv_bfloat16, RAW_X, true>(x, g_pre, w_qkv, w_attn, w_out,
                                                            b_out, g_out, out, B, n, C, st)
                 : launch_apply<float, RAW_X, true>(x, g_pre, w_qkv, w_attn, w_out, b_out,
                                                    g_out, out, B, n, C, st);
}

// #5, linear_attention_fused_v4: xn (B, n, C) → ChannelLN(attn(xn)·W_out + b)·g
extern "C" int daclip_linattn_fused_v4(const void* xn, const void* w_qkv, const void* w_out,
                                       const void* b_out, const void* g_out, void* part_m,
                                       void* part_s, void* part_ctx, void* w_attn, void* out,
                                       int B, int n, int C, int rows, int is_bf16,
                                       void* stream) {
  if (C % 32 || C > 512 || rows % TILE || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_forward<__nv_bfloat16, XN, false>(
                       xn, nullptr, w_qkv, w_out, b_out, g_out, part_m, part_s, part_ctx,
                       w_attn, out, B, n, C, rows, st)
                 : launch_forward<float, XN, false>(xn, nullptr, w_qkv, w_out, b_out, g_out,
                                                    part_m, part_s, part_ctx, w_attn, out, B,
                                                    n, C, rows, st);
}

// #7, linear_attention_pallas: qkv (B, n, 384) → the attention (B, n, 128)
extern "C" int daclip_linattn_core(const void* qkv, void* part_m, void* part_s, void* part_ctx,
                                   void* w_attn, void* out, int B, int n, int rows,
                                   int is_bf16, void* stream) {
  if (rows % TILE || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_forward<__nv_bfloat16, QKV, false>(
                       qkv, nullptr, nullptr, nullptr, nullptr, nullptr, part_m, part_s,
                       part_ctx, w_attn, out, B, n, 3 * HID, rows, st)
                 : launch_forward<float, QKV, false>(qkv, nullptr, nullptr, nullptr, nullptr,
                                                     nullptr, part_m, part_s, part_ctx, w_attn,
                                                     out, B, n, 3 * HID, rows, st);
}
