// Backward of Residual(PreNorm(LinearAttention)) for the ConditionalUNet, Hopper.
//
// Replaces the Pallas TPU kernel `attn_wrap_v5_bwd_pallas` (daclip_tpu/ops/
// linear_attention.py:885; bodies `_kernel_bwd1_v5` :763, `_bwd2_tail` :803,
// `_kernel_bwd2_v5_dy` :865), the VJP of the forward in linear_attention.cu:
//   out = x + LN(a·W_out + b_out)·g_out,  a = softmax_head(q)·W_h,
//   W_h = ctx_h·32^-½/(s·n),  ctx_h = exp(k_h − m)ᵀ·v_h,  qkv = LN(x)·g_pre·W_qkv.
// The math is `_wrap_v5_bwd_manual` (:616-687); operands of every product
// are rounded to T where the TPU kernel rounds them (dy, dattn, dctx, e, v,
// dqkv), statistics and sums stay f32. The forward's combine launch hands
// over the diagonal ctx blocks, s and the max m its e was taken against.
//
// Launches, per call (x is (B, n, C), T = bf16 or f32):
//   pass1 grid (parts, B), each CTA walks `rows` rows in tiles: rebuilds xn,
//         q_soft, a = q_soft·W, y and its LN; dy = LN-VJP(dO·g_out);
//         dattn = dy·W_outᵀ; keeps dW = q_softᵀ·dattn (the 4 diagonal 32×32
//         head blocks only: dctx is masked to them, the TPU's 128×128 was
//         three quarters thrown away), Σ dO·norm_y and Σ dy, and writes
//         them as per-CTA partials; spills dy and a in T.
//   mid   grid (128, B): sums the dW partials, dctx = dW·32^-½/(s·n) (rounded),
//         ds = −Σ(dctx∘ctx)/s; a CTA's up to 8 warps split the parts and add
//         their sums in warp order.
//   pass2 grid (parts, B): rebuilds xn, q_soft (f32), k, v, e = exp(k − m);
//         dq from the head-softmax VJP of dattn·Wᵀ; dk = e∘(v·dctxᵀ + ds);
//         dv = e·dctx; dxn = dqkv·W_qkvᵀ; dx = dO + LN-VJP(dxn·g_pre);
//         keeps Σ dxn·norm_x; spills xn and dqkv in T.
//   wgrad twice: dW_qkv = Σ xnᵀ·dqkv and dW_out = Σ aᵀ·dy over all B·n rows,
//         one f32 partial per split of the rows.
// The per-CTA and per-split partials are summed by the caller. The
// schedules are static (ops/linear_attention.py `_rows_per_part`,
// `_wgrad_split`) and no launch uses atomics, so the results repeat bit for
// bit.
//
// Why the weight gradients leave the passes: the TPU kept dW_qkv (C×384 f32)
// resident in VMEM across its in-order grid. On Hopper a CTA keeps its
// partial in wgmma accumulators: dW_qkv is 3·C f32 registers a thread of a
// 128-thread warpgroup (192 at C = 64) and dW_out C, beside a pass that
// already takes 248-255 of the 255 (ptxas -v below); a second warpgroup for
// them would cap every thread at 170 (ptxas 12.9 gives a thread 16,384 /
// (32·w) registers, w the warps a quarter of the SM). So pass 2 spills xn
// and dqkv and pass 1 a and dy, (2C + 512)·2 B of extra traffic a row in
// bf16, and a TMA-fed wgmma product reduces each pair.
//
// What bounds it on an H100: the L0 sites of a 256² training step (B=16,
// n=65536, C=64, bf16) must read x and dO and write dx (3·B·n·C·2 B ≈ 403 MB,
// ≈0.12 ms at 3.35 TB/s) and do 2·B·n·(1536·C + 20480) ≈ 249 GFLOP of
// products (qkv, a, y rebuilt; dattn, dW, dW_out, dq_soft, de, dv, dxn,
// dW_qkv; ≈0.25 ms on the bf16 tensor cores), so the operations bound it;
// the spills add ≈2.8 GB (≈0.84 ms), and the passes, like the forward's
// launches, are latency-bound by their tiles' chains of dependent steps.
//
// bf16 runs on Hopper's machinery with the tiles of linattn_tiles.cuh
// (`tc::pass1_tma_kernel`, `tc::pass2_tma_kernel`, `tc::wgrad_tma_kernel`):
// a pass's CTA is one warpgroup of 128 threads; thread 0 brings each tile's
// x and dO (pass 1) or x and the spilled dy (pass 2) by TMA into a ring of
// one or two stages on mbarriers, and the weights' boxes once a CTA where
// they fit (C ≤ 256 in pass 1, C ≤ 64 in pass 2; else each product loads
// its group). Every product is wgmma: the projections with the tile's box
// K-major and the weight boxes MN-major (xn·W) or K-major (dy·W_outᵀ,
// dqkv·W_qkvᵀ: the same boxes); the per-head products (a_h, dq_soft, de, dv)
// m64n32k16 with A in registers and W_h or dctx resident as bf16 blocks;
// y's chunks and dattn's and dxn's contributions with A re-packed from the
// accumulators; dW_h += q_softᵀ·dattn for the head pairs with both tiles
// MN-major, its diagonal blocks added to the CTA's partial in device memory
// each tile (no registers held across tiles); the weight gradients with
// both operands MN-major, a 64 × 384 (dW_qkv) or 64 × 128 output tile a
// CTA, a 3- or 4-stage ring a step ahead. The LayerNorms and their VJPs run
// over each row's quad of lanes (pass 1's y statistics and its VJP's means
// in one sweep, sums shifted by the row's first y), with the gains and
// biases in shared memory. At C ≤ 64 (`KEEP`) pass 1 keeps y's one chunk
// and pass 2 dxn in registers, dxn accumulating as dq and each head's dk,
// dv come; above, pass 1 forms y again in each sweep and pass 2 writes dq,
// dk, dv to a box tile and forms dxn from it. Every operand is a bf16 value
// where the scalar kernel rounds it, so only the order of the f32 sums
// differs.
// Resources (ptxas -v, sm_90a, CUDA 12.9; no spill, no stack): pass 1 254
// registers (C ≤ 64) and 255, pass 2 248 and 254, two CTAs an SM; the
// weight gradients 218 (64 × 384 tiles) and 90 (64 × 128); mid 27. Dynamic
// shared memory at C = 64 (daclip_wrap_bwd_smem): pass 1 112,664 bytes, pass
// 2 102,424, the weight gradients 173,080 and 99,360.
// f32 keeps the scalar kernels (`pass1_kernel`, `pass2_kernel`,
// `wgrad_kernel`), in full f32 like the plain version.

#include "common.cuh"
#include "linattn_tiles.cuh"
#include "tma.cuh"

namespace daclip {
namespace wrap_bwd {

constexpr int HID = 128;   // heads · dim_head
constexpr int DH = 32;     // dim_head
constexpr int QKV = 384;   // q | k | v columns
constexpr int NT = 256;    // threads per CTA (8 warps)
constexpr int WLD = 129;   // padded row of the staged weights
constexpr int HP = 33;     // padded row of a head's 32×32 block
constexpr float LN_EPS = 1e-5f;
constexpr float SCALE = 0.17677669529663687f;  // 32^-½

// Rows [t0, t0+valid) of x (row stride C) into xs as ChannelLN(x)·g rounded
// to T; each row's mean and 1/std into mean_s/rstd_s. Rows past `valid` are
// zero. With xn_out, the rounded rows are also written there.
template <typename T, int TILE>
__device__ void load_ln_rows(const T* __restrict__ xb, int t0, int valid, int C,
                             const T* __restrict__ g, float* xs, float* mean_s, float* rstd_s,
                             T* __restrict__ xn_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE; r += NT / 32) {
    float* row = xs + r * C;
    if (r < valid) {
      const T* src = xb + (size_t)(t0 + r) * C;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = to_f(src[c]);
        row[c] = v;
        sum += v;
      }
      const float mean = warp_sum(sum) / C;
      float sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = row[c] - mean;
        sq += d * d;
      }
      const float rs = 1.f / sqrtf(warp_sum(sq) / C + LN_EPS);
      for (int c = lane; c < C; c += 32) {
        const float v = round_t<T>((row[c] - mean) * rs * to_f(g[c]));
        row[c] = v;
        if (xn_out != nullptr) xn_out[(size_t)(t0 + r) * C + c] = from_f<T>(v);
      }
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rs;
      }
    } else {
      for (int c = lane; c < C; c += 32) row[c] = 0.f;
    }
  }
  __syncthreads();
}

// Rows [t0, t0+valid) of a (·, C) array in T into dst as f32; zero past valid.
template <typename T, int TILE>
__device__ void load_rows(const T* __restrict__ src, int t0, int valid, int C, float* dst) {
  for (int e = threadIdx.x; e < TILE * C; e += NT) {
    const int r = e / C;
    dst[e] = r < valid ? to_f(src[(size_t)t0 * C + e]) : 0.f;
  }
  __syncthreads();
}

// acc[i][j] = Σ_k A[(warp·RW + i)·lda + k] · W(k, c0 + lane + 32j) for the
// tile's 8·RW rows, j < NC with 32j < ncols, where W(k, c) = W[k·sk + c·sc]
// (sk = 1 reads a weight transposed; a lane's columns at or past ncols hold
// garbage, its caller writes none of them). K is a multiple of 16; W is
// staged up to 32 rows of k at a time through ws, as f32, in the order that
// reads the global weights contiguously. Thread (warp, lane) owns rows
// warp·RW + i.
template <typename T, int RW, int NC>
__device__ void gemm_rows(const float* A, int lda, int K, const T* __restrict__ W, int sk,
                          int sc, int c0, int ncols, float* ws, float (&acc)[RW][NC]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kn = min(32, K - k0);
    for (int e = threadIdx.x; e < 32 * ncols; e += NT) {
      int kk, c;
      if (sc == 1) {
        kk = e / ncols;
        c = e - kk * ncols;
      } else {
        c = e >> 5;
        kk = e & 31;
      }
      if (kk < kn) ws[kk * WLD + c] = to_f(W[(size_t)(k0 + kk) * sk + (size_t)(c0 + c) * sc]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float a[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) a[i] = A[(warp * RW + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (j * 32 < ncols) {
          const float w = ws[kk * WLD + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RW; ++i) acc[i][j] += a[i] * w;
        }
      }
    }
    __syncthreads();
  }
}

// Sum per-lane channel accumulators (channel c = lane + 32k) of the 8 warps
// through red (8·C floats) and write them to out[0..C).
__device__ void reduce_warps(const float (&v)[16], int C, float* red, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (lane + 32 * k < C) red[warp * C + lane + 32 * k] = v[k];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w * C + c];
    out[c] = s;
  }
  __syncthreads();
}

// (NT, 1): with the block size alone ptxas held the RW = 4 instance to 128
// registers and spilled
template <typename T, int RW>
__global__ void __launch_bounds__(NT, 1)
pass1_kernel(const T* __restrict__ x, const T* __restrict__ dout, const T* __restrict__ g_pre,
             const T* __restrict__ w_qkv, const float* __restrict__ w_attn,
             const T* __restrict__ w_out, const T* __restrict__ b_out,
             const T* __restrict__ g_out, T* __restrict__ dy_spill,
             T* __restrict__ attn_spill, float* __restrict__ part_dw,
             float* __restrict__ part_dgout, float* __restrict__ part_dbout, int n, int C,
             int rows) {
  constexpr int TILE = 8 * RW;
  extern __shared__ float smem[];
  float* r1 = smem;                   // [TILE][C]    xn, then y, then dy
  float* qs = r1 + TILE * C;          // [TILE][128]  q, then q_soft (rounded)
  float* as = qs + TILE * HID;        // [TILE][128]  a, then dattn
  float* ws = as + TILE * HID;        // [32][WLD]    staged weights
  float* wa = ws + 32 * WLD;          // [4][32][32]  W of this batch element
  float* mean_s = wa + 4 * DH * DH;   // [TILE]
  float* rstd_s = mean_s + TILE;      // [TILE]

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = part * rows, r1e = min(n, r0 + rows);
  const size_t bn = (size_t)b * n;
  const T* xb = x + bn * C;
  for (int e = tid; e < 4 * DH * DH; e += NT) wa[e] = w_attn[(size_t)b * 4 * DH * DH + e];
  // this thread's 16 entries of the diagonal dW blocks: head hh, row ci,
  // columns cj0 .. cj0+15
  const int hh = tid >> 6, ci = (tid & 63) >> 1, cj0 = (tid & 1) * 16;
  float dw[16], dgo[16], dbo[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) dw[k] = dgo[k] = dbo[k] = 0.f;

  for (int t0 = r0; t0 < r1e; t0 += TILE) {
    const int valid = min(TILE, r1e - t0);
    load_ln_rows<T, TILE>(xb, t0, valid, C, g_pre, r1, mean_s, rstd_s, nullptr);
    {
      float acc[RW][4];
      gemm_rows<T, RW, 4>(r1, C, C, w_qkv, QKV, 1, 0, HID, ws, acc);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) qs[(warp * RW + i) * HID + lane + 32 * j] = acc[i][j];
    }
    __syncthreads();
    for (int p = warp; p < TILE * 4; p += NT / 32) {  // per-pixel, per-head softmax
      float* q = qs + (p >> 2) * HID + (p & 3) * DH;
      const float v = q[lane];
      const float e = expf(v - warp_max(v));
      q[lane] = round_t<T>(e / warp_sum(e));
    }
    __syncthreads();
    {
      // a[r][h·32 + lane] = Σ_i q_soft[r][h·32 + i] · W_h[i][lane]
      float at[RW][4];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int h = 0; h < 4; ++h) at[i][h] = 0.f;
#pragma unroll 4
      for (int ii = 0; ii < DH; ++ii) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float w = wa[h * DH * DH + ii * DH + lane];
#pragma unroll
          for (int i = 0; i < RW; ++i) at[i][h] += qs[(warp * RW + i) * HID + h * DH + ii] * w;
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = warp * RW + i;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float a = round_t<T>(at[i][h]);
          as[r * HID + h * DH + lane] = a;
          if (r < valid) attn_spill[(bn + t0 + r) * HID + h * DH + lane] = from_f<T>(a);
        }
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += HID) {  // y = a·W_out + b_out into r1
      const int ncols = min(HID, C - c0);
      float acc[RW][4];
      gemm_rows<T, RW, 4>(as, HID, HID, w_out, C, 1, c0, ncols, ws, acc);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (lane + 32 * j < ncols) {
            const int col = c0 + lane + 32 * j;
            r1[(warp * RW + i) * C + col] = acc[i][j] + to_f(b_out[col]);
          }
    }
    __syncthreads();
    for (int r = warp; r < TILE; r += NT / 32) {  // post-norm LN and its VJP
      float* row = r1 + r * C;
      if (r >= valid) {
        for (int c = lane; c < C; c += 32) row[c] = 0.f;
        continue;
      }
      const T* gr = dout + (bn + t0 + r) * C;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) sum += row[c];
      const float mean = warp_sum(sum) / C;
      float sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = row[c] - mean;
        sq += d * d;
      }
      const float rs = 1.f / sqrtf(warp_sum(sq) / C + LN_EPS);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int c = lane + 32 * k;
        if (c < C) {
          const float ny = (row[c] - mean) * rs;
          const float gf = to_f(gr[c]);
          const float dn = gf * to_f(g_out[c]);
          dgo[k] += gf * ny;
          s1 += dn;
          s2 += dn * ny;
          row[c] = ny;
        }
      }
      const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int c = lane + 32 * k;
        if (c < C) {
          const float dn = to_f(gr[c]) * to_f(g_out[c]);
          const float dy = rs * (dn - m1 - row[c] * m2);
          dbo[k] += dy;
          const float dyb = round_t<T>(dy);
          row[c] = dyb;
          dy_spill[(bn + t0 + r) * C + c] = from_f<T>(dyb);
        }
      }
    }
    __syncthreads();
    {  // dattn = dy·W_outᵀ into as
      float acc[RW][4];
      gemm_rows<T, RW, 4>(r1, C, C, w_out, 1, C, 0, HID, ws, acc);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          as[(warp * RW + i) * HID + lane + 32 * j] = round_t<T>(acc[i][j]);
    }
    __syncthreads();
    for (int r = 0; r < valid; ++r) {  // dW += q_softᵀ·dattn, diagonal blocks
      const float qv = qs[r * HID + hh * DH + ci];
      const float* dr = as + r * HID + hh * DH + cj0;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) dw[jj] += qv * dr[jj];
    }
    __syncthreads();
  }

  const size_t pb = (size_t)b * nparts + part;
  float* pw = part_dw + pb * 4 * DH * DH + hh * DH * DH + ci * DH + cj0;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) pw[jj] = dw[jj];
  reduce_warps(dgo, C, r1, part_dgout + pb * C);
  reduce_warps(dbo, C, r1, part_dbout + pb * C);
}

// The mid launch, one CTA of W ≤ 8 warps per (ctx row c, batch b), W =
// ⌈parts / 8⌉: warp w sums parts w, w + W, … in order, lane j the row's
// column j; the warps' sums add in warp order, so the result repeats bit for
// bit.
constexpr int MID_WARPS = 8;
inline int mid_warps(int nparts) { return min(MID_WARPS, (nparts + 7) / 8); }
template <typename T>
__global__ void __launch_bounds__(32 * MID_WARPS)
mid_kernel(const float* __restrict__ part_dw, const float* __restrict__ ctx,
           const float* __restrict__ s, float* __restrict__ dctx, float* __restrict__ ds,
           int nparts, int n) {
  __shared__ float red[MID_WARPS][DH];
  const int c = blockIdx.x, b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5, hh = c / DH, i = c % DH;
  const size_t at = (size_t)hh * DH * DH + i * DH + lane;
  float acc = 0.f;
  for (int p = warp; p < nparts; p += W)
    acc += part_dw[((size_t)b * nparts + p) * 4 * DH * DH + at];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
  acc = red[0][lane];
  for (int w = 1; w < W; ++w) acc += red[w][lane];
  const float sc = s[(size_t)b * HID + c];
  const float d = acc * (SCALE / (sc * (float)n));
  const float dsum = warp_sum(d * ctx[(size_t)b * 4 * DH * DH + at]);
  dctx[(size_t)b * 4 * DH * DH + at] = round_t<T>(d);
  if (lane == 0) ds[(size_t)b * HID + c] = -dsum / sc;
}

template <typename T, int RW>
__global__ void __launch_bounds__(NT)
pass2_kernel(const T* __restrict__ x, const T* __restrict__ dout, const T* __restrict__ g_pre,
             const T* __restrict__ w_qkv, const float* __restrict__ w_attn,
             const T* __restrict__ w_out, const float* __restrict__ dctx,
             const float* __restrict__ ds, const float* __restrict__ m,
             const T* __restrict__ dy_spill, T* __restrict__ dx, T* __restrict__ xn_spill,
             T* __restrict__ dqkv_spill, float* __restrict__ part_dgpre, int n, int C,
             int rows) {
  constexpr int TILE = 8 * RW;
  extern __shared__ float smem[];
  float* r1 = smem;                   // [TILE][C]    dy, then xn, then dxn
  float* r2 = r1 + TILE * C;          // [TILE][384]  q|dattn|·, then q_soft|k|v, then dq|dk|dv
  float* ws = r2 + TILE * QKV;        // [32][WLD]    staged weights
  float* wp = ws + 32 * WLD;          // [4][32][HP]  W, padded
  float* cp = wp + 4 * DH * HP;       // [4][32][HP]  dctx (rounded), padded
  float* ms = cp + 4 * DH * HP;       // [128]        m
  float* dss = ms + HID;              // [128]        ds
  float* mean_s = dss + HID;          // [TILE]
  float* rstd_s = mean_s + TILE;      // [TILE]

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = part * rows, r1e = min(n, r0 + rows);
  const size_t bn = (size_t)b * n;
  const T* xb = x + bn * C;
  for (int e = tid; e < 4 * DH * DH; e += NT) {
    const int h = e / (DH * DH), rem = e - h * DH * DH, i = rem / DH, j = rem - i * DH;
    wp[h * DH * HP + i * HP + j] = w_attn[(size_t)b * 4 * DH * DH + e];
    cp[h * DH * HP + i * HP + j] = dctx[(size_t)b * 4 * DH * DH + e];
  }
  if (tid < HID) {
    ms[tid] = m[(size_t)b * HID + tid];
    dss[tid] = ds[(size_t)b * HID + tid];
  }
  float dgp[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) dgp[k] = 0.f;
  __syncthreads();

  for (int t0 = r0; t0 < r1e; t0 += TILE) {
    const int valid = min(TILE, r1e - t0);
    load_rows<T, TILE>(dy_spill + bn * C, t0, valid, C, r1);
    {  // dattn = dy·W_outᵀ into r2[:, 128:256]
      float acc[RW][4];
      gemm_rows<T, RW, 4>(r1, C, C, w_out, 1, C, 0, HID, ws, acc);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r2[(warp * RW + i) * QKV + HID + lane + 32 * j] = round_t<T>(acc[i][j]);
    }
    load_ln_rows<T, TILE>(xb, t0, valid, C, g_pre, r1, mean_s, rstd_s, xn_spill + bn * C);
    {  // q into r2[:, 0:128]
      float acc[RW][4];
      gemm_rows<T, RW, 4>(r1, C, C, w_qkv, QKV, 1, 0, HID, ws, acc);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r2[(warp * RW + i) * QKV + lane + 32 * j] = acc[i][j];
    }
    __syncthreads();
    for (int p = warp; p < TILE * 4; p += NT / 32) {
      // q_soft (f32), dq_soft = dattn·W_hᵀ, dq = q_soft∘(dq_soft − Σ dq_soft∘q_soft)
      const int r = p >> 2, h = p & 3;
      float* row = r2 + r * QKV + h * DH;
      const float v = row[lane];
      const float e = expf(v - warp_max(v));
      const float qsm = e / warp_sum(e);
      const float da = row[HID + lane];
      const float* wr = wp + h * DH * HP + lane * HP;
      float dqs = 0.f;
#pragma unroll
      for (int j = 0; j < DH; ++j) dqs += __shfl_sync(0xffffffffu, da, j) * wr[j];
      const float tsum = warp_sum(dqs * qsm);
      row[lane] = round_t<T>(qsm * (dqs - tsum));
    }
    __syncthreads();
    for (int c0 = HID; c0 < QKV; c0 += HID) {  // k, v into r2[:, 128:384]
      float acc[RW][4];
      gemm_rows<T, RW, 4>(r1, C, C, w_qkv, QKV, 1, c0, HID, ws, acc);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r2[(warp * RW + i) * QKV + c0 + lane + 32 * j] = acc[i][j];
    }
    __syncthreads();
    for (int p = warp; p < TILE * 4; p += NT / 32) {
      // e = exp(k − m); dk = e∘(v·dctxᵀ + ds); dv = e·dctx
      const int r = p >> 2, h = p & 3;
      float* row = r2 + r * QKV + h * DH;
      const int c = h * DH + lane;
      const float e = r < valid ? expf(row[HID + lane] - ms[c]) : 0.f;
      const float eb = round_t<T>(e), vb = round_t<T>(row[2 * HID + lane]);
      const float* ch = cp + h * DH * HP;
      float de = dss[c], dv = 0.f;
#pragma unroll
      for (int j = 0; j < DH; ++j) {
        de += __shfl_sync(0xffffffffu, vb, j) * ch[lane * HP + j];
        dv += __shfl_sync(0xffffffffu, eb, j) * ch[j * HP + lane];
      }
      row[HID + lane] = round_t<T>(e * de);
      row[2 * HID + lane] = round_t<T>(dv);
    }
    __syncthreads();
    for (int e = tid; e < valid * QKV; e += NT)
      dqkv_spill[(bn + t0) * QKV + e] = from_f<T>(r2[e]);
    for (int c0 = 0; c0 < C; c0 += HID) {  // dxn = dqkv·W_qkvᵀ into r1
      const int ncols = min(HID, C - c0);
      float acc[RW][4];
      gemm_rows<T, RW, 4>(r2, QKV, QKV, w_qkv, 1, QKV, c0, ncols, ws, acc);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (lane + 32 * j < ncols) r1[(warp * RW + i) * C + c0 + lane + 32 * j] = acc[i][j];
    }
    __syncthreads();
    for (int r = warp; r < valid; r += NT / 32) {  // pre-norm LN VJP + residual
      const float* row = r1 + r * C;
      const T* xr = xb + (size_t)(t0 + r) * C;
      const T* gr = dout + (bn + t0 + r) * C;
      const float mean = mean_s[r], rs = rstd_s[r];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int c = lane + 32 * k;
        if (c < C) {
          const float nx = (to_f(xr[c]) - mean) * rs;
          const float dn = row[c] * to_f(g_pre[c]);
          dgp[k] += row[c] * nx;
          s1 += dn;
          s2 += dn * nx;
        }
      }
      const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
      for (int c = lane; c < C; c += 32) {
        const float nx = (to_f(xr[c]) - mean) * rs;
        const float dn = row[c] * to_f(g_pre[c]);
        dx[(bn + t0 + r) * C + c] = from_f<T>(to_f(gr[c]) + rs * (dn - m1 - nx * m2));
      }
    }
    __syncthreads();
  }
  reduce_warps(dgp, C, r1, part_dgpre + ((size_t)b * nparts + part) * C);
}

// part[z][i][j] = Σ_{rows of split z} A[row][i] · Bm[row][j]; A (R, K1) and
// Bm (R, K2) row-major in T. 64×64 outputs per CTA, 4×4 per thread, 32 rows
// staged at a time.
template <typename T>
__global__ void __launch_bounds__(NT)
wgrad_kernel(const T* __restrict__ A, const T* __restrict__ Bm, float* __restrict__ part,
             long R, int K1, int K2, long rows_per_split) {
  __shared__ float as[32][64];
  __shared__ float bs[32][64];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
  const long ra = (long)blockIdx.z * rows_per_split;
  const long rb = min(R, ra + rows_per_split);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (long rr = ra; rr < rb; rr += 32) {
    for (int e = tid; e < 32 * 64; e += NT) {
      const int kr = e >> 6, c = e & 63;
      const long row = rr + kr;
      const bool in = row < rb;
      as[kr][c] = in && i0 + c < K1 ? to_f(A[(size_t)row * K1 + i0 + c]) : 0.f;
      bs[kr][c] = in && j0 + c < K2 ? to_f(Bm[(size_t)row * K2 + j0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kr = 0; kr < 32; ++kr) {
      float a[4], bv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        a[t] = as[kr][ty * 4 + t];
        bv[t] = bs[kr][tx * 4 + t];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[t][u] += a[t] * bv[u];
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = i0 + ty * 4 + t;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + tx * 4 + u;
      if (i < K1 && j < K2) part[((size_t)blockIdx.z * K1 + i) * K2 + j] = acc[t][u];
    }
  }
}

// -- bf16: wgmma fed by TMA ----------------------------------------------------------
namespace tc {

using namespace linattn;

// Per-channel sums kept in shared memory, one row of C floats a warp:
// zeroed, then summed over the 4 warps into out[0 .. C).
__device__ __forceinline__ void zero_sums(float* sums, int C) {
  for (int c = threadIdx.x; c < 4 * C; c += THREADS) sums[c] = 0.f;
}
__device__ __forceinline__ void write_sums(const float* sums, int C, float* __restrict__ out) {
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS)
    out[c] = (sums[c] + sums[C + c]) + (sums[2 * C + c] + sums[3 * C + c]);
}

__host__ __device__ inline int f32_bytes(int floats) { return (floats * 4 + 1023) / 1024 * 1024; }

// acc (64 × 64) = A · B over k-blocks [kb0, kb1): A's k-block kb a K-major
// box at a(kb), B's at b(kb), K-major. Issues and commits one group.
template <class A, class B>
__device__ __forceinline__ void gemm64(float (&acc)[8][4], int kb0, int kb1, A a, B b, bool first) {
  mma::wgmma_fence();
  for (int kb = kb0; kb < kb1; ++kb) {
    const uint32_t ab = a(kb), bb = b(kb);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      mma::wgmma_ss64<0>(acc, desc(ab + 32 * s), desc(bb + 32 * s), !(first && kb == kb0 && s == 0));
  }
  mma::wgmma_commit();
}

// Shared memory of pass1_tma_kernel: q_soft and dattn as box tiles of 128
// columns where the stage's x and dO are one box each (C ≤ 64; else q_soft
// takes the stage's first two x boxes once q is formed, and dattn its first
// two dO boxes once dattn is formed), W_h's blocks, the per-warp sums of
// dg_out and db_out [2][4][C] f32, g_pre, g_out and b_out; a stage holds the
// tile's x and dO boxes; the weights are W_q's and W_out's boxes.
inline Layout pass1_layout(int C) {
  const int CB = (C + 63) / 64;
  return plan((CB == 1 ? 4 * BOX : 0) + HEADS_BYTES + f32_bytes(8 * C) + 3 * VEC,
              2 * CB * BOX, 4 * CB, 2, 2 * CB);
}

// The bf16 pass 1: each CTA walks its `rows` rows in 64-row tiles, x and dO
// by TMA one tile ahead. Per tile: xn (LN in place), q = xn·W_q on wgmma,
// the head softmax in the accumulator, q_soft rounded (to A fragments and to
// a box tile), a_h = q_soft_h·W_h (wgmma, A in registers, W_h resident), a
// rounded (spilled, re-packed), y = a·W_out + b_out in 64-column chunks, the
// post-norm LN and its VJP over each row's quad: dy rounded, spilled and
// written over dO in the stage; dattn = dy·W_outᵀ (A the stage's dy boxes,
// B W_out's boxes K-major), rounded to a box tile; then dW_h +=
// q_softᵀ·dattn for the head pairs (A and B MN-major), whose diagonal
// blocks add up in the CTA's partial in device memory (no registers held
// across tiles: the sweeps that form y again need them). KEEP (C ≤ 64): the one y chunk
// stays in registers; else each of the four sweeps over a row's chunks
// (mean, variance, the VJP's means, dy) forms them again.
template <bool KEEP>
__global__ void __launch_bounds__(THREADS, 1)
pass1_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap to,
                 const bf16* __restrict__ g_pre, const float* __restrict__ w_attn,
                 const bf16* __restrict__ b_out, const bf16* __restrict__ g_out,
                 bf16* __restrict__ dy_spill, bf16* __restrict__ attn_spill,
                 float* __restrict__ part_dw, float* __restrict__ part_dgout,
                 float* __restrict__ part_dbout, int n, int C, LnWidth lw, int rows,
                 Layout L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned(smem_raw);
  const uint32_t base = mma::smem_u32(smem);
  const int own = C <= 64 ? 4 * BOX : 0;  // q_soft and dattn: 2 boxes each of their own
  const uint32_t heads = base + own;
  float* dgo_s = reinterpret_cast<float*>(smem + own + HEADS_BYTES);  // [4][C] Σ dO·ny
  float* dbo_s = dgo_s + 4 * C;                                           // [4][C] Σ dy
  bf16* gps = reinterpret_cast<bf16*>(smem + own + HEADS_BYTES + f32_bytes(8 * C));
  bf16* gos = gps + VEC / 2;  // g_pre, g_out, b_out
  bf16* bs = gos + VEC / 2;
  const Ring ring{base + L.ring, base + L.bars, L.stages, L.stage_bytes};
  Weights w{base + L.weights, base + L.bars + 8 * MAX_STAGES, 0, L.slots, -1, L.resident != 0,
            false};

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, ra = lane_row(), tq = lane_col();
  const int r0 = part * rows, r1 = min(n, r0 + rows);
  const int tiles = cdiv(r1 - r0, ROWS), CB = cdiv(C, 64);
  const size_t bn = (size_t)b * n;
  if (tid == 0) {
    tma::prefetch_map(&tx);
    tma::prefetch_map(&tdo);
    tma::prefetch_map(&tw);
    tma::prefetch_map(&to);
    for (int s = 0; s < L.stages; ++s) tma::mbar_init(ring.full(s), 1);
    tma::mbar_init(w.bar, 1);
    tma::mbar_init_fence();
  }
  load_heads(smem + own, w_attn + (size_t)b * 4 * DH * DH);
  mma::fence_proxy_async();
  zero_sums(dgo_s, C);
  zero_sums(dbo_s, C);
  load_vec(gps, g_pre, C);
  load_vec(gos, g_out, C);
  load_vec(bs, b_out, C);
  float* dgo_w = dgo_s + warp * C;
  float* dbo_w = dbo_s + warp * C;
  auto issue = [&](int it) {  // thread 0: tile it's x and dO into its stage
    if (it >= tiles) return;
    const uint32_t st = ring.stage(it), bar = ring.full(it);
    const int row = r0 + it * ROWS;
    tma::mbar_expect_tx(bar, 2 * CB * BOX);
    for (int cb = 0; cb < CB; ++cb) {
      tma::load_3d(st + cb * BOX, &tx, 64 * cb, row, b, bar);
      tma::load_3d(st + (CB + cb) * BOX, &tdo, 64 * cb, row, b, bar);
    }
  };
  if (tid == 0)
    for (int s = 0; s < L.stages; ++s) issue(s);
  // W_q's box (kb, i) resident in slot 2kb + i, W_out's (chunk j, rows 64rb)
  // in 2CB + 2j + rb
  if (w.resident)
    issue_group(w, 0, 4 * CB, [&](int i, const CUtensorMap*& map, int& col, int& row) {
      if (i < 2 * CB) {
        map = &tw;
        col = 64 * (i & 1);
        row = 64 * (i >> 1);
      } else {
        map = &to;
        col = 64 * ((i - 2 * CB) >> 1);
        row = 64 * (i & 1);
      }
    });
  __syncthreads();  // the barriers, W_h, the sums, the vectors
  const int kg = w.resident ? CB : min(CB, w.slots / 2);  // k-blocks, or chunks, a group
  // W_out's box (chunk j, rows 64rb), its group loaded
  auto out_box = [&](int j, int rb) {
    const int j0 = j / kg * kg;
    if (!w.resident)
      load_group(w, 64 + j0, 2 * min(kg, CB - j0),
                 [&](int i, const CUtensorMap*& map, int& col, int& row) {
                   map = &to;
                   col = 64 * (j0 + (i >> 1));
                   row = 64 * (i & 1);
                 });
    return w.slot(w.resident ? 2 * CB + 2 * j + rb : 2 * (j - j0) + rb);
  };

  // the diagonal dW blocks of head pairs (0, 1) and (2, 3) add up across
  // tiles in the CTA's own partial (each element by one thread)
  float* pdw = part_dw + ((size_t)b * nparts + part) * 4 * DH * DH;

  for (int it = 0; it < tiles; ++it) {
    const int t0 = r0 + it * ROWS, valid = min(ROWS, r1 - t0);
    const uint32_t st = ring.stage(it);
    unsigned char* xs = smem + (st - base);
    unsigned char* dos = xs + CB * BOX;
    unsigned char* qs = own ? smem : xs;            // q_soft: 2 boxes
    unsigned char* das = own ? smem + 2 * BOX : dos;  // dattn: 2 boxes
    ring.wait(it);
    wait_weights(w);
    ln_tile(xs, C, lw, valid, gps, nullptr, nullptr);
    mma::fence_proxy_async();
    __syncthreads();  // xn is whole; the last tile's pair products are done with qs, das
    float acc[16][4];
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
    head_softmax(acc);
    uint32_t fa[8][4];
    pack_rows<16>(fa, acc);    // q_soft, rounded
    if (!own) __syncthreads();  // every warp is done with xn: q_soft takes its boxes
    store_tile<16>(qs, 0, acc);
    head_products<1>(acc, fa, heads);  // a_h = q_soft_h·W_h
    pack_rows<16>(fa, acc);    // a, rounded
    store_frags<8>(attn_spill + (bn + t0) * HID, HID, 0, HID, valid, fa);
    // y chunk j = a·W_out[:, 64j ..] + b_out
    auto y_chunk = [&](int j, float (&y)[8][4]) {
      const uint32_t b0 = out_box(j, 0), b1 = out_box(j, 1);
      gemm64_rs<1, 8>(y, fa, [&](int kb) { return kb ? b1 : b0; }, true);
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
    // the post-norm LN and its VJP over each row's quad, in two sweeps over
    // the row's chunks. The first sums y − sh, (y − sh)², dn = dO·g_out and
    // dn·(y − sh) (sh: the row's y at column 0, so that the sums stay small):
    // mean and 1/std of y, m1 = mean(dn) and m2 = mean(dn·ny), over the LN's
    // cn columns (`LnWidth`: past cn y, dO and g_out are 0). The second
    // forms ny, dg_out +=
    // dO·ny and db_out += dy per column (rows past valid: dO, so dy, is 0;
    // columns past cn: dy is not, but meets only W_out's zero columns and
    // the gradients' columns that the caller cuts off).
    float sh[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    sweep([&](int j, const float (&t)[8][4]) {
      if (j == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sh[h] = __fmul_rn(__shfl_sync(0xffffffffu, t[0][2 * h], (tid & 31) & ~3), lw.shift);
      uint32_t gq[8][2];
      ld_chunk_sw<8>(gq, dos, C, 64 * j);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * j + 8 * jj + tq;
        if (c < C) {
          const float2 gg = ld_pair(gos + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 gf = unpack(gq[jj][h]);
            const float d0 = t[jj][2 * h] - sh[h], d1 = t[jj][2 * h + 1] - sh[h];
            const float dn0 = gf.x * gg.x, dn1 = gf.y * gg.y;
            s1[h] += d0 + d1;
            s2[h] += d0 * d0 + d1 * d1;
            m1[h] += dn0 + dn1;
            m2[h] += dn0 * d0 + dn1 * d1;
          }
        }
      }
    });
    float mean[2], rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e1 = __fmul_rn(quad_sum(s1[h]) / C, lw.ratio);  // mean(y − sh)
      mean[h] = sh[h] + e1;
      rs[h] =
          1.f / sqrtf(fmaxf(__fmul_rn(quad_sum(s2[h]) / C, lw.ratio) - e1 * e1, 0.f) + LN_EPS);
      m1[h] = __fmul_rn(quad_sum(m1[h]) / C, lw.ratio);
      m2[h] = (__fmul_rn(quad_sum(m2[h]) / C, lw.ratio) - e1 * m1[h]) * rs[h];
    }
    // dy = rs·(dn − m1 − ny·m2), rounded: spilled, and written over dO in
    // the stage (each pair by the lane that read it)
    sweep([&](int j, const float (&t)[8][4]) {
      uint32_t gq[8][2];  // dO's pairs, then dy's
      ld_chunk_sw<8>(gq, dos, C, 64 * j);
#pragma unroll
      for (int jb = 0; jb < 8; jb += 2) {  // two n8 tiles at a time: fewer registers
        float p[2][2], q[2][2];  // the lane's Σ over its two rows of dO·ny and of dy, per column
#pragma unroll
        for (int jj = jb; jj < jb + 2; ++jj) {
          const int c = 64 * j + 8 * jj + tq;
          p[jj - jb][0] = p[jj - jb][1] = q[jj - jb][0] = q[jj - jb][1] = 0.f;
          if (c < C) {
            const float2 gg = ld_pair(gos + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 gf = unpack(gq[jj][h]);
              const float ny0 = (t[jj][2 * h] - mean[h]) * rs[h];
              const float ny1 = (t[jj][2 * h + 1] - mean[h]) * rs[h];
              const float dy0 = rs[h] * (gf.x * gg.x - m1[h] - ny0 * m2[h]);
              const float dy1 = rs[h] * (gf.y * gg.y - m1[h] - ny1 * m2[h]);
              p[jj - jb][0] += gf.x * ny0;
              p[jj - jb][1] += gf.y * ny1;
              q[jj - jb][0] += dy0;
              q[jj - jb][1] += dy1;
              gq[jj][h] = mma::pack_bf16(dy0, dy1);
            }
          }
        }
        add_col_sums<2>(dgo_w, p, C, 64 * j + 8 * jb);
        add_col_sums<2>(dbo_w, q, C, 64 * j + 8 * jb);
      }
      bf16* sp = dy_spill + (bn + t0) * C;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * j + 8 * jj + tq;
        if (c < C) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = ra + 8 * h;
            *reinterpret_cast<uint32_t*>(pair_at(dos, r, c)) = gq[jj][h];
            if (r < valid) *reinterpret_cast<uint32_t*>(sp + (size_t)r * C + c) = gq[jj][h];
          }
        }
      }
    });
    mma::fence_proxy_async();
    __syncthreads();  // dy is whole
    // dattn = dy·W_outᵀ: B K-major, W_out's box (chunk kb, rows 64i)
    float dat[16][4];
    for (int kb0 = 0; kb0 < CB; kb0 += kg) {
      const int kb1 = min(CB, kb0 + kg);
      out_box(kb0, 0);  // its group of chunks is loaded
      gemm128<0>(
          dat, kb0, kb1, [&](int kb) { return st + (CB + kb) * BOX; },
          [&](int kb, int i) { return w.slot(w.resident ? 2 * CB + 2 * kb + i : 2 * (kb - kb0) + i); },
          kb0 == 0);
      wait_all(dat);
    }
    if (!own) __syncthreads();  // every warp is done with dy: dattn takes its boxes
    store_tile<16>(das, 0, dat);  // dattn, rounded
    mma::fence_proxy_async();
    __syncthreads();
    // dW_h += q_softᵀ·dattn over the tile's rows (rows past valid: dy, so
    // dattn, is 0)
    {
      float t[2][8][4];
      add_pair_diagonals_to(pdw, it == 0, t, mma::smem_u32(qs), mma::smem_u32(das));
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0) issue(it + L.stages);
  }

  const size_t pb = (size_t)b * nparts + part;
  write_sums(dgo_s, C, part_dgout + pb * C);
  write_sums(dbo_s, C, part_dbout + pb * C);
}

// Shared memory of pass2_tma_kernel: the W_h and dctx blocks; the rows' mean
// and 1/std and the per-warp sums of dg_pre [4][C] f32; without KEEP the
// dq | dk | dv tile (6 boxes; where that does not fit, at C ≥ 384, it takes
// the stage's dy boxes, free once dattn is formed, and the stage is refilled
// only after the tile), g_pre; a stage holds the tile's x and dy boxes; the
// weights are W_out's boxes (dattn) and all of W_qkv's.
inline Layout pass2_layout(int C) {
  const int CB = (C + 63) / 64, f32 = f32_bytes(2 * ROWS + 4 * C) + VEC;
  const bool keep = CB == 1;
  Layout L = plan(2 * HEADS_BYTES + (keep ? 0 : 6 * BOX) + f32, 2 * CB * BOX, 8 * CB, 6, 6 * CB);
  if (L.bytes == 0 && !keep && CB >= 6) {  // the dqkv tile in the stage's dy boxes
    L = plan(2 * HEADS_BYTES + f32, 2 * CB * BOX, 8 * CB, 6, 6 * CB);
    L.alias = 1;
  }
  return L;
}

// The bf16 pass 2: each CTA walks its `rows` rows in 64-row tiles, x and dy
// by TMA one tile ahead (the stage is refilled once the products have read
// it). Per tile: dattn = dy·W_outᵀ (rounded, A fragments); xn (LN in place,
// spilled); q = xn·W_q and its softmax (f32) in the accumulator; per head
// dq_soft = dattn_h·W_hᵀ and dq = q_soft∘(dq_soft − Σ dq_soft∘q_soft); v (as
// rounded A fragments) and k; e = exp(k − m); per head de = v_h·dctx_hᵀ,
// dk = e∘(de + ds), dv = e_h (rounded)·dctx_h; dq, dk, dv rounded and
// spilled; dxn = dqkv·W_qkvᵀ: KEEP (C ≤ 64) accumulates it in registers as
// dq and each head's dk, dv come (A in registers), else from the dqkv box
// tile in 64-column chunks, formed again in each of the two sweeps over a
// row's chunks; then the pre-norm LN's VJP and the residual over each row's
// quad.
template <bool KEEP>
__global__ void __launch_bounds__(THREADS, 1)
pass2_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap to,
                 const bf16* __restrict__ x, const bf16* __restrict__ dout,
                 const bf16* __restrict__ g_pre, const float* __restrict__ w_attn,
                 const float* __restrict__ dctx, const float* __restrict__ ds,
                 const float* __restrict__ m, bf16* __restrict__ dx, bf16* __restrict__ xn_spill,
                 bf16* __restrict__ dqkv_spill, float* __restrict__ part_dgpre, int n, int C,
                 LnWidth lw, int rows, Layout L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned(smem_raw);
  const uint32_t base = mma::smem_u32(smem);
  const uint32_t wh = base, dch = base + HEADS_BYTES;  // W_h, dctx blocks
  const bool own_dqt = !KEEP && !L.alias;  // dq | dk | dv: 6 boxes of its own
  float* mean_s = reinterpret_cast<float*>(smem + 2 * HEADS_BYTES + (own_dqt ? 6 * BOX : 0));
  float* rstd_s = mean_s + ROWS;
  float* dgp_s = rstd_s + ROWS;  // [4][C] Σ dxn·nx
  bf16* gps = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(mean_s) +
                                      f32_bytes(2 * ROWS + 4 * C));  // g_pre
  const Ring ring{base + L.ring, base + L.bars, L.stages, L.stage_bytes};
  Weights w{base + L.weights, base + L.bars + 8 * MAX_STAGES, 0, L.slots, -1, L.resident != 0,
            false};

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, ra = lane_row(), tq = lane_col();
  const int r0 = part * rows, r1 = min(n, r0 + rows);
  const int tiles = cdiv(r1 - r0, ROWS), CB = cdiv(C, 64);
  const size_t bn = (size_t)b * n;
  const bf16* xb = x + bn * C;
  const float* mb = m + (size_t)b * HID;
  const float* dsb = ds + (size_t)b * HID;
  if (tid == 0) {
    tma::prefetch_map(&tx);
    tma::prefetch_map(&tdy);
    tma::prefetch_map(&tw);
    tma::prefetch_map(&to);
    for (int s = 0; s < L.stages; ++s) tma::mbar_init(ring.full(s), 1);
    tma::mbar_init(w.bar, 1);
    tma::mbar_init_fence();
  }
  load_heads(smem, w_attn + (size_t)b * 4 * DH * DH);
  load_heads(smem + HEADS_BYTES, dctx + (size_t)b * 4 * DH * DH);
  mma::fence_proxy_async();
  zero_sums(dgp_s, C);
  load_vec(gps, g_pre, C);
  float* dgp_w = dgp_s + warp * C;
  auto issue = [&](int it) {  // thread 0: tile it's x and dy into its stage
    if (it >= tiles) return;
    const uint32_t st = ring.stage(it), bar = ring.full(it);
    const int row = r0 + it * ROWS;
    tma::mbar_expect_tx(bar, 2 * CB * BOX);
    for (int cb = 0; cb < CB; ++cb) {
      tma::load_3d(st + cb * BOX, &tx, 64 * cb, row, b, bar);
      tma::load_3d(st + (CB + cb) * BOX, &tdy, 64 * cb, row, b, bar);
    }
  };
  if (tid == 0)
    for (int s = 0; s < L.stages; ++s) issue(s);
  // W_out's box (k-block cb, rows 64rb) resident in slot 2cb + rb; W_qkv's
  // (row block r, column block c) in 2CB + 6r + c
  if (w.resident)
    issue_group(w, 0, 8 * CB, [&](int i, const CUtensorMap*& map, int& col, int& row) {
      if (i < 2 * CB) {
        map = &to;
        col = 64 * (i >> 1);
        row = 64 * (i & 1);
      } else {
        map = &tw;
        col = 64 * ((i - 2 * CB) % 6);
        row = 64 * ((i - 2 * CB) / 6);
      }
    });
  __syncthreads();  // the barriers, W_h, dctx, the sums, g_pre
  const int kg = w.resident ? CB : min(CB, w.slots / 2);  // k-blocks a group
  const int cg = w.resident ? CB : w.slots / 6;           // dxn chunks a group
  // acc (64 × 128) = A·B over C: A K-major box tile at `at`; B's box for
  // k-block kb and output block i: W_out's (kb, rb = i) when P is 0 (TB 0),
  // else W_qkv's (kb, column block P − 1 + i) (TB 1); key of its groups P
  auto product = [&](float (&acc)[16][4], int P, uint32_t at) {
    for (int kb0 = 0; kb0 < CB; kb0 += kg) {
      const int kb1 = min(CB, kb0 + kg);
      if (!w.resident)
        load_group(w, 64 * P + kb0, 2 * (kb1 - kb0),
                   [&](int i, const CUtensorMap*& map, int& col, int& row) {
                     const int kb = kb0 + (i >> 1);
                     if (P == 0) {
                       map = &to;
                       col = 64 * kb;
                       row = 64 * (i & 1);
                     } else {
                       map = &tw;
                       col = 64 * (P - 1 + (i & 1));
                       row = 64 * kb;
                     }
                   });
      auto a = [&](int kb) { return at + kb * BOX; };
      auto bb = [&](int kb, int i) {
        if (!w.resident) return w.slot(2 * (kb - kb0) + i);
        return w.slot(P == 0 ? 2 * kb + i : 2 * CB + 6 * kb + P - 1 + i);
      };
      if (P == 0)
        gemm128<0>(acc, kb0, kb1, a, bb, kb0 == 0);
      else
        gemm128<1>(acc, kb0, kb1, a, bb, kb0 == 0);
      wait_all(acc);
    }
  };
  // W_qkv's box (row block r, column block c) for the dxn products, its
  // group (the row blocks of cg chunks) loaded
  auto qkv_box = [&](int r, int c) {
    const int r0g = r / cg * cg;
    if (!w.resident)
      load_group(w, 1024 + r0g, 6 * min(cg, CB - r0g),
                 [&](int i, const CUtensorMap*& map, int& col, int& row) {
                   map = &tw;
                   col = 64 * (i % 6);
                   row = 64 * (r0g + i / 6);
                 });
    return w.slot(w.resident ? 2 * CB + 6 * r + c : 6 * (r - r0g) + c);
  };

  for (int it = 0; it < tiles; ++it) {
    const int t0 = r0 + it * ROWS, valid = min(ROWS, r1 - t0);
    const uint32_t st = ring.stage(it);
    unsigned char* xs = smem + (st - base);
    unsigned char* dqt = own_dqt ? smem + 2 * HEADS_BYTES : xs + CB * BOX;
    ring.wait(it);
    wait_weights(w);
    float acc[16][4];
    product(acc, 0, st + CB * BOX);  // dattn = dy·W_outᵀ
    uint32_t da[8][4];
    pack_rows<16>(da, acc);  // rounded
    ln_tile(xs, C, lw, valid, gps, mean_s, rstd_s);
    mma::fence_proxy_async();
    __syncthreads();  // xn is whole
    for (int e = tid; e < valid * (C / 8); e += THREADS) {  // spill xn
      const int r = e / (C / 8), c = (e - r * (C / 8)) * 8;
      *reinterpret_cast<uint4*>(xn_spill + (bn + t0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(xs + sw(r, c));
    }
    // q_soft (f32); per head dq_soft = dattn_h·W_hᵀ, dq
    product(acc, 1, st);
    head_softmax(acc);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float dqs[4][4];
      head_product<0>(dqs, da[2 * h], da[2 * h + 1], wh + h * HEAD_BLOCK);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float ts = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ts += dqs[j][2 * half] * acc[4 * h + j][2 * half] +
                dqs[j][2 * half + 1] * acc[4 * h + j][2 * half + 1];
        ts = quad_sum(ts);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 2 * half; e < 2 * half + 2; ++e)
            acc[4 * h + j][e] = acc[4 * h + j][e] * (dqs[j][e] - ts);
      }
    }
    float x0[8][4];  // KEEP: dxn
    {
      uint32_t f[8][4];
      pack_rows<16>(f, acc);  // dq, rounded
      store_frags<8>(dqkv_spill + (bn + t0) * 3 * HID, 3 * HID, 0, 3 * HID, valid, f);
      if constexpr (KEEP) {  // dxn = dq·W_qᵀ
        gemm64_rs<0, 8>(x0, f, [&](int kb) { return qkv_box(0, kb); }, true);
        wait_all(x0);
        mma::fence_regs(f);
      } else {
        store_tile<16>(dqt, 0, acc);
      }
    }
    uint32_t vb[8][4];
    product(acc, 5, st);  // v
    pack_rows<16>(vb, acc);  // rounded
    product(acc, 3, st);  // k
    if (!L.alias) {
      __syncthreads();  // every warp is done with the stage
      if (tid == 0) issue(it + L.stages);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // e = exp(k − m), 0 past valid
      const int c = 8 * j + tq;
      const float m0 = __ldg(mb + c), m1 = __ldg(mb + c + 1);
      acc[j][0] = ra < valid ? __expf(acc[j][0] - m0) : 0.f;
      acc[j][1] = ra < valid ? __expf(acc[j][1] - m1) : 0.f;
      acc[j][2] = ra + 8 < valid ? __expf(acc[j][2] - m0) : 0.f;
      acc[j][3] = ra + 8 < valid ? __expf(acc[j][3] - m1) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float de[4][4], dv[4][4];
      head_product<0>(de, vb[2 * h], vb[2 * h + 1], dch + h * HEAD_BLOCK);  // v·dctxᵀ
      uint32_t e0[4], e1[4];
      mma::pack_a(e0, acc[4 * h], acc[4 * h + 1]);
      mma::pack_a(e1, acc[4 * h + 2], acc[4 * h + 3]);
      head_product<1>(dv, e0, e1, dch + h * HEAD_BLOCK);  // e·dctx
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = h * DH + 8 * j + tq;
        const float d0 = __ldg(dsb + c), d1 = __ldg(dsb + c + 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) de[j][e] = acc[4 * h + j][e] * (de[j][e] + ((e & 1) ? d1 : d0));
      }
      uint32_t fk[2][4], fv[2][4];
      pack_rows<4>(fk, de);  // dk, rounded
      pack_rows<4>(fv, dv);  // dv, rounded
      store_frags<2>(dqkv_spill + (bn + t0) * 3 * HID, 3 * HID, HID + DH * h, 3 * HID, valid,
                     fk);
      store_frags<2>(dqkv_spill + (bn + t0) * 3 * HID, 3 * HID, 2 * HID + DH * h, 3 * HID,
                     valid, fv);
      if constexpr (KEEP) {  // dxn += dk_h·W_k,hᵀ + dv_h·W_v,hᵀ: B K-major
        const uint32_t bk = qkv_box(0, 2 + h / 2) + 64 * (h & 1);
        const uint32_t bv = qkv_box(0, 4 + h / 2) + 64 * (h & 1);
        mma::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          mma::wgmma_rs<64, 0>(x0, fk[s], desc(bk + 32 * s));
          mma::wgmma_rs<64, 0>(x0, fv[s], desc(bv + 32 * s));
        }
        mma::wgmma_commit();
        wait_all(x0);
        mma::fence_regs(fk);
        mma::fence_regs(fv);
      } else {
        store_tile<4>(dqt, HID + DH * h, de);
        store_tile<4>(dqt, 2 * HID + DH * h, dv);
      }
    }
    if constexpr (!KEEP) {
      mma::fence_proxy_async();
      __syncthreads();  // the dqkv tile is whole
    }
    // dxn chunk j = dqkv·W_qkv[64j .., :]ᵀ
    auto dxn_chunk = [&](int j, float (&d)[8][4]) {
      const uint32_t bq = mma::smem_u32(dqt);
      gemm64(d, 0, 6, [&](int kb) { return bq + kb * BOX; }, [&](int kb) { return qkv_box(j, kb); },
             true);
      wait_all(d);
    };
    auto sweep = [&](auto&& body) {
      if constexpr (KEEP) {
        body(0, x0);
      } else {
        for (int j = 0; j < CB; ++j) {
          float t[8][4];
          dxn_chunk(j, t);
          body(j, t);
        }
      }
    };
    // the pre-norm LN's VJP over each row's quad, and the residual: m1 =
    // mean(dn), m2 = mean(dn·nx), dn = dxn·g_pre; dg_pre += dxn·nx per column
    float mean[2], rs[2], m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = mean_s[ra + 8 * h];
      rs[h] = rstd_s[ra + 8 * h];
    }
    const bf16* xt = xb + (size_t)t0 * C;
    sweep([&](int j, const float (&d)[8][4]) {
      uint32_t xq[8][2];
      ld_chunk<8>(xq, xt, C, 64 * j, valid);
      float p[8][2];  // the lane's Σ over its two rows of dxn·nx, per column
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * j + 8 * jj + tq;
        p[jj][0] = p[jj][1] = 0.f;
        if (c < C) {
          const float2 gp = ld_pair(gps + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (ra + 8 * h < valid) {
              const float2 xv = unpack(xq[jj][h]);
              const float nx0 = (xv.x - mean[h]) * rs[h], nx1 = (xv.y - mean[h]) * rs[h];
              const float dn0 = d[jj][2 * h] * gp.x, dn1 = d[jj][2 * h + 1] * gp.y;
              m1[h] += dn0 + dn1;
              m2[h] += dn0 * nx0 + dn1 * nx1;
              p[jj][0] += d[jj][2 * h] * nx0;
              p[jj][1] += d[jj][2 * h + 1] * nx1;
            }
          }
        }
      }
      add_col_sums<8>(dgp_w, p, C, 64 * j);
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m1[h] = __fmul_rn(quad_sum(m1[h]) / C, lw.ratio);  // past cn dxn and g_pre are 0
      m2[h] = __fmul_rn(quad_sum(m2[h]) / C, lw.ratio);
    }
    bf16* dxt = dx + (bn + t0) * C;
    const bf16* gt = dout + (bn + t0) * C;
    sweep([&](int j, const float (&d)[8][4]) {
      uint32_t xq[8][2], gq[8][2];  // x's and dO's pairs, then dx's
      ld_chunk<8>(xq, xt, C, 64 * j, valid);
      ld_chunk<8>(gq, gt, C, 64 * j, valid);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * j + 8 * jj + tq;
        if (c < C) {
          const float2 gp = ld_pair(gps + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 xv = unpack(xq[jj][h]), gf = unpack(gq[jj][h]);
            const float nx0 = (xv.x - mean[h]) * rs[h], nx1 = (xv.y - mean[h]) * rs[h];
            gq[jj][h] = mma::pack_bf16(gf.x + rs[h] * (d[jj][2 * h] * gp.x - m1[h] - nx0 * m2[h]),
                                       gf.y + rs[h] * (d[jj][2 * h + 1] * gp.y - m1[h] - nx1 * m2[h]));
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (64 * j + 8 * jj + tq < C && ra + 8 * h < valid)
            *reinterpret_cast<uint32_t*>(dxt + (size_t)(ra + 8 * h) * C + 64 * j + 8 * jj + tq) =
                gq[jj][h];
    });
    if constexpr (!KEEP) {
      __syncthreads();  // every warp is done with the dqkv tile
      if (L.alias && tid == 0) issue(it + L.stages);
    }
  }
  write_sums(dgp_s, C, part_dgpre + ((size_t)b * nparts + part) * C);
}

// part[z][i][j] = Σ_{rows of split z} A[row][i] · Bm[row][j], A (R, K1) and Bm
// (R, K2) row-major bf16, K1 and K2 multiples of 8, rows_per_split a
// multiple of 64. A CTA owns 64 × 64·NB outputs (NB = 6: a row of dW_qkv's
// 384 columns at C ≤ 64, so that A is read once; NB = 2 elsewhere, where
// 64 × 384 tiles would read B once for each of A's column blocks); each 64-row
// step's A box (its 64 columns i0 ..) and B boxes (columns j0 + 64p ..)
// arrive by TMA through a ring issued by thread 0, and the contraction runs
// along the rows, so both enter wgmma MN-major (the transpose bits). One
// step's products stay in flight while the next one's issue. One f32
// partial per split, no atomics.
template <int NB>
struct Wgrad {
  static constexpr int STAGES = NB == 6 ? 3 : 4;
  static constexpr int STAGE = (1 + NB) * BOX;
  static constexpr int BYTES = STAGES * STAGE + 8 * STAGES + 1024;
};
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_tma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 float* __restrict__ part, long R, int K1, int K2, long rows_per_split) {
  using G = Wgrad<NB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned(smem_raw);
  const uint32_t base = mma::smem_u32(smem), bars = base + G::STAGES * G::STAGE;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64 * NB;
  const int nbs = min(NB, (K2 - j0 + 63) / 64);  // B blocks inside K2
  const long ra = (long)blockIdx.z * rows_per_split;
  const long rb = min(R, ra + rows_per_split);
  const int steps = (int)((rb - ra + ROWS - 1) / ROWS);
  auto issue = [&](int s) {  // thread 0: step s into stage s % STAGES
    if (s >= steps) return;
    const uint32_t st = base + (s % G::STAGES) * G::STAGE, bar = bars + 8 * (s % G::STAGES);
    const int row = (int)(ra + (long)s * ROWS);
    tma::mbar_expect_tx(bar, (1 + nbs) * BOX);
    tma::load_3d(st, &ta, i0, row, 0, bar);
    for (int p = 0; p < nbs; ++p) tma::load_3d(st + (1 + p) * BOX, &tb, j0 + 64 * p, row, 0, bar);
  };
  if (tid == 0) {
    tma::prefetch_map(&ta);
    tma::prefetch_map(&tb);
    for (int s = 0; s < G::STAGES; ++s) tma::mbar_init(bars + 8 * s, 1);
    tma::mbar_init_fence();
    for (int s = 0; s < G::STAGES; ++s) issue(s);
  }
  __syncthreads();
  float acc[NB][8][4];
  auto step = [&](int s) {
    tma::mbar_wait(bars + 8 * (s % G::STAGES), (s / G::STAGES) & 1);
    const uint32_t st = base + (s % G::STAGES) * G::STAGE;
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(st + 2048 * kk);
#pragma unroll
      for (int p = 0; p < NB; ++p)
        if (p < nbs)
          mma::wgmma_ss64<1, 1>(acc[p], da, desc(st + (1 + p) * BOX + 2048 * kk), s > 0 || kk > 0);
    }
    mma::wgmma_commit();
  };
  // One step's products stay in flight while the next one's issue; the
  // first step is peeled, so that every loop header sees one group in flight
  // (else ptxas waits for all of them there).
  step(0);
  for (int s = 1; s < steps; ++s) {
    step(s);
    mma::wgmma_wait<1>();  // step s − 1's products are done
#pragma unroll
    for (int p = 0; p < NB; ++p) mma::fence_regs(acc[p]);
    __syncthreads();  // in every warp
    if (tid == 0) issue(s - 1 + G::STAGES);
  }
  mma::wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < NB; ++p) mma::fence_regs(acc[p]);
  const int i = i0 + lane_row(), tq = lane_col();
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = j0 + 64 * p + 8 * jj + tq;
      if (p < nbs && c < K2) {
        if (i < K1)
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * K1 + i) * K2 + c) =
              make_float2(acc[p][jj][0], acc[p][jj][1]);
        if (i + 8 < K1)
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * K1 + i + 8) * K2 + c) =
              make_float2(acc[p][jj][2], acc[p][jj][3]);
      }
    }
}

}  // namespace tc

inline size_t pass1_smem(int C, int tile) {
  return (size_t)(tile * C + 2 * tile * HID + 32 * WLD + 4 * DH * DH + 2 * tile) * sizeof(float);
}
inline size_t pass2_smem(int C, int tile) {
  return (size_t)(tile * C + tile * QKV + 32 * WLD + 2 * 4 * DH * HP + 2 * HID + 2 * tile) *
         sizeof(float);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int RW>
int launch_pass1(const void* x, const void* dout, const void* g_pre, const void* w_qkv,
                 const void* w_attn, const void* w_out, const void* b_out, const void* g_out,
                 void* dy_spill, void* attn_spill, void* part_dw, void* part_dgout,
                 void* part_dbout, int B, int n, int C, int rows, cudaStream_t st) {
  const size_t smem = pass1_smem(C, 8 * RW);
  int err = set_smem(pass1_kernel<T, RW>, smem);
  if (err) return err;
  dim3 grid((n + rows - 1) / rows, B);
  pass1_kernel<T, RW><<<grid, NT, smem, st>>>(
      (const T*)x, (const T*)dout, (const T*)g_pre, (const T*)w_qkv, (const float*)w_attn,
      (const T*)w_out, (const T*)b_out, (const T*)g_out, (T*)dy_spill, (T*)attn_spill,
      (float*)part_dw, (float*)part_dgout, (float*)part_dbout, n, C, rows);
  return (int)cudaGetLastError();
}

template <typename T, int RW>
int launch_pass2(const void* x, const void* dout, const void* g_pre, const void* w_qkv,
                 const void* w_attn, const void* w_out, const void* dctx, const void* ds,
                 const void* m, const void* dy_spill, void* dx, void* xn_spill,
                 void* dqkv_spill, void* part_dgpre, int B, int n, int C, int rows,
                 cudaStream_t st) {
  const size_t smem = pass2_smem(C, 8 * RW);
  int err = set_smem(pass2_kernel<T, RW>, smem);
  if (err) return err;
  dim3 grid((n + rows - 1) / rows, B);
  pass2_kernel<T, RW><<<grid, NT, smem, st>>>(
      (const T*)x, (const T*)dout, (const T*)g_pre, (const T*)w_qkv, (const float*)w_attn,
      (const T*)w_out, (const float*)dctx, (const float*)ds, (const float*)m,
      (const T*)dy_spill, (T*)dx, (T*)xn_spill, (T*)dqkv_spill, (float*)part_dgpre, n, C,
      rows);
  return (int)cudaGetLastError();
}

template <bool KEEP>
int launch_pass1_tma(const void* x, const void* dout, const void* g_pre, const void* w_qkv,
                     const void* w_attn, const void* w_out, const void* b_out,
                     const void* g_out, void* dy_spill, void* attn_spill, void* part_dw,
                     void* part_dgout, void* part_dbout, int B, int n, int C, int cn, int rows,
                     cudaStream_t st) {
  using linattn::bf16;
  const linattn::Layout L = tc::pass1_layout(C);
  if (L.bytes == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tdo, tw, to;
  cudaError_t err = tma::encode_boxes(&tx, x, B, n, C);
  if (err == cudaSuccess) err = tma::encode_boxes(&tdo, dout, B, n, C);
  if (err == cudaSuccess) err = tma::encode_boxes(&tw, w_qkv, 1, C, QKV);
  if (err == cudaSuccess) err = tma::encode_boxes(&to, w_out, 1, HID, C);
  auto kernel = tc::pass1_tma_kernel<KEEP>;
  if (err == cudaSuccess) err = (cudaError_t)set_smem(kernel, L.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((n + rows - 1) / rows, B), linattn::THREADS, L.bytes, st>>>(
      tx, tdo, tw, to, (const bf16*)g_pre, (const float*)w_attn, (const bf16*)b_out,
      (const bf16*)g_out, (bf16*)dy_spill, (bf16*)attn_spill, (float*)part_dw,
      (float*)part_dgout, (float*)part_dbout, n, C, linattn::ln_width(C, cn), rows, L);
  return (int)cudaGetLastError();
}

template <bool KEEP>
int launch_pass2_tma(const void* x, const void* dout, const void* g_pre, const void* w_qkv,
                     const void* w_attn, const void* w_out, const void* dctx, const void* ds,
                     const void* m, const void* dy_spill, void* dx, void* xn_spill,
                     void* dqkv_spill, void* part_dgpre, int B, int n, int C, int cn, int rows,
                     cudaStream_t st) {
  using linattn::bf16;
  const linattn::Layout L = tc::pass2_layout(C);
  if (L.bytes == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tdy, tw, to;
  cudaError_t err = tma::encode_boxes(&tx, x, B, n, C);
  if (err == cudaSuccess) err = tma::encode_boxes(&tdy, dy_spill, B, n, C);
  if (err == cudaSuccess) err = tma::encode_boxes(&tw, w_qkv, 1, C, QKV);
  if (err == cudaSuccess) err = tma::encode_boxes(&to, w_out, 1, HID, C);
  auto kernel = tc::pass2_tma_kernel<KEEP>;
  if (err == cudaSuccess) err = (cudaError_t)set_smem(kernel, L.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((n + rows - 1) / rows, B), linattn::THREADS, L.bytes, st>>>(
      tx, tdy, tw, to, (const bf16*)x, (const bf16*)dout, (const bf16*)g_pre,
      (const float*)w_attn, (const float*)dctx, (const float*)ds, (const float*)m, (bf16*)dx,
      (bf16*)xn_spill, (bf16*)dqkv_spill, (float*)part_dgpre, n, C, linattn::ln_width(C, cn),
      rows, L);
  return (int)cudaGetLastError();
}

template <int NB>
inline int launch_wgrad_tma(const void* a, const void* bm, void* part, long R, int K1, int K2,
                            long rows_per_split, int splits, cudaStream_t st) {
  using G = tc::Wgrad<NB>;
  CUtensorMap ta, tb;
  cudaError_t err = tma::encode_boxes(&ta, a, 1, R, K1);
  if (err == cudaSuccess) err = tma::encode_boxes(&tb, bm, 1, R, K2);
  if (err == cudaSuccess) err = (cudaError_t)set_smem(tc::wgrad_tma_kernel<NB>, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((K2 + 64 * NB - 1) / (64 * NB), (K1 + 63) / 64, splits);
  tc::wgrad_tma_kernel<NB><<<grid, linattn::THREADS, G::BYTES, st>>>(ta, tb, (float*)part, R, K1,
                                                                   K2, rows_per_split);
  return (int)cudaGetLastError();
}

inline int launch_wgrad_bf16(const void* a, const void* bm, void* part, long R, int K1, int K2,
                             long rows_per_split, int splits, cudaStream_t st) {
  if (K1 % 8 || K2 % 8 || rows_per_split % 64) return (int)cudaErrorInvalidValue;
  if (!linattn::aligned16({a, bm})) return (int)cudaErrorMisalignedAddress;
  return K1 <= 64 && K2 > 128
             ? launch_wgrad_tma<6>(a, bm, part, R, K1, K2, rows_per_split, splits, st)
             : launch_wgrad_tma<2>(a, bm, part, R, K1, K2, rows_per_split, splits, st);
}

}  // namespace wrap_bwd
}  // namespace daclip

using namespace daclip::wrap_bwd;

// f32 tiles are 64 rows up to C = 256 and 32 rows above, so pass 2's shared
// memory stays under the 227 KB a CTA may use; bf16 tiles are 64 rows at every
// C.
extern "C" int daclip_wrap_bwd1(const void* x, const void* dout, const void* g_pre,
                                const void* w_qkv, const void* w_attn, const void* w_out,
                                const void* b_out, const void* g_out, void* dy_spill,
                                void* attn_spill, void* part_dw, void* part_dgout,
                                void* part_dbout, int B, int n, int C, int cn, int rows,
                                int is_bf16, void* stream) {
  if (!daclip::linattn::widths_ok(C, cn, is_bf16) || rows % 64 || n < 1)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (is_bf16) {
    if (!daclip::linattn::aligned16({x, dout, g_pre, w_qkv, w_out, b_out, g_out, dy_spill, attn_spill}))
      return (int)cudaErrorMisalignedAddress;
    return C <= 64 ? launch_pass1_tma<true>(x, dout, g_pre, w_qkv, w_attn, w_out, b_out, g_out,
                                            dy_spill, attn_spill, part_dw, part_dgout,
                                            part_dbout, B, n, C, cn, rows, st)
                   : launch_pass1_tma<false>(x, dout, g_pre, w_qkv, w_attn, w_out, b_out, g_out,
                                             dy_spill, attn_spill, part_dw, part_dgout,
                                             part_dbout, B, n, C, cn, rows, st);
  }
#define DACLIP_PASS1(T, RW)                                                                  \
  launch_pass1<T, RW>(x, dout, g_pre, w_qkv, w_attn, w_out, b_out, g_out, dy_spill,         \
                      attn_spill, part_dw, part_dgout, part_dbout, B, n, C, rows, st)
  return C <= 256 ? DACLIP_PASS1(float, 8) : DACLIP_PASS1(float, 4);
#undef DACLIP_PASS1
}

extern "C" int daclip_wrap_bwd_mid(const void* part_dw, const void* ctx, const void* s,
                                   void* dctx, void* ds, int B, int nparts, int n,
                                   int is_bf16, void* stream) {
  auto st = (cudaStream_t)stream;
  dim3 grid(HID, B);
  auto pd = (const float*)part_dw, c = (const float*)ctx, sp = (const float*)s;
  if (is_bf16)
    mid_kernel<__nv_bfloat16><<<grid, 32 * mid_warps(nparts), 0, st>>>(
        pd, c, sp, (float*)dctx, (float*)ds, nparts, n);
  else
    mid_kernel<float><<<grid, 32 * mid_warps(nparts), 0, st>>>(pd, c, sp, (float*)dctx,
                                                               (float*)ds, nparts, n);
  return (int)cudaGetLastError();
}

extern "C" int daclip_wrap_bwd2(const void* x, const void* dout, const void* g_pre,
                                const void* w_qkv, const void* w_attn, const void* w_out,
                                const void* dctx, const void* ds, const void* m,
                                const void* dy_spill, void* dx, void* xn_spill,
                                void* dqkv_spill, void* part_dgpre, int B, int n, int C,
                                int cn, int rows, int is_bf16, void* stream) {
  if (!daclip::linattn::widths_ok(C, cn, is_bf16) || rows % 64 || n < 1)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (is_bf16) {
    if (!daclip::linattn::aligned16({x, dout, g_pre, w_qkv, w_out, dy_spill, dx, xn_spill, dqkv_spill}))
      return (int)cudaErrorMisalignedAddress;
    return C <= 64 ? launch_pass2_tma<true>(x, dout, g_pre, w_qkv, w_attn, w_out, dctx, ds, m,
                                            dy_spill, dx, xn_spill, dqkv_spill, part_dgpre, B,
                                            n, C, cn, rows, st)
                   : launch_pass2_tma<false>(x, dout, g_pre, w_qkv, w_attn, w_out, dctx, ds, m,
                                             dy_spill, dx, xn_spill, dqkv_spill, part_dgpre, B,
                                             n, C, cn, rows, st);
  }
#define DACLIP_PASS2(T, RW)                                                                  \
  launch_pass2<T, RW>(x, dout, g_pre, w_qkv, w_attn, w_out, dctx, ds, m, dy_spill, dx,      \
                      xn_spill, dqkv_spill, part_dgpre, B, n, C, rows, st)
  return C <= 256 ? DACLIP_PASS2(float, 8) : DACLIP_PASS2(float, 4);
#undef DACLIP_PASS2
}

// part (splits, K1, K2) f32; rows_per_split a multiple of 32 (f32) or 64
// (bf16); in bf16 K1 and K2 multiples of 8.
extern "C" int daclip_wrap_wgrad(const void* a, const void* bm, void* part, long R, int K1,
                                 int K2, long rows_per_split, int splits, int is_bf16,
                                 void* stream) {
  if (R < 1 || splits < 1 || rows_per_split % 32) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (is_bf16) return launch_wgrad_bf16(a, bm, part, R, K1, K2, rows_per_split, splits, st);
  dim3 grid((K2 + 63) / 64, (K1 + 63) / 64, splits);
  wgrad_kernel<float><<<grid, NT, 0, st>>>((const float*)a, (const float*)bm, (float*)part, R,
                                           K1, K2, rows_per_split);
  return (int)cudaGetLastError();
}

// The bf16 launches' dynamic shared memory in bytes at C: kernel 0 pass 1,
// 1 pass 2, 2 the weight gradient dW_qkv, 3 dW_out; 0 if it does not fit.
extern "C" int daclip_wrap_bwd_smem(int kernel, int C) {
  if (!daclip::linattn::widths_ok(C, C, 1)) return 0;
  if (kernel == 2 && C <= 64) return tc::Wgrad<6>::BYTES;
  if (kernel >= 2) return tc::Wgrad<2>::BYTES;
  return kernel == 0 ? tc::pass1_layout(C).bytes : tc::pass2_layout(C).bytes;
}
