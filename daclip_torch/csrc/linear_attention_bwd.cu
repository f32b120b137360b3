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
//         three quarters thrown away), Σ dO·norm_y and Σ dy in registers and
//         writes them as per-CTA partials; spills dy and a in T.
//   mid   grid (128, B): sums the dW partials, dctx = dW·32^-½/(s·n) (rounded),
//         ds = −Σ(dctx∘ctx)/s.
//   pass2 grid (parts, B): rebuilds xn, q_soft (f32), k, v, e = exp(k − m);
//         dq from the head-softmax VJP of dattn·Wᵀ; dk = e∘(v·dctxᵀ + ds);
//         dv = e·dctx; dxn = dqkv·W_qkvᵀ; dx = dO + LN-VJP(dxn·g_pre);
//         keeps Σ dxn·norm_x; spills xn and dqkv in T.
//   wgrad grid (K2/64, K1/64, splits), twice: dW_qkv = Σ xnᵀ·dqkv and
//         dW_out = Σ aᵀ·dy over all B·n rows, one f32 partial per split.
// The per-CTA and per-split partials are summed by the caller.
//
// Why the weight gradients leave the passes: the TPU kept dW_qkv (C×384 f32)
// resident in VMEM across its in-order grid. On Hopper that is 384 KB per
// CTA at C=256, more than a CTA's registers or 227 KB of shared memory, so
// pass 2 spills xn and dqkv and a tiled product reduces them (likewise a and
// dy for dW_out). That costs (2C + 512)·2 B of extra traffic per row in bf16.
//
// What bounds it on an H100: the L0 sites of a 256² training step (B=16,
// n=65536, C=64, bf16) must read x and dO and write dx (3·B·n·C·2 B ≈ 403 MB,
// ≈0.12 ms at 3.35 TB/s) and do 2·B·n·(1536·C + 20480) ≈ 249 GFLOP of
// products (qkv, a, y rebuilt; dattn, dW, dW_out, dq_soft, de, dv, dxn,
// dW_qkv; ≈0.25 ms on the bf16 tensor cores), so the operations bound it.
// This first version does every product with scalar FMA in f32 (67 TFLOP/s
// peak, ≥4 ms there); tensor-core products are the next step, as for the
// forward.
#include "common.cuh"

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
// (sk = 1 reads a weight transposed). K is a multiple of 32; W is staged 32
// rows of k at a time through ws, as f32, in the order that reads the
// global weights contiguously. Thread (warp, lane) owns rows warp·RW + i.
template <typename T, int RW, int NC>
__device__ void gemm_rows(const float* A, int lda, int K, const T* __restrict__ W, int sk,
                          int sc, int c0, int ncols, float* ws, float (&acc)[RW][NC]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    for (int e = threadIdx.x; e < 32 * ncols; e += NT) {
      int kk, c;
      if (sc == 1) {
        kk = e / ncols;
        c = e - kk * ncols;
      } else {
        c = e >> 5;
        kk = e & 31;
      }
      ws[kk * WLD + c] = to_f(W[(size_t)(k0 + kk) * sk + (size_t)(c0 + c) * sc]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
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

template <typename T, int RW>
__global__ void __launch_bounds__(NT)
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
          if (j * 32 < ncols) {
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

// One warp per (ctx row c, batch b): lane = column within the head block.
template <typename T>
__global__ void __launch_bounds__(32)
mid_kernel(const float* __restrict__ part_dw, const float* __restrict__ ctx,
           const float* __restrict__ s, float* __restrict__ dctx, float* __restrict__ ds,
           int nparts, int n) {
  const int c = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int hh = c / DH, i = c % DH;
  const size_t at = (size_t)hh * DH * DH + i * DH + lane;
  float acc = 0.f;
  for (int p = 0; p < nparts; ++p) acc += part_dw[((size_t)b * nparts + p) * 4 * DH * DH + at];
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
          if (j * 32 < ncols) r1[(warp * RW + i) * C + c0 + lane + 32 * j] = acc[i][j];
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

}  // namespace wrap_bwd
}  // namespace daclip

using namespace daclip::wrap_bwd;

// Tiles are 64 rows up to C = 256 and 32 rows above, so pass 2's shared
// memory stays under the 227 KB a CTA may use.
extern "C" int daclip_wrap_bwd1(const void* x, const void* dout, const void* g_pre,
                                const void* w_qkv, const void* w_attn, const void* w_out,
                                const void* b_out, const void* g_out, void* dy_spill,
                                void* attn_spill, void* part_dw, void* part_dgout,
                                void* part_dbout, int B, int n, int C, int rows, int is_bf16,
                                void* stream) {
  if (C % 32 || C > 512 || rows % 64 || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
#define DACLIP_PASS1(T, RW)                                                                  \
  launch_pass1<T, RW>(x, dout, g_pre, w_qkv, w_attn, w_out, b_out, g_out, dy_spill,         \
                      attn_spill, part_dw, part_dgout, part_dbout, B, n, C, rows, st)
  if (is_bf16) return C <= 256 ? DACLIP_PASS1(__nv_bfloat16, 8) : DACLIP_PASS1(__nv_bfloat16, 4);
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
    mid_kernel<__nv_bfloat16><<<grid, 32, 0, st>>>(pd, c, sp, (float*)dctx, (float*)ds,
                                                   nparts, n);
  else
    mid_kernel<float><<<grid, 32, 0, st>>>(pd, c, sp, (float*)dctx, (float*)ds, nparts, n);
  return (int)cudaGetLastError();
}

extern "C" int daclip_wrap_bwd2(const void* x, const void* dout, const void* g_pre,
                                const void* w_qkv, const void* w_attn, const void* w_out,
                                const void* dctx, const void* ds, const void* m,
                                const void* dy_spill, void* dx, void* xn_spill,
                                void* dqkv_spill, void* part_dgpre, int B, int n, int C,
                                int rows, int is_bf16, void* stream) {
  if (C % 32 || C > 512 || rows % 64 || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
#define DACLIP_PASS2(T, RW)                                                                  \
  launch_pass2<T, RW>(x, dout, g_pre, w_qkv, w_attn, w_out, dctx, ds, m, dy_spill, dx,      \
                      xn_spill, dqkv_spill, part_dgpre, B, n, C, rows, st)
  if (is_bf16) return C <= 256 ? DACLIP_PASS2(__nv_bfloat16, 8) : DACLIP_PASS2(__nv_bfloat16, 4);
  return C <= 256 ? DACLIP_PASS2(float, 8) : DACLIP_PASS2(float, 4);
#undef DACLIP_PASS2
}

// part (splits, K1, K2) f32; rows_per_split a multiple of 32.
extern "C" int daclip_wrap_wgrad(const void* a, const void* bm, void* part, long R, int K1,
                                 int K2, long rows_per_split, int splits, int is_bf16,
                                 void* stream) {
  if (R < 1 || splits < 1 || rows_per_split % 32) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  dim3 grid((K2 + 63) / 64, (K1 + 63) / 64, splits);
  if (is_bf16)
    wgrad_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>((const __nv_bfloat16*)a,
                                                     (const __nv_bfloat16*)bm, (float*)part,
                                                     R, K1, K2, rows_per_split);
  else
    wgrad_kernel<float><<<grid, NT, 0, st>>>((const float*)a, (const float*)bm, (float*)part,
                                             R, K1, K2, rows_per_split);
  return (int)cudaGetLastError();
}
