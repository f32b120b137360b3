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
//
// bf16 runs on the tensor cores (`tc::pass1_mma_kernel`, `tc::pass2_mma_kernel`,
// `tc::wgrad_mma_kernel`): every product on mma.sync m16n8k16 with the tiles of
// linattn_tiles.cuh, 4 warps × 16 rows a 64-row tile at every C. Products
// that contract over the tile's rows (dW_h += q_softᵀ·dattn, the weight
// gradients) take their A operand through ldmatrix.trans; those with a
// transposed weight (dy·W_outᵀ, dqkv·W_qkvᵀ) stream it as [n][k] slices; the
// per-head products (a_h, dq_soft, de, dv) take W_h or dctx resident in
// shared memory as bf16. Every operand is a bf16 value where the scalar
// kernel rounds it, so only the order of the f32 sums differs. f32 keeps the
// scalar kernels (`pass1_kernel`, `pass2_kernel`, `wgrad_kernel`), in full
// f32 like the plain version.

#include "common.cuh"
#include "linattn_tiles.cuh"

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

// -- bf16: tensor cores --------------------------------------------------------
namespace tc {

using namespace linattn;
using linattn::load_rows;  // not the scalar kernels' f32 row loader
using linattn::WLD;        // nor their padded row

// Per-channel sums kept in shared memory, one row of C floats a warp (each
// lane adds to its channels lane + 32k only): zeroed, then summed over the 4
// warps into out[0 .. C).
__device__ __forceinline__ void zero_sums(float* sums, int C) {
  for (int c = threadIdx.x; c < 4 * C; c += THREADS) sums[c] = 0.f;
}
__device__ __forceinline__ void write_sums(const float* sums, int C, float* __restrict__ out) {
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS)
    out[c] = (sums[c] + sums[C + c]) + (sums[2 * C + c] + sums[3 * C + c]);
}

// Shared memory of pass1_mma_kernel: W_h, the ring, q_soft and dattn tiles
// [64][WLD] bf16, the per-warp sums of dg_out and db_out [2][4][C] f32, and
// the row tile: xn [64][C + 8] bf16, then y [64][C + 4] f32 with each row's
// dy (bf16) in the row's first half.
inline size_t pass1_smem(int C) {
  return HEADS_BYTES + RING_BYTES + 2 * (size_t)ROWS * WLD * 2 + 8 * (size_t)C * 4 +
         (size_t)ROWS * (C + 4) * 4;
}

// The bf16 pass 1, 4 warps × 16 rows a 64-row tile. Per tile: xn (LN in
// shared memory), q = xn·W_q, the head softmax in the accumulator, q_soft
// rounded (to A fragments and to shared memory), a_h = q_soft_h·W_h (W_h
// resident), a rounded (spilled, re-packed), y = a·W_out + b_out in 128-column
// chunks (f32, shared memory), the post-norm LN and its VJP over each row's
// quad (dy rounded, spilled, and kept in the row's own bytes), dattn = dy·W_outᵀ
// (W_out streamed as [n][k] slices), then warp h: dW_h += q_softᵀ·dattn over
// the tile's rows (A through ldmatrix.trans), in registers across tiles.
__global__ void __launch_bounds__(THREADS)
pass1_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                 const bf16* __restrict__ g_pre, const bf16* __restrict__ w_qkv,
                 const float* __restrict__ w_attn, const bf16* __restrict__ w_out,
                 const bf16* __restrict__ b_out, const bf16* __restrict__ g_out,
                 bf16* __restrict__ dy_spill, bf16* __restrict__ attn_spill,
                 float* __restrict__ part_dw, float* __restrict__ part_dgout,
                 float* __restrict__ part_dbout, int n, int C, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wa = reinterpret_cast<bf16*>(smem);  // [4][32][WLDT]
  bf16* ring = wa + 4 * DH * WLDT;
  bf16* qs = ring + 2 * STAGE;               // [64][WLD] q_soft
  bf16* das = qs + ROWS * WLD;               // [64][WLD] dattn
  float* dgo_s = reinterpret_cast<float*>(das + ROWS * WLD);  // [4][C] Σ dO·ny
  float* dbo_s = dgo_s + 4 * C;                               // [4][C] Σ dy
  bf16* xs = reinterpret_cast<bf16*>(dbo_s + 4 * C);          // [64][C + 8] xn
  float* ys = reinterpret_cast<float*>(xs);  // [64][C + 4] y; dy in each row's first half
  bf16* dys = xs;                            // dy: row stride 2·(C + 4)
  const int LDX = C + 8, LDY = C + 4, LDD = 2 * (C + 4);

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = 2 * (lane & 3), ra = warp * 16 + g;
  const int r0 = part * rows, r1e = min(n, r0 + rows);
  const size_t bn = (size_t)b * n;
  const bf16* xb = x + bn * C;
  load_heads(wa, w_attn + (size_t)b * 4 * DH * DH);
  float dw[2][4][4];  // dW of head `warp`: rows 16mi + g (+8), columns 8nj + tq (+1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[mi][j][e] = 0.f;
  zero_sums(dgo_s, C);
  zero_sums(dbo_s, C);
  float* dgo_w = dgo_s + warp * C;
  float* dbo_w = dbo_s + warp * C;

  for (int t0 = r0; t0 < r1e; t0 += ROWS) {
    const int valid = min(ROWS, r1e - t0);
    __syncthreads();  // the previous tile is done with qs, das, dy and the ring
    gemm_prime<false>(ring, w_qkv, QKV, 0, HID, C);  // W_q's copies start first
    load_rows(xs, LDX, xb, C, t0, valid, 0, C);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    ln_tile(xs, C, valid, g_pre, nullptr, nullptr);
    float acc[16][4];
    gemm_w<false, 0>(acc, SmemA{xs, LDX}, C, w_qkv, QKV, 0, HID, ring, true);
    __syncthreads();
    gemm_prime<false>(ring, w_out, C, 0, min(HID, C), HID);  // W_out's first slices
    head_softmax(acc);
    uint32_t fa[8][4];
    pack_rows(fa, acc);          // q_soft, rounded
    store_tile<16>(qs, WLD, acc);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float o[4][4];
      head_product<false>(o, fa[2 * h], fa[2 * h + 1], wa + h * DH * WLDT);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * h + j][e] = o[j][e];
    }
    pack_rows(fa, acc);          // a, rounded
    {
      bf16* sp = attn_spill + (bn + t0) * HID;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (ra < valid)
          *reinterpret_cast<uint32_t*>(sp + ra * HID + 8 * j + tq) = fa[j >> 1][(j & 1) * 2];
        if (ra + 8 < valid)
          *reinterpret_cast<uint32_t*>(sp + (ra + 8) * HID + 8 * j + tq) =
              fa[j >> 1][(j & 1) * 2 + 1];
      }
    }
    for (int c0 = 0; c0 < C; c0 += HID) {  // y = a·W_out + b_out
      const int ncols = min(HID, C - c0);
      gemm_w<false, HID>(acc, RegA{fa}, HID, w_out, C, c0, ncols, ring, c0 == 0);
      store_f32(ys, LDY, c0, ncols, acc, b_out);
    }
    __syncwarp();  // each warp reads back its own rows
    // the post-norm LN and its VJP over each row's quad: mean and 1/std of y;
    // m1 = mean(dn), m2 = mean(dn·ny), dn = dO·g_out; dg_out += dO·ny and
    // db_out += dy per column (rows past valid: dO, so dy, is 0)
    {
      float mean[2], rs[2], m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
      row_stats(ys, LDY, C, mean, rs);
      const bf16* gb = dout + (bn + t0) * C;
      uint32_t gq[16][2];
      for (int c0 = 0; c0 < C; c0 += HID) {
        ld_chunk(gq, gb, C, c0, valid);
        float p[16][2];  // the lane's Σ over its two rows of dO·ny, per column
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 8 * j + tq;
          p[j][0] = p[j][1] = 0.f;
          if (c < C) {
            const float2 gg = ld_pair(g_out + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 gf = unpack(gq[j][h]);
              const float2 v = *reinterpret_cast<const float2*>(ys + (ra + 8 * h) * LDY + c);
              const float ny0 = (v.x - mean[h]) * rs[h], ny1 = (v.y - mean[h]) * rs[h];
              const float dn0 = gf.x * gg.x, dn1 = gf.y * gg.y;
              m1[h] += dn0 + dn1;
              m2[h] += dn0 * ny0 + dn1 * ny1;
              p[j][0] += gf.x * ny0;
              p[j][1] += gf.y * ny1;
            }
          }
        }
        add_col_sums(dgo_w, p, C, c0);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] = quad_sum(m1[h]) / C;
        m2[h] = quad_sum(m2[h]) / C;
      }
      // dy = rs·(dn − m1 − ny·m2), rounded, into each row's first half, one
      // 128-column chunk at a time: a chunk's writes reach only columns that
      // this or an earlier chunk has read, so it writes once all its lanes
      // have read
      for (int c0 = 0; c0 < C; c0 += HID) {
        if (C > HID) ld_chunk(gq, gb, C, c0, valid);  // else the chunk's dO is still in gq
        float p[16][2];  // the lane's Σ over its two rows of dy, per column
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 8 * j + tq;
          p[j][0] = p[j][1] = 0.f;
          if (c < C) {
            const float2 gg = ld_pair(g_out + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 gf = unpack(gq[j][h]);
              const float2 v = *reinterpret_cast<const float2*>(ys + (ra + 8 * h) * LDY + c);
              const float ny0 = (v.x - mean[h]) * rs[h], ny1 = (v.y - mean[h]) * rs[h];
              const float dy0 = rs[h] * (gf.x * gg.x - m1[h] - ny0 * m2[h]);
              const float dy1 = rs[h] * (gf.y * gg.y - m1[h] - ny1 * m2[h]);
              p[j][0] += dy0;
              p[j][1] += dy1;
              gq[j][h] = mma::pack_bf16(dy0, dy1);  // dO's pair is used: dy's takes its place
            }
          }
        }
        __syncwarp();
        bf16* sp = dy_spill + (bn + t0) * C;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 8 * j + tq;
          if (c < C) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = ra + 8 * h;
              *reinterpret_cast<uint32_t*>(dys + r * LDD + c) = gq[j][h];
              if (r < valid) *reinterpret_cast<uint32_t*>(sp + r * C + c) = gq[j][h];
            }
          }
        }
        __syncwarp();
        add_col_sums(dbo_w, p, C, c0);
      }
    }
    // dattn = dy·W_outᵀ, rounded
    gemm_w<true, 0>(acc, SmemA{dys, LDD}, C, w_out, C, 0, HID, ring);
    store_tile<16>(das, WLD, acc);
    __syncthreads();
    // dW_h += q_softᵀ·dattn over the tile's rows, h = warp (rows past valid:
    // dy, so dattn, is 0)
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t a[4];
        ldsm_at(a, qs + 16 * kk * WLD + warp * DH + 16 * mi, WLD);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bb[4];
          mma::ldsm_bt(bb, das + 16 * kk * WLD + warp * DH + 16 * jp, WLD);
          mma::mma_bf16(dw[mi][2 * jp], a, bb[0], bb[1]);
          mma::mma_bf16(dw[mi][2 * jp + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  const size_t pb = (size_t)b * nparts + part;
  float* pw = part_dw + pb * 4 * DH * DH + warp * DH * DH;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 16 * mi + g, c = 8 * j + tq;
      *reinterpret_cast<float2*>(pw + i * DH + c) = make_float2(dw[mi][j][0], dw[mi][j][1]);
      *reinterpret_cast<float2*>(pw + (i + 8) * DH + c) = make_float2(dw[mi][j][2], dw[mi][j][3]);
    }
  write_sums(dgo_s, C, part_dgout + pb * C);
  write_sums(dbo_s, C, part_dbout + pb * C);
}

constexpr int QLD = QKV + 8;  // row of the dqkv tile

// Shared memory of pass2_mma_kernel: W_h and dctx, the ring, the dqkv tile
// [64][QLD] bf16, the rows' mean and 1/std [64], the per-warp sums of dg_pre
// [4][C] f32, and the row tile: dy [64][C + 8] bf16, then xn likewise, then
// dxn [64][C + 4] f32 (231,936 bytes at C = 512).
inline size_t pass2_smem(int C) {
  return 2 * HEADS_BYTES + RING_BYTES + (size_t)ROWS * QLD * 2 + 2 * ROWS * 4 +
         4 * (size_t)C * 4 + (size_t)ROWS * (C + 4) * 4;
}

// The bf16 pass 2, 4 warps × 16 rows a 64-row tile. Per tile: dattn =
// dy·W_outᵀ from the spilled dy (rounded, kept as A fragments); xn (LN,
// spilled); q = xn·W_q and its softmax (f32) in the accumulator; per head
// dq_soft = dattn_h·W_hᵀ and dq = q_soft∘(dq_soft − Σ dq_soft∘q_soft); v (as
// rounded A fragments) and k; e = exp(k − m); per head de = v_h·dctx_hᵀ, dk =
// e∘(de + ds), dv = e_h (rounded, re-packed)·dctx_h; dq | dk | dv rounded
// into a shared tile and spilled; dxn = dqkv·W_qkvᵀ in 128-column chunks
// (W_qkv streamed as [n][k] slices) into shared memory as f32; then the
// pre-norm LN's VJP and the residual over each row's quad. Each
// product's first weight slice is copied while the work before it runs.
__global__ void __launch_bounds__(THREADS)
pass2_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                 const bf16* __restrict__ g_pre, const bf16* __restrict__ w_qkv,
                 const float* __restrict__ w_attn, const bf16* __restrict__ w_out,
                 const float* __restrict__ dctx, const float* __restrict__ ds,
                 const float* __restrict__ m, const bf16* __restrict__ dy_spill,
                 bf16* __restrict__ dx, bf16* __restrict__ xn_spill,
                 bf16* __restrict__ dqkv_spill, float* __restrict__ part_dgpre, int n, int C,
                 int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wa = reinterpret_cast<bf16*>(smem);  // [4][32][WLDT] W_h
  bf16* cs = wa + 4 * DH * WLDT;             // [4][32][WLDT] dctx (rounded)
  bf16* ring = cs + 4 * DH * WLDT;
  bf16* dq = ring + 2 * STAGE;               // [64][QLD] dq | dk | dv
  float* mean_s = reinterpret_cast<float*>(dq + ROWS * QLD);  // [64]
  float* rstd_s = mean_s + ROWS;             // [64]
  float* dgp_s = rstd_s + ROWS;              // [4][C] Σ dxn·nx
  bf16* xs = reinterpret_cast<bf16*>(dgp_s + 4 * C);  // [64][C + 8] dy, then xn
  float* dxs = reinterpret_cast<float*>(xs);          // [64][C + 4] dxn
  const int LDX = C + 8, LDY = C + 4;

  const int b = blockIdx.y, part = blockIdx.x, nparts = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = 2 * (lane & 3), ra = warp * 16 + g;
  const int r0 = part * rows, r1e = min(n, r0 + rows);
  const size_t bn = (size_t)b * n;
  const bf16* xb = x + bn * C;
  const float* mb = m + (size_t)b * HID;
  const float* dsb = ds + (size_t)b * HID;
  load_heads(wa, w_attn + (size_t)b * 4 * DH * DH);
  load_heads(cs, dctx + (size_t)b * 4 * DH * DH);
  zero_sums(dgp_s, C);
  float* dgp_w = dgp_s + warp * C;

  for (int t0 = r0; t0 < r1e; t0 += ROWS) {
    const int valid = min(ROWS, r1e - t0);
    __syncthreads();  // the previous tile is done with xs, dq and the ring
    gemm_prime<true>(ring, w_out, C, 0, HID, C);  // W_out's copies start first
    load_rows(xs, LDX, dy_spill + bn * C, C, t0, valid, 0, C);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    float acc[16][4];
    gemm_w<true, 0>(acc, SmemA{xs, LDX}, C, w_out, C, 0, HID, ring, true);  // dattn
    uint32_t da[8][4];
    pack_rows(da, acc);  // rounded
    __syncthreads();     // every warp is done with dy and the ring
    gemm_prime<false>(ring, w_qkv, QKV, 0, HID, C);
    load_rows(xs, LDX, xb, C, t0, valid, 0, C);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    ln_tile(xs, C, valid, g_pre, mean_s, rstd_s);
    __syncthreads();
    for (int e = tid; e < valid * (C / 8); e += THREADS) {  // spill xn
      const int r = e / (C / 8), c = (e - r * (C / 8)) * 8;
      *reinterpret_cast<uint4*>(xn_spill + (bn + t0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(xs + r * LDX + c);
    }
    // q_soft (f32); per head dq_soft = dattn·W_hᵀ, dq
    gemm_w<false, 0>(acc, SmemA{xs, LDX}, C, w_qkv, QKV, 0, HID, ring, true);
    __syncthreads();
    gemm_prime<false>(ring, w_qkv, QKV, 2 * HID, HID, C);
    head_softmax(acc);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float dqs[4][4];
      head_product<true>(dqs, da[2 * h], da[2 * h + 1], wa + h * DH * WLDT);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float ts = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ts += dqs[j][2 * half] * acc[4 * h + j][2 * half] +
                dqs[j][2 * half + 1] * acc[4 * h + j][2 * half + 1];
        ts += __shfl_xor_sync(0xffffffffu, ts, 1);
        ts += __shfl_xor_sync(0xffffffffu, ts, 2);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 2 * half; e < 2 * half + 2; ++e)
            acc[4 * h + j][e] = acc[4 * h + j][e] * (dqs[j][e] - ts);
      }
    }
    store_tile<16>(dq, QLD, acc);  // dq, rounded
    gemm_w<false, 0>(acc, SmemA{xs, LDX}, C, w_qkv, QKV, 2 * HID, HID, ring, true);
    __syncthreads();
    gemm_prime<false>(ring, w_qkv, QKV, HID, HID, C);
    uint32_t vb[8][4];
    pack_rows(vb, acc);            // v, rounded
    gemm_w<false, 0>(acc, SmemA{xs, LDX}, C, w_qkv, QKV, HID, HID, ring, true);
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
      head_product<true>(de, vb[2 * h], vb[2 * h + 1], cs + h * DH * WLDT);  // v·dctxᵀ
      uint32_t e0[4], e1[4];
      mma::pack_a(e0, acc[4 * h], acc[4 * h + 1]);
      mma::pack_a(e1, acc[4 * h + 2], acc[4 * h + 3]);
      head_product<false>(dv, e0, e1, cs + h * DH * WLDT);  // e·dctx
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = h * DH + 8 * j + tq;
        const float d0 = __ldg(dsb + c), d1 = __ldg(dsb + c + 1);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          de[j][e] = acc[4 * h + j][e] * (de[j][e] + ((e & 1) ? d1 : d0));
      }
      store_tile<4>(dq + HID + h * DH, QLD, de);       // dk, rounded
      store_tile<4>(dq + 2 * HID + h * DH, QLD, dv);   // dv, rounded
    }
    __syncthreads();  // the dqkv tile is whole; every warp is done with the ring
    gemm_prime<true>(ring, w_qkv, QKV, 0, min(HID, C), QKV);
    for (int e = tid; e < valid * (QKV / 8); e += THREADS) {  // spill dqkv
      const int r = e / (QKV / 8), c = (e - r * (QKV / 8)) * 8;
      *reinterpret_cast<uint4*>(dqkv_spill + (bn + t0 + r) * QKV + c) =
          *reinterpret_cast<const uint4*>(dq + r * QLD + c);
    }
    for (int c0 = 0; c0 < C; c0 += HID) {  // dxn = dqkv·W_qkvᵀ
      const int ncols = min(HID, C - c0);
      gemm_w<true, 0>(acc, SmemA{dq, QLD}, QKV, w_qkv, QKV, c0, ncols, ring, c0 == 0);
      store_f32(dxs, LDY, c0, ncols, acc, nullptr);
    }
    __syncwarp();  // each warp reads back its own rows
    // the pre-norm LN's VJP over each row's quad, and the residual: m1 =
    // mean(dn), m2 = mean(dn·nx), dn = dxn·g_pre; dg_pre += dxn·nx per column
    {
      float mean[2], rs[2], m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] = mean_s[ra + 8 * h];
        rs[h] = rstd_s[ra + 8 * h];
      }
      const bf16* xt = xb + (size_t)t0 * C;
      uint32_t xq[16][2];
      for (int c0 = 0; c0 < C; c0 += HID) {
        ld_chunk(xq, xt, C, c0, valid);
        float p[16][2];  // the lane's Σ over its two rows of dxn·nx, per column
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 8 * j + tq;
          p[j][0] = p[j][1] = 0.f;
          if (c < C) {
            const float2 gp = ld_pair(g_pre + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (ra + 8 * h < valid) {
                const float2 xv = unpack(xq[j][h]);
                const float2 d = *reinterpret_cast<const float2*>(dxs + (ra + 8 * h) * LDY + c);
                const float nx0 = (xv.x - mean[h]) * rs[h], nx1 = (xv.y - mean[h]) * rs[h];
                const float dn0 = d.x * gp.x, dn1 = d.y * gp.y;
                m1[h] += dn0 + dn1;
                m2[h] += dn0 * nx0 + dn1 * nx1;
                p[j][0] += d.x * nx0;
                p[j][1] += d.y * nx1;
              }
            }
          }
        }
        add_col_sums(dgp_w, p, C, c0);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] = quad_sum(m1[h]) / C;
        m2[h] = quad_sum(m2[h]) / C;
      }
      for (int c0 = 0; c0 < C; c0 += HID) {
        uint32_t gq[16][2];  // dO's pairs, then dx's
        if (C > HID) ld_chunk(xq, xt, C, c0, valid);  // else the chunk's x is still in xq
        ld_chunk(gq, dout + (bn + t0) * C, C, c0, valid);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 8 * j + tq;
          if (c < C) {
            const float2 gp = ld_pair(g_pre + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 xv = unpack(xq[j][h]);
              const float2 gf = unpack(gq[j][h]);
              const float2 d = *reinterpret_cast<const float2*>(dxs + (ra + 8 * h) * LDY + c);
              const float nx0 = (xv.x - mean[h]) * rs[h], nx1 = (xv.y - mean[h]) * rs[h];
              gq[j][h] = mma::pack_bf16(gf.x + rs[h] * (d.x * gp.x - m1[h] - nx0 * m2[h]),
                                        gf.y + rs[h] * (d.y * gp.y - m1[h] - nx1 * m2[h]));
            }
          }
        }
        bf16* dxt = dx + (bn + t0) * C;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (c0 + 8 * j < C && ra + 8 * h < valid)
              *reinterpret_cast<uint32_t*>(dxt + (ra + 8 * h) * C + c0 + 8 * j + tq) = gq[j][h];
      }
    }
  }
  write_sums(dgp_s, C, part_dgpre + ((size_t)b * nparts + part) * C);
}

// part[z][i][j] = Σ_{rows of split z} A[row][i] · Bm[row][j], A (R, K1) and Bm
// (R, K2) row-major bf16, K1 and K2 multiples of 8. A CTA owns 64 × 64
// outputs, warp w the 16 rows i0 + 16w .. of them; both operands' 64-row
// slices stream through a 4-stage cp.async ring (73,728 bytes of dynamic
// shared memory), and the contraction runs along the rows, so A enters
// through ldmatrix.trans (ldsm_at) and B through ldmatrix.trans (ldsm_bt).
// One f32 partial per split, no atomics.
constexpr int WG_LD = 64 + 8;
constexpr int WG_STAGES = 4;
constexpr size_t WG_SMEM = (size_t)WG_STAGES * 2 * ROWS * WG_LD * 2;
__global__ void __launch_bounds__(THREADS)
wgrad_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ part, long R, int K1, int K2, long rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage s: A slice, then B slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = 2 * (lane & 3);
  const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
  const long ra = (long)blockIdx.z * rows_per_split;
  const long rb = min(R, ra + rows_per_split);
  const int S = (int)((rb - ra + ROWS - 1) / ROWS);
  auto load = [&](int s) {  // slice s into stage s % WG_STAGES; always one commit
    if (s < S) {
      bf16* as = ring + (s % WG_STAGES) * 2 * ROWS * WG_LD;
      bf16* bs = as + ROWS * WG_LD;
      for (int e = threadIdx.x; e < ROWS * 8; e += THREADS) {
        const int r = e >> 3, c = (e & 7) * 8;
        const long row = ra + (long)s * ROWS + r;
        const bool oka = row < rb && i0 + c < K1, okb = row < rb && j0 + c < K2;
        mma::cp_async16(as + r * WG_LD + c, A + (oka ? (size_t)row * K1 + i0 + c : 0), oka);
        mma::cp_async16(bs + r * WG_LD + c, Bm + (okb ? (size_t)row * K2 + j0 + c : 0), okb);
      }
    }
    mma::cp_async_commit();
  };
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) load(s);
  for (int s = 0; s < S; ++s) {
    mma::cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // slice s is in; every warp is done with slice s - 1
    load(s + WG_STAGES - 1);
    const bf16* at = ring + (s % WG_STAGES) * 2 * ROWS * WG_LD;
    const bf16* bt = at + ROWS * WG_LD;
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
      uint32_t a[4];
      ldsm_at(a, at + 16 * kk * WG_LD + 16 * warp, WG_LD);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        mma::ldsm_bt(bb, bt + 16 * kk * WG_LD + 16 * jp, WG_LD);
        mma::mma_bf16(acc[2 * jp], a, bb[0], bb[1]);
        mma::mma_bf16(acc[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
  }
  const int i = i0 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j0 + 8 * j + tq;
    if (c < K2) {
      if (i < K1)
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * K1 + i) * K2 + c) =
            make_float2(acc[j][0], acc[j][1]);
      if (i + 8 < K1)
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * K1 + i + 8) * K2 + c) =
            make_float2(acc[j][2], acc[j][3]);
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

inline int launch_pass1_mma(const void* x, const void* dout, const void* g_pre,
                            const void* w_qkv, const void* w_attn, const void* w_out,
                            const void* b_out, const void* g_out, void* dy_spill,
                            void* attn_spill, void* part_dw, void* part_dgout,
                            void* part_dbout, int B, int n, int C, int rows, cudaStream_t st) {
  using linattn::bf16;
  if (!linattn::aligned16({x, dout, g_pre, w_qkv, w_out, b_out, g_out, dy_spill, attn_spill}))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = tc::pass1_smem(C);
  int err = set_smem(tc::pass1_mma_kernel, smem);
  if (err) return err;
  dim3 grid((n + rows - 1) / rows, B);
  tc::pass1_mma_kernel<<<grid, linattn::THREADS, smem, st>>>(
      (const bf16*)x, (const bf16*)dout, (const bf16*)g_pre, (const bf16*)w_qkv,
      (const float*)w_attn, (const bf16*)w_out, (const bf16*)b_out, (const bf16*)g_out,
      (bf16*)dy_spill, (bf16*)attn_spill, (float*)part_dw, (float*)part_dgout,
      (float*)part_dbout, n, C, rows);
  return (int)cudaGetLastError();
}

inline int launch_pass2_mma(const void* x, const void* dout, const void* g_pre,
                            const void* w_qkv, const void* w_attn, const void* w_out,
                            const void* dctx, const void* ds, const void* m,
                            const void* dy_spill, void* dx, void* xn_spill, void* dqkv_spill,
                            void* part_dgpre, int B, int n, int C, int rows, cudaStream_t st) {
  using linattn::bf16;
  if (!linattn::aligned16({x, dout, g_pre, w_qkv, w_out, dy_spill, dx, xn_spill, dqkv_spill}))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = tc::pass2_smem(C);
  auto kernel = tc::pass2_mma_kernel;
  int err = set_smem(kernel, smem);
  if (err) return err;
  dim3 grid((n + rows - 1) / rows, B);
  kernel<<<grid, linattn::THREADS, smem, st>>>(
      (const bf16*)x, (const bf16*)dout, (const bf16*)g_pre, (const bf16*)w_qkv,
      (const float*)w_attn, (const bf16*)w_out, (const float*)dctx, (const float*)ds,
      (const float*)m, (const bf16*)dy_spill, (bf16*)dx, (bf16*)xn_spill, (bf16*)dqkv_spill,
      (float*)part_dgpre, n, C, rows);
  return (int)cudaGetLastError();
}

inline int launch_wgrad_mma(const void* a, const void* bm, void* part, long R, int K1, int K2,
                            long rows_per_split, dim3 grid, cudaStream_t st) {
  using linattn::bf16;
  if (K1 % 8 || K2 % 8) return (int)cudaErrorInvalidValue;
  if (!linattn::aligned16({a, bm})) return (int)cudaErrorMisalignedAddress;
  int err = set_smem(tc::wgrad_mma_kernel, tc::WG_SMEM);
  if (err) return err;
  tc::wgrad_mma_kernel<<<grid, linattn::THREADS, tc::WG_SMEM, st>>>(
      (const bf16*)a, (const bf16*)bm, (float*)part, R, K1, K2, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace wrap_bwd
}  // namespace daclip

using namespace daclip::wrap_bwd;

// f32 tiles are 64 rows up to C = 256 and 32 rows above, so pass 2's shared
// memory stays under the 227 KB a CTA may use; bf16 tiles are 64 rows at every
// C (pass 2 takes 224,768 bytes at C = 512).
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
  if (is_bf16)
    return launch_pass1_mma(x, dout, g_pre, w_qkv, w_attn, w_out, b_out, g_out, dy_spill,
                            attn_spill, part_dw, part_dgout, part_dbout, B, n, C, rows, st);
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
  if (is_bf16)
    return launch_pass2_mma(x, dout, g_pre, w_qkv, w_attn, w_out, dctx, ds, m, dy_spill, dx,
                            xn_spill, dqkv_spill, part_dgpre, B, n, C, rows, st);
  return C <= 256 ? DACLIP_PASS2(float, 8) : DACLIP_PASS2(float, 4);
#undef DACLIP_PASS2
}

// part (splits, K1, K2) f32; rows_per_split a multiple of 32; in bf16 K1 and
// K2 multiples of 8.
extern "C" int daclip_wrap_wgrad(const void* a, const void* bm, void* part, long R, int K1,
                                 int K2, long rows_per_split, int splits, int is_bf16,
                                 void* stream) {
  if (R < 1 || splits < 1 || rows_per_split % 32) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  dim3 grid((K2 + 63) / 64, (K1 + 63) / 64, splits);
  if (is_bf16) return launch_wgrad_mma(a, bm, part, R, K1, K2, rows_per_split, grid, st);
  wgrad_kernel<float><<<grid, NT, 0, st>>>((const float*)a, (const float*)bm, (float*)part, R,
                                           K1, K2, rows_per_split);
  return (int)cudaGetLastError();
}
