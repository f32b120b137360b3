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
// memory-bound there. This first version does its products with scalar FMA
// in f32 (67 TFLOP/s peak), so it is bound by those operations instead
// (≥80 µs at L0); tensor-core products are the next step.
//
// Design: the TPU ran n in order and carried (m, s, ctx) in VMEM across grid
// steps. Here three launches:
//   stats   grid (parts, B): each CTA walks its `rows` rows in 64-row tiles,
//           keeps running (m, s) and only the 4 diagonal 32×32 ctx blocks
//           (the TPU computed 128×128 and masked 3/4 away), writes partials;
//   combine grid (128, B): rescales partials to the global max, folds in
//           32^-½/(s·n), rounds W;
//   apply   grid (⌈n/64⌉, B): LN again, q, per-pixel per-head softmax (the
//           reference's softmax; the TPU's block-global max at :469 can
//           underflow a head), ·W, ·W_out + b_out, LN, + x.
// x is read twice (stats, apply) and written once; the (n, 384) qkv and the
// (n, 128) attention never leave shared memory.
#include "common.cuh"

namespace daclip {
namespace wrap {

constexpr int HID = 128;     // heads · dim_head
constexpr int DH = 32;       // dim_head
constexpr int TILE = 64;     // rows per tile
constexpr int NT = 256;      // threads per CTA (8 warps)
constexpr float LN_EPS = 1e-5f;

// Load a tile of rows [t0, t0+valid) of x (row stride C) into xs as f32 and
// apply the prenorm ChannelLN·g, rounded to T. Rows past `valid` are zero.
template <typename T>
__device__ void load_ln_tile(const T* __restrict__ xb, int t0, int valid, int C,
                             const T* __restrict__ g, float* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE; r += NT / 32) {
    float* row = xs + r * C;
    if (r < valid) {
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

template <typename T>
__global__ void __launch_bounds__(NT)
stats_kernel(const T* __restrict__ x, const T* __restrict__ g_pre,
             const T* __restrict__ w_qkv, float* __restrict__ part_m,
             float* __restrict__ part_s, float* __restrict__ part_ctx, int n, int C,
             int rows) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [TILE][C]     xn
  float* ws = xs + TILE * C;           // [32][256]     staged weights
  float* kv = ws + 32 * 2 * HID;       // [TILE][256]   k | v, then p | v
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
    load_ln_tile<T>(xb, t0, valid, C, g_pre, xs);
    {
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
template <typename T>
__global__ void __launch_bounds__(32)
combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
               const float* __restrict__ part_ctx, float* __restrict__ w_attn,
               int nparts, int n) {
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
  w_attn[(size_t)b * 4 * DH * DH + hh * DH * DH + i * DH + lane] = round_t<T>(acc * rowscale);
}

template <typename T>
__global__ void __launch_bounds__(NT)
apply_kernel(const T* __restrict__ x, const T* __restrict__ g_pre,
             const T* __restrict__ w_qkv, const float* __restrict__ w_attn,
             const T* __restrict__ w_out, const T* __restrict__ b_out,
             const T* __restrict__ g_out, T* __restrict__ out, int n, int C) {
  extern __shared__ float smem[];
  float* xs = smem;              // [TILE][C]   xn, then y
  float* ws = xs + TILE * C;     // [32][128]   staged weights
  float* qs = ws + 32 * HID;     // [TILE][128] q, q_soft, then attn
  float* wa = qs + TILE * HID;   // [4][32][32] W of this batch element

  const int b = blockIdx.y, t0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int valid = min(TILE, n - t0);
  const T* xb = x + (size_t)b * n * C;
  for (int e = tid; e < 4 * DH * DH; e += NT) wa[e] = w_attn[(size_t)b * 4 * DH * DH + e];
  load_ln_tile<T>(xb, t0, valid, C, g_pre, xs);  // ends in __syncthreads

  {
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
    for (int c = lane; c < C; c += 32)
      dst[c] = from_f<T>((row[c] - mean) * rs * to_f(g_out[c]) + to_f(src[c]));
  }
}

inline size_t stats_smem(int C) {
  return (size_t)(TILE * C + 32 * 2 * HID + TILE * 2 * HID + 3 * HID) * sizeof(float);
}
inline size_t apply_smem(int C) {
  return (size_t)(TILE * C + 32 * HID + TILE * HID + 4 * DH * DH) * sizeof(float);
}

template <typename T>
int launch_stats(const void* x, const void* g, const void* w, void* pm, void* ps,
                 void* pc, int B, int n, int C, int rows, cudaStream_t st) {
  const size_t smem = stats_smem(C);
  cudaError_t err = cudaFuncSetAttribute(stats_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + rows - 1) / rows, B);
  stats_kernel<T><<<grid, NT, smem, st>>>((const T*)x, (const T*)g, (const T*)w, (float*)pm,
                                          (float*)ps, (float*)pc, n, C, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const void* g_pre, const void* w_qkv, const void* w_attn,
                 const void* w_out, const void* b_out, const void* g_out, void* out, int B,
                 int n, int C, cudaStream_t st) {
  const size_t smem = apply_smem(C);
  cudaError_t err = cudaFuncSetAttribute(apply_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TILE - 1) / TILE, B);
  apply_kernel<T><<<grid, NT, smem, st>>>((const T*)x, (const T*)g_pre, (const T*)w_qkv,
                                          (const float*)w_attn, (const T*)w_out,
                                          (const T*)b_out, (const T*)g_out, (T*)out, n, C);
  return (int)cudaGetLastError();
}

}  // namespace wrap
}  // namespace daclip

using namespace daclip::wrap;

extern "C" int daclip_wrap_stats(const void* x, const void* g_pre, const void* w_qkv,
                                 void* part_m, void* part_s, void* part_ctx, int B, int n,
                                 int C, int rows, int is_bf16, void* stream) {
  if (C % 32 || C > 512 || rows % TILE || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_stats<__nv_bfloat16>(x, g_pre, w_qkv, part_m, part_s, part_ctx, B,
                                               n, C, rows, st)
                 : launch_stats<float>(x, g_pre, w_qkv, part_m, part_s, part_ctx, B, n, C,
                                       rows, st);
}

extern "C" int daclip_wrap_combine(const void* part_m, const void* part_s,
                                   const void* part_ctx, void* w_attn, int B, int nparts,
                                   int n, int is_bf16, void* stream) {
  auto st = (cudaStream_t)stream;
  dim3 grid(HID, B);
  if (is_bf16)
    combine_kernel<__nv_bfloat16><<<grid, 32, 0, st>>>(
        (const float*)part_m, (const float*)part_s, (const float*)part_ctx, (float*)w_attn,
        nparts, n);
  else
    combine_kernel<float><<<grid, 32, 0, st>>>((const float*)part_m, (const float*)part_s,
                                               (const float*)part_ctx, (float*)w_attn,
                                               nparts, n);
  return (int)cudaGetLastError();
}

extern "C" int daclip_wrap_apply(const void* x, const void* g_pre, const void* w_qkv,
                                 const void* w_attn, const void* w_out, const void* b_out,
                                 const void* g_out, void* out, int B, int n, int C,
                                 int is_bf16, void* stream) {
  if (C % 32 || C > 512 || n < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return is_bf16 ? launch_apply<__nv_bfloat16>(x, g_pre, w_qkv, w_attn, w_out, b_out, g_out,
                                               out, B, n, C, st)
                 : launch_apply<float>(x, g_pre, w_qkv, w_attn, w_out, b_out, g_out, out, B,
                                       n, C, st);
}
