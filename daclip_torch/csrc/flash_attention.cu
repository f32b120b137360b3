// Non-causal flash self-attention on the packed (B, N, H·D) layout, Hopper.
//
// Replaces the Pallas TPU kernel `flash_self_attention_pallas`
// (daclip_tpu/ops/flash_attention.py:68, body `_kernel` :39): per head,
// out = softmax(q·kᵀ·D^-½)·v, read from and written to the head's column
// slice of the packed layout, with no transposes. T is bf16 or f32; logits,
// softmax statistics and the output accumulate in f32, the output is cast
// once.
//
// What bounds it on an H100: at 256², B=1, the mid/up3 sites (N=1024, H=16,
// D=32, bf16) do 4·N²·H·D ≈ 2.1 GFLOP (≈2.2 µs at 989 TFLOP/s) on 4·N·H·D·2
// ≈ 4.2 MB (≈1.3 µs), so the bound is the operations. This first version does
// its products with scalar FMA in f32 (67 TFLOP/s peak, ≥32 µs); mma/wgmma
// products are the next step.
//
// Design: the TPU kernel held all of K/V in VMEM per q-block and took an
// exact softmax. Here FlashAttention-2 style: one CTA per (64-query block,
// head, batch), 256 threads, 4 per query. K/V tiles of 64 keys are staged in
// shared memory; each of a query's 4 threads takes every 4th key of a tile
// and keeps its own running max, sum and f32 output row. At the end the 4
// partial softmaxes merge exactly through warp shuffles. The N×N logits never
// leave registers.
#include "common.cuh"

namespace daclip {
namespace flash {

constexpr int BQ = 64;   // queries per CTA
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // 4 threads per query

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int N, int H, float scale) {
  constexpr int LD = D + 1;  // padded rows: the 4 key phases hit distinct banks
  __shared__ float ks[BK * LD];
  __shared__ float vs[BK * LD];
  const int tid = threadIdx.x, qi = tid >> 2, ph = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = (size_t)b * N * HD + (size_t)h * D;
  const int qrow = blockIdx.x * BQ + qi;

  float qv[D], o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = qrow < N ? to_f(q[base + (size_t)qrow * HD + d]) : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int kr = e / D, d = e - kr * D, key = k0 + kr;
      float kk = 0.f, vv = 0.f;
      if (key < N) {
        kk = to_f(k[base + (size_t)key * HD + d]);
        vv = to_f(v[base + (size_t)key * HD + d]);
      }
      ks[kr * LD + d] = kk;
      vs[kr * LD + d] = vv;
    }
    __syncthreads();
    float s[BK / 4];
    float mt = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int kr = jj * 4 + ph;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc += qv[d] * ks[kr * LD + d];
      s[jj] = k0 + kr < N ? acc * scale : -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    const float mn = fmaxf(m, mt);
    if (mn == -INFINITY) continue;  // no valid key for this thread yet
    const float alpha = expf(m - mn);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const float p = expf(s[jj] - mn);
      const int kr = jj * 4 + ph;
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] += p * vs[kr * LD + d];
    }
    m = mn;
  }

  // merge the 4 key phases of this query (adjacent lanes)
  float M = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
  const float a = m == -INFINITY ? 0.f : expf(m - M);
  l *= a;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float od = o[d] * a;
    od += __shfl_xor_sync(0xffffffffu, od, 1);
    od += __shfl_xor_sync(0xffffffffu, od, 2);
    if ((d & 3) == ph && qrow < N) out[base + (size_t)qrow * HD + d] = from_f<T>(od * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int N, int H,
           float scale, cudaStream_t st) {
  dim3 grid((N + BQ - 1) / BQ, H, B);
  fwd_kernel<T, D><<<grid, NT, 0, st>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, N,
                                        H, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace daclip

extern "C" int daclip_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                int B, int N, int H, int D, float scale, int is_bf16,
                                void* stream) {
  using namespace daclip::flash;
  auto st = (cudaStream_t)stream;
  if (N < 1 || H < 1 || B < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (D == 32)
    return is_bf16 ? launch<__nv_bfloat16, 32>(q, k, v, out, B, N, H, scale, st)
                   : launch<float, 32>(q, k, v, out, B, N, H, scale, st);
  if (D == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, out, B, N, H, scale, st)
                   : launch<float, 64>(q, k, v, out, B, N, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
