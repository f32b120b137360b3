// Backward of the non-causal flash self-attention on the packed (B, N, H·D)
// layout, Hopper.
//
// Replaces the Pallas TPU kernel `flash_self_attention_bwd_pallas`
// (daclip_tpu/ops/flash_attention.py:199, body `_bwd_kernel` :104), the
// FlashAttention-2 backward. Per head, with P = softmax(q·kᵀ·s), s = D^-½:
//   dsum = rowsum(dO ∘ O)                   (f32, per query)
//   dS   = P ∘ (dO·vᵀ − dsum) · s           (rounded to T, as the TPU kernel)
//   dQ   = dS·K                             (f32 sum, cast once)
//   dK   = dSᵀ·Q,  dV = round(P)ᵀ·dO        (f32 sums, cast once)
// P is rebuilt from the forward's log-sum-exp: P = exp(q·kᵀ·s − lse).
//
// What bounds it on an H100: at the mid/up3 sites of a 256² training step
// (B=16, N=1024, H=16, D=32, bf16) it reads q, k, v, O, dO and writes dq, dk,
// dv: 8·B·N·H·D·2 B ≈ 134 MB, ≈40 µs at 3.35 TB/s; it does the four N²·D
// products (q·kᵀ and dO·vᵀ rebuilt, dS·K, dSᵀ·Q, Pᵀ·dO: 5·2·N²·D per head)
// ≈ 86 GFLOP, ≈87 µs on the bf16 tensor cores, so the operations bound it.
// This first version does its products with scalar FMA in f32 (67 TFLOP/s
// peak, ≥1.3 ms there); tensor-core products are the next step, as for the
// forward.
//
// Design: the TPU kernel held all of K, V and f32 dK/dV of one batch element
// in VMEM and walked the query blocks in order. Hopper blocks run in no order,
// so the two reductions go to two launches that need no atomics:
//   dsum  one warp per (b, query, head);
//   dq    one CTA per (64-query block, head, b), 4 threads per query each
//         taking every 4th key of a 64-key tile staged in shared memory (the
//         forward's layout); the 4 partial dq rows merge by warp shuffles;
//   dkv   one CTA per (64-key block, head, b), 4 threads per key each owning
//         a quarter of D of that key's k, v, dk, dv in registers; the CTA
//         walks every 64-query tile of q and dO in shared memory, and the
//         quarters of each dot product merge by two shuffles.
#include "common.cuh"

namespace daclip {
namespace flash_bwd {

constexpr int BQ = 64;   // queries per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // 4 threads per query (dq) or per key (dkv)

template <typename T>
__global__ void __launch_bounds__(NT)
dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
            int N, int H, int D, long rows) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long bn = row / H;
  const int h = (int)(row - bn * H);
  const size_t base = (size_t)bn * H * D + (size_t)h * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f(o[base + d]) * to_f(dout[base + d]);
  acc = warp_sum(acc);
  const long b = bn / N, n = bn - b * N;
  if (lane == 0) dsum[((size_t)b * H + h) * N + n] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, T* __restrict__ dq, int N, int H, float scale) {
  constexpr int LD = D + 1;  // padded rows: the 4 key phases hit distinct banks
  __shared__ float ks[BK * LD];
  __shared__ float vs[BK * LD];
  const int tid = threadIdx.x, qi = tid >> 2, ph = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = (size_t)b * N * HD + (size_t)h * D;
  const int qrow = blockIdx.x * BQ + qi;
  const bool valid = qrow < N;

  float qv[D], dov[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = valid ? to_f(q[base + (size_t)qrow * HD + d]) : 0.f;
    dov[d] = valid ? to_f(dout[base + (size_t)qrow * HD + d]) : 0.f;
    acc[d] = 0.f;
  }
  const size_t srow = ((size_t)b * H + h) * N + (valid ? qrow : 0);
  const float L = lse[srow], dsm = dsum[srow];

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
#pragma unroll 2
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int kr = jj * 4 + ph;
      if (k0 + kr >= N) break;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += qv[d] * ks[kr * LD + d];
        dp += dov[d] * vs[kr * LD + d];
      }
      const float p = expf(s * scale - L);
      const float ds = round_t<T>(p * (dp - dsm) * scale);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += ds * ks[kr * LD + d];
    }
  }
  // merge the 4 key phases of this query (adjacent lanes)
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d];
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    if ((d & 3) == ph && valid) dq[base + (size_t)qrow * HD + d] = from_f<T>(a);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int N,
           int H, float scale) {
  constexpr int DQ = D / 4;  // dims of one key each thread owns
  __shared__ float qs[BQ * D];
  __shared__ float dos[BQ * D];
  __shared__ float ls[BQ];
  __shared__ float dss[BQ];
  const int tid = threadIdx.x, kk = tid >> 2, ph = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = (size_t)b * N * HD + (size_t)h * D;
  const int key = blockIdx.x * BK + kk;
  const bool valid = key < N;
  const int d0 = ph * DQ;

  float kv[DQ], vv[DQ], dka[DQ], dva[DQ];
#pragma unroll
  for (int d = 0; d < DQ; ++d) {
    kv[d] = valid ? to_f(k[base + (size_t)key * HD + d0 + d]) : 0.f;
    vv[d] = valid ? to_f(v[base + (size_t)key * HD + d0 + d]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }
  const size_t srow0 = ((size_t)b * H + h) * N;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    const int nq = min(BQ, N - q0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BQ * D; e += NT) {
      const int r = e / D, d = e - r * D;
      float a = 0.f, g = 0.f;
      if (r < nq) {
        a = to_f(q[base + (size_t)(q0 + r) * HD + d]);
        g = to_f(dout[base + (size_t)(q0 + r) * HD + d]);
      }
      qs[e] = a;
      dos[e] = g;
    }
    if (tid < BQ) {
      ls[tid] = tid < nq ? lse[srow0 + q0 + tid] : 0.f;
      dss[tid] = tid < nq ? dsum[srow0 + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      const float* qr = qs + r * D + d0;
      const float* gr = dos + r * D + d0;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DQ; ++d) {
        s += qr[d] * kv[d];
        dp += gr[d] * vv[d];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float p = expf(s * scale - ls[r]);
      const float ds = round_t<T>(p * (dp - dss[r]) * scale);
      const float pb = round_t<T>(p);
#pragma unroll
      for (int d = 0; d < DQ; ++d) {
        dka[d] += ds * qr[d];
        dva[d] += pb * gr[d];
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < DQ; ++d) {
      dk[base + (size_t)key * HD + d0 + d] = from_f<T>(dka[d]);
      dv[base + (size_t)key * HD + d0 + d] = from_f<T>(dva[d]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* dsum, void* dq, void* dk, void* dv, int B, int N, int H,
           float scale, cudaStream_t st) {
  const long rows = (long)B * N * H;
  dsum_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)dsum, N, H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  dq_kernel<T, D><<<grid, NT, 0, st>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                       (const float*)lse, (const float*)dsum, (T*)dq, N, H,
                                       scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 kgrid((N + BK - 1) / BK, H, B);
  dkv_kernel<T, D><<<kgrid, NT, 0, st>>>((const T*)q, (const T*)k, (const T*)v,
                                         (const T*)dout, (const float*)lse, (const float*)dsum,
                                         (T*)dk, (T*)dv, N, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd
}  // namespace daclip

// dsum is (B, H, N) f32 scratch; lse is the forward's (B, H, N) log-sum-exp.
extern "C" int daclip_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dsum, void* dq,
                                void* dk, void* dv, int B, int N, int H, int D, float scale,
                                int is_bf16, void* stream) {
  using namespace daclip::flash_bwd;
  auto st = (cudaStream_t)stream;
  if (N < 1 || H < 1 || B < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (D == 32)
    return is_bf16 ? launch<__nv_bfloat16, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, N,
                                               H, scale, st)
                   : launch<float, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, N, H,
                                       scale, st);
  if (D == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, N,
                                               H, scale, st)
                   : launch<float, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, N, H,
                                       scale, st);
  return (int)cudaErrorInvalidValue;
}
