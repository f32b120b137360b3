// 1×1 convolution over a logical concat(x, skip), without the concat, Hopper.
//
// Replaces the Pallas TPU kernels of `dual_conv1x1` (daclip_tpu/ops/
// pointwise.py:121; bodies `_dual_kernel` :37 and `_single_kernel` :46):
//   y (R, O) = x (R, Kx) · w[:Kx] + skip (R, Ks) · w[Kx:]     (Ks = 0: y = x · w)
// over the R = B·H·W pixels of channels-last activations, f32 accumulation
// and one rounding to T at the end. T is bf16 (production) or f32.
//
// What bounds it on an H100: at up0, serving (R = 65536, K = 128 → O = 64,
// bf16) it must move (R·K + R·O + K·O)·2 B = 25.2 MB, ≈7.5 µs at 3.35 TB/s,
// and compute 2·R·K·O = 1.07 GFLOP, ≈1.1 µs on the bf16 tensor cores: bound
// by bytes. At up3 (R = 1024, K = 768 → O = 512) the two are ≈1 µs and
// ≈0.8 µs. So a kernel near its bound streams x once and keeps the product
// on the tensor cores.
//
// Design: one CTA per 64×64 output tile walks K in 32-deep slices staged in
// shared memory; a slice's rows come from x or from skip by its place along
// K (two A pointers split along K), so the concat never exists. bf16 takes
// warp-level tensor-core products (wmma 16×16×16, mma.sync underneath) with
// f32 accumulators; f32 takes scalar FMA, 4×4 outputs a thread, in full f32
// like the plain version. Ragged R, K and O are masked with zeros. This first
// version neither double-buffers the slices nor uses wgmma/TMA.
#include <climits>

#include <mma.h>

#include "common.cuh"

namespace daclip {
namespace pointwise {

constexpr int BM = 64;   // rows of a tile
constexpr int BN = 64;   // output columns of a tile
constexpr int BK = 32;   // depth of a slice
constexpr int NT = 256;  // threads per CTA (8 warps)

// Element (r, k) of the logical concat [x | skip], zero outside.
template <typename T>
__device__ __forceinline__ T a_at(const T* __restrict__ x, const T* __restrict__ skip,
                                  int Kx, int Ks, int R, int r, int k) {
  if (r >= R) return from_f<T>(0.f);
  if (k < Kx) return x[(size_t)r * Kx + k];
  if (k < Kx + Ks) return skip[(size_t)r * Ks + (k - Kx)];
  return from_f<T>(0.f);
}

template <typename T>
__device__ __forceinline__ T w_at(const T* __restrict__ w, int K, int O, int k, int c) {
  return (k < K && c < O) ? w[(size_t)k * O + c] : from_f<T>(0.f);
}

// bf16: 8 warps, warp w owns rows 16·(w/2) and columns 32·(w%2) of the tile
// as two 16×16 accumulator fragments.
__global__ void __launch_bounds__(NT)
dual_kernel_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ skip,
                 const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y, int R,
                 int Kx, int Ks, int O) {
  using namespace nvcuda;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;  // padded row strides
  __shared__ __align__(32) __nv_bfloat16 as[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 bs[BK * LDB];
  __shared__ __align__(32) float cs[BM * LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN, K = Kx + Ks;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, k = e - r * BK;
      as[r * LDA + k] = a_at(x, skip, Kx, Ks, R, r0 + r, k0 + k);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, c = e - k * BN;
      bs[k * LDB + c] = w_at(w, K, O, k0 + k, c0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, as + wr * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bs + kk * LDB + wc + 16 * j, LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(cs + wr * LDC + wc, acc[0], LDC, wmma::mem_row_major);
  wmma::store_matrix_sync(cs + wr * LDC + wc + 16, acc[1], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, c = e - r * BN;
    if (r0 + r < R && c0 + c < O)
      y[(size_t)(r0 + r) * O + c0 + c] = __float2bfloat16_rn(cs[r * LDC + c]);
  }
}

// f32: thread (ty, tx) = (tid/16, tid%16) owns rows 4·ty.. and columns 4·tx..
__global__ void __launch_bounds__(NT)
dual_kernel_f32(const float* __restrict__ x, const float* __restrict__ skip,
                const float* __restrict__ w, float* __restrict__ y, int R, int Kx, int Ks,
                int O) {
  constexpr int LDA = BM + 4;  // as is k-major: as[k][r]
  __shared__ __align__(16) float as[BK * LDA];
  __shared__ __align__(16) float bs[BK * BN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN, K = Kx + Ks;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, k = e - r * BK;
      as[k * LDA + r] = a_at(x, skip, Kx, Ks, R, r0 + r, k0 + k);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, c = e - k * BN;
      bs[k * BN + c] = w_at(w, K, O, k0 + k, c0 + c);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(as + k * LDA + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(bs + k * BN + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < O) y[(size_t)r * O + c] = acc[i][j];
    }
  }
}

}  // namespace pointwise
}  // namespace daclip

using namespace daclip::pointwise;

// y (R, O) = x (R, Kx)·w[:Kx] + skip (R, Ks)·w[Kx:]; skip may be null with Ks = 0.
// Row-major, contiguous; w is (Kx + Ks, O).
extern "C" int daclip_dual_conv1x1(const void* x, const void* skip, const void* w, void* y,
                                   long R, int Kx, int Ks, int O, int is_bf16, void* stream) {
  if (R < 1 || R > INT_MAX || Kx < 1 || Ks < 0 || O < 1 || (Ks > 0) != (skip != nullptr) ||
      (O + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((R + BM - 1) / BM), (O + BN - 1) / BN);
  auto st = (cudaStream_t)stream;
  if (is_bf16)
    dual_kernel_bf16<<<grid, NT, 0, st>>>((const __nv_bfloat16*)x, (const __nv_bfloat16*)skip,
                                          (const __nv_bfloat16*)w, (__nv_bfloat16*)y, (int)R,
                                          Kx, Ks, O);
  else
    dual_kernel_f32<<<grid, NT, 0, st>>>((const float*)x, (const float*)skip,
                                         (const float*)w, (float*)y, (int)R, Kx, Ks, O);
  return (int)cudaGetLastError();
}
