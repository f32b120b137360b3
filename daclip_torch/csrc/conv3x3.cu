// 3×3, stride-1, SAME (zero-pad 1) convolution without bias, NHWC, Hopper.
//
// Replaces the Pallas TPU kernel `conv3x3_pallas` (daclip_tpu/ops/conv3x3.py:64;
// body `_kernel` :43): x (B, H, W, C), w (3, 3, C, O) in x's type T →
// y (B, H, W, O), the nine shifted (pixels, C)·(C, O) products summed in f32
// and rounded once to T. T is bf16 (production) or f32.
//
// What bounds it on an H100: at the UNet's level-0 site (1, 256², 64 → 64,
// bf16) it computes 2·65536·9·64·64 = 4.83 GFLOP, ≈4.9 µs on the bf16 tensor
// cores (989 TFLOP/s), and must move x, y and w once, 16.8 MB, ≈5.0 µs at
// 3.35 TB/s: balanced. So a kernel near its bound reads each input pixel once
// from device memory and keeps the products on the tensor cores.
//
// Design: an implicit GEMM. M is the output pixels, a CTA tile of 64 along a
// row (2 rows × 32 when W ≤ 32); N is O in tiles of 64; K is 9·C, walked as
// 32-deep channel slices with the nine taps inside each slice. For each slice
// the CTA stages the tile's halo strip, (rows + 2) × (cols + 2) pixels × 32
// channels, in shared memory once, and reads all nine taps from it: the TPU
// kernel's overlapping row strip, which cuts global reads about 9× against a
// gather per tap. The image border and channels past C are zero-filled by
// predication (no padded copy in device memory); the nine 32×64 weight slices
// of the slice, zero past C and O, sit beside it. bf16 takes warp-level
// tensor-core products (wmma 16×16×16, mma.sync underneath) with f32
// accumulators; f32 takes scalar FMA, 4×4 outputs a thread, in full f32 like
// the plain version. This first version neither double-buffers the slices nor
// uses wgmma, TMA or persistent CTAs.
#include <climits>
#include <cstdint>

#include <mma.h>

#include "common.cuh"

namespace daclip {
namespace conv3x3 {

constexpr int TM = 64;   // output pixels of a tile
constexpr int BN = 64;   // output channels of a tile
constexpr int BK = 32;   // input channels of a slice
constexpr int NT = 256;  // threads per CTA (8 warps)
constexpr int MAX_STRIP = 3 * (64 + 2);  // halo pixels of the larger tile shape (1 × 64)

// Row strides in elements. bf16: a strip pixel's 32 channels padded to 48
// (96 B, so every pixel, and with it every tap's A fragment, is 32-byte
// aligned as wmma needs), a weight row of 64 outputs padded to 72, the f32
// epilogue tile to 68. f32: unpadded.
constexpr int LDS_BF16 = BK + 16, LDB_BF16 = BN + 8, LDC = BN + 4;
constexpr int LDS_F32 = BK, LDB_F32 = BN;

constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }
constexpr size_t STRIP_BYTES_BF16 = round128(MAX_STRIP * LDS_BF16 * 2);
constexpr size_t SMEM_BF16 = STRIP_BYTES_BF16 + 9 * BK * LDB_BF16 * 2;
constexpr size_t STRIP_BYTES_F32 = round128(MAX_STRIP * LDS_F32 * 4);
constexpr size_t SMEM_F32 = STRIP_BYTES_F32 + 9 * BK * LDB_F32 * 4;
static_assert(TM * LDC * 4 <= SMEM_BF16, "the epilogue tile reuses the staging memory");

struct Geom {
  int H, W, C, O;
  int tr, tc;              // the tile's rows and columns (tr · tc = TM)
  int tiles_h, tiles_w;    // tiles along H and W
  bool vec_x, vec_w, vec_y;  // 16-byte loads/stores are legal on x, w, y
};

// The CTA's tile: batch b, first output row h0 and column w0.
struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_of(const Geom& g) {
  const int tw = blockIdx.x % g.tiles_w, rest = blockIdx.x / g.tiles_w;
  const int th = rest % g.tiles_h;
  return {rest / g.tiles_h, th * g.tr, tw * g.tc};
}

// Stage the halo strip of channels [c0, c0 + BK): pixel p of the strip is
// (h0 − 1 + p / sw, w0 − 1 + p % sw), zero outside the image and past C.
template <typename T>
__device__ __forceinline__ void load_strip(T* __restrict__ strip, int lds,
                                           const T* __restrict__ x, const Geom& g,
                                           const Tile& t, int c0) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int CHUNKS = BK / V;
  const int sw = g.tc + 2, npix = (g.tr + 2) * sw;
  for (int e = threadIdx.x; e < npix * CHUNKS; e += NT) {
    const int p = e / CHUNKS, k = (e - p * CHUNKS) * V;
    const int h = t.h0 - 1 + p / sw, w = t.w0 - 1 + p % sw, c = c0 + k;
    T* dst = strip + p * lds + k;
    const bool inside = h >= 0 && h < g.H && w >= 0 && w < g.W;
    const T* src = x + (((size_t)t.b * g.H + (inside ? h : 0)) * g.W + (inside ? w : 0)) * g.C + c;
    if (inside && g.vec_x && c < g.C) {  // C % V == 0: the whole chunk is in range
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = (inside && c + i < g.C) ? src[i] : from_f<T>(0.f);
    }
  }
}

// Stage the nine (BK × BN) weight slices of channels [c0, c0 + BK) and
// outputs [o0, o0 + BN): row tap·BK + k, zero past C and O.
template <typename T>
__device__ __forceinline__ void load_weights(T* __restrict__ ws, int ldb,
                                             const T* __restrict__ w, const Geom& g, int c0,
                                             int o0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CHUNKS = BN / V;
  for (int e = threadIdx.x; e < 9 * BK * CHUNKS; e += NT) {
    const int row = e / CHUNKS, n = (e - row * CHUNKS) * V;
    const int tap = row / BK, c = c0 + row - tap * BK, o = o0 + n;
    T* dst = ws + row * ldb + n;
    const T* src = w + ((size_t)tap * g.C + (c < g.C ? c : 0)) * g.O + o;
    if (g.vec_w && c < g.C && o < g.O) {  // O % V == 0: the whole chunk is in range
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = (c < g.C && o + i < g.O) ? src[i] : from_f<T>(0.f);
    }
  }
}

// bf16: warp w owns the tile's pixels 16·(w/2).. and outputs 32·(w%2).. as two
// 16×16 accumulator fragments. A 16-pixel run never crosses a tile row
// (tc ∈ {32, 64}), so tap (dy, dx) of the run is 16 consecutive strip pixels:
// a row-major A fragment with the strip's pixel stride.
__global__ void __launch_bounds__(NT)
conv_kernel_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, Geom g) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* strip = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* ws = reinterpret_cast<__nv_bfloat16*>(smem + STRIP_BYTES_BF16);
  auto* cs = reinterpret_cast<float*>(smem);  // the epilogue tile, after the last slice
  const int warp = threadIdx.x >> 5;
  const Tile t = tile_of(g);
  const int o0 = blockIdx.y * BN, sw = g.tc + 2;
  const int m0 = (warp >> 1) * 16, wc = (warp & 1) * 32;
  const int r = m0 / g.tc, c = m0 - r * g.tc;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int c0 = 0; c0 < g.C; c0 += BK) {
    load_strip(strip, LDS_BF16, x, g, t, c0);
    load_weights(ws, LDB_BF16, w, g, c0, o0);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const __nv_bfloat16* a = strip + ((r + dy) * sw + c + dx) * LDS_BF16;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + kk, LDS_BF16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, ws + (tap * BK + kk) * LDB_BF16 + wc + 16 * j, LDB_BF16);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(cs + m0 * LDC + wc, acc[0], LDC, wmma::mem_row_major);
  wmma::store_matrix_sync(cs + m0 * LDC + wc + 16, acc[1], LDC, wmma::mem_row_major);
  __syncthreads();
  // round once and store NHWC, 8 outputs a thread
  for (int e = threadIdx.x; e < TM * BN / 8; e += NT) {
    const int m = e / (BN / 8), n = (e - m * (BN / 8)) * 8;
    const int h = t.h0 + m / g.tc, ww = t.w0 + m % g.tc, o = o0 + n;
    if (h >= g.H || ww >= g.W || o >= g.O) continue;
    const float* src = cs + m * LDC + n;
    __nv_bfloat16* dst = y + (((size_t)t.b * g.H + h) * g.W + ww) * g.O + o;
    if (g.vec_y) {  // O % 8 == 0: all eight are in range
      unsigned u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(src[2 * i])) |
               ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(src[2 * i + 1])) << 16);
      *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      for (int i = 0; i < 8 && o + i < g.O; ++i) dst[i] = __float2bfloat16_rn(src[i]);
    }
  }
}

// f32: thread (ty, tx) = (tid/16, tid%16) owns the tile's pixels 4·ty.. (one
// tile row: tc is a multiple of 4) and outputs 4·tx.. .
__global__ void __launch_bounds__(NT)
conv_kernel_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* strip = reinterpret_cast<float*>(smem);
  auto* ws = reinterpret_cast<float*>(smem + STRIP_BYTES_F32);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Tile t = tile_of(g);
  const int o0 = blockIdx.y * BN, sw = g.tc + 2;
  const int r = 4 * ty / g.tc, c = 4 * ty - r * g.tc;
  float acc[4][4] = {};
  for (int c0 = 0; c0 < g.C; c0 += BK) {
    load_strip(strip, LDS_F32, x, g, t, c0);
    load_weights(ws, LDB_F32, w, g, c0, o0);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const float* a = strip + ((r + dy) * sw + c + dx) * LDS_F32;
      const float* b = ws + tap * BK * LDB_F32 + 4 * tx;
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float av[4] = {a[k], a[LDS_F32 + k], a[2 * LDS_F32 + k], a[3 * LDS_F32 + k]};
        const float4 bq = *reinterpret_cast<const float4*>(b + k * LDB_F32);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = t.h0 + r, ww = t.w0 + c + i;
    if (h >= g.H || ww >= g.W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * tx + j;
      if (o < g.O) y[(((size_t)t.b * g.H + h) * g.W + ww) * g.O + o] = acc[i][j];
    }
  }
}

__host__ inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace conv3x3
}  // namespace daclip

using namespace daclip::conv3x3;

// y (B, H, W, O) = the 3×3 SAME convolution of x (B, H, W, C) with w (3, 3, C,
// O), all contiguous and of one type (bf16 if is_bf16, else f32).
extern "C" int daclip_conv3x3(const void* x, const void* w, void* y, int B, int H, int W, int C,
                              int O, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || O < 1) return (int)cudaErrorInvalidValue;
  const int tc = W <= 32 ? 32 : 64, tr = TM / tc;
  const long tiles_w = (W + tc - 1) / tc, tiles_h = (H + tr - 1) / tr;
  const long tiles = (long)B * tiles_h * tiles_w;
  const int otiles = (O + BN - 1) / BN;
  if (tiles > INT_MAX || otiles > 65535) return (int)cudaErrorInvalidValue;
  const int v = is_bf16 ? 8 : 4;  // elements in 16 bytes
  const Geom g{H, W, C, O, tr, tc, (int)tiles_h, (int)tiles_w,
               C % v == 0 && aligned16(x), O % v == 0 && aligned16(w),
               O % v == 0 && aligned16(y)};
  const dim3 grid((unsigned)tiles, (unsigned)otiles);
  auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(conv_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    conv_kernel_bf16<<<grid, NT, SMEM_BF16, st>>>((const __nv_bfloat16*)x,
                                                  (const __nv_bfloat16*)w, (__nv_bfloat16*)y, g);
  } else {
    err = cudaFuncSetAttribute(conv_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    conv_kernel_f32<<<grid, NT, SMEM_F32, st>>>((const float*)x, (const float*)w, (float*)y, g);
  }
  return (int)cudaGetLastError();
}
