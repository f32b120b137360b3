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
// Design: an implicit GEMM. M is the output pixels, N is O, K is 9·C walked
// as channel slices with the nine taps inside each slice. For each slice a
// CTA stages its tile's halo strip, (rows + 2) × (cols + 2) pixels, in shared
// memory once and reads all nine taps from it: the TPU kernel's overlapping
// row strip, which cuts global reads about 9× against a gather per tap. The
// image border and channels past C are zero-filled by predication (no padded
// copy in device memory), and so are the weights past C and O.
//
// bf16 (`conv_wgmma_kernel`): CTA tiles of TM output pixels (rows of 64, or
// of 32 when W ≤ 32) × 64 outputs, one warpgroup per 64 pixels, products on
// wgmma m64n64k16 with f32 accumulators in registers. A 16-pixel run never
// crosses a tile row, so tap (dy, dx) of a warp's 16 pixels is 16 consecutive
// strip pixels: the A operand is one ldmatrix straight out of the strip
// (pixel stride padded to BK + 8 channels, so the ldmatrix is free of bank
// conflicts); the B operand, the tap's (16 × 64) weight slice, is read by the
// tensor cores from shared memory in the 128-byte swizzle. Slices of 32
// channels (the strip and the nine weight slices) stream through a cp.async
// ring, one barrier a slice. A CTA is persistent: one wave of CTAs walks the
// pixel tiles, its (tile, slice) steps one ring, so the next tile's first
// slices load while this tile's last ones multiply, and each tile's
// accumulators go from registers to y, rounded once. Where a wave holds
// fewer than half the card's CTA slots, the K slices are instead split over
// a thread block cluster of 2, 4 or 8 CTAs a tile, whose f32 partials are
// summed through distributed shared memory in rank order and rounded once.
// Two tile shapes, picked by the launcher from the grid (chosen by sweeps
// on the H100): Large, 256 pixels (4 warpgroups, 2 stages, 138,240 B of
// dynamic shared memory, 120 registers a thread), and Small, 128 pixels (2
// warpgroups, 3 stages, 176,128 B, 160 registers) for small grids; no spill
// (ptxas -v, sm_90a). No atomics: every output is summed in one fixed order,
// so the result repeats bit for bit.
//
// f32 (`conv_kernel_f32`): CTA tiles of 64 pixels × 64 outputs, 32-channel
// slices, scalar FMA, 4×4 outputs a thread, in full f32 like the plain
// version (tensor cores would round the operands to TF32).
#include <algorithm>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace daclip {
namespace conv3x3 {

constexpr size_t round_up(size_t n, size_t a) { return (n + a - 1) / a * a; }
constexpr size_t round128(size_t n) { return round_up(n, 128); }

struct Geom {
  int B, H, W, C, O;
  int tr, tc;              // the tile's rows and columns
  int tiles_h, tiles_w;    // tiles along H and W
  bool vec_x, vec_w, vec_y;  // 16-byte loads/stores are legal on x, w, y
};

// The CTA's tile: batch b, first output row h0 and column w0.
struct Tile {
  int b, h0, w0;
};

// Pixel tile i, in (batch, tile row, tile column) order.
__device__ __forceinline__ Tile tile_at(const Geom& g, int i) {
  const int tw = i % g.tiles_w, rest = i / g.tiles_w;
  const int th = rest % g.tiles_h;
  return {rest / g.tiles_h, th * g.tr, tw * g.tc};
}

__device__ __forceinline__ Tile tile_of(const Geom& g) { return tile_at(g, blockIdx.x); }

// -- bf16: tensor cores ---------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;  // outputs of a tile: one swizzled 128-byte weight row

// A tile shape: TM pixels (TM / 64 warpgroups), slices of BK channels,
// STAGES slices in flight.
template <int TM_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int TM = TM_, BK = BK_, STAGES = STAGES_;
  static constexpr int THREADS = 2 * TM;  // a warp per 16 pixels
  static constexpr int LDS = BK + 8;      // strip pixel stride, elements (48 or 80 B)
  static constexpr int LDF = BN + 4;      // f32 partial tile row stride
  // the larger halo of the two tile shapes: rows of 64, or of 32
  static constexpr int STRIP_PIX = (TM / 64 + 2) * 66 > (TM / 32 + 2) * 34
                                       ? (TM / 64 + 2) * 66 : (TM / 32 + 2) * 34;
  static constexpr int SCH = BK / 8, WCH = BN / 8;  // 16-byte chunks of a pixel, a weight row
  static constexpr int SITER = (STRIP_PIX * SCH + THREADS - 1) / THREADS;
  static constexpr int WITER = (9 * BK * WCH + THREADS - 1) / THREADS;
  // every region 1024-byte aligned, as the 128-byte swizzle's atoms must be
  static constexpr size_t STRIP = round_up(STRIP_PIX * LDS * 2, 1024);
  static constexpr size_t STAGE = STRIP + round_up(9 * BK * BN * 2, 1024);
  static constexpr size_t SMEM = STAGES * STAGE + 1024;  // + room to align the base
  static_assert(TM * LDF * 4 <= STAGES * STAGE, "the f32 partial tile reuses the ring");
  static_assert(TM % 64 == 0 && BK % 16 == 0, "tile shape");
};

// Slice `c0` (channels [c0, c0 + BK)) of tile t's halo strip into shared
// memory: cp.async where 16-byte chunks are legal (zero-filled outside the
// image and past C), else element by element with plain stores. `spos`
// holds the strip position (row · 65536 + column) of each strip chunk this
// thread copies, -1 past the strip; it depends on the tile shape only.
template <class K>
__device__ __forceinline__ void load_strip(bf16* __restrict__ strip, const bf16* __restrict__ x,
                                           const Geom& g, const int (&spos)[K::SITER],
                                           const Tile& t, int c0) {
#pragma unroll
  for (int i = 0; i < K::SITER; ++i) {
    if (spos[i] < 0) continue;
    const int e = threadIdx.x + i * K::THREADS, p = e / K::SCH, k = (e % K::SCH) * 8;
    const int hh = t.h0 - 1 + (spos[i] >> 16), ww = t.w0 - 1 + (spos[i] & 0xFFFF), c = c0 + k;
    const bool inside = hh >= 0 && hh < g.H && ww >= 0 && ww < g.W;
    const bf16* src = x + (inside ? (((size_t)t.b * g.H + hh) * g.W + ww) * g.C : 0);
    bf16* dst = strip + p * K::LDS + k;
    if (g.vec_x) {  // C % 8 == 0: a chunk is wholly in range or wholly past C
      const bool ok = inside && c < g.C;
      mma::cp_async16(dst, src + (ok ? c : 0), ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (inside && c + j < g.C) ? src[c + j] : __float2bfloat16_rn(0.f);
    }
  }
}

// The nine (BK × 64) weight slices of channels [c0, c0 + BK) and outputs
// [o0, o0 + 64), row tap·BK + k, in the 128-byte swizzle (row r's 16-byte
// chunk j at chunk j ^ (r % 8)); zero past C and O.
template <class K>
__device__ __forceinline__ void load_weights(bf16* __restrict__ ws, const bf16* __restrict__ w,
                                             const Geom& g, int c0, int o0) {
#pragma unroll
  for (int i = 0; i < K::WITER; ++i) {
    const int e = threadIdx.x + i * K::THREADS;
    if (e >= 9 * K::BK * K::WCH) break;
    const int row = e / K::WCH, j = e % K::WCH;
    const int tap = row / K::BK, c = c0 + row % K::BK, o = o0 + 8 * j;
    const bf16* src = w + ((size_t)tap * g.C + (c < g.C ? c : 0)) * g.O;
    bf16* dst = ws + row * BN + ((j ^ (row & 7)) * 8);
    if (g.vec_w) {  // O % 8 == 0
      const bool ok = c < g.C && o < g.O;
      mma::cp_async16(dst, src + (ok ? o : 0), ok);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dst[k] = (c < g.C && o + k < g.O) ? src[o + k] : __float2bfloat16_rn(0.f);
    }
  }
}

// CTA (x, y, z) computes outputs [64·y, 64·y + 64) of pixel tiles x,
// x + gridDim.x, ... over the channel slices of split z. Without a split
// (gridDim.z = 1) the CTA walks its tiles as one ring of (tile, slice) steps
// and stores each tile from its accumulators, rounded once. With a split each
// CTA takes one tile; the gridDim.z splits of a tile form one thread block
// cluster, which sums their f32 partials through distributed shared memory
// in rank order, rounds once and stores.
template <class K>
__global__ void __launch_bounds__(K::THREADS)
conv_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
                  Geom g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (mma::smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int o0 = blockIdx.y * BN, sw = g.tc + 2, m0 = 16 * warp;
  // element offset of this lane's A row (ldmatrix address) at tap (0, 0)
  const int r0 = m0 / g.tc;
  const int arow = (r0 * sw + (m0 - r0 * g.tc) + (lane & 15)) * K::LDS + (lane >> 4) * 8;
  int spos[K::SITER];
  const int npix = (g.tr + 2) * sw;
#pragma unroll
  for (int i = 0; i < K::SITER; ++i) {
    const int p = (threadIdx.x + i * K::THREADS) / K::SCH;
    spos[i] = p < npix ? (p / sw) << 16 | (p % sw) : -1;
  }
  auto strip_of = [&](int s) { return reinterpret_cast<bf16*>(smem + s * K::STAGE); };
  auto ws_of = [&](int s) { return reinterpret_cast<bf16*>(smem + s * K::STAGE + K::STRIP); };

  float acc[BN / 8][4];  // this warp's 16 pixels × 64 outputs, as n8 tiles
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // this split's channel slices [s0, s0 + nsl); this CTA's tiles and steps
  const int slices = (g.C + K::BK - 1) / K::BK, per = (slices + gridDim.z - 1) / gridDim.z;
  const int s0 = min(slices, (int)blockIdx.z * per), nsl = min(slices, s0 + per) - s0;
  const int tiles = g.tiles_h * g.tiles_w * g.B;
  const int mine = gridDim.z > 1 ? 1 : (tiles - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int steps = mine * nsl;
  auto load_step = [&](int i) {
    if (i < steps) {
      const int ti = i / nsl, sl = i - ti * nsl;
      load_strip<K>(strip_of(i % K::STAGES), x, g, spos, tile_at(g, blockIdx.x + ti * gridDim.x),
                    (s0 + sl) * K::BK);
      load_weights<K>(ws_of(i % K::STAGES), w, g, (s0 + sl) * K::BK, o0);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < K::STAGES - 1; ++s) load_step(s);

  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait<K::STAGES - 2>();
    mma::fence_proxy_async();  // wgmma reads the stage through the async proxy
    __syncthreads();           // step s is in; step s - 1's stage is free
    load_step(s + K::STAGES - 1);
    const bf16* strip = strip_of(s % K::STAGES);
    const bf16* ws = ws_of(s % K::STAGES);
    // per 16 channels of the slice: this warp's A fragments of the nine taps,
    // then the warpgroup's nine products
#pragma unroll
    for (int kc = 0; kc < K::BK; kc += 16) {
      uint32_t a[9][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        mma::ldsm_x4(a[tap], strip + arow + ((tap / 3) * sw + tap % 3) * K::LDS + kc);
      mma::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        mma::wgmma_m64n64(acc, a[tap],
                          mma::wgmma_desc_b128(ws + (tap * K::BK + kc) * BN, 8 * BN * 2));
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
    }
    if (gridDim.z == 1 && s % nsl == nsl - 1) {
      // the tile is done: round once and store from the accumulators
      const Tile t = tile_at(g, blockIdx.x + (s / nsl) * gridDim.x);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + gq + 8 * half;
        const int hh = t.h0 + m / g.tc, ww = t.w0 + m % g.tc;
        if (hh >= g.H || ww >= g.W) continue;
        bf16* row = y + (((size_t)t.b * g.H + hh) * g.W + ww) * g.O;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int o = o0 + 8 * j + 2 * tq;
          const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
          if (g.vec_y) {  // O even: both or neither in range
            if (o < g.O) *reinterpret_cast<uint32_t*>(row + o) = mma::pack_bf16(v0, v1);
          } else {
            if (o < g.O) row[o] = __float2bfloat16_rn(v0);
            if (o + 1 < g.O) row[o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
  }
  if (gridDim.z == 1) return;

  // split: this CTA's f32 partial (the ring is idle), then the cluster's sum:
  // rank r rounds and stores its share of the tile's rows, reading every
  // rank's partial in rank order
  mma::cp_async_wait<0>();
  __syncthreads();
  const Tile t = tile_of(g);
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float* c = part + (m0 + gq) * K::LDF + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(c) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(c + 8 * K::LDF) = make_float2(acc[j][2], acc[j][3]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int rows = K::TM / splits;
  for (int e = threadIdx.x; e < rows * K::WCH; e += K::THREADS) {
    const int m = rank * rows + e / K::WCH, n = (e % K::WCH) * 8;
    const int hh = t.h0 + m / g.tc, ww = t.w0 + m % g.tc, o = o0 + n;
    if (hh >= g.H || ww >= g.W || o >= g.O) continue;
    float v[8] = {};
    for (int r = 0; r < splits; ++r) {
      const float4* src =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + m * K::LDF + n);
      const float4 lo = src[0], hi = src[1];
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
    bf16* dst = y + (((size_t)t.b * g.H + hh) * g.W + ww) * g.O + o;
    if (g.vec_y) {  // O % 8 == 0: all eight are in range
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(mma::pack_bf16(v[0], v[1]), mma::pack_bf16(v[2], v[3]),
                     mma::pack_bf16(v[4], v[5]), mma::pack_bf16(v[6], v[7]));
    } else {
      for (int i = 0; i < 8 && o + i < g.O; ++i) dst[i] = __float2bfloat16_rn(v[i]);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

using Large = Cfg<256, 32, 2>;
using Small = Cfg<128, 32, 3>;

}  // namespace tc

// -- f32: scalar FMA ------------------------------------------------------------
constexpr int TM = 64;   // output pixels of a tile
constexpr int BN = 64;   // output channels of a tile
constexpr int BK = 32;   // input channels of a slice
constexpr int NT = 256;  // threads per CTA
constexpr int MAX_STRIP = 3 * (64 + 2);  // halo pixels of the larger tile shape (1 × 64)
constexpr int LDS_F32 = BK, LDB_F32 = BN;
constexpr size_t STRIP_BYTES_F32 = round128(MAX_STRIP * LDS_F32 * 4);
constexpr size_t SMEM_F32 = STRIP_BYTES_F32 + 9 * BK * LDB_F32 * 4;

// Stage the halo strip of channels [c0, c0 + BK): pixel p of the strip is
// (h0 − 1 + p / sw, w0 − 1 + p % sw), zero outside the image and past C.
__device__ __forceinline__ void load_strip_f32(float* __restrict__ strip,
                                               const float* __restrict__ x, const Geom& g,
                                               const Tile& t, int c0) {
  constexpr int CHUNKS = BK / 4;
  const int sw = g.tc + 2, npix = (g.tr + 2) * sw;
  for (int e = threadIdx.x; e < npix * CHUNKS; e += NT) {
    const int p = e / CHUNKS, k = (e - p * CHUNKS) * 4;
    const int h = t.h0 - 1 + p / sw, w = t.w0 - 1 + p % sw, c = c0 + k;
    float* dst = strip + p * LDS_F32 + k;
    const bool inside = h >= 0 && h < g.H && w >= 0 && w < g.W;
    const float* src = x + (((size_t)t.b * g.H + (inside ? h : 0)) * g.W + (inside ? w : 0)) * g.C + c;
    if (inside && g.vec_x && c < g.C) {  // C % 4 == 0: the whole chunk is in range
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = (inside && c + i < g.C) ? src[i] : 0.f;
    }
  }
}

// Stage the nine (BK × BN) weight slices of channels [c0, c0 + BK) and
// outputs [o0, o0 + BN): row tap·BK + k, zero past C and O.
__device__ __forceinline__ void load_weights_f32(float* __restrict__ ws,
                                                 const float* __restrict__ w, const Geom& g,
                                                 int c0, int o0) {
  constexpr int CHUNKS = BN / 4;
  for (int e = threadIdx.x; e < 9 * BK * CHUNKS; e += NT) {
    const int row = e / CHUNKS, n = (e - row * CHUNKS) * 4;
    const int tap = row / BK, c = c0 + row - tap * BK, o = o0 + n;
    float* dst = ws + row * LDB_F32 + n;
    const float* src = w + ((size_t)tap * g.C + (c < g.C ? c : 0)) * g.O + o;
    if (g.vec_w && c < g.C && o < g.O) {  // O % 4 == 0: the whole chunk is in range
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = (c < g.C && o + i < g.O) ? src[i] : 0.f;
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
    load_strip_f32(strip, x, g, t, c0);
    load_weights_f32(ws, w, g, c0, o0);
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

constexpr int MAX_DEVICES = 64;

__host__ inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Grid and geometry of a launch with tiles of `tm` pixels (rows of 64, or of
// 32 when W ≤ 32) and `bn` outputs; false if the grid is too large.
__host__ inline bool plan(int B, int H, int W, int C, int O, int tm, int bn, int v,
                          const void* x, const void* w, const void* y, Geom& g, dim3& grid) {
  const int tcol = W <= 32 ? 32 : 64, trow = tm / tcol;
  const long tiles_w = (W + tcol - 1) / tcol, tiles_h = (H + trow - 1) / trow;
  const long tiles = (long)B * tiles_h * tiles_w;
  const long otiles = (O + bn - 1) / bn;
  if (tiles > INT_MAX || otiles > 65535) return false;
  g = Geom{B, H, W, C, O, trow, tcol, (int)tiles_h, (int)tiles_w,
           C % v == 0 && aligned16(x), O % v == 0 && aligned16(w), O % v == 0 && aligned16(y)};
  grid = dim3((unsigned)tiles, (unsigned)otiles);
  return true;
}

// Launch tile shape K on `sms` SMs: persistent (one wave of CTAs walking the
// tiles), or, for a grid that fills at most half the card's CTA slots, with
// the K slices split over clusters of 2, 4 or 8 CTAs (at least 4 slices each).
template <class K>
int launch_wgmma(const void* x, const void* w, void* y, int B, int H, int W, int C, int O,
                 int dev, int sms, cudaStream_t st) {
  Geom g;
  dim3 grid;
  if (!plan(B, H, W, C, O, K::TM, tc::BN, 8, x, w, y, g, grid)) return (int)cudaErrorInvalidValue;
  auto kernel = tc::conv_wgmma_kernel<K>;
  // the shared-memory opt-in and the CTAs an SM holds, once a device
  static int resident[MAX_DEVICES] = {};
  cudaError_t err;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev], kernel, K::THREADS,
                                                        K::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const long slots = (long)std::max(resident[dev], 1) * sms;  // CTAs the card holds at once
  int splits = 1;
  const int slices = (C + K::BK - 1) / K::BK;
  while (splits < 8 && (long)grid.x * grid.y * splits * 2 <= slots && slices >= 4 * splits * 2)
    splits *= 2;
  if (splits == 1) grid.x = (unsigned)std::min<long>(grid.x, std::max<long>(1, slots / grid.y));
  grid.z = splits;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(K::THREADS);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                           (__nv_bfloat16*)y, g);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace conv3x3
}  // namespace daclip

using namespace daclip::conv3x3;


// y (B, H, W, O) = the 3×3 SAME convolution of x (B, H, W, C) with w (3, 3, C,
// O), all contiguous and of one type (bf16 if is_bf16, else f32).
extern "C" int daclip_conv3x3(const void* x, const void* w, void* y, int B, int H, int W, int C,
                              int O, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || O < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (!is_bf16) {
    Geom g;
    dim3 grid;
    if (!plan(B, H, W, C, O, TM, BN, 4, x, w, y, g, grid)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        conv_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    conv_kernel_f32<<<grid, NT, SMEM_F32, st>>>((const float*)x, (const float*)w, (float*)y, g);
    return (int)cudaGetLastError();
  }
  // the tile shape from the grid of 256-pixel tiles (measured on the H100's
  // 132 SMs: Large loses to Small below a CTA per SM at C < 128, and below
  // about half a CTA per SM at any C)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static int sm_counts[MAX_DEVICES] = {};
  if (sm_counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sm_counts[dev];
  const int tcol = W <= 32 ? 32 : 64, trow = 256 / tcol;
  const long grid = (long)B * ((H + trow - 1) / trow) * ((W + tcol - 1) / tcol) *
                    ((O + tc::BN - 1) / tc::BN);
  if (grid >= sms || (C >= 128 && 2 * grid >= sms - 8))
    return launch_wgmma<tc::Large>(x, w, y, B, H, W, C, O, dev, sms, st);
  return launch_wgmma<tc::Small>(x, w, y, B, H, W, C, O, dev, sms, st);
}
