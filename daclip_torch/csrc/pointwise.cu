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
// by bytes, as at every UNet site (at up3, R = 1024, K = 768 → O = 512, the
// two are ≈1 µs and ≈0.8 µs; at the training batch, R = 1048576, 0.120 ms of
// bytes). At the serving shapes a tile's K slices walked in series, each
// waiting on its copy, are the time; at up0 and the training batch, the
// bytes.
//
// Design, bf16 (`dual_tma_kernel`): a CTA is WG consumer warpgroups of 64
// rows each and PW producer warps. One producer thread loads each K slice's
// rows (a TMA box of 64 k × 64·WG rows, 128-byte swizzle, from a tensor map
// over x or over skip) and weights (boxes of 64 k × 64 outputs from a map
// over w[:Kx] or w[Kx:]) into a ring of stages with a full and an empty
// mbarrier each; the K slices of x come first, then those of skip, and
// TMA's zero fill past R and past each operand's K stands in for
// predication, so the concat never exists. The consumers run wgmma
// m64n64k16 with both operands in shared memory and f32 accumulators in
// registers, two product groups in flight, releasing a stage once the
// products that read it are done. Two tile shapes: Small, 64 × 64 with the
// column block's weights resident (loaded with the CTA's first tile), whose
// warpgroup rounds a finished tile into a staging tile (the 128-byte
// swizzle) and stores it by TMA while it goes on to the next tile; and
// Large, 256 × 128 with the weights streamed beside the rows, stored from
// its registers. Without a
// split the CTAs are persistent: one wave, each with a fixed column block,
// walks the row tiles as one ring of (tile, slice) steps, so the next
// tile's copies run under this tile's products and stores. With a split,
// each tile's slices are divided over a cluster of 2, 4 or 8 CTAs whose f32
// partials are summed through distributed shared memory in rank order and
// rounded once. The schedule (tile shape, ring depth, split, grid) is
// chosen in Python, `_dual_plan` in daclip_torch/ops/pointwise.py, from
// sweeps on the H100 (scripts/torch_pointwise_conv_hopper.py --sweep):
// splits past one CTA an SM, and split clusters at the serving shapes,
// ran slower than the chain they cut; a ring of four stages (three to eight
// ran within 1.3% at the serving rows, four beat three by 3-8% at the
// training rows); a launch carries a cluster dimension even
// unsplit (1 × 1 × 1: without it the kernel ran 8-15% slower). Where TMA
// cannot take an operand (Kx, Ks or O not a multiple of 8, a base not
// 16-byte aligned), the producer warps (four of them on Small) write it
// element by element, a 16-byte chunk at a time, in the same layout, after
// the producer has issued the step's TMA copies; the stage's full barrier
// then takes two arrivals. A tile's first product overwrites its accumulators
// (scale-d 0), and its first slice is peeled from the slice loop: a loop
// header reached with different numbers of product groups in flight makes
// ptxas wait for every group there (advisory C7517).
// No atomics: every output is summed in one fixed order, so the result
// repeats bit for bit.
//
// Device µs on an "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md;
// scripts/torch_pointwise_conv_hopper.py), the single form, this kernel /
// the cp.async-ring kernel before it / torch.matmul: serving up3 (1024,
// 768 → 512) 8.16 / 13.14 / 5.11, up2 6.88 / 10.05 / 5.32, up1 7.13 / 10.15
// / 5.83, up0 (65536, 128 → 64) 7.58 / 14.25 / 8.04; the training batch's
// up3 38.6 / 49.7 / 23.5, up2 54.5 / 64.3 / 34.4, up1 62.6 / 80.3 / 63.6,
// up0 (1048576, 128 → 64) 145.6 / 150.4 / 144.7. Registers a thread: Small
// 96, SmallE 109, Large 96; no spill (ptxas -v, sm_90a).
//
// f32 (`dual_kernel_f32`): one CTA per 64×64 output tile, K walked in
// 32-deep slices, scalar FMA, 4×4 outputs a thread, in full f32 like the
// plain version (tensor cores would round the operands to TF32).
#include <algorithm>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace daclip {
namespace pointwise {

// -- bf16: wgmma fed by TMA ---------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;                   // outputs of a panel: one 128-byte row
constexpr int BK = 64;                   // depth of a K slice: one 128-byte row
constexpr int BLOCK = 64 * BK * 2;       // 64 rows × 64 k, or 64 k × 64 outputs: 8 KB
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 16 * MAX_STAGES;  // the ring's full and empty barriers
constexpr int RES_SLICES = 16;           // the most K slices a CTA holds resident

struct Geom {
  int R, Kx, Ks, O;
  int nx, ns;          // K slices of x, then of skip
  int row_tiles, splits, stages;
  bool tma_a, tma_w;   // x and skip, w by TMA (else element by element)
  bool tma_y;          // y by TMA stores from a staging tile (Small, O % 8 == 0)
  bool vec_y, vec_y8;  // 4-byte, 16-byte stores of y are legal
};

// A tile shape: WG consumer warpgroups of 64 rows each, NB panels of 64
// outputs, the weights resident (RES: a CTA's column block, loaded with its
// first tile) or streamed through the ring beside the rows; PW producer
// warps (one issues the TMA loads; all of them write an element-path
// operand). MINB: the CTAs an SM the registers must allow, which the plan's
// grid assumes. A resident shape also stages each warpgroup's output tile
// for TMA stores.
template <int WG_, int NB_, bool RES_, int PW_>
struct Cfg {
  static constexpr int WG = WG_, NB = NB_, PW = PW_;
  static constexpr bool RES = RES_;
  static constexpr int BM = 64 * WG, CONSUMERS = 128 * WG, THREADS = CONSUMERS + 32 * PW;
  static constexpr int MINB = WG == 1 ? (PW == 1 ? 4 : 2) : 1;
  static constexpr int A = WG * BLOCK;                      // a stage's rows
  static constexpr int STAGE = A + (RES ? 0 : NB * BLOCK);  // + their weights, streamed
  static constexpr int OUT = RES ? WG * NB * BLOCK : 0;     // the output staging tiles
  static constexpr int LDF = NB * BN + 4;                   // f32 partial row stride
  static constexpr int MIN_STAGES = std::max(2, (BM * LDF * 4 + STAGE - 1) / STAGE);
  // the ring, the resident weights, the staging tiles, the barriers, + 1 KB
  // to align the base
  static constexpr int smem(int stages, int res_slices) {
    return stages * STAGE + (RES ? res_slices * NB * BLOCK : 0) + OUT + BAR_BYTES + 1024;
  }
};

// Element path: the rows [r0, r0 + BM) × k [k0, k0 + 64) of src (rows of K
// elements) into a stage's A block, K-major in the 128-byte swizzle (row r's
// 16-byte chunk c at chunk c ^ (r % 8)), zero past R and K. Thread t of the
// producer warps, a chunk of eight elements at a time, four chunks unrolled.
template <class C>
__device__ __forceinline__ void fill_a(unsigned char* dst, const bf16* __restrict__ src, int K,
                                       int R, int r0, int k0, int t) {
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll 4
  for (int e = t; e < C::BM * 8; e += 32 * C::PW) {
    const int r = e >> 3, c = e & 7, row = r0 + r, k = k0 + 8 * c;
    const bf16* s = src + (size_t)min(row, R - 1) * K;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = tma::pair(row < R && k + 2 * j < K ? s[k + 2 * j] : zero,
                       row < R && k + 2 * j + 1 < K ? s[k + 2 * j + 1] : zero);
    *reinterpret_cast<uint4*>(dst + r * 128 + ((c ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Element path: the weights of k [k0, k0 + 64) of src (K rows of O) and
// outputs [o0, o0 + 64), N-major in the 128-byte swizzle (k-row r's chunk c
// at chunk c ^ (r % 8)), zero past K and O.
template <class C>
__device__ __forceinline__ void fill_w(unsigned char* dst, const bf16* __restrict__ src, int K,
                                       int O, int k0, int o0, int t) {
  const int cw = min(BN, O - o0);
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll 4
  for (int e = t; e < BK * 8; e += 32 * C::PW) {
    const int k = e >> 3, c = e & 7, kk = k0 + k;
    const bf16* s = src + (size_t)min(kk, K - 1) * O + o0 + 8 * c;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = tma::pair(kk < K && 8 * c + 2 * j < cw ? s[2 * j] : zero,
                       kk < K && 8 * c + 2 * j + 1 < cw ? s[2 * j + 1] : zero);
    *reinterpret_cast<uint4*>(dst + k * 128 + ((c ^ (k & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// CTA (x, y, z) computes outputs [64·NB·y, 64·NB·(y + 1)). Persistent
// (splits 1): row tiles x, x + gridDim.x, ..., every K slice of each, as one
// ring of (tile, slice) steps. Split: row tile x, K slices [z·S/splits,
// (z + 1)·S/splits) of the S; the splits of a tile are one thread block
// cluster, which sums their f32 partials through distributed shared memory
// in rank order and rounds once. K slice sl < nx is x's slice sl (weights
// w[:Kx]), else skip's slice sl − nx (weights w[Kx:]).
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
dual_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ts,
                const __grid_constant__ CUtensorMap twx, const __grid_constant__ CUtensorMap tws,
                const __grid_constant__ CUtensorMap ty, const bf16* __restrict__ x,
                const bf16* __restrict__ skip, const bf16* __restrict__ w, bf16* __restrict__ y,
                Geom g) {
  constexpr int NB = C::NB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = tma::smem_addr(smem);
  const int total = g.nx + g.ns, ST = g.stages;
  const bool split = g.splits > 1;
  const int s0 = split ? (int)blockIdx.z * total / g.splits : 0;
  const int s1 = split ? ((int)blockIdx.z + 1) * total / g.splits : total;
  const int mine =
      split ? 1 : (g.row_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int o0 = blockIdx.y * NB * BN;
  const int res_off = ST * C::STAGE;  // the resident weights follow the ring
  const int out_off = res_off + (C::RES ? (s1 - s0) * NB * BLOCK : 0);  // then the staging
  const tma::Ring ring{base + (uint32_t)(out_off + C::OUT), ST};
  // a stage's A block; panel p's weights of K slice sl in step it's stage
  auto w_off = [&](int st, int sl, int p) {
    return C::RES ? res_off + ((sl - s0) * NB + p) * BLOCK : st * C::STAGE + C::A + p * BLOCK;
  };
  const bool elem = !g.tma_a || !g.tma_w;
  DACLIP_STAMP(threadIdx.x == 0, 0);
  if (threadIdx.x == 0) {
    // a stage's full barrier: the TMA bytes' arrival, and the element
    // path's once its writes are in
    ring.init(elem ? 2 : 1, 4 * C::WG);
    tma::mbar_init_fence();
  }
  __syncthreads();
  DACLIP_STAMP(threadIdx.x == 0, 1);
  // the warp index, uniform across the warp as the compiler sees it
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);

  if (warp >= 4 * C::WG) {  // the producer warps: thread 0 issues the TMA loads
    const int t = threadIdx.x - C::CONSUMERS;
    if (t == 0) {
      if (g.tma_a) {
        tma::prefetch_map(&tx);
        if (g.ns) tma::prefetch_map(&ts);
      }
      if (g.tma_w) {
        tma::prefetch_map(&twx);
        if (g.ns) tma::prefetch_map(&tws);
      }
    }
    if (elem || t == 0) {
      int it = 0;
      for (int i = 0; i < mine; ++i) {
        const int r0 = ((int)blockIdx.x + i * (int)gridDim.x) * C::BM;
        const bool load_w = !C::RES || i == 0;  // resident weights come with the first tile
        for (int sl = s0; sl < s1; ++sl, ++it) {
          const int st = it % ST;
          ring.wait_empty(it);
          DACLIP_STAMP(t == 0 && it == 0, 2);
          const bool in_x = sl < g.nx;
          const int k0 = (in_x ? sl : sl - g.nx) * BK, K = in_x ? g.Kx : g.Ks;
          const uint32_t bytes = (g.tma_a ? C::A : 0) + (load_w && g.tma_w ? NB * BLOCK : 0);
          const uint32_t full = ring.full(st);
          if (t == 0) {  // the copies first: they run under the element path's loads
            tma::mbar_expect_tx(full, bytes);
            if (g.tma_a) tma::load_3d(base + st * C::STAGE, in_x ? &tx : &ts, k0, r0, 0, full);
            if (load_w && g.tma_w)
#pragma unroll
              for (int p = 0; p < NB; ++p)
                tma::load_3d(base + w_off(st, sl, p), in_x ? &twx : &tws, o0 + p * BN, k0, 0,
                             full);
          }
          if (elem) {  // the element writes reach wgmma's proxy before their arrival
            if (!g.tma_a) fill_a<C>(smem + st * C::STAGE, in_x ? x : skip, K, g.R, r0, k0, t);
            if (load_w && !g.tma_w)
              for (int p = 0; p < NB; ++p)
                fill_w<C>(smem + w_off(st, sl, p), in_x ? w : w + (size_t)g.Kx * g.O, K, g.O,
                          k0, o0 + p * BN, t);
            DACLIP_STAMP(t == 0 && it == 0, 9);
            mma::fence_proxy_async();
            DACLIP_STAMP(t == 0 && it == 0, 10);
            tma::named_sync(1, 32 * C::PW);
            if (t == 0) tma::mbar_arrive(full);
          }
          DACLIP_STAMP(t == 0 && it == 0, 3);
        }
      }
      DACLIP_STAMP(t == 0, 4);
    }
  } else {  // the consumer warpgroups: warpgroup wg owns rows 64·wg of the tile
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3, wg = warp >> 2;
    // the warpgroup's output staging tiles (TMA stores), and its storing thread
    const uint32_t out = base + out_off + wg * NB * BLOCK;
    const bool storer = (threadIdx.x & 127) == 0;
    float acc[NB][BN / 8][4];  // this warp's 16 rows × 64·NB outputs, as n8 tiles
    int it = 0;
    // the products of K slice sl from step it's stage; a tile's first
    // overwrites the accumulators (scale-d 0)
    auto step = [&](int sl, bool first) {
      const int st = it % ST;
      ring.wait_full(it);
      DACLIP_STAMP(threadIdx.x == 0 && it == 0, 5);
      const uint32_t as = base + st * C::STAGE + wg * BLOCK;
#pragma unroll
      for (int p = 0; p < NB; ++p) mma::fence_regs(acc[p]);
      mma::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int p = 0; p < NB; ++p)
          mma::wgmma_ss64<1>(acc[p], mma::wgmma_desc_sw<128>(as + 32 * kc),
                             mma::wgmma_desc_sw<128>(base + w_off(st, sl, p) + kc * 16 * 128),
                             (first && kc == 0) ? 0 : 1);
      mma::wgmma_commit();
      ++it;
    };
    for (int i = 0; i < mine; ++i) {
      // Two product groups stay in flight. The first slice of a tile is
      // peeled, so that every loop header sees the same number of groups in
      // flight (else ptxas waits for all of them at the header).
      step(s0, true);
      for (int sl = s0 + 1; sl < s1; ++sl) {
        step(sl, false);
        mma::wgmma_wait<1>();  // the step before this one is done: release its stage
#pragma unroll
        for (int p = 0; p < NB; ++p) mma::fence_regs(acc[p]);
        ring.release(it - 2);
      }
      mma::wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NB; ++p) mma::fence_regs(acc[p]);
      ring.release(it - 1);
      DACLIP_STAMP(threadIdx.x == 0 && i == mine - 1, 6);
      if (split) break;
      // the tile is done: round once and store from the accumulators
      const int rt = ((int)blockIdx.x + i * (int)gridDim.x) * C::BM;
      if (C::RES && C::PW == 1 && g.tma_y) {
        // into the staging tiles in the 128-byte swizzle (row r's chunk j at
        // j ^ (r % 8)), then one TMA store a panel; the warpgroup goes on to
        // the next tile while the store runs
        if (storer) tma::bulk_wait_read();  // the last tile's stores have read the staging
        tma::named_sync(3 + wg, 128);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * (warp & 3) + gq + 8 * half;
#pragma unroll
          for (int p = 0; p < NB; ++p)
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
              *reinterpret_cast<uint32_t*>(smem + out_off + (wg * NB + p) * BLOCK + r * 128 +
                                           ((j ^ (r & 7)) << 4) + 4 * tq) =
                  mma::pack_bf16(acc[p][j][2 * half], acc[p][j][2 * half + 1]);
        }
        mma::fence_proxy_async();
        tma::named_sync(3 + wg, 128);
        if (storer) {
#pragma unroll
          for (int p = 0; p < NB; ++p)
            if (o0 + p * BN < g.O)
              tma::store_3d(&ty, out + p * BLOCK, o0 + p * BN, rt + 64 * wg, 0);
          tma::bulk_commit();
        }
        continue;
      }
      const int rw = rt + 16 * warp + gq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rw + 8 * half;
        if (row >= g.R) continue;
        bf16* yr = y + (size_t)row * g.O;
#pragma unroll
        for (int p = 0; p < NB; ++p)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int o = o0 + p * BN + 8 * j + 2 * tq;
            const float v0 = acc[p][j][2 * half], v1 = acc[p][j][2 * half + 1];
            if (g.vec_y) {  // O even: both or neither in range
              if (o < g.O) *reinterpret_cast<uint32_t*>(yr + o) = mma::pack_bf16(v0, v1);
            } else {
              if (o < g.O) yr[o] = __float2bfloat16_rn(v0);
              if (o + 1 < g.O) yr[o + 1] = __float2bfloat16_rn(v1);
            }
          }
      }
    }
    if (C::RES && C::PW == 1 && g.tma_y && !split && storer)
      tma::bulk_wait_read();  // before the CTA leaves
    DACLIP_STAMP(threadIdx.x == 0, 7);
    if (split) {  // this CTA's f32 partial, over the ring once every warpgroup is done
      tma::named_sync(2, C::CONSUMERS);
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int p = 0; p < NB; ++p)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float* c = part + (16 * warp + gq) * C::LDF + p * BN + 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(c) = make_float2(acc[p][j][0], acc[p][j][1]);
          *reinterpret_cast<float2*>(c + 8 * C::LDF) = make_float2(acc[p][j][2], acc[p][j][3]);
        }
    }
  }
  if (!split) return;

  // the cluster's sum: rank r rounds and stores its share of the tile's
  // rows, reading every rank's partial in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int S = g.splits, rank = (int)cluster.block_rank();
  const int rows = C::BM / S, chunks = NB * BN / 8, r0 = (int)blockIdx.x * C::BM;
  float* part = reinterpret_cast<float*>(smem);
  for (int e = threadIdx.x; e < rows * chunks; e += C::THREADS) {
    const int m = rank * rows + e / chunks, n = (e % chunks) * 8;
    const int row = r0 + m, o = o0 + n;
    if (row >= g.R || o >= g.O) continue;
    // every rank's eight partial sums first (the remote loads overlap), then
    // their sum in rank order
    float4 lo[8], hi[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < S) {
        const float4* src =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + m * C::LDF + n);
        lo[r] = src[0];
        hi[r] = src[1];
      }
    float v[8] = {};
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < S) {
        v[0] += lo[r].x; v[1] += lo[r].y; v[2] += lo[r].z; v[3] += lo[r].w;
        v[4] += hi[r].x; v[5] += hi[r].y; v[6] += hi[r].z; v[7] += hi[r].w;
      }
    bf16* dst = y + (size_t)row * g.O + o;
    if (g.vec_y8) {  // O % 8 == 0: all eight are in range
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(mma::pack_bf16(v[0], v[1]), mma::pack_bf16(v[2], v[3]),
                     mma::pack_bf16(v[4], v[5]), mma::pack_bf16(v[6], v[7]));
    } else {
      for (int i = 0; i < 8 && o + i < g.O; ++i) dst[i] = __float2bfloat16_rn(v[i]);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partial
  DACLIP_STAMP(threadIdx.x == 0, 8);
}

// The tile shapes the plan (daclip_torch/ops/pointwise.py `_dual_plan`) picks
// from, by index: 0 Small, 64 × 64 with the weights resident (SmallE: four
// producer warps for an element-path operand); 1 Large, 256 × 128 with the
// weights streamed (its one producer warp also writes an element-path operand).
using Small = Cfg<1, 1, true, 1>;
using SmallE = Cfg<1, 1, true, 4>;
using Large = Cfg<4, 2, false, 1>;

}  // namespace tc

// -- f32: scalar FMA ------------------------------------------------------------
constexpr int BM = 64;   // rows of a tile
constexpr int BN = 64;   // output columns of a tile
constexpr int BK = 32;   // depth of a slice
constexpr int NT = 256;  // threads per CTA

// Element (r, k) of the logical concat [x | skip], zero outside.
__device__ __forceinline__ float a_at(const float* __restrict__ x,
                                      const float* __restrict__ skip, int Kx, int Ks, int R,
                                      int r, int k) {
  if (r >= R) return 0.f;
  if (k < Kx) return x[(size_t)r * Kx + k];
  if (k < Kx + Ks) return skip[(size_t)r * Ks + (k - Kx)];
  return 0.f;
}

__device__ __forceinline__ float w_at(const float* __restrict__ w, int K, int O, int k, int c) {
  return (k < K && c < O) ? w[(size_t)k * O + c] : 0.f;
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

constexpr int MAX_DEVICES = 64;

__host__ inline bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// The 3-D map (cols, rows, 1) of a (rows, cols) bf16 matrix with boxes of
// (64, box_rows, 1) in the 128-byte swizzle.
inline cudaError_t encode_matrix(CUtensorMap* map, const void* ptr, long rows, long cols,
                                 int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return tma::encode_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launch the bf16 kernel with tile shape C as the plan says: a ring of
// `stages`, K split over clusters of `splits` CTAs (1: persistent CTAs,
// `grid_x` of them along the row tiles).
template <class C>
int launch_tc(const void* x, const void* skip, const void* w, void* y, int R, int Kx, int Ks,
              int O, int stages, int splits, int grid_x, cudaStream_t st) {
  const int nx = (Kx + tc::BK - 1) / tc::BK, ns = (Ks + tc::BK - 1) / tc::BK, total = nx + ns;
  const int row_tiles = (R + C::BM - 1) / C::BM, cols = (O + C::NB * tc::BN - 1) / (C::NB * tc::BN);
  const int res = (total + splits - 1) / splits;  // the most slices a CTA of the split takes
  if (stages < C::MIN_STAGES || stages > tc::MAX_STAGES || splits < 1 || splits > 8 ||
      (splits & (splits - 1)) != 0 || splits > total || (C::RES && res > tc::RES_SLICES) ||
      grid_x < 1 || grid_x > row_tiles || (splits > 1 && grid_x != row_tiles) || cols > 65535)
    return (int)cudaErrorInvalidValue;
  const tc::Geom g{R, Kx, Ks, O, nx, ns, row_tiles, splits, stages,
               Kx % 8 == 0 && Ks % 8 == 0 && aligned(x, 16) && (!skip || aligned(skip, 16)),
               O % 8 == 0 && aligned(w, 16), C::RES && C::PW == 1 && O % 8 == 0 && aligned(y, 16),
               O % 2 == 0 && aligned(y, 4), O % 8 == 0 && aligned(y, 16)};
  CUtensorMap tx{}, ts{}, twx{}, tws{}, ty{};
  cudaError_t err = cudaSuccess;
  if (g.tma_a) {
    err = encode_matrix(&tx, x, R, Kx, C::BM);
    if (err == cudaSuccess && Ks) err = encode_matrix(&ts, skip, R, Ks, C::BM);
  }
  if (err == cudaSuccess && g.tma_w) {
    err = encode_matrix(&twx, w, Kx, O, tc::BK);
    if (err == cudaSuccess && Ks)
      err = encode_matrix(&tws, (const tc::bf16*)w + (size_t)Kx * O, Ks, O, tc::BK);
  }
  if (err == cudaSuccess && g.tma_y) err = encode_matrix(&ty, y, R, O, 64);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = tc::dual_tma_kernel<C>;
  static bool opted[MAX_DEVICES] = {};  // the shared-memory opt-in, once a device
  if (!opted[dev]) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, cols, splits);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::smem(stages, C::RES ? res : 0);
  cfg.stream = st;
  cfg.attrs = attr;
  // a cluster dimension of 1 × 1 × 1 on an unsplit launch too: without it the
  // kernel ran 8-15% slower at most shapes on the H100 (PERF.md)
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, ts, twx, tws, ty, (const tc::bf16*)x,
                           (const tc::bf16*)skip, (const tc::bf16*)w, (tc::bf16*)y, g);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace pointwise
}  // namespace daclip

using namespace daclip::pointwise;

// y (R, O) = x (R, Kx)·w[:Kx] + skip (R, Ks)·w[Kx:]; skip may be null with Ks = 0.
// Row-major, contiguous; w is (Kx + Ks, O). bf16 takes the plan of
// daclip_torch/ops/pointwise.py `_dual_plan`: tile shape `cfg` (0 Small, 1
// Large), ring depth, cluster split and grid; f32 ignores it.
extern "C" int daclip_dual_conv1x1(const void* x, const void* skip, const void* w, void* y,
                                   long R, int Kx, int Ks, int O, int is_bf16, int cfg,
                                   int stages, int splits, int grid_x, void* stream) {
  if (R < 1 || R > INT_MAX || Kx < 1 || Ks < 0 || O < 1 || (Ks > 0) != (skip != nullptr) ||
      (O + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (!is_bf16) {
    dim3 grid((unsigned)((R + BM - 1) / BM), (O + BN - 1) / BN);
    dual_kernel_f32<<<grid, NT, 0, st>>>((const float*)x, (const float*)skip, (const float*)w,
                                         (float*)y, (int)R, Kx, Ks, O);
    return (int)cudaGetLastError();
  }
  // an operand TMA cannot take (Kx, Ks or O not a multiple of 8, a base not
  // 16-byte aligned) is written element by element by the producer warps
  const bool tma = Kx % 8 == 0 && Ks % 8 == 0 && O % 8 == 0 && aligned(x, 16) &&
                   (!skip || aligned(skip, 16)) && aligned(w, 16);
  if (cfg == 0)
    return tma ? launch_tc<tc::Small>(x, skip, w, y, (int)R, Kx, Ks, O, stages, splits, grid_x, st)
               : launch_tc<tc::SmallE>(x, skip, w, y, (int)R, Kx, Ks, O, stages, splits, grid_x,
                                       st);
  if (cfg == 1)
    return launch_tc<tc::Large>(x, skip, w, y, (int)R, Kx, Ks, O, stages, splits, grid_x, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's dynamic shared memory in bytes: tile shape cfg, a ring of
// `stages`, `res_slices` K slices resident (Small).
extern "C" int daclip_dual_smem(int cfg, int stages, int res_slices) {
  using namespace daclip::pointwise::tc;
  return cfg == 0 ? Small::smem(stages, res_slices) : Large::smem(stages, 0);
}
