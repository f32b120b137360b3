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
// 3.35 TB/s: balanced. At the 64² and 32² sites the grid is a few dozen
// tiles, and each tile's chain of channel slices is the time.
//
// Design: an implicit GEMM. M is the output pixels, N is O, K is 9·C walked
// as channel slices of 32 with the nine taps inside each slice. For each
// slice a CTA's tile of TM pixels (rows of 64, 32 or 16) takes its halo
// strip, (rows + 2) × (cols + 2) pixels, once and reads all nine taps from
// it: the TPU kernel's overlapping row strip, which cuts global reads about
// 9× against a gather per tap.
//
// bf16 (`conv_tma_kernel`): a CTA is TM / 64 consumer warpgroups and PW
// producer warps. One producer thread loads each slice's strip as one TMA
// box of a 4-D tensor map over x, (C, W, H, B), box (32, cols + 2, rows + 2,
// 1) at (c0, w0 − 1, h0 − 1, b): the out-of-bounds fill gives the SAME
// padding and the channels past C as zeros, with no predication. The box
// lands in the 64-byte swizzle, and the consumers' ldmatrix addresses XOR
// the same bits, so the nine shifted reads stay free of bank conflicts. The
// slice's nine (32 × 64) weight blocks come as one more box, (64, 32, 9)
// of a map over w as (O, C, 9), in the 128-byte swizzle that wgmma reads.
// Strip and weights fill a ring of stages with a full and an empty mbarrier
// each. A warp's 16 pixels never cross a tile row, so tap (dy, dx) of them
// is 16 consecutive strip pixels: the A operand is one ldmatrix; the
// products run on wgmma m64n64k16 with A in registers, B in shared memory
// and f32 accumulators in registers, in groups of a tap row (Large) or all
// nine taps (Small), two groups kept in flight in the source (a slice's
// second k16 step, where it lies wholly past C, is skipped). ptxas
// serializes them all the same (advisory C7513: ldmatrix defines the next
// group's A registers while a group is in flight), so each group waits for
// the last; the CTA's other warpgroups and the ring's copies fill that
// wait. Without a split the CTAs are persistent: one wave walks the pixel
// tiles, each tile's slices one ring of steps, so the next tile's copies
// run under this tile's products and stores. With a split, each tile's
// slices are divided over a cluster of two CTAs whose f32 partials are
// summed through distributed shared memory in rank order and rounded once.
// The schedule (tile shape, row length, split, grid) is chosen in Python,
// `_conv_plan` in daclip_torch/ops/conv3x3.py, from sweeps on the H100
// (scripts/torch_pointwise_conv_hopper.py --sweep): rows of 16 at W = 65 and
// 33 waste the fewest pixels; clusters of four or eight, and clusters past
// one wave, ran slower (the card holds 66 clusters of two of these CTAs at
// once, but only 30 of four and 15 of eight: 120 CTAs). A launch carries a
// cluster dimension even unsplit (1 × 1 × 1), as the dual 1×1's must. The
// strip multicast by TMA to the CTAs of a cluster that share a pixel tile
// across output tiles was built and timed: 1.15-1.24× slower where its clusters
// of two fit one wave (each stage then waits for both CTAs' consumers), and
// 1.16-2.2× at the split 64² and 32² sites, whose clusters of four take two
// waves; not kept. A variant that fed A by descriptor
// from three copies of the strip shifted by a column (no ldmatrix, so no
// C7513) ran 3-12% faster at C ≤ 64 and up to 40% slower elsewhere (it
// moves 2-3× the strip's bytes and holds two stages): not kept. Where TMA
// cannot take x or w (C or O not a multiple of 8, a base not 16-byte
// aligned: the UNet's final conv, 64 → 3), the producer warps write that
// operand element by element, a 16-byte chunk at a time, in the same
// layout, after the producer has issued the step's TMA copies (the stage's
// full barrier then takes two arrivals). No atomics: every output is
// summed in one fixed order, so the result repeats bit for bit.
//
// Device ms on an "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md;
// scripts/torch_pointwise_conv_hopper.py): the 44 sites of one 256²
// serving forward 0.8177 (the cp.async-ring kernel before it 1.0504, cuDNN
// 0.7803, bound 0.2116); against cuDNN 0.67-0.96× at the 256² sites, 0.87-0.95× at 128²,
// 1.19-1.30× at 64² and 1.21-1.44× at 32², where a few dozen CTAs each walk
// a chain of serialized product groups. Registers a thread: Large 96, Small
// 120; dynamic shared memory 188,544 and 218,240 B; no spill (ptxas -v).
//
// f32 (`conv_kernel_f32`): CTA tiles of 64 pixels × 64 outputs, 32-channel
// slices, scalar FMA, 4×4 outputs a thread, in full f32 like the plain
// version (tensor cores would round the operands to TF32).
#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace daclip {
namespace conv3x3 {

constexpr size_t round_up(size_t n, size_t a) { return (n + a - 1) / a * a; }
constexpr size_t round128(size_t n) { return round_up(n, 128); }

// A launch's pixel tiles (the bf16 kernel's geometry extends it).
struct Geom {
  int B, H, W, C, O;
  int tr, tc;              // the tile's rows and columns
  int tiles_h, tiles_w;    // tiles along H and W
  bool vec_x, vec_w, vec_y;  // f32: 16-byte loads/stores legal on x, w, y; bf16 y: 4-byte
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

// -- bf16: wgmma fed by TMA ---------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;                  // outputs of a tile: one 128-byte weight row
constexpr int BK = 32;                  // channels of a slice
constexpr int RB = 2 * BK;              // bytes of a strip pixel: its swizzle is 64-byte
constexpr int WBYTES = 9 * BK * BN * 2;  // a slice's nine (BK × 64) weight blocks: 36 KB
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 16 * MAX_STAGES;  // the ring's full and empty barriers

// The pixels of a halo strip: a tile of tm pixels in rows of tc, plus one
// pixel all round.
constexpr int halo(int tm, int tc) { return (tm / tc + 2) * (tc + 2); }

struct Geom : conv3x3::Geom {
  int slices, splits, stages;  // 32-channel slices; CTAs of a cluster a tile; ring depth
  bool tma_x, tma_w;           // x, w by TMA (else element by element)
  bool vec_y8;                 // 16-byte stores of y are legal
};

// A tile shape: TM = 64·WG pixels (WG consumer warpgroups, one a 64-pixel
// run of the tile), 64 outputs; PW producer warps (one issues the TMA loads;
// all of them write an element-path operand); TG taps a product group (3:
// a tap row, or 9). A stage holds a slice's halo strip, as large as the
// largest of the tile's three layouts (rows of 64, 32 or 16 pixels), and its
// nine weight blocks.
template <int WG_, int PW_, int TG_>
struct Cfg {
  static constexpr int WG = WG_, PW = PW_, TG = TG_;
  static_assert(TG == 3 || TG == 9, "a product group is a tap row or all nine taps");
  static constexpr int TM = 64 * WG, CONSUMERS = 128 * WG, THREADS = CONSUMERS + 32 * PW;
  static constexpr int STRIP_PIX = std::max(halo(TM, 64), std::max(halo(TM, 32), halo(TM, 16)));
  static constexpr int STRIP = (STRIP_PIX * RB + 1023) / 1024 * 1024;
  static constexpr int STAGE = STRIP + WBYTES;
  static constexpr int LDF = BN + 4;  // f32 partial tile row stride
  static constexpr int MIN_STAGES = std::max(2, (TM * LDF * 4 + STAGE - 1) / STAGE);
  // the ring, the barriers, + 1 KB to align the base
  static constexpr int smem(int stages) { return stages * STAGE + BAR_BYTES + 1024; }
};

// Element path of one step, slice c0 of tile t: the halo strip (with_x),
// pixel p at p·RB bytes in the 64-byte swizzle (its 16-byte chunk c at
// chunk c ^ (p / 2 % 4)), zero outside the image and past C; the weights
// (with_w), the nine (BK × 64) blocks of outputs [o0, o0 + 64), row tap·BK
// + k in the 128-byte swizzle (row r's chunk c at chunk c ^ (r % 8)), zero
// past C and O, their chunks wholly past O left as they are (zeroed once,
// at the start). Thread tid of the producer warps, a chunk of eight
// elements at a time, four chunks unrolled; the strip's chunks wholly past
// C take no load.
template <class K>
__device__ __forceinline__ void fill_stage(unsigned char* dst_x, const bf16* __restrict__ x,
                                           bool with_x, unsigned char* dst_w,
                                           const bf16* __restrict__ w, bool with_w,
                                           const Geom& g, const Tile& t, int c0, int o0,
                                           int tid) {
  constexpr int CHUNKS = BK / 8, STEP = 32 * K::PW;
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (with_x) {
    const int sw = g.tc + 2, npix = (g.tr + 2) * sw;
    const int cx = min(CHUNKS, (g.C - c0 + 7) >> 3);  // a pixel's chunks that hold data
#pragma unroll 4
    for (int e = tid; e < npix * cx; e += STEP) {
      const int p = e / cx, c = e % cx, ch = c0 + 8 * c;
      const int hh = t.h0 - 1 + p / sw, ww = t.w0 - 1 + p % sw;
      const bool in = hh >= 0 && hh < g.H && ww >= 0 && ww < g.W;
      const bf16* s = x + (in ? (((size_t)t.b * g.H + hh) * g.W + ww) * g.C + ch : 0);
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = tma::pair(in && ch + 2 * j < g.C ? s[2 * j] : zero,
                         in && ch + 2 * j + 1 < g.C ? s[2 * j + 1] : zero);
      *reinterpret_cast<uint4*>(dst_x + p * RB + ((c ^ ((p >> 1) & 3)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    for (int e = tid; e < npix * (CHUNKS - cx); e += STEP) {  // the chunks past C
      const int p = e / (CHUNKS - cx), c = cx + e % (CHUNKS - cx);
      *reinterpret_cast<uint4*>(dst_x + p * RB + ((c ^ ((p >> 1) & 3)) << 4)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (with_w) {
    const int cw = min(BN, g.O - o0), chunks = (cw + 7) >> 3, n = 9 * BK * chunks;
#pragma unroll 4
    for (int e = tid; e < n; e += STEP) {
      const int row = e / chunks, c = e % chunks, ch = c0 + row % BK;
      const bf16* s = w + ((size_t)(row / BK) * g.C + min(ch, g.C - 1)) * g.O + o0 + 8 * c;
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = tma::pair(ch < g.C && 8 * c + 2 * j < cw ? s[2 * j] : zero,
                         ch < g.C && 8 * c + 2 * j + 1 < cw ? s[2 * j + 1] : zero);
      *reinterpret_cast<uint4*>(dst_w + row * 128 + ((c ^ (row & 7)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// CTA (x, y, z) computes outputs [64·y, 64·y + 64). Persistent (splits 1):
// pixel tiles x, x + gridDim.x, ..., every channel slice of each, as one ring
// of (tile, slice) steps. Split: pixel tile x, slices [z·S/splits, (z +
// 1)·S/splits) of the S; the splits of a tile are one thread block cluster,
// which sums their f32 partials through distributed shared memory in rank
// order and rounds once.
template <class K>
__global__ void __launch_bounds__(K::THREADS, 1)
conv_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
                Geom g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = tma::smem_addr(smem);
  const int ST = g.stages;
  const bool split = g.splits > 1;
  const int s0 = split ? (int)blockIdx.z * g.slices / g.splits : 0;
  const int s1 = split ? ((int)blockIdx.z + 1) * g.slices / g.splits : g.slices;
  const int tiles = g.tiles_h * g.tiles_w * g.B;
  const int mine = split ? 1 : (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int o0 = blockIdx.y * BN;
  const tma::Ring ring{base + (uint32_t)(ST * K::STAGE), ST};
  const bool elem = !g.tma_x || !g.tma_w;
  if (!g.tma_w) {  // the element path leaves the weights' chunks past O unwritten
    for (int st = 0; st < ST; ++st)
      tma::zero_smem(smem + st * K::STAGE + K::STRIP, WBYTES, threadIdx.x, K::THREADS);
    mma::fence_proxy_async();
  }
  DACLIP_STAMP(threadIdx.x == 0, 0);
  if (threadIdx.x == 0) {
    // a stage's full barrier: the TMA bytes' arrival, and the element
    // path's once its writes are in
    ring.init(elem ? 2 : 1, 4 * K::WG);
    tma::mbar_init_fence();
  }
  __syncthreads();
  DACLIP_STAMP(threadIdx.x == 0, 1);
  // the warp index, uniform across the warp as the compiler sees it
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);

  if (warp >= 4 * K::WG) {  // the producer warps: thread 0 issues the TMA loads
    const int t = threadIdx.x - K::CONSUMERS;
    if (t == 0) {
      if (g.tma_x) tma::prefetch_map(&tx);
      if (g.tma_w) tma::prefetch_map(&tw);
    }
    if (elem || t == 0) {
      const uint32_t strip_bytes = (g.tr + 2) * (g.tc + 2) * RB;
      int it = 0;
      for (int i = 0; i < mine; ++i) {
        const Tile tl = tile_at(g, (int)blockIdx.x + i * (int)gridDim.x);
        for (int sl = s0; sl < s1; ++sl, ++it) {
          const int st = it % ST, c0 = sl * BK;
          ring.wait_empty(it);
          DACLIP_STAMP(t == 0 && it == 0, 2);
          const uint32_t bytes = (g.tma_x ? strip_bytes : 0) + (g.tma_w ? WBYTES : 0);
          const uint32_t full = ring.full(st), dst = base + st * K::STAGE;
          if (t == 0) {  // the copies first: they run under the element path's loads
            tma::mbar_expect_tx(full, bytes);
            // the strip's box at (c0, w0 − 1, h0 − 1, b): the image's border
            // and the channels past C come as zeros
            if (g.tma_x) tma::load_4d(dst, &tx, c0, tl.w0 - 1, tl.h0 - 1, tl.b, full);
            if (g.tma_w) tma::load_3d(dst + K::STRIP, &tw, o0, c0, 0, full);
          }
          if (elem) {  // the element writes reach wgmma's proxy before their arrival
            fill_stage<K>(smem + st * K::STAGE, x, !g.tma_x, smem + st * K::STAGE + K::STRIP, w,
                          !g.tma_w, g, tl, c0, o0, t);
            DACLIP_STAMP(t == 0 && it == 0, 9);
            mma::fence_proxy_async();
            DACLIP_STAMP(t == 0 && it == 0, 10);
            tma::named_sync(1, 32 * K::PW);
            if (t == 0) tma::mbar_arrive(full);
          }
          DACLIP_STAMP(t == 0 && it == 0, 3);
        }
      }
      DACLIP_STAMP(t == 0, 4);
    }
  } else {  // the consumer warpgroups: warp w owns the tile's pixels 16w .. 16w + 15
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const int sw = g.tc + 2, m0 = 16 * warp, r0 = m0 / g.tc;
    // this lane's ldmatrix row at tap (0, 0): a strip pixel (a 16-pixel run
    // never crosses a tile row), and its 8-channel chunk in a k16 step
    const int pix0 = r0 * sw + (m0 - r0 * g.tc) + (lane & 15), half = lane >> 4;
    float acc[BN / 8][4];    // this warp's 16 pixels × 64 outputs, as n8 tiles
    uint32_t a[2][K::TG][4];  // A fragments of two product groups
    int it = 0;
    // One slice from step it's stage: for each of its two k16 steps, 9 / TG
    // product groups of TG taps, each tap's A fragment from the strip by
    // ldmatrix. Two groups stay in flight; a group's fragments are reused
    // two groups later, once wgmma_wait<1> says it is done.
    auto stage = [&](auto first_c, int sl) {
      constexpr bool first = decltype(first_c)::value;
      constexpr int PER_K = 9 / K::TG;  // groups a k16 step
      const bool low_only = g.C - sl * BK <= 16;  // the slice's second k16 step is all past C
      const int st = it % ST;
      ring.wait_full(it);
      DACLIP_STAMP(threadIdx.x == 0 && it == 0, 5);
      const uint32_t strip = base + st * K::STAGE, ws = strip + K::STRIP;
#pragma unroll
      for (int q = 0; q < 2 * PER_K; ++q) {
        const int kk = q / PER_K, t0 = (q % PER_K) * K::TG, b = q & 1;
        mma::wgmma_wait<1>();
        mma::fence_regs(a[b]);
        if (!first && q == 1) ring.release(it - 1);  // the previous slice's groups are done
        if (kk == 1 && low_only) continue;
#pragma unroll
        for (int j = 0; j < K::TG; ++j) {
          const int tap = t0 + j, p = pix0 + (tap / 3) * sw + tap % 3, c = 2 * kk + half;
          mma::ldsm_x4(a[b][j], strip + p * RB + ((c ^ ((p >> 1) & 3)) << 4));
        }
        mma::fence_regs(acc);
        mma::wgmma_fence();
#pragma unroll
        for (int j = 0; j < K::TG; ++j)
          mma::wgmma_rs<BN, 1>(acc, a[b][j],
                               mma::wgmma_desc_sw<128>(ws + ((t0 + j) * BK + 16 * kk) * 128),
                               (first && q == 0 && j == 0) ? 0 : 1);
        mma::wgmma_commit();
      }
      ++it;
    };
    for (int i = 0; i < mine; ++i) {
      // a tile's first slice is peeled, so that every loop header sees the
      // same number of groups in flight (else ptxas waits for all of them)
      stage(std::true_type{}, s0);
      for (int sl = s0 + 1; sl < s1; ++sl) stage(std::false_type{}, sl);
      mma::wgmma_wait<0>();
      mma::fence_regs(acc);
      mma::fence_regs(a[0]);
      mma::fence_regs(a[1]);
      ring.release(it - 1);
      DACLIP_STAMP(threadIdx.x == 0 && i == mine - 1, 6);
      if (split) break;
      // the tile is done: round once and store from the accumulators
      const Tile t = tile_at(g, (int)blockIdx.x + i * (int)gridDim.x);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + gq + 8 * h;
        const int hh = t.h0 + m / g.tc, ww = t.w0 + m % g.tc;
        if (hh >= g.H || ww >= g.W) continue;
        bf16* row = y + (((size_t)t.b * g.H + hh) * g.W + ww) * g.O;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int o = o0 + 8 * j + 2 * tq;
          const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
          if (g.vec_y) {  // O even: both or neither in range
            if (o < g.O) *reinterpret_cast<uint32_t*>(row + o) = mma::pack_bf16(v0, v1);
          } else {
            if (o < g.O) row[o] = __float2bfloat16_rn(v0);
            if (o + 1 < g.O) row[o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    DACLIP_STAMP(threadIdx.x == 0, 7);
    if (split) {  // this CTA's f32 partial, over the ring once every warpgroup is done
      tma::named_sync(2, K::CONSUMERS);
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float* c = part + (m0 + gq) * K::LDF + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(c) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(c + 8 * K::LDF) = make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
  if (!split) return;

  // the cluster's sum: rank r rounds and stores its share of the tile's
  // pixels, reading every rank's partial in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const Tile t = tile_at(g, blockIdx.x);
  const int S = g.splits, rank = (int)cluster.block_rank(), rows = K::TM / S;
  constexpr int CH = BN / 8;
  float* part = reinterpret_cast<float*>(smem);
  for (int e = threadIdx.x; e < rows * CH; e += K::THREADS) {
    const int m = rank * rows + e / CH, n = (e % CH) * 8;
    const int hh = t.h0 + m / g.tc, ww = t.w0 + m % g.tc, o = o0 + n;
    if (hh >= g.H || ww >= g.W || o >= g.O) continue;
    // every rank's eight partial sums first (the remote loads overlap), then
    // their sum in rank order
    float4 lo[8], hi[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < S) {
        const float4* src =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + m * K::LDF + n);
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
    bf16* dst = y + (((size_t)t.b * g.H + hh) * g.W + ww) * g.O + o;
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

// The tile shapes the plan (daclip_torch/ops/conv3x3.py `_conv_plan`) picks
// from, by index: 0 Large, 256 pixels in product groups of a tap row
// (within its 120 registers a thread); 1 Small, 128 pixels in groups of all
// nine taps; each with one producer warp, or four where an operand takes
// the element path.
using Large = Cfg<4, 1, 3>;
using LargeE = Cfg<4, 4, 3>;
using Small = Cfg<2, 1, 9>;
using SmallE = Cfg<2, 4, 9>;

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

// The f32 kernel's grid and geometry: tiles of TM pixels (rows of 64, or of
// 32 when W ≤ 32) and BN outputs; false if the grid is too large.
__host__ inline bool plan_f32(int B, int H, int W, int C, int O, const void* x, const void* w,
                              const void* y, Geom& g, dim3& grid) {
  const int tcol = W <= 32 ? 32 : 64, trow = TM / tcol;
  const long tiles_w = (W + tcol - 1) / tcol, tiles_h = (H + trow - 1) / trow;
  const long tiles = (long)B * tiles_h * tiles_w;
  const long otiles = (O + BN - 1) / BN;
  if (tiles > INT_MAX || otiles > 65535) return false;
  g = Geom{B, H, W, C, O, trow, tcol, (int)tiles_h, (int)tiles_w,
           C % 4 == 0 && aligned16(x), O % 4 == 0 && aligned16(w), O % 4 == 0 && aligned16(y)};
  grid = dim3((unsigned)tiles, (unsigned)otiles);
  return true;
}

// Launch the bf16 kernel with tile shape K as the plan says: tiles of
// `tcols` columns (16, 32 or 64) and TM / tcols rows, a ring of `stages`,
// the channel slices split over clusters of `splits` CTAs (1: persistent
// CTAs, `grid_x` of them along the pixel tiles).
template <class K>
int launch_tc(const void* x, const void* w, void* y, int B, int H, int W, int C, int O,
              int tcols, int stages, int splits, int grid_x, cudaStream_t st) {
  if (tcols != 16 && tcols != 32 && tcols != 64) return (int)cudaErrorInvalidValue;
  const int trows = K::TM / tcols, slices = (C + tc::BK - 1) / tc::BK;
  const long tiles_w = (W + tcols - 1) / tcols, tiles_h = (H + trows - 1) / trows;
  const long tiles = (long)B * tiles_h * tiles_w, otiles = (O + tc::BN - 1) / tc::BN;
  if (tiles > INT_MAX || otiles > 65535 || stages < K::MIN_STAGES || stages > tc::MAX_STAGES ||
      splits < 1 || splits > 8 || (splits & (splits - 1)) != 0 || splits > slices ||
      grid_x < 1 || grid_x > tiles || (splits > 1 && grid_x != tiles))
    return (int)cudaErrorInvalidValue;
  tc::Geom g;
  static_cast<Geom&>(g) = Geom{B, H, W, C, O, trows, tcols, (int)tiles_h, (int)tiles_w, false,
                               false, O % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0};
  g.slices = slices;
  g.splits = splits;
  g.stages = stages;
  g.tma_x = C % 8 == 0 && aligned16(x);
  g.tma_w = O % 8 == 0 && aligned16(w);
  g.vec_y8 = O % 8 == 0 && aligned16(y);
  CUtensorMap tx{}, tw{};
  cudaError_t err = cudaSuccess;
  if (g.tma_x) {  // x as (C, W, H, B), boxes of one slice's halo strip, 64-byte swizzle
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                   (cuuint64_t)H * W * C * 2};
    const cuuint32_t box[4] = {tc::BK, (cuuint32_t)tcols + 2, (cuuint32_t)trows + 2, 1};
    err = tma::encode_map(&tx, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err == cudaSuccess && g.tma_w) {  // w as (O, C, 9), boxes of a slice's nine blocks
    const cuuint64_t dims[3] = {(cuuint64_t)O, (cuuint64_t)C, 9};
    const cuuint64_t strides[2] = {(cuuint64_t)O * 2, (cuuint64_t)C * O * 2};
    const cuuint32_t box[3] = {tc::BN, tc::BK, 9};
    err = tma::encode_map(&tw, w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = tc::conv_tma_kernel<K>;
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
  cfg.gridDim = dim3(grid_x, (unsigned)otiles, splits);
  cfg.blockDim = dim3(K::THREADS);
  cfg.dynamicSmemBytes = K::smem(stages);
  cfg.stream = st;
  cfg.attrs = attr;
  // a cluster dimension of 1 × 1 × 1 on an unsplit launch too: without it the
  // kernels ran slower on the H100 (PERF.md)
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, (const tc::bf16*)x, (const tc::bf16*)w,
                           (tc::bf16*)y, g);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace conv3x3
}  // namespace daclip

using namespace daclip::conv3x3;

// y (B, H, W, O) = the 3×3 SAME convolution of x (B, H, W, C) with w (3, 3, C,
// O), all contiguous and of one type (bf16 if is_bf16, else f32). bf16 takes
// the plan of daclip_torch/ops/conv3x3.py `_conv_plan`: tile shape `cfg` (0
// Large, 1 Small), tile columns, ring depth, cluster split and grid; f32
// ignores it.
extern "C" int daclip_conv3x3(const void* x, const void* w, void* y, int B, int H, int W, int C,
                              int O, int is_bf16, int cfg, int tile_cols, int stages, int splits,
                              int grid_x, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || O < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (!is_bf16) {
    Geom g;
    dim3 grid;
    if (!plan_f32(B, H, W, C, O, x, w, y, g, grid)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        conv_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    conv_kernel_f32<<<grid, NT, SMEM_F32, st>>>((const float*)x, (const float*)w, (float*)y, g);
    return (int)cudaGetLastError();
  }
  // an operand TMA cannot take (C or O not a multiple of 8, a base not
  // 16-byte aligned) is written element by element by four producer warps
  const bool tma = C % 8 == 0 && O % 8 == 0 && aligned16(x) && aligned16(w);
  if (cfg == 0)
    return tma ? launch_tc<tc::Large>(x, w, y, B, H, W, C, O, tile_cols, stages, splits, grid_x, st)
               : launch_tc<tc::LargeE>(x, w, y, B, H, W, C, O, tile_cols, stages, splits, grid_x,
                                       st);
  if (cfg == 1)
    return tma ? launch_tc<tc::Small>(x, w, y, B, H, W, C, O, tile_cols, stages, splits, grid_x, st)
               : launch_tc<tc::SmallE>(x, w, y, B, H, W, C, O, tile_cols, stages, splits, grid_x,
                                       st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's dynamic shared memory in bytes: tile shape cfg, a ring of
// `stages`.
extern "C" int daclip_conv_smem(int cfg, int stages) {
  return cfg == 0 ? tc::Large::smem(stages) : tc::Small::smem(stages);
}
