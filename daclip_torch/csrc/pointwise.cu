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
// bytes). So the kernel streams x (and skip) from device memory once, in
// 16-byte copies, and keeps the products off the critical path.
//
// Design, bf16 (`dual_wgmma_kernel`): CTAs of WG warpgroups compute tiles of
// 64·WG rows × 64·NB outputs on wgmma m64n64k16 with both operands in shared
// memory and f32 accumulators in registers. The CTA is persistent: one wave
// of CTAs, each with a fixed column block, walks the row tiles, its (tile,
// 64-deep K slice) steps one cp.async ring, so the next tile's first slices
// load while this tile's last ones multiply, and each tile's accumulators go
// from registers to y, rounded once. Copies are issued STAGES − 2 steps
// ahead and one step's products stay in flight while the next step's copies
// land (a stage is refilled once the products that read it are done). A
// slice of A (rows × 64 k) is stored K-major in the 128-byte swizzle; a
// 16-byte chunk of it comes from x or from skip by its place along K, so the
// concat never exists. The weights, (64 k × 64 outputs) slices N-major in
// the 128-byte swizzle (as conv3x3.cu stages them), either stay resident for
// the CTA's column block (loaded once) or stream through the ring beside A.
// Two tile shapes, picked by `daclip_dual_conv1x1` by shape: Large, 256 ×
// 128 with streamed weights, where O ≥ 256 and such tiles still give every
// SM one, and where the weights do not fit beside the ring (K > 1024);
// else Small, 64 × 64 with the weights resident (scripts/torch_dual_sweep.py
// times both at each UNet shape on the card). Rows past R, k past K and
// outputs past O are zero-filled by predication. Where a 16-byte chunk is
// not legal (Kx, Ks or O not a multiple of 8, or an operand not 16-byte
// aligned), the same kernel fills that operand's chunks element by element.
// A tile's first product overwrites its accumulators (wgmma scale-d 0, so
// no other instruction writes them between products), and its first slice
// is peeled from the slice loop: a loop header reached with different
// numbers of product groups in flight made ptxas insert a wait for every
// group there (its advisory C7517).
// No atomics: every output is summed in one fixed order, so the result
// repeats bit for bit. Dynamic shared memory: Small 6 × 8 KB + the resident
// weights (K/64 × 8 KB), Large 4 × 48 KB, + 1 KB to align. Registers a
// thread: Small 62, Large 102; no spill (ptxas -v, sm_90a).
//
// Against torch.matmul on the same operands it stays slower at the serving
// shapes and at up3/up2 of the training batch (PERF.md): its copies
// re-read A once per 128 outputs through per-thread cp.async, and its
// products, fed in lock-step by a CTA-wide barrier a step, keep one group
// in flight. A warp-specialised TMA producer is the next step.
//
// f32 (`dual_kernel_f32`): one CTA per 64×64 output tile, K walked in
// 32-deep slices, scalar FMA, 4×4 outputs a thread, in full f32 like the
// plain version (tensor cores would round the operands to TF32).
#include <algorithm>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace daclip {
namespace pointwise {

// -- bf16: tensor cores ---------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;                            // outputs of a panel: one 128-byte row
constexpr int BK = 64;                            // depth of a K slice: one 128-byte row
constexpr int CHUNKS = BK / 8;                    // 16-byte chunks of a 128-byte row
constexpr size_t BLOCK_BYTES = (size_t)64 * BK * 2;  // 64 rows × 64 k, or 64 k × 64 n: 8 KB

struct Geom {
  int R, Kx, Ks, O;
  int slices, row_tiles;     // K slices, tiles of 64·WG rows
  bool vec_a, vec_w, vec_y;  // 16-byte copies of x and skip, of w; 4-byte stores of y
};

// A tile shape: WG warpgroups of 64 rows each, NB panels of 64 outputs,
// STAGES ring stages, the weights resident (RES) or streamed through the ring.
template <int WG_, int NB_, int STAGES_, bool RES_>
struct Cfg {
  static constexpr int WG = WG_, NB = NB_, STAGES = STAGES_;
  static constexpr bool RES = RES_;
  static constexpr int BM = 64 * WG, THREADS = 128 * WG;
  static constexpr size_t A = WG * BLOCK_BYTES;                       // a stage's A
  static constexpr size_t STAGE = A + (RES ? 0 : NB * BLOCK_BYTES);  // + its weights
  // every block 1024-byte aligned, as the swizzle's atoms must be, + room to
  // align the base
  static size_t smem(int slices) {
    return (RES ? (size_t)slices * NB * BLOCK_BYTES : 0) + STAGES * STAGE + 1024;
  }
};

// The A slice of rows [r0, r0 + BM) and k [k0, k0 + 64) of the logical concat
// [x | skip], K-major in the 128-byte swizzle (row r's chunk c at chunk
// c ^ (r % 8); 64-row blocks of 8 KB): a chunk of 8 k comes from x or from
// skip by its place along K; zero past R and K.
template <class C>
__device__ __forceinline__ void load_a(bf16* __restrict__ as, const bf16* __restrict__ x,
                                       const bf16* __restrict__ skip, const Geom& g, int r0,
                                       int k0) {
  const int K = g.Kx + g.Ks;
#pragma unroll
  for (int i = 0; i < C::BM * CHUNKS / C::THREADS; ++i) {
    const int e = threadIdx.x + i * C::THREADS, r = e / CHUNKS, c = e % CHUNKS;
    const int row = r0 + r, k = k0 + 8 * c;
    bf16* dst = as + r * BK + ((c ^ (r & 7)) * 8);
    if (g.vec_a) {  // Kx % 8 == 0, Ks % 8 == 0: a chunk lies wholly in x, in skip or past K
      const bool ok = row < g.R && k < K;
      const bf16* src = !ok ? x
                        : k < g.Kx ? x + (size_t)row * g.Kx + k
                                   : skip + (size_t)row * g.Ks + (k - g.Kx);
      mma::cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = k + j;
        dst[j] = row >= g.R ? __float2bfloat16_rn(0.f)
                 : kk < g.Kx ? x[(size_t)row * g.Kx + kk]
                 : kk < K    ? skip[(size_t)row * g.Ks + (kk - g.Kx)]
                             : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// The (64 k × 64 outputs) weight slice of k [k0, k0 + 64) and outputs
// [o0, o0 + 64), N-major in the 128-byte swizzle (row k's chunk j at chunk
// j ^ (k % 8)); zero past K and O.
template <class C>
__device__ __forceinline__ void load_w(bf16* __restrict__ ws, const bf16* __restrict__ w,
                                       const Geom& g, int k0, int o0) {
  const int K = g.Kx + g.Ks;
#pragma unroll
  for (int i = 0; i < BK * CHUNKS / C::THREADS; ++i) {
    const int e = threadIdx.x + i * C::THREADS, row = e / CHUNKS, j = e % CHUNKS;
    const int k = k0 + row, o = o0 + 8 * j;
    bf16* dst = ws + row * BN + ((j ^ (row & 7)) * 8);
    if (g.vec_w) {  // O % 8 == 0: a chunk is wholly in range or wholly past O
      const bool ok = k < K && o < g.O;
      mma::cp_async16(dst, ok ? w + (size_t)k * g.O + o : w, ok);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        dst[t] = (k < K && o + t < g.O) ? w[(size_t)k * g.O + o + t] : __float2bfloat16_rn(0.f);
    }
  }
}

// CTA (x, y) computes outputs [64·NB·y, 64·NB·(y + 1)) of row tiles x,
// x + gridDim.x, ... as one ring of (tile, slice) steps. Step s's copies are
// issued STAGES − 2 steps ahead and its products wait one step: a stage is
// refilled once the products that read it (two steps back) are done.
template <class C>
__global__ void __launch_bounds__(C::THREADS)
dual_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ skip,
                  const bf16* __restrict__ w, bf16* __restrict__ y, Geom g) {
  constexpr int NB = C::NB, STAGES = C::STAGES, AHEAD = STAGES - 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (mma::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + (C::RES ? (size_t)g.slices * NB * BLOCK_BYTES : 0);
  auto a_of = [&](int stage) { return reinterpret_cast<bf16*>(ring + stage * C::STAGE); };
  // panel p's weight slice for ring stage `stage` (streamed) or K slice `sl` (resident)
  auto w_of = [&](int stage, int sl, int p) {
    return reinterpret_cast<bf16*>(C::RES ? smem + ((size_t)sl * NB + p) * BLOCK_BYTES
                                          : ring + stage * C::STAGE + C::A + p * BLOCK_BYTES);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2;  // this warp's warpgroup: rows 64·wg of the tile
  const int o0 = blockIdx.y * BN * NB, nsl = g.slices;
  const int mine = (g.row_tiles - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int steps = mine * nsl;  // ring steps: (tile, slice)

  if (C::RES)  // the column block's weights, once, in the first copy group
    for (int sl = 0; sl < nsl; ++sl)
#pragma unroll
      for (int p = 0; p < NB; ++p) load_w<C>(w_of(0, sl, p), w, g, sl * BK, o0 + p * BN);
  auto load_step = [&](int i) {
    if (i < steps) {
      const int ti = i / nsl, sl = i - ti * nsl;
      load_a<C>(a_of(i % STAGES), x, skip, g, (blockIdx.x + ti * gridDim.x) * C::BM, sl * BK);
      if (!C::RES)
#pragma unroll
        for (int p = 0; p < NB; ++p)
          load_w<C>(w_of(i % STAGES, sl, p), w, g, sl * BK, o0 + p * BN);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) load_step(s);

  float acc[NB][BN / 8][4];  // this warp's 16 rows × 64·NB outputs, as n8 tiles
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[p][j][i] = 0.f;

  // ring step s (slice sl of its tile): wait for its copies, refill the
  // stage two steps back, issue its products (a tile's first overwrites)
  auto step = [&](int s, int sl) {
    mma::cp_async_wait<AHEAD - 1>();
    mma::fence_proxy_async();  // wgmma reads the stage through the async proxy
    __syncthreads();           // step s is in; step s − 2's products are done
    load_step(s + AHEAD);
    const bf16* as = a_of(s % STAGES) + wg * 64 * BK;
#pragma unroll
    for (int p = 0; p < NB; ++p) mma::fence_acc(acc[p]);
    mma::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int p = 0; p < NB; ++p)
        mma::wgmma_m64n64_ss(acc[p], mma::wgmma_desc_b128(as + 16 * kc, 1024),
                             mma::wgmma_desc_b128(w_of(s % STAGES, sl, p) + 16 * kc * BN, 1024),
                             sl > 0 || kc > 0);
    mma::wgmma_commit();
  };
  // One product group stays in flight across steps. The first slice of a
  // tile is peeled, so that every loop header sees the same number of
  // groups in flight (else ptxas waits for all of them at the header).
  for (int ti = 0, s = 0; ti < mine; ++ti) {
    step(s++, 0);
    for (int sl = 1; sl < nsl; ++sl) {
      step(s++, sl);
      mma::wgmma_wait<1>();  // step s − 1's products are done
#pragma unroll
      for (int p = 0; p < NB; ++p) mma::fence_acc(acc[p]);
    }
    // the tile is done: round once and store from the accumulators
    mma::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NB; ++p) mma::fence_acc(acc[p]);
    const int r0 = (blockIdx.x + ti * gridDim.x) * C::BM + 16 * warp + gq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
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
  mma::cp_async_wait<0>();
}

// The tile shapes the launcher picks from.
using Small = Cfg<1, 1, 6, true>;   // 64 × 64, weights resident
using Large = Cfg<4, 2, 4, false>;  // 256 × 128, weights streamed
constexpr int RES_SLICES = 16;      // the most K slices Small holds resident: K ≤ 1024

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

// The current device and its SM count (asked once a device).
inline cudaError_t current_sms(int& dev, int& sms) {
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static int counts[MAX_DEVICES] = {};
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  sms = counts[dev];
  return cudaSuccess;
}

// Launch the bf16 kernel with tile shape C as one wave of persistent CTAs.
template <class C>
int launch_wgmma(const void* x, const void* skip, const void* w, void* y, int R, int Kx, int Ks,
                 int O, int dev, int sms, cudaStream_t st) {
  const int slices = (Kx + Ks + tc::BK - 1) / tc::BK;
  if (C::RES && slices > tc::RES_SLICES) return (int)cudaErrorInvalidValue;
  const tc::Geom g{R, Kx, Ks, O, slices, (R + C::BM - 1) / C::BM,
                   Kx % 8 == 0 && Ks % 8 == 0 && aligned(x, 16) && (!skip || aligned(skip, 16)),
                   O % 8 == 0 && aligned(w, 16), O % 2 == 0 && aligned(y, 4)};
  auto kernel = tc::dual_wgmma_kernel<C>;
  const size_t bytes = C::smem(slices);
  // the shared-memory opt-in and the CTAs an SM holds, once a device (and,
  // with resident weights, once a depth)
  static int per_sm[MAX_DEVICES][tc::RES_SLICES + 1] = {};
  int& held = per_sm[dev][C::RES ? slices : 0];
  if (held == 0) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&held, kernel, C::THREADS, bytes);
    if (err != cudaSuccess) return (int)err;
    if (held < 1) return (int)cudaErrorInvalidValue;
  }
  const int cols = (O + C::NB * tc::BN - 1) / (C::NB * tc::BN);
  const long slots = (long)held * sms;  // CTAs the card holds at once
  const dim3 grid((unsigned)std::min<long>(g.row_tiles, std::max<long>(1, slots / cols)), cols);
  tc::dual_wgmma_kernel<C><<<grid, C::THREADS, bytes, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)skip, (const __nv_bfloat16*)w,
      (__nv_bfloat16*)y, g);
  return (int)cudaGetLastError();
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
  auto st = (cudaStream_t)stream;
  if (!is_bf16) {
    dim3 grid((unsigned)((R + BM - 1) / BM), (O + BN - 1) / BN);
    dual_kernel_f32<<<grid, NT, 0, st>>>((const float*)x, (const float*)skip, (const float*)w,
                                         (float*)y, (int)R, Kx, Ks, O);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0;
  const cudaError_t err = current_sms(dev, sms);
  if (err != cudaSuccess) return (int)err;
  // 256 × 128 tiles where O is wide and they still give every SM a tile, or
  // where the weights do not fit resident; else 64 × 64 with the weights
  // resident
  const long wide = ((R + 255) / 256) * ((O + 127) / 128);
  if ((O >= 4 * tc::BN && wide >= sms) || (Kx + Ks + tc::BK - 1) / tc::BK > tc::RES_SLICES)
    return launch_wgmma<tc::Large>(x, skip, w, y, (int)R, Kx, Ks, O, dev, sms, st);
  return launch_wgmma<tc::Small>(x, skip, w, y, (int)R, Kx, Ks, O, dev, sms, st);
}
