// Non-causal flash self-attention on the packed (B, N, H·D) layout, Hopper.
//
// Replaces the Pallas TPU kernel `flash_self_attention_pallas`
// (daclip_tpu/ops/flash_attention.py:68, body `_kernel` :39): per head,
// out = softmax(q·kᵀ·D^-½)·v, read from and written to the head's column
// slice of the packed layout, with no transposes. T is bf16 or f32; logits,
// softmax statistics and the output accumulate in f32, the output is cast
// once. When a backward will follow, the kernel also writes each query's
// log-sum-exp (B, H, N) f32, from which flash_attention_bwd.cu rebuilds P
// without another pass for the row max and sum.
//
// What bounds it on an H100: the training step's mid/up3 sites (B=16,
// N=1024, H=16, D=32, bf16) do 4·B·H·N²·D ≈ 34.4 GFLOP, 0.0347 ms at 989
// TFLOP/s, on 4·B·N·H·D·2 ≈ 67 MB, 0.020 ms at 3.35 TB/s: the operations
// bound it. But each of the B·H·N² = 268 M logits also takes one
// exponential, and the SFU does about 3.9·10¹² a second (FlashAttention-3,
// Shah et al. 2024, §3): 0.069 ms, twice the tensor cores' time. At D = 32
// the exponentials, not the products, set the floor; the kernel's job is to
// keep the SFU busy while the tensor cores and the copies run beside it.
//
// Design (bf16, `fwd_wgmma_kernel`): FlashAttention-3's forward on Hopper's
// own machinery (flash_tiles.cuh, tma.cuh, mma.cuh). A CTA per (64-query
// block, head, batch) holds one consumer warpgroup and one producer warp.
// The producer loads the CTA's q once by TMA, then streams K and V tiles of
// 64 keys by TMA through a 3-stage ring of mbarriers. The warpgroup
// computes S = q·kᵀ on wgmma m64n64k16 with both operands in shared memory
// (K-major), runs the online softmax in registers on the accumulator layout
// (row max over the quad of lanes that hold a row, two chains a row, in
// base 2 on ex2.approx, keys past N at -inf), and feeds P, rounded to bf16
// and re-packed as the A operand from its registers (`pack_tile`: the
// wgmma accumulator layout is, warp for warp, that of mma.sync), into
// O += P·V on wgmma m64nDk16 with V MN-major (the transpose bit). Each
// tile's S is issued together with the previous tile's P·V, and the
// softmax's exponentials run while P·V is in flight. At least three CTAs
// share an SM (the launch bound; one producer warp where a producer
// warpgroup left room for two), four at D = 32 where ptxas allots fewer
// registers, so one CTA's exponentials run under another's products and
// copies. (Two consumer warpgroups a CTA,
// 128 queries, taking turns at the tensor cores through named barriers as
// in FlashAttention-3's ping-pong, one CTA an SM, ran 1.02-1.36× this
// design's time at every flash shape on the H100: PERF.md.) 64-query
// CTAs also keep serving at B = 1 on 128-256 CTAs. At the end the quad's
// row sums merge, O is divided by the sum in f32 and cast once, and lse =
// max + log(sum) is written once; queries past N are not stored. No
// atomics: the result repeats bit for bit.
//
// Resources (ptxas -v, sm_90a, CUDA 12.9): 90 registers a thread at D = 32,
// 106 at 64, no spill; dynamic shared memory 29,752 B (D = 32), 58,424 B
// (64).
//
// Rounding, against the TPU kernel: `_kernel` rounds the normalised P to
// bf16 before P·V; here, as in FlashAttention-2 and -3, the unnormalised P
// (its row max is 1) is rounded and the f32 sum divided at the end. The two
// differ by a bf16 rounding of each probability, inside the limit that
// chip_smoke.py holds the bf16 forward to (8e-3 of the output's max).
//
// f32 (`fwd_kernel`): scalar FMA, 4 threads per query, K/V tiles in shared
// memory as f32, in full f32 like the plain version (tensor cores would
// round the operands to TF32).
#include <cstdint>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace daclip {
namespace flash {

constexpr int BQ = 64;   // queries per CTA
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // 4 threads per query

// -- f32: scalar FMA ------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse, int N,
           int H, float scale) {
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
    qv[d] = qrow < N ? q[base + (size_t)qrow * HD + d] : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int kr = e / D, d = e - kr * D, key = k0 + kr;
      float kk = 0.f, vv = 0.f;
      if (key < N) {
        kk = k[base + (size_t)key * HD + d];
        vv = v[base + (size_t)key * HD + d];
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
  if (lse != nullptr && ph == 0 && qrow < N) lse[((size_t)b * H + h) * N + qrow] = M + logf(l);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float od = o[d] * a;
    od += __shfl_xor_sync(0xffffffffu, od, 1);
    od += __shfl_xor_sync(0xffffffffu, od, 2);
    if ((d & 3) == ph && qrow < N) out[base + (size_t)qrow * HD + d] = od * inv;
  }
}

// -- bf16: wgmma fed by TMA ------------------------------------------------------
namespace tc {

using namespace flash_tiles;

// 2^x on the SFU (ex2.approx, as __expf takes it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One consumer warpgroup of 64 queries and the producer warp, at least
// three CTAs an SM (128 registers a thread at most). Dynamic shared memory:
// q, STAGES × (K, V), the ring's barriers and q's.
template <int D>
struct Fwd {
  static constexpr int RB = Tile<D>::RB, TILE = Tile<D>::BYTES, STAGES = 3;
  static constexpr int THREADS = THREADS_A_CTA, MINB = 3;
  static constexpr int KV_OFF = TILE, BAR_OFF = KV_OFF + STAGES * 2 * TILE;
  static constexpr int BYTES = BAR_OFF + Ring<STAGES>::BYTES + 8 + 1024;
};

// 64 queries of one head; K, V streamed. `scale2` is D^-½·log2(e): the
// softmax runs in base 2, lse is written in base e.
template <int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, Fwd<D>::MINB)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                 float* __restrict__ lse, int N, int H, float scale2) {
  using C = Fwd<D>;
  constexpr int RB = C::RB, TILE = C::TILE, ST = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t qs = base, kv = base + C::KV_OFF;
  const Ring<ST> ring{base + C::BAR_OFF};
  const uint32_t qbar = base + C::BAR_OFF + Ring<ST>::BYTES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int tiles = (N + COLS - 1) / COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    ring.init(1, 4);
    tma::mbar_init(qbar, 1);
    tma::mbar_init_fence();
  }
  __syncthreads();

  if (warpgroup() == 1) {  // the producer warp: one lane works
    if (lane == 0) {
      tma::mbar_expect_tx(qbar, TILE);
      tma::load_3d(qs, &tq, h * D, q0, b, qbar);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % ST;
        ring.wait_empty(it);
        tma::mbar_expect_tx(ring.full(s), 2 * TILE);
        tma::load_3d(kv + s * 2 * TILE, &tk, h * D, it * COLS, b, ring.full(s));
        tma::load_3d(kv + s * 2 * TILE + TILE, &tv, h * D, it * COLS, b, ring.full(s));
      }
    }
  } else {  // the consumer warpgroup
    const int tq4 = lane & 3;
    float o[D / 8][4], s[COLS / 8][4];
    uint32_t p[COLS / 16][4];
    zero(o);
    // this lane's rows g and g + 8: running max (base 2, scaled) and partial sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    // S = q·kᵀ of the stage's K tile (scale-d 0 on the first k16 step)
    auto issue_s = [&](int it) {
      const uint32_t ks = kv + (it % ST) * 2 * TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma::wgmma_ss64<0>(s, mma::wgmma_desc_sw<RB>(qs + 32 * kk),
                           mma::wgmma_desc_sw<RB>(ks + 32 * kk), kk);
    };
    // O += round(P)·V of the stage's V tile
    auto issue_pv = [&](int it) {
      const uint32_t vs = kv + (it % ST) * 2 * TILE + TILE;
#pragma unroll
      for (int kk = 0; kk < COLS / 16; ++kk)
        mma::wgmma_rs<D, 1>(o, p[kk], mma::wgmma_desc_sw<RB>(vs + kk * 16 * RB));
    };
    // the rows' new max over tile it (-inf for keys past N; tile 0 always
    // holds key 0, so the max is finite from the first tile on), the factor
    // alpha that rescales the running sums, and P = 2^(S·scale2 − max) in s;
    // the max and the sum run as two chains a row
    auto softmax = [&](int it) {
      if ((it + 1) * COLS > N) {
#pragma unroll
        for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (it * COLS + 8 * j + 2 * tq4 + (i & 1) >= N) s[j][i] = -INFINITY;
      }
      float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1][j & 1] = fmaxf(mx[i >> 1][j & 1], s[j][i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(mx[r][0], mx[r][1]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mn = fmaxf(m[r], x * scale2);
        alpha[r] = ex2(m[r] - mn);  // 0 on the first tile
        m[r] = mn;
      }
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = ex2(fmaf(s[j][i], scale2, -m[i >> 1]));
          s[j][i] = e;
          sum[i >> 1][j & 1] += e;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
    };

    tma::mbar_wait(qbar, 0);
    ring.wait_full(0);
    mma::wgmma_fence();
    issue_s(0);
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(s);
    softmax(0);
    pack_tile(p, s);
    for (int it = 1; it < tiles; ++it) {
      ring.wait_full(it);
      mma::fence_regs(o);
      mma::fence_regs(p);
      mma::wgmma_fence();
      issue_s(it);
      mma::wgmma_commit();
      issue_pv(it - 1);
      mma::wgmma_commit();
      mma::wgmma_wait<1>();  // S is in; P·V may still run
      mma::fence_regs(s);
      softmax(it);
      mma::wgmma_wait<0>();
      mma::fence_regs(o);
      mma::fence_regs(p);
      ring.release(it - 1);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[j][i] *= alpha[i >> 1];
      pack_tile(p, s);
    }
    mma::fence_regs(o);
    mma::fence_regs(p);
    mma::wgmma_fence();
    issue_pv(tiles - 1);
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(o);
    mma::fence_regs(p);
    ring.release(tiles - 1);

    const int HD = H * D;
    const int row = q0 + 16 * warp + (lane >> 2);  // rows row, row + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (lse != nullptr && tq4 == 0 && row + 8 * r < N)
        lse[((size_t)b * H + h) * N + row + 8 * r] = (m[r] + log2f(l[r])) * 0.69314718055994531f;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= inv;
        o[j][2 * r + 1] *= inv;
      }
    }
    store_rows<D>(out + (size_t)b * N * HD + (size_t)h * D, o, row, N, HD);
  }
}

}  // namespace tc

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int N,
               int H, float scale, cudaStream_t st) {
  dim3 grid((N + BQ - 1) / BQ, H, B);
  fwd_kernel<D><<<grid, NT, 0, st>>>((const float*)q, (const float*)k, (const float*)v,
                                            (float*)out, (float*)lse, N, H, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                int N, int H, float scale, cudaStream_t st) {
  using C = tc::Fwd<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  const void* srcs[] = {q, k, v};
  CUtensorMap* maps[] = {&tq, &tk, &tv};
  for (int i = 0; i < 3; ++i)
    if ((err = tma::encode_rows(maps[i], srcs[i], B, N, H, D, flash_tiles::ROWS)) != cudaSuccess)
      return (int)err;
  auto kernel = tc::fwd_wgmma_kernel<D>;
  if ((err = flash_tiles::smem_opt_in<C, 0>(kernel, C::BYTES)) != cudaSuccess) return (int)err;
  const dim3 grid((N + flash_tiles::ROWS - 1) / flash_tiles::ROWS, H, B);
  kernel<<<grid, C::THREADS, C::BYTES, st>>>(tq, tk, tv, (__nv_bfloat16*)out, (float*)lse, N, H,
                                            scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace daclip

// bf16 pointers must be 16-byte aligned (TMA's global addresses).
extern "C" int daclip_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                void* lse, int B, int N, int H, int D, float scale,
                                int is_bf16, void* stream) {
  using namespace daclip::flash;
  auto st = (cudaStream_t)stream;
  if (N < 1 || H < 1 || B < 1 || H > 65535 || B > 65535 || (D != 32 && D != 64))
    return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return D == 32 ? launch_f32<32>(q, k, v, out, lse, B, N, H, scale, st)
                   : launch_f32<64>(q, k, v, out, lse, B, N, H, scale, st);
  const void* ptrs[] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorMisalignedAddress;
  return D == 32 ? launch_bf16<32>(q, k, v, out, lse, B, N, H, scale, st)
                 : launch_bf16<64>(q, k, v, out, lse, B, N, H, scale, st);
}

// The bf16 forward kernel's dynamic shared memory in bytes at D.
extern "C" int daclip_flash_fwd_smem(int D) {
  using namespace daclip::flash::tc;
  return D == 32 ? Fwd<32>::BYTES : Fwd<64>::BYTES;
}
