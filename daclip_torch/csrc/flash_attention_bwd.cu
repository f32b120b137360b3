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
// dv: 8·B·N·H·D·2 B ≈ 134 MB, ≈40 µs at 3.35 TB/s; it does the five N²·D
// products (q·kᵀ and dO·vᵀ rebuilt, dS·K, dSᵀ·Q, Pᵀ·dO: 5·2·N²·D per head)
// ≈ 86 GFLOP, ≈87 µs on the bf16 tensor cores, so the operations bound it.
// This design rebuilds S and dP in both launches below: 7 products, ≈122 µs,
// and two passes of B·H·N² = 268 M exponentials on the SFU (about 3.9·10¹² a
// second, FlashAttention-3 §3), ≈138 µs: at D = 32 the exponentials set the
// floor, as in the forward.
//
// Design: the TPU kernel held all of K, V and f32 dK/dV of one batch element
// in VMEM and walked the query blocks in order. Hopper blocks run in no order,
// so the two reductions go to two launches that need no atomics, for results
// that repeat bit for bit:
//   dq    one CTA per (64-query block, head, b): dsum = rowsum(dO ∘ O) of
//         its queries, written for dkv, then dQ += dS·K over key tiles;
//   dkv   one CTA per (64-key block, head, b): dV += round(Pᵀ)·dO and
//         dK += dSᵀ·Q over query tiles.
// (dsum had a launch of its own, one warp a row and 2-byte loads: 0.052 ms
// at the mid/up3 sites, five times its bytes' bound; dq now takes it from
// the O and dO tiles it holds anyway.)
// bf16 (`dq_wgmma_kernel`, `dkv_wgmma_kernel`), on Hopper's own machinery
// (flash_tiles.cuh, tma.cuh, mma.cuh): one consumer warpgroup owns the
// CTA's 64 rows and one producer warp feeds it: one lane loads the CTA's
// operands (q, dO and O, or k and v) once by TMA, then streams the other
// side's 64-row tiles (k and v, or q and dO) by TMA through a 3-stage ring
// of mbarriers; in dkv the warp also writes each tile's lse (in base 2) and
// dsum into the stage, from device memory, 0 past N. Per tile the warpgroup
// computes S and dP (dkv: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ) on wgmma m64n64k16
// with both operands in shared memory, K-major, turns them into P and dS
// in those registers, and feeds them, rounded to bf16 and re-packed as A
// operands from its registers, into dQ += dS·K (dkv: dV += Pᵀ·dO,
// dK += dSᵀ·Q) on wgmma m64nDk16 with the tile as the MN-major B operand
// (the transpose bit).
// Keys (dq) or queries (dkv) past N get P = 0; rows past N are not stored.
// Three CTAs an SM at D = 32 (two at D = 64) interleave one's exponentials
// with another's products and copies: on the H100 that beat two warpgroups
// a CTA issuing the next tile's S and dP beside this tile's products, by
// 8% at the mid/up3 sites (PERF.md).
// Resources (ptxas -v, sm_90a, CUDA 12.9): dq 106 and dkv 128 registers a
// thread at D = 32, 122 and 168 at D = 64, no spill; dynamic shared memory
// dq 39,480 B and dkv 35,384 B at D = 32, 76,344 and 68,152 B at D = 64.
// f32 (`dsum_kernel`, `dq_kernel`, `dkv_kernel`): scalar FMA in f32, one
// warp per dsum row, 4 threads per query or key, operands in shared memory
// as f32, as the plain version computes.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace daclip {
namespace flash_bwd {

constexpr int BQ = 64;   // queries per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // 4 threads per query (dq) or per key (dkv)

__global__ void __launch_bounds__(NT)
dsum_kernel(const float* __restrict__ o, const float* __restrict__ dout,
            float* __restrict__ dsum, int N, int H, int D, long rows) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long bn = row / H;
  const int h = (int)(row - bn * H);
  const size_t base = (size_t)bn * H * D + (size_t)h * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += o[base + d] * dout[base + d];
  acc = warp_sum(acc);
  const long b = bn / N, n = bn - b * N;
  if (lane == 0) dsum[((size_t)b * H + h) * N + n] = acc;
}


// -- bf16: wgmma fed by TMA ------------------------------------------------------
namespace tc {

using namespace flash_tiles;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PRODUCER_REGS = 40;  // dkv's producer warp after its setmaxnreg

// One consumer warpgroup of 64 rows and the producer warp: three CTAs an SM
// at D = 32 (128 registers a thread at most), two at D = 64 (168).
// Dynamic shared memory: the CTA's RES resident tiles, STAGES × two
// streamed tiles, (dkv) STAGES × the tile's lse and dsum, the ring's
// barriers and the resident tiles'.
template <int D, int RES>
struct Bwd {
  static constexpr int RB = Tile<D>::RB, TILE = Tile<D>::BYTES, STAGES = 3;
  static constexpr int THREADS = THREADS_A_CTA, MINB = D == 32 ? 3 : 2;
  static constexpr int STAGE_OFF = RES * TILE;
  static constexpr int STATS_OFF = STAGE_OFF + STAGES * 2 * TILE;  // 2·COLS floats a stage
  static constexpr int BAR_OFF = STATS_OFF + STAGES * 2 * COLS * 4;
  static constexpr int BYTES = BAR_OFF + Ring<STAGES>::BYTES + 8 + 1024;
};

// The 16 bytes of row r, chunk c of a resident tile at generic address
// `tile`, in the swizzle TMA wrote it with (mma.cuh `wgmma_desc_sw`).
template <int D>
__device__ __forceinline__ uint4 tile_chunk(const unsigned char* tile, int r, int c) {
  const int swz = D == 32 ? (r >> 1) & 3 : r & 7;
  return *reinterpret_cast<const uint4*>(tile + r * Tile<D>::RB + ((c ^ swz) << 4));
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// S (or Sᵀ) and dP (or dPᵀ) of one tile, waited for: A from the resident
// tiles a0, a1, B from the stage's tiles b0, b1, all K-major (scale-d 0 on
// the first step)
template <int D>
__device__ __forceinline__ void sdp(float (&s)[COLS / 8][4], float (&dp)[COLS / 8][4],
                                    uint32_t a0, uint32_t a1, uint32_t b0, uint32_t b1) {
  constexpr int RB = Tile<D>::RB;
  mma::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    mma::wgmma_ss64<0>(s, mma::wgmma_desc_sw<RB>(a0 + 32 * kk),
                       mma::wgmma_desc_sw<RB>(b0 + 32 * kk), kk);
    mma::wgmma_ss64<0>(dp, mma::wgmma_desc_sw<RB>(a1 + 32 * kk),
                       mma::wgmma_desc_sw<RB>(b1 + 32 * kk), kk);
  }
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
  mma::fence_regs(s);
  mma::fence_regs(dp);
}

// acc += A·B over a tile's 64 rows: A the four k16 fragments in registers,
// B the stage's tile at `b`, MN-major
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 8][4],
                                          const uint32_t (&a)[COLS / 16][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < COLS / 16; ++kk)
    mma::wgmma_rs<D, 1>(acc, a[kk], mma::wgmma_desc_sw<Tile<D>::RB>(b + kk * 16 * Tile<D>::RB));
}

// dQ of 64 queries: Q, dO and O resident; K, V streamed. Each query's dsum
// = rowsum(dO ∘ O) is taken from the resident tiles and written for dkv; it
// and the lse stay in registers. `scale` is D^-½.
template <int D>
__global__ void __launch_bounds__(Bwd<D, 3>::THREADS, Bwd<D, 3>::MINB)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                float* __restrict__ dsum, bf16* __restrict__ dq, int N, int H, float scale) {
  using C = Bwd<D, 3>;
  constexpr int TILE = C::TILE, ST = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const unsigned char* gbase = smem + (base - tma::smem_addr(smem));  // the same bytes, generic
  const uint32_t qs = base, dos = qs + TILE, os = dos + TILE, stage = base + C::STAGE_OFF;
  const Ring<ST> ring{base + C::BAR_OFF};
  const uint32_t rbar = base + C::BAR_OFF + Ring<ST>::BYTES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int tiles = (N + COLS - 1) / COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    ring.init(1, 4);
    tma::mbar_init(rbar, 1);
    tma::mbar_init_fence();
  }
  __syncthreads();

  if (warpgroup() == 1) {  // the producer warp: one lane works
    if (lane == 0) {
      tma::mbar_expect_tx(rbar, 3 * TILE);
      tma::load_3d(qs, &tq, h * D, q0, b, rbar);
      tma::load_3d(dos, &tdo, h * D, q0, b, rbar);
      tma::load_3d(os, &to, h * D, q0, b, rbar);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % ST;
        ring.wait_empty(it);
        tma::mbar_expect_tx(ring.full(s), 2 * TILE);
        tma::load_3d(stage + s * 2 * TILE, &tk, h * D, it * COLS, b, ring.full(s));
        tma::load_3d(stage + s * 2 * TILE + TILE, &tv, h * D, it * COLS, b, ring.full(s));
      }
    }
  } else {  // the consumer warpgroup
    const int tq4 = lane & 3;
    const int lr = 16 * warp + (lane >> 2), row = q0 + lr;  // rows lr, lr + 8 of the tile
    const size_t srow = ((size_t)b * H + h) * N;
    float L2[2], Dm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      L2[r] = row + 8 * r < N ? lse[srow + row + 8 * r] * LOG2E : 0.f;
    tma::mbar_wait(rbar, 0);
    // dsum of rows lr, lr + 8: the quad's four lanes take D/4 columns each
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int c = tq4 * D / 32; c < (tq4 + 1) * D / 32; ++c)
        acc += dot8(tile_chunk<D>(gbase + (os - base), lr + 8 * r, c),
                    tile_chunk<D>(gbase + (dos - base), lr + 8 * r, c));
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      Dm[r] = acc;
      if (tq4 == 0 && row + 8 * r < N) dsum[srow + row + 8 * r] = acc;
    }
    const float scale2 = scale * LOG2E;
    float acc[D / 8][4], s[COLS / 8][4], dp[COLS / 8][4];
    uint32_t a[COLS / 16][4];
    zero(acc);
    for (int it = 0; it < tiles; ++it) {
      const uint32_t ks = stage + (it % ST) * 2 * TILE;
      ring.wait_full(it);
      sdp<D>(s, dp, qs, dos, ks, ks + TILE);  // S = Q·Kᵀ, dP = dO·Vᵀ
      // dS = P ∘ (dP − dsum) · s, P = 2^(S·s·log2e − lse·log2e), 0 for keys past N
      const bool ragged = (it + 1) * COLS > N;
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = ex2(fmaf(s[j][i], scale2, -L2[i >> 1]));
          if (ragged && it * COLS + 8 * j + 2 * tq4 + (i & 1) >= N) p = 0.f;
          dp[j][i] = p * (dp[j][i] - Dm[i >> 1]) * scale;
        }
      pack_tile(a, dp);
      mma::fence_regs(acc);
      mma::fence_regs(a);
      mma::wgmma_fence();
      issue_acc<D>(acc, a, ks);  // dQ += round(dS)·K
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      mma::fence_regs(acc);
      mma::fence_regs(a);
      ring.release(it);
    }
    const int HD = H * D;
    store_rows<D>(dq + (size_t)b * N * HD + (size_t)h * D, acc, row, N, HD);
  }
}

// dK and dV of 64 keys: K, V resident; Q, dO, lse, dsum streamed.
template <int D>
__global__ void __launch_bounds__(Bwd<D, 2>::THREADS, Bwd<D, 2>::MINB)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H, float scale) {
  using C = Bwd<D, 2>;
  constexpr int TILE = C::TILE, ST = C::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - tma::smem_addr(smem));  // the same bytes, generic
  const uint32_t ks = base, vs = ks + TILE, stage = base + C::STAGE_OFF;
  float* stats = reinterpret_cast<float*>(gbase + C::STATS_OFF);
  const Ring<ST> ring{base + C::BAR_OFF};
  const uint32_t rbar = base + C::BAR_OFF + Ring<ST>::BYTES;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * ROWS;
  const int tiles = (N + COLS - 1) / COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t srow = ((size_t)b * H + h) * N;
  if (threadIdx.x == 0) {
    ring.init(32, 4);  // every producer lane arrives: its stats' stores are released
    tma::mbar_init(rbar, 1);
    tma::mbar_init_fence();
  }
  __syncthreads();

  if (warpgroup() == 1) {  // the producer warp
    // No warpgroup takes these registers, but with a setmaxnreg in the
    // kernel ptxas 12.9 fits dkv<32> in its 128 registers without the 8-byte
    // spill it makes otherwise. The forward and dq run none: ptxas then
    // allots them fewer registers, and the forward at D = 32 runs four CTAs
    // an SM, up to 20% faster (PERF.md).
    tma::regs_dec<PRODUCER_REGS>();
    if (lane == 0) {
      tma::mbar_expect_tx(rbar, 2 * TILE);
      tma::load_3d(ks, &tk, h * D, k0, b, rbar);
      tma::load_3d(vs, &tv, h * D, k0, b, rbar);
    }
    for (int it = 0; it < tiles; ++it) {
      const int s = it % ST, q0 = it * COLS;
      // the tile's lse (base 2) and dsum, lanes 0-31 then 32-63; 0 past N
      float st[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + 32 * half + lane;
        st[half] = q < N ? lse[srow + q] * LOG2E : 0.f;
        st[2 + half] = q < N ? dsum[srow + q] : 0.f;
      }
      ring.wait_empty(it);
      float* dst = stats + s * 2 * COLS;
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[32 * i + lane] = st[i];
      if (lane == 0) {
        tma::mbar_expect_tx(ring.full(s), 2 * TILE);
        tma::load_3d(stage + s * 2 * TILE, &tq, h * D, q0, b, ring.full(s));
        tma::load_3d(stage + s * 2 * TILE + TILE, &tdo, h * D, q0, b, ring.full(s));
      } else {
        tma::mbar_arrive(ring.full(s));
      }
    }
  } else {  // the consumer warpgroup
    const int tq4 = lane & 3;
    const float scale2 = scale * LOG2E;
    float dka[D / 8][4], dva[D / 8][4], s[COLS / 8][4], dp[COLS / 8][4];
    uint32_t ap[COLS / 16][4], ad[COLS / 16][4];
    zero(dka);
    zero(dva);
    tma::mbar_wait(rbar, 0);
    for (int it = 0; it < tiles; ++it) {
      const uint32_t qs = stage + (it % ST) * 2 * TILE, dos = qs + TILE;
      ring.wait_full(it);
      sdp<D>(s, dp, ks, vs, qs, dos);  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
      // Pᵀ and dSᵀ in place; queries past N get P = 0
      const float* ls = stats + (it % ST) * 2 * COLS;
      const bool ragged = (it + 1) * COLS > N;
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j) {
        const int col = 8 * j + 2 * tq4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 dm = *reinterpret_cast<const float2*>(ls + COLS + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = ex2(fmaf(s[j][i], scale2, -((i & 1) ? l2.y : l2.x)));
          if (ragged && it * COLS + col + (i & 1) >= N) p = 0.f;
          dp[j][i] = p * (dp[j][i] - ((i & 1) ? dm.y : dm.x)) * scale;
          s[j][i] = p;
        }
      }
      pack_tile(ap, s);
      pack_tile(ad, dp);
      mma::fence_regs(dka);
      mma::fence_regs(dva);
      mma::fence_regs(ap);
      mma::fence_regs(ad);
      mma::wgmma_fence();
      issue_acc<D>(dva, ap, dos);  // dV += round(Pᵀ)·dO
      issue_acc<D>(dka, ad, qs);   // dK += round(dSᵀ)·Q
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      mma::fence_regs(dka);
      mma::fence_regs(dva);
      mma::fence_regs(ap);
      mma::fence_regs(ad);
      ring.release(it);
    }
    const int HD = H * D;
    const size_t head = (size_t)b * N * HD + (size_t)h * D;
    const int row = k0 + 16 * warp + (lane >> 2);
    store_rows<D>(dk + head, dka, row, N, HD);
    store_rows<D>(dv + head, dva, row, N, HD);
  }
}

}  // namespace tc

// -- f32: scalar FMA ------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, float* __restrict__ dq, int N, int H, float scale) {
  constexpr int LD = D + 1;  // padded rows: the 4 key phases hit distinct banks
  __shared__ float ks[BK * LD];
  __shared__ float vs[BK * LD];
  const int tid = threadIdx.x, qi = tid >> 2, ph = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = (size_t)b * N * HD + (size_t)h * D;
  const int qrow = blockIdx.x * BQ + qi;
  const bool valid = qrow < N;

  // q is read through L1 where it is used (in registers beside dO and the
  // accumulators, D = 64 would spill)
  const float* qr = q + base + (size_t)(valid ? qrow : 0) * HD;
  float dov[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dov[d] = valid ? dout[base + (size_t)qrow * HD + d] : 0.f;
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
        kk = k[base + (size_t)key * HD + d];
        vv = v[base + (size_t)key * HD + d];
      }
      ks[kr * LD + d] = kk;
      vs[kr * LD + d] = vv;
    }
    __syncthreads();
#pragma unroll 1
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int kr = jj * 4 + ph;
      if (k0 + kr >= N) break;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += __ldg(qr + d) * ks[kr * LD + d];
        dp += dov[d] * vs[kr * LD + d];
      }
      const float p = expf(s * scale - L);
      const float ds = p * (dp - dsm) * scale;
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
    if ((d & 3) == ph && valid) dq[base + (size_t)qrow * HD + d] = a;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ dsum, float* __restrict__ dk, float* __restrict__ dv,
           int N, int H, float scale) {
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
    kv[d] = valid ? k[base + (size_t)key * HD + d0 + d] : 0.f;
    vv[d] = valid ? v[base + (size_t)key * HD + d0 + d] : 0.f;
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
        a = q[base + (size_t)(q0 + r) * HD + d];
        g = dout[base + (size_t)(q0 + r) * HD + d];
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
      const float ds = p * (dp - dss[r]) * scale;
#pragma unroll
      for (int d = 0; d < DQ; ++d) {
        dka[d] += ds * qr[d];
        dva[d] += p * gr[d];
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < DQ; ++d) {
      dk[base + (size_t)key * HD + d0 + d] = dka[d];
      dv[base + (size_t)key * HD + d0 + d] = dva[d];
    }
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* dsum, float* dq, float* dk, float* dv, int B,
               int N, int H, float scale, cudaStream_t st) {
  dq_kernel<D><<<dim3((N + BQ - 1) / BQ, H, B), NT, 0, st>>>(q, k, v, dout, lse, dsum, dq, N,
                                                            H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<D><<<dim3((N + BK - 1) / BK, H, B), NT, 0, st>>>(q, k, v, dout, lse, dsum, dk, dv,
                                                             N, H, scale);
  return (int)cudaGetLastError();
}


template <int D>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse, float* dsum,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int N, int H,
                float scale, cudaStream_t st) {
  using Q = tc::Bwd<D, 3>;
  using KV = tc::Bwd<D, 2>;
  CUtensorMap tq, tk, tv, to, tdo;
  cudaError_t err;
  const void* srcs[] = {q, k, v, o, dout};
  CUtensorMap* maps[] = {&tq, &tk, &tv, &to, &tdo};
  for (int i = 0; i < 5; ++i)
    if ((err = tma::encode_rows(maps[i], srcs[i], B, N, H, D, flash_tiles::ROWS)) != cudaSuccess)
      return (int)err;
  auto dq_kernel = tc::dq_wgmma_kernel<D>;
  auto dkv_kernel = tc::dkv_wgmma_kernel<D>;
  if ((err = flash_tiles::smem_opt_in<Q, 0>(dq_kernel, Q::BYTES)) != cudaSuccess ||
      (err = flash_tiles::smem_opt_in<KV, 1>(dkv_kernel, KV::BYTES)) != cudaSuccess)
    return (int)err;
  const dim3 grid((N + flash_tiles::ROWS - 1) / flash_tiles::ROWS, H, B);
  dq_kernel<<<grid, Q::THREADS, Q::BYTES, st>>>(tq, tk, tv, to, tdo, lse, dsum, dq, N, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkv_kernel<<<grid, KV::THREADS, KV::BYTES, st>>>(tq, tk, tv, tdo, lse, dsum, dk, dv, N, H,
                                                   scale);
  return (int)cudaGetLastError();
}

int launch_dsum(const float* o, const float* dout, float* dsum, int B, int N, int H, int D,
                cudaStream_t st) {
  const long rows = (long)B * N * H;
  dsum_kernel<<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(o, dout, dsum, N, H,
                                                                          D, rows);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd
}  // namespace daclip

// dsum is (B, H, N) f32 scratch; lse is the forward's (B, H, N) log-sum-exp.
// bf16 pointers must be 16-byte aligned (TMA's global addresses).
extern "C" int daclip_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dsum, void* dq,
                                void* dk, void* dv, int B, int N, int H, int D, float scale,
                                int is_bf16, void* stream) {
  using namespace daclip::flash_bwd;
  using bf16 = __nv_bfloat16;
  auto st = (cudaStream_t)stream;
  if (N < 1 || H < 1 || B < 1 || H > 65535 || B > 65535 || (D != 32 && D != 64))
    return (int)cudaErrorInvalidValue;
  const float* l = (const float*)lse;
  if (is_bf16) {  // dq takes dsum from its resident tiles
    const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorMisalignedAddress;
    auto c = [](const void* p) { return (const bf16*)p; };
    return (D == 32 ? launch_bf16<32> : launch_bf16<64>)(c(q), c(k), c(v), c(o), c(dout), l,
                                                         (float*)dsum, (bf16*)dq, (bf16*)dk,
                                                         (bf16*)dv, B, N, H, scale, st);
  }
  auto c = [](const void* p) { return (const float*)p; };
  int err = launch_dsum(c(o), c(dout), (float*)dsum, B, N, H, D, st);
  if (err != 0) return err;
  const float* ds = (const float*)dsum;
  return D == 32 ? launch_f32<32>(c(q), c(k), c(v), c(dout), l, ds, (float*)dq, (float*)dk,
                                  (float*)dv, B, N, H, scale, st)
                 : launch_f32<64>(c(q), c(k), c(v), c(dout), l, ds, (float*)dq, (float*)dk,
                                  (float*)dv, B, N, H, scale, st);
}

// The bf16 backward kernels' dynamic shared memory in bytes: `kernel` 0 is
// dq, 1 is dkv.
extern "C" int daclip_flash_bwd_smem(int kernel, int D) {
  using namespace daclip::flash_bwd::tc;
  if (D == 32) return kernel == 0 ? Bwd<32, 3>::BYTES : Bwd<32, 2>::BYTES;
  return kernel == 0 ? Bwd<64, 3>::BYTES : Bwd<64, 2>::BYTES;
}
