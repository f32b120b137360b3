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
//
// Design: the TPU kernel held all of K, V and f32 dK/dV of one batch element
// in VMEM and walked the query blocks in order. Hopper blocks run in no order,
// so the two reductions go to two launches that need no atomics (each
// rebuilds S and dP: 7 N²·D products per head instead of 5, for results that
// repeat bit for bit):
//   dsum  one warp per (b, query, head);
//   dq    one CTA per (64-query block, head, b);
//   dkv   one CTA per (64-key block, head, b).
// bf16 (`dq_mma_kernel`, `dkv_mma_kernel`): 4 warps, each owning 16 rows of
// the CTA's block (queries in dq, keys in dkv), whose two operands (q and dO,
// or k and v) stay in registers as mma.sync A fragments. The other side's
// 64-row tiles (k and v, or q, dO, lse and dsum) stream through a 3-stage
// cp.async ring in shared memory, bf16 rows padded to D + 8 elements so that
// every ldmatrix is free of bank conflicts (the tile helpers are shared with
// the forward, flash_tiles.cuh). Per tile the warp computes S (dkv:
// Sᵀ = K·Qᵀ) and dP on mma.sync m16n8k16 with f32 accumulators, turns them into
// P and dS in those registers, and feeds them, rounded to bf16 and re-packed
// as A fragments without a trip through shared memory (mma.cuh `pack_a`),
// into dQ += dS·K (dkv: dV += round(Pᵀ)·dO, dK += dSᵀ·Q) with the tile's B
// fragments from ldmatrix.trans. The tile is taken in column chunks of 64
// (D = 32) or 32 (D = 64) to bound the live accumulators. Keys past N get
// P = 0; queries past N have P = 0 and are not stored. Both D take the same
// mma.sync path: wgmma wants 64-row warpgroup tiles of one operand in shared
// memory, and at D = 32 the k-depth of the S products is two k16 steps.
// Dynamic shared memory: 42,496 B (D = 32), 75,264 B (D = 64); registers a
// thread (ptxas -v, sm_90a): dq 96 / 136, dkv 166 / 177; no spill.
// f32 (`dq_kernel`, `dkv_kernel`): scalar FMA in f32, 4 threads per query or
// key, operands in shared memory as f32, as the plain version computes.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "mma.cuh"

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

// -- bf16: tensor cores ---------------------------------------------------------
namespace tc {

using namespace flash_tiles;

template <int D>
struct Smem {
  static constexpr int LD = Tile<D>::LD;
  static constexpr int CHUNK = D == 32 ? 64 : 32;           // tile columns per pass
  static constexpr size_t OPERAND = Tile<D>::BYTES;         // one (64 × D) bf16 tile
  static constexpr size_t RESIDENT = 2 * OPERAND;           // the CTA's two operands
  static constexpr size_t STAGE = 2 * OPERAND + 2 * COLS * 4;  // two tiles (+ lse, dsum)
  static constexpr size_t BYTES = RESIDENT + STAGES * STAGE;
};

// dQ of 64 queries: Q, dO (registers), lse, dsum resident; K, V streamed.
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dsum, bf16* __restrict__ dq, int N, int H, float scale) {
  using S = Smem<D>;
  constexpr int LD = S::LD, KD = D / 16, CK = S::CHUNK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + COLS * LD;
  auto ks_of = [&](int s) { return reinterpret_cast<bf16*>(smem + S::RESIDENT + s * S::STAGE); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, HD = H * D;
  const size_t base = (size_t)b * N * HD + (size_t)h * D;
  const size_t srow = ((size_t)b * H + h) * N;
  const int q0 = blockIdx.x * ROWS, tiles = (N + COLS - 1) / COLS;

  auto load_tile = [&](int tile) {
    if (tile < tiles) {
      bf16* ks = ks_of(tile % STAGES);
      load_rows<D>(ks, k + base, tile * COLS, N, HD);
      load_rows<D>(ks + COLS * LD, v + base, tile * COLS, N, HD);
    }
    mma::cp_async_commit();
  };
  load_rows<D>(qs, q + base, q0, N, HD);
  load_rows<D>(dos, dout + base, q0, N, HD);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_tile(s);  // the first group holds q and dO

  const int row = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row, row + 8
  float L[2], Dm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row + 8 * i < N;
    L[i] = ok ? lse[srow + row + 8 * i] : 0.f;
    Dm[i] = ok ? dsum[srow + row + 8 * i] : 0.f;
  }
  mma::cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t qf[KD][4], df[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) {
    mma::ldsm_a(qf[kc], qs + warp * 16 * LD + 16 * kc, LD);
    mma::ldsm_a(df[kc], dos + warp * 16 * LD + 16 * kc, LD);
  }
  float acc[D / 8][4];
  zero<D>(acc);

  for (int tile = 0; tile < tiles; ++tile) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile is in; the previous tile's stage is free
    load_tile(tile + STAGES - 1);
    const bf16* ks = ks_of(tile % STAGES);
    const bf16* vs = ks + COLS * LD;
    const int k0 = tile * COLS;
#pragma unroll
    for (int c0 = 0; c0 < COLS; c0 += CK) {
      float s[CK / 8][4], dp[CK / 8][4];
#pragma unroll
      for (int j = 0; j < CK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      // S = Q·Kᵀ, dP = dO·Vᵀ (16 queries × CK keys)
#pragma unroll
      for (int kc = 0; kc < KD; ++kc)
#pragma unroll
        for (int np = 0; np < CK / 16; ++np) {
          uint32_t bk[4], bv[4];
          mma::ldsm_b(bk, ks + (c0 + 16 * np) * LD + 16 * kc, LD);
          mma::ldsm_b(bv, vs + (c0 + 16 * np) * LD + 16 * kc, LD);
          mma::mma_bf16(s[2 * np], qf[kc], bk[0], bk[1]);
          mma::mma_bf16(s[2 * np + 1], qf[kc], bk[2], bk[3]);
          mma::mma_bf16(dp[2 * np], df[kc], bv[0], bv[1]);
          mma::mma_bf16(dp[2 * np + 1], df[kc], bv[2], bv[3]);
        }
      // dS = P ∘ (dP − dsum) · s, P = exp(S·s − lse), 0 for keys past N
#pragma unroll
      for (int j = 0; j < CK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + c0 + 8 * j + 2 * tq + (i & 1);
          const float p = key < N ? __expf(s[j][i] * scale - L[i >> 1]) : 0.f;
          dp[j][i] = p * (dp[j][i] - Dm[i >> 1]) * scale;
        }
      // dQ += round(dS)·K
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        uint32_t a[4];
        mma::pack_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bk[4];
          mma::ldsm_bt(bk, ks + (c0 + 16 * kk) * LD + 16 * dn, LD);
          mma::mma_bf16(acc[2 * dn], a, bk[0], bk[1]);
          mma::mma_bf16(acc[2 * dn + 1], a, bk[2], bk[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  store_rows<D>(dq + base, acc, row, N, HD);
}

// dK and dV of 64 keys: K, V (registers) resident; Q, dO, lse, dsum streamed.
template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H, float scale) {
  using S = Smem<D>;
  constexpr int LD = S::LD, KD = D / 16, CQ = S::CHUNK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + COLS * LD;
  auto qs_of = [&](int s) { return reinterpret_cast<bf16*>(smem + S::RESIDENT + s * S::STAGE); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, HD = H * D;
  const size_t base = (size_t)b * N * HD + (size_t)h * D;
  const size_t srow = ((size_t)b * H + h) * N;
  const int k0 = blockIdx.x * ROWS, tiles = (N + COLS - 1) / COLS;

  auto load_tile = [&](int tile) {
    if (tile < tiles) {
      bf16* qs = qs_of(tile % STAGES);
      const int q0 = tile * COLS;
      load_rows<D>(qs, q + base, q0, N, HD);
      load_rows<D>(qs + COLS * LD, dout + base, q0, N, HD);
      // lse (threads 0-63) and dsum (64-127) of the tile's queries, 0 past N
      float* st = reinterpret_cast<float*>(qs + 2 * COLS * LD);
      const int r = threadIdx.x & (COLS - 1);
      const bool ok = q0 + r < N;
      mma::cp_async4(st + threadIdx.x, (threadIdx.x < COLS ? lse : dsum) + srow + (ok ? q0 + r : 0),
                     ok);
    }
    mma::cp_async_commit();
  };
  load_rows<D>(ks, k + base, k0, N, HD);
  load_rows<D>(vs, v + base, k0, N, HD);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_tile(s);  // the first group holds k and v

  mma::cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t kf[KD][4], vf[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) {
    mma::ldsm_a(kf[kc], ks + warp * 16 * LD + 16 * kc, LD);
    mma::ldsm_a(vf[kc], vs + warp * 16 * LD + 16 * kc, LD);
  }
  float dka[D / 8][4], dva[D / 8][4];
  zero<D>(dka);
  zero<D>(dva);

  for (int tile = 0; tile < tiles; ++tile) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile is in; the previous tile's stage is free
    load_tile(tile + STAGES - 1);
    const bf16* qs = qs_of(tile % STAGES);
    const bf16* dos = qs + COLS * LD;
    const float* ls = reinterpret_cast<const float*>(qs + 2 * COLS * LD);
    const float* dss = ls + COLS;
    const int q0 = tile * COLS;
#pragma unroll
    for (int c0 = 0; c0 < COLS; c0 += CQ) {
      float s[CQ / 8][4], dp[CQ / 8][4];
#pragma unroll
      for (int j = 0; j < CQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (16 keys × CQ queries)
#pragma unroll
      for (int kc = 0; kc < KD; ++kc)
#pragma unroll
        for (int np = 0; np < CQ / 16; ++np) {
          uint32_t bq[4], bo[4];
          mma::ldsm_b(bq, qs + (c0 + 16 * np) * LD + 16 * kc, LD);
          mma::ldsm_b(bo, dos + (c0 + 16 * np) * LD + 16 * kc, LD);
          mma::mma_bf16(s[2 * np], kf[kc], bq[0], bq[1]);
          mma::mma_bf16(s[2 * np + 1], kf[kc], bq[2], bq[3]);
          mma::mma_bf16(dp[2 * np], vf[kc], bo[0], bo[1]);
          mma::mma_bf16(dp[2 * np + 1], vf[kc], bo[2], bo[3]);
        }
      // Pᵀ and dSᵀ in place; queries past N get P = 0
#pragma unroll
      for (int j = 0; j < CQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = c0 + 8 * j + 2 * tq + (i & 1);
          const float p = q0 + col < N ? __expf(s[j][i] * scale - ls[col]) : 0.f;
          dp[j][i] = p * (dp[j][i] - dss[col]) * scale;
          s[j][i] = p;
        }
      // dV += round(Pᵀ)·dO, dK += round(dSᵀ)·Q
#pragma unroll
      for (int kk = 0; kk < CQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        mma::pack_a(ap, s[2 * kk], s[2 * kk + 1]);
        mma::pack_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bo[4], bq[4];
          mma::ldsm_bt(bo, dos + (c0 + 16 * kk) * LD + 16 * dn, LD);
          mma::ldsm_bt(bq, qs + (c0 + 16 * kk) * LD + 16 * dn, LD);
          mma::mma_bf16(dva[2 * dn], ap, bo[0], bo[1]);
          mma::mma_bf16(dva[2 * dn + 1], ap, bo[2], bo[3]);
          mma::mma_bf16(dka[2 * dn], ad, bq[0], bq[1]);
          mma::mma_bf16(dka[2 * dn + 1], ad, bq[2], bq[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  const int row = k0 + warp * 16 + (lane >> 2);
  store_rows<D>(dk + base, dka, row, N, HD);
  store_rows<D>(dv + base, dva, row, N, HD);
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
                const __nv_bfloat16* dout, const float* lse, const float* dsum,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int N, int H,
                float scale, cudaStream_t st) {
  constexpr int bytes = (int)tc::Smem<D>::BYTES;
  const dim3 grid((N + tc::ROWS - 1) / tc::ROWS, H, B);
  cudaError_t err = cudaFuncSetAttribute(tc::dq_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  tc::dq_mma_kernel<D><<<grid, tc::THREADS, bytes, st>>>(q, k, v, dout, lse, dsum, dq, N, H,
                                                         scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tc::dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  tc::dkv_mma_kernel<D><<<grid, tc::THREADS, bytes, st>>>(q, k, v, dout, lse, dsum, dk, dv, N,
                                                          H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dsum(const void* o, const void* dout, void* dsum, int B, int N, int H, int D,
                cudaStream_t st) {
  const long rows = (long)B * N * H;
  dsum_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)dsum, N, H, D, rows);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd
}  // namespace daclip

// dsum is (B, H, N) f32 scratch; lse is the forward's (B, H, N) log-sum-exp.
// bf16 pointers must be 16-byte aligned (the tensor-core path's cp.async).
extern "C" int daclip_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dsum, void* dq,
                                void* dk, void* dv, int B, int N, int H, int D, float scale,
                                int is_bf16, void* stream) {
  using namespace daclip::flash_bwd;
  using bf16 = __nv_bfloat16;
  auto st = (cudaStream_t)stream;
  if (N < 1 || H < 1 || B < 1 || H > 65535 || B > 65535 || (D != 32 && D != 64))
    return (int)cudaErrorInvalidValue;
  int err = is_bf16 ? launch_dsum<bf16>(o, dout, dsum, B, N, H, D, st)
                    : launch_dsum<float>(o, dout, dsum, B, N, H, D, st);
  if (err != 0) return err;
  const float* l = (const float*)lse;
  const float* ds = (const float*)dsum;
  if (is_bf16) {
    const void* ptrs[] = {q, k, v, dout, dq, dk, dv};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorMisalignedAddress;
    auto c = [](const void* p) { return (const bf16*)p; };
    return D == 32 ? launch_bf16<32>(c(q), c(k), c(v), c(dout), l, ds, (bf16*)dq, (bf16*)dk,
                                     (bf16*)dv, B, N, H, scale, st)
                   : launch_bf16<64>(c(q), c(k), c(v), c(dout), l, ds, (bf16*)dq, (bf16*)dk,
                                     (bf16*)dv, B, N, H, scale, st);
  }
  auto c = [](const void* p) { return (const float*)p; };
  return D == 32 ? launch_f32<32>(c(q), c(k), c(v), c(dout), l, ds, (float*)dq, (float*)dk,
                                  (float*)dv, B, N, H, scale, st)
                 : launch_f32<64>(c(q), c(k), c(v), c(dout), l, ds, (float*)dq, (float*)dk,
                                  (float*)dv, B, N, H, scale, st);
}
