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
// What bounds it on an H100: at 256², B=1, the mid/up3 sites (N=1024, H=16,
// D=32, bf16) do 4·N²·H·D ≈ 2.1 GFLOP (≈2.2 µs at 989 TFLOP/s) on 4·N·H·D·2
// ≈ 4.2 MB (≈1.3 µs), so the bound is the operations. At D = 32 the products
// are short (a k-depth of two k16 steps for S), and each of the N² logits
// also takes one exponential on the SFU: 16.8 M at that site, so the
// exponentials, not the tensor cores, set the pace once the products are on
// the tensor cores.
//
// Design: the TPU kernel held all of K/V in VMEM per q-block and took an
// exact softmax. Here FlashAttention-2's forward on Hopper's warp-level
// tensor cores (bf16, `fwd_mma_kernel`): one CTA of 4 warps per (64-query
// block, head, batch), each warp owning 16 queries whose q stays in
// registers as mma.sync A fragments. K and V tiles of 64 keys stream through
// a 3-stage cp.async ring in shared memory, rows padded to D + 8 elements so
// that every ldmatrix is free of bank conflicts (flash_tiles.cuh, shared with
// the backward). Per tile the warp computes S = q·kᵀ (16 × 64) on mma.sync
// m16n8k16 with f32 accumulators (K's B fragments from ldmatrix), masks keys
// past N with -inf, takes the new row max across the quad of lanes that hold
// a row with two shuffles, rescales its running sum and output, turns S into
// P = exp(S − max) in those registers and feeds P, rounded to bf16 and
// re-packed as A fragments (mma.cuh `pack_a`), into O += P·V (V's B
// fragments from ldmatrix.trans). The N×N logits never leave registers. At
// the end the quad's partial row sums merge, the output is divided by the
// sum in f32 and cast once, and lse = max + log(sum) is written once; queries
// past N are not stored. The softmax runs in base 2 on ex2.approx (the SFU
// instruction that __expf takes; the accurate exp2f cost D = 32 a spill).
// Dynamic shared memory: 35,840 B (D = 32), 64,512 B (D = 64); registers a
// thread 78 (D = 32), 137 (D = 64); no spill (ptxas -v, sm_90a). No atomics:
// the result repeats bit for bit.
//
// Rounding, against the TPU kernel: `_kernel` rounds the normalised P to
// bf16 before P·V; here, as in FlashAttention-2, the unnormalised P (its
// row max is 1) is rounded and the f32 sum divided at the end. The two
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

// -- bf16: tensor cores ---------------------------------------------------------
namespace tc {

using namespace flash_tiles;

// 2^x on the SFU (ex2.approx, as __expf takes it): the accurate exp2f's
// scaling steps cost registers (and a spill at D = 32)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Smem {
  static constexpr int LD = Tile<D>::LD;
  static constexpr size_t STAGE = 2 * Tile<D>::BYTES;  // a K and a V tile
  static constexpr size_t BYTES = Tile<D>::BYTES + STAGES * STAGE;  // + the CTA's q
};

// 64 queries of one head: q (registers) resident; K, V streamed. `scale2` is
// D^-½·log2(e): the softmax runs in base 2, lse is written in base e.
template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ out, float* __restrict__ lse, int N, int H, float scale2) {
  using S = Smem<D>;
  constexpr int LD = S::LD, KD = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  auto ks_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem + Tile<D>::BYTES + s * S::STAGE);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, HD = H * D;
  const size_t base = (size_t)b * N * HD + (size_t)h * D;
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
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_tile(s);  // the first group holds q

  mma::cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) mma::ldsm_a(qf[kc], qs + warp * 16 * LD + 16 * kc, LD);
  float acc[D / 8][4];
  zero<D>(acc);
  // this lane's rows g and g + 8: running max (base 2) and partial sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < tiles; ++tile) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile is in; the previous tile's stage is free
    load_tile(tile + STAGES - 1);
    const bf16* ks = ks_of(tile % STAGES);
    const bf16* vs = ks + COLS * LD;
    const int k0 = tile * COLS;
    float s[COLS / 8][4];
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    // S = q·kᵀ (16 queries × 64 keys)
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
#pragma unroll
      for (int np = 0; np < COLS / 16; ++np) {
        uint32_t bk[4];
        mma::ldsm_b(bk, ks + 16 * np * LD + 16 * kc, LD);
        mma::mma_bf16(s[2 * np], qf[kc], bk[0], bk[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kc], bk[2], bk[3]);
      }
    // the rows' new max over this tile, -inf for keys past N (tile 0 always
    // holds key 0, so the max is finite from the first tile on)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * j + 2 * tq + (i & 1);
        s[j][i] = key < N ? s[j][i] * scale2 : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = ex2(m[r] - mx[r]);  // 0 on the first tile
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
    }
    // P = exp(S − max) in place; the lane's share of each row's sum
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(s[j][i] - m[i >> 1]);
        s[j][i] = p;
        l[i >> 1] += p;
      }
    // O += round(P)·V
#pragma unroll
    for (int kk = 0; kk < COLS / 16; ++kk) {
      uint32_t a[4];
      mma::pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bv[4];
        mma::ldsm_bt(bv, vs + 16 * kk * LD + 16 * dn, LD);
        mma::mma_bf16(acc[2 * dn], a, bv[0], bv[1]);
        mma::mma_bf16(acc[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
  }
  mma::cp_async_wait<0>();
  const int row = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row, row + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (lse != nullptr && tq == 0 && row + 8 * r < N)
      lse[((size_t)b * H + h) * N + row + 8 * r] = (m[r] + log2f(l[r])) * 0.69314718055994531f;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][2 * r] *= inv;
      acc[j][2 * r + 1] *= inv;
    }
  }
  store_rows<D>(out + base, acc, row, N, HD);
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

constexpr int MAX_DEVICES = 64;

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                int N, int H, float scale, cudaStream_t st) {
  const void* ptrs[] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorMisalignedAddress;
  constexpr int bytes = (int)tc::Smem<D>::BYTES;
  // the shared-memory opt-in, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static bool opted[MAX_DEVICES] = {};
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(tc::fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  const dim3 grid((N + tc::ROWS - 1) / tc::ROWS, H, B);
  tc::fwd_mma_kernel<D><<<grid, tc::THREADS, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, N, H, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace daclip

// bf16 pointers must be 16-byte aligned (the tensor-core path's cp.async).
extern "C" int daclip_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                void* lse, int B, int N, int H, int D, float scale,
                                int is_bf16, void* stream) {
  using namespace daclip::flash;
  auto st = (cudaStream_t)stream;
  if (N < 1 || H < 1 || B < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (D == 32)
    return is_bf16 ? launch_bf16<32>(q, k, v, out, lse, B, N, H, scale, st)
                   : launch_f32<32>(q, k, v, out, lse, B, N, H, scale, st);
  if (D == 64)
    return is_bf16 ? launch_bf16<64>(q, k, v, out, lse, B, N, H, scale, st)
                   : launch_f32<64>(q, k, v, out, lse, B, N, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
