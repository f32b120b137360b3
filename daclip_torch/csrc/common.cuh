// Shared helpers for the daclip_torch CUDA kernels: working-type conversion
// and rounding, warp reductions. Plain C interface, no PyTorch headers.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Per-phase stamps of the CTA at blockIdx (0, 0, 0), only in a build with
// -DDACLIP_STAMPS (scripts/torch_pointwise_conv_hopper.py --stamps builds such
// a copy of the kernels): DACLIP_STAMP(cond, i) records clock64() and
// %globaltimer (ns) as stamp i where the thread for which cond holds passes.
// Without the flag it expands to nothing, its condition included, so the
// kernels compile as if it were not there.
#ifdef DACLIP_STAMPS
static __device__ long long daclip_stamps[2][32];
#define DACLIP_STAMP(cond, i)                                                    \
  do {                                                                           \
    if ((cond) && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {       \
      long long ns_;                                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                    \
      daclip_stamps[0][i] = clock64();                                           \
      daclip_stamps[1][i] = ns_;                                                 \
    }                                                                            \
  } while (0)
#else
#define DACLIP_STAMP(cond, i)
#endif

namespace daclip {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to the working type T and back: the points where the
// reference composition casts to its compute dtype.
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace daclip
