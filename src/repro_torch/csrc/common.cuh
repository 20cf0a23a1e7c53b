// Shared pieces of the kernels: dtype conversion and the deterministic
// cross-block reduction of the Nystrom kernels.
//
// The TPU kernels walk p in order into one accumulator that stays in VMEM.
// On Hopper p is split across thread blocks; each block writes its partial
// sums to f32 scratch that the Python wrapper allocates, and
// reduce_partials below adds them up in a fixed order (a fixed-shape tree
// per output), so a result is the same from run to run. No atomics.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// f32 -> T, rounding to nearest even for bf16.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// out[o] = sum over b of partial[b * n + o], one block per output o.
// Thread t sums b = t, t + 256, ... in order; the block then folds its 256
// sums with a fixed tree.
static __global__ void reduce_partials(const float* __restrict__ partial,
                                       float* __restrict__ out, int nblocks,
                                       int n) {
  __shared__ float red[kThreads];
  const int o = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += kThreads)
    s += partial[(int64_t)b * n + o];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int width = kThreads / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = red[0];
}

}  // namespace rt
