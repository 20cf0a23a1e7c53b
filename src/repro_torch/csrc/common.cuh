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
constexpr int kMaxGridY = 65535;   // gridDim.y's limit

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
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
// sums with a fixed tree. sym_k > 0 marks a symmetric (sym_k, sym_k) result
// whose partials hold the upper triangle only: out[i, j] with i > j is
// summed from entry (j, i), so the result is exactly symmetric.
static __global__ void reduce_partials(const float* __restrict__ partial,
                                       float* __restrict__ out, int nblocks,
                                       int n, int sym_k = 0) {
  __shared__ float red[kThreads];
  const int o = blockIdx.x;
  int src = o;
  if (sym_k > 0) {
    const int i = o / sym_k, j = o - i * sym_k;
    if (i > j) src = j * sym_k + i;
  }
  float s = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += kThreads)
    s += partial[(int64_t)b * n + src];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int width = kThreads / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = red[0];
}

// 16 bytes of T (4 f32 or 8 bf16 values) widened to f32.
template <typename T>
__device__ __forceinline__ void widen16(uint4 raw, float* x);
template <>
__device__ __forceinline__ void widen16<float>(uint4 raw, float* x) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(uint4 raw, float* x) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 16 bytes through the read-only data path.
__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Asynchronous 16-byte copy global -> shared (cp.async, bypassing L1) and
// its group bookkeeping.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace rt
