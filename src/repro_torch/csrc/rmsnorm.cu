// Kernel D: row RMSNorm over the last axis, out = (x * rsqrt(mean(x^2) +
// eps)).to(T) * scale.to(T), for x (n, d) in f32 or bf16 and a scale (d,)
// in f32 or bf16; out has x's dtype.
//
// Replaces src/repro/kernels/rmsnorm.py:rmsnorm (_make_kernel), the fused
// RMSNorm of every ln1/ln2 in the model zoo.
//
// What bounds it on an H100: bytes. It does about 4 FLOP per element
// against 2 (bf16) or 4 (f32) bytes read and as many written, far under the
// ridge; the least time is (2 n d + d) * itemsize / 3.35 TB/s.
//
// Design: one block per row, sized to the row (32 to 256 threads). Each
// lane moves 16 bytes at a time (8 bf16 or 4 f32): the first Nystrom
// kernels lost bandwidth to 2-byte loads per lane. A row that does not
// start on a 16-byte boundary (d % 8 != 0 in bf16) takes a scalar head up
// to the boundary and a scalar tail after the last whole vector. The sum
// of squares is taken in f32, folded by warp shuffles and then across
// warps, and divided by the true d: unlike the TPU kernel, nothing is
// padded. Pass 2 reads the row again (from L1/L2) and writes it. The casts
// follow the reference: y is rounded to T, the scale is rounded to T, and
// their product is rounded again, so bf16 matches the plain version bit for
// bit wherever the two variances round alike.
#include <algorithm>

#include "common.cuh"

namespace rt {

constexpr int kRmsThreads = 256;

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kRmsThreads / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) s += warp_sums[w];
    total = s;
  }
  __syncthreads();
  return total;
}

template <typename T, typename TS>
__device__ __forceinline__ T norm_one(float x, float inv, TS s) {
  const T y = from_f32<T>(x * inv);
  const T sc = from_f32<T>(to_f32(s));
  return from_f32<T>(to_f32(y) * to_f32(sc));
}

template <typename T, typename TS>
__global__ void __launch_bounds__(kRmsThreads)
    rmsnorm_rows(const T* __restrict__ x, const TS* __restrict__ scale,
                 T* __restrict__ out, int d, float eps) {
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte vector
  const int64_t r = blockIdx.x;
  const T* xr = x + r * d;
  T* orow = out + r * d;
  // x and out rows share their alignment (the wrapper checks the bases)
  const int mis = (int)((reinterpret_cast<uintptr_t>(xr) % 16) / sizeof(T));
  const int head = min(d, mis ? V - mis : 0);
  const int nvec = (d - head) / V;
  const int tail = head + nvec * V;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* ov = reinterpret_cast<uint4*>(orow + head);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    const float f = to_f32(xr[i]);
    ss = fmaf(f, f, ss);
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x) {
    const float f = to_f32(xr[i]);
    ss = fmaf(f, f, ss);
  }
  const float inv = 1.f / sqrtf(block_sum(ss) / (float)d + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
    const TS* s = scale + head + (int64_t)i * V;
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = norm_one<T>(to_f32(e[j]), inv, s[j]);
    ov[i] = res;
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    orow[i] = norm_one<T>(to_f32(xr[i]), inv, scale[i]);
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x)
    orow[i] = norm_one<T>(to_f32(xr[i]), inv, scale[i]);
}

template <typename T, typename TS>
static void launch(const void* x, const void* scale, void* out, long long n,
                   int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = (d + V - 1) / V;
  const int threads =
      std::min(kRmsThreads, std::max(32, (vecs + 31) / 32 * 32));
  rmsnorm_rows<T, TS><<<(unsigned)n, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(out), d, eps);
}

}  // namespace rt

// x and out: n contiguous rows of d; the bases 16-byte aligned alike.
extern "C" int rt_rmsnorm(const void* x, int x_dtype, const void* scale,
                          int s_dtype, void* out, long long n, int d,
                          float eps, void* stream) {
  using namespace rt;
  if (n < 1 || n > 0x7fffffffLL || d < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && s_dtype == kF32)
    launch<float, float>(x, scale, out, n, d, eps, s);
  else if (x_dtype == kF32 && s_dtype == kBF16)
    launch<float, __nv_bfloat16>(x, scale, out, n, d, eps, s);
  else if (x_dtype == kBF16 && s_dtype == kF32)
    launch<__nv_bfloat16, float>(x, scale, out, n, d, eps, s);
  else if (x_dtype == kBF16 && s_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, n, d, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
