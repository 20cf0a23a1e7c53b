// Kernel B: t = C^T v for a tall-skinny C (p, k) and v (p,), f32 out.
//
// Replaces src/repro/kernels/woodbury.py:_ctv_kernel (woodbury_ctv, the
// vector apply's first pass).
//
// What bounds it on an H100: bytes. It does one multiply-add per element of
// C, 2 FLOP per 4 bytes read in f32, far under the fp32 ridge of about
// 20 FLOP per byte (H100 SXM data sheet, 700 W); the least time is
// (p*k + p) * itemsize / 3.35 TB/s.
//
// Design: each block owns a contiguous run of rows. Its threads form
// 256/k row groups of k lanes; lane c of group g reads C[r, c] for rows
// r = g, g + groups, ..., so one sweep of the block reads one contiguous
// stretch of C (coalesced) and each element is read once. bf16 is widened
// to f32 before the multiply. The groups' sums fold in a fixed order in
// shared memory, the blocks' sums in reduce_partials: no atomics.
#include "common.cuh"

namespace rt {

constexpr int kMaxK = kThreads;

template <typename TC, typename TV>
__global__ void __launch_bounds__(kThreads)
    ctv_partial(const TC* __restrict__ C, const TV* __restrict__ v,
                float* __restrict__ partial, int64_t p, int k,
                int64_t rows_per_block) {
  __shared__ float red[kThreads];
  const int groups = kThreads / k;
  const int g = threadIdx.x / k;
  const int c = threadIdx.x - g * k;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = imin(p, r0 + rows_per_block);
  float acc = 0.f;
  if (g < groups) {
    for (int64_t r = r0 + g; r < r1; r += groups)
      acc = fmaf(to_f32(C[r * k + c]), to_f32(v[r]), acc);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < k) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += red[gg * k + threadIdx.x];
    partial[(int64_t)blockIdx.x * k + threadIdx.x] = s;
  }
}

template <typename TC, typename TV>
static void launch(const void* C, const void* v, float* partial, int64_t p,
                   int k, int nblocks, int64_t rows_per_block,
                   cudaStream_t stream) {
  ctv_partial<TC, TV><<<nblocks, kThreads, 0, stream>>>(
      static_cast<const TC*>(C), static_cast<const TV*>(v), partial, p, k,
      rows_per_block);
}

}  // namespace rt

// partial holds nblocks * k floats; out holds k floats.
extern "C" int rt_ctv(const void* C, int c_dtype, const void* v, int v_dtype,
                      void* partial, void* out, long long p, int k,
                      int nblocks, long long rows_per_block, void* stream) {
  using namespace rt;
  if (k < 1 || k > kMaxK || nblocks < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  if (c_dtype == kF32 && v_dtype == kF32)
    launch<float, float>(C, v, part, p, k, nblocks, rows_per_block, s);
  else if (c_dtype == kBF16 && v_dtype == kF32)
    launch<__nv_bfloat16, float>(C, v, part, p, k, nblocks, rows_per_block,
                                 s);
  else if (c_dtype == kF32 && v_dtype == kBF16)
    launch<float, __nv_bfloat16>(C, v, part, p, k, nblocks, rows_per_block,
                                 s);
  else if (c_dtype == kBF16 && v_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(C, v, part, p, k, nblocks,
                                         rows_per_block, s);
  else
    return (int)cudaErrorInvalidValue;
  reduce_partials<<<k, kThreads, 0, s>>>(part, static_cast<float*>(out),
                                         nblocks, k);
  return (int)cudaGetLastError();
}
