// Kernel C: U = V / rho - C W / rho^2 for C (p, k), W (k, m), V (p, m),
// f32 out; the vector form is m = 1.
//
// Replaces src/repro/kernels/woodbury.py:_make_apply_kernel
// (woodbury_apply, vector) and :_make_apply_block_kernel
// (_woodbury_apply_block). The Pallas kernels bake rho in per value and
// recompile for each; here 1/rho and 1/rho^2 are launch arguments, so a
// damping sweep over one cached sketch runs the same binary.
//
// What bounds it on an H100: bytes. Each output costs k multiply-adds and
// the kernel reads C once and V once and writes U once: at k = 10, m = 1 in
// f32 that is 20 FLOP per 48 bytes, at k = 64, m = 32 it is 4096 FLOP per
// 512 bytes (8 per byte), both under the fp32 ridge of about
// 20 (H100 SXM data sheet, 700 W: 67 TFLOP/s over 3.35 TB/s).
//
// Design: W (k*m <= 8192 floats) is staged once per block in shared memory.
// One thread per output element (r, j), grid-strided over p*m in storage
// order, so V and U are read and written coalesced; the m threads of a row
// share its C row through L1. bf16 C is widened to f32 before the multiply.
// Nothing is reduced across blocks, so the result is deterministic.
#include "common.cuh"

namespace rt {

constexpr int kMaxW = 8192;

template <typename TC, typename TV>
__global__ void __launch_bounds__(kThreads)
    woodbury_apply_kernel(const TC* __restrict__ C,
                          const float* __restrict__ W,
                          const TV* __restrict__ V, float* __restrict__ U,
                          int64_t p, int k, int m, float inv_rho,
                          float inv_rho2) {
  __shared__ float sW[kMaxW];
  for (int e = threadIdx.x; e < k * m; e += kThreads) sW[e] = W[e];
  __syncthreads();
  const int64_t total = p * m;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += stride) {
    const int64_t r = e / m;
    const int j = (int)(e - r * m);
    const TC* row = C + r * k;
    float s = 0.f;
    for (int i = 0; i < k; ++i) s = fmaf(to_f32(row[i]), sW[i * m + j], s);
    U[e] = to_f32(V[e]) * inv_rho - s * inv_rho2;
  }
}

template <typename TC, typename TV>
static void launch(const void* C, const float* W, const void* V, float* U,
                   int64_t p, int k, int m, float inv_rho, float inv_rho2,
                   int nblocks, cudaStream_t stream) {
  woodbury_apply_kernel<TC, TV><<<nblocks, kThreads, 0, stream>>>(
      static_cast<const TC*>(C), W, static_cast<const TV*>(V), U, p, k, m,
      inv_rho, inv_rho2);
}

}  // namespace rt

extern "C" int rt_woodbury_apply(const void* C, int c_dtype, const void* W,
                                 const void* V, int v_dtype, void* U,
                                 long long p, int k, int m, float inv_rho,
                                 float inv_rho2, int nblocks, void* stream) {
  using namespace rt;
  if (k < 1 || m < 1 || k * m > kMaxW || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const float*>(W);
  auto* u = static_cast<float*>(U);
  if (c_dtype == kF32 && v_dtype == kF32)
    launch<float, float>(C, w, V, u, p, k, m, inv_rho, inv_rho2, nblocks, s);
  else if (c_dtype == kBF16 && v_dtype == kF32)
    launch<__nv_bfloat16, float>(C, w, V, u, p, k, m, inv_rho, inv_rho2,
                                 nblocks, s);
  else if (c_dtype == kF32 && v_dtype == kBF16)
    launch<float, __nv_bfloat16>(C, w, V, u, p, k, m, inv_rho, inv_rho2,
                                 nblocks, s);
  else if (c_dtype == kBF16 && v_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(C, w, V, u, p, k, m, inv_rho,
                                         inv_rho2, nblocks, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
