// Kernel A: out = A^T B for a tall-skinny A (p, k) and B (p, m), f32 out.
//
// Replaces src/repro/kernels/nystrom_gram.py:_gram_kernel (nystrom_gram,
// A = B = C) and :_cross_kernel (nystrom_cross, the m-query C^T V).
//
// What bounds it on an H100: each row of A (k values) and of B (m values)
// is read once and used in k*m multiply-adds. Gram at k = 64 as computed
// here (all k*k entries) does 2*64*64 FLOP per 256 bytes, 32 FLOP per
// byte, above the fp32 CUDA-core ridge of about 20 (H100 SXM data sheet,
// 700 W: 67 TFLOP/s over 3.35 TB/s); its k(k+1)/2 distinct entries need
// 16 per byte, under the ridge, so gram's least time is set by bytes.
// The cross at k = 64, m = 32 does
// 2*64*32 FLOP per 384 bytes (about 11 per byte), and the main path's
// k = 10 shapes fewer still: bound by bytes.
//
// Design: p is cut into one contiguous run of rows per block. A block
// stages 16 rows of A and B at a time in shared memory, widened to f32
// (bf16 sketches are upcast here, before any multiply), and every thread
// owns up to 16 of the k*m outputs in registers, so each row is read from
// device memory once. gridDim.y tiles the outputs past 4096 (k*m > 4096).
// The per-block sums go to f32 scratch and reduce_partials adds them in a
// fixed order. Simple and right first: no tensor cores, no TMA.
#include "common.cuh"

namespace rt {

constexpr int kTileRows = 16;
constexpr int kMaxDim = 256;
constexpr int kOutPerThread = 16;
constexpr int kOutPerBlock = kThreads * kOutPerThread;

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
    atb_partial(const TA* __restrict__ A, const TB* __restrict__ B,
                float* __restrict__ partial, int64_t p, int k, int m,
                int64_t rows_per_block) {
  __shared__ float sA[kTileRows * kMaxDim];
  __shared__ float sB[kTileRows * kMaxDim];
  const int n = k * m;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = imin(p, r0 + rows_per_block);
  const int obase = blockIdx.y * kOutPerBlock + threadIdx.x;

  float acc[kOutPerThread];
  int oi[kOutPerThread], oj[kOutPerThread];
#pragma unroll
  for (int q = 0; q < kOutPerThread; ++q) {
    acc[q] = 0.f;
    const int o = obase + q * kThreads;
    oi[q] = o / m;
    oj[q] = o - oi[q] * m;
  }

  for (int64_t r = r0; r < r1; r += kTileRows) {
    const int rows = (int)imin(kTileRows, r1 - r);
    for (int e = threadIdx.x; e < rows * k; e += kThreads)
      sA[e] = to_f32(A[r * k + e]);
    for (int e = threadIdx.x; e < rows * m; e += kThreads)
      sB[e] = to_f32(B[r * m + e]);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kOutPerThread; ++q) {
      if (obase + q * kThreads < n) {
        // two-level sum: the tile's 16 rows first, then into the running
        // sum, so the rounding of a long run of rows grows with p/16
        float s = 0.f;
        for (int rr = 0; rr < rows; ++rr)
          s = fmaf(sA[rr * k + oi[q]], sB[rr * m + oj[q]], s);
        acc[q] += s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kOutPerThread; ++q) {
    const int o = obase + q * kThreads;
    if (o < n) partial[(int64_t)blockIdx.x * n + o] = acc[q];
  }
}

template <typename TA, typename TB>
static void launch(const void* A, const void* B, float* partial, int64_t p,
                   int k, int m, int nblocks, int64_t rows_per_block,
                   cudaStream_t stream) {
  const int n = k * m;
  dim3 grid(nblocks, (n + kOutPerBlock - 1) / kOutPerBlock);
  atb_partial<TA, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B), partial, p, k, m,
      rows_per_block);
}

}  // namespace rt

// partial holds nblocks * k * m floats; out holds k * m floats (row-major
// (k, m)). Returns cudaGetLastError() after both launches.
extern "C" int rt_atb(const void* A, int a_dtype, const void* B, int b_dtype,
                      void* partial, void* out, long long p, int k, int m,
                      int nblocks, long long rows_per_block, void* stream) {
  using namespace rt;
  if (k < 1 || m < 1 || k > kMaxDim || m > kMaxDim || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  if (a_dtype == kF32 && b_dtype == kF32)
    launch<float, float>(A, B, part, p, k, m, nblocks, rows_per_block, s);
  else if (a_dtype == kBF16 && b_dtype == kF32)
    launch<__nv_bfloat16, float>(A, B, part, p, k, m, nblocks,
                                 rows_per_block, s);
  else if (a_dtype == kF32 && b_dtype == kBF16)
    launch<float, __nv_bfloat16>(A, B, part, p, k, m, nblocks,
                                 rows_per_block, s);
  else if (a_dtype == kBF16 && b_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(A, B, part, p, k, m, nblocks,
                                         rows_per_block, s);
  else
    return (int)cudaErrorInvalidValue;
  reduce_partials<<<k * m, kThreads, 0, s>>>(part, static_cast<float*>(out),
                                             nblocks, k * m);
  return (int)cudaGetLastError();
}
