// Kernel B: t = C^T v for a tall-skinny C (p, k) and v (p,), f32 out, f32
// accumulation; C and v each f32 or bf16.
//
// Replaces src/repro/kernels/woodbury.py:_ctv_kernel (woodbury_ctv, the
// vector apply's first pass).
//
// What bounds it on an H100: bytes. It does one multiply-add per element of
// C, 2 FLOP per 4 bytes read in f32 (per 2 in bf16), far under the fp32
// ridge of about 20 FLOP per byte (H100 SXM data sheet, 700 W: 67 TFLOP/s
// over 3.35 TB/s), so the tensor cores have nothing to offer; the least
// time is (p k itemsize + p 4 + 4 k) / 3.35 TB/s. The design is about
// reading C at the memory's rate.
//
// ctv_rows16<L> -- C's base on the 16-byte grid and a row whole 16-byte
// chunks (the wrapper's rule, _lib.ctv_path; re-checked here). A group of
// L lanes (the row's chunks rounded up to a power of two, at most 32; 16
// at k = 64 in f32, 8 in bf16) reads a row, one 16-byte chunk a lane,
// neighbouring lanes on neighbouring chunks; a lane keeps its chunk's 4
// (f32) or 8 (bf16) column sums in registers over every row it visits. A
// warp's 32 / L groups take neighbouring rows, so a warp-wide load is one
// contiguous stretch of C. Rows of more than 32 chunks (k > 128 in f32,
// k > 256 in bf16) are cut into windows of 32 chunks, one window per
// gridDim.y (looping where there are more than 65,535), so any k works
// and a lane's registers stay 4 or 8 sums.
//   * v: a warp takes 32 rows (times 8 / L where L < 8) at a time; lane j
//     reads v of row j of each 32, coalesced, and the row's lanes get it
//     by __shfl_sync: one 4-byte load per 32 rows, not one per element.
//   * Loads in flight: 8 rows' 16-byte loads a lane are issued before
//     their FMAs (128 bytes a lane, 32 KB a block of 8 warps, 2 blocks an
//     SM; about 15 KB an SM covers 3.35 TB/s times the memory's ~0.6 us
//     latency over 132 SMs).
//
// ctv_scalar -- rows off the 16-byte grid (the main path's f32 k = 10,
// 40-byte rows; bf16 k = 100; a base off the grid). A window of kw =
// min(k, 256) columns; the block's threads form 256 / kw groups of kw
// lanes, lane c of group g reading column c of rows g, g + groups, ...
// (one sweep of the block reads one contiguous stretch of C), 8 rows'
// loads in flight a lane. Wider k takes windows of 256 columns over
// gridDim.y, as above.
//
// One launch a call, the same bits every run. Each block folds its lanes'
// sums in a fixed order (shuffles, then shared memory) and writes its
// partial, partial[blockIdx.x * k + c]; then __threadfence() and a ticket
// from a counter (atomicAdd). The block that draws the last ticket sums
// every block's partial in block order (each column's blocks split over
// up to 256 threads in a fixed pattern and folded in a fixed tree), writes
// t, and sets the counter back to 0. The rows a block reads depend only on
// the grid, so two calls on the same inputs give the same bits.
//
// The counter and the partials live in a scratch buffer that the wrapper
// keeps per (device, stream) (_lib.ctv_scratch; the counter zeroed when the
// buffer is made): launches on one stream run in turn, so one buffer serves
// every call on that stream, and calls on two streams use two. The call's
// one allocation is t. A call that dies mid-kernel leaves its counter
// dirty, but such a CUDA error is sticky: the context cannot launch again
// anyway.
#include "common.cuh"

namespace rt {

constexpr int kUnroll = 8;            // rows' loads in flight a lane
constexpr int kWarps = kThreads / 32;
constexpr int kWindowChunks = 32;     // 16-byte chunks of a rows16 window

// The lanes a rows16 row takes: its chunks rounded up to a power of two,
// at most kWindowChunks.
__host__ __device__ inline int rows16_lanes(int chunks) {
  int L = 1;
  while (L < chunks && L < kWindowChunks) L *= 2;
  return L;
}

// Every thread calls this after writing its share of the block's partial.
// True in the block that finished last (the same answer in all its
// threads).
__device__ __forceinline__ bool last_block(unsigned* counter) {
  __shared__ bool last;
  __threadfence();   // this thread's partials are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  return last;
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float4 ldcg(const float4* p) { return __ldcg(p); }
__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void set0(float& a) { a = 0.f; }
__device__ __forceinline__ void set0(float4& a) { a = make_float4(0, 0, 0, 0); }

// out[c] = sum over b < nrb of partial[b * ku + c] in units T, the floats
// (T = float4) or single floats (T = float) of a row of partials, in the
// last block. Units go kr = min(ku, 256) at a time; unit cc of a round is
// summed by threads s * kr + cc, s < sl = 256 / kr, thread s taking b = s,
// s + sl, ... in order, then the sl sums fold in a fixed tree.
template <typename T>
__device__ void fold_units(const T* partial, T* out, int nrb, int ku) {
  __shared__ T red[kThreads];
  const int kr = ku < kThreads ? ku : kThreads;
  const int sl = kThreads / kr;
  const int s = threadIdx.x / kr, cc = threadIdx.x - s * kr;
  for (int c0 = 0; c0 < ku; c0 += kr) {
    const int col = c0 + cc;
    T acc;
    set0(acc);
    if (s < sl && col < ku) {
#pragma unroll 8
      for (int b = s; b < nrb; b += sl)
        add(acc, ldcg(partial + (int64_t)b * ku + col));   // L2, not L1
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int n = sl; n > 1;) {
      const int h = (n + 1) / 2;
      if (s < n - h) add(red[threadIdx.x], red[threadIdx.x + h * kr]);
      __syncthreads();
      n = h;
    }
    if (s == 0 && col < ku) out[col] = red[cc];
    __syncthreads();
  }
}

// The last block's sum of the partials: 16-byte loads where k % 4 == 0
// (a quarter of the dependent loads a thread waits on), else 4-byte ones.
__device__ void fold_partials(const float* partial, float* out,
                              unsigned* counter, int nrb, int k) {
  __threadfence();   // see every other block's partials
  if (k % 4 == 0)    // partial and out lie on the 16-byte grid (wrapper)
    fold_units(reinterpret_cast<const float4*>(partial),
               reinterpret_cast<float4*>(out), nrb, k / 4);
  else
    fold_units(partial, out, nrb, k);
  if (threadIdx.x == 0) *counter = 0u;   // ready for the stream's next call
}

template <typename TC, typename TV, int L>
__global__ void __launch_bounds__(kThreads, 4)
    ctv_rows16(const TC* __restrict__ C, const TV* __restrict__ v,
               float* __restrict__ partial, float* __restrict__ out,
               unsigned* __restrict__ counter, int64_t p, int k) {
  constexpr int E = 16 / sizeof(TC);   // values a chunk
  constexpr int G = 32 / L;            // rows a warp reads at once
  constexpr int S = L < kUnroll ? kUnroll / L : 1;   // 32-row segments
  constexpr int IT = S * L;            // steps of a task, G rows each
  constexpr int TR = 32 * S;           // rows of a task
  __shared__ float red[kWarps][L * E];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int li = lane % L, g = lane / L;
  const int chunks = k / E;
  const int nw = (chunks + L - 1) / L;
  const int64_t tasks = (p + TR - 1) / TR;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  for (int w = blockIdx.y; w < nw; w += gridDim.y) {
    const int c = w * L + li;   // this lane's chunk of each row
    const bool mine = c < chunks;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int64_t task = (int64_t)blockIdx.x * kWarps + warp; task < tasks;
         task += step) {
      const int64_t base = task * TR;
      float vs[S];   // lane j: v of row base + 32 s + j
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int64_t r = base + 32 * s + lane;
        vs[s] = r < p ? to_f32(v[r]) : 0.f;
      }
      // one batch of kUnroll loads in flight at a time (two would spill
      // under the 64 registers of __launch_bounds__(256, 4)); S > 1 only
      // where the task is one batch, so vs's index is a constant
#pragma unroll 1
      for (int i0 = 0; i0 < IT; i0 += kUnroll) {
        uint4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {   // step it: group g reads row
          const int it = i0 + u;              // base + 32 seg + (it % L) G
          const int seg = S == 1 ? 0 : u / L;  // + g
          const int64_t r = base + 32 * seg + (it % L) * G + g;
          x[u] = (mine && r < p) ? ldg16(C + r * k + c * E)
                                 : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int it = i0 + u;
          const float vr =
              __shfl_sync(full, vs[S == 1 ? 0 : u / L], (it % L) * G + g);
          float f[E];
          widen16<TC>(x[u], f);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(f[e], vr, acc[e]);
        }
      }
    }
    // the warp's G groups (lanes li, li + L, ...) in a fixed tree, then
    // the block's warps in order
#pragma unroll
    for (int o = L; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(full, acc[e], o);
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) red[warp][li * E + e] = acc[e];
    }
    __syncthreads();
    if (threadIdx.x < L * E) {
      float s = red[0][threadIdx.x];
#pragma unroll
      for (int wp = 1; wp < kWarps; ++wp) s += red[wp][threadIdx.x];
      const int col = w * L * E + threadIdx.x;
      if (col < k) partial[(int64_t)blockIdx.x * k + col] = s;
    }
    __syncthreads();
  }
  if (last_block(counter)) fold_partials(partial, out, counter, gridDim.x, k);
}

template <typename TC, typename TV>
__global__ void __launch_bounds__(kThreads, 4)
    ctv_scalar(const TC* __restrict__ C, const TV* __restrict__ v,
               float* __restrict__ partial, float* __restrict__ out,
               unsigned* __restrict__ counter, int64_t p, int k) {
  __shared__ float red[kThreads];
  const int kw = k < kThreads ? k : kThreads;   // a window's columns
  const int groups = kThreads / kw;
  const int g = threadIdx.x / kw, cc = threadIdx.x - g * kw;
  const int nw = (k + kw - 1) / kw;
  const int64_t stride = (int64_t)gridDim.x * groups;
  for (int w = blockIdx.y; w < nw; w += gridDim.y) {
    const int col = w * kw + cc;
    float acc = 0.f;
    if (g < groups && col < k) {
      int64_t r = (int64_t)blockIdx.x * groups + g;
      for (; r + (kUnroll - 1) * stride < p; r += kUnroll * stride) {
        TC x[kUnroll];
        TV y[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          x[u] = C[(r + u * stride) * k + col];
          y[u] = v[r + u * stride];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          acc = fmaf(to_f32(x[u]), to_f32(y[u]), acc);
      }
      for (; r < p; r += stride)
        acc = fmaf(to_f32(C[r * k + col]), to_f32(v[r]), acc);
    }
    // the groups' sums of each column in a fixed tree
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int n = groups; n > 1;) {
      const int h = (n + 1) / 2;
      if (g < n - h) red[threadIdx.x] += red[threadIdx.x + h * kw];
      __syncthreads();
      n = h;
    }
    if (g == 0 && col < k) partial[(int64_t)blockIdx.x * k + col] = red[cc];
    __syncthreads();
  }
  if (last_block(counter)) fold_partials(partial, out, counter, gridDim.x, k);
}

template <typename TC, typename TV>
static int launch(const void* C, const void* v, float* partial, float* out,
                  unsigned* counter, int64_t p, int k, int nrb, int rows16,
                  cudaStream_t stream) {
  auto* c = static_cast<const TC*>(C);
  auto* x = static_cast<const TV*>(v);
  int nw;
  if (rows16) {
    const int chunks = k * (int)sizeof(TC) / 16;
    const int L = rows16_lanes(chunks);
    nw = (chunks + L - 1) / L;
    const dim3 grid(nrb, nw < kMaxGridY ? nw : kMaxGridY);
    switch (L) {
#define RT_CTV_L(n)                                                        \
  case n:                                                                  \
    ctv_rows16<TC, TV, n><<<grid, kThreads, 0, stream>>>(c, x, partial,    \
                                                         out, counter, p, k); \
    break;
      RT_CTV_L(1) RT_CTV_L(2) RT_CTV_L(4) RT_CTV_L(8) RT_CTV_L(16)
      RT_CTV_L(32)
#undef RT_CTV_L
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    const int kw = k < kThreads ? k : kThreads;
    nw = (k + kw - 1) / kw;
    const dim3 grid(nrb, nw < kMaxGridY ? nw : kMaxGridY);
    ctv_scalar<TC, TV><<<grid, kThreads, 0, stream>>>(c, x, partial, out,
                                                      counter, p, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace rt

// partial holds nrb * k floats, out k floats, both on the 16-byte grid;
// counter is a zeroed unsigned int kept for this stream (the last block
// sets it back to 0). rows16: C's
// rows are read as whole 16-byte chunks (refused here if C does not allow
// it). One launch.
extern "C" int rt_ctv(const void* C, int c_dtype, const void* v, int v_dtype,
                      void* partial, void* out, void* counter, long long p,
                      int k, int nrb, int rows16, void* stream) {
  using namespace rt;
  const int esize = c_dtype == kBF16 ? 2 : 4;
  if (k < 1 || p < 1 || nrb < 1 ||
      (rows16 && (reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
                  ((int64_t)k * esize) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  auto* cnt = static_cast<unsigned*>(counter);
  if (c_dtype == kF32 && v_dtype == kF32)
    return launch<float, float>(C, v, part, o, cnt, p, k, nrb, rows16, s);
  if (c_dtype == kBF16 && v_dtype == kF32)
    return launch<__nv_bfloat16, float>(C, v, part, o, cnt, p, k, nrb,
                                        rows16, s);
  if (c_dtype == kF32 && v_dtype == kBF16)
    return launch<float, __nv_bfloat16>(C, v, part, o, cnt, p, k, nrb,
                                        rows16, s);
  if (c_dtype == kBF16 && v_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(C, v, part, o, cnt, p, k,
                                                nrb, rows16, s);
  return (int)cudaErrorInvalidValue;
}
