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
// 512 bytes (8 per byte), both under the fp32 ridge of about 20 (H100 SXM
// data sheet, 700 W: 67 TFLOP/s over 3.35 TB/s). So the design is about
// reading C at the memory's rate: whole 16-byte loads, neighbouring lanes
// on neighbouring bytes, and enough of them in flight. W stays f32 (bf16
// would break the reference's contract), so the tensor cores do not apply.
//
// rows16 (the wrapper's rule): C's base is on the 16-byte grid and a row is
// whole 16-byte chunks (k * elem % 16 == 0), at most 64 of them.
//
// apply_vec (m = 1). With rows16: a group of L lanes (the chunks of a row,
// rounded up to a power of two; 16 at k = 64 in f32) reads one row with
// 16-byte loads, multiplies by its slice of w held in registers, and folds
// the group's sums with __shfl_xor_sync. A warp takes 32 rows at a time
// (four rows' loads in flight per lane), gathers the 32 dots into lane
// order with shuffles, and reads v and writes u coalesced. Without rows16
// (k = 10 in f32: 40-byte rows; rows of more than 64 chunks) a lane walks
// its own row with scalar loads against w in shared memory, or, where w
// has more than kMaxW values, against w read through __ldg (the warp's
// lanes read the same value of w at once: one broadcast load).
//
// apply_block (m > 1). W, zero-padded to whole 8-column groups, is staged
// once per block in shared memory. Stages of R rows of C come into a
// 2-stage ring with cp.async (16 bytes a thread; plain loads without
// rows16), each row padded to an odd number of 16-byte chunks so that 16-
// byte reads of neighbouring rows fall on distinct banks; the copy of the
// next stage is in flight while this one is multiplied. A thread owns a
// 4-row x 8-column register tile (rows rg + q R/4, columns 8cg..8cg + 7):
// per 4 (f32) or 8 (bf16) values of k it makes 4 16-byte loads of C and
// 2 per value of W, 8 FMAs per shared load. V is read into registers
// before the FMAs, and U is written with 16-byte stores where m % 8 == 0.
// bf16 C and V are widened to f32 in registers after the load. A block-form
// launch takes at most 256 columns of W and V; wider blocks run in slices
// of 256 columns, each reading C again. Where a 256-column slice of W and a
// ring of 4 rows do not fit a block's shared memory (k = 512 in f32), the
// slice narrows by whole 8-column groups to the width that gives the most
// threads a tile (slice_cols). Only where not even 8 columns fit (k in the
// thousands) does the slice run as the vector form, once a column (strided
// v, w and u). Any k and m. Nothing is reduced across blocks, so the
// result is deterministic.
#include "common.cuh"

namespace rt {

constexpr int kMaxW = 8192;        // w of the scalar vector path, floats
constexpr int kVecMaxChunks = 64;  // 16-byte chunks of a rows16 row
constexpr int kBlkTR = 4;          // rows of a block-form thread tile
constexpr int kBlkTC = 8;          // columns of it
constexpr int kBlkBudget = 200 * 1024;   // shared memory of a block
constexpr int kBlkSlice = 256;     // columns of W and V a block-form launch

template <typename TC, typename TV>
__global__ void __launch_bounds__(kThreads)
    apply_vec(const TC* __restrict__ C, const float* __restrict__ w,
              const TV* __restrict__ v, float* __restrict__ u, int64_t p,
              int k, int64_t ld, float inv_rho, float inv_rho2, int rows16) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int64_t tasks = (p + 31) / 32;   // 32 rows a warp at a time
  const int64_t nwarps = (int64_t)gridDim.x * (kThreads / 32);
  int64_t task = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  if (!rows16) {
    // w staged in shared memory where it fits, else read through __ldg
    __shared__ float sw[kMaxW];
    const bool staged = k <= kMaxW;
    if (staged)
      for (int e = threadIdx.x; e < k; e += kThreads) sw[e] = w[e * ld];
    __syncthreads();
    for (; task < tasks; task += nwarps) {
      const int64_t r = task * 32 + lane;
      if (r >= p) continue;
      const TC* row = C + r * k;
      float s = 0.f;
      if (staged)
        for (int i = 0; i < k; ++i) s = fmaf(to_f32(row[i]), sw[i], s);
      else
        for (int i = 0; i < k; ++i)
          s = fmaf(to_f32(row[i]), __ldg(w + (int64_t)i * ld), s);
      u[r * ld] = to_f32(v[r * ld]) * inv_rho - s * inv_rho2;
    }
    return;
  }
  constexpr int E = 16 / sizeof(TC);   // values per 16-byte chunk
  const int chunks = k / E;
  int L = 1;
  while (L < chunks && L < 32) L *= 2;
  const int G = 32 / L, li = lane % L, g = lane / L;
  float wr[2][E];   // this lane's chunks li and li + L of w
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = li + L * t;
      wr[t][e] = c < chunks ? w[(c * E + e) * ld] : 0.f;
    }
  for (; task < tasks; task += nwarps) {
    const int64_t base = task * 32;
    float mine = 0.f;   // lane j ends with the dot of row base + j
    for (int it0 = 0; it0 < L; it0 += 4) {
      // iteration it: group g reads row base + it * G + g
      uint4 x[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int64_t r = base + (int64_t)(it0 + q) * G + g;
          const int c = li + L * t;
          x[q][t] = (it0 + q < L && r < p && c < chunks)
                        ? ldg16(C + r * k + c * E)
                        : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float f[E];
          widen16<TC>(x[q][t], f);
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(f[e], wr[t][e], s);
        }
        for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(full, s, o);
        if (it0 + q < L) {
          const float dot = __shfl_sync(full, s, (lane % G) * L);
          if (lane / G == it0 + q) mine = dot;
        }
      }
    }
    const int64_t r = base + lane;
    if (r < p) u[r * ld] = to_f32(v[r * ld]) * inv_rho - mine * inv_rho2;
  }
}

// The block form's layout, shared by the host and the kernel.
struct BlockShape {
  int kp;        // k rounded up to whole 16-byte chunks of C's type
  int ldc;       // staged row of C, values: an odd number of chunks
  int mp;        // m rounded up to whole 8-column groups
  int w_bytes;   // W in shared memory, kp x mp f32
  int rows;      // R, rows of p in a stage
};

template <typename TC>
__host__ __device__ inline BlockShape block_shape(int k, int m) {
  constexpr int E = 16 / sizeof(TC);
  BlockShape b;
  b.kp = (k + E - 1) / E * E;
  b.ldc = b.kp + ((b.kp / E) % 2 == 0 ? E : 0);
  b.mp = (m + kBlkTC - 1) / kBlkTC * kBlkTC;
  const int64_t w_bytes = (int64_t)b.kp * b.mp * 4;
  b.w_bytes = w_bytes < kBlkBudget ? (int)w_bytes : kBlkBudget;
  const int64_t row_bytes = (int64_t)b.ldc * sizeof(TC);
  const int64_t fit = (kBlkBudget - w_bytes) / (2 * row_bytes);
  const int want = kBlkTR * (kThreads / (b.mp / kBlkTC));
  b.rows = fit < kBlkTR ? 0 : (int)(want < fit ? want : fit) / kBlkTR * kBlkTR;
  return b;
}

// The columns of W and V a block-form launch takes: kBlkSlice, or all that
// are left if fewer. Where W's slice and a ring of kBlkTR rows do not fit
// kBlkBudget, fewer whole 8-column groups: of the widths that fit, the one
// that gives the most threads a tile (ties to the wider, which reads C
// fewer times). 0 where not even 8 columns fit.
template <typename TC>
static int slice_cols(int k, int left) {
  const int top = left < kBlkSlice ? left : kBlkSlice;
  if (block_shape<TC>(k, top).rows >= kBlkTR) return top;
  int best = 0, busy = 0;
  for (int ms = (top - 1) / kBlkTC * kBlkTC; ms >= kBlkTC; ms -= kBlkTC) {
    const BlockShape b = block_shape<TC>(k, ms);
    if (b.rows < kBlkTR) continue;
    const int tiles = b.rows / kBlkTR * (b.mp / kBlkTC);
    if ((tiles < kThreads ? tiles : kThreads) > busy) {
      best = ms;
      busy = tiles < kThreads ? tiles : kThreads;
    }
  }
  return best;
}

template <typename TC, typename TV>
__global__ void __launch_bounds__(kThreads, 1)
    apply_block(const TC* __restrict__ C, const float* __restrict__ W,
                const TV* __restrict__ V, float* __restrict__ U, int64_t p,
                int k, int m, int ld, float inv_rho, float inv_rho2,
                int rows16, int vec_out) {
  constexpr int E = 16 / sizeof(TC);
  extern __shared__ __align__(16) uint8_t smem[];
  const BlockShape b = block_shape<TC>(k, m);
  const int R = b.rows, ldc = b.ldc, mp = b.mp;
  float* sW = reinterpret_cast<float*>(smem);
  TC* ring = reinterpret_cast<TC*>(smem + b.w_bytes);
  for (int e = threadIdx.x; e < b.kp * mp; e += kThreads) {
    const int i = e / mp, j = e - i * mp;
    sW[e] = (i < k && j < m) ? W[(int64_t)i * ld + j] : 0.f;
  }
  const int ng = mp / kBlkTC;
  const int cg = threadIdx.x % ng, rg = threadIdx.x / ng;
  const int quarter = R / kBlkTR;   // thread rows rg + q * quarter
  const bool active = rg < quarter;
  const int64_t ntiles = (p + R - 1) / R;
  const int nmine =
      blockIdx.x < ntiles
          ? (int)((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x)
          : 0;
  auto row0 = [&](int s) {
    return ((int64_t)blockIdx.x + (int64_t)s * gridDim.x) * R;
  };
  auto stage = [&](int s) { return ring + (s % 2) * R * ldc; };
  auto issue = [&](int s) {
    TC* dst = stage(s);
    const int64_t r0 = row0(s);
    const int rows = (int)imin(R, p - r0);
    if (rows16) {
      const int cpr = k / E;
      for (int c = threadIdx.x; c < rows * cpr; c += kThreads) {
        const int rr = c / cpr, cc = c - rr * cpr;
        cp_async16(dst + rr * ldc + cc * E, C + (r0 + rr) * k + cc * E);
      }
    } else {   // plain loads, zero past k
      for (int e = threadIdx.x; e < rows * b.kp; e += kThreads) {
        const int rr = e / b.kp, cc = e - rr * b.kp;
        dst[rr * ldc + cc] =
            cc < k ? C[(r0 + rr) * k + cc] : from_f32<TC>(0.f);
      }
    }
  };

  if (nmine > 0) issue(0);
  cp_async_commit();
  for (int s = 0; s < nmine; ++s) {
    if (s + 1 < nmine) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // stage s (and W) visible to every thread
    if (active) {
      const int64_t r0 = row0(s);
      // V first, so that its loads overlap the FMAs
      float vv[kBlkTR][kBlkTC];
#pragma unroll
      for (int q = 0; q < kBlkTR; ++q) {
        const int64_t r = r0 + rg + q * quarter;
#pragma unroll
        for (int y = 0; y < kBlkTC; ++y) vv[q][y] = 0.f;
        if (r >= p) continue;
        const TV* vr = V + r * ld + kBlkTC * cg;
        if (vec_out && kBlkTC * cg + kBlkTC <= m) {
          widen16<TV>(ldg16(vr), vv[q]);
          if constexpr (sizeof(TV) == 4) widen16<TV>(ldg16(vr + 4), vv[q] + 4);
        } else {
#pragma unroll
          for (int y = 0; y < kBlkTC; ++y)
            if (kBlkTC * cg + y < m) vv[q][y] = to_f32(vr[y]);
        }
      }
      float acc[kBlkTR][kBlkTC];
#pragma unroll
      for (int q = 0; q < kBlkTR; ++q)
#pragma unroll
        for (int y = 0; y < kBlkTC; ++y) acc[q][y] = 0.f;
      const TC* sc = stage(s) + rg * ldc;
      for (int i = 0; i < b.kp; i += E) {
        float c[kBlkTR][E];
#pragma unroll
        for (int q = 0; q < kBlkTR; ++q)
          widen16<TC>(*reinterpret_cast<const uint4*>(
                          sc + q * quarter * ldc + i),
                      c[q]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float* wr = sW + (i + e) * mp + kBlkTC * cg;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
          const float w8[kBlkTC] = {w0.x, w0.y, w0.z, w0.w,
                                    w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int q = 0; q < kBlkTR; ++q)
#pragma unroll
            for (int y = 0; y < kBlkTC; ++y)
              acc[q][y] = fmaf(c[q][e], w8[y], acc[q][y]);
        }
      }
#pragma unroll
      for (int q = 0; q < kBlkTR; ++q) {
        const int64_t r = r0 + rg + q * quarter;
        if (r >= p) continue;
        float o[kBlkTC];
#pragma unroll
        for (int y = 0; y < kBlkTC; ++y)
          o[y] = vv[q][y] * inv_rho - acc[q][y] * inv_rho2;
        float* ur = U + r * ld + kBlkTC * cg;
        if (vec_out && kBlkTC * cg + kBlkTC <= m) {
          *reinterpret_cast<float4*>(ur) = make_float4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<float4*>(ur + 4) =
              make_float4(o[4], o[5], o[6], o[7]);
        } else {
#pragma unroll
          for (int y = 0; y < kBlkTC; ++y)
            if (kBlkTC * cg + y < m) ur[y] = o[y];
        }
      }
    }
    __syncthreads();   // stage s is free for the copy of stage s + 2
  }
  cp_async_wait<0>();
}

// The vector form on column j of (p, ld) V and U and (k, ld) W.
template <typename TC, typename TV>
static int launch_vec(const void* C, const float* W, const void* V, float* U,
                      int64_t p, int k, int64_t ld, int64_t j, float inv_rho,
                      float inv_rho2, int rows16, int sms,
                      cudaStream_t stream) {
  const int64_t warps = (p + 31) / 32;
  const int64_t want = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const int blocks = (int)(want < 4 * sms ? want : 4 * sms);
  apply_vec<TC, TV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TC*>(C), W + j, static_cast<const TV*>(V) + j, U + j,
      p, k, ld, inv_rho, inv_rho2, rows16);
  return (int)cudaGetLastError();
}

template <typename TC, typename TV>
static int launch(const void* C, const float* W, const void* V, float* U,
                  int64_t p, int k, int m, float inv_rho, float inv_rho2,
                  int rows16, int sms, cudaStream_t stream) {
  if (m == 1)
    return launch_vec<TC, TV>(C, W, V, U, p, k, 1, 0, inv_rho, inv_rho2,
                              rows16, sms, stream);
  auto kernel = apply_block<TC, TV>;
  for (int j0 = 0, ms; j0 < m; j0 += ms) {
    ms = slice_cols<TC>(k, m - j0);
    if (ms == 0) {   // not even 8 columns of W and a ring fit: by column
      ms = m - j0;
      for (int j = j0; j < m; ++j) {
        const int code = launch_vec<TC, TV>(C, W, V, U, p, k, m, j, inv_rho,
                                            inv_rho2, rows16, sms, stream);
        if (code != 0) return code;
      }
      continue;
    }
    const BlockShape b = block_shape<TC>(k, ms);
    const int smem = b.w_bytes + 2 * b.rows * b.ldc * (int)sizeof(TC);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t ntiles = (p + b.rows - 1) / b.rows;
    const int per_sm = smem <= 100 * 1024 ? 2 : 1;
    const int blocks =
        (int)(ntiles < (int64_t)per_sm * sms ? ntiles : per_sm * sms);
    const TV* v = static_cast<const TV*>(V) + j0;
    float* u = U + j0;
    // 16-byte loads of V and stores of U where every row's slice is whole
    // 32-byte groups on the 16-byte grid
    const int vec_out = ms % kBlkTC == 0 && m % kBlkTC == 0 &&
                        reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(u) % 16 == 0;
    kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const TC*>(C), W + j0, v, u, p, k, ms, m, inv_rho,
        inv_rho2, rows16, vec_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace rt

// rows16: C's rows are read as whole 16-byte chunks (the wrapper's rule;
// refused here if C does not satisfy it). Takes any k, m >= 1. sms: the
// card's SM count, which sets the grids.
extern "C" int rt_woodbury_apply(const void* C, int c_dtype, const void* W,
                                 const void* V, int v_dtype, void* U,
                                 long long p, int k, int m, float inv_rho,
                                 float inv_rho2, int rows16, int sms,
                                 void* stream) {
  using namespace rt;
  const int esize = c_dtype == kBF16 ? 2 : 4;
  if (k < 1 || m < 1 || p < 1 || sms < 1 ||
      (rows16 && (reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
                  (k * esize) % 16 != 0 || k * esize > 16 * kVecMaxChunks)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const float*>(W);
  auto* u = static_cast<float*>(U);
  if (c_dtype == kF32 && v_dtype == kF32)
    return launch<float, float>(C, w, V, u, p, k, m, inv_rho, inv_rho2,
                                rows16, sms, s);
  if (c_dtype == kBF16 && v_dtype == kF32)
    return launch<__nv_bfloat16, float>(C, w, V, u, p, k, m, inv_rho,
                                        inv_rho2, rows16, sms, s);
  if (c_dtype == kF32 && v_dtype == kBF16)
    return launch<float, __nv_bfloat16>(C, w, V, u, p, k, m, inv_rho,
                                        inv_rho2, rows16, sms, s);
  if (c_dtype == kBF16 && v_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(C, w, V, u, p, k, m, inv_rho,
                                                inv_rho2, rows16, sms, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
