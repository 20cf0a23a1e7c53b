// Kernel E: attention forward, out = softmax(q k^T * scale [causal]) v, for
// q (B, S, H, hd) and k, v (B, T, H, hd) with H already GQA-expanded,
// hd <= 256, in f32 or bf16; out (B, S, H, hd) contiguous, in q's dtype.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention
// (_make_kernel), the attention of every layer of a prefill longer than
// attn_chunk.
//
// What it computes is the TPU kernel's arithmetic: inputs widened to f32,
// scores, softmax statistics, probabilities and the accumulator all in f32,
// the online-softmax recurrence over key tiles, out = acc / max(l, 1e-30).
// The causal diagonal is aligned top-left (a query at position i sees keys
// 0..i), as in the TPU kernel; with S == T that is the usual mask.
//
// What bounds it on an H100: operations. 4 B H S T hd FLOP (half of it
// when causal) against (2 B S + 2 B T) H hd elements moved; at prefill
// lengths that is thousands of FLOP per byte. This kernel multiplies on
// the CUDA cores in f32 (67 TFLOP/s), not on the tensor cores: it is the
// right-first version, and its bound is stated against the bf16 tensor-core
// peak where the inputs are bf16.
//
// Design: one block of 256 threads per (64-query tile, head, batch row);
// grid (ceil(S/64), H, B), the latest query tiles first, since under the
// causal mask they carry the most key tiles. The query tile stays in shared
// memory; key and value tiles of 64 rows are staged in shared memory in
// turn, read in place through q/k/v's strides (no (B*H, S, hd) copy).
// Thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 register tile of the
// scores (rows 4ty..4ty+3, columns tx + 16j) and the same four rows of the
// accumulator (columns tx + 16j, j < HD/16): per 4-deep step of q k^T it
// makes 8 16-byte shared loads for 64 FMAs, per 4 keys of p v it makes
// 4 + 4 HD/16 loads for 4 HD FMAs. A row's max and sum fold over its 16
// lanes with shuffles (the lanes are one half-warp). Key tiles wholly past
// the diagonal are not visited; the diagonal tile is masked element by
// element, as are keys past T and queries past S. The probabilities are
// staged through shared memory, in the buffer the key tile used.
#include "common.cuh"

namespace rt {

constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kFlashThreads = 256;
constexpr int kLDP = kBK + 4;      // padded row of the probability tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

template <int HD>
struct Tile {
  static constexpr int LD = HD + 4;                   // padded q/k/v row
  static constexpr int LDKP = LD > kLDP ? LD : kLDP;  // k tile or p tile
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(kBQ * LD + kBK * LDKP + kBK * LD);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// rows [row0, row0 + 64) of one head of q, k or v, widened to f32, into a
// 64 x LD tile; zero past n_rows and past hd.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows, int hd, bool vec) {
  constexpr int LD = Tile<HD>::LD;
  if (vec) {   // hd % 4 == 0, rows 4-element aligned
    constexpr int C4 = HD / 4;
    for (int idx = threadIdx.x; idx < kBK * C4; idx += kFlashThreads) {
      const int r = idx / C4, c = (idx % C4) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < n_rows && c < hd)
        val = load4(src + (int64_t)(row0 + r) * row_stride + c);
      *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < kBK * HD; idx += kFlashThreads) {
      const int r = idx / HD, c = idx % HD;
      float val = 0.f;
      if (row0 + r < n_rows && c < hd)
        val = to_f32(src[(int64_t)(row0 + r) * row_stride + c]);
      dst[r * LD + c] = val;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {
  long long b, s, h;   // elements; the hd axis has stride 1
};

template <typename T, int HD>
__global__ void __launch_bounds__(kFlashThreads, HD <= 128 ? 2 : 1)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int S, int Tn,
              int H, int hd, Strides qs, Strides ks, Strides vs, float scale,
              int causal, int vec_q, int vec_k, int vec_v) {
  constexpr int LD = Tile<HD>::LD;
  constexpr int NJ = HD / 16;   // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKP = sQ + kBQ * LD;             // k tile, then p tile
  float* sV = sKP + kBK * Tile<HD>::LDKP;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qh = q + b * qs.b + h * qs.h;
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;

  load_tile<T, HD>(sQ, qh, qs.s, q0, S, hd, vec_q);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // keys past the tile's last query are never visited under the mask
  const int k_end = causal ? min(Tn, q0 + kBQ) : Tn;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's p and v are consumed
    load_tile<T, HD>(sKP, kh, ks.s, k0, Tn, hd, vec_k);
    load_tile<T, HD>(sV, vh, vs.s, k0, Tn, hd, vec_v);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(sKP + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // online softmax: scale, mask, fold the row max, rescale
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (kpos >= Tn || (causal && kpos > qpos)) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        part += s[i][j];
      }
      // per-lane share of the row sum; alpha is the same on all 16 lanes
      l[i] = l[i] * alpha + part;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();   // every lane is done with the k tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sKP[(ty * 4 + i) * kLDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(sKP + (ty * 4 + i) * kLDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = sV[(c + cc) * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y
                        : cc == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    T* o = out + (((int64_t)b * S + row) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) o[col] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T>
static bool vec_ok(const void* p, const Strides& st, int hd) {
  return hd % 4 == 0 && st.b % 4 == 0 && st.s % 4 == 0 && st.h % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int Tn, int H, int hd, Strides qs, Strides ks,
                  Strides vs, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd<T, HD>;
  const size_t smem = Tile<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tn, H, hd, qs, ks,
      vs, scale, causal, vec_ok<T>(q, qs, hd), vec_ok<T>(k, ks, hd),
      vec_ok<T>(v, vs, hd));
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_hd(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int Tn, int H, int hd,
                       Strides qs, Strides ks, Strides vs, float scale,
                       int causal, cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, B, S, Tn, H, hd, qs, ks, vs, scale,
                         causal, st);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, S, Tn, H, hd, qs, ks, vs, scale,
                         causal, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, B, S, Tn, H, hd, qs, ks, vs, scale,
                          causal, st);
  return launch<T, 256>(q, k, v, out, B, S, Tn, H, hd, qs, ks, vs, scale,
                        causal, st);
}

}  // namespace rt

// Strides in elements, each (batch, sequence, head); the hd axis must have
// stride 1. q, k, v and out share one dtype; out is (B, S, H, hd)
// contiguous.
extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int S, int T, int H, int hd, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, int causal, void* stream) {
  using namespace rt;
  if (B < 1 || S < 1 || T < 1 || H < 1 || hd < 1 || hd > 256 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_hd<float>(q, k, v, out, B, S, T, H, hd, qs, ks, vs,
                              scale, causal, st);
  if (dtype == kBF16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, S, T, H, hd, qs, ks,
                                      vs, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
