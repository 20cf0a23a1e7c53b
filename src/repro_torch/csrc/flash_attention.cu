// Kernel E: attention forward, out = softmax(q k^T * scale [causal]) v, for
// q (B, S, H, hd) and k, v (B, T, KV, hd) with H % KV == 0: query head h
// reads KV head h / (H / KV) in place (GQA, no expanded copy). out is
// (B, S, H, hd) contiguous, in q's dtype.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention
// (_make_kernel), the attention of every layer of a prefill longer than
// attn_chunk.
//
// What it computes is the TPU kernel's arithmetic: q k^T accumulated in
// f32, then times scale in f32; the softmax statistics, probabilities and
// accumulator in f32; the online-softmax recurrence over key tiles;
// out = acc / max(l, 1e-30), rounded once. The causal diagonal is aligned
// top-left (a query at position i sees keys 0..i), as in the TPU kernel;
// with S == T that is the usual mask.
//
// What bounds it on an H100: operations. 4 B H S T hd FLOP (half of it when
// causal) against (2 B S H + 2 B T KV) hd elements moved; at prefill
// lengths that is thousands of FLOP per byte, far above the card's ~295.
//
// Two kernels; the wrapper (kernels/flash_attention.py) picks one by an
// explicit rule on dtype, hd and alignment:
//
// flash_fwd_tc<HD> -- bf16, hd in {64, 128}, every base address and stride
// on the 16-byte grid. Both products on the tensor cores (wgmma):
//   * CTA = 128 query rows of one (head, batch row): two consumer
//     warpgroups of 64 rows and one producer warp; grid (H, B, S / 128),
//     the latest query tiles (the most key tiles under the mask) first.
//   * The producer warp loads Q once and K/V tiles of 64 keys into a
//     2-stage ring with TMA (cp.async.bulk.tensor), completion counted in
//     bytes on an mbarrier per stage; each consumer warp releases a stage
//     (an "empty" mbarrier of 8 arrivals) once both of its products are
//     done. Tensor maps are built on the host in each call over the tensors
//     as they lie (4-d: hd, heads, rows, batch, through their strides) and
//     passed as __grid_constant__ parameters; cuTensorMapEncodeTiled is
//     reached through cudaGetDriverEntryPoint, so no -lcuda. TMA fills rows
//     past S or T with zeros; a zero key scores 0, not -1e30, so keys past
//     T are still masked in registers.
//   * S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory
//     (rows contiguous along hd, the reduction axis), f32 accumulators.
//   * Softmax in registers on the accumulator layout: a row's 16 values a
//     lane, its max and sum folded over the quad of lanes that share it.
//     Only the diagonal tile and a ragged last tile are masked; tiles
//     wholly past a warpgroup's diagonal are skipped (but still released).
//   * O += P V: P stays in registers as the A operand, split into two bf16
//     fragments hi = bf16(P) and lo = bf16(P - hi), two wgmma m64n{HD}k16
//     into one f32 accumulator. P in bf16 alone misses the one-ulp gate on
//     near-zero outputs; hi + lo carries 16 bits of P and stays within it
//     (tests/test_torch_kernels.py simulates both on the CPU). The
//     split makes the tensor-core work 1.5x the algorithm's. V is the B
//     operand from shared memory, MN-major (its rows run along hd = N):
//     the transpose bit, allowed for 16-bit types.
//   * 64-key tiles, not 128: a consumer lane then holds 32 score, 16 + 16
//     P-fragment and HD/2 output registers (128 at hd = 128) and needs no
//     setmaxnreg; at 128 keys the split's fragments would double to 64
//     registers beside 64 scores and 64 outputs. Shared memory is 32 KB of
//     Q plus 2 x 32 KB of K/V at hd = 128, one CTA per SM.
//   Trouble spots: (1) the 128-byte swizzle: a 256-byte row at hd = 128 is
//   loaded as two 64-column boxes, each its own 1024-byte-aligned block of
//   128-byte rows; a descriptor steps 32 bytes along a row per 16 columns
//   (K-major) or 2048 bytes per 16 keys (V), and LBO = the box's size
//   reaches V's second 64 columns. (2) The accumulator layout turned into
//   A fragments: registers 8kk..8kk+7 of the scores are the A fragment of
//   keys 16kk..16kk+15, pairs packed low column first. (3) Registers:
//   -Xptxas -v is printed by chip_smoke.py; no setmaxnreg unless it spills.
//   (4) mbarrier phases: tile i uses stage i % 2 and waits for parity
//   (i / 2) & 1; the producer waits for the previous round's release.
//
// flash_fwd<T, HD> -- everything else: f32 inputs (the tensor cores cannot
// give IEEE f32; f32 attention serves parity checks, not serving), and bf16
// with hd not in {64, 128} or off the 16-byte grid. It multiplies on the
// CUDA cores in f32 (67 TFLOP/s): one block of 256 threads per (64-query
// tile, head, batch row); grid (ceil(S/64), H, B), the latest query tiles
// first. The query tile stays in shared memory; key and value tiles of 64
// rows are staged in shared memory in turn, read in place through q/k/v's
// strides. Thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 register tile of
// the scores (rows 4ty..4ty+3, columns tx + 16j) and the same four rows of
// the accumulator (columns tx + 16j, j < HD/16). A row's max and sum fold
// over its 16 lanes with shuffles. Key tiles wholly past the diagonal are
// not visited; the diagonal tile is masked element by element, as are keys
// past T and queries past S. The probabilities are staged through shared
// memory, in the buffer the key tile used.
#include "hopper.cuh"

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
              int H, int group, int hd, Strides qs, Strides ks, Strides vs,
              float scale, int causal, int vec_q, int vec_k, int vec_v) {
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
  const T* kh = k + b * ks.b + (h / group) * ks.h;   // GQA: KV head h/group
  const T* vh = v + b * vs.b + (h / group) * vs.h;

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
                  int B, int S, int Tn, int H, int group, int hd, Strides qs,
                  Strides ks, Strides vs, float scale, int causal,
                  cudaStream_t stream) {
  auto kernel = flash_fwd<T, HD>;
  const size_t smem = Tile<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tn, H, group, hd,
      qs, ks, vs, scale, causal, vec_ok<T>(q, qs, hd), vec_ok<T>(k, ks, hd),
      vec_ok<T>(v, vs, hd));
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_hd(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int Tn, int H, int group,
                       int hd, Strides qs, Strides ks, Strides vs,
                       float scale, int causal, cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, B, S, Tn, H, group, hd, qs, ks, vs,
                         scale, causal, st);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, S, Tn, H, group, hd, qs, ks, vs,
                         scale, causal, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, B, S, Tn, H, group, hd, qs, ks, vs,
                          scale, causal, st);
  return launch<T, 256>(q, k, v, out, B, S, Tn, H, group, hd, qs, ks, vs,
                        scale, causal, st);
}

// ===================================================================
// The tensor-core kernel: bf16, hd in {64, 128}, TMA + wgmma (see the
// note at the top of the file).
// ===================================================================

constexpr int kTcBQ = 128;                // queries per CTA
constexpr int kTcBK = 64;                 // keys per K/V tile
constexpr int kTcStages = 2;              // K/V ring depth
constexpr int kTcConsumerWarps = 8;       // two warpgroups of 64 query rows
constexpr int kTcThreads = 32 * kTcConsumerWarps + 32;   // + producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcTile {
  static constexpr int HALVES = HD / 64;      // 128-byte column boxes a row
  static constexpr int Q_HALF = kTcBQ * 128;  // bytes of one Q column box
  static constexpr int KV_HALF = kTcBK * 128;
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;    // K then V
  static constexpr int BAR_OFFSET = Q_BYTES + kTcStages * STAGE_BYTES;
  // 1024 bytes of slack to put the swizzled tiles on a 1024-byte grid
  static constexpr size_t bytes =
      1024 + BAR_OFFSET + sizeof(uint64_t) * (1 + 2 * kTcStages);
};

// grid (H, B, ceil(S / 128)), the latest query tiles first; 288 threads:
// warps 0-7 are two consumer warpgroups (query rows 0-63 and 64-127 of the
// tile), warp 8 the producer. Thread layout of a consumer (the wgmma
// accumulator's): warp w of the group, lane l holds rows 16w + l/4 and
// 16w + l/4 + 8, columns 8j + 2(l%4) + {0, 1} for each 8-column group j.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ out, int S, int Tn, int H,
                 int group, float scale, int causal) {
  using L = TcTile<HD>;
  constexpr int NS = kTcBK / 2;   // score registers a lane
  constexpr int NO = HD / 2;      // output registers a lane
  constexpr int KSTEPS = kTcBK / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + L::Q_BYTES;   // stage s: K, then V
  const uint32_t bars = sQ + L::BAR_OFFSET;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kTcStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBQ;
  // keys past the tile's last query are never visited under the mask
  const int k_end = causal ? min(Tn, q0 + kTcBQ) : Tn;
  const int n_tiles = (k_end + kTcBK - 1) / kTcBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTcConsumerWarps) {
    // producer: one lane issues every copy
    if (lane == 0) {
      const int kvh = h / group;   // GQA: KV head read in place
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::HALVES; ++c)
        tma_load(sQ + c * L::Q_HALF, &qmap, q_full, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kTcStages, round = i / kTcStages;
        if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
        mbar_expect_tx(full(s), L::STAGE_BYTES);
        const uint32_t sK = sKV + s * L::STAGE_BYTES, sV = sK + L::KV_BYTES;
#pragma unroll
        for (int c = 0; c < L::HALVES; ++c) {
          tma_load(sK + c * L::KV_HALF, &kmap, full(s), 64 * c, kvh,
                   i * kTcBK, b);
          tma_load(sV + c * L::KV_HALF, &vmap, full(s), 64 * c, kvh,
                   i * kTcBK, b);
        }
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4, wi = warp % 4;
  const int q_first = q0 + 64 * wg;               // the group's first row
  const int row_a = q_first + 16 * wi + lane / 4;
  const int row_b = row_a + 8;
  const int col_l = 2 * (lane % 4);
  const uint32_t sQg = sQ + 64 * wg * 128;        // the group's 64 rows

  float o[NO], sc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kTcStages;
    const int k0 = i * kTcBK;
    const uint32_t sK = sKV + s * L::STAGE_BYTES, sV = sK + L::KV_BYTES;
    mbar_wait(full(s), (i / kTcStages) & 1);
    // a tile wholly past this group's diagonal adds nothing: skip it
    if (!causal || k0 <= q_first + 63) {
      // S = Q K^T: hd/16 steps of 16 columns, 32 bytes along each row
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::HALVES; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc,
                   sw128_desc(sQg + c * L::Q_HALF + 32 * kk, 16, 1024),
                   sw128_desc(sK + c * L::KV_HALF + 32 * kk, 16, 1024),
                   (c | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax in f32 on the accumulator layout
      const bool edge = (causal && k0 + kTcBK - 1 > q_first) ||
                        k0 + kTcBK > Tn;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale;
          if (edge) {
            const int kpos = k0 + 8 * j + col_l + (e & 1);
            const int qpos = e < 2 ? row_a : row_b;
            if (kpos >= Tn || (causal && kpos > qpos)) x = kNegInf;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], part[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // a row lives on the four lanes of one quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
      }
#pragma unroll
      for (int i2 = 0; i2 < NS; ++i2) {
        const int r = (i2 >> 1) & 1;
        sc[i2] = exp2f((sc[i2] - m[r]) * kLog2e);
        part[r] += sc[i2];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + part[r];
#pragma unroll
      for (int i2 = 0; i2 < NO; ++i2) o[i2] *= alpha[(i2 >> 1) & 1];

      // P = hi + lo, two bf16 A fragments; the accumulator's layout is
      // the A operand's: 16 keys kk hold registers 8kk .. 8kk + 7
      uint32_t hi[KSTEPS][4], lo[KSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float p0 = sc[8 * kk + 2 * t], p1 = sc[8 * kk + 2 * t + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(h2);
          hi[kk][t] = pack_bf16(h2);
          lo[kk][t] = pack_bf16(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
        }

      // O += P V: 16 keys (2048 bytes of V) a step, V MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t dv = sw128_desc(sV + 2048 * kk, L::KV_HALF, 1024);
        wgmma_rs(o, hi[kk], dv);
        wgmma_rs(o, lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // both products are done
  }

  // out = acc / max(l, 1e-30), rounded once to bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const int64_t ld = (int64_t)H * HD;
  __nv_bfloat16* oa = out + ((int64_t)b * S + row_a) * ld + (int64_t)h * HD;
  __nv_bfloat16* ob = oa + 8 * ld;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = 8 * j + col_l;
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(oa + col) = __floats2bfloat162_rn(
          o[4 * j] / l[0], o[4 * j + 1] / l[0]);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(
          o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]);
  }
}


// A (hd, heads, rows, batch) map over a bf16 tensor as it lies, boxes of
// 64 columns x box_rows rows of one head, 128-byte swizzle, rows past the
// end read as zeros.
static bool encode_map(CUtensorMap* map, const void* ptr, int hd, int heads,
                       int rows, int batch, const Strides& st,
                       int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
static int launch_tc(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int Tn, int H, int KV, Strides qs,
                     Strides ks, Strides vs, float scale, int causal,
                     cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(&qmap, q, HD, H, S, B, qs, kTcBQ) ||
      !encode_map(&kmap, k, HD, KV, Tn, B, ks, kTcBK) ||
      !encode_map(&vmap, v, HD, KV, Tn, B, vs, kTcBK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc<HD>;
  const size_t smem = TcTile<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), S, Tn, H, H / KV,
      scale, causal);
  return (int)cudaGetLastError();
}

// TMA's condition on a bf16 tensor: base address and strides (positive)
// on the 16-byte grid.
static bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b > 0 &&
         st.s > 0 && st.h > 0 && st.b % 8 == 0 && st.s % 8 == 0 &&
         st.h % 8 == 0;
}

}  // namespace rt

// Both entry points: q (B, S, H, hd), k and v (B, T, KV, hd) with H % KV
// == 0 (query head h reads KV head h / (H / KV)); strides in elements,
// each (batch, sequence, head), the hd axis of stride 1; out (B, S, H, hd)
// contiguous, in q's dtype.

// The CUDA-core kernel: f32 or bf16, hd <= 256.
extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int S, int T, int H, int KV, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale, int causal,
    void* stream) {
  using namespace rt;
  if (B < 1 || S < 1 || T < 1 || H < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > 256 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_hd<float>(q, k, v, out, B, S, T, H, H / KV, hd, qs, ks,
                              vs, scale, causal, st);
  if (dtype == kBF16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, S, T, H, H / KV, hd,
                                      qs, ks, vs, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: bf16, hd 64 or 128, every base address and
// stride on the 16-byte grid, the strides positive.
extern "C" int rt_flash_attention_tc(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int T, int H, int KV, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale, int causal,
    void* stream) {
  using namespace rt;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  if (B < 1 || S < 1 || T < 1 || H < 1 || KV < 1 || H % KV != 0 ||
      B > 65535 || S > 65535 * kTcBQ || !aligned16(q, qs) ||
      !aligned16(k, ks) || !aligned16(v, vs))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_tc<64>(q, k, v, out, B, S, T, H, KV, qs, ks, vs, scale,
                         causal, st);
  if (hd == 128)
    return launch_tc<128>(q, k, v, out, B, S, T, H, KV, qs, ks, vs, scale,
                          causal, st);
  return (int)cudaErrorInvalidValue;
}
