// Kernel A: out = A^T B for a tall-skinny A (p, k) and B (p, m), f32 out;
// gram (A = B, k = m) computes the upper triangle and mirrors it.
//
// Replaces src/repro/kernels/nystrom_gram.py:_gram_kernel (nystrom_gram,
// A = B = C) and :_cross_kernel (nystrom_cross, the m-query C^T V).
//
// What bounds it on an H100: each row of A (k values) and of B (m values)
// is read once and used in k*m multiply-adds. Gram at k = 64 has k(k+1)/2
// distinct entries, 2080 multiply-adds per 256-byte f32 row, 16 FLOP per
// byte: under the fp32 CUDA-core ridge of about 20 (H100 SXM data sheet,
// 700 W: 67 TFLOP/s over 3.35 TB/s), so bytes set its least time, with
// little room: the CUDA cores must run near their peak to keep up. The
// cross at k = 64, m = 32 does 2*64*32 FLOP per 384 bytes (about 11 per
// byte) and the main path's k = 10 shapes fewer still: bound by bytes. A
// bf16 sketch halves the bytes and doubles the FLOP per byte, beyond what
// the CUDA cores can give at the memory's rate; the tensor cores take it.
//
// Both variants cut the k x m result into 64 x 64 output tiles (gridDim.x;
// gram takes only the tiles on or above the diagonal) and p into one
// contiguous run of rows per block (gridDim.y, a multiple of kStageRows
// rows each). The tiles are the grid's fast dimension, so the blocks that
// run together are mostly the tiles of one run of rows, which then reads
// from L2 for all but the first of them. Each block sums its rows in two
// levels, a stage of 128 rows at a time added into a running f32 sum, so
// the rounding of a long run grows with its count of stages; it writes its
// partial sums to f32 scratch, and reduce_partials (reduce_columns from
// 65,536 outputs on) adds the blocks' partials in a fixed order (gram
// reading the upper triangle for both halves, so G equals G^T bit for
// bit). No atomics: two calls give the same bits. Any k and m with
// k m < 2^31 (an 8 GB result): the wrapper caps gridDim.y so that the
// scratch, gridDim.y k m floats, stays within _lib.ATB_SCRATCH_BYTES (one
// block where one partial alone is larger).
//
// atb_cc<TA, TB, V, STAGES, SYM> -- IEEE f32 on the CUDA cores, any
// f32/bf16 mix (TF32 is not allowed: f32 means IEEE f32); SYM: gram's.
//   * Register tiles: a thread owns an 8 x 8 tile of outputs. Per row it
//     loads its 8 values of A and 8 of B from shared memory (16-byte loads
//     where each staged row is whole 16-byte chunks, V), the next row's
//     before this row's 64 FMAs: 16 FMAs per shared load, against 1/2
//     before.
//   * Thread groups: the tile's thread tiles form a group; a block holds
//     up to 64 groups (256 threads: at 8 warps ptxas may give a thread 255
//     registers, where 10 capped it at 168 and spilled), which take the
//     stage's rows in turn and fold their sums in a fixed tree at the end.
//   * Gram's diagonal tile: the 28 thread tiles above the diagonal (at
//     k = 64) run as above; each of the 8 on it computes its 36 distinct
//     entries from one 8-value load, in half as many groups taking twice
//     the rows, so both roles take about as long a stage: 2080 FMAs a row,
//     k(k+1)/2, and 256 threads in 8 warps, 2 on each scheduler.
//   * Staging: a ring of 128-row stages (4, or 3 where 4 would not fit
//     200 KB), filled with cp.async (16 bytes a thread, bypassing L1); one
//     barrier a stage, after which the copy of stage s + 3 goes into the
//     slot stage s - 1 has left. Where k <= 64 the rows of a stage are one
//     contiguous span of 128 k elem bytes; wider operands copy their
//     64-column slice row by row. Data stays in its own type in shared
//     memory; bf16 is widened to f32 in registers after the load. Operands
//     off the 16-byte grid, rows that are not whole 16-byte chunks (bf16
//     k = 100) and a span's ragged tail take plain loads.
//   * What holds it: the shared-memory pipe and the FMA pipe together.
//     Each thread's 16 shared values per 64 FMAs keep the one about as busy
//     as the other, and neither the FMAs alone nor the copies alone reach
//     their peak (variants on an H100 with the global copies, the shared
//     loads or the FMAs dropped in turn; PERF.md). 4 x 8 tiles (twice the
//     warps, more shared loads per FMA) and interleaved columns were not
//     faster.
//
// atb_tc -- bf16 x bf16 where k and m are multiples of 8 and both base
// addresses lie on the 16-byte grid (what TMA can address): the gram of a
// bf16 sketch and a bf16 cross. Each bf16 product is exact in f32, so
// wgmma with f32 accumulators keeps the reference's contract (bf16
// storage, f32 accumulation).
//   * One producer warp issues TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle) of 64-column x 128-row boxes into a 4-stage ring; one
//     consumer warpgroup waits on a "full" mbarrier (bytes counted) and
//     releases the stage on an "empty" one (4 warp arrivals). TMA reads
//     columns past k or m and rows past p as zeros.
//   * Products: wgmma m64n64k16, M = 64 columns of A, N = 64 columns of B
//     (a 32-column B is a 64-column box half zeros), depth 16 rows of p.
//     Both operands are MN-major in shared memory (a staged row is
//     contiguous along M for A and along N for B): the transpose bits, with
//     the descriptor of flash_fwd_tc's V (+2048 bytes per 16 rows, SBO =
//     1024). The 8 k-steps of a stage accumulate in the tensor cores; the
//     stage's sum is then added into the running f32 sum in registers.
#include "hopper.cuh"

namespace rt {

constexpr int kTileN = 64;        // output tile edge
constexpr int kStageRows = 128;   // rows of p in one stage (both variants)

// An output tile: rows i0.. of the result (columns of A), columns j0..
// (columns of B), kt x mt entries; gram's tiles on the diagonal are diag.
struct OutTile {
  int i0, j0, kt, mt;
  bool diag;
};

__host__ __device__ inline int n_tiles(int n) {
  return (n + kTileN - 1) / kTileN;
}

// Tile t (blockIdx.x): gram walks the upper triangle row by row.
__device__ inline OutTile out_tile(int64_t t, int k, int m, int sym) {
  int a = 0, b;
  if (sym) {
    const int nk = n_tiles(k);
    while (t >= nk - a) {
      t -= nk - a;
      ++a;
    }
    b = a + (int)t;
  } else {
    a = (int)(t / n_tiles(m));
    b = (int)(t - (int64_t)a * n_tiles(m));
  }
  OutTile o;
  o.i0 = a * kTileN;
  o.j0 = b * kTileN;
  o.kt = min(kTileN, k - o.i0);
  o.mt = min(kTileN, m - o.j0);
  o.diag = sym && a == b;
  return o;
}

static int64_t out_tile_count(int k, int m, int sym) {
  const int64_t nk = n_tiles(k);
  return sym ? nk * (nk + 1) / 2 : nk * n_tiles(m);
}

// ===================================================================
// atb_cc: CUDA cores, IEEE f32
// ===================================================================

constexpr int kCcRingBytes = 200 * 1024;   // the ring's most
constexpr int kTR = 8;       // a thread tile: 8 columns of A ...
constexpr int kTC = 8;       // ... by 8 columns of B
constexpr int kCcMaxThreads = 256;   // 8 warps: ptxas may use 255 registers
constexpr int kCcMaxGroups = 64;
constexpr int kSlack = 16;   // values after a staged operand: tiles read
                             // up to 8 columns past a ragged width

enum CopyMode : int { kPlain = 0, kRows = 1, kSpan = 2 };

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Bytes of one stage of an operand whose staged slice is w values wide.
template <typename T>
__host__ __device__ inline int stage_bytes(int w) {
  return align16((kStageRows * w + kSlack) * (int)sizeof(T));
}

// One stage of the ring: A's slice, then B's unless B is A's only tile
// (gram with k <= 64).
template <typename TA, typename TB>
__host__ __device__ inline int ring_stride(int k, int m, int sym) {
  const int a = stage_bytes<TA>(k < kTileN ? k : kTileN);
  return (sym && k <= kTileN) ? a
                              : a + stage_bytes<TB>(m < kTileN ? m : kTileN);
}

// Thread groups of a block of `threads` threads: as many as fit, a power
// of two, at most kCcMaxGroups. A full output tile has tiles = (kt/8) x
// (mt/8) thread tiles a group. Gram's diagonal output tile splits its
// thread tiles on or above the diagonal in two roles: the na "self" tiles
// (a, a), whose 36 distinct entries need only a's 8 values, and the
// na (na - 1) / 2 tiles (a < b); the self role has half the groups, each
// taking twice the rows, so that the two roles' work per row is even.
__host__ __device__ inline int full_groups(int tiles, int threads) {
  int g = 1;
  while (2 * g <= kCcMaxGroups && 2 * g * tiles <= threads) g *= 2;
  return g;
}

__host__ __device__ inline int diag_groups(int na, int threads) {
  const int off = na * (na - 1) / 2;
  int g = 1;
  while (2 * g <= kCcMaxGroups && na * g + off * 2 * g <= threads) g *= 2;
  return g;   // the off-diagonal role's; the self role has max(1, g / 2)
}

// What a thread does: its 8 x 8 tile (pa, pb), its group g of `groups`,
// its index `pair` among the `tiles` tiles of its role.
struct Role {
  int pa, pb, g, groups, tiles, pair;
  bool self, active;
};

__device__ inline Role role_of(const OutTile& t) {
  const int na = (t.kt + kTR - 1) / kTR, nb = (t.mt + kTC - 1) / kTC;
  Role r;
  int tid = threadIdx.x;
  r.self = false;
  if (!t.diag) {
    r.tiles = na * nb;
    r.groups = full_groups(r.tiles, blockDim.x);
  } else {
    const int go = diag_groups(na, blockDim.x), gs = go > 1 ? go / 2 : 1;
    r.self = tid < na * gs;
    if (r.self) {
      r.tiles = na;
      r.groups = gs;
    } else {
      tid -= na * gs;
      r.tiles = na * (na - 1) / 2;
      r.groups = go;
    }
  }
  r.active = r.tiles > 0 && tid / max(r.tiles, 1) < r.groups;
  r.pair = r.tiles > 0 ? tid % r.tiles : 0;
  r.g = r.tiles > 0 ? tid / r.tiles : 0;
  if (r.self) {
    r.pa = r.pb = r.pair;
  } else if (t.diag) {   // a < b, column tile by column tile
    int q = r.pair;
    r.pb = 1;
    while (q >= r.pb) {
      q -= r.pb;
      ++r.pb;
    }
    r.pa = q;
  } else {
    r.pa = r.pair / nb;
    r.pb = r.pair - r.pa * nb;
  }
  return r;
}

// Rows [r, r + rows) of the slice X[:, c0 : c0 + w] of a row-major
// (p, ld) matrix into dst, packed as rows of w values of T.
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* __restrict__ X,
                                           int64_t r, int rows, int ld,
                                           int c0, int w, int mode) {
  constexpr int E = 16 / sizeof(T);   // values per 16-byte chunk
  const int tid = threadIdx.x, nthr = blockDim.x;
  if (mode == kSpan) {   // w == ld: the rows are one contiguous span
    const T* src = X + r * ld;
    const int n = rows * ld, chunks = n / E;
    for (int c = tid; c < chunks; c += nthr)
      cp_async16(dst + c * E, src + c * E);
    for (int e = chunks * E + tid; e < n; e += nthr) dst[e] = src[e];
  } else if (mode == kRows) {   // each row's slice is whole chunks
    const int cpr = w / E;
    for (int c = tid; c < rows * cpr; c += nthr) {
      const int rr = c / cpr, cc = c - rr * cpr;
      cp_async16(dst + rr * w + cc * E, X + (r + rr) * ld + c0 + cc * E);
    }
  } else {
    for (int e = tid; e < rows * w; e += nthr) {
      const int rr = e / w, cc = e - rr * w;
      dst[e] = X[(r + rr) * ld + c0 + cc];
    }
  }
}

// A thread tile's 8 staged values widened to f32; V: 16-byte shared loads.
template <typename T, bool V>
__device__ __forceinline__ void load8(const T* s, float (&x)[8]) {
  if constexpr (V) {
    widen16<T>(*reinterpret_cast<const uint4*>(s), x);
    if constexpr (sizeof(T) == 4)
      widen16<T>(*reinterpret_cast<const uint4*>(s + 4), x + 4);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = to_f32(s[e]);
  }
}

__device__ __forceinline__ void outer_fma(float (&s)[kTR][kTC],
                                          const float (&a)[kTR],
                                          const float (&b)[kTC]) {
#pragma unroll
  for (int x = 0; x < kTR; ++x)
#pragma unroll
    for (int y = 0; y < kTC; ++y) s[x][y] = fmaf(a[x], b[y], s[x][y]);
}

// the upper triangle of a a^T (a self tile of gram's diagonal)
__device__ __forceinline__ void self_fma(float (&s)[kTR][kTC],
                                         const float (&a)[kTR]) {
#pragma unroll
  for (int x = 0; x < kTR; ++x)
#pragma unroll
    for (int y = x; y < kTC; ++y) s[x][y] = fmaf(a[x], a[y], s[x][y]);
}

// Rows g, g + groups, ... < rows of a stage into sum (zeroed first), the
// next row's values loaded before this row's FMAs.
template <typename TA, typename TB, bool V, bool SELF>
__device__ __forceinline__ void stage_sum(float (&sum)[kTR][kTC],
                                          const TA* xa, int lda,
                                          const TB* xb, int ldb, int g,
                                          int groups, int rows) {
#pragma unroll
  for (int x = 0; x < kTR; ++x)
#pragma unroll
    for (int y = 0; y < kTC; ++y) sum[x][y] = 0.f;
  float va[kTR], vb[kTC];
  if (g < rows) {
    load8<TA, V>(xa + g * lda, va);
    if (!SELF) load8<TB, V>(xb + g * ldb, vb);
  }
#pragma unroll 2
  for (int rr = g; rr < rows; rr += groups) {
    const int nr = rr + groups < rows ? rr + groups : rr;
    float va_next[kTR], vb_next[kTC];
    load8<TA, V>(xa + nr * lda, va_next);
    if (SELF) {
      self_fma(sum, va);
    } else {
      load8<TB, V>(xb + nr * ldb, vb_next);
      outer_fma(sum, va, vb);
    }
#pragma unroll
    for (int e = 0; e < kTR; ++e) va[e] = va_next[e];
    if (!SELF) {
#pragma unroll
      for (int e = 0; e < kTC; ++e) vb[e] = vb_next[e];
    }
  }
}

template <typename TA, typename TB, bool V, int STAGES, bool SYM>
__global__ void __launch_bounds__(kCcMaxThreads, 1)
    atb_cc(const TA* __restrict__ A, const TB* __restrict__ B,
           float* __restrict__ partial, int64_t p, int k, int m, int sym,
           int64_t rows_per_block, int mode_a, int mode_b) {
  extern __shared__ __align__(16) uint8_t smem[];
  const OutTile t = out_tile(blockIdx.x, k, m, sym);
  const int a_bytes = stage_bytes<TA>(min(k, kTileN));
  const int stride = ring_stride<TA, TB>(k, m, sym);
  auto sa = [&](int s) {
    return reinterpret_cast<TA*>(smem + (s % STAGES) * stride);
  };
  auto sb = [&](int s) {   // gram's diagonal tile reads A's stage
    return t.diag ? reinterpret_cast<TB*>(sa(s))
                  : reinterpret_cast<TB*>(smem + (s % STAGES) * stride +
                                          a_bytes);
  };
  const int ldb = t.diag ? t.kt : t.mt;   // staged row lengths: t.kt, ldb

  const Role me = role_of(t);   // t.diag only where SYM

  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = imin(p, r0 + rows_per_block);
  const int nst = (int)((r1 - r0 + kStageRows - 1) / kStageRows);
  auto stage_rows = [&](int s) {
    return (int)imin(kStageRows, r1 - r0 - (int64_t)s * kStageRows);
  };
  auto issue = [&](int s) {
    const int64_t r = r0 + (int64_t)s * kStageRows;
    stage_copy(sa(s), A, r, stage_rows(s), k, t.i0, t.kt, mode_a);
    if (!t.diag) stage_copy(sb(s), B, r, stage_rows(s), m, t.j0, t.mt, mode_b);
  };

  float acc[kTR][kTC];
#pragma unroll
  for (int x = 0; x < kTR; ++x)
#pragma unroll
    for (int y = 0; y < kTC; ++y) acc[x][y] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();   // stage s has landed (this thread's)
    __syncthreads();   // ... and every thread's; stage s - 1 is done with
    if (s + STAGES - 1 < nst) issue(s + STAGES - 1);   // its slot
    cp_async_commit();
    if (me.active) {
      const TA* xa = sa(s) + kTR * me.pa;
      const TB* xb = sb(s) + kTC * me.pb;
      // two-level sum: this stage's rows first, then the running sum
      float sum[kTR][kTC];
      if (SYM && me.self)   // compiled only into gram's kernels
        stage_sum<TA, TB, V, SYM>(sum, xa, t.kt, xb, ldb, me.g, me.groups,
                                  stage_rows(s));
      else
        stage_sum<TA, TB, V, false>(sum, xa, t.kt, xb, ldb, me.g, me.groups,
                                    stage_rows(s));
#pragma unroll
      for (int x = 0; x < kTR; ++x)
#pragma unroll
        for (int y = 0; y < kTC; ++y) acc[x][y] += sum[x][y];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // fold each role's groups in a fixed tree: groups [h, n) hand their
  // sums to [0, n - h) through shared memory (the ring's space), slot-major
  // so that neighbouring threads write neighbouring words. Every thread
  // runs both roles' rounds (the block's barriers), active in its own.
  constexpr int NT = kTR * kTC;
  float* red = reinterpret_cast<float*>(smem);
  for (int self = 0; self < (SYM && t.diag ? 2 : 1); ++self) {
    const bool mine = me.active && me.self == (self == 1);
    // the role's group count, the same in every thread of the block
    int n = me.groups;
    if (t.diag) {
      const int go = diag_groups((t.kt + kTR - 1) / kTR, blockDim.x);
      n = self ? (go > 1 ? go / 2 : 1) : go;
    }
    while (n > 1) {
      const int h = (n + 1) / 2, slots = (n - h) * me.tiles;
      if (mine && me.g >= h && me.g < n) {
        const int slot = (me.g - h) * me.tiles + me.pair;
#pragma unroll
        for (int e = 0; e < NT; ++e)
          red[e * slots + slot] = acc[e / kTC][e % kTC];
      }
      __syncthreads();
      if (mine && me.g < n - h) {
        const int slot = me.g * me.tiles + me.pair;
#pragma unroll
        for (int e = 0; e < NT; ++e)
          acc[e / kTC][e % kTC] += red[e * slots + slot];
      }
      __syncthreads();
      n = h;
    }
  }
  if (me.active && me.g == 0) {
    // a diagonal tile's entries on or above the diagonal, each computed by
    // exactly one thread
    float* out = partial + (int64_t)blockIdx.y * k * m;
#pragma unroll
    for (int x = 0; x < kTR; ++x) {
      const int ci = kTR * me.pa + x;
#pragma unroll
      for (int y = 0; y < kTC; ++y) {
        const int cj = kTC * me.pb + y;
        if (ci < t.kt && cj < t.mt && !(t.diag && ci > cj))
          out[(int64_t)(t.i0 + ci) * m + t.j0 + cj] = acc[x][y];
      }
    }
  }
}

// How an operand's stages come in: a contiguous span where one tile spans
// its whole row (ld <= 64), 16-byte chunks per row where every 64-column
// slice is whole chunks, plain loads off the 16-byte grid.
template <typename T>
static int copy_mode(const void* X, int ld) {
  if (reinterpret_cast<uintptr_t>(X) % 16 != 0) return kPlain;
  if (ld <= kTileN) return kSpan;
  return (ld * (int)sizeof(T)) % 16 == 0 ? kRows : kPlain;
}

template <typename TA, typename TB, bool SYM>
static int launch_cc(const void* A, const void* B, float* partial,
                     int64_t p, int k, int m, int sym, int nblocks,
                     int64_t rows_per_block, cudaStream_t stream) {
  // the block's size: as many groups as fit in 256 threads for gram's one
  // diagonal tile (k <= 64), else for a full 64 x 64 or k x m tile
  const int na = (min(k, kTileN) + kTR - 1) / kTR;
  int used;
  if (sym && k <= kTileN) {
    const int go = diag_groups(na, kCcMaxThreads);
    used = na * (go > 1 ? go / 2 : 1) + na * (na - 1) / 2 * go;
  } else {
    const int tiles = na * ((min(sym ? k : m, kTileN) + kTC - 1) / kTC);
    used = tiles * full_groups(tiles, kCcMaxThreads);
  }
  const int threads = (used + 31) / 32 * 32;
  // a 4-stage ring where it fits in kCcRingBytes (f32 slices up to 64 +
  // 32 columns wide), else 3 stages
  const int stride = ring_stride<TA, TB>(k, m, sym);
  const bool deep = 4 * stride <= kCcRingBytes;
  const int ring = (deep ? 4 : 3) * stride;
  const int red = 4 * kTR * kTC * (threads / 2 + 1);   // the fold's space
  const int smem = ring > red ? ring : red;
  // vector shared loads where every staged row is whole 16-byte chunks
  const bool vec = (k * (int)sizeof(TA)) % 16 == 0 &&
                   (m * (int)sizeof(TB)) % 16 == 0;
  auto kernel = vec ? (deep ? atb_cc<TA, TB, true, 4, SYM>
                             : atb_cc<TA, TB, true, 3, SYM>)
                    : (deep ? atb_cc<TA, TB, false, 4, SYM>
                            : atb_cc<TA, TB, false, 3, SYM>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)out_tile_count(k, m, sym), nblocks);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B), partial, p, k, m,
      sym, rows_per_block, copy_mode<TA>(A, k), copy_mode<TB>(B, m));
  return (int)cudaGetLastError();
}

// ===================================================================
// atb_tc: bf16 x bf16 on the tensor cores (TMA + wgmma)
// ===================================================================

constexpr int kTcRing = 4;
constexpr int kTcBox = kStageRows * 128;   // 64 bf16 columns x 128 rows
constexpr int kTcThreadsA = 128 + 32;      // one warpgroup + producer warp
constexpr size_t kTcSmem = 1024 + 2 * kTcRing * kTcBox + 16 * kTcRing;

__global__ void __launch_bounds__(kTcThreadsA, 1)
    atb_tc(const __grid_constant__ CUtensorMap amap,
           const __grid_constant__ CUtensorMap bmap,
           float* __restrict__ partial, int64_t p, int k, int m, int sym,
           int64_t rows_per_block) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + 2 * kTcRing * kTcBox;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kTcRing + s); };
  auto box_a = [&](int s) { return base + 2 * s * kTcBox; };
  auto box_b = [&](int s) { return base + (2 * s + 1) * kTcBox; };
  const OutTile t = out_tile(blockIdx.x, k, m, sym);
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = imin(p, r0 + rows_per_block);
  const int nst = (int)((r1 - r0 + kStageRows - 1) / kStageRows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcRing; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: one lane issues every copy; stage s uses slot s % 4
    if (lane == 0) {
      for (int s = 0; s < nst; ++s) {
        const int b = s % kTcRing, round = s / kTcRing;
        if (round > 0) mbar_wait(empty(b), (round - 1) & 1);
        mbar_expect_tx(full(b), (t.diag ? 1 : 2) * kTcBox);
        const int row = (int)(r0 + (int64_t)s * kStageRows);
        tma_load_2d(box_a(b), &amap, full(b), t.i0, row);
        if (!t.diag) tma_load_2d(box_b(b), &bmap, full(b), t.j0, row);
      }
    }
    return;
  }

  // consumer warpgroup; accumulator layout: warp w, lane l holds rows
  // 16w + l/4 (+ 8) of the tile, columns 8j + 2(l % 4) + {0, 1}
  float acc[32], d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = d[i] = 0.f;
  for (int s = 0; s < nst; ++s) {
    const int b = s % kTcRing;
    mbar_wait(full(b), (s / kTcRing) & 1);
    const uint32_t sa = box_a(b), sb = t.diag ? sa : box_b(b);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageRows / 16; ++kk)
      wgmma_ss<1, 1>(d, sw128_desc(sa + 2048 * kk, kTcBox, 1024),
                     sw128_desc(sb + 2048 * kk, kTcBox, 1024), kk != 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(b));   // the stage's products are done
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += d[i];
  }

  float* out = partial + (int64_t)blockIdx.y * k * m;
  const int row = 16 * warp + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row + (e >= 2 ? 8 : 0), jj = 8 * j + col + (e & 1);
      if (i < t.kt && jj < t.mt)
        out[(int64_t)(t.i0 + i) * m + t.j0 + jj] = acc[4 * j + e];
    }
}

// A (cols, rows) map over a row-major bf16 matrix, boxes of 64 columns x
// 128 rows, 128-byte swizzle, reads past the edges as zeros.
static bool encode_rows(CUtensorMap* map, const void* ptr, int cols,
                        int64_t rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {kTileN, kStageRows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static int launch_tc(const void* A, const void* B, float* partial, int64_t p,
                     int k, int m, int sym, int nblocks,
                     int64_t rows_per_block, cudaStream_t stream) {
  if (k % 8 != 0 || m % 8 != 0 || p >= (int64_t)1 << 31 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  if (!encode_rows(&amap, A, k, p) || !encode_rows(&bmap, B, m, p))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      atb_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)out_tile_count(k, m, sym), nblocks);
  atb_tc<<<grid, kTcThreadsA, kTcSmem, stream>>>(amap, bmap, partial, p, k, m,
                                                 sym, rows_per_block);
  return (int)cudaGetLastError();
}

// out[o] = sum over b of partial[b * n + o] for results of kColumnsFrom
// outputs or more, where reduce_partials would launch a block of 256
// threads per output: here one thread an output, b in order, neighbouring
// threads on neighbouring words. sym_k as in reduce_partials: out[i, j]
// with i > j is summed from entry (j, i), in the same order, so the result
// is exactly symmetric.
constexpr int kColumnsFrom = 65536;

static __global__ void reduce_columns(const float* __restrict__ partial,
                                      float* __restrict__ out, int nblocks,
                                      int n, int sym_k) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= n) return;
  int src = o;
  if (sym_k > 0) {
    const int i = o / sym_k, j = o - i * sym_k;
    if (i > j) src = j * sym_k + i;
  }
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[(int64_t)b * n + src];
  out[o] = s;
}

}  // namespace rt

// partial holds nblocks * k * m floats; out holds k * m floats (row-major
// (k, m)). sym: A is B (gram), only the upper triangle is computed and
// mirrored. tensor_cores: atb_tc (bf16 x bf16, k and m multiples of 8, both
// bases on the 16-byte grid), else atb_cc. rows_per_block is a multiple of
// 128, nblocks at most 65,535 (gridDim.y). Any k, m >= 1 with k m < 2^31.
// Returns cudaGetLastError() after both launches.
extern "C" int rt_atb(const void* A, int a_dtype, const void* B, int b_dtype,
                      void* partial, void* out, long long p, int k, int m,
                      int sym, int tensor_cores, int nblocks,
                      long long rows_per_block, void* stream) {
  using namespace rt;
  if (k < 1 || m < 1 || nblocks < 1 || nblocks > kMaxGridY || p < 1 ||
      (int64_t)k * m > INT32_MAX ||
      rows_per_block % kStageRows != 0 ||
      (int64_t)nblocks * rows_per_block < p ||
      (sym && (A != B || k != m || a_dtype != b_dtype)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  int code;
  if (tensor_cores)
    code = (a_dtype == kBF16 && b_dtype == kBF16)
               ? launch_tc(A, B, part, p, k, m, sym, nblocks, rows_per_block,
                           s)
               : (int)cudaErrorInvalidValue;
  else if (a_dtype == kF32 && b_dtype == kF32)
    code = sym ? launch_cc<float, float, true>(A, B, part, p, k, m, sym,
                                               nblocks, rows_per_block, s)
               : launch_cc<float, float, false>(A, B, part, p, k, m, sym,
                                                nblocks, rows_per_block, s);
  else if (a_dtype == kBF16 && b_dtype == kF32)
    code = launch_cc<__nv_bfloat16, float, false>(
        A, B, part, p, k, m, sym, nblocks, rows_per_block, s);
  else if (a_dtype == kF32 && b_dtype == kBF16)
    code = launch_cc<float, __nv_bfloat16, false>(
        A, B, part, p, k, m, sym, nblocks, rows_per_block, s);
  else if (a_dtype == kBF16 && b_dtype == kBF16)
    code = sym ? launch_cc<__nv_bfloat16, __nv_bfloat16, true>(
                     A, B, part, p, k, m, sym, nblocks, rows_per_block, s)
               : launch_cc<__nv_bfloat16, __nv_bfloat16, false>(
                     A, B, part, p, k, m, sym, nblocks, rows_per_block, s);
  else
    code = (int)cudaErrorInvalidValue;
  if (code != 0) return code;
  const int n = k * m;
  if (n < kColumnsFrom)
    reduce_partials<<<n, kThreads, 0, s>>>(part, static_cast<float*>(out),
                                           nblocks, n, sym ? k : 0);
  else
    reduce_columns<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        part, static_cast<float*>(out), nblocks, n, sym ? k : 0);
  return (int)cudaGetLastError();
}
