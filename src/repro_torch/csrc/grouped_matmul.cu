// Grouped GEMMs of the MoE expert FFN, in both dispatch layouts, with their
// input (dX) and weight (dW) gradients.
//
// Dropless block layout.  Replaces: src/repro/kernels/grouped_matmul.py,
// grouped_matmul_blocks_pallas (_gmm_blocks_kernel): x [n, B, K] row tiles,
// tile i multiplied by its own expert's weights w[be[i]] [K, N], f32
// accumulation cast to x's dtype.  The same kernel with the
// transposed-weight flag reads w[e] stored [N, K] and computes
// dX = dY @ w[e]^T without a copy.  The weight gradient has no TPU kernel
// (the JAX package differentiates its jnp reference):
// dW[e] = sum over the tiles i with be[i] == e of x[i]^T dY[i], f32
// accumulation stored in the weight's dtype.
//
// Capacity layout.  Replaces: src/repro/kernels/grouped_matmul.py,
// grouped_matmul_pallas (_gmm_kernel): x [E, C, K] @ w [E, K, N] ->
// [E, C, N], the GShard/Switch token-dropping buffers (dispatch="capacity"),
// C a multiple of 4, empty slots zero rows.  dX reads w[e] transposed in
// place as above; dW[e] = x[e]^T dY[e] sums expert e's C rows in order.
//
// What bounds them on an H100: bytes.  At Mixtral's training step (T = 512
// tokens -> 1024 choices -> 135 tiles of B = 8 rows, or C = 200 capacity
// slots) a w_in forward or dX call reads 8 experts x 4096 x 14336 bf16 =
// 0.94 GB of weights and does 2 x 1080 x 4096 x 14336 = 127 GFLOP: 0.28 ms
// at 3.35 TB/s against 0.13 ms at 989 TFLOP/s; a dW call writes those 0.94
// GB.  The Pallas grid walked (tile, F block, D block) and re-read an
// expert's weights for every 8-row tile.
//
// bf16 (the training path) runs on Hopper's tensor cores with the pieces of
// hopper.cuh: TMA tensor maps (128-byte swizzle, zeros past every edge on
// load, clipped on store), a ring of stages guarded by "full" / "empty"
// mbarriers, one producer warpgroup (one thread issues every TMA load) and
// two consumer warpgroups running wgmma m64n128k16 with f32 accumulators in
// registers (setmaxnreg moves registers from the producer to them), and
// 2-CTA clusters that TMA-multicast the operand both CTAs share.  Every
// wgmma is issued unconditionally, with waits and predicates inside PTX: a
// branch around them makes ptxas serialise the wgmma pipeline (C7520).
//
// Forward and dX, both layouts (gmm_wgmma_kernel): a block owns up to 256
// rows of ONE expert and a 128-column output tile, and streams (x, w)
// 64-deep through a 4-stage ring of 48 KB stages; each weight element is
// read from HBM once per 256 rows of its expert, and the row chunks of one
// (expert, column tile) are adjacent in launch order, so they meet in L2.
// The forward's w[e] [K, N] is wgmma's MN-major B (transpose bit); dX reads
// w[e] [N_out, K_red] as the K-major B: neither copies.  The x tile is
// re-read for every 128 columns, from L2; a cluster of two adjacent column
// tiles loads half of it into both CTAs.  The epilogue stages bf16 in
// swizzled shared memory and TMA-stores it.
//   capacity: blockIdx = (256-row chunk of C, column tile, expert); maps
//   over [E, C, .], rows past C load as zeros and are not stored.
//   dropless: blockIdx.x is a RUN slot: up to 32 consecutive tiles (256
//   rows) of one expert counted from its first tile, found on the device
//   from be alone (one pass over be into a shared-memory table of the
//   experts' first tiles, then a warp prefix sum over the experts' run
//   counts): no host sync.  be is non-decreasing (the dropless
//   plan sorts choices by expert and clips its trailing padding tiles to the
//   last expert), so an expert owns one contiguous range of tiles.  x and
//   out are [1, n * 8, .] maps: the 128-row x boxes of a short run read the
//   next expert's rows, which are multiplied and never stored (another
//   block owns them): the epilogue stores only the run's whole tiles, each
//   an 8-row x 128-byte box, one 1024-byte swizzle atom of the staging
//   buffer.  The grid is a host-side bound on the runs, ceil(n / 32) +
//   min(E, n) slots; a block past the last run leaves at once (both CTAs
//   of a cluster share its slot, so they decide alike).
//
// dW, both layouts (gmm_dw_wgmma_kernel): dW[e] = x_e^T dY_e, a short
// reduction (the expert's rows: C = 200, ~135 dropless) into a wide output
// ([K, N] per expert).  Persistent 2-CTA clusters walk (expert, 256-row K
// tile, pair of 128-column N tiles) in that order.  A = x_e^T is wgmma's
// MN-major A (transpose bit): 64-row x 64-column boxes of x put d_model
// contiguous; the cluster's two CTAs (adjacent N tiles) each load half of
// it into both.  B = dY_e is the MN-major B, as the forward's w tile.  The
// ring has 3 stages of 64 rows; a 64 KB staging buffer apart from it lets a
// tile's TMA store and the producer's loads of the next tile run while the
// consumers convert.  Capacity maps are [E, C, .] (rows past C load as
// zeros).  Dropless boxes start at the expert's first row (the experts'
// first rows come from one pass over be into shared memory); the rows past
// its last row belong to the next expert and are zeroed in shared memory,
// in both operands, after the stage's "full" wait (proxy fence, named
// barrier).  An expert without rows stores exact zeros.
//
// f32 runs the CUDA-core kernels with one shared-memory stage: dropless
// forward / dX blocks of 64 rows (a run of 8 tiles) x 128 columns,
// capacity 256 rows x 64 columns, dW 64 x 128 tiles of dW[e].
//
// Both layouts: no atomics, no split of a reduction.  Every output element
// sums its products in one order fixed by the reduction index alone (dW: by
// the expert's own rows, from its first row, k16 steps in order; zero rows
// add exact zeros), so two calls agree bit for bit and an expert's results
// do not depend on the slot it occupies.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;     // output rows per block
constexpr int BN = 128;    // output columns per block
constexpr int BK = 32;     // reduction depth per shared-memory stage
constexpr int kTileRows = 8;                 // rows of one dispatch tile
constexpr int kRunTiles = BM / kTileRows;    // tiles per forward run
constexpr int kMaxExperts = 1 << 16;

template <typename T>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int PAD = VEC;             // keeps 16-byte rows and spreads banks
  static constexpr int A_LD = BK + PAD;       // As [BM][A_LD]
  static constexpr int B_LD = BN + PAD;       // Bs [BK][B_LD]
  static constexpr size_t SMEM = (BM * A_LD + BK * B_LD) * sizeof(T);
};

// dst[r][c] (row stride dst_ld) <- tile of a global matrix, zero outside
// r < r_lim, c < c_lim (tile-local limits).  kColMajor = false:
// src[(r0 + r) * ld + c0 + c] (contiguous along c); true:
// src[(c0 + c) * ld + r0 + r] (contiguous along r).  16-byte loads along the
// contiguous dimension.
template <typename T, int R, int C, bool kColMajor>
__device__ __forceinline__ void load_tile(T* dst, int dst_ld, const T* __restrict__ src,
                                          size_t ld, int r0, int c0, int r_lim, int c_lim) {
  constexpr int VEC = Layout<T>::VEC;
  if constexpr (!kColMajor) {
    constexpr int NV = C / VEC;
    for (int idx = threadIdx.x; idx < R * NV; idx += kThreads) {
      const int r = idx / NV;
      const int c = (idx % NV) * VEC;
      alignas(16) T e[VEC];
      *reinterpret_cast<uint4*>(e) = make_uint4(0, 0, 0, 0);
      if (r < r_lim) {
        const T* g = src + (static_cast<size_t>(r0 + r) * ld + c0 + c);
        if (c + VEC <= c_lim) {
          *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(g);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (c + j < c_lim) e[j] = g[j];
        }
      }
      *reinterpret_cast<uint4*>(dst + r * dst_ld + c) = *reinterpret_cast<const uint4*>(e);
    }
  } else {
    constexpr int NV = R / VEC;
    for (int idx = threadIdx.x; idx < NV * C; idx += kThreads) {
      const int c = idx / NV;
      const int r = (idx % NV) * VEC;
      alignas(16) T e[VEC];
      *reinterpret_cast<uint4*>(e) = make_uint4(0, 0, 0, 0);
      if (c < c_lim) {
        const T* g = src + (static_cast<size_t>(c0 + c) * ld + r0 + r);
        if (r + VEC <= r_lim) {
          *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(g);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (r + j < r_lim) e[j] = g[j];
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[(r + j) * dst_ld + c] = e[j];
    }
  }
}

template <typename T>
struct TileMath;

// f32: thread (tr, tc) owns rows tr * 4 + i and columns tc + 16 * j.
template <>
struct TileMath<float> {
  using L = Layout<float>;
  float acc[4][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ void step(const float* As, const float* Bs) {
    const int tr = threadIdx.x >> 4;
    const int tc = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(tr * 4 + i) * L::A_LD + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k * L::B_LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ void store(float* out, size_t ld, int row_lim, int col_lim, unsigned char*) {
    const int tr = threadIdx.x >> 4;
    const int tc = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tr * 4 + i;
      if (m >= row_lim) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tc + 16 * j;
        if (n < col_lim) out[static_cast<size_t>(m) * ld + n] = acc[i][j];
      }
    }
  }
};

// First index i in the non-decreasing be[0, n) with be[i] >= v.
__device__ __forceinline__ int lower_bound(const int* __restrict__ be, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (be[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Experts at most this many (+ 1) keep their first tiles in a shared-memory
// table (expert_starts); beyond it each block finds them by binary search.
constexpr int kTableMax = 4096;

// table[v] = first tile of expert v for v in [0, E], table[E] = n_tiles: the
// tile i with be[i - 1] < v <= be[i].  One pass over be by the block's
// `threads` threads (one load latency, where a binary search per expert
// waits for ~2 log2(n) dependent loads); the caller synchronises.
__device__ __forceinline__ void expert_starts(const int* __restrict__ be, int n_tiles, int E,
                                              int* table, int threads) {
  for (int i = threadIdx.x; i <= n_tiles; i += threads) {
    const int prev = i > 0 ? min(max(be[i - 1], 0), E) : -1;
    const int cur = i < n_tiles ? min(max(be[i], 0), E) : E;
    for (int v = prev + 1; v <= cur; ++v) table[v] = i;
  }
}

// Run slot r of the dropless plan -> out = {expert, first tile, tile count},
// expert -1 past the last run: experts in order, each contributing
// ceil(tiles / kRun) runs of up to kRun tiles from its first tile.  The
// experts' first tiles come from `table` (expert_starts) or, when it is
// null, by binary search.  Called by one whole warp; the caller
// synchronises before reading `out`.
template <int kRun>
__device__ __forceinline__ void find_run(const int* __restrict__ be, int n_tiles, int E, int r,
                                         int* out, const int* table) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) out[0] = -1;
  __syncwarp();
  int base = 0;  // runs of the experts before e0 (warp-uniform)
  for (int e0 = 0; e0 < E && base <= r; e0 += 32) {
    const int e = e0 + lane;
    int lo = 0, cnt = 0, runs = 0;
    if (e < E) {
      lo = table ? table[e] : lower_bound(be, n_tiles, e);
      cnt = (table ? table[e + 1] : lower_bound(be, n_tiles, e + 1)) - lo;
      runs = (cnt + kRun - 1) / kRun;
    }
    int incl = runs;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(repro::kFullMask, incl, off);
      if (lane >= off) incl += v;
    }
    const int excl = base + incl - runs;
    if (e < E && r >= excl && r < excl + runs) {
      const int k = r - excl;
      out[0] = e;
      out[1] = lo + k * kRun;
      out[2] = min(kRun, cnt - k * kRun);
    }
    base += __shfl_sync(repro::kFullMask, incl, 31);
  }
}

// f32: out[rows of run] = x[rows] @ W[e] (kBTrans: x[rows] @ W[e]^T, W[e]
// stored [N, K]); a run is up to 8 tiles (64 rows).
template <typename T, bool kBTrans>
__global__ void __launch_bounds__(kThreads)
    gmm_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ be,
                    T* __restrict__ out, int n_tiles, int E, int K, int N) {
  using L = Layout<T>;
  __shared__ __align__(128) unsigned char smem[L::SMEM];
  __shared__ int s_run[3];  // expert, first tile, tile count
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * L::A_LD;
  if (threadIdx.x < 32) find_run<kRunTiles>(be, n_tiles, E, blockIdx.x, s_run, nullptr);
  __syncthreads();
  const int e = s_run[0];
  if (e < 0) return;
  const int row0 = s_run[1] * kTileRows;
  const int rows = s_run[2] * kTileRows;
  const int n0 = blockIdx.y * BN;
  const T* we = w + static_cast<size_t>(e) * K * N;
  const T* xa = x + static_cast<size_t>(row0) * K;

  TileMath<T> tm;
  tm.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK, false>(As, L::A_LD, xa, K, 0, k0, rows, K - k0);
    if constexpr (kBTrans)
      load_tile<T, BK, BN, true>(Bs, L::B_LD, we, K, k0, n0, K - k0, N - n0);
    else
      load_tile<T, BK, BN, false>(Bs, L::B_LD, we, N, k0, n0, K - k0, N - n0);
    __syncthreads();
    tm.step(As, Bs);
    __syncthreads();
  }
  tm.store(out + static_cast<size_t>(row0) * N + n0, N, rows, N - n0, smem);
}

// f32: dw[e][k0:k0+64, n0:n0+128] = sum over rows r in [r_begin, r_end) of
// x[r, k]^T dy[r, n], in row order; blockIdx = (n tile, k tile, e).
template <typename T>
__device__ __forceinline__ void dw_tile(const T* __restrict__ x, const T* __restrict__ dy,
                                        T* __restrict__ dw, int r_begin, int r_end, int K,
                                        int N, unsigned char* smem) {
  using L = Layout<T>;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * L::A_LD;
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  TileMath<T> tm;
  tm.zero();
  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    // As[m][kk] = x[r0 + kk][k0 + m]; Bs[kk][n] = dy[r0 + kk][n0 + n].
    load_tile<T, BM, BK, true>(As, L::A_LD, x + static_cast<size_t>(r0) * K, K, k0, 0, K - k0,
                               r_end - r0);
    load_tile<T, BK, BN, false>(Bs, L::B_LD, dy + static_cast<size_t>(r0) * N, N, 0, n0,
                                r_end - r0, N - n0);
    __syncthreads();
    tm.step(As, Bs);
    __syncthreads();
  }
  tm.store(dw + static_cast<size_t>(e) * K * N + static_cast<size_t>(k0) * N + n0, N, K - k0,
           N - n0, smem);
}

// Dropless: expert e's rows are its tiles' rows, found by two lower bounds.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, const int* __restrict__ be,
                  T* __restrict__ dw, int n_tiles, int K, int N) {
  __shared__ __align__(128) unsigned char smem[Layout<T>::SMEM];
  __shared__ int s_rows[2];
  if (threadIdx.x == 0) {
    s_rows[0] = lower_bound(be, n_tiles, blockIdx.z) * kTileRows;
    s_rows[1] = lower_bound(be, n_tiles, blockIdx.z + 1) * kTileRows;
  }
  __syncthreads();
  dw_tile<T>(x, dy, dw, s_rows[0], s_rows[1], K, N, smem);
}

// Capacity: expert e's rows are [e * C, (e + 1) * C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_cap_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dw,
                      int C, int K, int N) {
  __shared__ __align__(128) unsigned char smem[Layout<T>::SMEM];
  const int r_begin = static_cast<int>(blockIdx.z) * C;
  dw_tile<T>(x, dy, dw, r_begin, r_begin + C, K, N, smem);
}

// ---------------------------------------------------------------------------
// capacity layout, forward and dX: a block owns up to CBM rows of one expert
// ---------------------------------------------------------------------------

constexpr int CBM = 256;  // capacity rows per block
constexpr int CBN = 64;   // output columns per block

template <typename T>
struct CapLayout {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int A_LD = BK + VEC;   // As [CBM][A_LD]
  static constexpr int B_LD = CBN + VEC;  // Bs [BK][B_LD]
  static constexpr size_t SMEM = (CBM * A_LD + BK * B_LD) * sizeof(T);
};

template <typename T>
struct CapMath;

// f32: thread (tr, tc) owns rows tr + 32 * i and columns tc + 8 * j.
template <>
struct CapMath<float> {
  using L = CapLayout<float>;
  float acc[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ void step(const float* As, const float* Bs, int) {
    const int tr = threadIdx.x >> 3;
    const int tc = threadIdx.x & 7;
#pragma unroll 2
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(tr + 32 * i) * L::A_LD + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k * L::B_LD + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ void store(float* out, size_t ld, int row_lim, int col_lim, unsigned char*) {
    const int tr = threadIdx.x >> 3;
    const int tc = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = tr + 32 * i;
      if (m >= row_lim) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tc + 8 * j;
        if (n < col_lim) out[static_cast<size_t>(m) * ld + n] = acc[i][j];
      }
    }
  }
};

// f32: out[e, r0:r0+256, n0:n0+64] = x[e, rows] @ W[e] (kBTrans: W[e]
// stored [N, K]); blockIdx = (n tile, row chunk, e).
template <typename T, bool kBTrans>
__global__ void __launch_bounds__(kThreads)
    gmm_cap_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int C,
                   int K, int N) {
  using L = CapLayout<T>;
  __shared__ __align__(128) unsigned char smem[L::SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + CBM * L::A_LD;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * CBM;
  const int rows = min(CBM, C - r0);
  const int n0 = blockIdx.x * CBN;
  const T* xa = x + (static_cast<size_t>(e) * C + r0) * K;
  const T* we = w + static_cast<size_t>(e) * K * N;

  CapMath<T> tm;
  tm.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, CBM, BK, false>(As, L::A_LD, xa, K, 0, k0, rows, K - k0);
    if constexpr (kBTrans)
      load_tile<T, BK, CBN, true>(Bs, L::B_LD, we, K, k0, n0, K - k0, N - n0);
    else
      load_tile<T, BK, CBN, false>(Bs, L::B_LD, we, N, k0, n0, K - k0, N - n0);
    __syncthreads();
    tm.step(As, Bs, rows);
    __syncthreads();
  }
  tm.store(out + (static_cast<size_t>(e) * C + r0) * N + n0, N, rows, N - n0, smem);
}

int launch_cap_f32(const void* x, const void* w, void* out, int E, int C, int K, int N, int trans,
                   cudaStream_t st) {
  const dim3 grid((N + CBN - 1) / CBN, (C + CBM - 1) / CBM, E);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (trans)
    gmm_cap_kernel<float, true><<<grid, kThreads, 0, st>>>(xp, wp, op, C, K, N);
  else
    gmm_cap_kernel<float, false><<<grid, kThreads, 0, st>>>(xp, wp, op, C, K, N);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 forward and dX, both layouts: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------

struct Gmm90 {
  static constexpr int BM = 256;  // rows of one expert per block: 2 consumers x 2 x m64
  static constexpr int BN = 128;  // output columns per block: one m64n128 per m64 tile
  static constexpr int BK = 64;   // reduction depth per stage: one 128-byte swizzled row
  static constexpr int kStages = 4;
  static constexpr int kCluster = 2;        // CTAs along N sharing each x tile
  static constexpr int kThreads = 384;      // warpgroup 0 produces, 1 and 2 consume
  static constexpr int kConsumerWarps = 8;  // each arrives on a stage's "empty" in every CTA
  static constexpr int kRunTiles = BM / kTileRows;  // dispatch tiles of a dropless run
  static constexpr int A_BYTES = BM * BK * 2;     // x tile [256 rows][64 k]
  static constexpr int A_SLICE_ROWS = BM / kCluster;  // rows of it each CTA loads
  static constexpr int B_BYTES = BK * BN * 2;     // w tile, 2 x [64 k][64 n] or [128 n][64 k]
  static constexpr int HALF_BYTES = B_BYTES / 2;  // one [64 k][64 n] box (forward)
  static constexpr int M64_BYTES = 64 * BK * 2;   // 64 rows of 128 bytes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, its 2 x kStages barriers and 1024 bytes to align the ring
  static constexpr int SMEM = kStages * STAGE_BYTES + 2 * kStages * 8 + 1024;
};

// One consumer's m64 x 128 f32 tile (its rows `row0`...) -> bf16 in the
// 128-byte-swizzled staging buffer of two [128 rows][64 columns] halves
// that the output map's boxes read.
__device__ __forceinline__ void stage_m64(const float (&acc)[64], uint32_t stage, int row0) {
  using L = Gmm90;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (t >> 5) * 16 + (lane >> 2) + 8 * h;
      const uint32_t addr = stage + (j >> 3) * (L::HALF_BYTES * 2) + row * 128 +
                            (((j & 7) ^ (row & 7)) << 4) + (lane & 3) * 4;
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                   "r"(*reinterpret_cast<const uint32_t*>(&v))
                   : "memory");
    }
  }
}

// out[rows] = x[rows] @ W[e] for up to 256 rows of one expert and 128
// columns; kBTrans: W[e] stored [N, K] (dX).  Capacity (kDropless false):
// blockIdx = (256-row chunk of C, n tile, e), maps x [E, C, K] (boxes {64,
// 128, 1}) and out [E, C, N] ({64, 64, 1}).  Dropless: blockIdx = (run
// slot, n tile), maps x [1, n_tiles * 8, K] and out [1, n_tiles * 8, N]
// ({64, 8, 1}: one dispatch tile).  w [E, K, N] boxes {64, 64, 1} (kBTrans:
// [E, N, K], {64, 128, 1}).  A cluster is kCluster adjacent n tiles of one
// row chunk.  All boxes 128-byte swizzled, zeros past every edge on load,
// clipped on store.
template <bool kBTrans, bool kDropless>
__global__ void __cluster_dims__(1, Gmm90::kCluster, 1) __launch_bounds__(Gmm90::kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_out, const int* __restrict__ be,
                     int n_tiles, int E, int C, int K, int N) {
  using namespace repro::hopper;
  using L = Gmm90;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_run[3];  // dropless: expert, first tile, tile count
  int e, r0, rows, z;       // expert, first row, rows to store, the maps' outer coordinate
  if constexpr (kDropless) {
    // The experts' first tiles (after the ring and its barriers), then warp
    // 0 maps the run slot to its run.
    int* table = reinterpret_cast<int*>(smem_raw + L::SMEM);
    const bool starts_in_smem = E + 1 <= kTableMax;
    if (starts_in_smem) expert_starts(be, n_tiles, E, table, L::kThreads);
    __syncthreads();
    if (threadIdx.x < 32)
      find_run<L::kRunTiles>(be, n_tiles, E, blockIdx.x, s_run, starts_in_smem ? table : nullptr);
    __syncthreads();
    e = s_run[0];
    if (e < 0) return;  // past the last run: the cluster's other CTA has the same slot
    r0 = s_run[1] * kTileRows;
    rows = s_run[2] * kTileRows;
    z = 0;
  } else {
    e = blockIdx.z;
    r0 = blockIdx.x * L::BM;
    rows = min(L::BM, C - r0);
    z = e;
  }
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa = base;
  const uint32_t sb = base + L::kStages * L::A_BYTES;
  const uint32_t bars = base + L::kStages * L::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::kStages + s); };
  const int n0 = blockIdx.y * L::BN;
  const int nk = (K + L::BK - 1) / L::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), L::kConsumerWarps * L::kCluster);
    }
    fence_mbar_init();
  }
  cluster_sync();  // every CTA's barriers exist before any multicast

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // Producer: one thread keeps kStages (x, w) tiles in flight.  The x
    // tile is the cluster's: this CTA loads its slice of rows into every
    // CTA of the cluster, and a stage is refilled only once the consumers
    // of every CTA have released it.
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const uint32_t rank = cluster_rank();
      const uint16_t all = (1u << L::kCluster) - 1;
      for (int it = 0; it < nk; ++it) {
        const int s = it % L::kStages;
        mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::STAGE_BYTES);
        const int k0 = it * L::BK;
        tma_load_3d_multicast(sa + s * L::A_BYTES + rank * L::A_SLICE_ROWS * 128, &map_x, full(s),
                              all, k0, r0 + rank * L::A_SLICE_ROWS, z);
        if constexpr (kBTrans) {
          tma_load_3d(sb + s * L::B_BYTES, &map_w, full(s), k0, n0, e);
        } else {
          tma_load_3d(sb + s * L::B_BYTES, &map_w, full(s), n0, k0, e);
          tma_load_3d(sb + s * L::B_BYTES + L::HALF_BYTES, &map_w, full(s), n0 + 64, k0, e);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows [128 c, 128 c + 128) of the block as
    // two m64 tiles.  Every wgmma is issued unconditionally (a tile past the
    // rows multiplies zeros or rows another block stores).
    reg_alloc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % L::kStages;
      mbar_wait(full(s), (it / L::kStages) & 1);
      const uint32_t a = sa + s * L::A_BYTES + 2 * c * L::M64_BYTES;
      const uint32_t b = sb + s * L::B_BYTES;
      fence_operands(acc0);
      fence_operands(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk) {
        // K-major tiles step 32 bytes along the swizzled row; the forward's
        // MN-major w tile steps 16 rows of 128 bytes.
        const uint64_t db = kBTrans ? desc_sw128(b + kk * 32, 16, 1024)
                                    : desc_sw128(b + kk * 2048, L::HALF_BYTES, 1024);
        wgmma_m64n128k16_bf16<0, kBTrans ? 0 : 1>(acc0, desc_sw128(a + kk * 32, 16, 1024), db);
        wgmma_m64n128k16_bf16<0, kBTrans ? 0 : 1>(
            acc1, desc_sw128(a + L::M64_BYTES + kk * 32, 16, 1024), db);
      }
      wgmma_commit();
      fence_operands(acc0);
      fence_operands(acc1);
      wgmma_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
      for (int r = 0; r < L::kCluster; ++r)
        mbar_arrive_cluster(empty((it + L::kStages - 1) % L::kStages), r, it > 0 && (t & 31) == 0);
    }
    wgmma_wait<0>();
    fence_operands(acc0);
    fence_operands(acc1);

    // Epilogue: both consumers are done with the ring, so consumer c stages
    // its bf16 tile in the ring's first 64 KB and one thread stores it with
    // TMA: capacity in 64-row boxes (rows past C and columns past N are not
    // written), dropless in 8-row boxes, the run's own tiles only.
    named_bar_sync(1, 2 * 128);
    const int valid = min(max(rows - 128 * c, 0), 128);  // this consumer's rows to store
    if (valid > 0) {
      const uint32_t stage = base + c * L::A_BYTES;
      stage_m64(acc0, stage, 0);
      if (valid > 64) stage_m64(acc1, stage, 64);
      fence_proxy_async();
      named_bar_sync(2 + c, 128);
      if (t == 0) {
        constexpr int kBoxRows = kDropless ? kTileRows : 64;
        for (int bx = 0; bx < (valid + kBoxRows - 1) / kBoxRows; ++bx)
          for (int half = 0; half < 2; ++half)
            if (n0 + 64 * half < N)
              tma_store_3d(&map_out, stage + half * 2 * L::HALF_BYTES + bx * kBoxRows * 128,
                           n0 + 64 * half, r0 + 128 * c + kBoxRows * bx, z);
        tma_store_commit();
        tma_store_wait_read();
      }
    }
    // No CTA exits while another may still arrive on its barriers.
    __syncwarp();
    cluster_sync();
  }
}

// Capacity: x [E, C, K] -> out [E, C, N].  Dropless: x [n_tiles * 8, K]
// (E experts, be [n_tiles]) -> out [n_tiles * 8, N].  w [E, K, N] (trans:
// [E, N, K]).
int launch_wgmma(const void* x, const void* w, const void* be, void* out, bool dropless,
                 int n_tiles, int E, int C, int K, int N, int trans, cudaStream_t st) {
  using namespace repro::hopper;
  using L = Gmm90;
  const int rows = dropless ? n_tiles * kTileRows : C;
  const int outer = dropless ? 1 : E;
  CUtensorMap mx, mw, mo;
  int err = bf16_map_3d(&mx, x, K, rows, outer, 64, L::A_SLICE_ROWS);
  if (!err) err = trans ? bf16_map_3d(&mw, w, K, N, E, 64, L::BN)
                        : bf16_map_3d(&mw, w, N, K, E, 64, 64);
  if (!err) err = bf16_map_3d(&mo, out, N, rows, outer, 64, dropless ? kTileRows : 64);
  if (err) return err;
  // n tiles rounded up to whole clusters: a tile past N loads zeros and
  // stores nothing.
  const int n_tiles_n = (N + L::BN - 1) / L::BN;
  const int gy = (n_tiles_n + L::kCluster - 1) / L::kCluster * L::kCluster;
  const dim3 grid = dropless ? dim3((n_tiles + L::kRunTiles - 1) / L::kRunTiles +
                                        min(E, n_tiles), gy, 1)
                             : dim3((C + L::BM - 1) / L::BM, gy, E);
  const auto kernel = dropless ? (trans ? &gmm_wgmma_kernel<true, true>
                                        : &gmm_wgmma_kernel<false, true>)
                               : (trans ? &gmm_wgmma_kernel<true, false>
                                        : &gmm_wgmma_kernel<false, false>);
  const size_t smem = L::SMEM + (dropless && E + 1 <= kTableMax ? 4u * (E + 1) : 0u);
  const cudaError_t ae = repro::allow_smem(kernel, smem);
  if (ae != cudaSuccess) return static_cast<int>(ae);
  kernel<<<grid, L::kThreads, smem, st>>>(mx, mw, mo, static_cast<const int*>(be), n_tiles, E, C,
                                          K, N);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 dW, both layouts: persistent clusters, TMA ring, wgmma with A = x^T
// ---------------------------------------------------------------------------

struct Dw90 {
  static constexpr int BM = 256;  // dW rows (x columns) per tile: 2 consumers x 2 x m64
  static constexpr int BN = 128;  // dW columns (dY columns) per tile
  static constexpr int BR = 64;   // reduction rows per stage
  static constexpr int kStages = 3;
  static constexpr int kCluster = 2;        // CTAs along N sharing each x slice
  static constexpr int kThreads = 384;      // warpgroup 0 produces, 1 and 2 consume
  static constexpr int kConsumerWarps = 8;  // each arrives on a stage's "empty" in every CTA
  static constexpr int BOX_BYTES = BR * 64 * 2;  // one [64 rows][64 columns] box
  static constexpr int A_BOXES = BM / 64;        // x slice: 4 boxes along d_model
  static constexpr int A_BYTES = A_BOXES * BOX_BYTES;
  static constexpr int B_BYTES = 2 * BOX_BYTES;  // dY tile: 2 boxes along N
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = BM * BN * 2;  // staged bf16 tile: 32 KB a consumer
  // the ring, the staging buffer, 2 x kStages barriers, 1024 bytes to align
  static constexpr int SMEM = kStages * STAGE_BYTES + OUT_BYTES + 2 * kStages * 8 + 1024;
};

// dW[e][k0:k0+256, n0:n0+128] = sum over expert e's rows r of x[r, k] dY[r, n],
// 64 rows a stage from its first row.  Capacity: maps x [E, C, K] and dY
// [E, C, N], rows [0, C).  Dropless: maps x [1, n_tiles * 8, K] and dY
// [1, n_tiles * 8, N], the rows of e's tiles in be.  dW [E, K, N].  All
// boxes {64, 64, 1}, 128-byte swizzled.  Cluster (rank 0, 1) = the two N
// tiles of a pair; cluster i walks tiles i, i + clusters, ... of the
// (expert, K tile, N pair) order.
template <bool kDropless>
__global__ void __cluster_dims__(Dw90::kCluster, 1, 1) __launch_bounds__(Dw90::kThreads, 1)
    gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dy,
                        const __grid_constant__ CUtensorMap map_dw, const int* __restrict__ be,
                        int n_tiles, int E, int C, int K, int N) {
  using namespace repro::hopper;
  using L = Dw90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sa = base;
  const uint32_t sb = base + L::kStages * L::A_BYTES;
  const uint32_t so = base + L::kStages * L::STAGE_BYTES;  // staging, OUT_BYTES
  const uint32_t bars = so + L::OUT_BYTES;
  int* table = reinterpret_cast<int*>(smem_raw + (bars + 16u * L::kStages - raw));
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::kStages + s); };
  const bool use_table = kDropless && E + 1 <= kTableMax;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), L::kConsumerWarps * L::kCluster);
    }
    fence_mbar_init();
  }
  if (use_table) expert_starts(be, n_tiles, E, table, L::kThreads);
  cluster_sync();  // barriers and table visible; every CTA's barriers exist before any multicast

  const int n_pairs = ((N + L::BN - 1) / L::BN + 1) / 2;
  const int per_e = (K + L::BM - 1) / L::BM * n_pairs;
  const int n_ctiles = E * per_e;
  const int first = blockIdx.x / L::kCluster;
  const int stride = gridDim.x / L::kCluster;
  const int rank = static_cast<int>(cluster_rank());
  // Expert e's rows [rb, re) in the maps' row coordinate.
  auto rows_of = [&](int e, int& rb, int& re) {
    if constexpr (kDropless) {
      if (use_table) {
        rb = table[e] * kTileRows;
        re = table[e + 1] * kTileRows;
      } else {
        rb = lower_bound(be, n_tiles, e) * kTileRows;
        re = lower_bound(be, n_tiles, e + 1) * kTileRows;
      }
    } else {
      rb = 0;
      re = C;
    }
  };

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // Producer: one thread streams every tile's stages through the ring; it
    // runs ahead into the next tile while the consumers store this one.
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const uint16_t all = (1u << L::kCluster) - 1;
      int it = 0;
      for (int tile = first; tile < n_ctiles; tile += stride) {
        const int e = tile / per_e;
        const int k0 = tile % per_e / n_pairs * L::BM;
        const int n0 = (tile % n_pairs * L::kCluster + rank) * L::BN;
        const int z = kDropless ? 0 : e;
        int rb, re;
        rows_of(e, rb, re);
        for (int r = rb; r < re; r += L::BR, ++it) {
          const int s = it % L::kStages;
          mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), L::STAGE_BYTES);
#pragma unroll
          for (int j = 0; j < L::A_BOXES / L::kCluster; ++j) {
            const int box = rank * (L::A_BOXES / L::kCluster) + j;
            tma_load_3d_multicast(sa + s * L::A_BYTES + box * L::BOX_BYTES, &map_x, full(s), all,
                                  k0 + 64 * box, r, z);
          }
          tma_load_3d(sb + s * L::B_BYTES, &map_dy, full(s), n0, r, z);
          tma_load_3d(sb + s * L::B_BYTES + L::BOX_BYTES, &map_dy, full(s), n0 + 64, r, z);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns dW rows [k0 + 128 c, k0 + 128 c + 128) of
    // the tile as two m64 tiles, A the x boxes 2c and 2c + 1 (MN-major,
    // d_model contiguous), B the whole dY tile (MN-major).
    reg_alloc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    const uint32_t stage_out = so + c * (L::OUT_BYTES / 2);
    float acc0[64], acc1[64];
    int it = 0;
    for (int tile = first; tile < n_ctiles; tile += stride) {
      const int e = tile / per_e;
      const int k0 = tile % per_e / n_pairs * L::BM;
      const int n0 = (tile % n_pairs * L::kCluster + rank) * L::BN;
      int rb, re;
      rows_of(e, rb, re);
      const int nst = (re - rb + L::BR - 1) / L::BR;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      for (int j = 0; j < nst; ++j, ++it) {
        const int s = it % L::kStages;
        mbar_wait(full(s), (it / L::kStages) & 1);
        const uint32_t a = sa + s * L::A_BYTES + 2 * c * L::BOX_BYTES;
        const uint32_t b = sb + s * L::B_BYTES;
        if constexpr (kDropless) {
          // Rows past the expert's last row belong to the next expert: zero
          // them in this consumer's two x boxes and its half of the dY tile
          // (whole 128-byte rows; the swizzle stays inside a row), then make
          // the zeros visible to wgmma in both consumers.
          const int valid = re - rb - j * L::BR;
#pragma unroll
          for (int i = 0; i < 12; ++i) {
            const int q = t + 128 * i;  // 16-byte chunk: box q / 512, row (q / 8) % 64
            const int box = q >> 9;
            const int row = (q >> 3) & 63;
            const uint32_t at = box < 2 ? a + box * L::BOX_BYTES : b + c * L::BOX_BYTES;
            st_shared_zero16_if(at + row * 128 + (q & 7) * 16, row >= valid);
          }
          fence_proxy_async();
          named_bar_sync(1, 2 * 128);
        }
        fence_operands(acc0);
        fence_operands(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::BR / 16; ++kk) {
          // MN-major operands step 16 rows of 128 bytes; the dY tile's two
          // 64-column boxes are BOX_BYTES apart.
          const uint64_t db = desc_sw128(b + kk * 2048, L::BOX_BYTES, 1024);
          wgmma_m64n128k16_bf16<1, 1>(acc0, desc_sw128(a + kk * 2048, L::BOX_BYTES, 1024), db);
          wgmma_m64n128k16_bf16<1, 1>(
              acc1, desc_sw128(a + L::BOX_BYTES + kk * 2048, L::BOX_BYTES, 1024), db);
        }
        wgmma_commit();
        fence_operands(acc0);
        fence_operands(acc1);
        wgmma_wait<1>();  // the previous stage of this tile is done: release it
#pragma unroll
        for (int r = 0; r < L::kCluster; ++r)
          mbar_arrive_cluster(empty((it + L::kStages - 1) % L::kStages), r, j > 0 && (t & 31) == 0);
      }
      wgmma_wait<0>();
      fence_operands(acc0);
      fence_operands(acc1);
#pragma unroll
      for (int r = 0; r < L::kCluster; ++r)
        mbar_arrive_cluster(empty((it + L::kStages - 1) % L::kStages), r, nst > 0 && (t & 31) == 0);

      // Epilogue: once this consumer's previous store has left the staging
      // buffer, stage the tile and let thread 0 store it with TMA (rows past
      // K and columns past N are not written) without waiting for it: the
      // producer is already filling the ring with the next tile.
      tma_store_wait_read();
      named_bar_sync(2 + c, 128);
      stage_m64(acc0, stage_out, 0);
      stage_m64(acc1, stage_out, 64);
      fence_proxy_async();
      named_bar_sync(2 + c, 128);
#pragma unroll
      for (int jm = 0; jm < 2; ++jm)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = k0 + 128 * c + 64 * jm;
          const int col = n0 + 64 * half;
          tma_store_3d_if(&map_dw, stage_out + half * 2 * Gmm90::HALF_BYTES + jm * 64 * 128, col,
                          row, e, t == 0 && row < K && col < N);
        }
      tma_store_commit();
    }
    tma_store_wait_read();
    // No CTA exits while another may still arrive on its barriers.
    __syncwarp();
    cluster_sync();
  }
}

// Clusters of `kernel` that fit on the card at once (one CTA an SM).
template <typename Kernel>
int resident_clusters(Kernel kernel, size_t smem, int cluster, int threads) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster * 1024, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n <= 0) {
    (void)cudaGetLastError();
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    n = sms / cluster;
  }
  return n > 0 ? n : 1;
}

// Capacity: x [E, C, K], dy [E, C, N].  Dropless: x [n_tiles * 8, K], dy
// [n_tiles * 8, N], be [n_tiles].  -> dw [E, K, N].
int launch_dw_wgmma(const void* x, const void* dy, const void* be, void* dw, bool dropless,
                    int n_tiles, int E, int C, int K, int N, cudaStream_t st) {
  using namespace repro::hopper;
  using L = Dw90;
  const int rows = dropless ? n_tiles * kTileRows : C;
  if (rows == 0)  // no rows: every expert's gradient is exactly zero
    return static_cast<int>(cudaMemsetAsync(
        dw, 0, static_cast<size_t>(E) * K * N * sizeof(__nv_bfloat16), st));
  const int outer = dropless ? 1 : E;
  CUtensorMap mx, mdy, mdw;
  int err = bf16_map_3d(&mx, x, K, rows, outer, 64, L::BR);
  if (!err) err = bf16_map_3d(&mdy, dy, N, rows, outer, 64, L::BR);
  if (!err) err = bf16_map_3d(&mdw, dw, N, K, E, 64, 64);
  if (err) return err;
  const size_t smem = L::SMEM + (dropless && E + 1 <= kTableMax ? 4u * (E + 1) : 0u);
  const auto kernel = dropless ? &gmm_dw_wgmma_kernel<true> : &gmm_dw_wgmma_kernel<false>;
  const cudaError_t ae = repro::allow_smem(kernel, smem);
  if (ae != cudaSuccess) return static_cast<int>(ae);
  const long long n_ctiles = static_cast<long long>(E) * ((K + L::BM - 1) / L::BM) *
                             (((N + L::BN - 1) / L::BN + 1) / 2);
  static int cached[2][2] = {{-1, 0}, {-1, 0}};  // per layout: smem, clusters
  int* c = cached[dropless ? 1 : 0];
  if (c[0] != static_cast<int>(smem)) {
    c[1] = resident_clusters(kernel, smem, L::kCluster, L::kThreads);
    c[0] = static_cast<int>(smem);
  }
  const int clusters = static_cast<int>(n_ctiles < c[1] ? n_ctiles : c[1]);
  kernel<<<clusters * L::kCluster, L::kThreads, smem, st>>>(mx, mdy, mdw,
                                                            static_cast<const int*>(be), n_tiles,
                                                            E, C, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cap_dw(const void* x, const void* dy, void* dw, int E, int C, int K, int N,
                  cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  gmm_cap_dw_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dw), C, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* x, const void* w, const void* be, void* out, int n_tiles, int E,
                int K, int N, int trans, cudaStream_t st) {
  const int runs_bound = (n_tiles + kRunTiles - 1) / kRunTiles + min(E, n_tiles);
  const dim3 grid(runs_bound, (N + BN - 1) / BN);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const int* bp = static_cast<const int*>(be);
  T* op = static_cast<T*>(out);
  if (trans)
    gmm_rows_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, wp, bp, op, n_tiles, E, K, N);
  else
    gmm_rows_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, wp, bp, op, n_tiles, E, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* x, const void* dy, const void* be, void* dw, int n_tiles, int E, int K,
              int N, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  gmm_dw_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                              static_cast<const T*>(dy),
                                              static_cast<const int*>(be), static_cast<T*>(dw),
                                              n_tiles, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n_tiles * 8, K], w [E, K, N] (trans: [E, N, K]), be [n_tiles] i32
// non-decreasing -> out [n_tiles * 8, N], all in dtype.
extern "C" int grouped_matmul_blocks(const void* x, const void* w, const void* be, void* out,
                                     int dtype, int n_tiles, int E, int K, int N, int trans,
                                     void* stream) {
  if (n_tiles <= 0 || N <= 0) return 0;
  if (E <= 0 || E > kMaxExperts || K <= 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) return launch_wgmma(x, w, be, out, true, n_tiles, E, 0, K, N, trans, st);
  if (dtype == repro::kF32) return launch_rows<float>(x, w, be, out, n_tiles, E, K, N, trans, st);
  return -2;
}

// x [n_tiles * 8, K], dy [n_tiles * 8, N], be [n_tiles] -> dw [E, K, N].
extern "C" int grouped_matmul_blocks_dw(const void* x, const void* dy, const void* be, void* dw,
                                        int dtype, int n_tiles, int E, int K, int N,
                                        void* stream) {
  if (E <= 0 || K <= 0 || N <= 0) return 0;
  if (E > kMaxExperts) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) return launch_dw_wgmma(x, dy, be, dw, true, n_tiles, E, 0, K, N, st);
  if (dtype == repro::kF32) return launch_dw<float>(x, dy, be, dw, n_tiles, E, K, N, st);
  return -2;
}

// Capacity layout: x [E, C, K], w [E, K, N] (trans: [E, N, K]) -> out [E, C, N].
extern "C" int grouped_matmul_capacity(const void* x, const void* w, void* out, int dtype, int E,
                                       int C, int K, int N, int trans, void* stream) {
  if (E <= 0 || C <= 0 || N <= 0) return 0;
  if (E > kMaxExperts || K <= 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) return launch_wgmma(x, w, nullptr, out, false, 0, E, C, K, N, trans, st);
  if (dtype == repro::kF32) return launch_cap_f32(x, w, out, E, C, K, N, trans, st);
  return -2;
}

// x [E, C, K], dy [E, C, N] -> dw [E, K, N] (zeros where C == 0).
extern "C" int grouped_matmul_capacity_dw(const void* x, const void* dy, void* dw, int dtype,
                                          int E, int C, int K, int N, void* stream) {
  if (E <= 0 || K <= 0 || N <= 0) return 0;
  if (E > kMaxExperts || C < 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) return launch_dw_wgmma(x, dy, nullptr, dw, false, 0, E, C, K, N, st);
  if (dtype == repro::kF32) return launch_cap_dw<float>(x, dy, dw, E, C, K, N, st);
  return -2;
}
