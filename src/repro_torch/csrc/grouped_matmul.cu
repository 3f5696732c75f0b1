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
// What bounds them on an H100: the weight stream.  At Mixtral's training
// step (T = 512 tokens -> 1024 choices -> 135 tiles of B = 8 rows) one
// w_in call reads 8 experts x 4096 x 14336 bf16 = 0.94 GB of weights and
// does 2 x 1080 x 4096 x 14336 = 127 GFLOP: 0.28 ms at 3.35 TB/s against
// 0.13 ms at 989 TFLOP/s (capacity layout, C = 200: 188 GFLOP, 0.19 ms).
// The Pallas grid walked (tile, F block, D block) and re-read an expert's
// weights for every 8-row tile; a CUDA block per 8-row tile would do the
// same, about 135 x 0.94 GB per call.
//
// Design, dropless: be is non-decreasing (the dropless plan sorts choices
// by expert, and its trailing padding tiles are clipped to the last
// expert), so an expert owns one contiguous range of tiles.  A forward / dX
// block takes a RUN of up to 8 consecutive tiles (64 rows) of one expert,
// counted from the expert's first tile, and one 128-column output tile:
// each weight tile is read once per run, and the runs of one expert for the
// same columns are adjacent in launch order, so they meet in L2.  Every
// block finds its run on the device from be alone (lower bounds per expert
// and a warp prefix sum over experts' run counts): no host sync.  A dW
// block owns one expert and one 64 x 128 tile of dW[e]; it finds the
// expert's tile range with two lower bounds and sums its rows in order, 32
// rows at a time from the expert's first row.
//
// Design, capacity: one expert's C rows share its weights, so a forward /
// dX block owns up to 256 rows (all C rows when C <= 256, as at the main
// path's C = 200) of ONE expert for one 64-column output tile: each weight
// element is read once per call (ceil(C / 256) times for a larger C).  The
// bf16 warps skip the 16-row fragments that lie wholly past C.  dW is the
// dropless dW tile over the expert's rows [e * C, (e + 1) * C).
//
// Both layouts: no atomics.  dW's sum order depends only on the expert's
// own rows, so an expert's gradient is bit-identical whatever slot it
// occupies (zero padding rows add exact zeros).  bf16 runs on the tensor
// cores through WMMA (16 x 16 x 16, f32 accumulators); f32 runs on the CUDA
// cores.  Tiles are staged through shared memory with 16-byte loads, one
// stage: cp.async / TMA pipelining and wgmma are later work.
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

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
  static constexpr int C_LD = BN + 4;         // Cs [BM][C_LD] f32 (bf16 epilogue)
  static constexpr size_t AB_BYTES = (BM * A_LD + BK * B_LD) * sizeof(T);
  static constexpr size_t C_BYTES = std::is_same<T, float>::value ? 0 : BM * C_LD * sizeof(float);
  static constexpr size_t SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
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

// bf16: 8 warps as 2 x 4, each a 32 x 32 sub-tile of 2 x 2 WMMA fragments.
template <>
struct TileMath<__nv_bfloat16> {
  using L = Layout<__nv_bfloat16>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 2;
    const int wn = warp & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * L::A_LD + kk, L::A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * L::B_LD + wn * 32 + j * 16, L::B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // Caller has synchronised: smem (As/Bs) is free to hold the f32 tile.
  __device__ void store(__nv_bfloat16* out, size_t ld, int row_lim, int col_lim,
                        unsigned char* smem) {
    float* Cs = reinterpret_cast<float*>(smem);
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 2;
    const int wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * L::C_LD + wn * 32 + j * 16, acc[i][j],
                                L::C_LD, wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
      const int m = idx / BN;
      const int n = idx % BN;
      if (m < row_lim && n < col_lim)
        out[static_cast<size_t>(m) * ld + n] = __float2bfloat16_rn(Cs[m * L::C_LD + n]);
    }
  }
};

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

// out[rows of run] = x[rows] @ W[e] (kBTrans: x[rows] @ W[e]^T, W[e] stored [N, K]).
template <typename T, bool kBTrans>
__global__ void __launch_bounds__(kThreads)
    gmm_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ be,
                    T* __restrict__ out, int n_tiles, int E, int K, int N) {
  using L = Layout<T>;
  __shared__ __align__(128) unsigned char smem[L::SMEM];
  __shared__ int s_run[3];  // expert, first tile, tile count
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * L::A_LD;

  // Warp 0 maps blockIdx.x to (expert, first tile, count): experts in
  // order, each contributing ceil(tiles / 8) runs.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int r = blockIdx.x;
    if (lane == 0) s_run[0] = -1;
    __syncwarp();
    int base = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      int lo = 0, cnt = 0, runs = 0;
      if (e < E) {
        lo = lower_bound(be, n_tiles, e);
        cnt = lower_bound(be, n_tiles, e + 1) - lo;
        runs = (cnt + kRunTiles - 1) / kRunTiles;
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
        s_run[0] = e;
        s_run[1] = lo + k * kRunTiles;
        s_run[2] = min(kRunTiles, cnt - k * kRunTiles);
      }
      base += __shfl_sync(repro::kFullMask, incl, 31);
    }
  }
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

// dw[e][k0:k0+64, n0:n0+128] = sum over rows r in [r_begin, r_end) of
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

// bf16: 8 warps as 4 x 2, each a 64 x 32 sub-tile of 4 x 2 WMMA fragments;
// fragment rows wholly past the block's valid rows are skipped.
template <>
struct CapMath<__nv_bfloat16> {
  using L = CapLayout<__nv_bfloat16>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs, int rows) {
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1;
    const int wn = warp & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * L::B_LD + wn * 32 + j * 16, L::B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16;
        if (r >= rows) continue;  // warp-uniform
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, As + r * L::A_LD + kk, L::A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }

  // Caller has synchronised: each warp stages its fragments, one at a time,
  // through its own 16 x 16 f32 scratch in smem.
  __device__ void store(__nv_bfloat16* out, size_t ld, int row_lim, int col_lim,
                        unsigned char* smem) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp >> 1;
    const int wn = warp & 1;
    float* sc = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 64 + i * 16;
      if (r >= row_lim) continue;  // warp-uniform
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int q = lane; q < 256; q += 32) {
          const int m = r + (q >> 4);
          const int n = c + (q & 15);
          if (m < row_lim && n < col_lim)
            out[static_cast<size_t>(m) * ld + n] = __float2bfloat16_rn(sc[q]);
        }
        __syncwarp();
      }
    }
  }
};

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

// out[e, r0:r0+256, n0:n0+64] = x[e, rows] @ W[e] (kBTrans: W[e] stored [N, K]);
// blockIdx = (n tile, row chunk, e).
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

template <typename T>
int launch_cap(const void* x, const void* w, void* out, int E, int C, int K, int N, int trans,
               cudaStream_t st) {
  const dim3 grid((N + CBN - 1) / CBN, (C + CBM - 1) / CBM, E);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (trans)
    gmm_cap_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, wp, op, C, K, N);
  else
    gmm_cap_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, wp, op, C, K, N);
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
  if (dtype == repro::kBF16)
    return launch_rows<__nv_bfloat16>(x, w, be, out, n_tiles, E, K, N, trans, st);
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
  if (dtype == repro::kBF16)
    return launch_dw<__nv_bfloat16>(x, dy, be, dw, n_tiles, E, K, N, st);
  if (dtype == repro::kF32) return launch_dw<float>(x, dy, be, dw, n_tiles, E, K, N, st);
  return -2;
}

// Capacity layout: x [E, C, K], w [E, K, N] (trans: [E, N, K]) -> out [E, C, N].
extern "C" int grouped_matmul_capacity(const void* x, const void* w, void* out, int dtype, int E,
                                       int C, int K, int N, int trans, void* stream) {
  if (E <= 0 || C <= 0 || N <= 0) return 0;
  if (E > kMaxExperts || K <= 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) return launch_cap<__nv_bfloat16>(x, w, out, E, C, K, N, trans, st);
  if (dtype == repro::kF32) return launch_cap<float>(x, w, out, E, C, K, N, trans, st);
  return -2;
}

// x [E, C, K], dy [E, C, N] -> dw [E, K, N] (zeros where C == 0).
extern "C" int grouped_matmul_capacity_dw(const void* x, const void* dy, void* dw, int dtype,
                                          int E, int C, int K, int N, void* stream) {
  if (E <= 0 || K <= 0 || N <= 0) return 0;
  if (E > kMaxExperts || C < 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) return launch_cap_dw<__nv_bfloat16>(x, dy, dw, E, C, K, N, st);
  if (dtype == repro::kF32) return launch_cap_dw<float>(x, dy, dw, E, C, K, N, st);
  return -2;
}
