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
// path's C = 200) of ONE expert: each weight element is read from HBM once
// per call (ceil(C / 256) times for a larger C, whose row chunks are
// adjacent in launch order and meet in L2).  bf16 (the training path) is
// built for Hopper: a 384-thread block of one producer warpgroup and two
// consumer warpgroups over a 128-column output tile.  The producer's one
// thread streams (x, w) tiles 64 deep with TMA (3-D tensor maps over
// [E, C, K] and the weights, 128-byte swizzle, zeros past C, K and N) into
// a 4-stage ring of 48 KB stages guarded by "full" / "empty" mbarriers,
// 4 x 16 KB of weights in flight per SM; each consumer runs wgmma m64n128k16
// on its 128 rows with f32 accumulators in registers (setmaxnreg moves
// registers from the producer to them).  The forward's w[e] [K, N] is the
// MN-major B operand (wgmma's transpose bit); dX reads w[e] [N_out, K_red]
// as the K-major B operand: neither copies.  The x tile is re-read for every
// 128 columns, from L2; two blocks of adjacent column tiles form a cluster
// and each loads half of it into both (TMA multicast), halving that L2
// traffic.  The epilogue stages bf16 in swizzled shared memory and TMA
// stores it, clipped at C and N.  f32 runs the CUDA-core kernel: 256-row x
// 64-column blocks, one shared-memory stage.
// dW is the dropless dW tile over the expert's rows [e * C, (e + 1) * C).
//
// Both layouts: no atomics, no split of K.  Every output element sums its K
// products in one order fixed by K alone, so two calls agree bit for bit
// and an expert's results do not depend on the slot it occupies.  dW's sum
// order depends only on the expert's own rows (zero padding rows add exact
// zeros).  Kernel 7 and both dW kernels run bf16 on the tensor cores
// through WMMA (16 x 16 x 16, f32 accumulators) with tiles staged through
// shared memory by 16-byte loads, one stage; f32 on the CUDA cores.
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
// capacity layout, bf16 forward and dX: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------

struct Cap90 {
  static constexpr int BM = 256;  // rows of one expert per block: 2 consumers x 2 x m64
  static constexpr int BN = 128;  // output columns per block: one m64n128 per m64 tile
  static constexpr int BK = 64;   // reduction depth per stage: one 128-byte swizzled row
  static constexpr int kStages = 4;
  static constexpr int kCluster = 2;        // CTAs along N sharing each x tile
  static constexpr int kThreads = 384;      // warpgroup 0 produces, 1 and 2 consume
  static constexpr int kConsumerWarps = 8;  // each arrives on a stage's "empty" in every CTA
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
  using L = Cap90;
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

// out[e, r0:r0+256, n0:n0+128] = x[e, rows] @ W[e]; kBTrans: W[e] stored
// [N, K] (dX).  blockIdx = (row chunk, n tile, e): the row chunks of one
// (expert, n tile) are adjacent in launch order, so for C > 256 they meet
// in L2; a cluster is kCluster adjacent n tiles of one (row chunk, expert).
// Maps: x [E, C, K] boxes {64, 256 / kCluster, 1}; w [E, K, N] boxes
// {64, 64, 1} (kBTrans: [E, N, K], {64, 128, 1}); out [E, C, N] boxes
// {64, 64, 1}; all 128-byte swizzled, zeros past every edge on load,
// clipped on store.
template <bool kBTrans>
__global__ void __cluster_dims__(1, Cap90::kCluster, 1) __launch_bounds__(Cap90::kThreads, 1)
    gmm_cap_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_out, int C, int K, int N) {
  using namespace repro::hopper;
  using L = Cap90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa = base;
  const uint32_t sb = base + L::kStages * L::A_BYTES;
  const uint32_t bars = base + L::kStages * L::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::kStages + s); };
  const int r0 = blockIdx.x * L::BM;
  const int n0 = blockIdx.y * L::BN;
  const int e = blockIdx.z;
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
                              all, k0, r0 + rank * L::A_SLICE_ROWS, e);
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
    // two m64 tiles.  Every wgmma is issued unconditionally (a tile past C
    // multiplies zeros): a branch around them serialises the wgmma pipeline.
    reg_alloc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    const int rows = min(L::BM, C - r0) - 128 * c;
    const int mt = rows <= 0 ? 0 : rows <= 64 ? 1 : 2;  // m64 tiles to store
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
        wgmma_m64n128k16_bf16<kBTrans ? 0 : 1>(acc0, desc_sw128(a + kk * 32, 16, 1024), db);
        wgmma_m64n128k16_bf16<kBTrans ? 0 : 1>(
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
    // TMA (rows past C and columns past N are not written).
    named_bar_sync(1, 2 * 128);
    if (mt > 0) {
      const uint32_t stage = base + c * L::A_BYTES;
      stage_m64(acc0, stage, 0);
      if (mt == 2) stage_m64(acc1, stage, 64);
      fence_proxy_async();
      named_bar_sync(2 + c, 128);
      if (t == 0) {
        for (int jm = 0; jm < mt; ++jm)
          for (int half = 0; half < 2; ++half)
            if (n0 + 64 * half < N)
              tma_store_3d(&map_out, stage + half * 2 * L::HALF_BYTES + jm * L::M64_BYTES,
                           n0 + 64 * half, r0 + 128 * c + 64 * jm, e);
        tma_store_commit();
        tma_store_wait_read();
      }
    }
    // No CTA exits while another may still arrive on its barriers.
    __syncwarp();
    cluster_sync();
  }
}

int launch_cap_bf16(const void* x, const void* w, void* out, int E, int C, int K, int N, int trans,
                    cudaStream_t st) {
  using namespace repro::hopper;
  using L = Cap90;
  CUtensorMap mx, mw, mo;
  int err = bf16_map_3d(&mx, x, K, C, E, 64, L::A_SLICE_ROWS);
  if (!err) err = trans ? bf16_map_3d(&mw, w, K, N, E, 64, L::BN)
                        : bf16_map_3d(&mw, w, N, K, E, 64, 64);
  if (!err) err = bf16_map_3d(&mo, out, N, C, E, 64, 64);
  if (err) return err;
  // n tiles rounded up to whole clusters: a tile past N loads zeros and
  // stores nothing.
  const int n_tiles = (N + L::BN - 1) / L::BN;
  const dim3 grid((C + L::BM - 1) / L::BM, (n_tiles + L::kCluster - 1) / L::kCluster * L::kCluster,
                  E);
  const auto kernel = trans ? &gmm_cap_wgmma_kernel<true> : &gmm_cap_wgmma_kernel<false>;
  const cudaError_t ae = repro::allow_smem(kernel, L::SMEM);
  if (ae != cudaSuccess) return static_cast<int>(ae);
  kernel<<<grid, L::kThreads, L::SMEM, st>>>(mx, mw, mo, C, K, N);
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
  if (dtype == repro::kBF16) return launch_cap_bf16(x, w, out, E, C, K, N, trans, st);
  if (dtype == repro::kF32) return launch_cap_f32(x, w, out, E, C, K, N, trans, st);
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
