// Mamba-2 SSD intra-chunk pass: for each group g (one batch row, chunk and
// head), with cum the within-chunk cumulative sum of the log-decays da,
//
//   y[l, p]     = sum_{s <= l} (C_l . B_s) exp(cum[l] - cum[s]) x[s, p]
//   state[n, p] = sum_s B[s, n] exp(cum[L-1] - cum[s]) x[s, p]
//
// Replaces: src/repro/kernels/ssd_chunk.py, ssd_chunk_pallas (_ssd_kernel):
// one grid cell per group with the [L, N] B/C tiles, the [L, P] inputs and
// the decay prefix in VMEM, fusing C B^T, the causal decay gate, the gated
// [L, L] @ [L, P] product and the chunk-state product; the [L, L] gate never
// reaches device memory.
//
// What bounds it on an H100: operations, in f32 without tensor cores.  At
// Mamba-2 1.3B's prefill of 256 tokens (G = 64 heads, L = 256, N = 128,
// P = 64) the full-L x L count is 1.88 GFLOP, ~28 us at 67 TFLOP/s, against
// ~10.8 MB of bytes (~3.2 us).  Counting only the causal half and one C B^T
// per chunk for all heads it is ~0.8 GFLOP.
//
// Design (a simple kernel that is right first):
// * B and C are shared by the H heads of a (batch, chunk): they arrive as
//   [G / H, L, N] and group g reads row g / H, so the 64x expansion of the
//   plain version's [G, L, N] layout never exists.  C B^T is recomputed per
//   head (the open optimisation).
// * blockIdx.x = group, blockIdx.z = a 64-wide tile of P.  blockIdx.y below
//   ceil(L / 64) is a 64-row tile of y; above it, a 64-row tile of N of the
//   chunk state.  256 threads, each owning a 4 x 4 micro-tile of a 64 x 64
//   output, operands in shared memory (row stride 68 floats keeps float4
//   reads aligned and spreads the transposed stores over banks).
// * Every block scans da into cum in shared memory itself (warp 0: 32
//   sequential runs, then a shuffle scan of their totals).  Its order of
//   summation differs from torch.cumsum's, and from the cum the model
//   computes outside for the inter-chunk decays: both agree to f32 rounding.
// * A y tile keeps its C rows ([N, 64], N <= 128) resident and walks the
//   s tiles up to the diagonal: C B^T over N into registers, the gate
//   exp(cum[l] - cum[s]) taken ONLY where s <= l (above the diagonal the
//   decay is positive and may overflow: exp is never evaluated there, so no
//   inf * 0 = NaN), stored transposed, then y += gate @ x[s tile].
// * A state tile walks s in tiles of 64, scaling B's rows by
//   exp(cum[L-1] - cum[s]) as they are staged, then state += B^T @ x.
// * f32 end to end, fixed summation order (no atomics): deterministic.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kStride = 68;  // shared row stride in floats
constexpr int kThreads = 256;
constexpr int kMaxN = 128;

__device__ void chunk_cumsum(const float* __restrict__ da, float* cum, int L) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (L + 31) / 32;
  const int lo = min(L, lane * per), hi = min(L, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += da[i];
    cum[i] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(repro::kFullMask, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run;
  for (int i = lo; i < hi; ++i) cum[i] += excl;
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ da,
                     const float* __restrict__ bmat, const float* __restrict__ cmat,
                     float* __restrict__ y, float* __restrict__ state, int L, int P, int N,
                     int heads) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x;
  const int bc = g / heads;
  const int p0 = blockIdx.z * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int n_ltiles = (L + kTile - 1) / kTile;

  float* ct = smem;                    // [N][kStride]: C rows of the l tile, transposed
  float* bt = ct + N * kStride;        // [N][kStride]: B rows of the s tile, transposed
  float* gt = bt + N * kStride;        // [64][kStride]: gate^T, or B * decay (state)
  float* xs = gt + kTile * kStride;    // [64][kStride]: x rows of the s tile
  float* cum = xs + kTile * kStride;   // [L]

  const float* xg = x + static_cast<size_t>(g) * L * P;
  const float* bg = bmat + static_cast<size_t>(bc) * L * N;
  const float* cg = cmat + static_cast<size_t>(bc) * L * N;
  chunk_cumsum(da + static_cast<size_t>(g) * L, cum, L);

  auto load_x = [&](int s0) {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int s = e / kTile, p = e % kTile;
      const bool in = s0 + s < L && p0 + p < P;
      xs[s * kStride + p] = in ? xg[static_cast<size_t>(s0 + s) * P + p0 + p] : 0.f;
    }
  };

  float acc[4][4];
  if (blockIdx.y >= n_ltiles) {
    // ---- chunk state, rows n0 .. n0+63 -----------------------------------
    const int n0 = (blockIdx.y - n_ltiles) * kTile;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    __syncthreads();  // cum
    const float last = cum[L - 1];
    for (int s0 = 0; s0 < L; s0 += kTile) {
      __syncthreads();  // the previous tile's reads are done
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int s = e / kTile, n = e % kTile;
        float v = 0.f;
        if (s0 + s < L && n0 + n < N)
          v = bg[static_cast<size_t>(s0 + s) * N + n0 + n] * expf(last - cum[s0 + s]);
        gt[s * kStride + n] = v;
      }
      load_x(s0);
      __syncthreads();
      const int send = min(kTile, L - s0);
      for (int s = 0; s < send; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(gt + s * kStride + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(xs + s * kStride + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    float* sg = state + static_cast<size_t>(g) * N * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty * 4 + i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx * 4 + j;
        if (p < P) sg[static_cast<size_t>(n) * P + p] = acc[i][j];
      }
    }
    return;
  }

  // ---- intra-chunk output, rows l0 .. l0+63 --------------------------------
  const int lt = blockIdx.y;
  const int l0 = lt * kTile;
  for (int e = tid; e < kTile * N; e += kThreads) {
    const int r = e / N, k = e % N;
    ct[k * kStride + r] = l0 + r < L ? cg[static_cast<size_t>(l0 + r) * N + k] : 0.f;
  }
  float yacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;

  for (int st = 0; st <= lt; ++st) {
    const int s0 = st * kTile;
    __syncthreads();  // cum and C are in; the previous tile's reads are done
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int c = e / N, k = e % N;
      bt[k * kStride + c] = s0 + c < L ? bg[static_cast<size_t>(s0 + c) * N + k] : 0.f;
    }
    load_x(s0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < N; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(ct + k * kStride + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(bt + k * kStride + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx * 4 + j;
        // Causal: the decay is taken only for s <= l < L.
        float gate = 0.f;
        if (s <= l && l < L) gate = acc[i][j] * expf(cum[l] - cum[s]);
        gt[(tx * 4 + j) * kStride + ty * 4 + i] = gate;
      }
    }
    __syncthreads();
    const int send = min(kTile, L - s0);
    for (int s = 0; s < send; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(gt + s * kStride + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(xs + s * kStride + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(av[i], bv[j], yacc[i][j]);
    }
  }
  float* yg = y + static_cast<size_t>(g) * L * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p < P) yg[static_cast<size_t>(l) * P + p] = yacc[i][j];
    }
  }
}

}  // namespace

// x [G, L, P], da [G, L], bmat/cmat [G / heads, L, N] (group g reads row
// g / heads), all f32 contiguous; y [G, L, P], state [G, N, P] f32.
// 1 <= N <= 128 (the wrapper checks).  Returns cudaGetLastError().
extern "C" int ssd_chunk_f32(const void* x, const void* da, const void* bmat, const void* cmat,
                             void* y, void* state, int G, int L, int P, int N, int heads,
                             void* stream) {
  if (G <= 0 || L <= 0) return 0;
  if (N < 1 || N > kMaxN || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ltiles = (L + kTile - 1) / kTile;
  const int n_ntiles = (N + kTile - 1) / kTile;
  const dim3 grid(G, n_ltiles + n_ntiles, (P + kTile - 1) / kTile);
  const size_t smem = (static_cast<size_t>(2 * N + 2 * kTile) * kStride + L) * sizeof(float);
  cudaError_t err = repro::allow_smem(ssd_chunk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(da),
      static_cast<const float*>(bmat), static_cast<const float*>(cmat), static_cast<float*>(y),
      static_cast<float*>(state), L, P, N, heads);
  return static_cast<int>(cudaGetLastError());
}
