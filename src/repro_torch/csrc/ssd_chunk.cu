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
// What bounds it on an H100: at Mamba-2 1.3B's prefill of 256 tokens (G = 64
// heads, L = 256, N = 128, P = 64) the least work is 0.546 GFLOP (C B^T once
// per chunk over the causal half, the gated product over the causal half,
// the state product) against 10.8 MB (3.2 us at 3.35 TB/s).  In f32 on CUDA
// cores that is 8 us of operations; on the tensor cores in 3xTF32 (three
// TF32 products per f32 product) 1.64 GFLOP, 3.3 us at 495 TFLOP/s.
//
// Design:
// * Tensor cores with f32 accuracy: every product is mma.sync m16n8k8 TF32
//   with each f32 operand split into a TF32 high part and a residual,
//   a_lo b_hi + a_hi b_lo + a_hi b_hi into one f32 accumulator (3xTF32;
//   a_hi b_hi alone, 1xTF32, fails the 1e-4 check).  The split is integer
//   and f32 ALU work (cvt.rna.tf32 was slower).
// * C B^T once per (batch, chunk): a first kernel computes the causal
//   64 x 64 tiles of C B^T of every (batch, chunk) into a workspace the
//   wrapper allocates, laid out as the A fragments of m16n8k8 (one float4 a
//   lane for each 16 x 8 tile).  The 64 heads of a chunk read it from L2.
//   The pass is launched with programmatic stream serialization, so it
//   starts while that kernel runs.
// * The pass: one CTA per (group, 32 columns of P), 16 warps.  x[s, p-block]
//   is staged once (256 rows at a time) and read by every warp: the state
//   product and the y product share it.  Warp w < 8 owns the 16-row y tiles
//   w and 15 - w of each 256-row pass (2w + 2 and 32 - 2w k-steps: 34 a
//   warp at L = 256); warp 8 + w the 16-row state tile w (32 k-steps).  A
//   fragment (C B^T of a y tile, B of a state tile) is read by one warp
//   only, so each lane streams its own fragment values through the warp's
//   own cp.async ring, kRing k-steps ahead, and the warps never wait on one
//   another.  The state warps skip the wait for C B^T.
// * The gate of head g is formed in registers from the shared C B^T
//   fragment: cb * exp2((cum[l] - cum[s]) log2 e) where s <= l, and
//   cb * exp2(-inf) = 0 elsewhere: the decay above the diagonal (positive,
//   overflowing at da = -40 a step) is never evaluated, so no inf * 0 = NaN.
//   The state's A operand is B[s, n] exp(cum[L-1] - cum[s]), with the decay
//   per s computed once per CTA.
// * Every CTA scans da into cum in shared memory itself (warp 0: 32
//   sequential runs, then a shuffle scan of their totals).  Its order of
//   summation differs from torch.cumsum's, and from the cum the model
//   computes outside for the inter-chunk decays: both agree to f32 rounding.
// * L above 256 runs in passes of 256 y rows, each streaming s from 0 to
//   its last row; the state is taken in the last pass.  f32 in and out,
//   fixed summation order, no atomics: deterministic.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxN = 128;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// ---- TF32 tensor-core products --------------------------------------------

// x = hi + lo: hi is x with its 13 low mantissa bits cleared (a TF32 value,
// so x - hi is exact), lo the rest.  The tensor cores read the top 19 bits
// of a TF32 operand and ignore the others, so lo enters with its own 13 low
// bits dropped: 2^-21 of x.  One AND and one FADD: the pass ran 14% faster
// than with cvt.rna.tf32 for both parts.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[t][nt] += a[t] b[nt] for every tile t that is on, in f32 accuracy
// (3xTF32: a_lo b_hi, then a_hi b_lo, then a_hi b_hi), one TF32 term of
// every product at a time, so no product waits on the one before it.
template <int kA, int kT>
__device__ __forceinline__ void mma_f32(float (&acc)[kA][4][4], const uint32_t (&ah)[kT][4],
                                       const uint32_t (&al)[kT][4], const uint32_t (&bh)[4][2],
                                       const uint32_t (&bl)[4][2], const bool (&on)[kT]) {
  static_assert(kT <= kA, "more tiles than accumulators");
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (!on[t]) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_tf32(acc[t][nt], term == 0 ? al[t] : ah[t], term == 1 ? bl[nt] : bh[nt]);
    }
}

// 2^x in one MUFU instruction: relative error below 2^-22; results below
// 2^-126 flush to 0 (a decay that small adds nothing at f32 accuracy).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The causal decay gate of one C B^T value: cb exp(cum[l] - cum[s]) where
// s <= l, and cb exp2(-inf) = 0 elsewhere (the decay there is never taken).
__device__ __forceinline__ float gate(float cb, bool causal, float dcum) {
  return cb * exp2_ftz(causal ? dcum * kLog2e : -INFINITY);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}

// ---- the C B^T workspace ----------------------------------------------------
//
// Per (batch, chunk): fragment tiles (mt, kt), mt < 4 TI, kt < 8 TI with
// TI = ceil(L / 64); tile (mt, kt) is 128 floats, lane-major: lane i holds
// CB[16mt + r][8kt + c], CB[16mt + 8 + r][8kt + c], CB[16mt + r][8kt + 4 + c],
// CB[16mt + 8 + r][8kt + 4 + c] with r = i / 4, c = i % 4 (the A operand of
// m16n8k8).  Only causal tiles (8kt <= 16mt + 15) are written or read.

__host__ __device__ inline size_t cb_floats_per_chunk(int ti) {
  return static_cast<size_t>(4 * ti) * (8 * ti) * 128;
}

constexpr int kCbThreads = 256;

// dst <- src[row][k .. k + kBytes / 4) of a [L, N] matrix, zeros past L or N.
template <int kBytes>
__device__ __forceinline__ void stage_part(float* dst, const float* src, int row, int k, int L,
                                           int N) {
  const bool in = row < L && k < N;
  repro::cp_async<kBytes>(dst, in ? src + static_cast<size_t>(row) * N + k : src, in);
}

// One CTA per causal 64 x 64 tile (I, J), J <= I, of one (batch, chunk):
// C[64I.., :] B[64J.., :]^T over K = N.  Warp w: rows 16 (w % 4), columns
// 32 (w / 4) .. + 31.
__global__ void __launch_bounds__(kCbThreads)
    ssd_cb_kernel(const float* __restrict__ bmat, const float* __restrict__ cmat,
                  float* __restrict__ cb, int L, int N, int ti, int vec) {
  extern __shared__ __align__(16) float smem[];
  // The pass may start now: it reads this kernel's output only after its
  // griddepcontrol.wait.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int stride = round_up(N, 32) + 4;  // = 4 mod 32: conflict-free fragment reads
  const int kpad = round_up(N, 8);
  float* cs = smem;
  float* bs = cs + 64 * stride;
  int pair = blockIdx.x, I = 0;
  while (pair > I) pair -= ++I;
  const int J = pair;
  const int bc = blockIdx.y;
  const float* cg = cmat + static_cast<size_t>(bc) * L * N;
  const float* bg = bmat + static_cast<size_t>(bc) * L * N;
  // Rows 64I.. of C and 64J.. of B, zero past L and N.
  if (vec) {
    for (int e = threadIdx.x; e < 64 * (kpad / 4); e += kCbThreads) {
      const int r = e / (kpad / 4), k = 4 * (e % (kpad / 4));
      stage_part<16>(cs + r * stride + k, cg, 64 * I + r, k, L, N);
      stage_part<16>(bs + r * stride + k, bg, 64 * J + r, k, L, N);
    }
  } else {
    for (int e = threadIdx.x; e < 64 * kpad; e += kCbThreads) {
      const int r = e / kpad, k = e % kpad;
      stage_part<4>(cs + r * stride + k, cg, 64 * I + r, k, L, N);
      stage_part<4>(bs + r * stride + k, bg, 64 * J + r, k, L, N);
    }
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = (warp % 4) * 16, cw = (warp / 4) * 32;
  float acc[1][4][4] = {};
  const bool on[1] = {true};
  for (int k0 = 0; k0 < kpad; k0 += 8) {
    const float* ap = cs + (rw + lane / 4) * stride + k0 + lane % 4;
    const float av[4] = {ap[0], ap[8 * stride], ap[4], ap[8 * stride + 4]};
    uint32_t ah[1][4], al[1][4], bh[4][2], bl[4][2];
    split4(av, ah[0], al[0]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* bp = bs + (cw + nt * 8 + lane / 4) * stride + k0 + lane % 4;
      split_tf32(bp[0], bh[nt][0], bl[nt][0]);
      split_tf32(bp[4], bh[nt][1], bl[nt][1]);
    }
    mma_f32(acc, ah, al, bh, bl, on);
  }
  // C fragment (row r, columns 2c, 2c + 1; row r + 8) -> A-fragment layout.
  const int mt = 4 * I + warp % 4;
  float* out = cb + cb_floats_per_chunk(ti) * bc;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int kt = 8 * J + (cw / 8) + nt;
    if (8 * kt > 16 * mt + 15) continue;  // above the diagonal: never read
    float* tile = out + (static_cast<size_t>(mt) * (8 * ti) + kt) * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lane / 4 + (i >= 2 ? 8 : 0);
      const int c = 2 * (lane % 4) + (i & 1);
      const int dst_lane = (r % 8) * 4 + c % 4;
      const int comp = (r >= 8 ? 1 : 0) + (c >= 4 ? 2 : 0);
      tile[dst_lane * 4 + comp] = acc[0][nt][i];
    }
  }
}

// ---- the main pass ------------------------------------------------------------

constexpr int kThreads = 512;   // 16 warps: 8 own y tiles, 8 own state tiles
constexpr int kBlock = 256;     // rows of y a pass, and rows of s (x) staged at once
constexpr int kPB = 32;         // columns of P per CTA: 4 n-tiles of 8
constexpr int kXStride = kPB + 8;  // = 8 mod 32: conflict-free B-operand reads
constexpr int kRing = 4;        // k-steps of A fragments a warp keeps in flight
constexpr int kSlot = 256;      // floats a ring slot: two y tiles' fragments, or one state tile's

__host__ __device__ inline size_t main_smem_floats(int L) {
  return 2 * static_cast<size_t>(round_up(L, kBlock)) + kBlock * kXStride +
         static_cast<size_t>(kThreads / 32) * kRing * kSlot;
}

__device__ void chunk_cumsum(const float* __restrict__ da, float* cum, int L) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) cum[i] = da[i];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (L + 31) / 32;
  const int lo = min(L, lane * per), hi = min(L, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += cum[i];
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

__global__ void __launch_bounds__(kThreads, 1)
    ssd_main_kernel(const float* __restrict__ x, const float* __restrict__ da,
                    const float* __restrict__ bmat, const float* __restrict__ cb,
                    float* __restrict__ y, float* __restrict__ state, int L, int P, int N,
                    int heads, int ti, int vec_x) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x;
  const int bc = g / heads;
  const int p0 = blockIdx.y * kPB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool y_warp = warp < 8;  // warps 8..15 take the state
  const int w8 = warp % 8;
  const int lpad = round_up(L, kBlock);
  const int kt_count = 8 * ti;

  float* cum = smem;                        // [lpad]
  float* wdec = cum + lpad;                 // [lpad]: exp(cum[L-1] - cum[s]), 0 past L
  float* xs = wdec + lpad;                  // [kBlock][kXStride]: x rows of the s block
  float* ring = xs + kBlock * kXStride + warp * kRing * kSlot;  // this warp's

  const float* xg = x + static_cast<size_t>(g) * L * P;
  const float* bg = bmat + static_cast<size_t>(bc) * L * N;
  const float* cbg = cb + cb_floats_per_chunk(ti) * bc;

  chunk_cumsum(da + static_cast<size_t>(g) * L, cum, L);
  __syncthreads();
  const float last = cum[L - 1];
  // Past L: no decay into the state, and cum = -1e30, so a padding row's
  // gate is exp2(-huge) = 0 (and exp2(0) * 0 where row and column both pad).
  for (int i = tid; i < lpad; i += kThreads) {
    wdec[i] = i < L ? exp2_ftz((last - cum[i]) * kLog2e) : 0.f;
    if (i >= L) cum[i] = repro::kNegBig;
  }

  for (int r0 = 0; r0 < L; r0 += kBlock) {
    const bool last_pass = r0 + kBlock >= L;
    const int s_end = last_pass ? L : r0 + kBlock;  // s this pass reads
    const int mt0 = r0 / 16;
    const int ya = mt0 + w8, yb = mt0 + 15 - w8;  // a y warp's tiles
    const bool ya_ok = y_warp && 16 * ya < L, yb_ok = y_warp && 16 * yb < L;
    const bool st_ok = !y_warp && last_pass && 16 * w8 < N;  // a state warp's tile
    // The last k-step + 1 this warp reads: its larger y tile's diagonal, or all of s.
    const int kt_stop = st_ok ? (s_end + 7) / 8
                      : yb_ok ? min(2 * yb + 2, (s_end + 7) / 8)
                      : ya_ok ? min(2 * ya + 2, (s_end + 7) / 8) : 0;
    float acc[2][4][4] = {};  // a y warp's tiles ya and yb; a state warp's tile

    for (int sb = 0; sb < s_end; sb += kBlock) {
      __syncthreads();  // the previous block's x is consumed
      const int rows = min(kBlock, s_end - sb);
      const int rows8 = round_up(rows, 8);  // the k-steps read no row past these
      if (vec_x) {
        for (int e = tid; e < rows8 * (kPB / 4); e += kThreads) {
          const int r = e / (kPB / 4), c = 4 * (e % (kPB / 4));
          const bool in = r < rows && p0 + c < P;
          repro::cp_async<16>(xs + r * kXStride + c,
                              in ? xg + static_cast<size_t>(sb + r) * P + p0 + c : xg, in);
        }
      } else {
        for (int e = tid; e < rows8 * kPB; e += kThreads) {
          const int r = e / kPB, c = e % kPB;
          const bool in = r < rows && p0 + c < P;
          repro::cp_async<4>(xs + r * kXStride + c,
                             in ? xg + static_cast<size_t>(sb + r) * P + p0 + c : xg, in);
        }
      }
      repro::cp_async_commit();
      repro::cp_async_wait<0>();
      __syncthreads();  // x of the block is in

      // This warp's k-steps of the block, each lane streaming its own A
      // fragment values through the warp's ring (it reads back only what
      // it copied, so no barrier): the C B^T fragments of its y tiles, or
      // B[s, n] of its state tile.
      const int kt0 = sb / 8, kt1 = min(kt_stop, (sb + rows + 7) / 8);
      // C B^T is the previous kernel's output (this one is launched with
      // programmatic stream serialization): the y warps wait for it before
      // their first read; the state warps never read it and overlap that
      // kernel's tail.
      if (y_warp && r0 == 0 && sb == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
      auto issue = [&](int kt) {
        float* slot = ring + (kt % kRing) * kSlot;
        if (y_warp) {
          if (ya_ok && kt <= 2 * ya + 1)
            repro::cp_async<16>(slot + lane * 4,
                                cbg + (static_cast<size_t>(ya) * kt_count + kt) * 128 + lane * 4,
                                true);
          if (yb_ok && kt <= 2 * yb + 1)
            repro::cp_async<16>(slot + 128 + lane * 4,
                                cbg + (static_cast<size_t>(yb) * kt_count + kt) * 128 + lane * 4,
                                true);
        } else {
          const int s0 = 8 * kt + lane % 4, n0 = 16 * w8 + lane / 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = s0 + (i >> 1) * 4, n = n0 + (i & 1) * 8;
            const bool in = s < L && n < N;
            repro::cp_async<4>(slot + lane * 4 + i, in ? bg + static_cast<size_t>(s) * N + n : bg,
                               in);
          }
        }
      };
      for (int i = 0; i < kRing - 1; ++i) {
        if (kt0 + i < kt1) issue(kt0 + i);
        repro::cp_async_commit();
      }
      for (int kt = kt0; kt < kt1; ++kt) {
        if (kt + kRing - 1 < kt1) issue(kt + kRing - 1);
        repro::cp_async_commit();
        repro::cp_async_wait<kRing - 1>();
        const float* slot = ring + (kt % kRing) * kSlot;
        const int s = 8 * kt, k8 = s - sb;
        uint32_t xh[4][2], xl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* xp = xs + (k8 + lane % 4) * kXStride + nt * 8 + lane / 4;
          split_tf32(xp[0], xh[nt][0], xl[nt][0]);
          split_tf32(xp[4 * kXStride], xh[nt][1], xl[nt][1]);
        }
        const int s0 = s + lane % 4, s1 = s0 + 4;
        if (y_warp) {
          // Both tiles' gated C B^T first, so their exps overlap.
          const bool on[2] = {ya_ok && kt <= 2 * ya + 1, yb_ok && kt <= 2 * yb + 1};
          uint32_t ah[2][4], al[2][4];
          const float cs0 = cum[s0], cs1 = cum[s1];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int mt = u == 0 ? ya : yb;
            const float4 c = on[u] ? *reinterpret_cast<const float4*>(slot + u * 128 + lane * 4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            const int l0 = min(16 * mt + lane / 4, lpad - 9), l1 = l0 + 8;
            const float cl0 = cum[l0], cl1 = cum[l1];
            const float gv[4] = {gate(c.x, s0 <= l0, cl0 - cs0), gate(c.y, s0 <= l1, cl1 - cs0),
                                 gate(c.z, s1 <= l0, cl0 - cs1), gate(c.w, s1 <= l1, cl1 - cs1)};
            split4(gv, ah[u], al[u]);
          }
          mma_f32(acc, ah, al, xh, xl, on);
        } else {
          // The state tile: B[s, n] exp(cum[L-1] - cum[s]).
          const bool on[1] = {true};
          uint32_t ah[1][4], al[1][4];
          const float4 b = *reinterpret_cast<const float4*>(slot + lane * 4);
          const float w0 = wdec[s0], w1 = wdec[s1];
          const float av[4] = {b.x * w0, b.y * w0, b.z * w1, b.w * w1};
          split4(av, ah[0], al[0]);
          mma_f32(acc, ah, al, xh, xl, on);
        }
      }
      repro::cp_async_wait<0>();
    }

    // C fragments: rows lane / 4 (+ 8), columns 2 (lane % 4) (+ 1) of each n-tile.
    auto store = [&](const float (&a)[4][4], float* out, int row0, int rows) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = p0 + nt * 8 + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + lane / 4 + 8 * h;
          if (row >= rows) continue;
          float* o = out + static_cast<size_t>(row) * P + col;
          if (col + 1 < P) {
            o[0] = a[nt][2 * h];
            o[1] = a[nt][2 * h + 1];
          } else if (col < P) {
            o[0] = a[nt][2 * h];
          }
        }
      }
    };
    float* yg = y + static_cast<size_t>(g) * L * P;
    if (ya_ok) store(acc[0], yg, 16 * ya, L);
    if (yb_ok) store(acc[1], yg, 16 * yb, L);
    if (st_ok) store(acc[0], state + static_cast<size_t>(g) * N * P, 16 * w8, N);
  }
}

}  // namespace

// Floats of the C B^T workspace ssd_chunk_f32 takes, for chunk length L and
// `chunks` (batch, chunk) pairs.
extern "C" long long ssd_chunk_workspace_floats(int L, int chunks) {
  if (L <= 0 || chunks <= 0) return 0;
  return static_cast<long long>(cb_floats_per_chunk((L + 63) / 64)) * chunks;
}

// x [G, L, P], da [G, L], bmat/cmat [G / heads, L, N] (group g reads row
// g / heads), all f32 contiguous; y [G, L, P], state [G, N, P] f32;
// workspace: ssd_chunk_workspace_floats(L, G / heads) f32, 16-byte aligned.
// 1 <= N <= 128 (the wrapper checks).  Two launches: C B^T, then the pass.
// Returns cudaGetLastError().
extern "C" int ssd_chunk_f32(const void* x, const void* da, const void* bmat, const void* cmat,
                             void* y, void* state, void* workspace, int G, int L, int P, int N,
                             int heads, void* stream) {
  if (G <= 0 || L <= 0 || P <= 0) return 0;
  if (N < 1 || N > kMaxN || heads < 1 || G % heads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ti = (L + 63) / 64;
  const int chunks = G / heads;
  float* cb = static_cast<float*>(workspace);

  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const size_t cb_smem = 2 * 64 * static_cast<size_t>(round_up(N, 32) + 4) * sizeof(float);
  cudaError_t err = repro::allow_smem(ssd_cb_kernel, cb_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_cb_kernel<<<dim3(ti * (ti + 1) / 2, chunks), kCbThreads, cb_smem, st>>>(
      static_cast<const float*>(bmat), static_cast<const float*>(cmat), cb, L, N, ti,
      N % 4 == 0 && aligned(bmat) && aligned(cmat));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int vec_x = P % 4 == 0 && aligned(x);
  const size_t smem = main_smem_floats(L) * sizeof(float);
  err = repro::allow_smem(ssd_main_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, (P + kPB - 1) / kPB);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_main_kernel, static_cast<const float*>(x),
                           static_cast<const float*>(da), static_cast<const float*>(bmat),
                           static_cast<const float*>(cb), static_cast<float*>(y),
                           static_cast<float*>(state), L, P, N, heads, ti, vec_x);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
