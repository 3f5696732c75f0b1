// Streaming-softmax (flash) attention for prefill.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel): q [B, Hq, S, D], k/v [B, Hkv, S, D] -> [B, Hq, S, D];
// GQA head hq // (Hq / Hkv), scale 1/sqrt(D), causal, sliding window
// q - k < window, tanh logit softcap; rows with no valid key give 0.
//
// What bounds it on an H100: operations.  At grok-1's prefill (q
// [1, 48, S, 128] bf16, S a prompt length) the QK^T and PV products are
// 2 * 2 * 48 * S^2/2 * 128 FLOP against a few MB of q/k/v, far above the
// 295 FLOP/byte ridge; the card's rate is the tensor cores' 989 TFLOP/s.
//
// f32 (the CUDA-core design, kept for f32 and for the bf16 backward above
// D = 128): one 256-thread block per (b, hq, 64-row q tile).  Four threads
// share a q row, each holding D/4 of its dims plus a D/4 f32 accumulator in
// registers.  64-row K/V tiles are staged in shared memory as f32; per tile:
// scores by a 4-lane shuffle reduction, the tile's row max, p = expf(s -
// m_new) (IEEE, no fast math), and the running-max / running-sum rescale of
// the accumulator.  The products run on the CUDA cores.  Its backward, in two
// launches (FlashAttention-2 style):
//   1. dQ: one block per (b, hq, 64-row q tile), laid out as the forward.
//      Each row first forms delta = rowsum(dO * O) (kept for launch 2),
//      then walks the key tiles the forward walked: p = exp(s - lse),
//      dp = dO . v, ds = p (dp - delta) (times 1 - tanh^2 under softcap),
//      dq += ds k.
//   2. dK/dV: one block per (b, kv head, 64-key tile), four threads per key
//      row holding k, v and the dk / dv accumulators in registers.  It
//      loops over the q tiles of ALL the group's q heads that can see the
//      key tile (causal: q >= k; window: q - k < window), staging q (scaled)
//      and dO in shared memory: dv += p dO, dk += ds q.
//
// bf16 (the training and prefill path) runs on the tensor cores with the
// pieces of hopper.cuh: 3-D TMA tensor maps {D, S, B * H} (a box past S or
// past D reads zeros from the same head and a store clips there, so any S
// and every D of 32 .. 256 go through boxes of 64 columns: D is padded to a
// multiple of 64 by the zero fill, which adds exact zeros), a ring of K/V or
// Q/dO stages guarded by "full" / "empty" mbarriers, one producer warpgroup
// (one thread issues every TMA load; setmaxnreg moves its registers to the
// consumers) and two consumer warpgroups of 64 rows each running wgmma with
// f32 accumulators in registers.  Every wgmma is issued unconditionally; the
// mask is a select per element, never a branch (a branch around wgmma makes
// ptxas serialise it, C7520).
//   Forward: one CTA per (b, hq, 128-row q tile), the longest (last) q
//   tiles launched first.  S = Q K^T is an SS wgmma (N = 128 keys, 64 at
//   D > 128 to keep O, S and P in registers); the softcap, the mask and the
//   running max / sum stay in f32 registers, p = 2^(s * scale * log2 e - m)
//   (one FMA and one ex2 an element).  O += P V takes P from registers (an
//   S accumulator slice is already the A fragment, packed to bf16 in place)
//   and V as the MN-major B, N = 64 columns per wgmma.  P is split into
//   bf16 P_hi (truncated) + P_lo = bf16(P - P_hi), two products into the
//   same f32 O: one bf16 rounding of P leaves outputs near zero (a sum of
//   large terms cancelling) outside the bf16 tolerance, which the split
//   keeps.  The loop is software-pipelined (a GEMM phase issues PV of the
//   previous tile with S of this one; the softmax follows) and the two
//   consumers take GEMM phases in turn through two named barriers, so one's
//   softmax runs while the other's products hold the tensor cores.  O is
//   divided by the row sum, rounded once and stored through the q tile's
//   shared memory by TMA.
//   Backward, D <= 128 (a 64-key tile of dK and dV needs D f32 registers a
//   thread besides its S^T and dP^T; at D > 128 that passes the budget, so
//   those widths keep the f32-staged kernels above):
//   1. dQ: one CTA per (b, hq, 128-row q tile), longest first as the
//      forward.  delta = rowsum(dO * O) from the bf16 O, kept for launch 2;
//      then per 64-key tile S = Q K^T and dP = dO V^T (SS), P = exp(s -
//      lse), dS = P (dP - delta) (times 1 - tanh^2 under softcap), dQ += dS
//      K (dS bf16 from registers, K as the MN-major B).
//   2. dK/dV: one CTA per (b, kv head, 64-key tile), the first key tiles
//      (which the most q rows see) launched first; the items are (q head
//      of the group, 64-row q tile that sees the key tile), taken in turn by
//      the two consumers.  S^T = K Q^T and dP^T = V dO^T (SS), dV += P^T dO
//      and dK += dS^T Q (bf16 from registers, MN-major B).  The consumers'
//      partial dK / dV meet once in shared memory at the end.
// Both designs skip key tiles wholly above the diagonal or wholly before
// the window and mask the rest (the ragged tail of any S included; the
// Pallas kernel relied on block sizes that divide S).  When asked (a
// non-null pointer; null when serving) the forward writes each row's f32
// log-sum-exp [B, Hq, S] (natural log, of the scaled and capped scores) for
// the backward; a row with no valid key gives 0 and lse = +inf.  Each output
// element has one writer and a fixed summation order: no atomics, so every
// result is deterministic.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 64;       // q rows per block
constexpr int kBN = 64;       // keys per tile
constexpr int kLanes = 4;     // threads per q row
constexpr int kThreads = kBM * kLanes;
constexpr int kSStride = kBN + 1;  // padded score row (no bank conflicts)

template <int D>
constexpr size_t smem_bytes() {
  return (2 * kBN * D + kBM * kSStride) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int S,
                     float scale, int causal, int window, float softcap) {
  constexpr int DPL = D / kLanes;
  extern __shared__ float sm[];
  float* Ks = sm;              // [kBN][D]
  float* Vs = Ks + kBN * D;    // [kBN][D]
  float* Ss = Vs + kBN * D;    // [kBM][kSStride]

  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int part = tid % kLanes;
  const int bh = blockIdx.y;  // b * Hq + hq
  const int b = bh / Hq;
  const int hq = bh % Hq;
  const int kvh = hq / (Hq / Hkv);
  const int q0 = blockIdx.x * kBM;
  const int qi = q0 + r;
  const bool row_ok = qi < S;

  const T* qrow = q + (static_cast<size_t>(bh) * S + (row_ok ? qi : 0)) * D;
  const size_t kv_off = static_cast<size_t>(b * Hkv + kvh) * S * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  float qr[DPL];
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qr[i] = row_ok ? repro::to_f32(qrow[part + kLanes * i]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = repro::kNegBig;
  float l = 0.f;

  const int kv_end = causal ? min(S, q0 + kBM) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (kv_begin / kBN) * kBN; k0 < kv_end; k0 += kBN) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int kj = k0 + idx / D;
      const size_t g = static_cast<size_t>(kj) * D + idx % D;
      Ks[idx] = kj < S ? repro::to_f32(kb[g]) : 0.f;
      Vs[idx] = kj < S ? repro::to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float mt = repro::kNegBig;
    for (int j = 0; j < kBN; ++j) {
      const float* kr = Ks + j * D + part;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s = fmaf(qr[i], kr[kLanes * i], s);
      s += __shfl_xor_sync(repro::kFullMask, s, 1);
      s += __shfl_xor_sync(repro::kFullMask, s, 2);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int kj = k0 + j;
      const bool valid = row_ok && kj < S && (!causal || kj <= qi) &&
                         (window <= 0 || qi - kj < window);
      if ((j & (kLanes - 1)) == part) Ss[r * kSStride + j] = valid ? s : -INFINITY;
      if (valid) mt = fmaxf(mt, s);
    }
    __syncwarp();

    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    float ps = 0.f;
    for (int j = 0; j < kBN; ++j) {
      const float s = Ss[r * kSStride + j];
      const float p = s == -INFINITY ? 0.f : expf(s - m_new);
      ps += p;
      const float* vr = Vs + j * D + part;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(p, vr[kLanes * i], acc[i]);
    }
    l = l * alpha + ps;
    m = m_new;
  }

  if (row_ok) {
    T* orow = o + (static_cast<size_t>(bh) * S + qi) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      orow[part + kLanes * i] = repro::from_f32<T>(l > 0.f ? acc[i] / l : 0.f);
    if (lse != nullptr && part == 0)
      lse[static_cast<size_t>(bh) * S + qi] = l > 0.f ? m + logf(l) : INFINITY;
  }
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  return (2 * kBM * D + 2 * kBM) * sizeof(float);
}

__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(repro::kFullMask, s, 1);
  s += __shfl_xor_sync(repro::kFullMask, s, 2);
  return s;
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal, int window) {
  return qi < S && kj < S && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// Launch 1: delta and dQ.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv, int S,
                        float scale, int causal, int window, float softcap) {
  constexpr int DPL = D / kLanes;
  extern __shared__ float sm[];
  float* Ks = sm;            // [kBN][D]
  float* Vs = Ks + kBN * D;  // [kBN][D]

  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int part = tid % kLanes;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int hq = bh % Hq;
  const int kvh = hq / (Hq / Hkv);
  const int q0 = blockIdx.x * kBM;
  const int qi = q0 + r;
  const bool row_ok = qi < S;
  const size_t roff = (static_cast<size_t>(bh) * S + (row_ok ? qi : 0)) * D;
  const size_t kv_off = static_cast<size_t>(b * Hkv + kvh) * S * D;

  float qr[DPL], dor[DPL], acc[DPL];
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int c = part + kLanes * i;
    qr[i] = row_ok ? repro::to_f32(q[roff + c]) * scale : 0.f;
    dor[i] = row_ok ? repro::to_f32(dout[roff + c]) : 0.f;
    dl = fmaf(dor[i], row_ok ? repro::to_f32(o[roff + c]) : 0.f, dl);
    acc[i] = 0.f;
  }
  dl = quad_sum(dl);
  if (row_ok && part == 0) delta[static_cast<size_t>(bh) * S + qi] = dl;
  const float l_i = row_ok ? lse[static_cast<size_t>(bh) * S + qi] : 0.f;

  const int kv_end = causal ? min(S, q0 + kBM) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (kv_begin / kBN) * kBN; k0 < kv_end; k0 += kBN) {
    __syncthreads();
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int kj = k0 + idx / D;
      const size_t g = kv_off + static_cast<size_t>(kj) * D + idx % D;
      Ks[idx] = kj < S ? repro::to_f32(k[g]) : 0.f;
      Vs[idx] = kj < S ? repro::to_f32(v[g]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kBN; ++j) {
      const float* kr = Ks + j * D + part;
      const float* vr = Vs + j * D + part;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        s = fmaf(qr[i], kr[kLanes * i], s);
        dp = fmaf(dor[i], vr[kLanes * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      float th = 0.f;
      if (softcap > 0.f) {
        th = tanhf(s / softcap);
        s = softcap * th;
      }
      const bool valid = row_ok && visible(qi, k0 + j, S, causal, window);
      const float p = valid ? expf(s - l_i) : 0.f;
      float ds = p * (dp - dl);
      if (softcap > 0.f) ds *= 1.f - th * th;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(ds, kr[kLanes * i], acc[i]);
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) dq[roff + part + kLanes * i] = repro::from_f32<T>(acc[i] * scale);
  }
}

// Launch 2: dK and dV, summed over every q head of the kv head's group.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int S,
                          float scale, int causal, int window, float softcap) {
  constexpr int DPL = D / kLanes;
  extern __shared__ float sm[];
  float* Qs = sm;              // [kBM][D], scaled
  float* Ds = Qs + kBM * D;    // [kBM][D], dO
  float* Ls = Ds + kBM * D;    // [kBM] lse
  float* Es = Ls + kBM;        // [kBM] delta

  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int part = tid % kLanes;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * kBN;
  const int kj = k0 + r;
  const bool key_ok = kj < S;
  const size_t koff = (static_cast<size_t>(bkv) * S + (key_ok ? kj : 0)) * D;

  float kr[DPL], vr[DPL], dka[DPL], dva[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int c = part + kLanes * i;
    kr[i] = key_ok ? repro::to_f32(k[koff + c]) : 0.f;
    vr[i] = key_ok ? repro::to_f32(v[koff + c]) : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + kBN - 1 + window) : S;
  for (int g = 0; g < group; ++g) {
    const int bh = b * Hq + kvh * group + g;
    const size_t hoff = static_cast<size_t>(bh) * S;
    for (int q0 = (q_begin / kBM) * kBM; q0 < q_end; q0 += kBM) {
      __syncthreads();
      for (int idx = tid; idx < kBM * D; idx += kThreads) {
        const int qi = q0 + idx / D;
        const size_t gi = (hoff + qi) * D + idx % D;
        Qs[idx] = qi < S ? repro::to_f32(q[gi]) * scale : 0.f;
        Ds[idx] = qi < S ? repro::to_f32(dout[gi]) : 0.f;
      }
      for (int idx = tid; idx < kBM; idx += kThreads) {
        const int qi = q0 + idx;
        Ls[idx] = qi < S ? lse[hoff + qi] : 0.f;
        Es[idx] = qi < S ? delta[hoff + qi] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < kBM; ++i) {
        const float* qrow = Qs + i * D + part;
        const float* drow = Ds + i * D + part;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          s = fmaf(qrow[kLanes * c], kr[c], s);
          dp = fmaf(drow[kLanes * c], vr[c], dp);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        float th = 0.f;
        if (softcap > 0.f) {
          th = tanhf(s / softcap);
          s = softcap * th;
        }
        const bool valid = key_ok && visible(q0 + i, kj, S, causal, window);
        const float p = valid ? expf(s - Ls[i]) : 0.f;
        float ds = p * (dp - Es[i]);
        if (softcap > 0.f) ds *= 1.f - th * th;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          dva[c] = fmaf(p, drow[kLanes * c], dva[c]);
          dka[c] = fmaf(ds, qrow[kLanes * c], dka[c]);
        }
      }
    }
  }
  if (key_ok) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      dk[koff + part + kLanes * i] = repro::from_f32<T>(dka[i]);
      dv[koff + part + kLanes * i] = repro::from_f32<T>(dva[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *out, *lse, *delta, *dq, *dk, *dv;
  int B, Hq, Hkv, S;
  float scale;
  int causal, window;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_fwd(const Args& a) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBM - 1) / kBM, a.B * a.Hq);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.Hq, a.Hkv, a.S, a.scale, a.causal,
      a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const Args& a) {
  auto dq_kernel = flash_bwd_dq_kernel<T, D>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, D>;
  const size_t dq_smem = smem_bytes<D>();
  const size_t kv_smem = bwd_smem_bytes<D>();
  cudaError_t err = repro::allow_smem(dq_kernel, dq_smem);
  if (err == cudaSuccess) err = repro::allow_smem(dkdv_kernel, kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dq_grid((a.S + kBM - 1) / kBM, a.B * a.Hq);
  dq_kernel<<<dq_grid, kThreads, dq_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta), static_cast<T*>(a.dq),
      a.Hq, a.Hkv, a.S, a.scale, a.causal, a.window, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((a.S + kBN - 1) / kBN, a.B * a.Hkv);
  dkdv_kernel<<<kv_grid, kThreads, kv_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Hq,
      a.Hkv, a.S, a.scale, a.causal, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, warp-specialised wgmma (sm_90a)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kSmemMax = 232448;  // bytes of shared memory one block may use
constexpr int kThreads90 = 384;   // warpgroup 0 produces, 1 and 2 consume
constexpr int kBox = 64;          // columns of one 128-byte swizzled box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x in one MUFU op (relative error ~2^-22; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(repro::kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(repro::kFullMask, x, 2));
}

// Generic pointer to the shared-memory address `addr` of the block whose
// dynamic shared memory starts at `raw`.
__device__ __forceinline__ float* smem_f32(unsigned char* raw, uint32_t addr) {
  return reinterpret_cast<float*>(raw + (addr - repro::hopper::smem_u32(raw)));
}

// One warpgroup's m64n64 f32 accumulator, row h of each thread's pair times
// mul[h], -> bf16 in the 128-byte-swizzled [64 rows][64 columns] box at smem
// `box` (the layout TMA reads back).
__device__ __forceinline__ void stage_box(const float (&acc)[32], uint32_t box, float mul0,
                                          float mul1) {
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (t >> 5) * 16 + (lane >> 2) + 8 * h;
      const float mul = h ? mul1 : mul0;
      const uint32_t addr = box + row * 128 + ((j ^ (row & 7)) << 4) + (lane & 3) * 4;
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                   "r"(pack_bf16(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul))
                   : "memory");
    }
  }
}

// Shared memory of the forward for head width DP (D padded to 64): the
// q tile (later the o tile), then the K/V ring, then the barriers.
template <int DP>
struct Fwd90 {
  static constexpr int BM = 128;                   // q rows: 2 consumers x m64
  static constexpr int BN = DP <= 128 ? 128 : 64;  // keys per stage
  static constexpr int NB = DP / kBox;             // 64-column boxes along D
  static constexpr int QBOX = BM * 128;            // one [128 rows][64] box
  static constexpr int KBOX = BN * 128;
  static constexpr int Q_BYTES = NB * QBOX;
  static constexpr int KV_BYTES = NB * KBOX;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int kStages = cmin(3, (kSmemMax - 1024 - 256 - Q_BYTES) / STAGE_BYTES);
  static constexpr int SMEM = 1024 + Q_BYTES + kStages * STAGE_BYTES + 256;
  static_assert(kStages >= 2, "the ring needs two stages");
};

// The forward consumer's three steps, each on one warpgroup's registers.
// S = Q K^T into sc (K-major A and B; the first k16 step overwrites sc).
template <int DP>
__device__ __forceinline__ void fwd_issue_s(float (&sc)[Fwd90<DP>::BN / 2], uint32_t qa,
                                            uint32_t kb) {
  using namespace repro::hopper;
  using L = Fwd90<DP>;
#pragma unroll
  for (int j = 0; j < L::NB; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_sw128(qa + j * L::QBOX + kk * 32, 16, 1024);
      const uint64_t db = desc_sw128(kb + j * L::KBOX + kk * 32, 16, 1024);
      if constexpr (L::BN == 128)
        wgmma_m64n128k16_bf16<0, 0>(sc, da, db, j + kk > 0);
      else
        wgmma_m64n64k16_bf16<0, 0>(sc, da, db, j + kk > 0);
    }
  }
}

// O += P_hi V + P_lo V (V: the MN-major B, 64 columns of D a wgmma).
template <int DP>
__device__ __forceinline__ void fwd_issue_pv(float (&o)[Fwd90<DP>::NB][32],
                                             const uint32_t (&ph)[Fwd90<DP>::BN / 16][4],
                                             const uint32_t (&pl)[Fwd90<DP>::BN / 16][4],
                                             uint32_t vb) {
  using namespace repro::hopper;
  using L = Fwd90<DP>;
#pragma unroll
  for (int kk = 0; kk < L::BN / 16; ++kk) {
#pragma unroll
    for (int jb = 0; jb < L::NB; ++jb) {
      const uint64_t db = desc_sw128(vb + jb * L::KBOX + kk * 2048, L::KBOX, 1024);
      wgmma_m64n64k16_rs_bf16<1>(o[jb], ph[kk], db);
      wgmma_m64n64k16_rs_bf16<1>(o[jb], pl[kk], db);
    }
  }
}

// The registers a GEMM phase reads or writes, fenced against reordering
// around the asynchronous wgmma.
template <int DP>
__device__ __forceinline__ void fwd_fence(float (&sc)[Fwd90<DP>::BN / 2],
                                          float (&o)[Fwd90<DP>::NB][32],
                                          uint32_t (&ph)[Fwd90<DP>::BN / 16][4],
                                          uint32_t (&pl)[Fwd90<DP>::BN / 16][4]) {
  using namespace repro::hopper;
  fence_operands(sc);
#pragma unroll
  for (int jb = 0; jb < Fwd90<DP>::NB; ++jb) fence_operands(o[jb]);
#pragma unroll
  for (int kk = 0; kk < Fwd90<DP>::BN / 16; ++kk) {
    fence_operands(ph[kk]);
    fence_operands(pl[kk]);
  }
}

// Mask S (key cb + 8 j + e is column 8 j + e of this thread; row h takes
// keys lo[h] .. hi[h]), cap it (kCap: sc becomes the capped score in log2
// units; else the scale, log2 e folded in, is applied inside the exponent's
// FMA), update the running max m and this thread's part of the row sums
// lsum, rescale O to the new max, and leave P = 2^(s - m) split as bf16 A
// fragments P_hi + P_lo: P_hi is P truncated to bf16 (one byte permute a
// pair), P_lo = bf16(P - P_hi) (slice kk of S is already the fragment's
// layout).  Every tile is masked: a second, unmasked copy of this code for
// the tiles that every row sees whole measured slower.
template <int DP, bool kCap>
__device__ __forceinline__ void fwd_softmax(float (&sc)[Fwd90<DP>::BN / 2],
                                            float (&o)[Fwd90<DP>::NB][32],
                                            uint32_t (&ph)[Fwd90<DP>::BN / 16][4],
                                            uint32_t (&pl)[Fwd90<DP>::BN / 16][4], float (&m)[2],
                                            float (&lsum)[2], const int (&hi)[2],
                                            const int (&lo)[2], int cb, float scale2,
                                            float cap_in, float cap_out) {
  using L = Fwd90<DP>;
  const float mul = kCap ? 1.f : scale2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int hi_off = hi[h] - cb;
    const int lo_off = lo[h] - cb;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < L::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int off = 8 * j + e;
        if constexpr (kCap) sc[i] = cap_out * tanhf(sc[i] * cap_in);
        sc[i] = (off <= hi_off && off >= lo_off) ? sc[i] : -INFINITY;
        mx = fmaxf(mx, sc[i]);
      }
    }
    const float m_new = fmaxf(m[h], quad_max(mx) * mul);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = ex2(m[h] - m_use);
    m[h] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < L::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        sc[i] = ex2(fmaf(sc[i], mul, -m_use));
        rs += sc[i];
      }
    }
    lsum[h] = lsum[h] * alpha + rs;
#pragma unroll
    for (int jb = 0; jb < L::NB; ++jb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[jb][4 * j + 2 * h] *= alpha;
        o[jb][4 * j + 2 * h + 1] *= alpha;
      }
  }
#pragma unroll
  for (int kk = 0; kk < L::BN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = sc[8 * kk + 2 * r];
      const float b = sc[8 * kk + 2 * r + 1];
      const uint32_t ab = __float_as_uint(a), bb = __float_as_uint(b);
      ph[kk][r] = __byte_perm(ab, bb, 0x7632);
      pl[kk][r] = pack_bf16(a - __uint_as_float(ab & 0xffff0000u),
                            b - __uint_as_float(bb & 0xffff0000u));
    }
  }
}

// q [B, Hq, S, D] -> o; maps {D, S, B * H}: q boxes {64, 128}, k / v
// {64, BN}, o {64, 64}.  blockIdx = (b * Hq + hq, q tile counted from the
// last): under a causal mask the longest CTAs start first.
template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads90, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_o, float* __restrict__ lse,
                           int Hq, int Hkv, int S, float scale, int causal, int window,
                           float softcap) {
  using namespace repro::hopper;
  using L = Fwd90<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ring = base + L::Q_BYTES;
  const uint32_t bars = ring + L::kStages * L::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::kStages + s); };
  const uint32_t qbar = bars + 16u * L::kStages;

  const int bh = blockIdx.x;
  const int bkv = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BM;
  const int kv_end = causal ? min(S, q0 + L::BM) : S;
  const int kt0 = (window > 0 ? max(0, q0 - window + 1) : 0) / L::BN * L::BN;
  const int n_tiles = (kv_end - kt0 + L::BN - 1) / L::BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // the consumers' warps
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // Producer: one thread loads the q tile once, then keeps kStages K/V
    // tiles in flight.
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qbar, L::Q_BYTES);
      for (int j = 0; j < L::NB; ++j) tma_load_3d(qs + j * L::QBOX, &map_q, qbar, j * kBox, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % L::kStages;
        mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::STAGE_BYTES);
        const int k0 = kt0 + it * L::BN;
        const uint32_t kb = ring + s * L::STAGE_BYTES;
        for (int j = 0; j < L::NB; ++j) {
          tma_load_3d(kb + j * L::KBOX, &map_k, full(s), j * kBox, k0, bkv);
          tma_load_3d(kb + L::KV_BYTES + j * L::KBOX, &map_v, full(s), j * kBox, k0, bkv);
        }
      }
    }
  } else {
    // Consumer c: q rows [q0 + 64 c, q0 + 64 c + 64); this thread's rows
    // r0 and r0 + 8, each with its own valid keys lo[h] <= key <= hi[h].
    reg_alloc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = q0 + 64 * c + 16 * (t >> 5) + (lane >> 2);
    const float scale2 = scale * kLog2e;
    const float cap_in = kCap ? scale / softcap : 0.f;
    const float cap_out = softcap * kLog2e;
    int hi[2], lo[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      hi[h] = causal ? min(r, S - 1) : S - 1;
      lo[h] = window > 0 ? r - window + 1 : 0;
    }
    float o[L::NB][32];
    float sc[L::BN / 2];
#pragma unroll
    for (int j = 0; j < L::NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < L::BN / 2; ++i) sc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float lsum[2] = {0.f, 0.f};  // this thread's part of the row sums
    uint32_t ph[L::BN / 16][4], pl[L::BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < L::BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) ph[kk][r] = pl[kk][r] = 0u;
    const uint32_t qa = qs + 64 * c * 128;  // this consumer's rows of each q box
    auto kstage = [&](int it) { return ring + (it % L::kStages) * L::STAGE_BYTES; };

    // Software-pipelined: each GEMM phase issues PV of the previous tile
    // with S of this one, then the softmax of this tile runs.  The two
    // consumers take GEMM phases in turn (named barriers 4 and 5: consumer
    // c waits on 4 + c, the other arrives on it once its phase is issued),
    // so one's softmax overlaps the other's products on the tensor cores.
    // Consumer 1 opens consumer 0's first turn and skips its own last
    // arrival, so every arrival is waited for.
    named_bar_arrive_if(4, 256, c == 1);
    mbar_wait(qbar, 0);
    mbar_wait(full(0), 0);
    named_bar_sync(4 + c, 256);
    fwd_fence<DP>(sc, o, ph, pl);
    wgmma_fence();
    fwd_issue_s<DP>(sc, qa, kstage(0));
    wgmma_commit();
    named_bar_arrive_if(5 - c, 256, true);
    fwd_fence<DP>(sc, o, ph, pl);
    wgmma_wait<0>();
    fwd_fence<DP>(sc, o, ph, pl);
    fwd_softmax<DP, kCap>(sc, o, ph, pl, m, lsum, hi, lo, kt0 + 2 * (lane & 3), scale2, cap_in,
                          cap_out);
    for (int it = 1; it < n_tiles; ++it) {
      mbar_wait(full(it % L::kStages), (it / L::kStages) & 1);
      named_bar_sync(4 + c, 256);
      fwd_fence<DP>(sc, o, ph, pl);
      wgmma_fence();
      fwd_issue_s<DP>(sc, qa, kstage(it));
      fwd_issue_pv<DP>(o, ph, pl, kstage(it - 1) + L::KV_BYTES);
      wgmma_commit();
      named_bar_arrive_if(5 - c, 256, true);
      fwd_fence<DP>(sc, o, ph, pl);
      wgmma_wait<0>();
      fwd_fence<DP>(sc, o, ph, pl);
      mbar_arrive_if(empty((it - 1) % L::kStages), lane == 0);  // tile it - 1 is read
      fwd_softmax<DP, kCap>(sc, o, ph, pl, m, lsum, hi, lo, kt0 + it * L::BN + 2 * (lane & 3),
                            scale2, cap_in, cap_out);
    }
    named_bar_sync(4 + c, 256);
    fwd_fence<DP>(sc, o, ph, pl);
    wgmma_fence();
    fwd_issue_pv<DP>(o, ph, pl, kstage(n_tiles - 1) + L::KV_BYTES);
    wgmma_commit();
    named_bar_arrive_if(5 - c, 256, c == 0);
    fwd_fence<DP>(sc, o, ph, pl);
    wgmma_wait<0>();
    fwd_fence<DP>(sc, o, ph, pl);
    mbar_arrive_if(empty((n_tiles - 1) % L::kStages), lane == 0);

    // Epilogue: O / l, rounded once, staged in this consumer's own q rows
    // (no other warpgroup reads them) and stored by TMA (rows past S and
    // columns past D clipped).
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l_row = quad_sum(lsum[h]);
      inv[h] = l_row > 0.f ? 1.f / l_row : 0.f;
      const int r = r0 + 8 * h;
      if (lse != nullptr && (lane & 3) == 0 && r < S)
        lse[static_cast<size_t>(bh) * S + r] = l_row > 0.f ? (m[h] + log2f(l_row)) * kLn2
                                                           : INFINITY;
    }
#pragma unroll
    for (int jb = 0; jb < L::NB; ++jb) stage_box(o[jb], qa + jb * L::QBOX, inv[0], inv[1]);
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (t == 0) {
      for (int jb = 0; jb < L::NB; ++jb)
        tma_store_3d(&map_o, qa + jb * L::QBOX, jb * kBox, q0 + 64 * c, bh);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// Backward, launch 1: shared memory for head width DP <= 128: the q and dO
// tiles (later the dq tile), the K/V ring, barriers and the rows' delta.
template <int DP>
struct Dq90 {
  static constexpr int BM = 128;  // q rows: 2 consumers x m64
  static constexpr int BN = 64;   // keys per stage
  static constexpr int NB = DP / kBox;
  static constexpr int QBOX = BM * 128;
  static constexpr int KBOX = BN * 128;
  static constexpr int Q_BYTES = NB * QBOX;  // q, and again dO
  static constexpr int KV_BYTES = NB * KBOX;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int kStages = cmin(4, (kSmemMax - 2048 - 2 * Q_BYTES) / STAGE_BYTES);
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + kStages * STAGE_BYTES + 1024;
};

// dq and delta = rowsum(dO * O); maps {D, S, B * H}: q / dO boxes {64,
// 128}, k / v {64, 64}, dq {64, 64}.  blockIdx = (b * Hq + hq, q tile
// counted from the last), as the forward.
template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads90, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_do,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_dq,
                              const bf16* __restrict__ o, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, float* __restrict__ delta, int Hq,
                              int Hkv, int S, int D, float scale, int causal, int window,
                              float softcap) {
  using namespace repro::hopper;
  using L = Dq90<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t dos = base + L::Q_BYTES;
  const uint32_t ring = base + 2 * L::Q_BYTES;
  const uint32_t bars = ring + L::kStages * L::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::kStages + s); };
  const uint32_t qbar = bars + 16u * L::kStages;
  float* dsm = smem_f32(smem_raw, bars + 256);  // delta of the tile's 128 rows

  const int bh = blockIdx.x;
  const int bkv = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BM;
  const int kv_end = causal ? min(S, q0 + L::BM) : S;
  const int kt0 = (window > 0 ? max(0, q0 - window + 1) : 0) / L::BN * L::BN;
  const int n_tiles = (kv_end - kt0 + L::BN - 1) / L::BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qbar, 2 * L::Q_BYTES);
      for (int j = 0; j < L::NB; ++j) {
        tma_load_3d(qs + j * L::QBOX, &map_q, qbar, j * kBox, q0, bh);
        tma_load_3d(dos + j * L::QBOX, &map_do, qbar, j * kBox, q0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % L::kStages;
        mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::STAGE_BYTES);
        const int k0 = kt0 + it * L::BN;
        const uint32_t kb = ring + s * L::STAGE_BYTES;
        for (int j = 0; j < L::NB; ++j) {
          tma_load_3d(kb + j * L::KBOX, &map_k, full(s), j * kBox, k0, bkv);
          tma_load_3d(kb + L::KV_BYTES + j * L::KBOX, &map_v, full(s), j * kBox, k0, bkv);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    {
      // delta for this consumer's 64 rows, two threads a row, from the
      // bf16 O and dO in global memory (16-byte loads).
      const int rr = t >> 1;
      const int row = q0 + 64 * c + rr;
      float d = 0.f;
      if (row < S) {
        const size_t off = (static_cast<size_t>(bh) * S + row) * D + (t & 1) * (D / 2);
        const uint4* po = reinterpret_cast<const uint4*>(o + off);
        const uint4* pd = reinterpret_cast<const uint4*>(dout + off);
        for (int i = 0; i < D / 16; ++i) {
          const uint4 a = po[i], b = pd[i];
          const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[u]));
            const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[u]));
            d = fmaf(fa.x, fb.x, d);
            d = fmaf(fa.y, fb.y, d);
          }
        }
      }
      d += __shfl_xor_sync(repro::kFullMask, d, 1);
      if ((t & 1) == 0) {
        dsm[64 * c + rr] = d;
        if (row < S) delta[static_cast<size_t>(bh) * S + row] = d;
      }
      named_bar_sync(1 + c, 128);
    }
    const int r0 = q0 + 64 * c + 16 * (t >> 5) + (lane >> 2);
    const float scale2 = scale * kLog2e;
    const float cap_in = kCap ? scale / softcap : 0.f;
    const float cap_out = softcap * kLog2e;
    int hi[2], lo[2];
    float dl[2], l2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      hi[h] = r < S ? (causal ? r : S - 1) : -1;
      lo[h] = window > 0 ? r - window + 1 : 0;
      dl[h] = dsm[r - q0];
      l2[h] = lse[static_cast<size_t>(bh) * S + min(r, S - 1)] * kLog2e;
    }
    float dq[L::NB][32];
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < L::NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    const uint32_t qa = qs + 64 * c * 128;
    const uint32_t da = dos + 64 * c * 128;

    mbar_wait(qbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % L::kStages;
      const uint32_t kb = ring + s * L::STAGE_BYTES;
      const uint32_t vb = kb + L::KV_BYTES;
      mbar_wait(full(s), (it / L::kStages) & 1);

      // S = Q K^T and dP = dO V^T.
      fence_operands(sc);
      fence_operands(dp);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < L::NB; ++j) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_bf16<0, 0>(sc, desc_sw128(qa + j * L::QBOX + kk * 32, 16, 1024),
                                     desc_sw128(kb + j * L::KBOX + kk * 32, 16, 1024), j + kk > 0);
          wgmma_m64n64k16_bf16<0, 0>(dp, desc_sw128(da + j * L::QBOX + kk * 32, 16, 1024),
                                     desc_sw128(vb + j * L::KBOX + kk * 32, 16, 1024), j + kk > 0);
        }
      }
      wgmma_commit();
      fence_operands(sc);
      fence_operands(dp);
      wgmma_wait<0>();
      fence_operands(sc);
      fence_operands(dp);

      // dS = P (dP - delta) (times 1 - tanh^2), 0 where masked.
      const int cb = kt0 + it * L::BN + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hi_off = hi[h] - cb;
        const int lo_off = lo[h] - cb;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const int off = 8 * j + e;
            float ds;
            if constexpr (kCap) {
              const float th = tanhf(sc[i] * cap_in);
              ds = ex2(cap_out * th - l2[h]) * (dp[i] - dl[h]) * (1.f - th * th);
            } else {
              ds = ex2(fmaf(sc[i], scale2, -l2[h])) * (dp[i] - dl[h]);
            }
            sc[i] = (off <= hi_off && off >= lo_off) ? ds : 0.f;
          }
        }
      }
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // dQ += dS K (K: the MN-major B).
#pragma unroll
      for (int jb = 0; jb < L::NB; ++jb) fence_operands(dq[jb]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_operands(dsa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jb = 0; jb < L::NB; ++jb)
          wgmma_m64n64k16_rs_bf16<1>(dq[jb], dsa[kk],
                                     desc_sw128(kb + jb * L::KBOX + kk * 2048, L::KBOX, 1024));
      wgmma_commit();
#pragma unroll
      for (int jb = 0; jb < L::NB; ++jb) fence_operands(dq[jb]);
      wgmma_wait<0>();
#pragma unroll
      for (int jb = 0; jb < L::NB; ++jb) fence_operands(dq[jb]);
      mbar_arrive_if(empty(s), lane == 0);
    }

    // dq * scale, staged in this consumer's own q rows, stored by TMA.
#pragma unroll
    for (int jb = 0; jb < L::NB; ++jb) stage_box(dq[jb], qa + jb * L::QBOX, scale, scale);
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (t == 0) {
      for (int jb = 0; jb < L::NB; ++jb)
        tma_store_3d(&map_dq, qa + jb * L::QBOX, jb * kBox, q0 + 64 * c, bh);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// Backward, launch 2: shared memory for head width DP <= 128: the key
// tile's K and V (later dK and dV), the Q/dO ring (later the consumers'
// exchange of partial sums), barriers and each consumer's lse / delta.
template <int DP>
struct Dkv90 {
  static constexpr int BK = 64;  // keys per CTA
  static constexpr int BQ = 64;  // q rows per item
  static constexpr int NB = DP / kBox;
  static constexpr int BOX = 64 * 128;
  static constexpr int KV_BYTES = NB * BOX;    // K, and again V
  static constexpr int STAGE_BYTES = 2 * NB * BOX;  // q and dO of one item
  static constexpr int kStages = cmin(4, (kSmemMax - 1024 - 4096 - 2 * KV_BYTES) / STAGE_BYTES);
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + kStages * STAGE_BYTES + 4096;
  static_assert(2 * 32 * NB * 128 * 4 <= kStages * STAGE_BYTES, "the exchange fits the ring");
};

// dk, dv summed over the kv head's group; maps {D, S, B * H}, boxes {64,
// 64}.  blockIdx = (b * Hkv + kv head, 64-key tile): under a causal mask
// the first key tiles see the most q rows and start first.
template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads90, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_do,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_dk,
                                const __grid_constant__ CUtensorMap map_dv,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                int Hq, int Hkv, int S, float scale, int causal, int window,
                                float softcap) {
  using namespace repro::hopper;
  using L = Dkv90<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = base;
  const uint32_t vs = base + L::KV_BYTES;
  const uint32_t ring = base + 2 * L::KV_BYTES;
  const uint32_t bars = ring + L::kStages * L::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::kStages + s); };
  const uint32_t kvbar = bars + 16u * L::kStages;

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int group = Hq / Hkv;
  const int hq0 = b * Hq + (bkv % Hkv) * group;  // b * Hq + the group's first q head
  const int k0 = blockIdx.y * L::BK;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + L::BK - 1 + window) : S;
  const int n_qt = (q_end - q_begin + L::BQ - 1) / L::BQ;
  const int n_items = group * n_qt;  // (q head, q tile), q tiles inner

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // the warps of the consumer that owns the item
    }
    mbar_init(kvbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * L::KV_BYTES);
      for (int j = 0; j < L::NB; ++j) {
        tma_load_3d(ks + j * L::BOX, &map_k, kvbar, j * kBox, k0, bkv);
        tma_load_3d(vs + j * L::BOX, &map_v, kvbar, j * kBox, k0, bkv);
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = it % L::kStages;
        mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::STAGE_BYTES);
        const int bh = hq0 + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * L::BQ;
        const uint32_t qb = ring + s * L::STAGE_BYTES;
        for (int j = 0; j < L::NB; ++j) {
          tma_load_3d(qb + j * L::BOX, &map_q, full(s), j * kBox, q0, bh);
          tma_load_3d(qb + L::NB * L::BOX + j * L::BOX, &map_do, full(s), j * kBox, q0, bh);
        }
      }
    }
  } else {
    // Consumer c takes items c, c + 2, ...; this thread's keys kr0 and
    // kr0 + 8, each seen by the q rows lo[h] <= q <= hi[h].
    reg_alloc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int kr0 = k0 + 16 * (t >> 5) + (lane >> 2);
    const float scale2 = scale * kLog2e;
    const float cap_in = kCap ? scale / softcap : 0.f;
    const float cap_out = softcap * kLog2e;
    int hi[2], lo[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = kr0 + 8 * h;
      lo[h] = causal ? kj : 0;
      hi[h] = kj < S ? (window > 0 ? min(S - 1, kj + window - 1) : S - 1) : -1;
    }
    float dk[L::NB][32], dv[L::NB][32];
    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < L::NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[j][i] = dv[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    // lse (log2 units) and delta of an item's 64 q rows, two buffers a
    // consumer, alternating by item.
    float* stats = smem_f32(smem_raw, bars + 256 + c * 1024);

    mbar_wait(kvbar, 0);
    for (int it = c, n = 0; it < n_items; it += 2, ++n) {
      const int s = it % L::kStages;
      const uint32_t qb = ring + s * L::STAGE_BYTES;
      const uint32_t db = qb + L::NB * L::BOX;
      const int bh = hq0 + it / n_qt;
      const int q0 = q_begin + (it % n_qt) * L::BQ;
      float* lb = stats + (n & 1) * 128;
      {
        const float* src = t < 64 ? lse : delta;
        const float x = src[static_cast<size_t>(bh) * S + min(q0 + (t & 63), S - 1)];
        lb[t] = t < 64 ? x * kLog2e : x;
      }
      named_bar_sync(1 + c, 128);
      mbar_wait(full(s), (it / L::kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T.
      fence_operands(st);
      fence_operands(dpt);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < L::NB; ++j) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_bf16<0, 0>(st, desc_sw128(ks + j * L::BOX + kk * 32, 16, 1024),
                                     desc_sw128(qb + j * L::BOX + kk * 32, 16, 1024), j + kk > 0);
          wgmma_m64n64k16_bf16<0, 0>(dpt, desc_sw128(vs + j * L::BOX + kk * 32, 16, 1024),
                                     desc_sw128(db + j * L::BOX + kk * 32, 16, 1024), j + kk > 0);
        }
      }
      wgmma_commit();
      fence_operands(st);
      fence_operands(dpt);
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);

      // P^T and dS^T, 0 where masked; column 8 j + e is q row cb + 8 j + e.
      const int cb = q0 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hi_off = hi[h] - cb;
        const int lo_off = lo[h] - cb;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const int off = 8 * j + e;
            const float l2 = lb[off + 2 * (lane & 3)];
            const float dl = lb[64 + off + 2 * (lane & 3)];
            float p, ds;
            if constexpr (kCap) {
              const float th = tanhf(st[i] * cap_in);
              p = ex2(cap_out * th - l2);
              ds = p * (dpt[i] - dl) * (1.f - th * th);
            } else {
              p = ex2(fmaf(st[i], scale2, -l2));
              ds = p * (dpt[i] - dl);
            }
            const bool ok = off <= hi_off && off >= lo_off;
            st[i] = ok ? p : 0.f;
            dpt[i] = ok ? ds : 0.f;
          }
        }
      }
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          dsa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q (dO and Q: MN-major B).
#pragma unroll
      for (int jb = 0; jb < L::NB; ++jb) {
        fence_operands(dk[jb]);
        fence_operands(dv[jb]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_operands(pa[kk]);
        fence_operands(dsa[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jb = 0; jb < L::NB; ++jb) {
          wgmma_m64n64k16_rs_bf16<1>(dv[jb], pa[kk],
                                     desc_sw128(db + jb * L::BOX + kk * 2048, L::BOX, 1024));
          wgmma_m64n64k16_rs_bf16<1>(dk[jb], dsa[kk],
                                     desc_sw128(qb + jb * L::BOX + kk * 2048, L::BOX, 1024));
        }
      }
      wgmma_commit();
#pragma unroll
      for (int jb = 0; jb < L::NB; ++jb) {
        fence_operands(dk[jb]);
        fence_operands(dv[jb]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int jb = 0; jb < L::NB; ++jb) {
        fence_operands(dk[jb]);
        fence_operands(dv[jb]);
      }
      mbar_arrive_if(empty(s), lane == 0);
    }

    // Both consumers are past the ring: consumer 0 hands its partial dV and
    // consumer 1 its partial dK over through the ring (thread t of one
    // warpgroup holds the same elements as thread t of the other), each adds
    // the other's, then stores its sum: consumer 0 dK, consumer 1 dV.
    named_bar_sync(3, 256);
    float* xk = smem_f32(smem_raw, ring);
    float* xv = xk + L::NB * 32 * 128;
#pragma unroll
    for (int jb = 0; jb < L::NB; ++jb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (c == 0) xv[(jb * 32 + i) * 128 + t] = dv[jb][i];
        else xk[(jb * 32 + i) * 128 + t] = dk[jb][i];
      }
    named_bar_sync(3, 256);
    const uint32_t out = c == 0 ? ks : vs;
#pragma unroll
    for (int jb = 0; jb < L::NB; ++jb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (c == 0) dk[jb][i] += xk[(jb * 32 + i) * 128 + t];
        else dv[jb][i] += xv[(jb * 32 + i) * 128 + t];
      }
      if (c == 0) stage_box(dk[jb], out + jb * L::BOX, scale, scale);
      else stage_box(dv[jb], out + jb * L::BOX, 1.f, 1.f);
    }
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (t == 0) {
      for (int jb = 0; jb < L::NB; ++jb)
        tma_store_3d(c == 0 ? &map_dk : &map_dv, out + jb * L::BOX, jb * kBox, k0, bkv);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// q / k / v / o [B, H, S, D] bf16 (D a multiple of 32, at most 256).
template <int DP, bool kCap>
int launch_fwd90(const Args& a, int D) {
  using namespace repro::hopper;
  using L = Fwd90<DP>;
  CUtensorMap mq, mk, mv, mo;
  int err = bf16_map_3d(&mq, a.q, D, a.S, a.B * a.Hq, kBox, L::BM);
  if (!err) err = bf16_map_3d(&mk, a.k, D, a.S, a.B * a.Hkv, kBox, L::BN);
  if (!err) err = bf16_map_3d(&mv, a.v, D, a.S, a.B * a.Hkv, kBox, L::BN);
  if (!err) err = bf16_map_3d(&mo, a.out, D, a.S, a.B * a.Hq, kBox, 64);
  if (err) return err;
  const auto kernel = &flash_fwd_wgmma_kernel<DP, kCap>;
  const cudaError_t ae = repro::allow_smem(kernel, L::SMEM);
  if (ae != cudaSuccess) return static_cast<int>(ae);
  const dim3 grid(a.B * a.Hq, (a.S + L::BM - 1) / L::BM);
  kernel<<<grid, kThreads90, L::SMEM, a.stream>>>(mq, mk, mv, mo, static_cast<float*>(a.lse),
                                                  a.Hq, a.Hkv, a.S, a.scale, a.causal, a.window,
                                                  a.softcap);
  return static_cast<int>(cudaGetLastError());
}

// The two backward launches, bf16, D a multiple of 32 up to DP <= 128.
template <int DP, bool kCap>
int launch_bwd90(const Args& a, int D) {
  using namespace repro::hopper;
  using Q = Dq90<DP>;
  using K = Dkv90<DP>;
  const int bhq = a.B * a.Hq, bhkv = a.B * a.Hkv;
  CUtensorMap mq128, mdo128, mk, mv, mdq, mq64, mdo64, mdk, mdv;
  int err = bf16_map_3d(&mq128, a.q, D, a.S, bhq, kBox, Q::BM);
  if (!err) err = bf16_map_3d(&mdo128, a.dout, D, a.S, bhq, kBox, Q::BM);
  if (!err) err = bf16_map_3d(&mk, a.k, D, a.S, bhkv, kBox, 64);
  if (!err) err = bf16_map_3d(&mv, a.v, D, a.S, bhkv, kBox, 64);
  if (!err) err = bf16_map_3d(&mdq, a.dq, D, a.S, bhq, kBox, 64);
  if (!err) err = bf16_map_3d(&mq64, a.q, D, a.S, bhq, kBox, K::BQ);
  if (!err) err = bf16_map_3d(&mdo64, a.dout, D, a.S, bhq, kBox, K::BQ);
  if (!err) err = bf16_map_3d(&mdk, a.dk, D, a.S, bhkv, kBox, K::BK);
  if (!err) err = bf16_map_3d(&mdv, a.dv, D, a.S, bhkv, kBox, K::BK);
  if (err) return err;
  const auto dq_kernel = &flash_bwd_dq_wgmma_kernel<DP, kCap>;
  const auto kv_kernel = &flash_bwd_dkdv_wgmma_kernel<DP, kCap>;
  cudaError_t ae = repro::allow_smem(dq_kernel, Q::SMEM);
  if (ae == cudaSuccess) ae = repro::allow_smem(kv_kernel, K::SMEM);
  if (ae != cudaSuccess) return static_cast<int>(ae);
  dq_kernel<<<dim3(bhq, (a.S + Q::BM - 1) / Q::BM), kThreads90, Q::SMEM, a.stream>>>(
      mq128, mdo128, mk, mv, mdq, static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta), a.Hq, a.Hkv, a.S, D,
      a.scale, a.causal, a.window, a.softcap);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return static_cast<int>(le);
  kv_kernel<<<dim3(bhkv, (a.S + K::BK - 1) / K::BK), kThreads90, K::SMEM, a.stream>>>(
      mq64, mdo64, mk, mv, mdk, mdv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.Hq, a.Hkv, a.S, a.scale, a.causal, a.window,
      a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCap>
int fwd90(int D, const Args& a) {
  if (D <= 64) return launch_fwd90<64, kCap>(a, D);
  if (D <= 128) return launch_fwd90<128, kCap>(a, D);
  if (D <= 192) return launch_fwd90<192, kCap>(a, D);
  return launch_fwd90<256, kCap>(a, D);
}

template <bool kCap>
int bwd90(int D, const Args& a) {
  if (D <= 64) return launch_bwd90<64, kCap>(a, D);
  return launch_bwd90<128, kCap>(a, D);
}

// The f32-staged kernels are built at every multiple of 32 up to 256 (the
// wrapper zero-pads any other multiple of 8 to the next one); the largest,
// D = 256, takes 144 KB of shared memory in the forward.
template <typename T, bool kBwd, int D = 32>
int dispatch_d(int d, const Args& a) {
  if (d == D) return kBwd ? launch_bwd<T, D>(a) : launch_fwd<T, D>(a);
  if constexpr (D < 256) return dispatch_d<T, kBwd, D + 32>(d, a);
  return -1;
}

// bf16 takes the wgmma kernels (the backward up to D = 128, a static rule on
// D alone), f32 the f32-staged ones.
template <bool kBwd>
int dispatch(int dtype, int D, const Args& a) {
  if (dtype == repro::kBF16) {
    if (D <= 0 || D % 32 || D > 256) return -1;
    if (!kBwd) return a.softcap > 0.f ? fwd90<true>(D, a) : fwd90<false>(D, a);
    if (D <= 128) return a.softcap > 0.f ? bwd90<true>(D, a) : bwd90<false>(D, a);
    return dispatch_d<__nv_bfloat16, true, 160>(D, a);
  }
  if (dtype == repro::kF32) return dispatch_d<float, kBwd>(D, a);
  return -2;
}

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap; lse null: not written.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int dtype, int B, int Hq, int Hkv, int S, int D,
                                   float scale, int causal, int window, float softcap,
                                   void* stream) {
  if (B <= 0 || S <= 0) return 0;
  Args a{q, k, v, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr, nullptr,
         B, Hq, Hkv, S, scale, causal, window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, D, a);
}

// o, lse: the forward's output and log-sum-exp; delta: f32 [B, Hq, S]
// scratch; dq [B, Hq, S, D], dk/dv [B, Hkv, S, D] in the inputs' dtype.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Hq, int Hkv, int S,
                                   int D, float scale, int causal, int window, float softcap,
                                   void* stream) {
  if (B <= 0 || S <= 0) return 0;
  Args a{q, k, v, o, dout, nullptr, const_cast<void*>(lse), delta, dq, dk, dv,
         B, Hq, Hkv, S, scale, causal, window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, D, a);
}
