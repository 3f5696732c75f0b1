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
// Design (right and simple first): one 256-thread block per (b, hq,
// 64-row q tile).  Four threads share a q row, each holding D/4 of its
// dims (interleaved, so the four read neighbouring shared-memory words)
// plus a D/4 f32 accumulator in registers.  64-row K/V tiles are staged in
// shared memory as f32; the K/V head is hq // group, so K/V are never
// repeated.  Per tile: scores by a 4-lane shuffle reduction, the tile's
// row max, p = expf(s - m_new) (IEEE, no fast math), and the running-max /
// running-sum rescale of the accumulator.  Causal tiles above the diagonal
// and tiles wholly before the window are skipped; window, softcap and the
// ragged tail of any S are masked in the kernel (the Pallas kernel relied
// on block sizes that divide S).  The products run on the CUDA cores in
// f32, not the tensor cores: mma/wgmma and TMA staging are later work.
// When asked (a non-null pointer; null when serving), the forward also
// writes each row's f32 log-sum-exp [B, Hq, S] for the backward.
//
// Backward (no TPU kernel: the JAX package differentiates its jnp
// reference), FlashAttention-2 style, in two launches on the stream:
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
// Each output element has one writer and a fixed summation order: no
// atomics, so the gradients are deterministic.
#include "common.cuh"

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

template <typename T, bool kBwd>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      return kBwd ? launch_bwd<T, 64>(a) : launch_fwd<T, 64>(a);
    case 128:
      return kBwd ? launch_bwd<T, 128>(a) : launch_fwd<T, 128>(a);
    case 256:
      return kBwd ? launch_bwd<T, 256>(a) : launch_fwd<T, 256>(a);
    default:
      return -1;
  }
}

template <bool kBwd>
int dispatch(int dtype, int D, const Args& a) {
  if (dtype == repro::kBF16) return dispatch_d<__nv_bfloat16, kBwd>(D, a);
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
