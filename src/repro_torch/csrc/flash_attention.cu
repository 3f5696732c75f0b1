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
                     T* __restrict__ o, int Hq, int Hkv, int S, float scale, int causal,
                     int window, float softcap) {
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
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
           float scale, int causal, int window, float softcap, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBM - 1) / kBM, B * Hq);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv,
                                           S, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
             int S, float scale, int causal, int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, softcap, stream);
    default:
      return -1;
  }
}

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Hq, int Hkv, int S, int D, float scale,
                                   int causal, int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, S, scale, causal, window, softcap,
                                   st);
  if (dtype == repro::kF32)
    return launch_d<float>(D, q, k, v, o, B, Hq, Hkv, S, scale, causal, window, softcap, st);
  return -2;
}
