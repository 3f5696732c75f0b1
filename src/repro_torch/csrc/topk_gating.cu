// Fused softmax + top-k router gate.
//
// Replaces: src/repro/kernels/topk_gating.py, topk_gating_pallas
// (_gating_kernel): f32 softmax over [T, E] router logits, then k argmax
// passes; weights [T, k] f32 descending, ids [T, k] i32.
//
// What bounds it on an H100: memory and launch latency.  At grok-1's
// shapes the input is [T, 8] f32 (T = prompt length at prefill, live slots
// at decode), a few KB, so the kernel's time is its launch.
//
// Design: one warp per token row, lanes striding over E.  The row's logits
// sit in shared memory; a warp-shuffle max, expf(x - max), a warp-shuffle
// sum and the division give the probabilities (IEEE expf: no fast math).
// Then k passes of a warp argmax that breaks ties on the LOWEST expert id
// (as jax.lax.top_k does; torch.topk on CUDA fixes no tie order), the
// chosen entry set to -inf before the next pass.  E <= 1024.
//
// Backward (no TPU kernel: the JAX package differentiates its jnp
// reference): the ids carry no gradient, and the weights are gathered
// softmax probabilities, so dlogits = p * (g - <p, g>) with p = softmax(x)
// recomputed as above and g the [E] scatter of dweights at ids.  One warp
// per row again; <p, g> is summed over the k chosen entries in order.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
    topk_gating_kernel(const float* __restrict__ logits, float* __restrict__ w_out,
                       int* __restrict__ i_out, int T, int E, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= T) return;  // the whole warp shares the row
  float* p = smem + warp * E;
  const float* x = logits + static_cast<size_t>(row) * E;

  float m = -INFINITY;
  for (int e = lane; e < E; e += 32) {
    const float v = x[e];
    p[e] = v;
    m = fmaxf(m, v);
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(repro::kFullMask, m, off));
  float s = 0.f;
  for (int e = lane; e < E; e += 32) {
    const float ex = expf(p[e] - m);
    p[e] = ex;
    s += ex;
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(repro::kFullMask, s, off);
  for (int e = lane; e < E; e += 32) p[e] = p[e] / s;

  for (int j = 0; j < k; ++j) {
    float best = -INFINITY;
    int bi = INT_MAX;
    // Ascending scan with a strict '>' keeps the lane's lowest index on ties.
    for (int e = lane; e < E; e += 32) {
      const float v = p[e];
      if (v > best) {
        best = v;
        bi = e;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(repro::kFullMask, best, off);
      const int oi = __shfl_xor_sync(repro::kFullMask, bi, off);
      if (ov > best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      w_out[static_cast<size_t>(row) * k + j] = best;
      i_out[static_cast<size_t>(row) * k + j] = bi;
    }
    // Only the owning lane ever reads p[bi] again.
    if (bi < E && (bi & 31) == lane) p[bi] = -INFINITY;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    topk_gating_bwd_kernel(const float* __restrict__ logits, const float* __restrict__ dw,
                           const int* __restrict__ ids, float* __restrict__ dlogits, int T,
                           int E, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= T) return;
  float* p = smem + warp * E;
  const float* x = logits + static_cast<size_t>(row) * E;
  const float* dwr = dw + static_cast<size_t>(row) * k;
  const int* ir = ids + static_cast<size_t>(row) * k;

  float m = -INFINITY;
  for (int e = lane; e < E; e += 32) {
    const float v = x[e];
    p[e] = v;
    m = fmaxf(m, v);
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(repro::kFullMask, m, off));
  float s = 0.f;
  for (int e = lane; e < E; e += 32) {
    const float ex = expf(p[e] - m);
    p[e] = ex;
    s += ex;
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(repro::kFullMask, s, off);
  for (int e = lane; e < E; e += 32) p[e] = p[e] / s;
  __syncwarp();

  float dot = 0.f;
  for (int j = 0; j < k; ++j) {
    const int e = ir[j];
    if (e >= 0 && e < E) dot = fmaf(p[e], dwr[j], dot);
  }
  float* out = dlogits + static_cast<size_t>(row) * E;
  for (int e = lane; e < E; e += 32) {
    float g = 0.f;
    for (int j = 0; j < k; ++j)
      if (ir[j] == e) g += dwr[j];
    out[e] = p[e] * (g - dot);
  }
}

}  // namespace

extern "C" int topk_gating_bwd_f32(const void* logits, const void* dweights, const void* ids,
                                   void* dlogits, int T, int E, int k, void* stream) {
  if (T <= 0) return 0;
  const dim3 grid((T + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) * E * sizeof(float);
  topk_gating_bwd_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(dweights),
      static_cast<const int*>(ids), static_cast<float*>(dlogits), T, E, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int topk_gating_f32(const void* logits, void* weights, void* ids, int T, int E,
                               int k, void* stream) {
  if (T <= 0) return 0;
  const dim3 grid((T + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) * E * sizeof(float);
  topk_gating_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(weights), static_cast<int*>(ids), T,
      E, k);
  return static_cast<int>(cudaGetLastError());
}
