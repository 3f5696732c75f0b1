// Fused softmax + top-k router gate.
//
// Replaces: src/repro/kernels/topk_gating.py, topk_gating_pallas
// (_gating_kernel): f32 softmax over [T, E] router logits, then k argmax
// passes; weights [T, k] f32 descending, ids [T, k] i32.
//
// What bounds it on an H100: launch latency.  At grok-1's and Mixtral's
// shapes the input is [T, 8] f32 (T = the live slots or the prompt when
// serving, 512 tokens in Mixtral's training step): a few KB, nanoseconds
// of bytes.  The design keeps the critical path to one load, a few dozen
// register instructions and one store.
//
// Design.  E <= 32 (grok-1, Mixtral: E = 8): one THREAD a row, the row in
// registers through 16-byte loads where the row is 16-byte aligned (two
// float4 at E = 8).  The max, expf(x - max) (IEEE: no fast math), the sum
// in expert order, the division and the top k (each entry's rank from the
// E (E - 1) / 2 pairwise compares, all independent) run in registers: no
// shared memory, no shuffles.  A warp covers 32 rows; the k
// weights and ids of a row are stored as one 8- or 16-byte vector where
// k * 4 bytes allow it.  32 < E <= 1024 (deepseek-v2: 160 experts, top-6):
// one warp a row, lane l holding experts l, l + 32, ... in registers
// (coalesced loads, no shared-memory staging); shuffles reduce the max,
// the sum and each argmax pass.
//
// Order of the ids: descending probability, ties to the LOWEST expert id
// (as jax.lax.top_k does; torch.topk on CUDA fixes no tie order).  A row
// whose probabilities are NaN (all -inf logits, a NaN or +inf logit: then
// every probability is NaN) gets ids 0..k-1, as torch.argmax, which puts
// the first NaN first, gives the plain version.
//
// Backward (no TPU kernel: the JAX package differentiates its jnp
// reference): the ids carry no gradient, and the weights are gathered
// softmax probabilities, so dlogits = p * (g - <p, g>) with p = softmax(x)
// recomputed as above and g the [E] scatter of dweights at ids, summed
// over the k chosen entries in order.  The same two layouts.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRowThreads = 64;  // threads of a CTA, a row each (E <= 32)
constexpr int kWarps = 4;        // warps of a CTA, a row each (E > 32)

// ---------------------------------------------------------------------------
// E <= 32: a thread a row.  kE: E rounded up to 4, 8, 16 or 32.
// ---------------------------------------------------------------------------

template <int kE>
__device__ __forceinline__ void load_row(const float* __restrict__ xr, int E, bool vec,
                                         float (&x)[kE]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) {
      if (4 * q < E) {
        const float4 v = reinterpret_cast<const float4*>(xr)[q];
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < E) x[e] = xr[e];
  }
}

// x -> softmax probabilities in place, over the first E entries.  Returns
// the sum of the exponentials: NaN exactly when every probability is NaN.
template <int kE>
__device__ __forceinline__ float softmax_row(float (&x)[kE], int E) {
  float m = -INFINITY;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < E) m = fmaxf(m, x[e]);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < E) {
      x[e] = expf(x[e] - m);
      s += x[e];
    }
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < E) x[e] = x[e] / s;
  return s;
}

template <int kE>
__global__ void __launch_bounds__(kRowThreads)
    topk_gating_rows_kernel(const float* __restrict__ logits, float* __restrict__ w_out,
                            int* __restrict__ i_out, int T, int E, int k, bool vec_in,
                            int vec_out) {
  repro::grid_dependency_wait();
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= T) return;
  float p[kE];
  load_row<kE>(logits + static_cast<size_t>(row) * E, E, vec_in, p);
  const bool nan_row = isnan(softmax_row<kE>(p, E));

  // Each entry's rank in the gate's order (descending; an equal value of a
  // lower id ranks first), from every pair's one compare: independent
  // compares and sums, no chain through a running best.  Output j is the
  // entry of rank j.  A NaN row: ids 0..k-1.
  int rank[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) rank[e] = 0;
#pragma unroll
  for (int a = 0; a < kE; ++a)
#pragma unroll
    for (int b = a + 1; b < kE; ++b)
      if (b < E) {
        const bool a_first = p[a] >= p[b];
        rank[b] += a_first;
        rank[a] += !a_first;
      }
  float ws[kE];
  int is[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    if (j >= k) break;
    ws[j] = p[j];
    is[j] = j;
    if (!nan_row) {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (e < E && rank[e] == j) {
          ws[j] = p[e];
          is[j] = e;
        }
    }
  }
  float* wr = w_out + static_cast<size_t>(row) * k;
  int* ir = i_out + static_cast<size_t>(row) * k;
  if (vec_out == 4) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q)
      if (4 * q < k) {
        reinterpret_cast<float4*>(wr)[q] = make_float4(ws[4 * q], ws[4 * q + 1], ws[4 * q + 2],
                                                       ws[4 * q + 3]);
        reinterpret_cast<int4*>(ir)[q] = make_int4(is[4 * q], is[4 * q + 1], is[4 * q + 2],
                                                   is[4 * q + 3]);
      }
  } else if (vec_out == 2) {
#pragma unroll
    for (int q = 0; q < kE / 2; ++q)
      if (2 * q < k) {
        reinterpret_cast<float2*>(wr)[q] = make_float2(ws[2 * q], ws[2 * q + 1]);
        reinterpret_cast<int2*>(ir)[q] = make_int2(is[2 * q], is[2 * q + 1]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j)
      if (j < k) {
        wr[j] = ws[j];
        ir[j] = is[j];
      }
  }
}

template <int kE>
__global__ void __launch_bounds__(kRowThreads)
    topk_gating_rows_bwd_kernel(const float* __restrict__ logits, const float* __restrict__ dw,
                                const int* __restrict__ ids, float* __restrict__ dlogits, int T,
                                int E, int k, bool vec) {
  repro::grid_dependency_wait();
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= T) return;
  float p[kE];
  load_row<kE>(logits + static_cast<size_t>(row) * E, E, vec, p);
  const float* dwr = dw + static_cast<size_t>(row) * k;
  const int* ir = ids + static_cast<size_t>(row) * k;
  float d[kE];
  int id[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j)
    if (j < k) {
      d[j] = dwr[j];
      id[j] = ir[j];
    }
  softmax_row<kE>(p, E);

  float dot = 0.f, g[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) g[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    if (j >= k) break;
    float pe = 0.f;
    bool hit = false;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < E && id[j] == e) {
        pe = p[e];
        hit = true;
        g[e] += d[j];
      }
    if (hit) dot = fmaf(pe, d[j], dot);
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) p[e] = p[e] * (g[e] - dot);
  float* out = dlogits + static_cast<size_t>(row) * E;
  if (vec) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q)
      if (4 * q < E)
        reinterpret_cast<float4*>(out)[q] = make_float4(p[4 * q], p[4 * q + 1], p[4 * q + 2],
                                                        p[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < E) out[e] = p[e];
  }
}

// ---------------------------------------------------------------------------
// 32 < E <= 1024: a warp a row, lane l holding experts l + 32 j, j < kPL.
// ---------------------------------------------------------------------------

template <int kPL>
__device__ __forceinline__ float warp_softmax(const float* __restrict__ xr, int E, int lane,
                                             float (&p)[kPL]) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPL; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? xr[e] : -INFINITY;
    if (e < E) m = fmaxf(m, p[j]);
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(repro::kFullMask, m, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPL; ++j)
    if (lane + 32 * j < E) {
      p[j] = expf(p[j] - m);
      s += p[j];
    }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(repro::kFullMask, s, off);
#pragma unroll
  for (int j = 0; j < kPL; ++j)
    if (lane + 32 * j < E) p[j] = p[j] / s;
  return s;
}

template <int kPL>
__global__ void __launch_bounds__(kWarps * 32)
    topk_gating_warp_kernel(const float* __restrict__ logits, float* __restrict__ w_out,
                            int* __restrict__ i_out, int T, int E, int k) {
  repro::grid_dependency_wait();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;  // the whole warp shares the row
  float p[kPL];
  const float sum = warp_softmax<kPL>(logits + static_cast<size_t>(row) * E, E, lane, p);
  const bool nan_row = isnan(sum);
  unsigned taken = 0;
  for (int j = 0; j < k; ++j) {
    // As the thread layout, over the lane's entries, then across the lanes
    // with ties to the lower id; a lane with none left offers (-1, E).
    float best = -1.f;
    int bi = E;
#pragma unroll
    for (int q = 0; q < kPL; ++q) {
      const int e = lane + 32 * q;
      if (e < E && !((taken >> q) & 1u) && p[q] > best) {
        best = p[q];
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
    if (nan_row) {
      best = p[0];
      bi = j;
    }
    if ((bi & 31) == lane) {  // the owning lane records and retires it
      w_out[static_cast<size_t>(row) * k + j] = best;
      i_out[static_cast<size_t>(row) * k + j] = bi;
      taken |= 1u << (bi >> 5);
    }
  }
}

template <int kPL>
__global__ void __launch_bounds__(kWarps * 32)
    topk_gating_warp_bwd_kernel(const float* __restrict__ logits, const float* __restrict__ dw,
                                const int* __restrict__ ids, float* __restrict__ dlogits, int T,
                                int E, int k) {
  repro::grid_dependency_wait();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;
  float p[kPL];
  warp_softmax<kPL>(logits + static_cast<size_t>(row) * E, E, lane, p);
  const float* dwr = dw + static_cast<size_t>(row) * k;
  const int* ir = ids + static_cast<size_t>(row) * k;
  float dot = 0.f, g[kPL];
#pragma unroll
  for (int q = 0; q < kPL; ++q) g[q] = 0.f;
  for (int j = 0; j < k; ++j) {
    const int e = ir[j];
    const float d = dwr[j];
    if (e < 0 || e >= E) continue;
    float sel = 0.f;
#pragma unroll
    for (int q = 0; q < kPL; ++q)
      if (q == (e >> 5)) {
        sel = p[q];
        if ((e & 31) == lane) g[q] += d;
      }
    dot = fmaf(__shfl_sync(repro::kFullMask, sel, e & 31), d, dot);
  }
  float* out = dlogits + static_cast<size_t>(row) * E;
#pragma unroll
  for (int q = 0; q < kPL; ++q)
    if (lane + 32 * q < E) out[lane + 32 * q] = p[q] * (g[q] - dot);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// f(std::integral_constant<int, n>) for the least power of two n in [kN, kHi]
// with n >= need (kHi if none).
template <int kN, int kHi, typename F>
cudaError_t by_pow2(int need, F f) {
  if constexpr (kN < kHi) {
    if (need > kN) return by_pow2<2 * kN, kHi>(need, f);
  }
  return f(std::integral_constant<int, kN>{});
}

}  // namespace

extern "C" int topk_gating_f32(const void* logits, void* weights, void* ids, int T, int E,
                               int k, void* stream) {
  if (T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  float* w = static_cast<float*>(weights);
  int* i = static_cast<int*>(ids);
  const auto aligned8 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  cudaError_t err;
  if (E <= 32) {
    const dim3 grid((T + kRowThreads - 1) / kRowThreads);
    const bool vec_in = E % 4 == 0 && aligned16(x);
    const int vec_out = k % 4 == 0 && aligned16(w) && aligned16(i)  ? 4
                        : k % 2 == 0 && aligned8(w) && aligned8(i) ? 2
                                                                    : 1;
    err = by_pow2<4, 32>(E, [&](auto n) {
      return repro::launch_pdl(topk_gating_rows_kernel<decltype(n)::value>, grid, dim3(kRowThreads),
                           st, x, w, i, T, E, k, vec_in, vec_out);
    });
  } else {
    err = by_pow2<2, 32>((E + 31) / 32, [&](auto n) {
      return repro::launch_pdl(topk_gating_warp_kernel<decltype(n)::value>,
                           dim3((T + kWarps - 1) / kWarps), dim3(kWarps * 32), st, x, w, i,
                           T, E, k);
    });
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int topk_gating_bwd_f32(const void* logits, const void* dweights, const void* ids,
                                   void* dlogits, int T, int E, int k, void* stream) {
  if (T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const float* d = static_cast<const float*>(dweights);
  const int* i = static_cast<const int*>(ids);
  float* out = static_cast<float*>(dlogits);
  cudaError_t err;
  if (E <= 32) {
    const bool vec = E % 4 == 0 && aligned16(x) && aligned16(out);
    err = by_pow2<4, 32>(E, [&](auto n) {
      return repro::launch_pdl(topk_gating_rows_bwd_kernel<decltype(n)::value>,
                           dim3((T + kRowThreads - 1) / kRowThreads), dim3(kRowThreads), st,
                           x, d, i, out, T, E, k, vec);
    });
  } else {
    err = by_pow2<2, 32>((E + 31) / 32, [&](auto n) {
      return repro::launch_pdl(topk_gating_warp_bwd_kernel<decltype(n)::value>,
                           dim3((T + kWarps - 1) / kWarps), dim3(kWarps * 32), st, x, d, i,
                           out, T, E, k);
    });
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
