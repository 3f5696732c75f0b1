// MoE dispatch (row gather), combine (weighted gather-sum) and the
// combine's backward.
//
// Replaces: src/repro/kernels/moe_dispatch.py, moe_dispatch_pallas
// (_dispatch_kernel): out[p] = x[src[p]], zeros where src[p] < 0; and
// moe_combine_pallas (_combine_kernel): out[t] = sum_s w[t,s] * y[slot[t,s]]
// in f32, s = 0..S-1 in order, terms with slot < 0 skipped.  The combine
// backward has no TPU kernel (the JAX package differentiates its jnp
// reference): dy[p] = w[t,s] * dout[t] for the (t, s) that reads row p
// (src[p] = t * S + s, zeros where src[p] < 0), and
// dw[t,s] = <dout[t], y[slot[t,s]]> (0 where slot < 0).
//
// What bounds them on an H100: bytes.  Each moves rows of D elements and
// does at most one multiply-add per element read.  At Mixtral's training
// step (T = 512 tokens, top-2, D = 4096 bf16) a call moves 12.6-25.2 MB:
// 3.8-7.5 us at 3.35 TB/s, less where the rows sit in the 50 MB L2.  At
// that size the launch and the first round trip to memory are a large part
// of the time, so what matters is having enough bytes in flight from the
// first cycle: ~25 KB per SM covers HBM's latency.
//
// Design:
// * gather (vector_gather_kernel<V, I>): each thread issues kUnroll
//   independent 16-byte loads (V = uint4; 8, 4 or 2 bytes when a row or a
//   base pointer is off 16 bytes) before any store, 256-thread CTAs over
//   the flattened output, up to 8 an SM.  Rows with src < 0 are stored as
//   zeros.  At Mixtral's shapes this is as fast as a plain copy of the same
//   bytes when they sit in L2 and 10-15% faster than the one-warp-a-row
//   kernel it replaced when they do not (PERF.md).  A TMA 1-D bulk-copy gather (persistent one-warp
//   CTAs, one lane moving 8 KB chunks through a 4-stage mbarrier ring) was
//   timed against it and lost at every shape: one thread issuing 8 KB
//   copies keeps fewer bytes in flight at these sizes than 256 threads
//   issuing 16-byte loads.
// * combine (combine_kernel<TY, TO, N, I>): one thread per 16 bytes of one
//   output row's input (8 bf16 or 4 f32), so a row is spread over many
//   threads (1024 CTAs of 256 at Mixtral's shapes).  A thread reads slot[t, :] and
//   w[t, :] once, issues the loads of kBatch terms before any arithmetic
//   (all of them at top-2), and sums in
//   order in f32 without FMA contraction (acc = 0, then
//   __fadd_rn(acc, __fmul_rn(w, y)) for s = 0..S-1, dropped terms
//   skipped): the result does not depend on which packed rows the terms sit
//   in, and a fully dropped row is exact zeros.  16-byte stores.
// * backward (combine_bwd_kernel): one CTA per token t reads dout[t] once
//   and, for each of its terms s with p = slot[t,s], writes
//   dy[p] = w[t,s] * dout[t] (one rounding) and reduces dw[t,s] (per-thread
//   sums in a fixed order, then a fixed shuffle tree, then the warps' sums in
//   order).  Precondition: slot and src are exact inverses (slot[t,s] = p
//   >= 0 exactly when src[p] = t * S + s), as DispatchPlan's are; each CTA
//   then zeros its stripe of the rows p with src[p] outside [0, T * S).
//   A register budget of 4 CTAs an SM puts Mixtral's 512 tokens in one
//   wave.
// No atomics anywhere: every output element has one writer, so results are
// deterministic.  Rows, widths or base pointers that are not 16-byte aligned
// take the same kernels with one-element (combine, backward) or narrower
// (gather) accesses.  The gather and the combine index their flattened
// output with 32-bit integers (I) and switch to 64-bit ones for outputs of
// 2^31 or more accesses.
#include <stdint.h>

#include "common.cuh"

namespace {

// Elements of T in 16 bytes (or one, for the unaligned paths), loaded and
// stored as one unit.
template <typename T, int N>
struct alignas(N * sizeof(T) >= 16 ? 16 : N * sizeof(T)) Pack {
  T v[N];
};

// A Pack from / to memory: 16-byte accesses when it is made of them.
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* p) {
  Pack<T, N> r;
  if constexpr (sizeof(r) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(r) / 16); ++i)
      reinterpret_cast<uint4*>(&r)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = p[i];
  }
  return r;
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, N>& r) {
  if constexpr (sizeof(r) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(r) / 16); ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(&r)[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = r.v[i];
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = n > 0 ? n : 132;
  }
  return count[dev];
}

// --- kernel 4: the gather ----------------------------------------------------

constexpr int kVecThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVecCtasPerSm = 8;  // the grid's cap; larger outputs loop

// I indexes the flattened output (total = P * nv vectors).
template <typename V, typename I>
__global__ void __launch_bounds__(kVecThreads)
    vector_gather_kernel(const V* __restrict__ x, const int* __restrict__ src,
                         V* __restrict__ out, int T, I total, I nv) {
  const I step = static_cast<I>(gridDim.x) * (kVecThreads * kUnroll);
  for (I base = static_cast<I>(blockIdx.x) * (kVecThreads * kUnroll) + threadIdx.x;
       base < total; base += step) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I i = base + u * kVecThreads;
      v[u] = V{};
      if (i < total) {
        const I p = i / nv;
        const int s = src[p];
        if (s >= 0 && s < T) v[u] = x[static_cast<size_t>(s) * nv + (i - p * nv)];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I i = base + u * kVecThreads;
      if (i < total) out[i] = v[u];
    }
  }
}

template <typename V>
int launch_vector_gather(const void* x, const int* src, void* out, int T, int P, int row_bytes,
                         cudaStream_t st) {
  const int nv = row_bytes / static_cast<int>(sizeof(V));
  const long long total = static_cast<long long>(P) * nv;
  const long long tiles = (total + kVecThreads * kUnroll - 1) / (kVecThreads * kUnroll);
  const long long cap = static_cast<long long>(kVecCtasPerSm) * sm_count();
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  const V* xp = static_cast<const V*>(x);
  V* op = static_cast<V*>(out);
  if (total < (1ll << 31))
    vector_gather_kernel<V, unsigned><<<grid, kVecThreads, 0, st>>>(
        xp, src, op, T, static_cast<unsigned>(total), static_cast<unsigned>(nv));
  else
    vector_gather_kernel<V, unsigned long long><<<grid, kVecThreads, 0, st>>>(
        xp, src, op, T, static_cast<unsigned long long>(total),
        static_cast<unsigned long long>(nv));
  return static_cast<int>(cudaGetLastError());
}

// --- kernel 5: the combine ---------------------------------------------------

constexpr int kThreads = 256;
// Terms whose loads a thread issues before their arithmetic (more terms go
// in further batches of this many).
constexpr int kBatch = 2;

// I indexes the flattened [T, D / N] output.
template <typename TY, typename TO, int N, typename I>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const TY* __restrict__ y, const int* __restrict__ slot,
                   const float* __restrict__ w, TO* __restrict__ out, int S, int P, int D,
                   I total) {
  const I nvec = D / N;
  // Item i of the flattened output, so neighbouring threads touch
  // neighbouring bytes.
  const I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int t = static_cast<int>(i / nvec);
  const int col = static_cast<int>(i - static_cast<I>(t) * nvec) * N;
  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kBatch) {
    Pack<TY, N> v[kBatch];
    float ws[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int s = s0 + b;
      const int p = s < S ? slot[static_cast<size_t>(t) * S + s] : -1;
      ok[b] = p >= 0 && p < P;
      ws[b] = ok[b] ? w[static_cast<size_t>(t) * S + s] : 0.f;
      if (ok[b]) v[b] = load_pack<TY, N>(y + static_cast<size_t>(p) * D + col);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (!ok[b]) continue;
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(ws[b], repro::to_f32(v[b].v[e])));
    }
  }
  Pack<TO, N> o;
#pragma unroll
  for (int e = 0; e < N; ++e) o.v[e] = repro::from_f32<TO>(acc[e]);
  store_pack(out + static_cast<size_t>(t) * D + col, o);
}

template <typename TY, typename TO, int N>
void launch_combine_n(const TY* y, const int* slot, const float* w, TO* out, int S, int P, int D,
                      long long items, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((items + kThreads - 1) / kThreads);
  if (items < (1ll << 31))
    combine_kernel<TY, TO, N, unsigned><<<grid, kThreads, 0, st>>>(
        y, slot, w, out, S, P, D, static_cast<unsigned>(items));
  else
    combine_kernel<TY, TO, N, unsigned long long><<<grid, kThreads, 0, st>>>(
        y, slot, w, out, S, P, D, static_cast<unsigned long long>(items));
}

template <typename TY, typename TO>
int launch_combine(const void* y, const void* slot, const void* w, void* out, int T, int S,
                   int P, int D, cudaStream_t st) {
  constexpr int kN = 16 / sizeof(TY);
  const bool vec = D % kN == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const TY* yp = static_cast<const TY*>(y);
  const int* sp = static_cast<const int*>(slot);
  const float* wp = static_cast<const float*>(w);
  TO* op = static_cast<TO*>(out);
  if (vec)
    launch_combine_n<TY, TO, kN>(yp, sp, wp, op, S, P, D, static_cast<long long>(T) * (D / kN),
                                 st);
  else
    launch_combine_n<TY, TO, 1>(yp, sp, wp, op, S, P, D, static_cast<long long>(T) * D, st);
  return static_cast<int>(cudaGetLastError());
}

// --- kernel 5's backward -------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kBwdBatch = 2;  // terms per pass over dout[t]
constexpr int kBwdCtasPerSm = 4;  // register budget: Mixtral's 512 tokens in one wave

// CTA b < T: token t = b, as the note at the top says.  Every CTA then
// zeros the dy rows p = b, b + gridDim.x, ... that no term reads.
template <typename TY, int N>
__global__ void __launch_bounds__(kThreads, kBwdCtasPerSm)
    combine_bwd_kernel(const float* __restrict__ dout, const TY* __restrict__ y,
                       const int* __restrict__ slot, const float* __restrict__ w,
                       const int* __restrict__ src, TY* __restrict__ dy, float* __restrict__ dw,
                       int T, int S, int P, int D) {
  const int nvec = D / N;
  __shared__ float red[kWarps][kBwdBatch];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* g = dout + static_cast<size_t>(t) * D;
  for (int s0 = 0; t < T && s0 < S; s0 += kBwdBatch) {
    int ps[kBwdBatch];
    float ws[kBwdBatch];
    bool ok[kBwdBatch];
#pragma unroll
    for (int b = 0; b < kBwdBatch; ++b) {
      ps[b] = s0 + b < S ? slot[static_cast<size_t>(t) * S + s0 + b] : -1;
      ok[b] = ps[b] >= 0 && ps[b] < P;
      ws[b] = ok[b] ? w[static_cast<size_t>(t) * S + s0 + b] : 0.f;
    }
    float part[kBwdBatch] = {};
    for (int c = threadIdx.x; c < nvec; c += kThreads) {
      const Pack<float, N> gv = load_pack<float, N>(g + c * N);
      Pack<TY, N> yv[kBwdBatch];
#pragma unroll
      for (int b = 0; b < kBwdBatch; ++b)
        if (ok[b] && dw != nullptr)
          yv[b] = load_pack<TY, N>(y + static_cast<size_t>(ps[b]) * D + c * N);
#pragma unroll
      for (int b = 0; b < kBwdBatch; ++b) {
        if (!ok[b]) continue;
        Pack<TY, N> o;
#pragma unroll
        for (int e = 0; e < N; ++e) o.v[e] = repro::from_f32<TY>(__fmul_rn(ws[b], gv.v[e]));
        store_pack(dy + static_cast<size_t>(ps[b]) * D + c * N, o);
        if (dw != nullptr) {
#pragma unroll
          for (int e = 0; e < N; ++e) part[b] = fmaf(gv.v[e], repro::to_f32(yv[b].v[e]), part[b]);
        }
      }
    }
    if (dw == nullptr) continue;
#pragma unroll
    for (int b = 0; b < kBwdBatch; ++b) {
      float v = part[b];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(repro::kFullMask, v, off);
      if (lane == 0) red[warp][b] = v;
    }
    __syncthreads();
    if (threadIdx.x < kBwdBatch && s0 + threadIdx.x < S) {
      float v = 0.f;
      for (int k = 0; k < kWarps; ++k) v += red[k][threadIdx.x];
      dw[static_cast<size_t>(t) * S + s0 + threadIdx.x] = ok[threadIdx.x] ? v : 0.f;
    }
    __syncthreads();
  }
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int f = src[p];
    if (f >= 0 && f < T * S) continue;
    Pack<TY, N> zero;
#pragma unroll
    for (int e = 0; e < N; ++e) zero.v[e] = repro::from_f32<TY>(0.f);
    for (int c = threadIdx.x; c < nvec; c += kThreads)
      store_pack(dy + static_cast<size_t>(p) * D + c * N, zero);
  }
}

template <typename TY>
int launch_combine_bwd(const float* dout, const void* y, const int* slot, const float* w,
                       const int* src, void* dy, float* dw, int T, int S, int P, int D,
                       cudaStream_t st) {
  constexpr int kN = 16 / sizeof(TY);
  const bool vec = D % kN == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  // At least one CTA per token; more (up to one per 32 rows) when a large P
  // has many rows to zero.
  const int zero_ctas = (P + 31) / 32;
  const int grid = T > zero_ctas ? T : zero_ctas;
  const TY* yp = static_cast<const TY*>(y);
  TY* dyp = static_cast<TY*>(dy);
  if (vec)
    combine_bwd_kernel<TY, kN><<<grid, kThreads, 0, st>>>(dout, yp, slot, w, src, dyp, dw, T, S,
                                                         P, D);
  else
    combine_bwd_kernel<TY, 1><<<grid, kThreads, 0, st>>>(dout, yp, slot, w, src, dyp, dw, T, S,
                                                        P, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [T, row_bytes] (any dtype, as bytes), src [P] i32 -> out [P, row_bytes].
extern "C" int moe_dispatch(const void* x, const void* src, void* out, int T, int P,
                            int row_bytes, void* stream) {
  if (P <= 0 || row_bytes <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                         static_cast<uintptr_t>(row_bytes);
  const int* s = static_cast<const int*>(src);
  if (bits % 16 == 0) return launch_vector_gather<uint4>(x, s, out, T, P, row_bytes, st);
  if (bits % 8 == 0) return launch_vector_gather<uint2>(x, s, out, T, P, row_bytes, st);
  if (bits % 4 == 0) return launch_vector_gather<unsigned int>(x, s, out, T, P, row_bytes, st);
  if (bits % 2 == 0) return launch_vector_gather<unsigned short>(x, s, out, T, P, row_bytes, st);
  return -3;
}

// y [P, D] (dtype_y), slot/w [T, S] -> out [T, D] (dtype_out: f32 or bf16).
extern "C" int moe_combine(const void* y, const void* slot, const void* w, void* out,
                           int dtype_y, int dtype_out, int T, int S, int P, int D,
                           void* stream) {
  if (T <= 0 || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_y == repro::kBF16 && dtype_out == repro::kF32)
    return launch_combine<__nv_bfloat16, float>(y, slot, w, out, T, S, P, D, st);
  if (dtype_y == repro::kBF16 && dtype_out == repro::kBF16)
    return launch_combine<__nv_bfloat16, __nv_bfloat16>(y, slot, w, out, T, S, P, D, st);
  if (dtype_y == repro::kF32 && dtype_out == repro::kF32)
    return launch_combine<float, float>(y, slot, w, out, T, S, P, D, st);
  return -2;
}

// dout [T, D] f32, y [P, D], slot/w [T, S], src [P] (flat t * S + s or -1;
// the exact inverse of slot) -> dy [P, D] (y's dtype), dw [T, S] f32
// (skipped when dw is null).
extern "C" int moe_combine_bwd(const void* dout, const void* y, const void* slot,
                               const void* w, const void* src, void* dy, void* dw, int dtype_y,
                               int T, int S, int P, int D, void* stream) {
  if ((T <= 0 && P <= 0) || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dout);
  const int* sl = static_cast<const int*>(slot);
  const float* wt = static_cast<const float*>(w);
  const int* sr = static_cast<const int*>(src);
  float* dwp = static_cast<float*>(dw);
  if (dtype_y == repro::kBF16)
    return launch_combine_bwd<__nv_bfloat16>(g, y, sl, wt, sr, dy, dwp, T, S, P, D, st);
  if (dtype_y == repro::kF32)
    return launch_combine_bwd<float>(g, y, sl, wt, sr, dy, dwp, T, S, P, D, st);
  return -2;
}
