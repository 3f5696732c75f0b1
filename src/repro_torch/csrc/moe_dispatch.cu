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
// What bounds them on an H100: memory.  Each moves rows of D elements and
// does at most one multiply-add per element read: the time is the row
// bytes over 3.35 TB/s.  At Mixtral's training step (T = 512 tokens, top-2,
// D = 4096 bf16) a dispatch moves 2 x 8.4 MB.
//
// Design: one warp per output row.  The gather copies the row with 16-byte
// loads and stores when the row and both base pointers allow it (8, 4 or 2
// bytes otherwise); it only moves bits, so it is exact.  The combine gives
// each warp one token row: lanes stride over D, and the S terms are summed
// in order in f32 without FMA contraction (__fmul_rn / __fadd_rn), so a
// row's sum does not depend on which packed rows its terms sit in.  A row
// whose terms are all dropped is written as exact zeros.  The backward is
// one launch with two parts (blockIdx.y): part 0 gathers dy rows through
// src, part 1 reduces one dw entry per warp (f32, fixed lane order, then a
// fixed shuffle tree).  No atomics anywhere: every output element has one
// writer, so results are deterministic.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const char* __restrict__ x, const int* __restrict__ src,
                       char* __restrict__ out, int T, int P, int row_bytes) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;
  const int s = src[p];
  const int nv = row_bytes / static_cast<int>(sizeof(V));
  V* o = reinterpret_cast<V*>(out + static_cast<size_t>(p) * row_bytes);
  if (s < 0 || s >= T) {
    const V zero{};
    for (int i = lane; i < nv; i += 32) o[i] = zero;
    return;
  }
  const V* in = reinterpret_cast<const V*>(x + static_cast<size_t>(s) * row_bytes);
  for (int i = lane; i < nv; i += 32) o[i] = in[i];
}

template <typename TY, typename TO>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const TY* __restrict__ y, const int* __restrict__ slot,
                   const float* __restrict__ w, TO* __restrict__ out, int T, int S, int P,
                   int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= T) return;
  const int* sl = slot + static_cast<size_t>(t) * S;
  const float* wt = w + static_cast<size_t>(t) * S;
  TO* o = out + static_cast<size_t>(t) * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const int p = sl[s];
      if (p < 0 || p >= P) continue;
      acc = __fadd_rn(acc, __fmul_rn(wt[s], repro::to_f32(y[static_cast<size_t>(p) * D + d])));
    }
    o[d] = repro::from_f32<TO>(acc);
  }
}

// blockIdx.y == 0: dy rows (one warp per packed row p).
// blockIdx.y == 1: dw entries (one warp per (t, s) pair).
template <typename TY>
__global__ void __launch_bounds__(kThreads)
    combine_bwd_kernel(const float* __restrict__ dout, const TY* __restrict__ y,
                       const int* __restrict__ slot, const float* __restrict__ w,
                       const int* __restrict__ src, TY* __restrict__ dy, float* __restrict__ dw,
                       int T, int S, int P, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (blockIdx.y == 0) {
    if (i >= P) return;
    const int f = src[i];
    TY* o = dy + static_cast<size_t>(i) * D;
    if (f < 0 || f >= T * S) {
      for (int d = lane; d < D; d += 32) o[d] = repro::from_f32<TY>(0.f);
      return;
    }
    const float wf = w[f];
    const float* g = dout + static_cast<size_t>(f / S) * D;
    for (int d = lane; d < D; d += 32) o[d] = repro::from_f32<TY>(__fmul_rn(wf, g[d]));
    return;
  }
  if (dw == nullptr || i >= T * S) return;
  const int p = slot[i];
  float acc = 0.f;
  if (p >= 0 && p < P) {
    const float* g = dout + static_cast<size_t>(i / S) * D;
    const TY* yr = y + static_cast<size_t>(p) * D;
    for (int d = lane; d < D; d += 32) acc = fmaf(g[d], repro::to_f32(yr[d]), acc);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(repro::kFullMask, acc, off);
  if (lane == 0) dw[i] = acc;
}

template <typename TY, typename TO>
int launch_combine(const void* y, const void* slot, const void* w, void* out, int T, int S,
                   int P, int D, cudaStream_t st) {
  combine_kernel<TY, TO><<<(T + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const TY*>(y), static_cast<const int*>(slot), static_cast<const float*>(w),
      static_cast<TO*>(out), T, S, P, D);
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
  const dim3 grid((P + kWarps - 1) / kWarps);
  const char* xc = static_cast<const char*>(x);
  const int* s = static_cast<const int*>(src);
  char* oc = static_cast<char*>(out);
  if (bits % 16 == 0)
    gather_rows_kernel<uint4><<<grid, kThreads, 0, st>>>(xc, s, oc, T, P, row_bytes);
  else if (bits % 8 == 0)
    gather_rows_kernel<uint2><<<grid, kThreads, 0, st>>>(xc, s, oc, T, P, row_bytes);
  else if (bits % 4 == 0)
    gather_rows_kernel<unsigned int><<<grid, kThreads, 0, st>>>(xc, s, oc, T, P, row_bytes);
  else if (bits % 2 == 0)
    gather_rows_kernel<unsigned short><<<grid, kThreads, 0, st>>>(xc, s, oc, T, P, row_bytes);
  else
    return -3;
  return static_cast<int>(cudaGetLastError());
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

// dout [T, D] f32, y [P, D], slot/w [T, S], src [P] (flat t * S + s or -1)
// -> dy [P, D] (y's dtype), dw [T, S] f32 (skipped when dw is null).
extern "C" int moe_combine_bwd(const void* dout, const void* y, const void* slot,
                               const void* w, const void* src, void* dy, void* dw, int dtype_y,
                               int T, int S, int P, int D, void* stream) {
  const int rows = P > T * S ? P : T * S;
  if (rows <= 0 || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + kWarps - 1) / kWarps, 2);
  const float* g = static_cast<const float*>(dout);
  const int* sl = static_cast<const int*>(slot);
  const float* wt = static_cast<const float*>(w);
  const int* sr = static_cast<const int*>(src);
  float* dwp = static_cast<float*>(dw);
  if (dtype_y == repro::kBF16)
    combine_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        g, static_cast<const __nv_bfloat16*>(y), sl, wt, sr, static_cast<__nv_bfloat16*>(dy),
        dwp, T, S, P, D);
  else if (dtype_y == repro::kF32)
    combine_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        g, static_cast<const float*>(y), sl, wt, sr, static_cast<float*>(dy), dwp, T, S, P, D);
  else
    return -2;
  return static_cast<int>(cudaGetLastError());
}
