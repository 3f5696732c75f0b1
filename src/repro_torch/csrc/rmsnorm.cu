// Fused RMSNorm: y = g * rsqrt(mean(g^2) + eps) * (1 + w), f32 math,
// rounded once to x's dtype, where g = x, or with a gate z (Mamba-2's gated
// norm) g = round(x * round(silu(z))), silu(z) = z / (1 + expf(-z)) in f32
// (PyTorch's formula; each round is to x's dtype, the identity in f32).
// Plus its backward.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (_rmsnorm_kernel):
// a (bt x D) token tile in VMEM, one read and one write of x per norm.  The
// gate is the multiply before the norm at src/repro/models/ssm.py:189-190.
// The backward replaces no TPU kernel (the JAX package differentiates its
// jnp reference):
//   dx = r (1 + w) dy - x r^3 / D * sum_row(dy (1 + w) x)   (f32, rounded once)
//   dw = sum_rows dy x r
//
// What bounds it on an H100: memory, and on the serving paths the launch.
// Mamba-2 1.3B runs it twice a layer, at T = the prompt (8-44 tokens in the
// chat serve) or the live slots at decode: [T, 2048] and the gated [T, 4096]
// bf16, a few KB to a few hundred KB, far under a microsecond of bytes.
// grok-1 runs [T, 6144], Mixtral's training step [512, 4096] forward and
// backward (12 MB: ~3.6 us of bytes for the backward).
//
// Design.  One CTA a row, its warps chosen by D and T so that each lane
// holds kVecTarget 16-byte vectors of the row in registers (kMaxWarps warps
// at most): one vector for fewer than kManyRows rows, where a launch is a
// few CTAs and the time is latency (and the gate's expf and division, spread
// over as many lanes as the row has vectors); two from kManyRows rows on,
// where the rows fill the card and fewer, fuller warps stream faster.  Every
// load of a row -- w, x and the gate -- is issued before any is used, so a
// row costs one memory latency; the reduction (shuffles, then one
// shared-memory exchange behind one barrier) is all that stands between the
// loads and the stores.  The gated value is formed in registers: z never
// becomes a tensor of its own and the two elementwise launches before the
// norm go away.  Results equal the ungated kernel's on the materialised
// x * silu(z) bit for bit: the same launch shape sums the same values in
// the same order.
//
// Programmatic dependent launch: every kernel here is launched with
// programmatic stream serialization, so its CTAs are scheduled and do
// their address arithmetic while the kernel before it in the stream
// drains; each reads and writes nothing before griddepcontrol.wait.  (On
// the model's paths the kernel before is a PyTorch launch that writes x or
// the gate -- the residual add, the D-skip add and cast, the embedding --
// and never w; even so w is read after the wait, with x: prefetching w into
// L2 before it measured no faster at the serving shapes, warm or cold.)
//
// Rows wider than the registers hold (above 1024 vectors: 8192 bf16, 4096
// f32) take two passes, the second reading the row again from L2.  The
// backward: CTA b takes rows b, b + G, ... (G a function of T alone), keeps
// its rows' share of dw in f32 registers (wide rows: in its own row of the
// workspace) and writes it to a [G, D] f32 workspace; a second kernel sums
// the workspace's rows in order.  No atomics: every result is the same on
// every run.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 16;   // warps a row
constexpr int kVecTarget = 1;   // 16-byte vectors a lane aims to hold (forward, few rows)
constexpr int kManyRows = 256;  // from this many rows on, the forward's lanes aim at
constexpr int kManyVecTarget = 2;  // this many vectors
constexpr int kBwdVecTarget = 2;  // the same, backward
constexpr int kMaxVpl = 2;      // vectors a lane may hold (kernels are built for 1 and 2)
// The widest row (in vectors: 8192 bf16, 4096 f32) the one-pass kernels hold.
constexpr int kRegVectors = kMaxWarps * 32 * kMaxVpl;
constexpr int kWideThreads = 256;
constexpr int kBwdBlocks = 128;   // CTAs of the backward (at most; fewer for T < 128)
constexpr int kDwCols = 16;    // groups of 4 columns a CTA of the dw sum
constexpr int kDwSlices = 16;  // its thread rows, each over every kDwSlices-th workspace row

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;  // 8 bf16
  static constexpr int n = 8;
};

template <typename T>
__device__ __forceinline__ void unpack(const typename Vec<T>::type& v, float* out);
template <>
__device__ __forceinline__ void unpack<float>(const float4& v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v, float* out) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

template <typename T>
__device__ __forceinline__ typename Vec<T>::type pack(const float* in);
template <>
__device__ __forceinline__ float4 pack<float>(const float* in) {
  return make_float4(in[0], in[1], in[2], in[3]);
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* in) {
  uint4 v;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(in[i]);
  return v;
}

// x * silu(z) as PyTorch's two elementwise kernels compute it in x's dtype.
template <typename T>
__device__ __forceinline__ float gated(float x, float z) {
  const float s = repro::to_f32(repro::from_f32<T>(z / (1.0f + expf(-z))));
  return repro::to_f32(repro::from_f32<T>(x * s));
}

// The row's sums of each of kM values over the CTA's threads: across each
// warp by shuffles, then (more than one warp) across the warps through
// shared memory.  Every thread gets the sums.  Safe to call again in a
// loop: a second barrier keeps the next call's writes behind this call's
// reads.
template <int kM>
__device__ __forceinline__ void row_sum(float (&s)[kM]) {
  __shared__ float partial[kM][kMaxWarps];
#pragma unroll
  for (int m = 0; m < kM; ++m)
    for (int off = 16; off > 0; off >>= 1) s[m] += __shfl_xor_sync(repro::kFullMask, s[m], off);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int m = 0; m < kM; ++m) partial[m][threadIdx.x >> 5] = s[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    float t = 0.f;
    for (int k = 0; k < warps; ++k) t += partial[m][k];
    s[m] = t;
  }
  __syncthreads();
}

template <typename T, bool kGate, int kVpl>
__global__ void __launch_bounds__(kMaxWarps * 32)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ z, const T* __restrict__ w,
                   T* __restrict__ y, int D, float eps) {
  using V = typename Vec<T>::type;
  constexpr int kN = Vec<T>::n;
  const int nv = D / kN;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const V* xr = reinterpret_cast<const V*>(x + base);
  const V* zr = reinterpret_cast<const V*>(z + base);
  const V* wv = reinterpret_cast<const V*>(w);
  V* yr = reinterpret_cast<V*>(y + base);

  repro::grid_dependency_wait();

  V wr[kVpl], xv[kVpl], zv[kVpl];
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    const int i = threadIdx.x + j * nt;
    if (i < nv) {
      wr[j] = wv[i];
      xv[j] = xr[i];
      if constexpr (kGate) zv[j] = zr[i];
    }
  }
  float v[kVpl][kN];
  float ss[1] = {0.f};
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    if (threadIdx.x + j * nt >= nv) continue;
    unpack<T>(xv[j], v[j]);
    if constexpr (kGate) {
      float g[kN];
      unpack<T>(zv[j], g);
#pragma unroll
      for (int k = 0; k < kN; ++k) v[j][k] = gated<T>(v[j][k], g[k]);
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) ss[0] = fmaf(v[j][k], v[j][k], ss[0]);
  }
  row_sum<1>(ss);
  const float r = 1.0f / sqrtf(ss[0] / static_cast<float>(D) + eps);

#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    const int i = threadIdx.x + j * nt;
    if (i >= nv) continue;
    float g[kN];
    unpack<T>(wr[j], g);
#pragma unroll
    for (int k = 0; k < kN; ++k) v[j][k] = (v[j][k] * r) * (1.0f + g[k]);
    yr[i] = pack<T>(v[j]);
  }
}

// Rows wider than the registers hold: two passes over the row.
template <typename T, bool kGate>
__global__ void __launch_bounds__(kWideThreads)
    rmsnorm_wide_kernel(const T* __restrict__ x, const T* __restrict__ z,
                        const T* __restrict__ w, T* __restrict__ y, int D, float eps) {
  using V = typename Vec<T>::type;
  constexpr int kN = Vec<T>::n;
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const V* xr = reinterpret_cast<const V*>(x + base);
  const V* zr = reinterpret_cast<const V*>(z + base);
  const V* wv = reinterpret_cast<const V*>(w);
  V* yr = reinterpret_cast<V*>(y + base);
  const int nv = D / kN;
  repro::grid_dependency_wait();

  const auto load = [&](int i, float* v) {
    unpack<T>(xr[i], v);
    if constexpr (kGate) {
      float g[kN];
      unpack<T>(zr[i], g);
#pragma unroll
      for (int k = 0; k < kN; ++k) v[k] = gated<T>(v[k], g[k]);
    }
  };
  float ss[1] = {0.f};
  for (int i = threadIdx.x; i < nv; i += kWideThreads) {
    float v[kN];
    load(i, v);
#pragma unroll
    for (int k = 0; k < kN; ++k) ss[0] = fmaf(v[k], v[k], ss[0]);
  }
  row_sum<1>(ss);
  const float r = 1.0f / sqrtf(ss[0] / static_cast<float>(D) + eps);

  for (int i = threadIdx.x; i < nv; i += kWideThreads) {
    float v[kN], g[kN];
    unpack<T>(wv[i], g);
    load(i, v);
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = (v[k] * r) * (1.0f + g[k]);
    yr[i] = pack<T>(v);
  }
}

// The backward's per-row terms: dx from the row's sums, and the row's dw
// share dy x r.
template <int kN>
__device__ __forceinline__ void bwd_terms(const float* xf, const float* dyf, const float* wf,
                                          float r, float c, float* dx, float* dwr) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    dx[k] = r * (1.0f + wf[k]) * dyf[k] - xf[k] * c;
    dwr[k] = dyf[k] * xf[k] * r;
  }
}

// CTA b: rows b, b + gridDim.x, ...; its rows' share of dw to part[b, :].
// The next row's x and dy are loaded before this row's sums, so the CTA
// waits on memory once, not once a row.
template <typename T, int kVpl>
__global__ void __launch_bounds__(kMaxWarps * 32)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                       int rows, int D, float eps) {
  using V = typename Vec<T>::type;
  constexpr int kN = Vec<T>::n;
  const int nv = D / kN;
  const int nt = blockDim.x;
  const V* wv = reinterpret_cast<const V*>(w);

  repro::grid_dependency_wait();

  const auto load = [&](int row, V (&xv)[kVpl], V (&dv)[kVpl]) {
    const V* xr = reinterpret_cast<const V*>(x + static_cast<size_t>(row) * D);
    const V* dyr = reinterpret_cast<const V*>(dy + static_cast<size_t>(row) * D);
#pragma unroll
    for (int j = 0; j < kVpl; ++j) {
      const int i = threadIdx.x + j * nt;
      if (i < nv) {
        xv[j] = xr[i];
        dv[j] = dyr[i];
      }
    }
  };
  V xv[kVpl], dv[kVpl], wr[kVpl];
#pragma unroll
  for (int j = 0; j < kVpl; ++j)
    if (threadIdx.x + j * nt < nv) wr[j] = wv[threadIdx.x + j * nt];
  load(blockIdx.x, xv, dv);
  float wf[kVpl][kN], acc[kVpl][kN];
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    if (threadIdx.x + j * nt < nv) unpack<T>(wr[j], wf[j]);
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[j][k] = 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    V xn[kVpl], dn[kVpl];
    if (row + static_cast<int>(gridDim.x) < rows) load(row + gridDim.x, xn, dn);
    float xf[kVpl][kN], df[kVpl][kN];
    float s[2] = {0.f, 0.f};  // sum x^2, sum dy (1 + w) x
#pragma unroll
    for (int j = 0; j < kVpl; ++j) {
      if (threadIdx.x + j * nt >= nv) continue;
      unpack<T>(xv[j], xf[j]);
      unpack<T>(dv[j], df[j]);
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        s[0] = fmaf(xf[j][k], xf[j][k], s[0]);
        s[1] = fmaf(df[j][k] * (1.0f + wf[j][k]), xf[j][k], s[1]);
      }
    }
    row_sum<2>(s);
    const float r = 1.0f / sqrtf(s[0] / static_cast<float>(D) + eps);
    const float c = r * r * r * s[1] / static_cast<float>(D);
    V* dxr = reinterpret_cast<V*>(dx + static_cast<size_t>(row) * D);
#pragma unroll
    for (int j = 0; j < kVpl; ++j) {
      const int i = threadIdx.x + j * nt;
      if (i >= nv) continue;
      float out[kN], share[kN];
      bwd_terms<kN>(xf[j], df[j], wf[j], r, c, out, share);
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[j][k] += share[k];
      dxr[i] = pack<T>(out);
      xv[j] = xn[j];
      dv[j] = dn[j];
    }
  }
  float4* pr = reinterpret_cast<float4*>(part + static_cast<size_t>(blockIdx.x) * D);
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    const int i = threadIdx.x + j * nt;
    if (i >= nv) continue;
#pragma unroll
    for (int q = 0; q < kN / 4; ++q)
      pr[i * (kN / 4) + q] = make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                                         acc[j][4 * q + 3]);
  }
}

// Wide rows: two passes over each row; the CTA's dw share accumulates in its
// own row of the workspace (written by its first row, then read and
// rewritten by the same thread: no other CTA touches it).
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ part, int rows, int D, float eps) {
  using V = typename Vec<T>::type;
  constexpr int kN = Vec<T>::n;
  const int nv = D / kN;
  const V* wv = reinterpret_cast<const V*>(w);
  float* pr = part + static_cast<size_t>(blockIdx.x) * D;
  repro::grid_dependency_wait();

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * D;
    const V* xr = reinterpret_cast<const V*>(x + base);
    const V* dyr = reinterpret_cast<const V*>(dy + base);
    float s[2] = {0.f, 0.f};
    for (int i = threadIdx.x; i < nv; i += kWideThreads) {
      float xf[kN], df[kN], wf[kN];
      unpack<T>(xr[i], xf);
      unpack<T>(dyr[i], df);
      unpack<T>(wv[i], wf);
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        s[0] = fmaf(xf[k], xf[k], s[0]);
        s[1] = fmaf(df[k] * (1.0f + wf[k]), xf[k], s[1]);
      }
    }
    row_sum<2>(s);
    const float r = 1.0f / sqrtf(s[0] / static_cast<float>(D) + eps);
    const float c = r * r * r * s[1] / static_cast<float>(D);
    V* dxr = reinterpret_cast<V*>(dx + base);
    const bool first = row == static_cast<int>(blockIdx.x);
    for (int i = threadIdx.x; i < nv; i += kWideThreads) {
      float xf[kN], df[kN], wf[kN], out[kN], share[kN];
      unpack<T>(xr[i], xf);
      unpack<T>(dyr[i], df);
      unpack<T>(wv[i], wf);
      bwd_terms<kN>(xf, df, wf, r, c, out, share);
      dxr[i] = pack<T>(out);
      float* p = pr + static_cast<size_t>(i) * kN;
#pragma unroll
      for (int k = 0; k < kN; ++k) p[k] = first ? share[k] : p[k] + share[k];
    }
  }
}

// dw[d] = sum over the workspace's G rows, rounded once.  A CTA takes
// kDwCols groups of 4 columns; its kDwSlices thread rows each sum the
// workspace rows s, s + kDwSlices, ... in order, then thread row 0 sums the
// slices in order: a fixed order, whatever runs first.
template <typename T>
__global__ void __launch_bounds__(kDwCols * kDwSlices)
    rmsnorm_dw_kernel(const float* __restrict__ part, T* __restrict__ dw, int G, int D) {
  __shared__ float4 slice[kDwSlices][kDwCols];
  repro::grid_dependency_wait();
  const int c = threadIdx.x % kDwCols, sl = threadIdx.x / kDwCols;
  const int q = blockIdx.x * kDwCols + c;  // a group of 4 columns
  const bool live = 4 * q < D;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const float4* p = reinterpret_cast<const float4*>(part) + q;
#pragma unroll 4
    for (int g = sl; g < G; g += kDwSlices) {
      const float4 v = p[static_cast<size_t>(g) * (D / 4)];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  slice[sl][c] = s;
  __syncthreads();
  if (sl != 0 || !live) return;
  for (int k = 1; k < kDwSlices; ++k) {
    const float4 v = slice[k][c];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  dw[4 * q] = repro::from_f32<T>(s.x);
  dw[4 * q + 1] = repro::from_f32<T>(s.y);
  dw[4 * q + 2] = repro::from_f32<T>(s.z);
  dw[4 * q + 3] = repro::from_f32<T>(s.w);
}

// The one-pass kernels' shape for a row of nv vectors, lanes aiming at
// `target` vectors: (warps, vectors a lane: 1 or 2), or (0, 0) when the row
// needs the two-pass kernel.
struct Shape {
  int warps, vpl;
};
Shape row_shape(int nv, int target) {
  if (nv > kRegVectors) return {0, 0};
  const int fewest = (nv + 32 * kMaxVpl - 1) / (32 * kMaxVpl);  // in [1, kMaxWarps]
  int warps = (nv + 32 * target - 1) / (32 * target);
  warps = warps < fewest ? fewest : warps > kMaxWarps ? kMaxWarps : warps;
  return {warps, (nv + 32 * warps - 1) / (32 * warps)};
}

template <typename T, bool kGate>
cudaError_t launch_fwd(const void* x, const void* z, const void* w, void* y, int rows, int D,
                       float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* zp = static_cast<const T*>(z);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  const Shape s = row_shape(D / Vec<T>::n, rows >= kManyRows ? kManyVecTarget : kVecTarget);
  const dim3 grid(rows), block(32 * s.warps);
  switch (s.vpl) {
    case 0:
      return repro::launch_pdl(rmsnorm_wide_kernel<T, kGate>, grid, dim3(kWideThreads), st, xp,
                               zp, wp, yp, D, eps);
    case 1:
      return repro::launch_pdl(rmsnorm_kernel<T, kGate, 1>, grid, block, st, xp, zp, wp, yp, D,
                               eps);
    default:
      return repro::launch_pdl(rmsnorm_kernel<T, kGate, kMaxVpl>, grid, block, st, xp, zp, wp,
                               yp, D, eps);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                       void* part, int rows, int D, float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  const int G = rows < kBwdBlocks ? rows : kBwdBlocks;
  const Shape s = row_shape(D / Vec<T>::n, kBwdVecTarget);
  const dim3 grid(G), block(32 * s.warps);
  cudaError_t err;
  switch (s.vpl) {
    case 0:
      err = repro::launch_pdl(rmsnorm_bwd_wide_kernel<T>, grid, dim3(kWideThreads), st, xp, wp,
                              dyp, dxp, pp, rows, D, eps);
      break;
    case 1:
      err = repro::launch_pdl(rmsnorm_bwd_kernel<T, 1>, grid, block, st, xp, wp, dyp, dxp, pp,
                              rows, D, eps);
      break;
    default:
      err = repro::launch_pdl(rmsnorm_bwd_kernel<T, kMaxVpl>, grid, block, st, xp, wp, dyp, dxp,
                              pp, rows, D, eps);
  }
  if (err != cudaSuccess) return err;
  const int groups = D / 4;
  return repro::launch_pdl(rmsnorm_dw_kernel<T>, dim3((groups + kDwCols - 1) / kDwCols),
                           dim3(kDwCols * kDwSlices), st, static_cast<const float*>(part),
                           static_cast<T*>(dw), G, D);
}

}  // namespace

// dtype: repro::kF32 or repro::kBF16 (x, the gate, w and y share it).  gate:
// null for the plain norm, else z of x's shape.  D must be a multiple of 16
// bytes' worth of elements and every pointer 16-byte aligned (the wrapper
// checks both).  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* gate, const void* w, void* y, int rows,
                           int D, float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kBF16)
    err = gate ? launch_fwd<__nv_bfloat16, true>(x, gate, w, y, rows, D, eps, st)
               : launch_fwd<__nv_bfloat16, false>(x, gate, w, y, rows, D, eps, st);
  else
    err = gate ? launch_fwd<float, true>(x, gate, w, y, rows, D, eps, st)
               : launch_fwd<float, false>(x, gate, w, y, rows, D, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Rows of the backward's f32 workspace for T rows (its columns: D).
extern "C" int rmsnorm_bwd_blocks(int rows) { return rows < kBwdBlocks ? rows : kBwdBlocks; }

// dx [T, D] and dw [D] (x's dtype) for dy [T, D]; part: rmsnorm_bwd_blocks(T)
// x D f32, 16-byte aligned.  Two launches: the rows, then dw's sum over the
// workspace.  Returns cudaGetLastError().
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                           void* part, int rows, int D, float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == repro::kBF16
          ? launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, part, rows, D, eps, st)
          : launch_bwd<float>(x, w, dy, dx, dw, part, rows, D, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
