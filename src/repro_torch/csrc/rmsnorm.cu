// Fused RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (1 + w), f32 math,
// rounded once to x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (_rmsnorm_kernel):
// a (bt x D) token tile in VMEM, one read and one write of x per norm.
//
// What bounds it on an H100: memory, and at decode the launch.  Mamba-2
// 1.3B applies it twice a layer: norm1 over [T, 2048] and the gated norm
// over [T, 4096] bf16, T = the prompt at prefill, the live slots at decode.
// At [256, 4096] bf16 the bytes (x in, y out, w) are 4.2 MB, ~1.3 us at
// 3.35 TB/s; at [4, 2048] the kernel is its launch.
//
// Design: one block of 256 threads per row; any T (the Pallas kernel needs
// a tile that divides T).  Each thread loads up to 4 16-byte vectors of the
// row (8 bf16 or 4 f32; D must be a multiple of that, and D <= 1024
// vectors: 8192 bf16 or 4096 f32) into registers, all loads issued before
// any is used, so a row costs one memory latency and not one per vector.
// Squares are summed in f32, then across the warp by shuffles and across
// the block through shared memory.  The output reuses the registers:
// (x * r) * (1 + w) in f32 in the reference's order, rounded once.  The sum
// runs in another order than the plain version's mean, so results agree to
// f32 rounding before the final cast.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // vectors a thread holds

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int D,
                   float eps) {
  using V = typename Vec<T>::type;
  constexpr int kN = Vec<T>::n;
  __shared__ float partial[kThreads / 32];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const V* xr = reinterpret_cast<const V*>(x + static_cast<size_t>(row) * D);
  const V* wv = reinterpret_cast<const V*>(w);
  V* yr = reinterpret_cast<V*>(y + static_cast<size_t>(row) * D);
  const int nv = D / kN;

  V xv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < nv) xv[j] = xr[i];
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (threadIdx.x + j * kThreads >= nv) continue;
    float v[kN];
    unpack<T>(xv[j], v);
#pragma unroll
    for (int k = 0; k < kN; ++k) ss = fmaf(v[k], v[k], ss);
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(repro::kFullMask, ss, off);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) total += partial[k];
  const float r = 1.0f / sqrtf(total / static_cast<float>(D) + eps);

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i >= nv) continue;
    float v[kN], g[kN];
    unpack<T>(xv[j], v);
    unpack<T>(wv[i], g);
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = (v[k] * r) * (1.0f + g[k]);
    yr[i] = pack<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int D, float eps, void* stream) {
  if (D / Vec<T>::n > kThreads * kPer) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_kernel<T><<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: repro::kF32 or repro::kBF16 (x, w and y share it).  D must be a
// multiple of 16 bytes' worth of elements, at most 1024 such vectors, and
// every pointer 16-byte aligned (the wrapper checks all three).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int rows, int D, float eps,
                           int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(x, w, y, rows, D, eps, stream);
  return launch<float>(x, w, y, rows, D, eps, stream);
}
