// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C entry point (loaded with
// ctypes by repro_torch/kernels/build.py): pointers and the stream arrive as
// void*, and the entry point returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;
// Initial running max of the streaming softmax, as the Pallas kernels use.
constexpr float kNegBig = -1e30f;

// dtype codes passed by the wrappers.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// cp.async of `bytes` (4, 8 or 16) from global `src` to shared `dst`,
// zero-filled where `pred` is false (nothing is read then).  Completion is
// per thread, in commit groups: cp_async_commit(), then
// cp_async_wait<n>() until at most n of this thread's groups are in flight.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Programmatic dependent launch, device side: wait until the kernel before
// this one in the stream has finished and its writes are visible.  A no-op
// for a kernel launched without the attribute.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch `kernel` on `st` with programmatic stream serialization: the grid
// may be scheduled while the preceding kernel drains, and must call
// grid_dependency_wait() before it reads what that kernel writes or writes
// anything.
template <typename... KArgs, typename... Args>
inline cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block, cudaStream_t st,
                              Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
