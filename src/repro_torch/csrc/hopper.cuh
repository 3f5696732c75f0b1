// Hopper (sm_90a) building blocks shared by the port's TMA / wgmma kernels:
// mbarriers (local and cluster-wide), TMA tensor-map loads (multicast too)
// and stores, wgmma descriptors, the bf16 m64n128k16 and m64n64k16
// instructions with both operands in shared memory (either K- or MN-major)
// and m64n64k16 with A in registers, cluster and named barriers and register
// rebalancing, in
// inline PTX; and, on the host, tensor-map encoding through the driver entry
// point that the CUDA runtime hands out, so a library that includes this
// header still links without -lcuda.
//
// Shared-memory tiles use the 128-byte swizzle that TMA writes and wgmma
// reads: rows of 128 bytes, the 16-byte chunk index XORed with (row % 8), so
// every tile starts on a 1024-byte boundary.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace hopper {

// An mbarrier wait that has not completed after this long traps: the launch
// fails with an error instead of hanging the card.
constexpr uint64_t kWatchdogNs = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  The spin is one
// PTX loop (no branch for the compiler to see as divergent around wgmma);
// it traps after kWatchdogNs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, %2;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "l"(kWatchdogNs)
      : "memory");
}

// If `pred`, arrive once on this CTA's barrier; predicated in PTX.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// If `pred`, arrive on the barrier at the same shared-memory offset in
// cluster CTA `cta` (this CTA included); predicated in PTX, not branched.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 remote;\n"
      "setp.ne.u32 p, %2, 0;\n"
      "@p mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta), "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// --- thread-block clusters --------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every non-exited thread of the cluster arrives, then waits for the rest;
// shared-memory writes before it are visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// --- TMA ------------------------------------------------------------------

// box of `map` at (c0, c1, c2) (innermost first) -> smem `dst`; completion
// counted in bytes on `bar`.  Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same load delivered to the same smem offset in every cluster CTA of
// `cta_mask`, each completing bytes on its own barrier at offset `bar`.
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, uint16_t cta_mask, int c0,
                                                      int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(cta_mask), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// smem `src` -> box of `map` at (c0, c1, c2); elements outside the tensor
// are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// The same store if `pred`, predicated in PTX (no branch).
__device__ __forceinline__ void tma_store_3d_if(const CUtensorMap* map, uint32_t src, int c0,
                                                int c1, int c2, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(static_cast<uint32_t>(pred))
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until every committed store has finished reading shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to TMA / wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// 16 zero bytes to smem `addr` if `pred`, predicated in PTX (no branch).
__device__ __forceinline__ void st_shared_zero16_if(uint32_t addr, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p st.shared.v4.b32 [%0], {%2, %2, %2, %2};\n"
      "}\n" ::"r"(addr),
      "r"(static_cast<uint32_t>(pred)), "r"(0)
      : "memory");
}

// --- warp specialisation --------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// Barrier `id` (1-15; 0 is __syncthreads) among `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// If `pred`, arrive on barrier `id` (of `threads` threads) without waiting;
// predicated in PTX.
__device__ __forceinline__ void named_bar_arrive_if(int id, int threads, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %2, 0;\n"
      "@p bar.arrive %0, %1;\n"
      "}\n" ::"r"(id),
      "r"(threads), "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand tile at smem address `addr`
// (1024-byte aligned atoms).  K-major: rows of 64 K-elements, `sbo` bytes
// between 8-row groups (`lbo` unused).  MN-major: rows of 64 MN-elements,
// one row per K index; `sbo` bytes between 8-row (K) groups, `lbo` bytes
// between 64-element MN blocks.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma that reads and writes them.
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d[64] (f32, per thread of the warpgroup) += A (64 x 16; K-major, or
// kTransA: MN-major) * B (16 x 128; K-major, or kTransB: MN-major).  Thread t
// of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2)
// and columns 8 (i / 4) + 2 (t % 4) + i % 2 of d[i].  scale_d = 0 drops d's
// old value (d = A * B).
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(kTransA), "n"(kTransB), "r"(scale_d));
}

// d[32] (f32) = A (64 x 16; K-major, or kTransA: MN-major) * B (16 x 64;
// K-major, or kTransB: MN-major) + (scale_d ? d : 0), both from shared
// memory.  d[i] sits at the row and column that m64n128k16 gives it.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t desc_a,
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d[32] (f32) += A (64 x 16, bf16 in registers) * B (16 x 64 from shared
// memory; K-major, or kTransB: MN-major).  a[r] packs two bf16 (the lower
// column in the low half) of A's rows 16 (t / 32) + (t % 32) / 4 + 8 (r % 2),
// columns 8 (r / 2) + 2 (t % 4) + {0, 1}: the places where a 16-column slice
// kk of an f32 accumulator keeps its values d[8 kk + 2 r], d[8 kk + 2 r + 1]
// (PTX ISA, wgmma register fragments for A and D), so an accumulator converts
// to an A operand in place.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs_bf16(float (&d)[32], const uint32_t (&a)[4],
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(kTransB));
}

// --- host: tensor maps ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; null if absent.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map over the row-major 3-D tensor at `ptr` with dims
// {d0, d1, d2} (d0 contiguous), read and written in boxes {b0, b1, 1} with
// the 128-byte swizzle (b0 * 2 must be 128).  Returns 0, or nonzero when the
// driver refuses (alignment, strides, box).
//
// cuTensorMapEncodeTiled encodes against the calling thread's current
// context, and a thread that has not yet used the runtime has none (PyTorch
// runs backward functions on such a worker thread): cudaFree(nullptr) first
// binds the runtime's primary context of the current device, the one the
// launch uses.
inline int bf16_map_3d(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                       uint32_t b0, uint32_t b1) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -3;
  if (cudaFree(nullptr) != cudaSuccess) return -5;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}

}  // namespace hopper
}  // namespace repro
