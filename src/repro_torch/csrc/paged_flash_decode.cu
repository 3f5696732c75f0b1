// Decode / chunk-continuation attention through the paged KV pool.
//
// Replaces: src/repro/kernels/flash_attention.py, paged_flash_decode_pallas
// (_paged_decode_kernel): q [B, C, Hq, D] against pools [N, page, Hkv, D]
// read through page_table [B, P] (-1 = unallocated) and lengths [B]; chunk
// row c attends positions <= t + c; sliding window and tanh softcap.
//
// What bounds it on an H100: memory.  Each query row does 4 * D FLOP per
// cached position while the position's K and V cost 2 * 2 * D bytes per kv
// head, far below the 295 FLOP/byte ridge: the time is the K/V bytes over
// 3.35 TB/s (plus launch latency at grok-1's few-KB decode shapes).
//
// Design: one 256-thread block per (b, kv head).  The block serves all
// group * C query rows of that kv head (row = c * group + g), so each K/V
// page is read from device memory once per kv head — the Pallas grid
// (B, Hq, P) read it once per q head, group (6 for grok-1) times over.
// Eight threads share a row (D/8 dims each, interleaved), 32 rows per
// pass; more rows loop inside the block.  The block walks the row's table
// only up to page (t + C - 1) // page (and from the window's first page),
// skipping -1 entries; each page is staged in shared memory as f32 and
// folded into the running max / sum / f32 accumulators (IEEE expf and
// tanhf, no fast math).  Any C >= 1: the Pallas wrapper's C=2 -> 4 padding
// existed only for XLA's contraction choice.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                  // threads per query row
constexpr int kRows = kThreads / kLanes;   // query rows per pass

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool, const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out, int C, int Hq,
                        int Hkv, int page, int P, float scale, int window, float softcap) {
  constexpr int DPL = D / kLanes;
  extern __shared__ float sm[];
  const int sstride = page + 1;
  float* Ks = sm;                 // [page][D]
  float* Vs = Ks + page * D;      // [page][D]
  float* Ss = Vs + page * D;      // [kRows][page + 1]

  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int R = group * C;
  const int t = lengths[b];
  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int part = tid % kLanes;

  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int row = r0 + r;
    const bool row_ok = row < R;
    const int c = row_ok ? row / group : 0;
    const int hq = kvh * group + (row_ok ? row % group : 0);
    const int qpos = t + c;
    const T* qrow = q + ((static_cast<size_t>(b) * C + c) * Hq + hq) * D;

    float qr[DPL];
    float acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[i] = row_ok ? repro::to_f32(qrow[part + kLanes * i]) * scale : 0.f;
      acc[i] = 0.f;
    }
    float m = repro::kNegBig;
    float l = 0.f;

    const int c_lo = r0 / group;
    const int c_hi = min(R - 1, r0 + kRows - 1) / group;
    const int last = min(P - 1, (t + c_hi) / page);
    const int first = window > 0 ? max(0, t + c_lo - window + 1) / page : 0;
    for (int p = first; p <= last; ++p) {
      const int pid = table[static_cast<size_t>(b) * P + p];
      if (pid < 0) continue;  // unallocated: uniform across the block
      __syncthreads();        // the previous page is fully consumed
      for (int idx = tid; idx < page * D; idx += kThreads) {
        const int j = idx / D;
        const size_t g = ((static_cast<size_t>(pid) * page + j) * Hkv + kvh) * D + idx % D;
        Ks[idx] = repro::to_f32(k_pool[g]);
        Vs[idx] = repro::to_f32(v_pool[g]);
      }
      __syncthreads();

      float mt = repro::kNegBig;
      for (int j = 0; j < page; ++j) {
        const float* kr = Ks + j * D + part;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) s = fmaf(qr[i], kr[kLanes * i], s);
        s += __shfl_xor_sync(repro::kFullMask, s, 1);
        s += __shfl_xor_sync(repro::kFullMask, s, 2);
        s += __shfl_xor_sync(repro::kFullMask, s, 4);
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int kpos = p * page + j;
        const bool valid = row_ok && kpos <= qpos && (window <= 0 || qpos - kpos < window);
        if ((j & (kLanes - 1)) == part) Ss[r * sstride + j] = valid ? s : -INFINITY;
        if (valid) mt = fmaxf(mt, s);
      }
      __syncwarp();

      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
      float ps = 0.f;
      for (int j = 0; j < page; ++j) {
        const float s = Ss[r * sstride + j];
        const float pj = s == -INFINITY ? 0.f : expf(s - m_new);
        ps += pj;
        const float* vr = Vs + j * D + part;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, vr[kLanes * i], acc[i]);
      }
      l = l * alpha + ps;
      m = m_new;
    }

    if (row_ok) {
      T* orow = out + ((static_cast<size_t>(b) * C + c) * Hq + hq) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        orow[part + kLanes * i] = repro::from_f32<T>(l > 0.f ? acc[i] / l : 0.f);
    }
    __syncthreads();  // Ss rows are reused by the next pass
  }
}

size_t smem_bytes(int page, int D) {
  return (2 * static_cast<size_t>(page) * D + static_cast<size_t>(kRows) * (page + 1)) *
         sizeof(float);
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* table, const void* lengths,
           void* out, int B, int C, int Hq, int Hkv, int page, int P, float scale, int window,
           float softcap, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, D>;
  const size_t smem = smem_bytes(page, D);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(table), static_cast<const int*>(lengths), static_cast<T*>(out), C,
      Hq, Hkv, page, P, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* kp, const void* vp, const void* table,
             const void* lengths, void* out, int B, int C, int Hq, int Hkv, int page, int P,
             float scale, int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, kp, vp, table, lengths, out, B, C, Hq, Hkv, page, P, scale, window,
                           softcap, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, table, lengths, out, B, C, Hq, Hkv, page, P, scale,
                            window, softcap, stream);
    case 256:
      return launch<T, 256>(q, kp, vp, table, lengths, out, B, C, Hq, Hkv, page, P, scale,
                            window, softcap, stream);
    default:
      return -1;
  }
}

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap.
extern "C" int paged_flash_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* table, const void* lengths, void* out, int dtype,
                                  int B, int C, int Hq, int Hkv, int page, int P, int D,
                                  float scale, int window, float softcap, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, table, lengths, out, B, C, Hq, Hkv,
                                   page, P, scale, window, softcap, st);
  if (dtype == repro::kF32)
    return launch_d<float>(D, q, k_pool, v_pool, table, lengths, out, B, C, Hq, Hkv, page, P,
                           scale, window, softcap, st);
  return -2;
}
