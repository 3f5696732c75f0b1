// Decode / chunk-continuation attention through the paged KV pool.
//
// Replaces: src/repro/kernels/flash_attention.py, paged_flash_decode_pallas
// (_paged_decode_kernel): q [B, C, Hq, D] against pools [N, page, Hkv, D]
// read through page_table [B, P] (-1 = unallocated: read as page 0, as the
// Pallas kernel's index map and the plain version do; callers mask those
// positions) and lengths [B]; chunk row c attends positions <= t + c;
// sliding window and tanh softcap.
//
// What bounds it on an H100: memory, and at short contexts latency.  Each
// query row does 4 * D FLOP per cached position while the position's K and
// V cost 2 * 2 * D bytes per kv head (bf16), far below the 295 FLOP/byte
// ridge: the time is the K/V bytes over 3.35 TB/s, plus the launch and one
// DRAM round trip when the context is a few pages.
//
// Design (flash-decoding):
// * Split the context across CTAs.  A CTA serves one (b, kv head, block of
//   8 query rows; row = c * group + g) over one span of the page table;
//   the spans of a (b, kv head, row block) are one thread-block cluster.
//   The number of splits is a function of the table's width P alone: one
//   for every 8 pages, at most 8 (the portable cluster size).  Page p of a
//   row's table always goes to the same split and the same warp, whatever
//   B, C or the lengths are, and a page that is masked for a row (past its
//   position, before its window) leaves that row's partial exactly as it
//   was.  So a row's result is a function of its own query, position and
//   pages: a verify pass over C = k + 1 rows gives each row the bits a
//   one-row decode tick gives it, and the serve's tokens are bit-identical
//   across runs, batch sizes and with reconfiguration on and off.
// * Inside a CTA, warp w walks pages pb + w, pb + w + 4, ... of its split's
//   span (pb the span's first page), skipping those before the block's
//   window and past the page of its last row's position; a span past them
//   leaves an empty partial, which merges as an exact zero (its max is
//   -1e30, so its weight expf(-1e30 - M) is 0).  Each warp loads its pages itself (16-byte cp.async,
//   bf16 kept as bf16 in shared memory; one page in flight a warp: more
//   CTAs an SM measured faster than a ring of two or three pages) and
//   serves all 8 rows from one read of each page, with the running max /
//   sum / f32 accumulator updated once a tile of keys (IEEE expf and
//   tanhf, no fast math).
// * bf16 on the tensor cores (mma.sync m16n8k16), with keys as the rows:
//   S^T [16 keys x 8 rows] = K q^T from ldmatrix'd K and q in registers,
//   the scale and softcap on the f32 scores, and O^T [D x 8] += V^T P^T
//   from ldmatrix.trans'd V.  P^T goes in as a bf16 high part plus a bf16
//   residual (two products, 16 bits of P's mantissa), moved into the
//   operand layout by movmatrix; every sum is f32, as on CUDA cores.
// * f32 on CUDA cores: lane (r, h) holds row r's q and its accumulator at
//   the D / 4 dims of 16-byte chunks h, h + 4, ...; a score is a 4-lane
//   sum, four keys at a time, and the page's scores go through shared
//   memory.
// * Merge in a fixed order: every warp leaves (max, sum, f32 accumulator)
//   in shared memory; after a cluster barrier CTA k of the cluster takes
//   the k-th slice of D and reduces the partials of every CTA (distributed
//   shared memory), in rank order, then warp order, and writes the output.
//   No atomics: two calls on the same input are bit-identical.
// * Any C >= 1 (the Pallas wrapper's C=2 -> 4 padding existed only for
//   XLA's contraction choice); D a multiple of 32 up to 256 (the wrapper
//   zero-pads other multiples of 8); bf16 or f32.
#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;         // query rows a CTA serves
constexpr int kParts = 4;        // lanes a row (CUDA cores)
constexpr int kTok = 4;          // keys whose scores are taken together (CUDA cores)
constexpr int kMaxSplits = 8;    // portable cluster size
constexpr int kSplitPages = 8;   // pages of the table a split (the split count's rule)
constexpr size_t kSmemMax = 232448;

// Shared memory: each warp's K and V page (rows of `rs` elements) and its
// scores, then every warp's partials.
size_t smem_bytes(int page, int rs, size_t elem) {
  const size_t warp_bytes =
      static_cast<size_t>(2) * page * rs * elem + page * kRows * sizeof(float);
  return kWarps * warp_bytes + kWarps * kRows * (2 + static_cast<size_t>(rs)) * sizeof(float);
}

__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// ---- bf16 tensor-core helpers ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// ---- what both kernels share ---------------------------------------------------

// The CTA's place: split (cluster rank), kv head, row block, batch row, and
// its pages: warp w takes pages pb + w + 4 i of its split's span for i in
// [i0, mine), the ones within the block's window and up to the page of its
// last row's position.  pb depends on the split alone, so which warp reads a
// page never depends on the block's rows.
struct Span {
  int split, splits, kvh, rb, b, group, R, t, pb, i0, mine;
};

__device__ __forceinline__ Span cta_span(const int* __restrict__ lengths, int C, int Hq, int Hkv,
                                         int page, int P, int pps, int window) {
  Span s;
  s.split = blockIdx.x, s.splits = gridDim.x;
  s.kvh = blockIdx.y % Hkv, s.rb = blockIdx.y / Hkv, s.b = blockIdx.z;
  s.group = Hq / Hkv, s.R = s.group * C;
  s.t = lengths[s.b];
  const int c_lo = (s.rb * kRows) / s.group;
  const int c_hi = min(s.R - 1, s.rb * kRows + kRows - 1) / s.group;
  const int last = min(P - 1, (s.t + c_hi) / page);
  const int first = window > 0 ? max(0, s.t + c_lo - window + 1) / page : 0;
  s.pb = s.split * pps;
  const int pe = min(last + 1, (s.split + 1) * pps);
  const int warp = threadIdx.x / 32;
  const int lo = first - s.pb - warp;  // the warp's pages before the window
  s.i0 = lo > 0 ? (lo + kWarps - 1) / kWarps : 0;
  s.mine = pe - s.pb - warp > 0 ? (pe - s.pb - warp + kWarps - 1) / kWarps : 0;
  return s;
}

// This warp's i-th page of K and V -> its buffers ks and vs (rows of `rs`
// elements), then wait for it; -1 reads page 0, as the plain version does.
template <typename T, int D>
__device__ __forceinline__ void load_page(T* ks, T* vs, const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool,
                                          const int* __restrict__ table, const Span& s, int i,
                                          int page, int P, int Hkv, int rs) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kRowChunks = D / E;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int p = s.pb + warp + kWarps * i;
  const int pid = max(table[static_cast<size_t>(s.b) * P + p], 0);
  for (int e = lane; e < page * kRowChunks; e += 32) {
    const int j = e / kRowChunks, ch = e % kRowChunks;
    const size_t src = ((static_cast<size_t>(pid) * page + j) * Hkv + s.kvh) * D + ch * E;
    repro::cp_async<16>(ks + j * rs + ch * E, k_pool + src, true);
    repro::cp_async<16>(vs + j * rs + ch * E, v_pool + src, true);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncwarp();  // every lane's copies of the page are visible
}

// After every warp of the cluster left (max, sum, accumulator) for its rows
// in pm / pl / pacc: CTA `split` reduces dims [split * slice, ...) of the
// block's rows over the cluster's partials, rank order, then warp order,
// and writes them.
template <typename T, int D>
__device__ __forceinline__ void merge_and_store(cg::cluster_group& cluster, float* pm, float* pl,
                                                float* pacc, T* __restrict__ out, const Span& s,
                                                int C, int Hq) {
  cluster.sync();  // every CTA's partials are in
  const int slice = (D + s.splits - 1) / s.splits;
  const int d_lo = s.split * slice, d_hi = min(D, d_lo + slice);
  for (int e = threadIdx.x; e < kRows * slice; e += kThreads) {
    const int rr = e / slice, d = d_lo + e % slice;
    const int orow = s.rb * kRows + rr;
    if (d >= d_hi || orow >= s.R) continue;
    float M = repro::kNegBig;
    for (int k = 0; k < s.splits; ++k) {
      const float* rpm = cluster.map_shared_rank(pm, k);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, rpm[w * kRows + rr]);
    }
    float lsum = 0.f, a = 0.f;
    for (int k = 0; k < s.splits; ++k) {
      const float* rpm = cluster.map_shared_rank(pm, k);
      const float* rpl = cluster.map_shared_rank(pl, k);
      const float* rpa = cluster.map_shared_rank(pacc, k);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(rpm[w * kRows + rr] - M);
        lsum = fmaf(rpl[w * kRows + rr], f, lsum);
        a = fmaf(rpa[static_cast<size_t>(w * kRows + rr) * D + d], f, a);
      }
    }
    const int oc = orow / s.group, ohq = s.kvh * s.group + orow % s.group;
    out[((static_cast<size_t>(s.b) * C + oc) * Hq + ohq) * D + d] =
        repro::from_f32<T>(lsum > 0.f ? a / lsum : 0.f);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// ---- bf16: tensor cores ----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_pool,
                            const __nv_bfloat16* __restrict__ v_pool,
                            const int* __restrict__ table, const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out, int C, int Hq, int Hkv, int page,
                            int P, int pps, float scale, int window, float softcap) {
  using T = __nv_bfloat16;
  constexpr int RS = D + 8;  // padded rows: conflict-free ldmatrix
  constexpr int KS = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Span s = cta_span(lengths, C, Hq, Hkv, page, P, pps, window);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;

  T* ks = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 2 * page * RS;
  T* vs = ks + static_cast<size_t>(page) * RS;
  float* pm = reinterpret_cast<float*>(reinterpret_cast<T*>(smem_raw) +
                                       static_cast<size_t>(kWarps) * 2 * page * RS) +
              kWarps * page * kRows;
  float* pl = pm + kWarps * kRows;
  float* pacc = pl + kWarps * kRows;

  // Rows 2qd and 2qd + 1 of the block: this thread's columns of S^T and O^T.
  int qpos[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = s.rb * kRows + 2 * qd + i;
    rok[i] = row < s.R;
    qpos[i] = s.t + (rok[i] ? row / s.group : 0);
  }
  // q as the B operand of S^T = K q^T: row g, dims 2qd, 2qd + 1 (+ 8) of
  // each 16-dim step.
  uint32_t qf[KS][2];
  {
    const int row = s.rb * kRows + g;
    const bool ok = row < s.R;
    const int c = ok ? row / s.group : 0;
    const int hq = s.kvh * s.group + (ok ? row % s.group : 0);
    const T* qrow = q + ((static_cast<size_t>(s.b) * C + c) * Hq + hq) * D;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      qf[k][0] = ok ? *reinterpret_cast<const uint32_t*>(qrow + k * 16 + 2 * qd) : 0u;
      qf[k][1] = ok ? *reinterpret_cast<const uint32_t*>(qrow + k * 16 + 8 + 2 * qd) : 0u;
    }
  }

  float o[KS][4];
#pragma unroll
  for (int k = 0; k < KS; ++k) o[k][0] = o[k][1] = o[k][2] = o[k][3] = 0.f;
  float m[2] = {repro::kNegBig, repro::kNegBig}, l[2] = {0.f, 0.f};

  for (int i = s.i0; i < s.mine; ++i) {
    load_page<T, D>(ks, vs, k_pool, v_pool, table, s, i, page, P, Hkv, RS);
    const int p = s.pb + warp + kWarps * i;

    for (int j0 = 0; j0 < page; j0 += 16) {  // tiles of 16 keys; rows past the page repeat its last
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const int krow = min(j0 + (lane & 7) + ((lane >> 3) & 1) * 8, page - 1);
        const T* kp = ks + krow * RS + (lane >> 4) * 8;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          uint32_t a[4];
          ldsm_x4(a, kp + k * 16);
          mma_bf16(sc, a, qf[k][0], qf[k][1]);
        }
      }
      // sc[e]: key j0 + g (+ 8 for e >= 2), row 2qd + (e & 1).
      float tmax[2] = {repro::kNegBig, repro::kNegBig};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e & 1, j = j0 + g + (e >> 1) * 8;
        float v = sc[e] * scale;
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        const int kpos = p * page + j;
        const bool valid = rok[i2] && j < page && kpos <= qpos[i2] &&
                           (window <= 0 || qpos[i2] - kpos < window);
        sc[e] = valid ? v : -INFINITY;
        tmax[i2] = fmaxf(tmax[i2], sc[e]);
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        tmax[i2] = fmaxf(tmax[i2], __shfl_xor_sync(repro::kFullMask, tmax[i2], 4));
        tmax[i2] = fmaxf(tmax[i2], __shfl_xor_sync(repro::kFullMask, tmax[i2], 8));
        tmax[i2] = fmaxf(tmax[i2], __shfl_xor_sync(repro::kFullMask, tmax[i2], 16));
      }
      float alpha[2], pv[4];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const float m_new = fmaxf(m[i2], tmax[i2]);
        alpha[i2] = expf(m[i2] - m_new);
        m[i2] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[e] = sc[e] == -INFINITY ? 0.f : expf(sc[e] - m[e & 1]);
      float ps[2] = {pv[0] + pv[2], pv[1] + pv[3]};
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        ps[i2] += __shfl_xor_sync(repro::kFullMask, ps[i2], 4);
        ps[i2] += __shfl_xor_sync(repro::kFullMask, ps[i2], 8);
        ps[i2] += __shfl_xor_sync(repro::kFullMask, ps[i2], 16);
        l[i2] = l[i2] * alpha[i2] + ps[i2];
      }
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        o[k][0] *= alpha[0], o[k][1] *= alpha[1], o[k][2] *= alpha[0], o[k][3] *= alpha[1];
      }
      // P^T = hi + lo in bf16, each moved from the accumulator layout into
      // the B operand's by an 8 x 8 transpose.
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        const __nv_bfloat16 h0 = __float2bfloat16_rn(pv[2 * blk]);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(pv[2 * blk + 1]);
        const __nv_bfloat16 l0 = __float2bfloat16_rn(pv[2 * blk] - __bfloat162float(h0));
        const __nv_bfloat16 l1 = __float2bfloat16_rn(pv[2 * blk + 1] - __bfloat162float(h1));
        bh[blk] = movmatrix_trans(pack_bf16(h0, h1));
        bl[blk] = movmatrix_trans(pack_bf16(l0, l1));
      }
      {
        const int vrow = min(j0 + (lane & 7) + (lane >> 4) * 8, page - 1);
        const T* vp = vs + vrow * RS + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          uint32_t a[4];
          ldsm_x4_trans(a, vp + k * 16);
          mma_bf16(o[k], a, bl[0], bl[1]);
          mma_bf16(o[k], a, bh[0], bh[1]);
        }
      }
    }
    __syncwarp();  // page i's buffers are free
  }

  if (g == 0) {
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      pm[warp * kRows + 2 * qd + i2] = m[i2];
      pl[warp * kRows + 2 * qd + i2] = l[i2];
    }
  }
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pacc[static_cast<size_t>(warp * kRows + 2 * qd + (e & 1)) * D + k * 16 + g + (e >> 1) * 8] =
          o[k][e];
  merge_and_store<T, D>(cluster, pm, pl, pacc, out, s, C, Hq);
}

// ---- any dtype: CUDA cores -------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool, const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out, int C, int Hq,
                        int Hkv, int page, int P, int pps, float scale, int window,
                        float softcap) {
  constexpr int E = 16 / sizeof(T);      // elements of a 16-byte chunk
  constexpr int NC = D / (E * kParts);   // chunks a lane holds
  constexpr int DL = NC * E;             // dims a lane holds: D / 4
  static_assert(NC >= 1 && D % (E * kParts) == 0, "D must be a multiple of 32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Span s = cta_span(lengths, C, Hq, Hkv, page, P, pps, window);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / kParts, h = lane % kParts;
  const int row = s.rb * kRows + r;
  const bool row_ok = row < s.R;
  const int c = row_ok ? row / s.group : 0;
  const int hq = s.kvh * s.group + (row_ok ? row % s.group : 0);
  const int qpos = s.t + c;

  const size_t page_elems = static_cast<size_t>(page) * D;
  T* ks = reinterpret_cast<T*>(smem_raw) + warp * 2 * page_elems;
  T* vs = ks + page_elems;
  float* score_base = reinterpret_cast<float*>(reinterpret_cast<T*>(smem_raw) +
                                               kWarps * 2 * page_elems);
  float* scores = score_base + warp * page * kRows;  // [page][kRows]
  float* pm = score_base + kWarps * page * kRows;    // [kWarps][kRows] running max
  float* pl = pm + kWarps * kRows;                   // [kWarps][kRows] running sum
  float* pacc = pl + kWarps * kRows;                 // [kWarps][kRows][D] accumulator

  float qv[DL], acc[DL];
  {
    const T* qrow = q + ((static_cast<size_t>(s.b) * C + c) * Hq + hq) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      float v[E];
      load_chunk(qrow + (h + kParts * i) * E, v);
#pragma unroll
      for (int e = 0; e < E; ++e) qv[i * E + e] = row_ok ? v[e] * scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  }

  float m = repro::kNegBig, l = 0.f;
  for (int i = s.i0; i < s.mine; ++i) {
    load_page<T, D>(ks, vs, k_pool, v_pool, table, s, i, page, P, Hkv, D);
    const int p = s.pb + warp + kWarps * i;
    // Scores, kTok tokens at a time: their dot products (two partial sums
    // each) and 4-lane reductions are independent, so they overlap.
    float mt = repro::kNegBig;
    for (int j0 = 0; j0 < page; j0 += kTok) {
      float sc[kTok];
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        const T* kr = ks + min(j0 + u, page - 1) * D;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int ci = 0; ci < NC; ++ci) {
          float kv[E];
          load_chunk(kr + (h + kParts * ci) * E, kv);
#pragma unroll
          for (int e = 0; e < E; e += 2) {
            s0 = fmaf(qv[ci * E + e], kv[e], s0);
            s1 = fmaf(qv[ci * E + e + 1], kv[e + 1], s1);
          }
        }
        sc[u] = s0 + s1;
      }
#pragma unroll
      for (int u = 0; u < kTok; ++u) sc[u] += __shfl_xor_sync(repro::kFullMask, sc[u], 1);
#pragma unroll
      for (int u = 0; u < kTok; ++u) sc[u] += __shfl_xor_sync(repro::kFullMask, sc[u], 2);
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        const int j = j0 + u;
        if (j >= page) break;
        float sv = sc[u];
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        const int kpos = p * page + j;
        const bool valid = row_ok && kpos <= qpos && (window <= 0 || qpos - kpos < window);
        sv = valid ? sv : -INFINITY;
        if (h == 0) scores[j * kRows + r] = sv;
        mt = fmaxf(mt, sv);
      }
    }
    __syncwarp();

    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i2 = 0; i2 < DL; ++i2) acc[i2] *= alpha;
    l *= alpha;
#pragma unroll 4
    for (int j = 0; j < page; ++j) {
      const float s = scores[j * kRows + r];
      const float pj = s == -INFINITY ? 0.f : expf(s - m_new);
      l += pj;
      const T* vr = vs + j * D;
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) {
        float vv[E];
        load_chunk(vr + (h + kParts * ci) * E, vv);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[ci * E + e] = fmaf(pj, vv[e], acc[ci * E + e]);
      }
    }
    m = m_new;
    __syncwarp();  // page i's buffers and the scores are free
  }

  if (h == 0) {
    pm[warp * kRows + r] = m;
    pl[warp * kRows + r] = l;
  }
  {
    float* pa = pacc + static_cast<size_t>(warp * kRows + r) * D;
#pragma unroll
    for (int ci = 0; ci < NC; ++ci)
#pragma unroll
      for (int e = 0; e < E; ++e) pa[(h + kParts * ci) * E + e] = acc[ci * E + e];
  }
  merge_and_store<T, D>(cluster, pm, pl, pacc, out, s, C, Hq);
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* table, const void* lengths,
           void* out, int B, int C, int Hq, int Hkv, int page, int P, float scale, int window,
           float softcap, cudaStream_t stream) {
  // bf16 on the tensor cores, f32 on CUDA cores.
  constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  auto kernel = [] {
    if constexpr (kMma) return paged_decode_mma_kernel<D>;
    else return paged_decode_kernel<T, D>;
  }();
  const int rs = kMma ? D + 8 : D;
  const int rblocks = (Hq / Hkv * C + kRows - 1) / kRows;
  // The split is a function of P alone (see the header): never of B or C.
  int splits = max(1, min(kMaxSplits, (P + kSplitPages - 1) / kSplitPages));
  const int pps = max(1, (P + splits - 1) / splits);
  splits = max(1, (P + pps - 1) / pps);
  const size_t smem = smem_bytes(page, rs, sizeof(T));
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv * rblocks, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(kp),
                           static_cast<const T*>(vp), static_cast<const int*>(table),
                           static_cast<const int*>(lengths), static_cast<T*>(out), C, Hq, Hkv,
                           page, P, pps, scale, window, softcap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Built at every multiple of 32 up to 256 (the wrapper zero-pads any other
// multiple of 8 to the next one).
template <typename T, int D = 32>
int launch_d(int d, const void* q, const void* kp, const void* vp, const void* table,
             const void* lengths, void* out, int B, int C, int Hq, int Hkv, int page, int P,
             float scale, int window, float softcap, cudaStream_t stream) {
  if (d == D)
    return launch<T, D>(q, kp, vp, table, lengths, out, B, C, Hq, Hkv, page, P, scale, window,
                        softcap, stream);
  if constexpr (D < 256)
    return launch_d<T, D + 32>(d, q, kp, vp, table, lengths, out, B, C, Hq, Hkv, page, P, scale,
                               window, softcap, stream);
  return -1;
}

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap.  q, the pools and out
// start on 16-byte boundaries (the wrapper checks).
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
