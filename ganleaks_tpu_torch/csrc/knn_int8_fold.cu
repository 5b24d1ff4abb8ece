// The int8 argmin fold of one synthetic block ('taps-int8'), fused into one
// kernel for Hopper (sm_90a), with its merge.
//
// Replaces no Pallas kernel: the JAX package leaves its int8 dot to XLA
// (ganleaks_tpu/ops/knn.py, _fold_block_parts_q). It replaces the port's
// per-part chain (ops/knn_int8._fold_block_parts_q: one torch._int_mm per
// part, the float32 dequantise and add, the mask, the min and the running
// state's where), and gives the same bits. Given the query cache q
// (N_q x K int8), its norms rq, one synthetic block s (rows < n_valid of
// it, K int8) with norms rs, and the parts' widths and factors f_l:
//
//     cross = sum_l, in part order, float(dot_l) * f_l
//     d     = (rq[m] + rs[n]) - 2 * cross
//
// dot_l the exact int32 dot of part l, every operation rounded to nearest
// as the chain rounds it (no contraction into FMA), then the first n of the
// least d per query row, merged into the running (min, index) with strict
// '<' so earlier blocks keep ties. Nothing of size N_q x n_valid is written.
//
// Bound at the main shape (20,480 cached rows x 8,192 x K = 512,000):
// 2 N_q S K = 1.718e14 int8 operations at 1,979 TOP/s = 86.8 ms, against
// (N_q + S) K = 14.7 GB read once at 3.35 TB/s = 4.4 ms: operations bound
// it. The chain it replaces takes 188-195 ms a block on an H100 SXM at
// 700 W (the library's int8 GEMM built for SM80's mma.sync, six products
// and their int32 tiles through HBM).
//
// What bounds a tiled design first is L2: a CTA that computes a 128 x 128
// tile reads 256 bytes of operands per K byte for 2 * 128 * 128 operations,
// 128 operations a byte, and at 70% of the peak the 132 SMs would pull
// ~11 TB/s from L2, more than it gives. The design raises the operations
// per L2 byte:
//  * CTA tile 128 x 256 (two consumer warpgroups, each
//    wgmma.m64n256k32.s32.s8.s8 over its 64 query rows): 170 op/B alone;
//  * clusters of kCluster CTAs along the queries share one synthetic tile:
//    each CTA loads its own 128 query rows and 1/kCluster of the synthetic
//    rows, and TMA multicasts that slice into every CTA of the cluster
//    (2 CTAs: 256 op/B; 4: 341 op/B). Two, not four: only 30 clusters of
//    4 are resident (120 of 132 SMs), and the attack ran 6% slower with
//    them end to end on an H100 SXM; a lone CTA (1) ran 2.6x slower;
//  * persistent CTAs, one per SM: cluster c takes work items c, c + C, ...
//    (C clusters), an item being kCluster query tiles x one synthetic tile,
//    in bands of `band` query groups per synthetic tile, so the items in
//    flight at once cover a compact rectangle and their rows stream from
//    HBM about once per block while the cache (10.5 GB) passes through L2.
//
// Exactness. One int32 accumulator per part: it restarts (scale_d = 0) at
// each part's first k32 step (parts end on k32 steps: every width is a
// multiple of 32), and the wrapper's bound check keeps every part's dot
// below 2^31. At each part's end the fragment is promoted,
// cross = cross + __int2float_rn(acc) * f_l (__fmul_rn, __fadd_rn), in part
// order. The float32 cross term of a 128 x 256 tile does not fit beside
// the 128 accumulators in a consumer thread's registers, so it lives in a
// per-CTA workspace in device memory, each thread's values at stride 256
// (coalesced): five reads and writes of 512 bytes a thread per tile of
// ~3 ms. The last part's promotion feeds the epilogue directly:
// d = (rq + rs) - 2 * cross (__fadd_rn, the exact doubling, __fsub_rn),
// columns >= n_valid skipped, each row's first minimum over its registers
// and its quad (K1's epilogue); one partial (min, column) per query row and
// synthetic tile. The merge kernel walks a row's partials in tile order
// with strict '<' and then the running state with strict '<'.
//
// Pipeline: K1's roles. A producer warpgroup (one thread issues TMA,
// setmaxnreg 40) fills a ring of stages of 128 K bytes (the query box and
// the synthetic box, 128-byte swizzled) with a "full" and an "empty"
// mbarrier each; the two consumer warpgroups (setmaxnreg 232) run four
// wgmma k32 steps a stage, one group in flight while the next is issued.
// Every consumer warp releases a stage to every CTA of its cluster (remote
// mbarrier arrive), since each CTA's producer writes into all of them; the
// producer waits for its ring to drain before it leaves.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <climits>

#include "knn_tile_wgmma.cuh"

namespace {

using knn_wgmma::mbar_expect_tx;
using knn_wgmma::mbar_init;
using knn_wgmma::mbar_wait;
using knn_wgmma::sw128_desc;
using knn_wgmma::smem_u32;
using knn_wgmma::wgmma_commit;
using knn_wgmma::wgmma_fence;
using knn_wgmma::wgmma_wait;

constexpr int kTileQ = 128;          // query rows per CTA
constexpr int kStageK = 128;         // K bytes per stage: one swizzled row
constexpr int kStepK = 32;           // K bytes per wgmma step
constexpr int kSteps = kStageK / kStepK;
constexpr int kQBytes = kTileQ * kStageK;    // 16 KB
constexpr int kConsumerThreads = knn_wgmma::kConsumerThreads;  // 256
constexpr int kThreads = knn_wgmma::kThreads;                  // 384
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kMaxParts = 16;
constexpr int kMaxSmem = knn_wgmma::kMaxSmem;
constexpr int kAlign = knn_wgmma::kAlignSlack;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The parts, in k32 steps: part l covers steps [end[l - 1], end[l]) and
// its dot is scaled by factor[l] (the float32 value torch multiplies by).
struct Parts {
  int n;
  int end[kMaxParts];
  float factor[kMaxParts];
};

constexpr int kTileS = 256;          // synthetic rows per CTA tile
constexpr int kCluster = 2;          // CTAs per cluster along the queries
constexpr int kRegs = kTileS / 2;    // accumulators per consumer thread
constexpr int kSBytes = kTileS * kStageK;    // 32 KB
constexpr int kStageBytes = kQBytes + kSBytes;
// stages of 48 KB (+ two mbarriers) beside the 1 KB alignment slack: 4
constexpr int kStages = (kMaxSmem - kAlign) / (kStageBytes + 16);
constexpr size_t kSmem = kAlign + kStages * (kStageBytes + 16);

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrive on the mbarrier at the same shared offset in CTA `cta` of the
// cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// One TMA box into the same shared offset of every CTA in `mask`, each
// CTA's mbarrier at `bar` counting the bytes.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   int k0, int row0,
                                                   uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(k0),
      "r"(row0)
      : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256, s32) = A (64 x 32, s8) . B (256 x 32, s8)^T
// + (scale_d ? d : 0), both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Stage i: the query box at q(i), the synthetic box at q(i) + 16 KB; then
// the stages' "full" and "empty" mbarriers.
struct Ring {
  uint32_t base;  // shared address of stage 0, 1024-byte aligned

  __device__ explicit Ring(unsigned char* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  }
  __device__ uint32_t q(int i) const { return base + i * kStageBytes; }
  __device__ uint32_t s(int i) const { return q(i) + kQBytes; }
  __device__ uint32_t full(int i) const {
    return base + kStages * kStageBytes + 8 * i;
  }
  __device__ uint32_t empty(int i) const { return full(kStages + i); }
};

// Work item `it` -> (query group, synthetic tile): bands of `band` query
// groups; within a band the query group varies fastest, then the tile.
__device__ __forceinline__ void item_coords(int it, int n_qg, int n_st,
                                            int band, int& qg, int& st) {
  const int per_band = band * n_st;
  const int b = it / per_band;
  const int r = it - b * per_band;
  const int height = min(band, n_qg - b * band);
  st = r / height;
  qg = b * band + (r - st * height);
}

// One consumer warp's release of a stage in every CTA of the cluster.
__device__ __forceinline__ void release(uint32_t bar) {
  if ((threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(bar, c);
}

__global__ void __launch_bounds__(kThreads, 1)
int8_fold_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_s,
                 const __grid_constant__ Parts parts,
                 const float* __restrict__ rq, const float* __restrict__ rs,
                 int n_q, int n_valid, int n_qg, int n_st, int band,
                 float* __restrict__ ws, float* __restrict__ part_d,
                 int* __restrict__ part_i) {
  extern __shared__ unsigned char smem[];
  const Ring ring(smem);
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster;
  const int n_clusters = gridDim.x / kCluster;
  const int n_items = n_qg * n_st;
  const int n_steps = parts.end[parts.n - 1];
  const int n_kb = (n_steps + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(ring.full(i), 1);
      mbar_init(ring.empty(i), kConsumerWarps * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // a peer's first multicast finds our barriers set

  if (threadIdx.x >= kConsumerThreads) {  // producer warpgroup
    knn_wgmma::producer_regs<kProducerRegs>();
    if (threadIdx.x != kConsumerThreads) return;
    knn_wgmma::Cursor c;
    for (int it = cluster; it < n_items; it += n_clusters) {
      int qg, st;
      item_coords(it, n_qg, n_st, band, qg, st);
      const int m0 = (qg * kCluster + static_cast<int>(rank)) * kTileQ;
      const int n0 =
          st * kTileS + static_cast<int>(rank) * (kTileS / kCluster);
      for (int kb = 0; kb < n_kb; ++kb) {
        mbar_wait(ring.empty(c.stage), c.phase ^ 1);  // passes on round one
        mbar_expect_tx(ring.full(c.stage), kStageBytes);
        knn_wgmma::tma_load(ring.q(c.stage), &map_q, kb * kStageK, m0,
                            ring.full(c.stage));
        tma_load_multicast(ring.s(c.stage) + rank * (kSBytes / kCluster),
                           &map_s, kb * kStageK, n0, ring.full(c.stage),
                           static_cast<uint16_t>((1u << kCluster) - 1));
        c.next(kStages);
      }
    }
    // Drain: every stage released by every consumer of the cluster, so no
    // peer still writes into this CTA or arrives on its barriers.
    for (int i = 0; i < kStages; ++i) {
      mbar_wait(ring.empty(c.stage), c.phase ^ 1);
      c.next(kStages);
    }
    return;
  }

  // consumer warpgroups
  knn_wgmma::consumer_regs<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  int rows[2], lane_col;
  knn_wgmma::frag_rows(rows, lane_col);
  float* wsp = ws + static_cast<size_t>(blockIdx.x) * kConsumerThreads *
                        kRegs + threadIdx.x;
  knn_wgmma::Cursor c;
  int acc[kRegs];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) acc[j] = 0;

  for (int it = cluster; it < n_items; it += n_clusters) {
    int qg, st;
    item_coords(it, n_qg, n_st, band, qg, st);
    const int m0 = (qg * kCluster + static_cast<int>(rank)) * kTileQ;
    const int n0 = st * kTileS;
    int step = 0;
    for (int l = 0; l < parts.n; ++l) {
      const int end = parts.end[l];
      int held = -1;  // a finished stage whose wgmma group may still read
      int scale = 0;  // 0 at the part's first step: the accumulator restarts
      while (step < end) {
        const int j0 = step % kSteps;
        const int first = step - j0;
        const int j1 = min(kSteps, end - first);
        if (j0 == 0) mbar_wait(ring.full(c.stage), c.phase);
        const uint64_t da = sw128_desc(ring.q(c.stage) + wg * (kQBytes / 2));
        const uint64_t db = sw128_desc(ring.s(c.stage));
        wgmma_fence();
        if (j0 == 0 && j1 == kSteps) {
#pragma unroll
          for (int j = 0; j < kSteps; ++j)  // 32 bytes of K each: +2 in desc
            wgmma_m64n256k32(acc, da + 2 * j, db + 2 * j, scale | j);
        } else {  // a part boundary inside the stage
#pragma unroll
          for (int j = 0; j < kSteps; ++j)
            if (j >= j0 && j < j1)
              wgmma_m64n256k32(acc, da + 2 * j, db + 2 * j,
                               scale | (j - j0));
        }
        scale = 1;
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0) release(ring.empty(held));
        held = -1;
        step = first + j1;
        if (j1 == kSteps || step == n_steps) {  // the stage is used up
          held = c.stage;
          c.next(kStages);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (held >= 0) release(ring.empty(held));
      const float f = parts.factor[l];
      if (l + 1 < parts.n) {  // promote into the workspace
        if (l == 0) {
#pragma unroll
          for (int j = 0; j < kRegs; ++j)
            wsp[j * kConsumerThreads] = __fmul_rn(__int2float_rn(acc[j]), f);
        } else {
#pragma unroll
          for (int j = 0; j < kRegs; ++j)
            wsp[j * kConsumerThreads] =
                __fadd_rn(wsp[j * kConsumerThreads],
                          __fmul_rn(__int2float_rn(acc[j]), f));
        }
        continue;
      }
      // the last part: the distances and each row's first minimum
      float rqh[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rqh[h] = m0 + rows[h] < n_q ? rq[m0 + rows[h]] : 0.f;
      float best_d[2] = {CUDART_INF_F, CUDART_INF_F};
      int best_i[2] = {INT_MAX, INT_MAX};
#pragma unroll
      for (int j = 0; j < kRegs; ++j) {  // columns ascend with j in each row
        const int col = n0 + 8 * (j >> 2) + lane_col + (j & 1);
        const int h = (j >> 1) & 1;
        float x = __fmul_rn(__int2float_rn(acc[j]), f);
        if (l > 0) x = __fadd_rn(wsp[j * kConsumerThreads], x);
        if (col < n_valid) {
          const float d =
              __fsub_rn(__fadd_rn(rqh[h], rs[col]), __fmul_rn(2.f, x));
          if (d < best_d[h]) {
            best_d[h] = d;
            best_i[h] = col;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        knn_wgmma::quad_min(best_d[h], best_i[h]);
        const int m = m0 + rows[h];
        if ((threadIdx.x & 3) == 0 && m < n_q) {
          const size_t o = static_cast<size_t>(st) * n_q + m;
          part_d[o] = best_d[h];
          part_i[o] = best_i[h];
        }
      }
    }
  }
}

// Per query row: the tiles' partials in tile order with strict '<' (the
// block's first minimum), then the running state with strict '<'.
__global__ void int8_fold_merge(const float* __restrict__ part_d,
                                const int* __restrict__ part_i, int n_st,
                                int n_q, const float* __restrict__ run_min,
                                const int* __restrict__ run_idx, int col0,
                                float* __restrict__ out_min,
                                int* __restrict__ out_idx) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_q) return;
  float best_d = CUDART_INF_F;
  int best_i = 0;
  for (int st = 0; st < n_st; ++st) {
    const size_t o = static_cast<size_t>(st) * n_q + m;
    const float d = part_d[o];
    if (d < best_d) {
      best_d = d;
      best_i = part_i[o];
    }
  }
  if (best_d < run_min[m]) {
    out_min[m] = best_d;
    out_idx[m] = col0 + best_i;
  } else {
    out_min[m] = run_min[m];
    out_idx[m] = run_idx[m];
  }
}

// The TMA map of a row-major (n_rows, k_dim) int8 matrix in boxes of
// box_rows rows x 128 K bytes, 128-byte swizzled, zero outside it.
inline cudaError_t int8_map(CUtensorMap* map, const void* base, int n_rows,
                            int k_dim, int box_rows) {
  if (k_dim % 16 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return cudaErrorInvalidValue;
  const knn_wgmma::EncodeTiledFn enc = knn_wgmma::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_dim),
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_dim)};
  const cuuint32_t box[2] = {kStageK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaLaunchConfig_t launch_config(int grid, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_smem() {
  return cudaFuncSetAttribute(int8_fold_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem));
}

cudaError_t launch(const void* q, const void* s, const float* rq,
                   const float* rs, int n_q, int n_valid, int k_dim,
                   int grid, int band, const Parts& parts, float* ws,
                   float* part_d, int* part_i, cudaStream_t stream) {
  CUtensorMap map_q, map_s;
  cudaError_t err = int8_map(&map_q, q, n_q, k_dim, kTileQ);
  if (err != cudaSuccess) return err;
  err = int8_map(&map_s, s, n_valid, k_dim, kTileS / kCluster);
  if (err != cudaSuccess) return err;
  err = set_smem();
  if (err != cudaSuccess) return err;
  const int n_qg = (n_q + kTileQ * kCluster - 1) / (kTileQ * kCluster);
  const int n_st = (n_valid + kTileS - 1) / kTileS;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(grid, stream, &attr);
  return cudaLaunchKernelEx(&cfg, int8_fold_kernel, map_q, map_s, parts,
                            rq, rs, n_q, n_valid, n_qg, n_st, band, ws,
                            part_d, part_i);
}

}  // namespace

extern "C" {

// Synthetic rows per CTA tile: the wrapper sizes the partials with it.
int knn_int8_fold_tile_cols() { return kTileS; }

// CTAs per cluster: the wrapper sizes query groups with it.
int knn_int8_fold_cluster() { return kCluster; }

// Clusters resident at once on the current device (one CTA per SM); -1 if
// the kernel cannot run there.
int knn_int8_fold_max_clusters() {
  if (set_smem() != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(kCluster, nullptr, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, int8_fold_kernel, &cfg) !=
      cudaSuccess)
    return -1;
  return n;
}

// One block's fold. q (n_q, k_dim) and s (n_valid, k_dim) int8, row-major,
// contiguous, 16-byte aligned, k_dim % 16 == 0; rq (n_q,), rs (n_valid,)
// float32. ends / factors: n_parts (<= 16) host values, ends in k32 steps,
// increasing, the last k_dim / 32. grid: CTAs, a multiple of kCluster, at
// most kCluster * knn_int8_fold_max_clusters(); band: query groups per
// band of the work order. ws: grid * 256 * 128 floats; part_d / part_i:
// ceil(n_valid / 256) * n_q each. run_min / run_idx: the running state
// (n_q,); out_min / out_idx receive the new one. Launches on `stream`
// without synchronising; returns the cudaError_t of the launches (0 on
// success).
int knn_int8_fold_launch(const void* q, const void* s, const void* rq,
                         const void* rs, int n_q, int n_valid, int k_dim, int grid, int band, const int* ends,
                         const float* factors, int n_parts, void* ws,
                         void* part_d, void* part_i, const void* run_min,
                         const void* run_idx, int col0, void* out_min,
                         void* out_idx, void* stream) {
  if (n_q <= 0 || n_valid <= 0 || k_dim <= 0 || band <= 0 || grid <= 0 ||
      grid % kCluster != 0 || n_parts <= 0 || n_parts > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  Parts parts = {};
  parts.n = n_parts;
  for (int l = 0; l < n_parts; ++l) {
    if (ends[l] <= (l > 0 ? ends[l - 1] : 0))
      return static_cast<int>(cudaErrorInvalidValue);
    parts.end[l] = ends[l];
    parts.factor[l] = factors[l];
  }
  if (static_cast<long long>(ends[n_parts - 1]) * kStepK != k_dim)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  const cudaError_t err =
      launch(q, s, static_cast<const float*>(rq),
             static_cast<const float*>(rs), n_q, n_valid, k_dim, grid, band,
             parts, static_cast<float*>(ws), pd, pi, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_st = (n_valid + kTileS - 1) / kTileS;
  int8_fold_merge<<<(n_q + 255) / 256, 256, 0, st>>>(
      pd, pi, n_st, n_q, static_cast<const float*>(run_min),
      static_cast<const int*>(run_idx), col0, static_cast<float*>(out_min),
      static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
