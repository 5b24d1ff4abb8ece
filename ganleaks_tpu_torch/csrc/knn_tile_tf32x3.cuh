// The float32 cross-term tile shared by the two distance kernels
// (knn_argmin.cu, K1, and knn_topk.cu, K3) on Hopper's tensor cores: the
// float32 dot products of a 128-query tile with a 128-row synthetic tile by
// a 3xTF32 split on wgmma.m64n128k8 (tf32 x tf32 -> f32). A new header
// beside knn_tile_wgmma.cuh (the bf16 tile), whose PTX wrappers, ring
// cursor, roles, fragment helpers and host side it reuses; a kernel takes it
// as its template parameter (knn_tf32x3::Tile).
//
// Bound at the attack's block (2048 x 2048, K = 512,000): 4.29 TFLOP of
// float32 multiply-adds, issued as three TF32 products each, over the
// 495 TFLOP/s of the TF32 tensor cores = 26.0 ms (the float32 CUDA cores'
// bound is 64.1 ms). At the tabular attack's 4,652 x 10,000 x 1,071:
// 0.604 ms. H100 SXM, 700 W.
//
// Accuracy. Each float32 x is split into x = hi + lo + e with
// hi = rna_tf32(x) and lo = rna_tf32(x - hi), rna_tf32 rounding to 10
// explicit mantissa bits, to nearest with ties away from zero (the
// rounding of cvt.rna.tf32.f32; here from two integer ops,
// (u + 0x1000) & ~0x1fff, which measured faster at the main block: 57.3
// against 68.9 ms with cvt, otherwise the same tile, on an H100 80GB HBM3
// at 700 W; PERF.md). x - hi
// is exact in float32, |x - hi| <= 2^-11 |x| and |e| <= 2^-22 |x|. Then
// a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b: each product of two 11-bit
// significands is exact in float32, and the dropped terms are
// <= ~3 * 2^-22 |a b|, so ~7e-7 * sum |a b| <= ~7e-7 * (rq + rs) in d,
// under the 1e-5 * (rq + rs) the attack's index checks use. The rounding
// matters: a TF32 wgmma reads only the top 19 bits of an operand
// (truncation), so feeding x raw as hi would leave an error of up to
// 2^-10 |x| for lo to absorb, and lo's own truncation would then dominate.
// tests/test_torch_knn_tf32x3.py holds the identity and the bounds.
//
// Design (the bf16 tile's, with the split in between).
//  * Block: three warpgroups (384 threads). Warpgroups 0 and 1 consume,
//    each issuing wgmma.m64n128k8 over its 64 tile rows and all 128
//    synthetic rows. Warpgroup 2 produces: one thread issues the TMA loads,
//    warps 1-3 split the synthetic box. setmaxnreg gives the producers 56
//    registers each (room for 4 float4 loads in flight per thread) and the
//    consumers 224.
//  * Ring: up to 6 stages of 16 K values: the TMA boxes of q and s, 128
//    rows x 64 bytes each (CU_TENSOR_MAP_SWIZZLE_64B, K-major, as TF32
//    wgmma needs both operands), 16 KB, and their lo siblings, 16 KB, so
//    32 KB a stage. The split is elementwise, so it keeps addresses: hi
//    overwrites x in place and lo goes to the same offset in the sibling
//    box, and the 64-byte swizzle stays valid for both. A stage of 32 K
//    values (128-byte swizzle) would take 64 KB: K1 would still fit 3, but
//    K3's k = 128 lists take 128 KB of the 227, which leaves room for one,
//    and the ring needs two. 16-deep stages keep one layout for both
//    kernels: 6 stages beside K1, 3 beside K3 at k = 128.
//  * The split is shared out: the producer's warps 1-3 split the synthetic
//    box (512 float4s a stage), each consumer warpgroup its own 64 query
//    rows (two float4s a thread) while its previous stage's wgmmas run.
//    With the producer splitting both boxes the tile took 51.2 ms at the
//    main block, 45.2 this way, against 44.7 with no split at all (same
//    card, PERF.md): the split's latency per stage, on three warps, bounded
//    the ring.
//  * Barriers per stage: "full" (TMA bytes arrived), "ready" (one arrival
//    per split warp, after each thread's fence.proxy.async: the generic
//    proxy's writes are visible to wgmma) and "empty" (one arrival per
//    consumer warp); a consumer warpgroup's own split ends on each
//    thread's fence and a 128-thread named barrier (bar.sync 1 + wg). The
//    producer thread waits on "empty", the split warps on "full", the
//    consumers on "ready". TMA's zero fill covers rows past N_q / N_s and
//    the K tail; TMA needs K % 4 == 0 and 16-byte-aligned rows, so the
//    wrappers pad K with zero columns otherwise. Nothing is written to
//    device memory but the kernels' outputs.
//  * Products: per 8-deep K step the three wgmmas go into one accumulator,
//    smallest first (lo.hi, hi.lo, hi.hi). The accumulator restarts every
//    kPromoteStages = 8 stages (128 K values, as the bf16 tile) and is then
//    added into a float32 register sum on the CUDA cores: one tensor-core
//    accumulator over K = 512,000 drifts (~1.6e-3 * (rq + rs) in the bf16
//    tile on non-negative rows). The promotion points are fixed multiples
//    of K, and nothing splits K across blocks, so a pair's d depends only on
//    its two rows and K, not on N_q, N_s, the tile or the span.
//  * Registers and fragment: the bf16 tile's (64 accumulator + 64 promoted
//    floats per consumer thread; a row's 128 columns on the 4 lanes of a
//    quad).

#pragma once

#include "knn_tile_wgmma.cuh"

namespace knn_tf32x3 {

using knn_wgmma::Cursor;
using knn_wgmma::kAlignSlack;
using knn_wgmma::kConsumerThreads;
using knn_wgmma::kConsumerWarps;
using knn_wgmma::kFragRegs;
using knn_wgmma::kTileQ;
using knn_wgmma::mbar_arrive;
using knn_wgmma::mbar_expect_tx;
using knn_wgmma::mbar_init;
using knn_wgmma::mbar_wait;
using knn_wgmma::smem_u32;

constexpr int kStageK = 16;  // K values per stage: one 64-byte row
constexpr int kOperandBytes = kTileQ * kStageK * 4;  // 8 KB per operand
constexpr int kLoadBytes = 2 * kOperandBytes;  // q and s: TMA bytes a stage
constexpr int kStageBytes = 2 * kLoadBytes;    // + the lo siblings: 32 KB
constexpr int kRingBytes = kStageBytes + 24;   // + full, ready, empty
constexpr int kMaxStages = 6;
constexpr int kPromoteStages = 8;  // K stages per promotion (128 K values)
constexpr int kSplitWarps = 3;     // producer warps 1..3
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kLoadVecs = kLoadBytes / 16;     // float4s a stage loads
constexpr int kBoxVecs = kOperandBytes / 16;   // float4s of one box
constexpr int kSplitIters = (kBoxVecs + kSplitThreads - 1) / kSplitThreads;
constexpr int kSplitBatch = 4;     // float4 loads in flight per split thread

// Stage i: the query box at q(i), the synthetic box at s(i) = q(i) + 8 KB,
// each one's lo sibling kLoadBytes further; then n_stages "full", "ready"
// and "empty" barriers each; then the caller's bytes.
struct Ring {
  uint32_t base;         // shared address of stage 0, 1024-byte aligned
  int n_stages;
  unsigned char* data;   // generic pointer to stage 0
  unsigned char* extra;  // generic pointer to the bytes after the barriers

  __device__ Ring(unsigned char* raw, int stages) : n_stages(stages) {
    const uint32_t r = smem_u32(raw);
    base = (r + kAlignSlack - 1) & ~static_cast<uint32_t>(kAlignSlack - 1);
    data = raw + (base - r);
    extra = data + stages * kRingBytes;
  }
  __device__ uint32_t q(int i) const { return base + i * kStageBytes; }
  __device__ uint32_t s(int i) const { return q(i) + kOperandBytes; }
  __device__ uint32_t full(int i) const {
    return base + n_stages * kStageBytes + 8 * i;
  }
  __device__ uint32_t ready(int i) const { return full(n_stages + i); }
  __device__ uint32_t empty(int i) const { return full(2 * n_stages + i); }

  // One thread, before the block splits into roles (then __syncthreads).
  __device__ void init() const {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(ready(i), kSplitWarps);
      mbar_init(empty(i), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// rna_tf32(x): float32 x rounded to TF32 (10 explicit mantissa bits), to
// nearest with ties away from zero (cvt.rna.tf32.f32's rounding), its low
// 13 bits clear. Finite x only; values within half a TF32 ulp of the
// float32 maximum round to inf.
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// v split into hi, written over x[i], and lo, written to x[i + kLoadVecs]
// (the same offset in the sibling box).
__device__ __forceinline__ void split_store(float4* x, int i, float4 v) {
  float4 hi, lo;
  hi.x = rna_tf32(v.x);
  hi.y = rna_tf32(v.y);
  hi.z = rna_tf32(v.z);
  hi.w = rna_tf32(v.w);
  lo.x = rna_tf32(v.x - hi.x);  // x - hi is exact
  lo.y = rna_tf32(v.y - hi.y);
  lo.z = rna_tf32(v.z - hi.z);
  lo.w = rna_tf32(v.w - hi.w);
  x[i] = hi;
  x[i + kLoadVecs] = lo;
}

// wgmma operand descriptor of a K-major, 64-byte-swizzled tile whose rows
// are 64 bytes apart (8-row groups 512 bytes apart).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |           // LBO: unused here
         (static_cast<uint64_t>(512 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(2) << 62);            // 64-byte swizzle
}

// d (64 x 128, f32) = A (64 x 8, tf32) . B (128 x 8, tf32)^T + (scale_d ? d
// : 0), both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[kFragRegs],
                                                uint64_t desc_a,
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

struct Tile {
  using Ring = knn_tf32x3::Ring;
  static constexpr int kStageK = knn_tf32x3::kStageK;
  static constexpr int kRingBytes = knn_tf32x3::kRingBytes;
  static constexpr int kMaxStages = knn_tf32x3::kMaxStages;
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs = 224;

  static cudaError_t map(CUtensorMap* m, const void* base, int n_rows,
                         int k_dim) {
    return knn_wgmma::rows_map(m, base, n_rows, k_dim,
                               CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kStageK,
                               CU_TENSOR_MAP_SWIZZLE_64B);
  }

  // Every thread of the producer warpgroup calls it, for synthetic tiles
  // [t_begin, t_end) and every K stage. Warp 0's first thread loads the
  // query box of rows [m0, m0 + 128) and the synthetic box; warps 1-3
  // split the synthetic box into hi (in place) and lo.
  __device__ static void produce(const Ring& ring, const CUtensorMap* map_q,
                                 const CUtensorMap* map_s, int m0,
                                 int t_begin, int t_end, int n_kb) {
    const int t_id = threadIdx.x - kConsumerThreads;  // 0..127
    Cursor c;
    if (t_id == 0) {
      for (int t = t_begin; t < t_end; ++t) {
        for (int kb = 0; kb < n_kb; ++kb) {
          mbar_wait(ring.empty(c.stage), c.phase ^ 1);  // passes on round 1
          mbar_expect_tx(ring.full(c.stage), kLoadBytes);
          knn_wgmma::tma_load(ring.q(c.stage), map_q, kb * kStageK, m0,
                              ring.full(c.stage));
          knn_wgmma::tma_load(ring.s(c.stage), map_s, kb * kStageK,
                              t * knn_wgmma::kTileS, ring.full(c.stage));
          c.next(ring.n_stages);
        }
      }
    } else if (t_id >= 32) {
      const int first = t_id - 32;
      for (int t = t_begin; t < t_end; ++t) {
        for (int kb = 0; kb < n_kb; ++kb) {
          mbar_wait(ring.full(c.stage), c.phase);
          float4* x = reinterpret_cast<float4*>(
              ring.data + c.stage * kStageBytes + kOperandBytes);
          // batches of loads in flight: the split's latency per stage,
          // not its issue rate, bounds the ring
#pragma unroll
          for (int b = 0; b < kSplitIters; b += kSplitBatch) {
            float4 v[kSplitBatch];
#pragma unroll
            for (int j = 0; j < kSplitBatch; ++j) {
              const int i = first + (b + j) * kSplitThreads;
              if (b + j < kSplitIters && i < kBoxVecs) v[j] = x[i];
            }
#pragma unroll
            for (int j = 0; j < kSplitBatch; ++j) {
              const int i = first + (b + j) * kSplitThreads;
              if (b + j < kSplitIters && i < kBoxVecs) split_store(x, i, v[j]);
            }
          }
          knn_wgmma::fence_proxy_async();
          __syncwarp();
          if ((t_id & 31) == 0) mbar_arrive(ring.ready(c.stage));
          c.next(ring.n_stages);
        }
      }
    }
  }

  // Consumer warpgroup `wg` splits its 64 query rows of a stage (4 KB, two
  // float4s a thread); every thread's fence and a barrier of the
  // warpgroup's 128 threads let its wgmmas read them all.
  __device__ static void split_query_rows(const Ring& ring, int stage,
                                          int wg) {
    float4* x = reinterpret_cast<float4*>(ring.data + stage * kStageBytes +
                                          wg * (kOperandBytes / 2));
    const int i = threadIdx.x & 127;
    const float4 v0 = x[i];
    const float4 v1 = x[i + 128];
    split_store(x, i, v0);
    split_store(x, i + 128, v1);
    knn_wgmma::fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  // A consumer warpgroup `wg`: sum[j] = the fragment's <q_m, s_n> over all
  // n_kb stages of one synthetic tile, as knn_wgmma::consume_tile, with
  // three TF32 products per 8-deep K step.
  __device__ static void consume_tile(const Ring& ring, Cursor& c, int wg,
                                      int n_kb, float (&acc)[kFragRegs],
                                      float (&sum)[kFragRegs]) {
#pragma unroll
    for (int j = 0; j < kFragRegs; ++j) sum[j] = 0.f;
    for (int kb = 0; kb < n_kb;) {
      const int n = min(kPromoteStages, n_kb - kb);
      int held = -1;  // stage whose wgmma group may still be reading
      for (int i = 0; i < n; ++i, ++kb) {
        mbar_wait(ring.ready(c.stage), c.phase);
        split_query_rows(ring, c.stage, wg);
        const uint32_t qa = ring.q(c.stage) + wg * (kOperandBytes / 2);
        const uint64_t a_hi = sw64_desc(qa);
        const uint64_t a_lo = sw64_desc(qa + kLoadBytes);
        const uint64_t b_hi = sw64_desc(ring.s(c.stage));
        const uint64_t b_lo = sw64_desc(ring.s(c.stage) + kLoadBytes);
        knn_wgmma::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kStageK / 8; ++j) {  // 32 bytes = 8 K values
          wgmma_m64n128k8(acc, a_lo + 2 * j, b_hi + 2 * j, i > 0 || j > 0);
          wgmma_m64n128k8(acc, a_hi + 2 * j, b_lo + 2 * j, 1);
          wgmma_m64n128k8(acc, a_hi + 2 * j, b_hi + 2 * j, 1);
        }
        knn_wgmma::wgmma_commit();
        knn_wgmma::wgmma_wait<1>();
        if (held >= 0) knn_wgmma::release(ring, held);
        held = c.stage;
        c.next(ring.n_stages);
      }
      knn_wgmma::wgmma_wait<0>();
      knn_wgmma::fence_regs(acc);
      knn_wgmma::release(ring, held);
#pragma unroll
      for (int j = 0; j < kFragRegs; ++j) sum[j] += acc[j];
    }
  }
};

}  // namespace knn_tf32x3
