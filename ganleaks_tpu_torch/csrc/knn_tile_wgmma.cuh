// The bfloat16 cross-term tile shared by the two distance kernels
// (knn_argmin.cu, K1, and knn_topk.cu, K3) on Hopper's tensor cores: the
// float32 dot products of a 128-query tile with a 128-row synthetic tile,
// computed by wgmma (bf16 x bf16 -> f32) from shared memory that TMA fills.
// float32 inputs take the 3xTF32 tile of knn_tile_tf32x3.cuh, built on this
// file's PTX wrappers, roles, fragment helpers and host side. A kernel takes
// its tile as a template parameter (Bf16 below, knn_tf32x3::Tile), which
// supplies the ring, the producer warpgroup's work and one tile's products.
//
// Bound at the attack's block (2048 x 2048, K = 512,000): 4.29 TFLOP over
// the 989 TFLOP/s of the bf16 tensor cores = 4.34 ms. A bf16 x bf16
// product is exact in float32, so the tensor cores compute the same
// products as the CUDA cores would (whose float32 bound is 64.1 ms).
//
// Design.
//  * Block: three warpgroups (384 threads). Warpgroups 0 and 1 consume:
//    warpgroup w owns tile rows [64 w, 64 w + 64) and issues
//    wgmma.m64n128k16 over them and all 128 synthetic rows. Warpgroup 2
//    produces: one thread issues the TMA loads; the warpgroup gives up its
//    registers with setmaxnreg (40 each; Bf16::kProducerRegs) and the
//    consumers take them (232 each), inside one if/else that never
//    reconverges.
//  * Ring: up to 6 stages of (128 + 128) rows x 64 K values x 2 B = 32 KB
//    (as many as fit beside the caller's bytes: 3 beside K3's k = 128 lists),
//    each a 128-byte-swizzled TMA box per operand (one 128-byte row per
//    tile row), with a "full" mbarrier (TMA bytes arrived) and an "empty"
//    mbarrier (one arrival per consumer warp) per stage. TMA's zero fill
//    covers rows past N_q / N_s and the K tail. TMA needs a row stride that
//    is a multiple of 16 bytes (K % 8 == 0) and a 16-byte-aligned base: the
//    wrappers pad K with zero columns otherwise, which leave every dot
//    product unchanged.
//  * Promotion: the wgmma accumulator restarts (scale_d = 0) every
//    kPromoteStages = 2 stages (128 K values) and is then added into a
//    float32 register sum on the CUDA cores, a two-level sum: over
//    K = 512,000 one tensor-core accumulator would
//    take 32,000 k16 steps whose internal rounding is not documented, and
//    on LPIPS embeddings (every product >= 0) a one-sided rounding adds up.
//    On an H100 SXM at 700 W a sweep of intervals from 1 stage to none
//    (PERF.md) found 2 the fastest, ~1e-6 * (rq + rs) off float64 at
//    K = 512,000 on non-negative rows, where one unpromoted accumulator is
//    ~1.6e-3 off.
//  * Registers: 64 accumulator + 64 promoted floats per consumer thread. A
//    128 x 256 tile (each consumer warpgroup on m64n256: 128 accumulator +
//    128 promoted floats) does not fit the 232 registers a consumer can
//    have.
//  * Fragment: in m64nNk16 thread t of a consumer warpgroup holds rows
//    16 (t / 32) + (t % 32) / 4 (+ 8) of its 64 and, of each 8-column
//    block i, columns 8 i + 2 (t % 4) + {0, 1}: a row's 128 columns lie on
//    the 4 lanes of a quad, ascending with the register index within a
//    lane. Epilogues reduce over the quad with shuffles at offsets 1 and 2.
//
// The kernels of K1/K3 run one CTA per SM (up to 227 KB of shared memory),
// so the wrappers split the synthetic axis for a single wave of CTAs.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn_wgmma {

constexpr int kTileQ = 128;       // queries per CTA (two 64-row warpgroups)
constexpr int kTileS = 128;       // synthetic rows per tile (wgmma N)
constexpr int kStageK = 64;       // K values per stage: one 128-byte row
constexpr int kOperandBytes = kTileQ * kStageK * 2;      // 16 KB per operand
constexpr int kStageBytes = 2 * kOperandBytes;           // 32 KB per stage
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 128;         // + producer group
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kFragRegs = 64;     // accumulator floats per consumer thread
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory limit
constexpr int kAlignSlack = 1024; // the 128-byte swizzle wants 1 KB bases
constexpr int kMaxStages = 6;
constexpr int kPromoteStages = 2; // K stages per accumulator promotion

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// One TMA box (64 K values x 128 rows at (k0, row0)) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k0, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(bar)
      : "memory");
}

// wgmma operand descriptor of a K-major, 128-byte-swizzled tile whose rows
// are 128 bytes apart (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO: unused here
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of them (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulator across a wait.
__device__ __forceinline__ void fence_regs(float (&d)[kFragRegs]) {
#pragma unroll
  for (int i = 0; i < kFragRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16, bf16) . B (128 x 16, bf16)^T + (scale_d ? d
// : 0), both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kFragRegs],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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

// ---------------------------------------------------------------------------
// The ring
// ---------------------------------------------------------------------------

// Stage s: the query box at q(s), the synthetic box at q(s) + 16 KB; then
// n_stages "full" and n_stages "empty" barriers; then the caller's bytes.
struct Ring {
  uint32_t base;  // shared address of stage 0, 1024-byte aligned
  int n_stages;
  unsigned char* extra;  // generic pointer to the bytes after the barriers

  __device__ Ring(unsigned char* raw, int stages) : n_stages(stages) {
    const uint32_t r = smem_u32(raw);
    base = (r + kAlignSlack - 1) & ~static_cast<uint32_t>(kAlignSlack - 1);
    extra = raw + (base - r) + stages * (kStageBytes + 16);
  }
  __device__ uint32_t q(int i) const { return base + i * kStageBytes; }
  __device__ uint32_t s(int i) const { return q(i) + kOperandBytes; }
  __device__ uint32_t full(int i) const {
    return base + n_stages * kStageBytes + 8 * i;
  }
  __device__ uint32_t empty(int i) const { return full(n_stages + i); }

  // One thread, before the block splits into roles (then __syncthreads).
  __device__ void init() const {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// Position in the ring; both roles walk the same sequence of stages.
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next(int n_stages) {
    if (++stage == n_stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---------------------------------------------------------------------------
// The two roles
// ---------------------------------------------------------------------------

// The register split of a tile's roles (per thread; 128 producer and 256
// consumer threads share the 384 x 168 registers of the launch).
template <int kRegs>
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// The producer thread: for synthetic tiles [t_begin, t_end) and every K
// stage, the query box of rows [m0, m0 + 128) and the synthetic box.
__device__ __forceinline__ void produce(const Ring& ring,
                                        const CUtensorMap* map_q,
                                        const CUtensorMap* map_s, int m0,
                                        int t_begin, int t_end, int n_kb) {
  Cursor c;
  for (int t = t_begin; t < t_end; ++t) {
    for (int kb = 0; kb < n_kb; ++kb) {
      mbar_wait(ring.empty(c.stage), c.phase ^ 1);  // passes on round one
      mbar_expect_tx(ring.full(c.stage), kStageBytes);
      tma_load(ring.q(c.stage), map_q, kb * kStageK, m0, ring.full(c.stage));
      tma_load(ring.s(c.stage), map_s, kb * kStageK, t * kTileS,
               ring.full(c.stage));
      c.next(ring.n_stages);
    }
  }
}

template <class R>
__device__ __forceinline__ void release(const R& ring, int stage) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(ring.empty(stage));
}

// A consumer warpgroup `wg`: sum[j] = the fragment's <q_m, s_n> over all
// n_kb stages of one synthetic tile. The accumulator restarts every
// kPromoteStages stages and is then added into sum on the CUDA cores. Within an
// interval one wgmma group stays in flight while the next is issued, so a
// stage is released one stage late; the interval ends on a full wait. (One
// loop per interval, not a branch inside one loop: ptxas then sees every
// read of the accumulator behind a full wait and adds no wait of its own.)
__device__ __forceinline__ void consume_tile(const Ring& ring, Cursor& c,
                                             int wg, int n_kb,
                                             float (&acc)[kFragRegs],
                                             float (&sum)[kFragRegs]) {
#pragma unroll
  for (int j = 0; j < kFragRegs; ++j) sum[j] = 0.f;
  for (int kb = 0; kb < n_kb;) {
    const int n = min(kPromoteStages, n_kb - kb);
    int held = -1;  // stage whose wgmma group may still be reading
    for (int i = 0; i < n; ++i, ++kb) {
      mbar_wait(ring.full(c.stage), c.phase);
      const uint64_t da =
          sw128_desc(ring.q(c.stage) + wg * (kOperandBytes / 2));
      const uint64_t db = sw128_desc(ring.s(c.stage));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kStageK / 16; ++j)  // 32 bytes = 16 K values each
        wgmma_m64n128k16(acc, da + 2 * j, db + 2 * j, i > 0 || j > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0) release(ring, held);
      held = c.stage;
      c.next(ring.n_stages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(ring, held);
#pragma unroll
    for (int j = 0; j < kFragRegs; ++j) sum[j] += acc[j];
  }
}

// The consumer thread's two tile rows (0..127) and the column offset of its
// quad lane: register j belongs to row rows[(j >> 1) & 1] and to column
// 8 * (j >> 2) + lane_col + (j & 1).
__device__ __forceinline__ void frag_rows(int (&rows)[2], int& lane_col) {
  const int t = threadIdx.x;  // < kConsumerThreads
  const int lane = t & 31;
  rows[0] = (t >> 7) * 64 + ((t >> 5) & 3) * 16 + (lane >> 2);
  rows[1] = rows[0] + 8;
  lane_col = 2 * (lane & 3);
}

// Lexicographic (d, index) minimum over the 4 lanes of a quad.
__device__ __forceinline__ void quad_min(float& d, int& i) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (od < d || (od == d && oi < i)) {
      d = od;
      i = oi;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The TMA map of a row-major (n_rows, k_dim) matrix of `elem_bytes`-byte
// elements in boxes of 128 rows x box_k K values (one `swizzle`-wide row per
// tile row), zero outside the matrix. TMA needs a row stride that is a
// multiple of 16 bytes and a 16-byte-aligned base.
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int n_rows,
                            int k_dim, CUtensorMapDataType type,
                            int elem_bytes, int box_k,
                            CUtensorMapSwizzle swizzle) {
  if ((static_cast<size_t>(k_dim) * elem_bytes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return cudaErrorInvalidValue;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_dim),
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_dim) *
                                 elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), kTileQ};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The bf16 tile as a kernel's template parameter.
struct Bf16 {
  using Ring = knn_wgmma::Ring;
  static constexpr int kStageK = knn_wgmma::kStageK;
  static constexpr int kRingBytes = kStageBytes + 16;  // a stage + barriers
  static constexpr int kMaxStages = knn_wgmma::kMaxStages;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;

  static cudaError_t map(CUtensorMap* m, const void* base, int n_rows,
                         int k_dim) {
    return rows_map(m, base, n_rows, k_dim, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    2, kStageK, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  // Every thread of the producer warpgroup calls it; one issues the loads.
  __device__ static void produce(const Ring& ring, const CUtensorMap* map_q,
                                 const CUtensorMap* map_s, int m0,
                                 int t_begin, int t_end, int n_kb) {
    if (threadIdx.x == kConsumerThreads)
      knn_wgmma::produce(ring, map_q, map_s, m0, t_begin, t_end, n_kb);
  }
  __device__ static void consume_tile(const Ring& ring, Cursor& c, int wg,
                                      int n_kb, float (&acc)[kFragRegs],
                                      float (&sum)[kFragRegs]) {
    knn_wgmma::consume_tile(ring, c, wg, n_kb, acc, sum);
  }
};

// Everything a wgmma kernel's launch needs before `<<<...>>>`: the ring's
// stage count (*n_stages, as many of Tile's stages as fit beside `extra`
// bytes, at most Tile::kMaxStages, at least 2), its dynamic shared memory
// (*smem, the kernel's limit raised to it) and the two TMA maps.
template <class Tile, typename Kernel>
inline cudaError_t prepare_launch(Kernel kernel, const void* q, const void* s,
                                  int n_q, int n_s, int k_dim, size_t extra,
                                  CUtensorMap* map_q, CUtensorMap* map_s,
                                  int* n_stages, size_t* smem) {
  if (extra + kAlignSlack > kMaxSmem) return cudaErrorInvalidValue;
  const size_t fit = (kMaxSmem - kAlignSlack - extra) / Tile::kRingBytes;
  *n_stages = fit < static_cast<size_t>(Tile::kMaxStages)
                  ? static_cast<int>(fit)
                  : Tile::kMaxStages;
  if (*n_stages < 2) return cudaErrorInvalidValue;
  *smem = kAlignSlack + static_cast<size_t>(*n_stages) * Tile::kRingBytes +
          extra;
  cudaError_t err = Tile::map(map_q, q, n_q, k_dim);
  if (err != cudaSuccess) return err;
  err = Tile::map(map_s, s, n_s, k_dim);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace knn_wgmma
