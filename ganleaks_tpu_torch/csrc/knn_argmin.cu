// Fused distance + first-index argmin over embedding rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ganleaks_tpu/ops/knn_pallas.py::knn_argmin_pallas
// (kernel _knn_kernel). For every query row q_m it returns
//
//     d_m   = min_n  rq[m] + rs[n] - 2 * <q_m, s_n>
//     idx_m = the FIRST n attaining that minimum (torch.min's tie-break)
//
// with the cross term accumulated in float32 over K and the (N_q x N_s)
// distance matrix never written to memory.
//
// Bound. 2*N_q*N_s*K operations against (N_q + N_s)*K input elements: at the
// attack's block (2048 x 2048, K = 512,000) about 2000 operations per byte
// read, so the kernel is bound by arithmetic, not by the 3.35 TB/s of
// device memory: 4.34 ms for bfloat16 inputs on the bf16 tensor cores
// (989 TFLOP/s; a bf16 x bf16 product is exact in float32), 26.0 ms for
// float32 inputs on the TF32 tensor cores (495 TFLOP/s, three TF32
// products per float32 multiply-add; the float32 CUDA cores' bound is
// 64.1 ms). All times for an H100 SXM at 700 W.
//
// Design: one pass-1 kernel on either of two tiles, one merge.
//  * knn_partial_wgmma<Tile>: a 384-thread CTA, one per SM, owns a
//    128-query tile and a span of synthetic tiles; the producer warpgroup
//    feeds a ring of stages by TMA, two consumer warpgroups run wgmma and
//    promote the accumulator into a float32 register sum every 128 K
//    values. bfloat16 takes knn_wgmma::Bf16 (knn_tile_wgmma.cuh:
//    m64n128k16, 6 stages of 64 K values); float32 takes knn_tf32x3::Tile
//    (knn_tile_tf32x3.cuh: each stage split into TF32 hi and lo in shared
//    memory, three m64n128k8 products per 8 K values, 6 stages of 16). On
//    the fragment, d = (rq + rs) - 2*sum, and each row's first minimal
//    column is found over its 32 registers and the 4 lanes of its quad;
//    the running (min, index) of the thread's two rows stays in registers.
//    Registers: 64 accumulator + 64 promoted floats per consumer thread
//    under setmaxnreg 232 (bf16) or 224 (float32).
//  * Tiles are visited in increasing order, so strict '<' keeps the earliest
//    index. The TPU grid is sequential and carries the running argmin across
//    the whole synthetic axis; blocks on Hopper run in parallel, so the
//    synthetic axis is split into spans (the wrapper plans them for one
//    wave of CTAs), each writing one partial (min, index) per query.
//  * Pass 2 (knn_merge_kernel) walks the partials of each query in span
//    order with strict '<', which is exactly the sequential walk.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <climits>

#include "knn_tile_tf32x3.cuh"
#include "knn_tile_wgmma.cuh"

namespace {

using knn_wgmma::kTileQ;
using knn_wgmma::kTileS;

template <class Tile>
__global__ void __launch_bounds__(knn_wgmma::kThreads, 1)
knn_partial_wgmma(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_s,
                  const float* __restrict__ rq, const float* __restrict__ rs,
                  int n_q, int n_s, int k_dim, int tiles_per_split,
                  int n_stages, float* __restrict__ part_d,
                  int* __restrict__ part_i) {
  extern __shared__ unsigned char smem[];
  const typename Tile::Ring ring(smem, n_stages);
  const int m0 = blockIdx.y * kTileQ;
  const int split = blockIdx.x;
  const int n_tiles = (n_s + kTileS - 1) / kTileS;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_kb = (k_dim + Tile::kStageK - 1) / Tile::kStageK;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= knn_wgmma::kConsumerThreads) {  // producer warpgroup
    knn_wgmma::producer_regs<Tile::kProducerRegs>();
    Tile::produce(ring, &map_q, &map_s, m0, t_begin, t_end, n_kb);
  } else {  // consumer warpgroups
    knn_wgmma::consumer_regs<Tile::kConsumerRegs>();
    const int wg = threadIdx.x >> 7;
    int rows[2], lane_col;
    knn_wgmma::frag_rows(rows, lane_col);
    float rqh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rqh[h] = m0 + rows[h] < n_q ? rq[m0 + rows[h]] : 0.f;
    float run_d[2] = {CUDART_INF_F, CUDART_INF_F};
    int run_i[2] = {0, 0};
    knn_wgmma::Cursor c;
    float acc[knn_wgmma::kFragRegs], sum[knn_wgmma::kFragRegs];
#pragma unroll
    for (int j = 0; j < knn_wgmma::kFragRegs; ++j) acc[j] = 0.f;

    for (int t = t_begin; t < t_end; ++t) {
      const int n0 = t * kTileS;
      Tile::consume_tile(ring, c, wg, n_kb, acc, sum);
      float best_d[2] = {CUDART_INF_F, CUDART_INF_F};
      int best_i[2] = {INT_MAX, INT_MAX};
#pragma unroll
      for (int j = 0; j < knn_wgmma::kFragRegs; ++j) {  // columns ascend
        const int col = n0 + 8 * (j >> 2) + lane_col + (j & 1);
        const int h = (j >> 1) & 1;
        if (col < n_s) {
          const float d = (rqh[h] + rs[col]) - 2.f * sum[j];
          if (d < best_d[h]) {
            best_d[h] = d;
            best_i[h] = col;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        knn_wgmma::quad_min(best_d[h], best_i[h]);
        if (best_d[h] < run_d[h]) {  // the quad holds the same values
          run_d[h] = best_d[h];
          run_i[h] = best_i[h];
        }
      }
    }
    if ((threadIdx.x & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + rows[h];
        if (m < n_q) {
          const size_t o = static_cast<size_t>(split) * n_q + m;
          part_d[o] = run_d[h];
          part_i[o] = run_i[h];
        }
      }
    }
  }
}

__global__ void knn_merge_kernel(const float* __restrict__ part_d,
                                 const int* __restrict__ part_i, int n_splits,
                                 int n_q, float* __restrict__ d_out,
                                 int* __restrict__ i_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_q) return;
  float best_d = CUDART_INF_F;
  int best_i = 0;
  for (int sp = 0; sp < n_splits; ++sp) {  // spans in index order: strict '<'
    const size_t o = static_cast<size_t>(sp) * n_q + m;
    const float d = part_d[o];
    if (d < best_d) {
      best_d = d;
      best_i = part_i[o];
    }
  }
  d_out[m] = best_d;
  i_out[m] = best_i;
}

template <class Tile>
cudaError_t launch(dim3 grid, const void* q, const void* s, const float* rq,
                   const float* rs, int n_q, int n_s, int k_dim,
                   int tiles_per_split, float* part_d, int* part_i,
                   cudaStream_t stream) {
  CUtensorMap map_q, map_s;
  int n_stages;
  size_t smem;
  const cudaError_t err = knn_wgmma::prepare_launch<Tile>(
      knn_partial_wgmma<Tile>, q, s, n_q, n_s, k_dim, 0, &map_q, &map_s,
      &n_stages, &smem);
  if (err != cudaSuccess) return err;
  knn_partial_wgmma<Tile><<<grid, knn_wgmma::kThreads, smem, stream>>>(
      map_q, map_s, rq, rs, n_q, n_s, k_dim, tiles_per_split, n_stages,
      part_d, part_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per synthetic tile (both tiles): the wrapper sizes the partial
// buffers with it.
int knn_argmin_tile_rows() { return kTileS; }

// dtype: 0 = float32 (3xTF32 tile; k_dim % 4 == 0), 1 = bfloat16 (bf16
// tile; k_dim % 8 == 0); 16-byte-aligned q and s, for TMA. q (n_q, k_dim)
// and s (n_s, k_dim) are row-major and contiguous; rq (n_q,), rs (n_s,)
// float32 squared row norms. part_d/part_i hold n_splits * n_q entries, with
// n_splits = ceil(ceil(n_s / tile_rows) / tiles_per_split). Launches on
// `stream` without synchronising; returns the cudaError_t of the launches
// (0 on success).
int knn_argmin_launch(int dtype, const void* q, const void* s, const void* rq,
                      const void* rs, int n_q, int n_s, int k_dim,
                      int tiles_per_split, void* part_d, void* part_i,
                      void* d_out, void* i_out, void* stream) {
  if (n_q <= 0 || n_s <= 0 || k_dim <= 0 || tiles_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_s + kTileS - 1) / kTileS;
  const int n_splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const int q_tiles = (n_q + kTileQ - 1) / kTileQ;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_splits, q_tiles);
  const auto* rqf = static_cast<const float*>(rq);
  const auto* rsf = static_cast<const float*>(rs);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<knn_tf32x3::Tile>(grid, q, s, rqf, rsf, n_q, n_s, k_dim,
                                   tiles_per_split, pd, pi, st);
  } else if (dtype == 1) {
    err = launch<knn_wgmma::Bf16>(grid, q, s, rqf, rsf, n_q, n_s, k_dim,
                                  tiles_per_split, pd, pi, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_merge_kernel<<<(n_q + 255) / 256, 256, 0, st>>>(
      pd, pi, n_splits, n_q, static_cast<float*>(d_out),
      static_cast<int*>(i_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
