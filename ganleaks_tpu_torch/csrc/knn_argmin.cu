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
// Bound. 2*N_q*N_s*K floating-point operations against (N_q + N_s)*K input
// elements: at the attack's block shape (2048 x 2048, K = 512,000) that is
// 2048 operations per float32 byte read, so the kernel is bound by
// arithmetic, not by the 3.35 TB/s of device memory. This first version runs
// the products on the float32 CUDA cores (FFMA, no TF32: the attack's float32
// path must keep float32 products), whose peak is 67 TFLOP/s.
//
// Design.
//  * Pass 1 (knn_partial_kernel): a 256-thread block owns a 128-query tile
//    and a contiguous span of 128-row synthetic tiles. Per synthetic tile it
//    (knn_tile.cuh, shared with the top-k kernel) walks K in 16-deep
//    stages through double-buffered shared memory, each
//    thread accumulating an 8x8 register block of q.s with fmaf. bfloat16
//    inputs are widened to float32 on load. Every 8 stages (128 K values)
//    the stage sums are added into the main accumulator. One running float32
//    sum of 512,000 products rounds by an estimated ~1e-5 of the sum; the
//    two-level sum cuts that estimate to ~1e-6, under the 1e-5 * (rq + rs)
//    tolerance the attack's index check uses.
//    At the end of a tile, d = (rq + rs) - 2*acc, rows >= N_s are skipped,
//    each row's first minimal column is found in registers and across the
//    16 lanes that share the row (lexicographic (d, index) shuffles), and
//    folded into the block's running (min, index) with strict '<' — tiles
//    are visited in increasing order, so the earliest index wins.
//  * The TPU grid is sequential and carries the running argmin in VMEM
//    across the whole synthetic axis; blocks on Hopper run in parallel, so
//    the synthetic axis is split into spans over enough blocks to fill the
//    132 SMs, each writing one partial (min, index) per query.
//  * Pass 2 (knn_merge_kernel) walks the partials of each query in span
//    order with strict '<', which is exactly the sequential walk.
// No tensor cores, TMA or wgmma yet: a simple kernel that is right first.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <climits>

#include "knn_tile.cuh"

namespace {

using knn_tile::kThreads;
using knn_tile::kTileQ;
using knn_tile::kTileS;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
knn_partial_kernel(const T* __restrict__ q, const T* __restrict__ s,
                   const float* __restrict__ rq, const float* __restrict__ rs,
                   int n_q, int n_s, int k_dim, int tiles_per_split,
                   float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ __align__(16) knn_tile::Stages sm;
  __shared__ float run_d[kTileQ];
  __shared__ int run_i[kTileQ];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kTileQ;
  const int split = blockIdx.x;
  const int n_tiles = (n_s + kTileS - 1) / kTileS;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (tid < kTileQ) {
    run_d[tid] = CUDART_INF_F;
    run_i[tid] = 0;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * kTileS;
    float acc[8][8];
    knn_tile::tile_dot<T, VEC>(q, s, m0, n0, n_q, n_s, k_dim, sm, acc);

    // epilogue: distances, first minimal column per row, running fold
    int col[8];
    float rs_c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col[j] = n0 + knn_tile::out_col(tx, j);
      rs_c[j] = col[j] < n_s ? rs[col[j]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int lrow = knn_tile::out_row(ty, i);
      const int m = m0 + lrow;
      const float rqm = m < n_q ? rq[m] : 0.f;
      float best_d = CUDART_INF_F;
      int best_i = INT_MAX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // columns ascend with j
        if (col[j] < n_s) {
          const float d = (rqm + rs_c[j]) - 2.f * acc[i][j];
          if (d < best_d) {
            best_d = d;
            best_i = col[j];
          }
        }
      }
      // the 16 lanes sharing this row differ only in the low 4 lane bits
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best_d, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (od < best_d || (od == best_d && oi < best_i)) {
          best_d = od;
          best_i = oi;
        }
      }
      // one thread owns each row's running state: no race across tiles
      if (tx == 0 && best_d < run_d[lrow]) {
        run_d[lrow] = best_d;
        run_i[lrow] = best_i;
      }
    }
  }

  __syncthreads();
  if (tid < kTileQ && m0 + tid < n_q) {
    const size_t o = static_cast<size_t>(split) * n_q + m0 + tid;
    part_d[o] = run_d[tid];
    part_i[o] = run_i[tid];
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

template <typename T>
cudaError_t launch(const void* q, const void* s, const float* rq,
                   const float* rs, int n_q, int n_s, int k_dim,
                   int tiles_per_split, float* part_d, int* part_i,
                   float* d_out, int* i_out, cudaStream_t stream) {
  const int n_tiles = (n_s + kTileS - 1) / kTileS;
  const int n_splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const int q_tiles = (n_q + kTileQ - 1) / kTileQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;  // grid.y limit
  const dim3 grid(n_splits, q_tiles);
  const bool vec = knn_tile::vector_rows<T>(q, s, k_dim);
  const T* qt = static_cast<const T*>(q);
  const T* st = static_cast<const T*>(s);
  if (vec) {
    knn_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        qt, st, rq, rs, n_q, n_s, k_dim, tiles_per_split, part_d, part_i);
  } else {
    knn_partial_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        qt, st, rq, rs, n_q, n_s, k_dim, tiles_per_split, part_d, part_i);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge_kernel<<<(n_q + 255) / 256, 256, 0, stream>>>(
      part_d, part_i, n_splits, n_q, d_out, i_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per synthetic tile: the wrapper sizes the partial buffers with it.
int knn_argmin_tile_rows() { return kTileS; }

// dtype: 0 = float32, 1 = bfloat16. q (n_q, k_dim) and s (n_s, k_dim) are
// row-major and contiguous; rq (n_q,), rs (n_s,) float32 squared row norms.
// part_d/part_i hold n_splits * n_q entries, with
// n_splits = ceil(ceil(n_s / tile_rows) / tiles_per_split).
// Launches on `stream` without synchronising; returns the cudaError_t of the
// launches (0 on success).
int knn_argmin_launch(int dtype, const void* q, const void* s, const void* rq,
                      const void* rs, int n_q, int n_s, int k_dim,
                      int tiles_per_split, void* part_d, void* part_i,
                      void* d_out, void* i_out, void* stream) {
  if (n_q <= 0 || n_s <= 0 || k_dim <= 0 || tiles_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rqf = static_cast<const float*>(rq);
  const auto* rsf = static_cast<const float*>(rs);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto* dd = static_cast<float*>(d_out);
  auto* ii = static_cast<int*>(i_out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, s, rqf, rsf, n_q, n_s, k_dim, tiles_per_split, pd,
                        pi, dd, ii, st);
  } else if (dtype == 1) {
    err = launch<uint16_t>(q, s, rqf, rsf, n_q, n_s, k_dim, tiles_per_split,
                           pd, pi, dd, ii, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
