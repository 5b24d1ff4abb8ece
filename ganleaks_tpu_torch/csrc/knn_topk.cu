// Fused distance + running per-query top-k over embedding rows, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel ganleaks_tpu/ops/knn_pallas.py::knn_topk_pallas
// (kernel _knn_topk_kernel). For every query row q_m it returns the k
// smallest
//
//     d(m, n) = rq[m] + rs[n] - 2 * <q_m, s_n>
//
// in ascending order, the earliest synthetic index first among equal
// distances (torch.min's tie-break extended to k entries), with their
// indices. When N_s < k the trailing entries are d = +inf, index -1. The
// cross term accumulates in float32 over K and the (N_q x N_s) distance
// matrix never reaches memory. Pass 1 of the two-pass exact-index mode.
//
// Bound. The same work as the argmin kernel (knn_argmin.cu): 2*N_q*N_s*K
// operations against (N_q + N_s)*K input elements, far above the card's
// operations-per-byte balance, so it is bound by arithmetic: at the attack's
// block (2048 x 2048, K = 512,000) 4.34 ms for bfloat16 inputs on the bf16
// tensor cores, 26.0 ms for float32 inputs on the TF32 tensor cores (three
// TF32 products per multiply-add; 64.1 ms on the float32 CUDA cores) (H100
// SXM, 700 W).
//
// Design: the argmin kernel's two tiles and split, with a k-list epilogue.
//  * Each query row keeps a running list of k (d, index) entries in
//    dynamic shared memory, ascending, initialised to (+inf, -1). After a
//    tile, the lanes that share a row extract the tile's first minimal
//    column (a lexicographic (d, index) shuffle) k times; an extracted entry
//    is inserted by one lane after every running entry of equal distance
//    whenever it beats the list's last entry, and the owning lane masks the
//    column. Running entries come from earlier tiles (lower indices), so
//    "ascending d, earliest index first" holds — the running entries are
//    merged before the tile's, as in the TPU kernel.
//  * knn_topk_partial_wgmma<Tile>: the argmin kernel's CTA on the bf16 tile
//    (knn_wgmma::Bf16) or the 3xTF32 tile (knn_tf32x3::Tile) for float32;
//    a row's columns lie on the 4 lanes of a quad, 32 each, d computed in
//    place in the promoted sum. The lists (128 x k x 8 bytes) share the
//    CTA's shared memory with the ring, so the launch picks the ring's
//    stage count from k (either tile: 6 up to k = 33, 3 at k = 128).
//  * Pass 2 (knn_topk_merge_kernel) merges each query's per-span lists in
//    span order by the same insertion, earlier spans first among equals.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <climits>

#include "knn_tile_tf32x3.cuh"
#include "knn_tile_wgmma.cuh"

namespace {

using knn_wgmma::kTileQ;
using knn_wgmma::kTileS;

// running lists: kTileQ * k * 8 bytes of dynamic shared memory
constexpr int kMaxK = 128;

// Insert (d, i) into the ascending list (ld, li) of length k, after every
// entry whose distance is <= d; the last entry drops out. The caller checks
// d < ld[k - 1].
__device__ __forceinline__ void insert_entry(float* ld, int* li, int k,
                                             float d, int i) {
  int p = k - 1;
  while (p > 0 && ld[p - 1] > d) {
    ld[p] = ld[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  ld[p] = d;
  li[p] = i;
}

template <class Tile>
__global__ void __launch_bounds__(knn_wgmma::kThreads, 1)
knn_topk_partial_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_s,
                       const float* __restrict__ rq,
                       const float* __restrict__ rs, int n_q, int n_s,
                       int k_dim, int k, int tiles_per_split, int n_stages,
                       float* __restrict__ part_d,
                       int* __restrict__ part_i) {
  extern __shared__ unsigned char smem[];
  const typename Tile::Ring ring(smem, n_stages);
  float* run_d = reinterpret_cast<float*>(ring.extra);
  int* run_i = reinterpret_cast<int*>(run_d + kTileQ * k);
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
    const int quad_lane = threadIdx.x & 3;
    int rows[2], lane_col;
    knn_wgmma::frag_rows(rows, lane_col);
    float rqh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rqh[h] = m0 + rows[h] < n_q ? rq[m0 + rows[h]] : 0.f;
      // each row's list belongs to its quad alone: no barrier across warps
      for (int e = quad_lane; e < k; e += 4) {
        run_d[rows[h] * k + e] = CUDART_INF_F;
        run_i[rows[h] * k + e] = -1;
      }
    }
    __syncwarp();
    knn_wgmma::Cursor c;
    float acc[knn_wgmma::kFragRegs], dv[knn_wgmma::kFragRegs];
#pragma unroll
    for (int j = 0; j < knn_wgmma::kFragRegs; ++j) acc[j] = 0.f;

    for (int t = t_begin; t < t_end; ++t) {
      const int n0 = t * kTileS;
      Tile::consume_tile(ring, c, wg, n_kb, acc, dv);
#pragma unroll
      for (int j = 0; j < knn_wgmma::kFragRegs; ++j) {  // d in place
        const int col = n0 + 8 * (j >> 2) + lane_col + (j & 1);
        dv[j] = col < n_s ? (rqh[(j >> 1) & 1] + rs[col]) - 2.f * dv[j]
                          : CUDART_INF_F;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* ld = run_d + rows[h] * k;
        int* li = run_i + rows[h] * k;
        // rounds run on every lane of the warp (full-mask shuffles) until
        // no row of the warp can enter its list: a round that cannot enter
        // changes nothing, and neither can any later one
        for (int r = 0; r < k; ++r) {
          float best_d = CUDART_INF_F;
          int best_i = INT_MAX;
#pragma unroll
          for (int j = 0; j < knn_wgmma::kFragRegs; ++j) {  // columns ascend
            if (((j >> 1) & 1) == h && dv[j] < best_d) {
              best_d = dv[j];
              best_i = n0 + 8 * (j >> 2) + lane_col + (j & 1);
            }
          }
          knn_wgmma::quad_min(best_d, best_i);
          const bool take = best_d < ld[k - 1];  // same on the quad's lanes
          if (!__any_sync(0xffffffffu, take)) break;
          __syncwarp();  // every lane read ld[k - 1] before lane 0 writes
          if (take) {
            if (quad_lane == 0) insert_entry(ld, li, k, best_d, best_i);
#pragma unroll
            for (int j = 0; j < knn_wgmma::kFragRegs; ++j)
              if (((j >> 1) & 1) == h &&
                  n0 + 8 * (j >> 2) + lane_col + (j & 1) == best_i)
                dv[j] = CUDART_INF_F;
          }
          __syncwarp();  // the insert is visible to the next round's reads
        }
      }
    }
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + rows[h];
      if (m < n_q) {
        const size_t o = (static_cast<size_t>(split) * n_q + m) * k;
        for (int e = quad_lane; e < k; e += 4) {
          part_d[o + e] = run_d[rows[h] * k + e];
          part_i[o + e] = run_i[rows[h] * k + e];
        }
      }
    }
  }
}

__global__ void knn_topk_merge_kernel(const float* __restrict__ part_d,
                                      const int* __restrict__ part_i,
                                      int n_splits, int n_q, int k,
                                      float* __restrict__ d_out,
                                      int* __restrict__ i_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_q) return;
  float* ld = d_out + static_cast<size_t>(m) * k;
  int* li = i_out + static_cast<size_t>(m) * k;
  for (int j = 0; j < k; ++j) {
    ld[j] = CUDART_INF_F;
    li[j] = -1;
  }
  for (int sp = 0; sp < n_splits; ++sp) {  // spans in index order
    const size_t base = (static_cast<size_t>(sp) * n_q + m) * k;
    for (int j = 0; j < k; ++j) {  // each span's list is ascending
      const float d = part_d[base + j];
      if (!(d < ld[k - 1])) break;
      insert_entry(ld, li, k, d, part_i[base + j]);
    }
  }
}

template <class Tile>
cudaError_t launch(dim3 grid, size_t lists_bytes, cudaStream_t stream,
                   const void* q, const void* s, const float* rq,
                   const float* rs, int n_q, int n_s, int k_dim, int k,
                   int tiles_per_split, float* part_d, int* part_i) {
  CUtensorMap map_q, map_s;
  int n_stages;
  size_t smem;
  const cudaError_t err = knn_wgmma::prepare_launch<Tile>(
      knn_topk_partial_wgmma<Tile>, q, s, n_q, n_s, k_dim, lists_bytes,
      &map_q, &map_s, &n_stages, &smem);
  if (err != cudaSuccess) return err;
  knn_topk_partial_wgmma<Tile><<<grid, knn_wgmma::kThreads, smem, stream>>>(
      map_q, map_s, rq, rs, n_q, n_s, k_dim, k, tiles_per_split, n_stages,
      part_d, part_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per synthetic tile: the wrapper sizes the partial buffers with it.
int knn_topk_tile_rows() { return kTileS; }

// dtype: 0 = float32 (3xTF32 tile; k_dim % 4 == 0), 1 = bfloat16 (bf16
// tile; k_dim % 8 == 0); 16-byte-aligned q and s, for TMA. q (n_q, k_dim)
// and s (n_s, k_dim) are row-major and contiguous; rq (n_q,), rs (n_s,) float32 squared row
// norms. part_d/part_i hold n_splits * n_q * k entries, with
// n_splits = ceil(ceil(n_s / tile_rows) / tiles_per_split); d_out/i_out hold
// n_q * k, row-major. Launches on `stream` without synchronising; returns
// the cudaError_t of the launches (0 on success).
int knn_topk_launch(int dtype, const void* q, const void* s, const void* rq,
                    const void* rs, int n_q, int n_s, int k_dim, int k,
                    int tiles_per_split, void* part_d, void* part_i,
                    void* d_out, void* i_out, void* stream) {
  if (n_q <= 0 || n_s <= 0 || k_dim <= 0 || k <= 0 || k > kMaxK ||
      tiles_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_s + kTileS - 1) / kTileS;
  const int n_splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const int q_tiles = (n_q + kTileQ - 1) / kTileQ;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_splits, q_tiles);
  const size_t lists_bytes =
      static_cast<size_t>(kTileQ) * k * (sizeof(float) + sizeof(int));
  const auto* rqf = static_cast<const float*>(rq);
  const auto* rsf = static_cast<const float*>(rs);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<knn_tf32x3::Tile>(grid, lists_bytes, st, q, s, rqf, rsf, n_q,
                                   n_s, k_dim, k, tiles_per_split, pd, pi);
  } else if (dtype == 1) {
    err = launch<knn_wgmma::Bf16>(grid, lists_bytes, st, q, s, rqf, rsf, n_q,
                                  n_s, k_dim, k, tiles_per_split, pd, pi);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_topk_merge_kernel<<<(n_q + 255) / 256, 256, 0, st>>>(
      pd, pi, n_splits, n_q, k, static_cast<float*>(d_out),
      static_cast<int*>(i_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
