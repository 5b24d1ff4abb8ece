// The float32 cross-term tile shared by the two distance kernels
// (knn_argmin.cu, K1, and knn_topk.cu, K3) on the CUDA cores: a 256-thread
// block computes the float32 dot products of a 128-query tile with a 128-row
// synthetic tile, each thread holding an 8x8 register block of <q_m, s_n>.
// bfloat16 inputs take the tensor-core tile of knn_tile_wgmma.cuh.
//
// K is walked in 16-deep stages through double-buffered shared memory, each
// thread accumulating its 8x8 block with fmaf. Every 8 stages (128 K
// values) the stage sums are added into the main accumulator: one running
// float32 sum of 512,000 products rounds by an estimated ~1e-5 of the sum,
// the two-level sum cuts that estimate to ~1e-6, under the 1e-5 * (rq + rs)
// tolerance the attack's index checks use. Bound at the attack's block
// (2048 x 2048, K = 512,000): 64.1 ms on the 67 TFLOP/s float32 CUDA cores
// of an H100 SXM at 700 W.
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns tile rows out_row(ty, i) and
// tile columns out_col(tx, j), i, j in [0, 8); the 16 lanes that share a row
// are one half of a warp and differ only in the low 4 lane bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace knn_tile {

constexpr int kTileQ = 128;      // queries per block
constexpr int kTileS = 128;      // synthetic rows per tile
constexpr int kStageK = 16;      // K depth per shared-memory stage
constexpr int kThreads = 256;    // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;          // keeps rows 16-byte aligned, eases banks
constexpr int kChunkStages = 8;  // stages per partial sum (128 K values)

struct Stages {
  float q[2][kStageK][kTileQ + kPad];
  float s[2][kStageK][kTileS + kPad];
};

// Four consecutive K values of one row, zero outside [0, n_rows) x [0, k_dim).
// VEC: rows are aligned for one vector load (k_dim % 4 == 0, aligned base).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ base,
                                        int row, int n_rows, int k,
                                        int k_dim) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= n_rows) return v;
  const float* p =
      base + static_cast<size_t>(row) * static_cast<size_t>(k_dim) + k;
  if (VEC && k + 3 < k_dim) return *reinterpret_cast<const float4*>(p);
  if (k < k_dim) v.x = p[0];
  if (k + 1 < k_dim) v.y = p[1];
  if (k + 2 < k_dim) v.z = p[2];
  if (k + 3 < k_dim) v.w = p[3];
  return v;
}

__device__ __forceinline__ int out_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int out_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc[i][j] = <q[m0 + out_row(ty, i)], s[n0 + out_col(tx, j)]> over all of K,
// rows past n_q / n_s read as zeros. Every thread of the block calls it; it
// ends on a barrier, so the stage buffers are free again on return.
template <bool VEC>
__device__ __forceinline__ void tile_dot(const float* __restrict__ q,
                                         const float* __restrict__ s, int m0,
                                         int n0, int n_q, int n_s, int k_dim,
                                         Stages& sm, float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_stages = (k_dim + kStageK - 1) / kStageK;
  // loader: 4 threads per row, 4 consecutive K values each, rows +0 / +64
  const int l_row = tid >> 2;
  const int l_k = (tid & 3) * 4;

  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      part[i][j] = 0.f;
    }

  float4 a_reg[2], b_reg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a_reg[r] = load4<VEC>(q, m0 + l_row + 64 * r, n_q, l_k, k_dim);
    b_reg[r] = load4<VEC>(s, n0 + l_row + 64 * r, n_s, l_k, k_dim);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = l_row + 64 * r;
    sm.q[0][l_k + 0][c] = a_reg[r].x; sm.q[0][l_k + 1][c] = a_reg[r].y;
    sm.q[0][l_k + 2][c] = a_reg[r].z; sm.q[0][l_k + 3][c] = a_reg[r].w;
    sm.s[0][l_k + 0][c] = b_reg[r].x; sm.s[0][l_k + 1][c] = b_reg[r].y;
    sm.s[0][l_k + 2][c] = b_reg[r].z; sm.s[0][l_k + 3][c] = b_reg[r].w;
  }
  __syncthreads();

  int buf = 0;
  for (int st = 0; st < n_stages; ++st) {
    const bool has_next = st + 1 < n_stages;
    if (has_next) {  // next stage's global loads overlap this stage's math
      const int k = (st + 1) * kStageK + l_k;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        a_reg[r] = load4<VEC>(q, m0 + l_row + 64 * r, n_q, k, k_dim);
        b_reg[r] = load4<VEC>(s, n0 + l_row + 64 * r, n_s, k, k_dim);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kStageK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.q[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.q[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.s[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.s[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    if (has_next) {
      const int nb = buf ^ 1;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = l_row + 64 * r;
        sm.q[nb][l_k + 0][c] = a_reg[r].x; sm.q[nb][l_k + 1][c] = a_reg[r].y;
        sm.q[nb][l_k + 2][c] = a_reg[r].z; sm.q[nb][l_k + 3][c] = a_reg[r].w;
        sm.s[nb][l_k + 0][c] = b_reg[r].x; sm.s[nb][l_k + 1][c] = b_reg[r].y;
        sm.s[nb][l_k + 2][c] = b_reg[r].z; sm.s[nb][l_k + 3][c] = b_reg[r].w;
      }
    }
    // one barrier per stage: the stores above went to the other buffer,
    // and nobody writes this buffer again before everyone passed here
    __syncthreads();
    buf ^= 1;
    if ((st + 1) % kChunkStages == 0 || !has_next) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }
}

// Whether rows of q and s can be read with one vector load per 4 values.
inline bool vector_rows(const float* q, const float* s, int k_dim) {
  return k_dim % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(s) % 16 == 0;
}

}  // namespace knn_tile
