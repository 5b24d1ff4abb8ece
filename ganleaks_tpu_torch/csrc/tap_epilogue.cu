// LPIPS tap epilogue in one pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ganleaks_tpu/ops/lpips/epilogue_pallas.py::tap_epilogue (kernels
// _kern_wide / _kern_halves, math _epilogue_math). For one raw VGG tap x of
// shape (N, H, W, C), read through the strides it is given, and for every
// (image n, position p, channel c):
//
//     phi = x / (sqrt(sum_c x^2) + 1e-10) * scale[c]
//     b   = phi rounded to the embed dtype (float32 or bfloat16)
//     out = int8 quantisation of b (round half to even of b * qscale,
//           clipped to +-127) or b cast to the output dtype
//     rn[n] = sum over p, c of b^2 (from the rounded b; summed in float64,
//             which costs nothing here and makes the order immaterial:
//             it is the float32 rounding of the exact sum, as in the plain
//             version, up to one unit in the last place)
//
// out[n, p * C + c] is written through a row stride, so a tap lands
// straight in its column slice of the engine's (N, K) embedding buffer.
//
// Rounding. The parts must equal the plain PyTorch version
// (ops/lpips/epilogue.tap_epilogue_plain) bit for bit: every operation is
// an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), so nvcc cannot contract or approximate, and the channel sum
// follows the plain version's order — each 32-channel chunk summed left to
// right from 0, then the chunk sums left to right (the order XLA's CPU
// backend uses for these channel counts, so the JAX package agrees too).
//
// Bound. Bytes: each input element is read once and each output written
// once, against ~10 operations per element, so the kernel is bound by
// device memory (3.35 TB/s).
//
// Design. One block per image walks its positions; one thread owns one
// 32-channel chunk of one position (T = next power of two of the chunk
// count, up to 32, lanes per position), loads it with 16-byte vector loads
// where the layout allows, keeps it in registers, sums its squares, and
// the T lanes of the position add the chunk sums in chunk order through
// shuffles. The same thread then writes its 32 outputs (16-byte vector
// stores where aligned). The image's rn is a fixed-order float64 block
// reduction, so it is the same on every run. Taps wider than 1024 channels
// take more than one round of chunks per lane and read their chunks twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_bits_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_bits_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float in_f32(float x) { return x; }
__device__ __forceinline__ float in_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// v[i] = row[(c0 + i) * s_c] for i < cnt, else 0.
template <typename Tin>
__device__ __forceinline__ void load_chunk(const Tin* __restrict__ row,
                                           int64_t s_c, int c0, int cnt,
                                           float (&v)[kChunk]) {
  const Tin* p = row + static_cast<int64_t>(c0) * s_c;
  const bool vec = cnt == kChunk && s_c == 1 &&
                   (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  if (vec) {
    if (sizeof(Tin) == 4) {
      const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
      for (int k = 0; k < kChunk / 4; ++k) {
        const float4 f = p4[k];
        v[4 * k] = f.x;
        v[4 * k + 1] = f.y;
        v[4 * k + 2] = f.z;
        v[4 * k + 3] = f.w;
      }
    } else {
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int k = 0; k < kChunk / 8; ++k) {
        const uint4 u = p4[k];
        v[8 * k] = bf16_bits_lo(u.x);
        v[8 * k + 1] = bf16_bits_hi(u.x);
        v[8 * k + 2] = bf16_bits_lo(u.y);
        v[8 * k + 3] = bf16_bits_hi(u.y);
        v[8 * k + 4] = bf16_bits_lo(u.z);
        v[8 * k + 5] = bf16_bits_hi(u.z);
        v[8 * k + 6] = bf16_bits_lo(u.w);
        v[8 * k + 7] = bf16_bits_hi(u.w);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    v[i] = i < cnt ? in_f32(p[static_cast<int64_t>(i) * s_c]) : 0.f;
}

// 32 output values as raw bits, packed and stored.
__device__ __forceinline__ void store_chunk(float* dst,
                                            const uint32_t (&o)[kChunk],
                                            int cnt) {
  if (cnt == kChunk && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < kChunk / 4; ++k)
      d4[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    if (i < cnt) dst[i] = __uint_as_float(o[i]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst,
                                            const uint32_t (&o)[kChunk],
                                            int cnt) {
  if (cnt == kChunk && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < kChunk / 8; ++k) {
      uint32_t w[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        w[t] = o[8 * k + 2 * t] | (o[8 * k + 2 * t + 1] << 16);
      d4[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    if (i < cnt) d16[i] = static_cast<uint16_t>(o[i]);
}
__device__ __forceinline__ void store_chunk(int8_t* dst,
                                            const uint32_t (&o)[kChunk],
                                            int cnt) {
  if (cnt == kChunk && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      uint32_t w[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int b = 16 * k + 4 * t;
        w[t] = (o[b] & 0xffu) | ((o[b + 1] & 0xffu) << 8) |
               ((o[b + 2] & 0xffu) << 16) | ((o[b + 3] & 0xffu) << 24);
      }
      d4[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    if (i < cnt) dst[i] = static_cast<int8_t>(o[i] & 0xffu);
}

// The output value of b as raw bits of Tout.
__device__ __forceinline__ uint32_t out_bits(float b, float qscale, float*) {
  return __float_as_uint(b);
}
__device__ __forceinline__ uint32_t out_bits(float b, float qscale,
                                             __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(b));
}
__device__ __forceinline__ uint32_t out_bits(float b, float qscale, int8_t*) {
  float r = rintf(__fmul_rn(b, qscale));  // round half to even
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int32_t>(r));
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
tap_epilogue_kernel(const Tin* __restrict__ x, int n_pos, int width, int c_dim,
                    int64_t s_n, int64_t s_h, int64_t s_w, int64_t s_c,
                    const float* __restrict__ scale, int embed_bf16,
                    float qscale, Tout* __restrict__ out, int64_t out_s_n,
                    float* __restrict__ rn_out) {
  __shared__ double red[kWarps];
  const int n = blockIdx.x;
  const int n_chunks = (c_dim + kChunk - 1) / kChunk;
  int lanes = 1;  // lanes per position: a power of two, at most 32
  while (lanes < n_chunks && lanes < 32) lanes <<= 1;
  const int rounds = (n_chunks + lanes - 1) / lanes;
  const int per_warp = 32 / lanes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / lanes;   // position within the warp
  const int li = lane % lanes;  // chunk within the round
  const Tin* xn = x + static_cast<int64_t>(n) * s_n;
  Tout* on = out + static_cast<int64_t>(n) * out_s_n;

  double rn_local = 0.0;
  for (int p0 = 0; p0 < n_pos; p0 += kWarps * per_warp) {  // block-uniform
    const int p = p0 + warp * per_warp + g;
    const bool valid = p < n_pos;
    const Tin* row =
        xn + (valid ? (p / width) * s_h + (p % width) * s_w : int64_t{0});
    float v[kChunk];
    float sum = 0.f;
    for (int r = 0; r < rounds; ++r) {
      const int m = r * lanes + li;
      const int cnt =
          valid && m < n_chunks ? min(kChunk, c_dim - m * kChunk) : 0;
      load_chunk(row, s_c, m * kChunk, cnt, v);
      float cs = 0.f;  // this chunk, left to right (zeros past C add 0)
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        cs = __fadd_rn(cs, __fmul_rn(v[i], v[i]));
      for (int j = 0; j < lanes; ++j) {  // chunk sums in chunk order
        const float o = __shfl_sync(0xffffffffu, cs, g * lanes + j);
        if (r * lanes + j < n_chunks) sum = __fadd_rn(sum, o);
      }
    }
    const float den = __fadd_rn(__fsqrt_rn(sum), 1e-10f);
    for (int r = 0; r < rounds; ++r) {
      const int m = r * lanes + li;
      const int cnt =
          valid && m < n_chunks ? min(kChunk, c_dim - m * kChunk) : 0;
      if (cnt == 0) continue;
      if (rounds > 1) load_chunk(row, s_c, m * kChunk, cnt, v);
      uint32_t o[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float sc = i < cnt ? scale[m * kChunk + i] : 0.f;
        const float phi = __fmul_rn(__fdiv_rn(v[i], den), sc);
        const float b =
            embed_bf16 ? __bfloat162float(__float2bfloat16_rn(phi)) : phi;
        rn_local = fma(static_cast<double>(b), static_cast<double>(b),
                       rn_local);  // b*b is exact in float64; zero past C
        o[i] = out_bits(b, qscale, static_cast<Tout*>(nullptr));
      }
      store_chunk(on + static_cast<int64_t>(p) * c_dim + m * kChunk, o, cnt);
    }
  }

  // the image's rn in a fixed order: lanes, then warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    rn_local += __shfl_xor_sync(0xffffffffu, rn_local, off);
  if (lane == 0) red[warp] = rn_local;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    rn_out[n] = __double2float_rn(t);
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, int n, int n_pos, int width, int c_dim,
                   const int64_t* strides, const float* scale, int embed_bf16,
                   float qscale, void* out, int64_t out_s_n, float* rn,
                   cudaStream_t stream) {
  tap_epilogue_kernel<Tin, Tout><<<n, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), n_pos, width, c_dim, strides[0], strides[1],
      strides[2], strides[3], scale, embed_bf16, qscale,
      static_cast<Tout*>(out), out_s_n, rn);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_out(int out_code, const void* x, int n, int n_pos,
                       int width, int c_dim, const int64_t* strides,
                       const float* scale, int embed_bf16, float qscale,
                       void* out, int64_t out_s_n, float* rn,
                       cudaStream_t stream) {
  switch (out_code) {
    case 0:
      return launch<Tin, float>(x, n, n_pos, width, c_dim, strides, scale,
                                embed_bf16, qscale, out, out_s_n, rn, stream);
    case 1:
      return launch<Tin, __nv_bfloat16>(x, n, n_pos, width, c_dim, strides,
                                        scale, embed_bf16, qscale, out,
                                        out_s_n, rn, stream);
    case 2:
      return launch<Tin, int8_t>(x, n, n_pos, width, c_dim, strides, scale,
                                 embed_bf16, qscale, out, out_s_n, rn, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: the tap, (n, height, width, c_dim) elements of in_code (0 = float32,
// 1 = bfloat16) at element strides strides[0..3]; scale: c_dim float32;
// embed_bf16: round phi to bfloat16 (else keep float32); out_code: 0 =
// float32, 1 = bfloat16, 2 = int8 (quantised with qscale = 127 / bound);
// out: n rows of height * width * c_dim contiguous elements, out_s_n
// elements apart; rn: n float32. Launches on `stream` without
// synchronising; returns the cudaError_t of the launch (0 on success).
int tap_epilogue_launch(int in_code, const void* x, int n, int height,
                        int width, int c_dim, const int64_t* strides,
                        const void* scale, int embed_bf16, int out_code,
                        float qscale, void* out, int64_t out_s_n, void* rn,
                        void* stream) {
  if (n <= 0 || height <= 0 || width <= 0 || c_dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  auto* r = static_cast<float*>(rn);
  auto st = static_cast<cudaStream_t>(stream);
  const int n_pos = height * width;
  cudaError_t err;
  if (in_code == 0) {
    err = launch_out<float>(out_code, x, n, n_pos, width, c_dim, strides, sc,
                            embed_bf16, qscale, out, out_s_n, r, st);
  } else if (in_code == 1) {
    err = launch_out<__nv_bfloat16>(out_code, x, n, n_pos, width, c_dim,
                                    strides, sc, embed_bf16, qscale, out,
                                    out_s_n, r, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
