// The LPIPS tower's pass after each convolution, for Hopper (sm_90a): the
// bias add, the ReLU and, where a 2x2 max pool follows, the pool, in one
// pass over the convolution's output.
//
// Replaces no kernel of the JAX package: XLA fuses the bias add and the
// ReLU into its convolution there. In the port the convolution is cuDNN's
// (F.conv2d with no bias), and this pass takes the place of three PyTorch
// passes that ran after it: the bias add (a broadcast over a channels-last
// output, PyTorch's non-vectorised elementwise kernel), F.relu (a second
// tensor) and F.max_pool2d (which read that tensor again).
//
// For x of shape (N, H, W, C) in memory (channels last, contiguous), float32
// or bfloat16, and a bias of C values of the same dtype, it writes in place
//
//     y = relu(x + b)
//
// and with `pooled` the 2x2, stride-2, floor-mode max pool of y into
// pooled (N, H/2, W/2, C) (a last odd row or column gets bias and ReLU but
// is not pooled).
//
// Bits. The result equals PyTorch's F.relu(x + b) then F.max_pool2d(y, 2,
// 2) on the card bit for bit, NaN and signed zeros included, since it runs
// the same float operations:
// * the add as PyTorch's add: float(x) + float(b) in float (__fadd_rn, so
//   nothing contracts), rounded once to the dtype (__float2bfloat16_rn);
// * the ReLU as PyTorch's clamp_min kernel: a NaN is kept as it is, any
//   other v becomes fmaxf(v, 0) in float, rounded back to the dtype;
// * the pool as PyTorch's channels-last max pool: a float running maximum
//   from -inf over the window in row order, taking a value that is
//   greater or NaN, rounded back to the dtype at the end.
//
// Bound. Bytes: each element of x is read once and written once, and each
// pooled element written once, so a VGG16 block is 2 bytes read and 2
// written an element in bf16 (plus a quarter where a pool follows) at
// 3.35 TB/s. Per element the pass does a handful of float operations, far
// below the card's issue rate, so the design is about bytes only:
// * each thread moves 16 bytes a load and a store (8 bfloat16 or 4 float32
//   channels), neighbouring threads on neighbouring channels;
// * each work item is one pooled pixel's 2x2 window at one 16-byte channel
//   slice: its four loads are issued before any arithmetic, the pooled
//   value is taken from registers, and no byte of x is read twice;
// * the bias slice stays in registers while the item's channel slice does
//   not change (on a 132-SM H100 the full grid's stride, 132 times the
//   resident blocks of 256 threads, a multiple of 2^10 * 33, is a multiple
//   of the slices a pixel of every tower's layer, so it never does);
// * a grid-stride loop over the items, with as many blocks as the SMs hold
//   at once (the occupancy query's count). There is no shared memory, TMA
//   or tensor core: a byte-bound stream needs none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// 16 bytes of one dtype, and the float operations on them
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  static constexpr int kN = 4;
  __device__ static float get(const uint4& v, int i) {
    return __uint_as_float((&v.x)[i]);
  }
  // relu(x + b) as PyTorch computes it in float32
  __device__ static void bias_relu(uint4& v, const uint4& b) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float s = __fadd_rn(get(v, i), get(b, i));
      if (!isnan(s)) s = fmaxf(s, 0.0f);
      (&v.x)[i] = __float_as_uint(s);
    }
  }
  __device__ static void store_max(uint4& out, const float* m) {
#pragma unroll
    for (int i = 0; i < kN; ++i) (&out.x)[i] = __float_as_uint(m[i]);
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __nv_bfloat16 raw(const uint4& v, int i) {
    uint32_t w = (&v.x)[i >> 1];
    return __ushort_as_bfloat16(
        static_cast<unsigned short>((i & 1) ? (w >> 16) : (w & 0xffffu)));
  }
  __device__ static float get(const uint4& v, int i) {
    return __bfloat162float(raw(v, i));
  }
  __device__ static void put(uint4& v, int i, __nv_bfloat16 h) {
    uint32_t& w = (&v.x)[i >> 1];
    uint32_t u = __bfloat16_as_ushort(h);
    w = (i & 1) ? ((w & 0xffffu) | (u << 16)) : ((w & 0xffff0000u) | u);
  }
  // PyTorch's bfloat16 add (float sum, one rounding), then its clamp_min:
  // a NaN stays as the add left it, else fmaxf in float, rounded back
  __device__ static void bias_relu(uint4& v, const uint4& b) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      __nv_bfloat16 r = __float2bfloat16_rn(__fadd_rn(get(v, i), get(b, i)));
      float f = __bfloat162float(r);
      if (!isnan(f)) r = __float2bfloat16_rn(fmaxf(f, 0.0f));
      put(v, i, r);
    }
  }
  __device__ static void store_max(uint4& out, const float* m) {
#pragma unroll
    for (int i = 0; i < kN; ++i) put(out, i, __float2bfloat16_rn(m[i]));
  }
};

// PyTorch's channels-last max pool step: take v where it is greater than
// the running maximum, or NaN
template <typename T>
__device__ __forceinline__ void pool_step(float* m, const uint4& v) {
#pragma unroll
  for (int i = 0; i < Lanes<T>::kN; ++i) {
    float f = Lanes<T>::get(v, i);
    if (f > m[i] || isnan(f)) m[i] = f;
  }
}

struct Params {
  void* x;
  const void* bias;
  void* pooled;     // null: no pool
  int64_t items;    // n * per_image
  uint32_t per_image;         // rows2 * cols2 * slices
  uint32_t slices;            // 16-byte channel groups a pixel
  uint32_t rows2, cols2;      // windows down and across (ceil of H/2, W/2)
  int height, width;
  int out_h, out_w;           // pooled size (floor of H/2, W/2)
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_relu_pool_kernel(const Params p) {
  uint4* x = static_cast<uint4*>(p.x);
  const uint4* bias = static_cast<const uint4*>(p.bias);
  uint4* pooled = static_cast<uint4*>(p.pooled);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  uint32_t cur_slice = 0xffffffffu;
  uint4 b = make_uint4(0, 0, 0, 0);
  for (int64_t it = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       it < p.items; it += stride) {
    // one 64-bit division an item; the rest within the image in 32 bits
    const int64_t n = it / p.per_image;
    uint32_t rest = static_cast<uint32_t>(it - n * p.per_image);
    const uint32_t s = rest % p.slices;
    rest /= p.slices;
    const int c2 = static_cast<int>(rest % p.cols2);
    const int r2 = static_cast<int>(rest / p.cols2);
    if (s != cur_slice) {
      b = bias[s];
      cur_slice = s;
    }
    const int h0 = 2 * r2, w0 = 2 * c2;
    const bool down = h0 + 1 < p.height, across = w0 + 1 < p.width;
    // the window's four pixels, in PyTorch's pool order: row by row
    const int64_t base =
        ((n * p.height + h0) * p.width + w0) * p.slices + s;
    const int64_t row = static_cast<int64_t>(p.width) * p.slices;
    uint4 v[4];
    v[0] = x[base];
    if (across) v[1] = x[base + p.slices];
    if (down) v[2] = x[base + row];
    if (down && across) v[3] = x[base + row + p.slices];
    Lanes<T>::bias_relu(v[0], b);
    x[base] = v[0];
    if (across) {
      Lanes<T>::bias_relu(v[1], b);
      x[base + p.slices] = v[1];
    }
    if (down) {
      Lanes<T>::bias_relu(v[2], b);
      x[base + row] = v[2];
    }
    if (down && across) {
      Lanes<T>::bias_relu(v[3], b);
      x[base + row + p.slices] = v[3];
    }
    if (pooled != nullptr && down && across) {
      float m[Lanes<T>::kN];
#pragma unroll
      for (int i = 0; i < Lanes<T>::kN; ++i) m[i] = -__int_as_float(0x7f800000);
#pragma unroll
      for (int k = 0; k < 4; ++k) pool_step<T>(m, v[k]);
      uint4 out;
      Lanes<T>::store_max(out, m);
      pooled[((n * p.out_h + r2) * p.out_w + c2) * p.slices + s] = out;
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bias_relu_pool_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t want = (p.items + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(want < most ? want : most);
  bias_relu_pool_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, height, width, c_dim) contiguous elements of dtype_code (0 =
// float32, 1 = bfloat16), 16-byte aligned, c_dim a multiple of 4 (float32)
// or 8 (bfloat16), written in place; bias: c_dim elements of the same
// dtype, 16-byte aligned; pooled: null, or (n, height / 2, width / 2,
// c_dim) contiguous elements (height and width at least 2). Launches on `stream` without synchronising;
// returns the cudaError_t of the launch (0 on success).
int bias_relu_pool_launch(int dtype_code, void* x, const void* bias, int n,
                          int height, int width, int c_dim, void* pooled,
                          void* stream) {
  const int lanes = dtype_code == 0 ? 4 : 8;
  if ((dtype_code != 0 && dtype_code != 1) || n <= 0 || height <= 0 ||
      width <= 0 || c_dim <= 0 || c_dim % lanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.bias = bias;
  p.pooled = pooled;
  p.height = height;
  p.width = width;
  p.slices = static_cast<uint32_t>(c_dim / lanes);
  p.rows2 = static_cast<uint32_t>((height + 1) / 2);
  p.cols2 = static_cast<uint32_t>((width + 1) / 2);
  const uint64_t per_image =
      static_cast<uint64_t>(p.rows2) * p.cols2 * p.slices;
  if (per_image > 0xffffffffu) return static_cast<int>(cudaErrorInvalidValue);
  p.per_image = static_cast<uint32_t>(per_image);
  p.out_h = height / 2;
  p.out_w = width / 2;
  p.items = static_cast<int64_t>(n) * p.per_image;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype_code == 0 ? launch<float>(p, st)
                                    : launch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}

}  // extern "C"
