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
//     rn[n] = sum over p, c of b^2 (from the rounded b; each b^2 is exact
//             in float64 and the sum is taken in float64 in a fixed order,
//             then rounded once to float32)
//
// out[n, p * C + c] is written through a row stride, so a tap lands
// straight in its column slice of the engine's (N, K) embedding buffer.
//
// Rounding. The parts equal the plain PyTorch version
// (ops/lpips/epilogue.tap_epilogue_plain) bit for bit: every float32
// operation is an explicitly rounded intrinsic, so nvcc cannot contract or
// approximate, and the channel sum follows the plain version's order —
// each 32-channel chunk summed left to right from 0, then the chunk sums
// left to right (the order XLA's CPU backend uses for these channel
// counts, so the JAX package agrees too). Square root and division stay
// correctly rounded.
//
// Bound. Bytes: each input element is read once and each output written
// once (3 bytes per element in bf16 -> int8, 8 in float32), so at
// 3.35 TB/s an element may cost about 30 issued instructions on the card's
// 132 SMs before the issue rate, not device memory, is the limit. The
// design keeps the per-element work near that (about 30 instructions in
// the bf16 -> int8 fast path's SASS), on the full-rate pipes.
//
// 1. No slow-pipe instruction per element. The pipe that runs at 16
//    results per clock per SM (MUFU, the F2F/F2I/FRND conversions) is
//    used once per position, for the reciprocal; each element then runs
//    only FMA-pipe and integer instructions. The identities, each exact
//    (tests/test_torch_epilogue_bits.py emulates them bit for bit):
//
//    a) Division x / den. y = __frcp_rn(den), the correctly rounded
//       reciprocal, once per position. Per element, two Markstein steps:
//           q = RN(x y);  r = RN(den q - x);  q = RN(q - r y);
//           r = RN(den q - x);  q = RN(q - r y)
//       (each RN(. - .) one fma, so r is the exact residual). The first
//       step leaves q within one ulp of x / den; Markstein's theorem then
//       makes the second step's q the correctly rounded quotient, the
//       value of __fdiv_rn, provided nothing underflows or overflows. The
//       residual is taken as den q - x, not x - den q, so that x = -0
//       gives -0 as the division does.
//       The fast path's domain: 2^-100 <= den <= 2^24, every nonzero
//       |x| >= 2^-76, and every scale value 0 or of magnitude in
//       [2^-26, 2^100]. There the residuals are exact, every nonzero q
//       has |q| >= 2^-100, and so b is finite and normal or zero. A chunk
//       outside it (and every chunk, when the scale is outside it) takes
//       the reference path, the same operations through __fdiv_rn,
//       __float2bfloat16_rn, rintf and float -> double conversions, so
//       NaN, inf and subnormal values never reach the identities.
//    b) bf16 rounding of phi: u = bits(phi);
//           bits(b) = (u + 0x7fff + ((u >> 16) & 1)) & 0xffff0000
//       round to nearest even on the bits, with the carry into the
//       exponent giving the next binade and, past the largest bf16, inf —
//       what __float2bfloat16_rn gives for every finite phi. On a NaN it
//       would not (a carry can turn it into inf or -0); NaN only arises on
//       the reference path, which keeps __float2bfloat16_rn.
//    c) float32 -> float64 for rn, on the integer pipe: with a = |u|,
//           double(hi = a ? (a >> 3) + (896 << 20) : 0, lo = a << 29)
//       is |b| for a normal or zero b (the exponent rebiased from 127 to
//       1023, the mantissa moved up by 29 bits). Then rn += |b| * |b| in
//       one DFMA. For bf16 embeds lo is 0.
//    d) int8: r = min(max(b * qscale, -127), 127), then t = r + 1.5 * 2^23
//       rounds r half to even (t lies in [2^23, 2^24), where the float
//       spacing is 1), and the low byte of bits(t) is the int8. Clamping
//       first gives the same result as rounding first: rounding is
//       monotone and the bounds are integers. (NaN maps to -127 in both.)
//
// 2. Loads that overlap compute. Where a tap's image is one contiguous run
//    of P * C elements (channels last, C a multiple of 32 up to 1024, 16-
//    byte aligned: every tower tap), a tile of P_t positions is one 1-D
//    cp.async.bulk copy into shared memory. One thread keeps a ring of
//    stages in flight (4 of 16 KB for bf16 taps, 3 of 32 KB for float32),
//    each with an mbarrier that completes on the copy's bytes; all 8 warps
//    compute on the stage that has arrived. A thread owns one 32-channel
//    chunk of one position: it reads it with 16-byte shared loads (chunks
//    are 64 or 128 bytes apart, so a quarter-warp phase meets 4-way (bf16)
//    or 8-way (float32) bank conflicts, well under the shared-memory rate
//    this needs), sums it, and writes its outputs back to shared memory,
//    where the tile's outputs lie as one contiguous run; after a
//    __syncthreads one bulk store (cp.async.bulk shared -> global) writes
//    that run into the out row, and the freed stage takes the tile
//    kStages ahead. bf16 -> int8 (the main path) has a ring of output
//    stages of its own, so a tile needs that one barrier; other modes
//    write their outputs over their input stage and need a second barrier
//    after the reads (a second ring would leave room for one block per SM).
//    The scale lives in shared memory as [4-channel quad][lane], so
//    neighbouring lanes read neighbouring 16 bytes. Output rows that are
//    not 16-byte aligned, and outputs wider than the input, take direct
//    stores instead. __launch_bounds__(256, 2): two blocks, 16 warps, per
//    SM, at most 128 registers a thread.
//
// 3. A grid that fills the card. The grid is the occupancy's resident
//    blocks per SM times the SM count (at most N), and each block walks
//    the (image, tile) items of a contiguous range of whole images through
//    its ring, across image boundaries. The tile is 256 / lanes positions,
//    lanes = the chunk count rounded up to a power of two, so a tile is
//    8192 channels whatever (P, C). A block finishes each image it owns,
//    so the image's rn is reduced in one fixed order (each thread's
//    elements in order, a shuffle tree, then the warps in order) and is
//    the same on every run, with no scratch and no second pass. With
//    N = 2,048 images per call, as on the main path, every block owns 7
//    or 8 images; below 264 images (two blocks on each of 132 SMs) the
//    grid is N blocks.
//
// Layouts the bulk path does not take (s_c != 1, rows not contiguous or
// not 16-byte aligned, C not a multiple of 32, C > 1024) run in a second
// kernel of this file, on a generic load path: each thread loads its
// chunks straight from global memory through the strides (taps wider than
// 1024 channels take several rounds of chunks per lane and read their
// chunks twice), with the same arithmetic and so the same results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // per SM: 16 warps resident
constexpr int kChunk = 32;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
// Built with -DTAP_EPILOGUE_FAST_ONLY (tools/bench_tap_epilogue.py does, to
// count the fast path's instructions in the SASS), the reference path is
// left out: that build gives wrong results outside the identities' domain.
#ifdef TAP_EPILOGUE_FAST_ONLY
constexpr bool kFastOnly = true;
#else
constexpr bool kFastOnly = false;
#endif

struct Params {
  const void* x;
  int n, n_pos, width, c_dim;
  int64_t s_n, s_h, s_w, s_c;
  const float* scale;
  float qscale;
  void* out;
  int64_t out_s_n;
  float* rn;
  int lanes, nch, rounds, tile_pos, tiles, stages;
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier and the 1-D bulk copy
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

// Arm `bar` for `bytes` and copy them from global `src` to shared `dst`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Copy `bytes` from shared `src` to global `dst` as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}

// Wait until every committed bulk store has read its shared memory.
__device__ __forceinline__ void bulk_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until every committed bulk store is complete.
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes visible to the bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_bits_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_bits_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const float4* p4, float (&v)[kChunk]) {
#pragma unroll
  for (int k = 0; k < kChunk / 4; ++k) {
    const float4 f = p4[k];
    v[4 * k] = f.x;
    v[4 * k + 1] = f.y;
    v[4 * k + 2] = f.z;
    v[4 * k + 3] = f.w;
  }
}
__device__ __forceinline__ void unpack(const uint4* p4, float (&v)[kChunk]) {
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

template <typename Tin>
using Vec16 = typename std::conditional<sizeof(Tin) == 4, float4, uint4>::type;

__device__ __forceinline__ float in_f32(float x) { return x; }
__device__ __forceinline__ float in_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// v[i] = row[(c0 + i) * s_c] for i < cnt, else 0 (the generic path).
template <typename Tin>
__device__ __forceinline__ void load_chunk(const Tin* __restrict__ row,
                                           int64_t s_c, int c0, int cnt,
                                           float (&v)[kChunk]) {
  const Tin* p = row + static_cast<int64_t>(c0) * s_c;
  if (cnt == kChunk && s_c == 1 &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    unpack(reinterpret_cast<const Vec16<Tin>*>(p), v);
    return;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    v[i] = i < cnt ? in_f32(p[static_cast<int64_t>(i) * s_c]) : 0.f;
}

// ---------------------------------------------------------------------------
// the per-element identities (header, 1a-1d)
// ---------------------------------------------------------------------------

constexpr uint32_t kTinyBits = 0x19800000u;  // 2^-76
constexpr float kMagic = 12582912.f;         // 1.5 * 2^23

// 1b: bits of bf16(phi), round to nearest even, for finite phi
__device__ __forceinline__ uint32_t bf16_rne_bits(uint32_t u) {
  return (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
}

// 1c: |b| as float64 from the bits of float32 b, normal or zero
template <bool kLoZero>
__device__ __forceinline__ double f32_abs_to_f64(uint32_t u) {
  const uint32_t a = u & 0x7fffffffu;
  return __hiloint2double(
      a ? static_cast<int>((a >> 3) + 0x38000000u) : 0,
      kLoZero ? 0 : static_cast<int>(a << 29));
}

// 1a + 1b: bits of b on the identities; y = __frcp_rn(den)
template <bool kEmbedBf16>
__device__ __forceinline__ uint32_t embed_fast(float x, float s, float den,
                                               float y) {
  float q = __fmul_rn(x, y);
  float r = __fmaf_rn(den, q, -x);
  q = __fmaf_rn(-r, y, q);
  r = __fmaf_rn(den, q, -x);
  q = __fmaf_rn(-r, y, q);
  const uint32_t u = __float_as_uint(__fmul_rn(q, s));
  return kEmbedBf16 ? bf16_rne_bits(u) : u;
}

// the reference path: the same values through the conversion intrinsics
template <bool kEmbedBf16>
__device__ __forceinline__ uint32_t embed_ref(float x, float s, float den) {
  const float phi = __fmul_rn(__fdiv_rn(x, den), s);
  return kEmbedBf16 ? static_cast<uint32_t>(__bfloat16_as_ushort(
                          __float2bfloat16_rn(phi)))
                          << 16
                    : __float_as_uint(phi);
}

// The output value of b (bits ub) as raw bits of Tout (low bits).
template <bool kFast, bool kEmbedBf16>
__device__ __forceinline__ uint32_t out_bits(uint32_t ub, float, float*) {
  return ub;
}
template <bool kFast, bool kEmbedBf16>
__device__ __forceinline__ uint32_t out_bits(uint32_t ub, float,
                                             __nv_bfloat16*) {
  if (kEmbedBf16) return ub >> 16;
  return kFast ? bf16_rne_bits(ub) >> 16
               : __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(ub)));
}
template <bool kFast, bool kEmbedBf16>
__device__ __forceinline__ uint32_t out_bits(uint32_t ub, float qscale,
                                             int8_t*) {
  const float bq = __fmul_rn(__uint_as_float(ub), qscale);
  if (kFast)  // 1d
    return __float_as_uint(__fadd_rn(fminf(fmaxf(bq, -127.f), 127.f), kMagic));
  const float r = fminf(fmaxf(rintf(bq), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int32_t>(r));
}

// ---------------------------------------------------------------------------
// stores: one group of 16 bytes of output
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_group(float* dst, const uint32_t (&o)[4],
                                            bool vec, int cnt) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < cnt) dst[j] = __uint_as_float(o[j]);
}
__device__ __forceinline__ void store_group(__nv_bfloat16* dst,
                                            const uint32_t (&o)[8], bool vec,
                                            int cnt) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        __byte_perm(o[0], o[1], 0x5410), __byte_perm(o[2], o[3], 0x5410),
        __byte_perm(o[4], o[5], 0x5410), __byte_perm(o[6], o[7], 0x5410));
    return;
  }
  uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < cnt) d16[j] = static_cast<uint16_t>(o[j]);
}
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {  // low bytes
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}
__device__ __forceinline__ void store_group(int8_t* dst,
                                            const uint32_t (&o)[16], bool vec,
                                            int cnt) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack4(o[0], o[1], o[2], o[3]), pack4(o[4], o[5], o[6], o[7]),
                   pack4(o[8], o[9], o[10], o[11]),
                   pack4(o[12], o[13], o[14], o[15]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < cnt) dst[j] = static_cast<int8_t>(o[j] & 0xffu);
}

// Where a chunk's scale comes from: shared memory laid out as [quad of 4
// channels][lane] (the bulk path: neighbouring lanes read neighbouring 16
// bytes), or global memory (the generic path, guarded past C).
struct ScaleShared {
  const float* base;  // this lane's first quad
  int stride;         // floats from one quad to the next
  __device__ __forceinline__ float4 quad(int q) const {
    return *reinterpret_cast<const float4*>(base + q * stride);
  }
};
struct ScaleGlobal {
  const float* base;  // the chunk's first channel
  int cnt;
  __device__ __forceinline__ float4 quad(int q) const {
    const float* s = base + 4 * q;
    if (4 * q + 4 <= cnt && (reinterpret_cast<uintptr_t>(s) & 15) == 0)
      return __ldg(reinterpret_cast<const float4*>(s));
    return make_float4(4 * q < cnt ? s[0] : 0.f, 4 * q + 1 < cnt ? s[1] : 0.f,
                       4 * q + 2 < cnt ? s[2] : 0.f,
                       4 * q + 3 < cnt ? s[3] : 0.f);
  }
};

// The chunk's outputs (cnt of them) to dst (16-byte stores where `vec`),
// and its b^2 into rn.
template <typename Tout, bool kEmbedBf16, bool kFast, typename Scale>
__device__ __forceinline__ void emit_chunk(const float (&v)[kChunk],
                                           const Scale& sc, int cnt, float den,
                                           float y, float qscale, Tout* dst,
                                           bool vec, double& rn) {
  constexpr int kPer = 16 / sizeof(Tout);  // outputs per 16-byte group
#pragma unroll
  for (int g0 = 0; g0 < kChunk; g0 += kPer) {
    uint32_t o[kPer];
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const float4 s4 = sc.quad(g0 / 4 + q);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g0 + 4 * q + e;
        uint32_t ub;
        double d;
        if (kFast) {
          ub = embed_fast<kEmbedBf16>(v[i], s[e], den, y);
          d = f32_abs_to_f64<kEmbedBf16>(ub);
        } else {
          ub = embed_ref<kEmbedBf16>(v[i], s[e], den);
          d = static_cast<double>(__uint_as_float(ub));
        }
        rn = fma(d, d, rn);  // exact square; zero past C
        o[4 * q + e] = out_bits<kFast, kEmbedBf16>(
            ub, qscale, static_cast<Tout*>(nullptr));
      }
    }
    store_group(dst + g0, o, vec, cnt - g0);
  }
}

// The channel sum of one 32-channel chunk, left to right from 0 (zeros past
// C add 0), and whether it holds a nonzero |x| < 2^-96 (header, 1a).
__device__ __forceinline__ float chunk_sumsq(const float (&v)[kChunk],
                                             bool& tiny) {
  float cs = 0.f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    cs = __fadd_rn(cs, __fmul_rn(v[i], v[i]));
    tiny |= (__float_as_uint(v[i]) & 0x7fffffffu) - 1u < kTinyBits - 1u;
  }
  return cs;
}

// The position's channel sum: the chunk sums of its `lanes` lanes (lanes
// from `gbase`, chunks from `m0`) added in chunk order onto `sum`; four
// shuffles at a time, so their latencies overlap.
__device__ __forceinline__ float add_chunk_sums(float sum, float cs,
                                                int gbase, int lanes, int m0,
                                                int nch) {
  for (int j = 0; j < lanes; j += 4) {
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      o[u] = __shfl_sync(0xffffffffu, cs, (gbase + j + u) & 31);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j + u < lanes && m0 + j + u < nch) sum = __fadd_rn(sum, o[u]);
  }
  return sum;
}

// Does every scale value keep phi normal or zero and finite on the fast
// path, |s| in [2^-26, 2^100] or s = 0? (header, 1c; a block-wide answer,
// false sends every chunk down the reference path)
__device__ __forceinline__ bool scale_in_domain(const float* scale,
                                                int c_dim) {
  bool ok = true;
  for (int c = threadIdx.x; c < c_dim; c += kThreads) {
    const float a = fabsf(scale[c]);
    ok = ok && (a == 0.f || (a >= 0x1p-26f && a <= 0x1p100f));
  }
  return __syncthreads_and(ok);
}

// The image's rn in a fixed order: each thread's elements in order (done),
// a shuffle tree, then the warps in order. Block-uniform call.
__device__ __forceinline__ void write_rn(double& rn_local, double* red,
                                         float* dst) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    rn_local += __shfl_xor_sync(0xffffffffu, rn_local, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = rn_local;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    *dst = __double2float_rn(s);
  }
  rn_local = 0.0;
}

// ---------------------------------------------------------------------------
// the bulk path: tiles through a ring of cp.async.bulk stages
// ---------------------------------------------------------------------------

// Shared memory of the bulk path: the input stages, then (bf16 -> int8
// only) one output stage per input stage, then the scale. Other outputs
// are staged in their input stage once it has been read, since a second
// ring would leave room for one block per SM only.
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kThreads * kChunk * static_cast<int>(sizeof(T));
}
template <typename Tin, typename Tout>
__host__ __device__ constexpr bool out_ring() {
  return sizeof(Tin) == 2 && sizeof(Tout) == 1;
}
template <typename Tin, typename Tout>
__host__ __device__ constexpr int ring_bytes(int stages) {
  return stages * (stage_bytes<Tin>() +
                   (out_ring<Tin, Tout>() ? stage_bytes<Tout>() : 0));
}
constexpr int kScaleBytes = 32 * kChunk * 4;  // up to 1024 channels

template <typename Tin, typename Tout, bool kEmbedBf16, bool kBulkStore>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tap_epilogue_bulk(const Params p) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ double red[kWarps];
  constexpr int kStage = stage_bytes<Tin>();
  constexpr bool kOutRing = kBulkStore && out_ring<Tin, Tout>();
  const int tid = threadIdx.x;
  const int lanes = p.lanes;
  const int g = tid / lanes;   // position within the tile
  const int li = tid % lanes;  // chunk of the position
  const int gbase = (tid & 31) & ~(lanes - 1);
  const int c_dim = p.c_dim;
  const Tin* x = static_cast<const Tin*>(p.x);
  Tout* out = static_cast<Tout*>(p.out);
  const int i0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * p.n /
                                  gridDim.x);
  const int i1 = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) *
                                  p.n / gridDim.x);
  const int64_t k_end = static_cast<int64_t>(i1 - i0) * p.tiles;

  // the scale as [quad][lane] floats4, so a lane reads 16-byte steps
  float* scale_s =
      reinterpret_cast<float*>(ring + ring_bytes<Tin, Tout>(p.stages));
  for (int c = tid; c < p.nch * kChunk; c += kThreads) {
    const int m = c / kChunk, i = c % kChunk;
    scale_s[((i / 4) * lanes + m) * 4 + i % 4] = c < c_dim ? p.scale[c] : 0.f;
  }
  const bool scale_ok = scale_in_domain(p.scale, c_dim);  // also a barrier
  const ScaleShared sc{scale_s + li * 4, lanes * 4};

  // the producer's cursor: image, tile, stage of the next load
  int ld_n = i0, ld_t = 0, ld_s = 0;
  auto issue = [&]() {
    const int p0 = ld_t * p.tile_pos;
    const int np = min(p.tile_pos, p.n_pos - p0);
    bulk_load(smem_u32(ring + ld_s * kStage),
              x + ld_n * p.s_n + static_cast<int64_t>(p0) * c_dim,
              static_cast<uint32_t>(np * c_dim * sizeof(Tin)),
              smem_u32(&full[ld_s]));
    if (++ld_t == p.tiles) ld_t = 0, ++ld_n;
    if (++ld_s == p.stages) ld_s = 0;
  };
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int64_t k = 0; k < p.stages && k < k_end; ++k) issue();

  double rn_local = 0.0;
  int n = i0, t = 0, s = 0;
  uint32_t parity = 0;
  for (int64_t k = 0; k < k_end; ++k) {  // block-uniform
    const int p0 = t * p.tile_pos;
    const int np = min(p.tile_pos, p.n_pos - p0);
    const int pos = p0 + g;
    const bool valid = g < np && li < p.nch;
    unsigned char* stage = ring + s * kStage;
    mbar_wait(smem_u32(&full[s]), parity);

    // pass 1: the chunk from shared memory, the channel sum in chunk order
    float v[kChunk];
    if (valid) {
      unpack(reinterpret_cast<const Vec16<Tin>*>(
                 reinterpret_cast<const Tin*>(stage) + g * c_dim +
                 li * kChunk),
             v);
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = 0.f;
    }
    bool tiny = false;
    const float cs = chunk_sumsq(v, tiny);
    const float sum = add_chunk_sums(0.f, cs, gbase, lanes, 0, p.nch);
    const float den = __fadd_rn(__fsqrt_rn(sum), 1e-10f);
    const float y = __frcp_rn(den);
    const bool fast = scale_ok && !tiny && den >= 0x1p-100f && den <= 0x1p24f;
    unsigned char* ostage =
        kOutRing ? ring + p.stages * kStage + s * stage_bytes<Tout>() : stage;
    if (kBulkStore && !kOutRing)
      __syncthreads();  // the stage is read: outputs go there

    // pass 2: the parts (into shared memory, or straight out) and rn
    Tout* dst = kBulkStore
                    ? reinterpret_cast<Tout*>(ostage) + g * c_dim + li * kChunk
                    : out + n * p.out_s_n +
                          static_cast<int64_t>(pos) * c_dim + li * kChunk;
    const bool vec =
        kBulkStore || (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
    if (valid) {
      if (kFastOnly || fast)
        emit_chunk<Tout, kEmbedBf16, true>(v, sc, kChunk, den, y, p.qscale,
                                           dst, vec, rn_local);
      else
        emit_chunk<Tout, kEmbedBf16, false>(v, sc, kChunk, den, y, p.qscale,
                                            dst, vec, rn_local);
    }
    if (kBulkStore) fence_async_shared();
    __syncthreads();  // the stage's outputs are written, its inputs read
    if (tid == 0) {
      if (kBulkStore) {
        bulk_store(out + n * p.out_s_n + static_cast<int64_t>(p0) * c_dim,
                   smem_u32(ostage),
                   static_cast<uint32_t>(np * c_dim * sizeof(Tout)));
        bulk_store_read_wait();  // before the stage takes its next tile
      }
      if (k + p.stages < k_end) issue();
    }
    if (t == p.tiles - 1) write_rn(rn_local, red, p.rn + n);
    if (++t == p.tiles) t = 0, ++n;
    if (++s == p.stages) s = 0, parity ^= 1u;
  }
  if (kBulkStore && tid == 0) bulk_store_wait();
}

// ---------------------------------------------------------------------------
// the generic path: chunks straight from global memory through the strides
// ---------------------------------------------------------------------------

template <typename Tin, typename Tout, bool kEmbedBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tap_epilogue_generic(const Params p) {
  __shared__ double red[kWarps];
  const int tid = threadIdx.x;
  const int lanes = p.lanes;
  const int g = tid / lanes;
  const int li = tid % lanes;
  const int gbase = (tid & 31) & ~(lanes - 1);
  const int c_dim = p.c_dim;
  const Tin* x = static_cast<const Tin*>(p.x);
  Tout* out = static_cast<Tout*>(p.out);
  const int i0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * p.n /
                                  gridDim.x);
  const int i1 = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) *
                                  p.n / gridDim.x);
  const bool scale_ok = scale_in_domain(p.scale, c_dim);

  double rn_local = 0.0;
  for (int n = i0; n < i1; ++n) {  // block-uniform
    for (int t = 0; t < p.tiles; ++t) {
      const int pos = t * p.tile_pos + g;
      const bool valid = pos < p.n_pos;
      const Tin* row =
          x + n * p.s_n +
          (valid ? (pos / p.width) * p.s_h + (pos % p.width) * p.s_w
                 : int64_t{0});
      float v[kChunk];
      float sum = 0.f;
      bool tiny = false;
      for (int r = 0; r < p.rounds; ++r) {
        const int m = r * lanes + li;
        const int cnt =
            valid && m < p.nch ? min(kChunk, c_dim - m * kChunk) : 0;
        load_chunk(row, p.s_c, m * kChunk, cnt, v);
        const float cs = chunk_sumsq(v, tiny);
        sum = add_chunk_sums(sum, cs, gbase, lanes, r * lanes, p.nch);
      }
      const float den = __fadd_rn(__fsqrt_rn(sum), 1e-10f);
      const float y = __frcp_rn(den);
      const bool fast =
          scale_ok && !tiny && den >= 0x1p-100f && den <= 0x1p24f;
      Tout* orow = out + n * p.out_s_n + static_cast<int64_t>(pos) * c_dim;
      for (int r = 0; r < p.rounds; ++r) {
        const int m = r * lanes + li;
        const int cnt =
            valid && m < p.nch ? min(kChunk, c_dim - m * kChunk) : 0;
        if (cnt == 0) continue;
        if (p.rounds > 1) load_chunk(row, p.s_c, m * kChunk, cnt, v);
        const ScaleGlobal sc{p.scale + m * kChunk, cnt};
        Tout* dst = orow + m * kChunk;
        const bool vec =
            cnt == kChunk && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
        if (kFastOnly || fast)
          emit_chunk<Tout, kEmbedBf16, true>(v, sc, cnt, den, y, p.qscale,
                                             dst, vec, rn_local);
        else
          emit_chunk<Tout, kEmbedBf16, false>(v, sc, cnt, den, y, p.qscale,
                                              dst, vec, rn_local);
      }
    }
    write_rn(rn_local, red, p.rn + n);
    __syncthreads();  // red is free again
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The persistent grid: resident blocks per SM times the SM count, at most n.
template <typename Kernel>
cudaError_t grid_size(Kernel kern, int smem, int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  *grid = static_cast<int>(
      std::min<int64_t>(n, static_cast<int64_t>(std::max(per_sm, 1)) * sms));
  return cudaSuccess;
}

template <typename Tin, typename Tout, bool kEmbedBf16>
cudaError_t launch(Params p, bool bulk, bool bulk_store,
                   cudaStream_t stream) {
  int grid = 0;
  cudaError_t err;
  if (!bulk) {
    auto kern = tap_epilogue_generic<Tin, Tout, kEmbedBf16>;
    if ((err = grid_size(kern, 0, p.n, &grid)) != cudaSuccess) return err;
    kern<<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  auto kern = bulk_store ? tap_epilogue_bulk<Tin, Tout, kEmbedBf16, true>
                         : tap_epilogue_bulk<Tin, Tout, kEmbedBf16, false>;
  const int smem = ring_bytes<Tin, Tout>(p.stages) + kScaleBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  if ((err = grid_size(kern, smem, p.n, &grid)) != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_embed(Params p, int embed_bf16, cudaStream_t stream) {
  const int64_t ei = sizeof(Tin), eo = sizeof(Tout);
  const int64_t c = p.c_dim;
  // the bulk path: each image one contiguous, 16-byte aligned run
  const bool bulk = p.s_c == 1 && (p.width == 1 || p.s_w == c) &&
                    (p.n_pos == p.width || p.s_h == p.width * c) &&
                    c % kChunk == 0 && c <= 32 * kChunk &&
                    (reinterpret_cast<uintptr_t>(p.x) & 15) == 0 &&
                    (p.n == 1 || (p.s_n * ei) % 16 == 0);
  // and its bulk store: the output tile fits in the stage, rows aligned
  const bool bulk_store = eo <= ei &&
                          (reinterpret_cast<uintptr_t>(p.out) & 15) == 0 &&
                          (p.n == 1 || (p.out_s_n * eo) % 16 == 0);
  return embed_bf16 ? launch<Tin, Tout, true>(p, bulk, bulk_store, stream)
                    : launch<Tin, Tout, false>(p, bulk, bulk_store, stream);
}

template <typename Tin>
cudaError_t launch_out(int out_code, Params p, int embed_bf16,
                       cudaStream_t stream) {
  p.stages = sizeof(Tin) == 4 ? 3 : 4;
  switch (out_code) {
    case 0:
      return launch_embed<Tin, float>(p, embed_bf16, stream);
    case 1:
      return launch_embed<Tin, __nv_bfloat16>(p, embed_bf16, stream);
    case 2:
      return launch_embed<Tin, int8_t>(p, embed_bf16, stream);
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
  Params p;
  p.x = x;
  p.n = n;
  p.n_pos = height * width;
  p.width = width;
  p.c_dim = c_dim;
  p.s_n = strides[0];
  p.s_h = strides[1];
  p.s_w = strides[2];
  p.s_c = strides[3];
  p.scale = static_cast<const float*>(scale);
  p.qscale = qscale;
  p.out = out;
  p.out_s_n = out_s_n;
  p.rn = static_cast<float*>(rn);
  p.nch = (c_dim + kChunk - 1) / kChunk;
  p.lanes = 1;  // lanes per position: a power of two, at most 32
  while (p.lanes < p.nch && p.lanes < 32) p.lanes <<= 1;
  p.rounds = (p.nch + p.lanes - 1) / p.lanes;
  p.tile_pos = kThreads / p.lanes;
  p.tiles = (p.n_pos + p.tile_pos - 1) / p.tile_pos;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_code == 0)
    err = launch_out<float>(out_code, p, embed_bf16, st);
  else if (in_code == 1)
    err = launch_out<__nv_bfloat16>(out_code, p, embed_bf16, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
