"""The bit-level identities of the tap epilogue kernel
(``ganleaks_tpu_torch/csrc/tap_epilogue.cu``, header items 1a-1d),
emulated in numpy float32/uint32 and held bit for bit against what each
replaces:

- 1a the division x / den as two Markstein steps on the correctly rounded
  reciprocal of den, against IEEE float32 division (numpy's), inside the
  domain where the kernel takes it;
- 1b the integer round to nearest even to bfloat16, against torch's cast;
- 1c float32 -> float64 built from the bits, against ``np.float64``;
- 1d the clamp-then-1.5*2^23 int8 rounding, against
  ``ops.distance.quantize_int8``;

and the kernel's whole per-element fast path against
``tap_epilogue_plain``. No GPU is needed: these check the arithmetic the
kernel relies on, not the kernel.
"""

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.ops.distance import quantize_int8
from ganleaks_tpu_torch.ops.lpips.epilogue import (EPS_NORM, channel_sumsq,
                                                   tap_epilogue_plain)

F32 = np.float32
MAGIC = F32(12582912.0)  # 1.5 * 2^23


def bits(x) -> np.ndarray:
    return np.asarray(x, F32).view(np.uint32)


def from_bits(u) -> np.ndarray:
    return np.asarray(u, np.uint32).view(F32)


# --- the emulations, one per identity --------------------------------------

def fma32(a, b, c) -> np.ndarray:
    """float32 fma, correctly rounded: a*b is exact in float64; a + c is
    rounded to odd in float64 (53 >= 24 + 2 bits, so the final rounding
    to float32 is correct)."""
    a, b, c = (np.asarray(v, F32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # TwoSum: p + c = s + err exactly
    even = (np.asarray(s).view(np.uint64) & 1) == 0
    bump = (err != 0) & even
    s = np.where(bump, np.nextafter(s, s + err), s)
    return s.astype(F32)


def div_markstein(x, den) -> np.ndarray:
    """1a: q = RN(x y), r = RN(den q - x), q = RN(q - r y), twice."""
    x, den = np.asarray(x, F32), np.asarray(den, F32)
    y = F32(1.0) / den
    q = x * y
    for _ in range(2):
        r = fma32(den, q, -x)
        q = fma32(-r, y, q)
    return q


def bf16_rne_bits(u) -> np.ndarray:
    """1b: float32 bits -> float32 bits of the bf16 value."""
    u = np.asarray(u, np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)


def f32_abs_to_f64(u, lo_zero: bool = False) -> np.ndarray:
    """1c: |float32| as float64 from its bits (normal or zero)."""
    a = np.asarray(u, np.uint64) & 0x7FFFFFFF
    hi = np.where(a != 0, (a >> 3) + 0x38000000, 0)
    lo = np.zeros_like(a) if lo_zero else (a << 29) & 0xFFFFFFFF
    return ((hi << 32) | lo).view(np.float64)


def int8_clamp_magic(b, qscale) -> np.ndarray:
    """1d: low byte of bits(min(max(b * qscale, -127), 127) + 1.5 * 2^23)."""
    bq = np.asarray(b, F32) * F32(qscale)
    r = np.minimum(np.maximum(bq, F32(-127)), F32(127))
    t = (r + MAGIC).astype(F32)
    return (bits(t) & 0xFF).astype(np.uint8).view(np.int8)


# --- 1d ----------------------------------------------------------------------

def _int8_cases(rng) -> np.ndarray:
    ties = np.arange(-256, 257, dtype=np.float64) / 2.0  # every .5 in [-128, 128]
    edges = [126.49999, 126.5, 126.50001, 127.0, 127.49999, 127.5, 128.0,
             128.5, 1e6, 3e38, np.inf]
    edges = np.array(edges + [-e for e in edges])
    zeros = np.array([0.0, -0.0])
    subn = np.array([1e-45, 1e-40, 1.1754942e-38, -1e-45, -1e-40])
    near = np.nextafter(ties.astype(F32), F32(np.inf))
    near_dn = np.nextafter(ties.astype(F32), F32(-np.inf))
    rand = rng.uniform(-140.0, 140.0, 20000)
    return np.concatenate([ties, edges, zeros, subn, near, near_dn,
                           rand]).astype(F32)


def test_int8_clamp_magic_every_case_with_unit_scale(rng):
    """qscale = 127 / 127 = 1: b * qscale is b, so the cases land on the
    ties, the clamp edges, zeros and subnormals as written."""
    b = _int8_cases(rng)
    want = quantize_int8(torch.from_numpy(b), 127.0).numpy()
    np.testing.assert_array_equal(int8_clamp_magic(b, F32(127.0 / 127.0)),
                                  want)


@pytest.mark.parametrize("bound", [0.06, 0.0123, 1.0, 3.5])
def test_int8_clamp_magic_over_tap_bounds(rng, bound):
    """Random values over a tap's bound (and past it), plus the values
    whose scaled image lands on or next to each half-integer."""
    qscale = F32(127.0 / bound)
    b = rng.uniform(-1.1 * bound, 1.1 * bound, 50000).astype(F32)
    ties = (np.arange(-255, 256) / 2.0 / float(qscale)).astype(F32)
    b = np.concatenate([b, ties, np.nextafter(ties, F32(np.inf)),
                        np.nextafter(ties, F32(-np.inf)),
                        F32([0.0, -0.0, bound, -bound])])
    want = quantize_int8(torch.from_numpy(b), bound).numpy()
    np.testing.assert_array_equal(int8_clamp_magic(b, qscale), want)


# --- 1b ----------------------------------------------------------------------

def _boundary_bits(rng, n_hi: int) -> np.ndarray:
    """float32 bit patterns at and next to every bf16 rounding boundary
    of ``n_hi`` bf16 values (random ones, both signs, plus the binade
    edges, the largest finite bf16, zeros and subnormals)."""
    hi = rng.integers(0, 0x7F80, n_hi, dtype=np.uint32)
    hi = np.concatenate([hi, [0, 1, 0x007F, 0x0080, 0x3F7F, 0x3F80, 0x7F7E,
                              0x7F7F]]).astype(np.uint32)
    hi = np.concatenate([hi, hi | 0x8000])
    base = hi << 16
    lows = np.array([0, 1, 0x7FFE, 0x7FFF, 0x8000, 0x8001, 0xFFFE, 0xFFFF],
                    np.uint32)
    return (base[:, None] | lows[None, :]).ravel()


def test_bf16_rne_bits_at_every_rounding_boundary(rng):
    u = _boundary_bits(rng, 4000)
    x = from_bits(u)
    assert np.isfinite(x).all()
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    got = (bf16_rne_bits(u) >> 16).astype(np.uint16).view(np.int16)
    np.testing.assert_array_equal(got, want)


def test_bf16_rne_bits_random_finite(rng):
    u = rng.integers(0, 2 ** 32, 200000, dtype=np.uint64).astype(np.uint32)
    u = u[np.isfinite(from_bits(u))]
    want = torch.from_numpy(from_bits(u)).to(torch.bfloat16) \
        .view(torch.int16).numpy()
    got = (bf16_rne_bits(u) >> 16).astype(np.uint16).view(np.int16)
    np.testing.assert_array_equal(got, want)


# --- 1c ----------------------------------------------------------------------

def test_f32_abs_to_f64_every_exponent(rng):
    """Every exponent field of a normal float32, random mantissas, both
    signs, and zeros (the fast path's b is normal or zero)."""
    exps = np.repeat(np.arange(1, 255, dtype=np.uint32), 64)
    mant = rng.integers(0, 1 << 23, exps.size, dtype=np.uint32)
    mant[::64] = 0
    mant[1::64] = (1 << 23) - 1
    mant[2::64] = 1
    u = np.concatenate([(exps << 23) | mant, [0]]).astype(np.uint32)
    u = np.concatenate([u, u | 0x80000000])
    want = np.abs(from_bits(u).astype(np.float64))
    np.testing.assert_array_equal(f32_abs_to_f64(u).view(np.uint64),
                                  want.view(np.uint64))


def test_f32_abs_to_f64_bf16_values_with_zero_low_word(rng):
    """bf16 values (low 16 bits zero): the low word of the double is 0."""
    u = rng.integers(0x0080, 0x7F80, 100000, dtype=np.uint32) << 16
    u[::2] |= 0x80000000
    u = np.concatenate([u, [0, 0x80000000, 0x00800000, 0x7F7F0000]]) \
        .astype(np.uint32)
    want = np.abs(from_bits(u).astype(np.float64))
    np.testing.assert_array_equal(
        f32_abs_to_f64(u, lo_zero=True).view(np.uint64),
        want.view(np.uint64))


# --- 1a ----------------------------------------------------------------------

def _dens(rng) -> np.ndarray:
    """Row-norm denominators sqrt(sum) + 1e-10 over the kernel's domain
    [2^-100, 2^24], and reciprocal-hard significands (all ones, powers of
    two, just above them)."""
    d = np.exp2(rng.uniform(-100, 24, 3000)).astype(F32)
    sig = np.array([1.0, 1.0 + 2 ** -23, 2.0 - 2 ** -23, 1.5, 1.25 + 2 ** -23],
                   np.float64)
    e = np.exp2(rng.integers(-99, 24, (sig.size, 40)).astype(np.float64))
    return np.concatenate([d, (sig[:, None] * e).ravel().astype(F32),
                           (np.sqrt(rng.uniform(0, 50, 500)) + EPS_NORM)
                           .astype(F32)])


def test_division_identity_random_numerators(rng):
    den = np.repeat(_dens(rng), 20)
    x = (den * rng.uniform(-1.0, 1.0, den.size)).astype(F32)
    x = np.where(np.abs(x) < 2.0 ** -96, F32(0), x)
    np.testing.assert_array_equal(bits(div_markstein(x, den)),
                                  bits(x / den))


def test_division_identity_near_rounding_midpoints(rng):
    """x chosen so that x / den lies within a few ulps of a midpoint
    between two float32 quotients: where a single correction step can
    round the wrong way."""
    den = np.repeat(_dens(rng), 30)
    q = (rng.uniform(0.5, 1.0, den.size)
         * np.exp2(rng.integers(-20, 1, den.size))).astype(F32)
    mid = (q.astype(np.float64) + np.nextafter(q, F32(2)).astype(np.float64)) / 2
    x = (mid * den.astype(np.float64)).astype(F32)
    x = np.concatenate([x, np.nextafter(x, F32(0)), np.nextafter(x, F32(9))])
    den = np.tile(den, 3)
    keep = np.abs(x) >= 2.0 ** -96
    np.testing.assert_array_equal(bits(div_markstein(x[keep], den[keep])),
                                  bits(x[keep] / den[keep]))


def test_division_identity_keeps_the_sign_of_zero():
    den = F32([1e-10, 1.0, 3.0, 2.0 ** 24])
    for z in (F32(0.0), F32(-0.0)):
        x = np.full(den.shape, z, F32)
        np.testing.assert_array_equal(bits(div_markstein(x, den)),
                                      bits(x / den))


# --- the whole fast path against the plain version's operations ----------

def ieee_den(fl: np.ndarray) -> np.ndarray:
    """sqrt(sum_c x^2) + 1e-10 per position, the sum in the epilogue's
    order and the square root correctly rounded, as on the card (numpy's;
    torch's CPU sqrt was seen one ulp off it on some of these inputs)."""
    s = channel_sumsq(torch.from_numpy(fl)).numpy()
    return (np.sqrt(s) + F32(EPS_NORM)).astype(F32)


def kernel_fast_path(fl: np.ndarray, den: np.ndarray, scale: np.ndarray,
                     embed_bf16: bool, qscale) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """The kernel's per-element fast path on (N, P, C) float32 values:
    the b bits (or int8 values when ``qscale``) and rn."""
    q = div_markstein(fl, den[..., None])
    u = bits((q * scale).astype(F32))
    ub = bf16_rne_bits(u) if embed_bf16 else u
    d = f32_abs_to_f64(ub, lo_zero=embed_bf16)
    rn = (d * d).sum(axis=(1, 2)).astype(F32)
    part = int8_clamp_magic(from_bits(ub), qscale) if qscale else ub
    return part, rn


@pytest.mark.parametrize("p,c", [(256, 64), (64, 128), (16, 256), (4, 512),
                                 (9, 96)])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_fast_path_matches_plain_ops(rng, p, c, mode):
    """The fast path against ``tap_epilogue_plain``'s operations (IEEE
    division, the scale, torch's bf16 cast, ``quantize_int8``, the float64
    rn) on the same correctly rounded denominators."""
    fl = np.maximum(rng.standard_normal((3, p, c)), 0).astype(F32)
    fl[0, 0] = 0.0  # a position of zeros: den = 1e-10
    scale = (np.abs(rng.standard_normal(c)) * 0.05).astype(F32)
    den = ieee_den(fl)
    edt = torch.float32 if mode == "f32" else torch.bfloat16
    phi = torch.from_numpy(fl) / torch.from_numpy(den)[..., None] \
        * torch.from_numpy(scale)
    b = phi.to(edt)
    rn_want = torch.sum(torch.square(b.double()), dim=(1, 2)).float()
    bound = 0.06 if mode == "int8" else None
    part, rn = kernel_fast_path(fl, den, scale, mode != "f32",
                                F32(127.0 / bound) if bound else None)
    if mode == "int8":
        np.testing.assert_array_equal(part, quantize_int8(b, bound).numpy())
    else:
        np.testing.assert_array_equal(part, bits(b.float().numpy()))
    np.testing.assert_allclose(rn, rn_want.numpy(), rtol=1e-6)


def test_fast_path_matches_plain_where_sqrt_agrees(rng):
    """Where torch's CPU sqrt gives the correctly rounded root (most
    positions), the fast path equals ``tap_epilogue_plain`` itself."""
    fl = np.maximum(rng.standard_normal((4, 64, 128)), 0).astype(F32)
    scale = (np.abs(rng.standard_normal(128)) * 0.05).astype(F32)
    den = ieee_den(fl)
    want, rn_want = tap_epilogue_plain(torch.from_numpy(fl), scale,
                                       embed_dtype=torch.bfloat16,
                                       out_dtype=torch.bfloat16,
                                       quant_bound=0.06)
    s = channel_sumsq(torch.from_numpy(fl))
    agree = (torch.sqrt(s) + EPS_NORM).numpy() == den
    assert agree.mean() > 0.9
    part, _ = kernel_fast_path(fl, den, scale, True, F32(127.0 / 0.06))
    np.testing.assert_array_equal(part[agree], want.numpy()[agree])


@pytest.mark.parametrize("embed_bf16", [False, True])
def test_fast_path_domain_keeps_b_normal_or_zero(rng, embed_bf16):
    """On the fast path's domain (nonzero |x| >= 2^-76, den in [2^-100,
    2^24], |s| in [2^-26, 2^100] or 0) b is normal or zero and finite, the
    inputs 1c takes: its corners and random points inside."""
    x = np.concatenate([F32([2.0 ** -76, -(2.0 ** -76), 0.0, 1.0]),
                        np.exp2(rng.uniform(-76, 24, 5000)).astype(F32)])
    den = np.concatenate([F32([2.0 ** 24, 2.0 ** 24, 1e-10, 2.0 ** -100]),
                          np.exp2(rng.uniform(-100, 24, 5000)).astype(F32)])
    den = np.maximum(den, np.abs(x))  # |x| <= den: it is a channel of it
    for s in (F32(2.0 ** -26), F32(2.0 ** 100), F32(0.0), F32(0.05)):
        u = bits((div_markstein(x, den) * s).astype(F32))
        b = from_bits(bf16_rne_bits(u) if embed_bf16 else u)
        a = np.abs(b)
        assert np.isfinite(b).all()
        assert ((a == 0) | (a >= np.finfo(F32).tiny)).all()
