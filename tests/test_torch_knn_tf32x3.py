"""The 3xTF32 split of the float32 kNN tile (``csrc/knn_tile_tf32x3.cuh``),
emulated in plain torch and held against float64. The kernel cannot run
here; these check the arithmetic it relies on, not the kernel:

- ``rna_tf32``, the kernel's integer identity on the float32 bits,
  ``(u + 0x1000) & ~0x1fff`` (the rounding of ``cvt.rna.tf32.f32``),
  against a float64 rounding to 11 significant bits, ties away from zero:
  exact midpoints, their neighbours, zeros, subnormals, large and mixed
  magnitudes;
- the split x = hi + lo + e: hi and lo keep at most 10 explicit mantissa
  bits, x - hi is exact in float32, |e| <= 2^-22 |x| (2^-137 at the
  bottom of the normal range);
- the three products hi.hi + hi.lo + lo.hi, summed exactly (float64), within
  3.01 * 2^-22 * sum |a b| of the float64 dot product (the dropped terms'
  bound, the header's accuracy note), and the kernel's order of sums
  (float32 accumulators over 128 K values, promoted into a float32 sum)
  within 1e-6 * sum |a b| at K = 4,096, on adversarial and on non-negative
  (LPIPS-like) rows;
- the argmin of the emulated d = (rq + rs) - 2 sum equals float64's
  wherever float64's best two lie more than TOL * (rq + rs) apart
  (TOL = 1e-5, the attack's gate).
"""

import numpy as np
import pytest
import torch

F32 = np.float32
TOL = 1e-5
DROPPED = 3.01 * 2.0 ** -22  # the split's dropped terms, relative to |a b|
PROMOTE = 128                # K values per tensor-core accumulator


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, on the bits: adding half a TF32 ulp to the
    magnitude carries into the kept bits exactly when the dropped 13 bits
    are >= 0x1000. Finite inputs only; values within half a TF32 ulp of
    the float32 maximum round to inf."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def rna_reference(x: np.ndarray) -> np.ndarray:
    """float64 rounding of float32 ``x`` to 11 significant bits (TF32's
    quantum 2^-136 below 2^-126), ties away from zero, back to float32."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(np.abs(x64))
    quantum = np.ldexp(1.0, np.maximum(e, -125) - 11)
    r = np.sign(x64) * np.floor(np.abs(x64) / quantum + 0.5) * quantum
    with np.errstate(over="ignore"):
        out = r.astype(F32)
    return np.where(x64 == 0, x, out)  # keeps the sign of zero


def bits_of(x) -> np.ndarray:
    return np.asarray(x, F32).view(np.uint32)


def from_bits(u) -> np.ndarray:
    return np.asarray(u, np.uint32).view(F32)


def special_values(rng) -> np.ndarray:
    """Exact TF32 midpoints and their neighbours at many exponents, both
    signs; zeros; subnormals; large and tiny normals."""
    exps = np.arange(1, 255, dtype=np.uint32)  # every normal exponent
    top = rng.integers(0, 1 << 10, exps.size).astype(np.uint32) << 13
    out = []
    for low in (0x1000, 0x0fff, 0x1001, 0x0000, 0x1fff, 0x0001):
        for sign in (0, 1):
            out.append((sign << 31) | (exps << 23) | top | low)
    # subnormals (exponent 0), midpoints among them too
    sub = rng.integers(1, 1 << 23, 200).astype(np.uint32)
    out += [sub, sub | (1 << 31), (sub & ~np.uint32(0x1fff)) | 0x1000]
    out.append(np.array([0, 1 << 31, 0x00001000, 0x00002000, 0x00800000,
                         0x7f7fe000, 0x7f7fefff, 0xff7fe000],
                        dtype=np.uint32))
    return from_bits(np.concatenate(out))


@pytest.fixture
def values(rng) -> np.ndarray:
    """Special values and random floats of mixed scales (2^-60 .. 2^60)."""
    mixed = (rng.standard_normal(20000)
             * np.exp2(rng.integers(-60, 61, 20000))).astype(F32)
    return np.concatenate([special_values(rng), mixed])


def test_rna_matches_round_half_away_reference(values):
    """The bit identity is a rounding to 11 significant bits, ties away from
    zero, everywhere on the finite floats below the overflow edge."""
    got = rna_tf32(torch.from_numpy(values)).numpy()
    want = rna_reference(values)
    assert np.array_equal(bits_of(got), bits_of(want))


def test_rna_rounds_midpoints_away_from_zero():
    """At an exact midpoint (dropped bits 0x1000) the magnitude rounds up,
    for either sign; one below rounds down, one above up."""
    base = np.array([0x3f800000, 0x40490000, 0x00400000, 0x7e000000],
                    dtype=np.uint32)  # 1.0, 3.14..., a subnormal, 2^125
    for sign in (0, 1 << 31):
        b = base | sign
        mid = rna_tf32(torch.from_numpy(from_bits(b | 0x1000))).numpy()
        below = rna_tf32(torch.from_numpy(from_bits(b | 0x0fff))).numpy()
        above = rna_tf32(torch.from_numpy(from_bits(b | 0x1001))).numpy()
        assert np.array_equal(bits_of(mid), b + 0x2000)
        assert np.array_equal(bits_of(below), b)
        assert np.array_equal(bits_of(above), b + 0x2000)


def test_rna_zero_subnormal_and_overflow_edges():
    """Zeros keep their sign, the smallest subnormals round to 0 or to one
    TF32 quantum, and only values within half a TF32 ulp of the float32
    maximum round to inf (the embeddings never come near it)."""
    u = np.array([0x00000000, 0x80000000, 0x00000fff, 0x00001000,
                  0x80001000, 0x7f7fefff, 0x7f7ff000], dtype=np.uint32)
    got = bits_of(rna_tf32(torch.from_numpy(from_bits(u))).numpy())
    assert got.tolist() == [0x00000000, 0x80000000, 0x00000000, 0x00002000,
                            0x80002000, 0x7f7fe000, 0x7f800000]


def test_split_keeps_ten_mantissa_bits_and_bounds_the_rest(values):
    """hi and lo have their low 13 bits clear (at most 10 explicit mantissa
    bits: what a TF32 wgmma reads), x - hi is exact in float32,
    |x - hi| <= 2^-11 |x| and |x - (hi + lo)| <= 2^-22 |x| — each at least
    half TF32's subnormal quantum 2^-136 where a part falls below float32's
    normal range (|x| < ~2^-115)."""
    finite = values[np.abs(values.astype(np.float64)) < 3.0e38]
    x = torch.from_numpy(finite)
    hi, lo = split(x)
    assert not (bits_of(hi.numpy()) & 0x1fff).any()
    assert not (bits_of(lo.numpy()) & 0x1fff).any()
    x64, hi64 = x.double(), hi.double()
    assert torch.equal((x - hi).double(), x64 - hi64)
    err = (x64 - hi64 - lo.double()).abs()
    assert bool((err <= torch.clamp(2.0 ** -22 * x64.abs(),
                                    min=2.0 ** -137)).all())
    assert bool(((x64 - hi64).abs() <= torch.clamp(2.0 ** -11 * x64.abs(),
                                                   min=2.0 ** -137)).all())


def dot_rows(kind: str, rng, n: int, k_dim: int) -> np.ndarray:
    """Rows of ``kind``: 'relu' (LPIPS-like, every product >= 0),
    'midpoints' (every value an exact TF32 midpoint: hi rounds away, lo is
    a whole half ulp), 'near_midpoints' (dropped bits 0x0fff / 0x1001),
    'mixed' (magnitudes spread over 2^-20 .. 2^20, signed)."""
    if kind == "relu":
        return np.maximum(rng.standard_normal((n, k_dim)), 0).astype(F32) \
            / np.sqrt(k_dim, dtype=F32)
    if kind == "mixed":
        return (rng.standard_normal((n, k_dim))
                * np.exp2(rng.integers(-20, 21, (n, k_dim)))).astype(F32)
    top = rng.integers(0, 1 << 10, (n, k_dim)).astype(np.uint32) << 13
    exp = rng.integers(120, 128, (n, k_dim)).astype(np.uint32) << 23
    low = (np.full((n, k_dim), 0x1000, np.uint32) if kind == "midpoints"
           else rng.choice(np.array([0x0fff, 0x1001], np.uint32),
                           (n, k_dim)))
    sign = rng.integers(0, 2, (n, k_dim)).astype(np.uint32) << 31
    return from_bits(sign | exp | top | low)


def emulated_dot(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The tile's cross terms as the kernel orders them: per 128 K values a
    float32 accumulator of lo.hi, hi.lo and hi.hi (each product exact in
    float32), promoted into a float32 sum."""
    qh, ql = split(q)
    sh, sl = split(s)
    total = torch.zeros((q.shape[0], s.shape[0]), dtype=torch.float32)
    for k0 in range(0, q.shape[1], PROMOTE):
        c = slice(k0, k0 + PROMOTE)
        acc = ql[:, c] @ sh[:, c].T
        acc = acc + qh[:, c] @ sl[:, c].T
        acc = acc + qh[:, c] @ sh[:, c].T
        total = total + acc
    return total


@pytest.mark.parametrize("kind", ["relu", "midpoints", "near_midpoints",
                                  "mixed"])
def test_three_products_within_bound_of_float64(rng, kind):
    """At K = 4,096: the three products summed exactly are within the
    dropped terms' bound of the float64 dot product; in the kernel's
    float32 order of sums within 1e-6 * sum |a b|."""
    k_dim = 4096
    q = torch.from_numpy(dot_rows(kind, rng, 16, k_dim))
    s = torch.from_numpy(dot_rows(kind, rng, 24, k_dim))
    q64, s64 = q.double(), s.double()
    exact = q64 @ s64.T
    scale = q64.abs() @ s64.abs().T
    qh, ql = (t.double() for t in split(q))
    sh, sl = (t.double() for t in split(s))
    three = ql @ sh.T + qh @ sl.T + qh @ sh.T
    assert bool(((three - exact).abs() <= DROPPED * scale).all())
    got = emulated_dot(q, s).double()
    assert bool(((got - exact).abs() <= 1e-6 * scale).all())


def test_split_beats_plain_tf32_by_orders_of_magnitude(rng):
    """One TF32 product per multiply-add (hi.hi only) is ~1e-3 off on
    LPIPS-like rows: the reason for three."""
    q = torch.from_numpy(dot_rows("relu", rng, 8, 4096))
    s = torch.from_numpy(dot_rows("relu", rng, 8, 4096))
    exact = q.double() @ s.double().T
    one = rna_tf32(q).double() @ rna_tf32(s).double().T
    three = emulated_dot(q, s).double()
    assert float(((three - exact).abs() / exact).max()) < 1e-6
    assert float(((one - exact).abs() / exact).max()) > 1e-5


@pytest.mark.parametrize("kind", ["relu", "mixed"])
def test_emulated_argmin_matches_float64_where_clear(rng, kind):
    """d = (rq + rs) - 2 sum with the emulated sums: within TOL * (rq + rs)
    of float64's, and the first minimal index equals float64's wherever
    float64's best two are further apart than that; planted near-copies
    found."""
    k_dim, n_q, n_s = 4096, 48, 400
    q = torch.from_numpy(dot_rows(kind, rng, n_q, k_dim))
    s = torch.from_numpy(dot_rows(kind, rng, n_s, k_dim))
    planted = {3: 17, 20: 399, 40: 128}
    for row, a in planted.items():
        noise = rng.standard_normal(k_dim).astype(F32) * F32(0.02)
        s[a] = q[row] * (1 + torch.from_numpy(noise))
    rq = torch.sum(q * q, dim=1)
    rs = torch.sum(s * s, dim=1)
    d = (rq[:, None] + rs[None, :]) - 2.0 * emulated_dot(q, s)
    d64 = (rq.double()[:, None] + rs.double()[None, :]
           - 2.0 * (q.double() @ s.double().T))
    norms = rq.double()[:, None] + rs.double()[None, :]
    assert bool(((d.double() - d64).abs() <= TOL * norms).all())
    idx = torch.argmin(d, dim=1)
    idx64 = torch.argmin(d64, dim=1)
    top2 = torch.topk(d64, 2, dim=1, largest=False).values
    gate = TOL * (rq.double() + rs.double()[idx64])
    clear = (top2[:, 1] - top2[:, 0]) > gate
    assert bool(clear.any())
    assert torch.equal(idx[clear], idx64[clear])
    for row, a in planted.items():
        assert int(idx[row]) == a == int(idx64[row])
