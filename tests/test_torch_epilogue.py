"""The tap epilogue of the port (``ganleaks_tpu_torch.ops.lpips.epilogue``)
against the JAX package's Pallas kernel in interpret mode
(``ganleaks_tpu.ops.lpips.epilogue_pallas.tap_epilogue(...,
interpret=True)``), over ``tests/test_epilogue_pallas.py``'s tap shapes
and its three modes.

Parts must be equal bit for bit once the JAX output is unpacked from its
TPU lane packing (``_unpack_lanes(..., mode='halves')``): both compute
``x / (sqrt(sum_c x^2) + 1e-10) * scale`` with correctly rounded ops in
the same order, the channel sum included (``channel_sumsq``).

The row norms rn: the port's is the float32 rounding of a float64 sum and
must lie within rtol 1e-6 of the float64 sum of squares of the rounded
parts. The JAX kernel sums in float32 in XLA's tile order, measured up to
1.3e-6 off that float64 sum on these shapes, so port and JAX agree within
rtol 2e-6.

On the CPU the wrapper takes its plain PyTorch version; the CUDA kernel is
compared with that version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops.lpips.epilogue_pallas import tap_epilogue as j_tap
from ganleaks_tpu.ops.lpips.lpips import _unpack_lanes
from ganleaks_tpu_torch.ops.lpips.epilogue import (channel_sumsq,
                                                   tap_epilogue,
                                                   tap_epilogue_plain)

TAP_SHAPES = [  # (P, C) of every vgg tap at 16x16 input + a 64x64 tap0
    (256, 64), (64, 128), (16, 256), (4, 512), (1, 512), (4096, 64),
]
MODES = {  # (embed dtype, out dtype, int8 bound) in JAX and in the port
    "bf16": ((jnp.bfloat16, jnp.bfloat16, None),
             (torch.bfloat16, torch.bfloat16)),
    "f32-demote": ((jnp.float32, jnp.bfloat16, None),
                   (torch.float32, torch.bfloat16)),
    "int8": ((jnp.bfloat16, jnp.int8, 0.06),
             (torch.bfloat16, torch.int8)),
}


def _tap(rng, n, p, c):
    """bf16-tower-like raw tap values, and a lin-head-like scale."""
    fl = np.array(jnp.asarray(
        rng.standard_normal((n, p, c)).astype(np.float32)
    ).astype(jnp.bfloat16).astype(jnp.float32))
    scale = np.abs(rng.standard_normal(c)).astype(np.float32) * 0.05
    return fl, scale


def _rn64(b: torch.Tensor) -> np.ndarray:
    """float64 sum of squares per image."""
    return (b.double() ** 2).sum(dim=(1, 2)).numpy()


@pytest.mark.parametrize("p,c", TAP_SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_tap_epilogue_matches_jax_interpret(rng, p, c, mode):
    fl, scale = _tap(rng, 3, p, c)
    (je, jo, qb), (te, to) = MODES[mode]
    out_j, rn_j = j_tap(jnp.asarray(fl), scale, embed_dtype=je,
                        out_dtype=jo, quant_bound=qb, interpret=True)
    part_j = np.asarray(_unpack_lanes(out_j, c, mode="halves"))
    part, rn = tap_epilogue(torch.from_numpy(fl), scale, embed_dtype=te,
                            out_dtype=to, quant_bound=qb)
    assert tuple(part.shape) == (3, p, c) and part.dtype == to
    assert rn.dtype == torch.float32
    if to == torch.bfloat16:
        got = part.view(torch.int16).numpy()
        want = part_j.view(np.int16)
    else:
        got, want = part.numpy(), part_j
    np.testing.assert_array_equal(got, want)
    # the norms come from the embed-dtype values (before the int8 step)
    b, _ = tap_epilogue_plain(torch.from_numpy(fl), scale, embed_dtype=te,
                              out_dtype=te)
    exact = _rn64(b)
    np.testing.assert_allclose(rn.numpy(), exact, rtol=1e-6)
    np.testing.assert_allclose(rn.numpy(), np.asarray(rn_j), rtol=2e-6)


@pytest.mark.parametrize("c", [64, 128, 256, 512, 1024])
def test_channel_sum_order_is_xlas(rng, c):
    """The fixed channel-sum order equals XLA's CPU reduction bit for
    bit: the reason the parts match the JAX package exactly."""
    x = rng.standard_normal((5, 7, c)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda a: jnp.sum(jnp.square(a), axis=-1))(jnp.asarray(x)))
    got = channel_sumsq(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_strided_tap_and_out_slice(rng):
    """The tower's channels-last permute views (N, H, W, C) go in without
    a copy and give the (N, P, C) result; ``out`` receives the part as a
    column slice of a wider buffer, leaving the rest untouched."""
    nchw = torch.from_numpy(rng.standard_normal((2, 64, 4, 8))
                            .astype(np.float32))
    tap = nchw.permute(0, 2, 3, 1)  # (2, 4, 8, 64), strided
    scale = np.full(64, 0.1, np.float32)
    want, rn_want = tap_epilogue(tap.contiguous().reshape(2, 32, 64), scale,
                                 embed_dtype=torch.float32,
                                 out_dtype=torch.float32)
    buf = torch.full((2, 10 + 32 * 64 + 6), -7.0)
    part, rn = tap_epilogue(tap, scale, embed_dtype=torch.float32,
                            out_dtype=torch.float32,
                            out=buf[:, 10:10 + 32 * 64])
    torch.testing.assert_close(part, want, rtol=0, atol=0)
    torch.testing.assert_close(rn, rn_want, rtol=0, atol=0)
    torch.testing.assert_close(buf[:, 10:-6].reshape(2, 32, 64), want,
                               rtol=0, atol=0)
    assert bool((buf[:, :10] == -7).all() and (buf[:, -6:] == -7).all())


@pytest.mark.parametrize("p,c", [(9, 64), (8, 96), (3, 40), (5, 17)])
def test_any_channel_count(rng, p, c):
    """Shapes outside the TPU kernel's lane envelope (odd P with C = 64,
    C not 64 or a multiple of 128) need no other route: unit channel
    vectors times the scale, within float32 rounding of float64."""
    fl, scale = _tap(rng, 2, p, c)
    part, rn = tap_epilogue(torch.from_numpy(fl), scale,
                            embed_dtype=torch.float32,
                            out_dtype=torch.float32)
    x = fl.astype(np.float64)
    ref = x / (np.sqrt((x ** 2).sum(-1, keepdims=True)) + 1e-10) * scale
    np.testing.assert_allclose(part.numpy(), ref, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(rn.numpy(), (ref ** 2).sum((1, 2)),
                               rtol=1e-5)


def test_int8_quantisation_rule(rng):
    """int8 parts are quantize_int8 of the embed-dtype values."""
    from ganleaks_tpu_torch.ops.distance import quantize_int8

    fl, scale = _tap(rng, 2, 16, 128)
    q, rn_q = tap_epilogue(torch.from_numpy(fl), scale,
                           embed_dtype=torch.bfloat16,
                           out_dtype=torch.bfloat16, quant_bound=0.05)
    b, rn_b = tap_epilogue(torch.from_numpy(fl), scale,
                           embed_dtype=torch.bfloat16,
                           out_dtype=torch.bfloat16)
    assert q.dtype == torch.int8
    torch.testing.assert_close(q, quantize_int8(b, 0.05), rtol=0, atol=0)
    torch.testing.assert_close(rn_q, rn_b, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    fl = torch.zeros((2, 4, 8))
    ok = dict(embed_dtype=torch.float32, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="expected a tap"):
        tap_epilogue(torch.zeros((2, 8)), np.ones(8), **ok)
    with pytest.raises(ValueError, match="tap dtype"):
        tap_epilogue(fl.double(), np.ones(8), **ok)
    with pytest.raises(ValueError, match="embed_dtype"):
        tap_epilogue(fl, np.ones(8), embed_dtype=torch.int8,
                     out_dtype=torch.float32)
    with pytest.raises(ValueError, match="scale"):
        tap_epilogue(fl, np.ones(7), **ok)
    with pytest.raises(ValueError, match="out must be"):
        tap_epilogue(fl, np.ones(8), out=torch.zeros((2, 31)), **ok)
    with pytest.raises(ValueError, match="unsupported device"):
        tap_epilogue(fl.to("meta"), np.ones(8), **ok)
    before = tap_epilogue.launches
    tap_epilogue(fl, np.ones(8), **ok)
    assert tap_epilogue.launches == before  # the CPU takes the plain version
