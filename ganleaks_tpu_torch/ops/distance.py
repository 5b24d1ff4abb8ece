"""Attack distances as squared-Euclidean embeddings (port of
``ganleaks_tpu.ops.distance``).

The reference's ``Loss`` (``attack_models/utils.py:153-177``) computes per
query/candidate pair

    d(x, y) = mean_{CHW}((y - x)^2) + 0.2 * LPIPS(x, y)        ('l2-lpips')
    d(x, y) = mean_{CHW}((y - x)^2)                            ('l2')

Both terms are quadratic forms, so each image is featurised once into phi
with ``d(x, y) = ||phi(x) - phi(y)||^2``: the pixel part is
``flatten(x) / sqrt(D)`` and the LPIPS part is built by ``ops/lpips``.
:func:`make_embed_fn` returns phi flat; :func:`make_embed_parts_fn`
returns it as a list of parts (pixel, then each tap) for the ``taps`` and
``taps-int8`` engines, whose int8 rule is :func:`quantize_int8`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ganleaks_tpu_torch.utils.profiling import span

# f32(f64(2*(x/255) - 1)) for every byte value: the exact value the host
# readers produce (float64 scaling, then a float32 cast). Used on every
# device: no float32 arithmetic reproduces these bits.
_U8_UNIT_TABLE = (2.0 * (np.arange(256, dtype=np.float64) / 255.0)
                  - 1.0).astype(np.float32)


def images_unit_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] image storage -> the [-1, 1] float32 the host
    readers produce, through the 256-entry table. Floats pass through."""
    if x.dtype != torch.uint8:
        return x
    table = torch.from_numpy(_U8_UNIT_TABLE).to(x.device)
    return table[x.long()]


def quantize_int8(x: torch.Tensor, bound: float) -> torch.Tensor:
    """Round-to-nearest (half to even) int8 quantisation at a static scale:
    the ``taps-int8`` engine's one rule, shared by every producer (the tap
    epilogue and the pixel part), because the two-pass certificate's
    error bound (``ops/knn._quant_abs_err``) is derived from exactly this
    expression. |x| <= bound by construction; the clip only guards float
    round-off at the boundary."""
    return torch.clamp(torch.round(x.float() * (127.0 / bound)),
                       -127, 127).to(torch.int8)


def pixel_embedding(x: torch.Tensor) -> torch.Tensor:
    """phi for the mean-square pixel distance (``utils.py:163``).

    x: (N, H, W, C) in [-1, 1] -> (N, H*W*C), scaled by 1/sqrt(D)."""
    flat = x.reshape(x.shape[0], -1)
    d = flat.shape[1]
    return flat * (1.0 / torch.sqrt(torch.tensor(d, dtype=flat.dtype,
                                                 device=flat.device)))


def l2_pair(x_hat: torch.Tensor, x_gt: torch.Tensor) -> torch.Tensor:
    """Reference ``loss_l2_fn``: the mean over all but the leading axis of
    (x_gt - x_hat)^2 (``utils.py:163``)."""
    diff = x_gt - x_hat
    return torch.mean(torch.square(diff), dim=tuple(range(1, diff.dim())))


def rows_embedding(x: torch.Tensor) -> torch.Tensor:
    """Tabular rows (medGAN path) as embeddings of the mean-square
    distance: (N, D) records times ``1 / sqrt(D)``. The scale is the JAX
    package's float32 scalar, bit for bit: the correctly rounded float32
    square root of D, then its correctly rounded float32 reciprocal (numpy
    on the host, where both are IEEE operations)."""
    if x.dim() != 2:
        x = x.reshape(x.shape[0], -1)
    np_dtype = torch.empty((), dtype=x.dtype).numpy().dtype
    one = np_dtype.type(1.0)
    scale = one / np.sqrt(np_dtype.type(x.shape[1]))
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)


def make_embed_fn(distance: str, lpips_embed: Callable | None = None,
                  dtype: torch.dtype = torch.float32
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Featuriser for the configured distance.

    distance='l2'        -> pixel embedding only.
    distance='l2-lpips'  -> concat(pixel embedding, LPIPS embedding); the
                            0.2 weight is folded into the LPIPS embedding.
    """
    if distance == "l2":
        def embed_l2(x: torch.Tensor) -> torch.Tensor:
            return pixel_embedding(images_unit_range(x)).to(dtype)
        return embed_l2
    if distance == "l2-lpips":
        if lpips_embed is None:
            raise ValueError("l2-lpips requires an LPIPS embed function")

        def embed(x: torch.Tensor) -> torch.Tensor:
            x = images_unit_range(x)
            return torch.cat([pixel_embedding(x).to(dtype),
                              lpips_embed(x).to(dtype)], dim=1)
        embed.tower = getattr(lpips_embed, "tower", None)
        return embed
    raise ValueError(f"unknown distance {distance!r}")


def _numel(shape) -> int:
    d = 1
    for dim in shape:
        d *= dim
    return d


def make_embed_parts_fn(distance: str, lpips_parts: Callable | None = None,
                        dtype: torch.dtype = torch.float32
                        ) -> Callable[[torch.Tensor], list[torch.Tensor]]:
    """Structured variant of :func:`make_embed_fn`: the featuriser returns
    a LIST of parts with ``d(x, y) = sum_l ||part_l(x) - part_l(y)||^2`` —
    part 0 the flat pixel embedding, then the LPIPS taps as (N, H_l*W_l,
    C_l) (``ops/lpips.lpips_embed_parts``).

    The closure carries ``part_bound_fn(sample_shape) -> [max|part_l|]``
    (rigorous elementwise bounds; images in [-1, 1] give
    ``|phi_pix| <= 1/sqrt(D)``), the static scales of the int8 engine, and
    ``part_int_dot_bound_fn(sample_shape)``, bounds on each part's int8
    cross dot for the int32-accumulator check. For 'l2-lpips' it also
    carries ``make_fast_parts_norms(cdtype, bounds=None)``: a featuriser
    ``blk -> (flat, r, widths)`` that writes every part into one (N, K)
    buffer of ``cdtype`` (int8 when ``bounds`` is given), the taps through
    the tap epilogue kernel, with the float32 row norms of the parts
    (taken before any int8 step) and the part widths; the byte table and
    the pixel part run in the span ``distance.pixels``."""
    def pix_bound(sample_shape):
        return 1.0 / float(_numel(sample_shape)) ** 0.5

    def pix_dot_bound(sample_shape):
        # every pixel element can saturate to +-127 (+rounding)
        return float(_numel(sample_shape)) * 127.5 ** 2

    if distance == "l2":
        def embed_l2(x: torch.Tensor) -> list[torch.Tensor]:
            return [pixel_embedding(images_unit_range(x)).to(dtype)]
        embed_l2.part_bound_fn = lambda shape: [pix_bound(shape)]
        embed_l2.part_int_dot_bound_fn = lambda shape: [pix_dot_bound(shape)]
        return embed_l2
    if distance != "l2-lpips":
        raise ValueError(f"unknown distance {distance!r}")
    if lpips_parts is None:
        raise ValueError("l2-lpips requires an LPIPS parts function")

    def embed(x: torch.Tensor) -> list[torch.Tensor]:
        x = images_unit_range(x)
        return [pixel_embedding(x).to(dtype)] + lpips_parts(x)

    embed.tower = getattr(lpips_parts, "tower", None)

    if hasattr(lpips_parts, "part_bound_fn"):
        embed.part_bound_fn = lambda shape: (
            [pix_bound(shape)] + lpips_parts.part_bound_fn(shape))
    if hasattr(lpips_parts, "part_int_dot_bound_fn"):
        embed.part_int_dot_bound_fn = lambda shape: (
            [pix_dot_bound(shape)] + lpips_parts.part_int_dot_bound_fn(shape))
    if hasattr(lpips_parts, "make_fast_parts_norms"):
        def make_fast(cdtype: torch.dtype, bounds=None):
            lp_fast = lpips_parts.make_fast_parts_norms(
                cdtype, None if bounds is None else tuple(bounds[1:]))
            pix_qb = None if bounds is None else bounds[0]
            res_dtype = torch.int8 if bounds is not None else cdtype

            def fused(blk: torch.Tensor):
                with span("distance.pixels"):
                    x = images_unit_range(blk)
                    pix = pixel_embedding(x).to(dtype)
                    w0 = pix.shape[1]
                    widths = (w0,) + tuple(lp_fast.widths(
                        tuple(x.shape[1:])))
                    flat = torch.empty((x.shape[0], sum(widths)),
                                       dtype=res_dtype, device=x.device)
                    flat[:, :w0] = quantize_int8(pix, pix_qb) \
                        if pix_qb is not None else pix.to(cdtype)
                    r = torch.sum(torch.square(pix.float()), dim=1)
                r = lp_fast(x, flat[:, w0:], r)
                return flat, r, widths
            return fused
        embed.make_fast_parts_norms = make_fast
    return embed
