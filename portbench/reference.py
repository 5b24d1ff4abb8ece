"""The plain reference of the attack's distance: ``l2 + 0.2 * LPIPS`` as a
squared Euclidean distance between embeddings, in plain PyTorch.

For images x, y in [-1, 1] (from uint8 bytes as 2 * b / 255 - 1)

    d(x, y) = mean((x - y)^2) + 0.2 * sum_l mean_hw sum_c w_lc (f_l(x) - f_l(y))^2

(GAN-Leaks ``attack_models/utils.py``'s ``Loss``; LPIPS v0.1's
``NetLinLayer``), where f_l is tap l of the tower on ``(x - shift) /
scale``, unit-normalised over channels at each position. Both terms are
quadratic, so ``d(x, y) = ||e(x) - e(y)||^2`` with ``e`` the pixels over
sqrt(D) followed by each tap times ``sqrt(0.2 * max(w_lc, 0) / (H_l W_l))``.

The tower runs in float32 with TF32 off (or float64 where asked); the
distances are taken in float64. Nothing here reads the program: the
weights come from the benchmark, which made them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import nets

LPIPS_WEIGHT = 0.2


def strict_float32() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tap_scales(lins, res: int, net: str) -> list[torch.Tensor]:
    """Per-channel scale of each tap: sqrt(0.2 * max(w, 0) / (H * W))."""
    return [torch.sqrt(torch.clamp(w.double(), min=0.0)
                       * (LPIPS_WEIGHT / (h * wd)))
            for w, (h, wd, _c) in zip(lins, nets.tap_shapes(net, res))]


def embed(images: torch.Tensor, weights: dict, net: str,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """e(x) of uint8 NHWC ``images`` as (N, K) in ``dtype``: the pixel part,
    then each tap flattened channels last."""
    strict_float32()
    n, res = images.shape[0], images.shape[1]
    x = images.to(dtype) * (2.0 / 255.0) - 1.0
    parts = [x.reshape(n, -1) / math.sqrt(x[0].numel())]
    shift = torch.tensor(nets.SHIFT, dtype=dtype, device=x.device)
    scale = torch.tensor(nets.SCALE, dtype=dtype, device=x.device)
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    convs = iter(weights["convs"])
    scales = iter(tap_scales(weights["lins"], res, net))
    for layer in nets.layers(net):
        if layer[0] == "conv":
            w, b = next(convs)
            h = F.relu(F.conv2d(h, w.to(dtype), b.to(dtype),
                                stride=layer[3], padding=layer[4]))
        elif layer[0] == "pool":
            h = F.max_pool2d(h, layer[1], layer[2])
        else:
            f = h.permute(0, 2, 3, 1)
            norm = torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True))
            sc = next(scales).to(dtype)
            parts.append((f / (norm + nets.EPS) * sc).reshape(n, -1))
    return torch.cat(parts, dim=1)


def part_widths(net: str, res: int) -> list[int]:
    """Columns of each part of :func:`embed`: pixels, then each tap."""
    return [res * res * 3] + [h * w * c for h, w, c
                              in nets.tap_shapes(net, res)]


def part_bounds(lins, net: str, res: int) -> list[float]:
    """max |e| of each part: 1 / sqrt(D) for the pixels (|x| <= 1), and
    the largest channel scale of each tap (unit-normalised features)."""
    return [1.0 / math.sqrt(res * res * 3)] + [
        float(s.max()) for s in tap_scales(lins, res, net)]


def quantize(e: torch.Tensor, widths: list[int], bounds: list[float],
             levels: int) -> torch.Tensor:
    """Each part rounded to the nearest of ``2 * levels + 1`` steps of its
    bound (half to even), as float64 integers."""
    out, off = [], 0
    for wd, a in zip(widths, bounds):
        part = e[:, off:off + wd].double() * (levels / a)
        out.append(torch.clamp(torch.round(part), -levels, levels))
        off += wd
    return torch.cat(out, dim=1)


def quantized_cross(q_int: torch.Tensor, s_int: torch.Tensor,
                    widths: list[int], bounds: list[float],
                    levels: int) -> torch.Tensor:
    """sum_l (a_l / levels)^2 * q_l . s_l in float64 (exact products of
    integers below 2^53)."""
    cross, off = 0.0, 0
    for wd, a in zip(widths, bounds):
        cross = cross + (q_int[:, off:off + wd] @ s_int[:, off:off + wd].T
                         ) * (a / levels) ** 2
        off += wd
    return cross
