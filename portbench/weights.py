"""The tower's weights, made on the card from the seed, and the npz that
hands the same weights to the program.

Convolutions: Kaiming-uniform kernels (bound sqrt(6 / fan_in)) and
uniform biases (bound 1 / sqrt(fan_in)), all drawn in one call. Lin
heads: a file of real heads beside the configuration, or uniform in
[low, high) from the seed (a configuration's ``lin_heads``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench import nets, traffic

HERE = os.path.dirname(os.path.abspath(__file__))


def make(config: dict, seed: int, device) -> dict:
    """``{"convs": [(kernel OIHW, bias)], "lins": [per-channel heads]}``,
    float32 on ``device``."""
    net = config["net"]
    shapes = nets.conv_shapes(net)
    sizes = [o * c * k * k + o for o, c, k in shapes]
    gen = traffic.generator(seed, device, 0)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    convs, off = [], 0
    for (o, c, k), size in zip(shapes, sizes):
        fan_in = c * k * k
        w = flat[off:off + o * fan_in].view(o, c, k, k) * math.sqrt(
            6.0 / fan_in)
        b = flat[off + o * fan_in:off + size] / math.sqrt(fan_in)
        convs.append((w, b))
        off += size
    heads = config["lin_heads"]
    chans = [t[2] for t in nets.tap_shapes(net, config["resolution"])]
    if isinstance(heads, str):
        with np.load(os.path.join(HERE, "configs", heads)) as z:
            lins = [torch.from_numpy(z[f"lin{i}"].reshape(-1)).float()
                    .to(device) for i in range(len(chans))]
    else:
        lo, hi = heads["low"], heads["high"]
        u = torch.rand(sum(chans), generator=gen, device=device)
        lins = list((lo + (hi - lo) * u).split(chans))
    for lin, c in zip(lins, chans):
        if lin.shape != (c,):
            raise ValueError(f"a lin head of {tuple(lin.shape)} for a tap of "
                             f"{c} channels")
    return {"convs": convs, "lins": lins}


def save_npz(weights: dict, net: str, path: str) -> None:
    """The weights in the npz schema the program's ``lpips_weights``
    reads: ``net``, ``conv{i}/kernel`` (HWIO), ``conv{i}/bias``,
    ``lin{i}``."""
    flat = {"net": np.asarray(net)}
    for i, (w, b) in enumerate(weights["convs"]):
        flat[f"conv{i}/kernel"] = np.ascontiguousarray(
            w.cpu().numpy().transpose(2, 3, 1, 0))
        flat[f"conv{i}/bias"] = b.cpu().numpy()
    for i, lin in enumerate(weights["lins"]):
        flat[f"lin{i}"] = lin.cpu().numpy()
    np.savez(path, **flat)
