"""Attack distances as squared-Euclidean embeddings (port of
``ganleaks_tpu.ops.distance``).

The reference's ``Loss`` (``attack_models/utils.py:153-177``) computes per
query/candidate pair

    d(x, y) = mean_{CHW}((y - x)^2) + 0.2 * LPIPS(x, y)        ('l2-lpips')
    d(x, y) = mean_{CHW}((y - x)^2)                            ('l2')

Both terms are quadratic forms, so each image is featurised once into phi
with ``d(x, y) = ||phi(x) - phi(y)||^2``: the pixel part is
``flatten(x) / sqrt(D)`` and the LPIPS part is built by ``ops/lpips``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

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


def pixel_embedding(x: torch.Tensor) -> torch.Tensor:
    """phi for the mean-square pixel distance (``utils.py:163``).

    x: (N, H, W, C) in [-1, 1] -> (N, H*W*C), scaled by 1/sqrt(D)."""
    flat = x.reshape(x.shape[0], -1)
    d = flat.shape[1]
    return flat * (1.0 / torch.sqrt(torch.tensor(d, dtype=flat.dtype,
                                                 device=flat.device)))


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
        return embed
    raise ValueError(f"unknown distance {distance!r}")
