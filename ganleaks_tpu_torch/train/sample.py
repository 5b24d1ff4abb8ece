"""Batched sampling from a trained generator (port of
``ganleaks_tpu.train.sample``; reference ``train_torch.py:150-158``):
eval mode (running BatchNorm statistics, ``gen.eval()`` at ``:150``), no
autograd, images denormalised with ``Normalize(mean=-1, std=2)`` ==
``(x + 1) / 2`` and clipped to [0, 1]."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sample_images(gen: nn.Module, num: int, nz: int, batch: int = 512,
                  generator: torch.Generator | None = None,
                  device: torch.device | str = "cpu"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``num`` samples in batches of ``batch``, latents drawn from
    ``generator`` on ``device``. Returns (noise (num, nz), images (num, C,
    H, W) in [0, 1]) on ``device``. The generator's train/eval mode is
    restored afterwards."""
    was_training = gen.training
    gen.eval()
    zs, imgs = [], []
    try:
        with torch.inference_mode():
            for lo in range(0, num, batch):
                z = torch.randn(min(batch, num - lo), nz,
                                generator=generator, device=device)
                zs.append(z)
                imgs.append(((gen(z) + 1.0) / 2.0).clamp_(0.0, 1.0))
    finally:
        gen.train(was_training)
    return torch.cat(zs), torch.cat(imgs)


def sample_to_host(gen: nn.Module, num: int, nz: int, batch: int = 512,
                   generator: torch.Generator | None = None,
                   device: torch.device | str = "cpu"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """:func:`sample_images` on the host: (noise (num, nz) float32, images
    (num, H, W, C) float32 in [0, 1], NHWC)."""
    z, img = sample_images(gen, num, nz, batch, generator, device)
    return (z.float().cpu().numpy(),
            img.permute(0, 2, 3, 1).float().cpu().numpy())
