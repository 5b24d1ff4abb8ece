"""DCGAN generator and discriminator (port of ``ganleaks_tpu.models.dcgan``;
reference ``gan_models/dcgan/model_torch.py``), NCHW.

The modules keep the reference's structure, so their state-dict keys are
the reference's (``gen.{i}.0.weight``, ``gen.{i}.1.running_mean``, ...,
``disc.5.bias``; ``tools/convert_victim.py`` reads the same
keys) and a reference ``generator.pth`` loads by name
(``utils/checkpoint.load_state_dict``).

* :class:`Generator` (``model_torch.py:75-96``): transposed-conv blocks
  with BatchNorm + ReLU from a 4x4 base at ``ngf * 16``, halving the
  features while doubling the size, then a transposed conv to the image
  and tanh. Latents may be flat (N, nz) or (N, nz, 1, 1).
* :class:`Discriminator` (``model_torch.py:25-47``): strided convs with
  BatchNorm + LeakyReLU(0.2) and a 4x4 conv to one logit; raw logits by
  default, ``sigmoid=True`` for the reference's probability.
* :class:`PrivateDiscriminator` (``model_torch.py:50-72``), privGAN's
  split classifier: the same trunk with a 4x4 head to ``n_splits``
  channels, returned as (N, n_splits) logits. The reference ends it in a
  Softmax and still feeds that to ``CrossEntropyLoss``; the trainer's
  loss reproduces the composition (``train/priv``).

Sizes other than 64 follow the same doubling schedule (``_n_mid_blocks``,
as the JAX package), for small test sizes.
"""

from __future__ import annotations

import torch
from torch import nn

from ganleaks_tpu_torch.ops.nn import (BatchNormTorch, Conv2dTorch,
                                       ConvTranspose2dTorch)


def _n_mid_blocks(image_size: int) -> int:
    """Stride-2 stages between the 4x4 base and the last doubling layer:
    3 at the reference's 64x64; other powers of two >= 8 follow the same
    schedule."""
    n = (image_size // 8).bit_length() - 1
    if image_size < 8 or image_size != 8 * 2 ** n:
        raise ValueError(f"image_size must be a power of 2 >= 8, "
                         f"got {image_size}")
    return n


class Generator(nn.Module):
    """``Generator(z_dim, channels_img, features_g)``."""

    def __init__(self, nz: int = 100, nc: int = 3, ngf: int = 64,
                 image_size: int = 64):
        super().__init__()
        self.nz = nz
        n_mid = _n_mid_blocks(image_size)
        feats = [ngf * 2 ** (n_mid + 1)]
        feats += [ngf * 2 ** (n_mid - k) for k in range(n_mid)]
        layers, cin = [], nz
        for i, feat in enumerate(feats):
            stride, pad = (1, 0) if i == 0 else (2, 1)
            layers.append(nn.Sequential(
                ConvTranspose2dTorch(cin, feat, 4, stride, pad, bias=False),
                BatchNormTorch(feat), nn.ReLU()))
            cin = feat
        layers += [ConvTranspose2dTorch(cin, nc, 4, 2, 1), nn.Tanh()]
        self.gen = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.gen(z.reshape(z.shape[0], self.nz, 1, 1))


def discriminator_trunk(nc: int, ndf: int, mults, norm, n_out: int = 1
                        ) -> nn.Sequential:
    """The reference's discriminator/critic ``disc`` Sequential: a strided
    conv and LeakyReLU(0.2), one (conv without bias, ``norm``, LeakyReLU)
    block per multiplier, and the 4x4 head conv to ``n_out`` channels."""
    layers = [Conv2dTorch(nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
    cin = ndf
    for mult in mults:
        layers.append(nn.Sequential(
            Conv2dTorch(cin, ndf * mult, 4, 2, 1, bias=False),
            norm(ndf * mult), nn.LeakyReLU(0.2)))
        cin = ndf * mult
    layers.append(Conv2dTorch(cin, n_out, 4, 2, 0))
    return nn.Sequential(*layers)


class Discriminator(nn.Module):
    """``Discriminator(channel_img, feature_d)``."""

    def __init__(self, ndf: int = 64, image_size: int = 64, nc: int = 3):
        super().__init__()
        mults = [2 ** k for k in range(1, _n_mid_blocks(image_size) + 1)]
        self.disc = discriminator_trunk(nc, ndf, mults, BatchNormTorch)

    def forward(self, x: torch.Tensor, sigmoid: bool = False
                ) -> torch.Tensor:
        logits = self.disc(x).reshape(x.shape[0])
        return torch.sigmoid(logits) if sigmoid else logits


class PrivateDiscriminator(nn.Module):
    """privGAN's ``PrivateDiscriminator(channel_img, feature_d, N_splits)``:
    (N, nc, R, R) -> (N, n_splits) logits."""

    def __init__(self, ndf: int = 64, n_splits: int = 2,
                 image_size: int = 64, nc: int = 3):
        super().__init__()
        self.n_splits = n_splits
        mults = [2 ** k for k in range(1, _n_mid_blocks(image_size) + 1)]
        self.disc = discriminator_trunk(nc, ndf, mults, BatchNormTorch,
                                        n_splits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.disc(x).reshape(x.shape[0], self.n_splits)
