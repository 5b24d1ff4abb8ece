"""WGAN-GP critic (port of ``ganleaks_tpu.models.wgangp``; reference
``gan_models/wgangp/model.py``), NCHW. The generator is DCGAN's
(``model.py:37-58``); the critic is the DCGAN discriminator's trunk with
affine InstanceNorm in place of BatchNorm and a raw score
(``model.py:12-33``), under the reference's state-dict keys
(``disc.{2,3,4}.1.weight`` for the InstanceNorm scales)."""

from __future__ import annotations

import torch
from torch import nn

from ganleaks_tpu_torch.models.dcgan import (  # noqa: F401  (same net)
    Generator, discriminator_trunk)
from ganleaks_tpu_torch.ops.nn import InstanceNorm2d


class Critic(nn.Module):
    """``Discriminator(img_channels, features_d)`` at 64x64."""

    def __init__(self, ndf: int = 64, nc: int = 3):
        super().__init__()
        self.disc = discriminator_trunk(nc, ndf, (2, 4, 8), InstanceNorm2d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.disc(x).reshape(x.shape[0])
