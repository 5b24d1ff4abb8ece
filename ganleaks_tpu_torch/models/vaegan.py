"""VAE-GAN networks (port of ``ganleaks_tpu.models.vaegan``; reference
``gan_models/vaegan/train.py``), NCHW, under the reference's state-dict
keys (a spectral-norm layer's are ``<name>.module.weight_bar`` /
``weight_u`` / ``weight_v`` / ``bias``).

* :class:`Encoder` (``train.py:61-106``): four conv + BatchNorm + ReLU
  blocks, two fully connected heads (mu, logvar) with BatchNorm1d;
  :meth:`Encoder.forward` reparametrises with ``eps * exp(logvar) + mu``,
  the reference's std without the 1/2 (``train.py:99``), eps given or
  drawn from an explicit ``torch.Generator``. Train or eval mode picks
  the batch or the running statistics.
* :class:`Generator` (``train.py:109-135``): spectral-norm transposed
  convolutions with self-attention at the 16x16 stage, tanh output.
* :class:`DiscriminatorL` (``train.py:138-160``): the latent
  discriminator, z -> 750 -> 750 -> 1 with LeakyReLU(0.01), sigmoid.
* :class:`Discriminator` (``train.py:163-186``): spectral-norm convs with
  LeakyReLU(0.02) and self-attention, the last conv's 2x2 map flattened
  as torch's ``view(-1, 4)`` into a spectral-norm linear head; raw
  scores (the hinge loss takes them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ganleaks_tpu_torch.ops.nn import (BatchNormTorch, ChannelsToLinear,
                                       Conv2dTorch, ConvTranspose2dTorch,
                                       DenseTorch, SelfAttention,
                                       SNConv2d, SNConvTranspose2d,
                                       SNDense)


class Encoder(nn.Module):
    """``Encoder(z_dim, d=64)`` at 64x64 input."""

    def __init__(self, z_dim: int = 100, d: int = 64):
        super().__init__()
        self.z_dim, self.d = z_dim, d
        chans = (3, d, d * 2, d * 4, d * 8)
        for i in range(4):
            setattr(self, f"cv{i + 1}",
                    Conv2dTorch(chans[i], chans[i + 1], 4, 2, 1))
            setattr(self, f"bn{i + 1}", BatchNormTorch(chans[i + 1]))
        flat = d * 8 * 4 * 4
        self.fc1 = ChannelsToLinear(flat, 4 * z_dim)
        self.bn6 = BatchNormTorch(4 * z_dim)
        self.fc1_1 = DenseTorch(4 * z_dim, z_dim)
        self.fc2 = ChannelsToLinear(flat, 4 * z_dim)
        self.bn7 = BatchNormTorch(4 * z_dim)
        self.fc2_1 = DenseTorch(4 * z_dim, z_dim)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar) of NCHW images in [-1, 1]."""
        h = x
        for i in range(1, 5):
            h = F.relu(getattr(self, f"bn{i}")(getattr(self, f"cv{i}")(h)))
        z_mu = self.fc1_1(F.relu(self.bn6(self.fc1(h))))
        z_var = self.fc2_1(F.relu(self.bn7(self.fc2(h))))
        return z_mu, z_var

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None) -> torch.Tensor:
        """z = eps * exp(logvar) + mu; ``eps`` defaults to N(0, 1) from
        ``generator``."""
        mu, logvar = self.encode(x)
        std = torch.exp(logvar)  # reference quirk: no 0.5 (train.py:99)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator,
                              dtype=std.dtype, device=std.device)
        return eps * std + mu


class Generator(nn.Module):
    """``Generator(z_dim, d=64)``: (N, z_dim) -> (N, 3, 64, 64) in
    [-1, 1]."""

    def __init__(self, z_dim: int = 100, d: int = 64):
        super().__init__()
        self.z_dim, self.d = z_dim, d
        chans = (z_dim, d * 8, d * 4, d * 2, d)
        for i in range(4):
            stride, pad = (1, 0) if i == 0 else (2, 1)
            setattr(self, f"deconv{i + 1}",
                    SNConvTranspose2d(chans[i], chans[i + 1], 4, stride, pad))
            setattr(self, f"deconv{i + 1}_bn", BatchNormTorch(chans[i + 1]))
        self.sa1 = SelfAttention(d * 2)
        self.deconv5 = ConvTranspose2dTorch(d, 3, 4, 2, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.reshape(z.shape[0], -1, 1, 1)
        for i in range(1, 5):
            if i == 4:
                x = self.sa1(x)
            x = F.relu(getattr(self, f"deconv{i}_bn")(
                getattr(self, f"deconv{i}")(x)))
        return torch.tanh(self.deconv5(x))


class DiscriminatorL(nn.Module):
    """Latent discriminator: (N, z_dim) -> (N,) probabilities."""

    def __init__(self, z_dim: int = 100):
        super().__init__()
        self.fc1 = DenseTorch(z_dim, 750)
        self.fc2 = DenseTorch(750, 750)
        self.fc3 = DenseTorch(750, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.fc1(z), 0.01)
        h = F.leaky_relu(self.fc2(h), 0.01)
        return torch.sigmoid(self.fc3(h)).reshape(-1)


class Discriminator(nn.Module):
    """Image discriminator: (N, 3, 64, 64) -> (N,) scores."""

    def __init__(self, d: int = 64):
        super().__init__()
        chans = (3, d, d * 2, d * 4, d * 8, 1)
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    SNConv2d(chans[i], chans[i + 1], 4, 2, 1))
        self.sa1 = SelfAttention(d * 4)
        self.fc = SNDense(4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(1, 5):
            if i == 4:
                h = self.sa1(h)
            h = F.leaky_relu(getattr(self, f"conv{i}")(h), 0.02)
        h = self.conv5(h)                         # (N, 1, 2, 2)
        return self.fc(h.reshape(-1, 4)).reshape(-1)
