"""medGAN, the tabular (EHR) victim (port of ``ganleaks_tpu.models.medgan``;
reference ``gan_models/medgan/model.py``), under the reference's
state-dict keys (``encoder.0``, ``decoder.0``, ``gen_block{1,2}.{0,1}``,
``disc.{0,2,4}``; ``tools/convert_victim.py`` (``convert_medgan``) reads
the same).

* :class:`Autoencoder` (``model.py:13-41``): one hidden layer; tanh /
  sigmoid when ``binary``, else ReLU both ways.
* :class:`Generator` (``model.py:44-73``): two residual blocks, ``z +
  relu(BN(fc(z)))`` then ``+ tanh(BN(fc(.)))``, BatchNorm1d with eps
  0.001 and momentum 0.01; ``hidden_size`` must equal ``z_dim`` for the
  adds (the reference's 128).
* :class:`Discriminator` (``model.py:76-103``): an MLP on ``[x,
  mean_batch(x)]`` divided by the batch size (the reference's quirk,
  ``model.py:99-101``), sigmoid output.
"""

from __future__ import annotations

import torch
from torch import nn

from ganleaks_tpu_torch.ops.nn import (BatchNormTorch, DenseTorch,
                                       batch_average, batch_rows)


class Autoencoder(nn.Module):

    def __init__(self, input_size: int, hidden_size: int = 128,
                 binary: bool = True):
        super().__init__()
        self.binary = binary
        self.encoder = nn.Sequential(
            DenseTorch(input_size, hidden_size),
            nn.Tanh() if binary else nn.ReLU())
        self.decoder = nn.Sequential(
            DenseTorch(hidden_size, input_size),
            nn.Sigmoid() if binary else nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        return self.decoder(h)


class Generator(nn.Module):

    def __init__(self, z_dim: int = 128, hidden_size: int = 128,
                 gen_dim: int | None = None):
        super().__init__()
        self.z_dim = z_dim
        gen_dim = z_dim if gen_dim is None else gen_dim
        self.gen_block1 = nn.Sequential(
            DenseTorch(z_dim, hidden_size),
            BatchNormTorch(hidden_size, eps=0.001, momentum=0.01),
            nn.ReLU())
        self.gen_block2 = nn.Sequential(
            DenseTorch(hidden_size, gen_dim),
            BatchNormTorch(gen_dim, eps=0.001, momentum=0.01),
            nn.Tanh())

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        out1 = z + self.gen_block1(z)
        return out1 + self.gen_block2(out1)


class Discriminator(nn.Module):

    def __init__(self, input_size: int, hidden1: int = 128,
                 hidden2: int = 256, minibatch_average: bool = True):
        super().__init__()
        self.minibatch_average = minibatch_average
        width = 2 * input_size if minibatch_average else input_size
        self.disc = nn.Sequential(
            DenseTorch(width, hidden1), nn.ReLU(),
            DenseTorch(hidden1, hidden2), nn.ReLU(),
            DenseTorch(hidden2, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.minibatch_average:  # over the global batch (ops/nn)
            mean = batch_average(x).expand_as(x)
            x = torch.cat([x, mean], dim=1) / batch_rows(x)
        return self.disc(x).reshape(-1)
