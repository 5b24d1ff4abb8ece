"""Progressive GAN (port of ``ganleaks_tpu.models.pggan``; reference
``gan_models/pggan/model_torch.py``), NCHW.

Like the torch reference, each network builds every progressive block and
every to/from-RGB layer in ``__init__``, under the reference's state-dict
keys: ``initial.{1,3}``, ``rgb_layers.{i}``, ``prog_blocks.{i}``, in the
critic ``final_block.{0,2,4}``, and ``initial_rgb``: the reference holds
its first generator / last critic RGB layer under that name too, so its
state dicts carry the layer twice. The port registers the layer once
(``torch.func.functional_call`` leaves a doubly registered layer's
swapped parameters in place) and a state-dict hook pair writes and reads
the ``initial_rgb`` copy (:func:`_alias_initial_rgb`). ``max_steps``
(default: the whole ``FACTORS`` schedule, 4 to 1,024 px) stops the build
at 4 * 2^max_steps px — the JAX package's ``init_progressive`` union
tree, and what narrow test widths need (``int(in_channels * 1/32)`` is 0
below 32 channels). The
critic's layers keep the reference's numbering from the top resolution
down, so a smaller build holds indices ``8 - max_steps`` to 8.

* :class:`Generator` (``model_torch.py:49-88``): PixelNorm, a 1x1 -> 4x4
  transposed conv (torch's default init, not a WSConv), a WSConv, then per
  step a nearest 2x upsample and a :class:`ConvBlock`; the output fades in
  as ``tanh(alpha * rgb(out) + (1 - alpha) * rgb_prev(upsampled))``. At
  ``steps == 0`` the 4x4 RGB output is returned without tanh (a reference
  quirk, DIVERGENCES.md).
* :class:`Discriminator` (``model_torch.py:91-144``): from-RGB at the
  current step, the avg-pool fade-in against the downscaled image's
  from-RGB, the remaining blocks with 2x average pooling, minibatch std
  and the 4x4 final block; one score per image, or ``n_outputs`` (privGAN's
  ``PrivateDiscriminator``, ``model_torch.py:150-204``: the same trunk
  with an ``n_splits``-wide last conv, whose softmax the loss applies).

``steps`` is the resolution index (4 * 2^steps px), ``alpha`` a float or
a 0-dim tensor (the trainer passes one in its compute dtype).
"""

from __future__ import annotations

import torch
from torch import nn

from ganleaks_tpu_torch.ops.nn import (ConvTranspose2dTorch, WSConv2d,
                                       avg_pool_2x, leaky_relu, minibatch_std,
                                       pixel_norm, upsample_nearest_2x)

FACTORS = (1, 1, 1, 1, 1 / 2, 1 / 4, 1 / 8, 1 / 16, 1 / 32)
N_BLOCKS = len(FACTORS) - 1


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x)


class ConvBlock(nn.Module):
    """Two 3x3 WSConvs with LeakyReLU(0.2), each followed by PixelNorm in
    the generator (``model_torch.py:33-47``)."""

    def __init__(self, in_ch: int, out_ch: int, use_pixel_norm: bool = True):
        super().__init__()
        self.conv1 = WSConv2d(in_ch, out_ch)
        self.conv2 = WSConv2d(out_ch, out_ch)
        self.use_pixel_norm = use_pixel_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2):
            x = leaky_relu(conv(x), 0.2)
            if self.use_pixel_norm:
                x = pixel_norm(x)
        return x


def _alias_initial_rgb(module: nn.Module, index: int) -> None:
    """Save ``rgb_layers.<index>`` under ``initial_rgb`` as well, and on
    load take ``initial_rgb`` for it where the dict lacks it (dropping the
    copy either way)."""
    twin = f"rgb_layers.{index}."

    def save(mod, sd, prefix, meta):
        for k in [k for k in sd if k.startswith(prefix + twin)]:
            sd[prefix + "initial_rgb." + k[len(prefix + twin):]] = sd[k]

    def load(mod, sd, prefix, meta, strict, missing, unexpected, errors):
        alias = prefix + "initial_rgb."
        for k in [k for k in sd if k.startswith(alias)]:
            sd.setdefault(prefix + twin + k[len(alias):], sd.pop(k))

    module.register_state_dict_post_hook(save)
    module.register_load_state_dict_pre_hook(load)


def _check_steps(max_steps: int) -> int:
    if not 0 <= max_steps <= N_BLOCKS:
        raise ValueError(f"max_steps must be in [0, {N_BLOCKS}], got "
                         f"{max_steps}")
    return max_steps


class Generator(nn.Module):
    """``Generator(z_dim, in_channels, img_channels)``."""

    def __init__(self, nz: int = 512, in_channels: int = 512, nc: int = 3,
                 max_steps: int = N_BLOCKS):
        super().__init__()
        self.nz, self.max_steps = nz, _check_steps(max_steps)
        self.initial = nn.Sequential(
            PixelNorm(), ConvTranspose2dTorch(nz, in_channels, 4, 1, 0),
            nn.LeakyReLU(0.2), WSConv2d(in_channels, in_channels),
            nn.LeakyReLU(0.2), PixelNorm())
        self.rgb_layers = nn.ModuleList(
            [WSConv2d(in_channels, nc, 1, 1, 0)])
        self.prog_blocks = nn.ModuleList()
        for i in range(max_steps):
            c_in = int(in_channels * FACTORS[i])
            c_out = int(in_channels * FACTORS[i + 1])
            self.prog_blocks.append(ConvBlock(c_in, c_out))
            self.rgb_layers.append(WSConv2d(c_out, nc, 1, 1, 0))
        _alias_initial_rgb(self, 0)

    def forward(self, z: torch.Tensor, steps: int,
                alpha: float | torch.Tensor = 1.0) -> torch.Tensor:
        out = self.initial(z.reshape(z.shape[0], -1, 1, 1))
        if steps == 0:
            return self.rgb_layers[0](out)
        upscaled = out
        for step in range(steps):
            upscaled = upsample_nearest_2x(out)
            out = self.prog_blocks[step](upscaled)
        final_upscaled = self.rgb_layers[steps - 1](upscaled)
        final_out = self.rgb_layers[steps](out)
        return torch.tanh(alpha * final_out + (1 - alpha) * final_upscaled)


class Discriminator(nn.Module):
    """``Discriminator(in_channels, img_channels)``: (N, nc, R, R) at R = 4
    * 2^steps -> (N, n_outputs) scores."""

    def __init__(self, in_channels: int = 512, nc: int = 3,
                 max_steps: int = N_BLOCKS, n_outputs: int = 1):
        super().__init__()
        self.max_steps = _check_steps(max_steps)
        self.prog_blocks = nn.ModuleDict()
        self.rgb_layers = nn.ModuleDict()
        for i in range(N_BLOCKS - max_steps, N_BLOCKS):
            # block i maps factor index N_BLOCKS - i down to the one below
            c_in = int(in_channels * FACTORS[N_BLOCKS - i])
            c_out = int(in_channels * FACTORS[N_BLOCKS - i - 1])
            self.prog_blocks[str(i)] = ConvBlock(c_in, c_out,
                                                 use_pixel_norm=False)
            self.rgb_layers[str(i)] = WSConv2d(nc, c_in, 1, 1, 0)
        self.rgb_layers[str(N_BLOCKS)] = WSConv2d(nc, in_channels, 1, 1, 0)
        _alias_initial_rgb(self, N_BLOCKS)
        self.final_block = nn.Sequential(
            WSConv2d(in_channels + 1, in_channels), nn.LeakyReLU(0.2),
            WSConv2d(in_channels, in_channels, 4, 1, 0), nn.LeakyReLU(0.2),
            WSConv2d(in_channels, n_outputs, 1, 1, 0))

    def forward(self, x: torch.Tensor, steps: int,
                alpha: float | torch.Tensor = 1.0) -> torch.Tensor:
        cur = N_BLOCKS - steps
        out = leaky_relu(self.rgb_layers[str(cur)](x), 0.2)
        if steps > 0:
            downscaled = leaky_relu(
                self.rgb_layers[str(cur + 1)](avg_pool_2x(x)), 0.2)
            out = avg_pool_2x(self.prog_blocks[str(cur)](out))
            out = alpha * out + (1 - alpha) * downscaled
            for step in range(cur + 1, N_BLOCKS):
                out = avg_pool_2x(self.prog_blocks[str(step)](out))
        out = minibatch_std(out)
        return self.final_block(out).reshape(x.shape[0], -1)


class AtResolution(nn.Module):
    """A generator fixed at one ``steps`` and ``alpha``: ``z -> image``,
    what the samplers and the grid logger call."""

    def __init__(self, gen: Generator, steps: int, alpha: float = 1.0):
        super().__init__()
        self.gen, self.steps, self.alpha = gen, steps, alpha
        self.nz = gen.nz

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.gen(z, self.steps, self.alpha)
