"""PyTorch layers with the numerics of the JAX package's torch-compatible
blocks (port of the inference part of ``ganleaks_tpu.ops.nn``), NCHW.

The JAX blocks re-create torch layers on NHWC; here most are the torch
layers themselves under the JAX names, and what matters is how the JAX
parameters map onto them (``weights.load_jax_tree``):

* ``Conv2dTorch``: ``nn.Conv2d``; JAX kernel HWIO -> weight OIHW;
* ``ConvTranspose2dTorch``: ``nn.ConvTranspose2d``; the JAX layer is an
  input-dilated convolution with the spatially flipped kernel, which is
  the definition of the transposed convolution, so its HWIO kernel (I =
  input channels) maps to the IOHW weight by ``transpose(2, 3, 0, 1)``;
* ``DenseTorch``: ``nn.Linear``; kernel (in, out) -> weight (out, in);
* ``ChannelsToLinear``: flatten in NCHW order, then a linear layer;
* ``BatchNormTorch``: running statistics only (eps 1e-5), in float32;
* ``SNConvTranspose2d``: spectral norm as the VAE-GAN wrapper does it at
  evaluation (``vaegan/ops.py:23-75``);
* ``SelfAttention``: SAGAN attention (``vaegan/ops.py:86-120``).

Train-mode batch statistics, ``SNConv2d``, ``SNDense`` and the PGGAN
blocks belong to training and are not ported yet (ROADMAP M10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


# the JAX package's names for the torch layers they re-create
Conv2dTorch = nn.Conv2d
ConvTranspose2dTorch = nn.ConvTranspose2d
DenseTorch = nn.Linear


class ChannelsToLinear(nn.Module):
    """NCHW-major flatten, then a linear layer (``vaegan/ops.py:78-83``);
    the column order matters for converted torch weights."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.linear = DenseTorch(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.flatten(1))


class BatchNormTorch(nn.Module):
    """torch ``BatchNorm2d``/``1d`` at evaluation over the channel axis
    (dim 1): ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32,
    cast back to the input dtype. Training mode raises: batch statistics
    are not ported yet (ROADMAP M10)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNormTorch runs on running statistics only; call "
                ".eval() (train-mode statistics: ROADMAP M10)")
        shape = (1, -1) + (1,) * (x.dim() - 2)
        ct = torch.promote_types(x.dtype, torch.float32)
        y = ((x.to(ct) - self.running_mean.to(ct).view(shape))
             * torch.rsqrt(self.running_var.to(ct).view(shape) + self.eps))
        return (y * self.weight.to(ct).view(shape)
                + self.bias.to(ct).view(shape)).to(x.dtype)


def l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``v / (||v|| + eps)`` (``vaegan/ops.py:19-20``), not
    ``F.normalize``'s ``v / max(||v||, eps)``."""
    return v / (torch.linalg.vector_norm(v) + eps)


class SNConvTranspose2d(nn.Module):
    """``SpectralNorm(nn.ConvTranspose2d(...))`` at evaluation, as the JAX
    layer runs it: one power iteration per forward from the stored ``u``
    and ``v`` (``v = l2n(W^T u)``, ``u = l2n(W v)``) with W the IOHW weight
    matricised as (I, O*k*k), then the convolution with ``W / (u^T W v)``.
    ``u`` and ``v`` are buffers the forward pass never writes (the torch
    wrapper updates them even in eval; the JAX package freezes them at
    evaluation, and so does this layer).
    ``torch.nn.utils.spectral_norm`` skips the iteration in eval mode, so
    it is not used."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(in_ch, out_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        bound = 1.0 / (out_ch * kernel_size * kernel_size) ** 0.5
        nn.init.uniform_(self.weight, -bound, bound)
        self.register_buffer("u", l2normalize(torch.randn(in_ch)))
        self.register_buffer("v", l2normalize(
            torch.randn(out_ch * kernel_size * kernel_size)))

    def normalized_weight(self) -> torch.Tensor:
        wm = self.weight.reshape(self.weight.shape[0], -1)
        v = l2normalize(wm.T @ self.u)
        u = l2normalize(wm @ v)
        sigma = u @ (wm @ v)
        return self.weight / sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.normalized_weight(), self.bias,
                                  self.stride, self.padding)


class SelfAttention(nn.Module):
    """SAGAN spatial self-attention (``vaegan/ops.py:86-120``): 1x1
    query/key convs to C/8 channels and a value conv to C, softmax over the
    keys with positions in row-major h*w order, ``gamma * out + x``."""

    def __init__(self, channels: int):
        super().__init__()
        self.query_conv = Conv2dTorch(channels, channels // 8, 1)
        self.key_conv = Conv2dTorch(channels, channels // 8, 1)
        self.value_conv = Conv2dTorch(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        q = self.query_conv(x).flatten(2).transpose(1, 2)   # (n, hw, c/8)
        k = self.key_conv(x).flatten(2).transpose(1, 2)
        v = self.value_conv(x).flatten(2).transpose(1, 2)   # (n, hw, c)
        attn = torch.softmax(q @ k.transpose(1, 2), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(n, c, h, w)
        return self.gamma * out + x
