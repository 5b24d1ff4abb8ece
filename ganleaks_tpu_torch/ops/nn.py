"""PyTorch layers with the numerics of the JAX package's torch-compatible
blocks (port of ``ganleaks_tpu.ops.nn`` for the VAE-GAN, DCGAN and
WGAN-GP nets), NCHW.

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
* ``BatchNormTorch``: at evaluation the running statistics (eps 1e-5) in
  float32; in training the batch statistics, accumulating the unbiased
  variance into the running ones (``F.batch_norm``, momentum 0.1);
* ``InstanceNorm2d``: ``nn.InstanceNorm2d`` with the JAX block's default
  ``affine=True`` (``wgangp/model.py:28``); scale/bias -> weight/bias;
* ``normal_init_`` / ``initialize_weights``: the reference's N(0, 0.02)
  draw of every conv and BatchNorm weight (``dcgan/model_torch.py:
  124-127``) from an explicit ``torch.Generator``;
* ``SNConvTranspose2d``: spectral norm as the VAE-GAN wrapper does it at
  evaluation (``vaegan/ops.py:23-75``);
* ``SelfAttention``: SAGAN attention (``vaegan/ops.py:86-120``).

``SNConv2d``, ``SNDense`` and the PGGAN blocks belong to the VAE-GAN and
PGGAN trainers and are not ported yet (ROADMAP M10).
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
    """torch ``BatchNorm2d``/``1d`` over the channel axis (dim 1). At
    evaluation ``(x - mean) * rsqrt(var + eps) * scale + bias`` from the
    running statistics, in float32, cast back to the input dtype. In
    training (``ganleaks_tpu.ops.nn._TorchBN``) the batch's mean and biased
    variance normalise, and the unbiased variance enters the running
    statistics with ``momentum``; torch reduces in its own order where the
    JAX package takes E[x^2] - mean^2, so the two agree to rounding."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=True,
                                momentum=self.momentum, eps=self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        ct = torch.promote_types(x.dtype, torch.float32)
        y = ((x.to(ct) - self.running_mean.to(ct).view(shape))
             * torch.rsqrt(self.running_var.to(ct).view(shape) + self.eps))
        return (y * self.weight.to(ct).view(shape)
                + self.bias.to(ct).view(shape)).to(x.dtype)


class InstanceNorm2d(nn.InstanceNorm2d):
    """``nn.InstanceNorm2d`` with ``affine=True`` by default, as the JAX
    block (``wgangp/model.py:28``): per-sample, per-channel normalisation
    over H, W with the biased variance, eps 1e-5, no running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__(num_features, eps=eps, affine=affine)


def normal_init_(tensor: torch.Tensor, std: float = 0.02,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Fill ``tensor`` from N(0, std) in place (``normal_init``)."""
    with torch.no_grad():
        return tensor.normal_(0.0, std, generator=generator)


def torch_conv_default_init_(tensor: torch.Tensor, fan_in: int,
                             generator: torch.Generator | None = None
                             ) -> torch.Tensor:
    """torch's default Conv/Linear draw, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    in place (``torch_conv_default_init``)."""
    bound = 1.0 / fan_in ** 0.5
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


def initialize_weights(model: nn.Module, generator: torch.Generator,
                       std: float = 0.02) -> nn.Module:
    """The reference's ``initialize_weights`` (``dcgan/model_torch.py:
    124-127``, ``wgangp/model.py:61-64``): every Conv2d, ConvTranspose2d
    and BatchNorm weight from N(0, std) — BatchNorm's scale included —
    with BatchNorm biases zero and conv biases torch's default U(+-1 /
    sqrt(fan_in)) (fan_in = weight.shape[1] * k * k: input channels for a
    conv, output channels for a transposed one), all drawn from
    ``generator`` in module order. InstanceNorm keeps its (1, 0)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            normal_init_(m.weight, std, generator)
            if m.bias is not None:
                fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
                torch_conv_default_init_(m.bias, fan_in, generator)
        elif isinstance(m, BatchNormTorch):
            normal_init_(m.weight, std, generator)
            with torch.no_grad():
                m.bias.zero_()
    return model


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
