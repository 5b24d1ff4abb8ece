"""PyTorch layers with the numerics of the JAX package's torch-compatible
blocks (port of ``ganleaks_tpu.ops.nn`` for the VAE-GAN, DCGAN, WGAN-GP,
PGGAN and medGAN nets), NCHW.

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
  ``torch_default_init``: torch's own default draw of every conv, linear
  and spectral-norm layer, from an explicit generator;
* ``SNConv2d`` / ``SNConvTranspose2d`` / ``SNDense``: the VAE-GAN's
  spectral-norm wrapper (``vaegan/ops.py:23-75``), one power iteration
  per forward, advancing ``u``/``v`` in training (see :class:`SpectralLayer`
  and :func:`spectral_chain` for the gradient);
* ``SelfAttention``: SAGAN attention (``vaegan/ops.py:86-120``);
* the PGGAN blocks (``pggan/model_torch.py``): ``leaky_relu``,
  ``pixel_norm``, ``minibatch_std``, ``upsample_nearest_2x``,
  ``avg_pool_2x`` and the equalised-learning-rate ``WSConv2d``;
* the batch axis (:func:`batch_axis`): a data-parallel trainer's hook
  through which every reduction over the rows of a batch — BatchNorm's
  and the minibatch std's statistics, medGAN's minibatch average, the
  losses' means (:func:`batch_mean`, :func:`batch_loss`) — and every
  draw with a row per image (:func:`batch_draw`) see the global batch.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


# the JAX package's names for the torch layers they re-create
Conv2dTorch = nn.Conv2d
ConvTranspose2dTorch = nn.ConvTranspose2d
DenseTorch = nn.Linear


# ---------------------------------------------------------------------------
# the batch axis
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _BatchAxis:
    reduce: Callable[[torch.Tensor], torch.Tensor]  # differentiable sum
    rows: int    # the global batch's rows
    start: int   # this rank's first row of it


_AXIS: _BatchAxis | None = None


@contextlib.contextmanager
def batch_axis(reduce_fn: Callable[[torch.Tensor], torch.Tensor],
               n_global: int, start: int = 0):
    """Inside the block, each batch a module or loss sees is this rank's
    rows ``[start, start + n)`` of a global batch of ``n_global`` rows,
    and ``reduce_fn`` sums a tensor over the ranks (differentiably, its
    backward the same sum). The reductions over the batch below then
    give the global batch's values; outside the block they are the plain
    single-device code, bit for bit. This module never talks to the
    ranks itself: the data-parallel layer (``parallel/dp``) passes the
    sum in."""
    global _AXIS
    prev, _AXIS = _AXIS, _BatchAxis(reduce_fn, int(n_global), int(start))
    try:
        yield
    finally:
        _AXIS = prev


def batch_rows(x: torch.Tensor) -> int:
    """The rows of the batch ``x`` belongs to: the global batch's on the
    batch axis, else ``x``'s own."""
    return x.shape[0] if _AXIS is None else _AXIS.rows


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over a batch (rows first). On the batch axis: this
    rank's share of the global batch's mean, ``x.sum() / (global element
    count)``; the shares of all ranks sum to the global mean (the
    gradient reduction sums them)."""
    if _AXIS is None:
        return x.mean()
    return x.sum() / (math.prod(x.shape[1:]) * _AXIS.rows)


def batch_loss(loss_fn, *args, **kwargs) -> torch.Tensor:
    """``loss_fn(*args)`` with its default mean reduction; on the batch
    axis :func:`batch_mean` of its unreduced values."""
    if _AXIS is None:
        return loss_fn(*args, **kwargs)
    return batch_mean(loss_fn(*args, reduction="none", **kwargs))


def batch_average(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over its rows, keeping the row axis (1, ...): on
    the batch axis the global batch's mean."""
    if _AXIS is None:
        return x.mean(dim=0, keepdim=True)
    return _AXIS.reduce(x.sum(dim=0, keepdim=True)) / _AXIS.rows


def batch_draw(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``draw(n)``, a draw with one row per image of an ``n``-row batch.
    On the batch axis ``draw(global rows)`` sliced to this rank's rows:
    every rank draws what one device draws for the global batch, from
    the same generator state."""
    if _AXIS is None:
        return draw(n)
    return draw(_AXIS.rows)[_AXIS.start:_AXIS.start + n]


def _global_moments(x: torch.Tensor, dims: list[int], correction: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance (``correction`` 0 biased, 1 unbiased) of ``x``
    over ``dims`` (the row axis among them) across the global batch, in
    ``x``'s dtype promoted to float32: two sums over the ranks, the mean
    first, then the squares about it."""
    xc = x.to(torch.promote_types(x.dtype, torch.float32))
    count = _AXIS.rows * math.prod(x.shape[d] for d in dims if d != 0)
    mean = _AXIS.reduce(xc.sum(dims, keepdim=True)) / count
    sq = _AXIS.reduce((xc - mean).square().sum(dims, keepdim=True))
    return mean, sq / (count - correction)


class ChannelsToLinear(nn.Linear):
    """NCHW-major flatten, then a linear layer (``vaegan/ops.py:78-83``);
    the column order matters for converted torch weights. Like the
    reference's it subclasses ``nn.Linear``, so its keys are
    ``weight``/``bias``; the JAX variables hold them under ``linear``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.flatten(1))


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
        if self.training and _AXIS is not None:
            return self._global_batch_norm(x)
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

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Training on the batch axis: the global batch's mean and biased
        variance normalise; its unbiased variance (N the global count)
        enters the running statistics."""
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean, var = _global_moments(x, dims, 0)
        ct = mean.dtype
        y = ((x.to(ct) - mean) * torch.rsqrt(var + self.eps)
             * self.weight.to(ct).view(shape) + self.bias.to(ct).view(shape))
        count = _AXIS.rows * math.prod(x.shape[2:])
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.reshape(-1))
            self.running_var.mul_(1 - m).add_(
                m * var.reshape(-1) * count / max(count - 1, 1))
        return y.to(x.dtype)


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


def fan_in(weight: torch.Tensor) -> int:
    """torch's fan-in of a conv / linear weight: ``weight.shape[1]`` times
    the kernel's size (output channels for a transposed conv, whose weight
    is IOHW)."""
    return weight.shape[1] * weight[0, 0].numel()


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
                torch_conv_default_init_(m.bias, fan_in(m.weight), generator)
        elif isinstance(m, BatchNormTorch):
            normal_init_(m.weight, std, generator)
            with torch.no_grad():
                m.bias.zero_()
    return model


def l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``v / (||v|| + eps)`` (``vaegan/ops.py:19-20``), not
    ``F.normalize``'s ``v / max(||v||, eps)``."""
    return v / (torch.linalg.vector_norm(v) + eps)


class _SpectralParams(nn.Module):
    """What the reference's ``SpectralNorm`` leaves on its wrapped layer
    (``vaegan/ops.py:47-63``): the raw weight as ``weight_bar``, the bias,
    and the power-iteration vectors ``weight_u`` / ``weight_v`` (kept as
    buffers here: the optimiser never sees them). So a wrapped layer's
    state-dict keys are the reference's ``<name>.module.weight_bar`` and
    the like, and a reference checkpoint loads by name."""

    def __init__(self, weight_shape: tuple, out_features: int, h: int,
                 w: int):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.register_buffer("weight_u", l2normalize(torch.randn(h)))
        self.register_buffer("weight_v", l2normalize(torch.randn(w)))


class SpectralLayer(nn.Module):
    """Spectral normalisation as the JAX layers compute it
    (``ganleaks_tpu.ops.nn._SpectralBase``): ``v = l2n(W^T u)``,
    ``u = l2n(W v)``, ``sigma = u^T W v`` with W the weight matricised as
    torch's ``w.view(height, -1)``, and the layer applies ``W / sigma``.

    In training each forward stores the new ``u``/``v`` in the buffers
    (the torch wrapper's in-place update, ``vaegan/ops.py:73-75``); at
    evaluation they stay frozen, as in the JAX package. The JAX forward
    is traced, so its gradient flows through the power iteration; this
    layer's does too (``torch.nn.utils.spectral_norm`` and the reference
    wrapper detach ``u``/``v``, which gives another gradient while ``u``
    has not converged). Inside :func:`spectral_chain` a forward starts
    from the previous forward's ``u`` still attached to its graph, as the
    JAX D step's fake forward starts from the real forward's output
    collection: the loss over both then differentiates through both
    iterations."""

    def _init_spectral(self, weight_shape: tuple, out_features: int,
                       h: int, w: int) -> None:
        self.module = _SpectralParams(weight_shape, out_features, h, w)
        self._chain = False
        self._live_u: torch.Tensor | None = None

    @property
    def weight(self) -> nn.Parameter:
        return self.module.weight_bar

    @property
    def bias(self) -> nn.Parameter:
        return self.module.bias

    @property
    def u(self) -> torch.Tensor:
        return self.module.weight_u

    @property
    def v(self) -> torch.Tensor:
        return self.module.weight_v

    def matrix(self) -> torch.Tensor:
        return self.weight.reshape(self.weight.shape[0], -1)

    def normalized_weight(self) -> torch.Tensor:
        wm = self.matrix()
        u0 = (self._live_u if self.training and self._live_u is not None
              else self.u)
        v = l2normalize(wm.T @ u0)
        u = l2normalize(wm @ v)
        if self.training:
            # a new tensor, not an in-place write: the previous forward's
            # graph may still hold the old vectors
            self.module.weight_u = u.detach()
            self.module.weight_v = v.detach()
            if self._chain:
                self._live_u = u
        return self.weight / (u @ (wm @ v))


class spectral_chain:
    """``with spectral_chain(net): ...``: the spectral-norm layers of
    ``net`` chain their forwards — each starts from the previous one's
    ``u`` with its graph (the JAX step threading one forward's
    ``spectral`` collection into the next inside one loss). Leaving the
    block drops the chain; the buffers hold the last vectors."""

    def __init__(self, *modules: nn.Module):
        self.layers = [m for mod in modules for m in mod.modules()
                       if isinstance(m, SpectralLayer)]

    def _set(self, on: bool) -> None:
        for layer in self.layers:
            layer._chain, layer._live_u = on, None

    def __enter__(self):
        self._set(True)
        return self

    def __exit__(self, *exc):
        self._set(False)


class SNConvTranspose2d(SpectralLayer):
    """``SpectralNorm(nn.ConvTranspose2d(...))`` (``vaegan/train.py:
    112-121``): W the IOHW weight matricised as (I, O*k*k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        k = kernel_size
        self._init_spectral((in_ch, out_ch, k, k), out_ch, in_ch,
                            out_ch * k * k)
        bound = 1.0 / (out_ch * k * k) ** 0.5
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.normalized_weight(), self.bias,
                                  self.stride, self.padding)


class SNConv2d(SpectralLayer):
    """``SpectralNorm(nn.Conv2d(...))`` (``vaegan/train.py:166-172``): W
    the OIHW weight matricised as (O, I*k*k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        k = kernel_size
        self._init_spectral((out_ch, in_ch, k, k), out_ch, out_ch,
                            in_ch * k * k)
        bound = 1.0 / (in_ch * k * k) ** 0.5
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.normalized_weight(), self.bias,
                        self.stride, self.padding)


class SNDense(SpectralLayer):
    """``SpectralNorm(nn.Linear(...))`` (``vaegan/train.py:172``): W the
    (out, in) weight."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self._init_spectral((out_features, in_features), out_features,
                            out_features, in_features)
        bound = 1.0 / in_features ** 0.5
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.normalized_weight(), self.bias)


def torch_default_init(model: nn.Module,
                       generator: torch.Generator) -> nn.Module:
    """torch's default draw of every ``nn.Conv2d``, ``nn.ConvTranspose2d``
    and ``nn.Linear`` (weight and bias U(+-1 / sqrt(fan_in))) and of every
    spectral-norm layer (the same for its ``weight_bar`` and bias, then
    ``u`` and ``v`` as l2-normalised standard normals), all from
    ``generator`` in module order (``torch_conv_default_init``)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SpectralLayer):
                fan = fan_in(m.weight)
                torch_conv_default_init_(m.weight, fan, generator)
                torch_conv_default_init_(m.bias, fan, generator)
                for buf in (m.u, m.v):
                    buf.copy_(l2normalize(torch.randn(
                        buf.shape, generator=generator, dtype=buf.dtype)))
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan = fan_in(m.weight)
                torch_conv_default_init_(m.weight, fan, generator)
                if m.bias is not None:
                    torch_conv_default_init_(m.bias, fan, generator)
    return model


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


# ---------------------------------------------------------------------------
# PGGAN blocks (pggan/model_torch.py)
# ---------------------------------------------------------------------------

def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """PixelNorm (``pggan/model_torch.py:25-31``): x over the root of its
    channel mean square, as the JAX block's ``x * rsqrt(...)``."""
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + eps)


def minibatch_std(x: torch.Tensor) -> torch.Tensor:
    """Minibatch std (``pggan/model_torch.py:122-124``): each feature's
    unbiased std over the batch (``torch.std``'s correction 1), averaged
    to one scalar and appended as a constant channel. On the batch axis
    the std is the global batch's, its sums over the ranks in float32."""
    if _AXIS is None:
        stat = torch.std(x, dim=0).mean()
    else:
        stat = _global_moments(x, [0], 1)[1].sqrt().to(x.dtype).mean()
    n, _, h, w = x.shape
    return torch.cat([x, stat.expand(n, 1, h, w)], dim=1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(scale_factor=2, mode='nearest')``
    (``pggan/model_torch.py:82``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.AvgPool2d(kernel_size=2, stride=2)`` (``:106``)."""
    return F.avg_pool2d(x, 2, 2)


class WSConv2d(nn.Module):
    """Equalised-learning-rate conv (``pggan/model_torch.py:8-22``): the
    input is scaled by ``sqrt(gain / (in * k^2))`` before a bias-free
    conv, whose weight is drawn from N(0, 1), and the bias (zero at
    first) is added unscaled after it. State-dict keys are the
    reference's: ``conv.weight`` and ``bias``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, gain: float = 2.0):
        super().__init__()
        self.conv = Conv2dTorch(in_ch, out_ch, kernel_size, stride, padding,
                                bias=False)
        self.scale = (gain / (in_ch * kernel_size ** 2)) ** 0.5
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.normal_(self.conv.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.scale
        conv = self.conv
        if x.dtype == torch.bfloat16 and x.device.type == "cpu":
            # torch's CPU bfloat16 convolution sums the weight gradient of
            # its double backward (the gradient penalty's) in bfloat16,
            # which stalls: 90% off float32 on one 16-px layer. Sum in
            # float32 and round the output, as cuDNN and XLA do.
            y = F.conv2d(x.float(), conv.weight.float(), None, conv.stride,
                         conv.padding).to(x.dtype)
        else:
            y = conv(x)
        return y + self.bias.view(1, -1, 1, 1)
