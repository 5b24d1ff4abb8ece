"""InceptionV3 pool_3 feature extractor for FID (port of
``ganleaks_tpu.ops.inception``).

The standard InceptionV3 tower up to the 2048-d global average pool, NCHW,
with torchvision's module names (``Mixed_5b.branch1x1.conv`` /
``.bn``) so a torchvision ``inception_v3`` state dict loads into it
(``weights.inception_from_torchvision_state_dict``) and the JAX package's
parameter tree maps onto it name for name (``weights.inception_from_jax_params``).
torchvision itself is not imported, and its ``transform_input`` is not part
of this tower.

Input convention (the reference's, ``z_fid.py:72-73``): images in
[0, 255]; :func:`preprocess` resizes them to 299 and scales to [-1, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 0.001, running statistics) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int],
                 stride: int = 1, padding: tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        x = F.batch_norm(x, self.bn.running_mean, self.bn.running_var,
                         self.bn.weight, self.bn.bias, False, 0.0,
                         self.bn.eps)
        return F.relu(x)


def avg_pool_3x3_s1(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool`` with padding 1: the zero padding counts in the
    divisor."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """VALID padding."""
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_ch, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(in_ch, pool_features, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_s1(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(avg_pool_3x3_s1(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, max_pool_3x3_s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_ch, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = self.branch_pool(avg_pool_3x3_s1(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3Pool3(nn.Module):
    """The pool_3 tower: stem + 11 mixed blocks + the spatial mean.
    (N, 3, H, W) in [-1, 1] -> (N, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = max_pool_3x3_s2(self.Conv2d_2b_3x3(x))
        x = self.Conv2d_3b_1x1(x)
        x = max_pool_3x3_s2(self.Conv2d_4a_3x3(x))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                      self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                      self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return torch.mean(x, dim=(2, 3))  # pool_3: (N, 2048)


def preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[0, 255] NHWC images (any resolution) -> NCHW ``size`` x ``size`` in
    [-1, 1]: bilinear without antialiasing (``F.interpolate``, the
    pytorch-fid convention the JAX package matches with
    ``jax.image.resize(..., antialias=False)``)."""
    x = images.float().permute(0, 3, 1, 2) / 255.0
    if x.shape[2] != size or x.shape[3] != size:
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False, antialias=False)
    return x * 2.0 - 1.0
