"""Feature towers for LPIPS: VGG16, AlexNet, SqueezeNet1.1 and ResNet18
(port of ``ganleaks_tpu.ops.lpips.backbones``).

Reproduces the torchvision slicing of
``attack_models/lpips_pytorch/models/pretrained_networks.py``:

* vgg16: taps after features[3, 8, 15, 22, 29] (relu1_2 .. relu5_3),
  channels (64, 128, 256, 512, 512) (``:96-134``);
* alexnet: taps after features[1, 4, 7, 9, 11], channels
  (64, 192, 384, 256, 256) (``:56-94``);
* squeezenet1_1: seven taps after features[1, 4, 7, 9, 10, 11, 12],
  channels (64, 128, 256, 384, 384, 512, 512), ``ceil_mode=True``
  max-pools (``:5-53``);
* resnet18: taps at the post-ReLU conv1 and layer1..layer4, channels
  (64, 64, 128, 256, 512) (``:138-180``), with every eval-mode BatchNorm
  folded into the conv before it, so the tower is a flat conv list.

Each tower is one :class:`Tower` driven by its element list. ``convs``
holds its convolutions flat in the JAX package's traversal order
(``_conv_shapes``: a fire module's squeeze, expand1x1, expand3x3; a
BasicBlock's conv1, conv2, downsample), so one weights file fits both
packages. The tower runs NCHW on cuDNN; its public input and taps are
NHWC, the JAX package's layout.

On the card, where autograd records nothing (the attack's searches run
under ``torch.inference_mode``), every ReLU-following convolution runs
with no bias and hands its output to ``bias_relu.bias_relu_pool``, the
hand-written pass that adds the bias and applies the ReLU in place, and
also pools where the element list reads conv, tap, then a 2x2 stride-2
floor pool (all four of VGG16's pools; the 3x3 and padded pools keep
``F.max_pool2d``). The tap stays the full-resolution post-ReLU tensor.
Everywhere else (the CPU, or a backward through the tower: ``train2afc``
with ``tune_backbone``) the bias goes into ``F.conv2d``, then ``F.relu``
and ``F.max_pool2d`` follow. The two routes give the same bits on the
card; ``bias_relu.tower_counts`` counts the convolutions each took.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ganleaks_tpu_torch.ops.lpips.bias_relu import (TOWER_COUNTERS,
                                                   bias_relu_pool,
                                                   tower_counts)

# Elements:
#   ("conv", out, k, s, p)      conv + bias + relu
#   ("fire", sq, e1, e3)        squeeze 1x1 -> relu -> concat(expand1x1,
#                               expand3x3 pad 1), each + relu (3 convs)
#   ("resblock", out, s, down)  BasicBlock: conv3x3(s) - relu - conv3x3,
#                               plus the input (through a 1x1 stride-s
#                               downsample conv when ``down``), relu
#   ("maxpool", k, s, mode)     mode 'floor', 'ceil' (torch ceil_mode=True)
#                               or 'pad1' (torch padding=1)
#   ("tap",)                    collect the current activation
VGG16_ELEMS = [
    ("conv", 64, 3, 1, 1), ("conv", 64, 3, 1, 1), ("tap",),
    ("maxpool", 2, 2, "floor"),
    ("conv", 128, 3, 1, 1), ("conv", 128, 3, 1, 1), ("tap",),
    ("maxpool", 2, 2, "floor"),
    ("conv", 256, 3, 1, 1), ("conv", 256, 3, 1, 1), ("conv", 256, 3, 1, 1),
    ("tap",),
    ("maxpool", 2, 2, "floor"),
    ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1),
    ("tap",),
    ("maxpool", 2, 2, "floor"),
    ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1),
    ("tap",),
]
VGG16_CHNS = (64, 128, 256, 512, 512)

ALEXNET_ELEMS = [
    ("conv", 64, 11, 4, 2), ("tap",),
    ("maxpool", 3, 2, "floor"),
    ("conv", 192, 5, 1, 2), ("tap",),
    ("maxpool", 3, 2, "floor"),
    ("conv", 384, 3, 1, 1), ("tap",),
    ("conv", 256, 3, 1, 1), ("tap",),
    ("conv", 256, 3, 1, 1), ("tap",),
]
ALEXNET_CHNS = (64, 192, 384, 256, 256)

SQUEEZE_ELEMS = [
    ("conv", 64, 3, 2, 0), ("tap",),
    ("maxpool", 3, 2, "ceil"),
    ("fire", 16, 64, 64),
    ("fire", 16, 64, 64), ("tap",),
    ("maxpool", 3, 2, "ceil"),
    ("fire", 32, 128, 128),
    ("fire", 32, 128, 128), ("tap",),
    ("maxpool", 3, 2, "ceil"),
    ("fire", 48, 192, 192), ("tap",),
    ("fire", 48, 192, 192), ("tap",),
    ("fire", 64, 256, 256), ("tap",),
    ("fire", 64, 256, 256), ("tap",),
]
SQUEEZE_CHNS = (64, 128, 256, 384, 384, 512, 512)

RESNET18_ELEMS = [
    ("conv", 64, 7, 2, 3), ("tap",),
    ("maxpool", 3, 2, "pad1"),
    ("resblock", 64, 1, False), ("resblock", 64, 1, False), ("tap",),
    ("resblock", 128, 2, True), ("resblock", 128, 1, False), ("tap",),
    ("resblock", 256, 2, True), ("resblock", 256, 1, False), ("tap",),
    ("resblock", 512, 2, True), ("resblock", 512, 1, False), ("tap",),
]
RESNET18_CHNS = (64, 64, 128, 256, 512)


def _elems(net: str) -> tuple[list[tuple], tuple[int, ...]]:
    if net in ("vgg", "vgg16"):
        return VGG16_ELEMS, VGG16_CHNS
    if net == "alex":
        return ALEXNET_ELEMS, ALEXNET_CHNS
    if net == "squeeze":
        return SQUEEZE_ELEMS, SQUEEZE_CHNS
    if net in ("resnet", "resnet18"):
        return RESNET18_ELEMS, RESNET18_CHNS
    raise ValueError(f"unknown LPIPS backbone {net!r}")


def backbone_channels(net: str) -> tuple[int, ...]:
    return _elems(net)[1]


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _pool_out(n: int, k: int, s: int, mode: str) -> int:
    """torch ``max_pool2d``'s output size (no dilation)."""
    if mode == "pad1":
        return _conv_out(n, k, s, 1)
    if mode == "floor":
        return _conv_out(n, k, s, 0)
    out = -(-(n - k) // s) + 1   # ceil_mode: keep the partial window ...
    if (out - 1) * s >= n:       # ... unless it would start past the input
        out -= 1
    return out


def tap_shapes(net: str, sample_shape: tuple) -> list[tuple[int, int, int]]:
    """(H_l, W_l, C_l) of every tap for one (H, W, C) input, from the conv
    and pool shapes alone (no forward pass)."""
    elems, _ = _elems(net)
    h, w = int(sample_shape[0]), int(sample_shape[1])
    c = 0  # every tower starts with a conv
    shapes = []
    for el in elems:
        kind = el[0]
        if kind == "tap":
            shapes.append((h, w, c))
        elif kind == "maxpool":
            h, w = (_pool_out(n, el[1], el[2], el[3]) for n in (h, w))
        elif kind == "conv":
            c, k, s, p = el[1:]
            h, w = _conv_out(h, k, s, p), _conv_out(w, k, s, p)
        elif kind == "fire":
            c = el[2] + el[3]
        elif kind == "resblock":
            c, s = el[1], el[2]
            h, w = _conv_out(h, 3, s, 1), _conv_out(w, 3, s, 1)
    return shapes


def _conv_specs(net: str, in_ch: int = 3) -> list[tuple[int, int, int, int,
                                                       int]]:
    """(in, out, k, stride, pad) of every conv, in traversal order."""
    elems, _ = _elems(net)
    specs = []
    c = in_ch
    for el in elems:
        kind = el[0]
        if kind == "conv":
            out, k, s, p = el[1:]
            specs.append((c, out, k, s, p))
            c = out
        elif kind == "fire":
            sq, e1, e3 = el[1:]
            specs += [(c, sq, 1, 1, 0), (sq, e1, 1, 1, 0), (sq, e3, 3, 1, 1)]
            c = e1 + e3
        elif kind == "resblock":
            out, s, down = el[1:]
            specs += [(c, out, 3, s, 1), (out, out, 3, 1, 1)]
            if down:
                specs.append((c, out, 1, s, 0))
            c = out
    return specs


def _conv(h: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` in ``h``'s dtype (weights cast per call, as the JAX tower
    casts its kernels), so a bfloat16 input runs a bfloat16 tower."""
    return F.conv2d(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype),
                    stride=conv.stride, padding=conv.padding)


def _records_grad(h: torch.Tensor, conv: nn.Conv2d) -> bool:
    """Whether autograd records ``conv`` applied to ``h``."""
    return torch.is_grad_enabled() and (
        h.requires_grad or conv.weight.requires_grad
        or conv.bias.requires_grad)


def _on_kernel(h: torch.Tensor, conv: nn.Conv2d) -> bool:
    """Whether ``conv``'s bias and ReLU run in ``bias_relu_pool``'s kernel:
    on the card, where autograd records nothing."""
    return h.device.type == "cuda" and not _records_grad(h, conv)


def _conv_relu(h: torch.Tensor, conv: nn.Conv2d, pool: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``relu(conv(h))`` and, with ``pool`` on the kernel's route, its 2x2
    stride-2 max pool (else None: the caller pools)."""
    if not _on_kernel(h, conv):
        tower_counts[TOWER_COUNTERS[1]] += 1
        return F.relu(_conv(h, conv)), None
    y = F.conv2d(h, conv.weight.to(h.dtype), None, stride=conv.stride,
                 padding=conv.padding)
    tower_counts[TOWER_COUNTERS[0]] += 1
    return bias_relu_pool(y.contiguous(memory_format=torch.channels_last),
                          conv.bias.to(h.dtype), pool)


class Tower(nn.Module):
    """One LPIPS feature tower (``net`` in vgg / alex / squeeze / resnet,
    with the 'vgg16' and 'resnet18' aliases); ``forward`` returns its
    post-ReLU taps."""

    def __init__(self, net: str = "vgg", in_ch: int = 3):
        super().__init__()
        self.elems, _ = _elems(net)
        self.convs = nn.ModuleList(
            nn.Conv2d(c, out, k, stride=s, padding=p)
            for c, out, k, s, p in _conv_specs(net, in_ch))
        # conv elements whose pool the kernel's pass takes: conv, tap, then
        # a 2x2 stride-2 floor pool
        self.pool_after = frozenset(
            i for i, el in enumerate(self.elems) if el[0] == "conv"
            and self.elems[i + 1:i + 3] == [("tap",),
                                            ("maxpool", 2, 2, "floor")])

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (N, H, W, C), already shift/scale-normalised -> NHWC taps."""
        h = x.permute(0, 3, 1, 2)
        convs = iter(self.convs)
        taps = []
        pooled = None  # the kernel's pool of the last conv, if it took it
        for i, el in enumerate(self.elems):
            kind = el[0]
            if kind == "tap":
                taps.append(h.permute(0, 2, 3, 1))
            elif kind == "maxpool":
                if pooled is not None:
                    h, pooled = pooled, None
                else:
                    k, s, mode = el[1:]
                    h = F.max_pool2d(h, k, s, padding=int(mode == "pad1"),
                                     ceil_mode=mode == "ceil")
            elif kind == "conv":
                h, pooled = _conv_relu(h, next(convs), i in self.pool_after)
            elif kind == "fire":
                sq, _ = _conv_relu(h, next(convs))
                e1, _ = _conv_relu(sq, next(convs))
                e3, _ = _conv_relu(sq, next(convs))
                h = torch.cat([e1, e3], dim=1)
            elif kind == "resblock":
                y, _ = _conv_relu(h, next(convs))
                y = _conv(y, next(convs))
                if el[3]:
                    h = _conv(h, next(convs))
                h = F.relu(y + h)
        return taps
