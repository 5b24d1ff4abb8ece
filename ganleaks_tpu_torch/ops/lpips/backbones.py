"""Feature tower for LPIPS: VGG16 (port of the VGG16 part of
``ganleaks_tpu.ops.lpips.backbones``).

Reproduces the torchvision slicing of
``attack_models/lpips_pytorch/models/pretrained_networks.py:96-134``: taps
after features[3, 8, 15, 22, 29] -> relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3 with channels (64, 128, 256, 512, 512).

The tower runs NCHW on cuDNN; its public input and taps are NHWC, the JAX
package's layout, so flattened taps match ``lpips_embed`` element for
element.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (out_ch, kernel, stride, pad) per conv; 'M' = max-pool 2x2 stride 2.
VGG16_CONVS = [
    (64, 3, 1, 1), (64, 3, 1, 1), "M",
    (128, 3, 1, 1), (128, 3, 1, 1), "M",
    (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
]
VGG16_TAPS = (1, 3, 6, 9, 12)      # conv-list indices (relu after these)
VGG16_CHNS = (64, 128, 256, 512, 512)


def backbone_channels(net: str) -> tuple[int, ...]:
    if net in ("vgg", "vgg16"):
        return VGG16_CHNS
    raise ValueError(f"LPIPS backbone {net!r} is not ported yet (only "
                     f"'vgg'; see ROADMAP)")


def tap_shapes(net: str, sample_shape: tuple) -> list[tuple[int, int, int]]:
    """(H_l, W_l, C_l) of every tap for one (H, W, C) input, from the conv
    and pool shapes alone (no forward pass)."""
    backbone_channels(net)  # raises for a tower that is not ported
    h, w = int(sample_shape[0]), int(sample_shape[1])
    shapes = []
    conv_i = 0
    for layer in VGG16_CONVS:
        if layer == "M":  # F.max_pool2d(2, 2) floors
            h, w = h // 2, w // 2
            continue
        c, k, s, p = layer
        h = (h + 2 * p - k) // s + 1
        w = (w + 2 * p - k) // s + 1
        if conv_i in VGG16_TAPS:
            shapes.append((h, w, c))
        conv_i += 1
    return shapes


class VGG16(nn.Module):
    """The 13-conv VGG16 feature tower with ReLU after every conv and a
    2x2 max-pool between stages; ``forward`` returns the five post-ReLU
    taps."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        convs = []
        self.pool_after: list[bool] = []
        c = in_ch
        for layer in VGG16_CONVS:
            if layer == "M":
                self.pool_after[-1] = True
                continue
            out, k, s, p = layer
            convs.append(nn.Conv2d(c, out, k, stride=s, padding=p))
            self.pool_after.append(False)
            c = out
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (N, H, W, C), already shift/scale-normalised -> five NHWC
        taps. The convs run in ``x``'s dtype (weights cast per call, as the
        JAX tower casts its kernels), so a bfloat16 input runs a bfloat16
        tower."""
        h = x.permute(0, 3, 1, 2)
        taps = []
        for i, conv in enumerate(self.convs):
            h = F.relu(F.conv2d(h, conv.weight.to(h.dtype),
                                conv.bias.to(h.dtype),
                                stride=conv.stride, padding=conv.padding))
            if i in VGG16_TAPS:
                taps.append(h.permute(0, 2, 3, 1))
            if self.pool_after[i]:
                h = F.max_pool2d(h, 2, 2)
        return taps
