"""The LPIPS towers as layer tables: the one description of each network
that the plain reference (``reference.py``) runs and the counting
functions (``counting.py``) count.

Written from the published networks, not from the program:
torchvision's VGG16 ``features`` (Simonyan and Zisserman, 2015) and
AlexNet ``features`` as LPIPS v0.1 slices them
(``lpips/pretrained_networks.py``): VGG16 taps relu1_2, relu2_2, relu3_3,
relu4_3 and relu5_3; AlexNet taps relu1 to relu5.

A layer is ``("conv", out_channels, kernel, stride, padding)`` (a
convolution with bias, then ReLU), ``("pool", kernel, stride)`` (max
pooling, floor mode) or ``("tap",)`` (the current activation is an LPIPS
feature).
"""

from __future__ import annotations

_VGG16 = [
    ("conv", 64, 3, 1, 1), ("conv", 64, 3, 1, 1), ("tap",), ("pool", 2, 2),
    ("conv", 128, 3, 1, 1), ("conv", 128, 3, 1, 1), ("tap",), ("pool", 2, 2),
    ("conv", 256, 3, 1, 1), ("conv", 256, 3, 1, 1), ("conv", 256, 3, 1, 1),
    ("tap",), ("pool", 2, 2),
    ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1),
    ("tap",), ("pool", 2, 2),
    ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1), ("conv", 512, 3, 1, 1),
    ("tap",),
]

_ALEX = [
    ("conv", 64, 11, 4, 2), ("tap",), ("pool", 3, 2),
    ("conv", 192, 5, 1, 2), ("tap",), ("pool", 3, 2),
    ("conv", 384, 3, 1, 1), ("tap",),
    ("conv", 256, 3, 1, 1), ("tap",),
    ("conv", 256, 3, 1, 1), ("tap",),
]

NETS = {"vgg": _VGG16, "alex": _ALEX}

# LPIPS v0.1's input normalisation (``ScalingLayer``)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
EPS = 1e-10  # ``normalize_tensor``: f / (||f||_c + eps)


def layers(net: str) -> list[tuple]:
    try:
        return NETS[net]
    except KeyError:
        raise ValueError(f"unknown net {net!r}; expected one of "
                         f"{sorted(NETS)}") from None


def conv_shapes(net: str, in_ch: int = 3) -> list[tuple[int, int, int]]:
    """(out_channels, in_channels, kernel) of every convolution, in order."""
    out, c = [], in_ch
    for layer in layers(net):
        if layer[0] == "conv":
            out.append((layer[1], c, layer[2]))
            c = layer[1]
    return out


def walk(net: str, res: int):
    """Yield ``(layer, h_in, w_in, c_in, h_out, w_out, c_out)`` for every
    layer at a square ``res`` input with 3 channels."""
    h = w = res
    c = 3
    for layer in layers(net):
        kind = layer[0]
        if kind == "conv":
            _, co, k, s, p = layer
            ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            yield layer, h, w, c, ho, wo, co
            h, w, c = ho, wo, co
        elif kind == "pool":
            _, k, s = layer
            ho, wo = (h - k) // s + 1, (w - k) // s + 1
            yield layer, h, w, c, ho, wo, c
            h, w = ho, wo
        else:
            yield layer, h, w, c, h, w, c


def tap_shapes(net: str, res: int) -> list[tuple[int, int, int]]:
    """(H, W, C) of every tap at a square ``res`` input."""
    return [(h, w, c) for layer, h, w, c, *_ in walk(net, res)
            if layer[0] == "tap"]
