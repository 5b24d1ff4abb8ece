"""LPIPS (net-lin) perceptual distance in PyTorch (port of
``ganleaks_tpu.ops.lpips.lpips``).

* inputs in [-1, 1], shifted/scaled per channel by the v0.1 constants
  (``networks_basic.py:115-116,135-136``);
* backbone taps unit-normalised per pixel over channels with eps OUTSIDE
  the sqrt (``util/util.py:70-73``);
* squared differences weighted by the non-negative lin heads, spatially
  averaged, summed over the five layers (``networks_basic.py:158-181``).

:func:`lpips_pair` is the pairwise form; :func:`lpips_embed` the factorised
form ``weight * LPIPS(x, y) == ||phi(x) - phi(y)||^2`` with
``phi_l = f_l * sqrt(weight * w_l / (H_l * W_l))`` that turns the attack
into one nearest-neighbour search.

Weights: :func:`init_lpips_params` seeds a surrogate backbone from a
``torch.Generator`` (same init distribution as the JAX surrogate, other
bits); :func:`default_lpips_params` adds the real v0.1 lin heads shipped in
``weights/vgg_lin.npz``; :func:`save_lpips_params` /
:func:`load_lpips_params` read and write the JAX package's npz schema, so
one file drives both packages.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ganleaks_tpu_torch.ops.distance import images_unit_range
from ganleaks_tpu_torch.ops.lpips.backbones import VGG16, backbone_channels

# v0.1 input normalisation constants (networks_basic.py:115-116)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)

_EPS_NORM = 1e-10  # util.normalize_tensor eps (util/util.py:70)


def normalize_tensor(feat: torch.Tensor, eps: float = _EPS_NORM
                     ) -> torch.Tensor:
    """f / (||f||_c + eps): channel-unit vectors per pixel, channels last
    (``util/util.py:70-73``)."""
    norm = torch.sqrt(torch.sum(torch.square(feat), dim=-1, keepdim=True))
    return feat / (norm + eps)


class LPIPS(nn.Module):
    """VGG16 feature tower plus the five lin heads (buffers ``lin0`` ..
    ``lin4``). ``features`` takes NHWC images in [-1, 1] (or uint8 bytes)
    and returns the five NHWC taps."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        chns = backbone_channels(net)
        self.net = net
        self.tower = VGG16()
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT))
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE))
        for i, c in enumerate(chns):
            self.register_buffer(f"lin{i}", torch.full((c,), 1.0 / c))

    @property
    def lins(self) -> list[torch.Tensor]:
        return [getattr(self, f"lin{i}")
                for i in range(len(backbone_channels(self.net)))]

    def features(self, x: torch.Tensor,
                 compute_dtype: torch.dtype | None = None
                 ) -> list[torch.Tensor]:
        """Backbone taps of ``(x - shift) / scale``; ``compute_dtype``
        (e.g. bfloat16) runs the tower in that dtype."""
        x = images_unit_range(x)
        xs = (x - self.shift.to(x.dtype)) / self.scale.to(x.dtype)
        if compute_dtype is not None:
            xs = xs.to(compute_dtype)
        return self.tower(xs)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_lpips_params(seed: int = 0, net: str = "vgg",
                      lin_weights: list[np.ndarray] | None = None) -> LPIPS:
    """Surrogate-backbone LPIPS, drawn from a ``torch.Generator`` seeded
    with ``seed`` (never the global RNG): every conv kernel and bias is
    uniform in ``±1/sqrt(fan_in)``, torch's default conv init scale.
    ``lin_weights`` sets the heads; otherwise they are uniform ``1/C``."""
    g = torch.Generator().manual_seed(seed)
    model = LPIPS(net)
    with torch.no_grad():
        for conv in model.tower.convs:
            out, c, k, _ = conv.weight.shape
            bound = 1.0 / (c * k * k) ** 0.5
            conv.weight.uniform_(-bound, bound, generator=g)
            conv.bias.uniform_(-bound, bound, generator=g)
        if lin_weights is not None:
            for buf, w in zip(model.lins, lin_weights):
                buf.copy_(torch.as_tensor(np.asarray(w, np.float32))
                          .reshape(-1))
    return model


def save_lpips_params(path: str, model: LPIPS) -> None:
    """Write ``model`` in the JAX package's npz schema (``net``,
    ``conv{i}/kernel`` HWIO, ``conv{i}/bias``, ``lin{i}``)."""
    from ganleaks_tpu_torch.weights import lpips_to_jax_params

    params = lpips_to_jax_params(model)
    flat = {"net": np.asarray(params["net"])}
    for i, c in enumerate(params["convs"]):
        flat[f"conv{i}/kernel"] = c["kernel"]
        flat[f"conv{i}/bias"] = c["bias"]
    for i, lin in enumerate(params["lins"]):
        flat[f"lin{i}"] = lin
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_lpips_params(path: str) -> LPIPS:
    """Read an npz in the JAX package's schema into an :class:`LPIPS`."""
    from ganleaks_tpu_torch.weights import lpips_from_jax_params

    with np.load(path) as z:
        convs = []
        i = 0
        while f"conv{i}/kernel" in z.files:
            convs.append({"kernel": z[f"conv{i}/kernel"],
                          "bias": z[f"conv{i}/bias"]})
            i += 1
        lins = []
        i = 0
        while f"lin{i}" in z.files:
            lins.append(z[f"lin{i}"])
            i += 1
        net = str(z["net"])
    return lpips_from_jax_params({"net": net, "convs": convs, "lins": lins})


def reference_lin_weights(net: str = "vgg") -> list[np.ndarray]:
    """The real v0.1 lin-head weights (7 KB, converted from the
    reference's ``pretrained_models/v0.1/vgg.pth``), bundled as npz."""
    path = os.path.join(os.path.dirname(__file__), "weights",
                        f"{net}_lin.npz")
    with np.load(path) as z:
        return [z[f"lin{i}"] for i in range(len(z.files))]


def default_lpips_params(net: str = "vgg", seed: int = 0) -> LPIPS:
    """Best available LPIPS without external files: real lin heads plus a
    seeded surrogate backbone. Load a converted npz with
    :func:`load_lpips_params` for the pretrained backbone instead."""
    try:
        lins = reference_lin_weights(net)
    except FileNotFoundError:
        lins = None
    return init_lpips_params(seed, net, lin_weights=lins)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def lpips_pair(model: LPIPS, x: torch.Tensor, y: torch.Tensor
               ) -> torch.Tensor:
    """LPIPS(x, y) for NHWC batches in [-1, 1], broadcast on the leading
    axis (``networks_basic.py:134-181``)."""
    if x.shape[0] != y.shape[0]:
        n = max(x.shape[0], y.shape[0])
        x = x.expand((n,) + tuple(x.shape[1:]))
        y = y.expand((n,) + tuple(y.shape[1:]))
    fx = model.features(x)
    fy = model.features(y)
    val = 0.0
    for fl_x, fl_y, w in zip(fx, fy, model.lins):
        diff = torch.square(normalize_tensor(fl_x) - normalize_tensor(fl_y))
        lin = torch.sum(diff * w.to(diff.dtype), dim=-1)
        val = val + torch.mean(lin, dim=(1, 2))
    return val


def lpips_embed(model: LPIPS, x: torch.Tensor, weight: float = 1.0,
                dtype: torch.dtype = torch.float32,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """phi(x): concatenated scaled normalised taps, flattened in NHWC
    order, so that ``weight * LPIPS(x, y) == ||phi(x) - phi(y)||^2``
    (negative lin weights are clamped to 0)."""
    feats = model.features(x, compute_dtype)
    parts = []
    for fl, w in zip(feats, model.lins):
        n, h, wd, _c = fl.shape
        scale = torch.sqrt(torch.clamp(w, min=0.0) * (weight / (h * wd)))
        # normalisation in f32 regardless of tower dtype
        phi = normalize_tensor(fl.float()) * scale
        parts.append(phi.reshape(n, -1).to(dtype))
    return torch.cat(parts, dim=1)


def lpips_embed_fn(model: LPIPS, weight: float = 0.2,
                   dtype: torch.dtype = torch.float32,
                   compute_dtype: torch.dtype | None = None):
    """Closure for ``ops/distance.make_embed_fn`` ('l2-lpips')."""
    def embed(x: torch.Tensor) -> torch.Tensor:
        return lpips_embed(model, x, weight=weight, dtype=dtype,
                           compute_dtype=compute_dtype)
    return embed
