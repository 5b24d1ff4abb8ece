"""LPIPS (net-lin) perceptual distance in PyTorch (port of
``ganleaks_tpu.ops.lpips.lpips``), on any of the four towers of
``backbones`` (vgg, alex, squeeze, resnet).

* inputs in [-1, 1], shifted/scaled per channel by the v0.1 constants
  (``networks_basic.py:115-116,135-136``);
* backbone taps unit-normalised per pixel over channels with eps OUTSIDE
  the sqrt (``util/util.py:70-73``);
* squared differences weighted by the non-negative lin heads, spatially
  averaged, summed over the taps (``networks_basic.py:158-181``).

:func:`lpips_pair` is the pairwise form and :func:`pnet_pair` the
uncalibrated cosine ('net') distance; :func:`lpips_embed` the factorised
form ``weight * LPIPS(x, y) == ||phi(x) - phi(y)||^2`` with
``phi_l = f_l * sqrt(weight * w_l / (H_l * W_l))`` that turns the attack
into one nearest-neighbour search. :func:`lpips_embed_parts` returns the
same phi as one (N, H_l*W_l, C_l) part per tap (the ``taps`` engines), and
:func:`lpips_embed_parts_fn` adds the parts' static bounds and the fused
featuriser that runs each tap through the tap epilogue kernel
(``ops/lpips/epilogue``).

Weights: :func:`init_lpips_params` seeds a surrogate backbone from a
``torch.Generator`` (same init distribution as the JAX surrogate, other
bits); :func:`default_lpips_params` adds the real v0.1 lin heads where
the repository has them (only ``weights/vgg_lin.npz``: the other towers
keep uniform heads); :func:`save_lpips_params` /
:func:`load_lpips_params` read and write the JAX package's npz schema, so
one file drives both packages.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.ops.distance import images_unit_range
from ganleaks_tpu_torch.ops.lpips.backbones import (Tower, backbone_channels,
                                                    tap_shapes)
from ganleaks_tpu_torch.ops.lpips.epilogue import tap_epilogue, tap_phi
from ganleaks_tpu_torch.utils.profiling import span

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
    """A feature tower (``backbones.Tower(net)``) plus one lin head per tap
    (buffers ``lin0``, ``lin1``, ...: five, seven for squeeze).
    ``features`` takes NHWC images in [-1, 1] (or uint8 bytes) and returns
    the NHWC taps."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        chns = backbone_channels(net)
        self.net = net
        self.tower = Tower(net)
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

def _pair_features(model: LPIPS, x: torch.Tensor, y: torch.Tensor):
    """Taps of ``x`` and ``y`` broadcast on the leading axis."""
    if x.shape[0] != y.shape[0]:
        n = max(x.shape[0], y.shape[0])
        x = x.expand((n,) + tuple(x.shape[1:]))
        y = y.expand((n,) + tuple(y.shape[1:]))
    return model.features(x), model.features(y)


def lpips_pair(model: LPIPS, x: torch.Tensor, y: torch.Tensor
               ) -> torch.Tensor:
    """LPIPS(x, y) for NHWC batches in [-1, 1], broadcast on the leading
    axis (``networks_basic.py:134-181``)."""
    fx, fy = _pair_features(model, x, y)
    val = 0.0
    for fl_x, fl_y, w in zip(fx, fy, model.lins):
        diff = torch.square(normalize_tensor(fl_x) - normalize_tensor(fl_y))
        lin = torch.sum(diff * w.to(diff.dtype), dim=-1)
        val = val + torch.mean(lin, dim=(1, 2))
    return val


def pnet_pair(model: LPIPS, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """Uncalibrated 'net' distance (``networks_basic.PNet``,
    ``networks_basic.py:21-73``): the sum over taps of
    ``1 - mean_{h,w} cos_sim(f_x, f_y)``, DistModel's ``model='net'``
    branch (``dist_model.py:77-79``)."""
    fx, fy = _pair_features(model, x, y)
    val = 0.0
    for fl_x, fl_y in zip(fx, fy):
        cos = torch.sum(normalize_tensor(fl_x) * normalize_tensor(fl_y),
                        dim=-1)
        val = val + (1.0 - torch.mean(cos, dim=(1, 2)))
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
        scale = _tap_scale(w, weight, h * wd)
        # normalisation in f32 regardless of tower dtype
        phi = normalize_tensor(fl.float()) * scale
        parts.append(phi.reshape(n, -1).to(dtype))
    return torch.cat(parts, dim=1)


def _tap_scale(w: torch.Tensor, weight: float, n_pos: int) -> torch.Tensor:
    """float32 ``sqrt(max(w, 0) * weight / (H * W))`` of one tap."""
    return torch.sqrt(torch.clamp(w, min=0.0) * (weight / n_pos))


def lpips_embed_fn(model: LPIPS, weight: float = 0.2,
                   dtype: torch.dtype = torch.float32,
                   compute_dtype: torch.dtype | None = None):
    """Closure for ``ops/distance.make_embed_fn`` ('l2-lpips'), carrying
    ``tower`` (:func:`tower_key`) for the stream planner."""
    def embed(x: torch.Tensor) -> torch.Tensor:
        return lpips_embed(model, x, weight=weight, dtype=dtype,
                           compute_dtype=compute_dtype)
    embed.tower = tower_key(model, compute_dtype)
    return embed


def tower_key(model: LPIPS, compute_dtype: torch.dtype | None) -> tuple:
    """(net, dtype name) of the tower a featuriser runs: the key of the
    stream planner's activation charge (``ops/stream_plan``)."""
    dt = compute_dtype if compute_dtype is not None else torch.float32
    return model.net, str(dt).replace("torch.", "")


class PerceptualLoss:
    """The reference's facade (``lpips_pytorch/__init__.py:9-32``):
    ``forward(pred, target, normalize)``, where ``normalize=True`` takes
    inputs in [0, 1] and maps them to [-1, 1] first. The model lives on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``), and
    ``forward`` moves its inputs there."""

    def __init__(self, net: str = "vgg", weights: str | None = None,
                 seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = (load_lpips_params(weights) if weights
                      else default_lpips_params(net, seed)
                      ).eval().to(self.device)

    def forward(self, pred: torch.Tensor, target: torch.Tensor,
                normalize: bool = False) -> torch.Tensor:
        pred = pred.to(self.device)
        target = target.to(self.device)
        if normalize:
            pred = 2 * pred - 1
            target = 2 * target - 1
        return lpips_pair(self.model, target, pred)

    __call__ = forward


def embed_dim(model: LPIPS, resolution: int) -> int:
    """Width of :func:`lpips_embed` at a square input resolution, from the
    tap shapes (no forward pass)."""
    return sum(h * w * c for h, w, c
               in tap_shapes(model.net, (resolution, resolution, 3)))


# ---------------------------------------------------------------------------
# tap-structured parts (the 'taps' / 'taps-int8' engines)
# ---------------------------------------------------------------------------

def lpips_part_shapes(net: str, sample_shape: tuple) -> list[tuple[int, int]]:
    """(H_l*W_l, C_l) of every part of :func:`lpips_embed_parts` for one
    (H, W, C) input."""
    return [(h * w, c) for h, w, c in tap_shapes(net, sample_shape)]


def lpips_embed_parts(model: LPIPS, x: torch.Tensor, weight: float = 1.0,
                      dtype: torch.dtype = torch.float32,
                      compute_dtype: torch.dtype | None = None
                      ) -> list[torch.Tensor]:
    """Tap-structured phi: one (N, H_l*W_l, C_l) part per tap, channels
    last, such that the sum of per-part squared distances equals
    :func:`lpips_embed`'s flat ``||phi(x) - phi(y)||^2``. The channel norm
    takes the tap epilogue's summation order (``epilogue.channel_sumsq``),
    so these parts equal the fused featuriser's bit for bit. The tower
    runs in the span ``lpips.tower``."""
    with span("lpips.tower"):
        feats = model.features(x, compute_dtype)
    parts = []
    for fl, w in zip(feats, model.lins):
        n, h, wd, c = fl.shape
        phi = tap_phi(fl.reshape(n, h * wd, c), _tap_scale(w, weight, h * wd))
        parts.append(phi.to(dtype))
    return parts


def lpips_part_bounds(model: LPIPS, sample_shape: tuple,
                      weight: float = 0.2) -> list[float]:
    """Per-part elementwise bound max|phi_l| at input ``sample_shape``
    (H, W, C): every component of a unit-normalised feature vector is
    <= 1, so ``|phi_l| <= max_c sqrt(w_lc * weight / (H_l * W_l))``.
    Rigorous: the static quantisation scale of the int8 engine."""
    bounds = []
    for (n_pos, _c), w in zip(lpips_part_shapes(model.net, sample_shape),
                              model.lins):
        wmax = float(np.max(np.maximum(w.detach().cpu().numpy(), 0.0)))
        bounds.append(float(np.sqrt(wmax * weight / n_pos)))
    return bounds


def lpips_part_int_dot_bounds(model: LPIPS,
                              sample_shape: tuple) -> list[float]:
    """:func:`lpips_net_int_dot_bounds` of ``model``'s net."""
    return lpips_net_int_dot_bounds(model.net, sample_shape)


def lpips_net_int_dot_bounds(net: str, sample_shape: tuple) -> list[float]:
    """Per-part bound on |int8 cross dot| of ``net``'s taps at one
    ``sample_shape`` input, from the tap shapes alone (no weights): per
    position the channel vector is unit-normalised, so its int8 image has
    L2 <= 127 + 0.5*sqrt(C) (rounding), and Cauchy-Schwarz gives |dot per
    position| <= that squared, summed over the H_l*W_l positions."""
    return [float(n_pos) * (127.0 + 0.5 * float(c) ** 0.5) ** 2
            for n_pos, c in lpips_part_shapes(net, sample_shape)]


def lpips_fast_parts_norms(model: LPIPS, weight: float, dtype: torch.dtype,
                           compute_dtype: torch.dtype | None,
                           cdtype: torch.dtype, bounds=None):
    """The fused LPIPS featuriser of the ``taps`` engines:
    ``fast(x, out, r) -> r`` runs the tower and each tap through
    ``epilogue.tap_epilogue`` (the kernel on CUDA), writing the parts in
    order into the column slices of ``out`` (N, sum of widths) — cast to
    ``cdtype``, or int8 at ``bounds`` — and returns ``r`` plus each tap's
    float32 norms, added tap by tap. ``fast.widths(sample_shape)`` gives
    the part widths H_l*W_l*C_l. Spans: ``lpips.tower`` (the tower) and
    ``lpips.epilogue`` (the taps' epilogues)."""
    def fast(x: torch.Tensor, out: torch.Tensor, r: torch.Tensor
             ) -> torch.Tensor:
        with span("lpips.tower"):
            feats = model.features(x, compute_dtype)
        off = 0
        with span("lpips.epilogue"):
            for i, (fl, w) in enumerate(zip(feats, model.lins)):
                _n, h, wd, c = fl.shape
                width = h * wd * c
                _, rn = tap_epilogue(
                    fl, _tap_scale(w, weight, h * wd), embed_dtype=dtype,
                    out_dtype=cdtype,
                    quant_bound=None if bounds is None else bounds[i],
                    out=out[:, off:off + width])
                r = r + rn
                off += width
        return r

    fast.widths = lambda sample_shape: [
        n_pos * c for n_pos, c in lpips_part_shapes(model.net, sample_shape)]
    return fast


def lpips_embed_parts_fn(model: LPIPS, weight: float = 0.2,
                         dtype: torch.dtype = torch.float32,
                         compute_dtype: torch.dtype | None = None):
    """Closure form of :func:`lpips_embed_parts` for
    ``ops/distance.make_embed_parts_fn``, carrying ``part_bound_fn``,
    ``part_int_dot_bound_fn``, ``make_fast_parts_norms`` and ``tower``."""
    def embed(x: torch.Tensor) -> list[torch.Tensor]:
        return lpips_embed_parts(model, x, weight=weight, dtype=dtype,
                                 compute_dtype=compute_dtype)
    embed.part_bound_fn = lambda sample_shape: lpips_part_bounds(
        model, sample_shape, weight)
    embed.part_int_dot_bound_fn = lambda sample_shape: \
        lpips_part_int_dot_bounds(model, sample_shape)
    embed.make_fast_parts_norms = lambda cdtype, bounds=None: \
        lpips_fast_parts_norms(model, weight, dtype, compute_dtype, cdtype,
                               bounds)
    embed.tower = tower_key(model, compute_dtype)
    return embed
