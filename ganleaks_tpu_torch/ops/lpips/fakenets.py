"""DistModel's non-network distance branches, a copy of
``ganleaks_tpu.ops.lpips.fakenets`` (reference:
``lpips_pytorch/models/networks_basic.py:233-274`` + ``util/util.py``):

* ``l2_distance`` — RGB: per-image mean square error; Lab: mean square
  error on the Lab-converted images normalized by range 100^2
  (``util.l2`` + ``tensor2tensorlab``);
* ``dssim_distance`` — (1 - SSIM) / 2 in RGB (data range 255) or Lab
  (range 100) (``util.dssim``).

The reference leans on skimage for rgb2lab/SSIM; this environment has no
skimage, so both are implemented directly: the standard sRGB -> XYZ(D65)
-> CIELAB transform and SSIM with skimage's defaults (7x7 uniform window,
K1=0.01, K2=0.03). Host-side numpy utilities; inputs NHWC in [-1, 1].
"""

from __future__ import annotations

import numpy as np


# --- colorspace ------------------------------------------------------------

_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_D65 = np.array([0.95047, 1.0, 1.08883])


def rgb2lab(rgb01: np.ndarray) -> np.ndarray:
    """sRGB in [0,1] (HWC or NHWC) -> CIELAB (same layout, D65)."""
    rgb = np.clip(np.asarray(rgb01, np.float64), 0.0, 1.0)
    linear = np.where(rgb > 0.04045,
                      ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    xyz = linear @ _RGB2XYZ.T
    xyz = xyz / _D65

    eps = 216.0 / 24389.0
    kappa = 24389.0 / 27.0
    f = np.where(xyz > eps, np.cbrt(xyz), (kappa * xyz + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    lab = np.stack([116.0 * fy - 16.0,
                    500.0 * (fx - fy),
                    200.0 * (fy - fz)], axis=-1)
    return lab


def _to_im255(x: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8-truncated [0,255] floats (``util.tensor2im``:
    ``((x+1)*127.5).astype(np.uint8)`` — the reference quantizes to bytes
    BEFORE SSIM/Lab, so continuous inputs lose their sub-byte detail
    here; keeping floats diverged in the 3rd-4th decimal)."""
    x = (np.asarray(x, np.float64) + 1.0) * 127.5
    return x.astype(np.uint8).astype(np.float64)


def _to_lab(x: np.ndarray) -> np.ndarray:
    """``util.tensor2tensorlab``: rgb2lab of the tensor2im uint8 image
    (skimage scales uint8 by 255)."""
    return rgb2lab(_to_im255(x) / 255.0)


# --- SSIM -------------------------------------------------------------------

def _uniform_filter(img: np.ndarray, win: int) -> np.ndarray:
    """Mean filter with a win x win window, 'valid' region (matches
    skimage's crop of the pad margin)."""
    c = np.cumsum(np.cumsum(img, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)) + ((0, 0),) * (img.ndim - 2))
    s = (c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win])
    return s / (win * win)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float,
         win: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM over channels with skimage's default settings (uniform
    window, sample covariance normalization N/(N-1))."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = win * win
    cov_norm = n / (n - 1.0)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    ua = _uniform_filter(a, win)
    ub = _uniform_filter(b, win)
    uaa = _uniform_filter(a * a, win)
    ubb = _uniform_filter(b * b, win)
    uab = _uniform_filter(a * b, win)
    va = cov_norm * (uaa - ua * ua)
    vb = cov_norm * (ubb - ub * ub)
    vab = cov_norm * (uab - ua * ub)

    s = ((2 * ua * ub + c1) * (2 * vab + c2)) \
        / ((ua ** 2 + ub ** 2 + c1) * (va + vb + c2))
    return float(np.mean(s))


# --- DistModel branches ------------------------------------------------------

def l2_distance(in0: np.ndarray, in1: np.ndarray,
                colorspace: str = "Lab") -> np.ndarray:
    """``networks_basic.L2.forward`` per-pair distance for NHWC batches."""
    if colorspace == "RGB":
        return np.mean((np.asarray(in0) - np.asarray(in1)) ** 2,
                       axis=(1, 2, 3))
    a = _to_lab(in0)
    b = _to_lab(in1)
    # util.l2 (util.py:42-43): .5 * mean((a/range - b/range)^2), range=100
    return 0.5 * np.mean((a - b) ** 2, axis=(1, 2, 3)) / (100.0 ** 2)


def dssim_distance(in0: np.ndarray, in1: np.ndarray,
                   colorspace: str = "Lab") -> np.ndarray:
    """``networks_basic.DSSIM.forward``: (1 - SSIM) / 2 per pair."""
    out = []
    for a, b in zip(np.asarray(in0), np.asarray(in1)):
        if colorspace == "RGB":
            s = ssim(_to_im255(a), _to_im255(b), data_range=255.0)
        else:
            s = ssim(_to_lab(a), _to_lab(b), data_range=100.0)
        out.append((1.0 - s) / 2.0)
    return np.asarray(out)
