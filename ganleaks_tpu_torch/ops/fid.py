"""Frechet Inception Distance (port of ``ganleaks_tpu.ops.fid``; reference
``z_fid.py``).

* activations: the InceptionV3 pool_3 tower (``ops/inception``) in
  fixed-size batches; ``drop_remainder=True`` drops the final partial
  batch as the reference's in-memory path does (``z_fid.py:88``);
* statistics: mean and covariance in numpy (``np.cov``, rowvar=False,
  float64);
* ``||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))`` with three matrix
  square roots: Newton-Schulz (matrix products on the device), the
  symmetrised ``eigh`` (device), and scipy on the host (``z_fid.py:
  109-160`` with its eps-jitter retry and imaginary-part guard).

The device square roots always run in float64, whatever the statistics'
dtype (the JAX package casts to float32). Full-width statistics need it:
their eigenvalues span ~5 decades, the similarity below squares that, and
float32 then loses the small eigenvalues (Newton-Schulz diverges, ``eigh``
misses scipy's value by far more than ``tests/test_fid_split.py``'s bar),
with no sign of it in the result.

Where a device square root gives a non-finite trace (an indefinite
covariance), the JAX package's rule falls back to the scipy path with a
warning; each such fall-back adds one to
``frechet_distance.scipy_fallbacks``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.ops.inception import InceptionV3Pool3, preprocess

SQRTM_METHODS = ("newton-schulz", "eigh", "scipy")


def init_inception_params(seed: int = 0) -> InceptionV3Pool3:
    """Surrogate (seeded) InceptionV3 on the CPU: every conv kernel He
    (fan_in, truncated normal: std ``sqrt(2 / fan_in) / .8796`` cut at two
    std) from a ``torch.Generator`` seeded with ``seed``, BatchNorm at
    scale 1, bias 0, mean 0, var 1 — the JAX surrogate's distribution, not
    its bits (the RNG streams differ). Load converted torchvision weights
    (``weights.inception_from_jax_params``) for standard-FID numbers."""
    g = torch.Generator().manual_seed(seed)
    model = InceptionV3Pool3()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                out_ch, in_ch, kh, kw = mod.weight.shape
                # flax variance_scaling's truncated-normal correction
                std = math.sqrt(2.0 / (in_ch * kh * kw)) / .87962566103423978
                torch.nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                            2 * std, generator=g)
    return model.eval()


def get_activations(model: torch.nn.Module, images: np.ndarray,
                    batch_size: int = 50, drop_remainder: bool = True,
                    device: torch.device | str | None = None,
                    mesh=None) -> np.ndarray:
    """pool_3 activations (float32 (N, 2048) numpy) of NHWC [0, 255] images
    (float or uint8), uploaded one batch at a time. ``drop_remainder`` drops
    the final partial batch (``z_fid.py:88``: 5 images at batch 2 give 4
    rows); otherwise the last batch is padded and sliced back. The model
    moves to ``device``.

    ``mesh`` (``parallel/mesh.Mesh``, every rank calling with the same
    images and weights): each batch is split over the ranks, a contiguous
    share each (the batch padded to a multiple of the ranks), each rank
    runs the tower on its share on its device, and the activations are
    all-gathered in image order; every rank returns them all."""
    device = resolve_device(device)
    if mesh is not None:
        device = mesh.device
    model = model.to(device).eval()
    n = len(images)
    batch_size = min(batch_size, n)
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    outs = []
    with torch.inference_mode():
        for i in range(n_batches):
            batch = np.asarray(images[i * batch_size:(i + 1) * batch_size])
            rows = len(batch)
            if rows < batch_size:  # pad the final partial batch to one shape
                batch = np.concatenate([batch, np.zeros(
                    (batch_size - rows,) + batch.shape[1:], batch.dtype)])
            if mesh is None:
                x = torch.from_numpy(batch).to(device)
                outs.append(model(preprocess(x))[:rows].float().cpu()
                            .numpy())
                continue
            from ganleaks_tpu_torch.parallel.mesh import (all_gather_rows,
                                                          shard_rows)
            start, stop, per = shard_rows(len(batch), mesh)
            share = np.zeros((per,) + batch.shape[1:], batch.dtype)
            share[:stop - start] = batch[start:stop]
            act = model(preprocess(torch.from_numpy(share).to(device)))
            outs.append(all_gather_rows(act.float(), mesh)[:rows].cpu()
                        .numpy())
    return np.concatenate(outs)


def activation_statistics(acts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """mu, sigma (np.cov rowvar=False => ddof=1), ``z_fid.py:180-183``."""
    return np.mean(acts, axis=0), np.cov(acts, rowvar=False)


# ---------------------------------------------------------------------------
# matrix square roots
# ---------------------------------------------------------------------------

def sqrtm_newton_schulz(a: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Newton-Schulz iteration for the principal square root of a
    PSD-ish matrix: matrix products only, in ``a``'s dtype (TF32 off,
    ``device.set_f32_numerics``)."""
    dim = a.shape[0]
    norm = torch.sqrt(torch.sum(torch.square(a)))
    y = a / norm
    z = torch.eye(dim, dtype=a.dtype, device=a.device)
    eye3 = 3.0 * torch.eye(dim, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        t = 0.5 * (eye3 - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def sqrtm_eigh(a: torch.Tensor) -> torch.Tensor:
    """Square root via the eigendecomposition of the symmetrised matrix,
    eigenvalues clamped at 0."""
    sym = (a + a.T) / 2.0
    w, v = torch.linalg.eigh(sym)
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w)) @ v.T


def _tr_sqrt_scipy(sigma1: np.ndarray, sigma2: np.ndarray,
                   eps: float) -> float:
    from scipy import linalg

    # z_fid.py passes disp=False (deprecated in SciPy 1.16); without it
    # sqrtm returns the same matrix alone
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():  # z_fid.py:145-149
        warnings.warn("fid produces singular product; adding %s to "
                      "diagonal of cov estimates" % eps)
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):        # z_fid.py:152-156
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError("Imaginary component {}".format(m))
        covmean = covmean.real
    return float(np.trace(covmean))


def _tr_sqrt_product(sigma1: np.ndarray, sigma2: np.ndarray, method: str,
                     eps: float, device: torch.device | str | None) -> float:
    """Tr(sqrt(S1 S2)). The device paths use the similarity
    Tr(sqrt(S1 S2)) = Tr(sqrt(R S2 R)), R = sqrt(S1 + eps I), so the square
    root sees a (near-)PSD argument."""
    if method == "scipy":
        return _tr_sqrt_scipy(sigma1, sigma2, eps)
    if method not in SQRTM_METHODS:
        raise ValueError(f"unknown sqrtm method {method!r}")
    device = resolve_device(device)
    s1 = torch.as_tensor(sigma1, dtype=torch.float64, device=device)
    s2 = torch.as_tensor(sigma2, dtype=torch.float64, device=device)
    offset = eps * torch.eye(s1.shape[0], dtype=torch.float64, device=device)
    root1 = sqrtm_eigh(s1 + offset)
    inner = root1 @ (s2 + offset) @ root1
    root = (sqrtm_newton_schulz(inner) if method == "newton-schulz"
            else sqrtm_eigh(inner))
    tr = float(torch.trace(root))
    if not math.isfinite(tr):
        # Newton-Schulz diverges on a product with a negative eigenvalue
        # (an indefinite covariance); the reference's only sqrtm is
        # scipy with the eps retry (z_fid.py:141-149), so every input it
        # survives stays finite here too
        warnings.warn(f"{method} sqrtm produced a non-finite trace; "
                      "falling back to the scipy path")
        frechet_distance.scipy_fallbacks += 1
        return _tr_sqrt_scipy(sigma1, sigma2, eps)
    return tr


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6,
                     method: str = "newton-schulz",
                     device: torch.device | str | None = None) -> float:
    """``calculate_frechet_distance`` (``z_fid.py:109-160``); the
    'newton-schulz' and 'eigh' square roots run on ``device``."""
    mu1 = np.atleast_1d(np.asarray(mu1))
    mu2 = np.atleast_1d(np.asarray(mu2))
    sigma1 = np.atleast_2d(np.asarray(sigma1))
    sigma2 = np.atleast_2d(np.asarray(sigma2))
    if mu1.shape != mu2.shape:
        raise ValueError("Training and test mean vectors have different "
                         "lengths")
    if sigma1.shape != sigma2.shape:
        raise ValueError("Training and test covariances have different "
                         "dimensions")
    diff = mu1 - mu2
    tr_covmean = _tr_sqrt_product(sigma1, sigma2, method, eps, device)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


frechet_distance.scipy_fallbacks = 0


def fid_from_image_sets(model: torch.nn.Module, images1: np.ndarray,
                        images2: np.ndarray, batch_size: int = 50,
                        method: str = "newton-schulz",
                        device: torch.device | str | None = None,
                        mesh=None) -> float:
    """FID between two [0, 255] NHWC image sets
    (``calculate_fid_given_paths``, ``z_fid.py:303-317``); ``mesh``
    splits the featurisation over the ranks (:func:`get_activations`)."""
    device = resolve_device(device)
    if mesh is not None:
        device = mesh.device
    m1, s1 = activation_statistics(
        get_activations(model, images1, batch_size, device=device,
                        mesh=mesh))
    m2, s2 = activation_statistics(
        get_activations(model, images2, batch_size, device=device,
                        mesh=mesh))
    return frechet_distance(m1, s1, m2, s2, method=method, device=device)


def _load_path_images(path: str) -> np.ndarray:
    """[0, 255] float32 NHWC images of one FID input: an image npz (floor-
    quantised to the PNG bytes, ``io/npz``) or a directory of jpg/png
    files in the JAX package's order (the ``*.jpg`` glob, then ``*.png``).
    The PNGs decode in one batch on the port's codec threads
    (``io/native``: 8-bit RGB PNGs; those of another size than the first
    one by one), the JPEGs through a lazily imported Pillow."""
    import pathlib

    from ganleaks_tpu_torch.io.native import decode_exact, decode_png
    from ganleaks_tpu_torch.io.npz import (load_npz_images,
                                           resolve_input_format)

    if resolve_input_format(path) == "npz":
        return load_npz_images(path, resolution=None,
                               dtype=np.uint8).astype(np.float32)
    jpgs = [str(fn) for fn in pathlib.Path(path).glob("*.jpg")]
    pngs = [str(fn) for fn in pathlib.Path(path).glob("*.png")]
    imgs: list = []
    if jpgs:
        import PIL.Image
        for fn in jpgs:
            with PIL.Image.open(fn) as im:
                imgs.append(np.asarray(im))
    if pngs:
        batch, other = decode_exact(pngs, decode_png(pngs[0]).shape[:2])
        rows = list(batch)
        for i in other:
            rows[i] = decode_png(pngs[i])
        imgs += rows
    return np.array(imgs, dtype=np.float32)


def fid_from_paths(model: torch.nn.Module, path1: str, path2: str,
                   batch_size: int = 50, method: str = "newton-schulz",
                   device: torch.device | str | None = None,
                   mesh=None) -> float:
    """Path flavour: each argument is an image directory (jpg + png), a
    precomputed ``.npz`` with ``mu``/``sigma`` (``z_fid.py:286-300``), or
    an image npz (``npz_images/``, ``generated.npz``); ``mesh`` splits the
    featurisation over the ranks (:func:`get_activations`)."""
    device = resolve_device(device)
    if mesh is not None:
        device = mesh.device
    stats = []
    for p in (path1, path2):
        if p.endswith(".npz"):
            with np.load(p) as f:
                if "mu" in f.files:
                    stats.append((f["mu"][:], f["sigma"][:]))
                    continue
        stats.append(activation_statistics(get_activations(
            model, _load_path_images(p), batch_size, device=device,
            mesh=mesh)))
    (m1, s1), (m2, s2) = stats
    return frechet_distance(m1, s1, m2, s2, method=method, device=device)
