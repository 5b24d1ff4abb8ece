"""Training images: the host reader and the device dataset (port of
``ganleaks_tpu.io.data``).

The reference streams PNGs through DataLoader workers
(``dcgan/utils.py:6-26``). At GAN-Leaks scale the whole training set fits
on the card, so it is decoded once on the host (PNGs in one batch on the
port's codec threads, ``io/native``) and kept there as one NCHW tensor; a
batch is a gather by a shuffled index vector drawn from
``np.random.default_rng(seed)``, the JAX package's permutations, so the
batch order is the same. ``random_hflip`` mirrors a batch by a given or
drawn mask (PGGAN's ``RandomHorizontalFlip``).
"""

from __future__ import annotations

import numpy as np
import torch

from ganleaks_tpu_torch.io.images import _decode_rgb, _pil_image
from ganleaks_tpu_torch.io.images import get_filepaths_from_dir
from ganleaks_tpu_torch.io.native import LUT_CROP, decode_exact


def _bilinear(img: np.ndarray, resolution: int, path: str) -> np.ndarray:
    """torchvision's default ``Resize`` (Pillow's bilinear) of one image,
    through a lazily imported Pillow."""
    pil = _pil_image(path, f"resizing a {img.shape[1]}x{img.shape[0]} "
                           f"image to {resolution}x{resolution}")
    return np.asarray(pil.fromarray(img).resize((resolution, resolution),
                                                pil.BILINEAR))


def load_train_images(data_dir: str, resolution: int = 64,
                      limit: int | None = None,
                      num_threads: int | None = None) -> np.ndarray:
    """Image dir (PNG and JPEG, sorted) -> NHWC float32 in [-1, 1]: the
    reference's ``Resize -> ToTensor -> Normalize(0.5, 0.5)``
    (``train_torch.py:60-64``), bit for bit
    ``ganleaks_tpu.io.data.load_train_images``. PNGs of the resolution
    decode in one batch on the codec's threads; PNGs of another size are
    then decoded one by one and JPEGs read by Pillow, and both resized
    bilinearly. Pixels map through the float32 ``x / 255 * 2 - 1``."""
    paths = sorted(get_filepaths_from_dir(data_dir, "png")
                   + get_filepaths_from_dir(data_dir, "jpg"))
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no images under {data_dir}")
    png = np.array([p.endswith(".png") for p in paths])
    rows = np.nonzero(png)[0]
    out = np.empty((len(paths), resolution, resolution, 3), np.uint8)
    out[rows], other = decode_exact([paths[i] for i in rows], resolution,
                                    num_threads)
    for i in [*rows[other], *np.nonzero(~png)[0]]:
        img = _decode_rgb(paths[i])
        out[i] = (img if img.shape[:2] == (resolution, resolution)
                  else _bilinear(img, resolution, paths[i]))
    return LUT_CROP[out]


def epoch_batch_indices(rng: np.random.Generator, n: int, batch_size: int,
                        drop_last: bool = False) -> list[np.ndarray]:
    """Shuffled batch index vectors for one epoch (DataLoader shuffle=True)."""
    perm = rng.permutation(n)
    batches = [perm[i:i + batch_size] for i in range(0, n, batch_size)]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()
    return batches


class DeviceDataset:
    """The whole training set as one NCHW tensor on ``device`` plus an
    index-batch iterator."""

    def __init__(self, images: np.ndarray, seed: int = 0,
                 device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(
            np.asarray(images, np.float32).transpose(0, 3, 1, 2))
        ).to(self.device)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return int(self.images.shape[0])

    def epoch(self, batch_size: int, drop_last: bool = False):
        for idx in epoch_batch_indices(self._rng, len(self), batch_size,
                                       drop_last):
            yield self.images[torch.from_numpy(idx).to(self.device)]


def random_hflip(batch: torch.Tensor, flip: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """``RandomHorizontalFlip(p=0.5)`` (``gan_models/pggan/train.py:83``)
    on an NCHW batch: image i is mirrored along W where ``flip[i]`` is
    true; ``flip`` (N,) bool defaults to one Bernoulli(0.5) draw per image
    from ``generator``."""
    if flip is None:
        flip = torch.rand(batch.shape[0], generator=generator,
                          device=batch.device) < 0.5
    return torch.where(flip.to(batch.device).view(-1, 1, 1, 1),
                       batch.flip(-1), batch)
