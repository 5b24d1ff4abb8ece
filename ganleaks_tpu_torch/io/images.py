"""Host-side image IO (copy of the two readers of ``ganleaks_tpu.io.images``:
the fbb attack's resize variant and the VAE-GAN's center crop). Pillow is
imported inside the functions that decode PNGs, so the npz ingest path runs
without it.

Images are NHWC: float32 in [-1, 1], or the original uint8 bytes.
"""

from __future__ import annotations

import fnmatch
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def get_filepaths_from_dir(data_dir: str, ext: str = "png") -> list[str]:
    """Recursive sorted glob, identical semantics to
    ``attack_models/utils.py:43-57`` (os.walk + fnmatch + sorted)."""
    pattern = "*." + ext
    path_list = []
    for d, _s, flist in os.walk(data_dir):
        for filename in flist:
            if fnmatch.fnmatch(filename, pattern):
                path_list.append(os.path.join(d, filename))
    return sorted(path_list)


def read_image(filepath: str, resolution: int = 64) -> np.ndarray:
    """Resize-variant reader (``attack_models/utils.py:60-84``): PIL's
    default-filter resize when the stored size differs, then the exact
    ``2*(img/255)-1`` scaling in float64."""
    import PIL.Image

    pil = PIL.Image.open(filepath)
    if pil.mode != "RGB":
        pil = pil.convert("RGB")
    img = np.asarray(pil)
    if img.shape != (resolution, resolution, 3):
        img = np.asarray(PIL.Image.fromarray(img).resize(
            (resolution, resolution)))
    return 2.0 * (img / 255.0) - 1.0


def read_image_center_crop(filepath: str, resolution: int = 64,
                           cx: int = 89, cy: int = 121) -> np.ndarray:
    """Center-crop-variant reader (``gan_models/vaegan/utils.py:44-71``):
    crop [cy-64:cy+64, cx-64:cx+64], then 2x box halvings in float32 from
    128 down to ``resolution``, ``rint``/clip through uint8, and the
    float32 ``x / 255 * 2 - 1``. Images already at the resolution pass
    through uncropped. Like the JAX package it halves log2(128 /
    resolution) times (the reference's loop is wrong below 64,
    DIVERGENCES.md)."""
    import PIL.Image

    pil = PIL.Image.open(filepath)
    if pil.mode != "RGB":
        pil = pil.convert("RGB")
    img = np.asarray(pil)
    if img.shape != (resolution, resolution, 3):
        img = img[cy - 64: cy + 64, cx - 64: cx + 64]
        resize_factor = 128 // resolution
        img = img.astype(np.float32)
        while resize_factor > 1:
            img = (img[0::2, 0::2, :] + img[0::2, 1::2, :]
                   + img[1::2, 0::2, :] + img[1::2, 1::2, :]) * 0.25
            resize_factor //= 2
        img = np.rint(img).clip(0, 255).astype(np.uint8)
    img = img.astype(np.float32) / 255.0
    return img * 2.0 - 1.0


def unit_to_uint8_exact(arr: np.ndarray) -> np.ndarray:
    """Invert the readers' ``2*(x/255)-1`` scaling back to the original
    bytes (``rint((v+1)*127.5)`` recovers every byte value exactly),
    converted in row chunks to bound the float64 transient."""
    if arr.dtype == np.uint8:
        return arr
    out = np.empty(arr.shape, np.uint8)
    step = max(1, (64 << 20) // max(1, int(np.prod(arr.shape[1:])) * 8))
    for i in range(0, arr.shape[0], step):
        blk = arr[i:i + step].astype(np.float64)
        out[i:i + step] = np.rint((blk + 1.0) * 127.5).astype(np.uint8)
    return out


def load_image_dir(data_dir: str, resolution: int = 64, ext: str = "png",
                   limit: int | None = None, num_threads: int = 8,
                   dtype=np.float32, reader=read_image) -> np.ndarray:
    """Load a directory of images into one NHWC array: float32 in [-1, 1]
    (default) or the original uint8 bytes with ``dtype=np.uint8``, each
    file decoded by ``reader(path, resolution)``."""
    paths = get_filepaths_from_dir(data_dir, ext)
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no *.{ext} files under {data_dir}")
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        imgs = list(pool.map(lambda p: reader(p, resolution), paths))
    out = np.asarray(imgs, dtype=np.float32)
    if np.dtype(dtype) == np.uint8:
        return unit_to_uint8_exact(out)
    return out


def to_uint8(img: np.ndarray, drange=(-1.0, 1.0)) -> np.ndarray:
    """Map images from ``drange`` to uint8 [0, 255], truncating like
    torchvision ``ToPILImage`` (``train_torch.py:155``) and
    ``np.uint8(img*255)`` (``fbb.py:106``)."""
    lo, hi = drange
    img = np.clip((img - lo) / (hi - lo), 0.0, 1.0) * 255.0
    return img.astype(np.uint8)
