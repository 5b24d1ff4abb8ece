"""Host-side image IO (copy of the two readers of ``ganleaks_tpu.io.images``:
the fbb attack's resize variant and the VAE-GAN's center crop). PNGs decode
and encode through the port's own codec (``io/native``); Pillow is imported
only to resize an image whose size differs from the resolution (the resize
variant) or to decode another format, and its absence then raises naming
the file.

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


def _decode_rgb(filepath: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of one file: PNGs through the port's codec
    (``io/native``), other formats through Pillow, imported here."""
    if filepath.lower().endswith(".png"):
        from ganleaks_tpu_torch.io.native import decode_png
        return decode_png(filepath)
    pil = _pil_image(filepath, "decoding").open(filepath)
    return np.asarray(pil if pil.mode == "RGB" else pil.convert("RGB"))


def _pil_image(filepath: str, what: str):
    """``PIL.Image``, or an ImportError naming the file that needs it."""
    try:
        import PIL.Image
    except ImportError:
        raise ImportError(f"{filepath}: {what} needs Pillow, which is not "
                          f"installed") from None
    return PIL.Image


def resize_u8(img: np.ndarray, resolution: int,
              filepath: str = "") -> np.ndarray:
    """The resize variant's resampling (``attack_models/utils.py:79``):
    Pillow's default filter, as the bare ``img.resize((r, r))``."""
    pil = _pil_image(filepath, f"resizing a {img.shape[1]}x{img.shape[0]} "
                               f"image to {resolution}x{resolution}")
    return np.asarray(pil.fromarray(img).resize((resolution, resolution)))


def center_crop_u8(img: np.ndarray, resolution: int, cx: int = 89,
                   cy: int = 121) -> np.ndarray:
    """The VAE-GAN crop (``gan_models/vaegan/utils.py:44-71``): crop
    [cy-64:cy+64, cx-64:cx+64], then 2x box halvings in float32 from 128
    down to ``resolution``, ``rint``/clip to uint8. Like the JAX package it
    halves log2(128 / resolution) times (the reference's loop is wrong
    below 64, DIVERGENCES.md)."""
    img = img[cy - 64: cy + 64, cx - 64: cx + 64].astype(np.float32)
    resize_factor = 128 // resolution
    while resize_factor > 1:
        img = (img[0::2, 0::2, :] + img[0::2, 1::2, :]
               + img[1::2, 0::2, :] + img[1::2, 1::2, :]) * 0.25
        resize_factor //= 2
    return np.rint(img).clip(0, 255).astype(np.uint8)


def read_image(filepath: str, resolution: int = 64) -> np.ndarray:
    """Resize-variant reader (``attack_models/utils.py:60-84``): Pillow's
    default-filter resize when the stored size differs, then the exact
    ``2*(img/255)-1`` scaling in float64."""
    img = _decode_rgb(filepath)
    if img.shape != (resolution, resolution, 3):
        img = resize_u8(img, resolution, filepath)
    return 2.0 * (img / 255.0) - 1.0


def read_image_center_crop(filepath: str, resolution: int = 64,
                           cx: int = 89, cy: int = 121) -> np.ndarray:
    """Center-crop-variant reader (``gan_models/vaegan/utils.py:44-71``):
    :func:`center_crop_u8` where the stored size differs, then the float32
    ``x / 255 * 2 - 1``. Images already at the resolution pass through
    uncropped."""
    img = _decode_rgb(filepath)
    if img.shape != (resolution, resolution, 3):
        img = center_crop_u8(img, resolution, cx, cy)
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
    (default) or the original uint8 bytes with ``dtype=np.uint8``. PNGs
    read by either reader of this module decode in one threaded batch
    (``io/native.load_image_paths_native``); any other reader runs as
    ``reader(path, resolution)`` per file."""
    paths = get_filepaths_from_dir(data_dir, ext)
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no *.{ext} files under {data_dir}")
    if ext == "png" and reader in (read_image, read_image_center_crop):
        from ganleaks_tpu_torch.io.native import (MODE_CENTER_CROP,
                                                  MODE_EXACT,
                                                  load_image_paths_native)
        mode = MODE_EXACT if reader is read_image else MODE_CENTER_CROP
        return load_image_paths_native(paths, resolution, mode=mode,
                                       num_threads=num_threads, dtype=dtype)
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        imgs = list(pool.map(lambda p: reader(p, resolution), paths))
    out = np.asarray(imgs, dtype=np.float32)
    if np.dtype(dtype) == np.uint8:
        return unit_to_uint8_exact(out)
    return out


def nearest_resize(images, size: int):
    """PIL-NEAREST-exact resize over the trailing (H, W, C) axes of a numpy
    array or tensor, as a gather: output pixel ``i`` samples input row /
    column ``floor((i + 0.5) * S / s)``, Pillow's center-aligned nearest
    mapping — the PGGAN loader's ``Resize(size, interpolation=NEAREST)``
    (``gan_models/pggan/train.py:82-88``)."""
    h, w = images.shape[-3], images.shape[-2]
    if h == size and w == size:
        return images
    ri = np.floor((np.arange(size) + 0.5) * h / size).astype(np.int64)
    ci = np.floor((np.arange(size) + 0.5) * w / size).astype(np.int64)
    if not isinstance(images, np.ndarray):
        import torch
        ri, ci = (torch.from_numpy(a).to(images.device) for a in (ri, ci))
    return images[..., ri[:, None], ci[None, :], :]


def to_uint8(img: np.ndarray, drange=(-1.0, 1.0),
             rounding: str = "floor") -> np.ndarray:
    """Map images from ``drange`` to uint8 [0, 255]. ``rounding='floor'``
    truncates like torchvision ``ToPILImage`` (``train_torch.py:155``) and
    ``np.uint8(img*255)`` (``fbb.py:106``); ``'rint'`` matches the VAE-GAN
    grid saver (``vaegan/utils.py:110``)."""
    lo, hi = drange
    img = np.clip((img - lo) / (hi - lo), 0.0, 1.0) * 255.0
    if rounding == "rint":
        img = np.rint(img)
    return img.astype(np.uint8)


def save_png(img: np.ndarray, path: str, drange=(0.0, 1.0),
             rounding: str = "floor") -> None:
    """Save one HWC RGB image through the port's encoder. With the defaults
    this matches torchvision's ``ToPILImage`` on a [0, 1] tensor
    (``train_torch.py:155,171-174``)."""
    from ganleaks_tpu_torch.io.native import encode_png
    encode_png(to_uint8(np.asarray(img), drange, rounding), path)
