"""NPZ image-set ingest (copy of ``ganleaks_tpu.io.npz``): attack directly
on the reference's array dumps — ``npz_images/<ts>/*_synthetic_data.npz``
with key ``fake`` (NCHW, [0, 1]), the VAE-GAN sampler's ``generated.npz``
with key ``img_r01`` (NHWC, [0, 1]), or a generic ``images`` array.

Float arrays are floor-quantised to uint8 exactly as torchvision
``ToPILImage`` truncates when the reference writes its PNGs, so the loaded
set is bit-identical to reading the corresponding PNG dir. Pillow is needed
only to resize arrays whose size differs from the attack resolution.
"""

from __future__ import annotations

import os

import numpy as np

from ganleaks_tpu_torch.io.images import get_filepaths_from_dir, to_uint8

# keys tried in order; each maps to its documented layout
_KNOWN_KEYS = (
    ("fake", "NCHW"),       # dcgan/pggan synthetic dumps, [0, 1]
    ("img_r01", "NHWC"),    # vaegan generated.npz, [0, 1]
    ("images", "NHWC"),     # generic escape hatch
)


def find_npz_files(path: str) -> list[str]:
    """``path`` itself if it is a file, else the recursive sorted
    ``*.npz`` glob under it (multiple files concatenate in sorted order)."""
    if os.path.isfile(path):
        return [path]
    return get_filepaths_from_dir(path, "npz")


def _member_ndims(path: str) -> dict[str, int]:
    """Member name -> ndim, read from the .npy headers inside the zip
    without inflating any array data."""
    import zipfile

    from numpy.lib import format as npf

    ndims: dict[str, int] = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if not name.endswith(".npy"):
                continue
            with z.open(name) as f:
                version = npf.read_magic(f)
                if version == (1, 0):
                    shape, _, _ = npf.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, _, _ = npf.read_array_header_2_0(f)
                else:
                    raise ValueError(f"npy header version {version}")
                ndims[name[:-4]] = len(shape)
    return ndims


def _pick_array(f, path: str) -> tuple[np.ndarray, str]:
    for key, layout in _KNOWN_KEYS:
        if key in f.files:
            return f[key], layout
    try:
        ndims = _member_ndims(path)
        four_d = [k for k in f.files if ndims.get(k) == 4]
    except (OSError, ValueError):  # unreadable headers: full-inflate scan
        four_d = [k for k in f.files if f[k].ndim == 4]
    if len(four_d) == 1:
        return f[four_d[0]], "auto"
    raise ValueError(
        f"{path}: no image array found (keys {f.files}); expected one of "
        f"{[k for k, _ in _KNOWN_KEYS]} or a single 4-D array")


def _to_nhwc(arr: np.ndarray, layout: str, path: str) -> np.ndarray:
    if arr.ndim != 4:
        raise ValueError(f"{path}: image array must be 4-D, got {arr.shape}")
    if layout == "auto":
        if arr.shape[3] in (1, 3):
            layout = "NHWC"
        elif arr.shape[1] in (1, 3):
            layout = "NCHW"
        else:
            raise ValueError(f"{path}: cannot infer layout from {arr.shape}")
    if layout == "NCHW":
        arr = np.transpose(arr, (0, 2, 3, 1))
    if arr.shape[3] not in (1, 3):
        raise ValueError(f"{path}: expected 1 or 3 channels, got {arr.shape}")
    return arr


def _resize_uint8(u8: np.ndarray, resolution: int) -> np.ndarray:
    """Per-image PIL resize with the library default filter — the path a
    stored PNG of this content would take through ``read_image``."""
    import PIL.Image

    out = np.empty((u8.shape[0], resolution, resolution, u8.shape[3]),
                   np.uint8)
    for i in range(u8.shape[0]):
        img = u8[i, :, :, 0] if u8.shape[3] == 1 else u8[i]
        pil = PIL.Image.fromarray(img).resize((resolution, resolution))
        out[i] = np.asarray(pil).reshape(resolution, resolution, -1)
    return out


def load_npz_images(path: str, resolution: int | None = 64,
                    limit: int | None = None, dtype=np.float32
                    ) -> np.ndarray:
    """Load NPZ image dumps as one NHWC set: float32 in [-1, 1] (default)
    or the raw uint8 bytes (``dtype=np.uint8``). Grayscale broadcasts to 3
    channels."""
    files = find_npz_files(path)
    if not files:
        raise FileNotFoundError(f"no *.npz files under {path}")
    parts: list[np.ndarray] = []
    n = 0
    for fp in files:
        with np.load(fp) as f:
            arr, layout = _pick_array(f, fp)
            arr = _to_nhwc(np.asarray(arr), layout, fp)
        if arr.dtype == np.uint8:
            u8 = arr
        else:
            arr = arr.astype(np.float32, copy=False)
            if arr.size:
                lo, hi = float(arr.min()), float(arr.max())
                if lo < -0.05 or hi > 1.0 + 1e-6:
                    raise ValueError(
                        f"{fp}: float values span [{lo:g}, {hi:g}] — "
                        f"expected the reference's [0, 1] convention; a "
                        f"[-1, 1] or 0-255-scaled dump must be "
                        f"renormalized before ingest")
            u8 = to_uint8(arr, drange=(0.0, 1.0))
        if u8.shape[3] == 1:
            u8 = np.broadcast_to(u8, u8.shape[:3] + (3,)).copy()
        if resolution is not None and (u8.shape[1] != resolution
                                       or u8.shape[2] != resolution):
            u8 = _resize_uint8(u8, resolution)
        if np.dtype(dtype) == np.uint8:
            parts.append(u8)
        else:
            parts.append((2.0 * (u8.astype(np.float64) / 255.0) - 1.0)
                         .astype(np.float32))
        n += len(u8)
        if limit is not None and n >= limit:
            break
    out = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    return out[:limit] if limit is not None else out


def _scan_for_resolution(path: str) -> tuple[list[str], list[str]]:
    """One walk: lowercased image and npz basenames under ``path``, each
    capped at 2 entries, with an early exit once both caps are hit."""
    imgs: list[str] = []
    npzs: list[str] = []
    for _d, _s, flist in os.walk(path):
        for fn in flist:
            low = fn.lower()
            if low.endswith((".png", ".jpg", ".jpeg")):
                if len(imgs) < 2:
                    imgs.append(low)
            elif low.endswith(".npz"):
                if len(npzs) < 2:
                    npzs.append(low)
        if len(imgs) >= 2 and len(npzs) >= 2:
            break
    return imgs, npzs


def resolve_input_format(path: str, fmt: str = "auto") -> str:
    """'png' | 'npz' for one image-set path. 'auto' picks npz only for an
    ``.npz`` file or a dir with npz content and no image files — except
    the VAE-GAN sampler's ``samples.png`` + ``generated.npz`` layout, where
    the png is a preview grid and the npz is the set."""
    if fmt in ("png", "npz"):
        return fmt
    if fmt != "auto":
        raise ValueError(f"input_format must be auto/png/npz, got {fmt!r}")
    if os.path.isfile(path):
        return "npz" if path.endswith(".npz") else "png"
    imgs, npzs = _scan_for_resolution(path)
    if imgs:
        if imgs == ["samples.png"] and npzs == ["generated.npz"]:
            return "npz"
        if npzs:
            print(f"[io] {path!r} holds BOTH images and .npz files; "
                  f"attacking the IMAGES (input_format='npz' or an "
                  f"explicit .npz path selects the arrays)")
        return "png"
    if npzs:
        return "npz"
    return "png"
