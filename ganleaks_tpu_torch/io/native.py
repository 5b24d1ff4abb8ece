"""The port's PNG codec: batched, threaded reads and writes of 8-bit RGB,
non-interlaced PNGs (what the repository's writers produce) without
libpng or Pillow.

``csrc/png_codec.cpp`` does the work for a whole batch on a pool of C++
threads — read, chunk parse, zlib inflate, row un-filtering; or rows with
filter type None, zlib deflate (level 1 by default, as the JAX package's
libpng encoder), chunks and CRCs, write — so no Python runs per image. It
is built with g++ (and zlib, ``-l:libz.so.1``) at first use into
``_build/`` and loaded with ctypes. Pixels are what libpng and Pillow
decode from the same file; file bytes are this encoder's own.

Any other PNG form (palette, grey, alpha, 16-bit, interlaced) or a
corrupt file raises ``ValueError`` naming the file. A failed build raises
with the compiler's output: nothing falls back to Pillow. Images whose size
differs from the requested resolution are decoded here and then resized as
the readers of ``io/images`` do (the resize variant through Pillow,
imported lazily; the center crop in numpy).

Port of the API of ``ganleaks_tpu.io.native`` (``load_image_paths_native``,
``load_image_dir_native``, ``save_png_batch_native``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ganleaks_tpu_torch.io.images import (center_crop_u8,
                                          get_filepaths_from_dir,
                                          resize_u8)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "png_codec.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
LIBS = ("-l:libz.so.1",)

MODE_EXACT = 0        # resize variant (io/images.read_image)
MODE_CENTER_CROP = 1  # VAE-GAN center crop (io/images.read_image_center_crop)

# the readers' [-1, 1] scalings as 256-entry tables: the resize variant's
# float64 2*(x/255)-1 cast to float32, the center crop's float32 x/255*2-1
LUT_RESIZE = (2.0 * (np.arange(256) / 255.0) - 1.0).astype(np.float32)
LUT_CROP = np.arange(256, dtype=np.float32) / 255.0 * 2.0 - 1.0

# csrc/png_codec.cpp's per-image status codes
_OK, _ERR_OPEN, _ERR_NOT_PNG, _ERR_CORRUPT, _ERR_FORM, _ERR_SIZE = range(6)

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int


def library_path() -> str:
    """Where the codec's library is built: the name hashes the source and
    the flags, so an edited source never loads a stale library."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpng_codec-{digest.hexdigest()[:16]}.so")


def _library() -> ctypes.CDLL:
    """The codec's library, built with g++ on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                cxx = os.environ.get("CXX", "g++")
                res = subprocess.run(
                    [cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                    capture_output=True, text=True)
                if res.returncode != 0:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    raise RuntimeError(
                        f"{cxx} failed to build {SOURCE} (exit "
                        f"{res.returncode}):\n{res.stdout}{res.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
            lib.gl_decode_batch.argtypes = [_P, _I, _I, _I, _P, _P, _P, _I]
            lib.gl_encode_batch.argtypes = [_P, _I, _I, _I, _P, _I, _P, _I]
            lib.gl_stat_batch.argtypes = [_P, _I, _P, _P, _I]
            lib.gl_decode_any.argtypes = [ctypes.c_char_p, _P, _P]
            lib.gl_free.argtypes = [_P]
            _lib = lib
        return _lib


def _threads(num_threads: int | None) -> int:
    """Codec threads: the files are read and written through the
    threads' own system calls, so twice the cores (at most 16) hide I/O
    latency (``tools/measure_png_codec.py`` on an 8-core host whose file
    system is 9p: 15,604 decodes/s at 16 threads, 12,645 at 8)."""
    return num_threads or min(16, 2 * (os.cpu_count() or 1))


def _c_paths(paths) -> ctypes.Array:
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def _error(path: str, status: int, info) -> ValueError | OSError:
    if status == _ERR_OPEN:
        return OSError(f"{path}: cannot be read or written")
    if status == _ERR_NOT_PNG:
        return ValueError(f"{path}: not a PNG file")
    if status == _ERR_FORM:
        return ValueError(
            f"{path}: a PNG of bit depth {info[2]}, color type {info[3]}, "
            f"interlace {info[4]}; the port's codec reads 8-bit RGB (color "
            f"type 2), non-interlaced PNGs only")
    return ValueError(f"{path}: corrupt PNG data")


def decode_png(path: str) -> np.ndarray:
    """One PNG of any size as an (H, W, 3) uint8 array."""
    lib = _library()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    info = np.zeros(5, np.int32)
    status = lib.gl_decode_any(os.fsencode(path), ctypes.byref(buf),
                               info.ctypes.data)
    try:
        if status != _OK:
            raise _error(path, int(status), info)
        h, w = int(info[1]), int(info[0])
        return np.ctypeslib.as_array(buf, (h, w, 3)).copy()
    finally:
        lib.gl_free(buf)


def decode_exact(paths: list, resolution: int | tuple[int, int],
                 num_threads: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Decode ``paths`` on the codec's threads into an (n, H, W, 3) uint8
    array (``resolution``: H = W, or ``(H, W)``); returns it and the rows
    whose PNG has another size (left unwritten for the caller's resize).
    Any other failure raises, naming the file."""
    n = len(paths)
    h, w = ((resolution, resolution) if isinstance(resolution, int)
            else resolution)
    out = np.empty((n, h, w, 3), np.uint8)
    status = np.zeros(n, np.int32)
    info = np.zeros((n, 5), np.int32)
    if n:
        _library().gl_decode_batch(
            _c_paths(paths), n, h, w, out.ctypes.data,
            status.ctypes.data, info.ctypes.data, _threads(num_threads))
    bad = np.nonzero((status != _OK) & (status != _ERR_SIZE))[0]
    if bad.size:
        raise _error(paths[bad[0]], int(status[bad[0]]), info[bad[0]])
    return out, np.nonzero(status == _ERR_SIZE)[0]


def load_image_paths_native(paths: list, resolution: int = 64,
                            mode: int = MODE_EXACT,
                            num_threads: int | None = None,
                            dtype=np.float32) -> np.ndarray:
    """Explicit path list -> NHWC array: float32 in [-1, 1] by the mode's
    reader scaling, or the bytes with ``dtype=np.uint8`` (what
    ``unit_to_uint8_exact`` recovers from the floats). PNGs of another size
    are decoded one by one and resized as the mode's reader does."""
    out, other = decode_exact(paths, resolution, num_threads)
    for i in other:
        img = decode_png(paths[i])
        out[i] = (center_crop_u8(img, resolution)
                  if mode == MODE_CENTER_CROP
                  else resize_u8(img, resolution, paths[i]))
    if np.dtype(dtype) == np.uint8:
        return out
    return (LUT_CROP if mode == MODE_CENTER_CROP else LUT_RESIZE)[out]


def load_image_dir_native(data_dir: str, resolution: int = 64,
                          ext: str = "png", limit: int | None = None,
                          mode: int = MODE_EXACT,
                          num_threads: int | None = None,
                          dtype=np.float32) -> np.ndarray:
    """Directory -> NHWC (:func:`load_image_paths_native` over the sorted
    recursive glob)."""
    paths = get_filepaths_from_dir(data_dir, ext)
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no *.{ext} files under {data_dir}")
    return load_image_paths_native(paths, resolution, mode=mode,
                                   num_threads=num_threads, dtype=dtype)


def save_png_batch_native(images_u8: np.ndarray, paths: list,
                          compress_level: int = 1,
                          num_threads: int | None = None) -> None:
    """Encode a uint8 NHWC RGB batch to one PNG per path on the codec's
    threads (the reference's python loop over ``ToPILImage`` +
    ``Image.save``, ``train_torch.py:160-174``). The PNGs decode to exactly
    these pixels."""
    images_u8 = np.asarray(images_u8)
    if images_u8.dtype != np.uint8:
        # an implicit cast would corrupt the dump; the caller owns the
        # quantisation (io/images.to_uint8, and its rounding)
        raise TypeError(
            f"save_png_batch_native expects uint8 pixels, got "
            f"{images_u8.dtype}; convert with io.images.to_uint8 first")
    images_u8 = np.ascontiguousarray(images_u8)
    n, h, w, c = images_u8.shape
    if len(paths) != n or c != 3:
        raise ValueError(f"save_png_batch_native: {n} images (c={c}) "
                         f"vs {len(paths)} paths; need equal counts and "
                         f"RGB (c=3)")
    status = np.zeros(n, np.int32)
    if n:
        _library().gl_encode_batch(
            _c_paths(paths), n, h, w, images_u8.ctypes.data,
            int(compress_level), status.ctypes.data, _threads(num_threads))
    bad = np.nonzero(status)[0]
    if bad.size:
        raise OSError(f"could not write {bad.size} PNG(s), the first "
                      f"{paths[bad[0]]}")


def encode_png(img: np.ndarray, path: str, compress_level: int = 1) -> None:
    """Write one (H, W, 3) uint8 image as a PNG."""
    save_png_batch_native(np.asarray(img)[None], [path], compress_level, 1)


def stat_paths(paths: list, num_threads: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """``(st_size, st_mtime_ns)`` of every path, stat'ed on the codec's
    threads; ``OSError`` naming the first path that cannot be stat'ed."""
    n = len(paths)
    size = np.zeros(n, np.int64)
    mtime = np.zeros(n, np.int64)
    if n:
        _library().gl_stat_batch(_c_paths(paths), n, size.ctypes.data,
                                 mtime.ctypes.data, _threads(num_threads))
    bad = np.nonzero(size < 0)[0]
    if bad.size:
        raise OSError(f"{paths[bad[0]]}: cannot be stat'ed")
    return size, mtime
