"""Persistent decoded-image disk cache (memmapped .npy); copy of
``ganleaks_tpu.io.diskcache`` over the port's codec (``io/native``).

The decoded pixels are a pure function of (file bytes, resolution, resize
mode, dtype), so they are cached ONCE as a raw ``.npy`` beside the data
and every later run reads them as a read-only memmap: repeat attacks,
sweeps over attack hyperparameters and evaluation re-runs skip the
decode. The reference re-decodes its PNG dirs on every invocation
(``attack_models/fbb.py:101-110``).

Layout: ``<cache_dir>/<key>.npy`` plus ``<key>.json``, the completeness
sidecar. Writers NEVER touch the published ``.npy`` in place: rows are
decoded into a per-process ``<key>.npy.w<pid>`` temp file that is
``os.replace``d onto the final name only when every row has landed, and
the sidecar is published (tmp + rename) after that. A reader therefore
only ever memmaps a complete file; a crashed or concurrent partial write
is invisible (it lives under the temp name), and two processes racing on
the SAME key each publish identical bytes — the worst case is duplicate
work, never torn or truncated data. The key is a sha1 over the loader
version, the decode parameters, and each file's (relative path, size,
mtime_ns) — touching any input file, reordering the directory, or
changing resolution/mode/dtype misses and re-decodes.

Cache location (``_resolve_cache_dir``): the config knob
(``AttackConfig.decode_cache``: False/'off' disables, a path pins the
dir); otherwise ``<data_dir>/.ganleaks_decoded`` when the data dir is
writable, else ``~/.cache/ganleaks_tpu/decoded`` (the JAX package's
location: an entry is the same bytes for either).

Hygiene: publishing an entry garbage-collects its cache dir best-effort —
stale writer temp files older than a day (a crashed decode), published
``.npy`` files with no sidecar (pre-rename leftovers from older versions),
and the oldest published entries beyond ``_KEEP`` (4 — each entry is a
full decoded set, 1.47 GB uint8 at the 120,000 images of the north star,
and every mtime touch or dtype sweep mints a new key).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

_VERSION = 1  # bump to invalidate every existing cache entry
_KEEP = 4  # published entries a cache dir keeps (a sweep holds several)
_TMP_TTL_S = 24 * 3600.0  # writer temps older than this are crash debris


def _resolve_cache_dir(data_dir: str, policy) -> str | None:
    """Where (if anywhere) the cache for ``data_dir`` lives: ``policy``
    is the config knob — False/'off' disables; True/'auto' picks a
    default location; a path string pins the directory."""
    if policy in (False, "off", "false", "0"):
        return None
    if isinstance(policy, str) and policy not in ("auto", "true", "1"):
        return policy  # explicit directory from config
    if os.access(data_dir, os.W_OK):
        return os.path.join(data_dir, ".ganleaks_decoded")
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "ganleaks_tpu", "decoded")


class DecodeCache:
    """One (path list, decode params) cache entry.

    ``load()`` returns the complete read-only memmap or None;
    ``open_for_write()`` a writable memmap (temp-file backed) rows are
    decoded into; ``mark_complete()`` flushes it, renames it onto the
    published name, and publishes the sidecar.
    Every filesystem failure degrades to "no cache" — decode correctness
    never depends on this module.
    """

    def __init__(self, data_dir: str, paths: list, resolution: int,
                 mode: int, dtype, policy="auto"):
        self.shape = (len(paths), resolution, resolution, 3)
        self.dtype = np.dtype(dtype)
        self.complete = False
        self._dir = _resolve_cache_dir(data_dir, policy)
        self._mm = None
        self._tmp_path = None
        if self._dir is None:
            self.npy_path = self.sidecar_path = None
            return
        h = hashlib.sha1()
        h.update(f"v{_VERSION}|{resolution}|{mode}|"
                 f"{self.dtype.name}|{len(paths)}".encode())
        try:
            from ganleaks_tpu_torch.io.native import stat_paths
            sizes, mtimes = stat_paths(paths)  # threaded: 1e5 files
            for p, size, mtime in zip(paths, sizes.tolist(),
                                      mtimes.tolist()):
                rel = os.path.relpath(p, data_dir)
                h.update(f"{rel}|{size}|{mtime}".encode())
        except OSError:
            self.npy_path = self.sidecar_path = None
            self._dir = None
            return
        key = h.hexdigest()[:24]
        self.npy_path = os.path.join(self._dir, f"{key}.npy")
        self.sidecar_path = os.path.join(self._dir, f"{key}.json")

    @property
    def enabled(self) -> bool:
        return self.npy_path is not None

    def load(self):
        """The complete cached array as a read-only memmap, or None."""
        if not self.enabled:
            return None
        try:
            with open(self.sidecar_path) as f:
                meta = json.load(f)
            if (tuple(meta["shape"]) != self.shape
                    or meta["dtype"] != self.dtype.name):
                return None
            arr = np.load(self.npy_path, mmap_mode="r")
            if arr.shape != self.shape or arr.dtype != self.dtype:
                return None
        except Exception:
            return None
        self.complete = True
        return arr

    def open_for_write(self):
        """A writable memmap of the right shape/dtype, or None.

        Backed by a per-process TEMP file (``<key>.npy.w<pid>``), not the
        published path: a published entry is never truncated in place, so
        a concurrent reader — or a crash mid-fill — can never observe a
        valid sidecar over zeroed/partial pixels. Rows are written by the
        caller as they decode; :meth:`mark_complete` renames the finished
        file onto the published name.
        """
        if not self.enabled:
            return None
        try:
            os.makedirs(self._dir, exist_ok=True)
            self._gc(prune_published=False)  # reclaim crashed-writer temps
            self._tmp_path = f"{self.npy_path}.w{os.getpid()}"
            self._mm = np.lib.format.open_memmap(
                self._tmp_path, mode="w+", dtype=self.dtype,
                shape=self.shape)
        except Exception:
            self._mm = None
            self._tmp_path = None
        return self._mm

    def mark_complete(self, arr=None) -> None:
        """Flush + rename the temp file onto the published name, then
        atomically publish the sidecar (and GC the cache dir)."""
        if not self.enabled or self.complete:
            return
        try:
            if self._mm is not None and self._tmp_path is not None:
                self._mm.flush()
                os.replace(self._tmp_path, self.npy_path)
                self._tmp_path = None
            elif arr is not None:
                # rows were decoded into a plain RAM array (memmap open
                # failed earlier, or the caller cached in RAM): persist
                # the finished set through the same tmp + rename
                os.makedirs(self._dir, exist_ok=True)
                tmp = f"{self.npy_path}.w{os.getpid()}"
                with open(tmp, "wb") as f:
                    np.lib.format.write_array(
                        f, np.asarray(arr, self.dtype))
                os.replace(tmp, self.npy_path)
            else:
                return
            tmp = self.sidecar_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"shape": self.shape, "dtype": self.dtype.name,
                           "version": _VERSION}, f)
            os.replace(tmp, self.sidecar_path)
            self.complete = True
            self._gc(prune_published=True)
        except Exception:
            pass

    def _gc(self, prune_published: bool) -> None:
        """Best-effort cache-dir hygiene; every key change strands a
        full-set ``.npy`` otherwise. Never touches this entry's own key,
        and keeps the ``_KEEP`` newest published entries."""
        own = {os.path.basename(self.npy_path),
               os.path.basename(self.sidecar_path)}
        now = time.time()
        try:
            names = os.listdir(self._dir)
        except OSError:
            return
        sidecars = []
        for fn in names:
            if fn in own or fn.endswith(".tmp"):
                continue
            path = os.path.join(self._dir, fn)
            try:
                if ".npy.w" in fn:
                    # crashed/abandoned writer temp (a LIVE concurrent
                    # writer's temp is younger than the TTL)
                    if now - os.path.getmtime(path) > _TMP_TTL_S:
                        os.remove(path)
                elif fn.endswith(".json"):
                    sidecars.append((os.path.getmtime(path), fn))
                elif (fn.endswith(".npy")
                      and fn[:-4] + ".json" not in names
                      and now - os.path.getmtime(path) > _TMP_TTL_S):
                    os.remove(path)  # unpublished leftover, no sidecar
            except OSError:
                continue
        if not prune_published:
            return
        # newest _KEEP - 1 foreign entries survive beside this one; remove
        # the sidecar FIRST so no reader trusts a half-removed entry
        sidecars.sort(reverse=True)
        for _, fn in sidecars[_KEEP - 1:]:
            for victim in (fn, fn[:-5] + ".npy"):
                try:
                    os.remove(os.path.join(self._dir, victim))
                except OSError:
                    pass


def load_image_dir_cached(data_dir: str, resolution: int = 64,
                          ext: str = "png", limit: int | None = None,
                          mode: int | None = None,
                          num_threads: int | None = None,
                          dtype=np.float32, policy="auto") -> np.ndarray:
    """``io/native.load_image_paths_native`` behind the disk cache.

    First call decodes (threaded native loader) and persists; later
    calls with unchanged files memmap the cached bytes read-only — the
    query sets of a re-run attack cost a file open instead of a decode.
    ``limit`` is part of the key (the limited prefix is what's cached).
    """
    from ganleaks_tpu_torch.io.images import get_filepaths_from_dir
    from ganleaks_tpu_torch.io.native import (MODE_EXACT,
                                              load_image_paths_native)

    if mode is None:
        mode = MODE_EXACT
    paths = get_filepaths_from_dir(data_dir, ext)
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no *.{ext} files under {data_dir}")
    dc = DecodeCache(data_dir, paths, resolution, mode, dtype, policy)
    cached = dc.load()
    if cached is not None:
        return cached
    arr = load_image_paths_native(paths, resolution, mode=mode,
                                  num_threads=num_threads, dtype=dtype)
    mm = dc.open_for_write()
    if mm is not None:
        mm[:] = arr
    dc.mark_complete(arr)
    return arr
