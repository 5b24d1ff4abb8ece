"""Lazy block-decoded image sets for pipelined ingest (copy of
``ganleaks_tpu.io.stream`` over the port's codec, ``io/native``).

The reference decodes every PNG up front and moves the whole set to the
device before the first distance is computed (``fbb.py:133-145``).
:class:`HostImageSet` indexes like an ``(N, H, W, C)`` array but decodes
rows on demand (the threaded codec, ``io/native``) with background
readahead of the sequentially-next window, so the streamed searches'
block slices (``ops/knn._as_device_block``: ``x[start:start+block]``)
overlap decode and host->device shipping with the featurise and fold of
the block before. Decoded rows are kept in host memory, so a
re-sweep or an OOM resume reads them from host memory.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ganleaks_tpu_torch.io.diskcache import DecodeCache
from ganleaks_tpu_torch.io.images import get_filepaths_from_dir
from ganleaks_tpu_torch.io.native import (MODE_EXACT,
                                          load_image_paths_native)


class HostImageSet:
    """A directory of images as a lazily-decoded array-like.

    Supports the access patterns of the streamed engines and of
    ``attack.fbb``: ``x[start:stop]`` (sequential block reads, with readahead of
    the next window on one worker thread), ``x[i]`` (single row, e.g. a
    closest-pair plot) and ``x[index_array]`` (the two-pass candidate
    gather). Every access returns a fresh decoded ``np.ndarray``. Each row
    decodes at most once and is kept in host memory (the full decoded
    set, what the eager loader would hold), so multi-chunk schedules and
    OOM resumes re-sweep from memory; with ``disk_cache`` that memory is
    the decode cache's memmap, published for the next run once the last
    row lands, and a complete cache entry is read without decoding.
    """

    def __init__(self, data_dir: str, resolution: int = 64,
                 ext: str = "png", limit: int | None = None,
                 mode: int = MODE_EXACT, dtype=np.uint8,
                 num_threads: int | None = None, disk_cache="auto"):
        self.paths = get_filepaths_from_dir(data_dir, ext)
        if limit is not None:
            self.paths = self.paths[:limit]
        if not self.paths:
            raise FileNotFoundError(f"no *.{ext} files under {data_dir}")
        self.resolution = resolution
        self.mode = mode
        self.dtype = np.dtype(dtype)
        self.num_threads = num_threads
        self.shape = (len(self.paths), resolution, resolution, 3)
        # one worker: the point is overlap with device work; the codec's
        # own threads decode each window in parallel
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._next: tuple | None = None  # ((start, stop), Future)
        self._dc = DecodeCache(data_dir, self.paths, resolution, mode,
                               self.dtype, policy=disk_cache)
        cached = self._dc.load()
        if cached is not None:
            self._cache = cached
            self._have = np.ones(len(self.paths), bool)
            return
        mm = self._dc.open_for_write()
        self._cache = mm if mm is not None else np.empty(self.shape,
                                                         self.dtype)
        self._have = np.zeros(len(self.paths), bool)

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def nbytes(self) -> int:
        """Logical size of the DECODED set. Note it is never resident on
        the host or device all at once — the device-memory planner
        charges host-backed inputs nothing (``ops/stream_plan``)."""
        return int(np.prod(self.shape)) * self.dtype.itemsize

    @property
    def ndim(self) -> int:
        return 4

    def _decode(self, start: int, stop: int) -> np.ndarray:
        if self._have[start:stop].all():
            return self._cache[start:stop].copy()
        arr = load_image_paths_native(
            self.paths[start:stop], self.resolution, mode=self.mode,
            num_threads=self.num_threads, dtype=self.dtype)
        # data first, THEN the flags: a concurrent reader (readahead
        # worker vs main thread) may see have=False and re-decode, never a
        # True flag over unwritten rows
        self._cache[start:stop] = arr
        self._have[start:stop] = True
        if not self._dc.complete and self._have.all():
            # last row landed: publish the disk cache for later runs
            self._dc.mark_complete(self._cache)
        return arr

    def _window(self, start: int, stop: int) -> np.ndarray:
        """Decode [start, stop), serving/priming the readahead window."""
        arr = None
        if self._next is not None:
            (ps, pe), fut = self._next
            if (ps, pe) == (start, stop):
                arr = fut.result()
                self._next = None
            elif fut.done():  # stale prefetch (resume changed the walk)
                self._next = None
            else:
                fut.result()  # drain: one worker, must not queue behind
                self._next = None
        if arr is None:
            arr = self._decode(start, stop)
        nxt = (stop, min(len(self), stop + (stop - start)))
        if nxt[1] > nxt[0]:
            self._next = (nxt, self._pool.submit(self._decode, *nxt))
        return arr

    def __getitem__(self, idx) -> np.ndarray:
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self))
            if step != 1:  # decode only the selected rows, not the set
                return self[np.arange(start, stop, step)]
            if start >= stop:
                return np.empty((0,) + self.shape[1:], self.dtype)
            return self._window(start, stop)
        if self._next is not None:
            # let a pending readahead land first: its rows are then served
            # from the decoded-row cache instead of being decoded twice
            self._next[1].result()
        if isinstance(idx, (int, np.integer)):
            i = int(idx)
            i0 = i + len(self) if i < 0 else i
            if not 0 <= i0 < len(self):
                raise IndexError(f"index {i} out of range for "
                                 f"HostImageSet of length {len(self)}")
            return self._decode(i0, i0 + 1)[0]
        rows = np.asarray(idx)
        if rows.ndim != 1:
            raise TypeError(f"HostImageSet: unsupported index {idx!r}")
        if rows.dtype == bool:
            # numpy boolean-mask semantics — treating the mask as int
            # indices would silently return copies of rows 0/1
            if len(rows) != len(self):
                raise IndexError(
                    f"boolean mask of length {len(rows)} does not match "
                    f"HostImageSet of length {len(self)}")
            rows = np.nonzero(rows)[0]
        rows = np.where(rows < 0, rows + len(self), rows)
        if rows.size and (rows.min() < 0 or rows.max() >= len(self)):
            raise IndexError(f"index out of range for HostImageSet of "
                             f"length {len(self)}")
        out = np.empty((len(rows),) + self.shape[1:], self.dtype)
        order = np.argsort(rows, kind="stable")
        k = 0
        while k < len(order):  # decode contiguous runs in one call
            j = k
            while (j + 1 < len(order)
                   and rows[order[j + 1]] == rows[order[j]] + 1):
                j += 1
            lo, hi = int(rows[order[k]]), int(rows[order[j]]) + 1
            out[order[k:j + 1]] = self._decode(lo, hi)
            k = j + 1
        return out

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """Full eager decode — lets ``np.asarray`` (the non-streaming
        paths: closest-pair plots, an explicit copy) consume the set
        like any array. Defeats laziness by design; the streamed engines
        never call it."""
        arr = self._decode(0, len(self))
        return arr.astype(dtype) if dtype is not None else arr

    def limit(self, n: int) -> "HostImageSet":
        """A view over the first ``n`` rows (lazy — no decode)."""
        clone = object.__new__(HostImageSet)
        clone.__dict__.update(self.__dict__)
        clone.paths = self.paths[:n]
        clone.shape = (len(clone.paths),) + self.shape[1:]
        clone._next = None
        return clone
