"""Structured metrics logging (copy of ``ganleaks_tpu.utils.logging``):
JSONL records to disk plus an optional wandb sink, imported lazily,
sample-image grids written as PNGs by the port's encoder, and a throughput
meter."""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLogger:
    def __init__(self, path: str | None = None,
                 wandb_project: str | None = None,
                 config: dict | None = None, echo: bool = True,
                 image_dir: str | None = None):
        self._file = None
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a")
        self.image_dir = image_dir
        if image_dir:
            os.makedirs(image_dir, exist_ok=True)
        self._wandb = None
        if wandb_project:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project, config=config)
            except Exception as e:  # wandb optional / offline
                print(f"[metrics] wandb disabled: {e}")

    def log(self, record: dict[str, Any], step: int | None = None) -> None:
        rec = {"time": time.time(),
               **({"step": step} if step is not None else {}),
               **{k: _tofloat(v) for k, v in record.items()}}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(record, step=step)
        if self.echo:
            body = " ".join(f"{k}={v:.6g}" if isinstance(v, float)
                            else f"{k}={v}"
                            for k, v in rec.items() if k != "time")
            print(f"[metrics] {body}")

    def log_image_grid(self, name: str, images01, step: int | None = None,
                       ncols: int = 8) -> str | None:
        """Write a sample-image grid PNG under ``image_dir`` (and a
        ``wandb.Image`` where wandb is on), as the reference logs per-epoch
        grids (``train_torch.py:125-127``). ``images01``: (N, H, W, C) in
        [0, 1]. Returns the path, or None without an image sink."""
        if self.image_dir is None and self._wandb is None:
            return None
        grid = tile_image_grid(images01, ncols)
        path = None
        if self.image_dir is not None:
            from ganleaks_tpu_torch.io.native import encode_png
            tag = f"_{step:07d}" if step is not None else ""
            path = os.path.join(self.image_dir, f"{name}{tag}.png")
            encode_png(grid, path)
        if self._wandb:
            import wandb
            self._wandb.log({name: wandb.Image(grid)}, step=step)
        return path

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()


def tile_image_grid(images01, ncols: int = 8):
    """Tile (N, H, W, C) images in [0, 1] into one uint8 (rows*H, ncols*W,
    C) grid, padding the last row with black (``rint`` of x * 255)."""
    import numpy as np
    imgs = np.clip(np.asarray(images01, np.float32), 0.0, 1.0)
    n, h, w, c = imgs.shape
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    pad = nrows * ncols - n
    if pad:
        imgs = np.concatenate(
            [imgs, np.zeros((pad, h, w, c), np.float32)], axis=0)
    grid = (imgs.reshape(nrows, ncols, h, w, c)
            .transpose(0, 2, 1, 3, 4)
            .reshape(nrows * h, ncols * w, c))
    return np.round(grid * 255.0).astype(np.uint8)


def _tofloat(v):
    """JSONL-safe value: numeric scalars become floats, strings stay
    strings, arrays become lists, anything else degrades to repr."""
    if isinstance(v, str):
        return v
    if isinstance(v, (bool, int)):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        pass
    if hasattr(v, "tolist"):
        return v.tolist()
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


class Throughput:
    """items/sec meter; callers add items after the work they count has
    finished on the device."""

    def __init__(self):
        self.items = 0
        self.start = time.perf_counter()

    def add(self, n: int) -> None:
        self.items += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.start
        return self.items / dt if dt > 0 else float("inf")
