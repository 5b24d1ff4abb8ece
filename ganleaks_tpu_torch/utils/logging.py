"""Structured metrics logging (copy of ``ganleaks_tpu.utils.logging``):
JSONL records to disk plus an optional wandb sink, imported lazily, and a
throughput meter."""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLogger:
    def __init__(self, path: str | None = None,
                 wandb_project: str | None = None,
                 config: dict | None = None, echo: bool = True):
        self._file = None
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a")
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

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()


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
