"""On-disk artifact layout, byte-compatible with the reference (copy of
``ganleaks_tpu.io.artifacts``): attack loss vectors (``pos_loss.npy``
etc., ``fbb.py:162,171``) and per-run parameter dumps
(``params.txt``/``params.pkl``, ``fbb.py:62-66``)."""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Sequence

import numpy as np


def check_folder(path: str) -> str:
    """mkdir -p (``attack_models/utils.py:19-27``)."""
    os.makedirs(path, exist_ok=True)
    return path


def save_files(save_dir: str, names: Sequence[str],
               arrays: Sequence[np.ndarray]) -> None:
    """np.save a list of arrays (``attack_models/utils.py:30-40``)."""
    if len(names) != len(arrays):
        raise ValueError(f"{len(names)} names for {len(arrays)} arrays")
    for name, arr in zip(names, arrays):
        np.save(os.path.join(save_dir, name), np.asarray(arr),
                allow_pickle=False)


def dump_params(save_dir: str, cfg: Any) -> None:
    """params.txt + params.pkl per run (``fbb.py:62-66``)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        d = dataclasses.asdict(cfg)
    elif isinstance(cfg, dict):
        d = cfg
    else:
        d = vars(cfg)
    check_folder(save_dir)
    with open(os.path.join(save_dir, "params.txt"), "w") as f:
        for k, v in d.items():
            f.write(f"{k}:{v}\n")
    with open(os.path.join(save_dir, "params.pkl"), "wb") as f:
        pickle.dump(d, f, protocol=2)
