"""On-disk artifact layout, byte-compatible with the reference (copy of
``ganleaks_tpu.io.artifacts``): timestamped synthetic-sample dirs
(``png_images/ npz_images/ npz_noise/``, ``train_torch.py:160-174``),
attack loss vectors (``pos_loss.npy`` etc., ``fbb.py:162,171``) and
per-run parameter dumps (``params.txt``/``params.pkl``, ``fbb.py:62-66``).
PNGs are written by the port's encoder (``io/native``): they decode to
the reference's pixels, not to its file bytes."""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
from typing import Any, Sequence

import numpy as np


def check_folder(path: str) -> str:
    """mkdir -p (``attack_models/utils.py:19-27``)."""
    os.makedirs(path, exist_ok=True)
    return path


def timestamp_stamp() -> str:
    """The reference's run-dir strftime format (``train_torch.py:71-72``)."""
    return datetime.datetime.now().strftime("_%Y_%m_%d__%H_%M_%S")


def timestamp_dir(root: str) -> str:
    """A timestamped run dir under ``root``."""
    return os.path.join(root, timestamp_stamp())


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


def write_synthetic_artifacts(root: str, model_name: str,
                              images01: np.ndarray, noise: np.ndarray,
                              run_dir: str | None = None) -> dict[str, str]:
    """The three-way synthetic dump of ``train_torch.py:160-174``:

    - ``npz_images/<run>/<model>_synthetic_data.npz`` with key ``fake``
      (NCHW, [0, 1]);
    - ``npz_noise/<run>/<model>_noise.npz`` with key ``noise``
      (N, nz, 1, 1, the torch latent shape);
    - ``png_images/<run>/image_<i>.png``, quantised by ``to_uint8``'s
      floor (``ToPILImage``) and written on the codec's threads.

    ``images01``: NHWC in [0, 1]. Returns the three dir paths."""
    from ganleaks_tpu_torch.io.images import to_uint8
    from ganleaks_tpu_torch.io.native import save_png_batch_native

    if run_dir is None:
        run_dir = timestamp_stamp()
    d_img = check_folder(os.path.join(root, "npz_images", run_dir))
    d_noise = check_folder(os.path.join(root, "npz_noise", run_dir))
    d_png = check_folder(os.path.join(root, "png_images", run_dir))
    images01 = np.asarray(images01, dtype=np.float32)
    np.savez(os.path.join(d_img, f"{model_name}_synthetic_data.npz"),
             fake=np.transpose(images01, (0, 3, 1, 2)))
    noise = np.asarray(noise, dtype=np.float32)
    if noise.ndim == 2:
        noise = noise[:, :, None, None]
    np.savez(os.path.join(d_noise, f"{model_name}_noise.npz"), noise=noise)
    paths = [os.path.join(d_png, f"image_{i}.png")
             for i in range(len(images01))]
    save_png_batch_native(to_uint8(images01, (0.0, 1.0)), paths)
    return {"npz_images": d_img, "npz_noise": d_noise, "png_images": d_png}
