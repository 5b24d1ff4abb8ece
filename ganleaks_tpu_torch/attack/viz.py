"""Matplotlib visualisation helpers (port of ``ganleaks_tpu.attack.viz``;
reference ``attack_models/utils.py:90-148``): ground-truth grids,
optimisation progress with per-image losses, and the 8x8 sample sheet.

Images are NHWC numpy arrays or tensors on any device (copied to the
host). matplotlib (the Agg backend) is imported inside the functions, so
the module imports where matplotlib is absent; each plot then raises
``ImportError``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

NCOLS = 5  # attack_models/utils.py:16


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(x) -> np.ndarray:
    """``x`` as a numpy array on the host (bfloat16 tensors as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def inverse_transform(imgs) -> np.ndarray:
    """[-1,1] -> [0,1] (``utils.py:90-98``)."""
    return (_host(imgs) + 1.0) / 2.0


def visualize_gt(imgs, save_dir: str) -> str:
    """(``utils.py:101-116``)."""
    path = os.path.join(save_dir, "input.png")
    _grid(np.clip(inverse_transform(imgs), 0.0, 1.0), path)
    return path


def visualize_progress(imgs, loss, save_dir: str, counter: int) -> str:
    """(``utils.py:119-138``)."""
    plt = _pyplot()
    imgs = np.clip(inverse_transform(imgs), 0.0, 1.0)
    loss = _host(loss)
    nrows = int(np.ceil(len(imgs) / NCOLS))
    plt.figure()
    for i in range(len(imgs)):
        plt.subplot(nrows, NCOLS, i + 1)
        plt.imshow(imgs[i])
        plt.title("loss: %.4f" % loss[i],
                  fontdict={"fontsize": 8, "color": "blue"})
        plt.axis("off")
    path = os.path.join(save_dir, "output_%d.png" % counter)
    plt.savefig(path)
    plt.close()
    return path


def visualize_samples(img_r01, save_dir: str) -> str:
    """8x8 sample sheet (``utils.py:141-148``); input already in [0,1]."""
    plt = _pyplot()
    img_r01 = _host(img_r01)
    plt.figure(figsize=(20, 20))
    for i in range(min(64, len(img_r01))):
        plt.subplot(8, 8, i + 1)
        plt.imshow(img_r01[i])
        plt.axis("off")
    plt.tight_layout()
    path = os.path.join(save_dir, "samples.png")
    plt.savefig(path)
    plt.close()
    return path


def _grid(imgs: np.ndarray, path: str) -> None:
    plt = _pyplot()
    nrows = int(np.ceil(len(imgs) / NCOLS))
    plt.figure()
    for i in range(len(imgs)):
        plt.subplot(nrows, NCOLS, i + 1)
        plt.imshow(imgs[i])
        plt.axis("off")
    plt.savefig(path)
    plt.close()
