"""The fbb attack on tabular/EHR records, the medGAN path (port of
``ganleaks_tpu.attack.tabular``).

Loads row sets — ``.npy`` (or single-array ``.npz``) files, CSVs, or the
reference's CSV dataset with its exact 90/10 member/non-member split
(``medgan/model.py:107-130``: sklearn ``train_test_split(test_size=0.1,
random_state=42)``, reproduced here in numpy) — runs
:func:`attack.reconstruction.fbb_tabular`, and writes the fbb artifact
layout (``fbb.py:42-67,162-171``) plus ``metrics.jsonl``, so
``cli.eval_roc`` consumes the run unchanged. CSVs are read without
pandas (``io/tables``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ganleaks_tpu_torch.attack.reconstruction import fbb_tabular
from ganleaks_tpu_torch.config import TabularAttackConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.io.artifacts import (check_folder, dump_params,
                                             save_files)
from ganleaks_tpu_torch.io.tables import (load_csv_dataset, read_csv_filled,
                                          split_indices)  # noqa: F401
from ganleaks_tpu_torch.utils.logging import MetricsLogger


def load_rows(path: str) -> np.ndarray:
    """(N, D) float32 rows from .npy / single-array .npz / .csv (header
    row, NaNs filled with the column median like the reference's dataset
    loader, ``medgan/model.py:114``)."""
    path = os.path.expanduser(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            keys = list(z.keys())
            if len(keys) != 1:
                raise ValueError(f"{path}: expected a single array, "
                                 f"found keys {keys}")
            rows = z[keys[0]]
    elif path.endswith(".csv"):
        rows = read_csv_filled(path)
    else:
        rows = np.load(path)
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2:
        rows = rows.reshape(rows.shape[0], -1)
    return rows


def _query_rows(cfg: TabularAttackConfig) -> tuple[np.ndarray, np.ndarray]:
    if cfg.dataset_csv:
        pos = load_csv_dataset(cfg.dataset_csv, train=True)
        neg = load_csv_dataset(cfg.dataset_csv, train=False)
        return pos, neg
    if not (cfg.pos_data_path and cfg.neg_data_path):
        raise ValueError("need either dataset_csv or both pos_data_path "
                         "and neg_data_path")
    return load_rows(cfg.pos_data_path), load_rows(cfg.neg_data_path)


def run_tabular_attack(cfg: TabularAttackConfig,
                       device: torch.device | str | None = None) -> dict:
    """Load rows, 1-NN search on ``device``, fbb-layout artifacts. Returns
    the losses, the true NN indices, the save dir and the query pairs
    searched per second."""
    device = resolve_device(device)
    if not cfg.syn_data_path:
        raise ValueError("syn_data_path (synthetic.npy) is required")
    syn = load_rows(cfg.syn_data_path)
    pos, neg = _query_rows(cfg)
    pos, neg = pos[:cfg.data_num], neg[:cfg.data_num]
    if syn.shape[1] != pos.shape[1]:
        raise ValueError(f"feature dim mismatch: synthetic {syn.shape[1]} "
                         f"vs queries {pos.shape[1]}")

    save_dir = check_folder(os.path.join(os.getcwd(), cfg.save_root,
                                         cfg.exp_name))
    dump_params(save_dir, cfg)
    logger = MetricsLogger(os.path.join(save_dir, "metrics.jsonl"))
    t0 = time.perf_counter()
    out = fbb_tabular(syn, pos, neg, engine=cfg.engine,
                      s_block=cfg.syn_block, device=device)
    dt = time.perf_counter() - t0  # fbb_tabular returns host arrays
    rate = (len(pos) + len(neg)) * len(syn) / max(dt, 1e-9)
    logger.log({"query_pairs_per_sec": rate, "n_syn": len(syn),
                "n_pos": len(pos), "n_neg": len(neg),
                "n_features": int(syn.shape[1]), "engine": cfg.engine,
                "device": str(device)})

    # fbb artifact layout incl. the sequential-counter idx quirk
    # (fbb.py:162,171 — the neg file reuses len(pos_loss)) with the true
    # NN indices beside it, as attack/fbb.run_attack writes them
    seq = np.arange(len(out["pos_loss"])).reshape(-1, 1)
    save_files(save_dir, ["pos_loss", "pos_idx", "pos_nn_idx"],
               [out["pos_loss"].reshape(-1, 1), seq,
                out["pos_nn_idx"].reshape(-1, 1)])
    save_files(save_dir, ["neg_loss", "neg_idx", "neg_nn_idx"],
               [out["neg_loss"].reshape(-1, 1), seq,
                out["neg_nn_idx"].reshape(-1, 1)])
    logger.close()
    out["save_dir"] = save_dir
    out["query_pairs_per_sec"] = rate
    return out
