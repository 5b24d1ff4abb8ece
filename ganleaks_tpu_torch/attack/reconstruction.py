"""Encoder-seeded reconstruction attack (VAE-GAN) and the tabular fbb path
(port of ``ganleaks_tpu.attack.reconstruction``).

BASELINE config #3: for a victim with an encoder (VAE-GAN), the membership
score of a query x is its reconstruction distance ``d(x, G(E(x)))`` under
'l2' or 'l2' + 0.2 LPIPS, the fbb metric family.

BASELINE config #4: medGAN's tabular records go through the same 1-NN
search as image embeddings — the embeddings are the scaled rows
(``ops/distance.rows_embedding``), and ``engine='pallas'`` runs the fused
CUDA distance+argmin kernel on them.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.ops.distance import l2_pair, rows_embedding
from ganleaks_tpu_torch.ops.knn import knn_argmin


def batch_generator(seed: int, sub: int, offset: int,
                    device: torch.device | str) -> torch.Generator:
    """The generator of the reparametrisation noise of one batch: seeded
    from (``seed``, query set ``sub``, the batch's first row ``offset``),
    as the JAX package folds ``sub`` and ``offset`` into its key."""
    state = np.random.SeedSequence([seed, sub, offset]).generate_state(2)
    seed64 = (int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed64)


def reconstruction_scores(encoder_apply: Callable, generator_apply: Callable,
                          queries: np.ndarray, generator: Callable,
                          lpips_model=None, lpips_weight: float = 0.2,
                          batch: int = 256,
                          device: torch.device | str | None = None
                          ) -> np.ndarray:
    """Per-query reconstruction losses d(x, G(E(x))) (smaller => member)
    as float32 numpy.

    ``queries``: NHWC images in [-1, 1], uploaded to ``device`` one batch
    at a time. ``encoder_apply(x, g) -> z`` with ``g`` the torch.Generator
    ``generator(offset)`` of the batch starting at row ``offset``;
    ``generator_apply(z)`` -> NHWC images in [-1, 1]. ``lpips_model``
    optionally adds ``lpips_weight`` * LPIPS (the fbb attack's 0.2,
    ``attack_models/utils.py:176``)."""
    from ganleaks_tpu_torch.ops.lpips import lpips_pair

    device = resolve_device(device)
    out = []
    with torch.inference_mode():
        for i in range(0, len(queries), batch):
            x = torch.as_tensor(np.asarray(queries[i:i + batch]),
                                dtype=torch.float32).to(device)
            rec = generator_apply(encoder_apply(x, generator(i)))
            d = l2_pair(rec, x)
            if lpips_model is not None:
                d = d + lpips_weight * lpips_pair(lpips_model, rec, x)
            out.append(d.float().cpu().numpy())
    return np.concatenate(out)


def _load_queries(cfg, path: str, reader) -> np.ndarray:
    """A query set as NHWC float32 in [-1, 1]: an image npz (or a dir of
    them) at ``cfg.resolution``, else a PNG dir through ``reader``."""
    from ganleaks_tpu_torch.io.npz import (load_npz_images,
                                           resolve_input_format)

    if resolve_input_format(path) == "npz":
        return load_npz_images(path, cfg.resolution, limit=cfg.data_num)
    from ganleaks_tpu_torch.io.images import load_image_dir
    return load_image_dir(path, cfg.resolution, limit=cfg.data_num,
                          reader=reader)


def run_reconstruction_attack(cfg, device: torch.device | str | None = None
                              ) -> dict:
    """Full reconstruction-attack pipeline (BASELINE config #3).

    Loads the pos/neg query sets (PNG dirs through the configured reader,
    or image npz files), reconstructs every query through the VAE-GAN
    encoder and generator (``cfg.netE``/``cfg.netG``: the JAX trainer's
    msgpack or an npz of the same variables), and writes the fbb layout:
    ``pos_loss.npy``/``neg_loss.npy`` (N, 1) float64, sequential
    ``pos_idx``/``neg_idx`` — the neg file reuses ``len(pos)``, the
    reference quirk (``fbb.py:162,171``) — ``params.txt``/``params.pkl``
    and, with ``save_plots``, query|reconstruction PNG pairs. Returns the
    losses, the save dir and the queries scored per second."""
    from ganleaks_tpu_torch.io.artifacts import (check_folder, dump_params,
                                                 save_files)
    from ganleaks_tpu_torch.io.images import (read_image,
                                              read_image_center_crop,
                                              to_uint8)
    from ganleaks_tpu_torch.utils.checkpoint import load_variables
    from ganleaks_tpu_torch.weights import vaegan_from_jax_variables

    device = resolve_device(device)
    if cfg.distance not in ("l2", "l2-lpips"):
        raise ValueError(f"unknown distance {cfg.distance!r}; expected "
                         f"'l2' or 'l2-lpips'")
    save_dir = check_folder(os.path.join(os.getcwd(), cfg.save_root,
                                         cfg.exp_name))
    dump_params(save_dir, cfg)

    reader = (read_image_center_crop if cfg.reader == "center_crop"
              else read_image)
    pos = _load_queries(cfg, cfg.pos_data_dir, reader)
    neg = _load_queries(cfg, cfg.neg_data_dir, reader)

    enc = vaegan_from_jax_variables("encoder", load_variables(cfg.netE),
                                    cfg.z_dim, cfg.d).to(device)
    gen = vaegan_from_jax_variables("generator", load_variables(cfg.netG),
                                    cfg.z_dim, cfg.d).to(device)

    def encoder_apply(x, g):
        return enc(x.permute(0, 3, 1, 2), g)

    def generator_apply(z):
        return gen(z).permute(0, 2, 3, 1)

    lpips_model = None
    if cfg.distance == "l2-lpips":
        from ganleaks_tpu_torch.ops.lpips import (default_lpips_params,
                                                  load_lpips_params)
        lpips_model = (load_lpips_params(cfg.lpips_weights)
                       if cfg.lpips_weights
                       else default_lpips_params(cfg.lpips_net))
        lpips_model = lpips_model.to(device).eval()

    out = {}
    n_pos = len(pos)
    secs = 0.0
    for name, queries, sub in (("pos", pos, 0), ("neg", neg, 1)):
        t0 = time.perf_counter()
        losses = reconstruction_scores(
            encoder_apply, generator_apply, queries,
            lambda off, sub=sub: batch_generator(cfg.seed, sub, off, device),
            lpips_model=lpips_model, batch=cfg.batch, device=device)
        secs += time.perf_counter() - t0
        save_files(save_dir, [f"{name}_loss", f"{name}_idx"],
                   [losses.astype(np.float64).reshape(-1, 1),
                    np.arange(n_pos).reshape(-1, 1)])
        if cfg.save_plots:  # query | G(E(query)) pairs, fbb.py:91-106 style
            import PIL.Image

            with torch.inference_mode():
                x = torch.from_numpy(np.asarray(queries[:20])).to(device)
                recon = generator_apply(encoder_apply(
                    x, batch_generator(cfg.seed, 10 + sub, 0, device)))
                recon = recon.float().cpu().numpy()
            for i in range(min(20, len(queries))):
                pair = np.concatenate([queries[i], recon[i]], axis=1)
                PIL.Image.fromarray(to_uint8(pair, drange=(-1, 1))).save(
                    os.path.join(save_dir, f"{i}{name}.png"))
        out[f"{name}_loss"] = losses
    out["save_dir"] = save_dir
    out["queries_per_sec"] = (len(pos) + len(neg)) / max(secs, 1e-9)
    return out


def fbb_tabular(syn_rows: np.ndarray, pos_rows: np.ndarray,
                neg_rows: np.ndarray, *, engine: str = "gemm",
                s_block: int = 8192,
                device: torch.device | str | None = None) -> dict:
    """fbb attack on (N, D) tabular records (medGAN path): 1-NN distance
    under the mean-square-feature metric. ``engine``: 'gemm' / 'exact'
    (torch folds) or 'pallas' (the fused CUDA distance+argmin kernel on
    CUDA; its plain version on the CPU). Returns float64 losses and int32
    NN indices per query set."""
    device = resolve_device(device)

    def embed(rows):
        return rows_embedding(torch.as_tensor(
            np.asarray(rows, np.float32)).to(device))

    emb_s = embed(syn_rows)
    out = {}
    for name, rows in (("pos", pos_rows), ("neg", neg_rows)):
        d, i = knn_argmin(embed(rows), emb_s, engine=engine, s_block=s_block)
        out[f"{name}_loss"] = d.cpu().numpy().astype(np.float64)
        out[f"{name}_nn_idx"] = i.cpu().numpy()
    return out
