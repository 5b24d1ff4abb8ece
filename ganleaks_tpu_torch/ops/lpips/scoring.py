"""Perceptual-metric evaluation scores (port of
``ganleaks_tpu.ops.lpips.scoring``; reference:
``lpips_pytorch/models/dist_model.py:253-330``), used to validate a
distance function against human judgments:

* 2AFC (two-alternative forced choice): given triplets (ref, p0, p1) and
  the human preference ``gt`` in [0,1] (fraction choosing p1), score =
  mean of ``d1 < d0 ? gt : (d0 < d1 ? 1-gt : 0.5)`` — the reference's
  eval-side formula (``dist_model.py:287``);
* JND (just-noticeable differences): given pairs with binary ``same``
  labels, mAP of -distance as a same-detector (``score_jnd_dataset``,
  ``:291-330``; sklearn-style AP).

The scores and the dataset loops are numpy copies of the JAX package's;
:func:`make_pair_dist_fn` runs the network distances on the port's LPIPS.
"""

from __future__ import annotations

import numpy as np


def score_2afc(d0s: np.ndarray, d1s: np.ndarray,
               gts: np.ndarray) -> float:
    """Mean 2AFC agreement, the reference's exact formula
    (``dist_model.py:287``): ``gt`` is the fraction of humans judging
    p1 more similar; score = (d0<d1)*(1-gt) + (d1<d0)*gt + (d0==d1)*0.5
    — an exact tie scores 0.5 (the TRAINING-side compute_accuracy,
    ``dist_model.py:208-212``, folds ties toward p0 instead; this is the
    eval scorer)."""
    d0s = np.asarray(d0s, np.float64)
    d1s = np.asarray(d1s, np.float64)
    gts = np.asarray(gts, np.float64)
    scores = ((d0s < d1s) * (1.0 - gts) + (d1s < d0s) * gts
              + (d0s == d1s) * 0.5)
    return float(np.mean(scores))


def score_jnd(ds: np.ndarray, sames: np.ndarray) -> float:
    """mAP of -distance predicting 'same' (``dist_model.py:291-330``,
    which sorts by distance and computes precision/recall via the
    voc-style AP of ``util.voc_ap``; this is the equivalent
    average-precision integral)."""
    ds = np.asarray(ds, np.float64)
    sames = np.asarray(sames, np.float64)
    order = np.argsort(ds, kind="stable")
    sames_sorted = sames[order]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1.0 - sames_sorted)
    n_pos = sames.sum()
    recs = tps / n_pos
    precs = tps / (tps + fps)
    # voc_ap (util.py:419-449): precision envelope integral
    mrec = np.concatenate([[0.0], recs, [1.0]])
    mpre = np.concatenate([[0.0], precs, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def make_pair_dist_fn(model: str = "net-lin", net: str = "vgg",
                      colorspace: str = "Lab", weights: str | None = None,
                      device=None):
    """The DistModel factory branches (``dist_model.py:63-86``) as a
    batched pair-distance callable ``(a, b) -> np.ndarray`` over NHWC
    [-1, 1] batches: 'net-lin' (calibrated LPIPS) and 'net' (uncalibrated
    cosine) on ``device`` (``cuda`` unless the caller passes ``"cpu"``),
    'l2'/'ssim' (non-network baselines, Lab by default) on the host."""
    m = model.lower().replace("_", "-")
    if m in ("net-lin", "net"):
        import torch

        from ganleaks_tpu_torch.device import resolve_device
        from ganleaks_tpu_torch.ops.lpips.lpips import (default_lpips_params,
                                                        load_lpips_params,
                                                        lpips_pair,
                                                        pnet_pair)
        dev = resolve_device(device)
        params = (load_lpips_params(weights) if weights
                  else default_lpips_params(net=net)).to(dev).eval()
        fn = lpips_pair if m == "net-lin" else pnet_pair

        def dist(a, b):
            with torch.no_grad():
                d = fn(params,
                       torch.from_numpy(np.asarray(a, np.float32)).to(dev),
                       torch.from_numpy(np.asarray(b, np.float32)).to(dev))
            return d.cpu().numpy()
        return dist
    from ganleaks_tpu_torch.ops.lpips.fakenets import (dssim_distance,
                                                       l2_distance)
    if m == "l2":
        return lambda a, b: l2_distance(a, b, colorspace=colorspace)
    if m in ("ssim", "dssim"):
        return lambda a, b: dssim_distance(a, b, colorspace=colorspace)
    raise ValueError(f"unknown distance model {model!r} "
                     "(net-lin | net | l2 | ssim)")


def score_2afc_dataset(dist_fn, triplets) -> tuple[float, dict]:
    """Reference-shaped loop: ``dist_fn(a, b) -> per-pair distances``,
    ``triplets`` yields dicts with 'ref', 'p0', 'p1', 'judge' arrays."""
    d0s, d1s, gts = [], [], []
    for batch in triplets:
        d0s.append(np.asarray(dist_fn(batch["ref"], batch["p0"])))
        d1s.append(np.asarray(dist_fn(batch["ref"], batch["p1"])))
        gts.append(np.asarray(batch["judge"]).reshape(-1))
    d0s = np.concatenate(d0s)
    d1s = np.concatenate(d1s)
    gts = np.concatenate(gts)
    return score_2afc(d0s, d1s, gts), {"d0s": d0s, "d1s": d1s, "gts": gts}


def score_jnd_dataset(dist_fn, pairs) -> tuple[float, dict]:
    """``dist_fn(p0, p1)`` over batches of dicts with 'p0', 'p1', 'same'."""
    ds, sames = [], []
    for batch in pairs:
        ds.append(np.asarray(dist_fn(batch["p0"], batch["p1"])))
        sames.append(np.asarray(batch["same"]).reshape(-1))
    ds = np.concatenate(ds)
    sames = np.concatenate(sames)
    return score_jnd(ds, sames), {"ds": ds, "sames": sames}
