"""ROC / AUC / AP / precision with sklearn's semantics (port of
``ganleaks_tpu.ops.roc``), in numpy: scoring 2 x 20,000 losses is host
work next to the attack.

* scores are NEGATED losses (smaller distance => more likely member,
  ``eval_roc.py:78``), compared as float32 like the JAX package;
* ``roc_curve``/``roc_auc_score``: threshold sweep over distinct scores,
  trapezoidal AUC; cumulative counts are taken at the last element of each
  tied group, as sklearn does;
* ``average_precision_score``: sum over recall increments of the precision
  at the end of each tied run (sklearn's step integral);
* ``precision_score`` at the reference's hardcoded ``score > -0.14``
  (``eval_roc.py:21-23``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RocResult(NamedTuple):
    fpr: np.ndarray         # (n + 1,), origin first, tied runs collapsed
    tpr: np.ndarray
    thresholds: np.ndarray  # (n + 1,), +inf first
    auc: float
    ap: float
    precision: float
    mask: np.ndarray        # (n,) True at the last element of each tied run


def roc_curve_auc(pos_scores, neg_scores,
                  precision_threshold: float = -0.14) -> RocResult:
    """ROC for (positive = member, negative = non-member) score vectors,
    matching ``plot_roc`` (``eval_roc.py:14-25``)."""
    pos = np.asarray(pos_scores, np.float32).reshape(-1)
    neg = np.asarray(neg_scores, np.float32).reshape(-1)
    scores = np.concatenate([neg, pos])
    labels = np.concatenate([np.zeros(neg.size), np.ones(pos.size)])
    n = scores.size
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    tps = np.cumsum(labels[order])
    fps = np.cumsum(1.0 - labels[order])

    is_last = np.concatenate([s[1:] != s[:-1], [True]])
    p_tot, n_tot = tps[-1], fps[-1]
    tpr0 = np.concatenate([[0.0], tps / p_tot])
    fpr0 = np.concatenate([[0.0], fps / n_tot])
    keep0 = np.concatenate([[True], is_last])
    # collapse tied runs: every point takes the value of the latest kept
    # (run-end) point at or before it
    idx = np.arange(n + 1)
    last_kept = np.maximum.accumulate(np.where(keep0, idx, -1))
    fpr_k, tpr_k = fpr0[last_kept], tpr0[last_kept]
    auc = np.sum((fpr_k[1:] - fpr_k[:-1]) * (tpr_k[1:] + tpr_k[:-1]) / 2.0)

    # each rank's recall increment weighted by the precision at the END of
    # its tied run
    prec_full = tps / np.arange(1, n + 1)
    run_end = np.minimum.accumulate(
        np.where(is_last, idx[:n], n - 1)[::-1])[::-1]
    rec_inc = np.diff(np.concatenate([[0.0], tps])) / p_tot
    ap = np.sum(rec_inc * prec_full[run_end])

    pred = scores > precision_threshold
    denom = pred.sum()
    precision = float((pred * labels).sum() / denom) if denom > 0 else 0.0

    thr = np.concatenate([[np.inf], s]).astype(np.float32)
    return RocResult(fpr=fpr_k, tpr=tpr_k, thresholds=thr, auc=float(auc),
                     ap=float(ap), precision=precision, mask=is_last)


def auroc(pos_scores, neg_scores) -> float:
    """The ROC AUC of member vs non-member scores."""
    return roc_curve_auc(pos_scores, neg_scores).auc
