"""Attack evaluation: ROC / AUC / AP / precision, with optional
calibration (port of ``ganleaks_tpu.attack.eval_roc``; reference
``attack_models/eval_roc.py``). Scores are negated losses. matplotlib is
imported only by :func:`evaluate_and_plot`.
"""

from __future__ import annotations

import os

import numpy as np

from ganleaks_tpu_torch.config import EvalConfig
from ganleaks_tpu_torch.ops.roc import roc_curve_auc
from ganleaks_tpu_torch.utils.logging import MetricsLogger


def load_losses(result_dir: str, attack_type: str
                ) -> tuple[np.ndarray, np.ndarray]:
    """fbb losses keep their (N, 1) shape; other attack types flatten
    (``eval_roc.py:67-72``)."""
    pos = np.load(os.path.join(result_dir, "pos_loss.npy"))
    neg = np.load(os.path.join(result_dir, "neg_loss.npy"))
    if attack_type != "fbb":
        pos, neg = pos.flatten(), neg.flatten()
    return pos, neg


def evaluate(cfg: EvalConfig, pos_loss: np.ndarray | None = None,
             neg_loss: np.ndarray | None = None) -> dict:
    """Metrics for the run in ``cfg.result_load_dir`` (or the given
    losses); with ``cfg.reference_load_dir`` also the calibrated scores
    ``-(loss - ref_loss)`` (``eval_roc.py:86-103``)."""
    if pos_loss is None:
        pos_loss, neg_loss = load_losses(cfg.result_load_dir, cfg.attack_type)
    pos_loss = np.asarray(pos_loss, np.float32).reshape(-1)
    neg_loss = np.asarray(neg_loss, np.float32).reshape(-1)

    # non-finite losses would sort arbitrarily and emerge as a
    # plausible-looking AUROC: refuse unless the caller opted in, and then
    # flag the result as degenerate
    n_bad_pos = int(pos_loss.size - np.isfinite(pos_loss).sum())
    n_bad_neg = int(neg_loss.size - np.isfinite(neg_loss).sum())
    degenerate = bool(n_bad_pos or n_bad_neg)
    if degenerate and not cfg.allow_nonfinite:
        raise ValueError(
            f"non-finite attack losses: {n_bad_pos}/{pos_loss.size} pos, "
            f"{n_bad_neg}/{neg_loss.size} neg — the victim or the attack "
            f"diverged; refusing to compute a meaningless AUROC. Pass "
            f"EvalConfig(allow_nonfinite=True) to score anyway (the result "
            f"will carry degenerate=True).")

    res = roc_curve_auc(-pos_loss, -neg_loss, cfg.precision_threshold)
    out = {"auc": res.auc, "ap": res.ap, "precision": res.precision,
           "fpr": res.fpr, "tpr": res.tpr}
    if degenerate:
        out.update({"degenerate": True, "nonfinite_pos": n_bad_pos,
                    "nonfinite_neg": n_bad_neg})

    if cfg.reference_load_dir is not None:
        pos_ref, neg_ref = load_losses(cfg.reference_load_dir,
                                       cfg.attack_type)
        pos_ref = np.asarray(pos_ref, np.float32).reshape(-1)
        neg_ref = np.asarray(neg_ref, np.float32).reshape(-1)
        # calibration pairs by index: different lengths mean different
        # query sets, and truncating would report a meaningless AUC
        if len(pos_ref) != len(pos_loss) or len(neg_ref) != len(neg_loss):
            raise ValueError(
                f"calibration length mismatch: result has "
                f"{len(pos_loss)} pos / {len(neg_loss)} neg losses, "
                f"reference has {len(pos_ref)} / {len(neg_ref)} — the "
                f"runs must score the same query sets in the same order")
        n_bad_ref = int((~np.isfinite(pos_ref)).sum()
                        + (~np.isfinite(neg_ref)).sum())
        if n_bad_ref:
            if not cfg.allow_nonfinite:
                raise ValueError(
                    f"non-finite reference-model losses ({n_bad_ref} "
                    f"values) in {cfg.reference_load_dir} — the "
                    f"calibration baseline is garbage; refusing to "
                    f"compute a calibrated AUROC.")
            out.update({"degenerate": True, "nonfinite_ref": n_bad_ref})
        cal = roc_curve_auc(-(pos_loss - pos_ref), -(neg_loss - neg_ref),
                            cfg.precision_threshold)
        out.update({"auc_calibrated": cal.auc, "ap_calibrated": cal.ap})
    return out


def evaluate_and_plot(cfg: EvalConfig) -> dict:
    """CLI flavour: metrics + roc.png + histogram (``eval_roc.py:105-121``,
    ``:28-37``)."""
    out = evaluate(cfg)
    logger = MetricsLogger(wandb_project=cfg.wandb)
    logger.log({k: v for k, v in out.items()
                if not isinstance(v, np.ndarray)})
    if cfg.save_dir and cfg.result_load_dir:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(out["fpr"], out["tpr"],
                 label=f"{cfg.attack_type} attack, auc={out['auc']:.3f}, "
                       f"ap={out['ap']:.3f}")
        plt.legend(loc="lower right")
        plt.xlabel("false positive")
        plt.ylabel("true positive")
        plt.title("ROC curve")
        plt.savefig(os.path.join(cfg.result_load_dir, "roc.png"))
        plt.close()

        pos, neg = load_losses(cfg.result_load_dir, cfg.attack_type)
        plt.figure()
        plt.hist(pos.ravel(), bins=100, alpha=0.5,
                 weights=np.full(pos.size, 1.0 / pos.size), label="positive")
        plt.hist(neg.ravel(), bins=100, alpha=0.5,
                 weights=np.full(neg.size, 1.0 / neg.size), label="negative")
        plt.legend(loc="upper right")
        plt.xlabel("distance")
        plt.ylabel("normalized frequency")
        plt.savefig(os.path.join(cfg.result_load_dir, "hist.png"))
        plt.close()
    logger.close()
    return out
