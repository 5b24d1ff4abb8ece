"""``ganleaks_tpu_torch.ops.roc`` / ``attack.eval_roc`` against the JAX
package's ``roc_curve_auc`` / ``evaluate`` on the CPU, with tied scores.

Tolerance 1e-6: the JAX side accumulates its counts and trapezoids in
float32, the port in float64; the curves themselves (tie collapse, run
ends) must match exactly in shape.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from sklearn import metrics as skm

from ganleaks_tpu.attack.eval_roc import evaluate as j_evaluate
from ganleaks_tpu.config import EvalConfig as JEvalConfig
from ganleaks_tpu.ops.roc import roc_curve_auc as j_roc
from ganleaks_tpu_torch.attack.eval_roc import evaluate, evaluate_and_plot
from ganleaks_tpu_torch.config import EvalConfig
from ganleaks_tpu_torch.ops.roc import roc_curve_auc

TOL = 1e-6


def _scores(rng, kind, n_pos=40, n_neg=50):
    if kind == "continuous":
        return (rng.normal(0.5, 1, n_pos).astype(np.float32),
                rng.normal(0, 1, n_neg).astype(np.float32))
    if kind == "ties":  # few distinct values, ties inside and across sets
        return (rng.integers(-4, 3, n_pos).astype(np.float32) / 4,
                rng.integers(-5, 2, n_neg).astype(np.float32) / 4)
    if kind == "all_tied":
        return np.zeros(n_pos, np.float32), np.zeros(n_neg, np.float32)
    # threshold: scores straddling the hardcoded -0.14 precision cut
    return (rng.uniform(-0.3, 0.0, n_pos).astype(np.float32),
            rng.uniform(-0.4, -0.1, n_neg).astype(np.float32))


@pytest.mark.parametrize("kind", ["continuous", "ties", "all_tied",
                                  "threshold"])
def test_roc_matches_jax_and_sklearn(rng, kind):
    pos, neg = _scores(rng, kind)
    got = roc_curve_auc(pos, neg)
    want = j_roc(jnp.asarray(pos), jnp.asarray(neg))
    for field in ("fpr", "tpr"):
        np.testing.assert_allclose(getattr(got, field),
                                   np.asarray(getattr(want, field)),
                                   atol=TOL)
    np.testing.assert_array_equal(got.thresholds, np.asarray(want.thresholds))
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    for field in ("auc", "ap", "precision"):
        np.testing.assert_allclose(getattr(got, field),
                                   float(getattr(want, field)), atol=TOL)
    labels = np.concatenate([np.zeros(neg.size), np.ones(pos.size)])
    scores = np.concatenate([neg, pos])
    np.testing.assert_allclose(got.auc, skm.roc_auc_score(labels, scores),
                               atol=TOL)
    np.testing.assert_allclose(
        got.ap, skm.average_precision_score(labels, scores), atol=TOL)


def _write(d, pos, neg):
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "pos_loss.npy"), pos.reshape(-1, 1))
    np.save(os.path.join(d, "neg_loss.npy"), neg.reshape(-1, 1))
    return str(d)


def test_evaluate_with_calibration_matches_jax(rng, tmp_path):
    run = _write(tmp_path / "run", rng.random(30), rng.random(30) + 0.2)
    ref = _write(tmp_path / "ref", rng.random(30), rng.random(30))
    got = evaluate(EvalConfig(result_load_dir=run, reference_load_dir=ref))
    want = j_evaluate(JEvalConfig(result_load_dir=run,
                                  reference_load_dir=ref))
    for key in ("auc", "ap", "precision", "auc_calibrated",
                "ap_calibrated"):
        np.testing.assert_allclose(got[key], want[key], atol=TOL)
    np.testing.assert_allclose(got["fpr"], want["fpr"], atol=TOL)


def test_evaluate_refuses_nonfinite(tmp_path):
    pos = np.array([0.1, np.nan, 0.3])
    neg = np.array([0.5, 0.6, np.inf])
    with pytest.raises(ValueError, match="non-finite"):
        evaluate(EvalConfig(), pos, neg)
    out = evaluate(EvalConfig(allow_nonfinite=True), pos, neg)
    assert out["degenerate"] is True
    assert out["nonfinite_pos"] == 1 and out["nonfinite_neg"] == 1
    # a garbage calibration baseline is refused too
    run = _write(tmp_path / "run", np.array([0.1, 0.2]), np.array([0.3, 0.4]))
    ref = _write(tmp_path / "ref", np.array([0.1, np.nan]),
                 np.array([0.3, 0.4]))
    with pytest.raises(ValueError, match="reference-model"):
        evaluate(EvalConfig(result_load_dir=run, reference_load_dir=ref))


def test_evaluate_calibration_length_guard(tmp_path):
    run = _write(tmp_path / "run", np.arange(4.0), np.arange(4.0))
    ref = _write(tmp_path / "ref", np.arange(3.0), np.arange(4.0))
    with pytest.raises(ValueError, match="length mismatch"):
        evaluate(EvalConfig(result_load_dir=run, reference_load_dir=ref))


def test_evaluate_and_plot_writes_figures(rng, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = _write(tmp_path / "run", rng.random(20), rng.random(20) + 0.3)
    out = evaluate_and_plot(EvalConfig(result_load_dir=run))
    assert 0.5 < out["auc"] <= 1.0
    assert os.path.exists(os.path.join(run, "roc.png"))
    assert os.path.exists(os.path.join(run, "hist.png"))
