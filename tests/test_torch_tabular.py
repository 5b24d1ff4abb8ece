"""The port's tabular fbb attack (``ganleaks_tpu_torch.attack.tabular``,
``fbb_tabular`` in ``attack.reconstruction``, ``cli.fbb_tabular``) against
the JAX package's on the CPU.

Tolerances, and how they were chosen:
* ``rows_embedding``: bit for bit (one correctly rounded float32 scale,
  one correctly rounded multiply on either side).
* losses: |port - JAX| <= 1e-5 * (rq + rs) — both are rq + rs - 2 q.s in
  float32 with the products summed in different orders ('exact': the
  squared differences, likewise), so the rounding scales with the norms.
* indices, continuous rows: identical (no two synthetic rows lie within
  that rounding of each other at these sizes).
* indices, binary rows: many synthetic rows share a distance exactly, and
  the float32 rounding decides among them differently in each package;
  so each port index equals the JAX index, or its float64 distance lies
  within 2e-5 * (rq + rs) of the float64 minimum (two roundings of 1e-5
  each, one per package).
"""

import os
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.attack.reconstruction import fbb_tabular as j_fbb_tabular
from ganleaks_tpu.attack.tabular import load_rows as j_load_rows
from ganleaks_tpu.attack.tabular import run_tabular_attack as j_run_tabular
from ganleaks_tpu.config import TabularAttackConfig as JTabularAttackConfig
from ganleaks_tpu.ops.distance import rows_embedding as j_rows_embedding
from ganleaks_tpu.train.medgan import load_csv_dataset as j_load_csv_dataset
from ganleaks_tpu_torch.attack.eval_roc import evaluate
from ganleaks_tpu_torch.attack.reconstruction import fbb_tabular
from ganleaks_tpu_torch.attack.tabular import (load_csv_dataset, load_rows,
                                               run_tabular_attack,
                                               split_indices)
from ganleaks_tpu_torch.cli import eval_roc as cli_eval_roc
from ganleaks_tpu_torch.cli import fbb_tabular as cli_tabular
from ganleaks_tpu_torch.config import EvalConfig, TabularAttackConfig
from ganleaks_tpu_torch.ops.distance import rows_embedding


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's CPU thread
    pool in each of them, on top of the others, slows every process many
    times over. One thread per process for this module's convolutions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-5


@pytest.mark.parametrize("d", [1, 3, 7, 32, 1071, 4099])
def test_rows_embedding_bit_for_bit(d):
    x = np.random.default_rng(d).standard_normal((5, d)).astype(np.float32)
    want = np.asarray(j_rows_embedding(jnp.asarray(x)))
    got = rows_embedding(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # higher-rank records flatten first
    x3 = x.reshape(5, 1, d)
    np.testing.assert_array_equal(rows_embedding(torch.from_numpy(x3)), got)


def _binary_rows(rng, n_syn=300, n_q=40, d=97, density=0.1):
    syn = (rng.uniform(size=(n_syn, d)) < density).astype(np.float32)
    pos = syn[rng.integers(0, n_syn, n_q)].copy()
    flips = rng.integers(0, d, n_q)
    pos[np.arange(n_q), flips] = 1.0 - pos[np.arange(n_q), flips]
    neg = (rng.uniform(size=(n_q, d)) < density).astype(np.float32)
    return syn, pos, neg


def _continuous_rows(rng, n_syn=300, n_q=40, d=97):
    syn = rng.standard_normal((n_syn, d)).astype(np.float32)
    pos = syn[rng.integers(0, n_syn, n_q)] \
        + 0.05 * rng.standard_normal((n_q, d)).astype(np.float32)
    neg = rng.standard_normal((n_q, d)).astype(np.float32)
    return syn, pos, neg


def _norms_and_d64(rows, syn):
    q = np.asarray(j_rows_embedding(jnp.asarray(rows))).astype(np.float64)
    s = np.asarray(j_rows_embedding(jnp.asarray(syn))).astype(np.float64)
    d64 = ((q[:, None, :] - s[None, :, :]) ** 2).sum(-1)
    return (q ** 2).sum(1), (s ** 2).sum(1), d64


@pytest.mark.parametrize("engine", ["gemm", "exact", "pallas"])
@pytest.mark.parametrize("kind", ["continuous", "binary"])
def test_fbb_tabular_matches_jax(engine, kind, monkeypatch):
    """'pallas' runs the fused kernel's plain version here (CPU tensors);
    on the JAX side the Pallas kernel, which runs on the CPU only in
    interpret mode, with float32 streams (``demote=False``: the port's
    float32 route keeps float32 rows throughout)."""
    if engine == "pallas":
        from ganleaks_tpu.ops import knn_pallas

        monkeypatch.setattr(knn_pallas, "knn_argmin_pallas", partial(
            knn_pallas.knn_argmin_pallas, interpret=True, demote=False))
    rng = np.random.default_rng(0)
    syn, pos, neg = (_continuous_rows if kind == "continuous"
                     else _binary_rows)(rng)
    want = j_fbb_tabular(syn, pos, neg, engine=engine, s_block=128)
    got = fbb_tabular(syn, pos, neg, engine=engine, s_block=128,
                      device="cpu")
    for name, rows in (("pos", pos), ("neg", neg)):
        rq, rs, d64 = _norms_and_d64(rows, syn)
        loss, idx = got[f"{name}_loss"], got[f"{name}_nn_idx"]
        assert loss.dtype == np.float64 and idx.shape == (len(rows),)
        j_idx = want[f"{name}_nn_idx"]
        bound = TOL * (rq + rs[j_idx])
        assert (np.abs(loss - want[f"{name}_loss"]) <= bound).all()
        if kind == "continuous":
            np.testing.assert_array_equal(idx, j_idx)
        else:
            pick = d64[np.arange(len(rows)), idx]
            near = pick - d64.min(1) <= 2 * TOL * (rq + rs[idx])
            assert ((idx == j_idx) | near).all()
            assert (idx == j_idx).mean() > 0.5


def test_load_rows_formats(tmp_path):
    rng = np.random.default_rng(1)
    rows = rng.uniform(size=(5, 3)).astype(np.float32)
    np.save(tmp_path / "a.npy", rows)
    np.savez(tmp_path / "b.npz", rows=rows)
    np.save(tmp_path / "c.npy", rows.reshape(5, 3, 1))
    for name in ("a.npy", "b.npz", "c.npy"):
        got = load_rows(str(tmp_path / name))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, rows)
    import pandas as pd

    frame = pd.DataFrame(rows, columns=["x", "y", "z"])
    frame.iloc[1, 0] = np.nan
    frame.iloc[3, 2] = np.nan
    frame.to_csv(tmp_path / "d.csv", index=False)
    got = load_rows(str(tmp_path / "d.csv"))
    np.testing.assert_array_equal(got, j_load_rows(str(tmp_path / "d.csv")))
    filled = pd.read_csv(tmp_path / "d.csv")["x"].median()
    assert got[1, 0] == np.float32(filled) and np.isfinite(got).all()
    np.savez(tmp_path / "two.npz", a=rows, b=rows)
    with pytest.raises(ValueError, match="single array"):
        load_rows(str(tmp_path / "two.npz"))


@pytest.mark.parametrize("n", [10, 11, 19, 97, 1000, 46520])
def test_split_matches_sklearn(n):
    from sklearn.model_selection import train_test_split

    idx = np.arange(n)
    want_train, want_test = train_test_split(idx, test_size=0.1,
                                             random_state=42)
    train, test = split_indices(n)
    np.testing.assert_array_equal(train, want_train)
    np.testing.assert_array_equal(test, want_test)


def test_dataset_csv_split_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    data = (rng.uniform(size=(53, 6)) < 0.3).astype(np.float32)
    data[4, 2] = np.nan
    import pandas as pd

    pd.DataFrame(data, columns=[f"c{i}" for i in range(6)]).to_csv(
        tmp_path / "mimic.csv", index=False)
    path = str(tmp_path / "mimic.csv")
    for train in (True, False):
        got = load_csv_dataset(path, train=train)
        want = j_load_csv_dataset(path, train=train)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert len(load_csv_dataset(path, train=False)) == 6  # ceil(5.3)


def _write_rows(tmp_path, rng):
    syn, pos, neg = _binary_rows(rng, n_syn=64, n_q=16, d=32, density=0.3)
    for name, arr in (("synthetic", syn), ("pos", pos), ("neg", neg)):
        np.save(tmp_path / f"{name}.npy", arr)
    return [f"syn_data_path={tmp_path}/synthetic.npy",
            f"pos_data_path={tmp_path}/pos.npy",
            f"neg_data_path={tmp_path}/neg.npy"]


def test_cli_into_eval_roc_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = _write_rows(tmp_path, np.random.default_rng(3))
    cli_tabular.main(args + ["exp_name=port", "engine=pallas"], device="cpu")
    assert "query-pairs/sec" in capsys.readouterr().out
    port_dir = os.path.join(str(tmp_path), "fbb_attack", "port")
    cli_eval_roc.main(["--device", "cpu", f"result_load_dir={port_dir}"])
    assert "AUC ROC" in capsys.readouterr().out
    kw = {a.split("=")[0]: a.split("=")[1] for a in args}
    j_out = j_run_tabular(JTabularAttackConfig(exp_name="jax", **kw))
    files = ("pos_loss", "neg_loss", "pos_idx", "neg_idx", "pos_nn_idx",
             "neg_nn_idx")
    for name in files:
        got = np.load(os.path.join(port_dir, name + ".npy"))
        want = np.load(os.path.join(j_out["save_dir"], name + ".npy"))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name.endswith("_loss"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        np.load(os.path.join(port_dir, "neg_idx.npy")).ravel(),
        np.arange(16))
    with open(os.path.join(port_dir, "metrics.jsonl")) as f:
        assert "query_pairs_per_sec" in f.readline()
    res = evaluate(EvalConfig(result_load_dir=port_dir))
    assert res["auc"] > 0.9  # members are one bit from a synthetic row
    for name in ("params.txt", "params.pkl"):
        assert os.path.exists(os.path.join(port_dir, name))


def test_run_tabular_attack_checks_inputs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_rows(tmp_path, np.random.default_rng(4))
    np.save(tmp_path / "wide.npy", np.zeros((3, 33), np.float32))
    with pytest.raises(ValueError, match="feature dim"):
        run_tabular_attack(TabularAttackConfig(
            syn_data_path=str(tmp_path / "wide.npy"),
            pos_data_path=str(tmp_path / "pos.npy"),
            neg_data_path=str(tmp_path / "neg.npy")), device="cpu")
    with pytest.raises(ValueError, match="dataset_csv"):
        run_tabular_attack(TabularAttackConfig(
            syn_data_path=str(tmp_path / "synthetic.npy")), device="cpu")
    out = run_tabular_attack(TabularAttackConfig(
        syn_data_path=str(tmp_path / "synthetic.npy"),
        pos_data_path=str(tmp_path / "pos.npy"),
        neg_data_path=str(tmp_path / "neg.npy"), data_num=5,
        engine="exact"), device="cpu")
    assert out["pos_loss"].shape == (5,) and out["query_pairs_per_sec"] > 0
