"""The port's medGAN victim (``ganleaks_tpu_torch.models.medgan``,
``train.medgan``, ``io.tables``, ``cli.train_medgan``, the medGAN part of
``weights``) against the JAX package on the CPU, at D 40 binary features,
latent 8, batch 16.

Weights come from the JAX trainer's ``build_state`` and are carried into
the port by ``weights.gan_load_jax_variables``; each GAN step is handed
the JAX step's own noise. Tolerances are ``tests/test_torch_victims.py``'s:
forwards atol 2e-5, losses rtol 1e-4, BatchNorm statistics atol 1e-5,
parameters within a tenth of lr after the pretrain step and two GAN steps
(the encoder's included: the G-side Adam decays it on a zero gradient).
The CSV loader and the batch schedule are held exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.config import MedGANConfig as JMedGANConfig
from ganleaks_tpu.models import medgan as jm
from ganleaks_tpu.tools import convert_victim
from ganleaks_tpu.train import medgan as jt
from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.attack.eval_roc import evaluate
from ganleaks_tpu_torch.attack.tabular import run_tabular_attack
from ganleaks_tpu_torch.cli import train_medgan as cli
from ganleaks_tpu_torch.config import (EvalConfig, MedGANConfig,
                                       TabularAttackConfig)
from ganleaks_tpu_torch.io.tables import load_csv_dataset
from ganleaks_tpu_torch.models.medgan import (Autoencoder, Discriminator,
                                              Generator)
from ganleaks_tpu_torch.train import medgan
from ganleaks_tpu_torch.utils.checkpoint import load_state_dict

ATOL = 2e-5
LOSS_RTOL = 1e-4
STAT_ATOL = 1e-5
D_IN, LATENT, B = 40, 8, 16
KW = dict(latent_dim=LATENT, hidden_gen=LATENT, hidden_disc1=16,
          hidden_disc2=16, batch_size=B)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _variables(ms):
    return jax.tree_util.tree_map(np.asarray, {
        "params": ms.params, "batch_stats": ms.batch_stats})


def _rows(rng, n):
    return (rng.random((n, D_IN)) < 0.3).astype(np.float32)


def _write_csv(path, data):
    with open(path, "w") as f:
        f.write(",".join(f"c{i}" for i in range(data.shape[1])) + "\n")
        for row in data:
            f.write(",".join("" if np.isnan(v) else f"{v:g}" for v in row)
                    + "\n")


@pytest.mark.parametrize("kind,train", [("gen", False), ("gen", True),
                                        ("ae", False), ("disc", False),
                                        ("disc_flat", False)])
def test_medgan_nets_forward_match_jax(kind, train):
    """Generator (eval and train: the BatchNorm eps 0.001 / momentum 0.01
    statistics), autoencoder, discriminator with and without minibatch
    averaging (its divide-by-batch quirk)."""
    rng = np.random.default_rng(0)
    x = _rows(rng, 6)
    z = rng.standard_normal((6, LATENT)).astype(np.float32)
    mb = kind != "disc_flat"
    jmod, inp = {"gen": (jm.Generator(LATENT, LATENT), z),
                 "ae": (jm.Autoencoder(D_IN, LATENT), x),
                 "disc": (jm.Discriminator(16, 16, True), x),
                 "disc_flat": (jm.Discriminator(16, 16, False), x)}[kind]
    v = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.key(1), inp, **({"train": True} if kind == "gen"
                                   else {})))
    if kind == "gen":
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            v["batch_stats"])
        want, upd = jmod.apply(v, z, train=train, mutable=["batch_stats"])
    else:
        want, upd = jmod.apply(v, inp), {}
    port = weights.medgan_from_jax_variables(
        "disc" if kind.startswith("disc") else kind, v,
        minibatch_average=mb).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(inp)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    if train:
        got_stats = _flat(weights.medgan_to_jax_variables(port)
                          ["batch_stats"])
        for k, w in _flat(upd["batch_stats"]).items():
            np.testing.assert_allclose(got_stats[k], w, atol=STAT_ATOL)


def test_pretrain_and_gan_steps_match_jax():
    """One autoencoder pretrain step, then two GAN steps with the JAX
    steps' noise: losses, every net's parameters (the encoder moved only
    by the G-side Adam's weight decay), G's BatchNorm statistics; the
    autoencoder the port keeps is the JAX state's ``ae`` and
    ``ae_in_g``."""
    jcfg, cfg = JMedGANConfig(**KW), MedGANConfig(**KW)
    jstate = jt.build_state(jcfg, D_IN, jax.random.key(2))
    port = medgan.build_state(cfg, D_IN)
    for net, ms in (("gen", jstate.gen), ("disc", jstate.disc),
                    ("ae", jstate.ae)):
        weights.gan_load_jax_variables(getattr(port, net), _variables(ms))
    enc0 = port.ae.encoder[0].weight.detach().clone()
    real = _rows(np.random.default_rng(3), B)
    ae, jm1 = jt.ae_pretrain_step(jstate.ae, jnp.asarray(real))
    m1 = medgan.ae_pretrain_step(port, torch.from_numpy(real))
    np.testing.assert_allclose(float(m1["a_loss"]), float(jm1["a_loss"]),
                               rtol=LOSS_RTOL)
    jstate = jstate.replace(ae=ae, ae_in_g=jstate.ae_in_g.replace(
        params=ae.params))
    key = jax.random.key(4)
    for i in range(2):
        k = jax.random.fold_in(key, i)
        z = np.asarray(jax.random.normal(k, (B, LATENT), jnp.float32))
        jstate, jmet = jt.medgan_train_step(jstate, jnp.asarray(real), k)
        met = medgan.medgan_train_step(port, torch.from_numpy(real),
                                       noise=torch.from_numpy(z))
        for name in ("d_loss", "g_loss"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=LOSS_RTOL, err_msg=name)
    for net, ms in (("gen", jstate.gen), ("disc", jstate.disc),
                    ("ae", jstate.ae), ("ae", jstate.ae_in_g)):
        got = weights.medgan_to_jax_variables(getattr(port, net))
        for coll, tol in (("params", cfg.lr / 10),
                          ("batch_stats", STAT_ATOL)):
            g, w = _flat(got.get(coll, {})), _flat(ms.params if coll ==
                                                   "params" else
                                                   ms.batch_stats)
            assert sorted(g) == sorted(w), (net, coll)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol,
                                           err_msg=f"{net} {coll} {k}")
    decayed = float((port.ae.encoder[0].weight - enc0).abs().max())
    assert 0 < decayed, "the G-side Adam left the encoder alone"
    assert port.step == 2


@pytest.mark.parametrize("train", [True, False])
def test_csv_loader_matches_jax(tmp_path, train):
    """The CSV read without pandas: column-median fill of empty fields and
    NA words, the 90/10 split of ``train_test_split(test_size=0.1,
    random_state=42)``, rows in the split's order — the JAX loader's
    (pandas and sklearn) array exactly, at n = 53 (not a multiple of
    10)."""
    rng = np.random.default_rng(5)
    data = rng.uniform(size=(53, 6)).round(3)
    data[(rng.random(data.shape) < 0.05)] = np.nan
    data[0, 0] = np.nan
    path = str(tmp_path / "d.csv")
    _write_csv(path, data)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:   # one NA word, and a trailing blank line
        f.write(text.replace(",,", ",NA,", 1) + "\n")
    got = load_csv_dataset(path, train=train)
    want = jt.load_csv_dataset(path, train=train)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_sampling_schedule_matches_jax(monkeypatch):
    """With the steps replaced by recorders, both loops hand their steps
    the same batches: ``default_rng(seed).integers`` with replacement,
    ``n // batch_size`` per epoch, pretrain then GAN."""
    data = _rows(np.random.default_rng(6), 37)
    got, want = [], []

    def rec(sink, jax_step):
        def step(state, real, *a, **k):
            sink.append(np.asarray(real))
            if jax_step:
                return state, {"a_loss": 0.0}
            return {"a_loss": torch.zeros(())}
        return step

    monkeypatch.setattr(medgan, "ae_pretrain_step", rec(got, False))
    monkeypatch.setattr(medgan, "medgan_train_step", rec(got, False))
    monkeypatch.setattr(jt, "ae_pretrain_step", rec(want, True))
    monkeypatch.setattr(jt, "medgan_train_step", rec(want, True))
    kw = {**KW, "batch_size": 8, "n_epochs": 2, "n_epochs_pretrain": 1,
          "save_model": False, "seed": 3}
    medgan.train(MedGANConfig(**kw), data, device="cpu")
    jt.train(JMedGANConfig(**kw), data)
    assert len(got) == len(want) == 3 * (37 // 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _reference_state_dicts(rng):
    """Random values under the reference's keys (``medgan/model.py``;
    ``tools/convert_victim.py:99-131``)."""
    def t(*shape):
        return torch.from_numpy(rng.normal(0, 0.3, shape).astype(np.float32))

    h = LATENT
    g = {"gen_block1.0.weight": t(h, LATENT), "gen_block1.0.bias": t(h),
         "gen_block2.0.weight": t(LATENT, h), "gen_block2.0.bias": t(LATENT)}
    for blk, n in (("gen_block1.1", h), ("gen_block2.1", LATENT)):
        g.update({f"{blk}.weight": t(n), f"{blk}.bias": t(n),
                  f"{blk}.running_mean": t(n),
                  f"{blk}.running_var": t(n).abs() + 0.5,
                  f"{blk}.num_batches_tracked": torch.tensor(5)})
    a = {"encoder.0.weight": t(h, D_IN), "encoder.0.bias": t(h),
         "decoder.0.weight": t(D_IN, h), "decoder.0.bias": t(D_IN)}
    d = {"disc.0.weight": t(16, 2 * D_IN), "disc.0.bias": t(16),
         "disc.2.weight": t(16, 16), "disc.2.bias": t(16),
         "disc.4.weight": t(1, 16), "disc.4.bias": t(1)}
    return g, a, d


def test_reference_state_dicts_load_by_name(tmp_path):
    """Reference-layout state dicts load into the port's nets by name and
    compute what the JAX nets compute on the converted checkpoint; the
    port saves the same keys."""
    rng = np.random.default_rng(7)
    g_sd, a_sd, d_sd = _reference_state_dicts(rng)
    gen = load_state_dict(Generator(LATENT, LATENT), g_sd).eval()
    ae = load_state_dict(Autoencoder(D_IN, LATENT), a_sd)
    disc = load_state_dict(Discriminator(D_IN, 16, 16), d_sd)
    conv = convert_victim.convert_medgan(
        *({k: v.numpy() for k, v in sd.items()} for sd in (g_sd, a_sd,
                                                           d_sd)))
    z = rng.standard_normal((5, LATENT)).astype(np.float32)
    x = _rows(rng, 5)
    for port, jmod, var, inp in (
            (gen, jm.Generator(LATENT, LATENT), conv["gen"], z),
            (ae, jm.Autoencoder(D_IN, LATENT), conv["ae"], x),
            (disc, jm.Discriminator(16, 16), conv["disc"], x)):
        with torch.no_grad():
            got = port(torch.from_numpy(inp)).numpy()
        np.testing.assert_allclose(got, np.asarray(jmod.apply(var, inp)),
                                   atol=1e-5)
    for port, sd in ((gen, g_sd), (ae, a_sd), (disc, d_sd)):
        assert set(port.state_dict()) == {
            k for k in sd if not k.endswith("num_batches_tracked")}


def test_train_generate_and_tabular_attack(tmp_path, monkeypatch):
    """The pipeline on the CPU: the CLI trains from a CSV with NaNs (the
    pretrain and two GAN epochs), saves the three nets under the
    reference's keys and writes ``synthetic.npy`` (binary float32); the
    port's tabular attack ('pallas', the CSV's own split as members and
    non-members) reads it and ``evaluate`` scores the run."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(8)
    data = _rows(rng, 101)
    data[4, 7] = np.nan
    _write_csv("m.csv", data)
    cli.main(["DATASETPATH=m.csv", "n_epochs=2", "n_epochs_pretrain=2",
              f"batch_size={B}", f"latent_dim={LATENT}",
              f"hidden_gen={LATENT}", "generate_N=60", "PATH=model"],
             device="cpu")
    (run,) = os.listdir("model/medgan")
    assert sorted(os.listdir(f"model/medgan/{run}")) == [
        "autoencoder.pth", "discriminator.pth", "generator.pth"]
    syn = np.load("model/synthetic.npy")
    assert syn.shape == (60, D_IN) and syn.dtype == np.float32
    assert set(np.unique(syn)) <= {0.0, 1.0}
    real_p, syn_p = medgan.dimension_wise_probability(
        load_csv_dataset("m.csv"), syn)
    assert real_p.shape == syn_p.shape == (D_IN,)
    out = run_tabular_attack(TabularAttackConfig(
        syn_data_path="model/synthetic.npy", dataset_csv="m.csv",
        engine="pallas"), device="cpu")
    assert out["pos_nn_idx"].shape == (90,)
    assert np.isfinite(out["pos_loss"]).all()
    assert 0.0 <= evaluate(EvalConfig(
        result_load_dir=out["save_dir"]))["auc"] <= 1.0
