"""The port's privGAN victims (``ganleaks_tpu_torch.train.priv``,
``models.dcgan.PrivateDiscriminator``, ``models.pggan.Discriminator``'s
``n_outputs``, the privGAN part of ``weights`` and ``config``, and
``cli.train_priv{dcgan,pggan}``) against the JAX package on the CPU, at
the sizes of ``tests/test_privgan.py``: privDCGAN at 16 px with nz 8 and
ngf / ndf 8, privPGGAN with in_channels 16 and nz 16 up to 8 px, batch 4,
with 2 and 3 splits.

Weights come from the JAX package's ``build_priv*_state`` (the splits
stacked on a leading axis) and are carried into the port's per-split
modules by ``weights.privgan_from_jax_state``. The port cannot draw
``jax.random``'s numbers, so each step is handed the JAX step's own
draws, made from the keys it splits: noise, eps and the ``randint``
behind the target labels.

Tolerances, as ``tests/test_torch_victims.py``: forwards atol 2e-5 (float32
sums in different orders); losses rtol 1e-4; parameters after Adam steps
within a tenth of lr (a disagreeing gradient shows as about one lr, Adam's
first steps being sign-like); BatchNorm running statistics atol 1e-5. The
private classifier's running statistics across the generator step: bit
for bit (that forward must not touch them). Batches, labels, fade-ins,
dp gates and artifact names: exact.
"""

import copy
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ganleaks_tpu.config import DCGANConfig as JDCGANConfig
from ganleaks_tpu.config import PGGANConfig as JPGGANConfig
from ganleaks_tpu.config import PrivGANConfig as JPrivGANConfig
from ganleaks_tpu.config import expand_grid as j_expand_grid
from ganleaks_tpu.config import sweep_tag as j_sweep_tag
from ganleaks_tpu.models import dcgan as jdcgan
from ganleaks_tpu.models import pggan as jpggan
from ganleaks_tpu.train import priv as jpriv
from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.attack.eval_roc import evaluate
from ganleaks_tpu_torch.attack.fbb import run_attack
from ganleaks_tpu_torch.cli import train_privdcgan, train_privpggan
from ganleaks_tpu_torch.config import (AttackConfig, DCGANConfig, EvalConfig,
                                       PGGANConfig, PrivGANConfig,
                                       expand_grid, sweep_tag)
from ganleaks_tpu_torch.io import native
from ganleaks_tpu_torch.models.dcgan import PrivateDiscriminator
from ganleaks_tpu_torch.models.pggan import Discriminator
from ganleaks_tpu_torch.train import priv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
LOSS_RTOL = 1e-4
STAT_ATOL = 1e-5
B = 4
DC = dict(nz=8, ngf=8, ndf=8, image_size=16, batch_size=B)
PG = dict(nz=16, in_channels=16, image_size=8, batch_sizes=(B, B))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _close(got, want, atol, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, -3)))


def _variables(ms):
    out = {"params": ms.params}
    if ms.batch_stats:
        out["batch_stats"] = ms.batch_stats
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_state(kind, n_splits, seed=0):
    pcfg = JPrivGANConfig(N_splits=n_splits)
    if kind == "dcgan":
        cfg = JDCGANConfig(**DC)
        return cfg, jpriv.build_privdcgan_state(cfg, pcfg,
                                                jax.random.key(seed))
    cfg = JPGGANConfig(**PG)
    return cfg, jpriv.build_privpggan_state(cfg, pcfg, jax.random.key(seed),
                                            1)


def _port_state(kind, jstate, cfg):
    genS, discS, pv = weights.privgan_from_jax_state(
        kind, _variables(jstate.genS), _variables(jstate.discS),
        _variables(jstate.priv))
    betas = (cfg.beta1, cfg.beta2) if kind == "dcgan" else (0.0, 0.99)
    return priv.privgan_state(genS, discS, pv, cfg.lr, *betas)


def _port_as_jax(state):
    return weights.privgan_to_jax_state(state.genS, state.discS, state.priv)


def _assert_state(port, jstate, lr, what):
    got = _port_as_jax(port)
    for name, g, ms in zip(("G", "D", "P"), got,
                           (jstate.genS, jstate.discS, jstate.priv)):
        want = _variables(ms)
        _close(g["params"], want["params"], lr / 10, f"{what} {name} params")
        if "batch_stats" in want:
            _close(g["batch_stats"], want["batch_stats"], STAT_ATOL,
                   f"{what} {name} stats")


def _draws(rng, kind, n_splits, nz):
    """The JAX step's own draws from ``rng`` (its split order)."""
    if kind == "dcgan":
        _, k_noise, k_lab = jax.random.split(rng, 3)
    else:
        _, k_noise, k_eps, k_lab = jax.random.split(rng, 4)
    out = {"noise": jax.random.normal(k_noise, (n_splits, B, nz),
                                      jnp.float32)}
    if kind == "pggan":
        out["eps"] = jax.random.uniform(k_eps, (n_splits, B, 1, 1, 1),
                                        jnp.float32)
    r = jax.random.randint(k_lab, (n_splits, B), 0, n_splits - 1)
    out["gen_y"] = r + (r >= jnp.arange(n_splits)[:, None])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


# ---------------------------------------------------------------------------
# helpers, config, models, weights
# ---------------------------------------------------------------------------

def test_softmax_cross_entropy_on_probs():
    """The JAX helper, torch's ``CrossEntropyLoss`` on softmax outputs (the
    reference's composition) and the port agree."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, 6)
    got = priv.softmax_cross_entropy_on_probs(torch.from_numpy(logits),
                                              torch.from_numpy(labels))
    ref = torch.nn.CrossEntropyLoss()(torch.softmax(
        torch.from_numpy(logits), 1), torch.from_numpy(labels))
    want = jpriv.softmax_cross_entropy_on_probs(jnp.asarray(logits),
                                                jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("n_splits", [2, 3])
def test_split_dataset(n_splits):
    imgs = np.random.default_rng(1).standard_normal(
        (12, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(priv.split_dataset(imgs, n_splits),
                                  jpriv.split_dataset(imgs, n_splits))
    with pytest.raises(ValueError, match="divide"):
        priv.split_dataset(imgs[:7], n_splits)


def test_grid_sweep_matches_jax():
    """``configs/privgan_grid.yaml`` expands to the JAX package's points
    in its order, with the same run tags, and each point applies to
    ``PrivGANConfig`` alike."""
    with open(os.path.join(REPO, "configs", "privgan_grid.yaml")) as f:
        grid = yaml.safe_load(f)
    got, want = list(expand_grid(grid)), list(j_expand_grid(grid))
    assert got == want and len(got) == 9
    assert [sweep_tag(p) for p in got] == [j_sweep_tag(p) for p in want]
    assert sweep_tag(got[0]) == ("privacy_ratio-N_splits", "0.1-2")
    assert list(expand_grid({"a": 1, "b": [2, 3]})) == [{"a": 1, "b": 2},
                                                       {"a": 1, "b": 3}]
    from ganleaks_tpu.config import apply_overrides as j_apply
    from ganleaks_tpu_torch.config import apply_overrides
    for p in got:
        assert vars(apply_overrides(PrivGANConfig(), p)) == \
            vars(j_apply(JPrivGANConfig(), p))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_private_discriminator_forward_matches_jax(train):
    """The DCGAN private classifier with 3 splits (randomised running
    statistics) and the PGGAN critic with ``n_outputs=3`` at steps 0 and
    1, alpha 0.5."""
    rng = np.random.default_rng(2)
    jd = jdcgan.PrivateDiscriminator(ndf=8, n_splits=3, image_size=16)
    v = jax.tree_util.tree_map(np.asarray, jd.init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=True))
    for path in _flat(v["batch_stats"]):
        *parents, leaf = path.split("/")
        node = v["batch_stats"]
        for p in parents:
            node = node[p]
        node[leaf] = (rng.uniform(-0.5, 0.5, node[leaf].shape)
                      if leaf == "mean" else
                      rng.uniform(0.5, 2.0, node[leaf].shape)
                      ).astype(np.float32)
    x = rng.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    port = weights.dcgan_from_jax_variables("private", v).train(train)
    assert isinstance(port, PrivateDiscriminator)
    assert port.disc[-1].weight.shape == (3, 16, 4, 4)
    if train:
        want, upd = jd.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want = jd.apply(v, jnp.asarray(x))
    got = port(_nchw(x))
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    if train:
        _close(weights.gan_to_jax_variables(port)["batch_stats"],
               upd["batch_stats"], STAT_ATOL, "stats")
    _close(weights.gan_to_jax_variables(
        weights.dcgan_from_jax_variables("private", v)), v, 0, "round trip")

    jc = jpggan.Discriminator(in_channels=16, n_outputs=3)
    cv = jpggan.init_progressive(jc, jax.random.key(1),
                                 jnp.zeros((1, 4, 4, 3)), 1)
    cv = jax.tree_util.tree_map(np.asarray, cv)
    critic = weights.pggan_from_jax_variables("critic", cv).train(train)
    assert isinstance(critic, Discriminator)
    for steps in (0, 1):
        res = 4 * 2 ** steps
        xs = rng.uniform(-1, 1, (4, res, res, 3)).astype(np.float32)
        want = jc.apply(cv, jnp.asarray(xs), steps, 0.5)
        with torch.no_grad():
            got = critic(_nchw(xs), steps, 0.5)
        assert got.shape == (4, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the default width keeps the one-score critic and its keys
    one = Discriminator(16, 3, 1)
    assert one.final_block[4].conv.weight.shape == (1, 16, 1, 1)
    assert set(one.state_dict()) == set(Discriminator(16, 3, 1,
                                                      3).state_dict())


@pytest.mark.parametrize("kind", ["dcgan", "pggan"])
@pytest.mark.parametrize("n_splits", [2, 3])
def test_weights_round_trip(kind, n_splits):
    """The stacked state carries into per-split modules and back bit for
    bit; each split's generator computes what the JAX package's slice
    computes."""
    _, jstate = _jax_state(kind, n_splits)
    got = weights.privgan_from_jax_state(
        kind, _variables(jstate.genS), _variables(jstate.discS),
        _variables(jstate.priv))
    assert len(got[0]) == len(got[1]) == n_splits
    back = weights.privgan_to_jax_state(*got)
    for g, ms in zip(back, (jstate.genS, jstate.discS, jstate.priv)):
        _close(g, _variables(ms), 0, f"{kind} round trip")
    z = np.random.default_rng(3).standard_normal((2, 8 if kind == "dcgan"
                                                  else 16)).astype(
                                                      np.float32)
    i = n_splits - 1
    gv = jax.tree_util.tree_map(lambda x: x[i], _variables(jstate.genS))
    with torch.no_grad():
        if kind == "dcgan":
            want = jdcgan.Generator(nz=8, ngf=8, image_size=16).apply(
                gv, jnp.asarray(z))
            out = got[0][i].eval()(torch.from_numpy(z))
        else:
            want = jpggan.Generator(16, 16).apply(gv, jnp.asarray(z), 1, 0.5)
            out = got[0][i](torch.from_numpy(z), 1, 0.5)
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1),
                               np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError):
        weights.privgan_from_jax_state("wgangp", {}, {}, {})


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_splits", [2, 3])
def test_privdcgan_steps_match_jax(n_splits):
    """Three all-splits steps, the first with the classifier's gate off,
    then on, with the JAX step's own draws: losses, every net's
    parameters and BatchNorm statistics (each generator's advanced twice a
    step, the classifier's only by its own update) after each step."""
    cfg, jstate = _jax_state("dcgan", n_splits)
    port = _port_state("dcgan", jstate, cfg)
    rng = np.random.default_rng(4)
    for i, dp_on in enumerate((False, True, True)):
        real = rng.uniform(-1, 1, (n_splits, B, 16, 16, 3)).astype(
            np.float32)
        key = jax.random.key(10 + i)
        d = _draws(key, "dcgan", n_splits, 8)
        jstate, jm = jpriv.privdcgan_train_step(
            jstate, jnp.asarray(real), key, 0.5, dp_on=dp_on)
        m = priv.privdcgan_train_step(port, _nchw(real), 0.5, dp_on,
                                      noise=d["noise"], gen_y=d["gen_y"])
        for k in ("loss_d", "loss_dp", "loss_g"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        assert (float(m["loss_dp"]) == 0.0) == (not dp_on)
        _assert_state(port, jstate, cfg.lr, f"step {i}")
    assert port.step == 3


def test_privdcgan_statistics_discipline():
    """Within one step each generator's running statistics advance twice
    (two train-mode forwards on the same noise before its update), and the
    generator step's train-mode classifier forwards leave its buffers bit
    for bit as they were; with the gate off the classifier does not move
    at all."""
    cfg = DCGANConfig(**DC)
    state = priv.build_privdcgan_state(cfg, PrivGANConfig(N_splits=2))
    gen = torch.Generator().manual_seed(0)
    real = torch.rand(2, B, 3, 16, 16, generator=gen) * 2 - 1
    noise = torch.randn(2, B, 8, generator=gen)
    twice = copy.deepcopy(state.genS[1])
    with torch.no_grad():
        twice(noise[1])
        twice(noise[1])
    before = copy.deepcopy(state.priv.state_dict())
    m = priv.privdcgan_train_step(state, real, 0.5, False, noise=noise,
                                  generator=gen)
    assert float(m["loss_dp"]) == 0.0
    for k, v in state.priv.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in twice.named_buffers():
        assert torch.equal(dict(state.genS[1].named_buffers())[k], v), k

    # gate on: the buffers are the update's alone
    flat = torch.cat([g(z).detach() for g, z in
                      zip(copy.deepcopy(state.genS), noise)])
    expect = copy.deepcopy(state.priv)
    with torch.no_grad():
        expect(flat)
    priv.privdcgan_train_step(state, real, 0.5, True, noise=noise,
                              generator=gen)
    for k, v in expect.named_buffers():
        assert torch.equal(dict(state.priv.named_buffers())[k], v), k


@pytest.mark.parametrize("steps", [0, 1])
def test_privpggan_steps_match_jax(steps):
    """Two float32 all-splits WGAN-GP steps at resolution ``steps`` with
    the fade-in at 0.5, the private critic's gate off then on, with the
    JAX step's own noise, eps and labels."""
    cfg, jstate = _jax_state("pggan", 2)
    port = _port_state("pggan", jstate, cfg)
    rng = np.random.default_rng(5 + steps)
    res = 4 * 2 ** steps
    for i, dp_on in enumerate((False, True)):
        real = rng.uniform(-1, 1, (2, B, res, res, 3)).astype(np.float32)
        key = jax.random.key(20 + i)
        d = _draws(key, "pggan", 2, 16)
        jstate, jm = jpriv.privpggan_train_step(
            jstate, jnp.asarray(real), jnp.float32(0.5), key, steps, 5.0,
            dp_on, cfg.lambda_gp, cfg.drift)
        m = priv.privpggan_train_step(
            port, _nchw(real), 0.5, steps, 5.0, dp_on, cfg.lambda_gp,
            cfg.drift, noise=d["noise"], eps=d["eps"], gen_y=d["gen_y"])
        for k in ("loss_critic", "loss_dp", "loss_gen"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        _assert_state(port, jstate, cfg.lr, f"steps {steps}, step {i}")


def test_pretrain_steps_match_jax():
    """The private classifier's pretrain steps on real images: privDCGAN's
    (train-mode BatchNorm) and privPGGAN's at 8 px, alpha 0.3."""
    rng = np.random.default_rng(6)
    labels = np.array([0, 1, 1, 0, 1, 0])
    cfg, jstate = _jax_state("dcgan", 2)
    port = _port_state("dcgan", jstate, cfg)
    for _ in range(2):
        x = rng.uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
        jp, jl = jpriv.priv_pretrain_step(jstate.priv, jnp.asarray(x),
                                          jnp.asarray(labels))
        jstate = jstate.replace(priv=jp)
        loss = priv.priv_pretrain_step(port, _nchw(x),
                                       torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _assert_state(port, jstate, cfg.lr, "dcgan pretrain")
    cfg, jstate = _jax_state("pggan", 2)
    port = _port_state("pggan", jstate, cfg)
    x = rng.uniform(-1, 1, (6, 8, 8, 3)).astype(np.float32)
    jp, jl = jpriv._privpggan_pretrain_step(
        jstate.priv, jnp.asarray(x), jnp.asarray(labels), jnp.float32(0.3),
        1)
    loss = priv._privpggan_pretrain_step(port, _nchw(x),
                                         torch.from_numpy(labels), 0.3, 1)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _assert_state(port, jstate.replace(priv=jp), cfg.lr, "pggan pretrain")


# ---------------------------------------------------------------------------
# loops, artifacts, entry points
# ---------------------------------------------------------------------------

def _record(calls, name, ret):
    def rec(*args, **kw):
        calls.append((name, args, kw))
        return ret(args)
    return rec


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_splits", [2, 3])
def test_privdcgan_schedule_matches_jax(monkeypatch, n_splits):
    """The pretrain's batches (the last one short) and labels, each epoch's
    per-split batches (remainders dropped) and the ``epoch > dp_delay``
    gate are the JAX loop's bit for bit."""
    images = np.random.default_rng(7).uniform(-1, 1, (12, 16, 16, 3)).astype(
        np.float32)
    kw = dict(DC, num_epochs=3)
    pkw = dict(N_splits=n_splits, dp_delay=1, disc_epochs=2)
    jcalls, calls = [], []
    monkeypatch.setattr(jpriv, "priv_pretrain_step", _record(
        jcalls, "pre", lambda a: (a[0], 0.0)))
    monkeypatch.setattr(jpriv, "privdcgan_train_step", _record(
        jcalls, "step", lambda a: (a[0], {"loss_d": 0.0})))
    jpriv.train_privdcgan(JDCGANConfig(**kw), JPrivGANConfig(**pkw),
                          images=images)
    monkeypatch.setattr(priv, "priv_pretrain_step", _record(
        calls, "pre", lambda a: 0.0))
    monkeypatch.setattr(priv, "privdcgan_train_step", _record(
        calls, "step", lambda a: {"loss_d": 0.0}))
    priv.train_privdcgan(DCGANConfig(**kw), PrivGANConfig(**pkw),
                         images=images, device="cpu")
    assert [c[0] for c in calls] == [c[0] for c in jcalls]
    t = 12 // n_splits
    assert sum(c[0] == "step" for c in calls) == 3 * (t // min(B, t))
    for (name, args, kw_), (_, jargs, jkw) in zip(calls, jcalls):
        if name == "pre":
            np.testing.assert_array_equal(_arr(args[1]),
                                          np.moveaxis(_arr(jargs[1]), -1, 1))
            np.testing.assert_array_equal(_arr(args[2]), _arr(jargs[2]))
        else:
            np.testing.assert_array_equal(_arr(args[1]),
                                          np.moveaxis(_arr(jargs[1]), -1, 2))
            assert args[2] == jargs[3] and args[3] == jkw["dp_on"]
    assert [c[1][3] for c in calls if c[0] == "step"] == \
        [e > 1 for e in range(3) for _ in range(t // min(B, t))]


def test_privpggan_schedule_matches_jax(monkeypatch):
    """The private critic's pretrain at every resolution (uncapped batch,
    the fade-in ramp by each batch's length) and the progressive loop's
    batches (capped at T, remainders dropped), fade-ins, resolutions and
    ``4 * 2**steps >= dp_delay`` gate are the JAX loop's bit for bit."""
    images = np.random.default_rng(8).uniform(-1, 1, (10, 8, 8, 3)).astype(
        np.float32)
    kw = dict(PG, batch_sizes=(4, 6), num_epochs=2, hflip=False)
    pkw = dict(N_splits=2, dp_delay=8, disc_epochs=2)
    jcalls, calls = [], []
    monkeypatch.setattr(jpriv, "_privpggan_pretrain_step", _record(
        jcalls, "pre", lambda a: (a[0], 0.0)))
    monkeypatch.setattr(jpriv, "privpggan_train_step", _record(
        jcalls, "step", lambda a: (a[0], {"loss_gen": 0.0})))
    jpriv.train_privpggan(JPGGANConfig(**kw), JPrivGANConfig(**pkw),
                          images=images)
    monkeypatch.setattr(priv, "_privpggan_pretrain_step", _record(
        calls, "pre", lambda a: 0.0))
    monkeypatch.setattr(priv, "privpggan_train_step", _record(
        calls, "step", lambda a: {"loss_gen": 0.0}))
    priv.train_privpggan(PGGANConfig(**kw), PrivGANConfig(**pkw),
                         images=images, device="cpu")
    assert [c[0] for c in calls] == [c[0] for c in jcalls]
    # pretrain: 2 epochs of batches 4,4,2 (4 px) and 6,4 (8 px); loop:
    # 2 epochs of one batch of 4 (4 px) and of 5 (8 px)
    assert [len(_arr(c[1][1])) for c in calls] == \
        [4, 4, 2, 4, 4, 2, 6, 4, 6, 4, 2, 2, 2, 2]
    for (name, args, _), (_, jargs, _) in zip(calls, jcalls):
        if name == "pre":
            np.testing.assert_array_equal(_arr(args[1]),
                                          np.moveaxis(_arr(jargs[1]), -1, 1))
            np.testing.assert_array_equal(_arr(args[2]), _arr(jargs[2]))
            assert np.float32(args[3]) == np.float32(jargs[3])
            assert args[4] == jargs[4]
        else:
            np.testing.assert_array_equal(_arr(args[1]),
                                          np.moveaxis(_arr(jargs[1]), -1, 2))
            assert np.float32(args[2]) == np.float32(jargs[2])
            assert args[3] == jargs[4] and args[5] == jargs[6]
            assert args[4] == jargs[5] == 0.5
    assert [(c[1][3], c[1][5]) for c in calls if c[0] == "step"] == \
        [(0, False)] * 2 + [(1, True)] * 2


def test_privpggan_flips_per_split_and_image(monkeypatch):
    """With ``hflip`` each (split, image) of a batch is mirrored by its own
    draw: the recorded batch is the unflipped one mirrored where the mask
    the loop drew says so."""
    images = np.random.default_rng(9).uniform(-1, 1, (16, 8, 8, 3)).astype(
        np.float32)
    cfg = PGGANConfig(**dict(PG, start_img_size=8, num_epochs=1,
                             batch_sizes=(8, 8)))
    seen = {}
    for hflip in (False, True):
        calls = []
        monkeypatch.setattr(priv, "privpggan_train_step", _record(
            calls, "step", lambda a: {}))
        priv.train_privpggan(replace(cfg, hflip=hflip),
                             PrivGANConfig(N_splits=2, disc_epochs=0),
                             images=images, device="cpu")
        seen[hflip] = _arr(calls[0][1][1])
    flip = (torch.rand(16, generator=torch.Generator().manual_seed(
        cfg.seed + 1)) < 0.5).numpy().reshape(2, 8)
    assert 0 < flip.sum() < 16
    want = np.where(flip[..., None, None, None], seen[False][..., ::-1],
                    seen[False])
    np.testing.assert_array_equal(seen[True], want)


@pytest.mark.parametrize("kind", ["dcgan", "pggan"])
def test_artifact_paths_match_jax(tmp_path, kind):
    """Split 0's samples land where the JAX package writes them:
    ``privDCGAN`` / ``privPGGAN`` roots, ``dcgan_`` / ``pggan_`` file
    names, the run directory, and as many PNGs."""
    n = 5
    if kind == "dcgan":
        # the JAX sampler builds the generator at the default 64 px
        # whatever image_size says, so both run at 64 px here
        kw = dict(DC, image_size=64, num_generated=n)
        jcfg = JDCGANConfig(**kw, PATH_syn_data=str(tmp_path / "jax"))
        cfg = DCGANConfig(**kw, PATH_syn_data=str(tmp_path / "port"))
        jst = jpriv.build_privdcgan_state(jcfg, JPrivGANConfig(),
                                          jax.random.key(0))
        want = jpriv.generate_privdcgan(jcfg, JPrivGANConfig(), jst, "r/1")
        state = priv.build_privdcgan_state(cfg, PrivGANConfig())
        got = priv.generate_privdcgan(cfg, PrivGANConfig(), state, "r/1",
                                      device="cpu")
    else:
        jcfg = JPGGANConfig(**PG, num_generated=n,
                            PATH_syn_data=str(tmp_path / "jax"))
        cfg = PGGANConfig(**PG, num_generated=n,
                          PATH_syn_data=str(tmp_path / "port"))
        jst = jpriv.build_privpggan_state(jcfg, JPrivGANConfig(),
                                          jax.random.key(0), 1)
        want = jpriv.generate_privpggan(jcfg, JPrivGANConfig(), jst, "r/1")
        state = priv.build_privpggan_state(cfg, PrivGANConfig())
        got = priv.generate_privpggan(cfg, PrivGANConfig(), state, "r/1",
                                      device="cpu")
    assert sorted(got) == sorted(want)
    for sub in want:
        assert os.path.relpath(got[sub], tmp_path / "port") == \
            os.path.relpath(want[sub], tmp_path / "jax")
        assert sorted(os.listdir(got[sub])) == sorted(os.listdir(want[sub]))
    fake = np.load(os.path.join(got["npz_images"],
                                f"{kind}_synthetic_data.npz"))["fake"]
    res = cfg.image_size
    assert fake.shape == (n, 3, res, res) and np.isfinite(fake).all()
    assert len(os.listdir(got["png_images"])) == n


def _png_dir(path, rng, n, res):
    path.mkdir()
    native.save_png_batch_native(
        rng.integers(0, 256, (n, res, res, 3), np.uint8),
        [str(path / f"{i:03d}.png") for i in range(n)])
    return str(path)


def test_train_sample_attack_pipeline(tmp_path, monkeypatch):
    """privDCGAN end to end on the CPU: train on a PNG directory (2
    splits, the gate opening in the second epoch), sample split 0's
    generator to the PNG + npz + noise triplet, attack the PNG dump with
    members planted, score; privPGGAN trains 4 -> 8 px and samples."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(10)
    train_dir = _png_dir(tmp_path / "train", rng, 16, 16)
    test_dir = _png_dir(tmp_path / "test", rng, 16, 16)
    cfg = DCGANConfig(**{**DC, "batch_size": 8}, data_path=train_dir,
                      num_epochs=2, num_generated=24,
                      PATH_syn_data=str(tmp_path / "syn"))
    pcfg = PrivGANConfig(N_splits=2, dp_delay=0, disc_epochs=1)
    from ganleaks_tpu_torch.utils.logging import MetricsLogger
    log = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(log, echo=False)
    state = priv.train_privdcgan(cfg, pcfg, logger=logger, device="cpu")
    logger.close()
    assert state.step == 2
    import json
    with open(log) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["loss_dp"] == 0.0 for r in recs] == [True, False]
    dirs = priv.generate_privdcgan(cfg, pcfg, state, run_dir="r",
                                   device="cpu")
    png = dirs["png_images"]
    assert len(os.listdir(png)) == 24
    members = native.load_image_dir_native(train_dir, 16, dtype=np.uint8)
    native.save_png_batch_native(
        members[:4], [os.path.join(png, f"image_{100 + i}.png")
                      for i in range(4)])
    out = run_attack(AttackConfig(
        syn_data_path=png, pos_data_dir=train_dir, neg_data_dir=test_dir,
        resolution=16, distance="l2", save_plots=False), device="cpu")[0]
    assert (np.abs(np.sort(out["pos_loss"])[:4]) < 1e-5).all()
    res = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
    assert 0.5 < res["auc"] <= 1.0
    pg = PGGANConfig(**PG, data_path=_png_dir(tmp_path / "t8", rng, 8, 8),
                     num_epochs=1, num_generated=6,
                     PATH_syn_data=str(tmp_path / "syn"))
    pst = priv.train_privpggan(pg, PrivGANConfig(N_splits=2, dp_delay=4,
                                                 disc_epochs=1),
                               device="cpu")
    assert pst.step == 2
    fake = np.load(os.path.join(priv.generate_privpggan(
        pg, PrivGANConfig(), pst, device="cpu")["npz_images"],
        "pggan_synthetic_data.npz"))["fake"]
    assert fake.shape == (6, 3, 8, 8) and np.isfinite(fake).all()


def test_clis_run_a_grid(tmp_path, monkeypatch):
    """Both CLIs through ``main(argv, device="cpu")``: ``key=value``
    overrides split between the model config and ``PrivGANConfig``, and
    ``--grid`` over two points writes one synthetic set per point under
    ``<keys>/<values>``; an unknown key raises."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(11)
    d16 = _png_dir(tmp_path / "t16", rng, 8, 16)
    d8 = _png_dir(tmp_path / "t8", rng, 8, 8)
    grid = tmp_path / "grid.yaml"
    grid.write_text("privacy_ratio: [0.1, 5]\nN_splits: [2]\n")
    train_privdcgan.main(
        ["--grid", str(grid), f"data_path={d16}", "image_size=16", "nz=8",
         "ngf=8", "ndf=8", "batch_size=4", "num_epochs=1",
         "num_generated=3", "disc_epochs=1", "dp_delay=0"], device="cpu")
    root = tmp_path / "syn_data" / "privDCGAN" / "png_images"
    assert sorted(os.listdir(root / "privacy_ratio-N_splits")) == \
        ["0.1-2", "5-2"]
    assert len(os.listdir(root / "privacy_ratio-N_splits" / "5-2")) == 3
    train_privpggan.main(
        ["--grid", str(grid), f"data_path={d8}", "image_size=8", "nz=8",
         "in_channels=8", "batch_sizes=[2]", "num_epochs=1",
         "num_generated=2", "disc_epochs=1", "N_splits=2"], device="cpu")
    root = tmp_path / "syn_data" / "privPGGAN" / "npz_images"
    assert sorted(os.listdir(root / "privacy_ratio-N_splits")) == \
        ["0.1-2", "5-2"]
    train_privdcgan.main([f"data_path={d16}", "image_size=16", "nz=8",
                          "ngf=8", "ndf=8", "num_epochs=0",
                          "num_generated=2", "disc_epochs=0",
                          "PATH_syn_data=single"], device="cpu")
    (stamp,) = os.listdir(tmp_path / "single" / "privDCGAN" / "png_images")
    assert len(os.listdir(tmp_path / "single" / "privDCGAN" / "png_images"
                          / stamp)) == 2
    with pytest.raises(KeyError, match="no_such_key"):
        train_privdcgan.main(["no_such_key=1"], device="cpu")
