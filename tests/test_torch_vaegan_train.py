"""The port's VAE-GAN trainer (``ganleaks_tpu_torch.models.vaegan``'s four
nets in training, ``train.vaegan``, ``cli.train_vaegan``, the VAE-GAN
part of ``weights``) against the JAX package on the CPU, at d 8, z_dim
16, 64 px, batch 4.

Weights come from the JAX trainer's own ``build_state`` and are carried
into the port by ``weights.vaegan_from_jax_variables``; the step is handed
the JAX step's own draws, made from the keys it splits.

Tolerances are ``tests/test_torch_victims.py``'s: forwards atol 2e-5,
losses rtol 1e-4, BatchNorm statistics and spectral-norm vectors atol
1e-5, parameters after one Adam step within a tenth of the net's lr (the
first Adam step is ~lr * sign(g), so a disagreement would show as ~lr).
One class of elements is held apart: those whose gradient is at
float32's noise floor, below 1e-5 of its net's largest (the conv and
transposed-conv biases ahead of a train-mode BatchNorm, whose exact
gradient is 0, and a few isolated weights); there Adam turns rounding
noise into a step of up to lr of either sign in either package, so those
beyond lr / 10 are held to the first step's bound, 2 lr, and must be
under 1% of every net (seen: 0.09% of the encoder's). Image reading and
the resumed run are held bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from ganleaks_tpu.config import VAEGANConfig as JVAEGANConfig
from ganleaks_tpu.models import vaegan as jm
from ganleaks_tpu.tools import convert_victim
from ganleaks_tpu.train import vaegan as jv
from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.attack.eval_roc import evaluate
from ganleaks_tpu_torch.attack.reconstruction import \
    run_reconstruction_attack
from ganleaks_tpu_torch.cli import train_vaegan as cli
from ganleaks_tpu_torch.config import (EvalConfig, ReconstructionConfig,
                                       VAEGANConfig)
from ganleaks_tpu_torch.io import native
from ganleaks_tpu_torch.models.vaegan import (Discriminator, DiscriminatorL,
                                              Encoder, Generator)
from ganleaks_tpu_torch.train import vaegan
from ganleaks_tpu_torch.train.state import adam_torch
from ganleaks_tpu_torch.utils.checkpoint import load_state_dict

ATOL = 2e-5
LOSS_RTOL = 1e-4
STAT_ATOL = 1e-5
Z, D, B = 16, 8, 4
KINDS = {"enc": "encoder", "gen": "generator", "disc": "discriminator",
         "disc_l": "discriminator_l"}
LRS = {"enc": 1e-4, "gen": 1e-4, "disc": 4e-4, "disc_l": 2e-4}


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


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _variables(ms):
    return jax.tree_util.tree_map(np.asarray, {
        "params": ms.params, "batch_stats": ms.batch_stats,
        **dict(ms.extra)})


@pytest.fixture(scope="module")
def jax_state():
    return jv.build_state(JVAEGANConfig(z_dim=Z, d=D, batch_size=B),
                          jax.random.key(0))


def _port_state(jstate):
    nets = {k: weights.vaegan_from_jax_variables(
        kind, _variables(getattr(jstate, k))).train()
        for k, kind in KINDS.items()}
    opts = [adam_torch(nets[k].parameters(), LRS[k], 0.0, 0.9)
            for k in KINDS]
    return vaegan.VAEGANState(*nets.values(), *opts)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("train", [False, True])
def test_vaegan_nets_forward_match_jax(jax_state, kind, train):
    """Every net in eval and train mode: outputs, and in training the
    advanced BatchNorm statistics and spectral-norm vectors."""
    variables = _variables(getattr(jax_state, kind))
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    z = rng.standard_normal((B, Z)).astype(np.float32)
    jmod = {"enc": jm.Encoder(Z, D), "gen": jm.Generator(Z, D),
            "disc": jm.Discriminator(D), "disc_l": jm.DiscriminatorL()}[kind]
    key = jax.random.key(2)
    eps = np.asarray(jax.random.normal(key, (B, Z)))
    args = {"enc": (img, key), "gen": (z,), "disc": (img,),
            "disc_l": (z,)}[kind]
    kw = {"train": train} if kind in ("enc", "gen") else {}
    mutable = [c for c in ("batch_stats", "spectral") if c in variables]
    if train and mutable:
        want, upd = jmod.apply(variables, *map(jnp.asarray, args),
                               mutable=mutable, **kw)
    else:
        want, upd = jmod.apply(variables, *map(jnp.asarray, args), **kw), {}
    port = weights.vaegan_from_jax_variables(KINDS[kind], variables)
    port.train(train)
    with torch.no_grad():
        if kind == "enc":
            got = port(_nchw(img), eps=torch.from_numpy(eps))
        elif kind in ("gen", "disc_l"):
            got = port(torch.from_numpy(z))
        else:
            got = port(_nchw(img))
    got = got.numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1) if got.ndim == 4
                               else got, np.asarray(want), atol=ATOL)
    dumped = weights.vaegan_to_jax_variables(port)
    for coll in (c for c in upd if _flat(upd[c])):
        g, w = _flat(dumped[coll]), _flat(upd[coll])
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=STAT_ATOL,
                                       err_msg=f"{coll}/{k}")
    if not train:   # evaluation leaves every buffer as it was
        _assert_same(_flat(dumped), _flat(variables))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _draws(key):
    _, k_enc, k_noise, kd1, kd2, k_genc = jax.random.split(key, 6)

    def n(k):
        return torch.from_numpy(np.asarray(jax.random.normal(k, (B, Z))))

    return {"eps_dl": n(k_enc), "noise_dl": n(k_noise),
            "noise_d": [n(kd1), n(kd2)], "eps_g": n(k_genc)}


def _check_step(port_net, kind, jax_ms, init_vars, lr):
    """Against the JAX step's net: buffers (BatchNorm statistics,
    spectral-norm vectors) within STAT_ATOL; parameters within lr / 10,
    but for elements at the gradient's noise floor, which stay within
    2 lr (and number under 1% of the net); the net moved by about one
    Adam step per update (the median step over its elements above the
    floor at least 0.9 lr and at most Adam's bound)."""
    want = weights.vaegan_from_jax_variables(KINDS[kind], _variables(jax_ms))
    init = weights.vaegan_from_jax_variables(KINDS[kind], init_vars)
    for (name, b), w in zip(port_net.named_buffers(), want.buffers()):
        np.testing.assert_allclose(b.numpy(), w.numpy(), atol=STAT_ATOL,
                                   err_msg=f"{kind} {name}")
    exempt, steps = 0, []
    g_max = max(float(p.grad.abs().max()) for p in port_net.parameters())
    for (name, p), w, p0 in zip(port_net.named_parameters(),
                                want.parameters(), init.parameters()):
        diff = (p - w).abs().detach()
        noise = p.grad.abs() <= 1e-5 * g_max
        off = diff > lr / 10
        assert not (off & ~noise).any(), \
            f"{kind} {name}: {float(diff[~noise].max()) / lr:.3g} lr"
        assert float(diff.max()) <= 2 * lr, f"{kind} {name}"
        exempt += int(off.sum())
        steps.append((w - p0).abs()[~noise].detach().reshape(-1))
    n = sum(p.numel() for p in port_net.parameters())
    assert exempt <= 0.01 * n, f"{kind}: {exempt} of {n} beyond lr / 10"
    # D takes two Adam steps an iteration; the second, at betas (0,
    # 0.9), moves at most sqrt(0.19 / 0.1) = 1.38 lr
    median = float(torch.cat(steps).median())
    most = 1.0 + (1.38 if kind == "disc" else 0.0)
    assert 0.9 * lr <= median <= most * lr * (1 + 1e-6), (kind, median / lr)


def test_vaegan_step_matches_jax(jax_state):
    """One iteration (Dl, D twice, G + E) from the JAX init with the JAX
    step's draws: the three losses, then every net's parameters,
    BatchNorm statistics and spectral-norm vectors."""
    init = {k: _variables(getattr(jax_state, k)) for k in KINDS}
    port = _port_state(jax_state)
    rng = np.random.default_rng(3)
    reals = [rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
             for _ in range(4)]
    key = jax.random.key(4)
    jstate, jmet = jv.vaegan_train_step(
        jv.build_state(JVAEGANConfig(z_dim=Z, d=D, batch_size=B),
                       jax.random.key(0)), *map(jnp.asarray, reals), key)
    met = vaegan.vaegan_train_step(port, *map(_nchw, reals),
                                   draws=_draws(key))
    for k in ("loss_dl", "loss_d", "loss_g"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for kind in KINDS:
        _check_step(getattr(port, kind), kind, getattr(jstate, kind),
                    init[kind], LRS[kind])
    assert port.step == 1


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_matches_the_jax_custom_vjp_at_saturation(target):
    """``F.binary_cross_entropy`` against the JAX package's ``bce``
    (``train/vaegan.py:77-109``): the log clamped at -100 forward and the
    denominator clamped at 1e-12 backward, so probabilities of exactly 0
    and 1 give finite values and gradients. (Normal floats only: XLA's
    CPU backend flushes denormals to zero, torch does not.)"""
    p = np.array([0.0, 1e-37, 1e-30, 1e-7, 0.3, 0.5, 1 - 1e-7, 1.0],
                 np.float32)
    want, g_want = jax.value_and_grad(jv.bce)(jnp.asarray(p), target)
    pt = torch.from_numpy(p).requires_grad_(True)
    got = vaegan.bce(pt, target)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(g_want),
                               rtol=1e-5)
    assert np.isfinite(pt.grad.numpy()).all()
    assert np.abs(pt.grad.numpy()).max() > 1e10   # the clamped end


# ---------------------------------------------------------------------------
# data, schedule, resume
# ---------------------------------------------------------------------------

def _write_pngs(d, n, rng, size=64):
    os.makedirs(d, exist_ok=True)
    native.save_png_batch_native(
        rng.integers(0, 256, (n, size, size, 3), np.uint8),
        [os.path.join(d, f"{i:03d}.png") for i in range(n)])


def test_dataset_reads_like_the_jax_dataset(tmp_path):
    """``VaeganImageDataset.from_dir``: the resize-variant reader (the
    float64 ``2 * (x / 255) - 1`` through the codec's LUT, Pillow's
    default resize for another size), bit for bit the JAX dataset's."""
    rng = np.random.default_rng(5)
    _write_pngs(str(tmp_path), 5, rng)
    PIL.Image.fromarray(rng.integers(0, 256, (50, 70, 3), np.uint8)).save(
        tmp_path / "odd.png")
    got = vaegan.VaeganImageDataset.from_dir(str(tmp_path), 64, seed=1)
    want = jv.VaeganImageDataset.from_dir(str(tmp_path), 64, seed=1)
    np.testing.assert_array_equal(got.images.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want.images))


def _record(monkeypatch, module, name, sink, batch_args):
    def step(state, *args, **kw):
        sink.append([np.asarray(a) for a in args[:batch_args]])
        if hasattr(state, "step") and isinstance(state.step, int):
            state.step += 1
            return {}
        return state, {}
    monkeypatch.setattr(module, name, step)


def test_batch_schedule_and_resume_match_jax(tmp_path, monkeypatch):
    """With both steps replaced by recorders, the port's loop hands its
    step the JAX loop's batches (four an iteration, drop_last, the
    forever iterator), and a run resumed after epoch 1 hands it the
    uninterrupted run's remaining ones."""
    monkeypatch.chdir(tmp_path)
    images = np.random.default_rng(6).uniform(
        -1, 1, (10, 64, 64, 3)).astype(np.float32)
    kw = dict(z_dim=Z, d=D, batch_size=3, nepoch=3, steps_per_epoch=2,
              checkpoint_every=1)
    got, want = [], []
    _record(monkeypatch, vaegan, "vaegan_train_step", got, 4)
    _record(monkeypatch, jv, "vaegan_train_step", want, 4)
    vaegan.train(VAEGANConfig(exp_name="p", **kw), images, device="cpu")
    jv.train(JVAEGANConfig(exp_name="j", **kw), images)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.transpose(0, 2, 3, 1), b)
    resumed = []
    _record(monkeypatch, vaegan, "vaegan_train_step", resumed, 4)
    vaegan.train(VAEGANConfig(exp_name="r", **{**kw, "nepoch": 1}), images,
                 device="cpu")
    vaegan.train(VAEGANConfig(exp_name="r", **kw), images, device="cpu")
    assert len(resumed) == 2 + 4
    for g, w in zip(resumed[2:], got[2:]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_resumed_run_is_bit_exact(tmp_path, monkeypatch):
    """Two epochs in one run against one epoch, then a resume from its
    checkpoint for the second: every parameter, statistic and vector of
    the four nets equal bit for bit (the draw generator's state rides in
    the checkpoint)."""
    monkeypatch.chdir(tmp_path)
    images = np.random.default_rng(7).uniform(
        -1, 1, (8, 64, 64, 3)).astype(np.float32)
    kw = dict(z_dim=Z, d=D, batch_size=2, steps_per_epoch=1,
              checkpoint_every=5)
    full = vaegan.train(VAEGANConfig(exp_name="a", nepoch=2, **kw), images,
                        device="cpu")
    vaegan.train(VAEGANConfig(exp_name="b", nepoch=1, **kw), images,
                 device="cpu")
    resumed = vaegan.train(VAEGANConfig(exp_name="b", nepoch=2, **kw),
                           images, device="cpu")
    assert full.step == resumed.step == 2 and resumed.epoch == 2
    for kind in KINDS:
        a = getattr(full, kind).state_dict()
        b = getattr(resumed, kind).state_dict()
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (kind, k)


# ---------------------------------------------------------------------------
# reference checkpoints, artifacts, end to end
# ---------------------------------------------------------------------------

def _reference_state_dict(model, rng):
    """Random values under the port's keys, which are the reference's."""
    return {k: torch.from_numpy(rng.normal(0, 0.3, tuple(v.shape)).astype(
        np.float32)) + (1.0 if "running_var" in k else 0.0)
        for k, v in model.state_dict().items()}


def test_reference_state_dicts_load_by_name():
    """netG / netE state dicts in the reference's layout
    (``deconv{i}.module.weight_bar`` / ``weight_u`` / ``weight_v``,
    ``fc1.weight``; ``tools/convert_victim.py:200-265``) load into the
    port's modules by name and compute what the JAX modules compute on
    the converted checkpoint; both discriminators' keys are the reference
    wrapper's too."""
    rng = np.random.default_rng(8)
    sd_g = _reference_state_dict(Generator(Z, D), rng)
    sd_e = _reference_state_dict(Encoder(Z, D), rng)
    assert "deconv1.module.weight_bar" in sd_g and "fc1.weight" in sd_e
    sd_g["deconv1.module.weight_u"] /= sd_g["deconv1.module.weight_u"].norm()
    gen = load_state_dict(Generator(Z, D), sd_g).eval()
    enc = load_state_dict(Encoder(Z, D), {
        **sd_e, "bn1.num_batches_tracked": torch.tensor(3)}).eval()
    z = rng.standard_normal((3, Z)).astype(np.float32)
    img = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    want_g = jm.Generator(Z, D).apply(
        convert_victim.convert_vaegan_generator(_numpy(sd_g)), z)
    np.testing.assert_allclose(
        gen(torch.from_numpy(z)).detach().numpy().transpose(0, 2, 3, 1),
        np.asarray(want_g), atol=1e-4)
    want_mu, _ = jm.Encoder(Z, D).apply(
        convert_victim.convert_vaegan_encoder(_numpy(sd_e)), jnp.asarray(img),
        False, method=jm.Encoder.encode)
    np.testing.assert_allclose(enc.encode(_nchw(img))[0].detach().numpy(),
                               np.asarray(want_mu), atol=1e-4)
    keys = set(Discriminator(D).state_dict())
    assert {"conv1.module.weight_bar", "conv5.module.weight_v",
            "sa1.gamma", "fc.module.weight_u"} <= keys
    assert set(DiscriminatorL(Z).state_dict()) == {
        f"fc{i}.{p}" for i in (1, 2, 3) for p in ("weight", "bias")}


def test_train_sample_and_reconstruction_attack(tmp_path, monkeypatch):
    """The pipeline on the CPU: the CLI trains on a PNG directory (two
    epochs, a checkpoint, ``netE.npz`` / ``netG.npz``) and samples;
    ``generated.npz`` and the grid have the reference's schema; the port's
    reconstruction attack reads the trained nets and scores members and
    non-members; ``evaluate`` reads the run."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(9)
    _write_pngs("train", 8, rng)
    _write_pngs("test", 8, rng)
    cli.main(["data_path=train", f"z_dim={Z}", f"d={D}", "batch_size=4",
              "nepoch=2", "steps_per_epoch=1", "num_samples=12",
              "exp_name=v"], device="cpu")
    run = tmp_path / "results" / "v"
    assert {"checkpoint.pth", "netG.npz", "netE.npz",
            "metrics.jsonl"} <= set(os.listdir(run))
    gen = np.load(run / "samples" / "generated.npz")
    assert sorted(gen.files) == ["img_r01", "noise"]
    assert gen["noise"].shape == (12, Z) and gen["noise"].dtype == np.float32
    imgs = gen["img_r01"]
    assert imgs.shape == (12, 64, 64, 3) and imgs.dtype == np.float32
    assert 0.0 <= imgs.min() and imgs.max() <= 1.0
    grid = native.decode_png(str(run / "samples" / "samples.png"))
    assert grid.shape == (640, 640, 3)
    out = run_reconstruction_attack(ReconstructionConfig(
        pos_data_dir="train", neg_data_dir="test",
        netE=str(run / "netE.npz"), netG=str(run / "netG.npz"), z_dim=Z,
        d=D, batch=4, distance="l2", save_plots=False), device="cpu")
    assert out["pos_loss"].shape == (8,) and np.isfinite(
        out["pos_loss"]).all()
    assert 0.0 <= evaluate(EvalConfig(
        result_load_dir=out["save_dir"]))["auc"] <= 1.0
    # training=false samples the saved netG.npz
    cli.main([f"z_dim={Z}", f"d={D}", "training=false", "num_samples=4",
              "exp_name=v"], device="cpu")
    assert np.load(run / "samples" / "generated.npz")["noise"].shape == (4, Z)
