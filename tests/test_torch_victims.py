"""The port's DCGAN and WGAN-GP victims (``ganleaks_tpu_torch.ops.nn``,
``models.dcgan``, ``models.wgangp``, ``io.data``, ``train.*``,
``weights`` and ``utils.checkpoint``) against the JAX package on the CPU,
at small sizes: DCGAN at 16 px with nz 8 and ngf / ndf 8, WGAN-GP at its
fixed 64 px with nz 8 and ngf / ndf 8, batches of 4-8.

Weights come from the JAX trainers' own ``build_state`` (BatchNorm
running statistics randomised where eval mode is checked) and are carried
into the port by ``weights.dcgan_from_jax_variables`` /
``wgangp_from_jax_variables``. The port cannot draw ``jax.random``'s
numbers, so each step is handed the JAX step's own noise and eps, made
from the same keys the JAX step splits.

Tolerances: forwards are float32 against float32 with sums in different
orders (XLA's convolutions and E[x^2] - mean^2 BatchNorm variance against
torch's), observed ~1e-6 on O(1) values: held to atol 2e-5. Losses: rtol
1e-4 (WGAN-GP's penalty differentiates twice). Parameters after one Adam
step: atol a tenth of the learning rate — the first Adam step moves a
parameter by lr * g / (|g| + 1e-8) ~ lr * sign(g), so a disagreement
would show as ~lr, while a gradient at float32's noise floor (seen: one
WGAN-GP generator weight of 131,072, 1.6% of lr off) moves less.
BatchNorm running statistics: atol 1e-5. Image readers and artifacts:
bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from ganleaks_tpu.config import DCGANConfig as JDCGANConfig
from ganleaks_tpu.config import WGANGPConfig as JWGANGPConfig
from ganleaks_tpu.io.artifacts import \
    write_synthetic_artifacts as j_write_artifacts
from ganleaks_tpu.io.data import epoch_batch_indices as j_epoch_batches
from ganleaks_tpu.io.data import load_train_images as j_load_train_images
from ganleaks_tpu.models.dcgan import Discriminator as JDiscriminator
from ganleaks_tpu.models.dcgan import Generator as JGenerator
from ganleaks_tpu.models.wgangp import Critic as JCritic
from ganleaks_tpu.ops import nn as jnn
from ganleaks_tpu.tools import convert_victim
from ganleaks_tpu.train import dcgan as j_dcgan
from ganleaks_tpu.train import wgangp as j_wgangp
from ganleaks_tpu.train.gan import dcgan_train_step as j_dcgan_step
from ganleaks_tpu.utils.logging import tile_image_grid as j_tile_grid
from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.attack.eval_roc import evaluate
from ganleaks_tpu_torch.attack.fbb import run_attack
from ganleaks_tpu_torch.config import (AttackConfig, DCGANConfig,
                                       EvalConfig, WGANGPConfig)
from ganleaks_tpu_torch.io import native
from ganleaks_tpu_torch.io.artifacts import write_synthetic_artifacts
from ganleaks_tpu_torch.io.data import (DeviceDataset, epoch_batch_indices,
                                        load_train_images)
from ganleaks_tpu_torch.models.dcgan import Discriminator, Generator
from ganleaks_tpu_torch.models.wgangp import Critic
from ganleaks_tpu_torch.ops.nn import BatchNormTorch, InstanceNorm2d
from ganleaks_tpu_torch.train import dcgan, wgangp
from ganleaks_tpu_torch.train.gan import dcgan_train_step
from ganleaks_tpu_torch.train.state import GANState, adam_torch
from ganleaks_tpu_torch.train.wgangp import wgangp_train_step
from ganleaks_tpu_torch.utils.checkpoint import (load_state_dict,
                                                 save_state_dict)
from ganleaks_tpu_torch.utils.logging import MetricsLogger

ATOL = 2e-5
LOSS_RTOL = 1e-4
STAT_ATOL = 1e-5


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


def _assert_trees_close(got, want, atol, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _randomise_stats(variables, rng):
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for path, leaf in _flat(stats).items():
        node = stats
        parts = path.split("/")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = (rng.uniform(-0.5, 0.5, leaf.shape) if parts[-1]
                           == "mean" else rng.uniform(0.5, 2.0, leaf.shape)
                           ).astype(np.float32)
    return {"params": jax.tree_util.tree_map(np.asarray,
                                             variables["params"]),
            "batch_stats": stats}


def _dcgan_cfg(**kw):
    kw = dict(nz=8, ngf=8, ndf=8, image_size=16, batch_size=8, **kw)
    return JDCGANConfig(**kw), DCGANConfig(**kw)


def _wgangp_cfg(**kw):
    kw = dict(nz=8, ngf=8, ndf=8, batch_size=4, critic_iter=2, **kw)
    return JWGANGPConfig(**kw), WGANGPConfig(**kw)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_batchnorm_train_mode_matches_jax():
    """Train mode normalises by the batch's biased variance and
    accumulates the unbiased one (torch) into the running statistics."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (5, 3, 3, 4)).astype(np.float32)
    bn = jnn.BatchNormTorch(momentum=0.1)
    v = bn.init(jax.random.key(0), jnp.asarray(x), use_running_average=False)
    scale = rng.normal(0, 1, 4).astype(np.float32)
    bias = rng.normal(0, 1, 4).astype(np.float32)
    v = {"params": {"bn": {"scale": scale, "bias": bias}},
         "batch_stats": {"bn": {"mean": np.full(4, 0.2, np.float32),
                                "var": np.full(4, 1.5, np.float32)}}}
    y, upd = bn.apply(v, jnp.asarray(x), use_running_average=False,
                      mutable=["batch_stats"])
    port = BatchNormTorch(4)
    weights.load_jax_tree(port, v["params"], v["batch_stats"])
    got = port.train()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(y), atol=ATOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               upd["batch_stats"]["bn"]["mean"],
                               atol=STAT_ATOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               upd["batch_stats"]["bn"]["var"],
                               atol=STAT_ATOL)


def test_instance_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0.5, 3.0, (3, 5, 6, 4)).astype(np.float32)
    scale = rng.normal(1, 0.5, 4).astype(np.float32)
    bias = rng.normal(0, 0.5, 4).astype(np.float32)
    want = jnn.InstanceNorm2d().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    port = InstanceNorm2d(4)
    weights.load_jax_tree(port, {"scale": scale, "bias": bias})
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), np.asarray(want),
                               atol=ATOL)


def test_transposed_conv_carries_a_non_symmetric_kernel():
    """A kernel with one hot tap: the JAX layer (flipped kernel on the
    dilated input) and torch's ConvTranspose2d put it at the same output
    position."""
    k = np.zeros((4, 4, 2, 3), np.float32)
    k[0, 1, 1, 2] = 1.0
    k[3, 2, 0, 0] = -2.0
    x = np.random.default_rng(2).normal(size=(1, 5, 5, 2)).astype(np.float32)
    layer = jnn.ConvTranspose2dTorch(3, 4, 2, 1, use_bias=False)
    want = layer.apply({"params": {"kernel": k}}, jnp.asarray(x))
    port = torch.nn.ConvTranspose2d(2, 3, 4, 2, 1, bias=False)
    weights.load_jax_tree(port, {"kernel": k})
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), np.asarray(want),
                               atol=ATOL)
    back = weights.dump_jax_tree(port)["params"]["kernel"]
    np.testing.assert_array_equal(back, k)


# ---------------------------------------------------------------------------
# models and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_dcgan_forward_matches_jax(train):
    jcfg, _ = _dcgan_cfg()
    state = j_dcgan.build_state(jcfg, jax.random.key(0))
    rng = np.random.default_rng(3)
    gv = _randomise_stats({"params": state.gen.params,
                           "batch_stats": state.gen.batch_stats}, rng)
    dv = _randomise_stats({"params": state.disc.params,
                           "batch_stats": state.disc.batch_stats}, rng)
    gen = weights.dcgan_from_jax_variables("generator", gv).train(train)
    disc = weights.dcgan_from_jax_variables("discriminator", dv).train(train)
    z = rng.normal(size=(6, 8)).astype(np.float32)
    jg = JGenerator(nz=8, ngf=8, image_size=16)
    jd = JDiscriminator(ndf=8, image_size=16)
    if train:
        img, gupd = jg.apply(gv, jnp.asarray(z), train=True,
                             mutable=["batch_stats"])
        logits, dupd = jd.apply(dv, img, train=True, mutable=["batch_stats"])
    else:
        img = jg.apply(gv, jnp.asarray(z))
        logits = jd.apply(dv, img)
    got_img = gen(torch.from_numpy(z))
    np.testing.assert_allclose(_nhwc(got_img), np.asarray(img), atol=ATOL)
    got = disc(_nchw(np.asarray(img)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               atol=ATOL)
    if train:
        _assert_trees_close(weights.gan_to_jax_variables(gen)["batch_stats"],
                            gupd["batch_stats"], STAT_ATOL, "G stats")
        _assert_trees_close(weights.gan_to_jax_variables(disc)["batch_stats"],
                            dupd["batch_stats"], STAT_ATOL, "D stats")
    # the bridge is its own inverse
    _assert_trees_close(weights.dcgan_to_jax_variables(
        weights.dcgan_from_jax_variables("generator", gv)), gv, 0, "G")
    assert gen.gen[0][0].weight.shape == (8, 32, 4, 4)


def test_wgangp_critic_matches_jax():
    jcfg, _ = _wgangp_cfg()
    state = j_wgangp.build_state(jcfg, jax.random.key(1))
    cv = {"params": jax.tree_util.tree_map(np.asarray, state.disc.params)}
    critic = weights.wgangp_from_jax_variables("critic", cv)
    x = np.random.default_rng(4).uniform(-1, 1, (3, 64, 64, 3)).astype(
        np.float32)
    want = JCritic(ndf=8).apply(cv, jnp.asarray(x))
    np.testing.assert_allclose(critic(_nchw(x)).detach().numpy(),
                               np.asarray(want), atol=ATOL)
    _assert_trees_close(weights.wgangp_to_jax_variables(critic), cv, 0,
                        "critic")
    gv = {"params": state.gen.params, "batch_stats": state.gen.batch_stats}
    assert isinstance(weights.wgangp_from_jax_variables("generator", gv),
                      Generator)
    with pytest.raises(ValueError):
        weights.wgangp_from_jax_variables("discriminator", cv)


def _reference_state_dicts(rng, nz=8, ngf=8, ndf=8):
    """State dicts with the reference's keys and shapes
    (``gan_models/dcgan/model_torch.py``, ``wgangp/model.py``; the layout
    ``tools/convert_victim.py`` documents), random values, BatchNorm's
    ``num_batches_tracked`` included."""
    def t(*shape):
        return torch.from_numpy(rng.normal(0, 0.3, shape).astype(np.float32))

    g = {}
    chans = [nz, ngf * 16, ngf * 8, ngf * 4, ngf * 2]
    for i in range(4):
        g[f"gen.{i}.0.weight"] = t(chans[i], chans[i + 1], 4, 4)
        g[f"gen.{i}.1.weight"] = t(chans[i + 1])
        g[f"gen.{i}.1.bias"] = t(chans[i + 1])
        g[f"gen.{i}.1.running_mean"] = t(chans[i + 1])
        g[f"gen.{i}.1.running_var"] = t(chans[i + 1]).abs() + 0.5
        g[f"gen.{i}.1.num_batches_tracked"] = torch.tensor(7)
    g["gen.4.weight"], g["gen.4.bias"] = t(ngf * 2, 3, 4, 4), t(3)
    d, c = {}, {}
    for sd in (d, c):
        sd["disc.0.weight"], sd["disc.0.bias"] = t(ndf, 3, 4, 4), t(ndf)
        sd["disc.5.weight"], sd["disc.5.bias"] = t(1, ndf * 8, 4, 4), t(1)
    for i, (cin, cout) in zip((2, 3, 4), ((1, 2), (2, 4), (4, 8))):
        for sd in (d, c):
            sd[f"disc.{i}.0.weight"] = t(ndf * cout, ndf * cin, 4, 4)
            sd[f"disc.{i}.1.weight"] = t(ndf * cout)
            sd[f"disc.{i}.1.bias"] = t(ndf * cout)
        d[f"disc.{i}.1.running_mean"] = t(ndf * cout)
        d[f"disc.{i}.1.running_var"] = t(ndf * cout).abs() + 0.5
        d[f"disc.{i}.1.num_batches_tracked"] = torch.tensor(7)
    return g, d, c


def test_reference_state_dicts_load_by_name(tmp_path):
    """Reference-layout state dicts load into the port's models by name
    and compute what the JAX models compute on the same checkpoint
    (``tools/convert_victim``); the port saves the same keys."""
    rng = np.random.default_rng(5)
    g_sd, d_sd, c_sd = _reference_state_dicts(rng)
    gen = load_state_dict(Generator(nz=8, ngf=8), g_sd).eval()
    disc = load_state_dict(Discriminator(ndf=8), d_sd).eval()
    critic = load_state_dict(Critic(ndf=8), c_sd)
    z = rng.normal(size=(3, 8)).astype(np.float32)
    x = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    jg = JGenerator(nz=8, ngf=8).apply(
        convert_victim.convert_dcgan_generator(g_sd), jnp.asarray(z))
    np.testing.assert_allclose(_nhwc(gen(torch.from_numpy(z))),
                               np.asarray(jg), atol=ATOL)
    jd = JDiscriminator(ndf=8).apply(
        convert_victim.convert_dcgan_discriminator(d_sd), jnp.asarray(x))
    np.testing.assert_allclose(disc(_nchw(x)).detach().numpy(),
                               np.asarray(jd), atol=ATOL)
    jc = JCritic(ndf=8).apply(convert_victim.convert_wgangp_critic(c_sd),
                              jnp.asarray(x))
    np.testing.assert_allclose(critic(_nchw(x)).detach().numpy(),
                               np.asarray(jc), atol=ATOL)
    for model, sd, name in ((gen, g_sd, "generator"),
                            (disc, d_sd, "discriminator"),
                            (critic, c_sd, "critic")):
        path = str(tmp_path / f"{name}.pth")
        save_state_dict(path, model)
        saved = torch.load(path, weights_only=True)
        assert set(saved) == {k for k in sd
                              if not k.endswith("num_batches_tracked")}
        for k, v in saved.items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    bad = dict(g_sd)
    bad.pop("gen.4.bias")
    with pytest.raises(RuntimeError, match="gen.4.bias"):
        load_state_dict(Generator(nz=8, ngf=8), bad)


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def _port_state(cls_gen, cls_disc, gv, dv, cfg):
    gen = weights.gan_load_jax_variables(cls_gen, gv).train()
    disc = weights.gan_load_jax_variables(cls_disc, dv).train()
    return GANState(gen, disc,
                    adam_torch(gen.parameters(), cfg.lr, cfg.beta1,
                               cfg.beta2),
                    adam_torch(disc.parameters(), cfg.lr, cfg.beta1,
                               cfg.beta2))


def test_dcgan_step_matches_jax():
    """One D + G step with the JAX step's own noise: losses, updated
    parameters of both nets and both nets' running statistics."""
    jcfg, cfg = _dcgan_cfg()
    state = j_dcgan.build_state(jcfg, jax.random.key(0))
    gv = jax.tree_util.tree_map(np.asarray, {
        "params": state.gen.params, "batch_stats": state.gen.batch_stats})
    dv = jax.tree_util.tree_map(np.asarray, {
        "params": state.disc.params, "batch_stats": state.disc.batch_stats})
    real = np.random.default_rng(6).uniform(-1, 1, (8, 16, 16, 3)).astype(
        np.float32)
    key = jax.random.key(7)
    noise = np.asarray(jax.random.normal(key, (8, 8), jnp.float32))
    jstate, jm = j_dcgan_step(state, jnp.asarray(real), key)
    port = _port_state(Generator(nz=8, ngf=8, image_size=16),
                       Discriminator(ndf=8, image_size=16), gv, dv, cfg)
    m = dcgan_train_step(port, _nchw(real), noise=torch.from_numpy(noise))
    for k in ("loss_disc", "loss_gen"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    tol = cfg.lr / 10
    _assert_trees_close(weights.gan_to_jax_variables(port.gen)["params"],
                        jstate.gen.params, tol, "G params")
    _assert_trees_close(weights.gan_to_jax_variables(port.disc)["params"],
                        jstate.disc.params, tol, "D params")
    _assert_trees_close(weights.gan_to_jax_variables(port.gen)["batch_stats"],
                        jstate.gen.batch_stats, STAT_ATOL, "G stats")
    _assert_trees_close(
        weights.gan_to_jax_variables(port.disc)["batch_stats"],
        jstate.disc.batch_stats, STAT_ATOL, "D stats")
    # the step moved every parameter group by about one Adam step
    moved = np.abs(port.gen.gen[0][0].weight.detach().numpy()
                   - gv["params"]["block0_conv"]["kernel"].transpose(
                       2, 3, 0, 1)).max()
    assert moved > 0.5 * cfg.lr


def test_wgangp_step_matches_jax():
    """One WGAN-GP step (critic_iter 2) with the JAX step's own noise and
    eps (the keys it splits): losses, updated generator and critic
    parameters, the generator's running statistics (advanced twice)."""
    jcfg, cfg = _wgangp_cfg()
    state = j_wgangp.build_state(jcfg, jax.random.key(2))
    gv = jax.tree_util.tree_map(np.asarray, {
        "params": state.gen.params, "batch_stats": state.gen.batch_stats})
    cv = {"params": jax.tree_util.tree_map(np.asarray, state.disc.params)}
    real = np.random.default_rng(8).uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)
    rng = key = jax.random.key(9)
    noise, eps = [], []
    for _ in range(cfg.critic_iter):
        rng, k_noise, k_eps = jax.random.split(rng, 3)
        noise.append(torch.from_numpy(np.asarray(
            jax.random.normal(k_noise, (4, 8), jnp.float32))))
        eps.append(torch.from_numpy(np.asarray(
            jax.random.uniform(k_eps, (4, 1, 1, 1), jnp.float32))))
    jstate, jm = j_wgangp.wgangp_train_step(
        state, jnp.asarray(real), key, critic_iter=cfg.critic_iter,
        lambda_gp=cfg.lambda_gp)
    port = _port_state(Generator(nz=8, ngf=8), Critic(ndf=8), gv, cv, cfg)
    m = wgangp_train_step(port, _nchw(real), cfg.critic_iter, cfg.lambda_gp,
                          noise=noise, eps=eps)
    for k in ("loss_critic", "loss_gen"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    tol = cfg.lr / 10
    _assert_trees_close(weights.gan_to_jax_variables(port.gen)["params"],
                        jstate.gen.params, tol, "G params")
    _assert_trees_close(weights.gan_to_jax_variables(port.disc)["params"],
                        jstate.disc.params, tol, "critic params")
    _assert_trees_close(weights.gan_to_jax_variables(port.gen)["batch_stats"],
                        jstate.gen.batch_stats, STAT_ATOL, "G stats")


def test_gradient_penalty_matches_jax():
    jcfg, _ = _wgangp_cfg()
    state = j_wgangp.build_state(jcfg, jax.random.key(3))
    cv = {"params": jax.tree_util.tree_map(np.asarray, state.disc.params)}
    rng = np.random.default_rng(10)
    real, fake = (rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
                  for _ in range(2))
    eps = rng.uniform(size=(3, 1, 1, 1)).astype(np.float32)
    want = j_wgangp.gradient_penalty_fn(JCritic(ndf=8).apply, cv["params"],
                                        real, fake, eps)
    critic = weights.wgangp_from_jax_variables("critic", cv)
    got = wgangp.gradient_penalty_fn(critic, _nchw(real), _nchw(fake),
                                     torch.from_numpy(eps))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# data, artifacts, end to end
# ---------------------------------------------------------------------------

def test_train_images_and_batches_match_jax(tmp_path):
    """Exact-size PNGs through the codec, other sizes through Pillow's
    bilinear resize, JPEGs through Pillow: the JAX reader's floats bit for
    bit; the epoch batches are the JAX package's permutations."""
    rng = np.random.default_rng(11)
    for i in range(5):
        PIL.Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8)
                            ).save(tmp_path / f"a{i}.png")
    PIL.Image.fromarray(rng.integers(0, 256, (30, 20, 3), np.uint8)).save(
        tmp_path / "b.png")
    PIL.Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8)).save(
        tmp_path / "c.jpg")
    got = load_train_images(str(tmp_path), 16)
    want = j_load_train_images(str(tmp_path), 16)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for n, b in ((7, 3), (8, 4)):
        for got_b, want_b in zip(
                epoch_batch_indices(np.random.default_rng(1), n, b, True),
                j_epoch_batches(np.random.default_rng(1), n, b, True)):
            np.testing.assert_array_equal(got_b, want_b)
    ds = DeviceDataset(got, seed=3)
    order = np.concatenate([b.numpy() for b in ds.epoch(4)])
    perm = np.random.default_rng(3).permutation(len(got))
    np.testing.assert_array_equal(order, got[perm].transpose(0, 3, 1, 2))


def test_synthetic_artifacts_and_grid_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    imgs = rng.uniform(0, 1, (5, 16, 16, 3)).astype(np.float32)
    imgs[0, 0, 0] = (0.0, 1.0, 0.999)
    noise = rng.normal(size=(5, 8)).astype(np.float32)
    got = write_synthetic_artifacts(str(tmp_path / "port"), "dcgan", imgs,
                                    noise, run_dir="run")
    want = j_write_artifacts(str(tmp_path / "jax"), "dcgan", imgs, noise,
                             run_dir="run")
    for sub, name, key in (("npz_images", "dcgan_synthetic_data.npz",
                            "fake"),
                           ("npz_noise", "dcgan_noise.npz", "noise")):
        a = np.load(os.path.join(got[sub], name))[key]
        b = np.load(os.path.join(want[sub], name))[key]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(got["png_images"])) == \
        sorted(os.listdir(want["png_images"]))
    for f in os.listdir(want["png_images"]):
        np.testing.assert_array_equal(
            native.decode_png(os.path.join(got["png_images"], f)),
            np.asarray(PIL.Image.open(os.path.join(want["png_images"], f))))
    logger = MetricsLogger(echo=False, image_dir=str(tmp_path / "grids"))
    path = logger.log_image_grid("samples", imgs, step=3, ncols=2)
    assert path.endswith("samples_0000003.png")
    np.testing.assert_array_equal(native.decode_png(path),
                                  j_tile_grid(imgs, 2))


def test_train_sample_attack_pipeline(tmp_path, monkeypatch):
    """The reference study for one victim at toy size on the CPU: train
    DCGAN on a PNG directory, save the reference-keyed checkpoints,
    sample the PNG + npz + noise triplet (again from ``saved_model_name``,
    identically), attack the PNG dump with members planted from the
    training directory, score the AUROC; WGAN-GP trains and samples."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(13)
    train_dir, test_dir = tmp_path / "train", tmp_path / "test"
    for d in (train_dir, test_dir):
        d.mkdir()
        native.save_png_batch_native(
            rng.integers(0, 256, (16, 16, 16, 3), np.uint8),
            [str(d / f"{i:03d}.png") for i in range(16)])
    cfg = DCGANConfig(data_path=str(train_dir), image_size=16, nz=8, ngf=8,
                      ndf=8, batch_size=8, num_epochs=2, num_generated=24,
                      PATH=str(tmp_path / "model"),
                      PATH_syn_data=str(tmp_path / "syn"))
    state = dcgan.train(cfg, logger=MetricsLogger(
        echo=False, image_dir=str(tmp_path / "grids")), device="cpu")
    assert state.step == 4
    assert sorted(os.listdir(tmp_path / "grids")) == [
        "samples_0000002.png", "samples_0000004.png"]
    (run,) = os.listdir(tmp_path / "model" / "dcgan")
    model_dir = str(tmp_path / "model" / "dcgan" / run)
    assert sorted(os.listdir(model_dir)) == ["discriminator.pth",
                                             "generator.pth"]
    dirs = dcgan.generate(cfg, state, run_dir="r1", device="cpu")
    again = dcgan.generate(
        DCGANConfig(**{**cfg.__dict__, "saved_model_name": model_dir}),
        run_dir="r2", device="cpu")
    png = dirs["png_images"]
    assert len(os.listdir(png)) == 24
    for f in os.listdir(png):
        np.testing.assert_array_equal(
            native.decode_png(os.path.join(png, f)),
            native.decode_png(os.path.join(again["png_images"], f)))
    # members planted in the dump: their nearest distance is ~0
    members = native.load_image_dir_native(str(train_dir), 16,
                                           dtype=np.uint8)
    native.save_png_batch_native(
        members[:4], [os.path.join(png, f"image_{100 + i}.png")
                      for i in range(4)])
    out = run_attack(AttackConfig(
        syn_data_path=png, pos_data_dir=str(train_dir),
        neg_data_dir=str(test_dir), resolution=16, distance="l2",
        save_plots=False), device="cpu")[0]
    assert (np.abs(np.sort(out["pos_loss"])[:4]) < 1e-5).all()
    assert np.sort(out["pos_loss"])[4] > 1e-2
    res = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
    assert 0.5 < res["auc"] <= 1.0
    wcfg = WGANGPConfig(data_path=str(tmp_path / "w"), nz=8, ngf=8, ndf=8,
                        batch_size=4, num_epochs=1, critic_iter=2,
                        num_generated=6, PATH=str(tmp_path / "model"),
                        PATH_syn_data=str(tmp_path / "syn"),
                        sample_grid_dir=None)
    (tmp_path / "w").mkdir()
    native.save_png_batch_native(
        rng.integers(0, 256, (4, 64, 64, 3), np.uint8),
        [str(tmp_path / "w" / f"{i}.png") for i in range(4)])
    wstate = wgangp.train(wcfg, device="cpu")
    assert wstate.step == 1
    (wrun,) = os.listdir(tmp_path / "model" / "wgangp")
    assert sorted(os.listdir(tmp_path / "model" / "wgangp" / wrun)) == [
        "critic.pth", "generator.pth"]
    wdirs = wgangp.generate(wcfg, wstate, run_dir="w1", device="cpu")
    fake = np.load(os.path.join(wdirs["npz_images"],
                                "wgangp_synthetic_data.npz"))["fake"]
    assert fake.shape == (6, 3, 64, 64) and np.isfinite(fake).all()


def test_mesh_shape_refused():
    """A data-parallel mesh outside a process group raises
    ``data_parallel_mesh``'s error naming the ranks it needs (the CLI
    launches them; ``tests/test_torch_train_ranks.py`` trains on them);
    the privGAN trainers refuse any mesh, naming ``parallel/ep``."""
    from ganleaks_tpu_torch.config import PGGANConfig, PrivGANConfig
    from ganleaks_tpu_torch.train import priv

    _, cfg = _dcgan_cfg(mesh_shape=(2,))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        dcgan.train(cfg, images=np.zeros((4, 16, 16, 3), np.float32),
                    device="cpu")
    for train, mcfg in ((priv.train_privdcgan, cfg),
                        (priv.train_privpggan, PGGANConfig(
                            mesh_shape=(2,)))):
        with pytest.raises(NotImplementedError, match="parallel/ep"):
            train(mcfg, PrivGANConfig(),
                  images=np.zeros((4, 16, 16, 3), np.float32),
                  device="cpu")
