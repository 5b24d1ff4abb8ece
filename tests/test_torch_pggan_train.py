"""The port's PGGAN victim (``ganleaks_tpu_torch.models.pggan``,
``train.pggan``, ``io.images.nearest_resize``, ``io.data.random_hflip``,
``cli.train_pggan``, the PGGAN part of ``weights``) against the JAX
package on the CPU, at in_channels 16, nz 16, up to 16 px, batch 4.

Weights come from the JAX trainer's ``build_state`` (``init_progressive``'s
union tree) and are carried into the port whole by
``weights.pggan_from_jax_variables``; each step is handed the JAX step's
own noise and eps, made from the keys it splits, at alpha 0.5.

Tolerances: forwards atol 2e-5; float32 steps as
``tests/test_torch_victims.py``: losses rtol 1e-4, parameters within a
tenth of lr. The bfloat16 step: both packages round every activation to
bfloat16, at different points (torch after each op, XLA's CPU backend
after fused chains of them), and Adam's first step (~lr * sign(g)) turns
that noise into whole steps on small gradients. So the bound is relative
to the float32 step on the same draws (the port's, which the float32
tests hold to the JAX package's) and to the JAX package's own bf16
error: the port's bf16 update is held to at most three times the JAX
bf16 update's distance from the float32 one, plus 0.1 (relative L2 over
each net's update; torch rounds after every op, so the port's is the
noisier: seen 0.74 against the JAX step's 0.36 on the 16-px critic,
below it on the other nets and steps), and both
packages' bf16 losses to within 8% of the float32 losses (absolute
below 1: the generator's loss sits near 0). The critic's loss is mostly
``10 * (|grad| - 1)^2``, which magnifies bfloat16's 0.4% rounding: seen
4.1% off in the port and 2.7% in the JAX package, on different steps.
Resizing, flips and the schedule are held exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from ganleaks_tpu.config import PGGANConfig as JPGGANConfig
from ganleaks_tpu.io.data import random_hflip as j_random_hflip
from ganleaks_tpu.io.images import nearest_resize as j_nearest_resize
from ganleaks_tpu.models import pggan as jm
from ganleaks_tpu.tools import convert_victim
from ganleaks_tpu.train import pggan as jt
from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.attack.eval_roc import evaluate
from ganleaks_tpu_torch.attack.fbb import run_attack
from ganleaks_tpu_torch.cli import train_pggan as cli
from ganleaks_tpu_torch.config import AttackConfig, EvalConfig, PGGANConfig
from ganleaks_tpu_torch.io import native
from ganleaks_tpu_torch.io.data import random_hflip
from ganleaks_tpu_torch.io.images import nearest_resize
from ganleaks_tpu_torch.models.pggan import Discriminator, Generator
from ganleaks_tpu_torch.train import pggan
from ganleaks_tpu_torch.train.state import GANState, adam_torch
from ganleaks_tpu_torch.utils.checkpoint import load_state_dict

ATOL = 2e-5
LOSS_RTOL = 1e-4
KW = dict(nz=16, in_channels=16, image_size=16)
B = 4


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


@pytest.fixture(scope="module")
def jax_vars():
    st = jt.build_state(JPGGANConfig(**KW), jax.random.key(0))
    return ({"params": jax.tree_util.tree_map(np.asarray, st.gen.params)},
            {"params": jax.tree_util.tree_map(np.asarray, st.disc.params)})


def _port_state(jax_vars, lr):
    gen = weights.pggan_from_jax_variables("generator", jax_vars[0])
    critic = weights.pggan_from_jax_variables("critic", jax_vars[1])
    return GANState(gen.train(), critic.train(),
                    adam_torch(gen.parameters(), lr, 0.0, 0.99),
                    adam_torch(critic.parameters(), lr, 0.0, 0.99))


@pytest.mark.parametrize("steps", [0, 1, 2])
def test_pggan_forward_matches_jax(jax_vars, steps):
    """Generator and critic at every resolution with the fade-in at 0.5
    (at steps 0 the generator's 4x4 output without tanh)."""
    gv, dv = jax_vars
    z = np.random.default_rng(1).standard_normal((B, 16)).astype(np.float32)
    img = jm.Generator(16, 16).apply(gv, jnp.asarray(z), steps, 0.5)
    score = jm.Discriminator(16).apply(dv, img, steps, 0.5)
    gen = weights.pggan_from_jax_variables("generator", gv)
    critic = weights.pggan_from_jax_variables("critic", dv)
    with torch.no_grad():
        got = gen(torch.from_numpy(z), steps, 0.5)
        got_s = critic(_nchw(img), steps, 0.5)
    assert got.shape == (B, 3, 4 * 2 ** steps, 4 * 2 ** steps)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(img), atol=ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(score), atol=ATOL)


def test_weights_round_trip_the_union_tree(jax_vars):
    """``init_progressive``'s union over steps 0..2 carries across whole
    and back, bit for bit; the critic keeps the reference's top-down
    numbering (rgb6..rgb8, prog6, prog7)."""
    for kind, v in zip(("generator", "critic"), jax_vars):
        back = weights.pggan_to_jax_variables(
            weights.pggan_from_jax_variables(kind, v))
        got, want = _flat(back), _flat(v)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(k for k in jax_vars[1]["params"] if k[:3] in
                  ("rgb", "pro")) == ["prog6", "prog7", "rgb6", "rgb7",
                                      "rgb8"]


def _draws(key, dtype):
    _, kn, ke = jax.random.split(key, 3)
    jdt = jnp.dtype(dtype)
    noise = jax.random.normal(kn, (B, 16), jdt)
    eps = jax.random.uniform(ke, (B, 1, 1, 1), jdt)
    tdt = getattr(torch, dtype)
    return tuple(torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdt)
                 for a in (noise, eps))


def _run_steps(jax_vars, steps, dtype):
    """The JAX step and the port's on the same draws; with bfloat16 also
    the port's float32 step on them (the float32 update, the reference
    the bf16 bound is measured against)."""
    cfg = PGGANConfig(**KW)
    real = np.random.default_rng(2).uniform(
        -1, 1, (B, 4 * 2 ** steps, 4 * 2 ** steps, 3)).astype(np.float32)
    key = jax.random.key(3)
    jstate, jmet = jt.pggan_train_step(
        jt.build_state(JPGGANConfig(**KW), jax.random.key(0)),
        jnp.asarray(real), jnp.float32(0.5), key, steps,
        compute_dtype=dtype)
    noise, eps = _draws(key, dtype)
    out = {}
    for cdt in ((dtype, "float32") if dtype == "bfloat16" else (dtype,)):
        state = _port_state(jax_vars, cfg.lr)
        met = pggan.pggan_train_step(state, _nchw(real), 0.5, steps,
                                     compute_dtype=cdt, noise=noise.to(
                                         getattr(torch, cdt)),
                                     eps=eps.to(getattr(torch, cdt)))
        out[cdt] = (met, {n: _flat(weights.pggan_to_jax_variables(m)
                                   ["params"])
                          for n, m in (("gen", state.gen),
                                       ("critic", state.disc))})
    want = {"gen": _flat(jstate.gen.params),
            "critic": _flat(jstate.disc.params)}
    return out, jmet, want, cfg.lr


@pytest.mark.parametrize("steps", [0, 1, 2])
def test_pggan_step_matches_jax_float32(jax_vars, steps):
    """One critic (WGAN-GP + drift) and one generator update in float32:
    losses and every parameter of both nets; each net moved by about one
    Adam step."""
    out, jmet, want, lr = _run_steps(jax_vars, steps, "float32")
    met, got = out["float32"]
    for k in ("loss_critic", "loss_gen"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    init = {"gen": _flat(jax_vars[0]["params"]),
            "critic": _flat(jax_vars[1]["params"])}
    for net in ("gen", "critic"):
        assert sorted(got[net]) == sorted(want[net])
        for k in want[net]:
            np.testing.assert_allclose(got[net][k], want[net][k], rtol=0,
                                       atol=lr / 10, err_msg=f"{net} {k}")
        moved = max(float(np.abs(got[net][k] - init[net][k]).max())
                    for k in init[net])
        assert 0.5 * lr < moved <= lr + 1e-6, (net, moved)


@pytest.mark.parametrize("steps", [0, 1, 2])
def test_pggan_step_bfloat16_within_bound(jax_vars, steps):
    """The bfloat16 step (parameters and activations cast, losses and Adam
    in float32) against the JAX package's bfloat16 step, within the bound
    the module docstring states."""
    out, jmet, want, lr = _run_steps(jax_vars, steps, "bfloat16")
    (met, got), (met32, truth) = out["bfloat16"], out["float32"]
    for k in ("loss_critic", "loss_gen"):
        ref = float(met32[k])
        for pkg, val in (("port", float(met[k])), ("jax", float(jmet[k]))):
            assert abs(val - ref) <= 0.08 * max(abs(ref), 1.0), (pkg, k,
                                                                 val, ref)
    init = {"gen": _flat(jax_vars[0]["params"]),
            "critic": _flat(jax_vars[1]["params"])}

    def rel(a, b, net):
        num = sum(((a[k] - b[k]) ** 2).sum() for k in b)
        den = sum(((b[k] - init[net][k]) ** 2).sum() for k in b)
        return float(np.sqrt(num / den))

    for net in ("gen", "critic"):
        port_err = rel(got[net], truth[net], net)
        jax_err = rel(want[net], truth[net], net)
        assert port_err <= 3 * jax_err + 0.1, (net, port_err, jax_err)
        for k in got[net]:   # the master parameters stay float32
            assert got[net][k].dtype == np.float32


def test_gradient_penalty_matches_jax(jax_vars):
    _, dv = jax_vars
    rng = np.random.default_rng(4)
    real, fake = (rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32)
                  for _ in range(2))
    eps = rng.uniform(size=(B, 1, 1, 1)).astype(np.float32)
    want = jt.gradient_penalty_fn(jm.Discriminator(16).apply, dv["params"],
                                  real, fake, eps, 1, 0.5)
    critic = weights.pggan_from_jax_variables("critic", dv)
    got = pggan.gradient_penalty_fn(critic, _nchw(real), _nchw(fake),
                                    _nchw(eps), 1, 0.5)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# data and schedule
# ---------------------------------------------------------------------------

def test_nearest_resize_matches_jax_and_pil():
    imgs = np.random.default_rng(5).integers(0, 256, (3, 64, 48, 3),
                                             np.uint8)
    sq = imgs[:, :48]
    for size in (4, 8, 16, 32, 48):
        got = nearest_resize(sq, size)
        np.testing.assert_array_equal(got, j_nearest_resize(sq, size))
        np.testing.assert_array_equal(
            got, np.stack([np.asarray(PIL.Image.fromarray(x).resize(
                (size, size), PIL.Image.NEAREST)) for x in sq]))
        assert torch.equal(nearest_resize(torch.from_numpy(sq), size),
                           torch.from_numpy(got))
    assert nearest_resize(sq, 48) is sq


def test_random_hflip_matches_jax():
    """Given the JAX flip's own Bernoulli mask, the same images are
    mirrored; drawn from a generator, about half of them are."""
    x = np.random.default_rng(6).uniform(size=(64, 4, 4, 3)).astype(
        np.float32)
    key = jax.random.key(7)
    want = np.asarray(j_random_hflip(jnp.asarray(x), key))
    mask = np.asarray(jax.random.bernoulli(key, 0.5, (64, 1, 1, 1)))
    got = random_hflip(_nchw(x), torch.from_numpy(mask.reshape(-1)))
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    drawn = random_hflip(_nchw(x), generator=torch.Generator().manual_seed(
        0))
    flipped = sum(not torch.equal(a, b) for a, b in zip(drawn, _nchw(x)))
    assert 16 < flipped < 48


def test_progressive_schedule_matches_jax(monkeypatch):
    """With both steps replaced by recorders (and no flips), the port's
    loop hands its step the JAX loop's inputs: per resolution the
    nearest-resized images in the order of ``DeviceDataset(seed + steps)``
    at that resolution's batch size, and the fade-in alpha ramped per
    batch from 1e-5 (as float32, what the JAX loop passes)."""
    got, want = [], []

    def rec(sink, jax_step):
        def step(state, batch, alpha, *args, **kw):
            steps = args[1] if jax_step else args[0]
            sink.append((np.asarray(batch), np.float32(alpha), steps))
            return (state, {}) if jax_step else {}
        return step

    monkeypatch.setattr(pggan, "pggan_train_step", rec(got, False))
    monkeypatch.setattr(jt, "pggan_train_step", rec(want, True))
    images = np.random.default_rng(8).uniform(
        -1, 1, (10, 16, 16, 3)).astype(np.float32)
    kw = {**KW, "batch_sizes": (4, 3, 5), "num_epochs": 2, "hflip": False,
          "save_model": False, "sample_grid_dir": None}
    pggan.train(PGGANConfig(**kw), images, device="cpu")
    jt.train(JPGGANConfig(**kw), images)
    assert len(got) == len(want) == 2 * (3 + 4 + 2)
    for (gb, ga, gs), (wb, wa, ws) in zip(got, want):
        assert gs == ws and ga == wa
        np.testing.assert_array_equal(gb.transpose(0, 2, 3, 1), wb)
    assert [s for _, _, s in got] == [0] * 6 + [1] * 8 + [2] * 4


# ---------------------------------------------------------------------------
# reference checkpoints and end to end
# ---------------------------------------------------------------------------

def test_reference_state_dicts_load_by_name(tmp_path):
    """Full reference builds (every layer of the 1,024-px schedule, so
    ``in_channels`` 32 keeps 1/32 of it) under the reference's keys —
    ``initial.{1,3}``, ``rgb_layers.{i}``, ``prog_blocks.{i}``,
    ``final_block.{0,2,4}`` and the ``initial_rgb`` copy — load by name
    and compute what the JAX nets compute on the converted checkpoint;
    the port saves the same keys, and a dict without the copy loads
    too."""
    rng = np.random.default_rng(9)

    def random_sd(model):
        return {k: torch.from_numpy(rng.normal(0, 0.5, tuple(v.shape))
                                    .astype(np.float32))
                for k, v in model.state_dict().items()}

    g_sd = random_sd(Generator(16, 32, 3))
    g_sd["initial_rgb.bias"] = g_sd["rgb_layers.0.bias"]
    g_sd["initial_rgb.conv.weight"] = g_sd["rgb_layers.0.conv.weight"]
    d_sd = random_sd(Discriminator(32, 3))
    for p in ("bias", "conv.weight"):
        d_sd[f"initial_rgb.{p}"] = d_sd[f"rgb_layers.8.{p}"]
    assert {"initial.1.weight", "initial.3.conv.weight", "rgb_layers.8.bias",
            "prog_blocks.7.conv2.bias"} <= set(g_sd)
    assert {"final_block.4.bias", "rgb_layers.0.conv.weight",
            "prog_blocks.0.conv1.bias"} <= set(d_sd)
    gen = load_state_dict(Generator(16, 32, 3), g_sd)
    critic = load_state_dict(Discriminator(32, 3), d_sd)
    gv = convert_victim.convert_pggan_generator(_numpy(g_sd))
    dv = convert_victim.convert_pggan_discriminator(_numpy(d_sd))
    z = rng.standard_normal((2, 16)).astype(np.float32)
    for steps in (0, 2):
        img = jm.Generator(16, 32).apply(gv, jnp.asarray(z), steps, 0.3)
        with torch.no_grad():
            got = gen(torch.from_numpy(z), steps, 0.3)
            score = critic(_nchw(img), steps, 0.3)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(img), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            score.numpy(), np.asarray(jm.Discriminator(32).apply(
                dv, img, steps, 0.3)), rtol=1e-4, atol=1e-4)
    for model, sd in ((gen, g_sd), (critic, d_sd)):
        assert set(model.state_dict()) == set(sd)
    bare = {k: v for k, v in g_sd.items() if not k.startswith("rgb_layers.0")}
    again = load_state_dict(Generator(16, 32, 3), bare)
    assert torch.equal(again.rgb_layers[0].bias, gen.rgb_layers[0].bias)


def test_train_generate_and_attack_pipeline(tmp_path, monkeypatch):
    """The pipeline on the CPU: the CLI trains 4 -> 16 px (bfloat16, the
    config's default, with flips; one epoch a resolution, the fade-in
    active) on a PNG directory, saves ``generator.pth`` / ``critic.pth``
    and writes the PNG + npz + noise triplet; training PNGs planted in
    the dump are found by the port's fbb attack (every planted member
    below every non-member) and ``evaluate`` reads the run; the saved
    generator samples again from ``saved_model_name``."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(10)
    for d in ("train", "test"):
        os.makedirs(d)
        native.save_png_batch_native(
            rng.integers(0, 256, (8, 16, 16, 3), np.uint8),
            [f"{d}/{i:02d}.png" for i in range(8)])
    common = ["image_size=16", "nz=16", "in_channels=16", "num_epochs=1",
              "batch_sizes=[4]", "num_generated=12", "PATH=model",
              "PATH_syn_data=syn", "sample_grid_dir=grids"]
    cli.main(["data_path=train", *common], device="cpu")
    assert sorted(os.listdir("grids")) == [
        "samples_0000002.png", "samples_0000004.png", "samples_0000006.png"]
    (run,) = os.listdir("model/pggan")
    assert sorted(os.listdir(f"model/pggan/{run}")) == ["critic.pth",
                                                       "generator.pth"]
    (stamp,) = os.listdir("syn/pggan/png_images")
    png = f"syn/pggan/png_images/{stamp}"
    fake = np.load(f"syn/pggan/npz_images/{stamp}/pggan_synthetic_data.npz"
                   )["fake"]
    noise = np.load(f"syn/pggan/npz_noise/{stamp}/pggan_noise.npz")["noise"]
    assert fake.shape == (12, 3, 16, 16) and noise.shape == (12, 16, 1, 1)
    assert len(os.listdir(png)) == 12
    members = sorted(os.listdir("train"))[:4]
    for i, f in enumerate(members):
        os.link(f"train/{f}", f"{png}/image_{100 + i}.png")
    out = run_attack(AttackConfig(
        syn_data_path=png, pos_data_dir="train", neg_data_dir="test",
        resolution=16, distance="l2", save_plots=False), device="cpu")[0]
    assert (np.sort(out["pos_loss"])[:4] < out["neg_loss"].min()).all()
    assert 0.5 < evaluate(EvalConfig(
        result_load_dir=out["save_dir"]))["auc"] <= 1.0
    again = pggan.generate(PGGANConfig(
        image_size=16, nz=16, in_channels=16, num_generated=12,
        PATH_syn_data="syn", saved_model_name=f"model/pggan/{run}"),
        run_dir="again", device="cpu")
    assert len(os.listdir(again["png_images"])) == 12
    for f in os.listdir(again["png_images"]):
        np.testing.assert_array_equal(
            native.decode_png(os.path.join(png, f)),
            native.decode_png(os.path.join(again["png_images"], f)))
