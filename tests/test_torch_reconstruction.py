"""The port's VAE-GAN inference modules and reconstruction attack
(``ganleaks_tpu_torch.ops.nn``, ``models.vaegan``,
``attack.reconstruction``, ``cli.reconstruction``) against the JAX
package's on the CPU, at ``d = 8``, ``z_dim = 16``.

Weights come from the JAX modules' own init, with the BatchNorm statistics
and the self-attention ``gamma`` randomised (gamma 0 would hide the
attention path), and are carried into the port by ``weights.load_jax_tree``
/ ``vaegan_from_jax_variables``.

Tolerances, and how they were chosen: every comparison is float32 against
float32 with the products summed in different orders (XLA's convolutions
against torch's), through at most ~12 layers of O(1) values; the observed
gaps are ~1e-6, so blocks and models are held to atol 1e-5 and losses to
rtol 1e-5 (l2) and rtol 1e-4 (l2 + 0.2 LPIPS: the VGG16 tower's 13 more
layers). The image reader is held bit for bit.
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from ganleaks_tpu.attack.reconstruction import \
    reconstruction_scores as j_reconstruction_scores
from ganleaks_tpu.config import VAEGANConfig
from ganleaks_tpu.io.images import load_image_dir as j_load_image_dir
from ganleaks_tpu.io.images import \
    read_image_center_crop as j_read_image_center_crop
from ganleaks_tpu.models.vaegan import Encoder as JEncoder
from ganleaks_tpu.models.vaegan import Generator as JGenerator
from ganleaks_tpu.ops import nn as jnn
from ganleaks_tpu.ops.lpips import default_lpips_params as j_default_lpips
from ganleaks_tpu.ops.lpips import lpips_pair as j_lpips_pair
from ganleaks_tpu.train.vaegan import build_state
from ganleaks_tpu.utils.checkpoint import save_params_npz as j_save_npz
from ganleaks_tpu.utils.checkpoint import save_state as j_save_state
from ganleaks_tpu_torch.attack.eval_roc import evaluate_and_plot
from ganleaks_tpu_torch.attack.reconstruction import (batch_generator,
                                                      reconstruction_scores)
from ganleaks_tpu_torch.cli import reconstruction as cli_recon
from ganleaks_tpu_torch.config import EvalConfig
from ganleaks_tpu_torch.io.images import load_image_dir, read_image_center_crop
from ganleaks_tpu_torch.ops import nn as tnn
from ganleaks_tpu_torch.utils.checkpoint import load_variables
from ganleaks_tpu_torch.weights import (dump_jax_tree, load_jax_tree,
                                        lpips_from_jax_params,
                                        vaegan_from_jax_variables)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's CPU thread
    pool in each of them, on top of the others, slows every process many
    times over. One thread per process for this module's convolutions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


Z_DIM, D = 16, 8
ATOL = 1e-5


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _randomise(variables, rng, gamma=0.7):
    """BatchNorm scale/bias/mean/var and every attention gamma made
    nonzero and non-trivial."""
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "mean" or (name == "bias" and path[-2].key == "bn"):
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name == "gamma":
            return np.full(x.shape, gamma, np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _init(module, *args, rng=None, **kw):
    variables = jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.key(0))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return _randomise(variables, rng or np.random.default_rng(0))


# --- blocks ------------------------------------------------------------------

def test_conv_transpose_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 6, 6, 3)).astype(
        np.float32)
    jmod = jnn.ConvTranspose2dTorch(5, 4, 2, 1)
    v = _init(jmod, x)
    tmod = tnn.ConvTranspose2dTorch(3, 5, 4, 2, 1)
    load_jax_tree(tmod, v["params"])
    want = np.asarray(jmod.apply(v, x))
    got = _nhwc(tmod(_nchw(x)))
    assert got.shape == want.shape == (2, 12, 12, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_sn_conv_transpose_one_iteration_buffers_unchanged():
    """One power iteration from the stored u, v per forward; at
    evaluation the forward leaves the buffers as they were (the JAX layer
    freezes them at evaluation; in training both advance them)."""
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 6)).astype(
        np.float32)
    jmod = jnn.SNConvTranspose2d(features=3, kernel_size=4, stride=2,
                                 padding=1)
    v = _init(jmod, x)
    tmod = tnn.SNConvTranspose2d(6, 3, 4, 2, 1).eval()
    load_jax_tree(tmod, v["params"], spectral=v["spectral"])
    u0, v0 = tmod.u.clone(), tmod.v.clone()
    want = np.asarray(jmod.apply(v, x))
    got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert torch.equal(tmod.u, u0) and torch.equal(tmod.v, v0)
    np.testing.assert_array_equal(tmod.u.numpy(), v["spectral"]["u"])
    # one iteration from (u, v) is not the converged sigma: a layer that
    # skipped the iteration (torch's spectral_norm at eval) would differ
    wm = tmod.weight.detach().reshape(6, -1)
    assert not torch.allclose(tmod.normalized_weight(),
                              tmod.weight / torch.linalg.matrix_norm(wm, 2))


def test_self_attention_with_gamma_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 4, 5, 16)).astype(
        np.float32)
    jmod = jnn.SelfAttention()
    v = _init(jmod, x)
    assert float(v["params"]["gamma"][0]) == pytest.approx(0.7)
    tmod = tnn.SelfAttention(16)
    load_jax_tree(tmod, v["params"])
    want = np.asarray(jmod.apply(v, x))
    got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(want - x).max() > 0.01  # the attention term is present


@pytest.mark.parametrize("shape", [(3, 4, 5, 6), (7, 6)],
                         ids=["2d", "1d"])
def test_batchnorm_eval_matches_jax(shape):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jmod = jnn.BatchNormTorch()
    v = _init(jmod, x, use_running_average=True)
    tmod = tnn.BatchNormTorch(shape[-1]).eval()
    load_jax_tree(tmod, v["params"], v["batch_stats"])
    want = np.asarray(jmod.apply(v, x, use_running_average=True))
    xt = _nchw(x) if len(shape) == 4 else torch.from_numpy(x)
    got = tmod(xt)
    got = _nhwc(got) if len(shape) == 4 else got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # train mode (ported with the DCGAN trainer): batch statistics, and
    # the running ones updated as the JAX layer updates them
    want, upd = jmod.apply(v, x, use_running_average=False,
                           mutable=["batch_stats"])
    got = tmod.train()(xt)
    got = _nhwc(got) if len(shape) == 4 else got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               upd["batch_stats"]["bn"]["mean"], atol=ATOL)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               upd["batch_stats"]["bn"]["var"], atol=ATOL)


def test_channels_to_linear_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 3, 3, 4)).astype(
        np.float32)
    jmod = jnn.ChannelsToLinear(7)
    v = _init(jmod, x)
    tmod = tnn.ChannelsToLinear(36, 7)
    load_jax_tree(tmod, v["params"])
    want = np.asarray(jmod.apply(v, x))
    got = tmod(_nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# --- models ------------------------------------------------------------------

@pytest.fixture(scope="module")
def vaegan():
    """(JAX encoder variables, JAX generator variables, port encoder, port
    generator)."""
    img = jnp.zeros((2, 64, 64, 3))
    ve = _init(JEncoder(Z_DIM, D), img, jax.random.key(5), train=False,
               rng=np.random.default_rng(6))
    vg = _init(JGenerator(Z_DIM, D), jnp.zeros((2, Z_DIM)), train=False,
               rng=np.random.default_rng(7))
    return (ve, vg, vaegan_from_jax_variables("encoder", ve),
            vaegan_from_jax_variables("generator", vg))


def test_encoder_encode_matches_jax(vaegan):
    ve, _, enc, _ = vaegan
    x = np.random.default_rng(8).uniform(-1, 1, (3, 64, 64, 3)).astype(
        np.float32)
    mu_j, lv_j = JEncoder(Z_DIM, D).apply(ve, x, False,
                                          method=JEncoder.encode)
    with torch.no_grad():
        mu_t, lv_t = enc.encode(_nchw(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), rtol=0,
                               atol=ATOL)
    # z = eps * exp(logvar) + mu (no 1/2), eps from the generator
    with torch.no_grad():
        z = enc(_nchw(x), torch.Generator().manual_seed(3))
    eps = torch.randn((3, Z_DIM), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(z, eps * torch.exp(lv_t) + mu_t)


def test_generator_matches_jax(vaegan):
    _, vg, _, gen = vaegan
    z = np.random.default_rng(9).standard_normal((3, Z_DIM)).astype(
        np.float32)
    want = np.asarray(JGenerator(Z_DIM, D).apply(vg, z, train=False))
    with torch.no_grad():
        got = _nhwc(gen(torch.from_numpy(z)))
    assert got.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bridge_round_trip(vaegan):
    ve, vg, enc, gen = vaegan
    for want, model in ((ve, enc), (vg, gen)):
        got = dump_jax_tree(model)
        assert set(got) == set(want)
        assert jax.tree_util.tree_structure(got) \
            == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="z_dim=16"):
        vaegan_from_jax_variables("generator", vg, z_dim=100)


@pytest.mark.parametrize("distance", ["l2", "l2-lpips"])
def test_reconstruction_scores_match_jax(vaegan, distance):
    """Both packages driven by deterministic encoder closures that share
    one numpy eps per batch (10 queries at batch 4: a partial last
    batch)."""
    ve, vg, enc, gen = vaegan
    rng = np.random.default_rng(10)
    queries = rng.uniform(-1, 1, (10, 64, 64, 3)).astype(np.float32)
    eps = rng.standard_normal((4, Z_DIM)).astype(np.float32)
    jenc, jgen = JEncoder(Z_DIM, D), JGenerator(Z_DIM, D)

    def j_encoder(x, _key):
        mu, lv = jenc.apply(ve, x, False, method=JEncoder.encode)
        return jnp.asarray(eps[:x.shape[0]]) * jnp.exp(lv) + mu

    def t_encoder(x, _gen):
        mu, lv = enc.encode(x.permute(0, 3, 1, 2))
        return torch.from_numpy(eps[:x.shape[0]]) * torch.exp(lv) + mu

    j_lp = t_lp = None
    if distance == "l2-lpips":
        params = j_default_lpips("vgg")
        j_lp = lambda a, b: j_lpips_pair(params, a, b)  # noqa: E731
        t_lp = lpips_from_jax_params(params).eval()
    want = j_reconstruction_scores(
        j_encoder, lambda z: jgen.apply(vg, z, train=False),
        jnp.asarray(queries), jax.random.key(0), lpips_pair_fn=j_lp,
        batch=4)
    got = reconstruction_scores(
        t_encoder, lambda z: gen(z).permute(0, 2, 3, 1), queries,
        lambda off: None, lpips_model=t_lp, batch=4, device="cpu")
    assert got.shape == (10,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want),
                               rtol=1e-5 if distance == "l2" else 1e-4)


def test_batch_generator_is_seeded_per_set_and_batch():
    draw = [torch.randn(4, generator=batch_generator(0, s, o, "cpu"))
            for s, o in ((0, 0), (0, 0), (1, 0), (0, 256), (0, 0))]
    assert torch.equal(draw[0], draw[1]) and torch.equal(draw[0], draw[4])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])


# --- the CLI end to end ----------------------------------------------------------

def _write_pngs(dirname, rng, n=6, size=(64, 64)):
    os.makedirs(dirname)
    for i in range(n):
        img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        PIL.Image.fromarray(img).save(os.path.join(dirname, f"{i}.png"))


@pytest.fixture(scope="module")
def trained_state_files(tmp_path_factory):
    """JAX ``build_state`` weights written as the trainer's msgpack and as
    path-keyed npz (as ``tests/test_reconstruction_pipeline.py`` does)."""
    d = tmp_path_factory.mktemp("vaegan")
    state = build_state(VAEGANConfig(z_dim=Z_DIM, d=D, image_size=64),
                        jax.random.key(0))
    gen = {"params": state.gen.params, "batch_stats": state.gen.batch_stats,
           "spectral": dict(state.gen.extra).get("spectral", {})}
    enc = {"params": state.enc.params, "batch_stats": state.enc.batch_stats}
    files = {}
    for name, tree in (("netG", gen), ("netE", enc)):
        files[name + ".msgpack"] = str(d / f"{name}.msgpack")
        files[name + ".npz"] = str(d / f"{name}.npz")
        j_save_state(files[name + ".msgpack"], tree)
        j_save_npz(files[name + ".npz"], tree)
    files["trees"] = (enc, gen)
    return files


def _flat(tree, prefix=()):
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def test_weight_files_load_like_the_jax_trees(trained_state_files):
    enc, gen = trained_state_files["trees"]
    for name, tree in (("netE", enc), ("netG", gen)):
        want = _flat(tree)
        for ext in ("msgpack", "npz"):
            got = _flat(load_variables(trained_state_files[f"{name}.{ext}"]))
            assert set(got) == set(want), (name, ext)
            for key, val in want.items():
                assert got[key].dtype == val.dtype, key
                np.testing.assert_array_equal(got[key], val)


def test_reconstruction_cli_end_to_end(trained_state_files, tmp_path,
                                       monkeypatch):
    rng = np.random.default_rng(11)
    pos_dir, neg_dir = str(tmp_path / "pos"), str(tmp_path / "neg")
    _write_pngs(pos_dir, rng)
    _write_pngs(neg_dir, rng)
    monkeypatch.chdir(tmp_path)
    losses = {}
    for ext in ("msgpack", "npz"):
        cli_recon.main([
            f"pos_data_dir={pos_dir}", f"neg_data_dir={neg_dir}",
            f"netE={trained_state_files['netE.' + ext]}",
            f"netG={trained_state_files['netG.' + ext]}",
            f"z_dim={Z_DIM}", f"d={D}", "reader=resize", "distance=l2",
            f"exp_name=e2e_{ext}", "batch=4"], device="cpu")
        save_dir = os.path.join(str(tmp_path), "recon_attack", f"e2e_{ext}")
        pos_loss = np.load(os.path.join(save_dir, "pos_loss.npy"))
        neg_loss = np.load(os.path.join(save_dir, "neg_loss.npy"))
        assert pos_loss.shape == (6, 1) and pos_loss.dtype == np.float64
        assert (pos_loss > 0).all() and (neg_loss > 0).all()
        # the reference's sequential-counter idx quirk (fbb.py:162,171)
        for name in ("pos_idx", "neg_idx"):
            np.testing.assert_array_equal(
                np.load(os.path.join(save_dir, f"{name}.npy")).ravel(),
                np.arange(6))
        for name in ("params.txt", "params.pkl", "0pos.png", "5neg.png"):
            assert os.path.exists(os.path.join(save_dir, name)), name
        with PIL.Image.open(os.path.join(save_dir, "0pos.png")) as im:
            assert im.size == (128, 64)
        out = evaluate_and_plot(EvalConfig(result_load_dir=save_dir))
        assert 0.0 <= out["auc"] <= 1.0
        losses[ext] = (pos_loss, neg_loss)
    # the same weights through either file format, the same seeded eps
    for a, b in zip(losses["msgpack"], losses["npz"]):
        np.testing.assert_array_equal(a, b)


def test_msgpack_without_package_names_npz_route(trained_state_files,
                                                 monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match=r"\.npz"):
        load_variables(trained_state_files["netE.msgpack"])


# --- the center-crop reader ------------------------------------------------------

@pytest.mark.parametrize("size,resolution", [((178, 218), 64),
                                             ((178, 218), 32),
                                             ((64, 64), 64)])
def test_read_image_center_crop_bit_for_bit(tmp_path, size, resolution):
    rng = np.random.default_rng(12)
    d = str(tmp_path / "imgs")
    _write_pngs(d, rng, n=3, size=size[::-1])
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        want = j_read_image_center_crop(path, resolution)
        got = read_image_center_crop(path, resolution)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        load_image_dir(d, resolution, reader=read_image_center_crop),
        j_load_image_dir(d, resolution, reader=j_read_image_center_crop))
