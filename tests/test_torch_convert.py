"""The port's weight converters (``ganleaks_tpu_torch.tools.convert_victim``,
``tools.convert_inception``) against the JAX package's on the CPU, on
synthetic state dicts: the port's own modules (which carry the
reference's state-dict keys) filled with seeded values, BatchNorm's
``num_batches_tracked`` added as the reference saves it, torchvision's
``fc`` / ``AuxLogits`` beside the Inception tower. No download.

For every ``CONVERTERS`` entry, medGAN's three parts and the Inception
tower: the npz each port tool's ``main`` writes from a ``.pth`` equals,
key for key and bit for bit, the JAX converter's ``convert_*`` output on
the same dict saved by the JAX package's ``save_params_npz``; that npz read
through the port's bridge (``weights.*_from_jax_variables``) is the module
the ``.pth`` loads by name, bit for bit. Each tool also runs as
``python -m`` in a fresh interpreter where JAX and the JAX package cannot
be imported, VAE-GAN's whole pickled ``netG.pt`` included.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ganleaks_tpu.tools import convert_inception as j_inception
from ganleaks_tpu.tools import convert_victim as j_victim
from ganleaks_tpu.utils.checkpoint import save_params_npz as j_save_npz
from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.models import dcgan, medgan, pggan, vaegan, wgangp
from ganleaks_tpu_torch.ops.inception import InceptionV3Pool3
from ganleaks_tpu_torch.tools import convert_inception, convert_victim
from ganleaks_tpu_torch.utils.checkpoint import (load_params_npz,
                                                 load_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """``model``'s reference-keyed state dict with seeded values (variances
    positive) and ``num_batches_tracked`` beside every running mean."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        val = rng.normal(0, 0.3, tuple(v.shape)).astype(np.float32)
        if k.endswith("running_var"):
            val = np.abs(val) + 0.5
        sd[k] = torch.from_numpy(val)
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(7)
    return sd


# (model, part) -> (port module the .pth loads into, port reader of the npz)
CASES = {
    ("dcgan", "generator"): (
        lambda: dcgan.Generator(nz=8, ngf=8),
        lambda v: weights.dcgan_from_jax_variables("generator", v)),
    ("dcgan", "discriminator"): (
        lambda: dcgan.Discriminator(ndf=8),
        lambda v: weights.dcgan_from_jax_variables("discriminator", v)),
    ("wgangp", "generator"): (
        lambda: wgangp.Generator(nz=8, ngf=8),
        lambda v: weights.wgangp_from_jax_variables("generator", v)),
    ("wgangp", "critic"): (
        lambda: wgangp.Critic(ndf=8),
        lambda v: weights.wgangp_from_jax_variables("critic", v)),
    ("pggan", "generator"): (
        lambda: pggan.Generator(32, 32),
        lambda v: weights.pggan_from_jax_variables("generator", v)),
    ("pggan", "critic"): (
        lambda: pggan.Discriminator(32),
        lambda v: weights.pggan_from_jax_variables("critic", v)),
    # privPGGAN's private critic: the same trunk, a 2-wide head
    ("pggan", "discriminator"): (
        lambda: pggan.Discriminator(32, n_outputs=2),
        lambda v: weights.pggan_from_jax_variables("critic", v)),
    ("vaegan", "generator"): (
        lambda: vaegan.Generator(16, 8),
        lambda v: weights.vaegan_from_jax_variables("generator", v)),
    ("vaegan", "encoder"): (
        lambda: vaegan.Encoder(16, 8),
        lambda v: weights.vaegan_from_jax_variables("encoder", v)),
    ("medgan", "gen"): (
        lambda: medgan.Generator(8, 8),
        lambda v: weights.medgan_from_jax_variables("gen", v)),
    ("medgan", "ae"): (
        lambda: medgan.Autoencoder(12, 8),
        lambda v: weights.medgan_from_jax_variables("ae", v)),
    ("medgan", "disc"): (
        lambda: medgan.Discriminator(12, 8, 6),
        lambda v: weights.medgan_from_jax_variables("disc", v)),
}


def test_every_converter_is_covered():
    assert set(convert_victim.CONVERTERS) == set(j_victim.CONVERTERS)
    assert set(CASES) == set(convert_victim.CONVERTERS) | {
        ("medgan", p) for p in ("gen", "ae", "disc")}


def _jax_variables(model, part, sd):
    if model == "medgan":
        return j_victim.convert_medgan(**{f"sd_{part}": sd})[part]
    return j_victim.CONVERTERS[(model, part)](sd)


def _assert_npz_equal(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_same_module(got, want):
    g, w = got.state_dict(), want.state_dict()
    assert set(g) == set(w)
    for k, v in w.items():
        assert torch.equal(g[k], v), k


@pytest.mark.parametrize("model,part", sorted(CASES), ids=lambda x: str(x))
def test_victim_npz_matches_jax_and_loads_as_the_pth(tmp_path, model, part):
    build, read = CASES[(model, part)]
    sd = seeded_state_dict(build(), sorted(CASES).index((model, part)))
    pth = str(tmp_path / "net.pth")
    torch.save(sd, pth)
    out = str(tmp_path / "port.npz")
    convert_victim.main(["--model", model, "--part", part, "--pth", pth,
                         "--out", out])
    want = str(tmp_path / "jax.npz")
    j_save_npz(want, _jax_variables(model, part, sd))
    _assert_npz_equal(out, want)
    _assert_same_module(read(load_params_npz(out)),
                        load_state_dict(build(), pth))


def test_inception_npz_matches_jax_and_loads_as_the_state_dict(tmp_path):
    sd = seeded_state_dict(InceptionV3Pool3(), 3)
    rng = np.random.default_rng(4)
    sd["fc.weight"] = torch.from_numpy(
        rng.standard_normal((10, 2048)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(10)
    sd["AuxLogits.conv0.conv.weight"] = torch.from_numpy(
        rng.standard_normal((128, 768, 1, 1)).astype(np.float32))
    pth = str(tmp_path / "inception.pth")
    torch.save(sd, pth)
    out = str(tmp_path / "port.npz")
    convert_inception.main(["--state_dict", pth, "--out", out])
    want = str(tmp_path / "jax.npz")
    j_save_npz(want, j_inception.convert_state_dict(sd))
    _assert_npz_equal(out, want)
    _assert_same_module(
        weights.inception_from_jax_params(load_params_npz(out)),
        weights.inception_from_torchvision_state_dict(sd))


BLOCKER = textwrap.dedent(f"""
    import importlib.abc, importlib.machinery, runpy, sys
    sys.path.insert(0, {REPO!r})
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "ganleaks_tpu")

    class _Refuse(importlib.abc.Loader):
        def create_module(self, spec):
            raise ImportError(f"blocked import of {{spec.name}}")

        def exec_module(self, module):
            pass

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                return importlib.machinery.ModuleSpec(name, _Refuse())
            return None

    sys.meta_path.insert(0, _Block())
    sys.argv = sys.argv[1:]
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
    bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not bad, bad
""")


def _run_module(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", BLOCKER, *argv],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)


def test_tools_run_without_jax(tmp_path):
    """Both tools under ``python -m`` with JAX and the JAX package
    unimportable: a DCGAN generator's state dict, VAE-GAN's whole pickled
    ``netG.pt`` (the ``weights_only`` retry) and an Inception state dict
    inside a whole module."""
    gen = dcgan.Generator(nz=8, ngf=8)
    sd = seeded_state_dict(gen, 5)
    torch.save(sd, tmp_path / "generator.pth")
    net_g = vaegan.Generator(16, 8)
    torch.save(net_g, tmp_path / "netG.pt")
    tower = InceptionV3Pool3()
    torch.save(tower, tmp_path / "inception.pt")
    for args in (
            ("ganleaks_tpu_torch.tools.convert_victim", "--model", "dcgan",
             "--part", "generator", "--pth", str(tmp_path / "generator.pth"),
             "--out", str(tmp_path / "g.npz")),
            ("ganleaks_tpu_torch.tools.convert_victim", "--model", "vaegan",
             "--part", "generator", "--pth", str(tmp_path / "netG.pt"),
             "--out", str(tmp_path / "netG.npz")),
            ("ganleaks_tpu_torch.tools.convert_inception", "--state_dict",
             str(tmp_path / "inception.pt"), "--out",
             str(tmp_path / "inception.npz"))):
        res = _run_module(*args)
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip().startswith("wrote ")
    _assert_same_module(weights.dcgan_from_jax_variables(
        "generator", load_params_npz(str(tmp_path / "g.npz"))),
        load_state_dict(dcgan.Generator(nz=8, ngf=8), sd))
    _assert_same_module(weights.vaegan_from_jax_variables(
        "generator", load_params_npz(str(tmp_path / "netG.npz"))), net_g)
    _assert_same_module(weights.inception_from_jax_params(
        load_params_npz(str(tmp_path / "inception.npz"))), tower)
