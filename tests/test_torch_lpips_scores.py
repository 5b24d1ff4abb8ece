"""The port's 2AFC/JND scorer CLI (``ganleaks_tpu_torch.cli.lpips_scores``)
and its network distances against the JAX package on the CPU (mirrors
``tests/test_lpips_scores_cli.py``): both input forms (one .npz and the
original LPIPS directory layout), the host baselines, and 'net-lin' /
'net' through ``make_pair_dist_fn`` on one shared LPIPS npz (distances
within rtol 1e-5 plus atol 1e-6, the CLI's score within 1e-6 of the JAX
CLI's on the same file)."""

import json
import os

import numpy as np
import pytest
import torch

from ganleaks_tpu.cli.lpips_scores import main as j_main
from ganleaks_tpu.io.images import save_png
from ganleaks_tpu.ops.lpips.scoring import make_pair_dist_fn as j_dist_fn
from ganleaks_tpu_torch.cli.lpips_scores import main
from ganleaks_tpu_torch.io.images import load_image_dir
from ganleaks_tpu_torch.ops import lpips as tl
from ganleaks_tpu_torch.ops.lpips.fakenets import l2_distance
from ganleaks_tpu_torch.ops.lpips.scoring import (make_pair_dist_fn,
                                                  score_2afc, score_jnd)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's CPU thread
    pool in each of them, on top of the others, slows every process many
    times over. One thread per process for this module's convolutions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rand_imgs(rng, n, res=16):
    return rng.uniform(-1, 1, size=(n, res, res, 3)).astype(np.float32)


def test_2afc_npz_l2_matches_direct_and_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    ref, p0, p1 = (rand_imgs(rng, 12) for _ in range(3))
    judge = rng.uniform(0, 1, 12)
    npz = tmp_path / "triplets.npz"
    np.savez(npz, ref=ref, p0=p0, p1=p1, judge=judge)
    out = tmp_path / "out.json"
    res = main([f"data_dir={npz}", "mode=2afc", "model=l2", "batch_size=5",
                f"out_json={out}"])
    got = json.loads(out.read_text())
    assert got == res == json.loads(capsys.readouterr().out.strip())
    want = score_2afc(l2_distance(ref, p0), l2_distance(ref, p1), judge)
    assert got["n"] == 12
    assert abs(got["score"] - want) < 1e-12
    j_out = tmp_path / "jax.json"
    j_main([f"data_dir={npz}", "mode=2afc", "model=l2", "batch_size=5",
            f"out_json={j_out}"])
    assert json.loads(j_out.read_text()) == got


def test_jnd_directory_layout(tmp_path):
    rng = np.random.default_rng(1)
    n = 10
    for sub in ("p0", "p1"):
        os.makedirs(tmp_path / sub)
        for k in range(n):
            save_png(rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32),
                     str(tmp_path / sub / f"{k:03d}.png"), drange=(-1, 1))
    os.makedirs(tmp_path / "same")
    sames = rng.integers(0, 2, n).astype(np.float64)
    for k in range(n):
        np.save(tmp_path / "same" / f"{k:03d}.npy", sames[k])
    out = tmp_path / "out.json"
    main([f"data_dir={tmp_path}", "mode=jnd", "model=ssim", "resolution=16",
          f"out_json={out}"])
    got = json.loads(out.read_text())
    a = load_image_dir(str(tmp_path / "p0"), resolution=16)
    b = load_image_dir(str(tmp_path / "p1"), resolution=16)
    want = score_jnd(make_pair_dist_fn("ssim")(a, b), sames)
    assert got["n"] == n and got["mode"] == "jnd"
    assert abs(got["score"] - want) < 1e-12
    j_out = tmp_path / "jax.json"
    j_main([f"data_dir={tmp_path}", "mode=jnd", "model=ssim",
            "resolution=16", f"out_json={j_out}"])
    assert json.loads(j_out.read_text()) == got


@pytest.fixture(scope="module")
def npz_by_net(tmp_path_factory):
    """One LPIPS npz per tower (the port's seeded surrogate, real heads for
    vgg), written by the port in the schema both packages read."""
    d = tmp_path_factory.mktemp("lpips_npz")
    out = {}
    for net in ("vgg", "alex", "squeeze", "resnet"):
        out[net] = str(d / f"{net}.npz")
        tl.save_lpips_params(out[net], tl.default_lpips_params(net, seed=1))
    return out


@pytest.mark.parametrize("model,net", [
    ("net-lin", "vgg"), ("net-lin", "alex"), ("net-lin", "squeeze"),
    ("net", "resnet"), ("net", "alex")])
def test_network_dist_fn_matches_jax(npz_by_net, model, net):
    rng = np.random.default_rng(2)
    a, b = rand_imgs(rng, 4, 32), rand_imgs(rng, 4, 32)
    got = make_pair_dist_fn(model, net=net, weights=npz_by_net[net],
                            device="cpu")(a, b)
    want = j_dist_fn(model, net=net, weights=npz_by_net[net])(a, b)
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_netlin_cli_score_matches_jax_cli(npz_by_net, tmp_path):
    """The CLI on an npz of 2AFC triplets, alex 'net-lin': the same score
    as the JAX CLI on the same file."""
    rng = np.random.default_rng(3)
    ref = rand_imgs(rng, 10, 32)
    p0 = np.clip(ref + rng.normal(0, 0.1, ref.shape), -1, 1
                 ).astype(np.float32)
    p1 = rand_imgs(rng, 10, 32)
    judge = (rng.random(10) < 0.3).astype(np.float64)
    npz = tmp_path / "t.npz"
    np.savez(npz, ref=ref, p0=p0, p1=p1, judge=judge)
    argv = [f"data_dir={npz}", "mode=2afc", "model=net-lin", "net=alex",
            f"weights={npz_by_net['alex']}", "batch_size=4"]
    got = main(argv + [f"out_json={tmp_path / 'p.json'}"], device="cpu")
    j_main(argv + [f"out_json={tmp_path / 'j.json'}"])
    want = json.loads((tmp_path / "j.json").read_text())
    assert abs(got["score"] - want["score"]) < 1e-6
    assert got["n"] == want["n"] == 10


def test_unknown_model_and_mode_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown distance model"):
        make_pair_dist_fn("resnet-gan")
    npz = tmp_path / "x.npz"
    np.savez(npz, p0=np.zeros((1, 8, 8, 3)))
    with pytest.raises(ValueError, match="unknown mode"):
        main([f"data_dir={npz}", "mode=3afc", "model=l2"])
