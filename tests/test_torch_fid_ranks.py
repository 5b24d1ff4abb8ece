"""FID over ranks (``ganleaks_tpu_torch.ops.fid`` with a mesh; the JAX
package's ``--n_chips``, ``ganleaks_tpu/ops/fid.py:38-63``): each
Inception batch split over two and three ``gloo`` ranks on the CPU, the
activations all-gathered in image order, against one process and the
JAX package's batch-sharded activations on its virtual CPU mesh; and the
CLI's ``--n_chips 2`` on statistic files.

Bars: the activations in image order, within 1e-5 of the largest
activation of one process (each rank runs the tower on its share of a
batch, whose convolutions may sum in another order); the FID within
1e-4 relative of one process's; the JAX package's activations as
``tests/test_torch_fid.py`` holds them.
"""

import numpy as np
import pytest
import torch

import torch_rank_workers as workers
from ganleaks_tpu_torch.ops import fid as tfid
from ganleaks_tpu_torch.parallel.multihost import launch

BATCH = 4
LAUNCH_S = 300


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 255, (6, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.uniform(-20, 20, a.shape), 0, 255).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def single(images):
    before = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks
    model = tfid.init_inception_params(0)
    a, b = images
    out = {"acts": tfid.get_activations(model, a, BATCH, device="cpu"),
           "tail": tfid.get_activations(model, a, BATCH,
                                        drop_remainder=False, device="cpu"),
           "fid": tfid.fid_from_image_sets(model, a, b, BATCH,
                                           method="eigh", device="cpu")}
    torch.set_num_threads(before)
    return out


@pytest.fixture(scope="module", params=(2, 3), ids=lambda n: f"ranks{n}")
def ranks(request, images):
    a, b = images
    return launch(workers.fid_case, request.param, a, b, BATCH,
                  devices="cpu", timeout_s=LAUNCH_S)


@pytest.mark.parametrize("key", ("acts", "tail"))
def test_activations_over_ranks_in_image_order(ranks, single, key):
    got, want = ranks[key], single[key]
    assert got.shape == want.shape == ((4, 2048) if key == "acts"
                                       else (6, 2048))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    # every rank returned the same activations
    assert len(set(ranks["same"])) == 1


def test_fid_over_ranks_equals_one_rank(ranks, single):
    assert ranks["fid"] == pytest.approx(single["fid"], rel=1e-4)


def test_activations_match_jax_mesh(images):
    import jax
    from jax.sharding import Mesh

    from ganleaks_tpu.ops import fid as jfid
    from ganleaks_tpu_torch.weights import inception_from_jax_params

    params = jfid.init_inception_params(0)
    model = inception_from_jax_params(params)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    want = jfid.get_activations(params, images[0], BATCH, mesh=mesh)
    got = tfid.get_activations(model, images[0], BATCH, device="cpu")
    # the port's ranks are held to one process above; one process is held
    # to the JAX tower as test_torch_fid.py holds it
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_cli_n_chips_two_on_statistics(tmp_path, capsys):
    from ganleaks_tpu_torch.cli import fid as cli_fid

    rng = np.random.default_rng(10)
    paths = []
    for name in ("a", "b"):
        x = rng.standard_normal((20, 3))
        p = str(tmp_path / f"{name}.npz")
        np.savez(p, mu=x.mean(0), sigma=np.cov(x, rowvar=False))
        paths.append(p)
    cli_fid.main(paths + ["--sqrtm", "scipy"], device="cpu")
    one = float(capsys.readouterr().out.split("FID:")[1])
    cli_fid.main(paths + ["--sqrtm", "scipy", "--n_chips", "2"],
                 device="cpu")
    two = float(capsys.readouterr().out.split("FID:")[1])
    assert two == one
