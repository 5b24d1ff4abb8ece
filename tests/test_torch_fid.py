"""The port's FID (``ganleaks_tpu_torch.ops.fid``, ``ops.inception``,
``cli.fid``) against the JAX package's on the CPU.

Weights: one randomised flax variables tree of ``InceptionV3Pool3`` (the
shapes from ``jax.eval_shape`` of its init; conv kernels He-scaled normal,
BatchNorm scale and var uniform in [0.5, 1.5], bias and mean N(0, 0.1):
randomised as in ``tests/test_convert_inception.py`` but with positive
variances, so every activation is finite) carried into the port by
``weights.inception_from_jax_params``.

Tolerances, and how they were chosen:
* pool_3 activations: |port - JAX| <= 1e-5 * max|JAX| — both sum the same
  float32 products in different orders through ~95 layers; the observed
  gap is ~1e-6 of the maximum.
* ``preprocess``: atol 1e-6 on values in [-1, 1] — the two bilinear
  resizes compute their weights in different float32 expressions (the
  observed gap is 2.4e-7, one or two ulps near 1).
* ``frechet_distance``: 'scipy' equal to 1e-12 relative (same host
  code); 'newton-schulz' and 'eigh' within rtol 1e-4 plus 1e-5 * (Tr S1 +
  Tr S2): the port's square roots run in float64, the JAX package's in
  float32, which rounds relative to the traces it cancels against, not to
  the FID (FID ~512 against traces ~1e4 in the image-npz case differs by
  0.066 between the packages). The port is also held to scipy at
  tests/test_fid_split.py's bar, rtol 1e-3 plus atol 1e-3, on
  ill-conditioned statistics where float32 misses that bar.
* end to end (4 + 4 images, batch 2, 'eigh'), and the image npz through
  ``fid_from_paths`` (against the float64 FID of the JAX package's
  statistics of that file, ``_fid_float64``, which its 'scipy' route
  approximates): the same bound, with the activation gap (1e-5 of the
  maximum) propagated through the statistics.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops import fid as jfid
from ganleaks_tpu.ops.inception import InceptionV3Pool3 as JInception
from ganleaks_tpu.ops.inception import preprocess as jpreprocess
from ganleaks_tpu.tools.convert_inception import convert_state_dict
from ganleaks_tpu_torch.cli import fid as cli_fid
from ganleaks_tpu_torch.ops import fid as tfid
from ganleaks_tpu_torch.ops.inception import (InceptionV3Pool3,
                                              avg_pool_3x3_s1, preprocess)
from ganleaks_tpu_torch.utils.checkpoint import save_params_npz
from ganleaks_tpu_torch.weights import (inception_from_jax_params,
                                        inception_from_torchvision_state_dict,
                                        inception_to_jax_params)

ACT_RTOL = 1e-5
FID_RTOL = 1e-4
TRACE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's CPU thread
    pool in each of them, on top of the others, slows every process many
    times over. One thread per process for this module's convolutions,
    and for the BLAS under numpy and scipy (the 2048-wide square roots and
    eigendecompositions), whose pool in every process is one thread per
    core as well."""
    from threadpoolctl import threadpool_limits

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(before)


def _fid_float64(acts1, mu2, sigma2) -> float:
    """The FID of ``acts1``'s statistics (``activation_statistics``: mean,
    ``np.cov``) against (mu2, sigma2), in float64 without a 2048-wide
    root: with S1 = A A^T (A the centred activations over sqrt(n - 1), n
    columns), the nonzero eigenvalues of S1 S2 are those of the n x n
    matrix A^T S2 A, so Tr sqrt(S1 S2) is the sum of their square roots
    (exact for PSD S2)."""
    a = np.asarray(acts1, np.float64)
    mu1 = a.mean(0)
    cen = (a - mu1).T / np.sqrt(len(a) - 1)
    w = np.linalg.eigvalsh(cen.T @ np.asarray(sigma2, np.float64) @ cen)
    diff = mu1 - np.asarray(mu2, np.float64)
    return float(diff @ diff + (cen * cen).sum() + np.trace(sigma2)
                 - 2.0 * np.sqrt(np.clip(w, 0.0, None)).sum())


def _assert_fid_close(got, want, sigma1, sigma2):
    atol = TRACE_TOL * (np.trace(sigma1) + np.trace(sigma2))
    np.testing.assert_allclose(got, want, rtol=FID_RTOL, atol=atol)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_variables():
    shapes = jax.eval_shape(JInception().init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 75, 75, 3), jnp.float32))
    rng = np.random.default_rng(1)

    def leaf(path, s):
        name = path[-1].key
        if name == "conv":
            fan_in = int(np.prod(s.shape[:3]))
            return (rng.standard_normal(s.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def port_model(jax_variables):
    return inception_from_jax_params(jax_variables)


@pytest.fixture(scope="module")
def image_sets():
    """Whole byte values, so the uint8 copy of the first set is the same
    input."""
    rng = np.random.default_rng(2)
    imgs1 = rng.integers(0, 256, (4, 64, 64, 3)).astype(np.float32)
    return imgs1, imgs1 * 0.5 + 64.0


@pytest.fixture(scope="module")
def jax_acts(jax_variables, image_sets):
    """The JAX package's pool_3 activations of both sets at batch 2
    (through its ``preprocess``), computed once for the module."""
    return [jfid.get_activations(jax_variables, imgs, batch_size=2)
            for imgs in image_sets]


def _to_torchvision_sd(variables) -> dict:
    """The torchvision checkpoint layout of a flax tree (as
    ``tests/test_convert_inception.py`` builds it)."""
    sd = {}
    for path, leaf in _flatten(variables["params"]).items():
        if path[-1] == "conv":
            sd[".".join(path) + ".weight"] = leaf.transpose(3, 2, 0, 1)
        elif path[-1] == "scale":
            sd[".".join(path[:-1]) + ".weight"] = leaf
        else:
            sd[".".join(path[:-1]) + ".bias"] = leaf
    for path, leaf in _flatten(variables["batch_stats"]).items():
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        sd[".".join(path[:-1]) + "." + name] = leaf
    return sd


def test_tower_matches_jax_at_75px(jax_variables, port_model):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 75, 75, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(JInception().apply)(jax_variables, x))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ACT_RTOL * np.abs(want).max())


def test_bridge_round_trip(jax_variables, port_model):
    back = _flatten(inception_to_jax_params(port_model))
    want = _flatten(jax_variables)
    assert set(back) == set(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], err_msg=str(key))


def test_torchvision_state_dict_matches_converter(jax_variables, port_model):
    """One torchvision-layout file serves both packages: the port's loader
    and ``convert_state_dict`` (then the bridge) give the same tower, with
    ``fc.*`` and ``AuxLogits.*`` skipped."""
    rng = np.random.default_rng(4)
    sd = _to_torchvision_sd(jax_variables)
    sd["fc.weight"] = rng.standard_normal((1000, 2048)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal((1000,)).astype(np.float32)
    sd["AuxLogits.conv0.conv.weight"] = rng.standard_normal(
        (128, 768, 1, 1)).astype(np.float32)
    sd["Mixed_5b.branch1x1.bn.num_batches_tracked"] = np.asarray(7)
    direct = inception_from_torchvision_state_dict(
        {k: torch.as_tensor(v) for k, v in sd.items()})
    via_jax = inception_from_jax_params(convert_state_dict(sd))
    got, want = direct.state_dict(), via_jax.state_dict()
    for key, val in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], val), key
            assert torch.equal(got[key], port_model.state_dict()[key]), key
    with pytest.raises(KeyError, match="missing keys"):
        inception_from_torchvision_state_dict(
            {k: v for k, v in sd.items() if not k.startswith("Mixed_7c")})


@pytest.mark.parametrize("res", [64, 320], ids=["up_64", "down_320"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_preprocess_matches_jax(res, dtype):
    """F.interpolate(bilinear, antialias=False) equals
    jax.image.resize(bilinear, antialias=False) upscaling and
    downscaling."""
    rng = np.random.default_rng(res)
    imgs = rng.uniform(0, 255, (2, res, res, 3)).astype(dtype)
    want = np.asarray(jpreprocess(jnp.asarray(imgs)))
    got = preprocess(torch.from_numpy(imgs)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_avg_pool_counts_padding():
    """flax ``avg_pool`` with padding 1 divides by 9 at the borders too."""
    from flax import linen as nn

    x = np.random.default_rng(5).standard_normal((2, 6, 7, 3)).astype(
        np.float32)
    want = np.asarray(nn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                                  padding=((1, 1), (1, 1))))
    got = avg_pool_3x3_s1(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)
    x1 = torch.ones((1, 1, 4, 4))
    assert float(avg_pool_3x3_s1(x1)[0, 0, 0, 0]) == pytest.approx(4 / 9)


class _Probe(torch.nn.Module):
    """Stand-in tower: the per-channel mean of the preprocessed batch, so
    batching is checked without the Inception cost."""

    def forward(self, x):
        return x.mean(dim=(2, 3))


@pytest.mark.parametrize("drop", [True, False])
def test_get_activations_remainder(drop):
    imgs = np.random.default_rng(6).uniform(0, 255, (5, 16, 16, 3)).astype(
        np.float32)
    acts = tfid.get_activations(_Probe(), imgs, batch_size=2,
                                drop_remainder=drop, device="cpu")
    assert acts.dtype == np.float32
    # z_fid.py:88 drops the last partial batch: 5 images at batch 2 -> 4
    assert acts.shape == ((4, 3) if drop else (5, 3))
    whole = _Probe()(preprocess(torch.from_numpy(imgs))).numpy()
    np.testing.assert_allclose(acts, whole[:len(acts)], rtol=1e-6)


def _random_stats(rng, dim=16, n=200):
    a = rng.standard_normal((n, dim))
    b = rng.standard_normal((n, dim)) * 1.3 + 0.4
    return (a.mean(0), np.cov(a, rowvar=False),
            b.mean(0), np.cov(b, rowvar=False))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", ["newton-schulz", "eigh", "scipy"])
def test_frechet_distance_matches_jax(method, dtype):
    """The port's float64 square roots against the JAX package's float32
    ones, on float32 and on float64 (``np.cov``'s) statistics."""
    m1, s1, m2, s2 = (a.astype(dtype) for a in
                      _random_stats(np.random.default_rng(7), dim=64))
    want = jfid.frechet_distance(m1, s1, m2, s2, method=method)
    got = tfid.frechet_distance(m1, s1, m2, s2, method=method, device="cpu")
    if method == "scipy":
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        _assert_fid_close(got, want, s1, s2)
    assert abs(tfid.frechet_distance(m1, s1, m1, s1, method=method,
                                     device="cpu")) < 1e-3


def _ill_conditioned_stats():
    """Statistics whose eigenvalues span 5 decades, as full-width pool_3
    statistics do, of two nearly equal sets (FID ~10 against traces
    ~490)."""
    rng = np.random.default_rng(11)
    dim = 128
    scales = np.sqrt(np.logspace(-4, 1.3, dim))
    rot, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    stats = []
    for gain in (1.0, 1.1):
        x = (rng.standard_normal((4 * dim, dim)) * scales * gain) @ rot.T
        stats += [x.mean(0), np.cov(x, rowvar=False)]
    return stats


def _indefinite_stats():
    """Statistics whose second covariance has an eigenvalue of -1e-5 (below
    the -eps offset), as rounding can leave a saved one: Newton-Schulz
    diverges on the product in any precision, scipy's root carries an
    imaginary part small enough for its guard."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((200, 16))
    b = rng.standard_normal((200, 16)) * 1.3 + 0.4
    w, v = np.linalg.eigh(np.cov(b, rowvar=False))
    w[0] = -1e-5
    return a.mean(0), np.cov(a, rowvar=False), b.mean(0), (v * w) @ v.T


def test_device_sqrtm_falls_back_to_scipy_like_jax():
    """On an indefinite covariance both packages warn, take the scipy path
    and agree. On rank-deficient statistics (3 samples of 16 features) the
    JAX package's float32 root still falls back; the port's float64 root
    converges, to the value of JAX's scipy path, with no warning."""
    stats = _indefinite_stats()
    with pytest.warns(UserWarning, match="falling back to the scipy path"):
        want = jfid.frechet_distance(*stats, method="newton-schulz")
    before = tfid.frechet_distance.scipy_fallbacks
    with pytest.warns(UserWarning, match="falling back to the scipy path"):
        got = tfid.frechet_distance(*stats, method="newton-schulz",
                                    device="cpu")
    assert tfid.frechet_distance.scipy_fallbacks == before + 1
    np.testing.assert_allclose(got, want, rtol=1e-12)

    rng = np.random.default_rng(8)
    a = rng.standard_normal((3, 16)) * 3
    b = rng.standard_normal((3, 16)) * 2 + 0.5
    stats = (a.mean(0), np.cov(a, rowvar=False),
             b.mean(0), np.cov(b, rowvar=False))
    with pytest.warns(UserWarning, match="falling back to the scipy path"):
        want = jfid.frechet_distance(*stats, method="newton-schulz")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        got = tfid.frechet_distance(*stats, method="newton-schulz",
                                    device="cpu")
        tfid.frechet_distance(*_random_stats(rng), method="newton-schulz",
                              device="cpu")
    assert abs(got - want) <= 1e-3 + 1e-3 * abs(want)
    assert tfid.frechet_distance.scipy_fallbacks == before + 1


def test_device_square_roots_run_in_float64():
    """Both device square roots meet scipy at tests/test_fid_split.py's bar
    on ill-conditioned statistics without a fall-back, given them in
    float64 or in float32; the JAX package's float32 'eigh' misses it (the
    similarity R S2 R squares the spread of the eigenvalues, past
    float32's precision)."""
    stats = _ill_conditioned_stats()
    stats32 = [s.astype(np.float32) for s in stats]
    want = tfid.frechet_distance(*stats, method="scipy")
    bar = 1e-3 + 1e-3 * abs(want)
    before = tfid.frechet_distance.scipy_fallbacks
    for method in ("newton-schulz", "eigh"):
        for given in (stats, stats32):
            got = tfid.frechet_distance(*given, method=method, device="cpu")
            assert abs(got - want) <= bar, (method, got, want)
    assert tfid.frechet_distance.scipy_fallbacks == before
    assert abs(jfid.frechet_distance(*stats32, method="eigh") - want) > bar


def test_fid_end_to_end_matches_jax(port_model, image_sets, jax_acts):
    """The port's ``fid_from_image_sets`` against the JAX package's, whose
    body is ``activation_statistics`` of ``get_activations`` of each set,
    then ``frechet_distance``."""
    imgs1, imgs2 = image_sets
    (m1, s1), (m2, s2) = (jfid.activation_statistics(a) for a in jax_acts)
    want = jfid.frechet_distance(m1, s1, m2, s2, method="eigh")
    got = tfid.fid_from_image_sets(port_model, imgs1, imgs2, batch_size=2,
                                   method="eigh", device="cpu")
    assert np.isfinite(got) and got > 0
    _assert_fid_close(got, want, s1, s2)


@pytest.fixture(scope="module")
def image_npz_route(port_model, image_sets, jax_acts, tmp_path_factory):
    """The port's ``fid_from_paths`` of an image npz (the first set as
    uint8 bytes at native size) against a mu/sigma npz, through its
    'scipy' and float64 'eigh' routes, with the port's activations of the
    same bytes. The 'scipy' route takes one 2048-wide Schur root of a
    rank-3 product, the costliest step of the module (~25 s on one
    thread): it is taken once, here."""
    tmp = tmp_path_factory.mktemp("fid_npz")
    imgs = image_sets[0].astype(np.uint8)
    pimg = str(tmp / "images.npz")
    np.savez(pimg, images=imgs)
    mu, sigma = jfid.activation_statistics(jax_acts[0])
    pst = str(tmp / "ref_stats.npz")
    np.savez(pst, mu=mu + 0.5, sigma=sigma)
    fids = {method: tfid.fid_from_paths(port_model, pimg, pst, batch_size=2,
                                        method=method, device="cpu")
            for method in ("scipy", "eigh")}
    acts_t = tfid.get_activations(port_model, imgs, batch_size=2,
                                  device="cpu")
    return {"fids": fids, "acts_t": acts_t, "mu": mu + 0.5, "sigma": sigma}


def test_fid_from_paths_matches_jax(jax_variables, port_model, jax_acts,
                                    image_npz_route, tmp_path):
    """A mu/sigma npz on both sides, then an image npz (uint8 bytes at
    native size) against a mu/sigma npz."""
    m1, s1, m2, s2 = _random_stats(np.random.default_rng(9), dim=64)
    p1, p2 = str(tmp_path / "s1.npz"), str(tmp_path / "s2.npz")
    np.savez(p1, mu=m1, sigma=s1)
    np.savez(p2, mu=m2, sigma=s2)
    want = jfid.fid_from_paths(jax_variables, p1, p2, method="eigh")
    got = tfid.fid_from_paths(port_model, p1, p2, method="eigh",
                              device="cpu")
    _assert_fid_close(got, want, s1, s2)

    acts_j, acts_t = jax_acts[0], image_npz_route["acts_t"]
    np.testing.assert_allclose(acts_t, acts_j, rtol=0,
                               atol=ACT_RTOL * np.abs(acts_j).max())
    mu2, sigma = image_npz_route["mu"], image_npz_route["sigma"]
    # the JAX package's FID of the same file, exactly in float64: its
    # image-npz route takes the statistics of acts_j (the same bytes at
    # batch 2) against these. Four images give rank-3 statistics, where
    # its float32 'eigh' is 0.28 off that value (the 2045 null
    # eigenvalues' rounding, square-rooted) and its scipy route takes a
    # 2048-wide Schur root of a singular product (a minute or more on a
    # busy host) to approximate it; the port's 'scipy' and float64 'eigh'
    # routes are held to the exact value
    want = _fid_float64(acts_j, mu2, sigma)
    for method in ("scipy", "eigh"):
        got = image_npz_route["fids"][method]
        assert np.isfinite(got) and got > 0
        _assert_fid_close(got, want, sigma, sigma)
    # and the npz route is the port's activations and statistics exactly
    assert got == tfid.frechet_distance(
        *tfid.activation_statistics(acts_t), mu2, sigma, method="eigh",
        device="cpu")


def test_cli_with_weights_and_surrogate(jax_variables, tmp_path, capsys):
    m1, s1, m2, s2 = _random_stats(np.random.default_rng(10))
    p1, p2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    np.savez(p1, mu=m1, sigma=s1)
    np.savez(p2, mu=m2, sigma=s2)
    weights = str(tmp_path / "inception.npz")
    save_params_npz(weights, jax_variables)
    cli_fid.main([p1, p2, "--weights", weights, "--sqrtm", "scipy"],
                 device="cpu")
    out = capsys.readouterr().out
    assert "surrogate" not in out
    value = float(out.split("FID:")[1])
    want = jfid.frechet_distance(m1, s1, m2, s2, method="scipy")
    assert value == pytest.approx(want, rel=1e-12)
    cli_fid.main([p1, p2, "--sqrtm", "eigh"], device="cpu")
    assert "surrogate" in capsys.readouterr().out
    # two ranks (gloo processes on the CPU) read the same statistics
    cli_fid.main([p1, p2, "--weights", weights, "--sqrtm", "scipy",
                  "--n_chips", "2"], device="cpu")
    assert float(capsys.readouterr().out.split("FID:")[1]) == value


def test_surrogate_init_is_seeded_he():
    a = tfid.init_inception_params(0)
    b = tfid.init_inception_params(0)
    c = tfid.init_inception_params(1)
    wa = a.Mixed_6b.branch7x7_2.conv.weight
    assert torch.equal(wa, b.Mixed_6b.branch7x7_2.conv.weight)
    assert not torch.equal(wa, c.Mixed_6b.branch7x7_2.conv.weight)
    fan_in = wa.shape[1] * wa.shape[2] * wa.shape[3]
    std = (2.0 / fan_in) ** 0.5 / .87962566103423978
    assert float(wa.abs().max()) <= 2 * std
    assert float(wa.std()) == pytest.approx((2.0 / fan_in) ** 0.5, rel=0.05)
    bn = a.Mixed_6b.branch7x7_2.bn
    assert bool((bn.weight == 1).all() and (bn.running_var == 1).all())
    assert not a.training
