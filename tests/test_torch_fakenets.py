"""The port's copies of the numpy modules ``ops/lpips/fakenets`` (l2 and
DSSIM, RGB and Lab) and ``ops/lpips/scoring`` (2AFC and JND scores, the
dataset loops), against the JAX package's: the same numpy code, so the
results are equal exactly. Mirrors ``tests/test_fakenets.py`` (CIELAB
reference values, SSIM properties, the Lab byte truncation, the scores'
edge cases)."""

import numpy as np
import pytest

from ganleaks_tpu.ops.lpips import fakenets as jf
from ganleaks_tpu.ops.lpips import scoring as js
from ganleaks_tpu_torch.ops.lpips import fakenets as tf
from ganleaks_tpu_torch.ops.lpips import scoring as ts


def test_rgb2lab_reference_values_and_equal_to_jax(rng):
    rgb = np.array([[[1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]])
    lab = tf.rgb2lab(rgb)[0]
    np.testing.assert_allclose(lab[0], [100.0, 0.0, 0.0], atol=0.02)
    np.testing.assert_allclose(lab[1], [0.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(lab[2], [53.24, 80.09, 67.20], atol=0.05)
    x = rng.uniform(0, 1, (3, 9, 9, 3))
    np.testing.assert_array_equal(tf.rgb2lab(x), jf.rgb2lab(x))


def test_ssim_identity_ordering_and_equal_to_jax(rng):
    a = rng.uniform(0, 255, (32, 32, 3))
    assert abs(tf.ssim(a, a, 255.0) - 1.0) < 1e-12
    slight = a + rng.normal(0, 2, a.shape)
    heavy = a + rng.normal(0, 40, a.shape)
    s1, s2 = tf.ssim(a, slight, 255.0), tf.ssim(a, heavy, 255.0)
    assert 1.0 > s1 > s2
    assert s1 == jf.ssim(a, slight, 255.0) and s2 == jf.ssim(a, heavy, 255.0)


@pytest.mark.parametrize("colorspace", ["RGB", "Lab"])
def test_l2_and_dssim_equal_to_jax(rng, colorspace):
    a = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    for fn in ("l2_distance", "dssim_distance"):
        got = getattr(tf, fn)(a, b, colorspace)
        np.testing.assert_array_equal(got, getattr(jf, fn)(a, b, colorspace))
        assert got.shape == (3,) and (got > 0).all()
        np.testing.assert_allclose(getattr(tf, fn)(a, a, colorspace), 0.0,
                                   atol=1e-12)
    if colorspace == "RGB":
        np.testing.assert_allclose(tf.l2_distance(a, b, "RGB"),
                                   np.mean((a - b) ** 2, axis=(1, 2, 3)),
                                   rtol=1e-6)
    assert (tf.dssim_distance(a, b, colorspace) < 1).all()


def test_lab_l2_byte_truncation(rng):
    """tensor2im truncates to uint8 before rgb2lab and util.l2 carries a
    0.5 factor (``util.py:42-43,134-138``)."""
    x0 = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    x1 = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    u0 = ((x0.astype(np.float64) + 1.0) * 127.5).astype(np.uint8)
    u1 = ((x1.astype(np.float64) + 1.0) * 127.5).astype(np.uint8)
    ref = 0.5 * np.mean((tf.rgb2lab(u0 / 255.0) / 100.0
                         - tf.rgb2lab(u1 / 255.0) / 100.0) ** 2,
                        axis=(1, 2, 3))
    np.testing.assert_allclose(tf.l2_distance(x0, x1, "Lab"), ref,
                               rtol=1e-12)


def test_2afc_and_jnd_scores_equal_to_jax(rng):
    gts = (rng.random(50) > 0.5).astype(np.float64)
    d0 = np.where(gts == 1, 0.9, 0.1)
    d1 = np.where(gts == 1, 0.1, 0.9)
    assert ts.score_2afc(d0, d1, gts) == 1.0
    assert ts.score_2afc(d1, d0, gts) == 0.0
    assert ts.score_2afc(d0, d0, gts) == 0.5  # exact ties score 0.5
    sames = np.array([1, 1, 1, 0, 0, 0], np.float64)
    ds = np.array([0.1, 0.2, 0.3, 0.8, 0.9, 1.0])
    assert abs(ts.score_jnd(ds, sames) - 1.0) < 1e-12
    for _ in range(3):
        d0, d1, g = rng.random(200), rng.random(200), rng.random(200)
        d1[:10] = d0[:10]
        assert ts.score_2afc(d0, d1, g) == js.score_2afc(d0, d1, g)
        same = (rng.random(200) < 0.4).astype(np.float64)
        assert ts.score_jnd(d0, same) == js.score_jnd(d0, same)


def test_dataset_loops_equal_to_jax(rng):
    """``score_2afc_dataset`` / ``score_jnd_dataset`` over batches with the
    host 'l2' distance of both packages."""
    def batches(keys, n=3):
        return [{k: (rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
                     if k not in ("judge", "same")
                     else rng.uniform(0, 1, 4)) for k in keys}
                for _ in range(n)]

    trip = batches(("ref", "p0", "p1", "judge"))
    pairs = batches(("p0", "p1", "same"))
    for port, jax_, data in (
            (ts.score_2afc_dataset, js.score_2afc_dataset, trip),
            (ts.score_jnd_dataset, js.score_jnd_dataset, pairs)):
        got, got_arrays = port(ts.make_pair_dist_fn("l2"), data)
        want, want_arrays = jax_(js.make_pair_dist_fn("l2"), data)
        assert got == want
        for k in want_arrays:
            np.testing.assert_array_equal(got_arrays[k], want_arrays[k])
    with pytest.raises(ValueError, match="unknown distance model"):
        ts.make_pair_dist_fn("resnet-gan")
