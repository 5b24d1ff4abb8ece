"""``ganleaks_tpu_torch.ops.distance`` against ``ganleaks_tpu.ops.distance``
on the CPU: the uint8 dequant table, the pixel embedding and the flat
featurisers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops import distance as jd
from ganleaks_tpu.ops.lpips import lpips_embed_fn as j_lpips_embed_fn
from ganleaks_tpu.ops.lpips import init_lpips_params as j_init_lpips
from ganleaks_tpu_torch.ops import distance as td
from ganleaks_tpu_torch.ops.lpips import lpips_embed_fn as t_lpips_embed_fn
from ganleaks_tpu_torch.weights import lpips_from_jax_params


def _np_params(p):
    return {"net": p["net"],
            "convs": [{k: np.asarray(v) for k, v in c.items()}
                      for c in p["convs"]],
            "lins": [np.asarray(w) for w in p["lins"]]}


def test_dequant_table_bit_identical_all_bytes():
    """Bit-identical to JAX ``images_unit_range`` (the CPU LUT) and to the
    host readers' float64 ``2*(x/255)-1`` on every byte value."""
    x = np.arange(256, dtype=np.uint8).reshape(4, 4, 4, 4)
    got = td.images_unit_range(torch.from_numpy(x)).numpy()
    want = np.asarray(jd.images_unit_range(jnp.asarray(x)))
    host = (2.0 * (x.astype(np.float64) / 255.0) - 1.0).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), host.view(np.uint32))


def test_float_images_pass_through():
    x = torch.linspace(-1, 1, 48).reshape(1, 4, 4, 3)
    assert td.images_unit_range(x) is x


@pytest.mark.parametrize("shape", [(3, 8, 8, 3), (2, 32, 32, 3),
                                   (5, 7, 9, 1)])
def test_pixel_embedding_matches(rng, shape):
    """Same ops in the same order (sqrt, reciprocal, multiply, all
    correctly rounded): equal to 1 ulp."""
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    got = td.pixel_embedding(torch.from_numpy(x)).numpy()
    want = np.asarray(jd.pixel_embedding(jnp.asarray(x)))
    assert got.shape == (shape[0], int(np.prod(shape[1:])))
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


def test_l2_embed_fn_matches_on_uint8(rng):
    x = rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    got = td.make_embed_fn("l2")(torch.from_numpy(x)).numpy()
    want = np.asarray(jd.make_embed_fn("l2")(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


def test_l2_lpips_embed_fn_matches(rng):
    """Pixel part + five VGG16 taps with shared weights: float32 tower
    (TF32 off), tolerance of the two conv implementations' sum orders."""
    p = j_init_lpips(seed=3, lin_weights=None)
    model = lpips_from_jax_params(_np_params(p))
    x = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    got = td.make_embed_fn("l2-lpips", t_lpips_embed_fn(model))(
        torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jd.make_embed_fn("l2-lpips", j_lpips_embed_fn(p))(
        jnp.asarray(x)))
    assert got.shape == want.shape == (2, 125 * 32 * 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_embed_fn_dtype_and_errors():
    x = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
    assert td.make_embed_fn("l2", dtype=torch.bfloat16)(x).dtype \
        == torch.bfloat16
    with pytest.raises(ValueError, match="LPIPS"):
        td.make_embed_fn("l2-lpips")
    with pytest.raises(ValueError, match="unknown distance"):
        td.make_embed_fn("l1")
