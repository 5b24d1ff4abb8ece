"""``ganleaks_tpu_torch.ops.lpips`` against ``ganleaks_tpu.ops.lpips`` on
the CPU: JAX ``default_lpips_params`` carried through ``weights.py`` into
the port, then VGG16 taps, ``lpips_pair`` and ``lpips_embed`` at
rtol 1e-5 / atol 1e-6 (float32, TF32 off; the two conv implementations sum
in different orders), plus the npz schema round trip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops import lpips as jl
from ganleaks_tpu.ops.lpips.lpips import _features as j_features
from ganleaks_tpu_torch.device import set_f32_numerics
from ganleaks_tpu_torch.ops import lpips as tl
from ganleaks_tpu_torch.weights import (lpips_from_jax_params,
                                        lpips_to_jax_params)

RTOL, ATOL = 1e-5, 1e-6


def _np_params(p):
    return {"net": p["net"],
            "convs": [{k: np.asarray(v) for k, v in c.items()}
                      for c in p["convs"]],
            "lins": [np.asarray(w) for w in p["lins"]]}


@pytest.fixture(scope="module")
def shared():
    set_f32_numerics()
    p = jl.default_lpips_params()
    return p, lpips_from_jax_params(_np_params(p)).eval()


def _images(rng, n=3, res=32):
    return rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


def test_vgg16_taps_match(shared, rng):
    p, model = shared
    x = _images(rng)
    with torch.no_grad():
        got = model.features(torch.from_numpy(x))
    want = j_features(p, jnp.asarray(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape  # NHWC on both sides
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_uint8_input_matches_float(shared, rng):
    _, model = shared
    u8 = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    f32 = (2.0 * (u8 / 255.0) - 1.0).astype(np.float32)
    with torch.no_grad():
        a = model.features(torch.from_numpy(u8))
        b = model.features(torch.from_numpy(f32))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("broadcast", [False, True])
def test_lpips_pair_matches(shared, rng, broadcast):
    p, model = shared
    x = _images(rng, 1 if broadcast else 3)
    y = _images(rng, 3)
    with torch.no_grad():
        got = tl.lpips_pair(model, torch.from_numpy(x),
                            torch.from_numpy(y)).numpy()
    want = np.asarray(jl.lpips_pair(p, jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight", [1.0, 0.2])
def test_lpips_embed_matches(shared, rng, weight):
    p, model = shared
    x = _images(rng)
    with torch.no_grad():
        got = tl.lpips_embed(model, torch.from_numpy(x),
                             weight=weight).numpy()
    want = np.asarray(jl.lpips_embed(p, jnp.asarray(x), weight=weight))
    assert got.shape == want.shape == (3, 122 * 32 * 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_embedding_factorises_pair(shared, rng):
    """weight * LPIPS(x, y) == ||phi(x) - phi(y)||^2 inside the port
    (float32 sums of ~1e5 terms: rtol 1e-4)."""
    _, model = shared
    x, y = torch.from_numpy(_images(rng)), torch.from_numpy(_images(rng))
    with torch.no_grad():
        pair = tl.lpips_pair(model, x, y)
        ex = tl.lpips_embed(model, x, weight=0.2)
        ey = tl.lpips_embed(model, y, weight=0.2)
    torch.testing.assert_close(((ex - ey) ** 2).sum(1), 0.2 * pair,
                               rtol=1e-4, atol=1e-7)


def test_bf16_tower_runs(shared, rng):
    _, model = shared
    x = torch.from_numpy(_images(rng, 2))
    with torch.no_grad():
        e = tl.lpips_embed(model, x, dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
        ref = tl.lpips_embed(model, x)
    assert e.dtype == torch.bfloat16
    torch.testing.assert_close(e.float(), ref, rtol=5e-2, atol=5e-3)


def test_npz_round_trip_both_ways(tmp_path):
    """JAX npz -> port -> npz -> JAX: every array bit-identical, and the
    port module equals the one built by weights.py."""
    p = jl.init_lpips_params(seed=7, lin_weights=jl.reference_lin_weights())
    a = str(tmp_path / "jax.npz")
    b = str(tmp_path / "port.npz")
    jl.save_lpips_params(a, p)
    model = tl.load_lpips_params(a)
    direct = lpips_from_jax_params(_np_params(p))
    for x, y in zip(model.state_dict().values(),
                    direct.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    tl.save_lpips_params(b, model)
    back = jl.load_lpips_params(b)
    assert back["net"] == p["net"] == "vgg"
    assert len(back["convs"]) == len(p["convs"]) == 13
    for c0, c1 in zip(p["convs"], back["convs"]):
        np.testing.assert_array_equal(np.asarray(c1["kernel"]),
                                      np.asarray(c0["kernel"]))
        np.testing.assert_array_equal(np.asarray(c1["bias"]),
                                      np.asarray(c0["bias"]))
    for l0, l1 in zip(p["lins"], back["lins"]):
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l0))
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)


def test_weight_bridge_layout():
    model = tl.init_lpips_params(seed=1)
    params = lpips_to_jax_params(model)
    assert params["convs"][0]["kernel"].shape == (3, 3, 3, 64)  # HWIO
    assert tuple(model.tower.convs[0].weight.shape) == (64, 3, 3, 3)
    back = lpips_from_jax_params(params)
    for x, y in zip(model.state_dict().values(),
                    back.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    bad = dict(params, convs=params["convs"][:-1])
    with pytest.raises(ValueError):
        lpips_from_jax_params(bad)


def test_default_params_surrogate_and_real_heads():
    """Seeded surrogate (deterministic per seed, torch's default init
    scale) with the real v0.1 lin heads, as the JAX package does."""
    m0 = tl.default_lpips_params(seed=0)
    m1 = tl.default_lpips_params(seed=0)
    m2 = tl.default_lpips_params(seed=1)
    w0 = m0.tower.convs[4].weight
    torch.testing.assert_close(w0, m1.tower.convs[4].weight, rtol=0, atol=0)
    assert not torch.equal(w0, m2.tower.convs[4].weight)
    bound = 1.0 / (128 * 9) ** 0.5
    assert float(w0.detach().abs().max()) <= bound
    for got, want in zip(m0.lins, jl.reference_lin_weights()):
        np.testing.assert_array_equal(got.numpy(), want.reshape(-1))
    assert [int(w.numel()) for w in m0.lins] == [64, 128, 256, 512, 512]
    with pytest.raises(ValueError):
        tl.LPIPS("alex")
