"""The port's training layers (``ganleaks_tpu_torch.ops.nn``: the
spectral-norm layers in training, ``WSConv2d``, ``pixel_norm``,
``minibatch_std``, ``upsample_nearest_2x``, ``avg_pool_2x``,
``leaky_relu``, ``torch_default_init``) against the JAX package's blocks
on the CPU: each forward, and ``jax.grad`` of a fixed random projection of
its output against torch's backward, w.r.t. the parameters and the input.

Spectral norm: the JAX layer runs its power iteration inside the traced
forward, so ``jax.grad`` differentiates through it; the port's does too,
and inside ``spectral_chain`` a second forward starts from the first's
``u`` with its graph, as the JAX VAE-GAN D step threads one forward's
``spectral`` collection into the next. The reference's wrapper (and
``torch.nn.utils.spectral_norm``) computes ``u``/``v`` on ``.data``,
which gives another gradient while ``u`` has not converged; one test
shows the difference (ROADMAP C).

Tolerances: float32 against float32 with sums in different orders,
observed ~1e-6 on O(1) values: forwards and gradients atol 2e-5 (rtol
1e-5 on larger gradients), the updated ``u``/``v`` atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops import nn as jnn
from ganleaks_tpu_torch.ops import nn as tnn
from ganleaks_tpu_torch.weights import load_jax_tree

ATOL = 2e-5
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    t = t.detach().numpy()
    return t.transpose(0, 2, 3, 1) if t.ndim == 4 else t


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# spectral norm
# ---------------------------------------------------------------------------

# (JAX layer, port layer, input NHWC or (N, F))
SN_CASES = {
    "conv": (lambda: jnn.SNConv2d(features=5, kernel_size=4, stride=2,
                                  padding=1),
             lambda: tnn.SNConv2d(3, 5, 4, 2, 1), (2, 8, 8, 3)),
    "conv_transpose": (lambda: jnn.SNConvTranspose2d(
        features=4, kernel_size=4, stride=2, padding=1),
        lambda: tnn.SNConvTranspose2d(6, 4, 4, 2, 1), (2, 4, 4, 6)),
    "dense": (lambda: jnn.SNDense(features=4), lambda: tnn.SNDense(6, 4),
              (3, 6)),
}


def _sn_setup(case, seed=0):
    jmod_f, tmod_f, shape = SN_CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = jmod_f()
    v = jax.tree_util.tree_map(np.asarray,
                               jmod.init(jax.random.key(seed), x))
    tmod = tmod_f()
    load_jax_tree(tmod, v["params"], spectral=v["spectral"])
    return jmod, tmod, v, x, rng


def _port_in(x):
    return _nchw(x) if x.ndim == 4 else torch.from_numpy(x)


def _kernel_grad(tmod):
    """The weight's gradient in the JAX kernel layout."""
    g = tmod.weight.grad.numpy()
    if g.ndim == 2:
        return g.T
    return g.transpose((2, 3, 0, 1) if isinstance(
        tmod, tnn.SNConvTranspose2d) else (2, 3, 1, 0))


@pytest.mark.parametrize("case", sorted(SN_CASES))
def test_spectral_train_forward_and_grad_match_jax(case):
    """One training forward: output, the advanced u/v, and the gradient
    of a random projection w.r.t. kernel, bias and input."""
    jmod, tmod, v, x, rng = _sn_setup(case)
    out_shape = np.asarray(jmod.apply(v, x)).shape
    proj = rng.standard_normal(out_shape).astype(np.float32)

    def loss(params, xx):
        out, mut = jmod.apply({"params": params, "spectral": v["spectral"]},
                              xx, mutable=["spectral"])
        return jnp.sum(out * proj), (out, mut["spectral"])

    (_, (out, spec)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    xt = _port_in(x).requires_grad_(True)
    got = tmod.train()(xt)
    proj_t = _port_in(proj)
    (got * proj_t).sum().backward()
    _close(_to_nhwc(got), out, "output")
    np.testing.assert_allclose(tmod.u.numpy(), spec["u"], atol=1e-6)
    np.testing.assert_allclose(tmod.v.numpy(), spec["v"], atol=1e-6)
    _close(_kernel_grad(tmod), g_params["kernel"], "kernel grad")
    _close(tmod.bias.grad.numpy(), g_params["bias"], "bias grad")
    _close(_to_nhwc(xt.grad), g_x, "input grad")


@pytest.mark.parametrize("case", sorted(SN_CASES))
def test_spectral_chain_matches_jax(case):
    """Two forwards in one loss, the second from the first's spectral
    collection (the VAE-GAN D step): the gradient flows through both
    power iterations; the buffers end at the second forward's vectors."""
    jmod, tmod, v, x, rng = _sn_setup(case, seed=1)
    x2 = rng.standard_normal(x.shape).astype(np.float32)

    def loss(params):
        o1, m1 = jmod.apply({"params": params, "spectral": v["spectral"]},
                            x, mutable=["spectral"])
        o2, m2 = jmod.apply({"params": params, "spectral": m1["spectral"]},
                            x2, mutable=["spectral"])
        return jnp.sum(o1) - 2.0 * jnp.sum(o2 ** 2), m2["spectral"]

    (val, spec), g = jax.value_and_grad(loss, has_aux=True)(v["params"])
    tmod.train()
    with tnn.spectral_chain(tmod):
        o1 = tmod(_port_in(x))
        o2 = tmod(_port_in(x2))
    got = o1.sum() - 2.0 * o2.square().sum()
    got.backward()
    np.testing.assert_allclose(float(got), float(val), rtol=1e-5)
    np.testing.assert_allclose(tmod.u.numpy(), spec["u"], atol=1e-6)
    _close(_kernel_grad(tmod), g["kernel"], "kernel grad")
    assert tmod._live_u is None and not tmod._chain


def test_spectral_gradient_is_not_the_detached_formula():
    """On an unconverged ``u`` (the layer at its init, one iteration) the
    JAX gradient of the summed output — the port's — differs from the
    gradient with ``u``/``v`` detached (the reference wrapper's ``.data``
    writes, ``torch.nn.utils.spectral_norm``): a real difference between
    the JAX package and the reference, recorded in ROADMAP C, which the
    port follows."""
    jmod, tmod, v, x, _ = _sn_setup("dense", seed=3)

    def loss(params):
        out, _ = jmod.apply({"params": params, "spectral": v["spectral"]},
                            x, mutable=["spectral"])
        return jnp.sum(out)

    g_jax = np.asarray(jax.grad(loss)(v["params"])["kernel"]).T
    tmod.train()(torch.from_numpy(x)).sum().backward()
    g_port = tmod.weight.grad.numpy()
    np.testing.assert_allclose(g_port, g_jax, rtol=RTOL, atol=ATOL)

    w = torch.from_numpy(v["params"]["kernel"].T.copy()).requires_grad_(True)
    u0 = torch.from_numpy(v["spectral"]["u"])
    with torch.no_grad():  # the reference's .data power iteration
        v1 = tnn.l2normalize(w.T @ u0)
        u1 = tnn.l2normalize(w @ v1)
    sigma = u1 @ (w @ v1)
    out = torch.from_numpy(x) @ (w / sigma).T
    out.sum().backward()
    g_data = w.grad.numpy()
    gap = np.abs(g_data - g_jax).max()
    assert gap > 0.05 * np.abs(g_jax).max(), gap


def test_spectral_eval_freezes_and_train_advances():
    _, tmod, _, x, _ = _sn_setup("conv")
    u0 = tmod.u.clone()
    with torch.no_grad():
        a = tmod.eval()(_port_in(x))
        b = tmod(_port_in(x))
    assert torch.equal(tmod.u, u0) and torch.equal(a, b)
    with torch.no_grad():
        tmod.train()(_port_in(x))
    assert not torch.equal(tmod.u, u0)
    assert abs(float(torch.linalg.vector_norm(tmod.u)) - 1.0) < 1e-6


def test_spectral_state_dict_keys_are_the_reference_wrappers():
    """``SpectralNorm`` (``vaegan/ops.py:47-63``) leaves ``weight_bar``,
    ``weight_u``, ``weight_v`` and the bias on ``<layer>.module``."""
    for _, make, _ in SN_CASES.values():
        assert sorted(make().state_dict()) == [
            "module.bias", "module.weight_bar", "module.weight_u",
            "module.weight_v"]


# ---------------------------------------------------------------------------
# PGGAN blocks
# ---------------------------------------------------------------------------

def _check_fn(jfn, tfn, x, seed):
    """Forward and input gradient of a projection, NHWC against NCHW."""
    rng = np.random.default_rng(seed)
    want = np.asarray(jfn(jnp.asarray(x)))
    proj = rng.standard_normal(want.shape).astype(np.float32)
    g_want = jax.grad(lambda xx: jnp.sum(jfn(xx) * proj))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    got = tfn(xt)
    (got * _nchw(proj)).sum().backward()
    _close(_to_nhwc(got), want, "forward")
    _close(_to_nhwc(xt.grad), g_want, "input grad")


@pytest.mark.parametrize("name", ["pixel_norm", "upsample_nearest_2x",
                                  "avg_pool_2x", "leaky_relu",
                                  "minibatch_std"])
def test_pggan_functions_match_jax(name):
    x = np.random.default_rng(4).normal(0.2, 1.5, (3, 4, 6, 5)).astype(
        np.float32)
    _check_fn(getattr(jnn, name), getattr(tnn, name), x, 5)


def test_minibatch_std_is_unbiased():
    x = torch.randn(4, 3, 2, 2, dtype=torch.float64)
    out = tnn.minibatch_std(x)
    want = x.numpy().std(axis=0, ddof=1).mean()
    assert out.shape == (4, 4, 2, 2)
    np.testing.assert_allclose(out[:, 3].numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("k,pad", [(3, 1), (1, 0), (4, 0)])
def test_wsconv2d_matches_jax(k, pad):
    """The input scaled by sqrt(2 / (in * k^2)), a bias-free conv, the
    bias after it: forward and gradients w.r.t. weight, bias and input."""
    rng = np.random.default_rng(6 + k)
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    jmod = jnn.WSConv2d(5, kernel_size=k, padding=pad)
    v = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.key(k), x))
    v["params"]["bias"] = rng.standard_normal(5).astype(np.float32)
    tmod = tnn.WSConv2d(4, 5, k, 1, pad)
    load_jax_tree(tmod, v["params"])
    want = np.asarray(jmod.apply(v, x))
    proj = rng.standard_normal(want.shape).astype(np.float32)
    g = jax.grad(lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx) * proj),
                 argnums=(0, 1))(v["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    got = tmod(xt)
    (got * _nchw(proj)).sum().backward()
    _close(_to_nhwc(got), want, "forward")
    _close(tmod.bias.grad.numpy(), g[0]["bias"], "bias grad")
    _close(tmod.conv.weight.grad.numpy().transpose(2, 3, 1, 0),
           g[0]["conv"]["kernel"], "weight grad")
    _close(_to_nhwc(xt.grad), g[1], "input grad")
    assert sorted(tmod.state_dict()) == ["bias", "conv.weight"]
    assert tmod.scale == pytest.approx((2.0 / (4 * k * k)) ** 0.5)


def test_torch_default_init_is_seeded_and_in_bounds():
    """torch's default draws from an explicit generator: the same seed
    gives the same weights, every weight and bias within 1/sqrt(fan_in),
    spectral-norm vectors of unit norm."""
    def build(seed):
        net = torch.nn.Sequential(tnn.Conv2dTorch(3, 4, 3),
                                  tnn.ConvTranspose2dTorch(4, 2, 4),
                                  tnn.DenseTorch(5, 6),
                                  tnn.SNConv2d(2, 3, 4), tnn.SNDense(6, 2))
        return tnn.torch_default_init(net, torch.Generator().manual_seed(
            seed))

    a, b, c = build(0), build(0), build(1)
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y) and not torch.equal(x, z), k
    for m, fan in ((a[0], 27), (a[1], 32), (a[2], 5), (a[3], 32), (a[4], 6)):
        for p in (m.weight, m.bias):
            assert float(p.abs().max()) <= fan ** -0.5
    for m in (a[3], a[4]):
        for vec in (m.u, m.v):
            assert abs(float(torch.linalg.vector_norm(vec)) - 1) < 1e-6
