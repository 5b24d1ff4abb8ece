"""The victim trainers' data-parallel layout (``ganleaks_tpu_torch.
parallel.dp`` with ``ops/nn.batch_axis``) on ``gloo`` ranks on the CPU,
world sizes 2 and 4, against the port's single-process step and the JAX
package's data-parallel step (``pjit`` on a mesh of the first n virtual
CPU devices).

One ``launch`` per world size (a module fixture) runs every case
(``torch_rank_workers.train_rank_cases``): for each of DCGAN, WGAN-GP
(critic_iter 2), PGGAN (8 px: the minibatch std and the gradient
penalty's double backward), medGAN (an autoencoder pretrain step, then a
GAN step: the minibatch average) and VAE-GAN, two steps (VAE-GAN one
iteration) on an even global batch of 8 rows and on an uneven one of 5
(3/2 on 2 ranks, 2/1/1/1 on 4), drawn from a seeded generator; one step
from the JAX trainer's weights with the JAX step's own draws; a whole
``dcgan.train`` of 2 epochs on 13 images at batch 8 (a last batch of 5);
a batch with fewer rows than ranks.

Bars. Against one process on the same draws: losses rtol 1e-5;
parameters those of ``tests/test_parallel_train.py`` (DCGAN rtol 1e-4 /
atol 1e-5, WGAN-GP and PGGAN rtol 1e-3 / atol 1e-4, medGAN rtol 1e-3 /
atol 1e-5); VAE-GAN's rtol 1e-4 / atol 1e-5, but for parameters whose
gradient is at its noise floor (a convolution's bias before a BatchNorm,
whose gradient is rounding alone: Adam's sign-like first step turns it
into up to 2 lr), which number under 1% of a net; BatchNorm running
statistics and spectral-norm vectors atol 1e-5; the replicas bit for
bit. Against the JAX data-parallel step: ``tests/test_torch_victims.
py``'s bars (losses rtol 1e-4, parameters a tenth of lr, statistics atol
1e-5), but VAE-GAN's floor at 1e-3 of a net's largest gradient: the
JAX package's own step moves elements below it by up to 2 lr between 1,
2 and 4 devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_rank_workers as workers
from ganleaks_tpu import config as JC
from ganleaks_tpu.train import dcgan as j_dcgan
from ganleaks_tpu.train import medgan as j_medgan
from ganleaks_tpu.train import pggan as j_pggan
from ganleaks_tpu.train import vaegan as j_vaegan
from ganleaks_tpu.train import wgangp as j_wgangp
from ganleaks_tpu.train.gan import dcgan_train_step as j_dcgan_step
from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.cli import train_dcgan
from ganleaks_tpu_torch.parallel import multihost
from ganleaks_tpu_torch.parallel.dp import share_bounds
from ganleaks_tpu_torch.parallel.multihost import launch
from ganleaks_tpu_torch.train import dcgan

SIZES = (2, 4)
KINDS = ("dcgan", "wgangp", "pggan", "medgan", "vaegan")
LAUNCH_S = 240
EVEN, UNEVEN = 8, 5
LOSS_RTOL = 1e-5
# parameters against one process: tests/test_parallel_train.py's bars
PARAM_BARS = {"dcgan": (1e-4, 1e-5), "wgangp": (1e-3, 1e-4),
              "pggan": (1e-3, 1e-4), "medgan": (1e-3, 1e-5),
              "vaegan": (1e-4, 1e-5)}
STAT_ATOL = 1e-5
JAX_LOSS_RTOL = 1e-4
RES = {"dcgan": 16, "wgangp": 64, "pggan": 8, "vaegan": 64}
RUN_IMAGES = 13


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The ranks run torch on one thread each; so do the references."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(kind, n, rng):
    """A step's global batches: NCHW images in [-1, 1] (VAE-GAN's four),
    or medGAN's binary records."""
    if kind == "medgan":
        return [(rng.uniform(size=(n, workers.MEDGAN_D)) < 0.3)
                .astype(np.float32)]
    res = RES[kind]
    return [rng.uniform(-1, 1, (n, 3, res, res)).astype(np.float32)
            for _ in range(4 if kind == "vaegan" else 1)]


def _seeded_cases():
    rng = np.random.default_rng(0)
    cases = []
    for kind in KINDS:
        for label, n in (("even", EVEN), ("uneven", UNEVEN)):
            steps = 1 if kind == "vaegan" else 2
            cases.append({"name": f"{kind}_{label}", "kind": kind,
                          "seed": 3, "steps": [
                              {"batches": _batches(kind, n, rng)}
                              for _ in range(steps)]})
    return cases


SEEDED = _seeded_cases()
RUN_SET = np.random.default_rng(1).uniform(
    -1, 1, (RUN_IMAGES, 16, 16, 3)).astype(np.float32)
RUN_KW = dict(batch_size=8, num_epochs=2, seed=5, sample_grid_dir=None)


# ---------------------------------------------------------------------------
# the JAX trainers: weights, draws and the data-parallel step
# ---------------------------------------------------------------------------

def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(np.moveaxis(x, 1, -1))) \
        if x.ndim == 4 else jnp.asarray(x)


def _vars(ms, extra=False):
    out = {"params": ms.params, "batch_stats": ms.batch_stats}
    if extra:
        out.update(dict(ms.extra))
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_state(kind):
    key = jax.random.key(0)
    if kind == "dcgan":
        return j_dcgan.build_state(JC.DCGANConfig(
            nz=8, ngf=8, ndf=8, image_size=16), key)
    if kind == "wgangp":
        return j_wgangp.build_state(JC.WGANGPConfig(nz=8, ngf=8, ndf=8),
                                    key)
    if kind == "pggan":
        return j_pggan.build_state(JC.PGGANConfig(
            nz=16, in_channels=16, image_size=8), key, 1)
    if kind == "medgan":
        return j_medgan.build_state(JC.MedGANConfig(
            latent_dim=16, hidden_gen=16, hidden_disc1=16,
            hidden_disc2=16), workers.MEDGAN_D, key)
    return j_vaegan.build_state(JC.VAEGANConfig(z_dim=16, d=8), key)


VAE_NETS = {"enc": "encoder", "gen": "generator", "disc": "discriminator",
            "disc_l": "discriminator_l"}


def _port_nets(kind, jstate) -> dict:
    """The JAX state's nets as the port's modules (net name -> module)."""
    if kind == "vaegan":
        return {k: weights.vaegan_from_jax_variables(
            v, _vars(getattr(jstate, k), extra=True))
            for k, v in VAE_NETS.items()}
    if kind == "pggan":
        return {k: weights.pggan_from_jax_variables(part, {
            "params": jax.tree_util.tree_map(
                np.asarray, getattr(jstate, k).params)})
            for k, part in (("gen", "generator"), ("disc", "critic"))}
    nets = workers.trainer_nets(workers.trainer_state(
        kind, workers.trainer_config(kind)))
    for name, net in nets.items():
        weights.gan_load_jax_variables(net, _vars(getattr(jstate, name)))
    return nets


def _state_dicts(nets) -> dict:
    return {name: {k: v.detach().numpy().copy()
                   for k, v in net.state_dict().items()}
            for name, net in nets.items()}


def _flat_snapshot(sds) -> dict:
    return {f"{name}.{k}": v for name, sd in sds.items()
            for k, v in sd.items()}


def _jax_draws(kind, key, n):
    """The JAX step's own draws from ``key`` (its split order), as the
    port's step keywords."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if kind == "dcgan":
        return {"noise": t(jax.random.normal(key, (n, 8)))}
    if kind == "wgangp":
        rng, noise, eps = key, [], []
        for _ in range(2):
            rng, kn, ke = jax.random.split(rng, 3)
            noise.append(t(jax.random.normal(kn, (n, 8))))
            eps.append(t(jax.random.uniform(ke, (n, 1, 1, 1))))
        return {"noise": noise, "eps": eps}
    if kind == "pggan":
        _, kn, ke = jax.random.split(key, 3)
        return {"noise": t(jax.random.normal(kn, (n, 16))),
                "eps": t(jax.random.uniform(ke, (n, 1, 1, 1)))}
    if kind == "medgan":
        return {"noise": t(jax.random.normal(key, (n, 16)))}
    _, k_enc, k_noise, kd1, kd2, k_genc = jax.random.split(key, 6)
    return {"eps_dl": t(jax.random.normal(k_enc, (n, 16))),
            "noise_dl": t(jax.random.normal(k_noise, (n, 16))),
            "noise_d": [t(jax.random.normal(k, (n, 16)))
                        for k in (kd1, kd2)],
            "eps_g": t(jax.random.normal(k_genc, (n, 16)))}


def _jax_dp_step(kind, jstate, batches, key, n):
    """The JAX trainer's step on the first ``n`` devices: the state
    replicated, every batch sharded over ``data`` (the trainers' layout);
    medGAN's is the pretrain step, then the GAN step. Returns (state,
    losses)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    # a copy: the steps donate their state
    state = jax.device_put(jax.tree_util.tree_map(jnp.copy, jstate),
                           NamedSharding(mesh, P()))
    bs = [jax.device_put(_nhwc(b), NamedSharding(
        mesh, P("data", *([None] * (b.ndim - 1))))) for b in batches]
    if kind == "dcgan":
        return j_dcgan_step(state, bs[0], key)
    if kind == "wgangp":
        return j_wgangp.wgangp_train_step(state, bs[0], key, critic_iter=2,
                                          lambda_gp=10.0)
    if kind == "pggan":
        return j_pggan.pggan_train_step(state, bs[0], jnp.float32(0.5), key,
                                        1, 10.0, 0.001,
                                        compute_dtype="float32")
    if kind == "medgan":
        ae, m1 = j_medgan.ae_pretrain_step(state.ae, bs[0])
        state = state.replace(ae=ae, ae_in_g=state.ae_in_g.replace(
            params=ae.params))
        state, m2 = j_medgan.medgan_train_step(state, bs[0], key)
        return state, {**m1, **m2}
    return j_vaegan.vaegan_train_step(state, *bs, key)


def _jax_case(kind):
    """The JAX-initialised case: its port init, batches, draws, and the
    pieces the JAX data-parallel step needs."""
    rng = np.random.default_rng(11)
    jstate = _jax_state(kind)
    batches = _batches(kind, EVEN, rng)
    key = jax.random.key(7)
    return {"jstate": jstate, "batches": batches, "key": key,
            "init": _state_dicts(_port_nets(kind, jstate)),
            "draws": _jax_draws(kind, key, EVEN)}


JAX_CASES = {}


def _jax_cases():
    if not JAX_CASES:
        JAX_CASES.update({kind: _jax_case(kind) for kind in KINDS})
    return JAX_CASES


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def ranks(request, tmp_path_factory):
    cases = list(SEEDED) + [
        {"name": f"{kind}_jax", "kind": kind, "init": c["init"],
         "steps": [{"batches": c["batches"], "draws": c["draws"]}]}
        for kind, c in _jax_cases().items()]
    path = tmp_path_factory.mktemp(f"run{request.param}")
    out = launch(workers.train_rank_cases, request.param, cases,
                 dict(RUN_KW, PATH=str(path)), RUN_SET, devices="cpu",
                 timeout_s=LAUNCH_S)
    assert out["size"] == request.param
    return out


ONE = {}


def _one_process(name):
    """The port's single-process run of a seeded case (cached)."""
    if name not in ONE:
        case = next(c for c in SEEDED if c["name"] == name)
        cfg = workers.trainer_config(case["kind"])
        state = workers.trainer_state(case["kind"], cfg)
        gen = torch.Generator().manual_seed(case["seed"])
        losses = [workers.trainer_step(case["kind"], cfg, state,
                                       st["batches"], None, gen)
                  for st in case["steps"]]
        ONE[name] = (losses, workers.snapshot(state, grads=True))
    return ONE[name]


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _param_keys(kind) -> set:
    nets = workers.trainer_nets(workers.trainer_state(
        kind, workers.trainer_config(kind)))
    return {f"{name}.{k}" for name, net in nets.items()
            for k, _ in net.named_parameters()}


LRS = {"enc": 1e-4, "gen": 1e-4, "disc": 4e-4, "disc_l": 2e-4}
# VAE-GAN against the JAX step: its reconstruction term's gradient
# cancels, so elements up to 1e-3 of a net's largest gradient take
# rounding's sign — the JAX step moves them by up to 2 lr between 1, 2
# and 4 devices itself (67 elements of the encoder's fc1 at 2)
VAE_JAX_FLOOR = 1e-3


def _noise_floor(grads: dict, key: str, floor: float) -> np.ndarray:
    """Where ``key``'s gradient is at most ``floor`` of its net's largest
    gradient."""
    net = key.split(".", 1)[0]
    g_max = max(float(np.abs(v).max()) for k, v in grads.items()
                if k.startswith(f"grad:{net}."))
    return np.abs(grads[f"grad:{key}"]) <= floor * g_max


def _assert_states(kind, got, want, tol, grads, what, floor=1e-5):
    """Parameters within ``tol(key)`` = (rtol, atol) — VAE-GAN's whose
    gradient in ``grads`` is at most ``floor`` of the net's largest
    within 2 lr instead, under 1% of a net —, buffers within
    STAT_ATOL."""
    params = _param_keys(kind)
    keys = sorted(k for k in want if not k.startswith("grad:"))
    assert keys == sorted(k for k in got if not k.startswith("grad:"))
    exempt = {}
    for k in keys:
        if k not in params:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=STAT_ATOL, err_msg=f"{what} {k}")
            continue
        rtol, atol = tol(k)
        off = ~np.isclose(got[k], want[k], rtol=rtol, atol=atol)
        if kind == "vaegan":
            net = k.split(".", 1)[0]
            assert np.abs(got[k] - want[k]).max() <= 2 * LRS[net], \
                f"{what} {k}"
            off &= ~_noise_floor(grads, k, floor)
            exempt[net] = exempt.get(net, 0) + int(
                (~np.isclose(got[k], want[k], rtol=rtol, atol=atol)).sum())
        assert not off.any(), (
            f"{what} {k}: {int(off.sum())} elements off, "
            f"{float(np.abs(got[k] - want[k]).max()):.3g} at most")
    for net, n in exempt.items():
        size = sum(want[k].size for k in params if k.startswith(f"{net}."))
        assert n <= 0.01 * size, f"{what} {net}: {n} of {size} exempt"


def _assert_replicas(result, what):
    first = result["digests"][0]
    for r, d in enumerate(result["digests"][1:], 1):
        differ = sorted(k for k in first if d[k] != first[k])
        assert not differ, f"{what}: rank {r} differs in {differ[:5]}"


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,want", [
    (5, [(0, 3), (3, 5)]), (8, [(0, 4), (4, 8)])])
def test_share_bounds_split_like_array_split(n, want):
    assert share_bounds(n, 2) == want
    assert share_bounds(5, 4) == [(0, 2), (2, 3), (3, 4), (4, 5)]
    parts = np.array_split(np.arange(n), 3)
    assert share_bounds(n, 3) == [(int(p[0]), int(p[-1]) + 1)
                                  for p in parts]


@pytest.mark.parametrize("batch", ("even", "uneven"))
@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_matches_one_process(ranks, kind, batch):
    """The data-parallel steps against one process's on the same global
    batches and draws: losses, parameters, running statistics; the
    replicas bit for bit."""
    name = f"{kind}_{batch}"
    got = ranks[name]
    losses, want = _one_process(name)
    for g, w in zip(got["losses"], losses):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"{name} {k}")
    _assert_states(kind, got["state"], want, lambda k: PARAM_BARS[kind],
                   want, name)
    _assert_replicas(got, name)


JAX_DP = {}


@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_matches_jax_dp_step(ranks, kind):
    """One step from the JAX trainer's weights with the JAX step's own
    draws, against the JAX data-parallel step on as many devices."""
    n = ranks["size"]
    case = _jax_cases()[kind]
    if (kind, n) not in JAX_DP:
        jstate, jm = _jax_dp_step(kind, case["jstate"], case["batches"],
                                  case["key"], n)
        JAX_DP[kind, n] = (_flat_snapshot(_state_dicts(
            _port_nets(kind, jstate))), {k: float(v) for k, v in
                                         jax.device_get(jm).items()})
    want, jm = JAX_DP[kind, n]
    got = ranks[f"{kind}_jax"]
    (losses,) = got["losses"]
    for k, v in losses.items():
        np.testing.assert_allclose(v, jm[k], rtol=JAX_LOSS_RTOL, atol=1e-6,
                                   err_msg=f"{kind} {k}")
    lr = workers.trainer_config(kind).lr if kind != "vaegan" else None

    def tol(k):
        return 0, (LRS[k.split(".", 1)[0]] if lr is None else lr) / 10

    _assert_states(kind, got["state"], want, tol, got["state"],
                   f"{kind} vs jax", VAE_JAX_FLOOR)
    _assert_replicas(got, f"{kind} vs jax")


def test_dp_train_run_matches_one_process(ranks, tmp_path):
    """``dcgan.train`` for 2 epochs with ``mesh_shape=(n,)`` on a set
    whose last batch is partial, against one process's ``train`` with
    the same seed; rank 0 alone wrote the checkpoint."""
    cfg = workers.trainer_config("dcgan", PATH=str(tmp_path), **RUN_KW)
    state = dcgan.train(cfg, images=RUN_SET, device="cpu")
    run = ranks["run"]
    assert run["step"] == state.step == 4
    _assert_states("dcgan", run["state"], workers.snapshot(state),
                   lambda k: PARAM_BARS["dcgan"], None, "train()")
    _assert_replicas(run, "train()")
    assert run["written"][0] == ["discriminator.pth", "generator.pth"]
    assert all(w == [] for w in run["written"][1:]), run["written"]


def test_batch_with_fewer_rows_than_ranks_raises(ranks):
    n = ranks["size"]
    msg = ranks["short_batch"]
    assert f"{n - 1} rows" in msg and f"{n} ranks" in msg, msg
    with pytest.raises(ValueError, match=f"{n - 1} rows .* {n} ranks"):
        share_bounds(n - 1, n)


def test_cli_launches_the_mesh_ranks(monkeypatch, tmp_path):
    """``mesh_shape=[2]`` outside a process group launches 2 local ranks
    running the CLI's body (``gloo`` on the CPU), and a generation-only
    run does not launch."""
    calls = []
    monkeypatch.setattr(multihost, "launch",
                        lambda fn, n, *a, **kw: calls.append((fn, n, a, kw)))
    train_dcgan.main([f"PATH={tmp_path}", "mesh_shape=[2]"], device="cpu")
    (fn, n, args, kw), = calls
    assert fn is train_dcgan._run and n == 2
    assert args[0].mesh_shape == (2,) and args[1] == "cpu"
    assert kw["devices"] == "cpu" and kw["backend"] == "gloo"
    assert multihost.launch_plan(3, "cpu") == ("cpu", "gloo")
