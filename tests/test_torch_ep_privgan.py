"""Expert-parallel privGAN (``ganleaks_tpu_torch.parallel.ep``: one
(generator, discriminator) split per rank, the private classifier
replicated) on ``gloo`` ranks on the CPU, world sizes 2 and 4 (as many
splits), against the port's all-splits step (``train/priv``) and the
JAX package's EP step (``ganleaks_tpu.parallel.ep``, ``shard_map`` over
as many virtual CPU devices), after ``tests/test_ep_privgan.py``.

One ``launch`` per world size (a module fixture) runs every case
(``torch_rank_workers.ep_cases``), each one step from the JAX trainer's
weights with the JAX step's own draws: privDCGAN (16 px, nz 8, ngf / ndf
8, batch 4 a split) with the classifier's gate off and on, privPGGAN (8
px, nz 16 != in_channels 8) with it on.

Bars. privDCGAN with the gate off against the all-splits step: every
split's parameters and statistics bit for bit (each split's work is the
same ops on the same rows), the losses within rtol 1e-6 (a mean over
ranks against a mean over splits). Against the JAX EP step:
``tests/test_torch_privgan.py``'s bars (losses rtol 1e-4, parameters a
tenth of lr, statistics atol 1e-5). privPGGAN (gate on) against the
all-splits step: ``tests/test_ep_privgan.py``'s bars for the JAX pair
(losses rtol 2e-3 / atol 1e-4, parameters rtol 2e-3 / atol 2.5e-3): the
private critic's minibatch std sees a rank's B fakes here, all S * B
there. The classifier's replicas bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_workers as workers
from ganleaks_tpu.config import DCGANConfig as JDCGANConfig
from ganleaks_tpu.config import PGGANConfig as JPGGANConfig
from ganleaks_tpu.config import PrivGANConfig as JPrivGANConfig
from ganleaks_tpu.parallel import ep as jep
from ganleaks_tpu.train import priv as jpriv
from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.parallel import ep
from ganleaks_tpu_torch.parallel.mesh import Mesh as TorchMesh
from ganleaks_tpu_torch.parallel.multihost import launch
from ganleaks_tpu_torch.train import priv

SIZES = (2, 4)
LAUNCH_S = 180
B = 4
RATIO = 0.5
DC = dict(nz=8, ngf=8, ndf=8, image_size=16, batch_size=B)
PG = dict(nz=16, in_channels=8, image_size=8)
LOSS_RTOL = 1e-4
STAT_ATOL = 1e-5
ALPHA = 0.7
CASES = (("dcgan_off", "dcgan", False), ("dcgan_on", "dcgan", True),
         ("pggan_on", "pggan", True))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _variables(ms):
    out = {"params": ms.params}
    if ms.batch_stats:
        out["batch_stats"] = ms.batch_stats
    return jax.tree_util.tree_map(np.asarray, out)


JAX_STATES = {}


def _jax_state(kind, n):
    """The JAX trainer's stacked state of ``n`` splits (built once: the
    steps below take copies)."""
    if (kind, n) not in JAX_STATES:
        JAX_STATES[kind, n] = _build_jax_state(kind, n)
    return JAX_STATES[kind, n]


def _build_jax_state(kind, n):
    pcfg = JPrivGANConfig(N_splits=n, privacy_ratio=RATIO)
    if kind == "dcgan":
        cfg = JDCGANConfig(**DC)
        return cfg, jpriv.build_privdcgan_state(cfg, pcfg,
                                                jax.random.key(0))
    cfg = JPGGANConfig(**PG)
    return cfg, jpriv.build_privpggan_state(cfg, pcfg, jax.random.key(0),
                                            max_steps=1)


def _draws(kind, key, n, nz):
    """The JAX EP step's own draws (its split order), global-shaped."""
    if kind == "dcgan":
        _, k_noise, k_lab = jax.random.split(key, 3)
    else:
        _, k_noise, k_eps, k_lab = jax.random.split(key, 4)
    out = {"noise": jax.random.normal(k_noise, (n, B, nz))}
    if kind == "pggan":
        out["eps"] = jax.random.uniform(k_eps, (n, B, 1, 1, 1))
    r = jax.random.randint(k_lab, (n, B), 0, n - 1)
    out["gen_y"] = r + (r >= jnp.arange(n)[:, None])
    return {k: np.array(v) for k, v in out.items()}


def _case(name, kind, dp_on, n):
    cfg, jstate = _jax_state(kind, n)
    res = 16 if kind == "dcgan" else 8
    real = np.random.default_rng(n).uniform(
        -1, 1, (n, B, res, res, 3)).astype(np.float32)
    key = jax.random.key(9)
    init = tuple(_variables(ms) for ms in (jstate.genS, jstate.discS,
                                           jstate.priv))
    betas = (cfg.beta1, cfg.beta2) if kind == "dcgan" else (0.0, 0.99)
    return {"name": name, "kind": kind, "init": init, "lr": cfg.lr,
            "betas": betas, "cfg": cfg, "key": key, "jstate": jstate,
            "steps": [{"real": np.ascontiguousarray(np.moveaxis(real, -1,
                                                                -3)),
                       "real_nhwc": real, "dp_on": dp_on, "alpha": ALPHA,
                       "draws": _draws(kind, key, n, cfg.nz)}]}


def _cases(n):
    return {name: _case(name, kind, dp_on, n)
            for name, kind, dp_on in CASES}


CASE_CACHE = {}


def _cases_of(n):
    if n not in CASE_CACHE:
        CASE_CACHE[n] = _cases(n)
    return CASE_CACHE[n]


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def ranks(request):
    n = request.param
    sent = [{k: v for k, v in c.items()
             if k not in ("cfg", "key", "jstate")}
            for c in _cases_of(n).values()]
    for c in sent:
        c["steps"] = [{k: v for k, v in st.items() if k != "real_nhwc"}
                      for st in c["steps"]]
    out = launch(workers.ep_cases, n, sent, devices="cpu",
                 timeout_s=LAUNCH_S)
    assert out["size"] == n
    return out


def _flat(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _split(tree, r):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[r], tree)


def _close(got, want, rtol, atol, stat_atol, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        is_stat = k.startswith("batch_stats")
        np.testing.assert_allclose(
            got[k], want[k], rtol=0 if is_stat else rtol,
            atol=stat_atol if is_stat else atol, err_msg=f"{what}: {k}")


def _all_splits(case):
    """The port's all-splits step on the case's weights and draws:
    losses and the state as the JAX package stacks it."""
    genS, discS, pv = weights.privgan_from_jax_state(case["kind"],
                                                     *case["init"])
    state = priv.privgan_state(genS, discS, pv, case["lr"], *case["betas"])
    (st,) = case["steps"]
    d = {k: torch.from_numpy(v) for k, v in st["draws"].items()}
    real = torch.from_numpy(st["real"])
    if case["kind"] == "dcgan":
        m = priv.privdcgan_train_step(state, real, RATIO, st["dp_on"], **d)
    else:
        m = priv.privpggan_train_step(state, real, ALPHA, 1, RATIO,
                                      st["dp_on"], **d)
    return ({k: float(v) for k, v in m.items()},
            weights.privgan_to_jax_state(state.genS, state.discS,
                                         state.priv))


JAX_EP = {}


def _jax_ep(case, n):
    """The JAX EP step on the first ``n`` devices: losses and the stacked
    (generators, discriminators, classifier) variables."""
    if (case["name"], n) not in JAX_EP:
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("split",))
        (st,) = case["steps"]
        # a copy: the EP steps donate their state
        jstate = jep.shard_split_state(
            jax.tree_util.tree_map(jnp.copy, case["jstate"]), mesh)
        real = jnp.asarray(st["real_nhwc"])
        if case["kind"] == "dcgan":
            step = jep.make_ep_privdcgan_step(mesh, n, RATIO, st["dp_on"])
            out, m = step(jstate, real, case["key"])
        else:
            step = jep.make_ep_privpggan_step(mesh, n, RATIO, st["dp_on"],
                                              steps=1)
            out, m = step(jstate, real, jnp.float32(ALPHA), case["key"])
        JAX_EP[case["name"], n] = (
            {k: float(v) for k, v in jax.device_get(m).items()},
            tuple(_variables(ms) for ms in (out.genS, out.discS, out.priv)))
    return JAX_EP[case["name"], n]


def _assert_against(got, want_losses, want_state, n, rtol, atol,
                    stat_atol, loss_rtol, loss_atol, what):
    (losses,) = got["losses"]
    for k, v in want_losses.items():
        np.testing.assert_allclose(losses[k], v, rtol=loss_rtol,
                                   atol=loss_atol, err_msg=f"{what} {k}")
    gens, discs, pv = want_state
    for r, mine in enumerate(got["splits"]):
        _close(mine["gen"], _split(gens, r), rtol, atol, stat_atol,
               f"{what} split {r} G")
        _close(mine["disc"], _split(discs, r), rtol, atol, stat_atol,
               f"{what} split {r} D")
    _close(got["priv"], pv, rtol, atol, stat_atol, f"{what} classifier")
    assert len(set(got["priv_digests"])) == 1, got["priv_digests"]


def test_ep_privdcgan_gate_off_is_the_all_splits_step(ranks):
    n = ranks["size"]
    case = _cases_of(n)["dcgan_off"]
    losses, state = _all_splits(case)
    _assert_against(ranks["dcgan_off"], losses, state, n, 0, 0, 0, 1e-6,
                    0, "EP vs all-splits")
    assert ranks["dcgan_off"]["losses"][0]["loss_dp"] == 0.0


@pytest.mark.parametrize("name", ("dcgan_off", "dcgan_on", "pggan_on"))
def test_ep_step_matches_jax_ep_step(ranks, name):
    """Each case against the JAX EP step on as many devices: losses,
    every split's nets, the classifier (moved where its gate is on)."""
    n = ranks["size"]
    case = _cases_of(n)[name]
    losses, state = _jax_ep(case, n)
    lr = case["lr"]
    _assert_against(ranks[name], losses, state, n, 0, lr / 10, STAT_ATOL,
                    LOSS_RTOL, 1e-6, f"EP vs JAX EP ({name})")
    after = _flat(ranks[name]["priv"]["params"])
    before = _flat(case["init"][2]["params"])
    moved = max(float(np.abs(after[k] - before[k]).max()) for k in before)
    assert (moved > 0) == case["steps"][0]["dp_on"], moved


def test_ep_privpggan_near_the_all_splits_step(ranks):
    """privPGGAN with the gate on against the all-splits step, at the bars
    the JAX package holds its EP step to against its vmapped one."""
    n = ranks["size"]
    case = _cases_of(n)["pggan_on"]
    losses, state = _all_splits(case)
    _assert_against(ranks["pggan_on"], losses, state, n, 2e-3, 2.5e-3,
                    STAT_ATOL, 2e-3, 1e-4, "EP vs all-splits (pggan)")


def test_ep_refuses_a_split_count_off_the_mesh():
    mesh = TorchMesh(rank=0, size=2, device=torch.device("cpu"))
    for make in (ep.make_ep_privdcgan_step,
                 lambda *a: ep.make_ep_privpggan_step(*a, steps=1)):
        with pytest.raises(ValueError, match="3 splits on a mesh of 2"):
            make(mesh, 3, RATIO, True)
