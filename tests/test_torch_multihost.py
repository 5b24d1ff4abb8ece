"""The port's multi-process wire-up (``ganleaks_tpu_torch.parallel.
multihost``, ``parallel/mesh``) after ``tests/test_multihost.py:24-121``,
on ``gloo`` ranks on the CPU: ``initialize``'s contract (a no-op alone,
a partial explicit configuration refused, the arguments reaching the
process group, idempotent inside one), the launcher's world gating it,
``global_mesh``, ``gather_to_host`` and the collectives, ``launch``
raising on a failed or deadlocked rank instead of hanging, the attack on
two ranks end to end — ``attack_arrays`` on a mesh against the port's
single process and the JAX package's mesh, the CLI's local launch writing
rank 0's artifacts — and ``dryrun_multichip(2, device="cpu")``.

Every ``launch`` has its own time limit. Bars: indices identical; the
sharded layout's losses bit-equal to the single process's (one torch
thread on both sides: the tower on a rank's share of a query block gives
the same bits), the ring's within 1e-6 * (rq + rs) (each rank folds its
query shard as one cache), and the JAX package's within the
2e-6 * (rq + rs) of ``tests/test_torch_two_pass.py``.
"""

import os
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import torch_rank_workers as workers
from ganleaks_tpu.attack.fbb import attack_arrays as j_attack_arrays
from ganleaks_tpu.config import AttackConfig as JAttackConfig
from ganleaks_tpu.ops.lpips import default_lpips_params, save_lpips_params
from ganleaks_tpu_torch.attack.fbb import attack_arrays, build_embed_fn
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.parallel import multihost
from ganleaks_tpu_torch.parallel.multihost import launch

LAUNCH_S = 120
_VARS = ("GANLEAKS_COORDINATOR", "GANLEAKS_NUM_PROCESSES",
         "GANLEAKS_PROCESS_ID", "WORLD_SIZE", "RANK", "LOCAL_RANK",
         "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_initialize_is_noop_single_process(clean_env):
    assert multihost.initialize() == (0, 1)
    assert multihost.initialize() == (0, 1)  # idempotent
    assert not dist.is_initialized()
    assert multihost.process_index() == 0 and not multihost.in_group()


def test_initialize_rejects_partial_explicit_config(clean_env):
    clean_env.setenv("GANLEAKS_NUM_PROCESSES", "4")
    clean_env.setenv("GANLEAKS_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="no coordinator"):
        multihost.initialize()
    clean_env.delenv("GANLEAKS_NUM_PROCESSES")
    with pytest.raises(ValueError, match="no coordinator"):
        multihost.initialize()  # a process id alone is just as partial
    clean_env.delenv("GANLEAKS_PROCESS_ID")
    assert multihost.initialize() == (0, 1)
    with pytest.raises(ValueError, match="no coordinator"):
        multihost.initialize(num_processes=2)


def test_launcher_env_gates(clean_env):
    assert not multihost._launcher_env()
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    assert not multihost._launcher_env()  # no rendezvous address
    clean_env.setenv("MASTER_ADDR", "localhost")
    assert multihost._launcher_env() and multihost.in_group()


def test_initialize_passes_resolved_args(clean_env):
    """Explicit arguments and ``GANLEAKS_*`` reach the process group
    (stubbed: contacting a coordinator would block the suite); a
    launcher's world goes through ``env://``."""
    calls = []
    clean_env.setattr(dist, "init_process_group",
                      lambda backend, **kw: calls.append((backend, kw)))
    clean_env.setattr(dist, "get_rank", lambda: 1)
    clean_env.setattr(dist, "get_world_size", lambda: 2)
    clean_env.setenv("GANLEAKS_COORDINATOR", "coord:1234")
    clean_env.setenv("GANLEAKS_NUM_PROCESSES", "2")
    clean_env.setenv("GANLEAKS_PROCESS_ID", "1")
    assert multihost.initialize(backend="gloo") == (1, 2)
    backend, kw = calls[0]
    assert backend == "gloo"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == \
        ("tcp://coord:1234", 2, 1)
    for var in ("GANLEAKS_COORDINATOR", "GANLEAKS_NUM_PROCESSES",
                "GANLEAKS_PROCESS_ID"):
        clean_env.delenv(var)
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    clean_env.setenv("MASTER_ADDR", "localhost")
    multihost.initialize(backend="gloo")
    assert calls[1] == ("gloo", {"init_method": "env://",
                                 "timeout": calls[1][1]["timeout"]})
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("coord:1", num_processes=2)


def test_global_mesh_without_a_group(clean_env):
    assert multihost.global_mesh() is None
    assert multihost.global_mesh(1) is None
    with pytest.raises(ValueError, match="n_chips=2 but only 1"):
        multihost.global_mesh(2)
    assert multihost.gather_to_host(torch.arange(3)).tolist() == [0, 1, 2]


@pytest.fixture(scope="module", params=(2, 3), ids=lambda n: f"ranks{n}")
def wired(request):
    return request.param, launch(workers.wireup_cases, request.param,
                                 devices="cpu", timeout_s=LAUNCH_S)


def test_initialize_inside_the_group_reports_it(wired):
    n, out = wired
    assert out["initialize"] == [(r, n) for r in range(n)]
    assert out["mesh"] == (n, n, "gloo", "cpu")  # every rank on this CPU
    assert out["single"]
    assert out["data_parallel"] == (True, n, "data", True)
    # beyond the world, and short of it (a mesh of one is None)
    assert set(out["errors"]) == {n + 1} | ({n - 1} - {1})
    assert f"n_chips={n + 1} but only {n}" in out["errors"][n + 1]


def test_gather_and_collectives(wired):
    n, out = wired
    want = np.repeat(np.arange(n, dtype=np.float32), 3)[:, None] \
        .repeat(2, axis=1)[:2 * n - 1]
    np.testing.assert_array_equal(out["gathered"], want)
    assert out["replicated"] == [[0.0, 1.0, 2.0, 3.0]] * n
    # each rank received the previous rank's tensor
    assert out["ring"] == [[10.0 * ((r - 1) % n) + k for k in range(4)]
                           for r in range(n)]
    assert out["any"] == (True, False)
    per = -(-7 // n)
    assert out["shares"] == [(min(7, r * per), min(7, r * per + per), per)
                             for r in range(n)]
    assert [x for b in out["batch"] for x in b] == list(range(7))


def test_launch_raises_the_failed_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        launch(workers.fail_on, 2, 1, devices="cpu", timeout_s=LAUNCH_S)
    assert "planted failure on rank 1" in str(e.value)
    assert "Traceback" in str(e.value)


def test_launch_deadlock_times_out():
    with pytest.raises(TimeoutError, match="still running"):
        launch(workers.deadlock, 2, devices="cpu", timeout_s=5)


# ---------------------------------------------------------------------------
# the attack on two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attack_setup(tmp_path_factory):
    rng = np.random.default_rng(3)
    syn = rng.uniform(-1, 1, (12, 32, 32, 3)).astype(np.float32)
    pos = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    neg = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    syn[7] = pos[1]  # an exact member copy in the second shard
    npz = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    save_lpips_params(npz, default_lpips_params())
    base = dict(query_block=8, syn_block=4, resolution=32)
    cfgs = {
        "sharded_gemm": AttackConfig(distance="l2", engine="gemm", **base),
        "sharded_pallas": AttackConfig(distance="l2", engine="pallas",
                                       **base),
        "sharded_taps_int8": AttackConfig(distance="l2", engine="taps-int8",
                                          **base),
        "two_pass": AttackConfig(distance="l2", engine="gemm", two_pass=True,
                                 two_pass_k=4, **base),
        "ring_taps": AttackConfig(distance="l2", engine="taps",
                                  shard_layout="ring", **base),
        "lpips_taps": AttackConfig(distance="l2-lpips", engine="taps",
                                   lpips_weights=npz, **base),
        "lpips_ring": AttackConfig(distance="l2-lpips", engine="gemm",
                                   shard_layout="ring", lpips_weights=npz,
                                   **base)}
    before = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks
    single = {k: attack_arrays(c, syn, pos, neg, device="cpu")
              for k, c in cfgs.items()}
    torch.set_num_threads(before)
    ranks = launch(workers.attack_cases, 2, cfgs, syn, pos, neg,
                   devices="cpu", timeout_s=LAUNCH_S)
    return {"syn": syn, "pos": pos, "neg": neg, "cfgs": cfgs,
            "single": single, "ranks": ranks, "npz": npz}


@pytest.mark.parametrize("name", ("sharded_gemm", "sharded_pallas",
                                  "sharded_taps_int8", "two_pass",
                                  "ring_taps", "lpips_taps", "lpips_ring"))
def test_attack_on_two_ranks_equals_single_and_jax(attack_setup, name):
    got, ref = attack_setup["ranks"][name], attack_setup["single"][name]
    cfg = attack_setup["cfgs"][name]
    assert got["ranks"]["size"] == 2
    assert got["ranks"]["layout"] == cfg.shard_layout
    for key in ("pos_nn_idx", "neg_nn_idx"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert int(got["pos_nn_idx"][1]) == 7
    loss = np.concatenate([got["pos_loss"], got["neg_loss"]])
    loss0 = np.concatenate([ref["pos_loss"], ref["neg_loss"]])
    if cfg.shard_layout == "sharded":
        np.testing.assert_array_equal(loss, loss0)
    queries = np.concatenate([attack_setup["pos"], attack_setup["neg"]])
    idx = np.concatenate([got["pos_nn_idx"], got["neg_nn_idx"]])
    embed = build_embed_fn(replace(cfg, engine="gemm"), "cpu")
    with torch.no_grad():
        eq = embed(torch.from_numpy(queries)).double()
        es = embed(torch.from_numpy(attack_setup["syn"][idx])).double()
    norms = ((eq ** 2).sum(1) + (es ** 2).sum(1)).numpy()
    assert (np.abs(loss - loss0) <= 1e-6 * norms).all()
    jcfg = JAttackConfig(**{f: getattr(cfg, f) for f in (
        "distance", "engine", "query_block", "syn_block", "resolution",
        "two_pass", "two_pass_k", "shard_layout", "lpips_weights")})
    jmesh = Mesh(np.asarray(jax.devices()[:2]), ("syn",))
    jout = j_attack_arrays(jcfg, attack_setup["syn"], attack_setup["pos"],
                           attack_setup["neg"], mesh=jmesh)
    for key in ("pos_nn_idx", "neg_nn_idx"):
        np.testing.assert_array_equal(got[key], jout[key])
    jloss = np.concatenate([jout["pos_loss"], jout["neg_loss"]])
    assert (np.abs(loss - jloss) <= 2e-6 * norms).all()


def test_attack_layout_refusals():
    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="host_stream=true"):
        attack_arrays(AttackConfig(distance="l2", n_chips=2,
                                   host_stream=True), imgs, imgs, imgs,
                      device="cpu")
    with pytest.raises(ValueError, match="host_stream=true"):
        attack_arrays(AttackConfig(distance="l2", multihost=True,
                                   host_stream=True), imgs, imgs, imgs,
                      device="cpu")
    # n_chips alone selects nothing in attack_arrays: the mesh does
    out = attack_arrays(AttackConfig(distance="l2", n_chips=2), imgs, imgs,
                        imgs, device="cpu")
    assert out["pos_loss"].shape == (2,) and "ranks" not in out


def test_run_attack_two_ranks_through_the_cli(tmp_path, monkeypatch,
                                              capsys):
    """``cli.fbb`` with ``n_chips=2`` and no process group launches two
    ``gloo`` processes; rank 0 alone writes the artifacts, equal to the
    single process's. ``multihost=true`` with no launcher's world runs in
    place, and its mesh of two refuses a world of one."""
    from ganleaks_tpu_torch.cli import fbb as cli_fbb
    from ganleaks_tpu_torch.io.native import encode_png

    rng = np.random.default_rng(0)
    dirs = {}
    for name, cnt in (("syn", 16), ("pos", 3), ("neg", 3)):
        d = tmp_path / name
        d.mkdir()
        for i in range(cnt):
            encode_png(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                       str(d / f"{i}.png"))
        dirs[name] = str(d)
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    args = [f"syn_data_path={dirs['syn']}", f"pos_data_dir={dirs['pos']}",
            f"neg_data_dir={dirs['neg']}", "data_num=3", "resolution=8",
            "distance=l2", "engine=gemm", "query_block=2", "syn_block=4",
            "save_plots=false", f"save_root={tmp_path / 'out'}",
            "decode_cache=false"]
    cli_fbb.main(args + ["exp_name=plain"], device="cpu")
    cli_fbb.main(args + ["exp_name=ranks", "n_chips=2"], device="cpu")
    printed = capsys.readouterr().out
    assert printed.count("saved ") == 2
    for name in ("pos_loss", "pos_nn_idx", "neg_loss", "neg_nn_idx"):
        a = np.load(tmp_path / "out" / "plain" / f"{name}.npy")
        b = np.load(tmp_path / "out" / "ranks" / f"{name}.npy")
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="n_chips=2 but only 1"):
        cli_fbb.main(args + ["exp_name=mh", "n_chips=2", "multihost=true"],
                     device="cpu")
    assert not os.path.exists(tmp_path / "out" / "mh")


def test_dryrun_multichip_on_cpu():
    from ganleaks_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(2, device="cpu", timeout_s=LAUNCH_S)
    assert out["ranks"] == 2 and out["backend"] == "gloo"
    assert len(out["indices"]) == 4
    assert set(out["layouts"]) >= {"sharded", "ring", "ring_streamed_pallas",
                                   "sharded_streamed_pallas"}
    # the training parts: the data-parallel DCGAN step against one
    # process's, the expert-parallel privDCGAN step (gate on)
    assert set(out["dp_losses"]) == {"loss_disc", "loss_gen"}
    assert out["dp_max_param_diff_lr"] <= 0.1
    assert out["dp_update_rel"] < 1e-4
    assert set(out["ep_losses"]) == {"loss_d", "loss_dp", "loss_g"}
    assert all(np.isfinite(v) for v in out["ep_losses"].values())
    assert out["ep_losses"]["loss_dp"] > 0
