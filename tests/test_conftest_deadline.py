"""The harness's own rules (the repo's root ``conftest.py``): every test
runs under a deadline that fails that test alone, with its node id, its
limit and every thread's stack, and OpenBLAS keeps no worker threads for a
forked cache write to take down."""

import os
import subprocess
import sys
import time

from threadpoolctl import threadpool_info

pytest_plugins = ("pytester",)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

INNER = """
import signal
import time

import pytest


@pytest.mark.timeout(1)
def test_sleeps_past():
    time.sleep(60)


@pytest.mark.timeout(1)
def test_sleeps_past_under_capsys(capsys):
    time.sleep(60)


@pytest.mark.timeout(1)
def test_stuck_where_no_signal_lands():
    # what a hang inside C code looks like to the interpreter: the
    # SIGALRM handler never runs, so only the backstop can end it
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)


@pytest.mark.timeout(5)
def test_in_time():
    time.sleep(0.1)
"""

# a test of a file that carries no marker, given its limit by name
GRAFT_ENTRY = """
def test_graft_entry_single_and_multichip(request):
    assert request.node.get_closest_marker("timeout").args == (750,)


def test_other(request):
    assert request.node.get_closest_marker("timeout") is None
"""


def _run_inner(pytester, monkeypatch, *args):
    """The inner suite under the root conftest.py's hooks, in a subprocess
    (its deadline must not replace this test's own): (result, seconds)."""
    pytester.makepyfile(test_inner=INNER, test_parallel_train=GRAFT_ENTRY)
    monkeypatch.setenv("PYTHONPATH", REPO)
    t0 = time.monotonic()
    res = pytester.runpytest_subprocess(
        "-p", "conftest", "-p", "no:randomly", "-p", "no:cacheprovider",
        *args, timeout=240)
    return res, time.monotonic() - t0


def test_late_test_fails_alone_with_its_limit_and_stacks(pytester,
                                                         monkeypatch):
    res, seconds = _run_inner(pytester, monkeypatch, "test_inner.py", "-k",
                              "sleeps_past or in_time")
    res.assert_outcomes(passed=1, failed=2)
    out = res.stdout.str()
    assert "test_inner.py::test_sleeps_past ran past its limit of 1 s" in out
    assert ("test_inner.py::test_sleeps_past_under_capsys ran past its "
            "limit of 1 s") in out
    # faulthandler's dump of every thread, in the test's captured stderr
    assert "Captured stderr call" in out
    assert "Current thread" in out and "in test_sleeps_past" in out
    assert seconds < 60


def test_hang_in_c_costs_one_worker_not_the_run(pytester, monkeypatch):
    """Past twice its limit the backstop ends the worker; xdist charges the
    crash to that test and runs the rest on a new worker."""
    res, seconds = _run_inner(pytester, monkeypatch, "test_inner.py", "-p",
                              "xdist", "-n", "1")
    res.assert_outcomes(passed=1, failed=3)
    out = res.stdout.str()
    assert "crashed while running" in out
    assert "test_stuck_where_no_signal_lands" in out
    # the backstop's dump goes to the worker's real stderr
    err = res.stderr.str()
    assert "Timeout (0:00:02)!" in err
    assert "in test_stuck_where_no_signal_lands" in err
    assert seconds < 60


def test_a_test_named_in_the_harness_gets_its_longer_limit(pytester,
                                                          monkeypatch):
    res, _ = _run_inner(pytester, monkeypatch, "test_parallel_train.py")
    res.assert_outcomes(passed=2)


def test_every_openblas_runs_on_one_thread():
    import scipy.linalg  # noqa: F401  (loads scipy's OpenBLAS)

    blas = [p for p in threadpool_info() if p["internal_api"] == "openblas"]
    assert blas and all(p["num_threads"] == 1 for p in blas), blas


# The harness forks for every persistent-cache write (harden_cache_writes).
# jaxlib's CPU eigh runs asynchronously inside scipy's OpenBLAS; a fork in
# the meantime ran OpenBLAS's fork handler, which takes its worker threads
# down under that call, and the call then waited forever: the suite's
# stall inside test_fid_split.py::test_inception_pool3_shape_and_fid,
# whose frechet_distance(method="eigh") overlaps compiles slow enough to
# be written once the host is loaded.
FORK_DURING_EIGH = """
import sys, time
import numpy as np, jax, jax.numpy as jnp
from ganleaks_tpu.cli.common import (enable_persistent_compilation_cache,
                                     harden_cache_writes)
enable_persistent_compilation_cache(sys.argv[1])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
harden_cache_writes()
a = np.random.default_rng(0).standard_normal((2048, 2048)).astype(np.float32)
sym = jnp.asarray(a + a.T)
jnp.linalg.eigh(sym)[0].block_until_ready()
w, _ = jnp.linalg.eigh(sym)
time.sleep(0.2)
jax.jit(lambda x: jnp.sin(x) * 3.5)(jnp.arange(7.0)).block_until_ready()
w.block_until_ready()
print("ok")
"""


def test_forked_cache_write_during_a_running_eigh_returns(tmp_path):
    """A process with this harness's environment forks a cache write
    while an eigh is inside OpenBLAS, then waits for the eigh."""
    env = {k: v for k, v in os.environ.items()
           if k != "GANLEAKS_NO_COMPILE_CACHE"}
    res = subprocess.run(
        [sys.executable, "-c", FORK_DURING_EIGH, str(tmp_path)],
        capture_output=True, text=True, timeout=60, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    assert any(tmp_path.iterdir()), "the forked write landed no entry"
