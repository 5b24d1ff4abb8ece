"""Rules of every test run in this repo, loaded before ``tests/conftest.py``
imports jax.

OpenBLAS runs on the calling thread alone. ``tests/conftest.py`` forks the
test process for every persistent compile-cache write, while jax may be
inside scipy's OpenBLAS on another thread (jaxlib's CPU ``eigh`` and friends
run asynchronously); OpenBLAS's fork handler takes its worker threads down
under that call, which then waits for them forever.

Every test runs under a deadline: ``TEST_TIMEOUT_S``, or the seconds of its
``@pytest.mark.timeout(seconds)``.
"""

import contextlib
import faulthandler
import os
import signal

os.environ["OPENBLAS_NUM_THREADS"] = "1"

import pytest  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

# a plugin (jaxtyping's) loads numpy before this file runs: its OpenBLAS
# has read no OPENBLAS_NUM_THREADS
threadpool_limits(limits=1, user_api="blas")

TEST_TIMEOUT_S = 300.0
# (file, test) -> seconds: the tests whose slowest run under the tier-1
# command (-n 6) passed half the default, at twice that run or more
LONGER_S = {
    # the JAX package's whole 8-device CPU dry run (343 s)
    ("test_parallel_train.py", "test_graft_entry_single_and_multichip"): 750,
    ("test_npz_ingest.py", "test_fid_from_paths_npz_equals_png_dir"): 600,
    ("test_torch_ep_privgan.py",
     "test_ep_privdcgan_gate_off_is_the_all_splits_step"): 600,
    ("test_pggan_highres.py", "test_pggan_shapes_to_1024"): 600,
    ("test_torch_train_ranks.py", "test_dp_step_matches_one_process"): 600,
}
# a dup of the real stderr, for the backstop's stack dump (fd 2 is
# pytest's capture file while a test runs)
_STDERR = None


def pytest_configure(config):
    global _STDERR
    capman = config.pluginmanager.getplugin("capturemanager")
    with (capman.global_and_fixture_disabled() if capman
          else contextlib.nullcontext()):
        _STDERR = os.fdopen(os.dup(2), "w")


def pytest_collection_modifyitems(items):
    for item in items:
        seconds = LONGER_S.get((item.path.name, item.originalname))
        if seconds:
            item.add_marker(pytest.mark.timeout(seconds))


def deadline_s(item) -> float:
    mark = item.get_closest_marker("timeout")
    return float(mark.args[0]) if mark else TEST_TIMEOUT_S


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """Setup, call and teardown of a test run under its deadline. Past it
    every thread's stack is dumped into the test's captured stderr and
    the test fails with its node id and limit. A test stuck in C code
    never takes that exception: at twice the limit (at most a minute
    past it) faulthandler dumps the stacks to the real stderr and ends
    the process, which xdist reports as a crash of this test before it
    starts a new worker."""
    limit = deadline_s(item)

    def expire(signum, frame):
        try:
            faulthandler.dump_traceback(all_threads=True)
        except ValueError:  # capsys's stderr has no file descriptor
            faulthandler.dump_traceback(file=_STDERR, all_threads=True)
        pytest.fail(f"{item.nodeid} ran past its limit of {limit:g} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + min(limit, 60.0), exit=True,
                                      file=_STDERR)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
