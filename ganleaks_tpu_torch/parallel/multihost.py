"""Multi-process wire-up for multi-GPU runs (port of
``ganleaks_tpu.parallel.multihost``).

The JAX package runs one controller per host over ``jax.distributed``;
the port runs one process per device over ``torch.distributed``, as under
``torchrun``: each process sets its own device first, joins the process
group, and runs the same program on the same data order, the searches
exchanging only what their layout needs (``parallel/knn_shard``).

* :func:`initialize` joins the group from explicit arguments, the
  ``GANLEAKS_*`` variables or a launcher's world (``torchrun``'s
  ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``MASTER_ADDR``); with none
  of them it is a no-op returning ``(0, 1)``.
* :func:`global_mesh` is the group's mesh (None for one device).
* :func:`gather_to_host` collects rank-sharded rows (the ring layout's
  results) on every rank.
* :func:`launch` spawns ``n`` local processes, one per device, runs a
  function on each and returns rank 0's result; a failed rank makes it
  raise with that rank's traceback, and a time limit makes a deadlock fail
  instead of hang. :func:`launch_plan` picks the devices and backend of
  such a launch on a host with fewer cards than ranks.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ganleaks_tpu_torch.parallel.mesh import Mesh, all_gather_rows, mesh_of

_COORD_ENV = "GANLEAKS_COORDINATOR"        # host:port of process 0
_NPROC_ENV = "GANLEAKS_NUM_PROCESSES"
_PID_ENV = "GANLEAKS_PROCESS_ID"
# collectives that wait longer than this fail instead of hanging
DEFAULT_TIMEOUT_S = 1800.0

_RANK_DEVICE: torch.device | None = None   # set by launch() in each child


def _launcher_env() -> bool:
    """True under a launcher that publishes the world (``torchrun``)."""
    env = os.environ
    return bool(env.get("WORLD_SIZE") and env.get("RANK")
                and env.get("MASTER_ADDR"))


def local_device() -> torch.device:
    """This process's device: the one :func:`launch` gave it, else the
    current CUDA device where CUDA is up, else the CPU."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _set_local_cuda(rank: int) -> None:
    """Before anything else touches the card: this rank's device is
    ``LOCAL_RANK`` (else rank modulo the visible devices)."""
    if not torch.cuda.is_available():
        return
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local else rank % torch.cuda.device_count()
    torch.cuda.set_device(index)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Join the process group; returns ``(rank, world size)``.

    Each parameter resolves from the explicit argument, then the
    ``GANLEAKS_*`` variable; without a coordinator a launcher's world
    (``torchrun``: ``env://``) is read instead. With none of them — no
    arguments, no variables, no launcher — this is a no-op returning
    ``(0, 1)``, so the same entry points run anywhere.

    A partial explicit configuration (more than one process, or a process
    id past 0, with no coordinator and no launcher) raises ``ValueError``:
    every rank would otherwise run as an independent process 0, N full
    runs racing to write the same save_dir. Idempotent: with the group
    already up it reports the current topology. ``backend``: default NCCL
    where CUDA and NCCL are up, else ``gloo`` (ranks sharing a card need
    ``gloo``)."""
    coordinator_address = coordinator_address or os.environ.get(_COORD_ENV)
    if num_processes is None and os.environ.get(_NPROC_ENV):
        num_processes = int(os.environ[_NPROC_ENV])
    if process_id is None and os.environ.get(_PID_ENV):
        process_id = int(os.environ[_PID_ENV])
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    launcher = _launcher_env()
    if (coordinator_address is None and not launcher
            and ((num_processes or 1) > 1 or (process_id or 0) > 0)):
        raise ValueError(
            f"multihost: num_processes={num_processes} "
            f"process_id={process_id} but no coordinator address "
            f"({_COORD_ENV}) and no launcher (torchrun's WORLD_SIZE / "
            f"RANK / MASTER_ADDR) — refusing to run single-process with "
            f"multi-process config")
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError(
                f"multihost: coordinator {coordinator_address} needs "
                f"num_processes ({_NPROC_ENV}) and process_id ({_PID_ENV})")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
        rank = process_id
    elif launcher:
        rank = int(os.environ["RANK"])
        init = dict(init_method="env://")
    else:
        return 0, 1
    _set_local_cuda(rank)
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and dist.is_nccl_available() else "gloo")
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **init)
    return dist.get_rank(), dist.get_world_size()


def in_group() -> bool:
    """Whether this process is one rank of several: a live process group,
    or a launcher's world to join."""
    return (dist.is_available() and dist.is_initialized()) \
        or _launcher_env()


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(n_chips: int | None = None, axis: str = "syn",
                device: torch.device | str | None = None) -> Mesh | None:
    """The 1-D mesh over the process group's ranks: ``n_chips`` defaults
    to the world; None for one device. It raises when ``n_chips`` exceeds
    the world, or falls short of it (one rank per device of the mesh).
    ``device``: this rank's (default :func:`local_device`). Collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_chips or world
    if n > world:
        raise ValueError(
            f"n_chips={n} but only {world} rank(s): start one process per "
            f"device (torchrun, multihost=true, or the CLI's local launch)")
    if n <= 1:
        return None
    if n != world:
        raise ValueError(f"n_chips={n} but the process group has {world} "
                         f"ranks: the mesh takes one rank per device")
    return mesh_of(device if device is not None else local_device(),
                   axis=axis)


def gather_to_host(x, mesh: Mesh | None = None,
                   n: int | None = None) -> np.ndarray:
    """Host numpy copy of rank-sharded rows: every rank's rows of ``x``
    (equal shapes) in rank order, cut to the first ``n``; without a mesh,
    ``x`` itself. Every rank gets the whole value, so artifact writing
    stays rank-agnostic."""
    if mesh is not None:
        x = all_gather_rows(torch.as_tensor(x), mesh)
    out = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out if n is None else out[:n]


# ---------------------------------------------------------------------------
# local launcher
# ---------------------------------------------------------------------------

def local_devices(n: int, device: torch.device | str) -> list[str] | str:
    """The devices of a local launch of ``n`` ranks of ``device``'s type:
    ``cuda:0..n-1``, refused where fewer cards are visible (as the JAX
    package's ``global_mesh`` refuses more chips than devices), or the
    CPU for every rank."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if n > torch.cuda.device_count():
        raise ValueError(f"n_chips={n} but only "
                         f"{torch.cuda.device_count()} CUDA devices")
    return [f"cuda:{r}" for r in range(n)]


def launch_plan(n: int, device: torch.device | str
                ) -> tuple[list[str] | str, str]:
    """The devices and backend of a local launch of ``n`` ranks on
    ``device``'s type: on the card rank r on ``cuda:r % cards``, NCCL
    where every rank has a card of its own, else ``gloo`` (NCCL refuses
    ranks that share a card); off the card ``gloo`` on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu", "gloo"
    cards = torch.cuda.device_count()
    return ([f"cuda:{r % cards}" for r in range(n)],
            "nccl" if n <= cards else "gloo")


def _devices(n: int, devices) -> list[torch.device]:
    if devices is None:
        devices = ([f"cuda:{r}" for r in range(n)]
                   if torch.cuda.is_available() else "cpu")
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    return [torch.device(d) for d in devices]


def _child(fn, args, kwargs, rank: int, n: int, device: str, backend: str,
           store_path: str, timeout_s: float, results) -> None:
    """One rank: its device first, then the group, then ``fn``."""
    global _RANK_DEVICE
    try:
        # every rank of a local launch is on this host: rendezvous and
        # gloo's transport over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                          LOCAL_RANK=str(rank))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # the ranks share this host's cores
            torch.set_num_threads(1)
        _RANK_DEVICE = dev
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*args, **kwargs)
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — the result is already sent
        pass


def launch(fn, n: int, *args, devices=None, backend: str | None = None,
           timeout_s: float = 600.0, **kwargs):
    """Run ``fn(*args, **kwargs)`` on ``n`` spawned processes, one per
    device, joined in one process group; return rank 0's result.

    ``devices``: one per rank (``"cuda:0"``, ``"cpu"``), or one for all
    (several ranks may share a card: they then split its memory budget);
    default ``cuda:0..n-1`` where CUDA is up, else the CPU. ``backend``:
    default NCCL when every rank has a card of its own, else ``gloo``.
    ``fn`` must be importable by name (a module-level function); each
    child imports its module, so keep JAX out of it. Rendezvous goes
    through a ``FileStore`` in a fresh temporary directory, so concurrent
    launches never collide on a port. A rank on the CPU runs torch on one
    thread (the ranks share the host's cores).

    A rank that raises makes this raise ``RuntimeError`` with its
    traceback, after ending every rank; so does a rank that dies without
    a word. Past ``timeout_s`` seconds (also each collective's limit) it
    ends every rank and raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    devs = _devices(n, devices)
    cuda = [d for d in devs if d.type == "cuda"]
    if backend is None:
        distinct = len({str(d) for d in cuda}) == n
        backend = ("nccl" if distinct and dist.is_nccl_available()
                   else "gloo")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ganleaks_launch_")
    procs = [ctx.Process(target=_child, args=(
        fn, args, kwargs, rank, n, str(devs[rank]), backend,
        os.path.join(tmp, "store"), timeout_s, results))
        for rank in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        done, out = set(), None
        dead: list = []
        while len(done) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"launch: {n - len(done)} of {n} ranks still running "
                    f"after {timeout_s:.0f} s (a deadlock?)")
            try:
                status, rank, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                if dead:  # dead at the last look, and still no word
                    raise RuntimeError(
                        f"launch: rank {dead[0]} died (exit code "
                        f"{procs[dead[0]].exitcode}) without a result")
                # a rank that reported and exited may have its message
                # still in the pipe: read once more before judging it
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                continue
            if status == "error":
                raise RuntimeError(f"launch: rank {rank} of {n} failed:\n"
                                   f"{value}")
            done.add(rank)
            if rank == 0:
                out = value
        for p in procs:
            p.join(timeout=30)
        return out
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
