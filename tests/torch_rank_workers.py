"""Functions the rank tests run on each spawned rank
(``ganleaks_tpu_torch.parallel.multihost.launch``). Every child imports
this module by name, so it imports torch and the port only, never JAX.

Each function runs several cases on one launch and returns, from rank 0,
a dict of numpy results the tests assert one by one."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ganleaks_tpu_torch.ops import knn
from ganleaks_tpu_torch.ops.distance import (make_embed_fn,
                                             make_embed_parts_fn)
from ganleaks_tpu_torch.parallel import knn_shard as ks
from ganleaks_tpu_torch.parallel import mesh as pmesh
from ganleaks_tpu_torch.parallel import multihost

ENGINES = ("gemm", "exact", "pallas", "taps", "taps-int8")


def embed_for(engine: str):
    return (make_embed_parts_fn("l2") if engine in ("taps", "taps-int8")
            else make_embed_fn("l2"))


def _np(*ts):
    return tuple(t.cpu().numpy() for t in ts)


# ---------------------------------------------------------------------------
# the two-pass certificate's adversarial embeddings (tests/
# test_knn_mesh_streamed.py::_adversarial_sets): row values in (0.9, 1.1)
# inflated by 1 + gamma in the cheap embedding
# ---------------------------------------------------------------------------

GAMMA = 5e-3


def embed_hi(x):
    return torch.as_tensor(x).float()


def embed_lo(x):
    x = torch.as_tensor(x).float()
    boost = torch.where((x > 0.9) & (x < 1.1), 1.0 + GAMMA, 1.0)
    return x * boost


class OneShotOOM:
    """Wraps ``fn``: on rank ``rank`` only, its call number ``at`` raises
    ``torch.cuda.OutOfMemoryError`` once. With ``row``, only the calls
    whose first argument's first row is ``row`` count."""

    def __init__(self, fn, rank: int, at: int = 1, row=None):
        self.fn, self.rank, self.at, self.calls = fn, rank, at, 0
        self.row = None if row is None else torch.as_tensor(row)

    def __call__(self, *a, **kw):
        if self.row is None or torch.equal(torch.as_tensor(a[0])[0],
                                           self.row):
            self.calls += 1
            if dist.get_rank() == self.rank and self.calls == self.at:
                raise torch.cuda.OutOfMemoryError("injected on one rank")
        return self.fn(*a, **kw)


def _forced(mesh, run, obj=None, name: str = "", at: int = 1) -> tuple:
    """``run(info)``, with ``obj.name`` failing once on the last rank at
    its call ``at`` where ``obj`` is given: the result and every rank's
    halvings."""
    real = getattr(obj, name, None)
    if obj is not None:
        setattr(obj, name, OneShotOOM(real, mesh.size - 1, at=at))
    info: dict = {}
    try:
        res = _np(*run(info))
    finally:
        if obj is not None:
            setattr(obj, name, real)
    return res, _halvings(info, mesh)


def _halvings(info: dict, mesh) -> list:
    return pmesh.gather_objects(info["halvings"], mesh)


# ---------------------------------------------------------------------------
# sharded layout
# ---------------------------------------------------------------------------

def sharded_cases(data: dict) -> dict:
    mesh = multihost.global_mesh()
    out: dict = {"size": mesh.size}
    q, s = data["q"], data["s"]
    for engine in ENGINES:
        out[f"argmin_{engine}"] = _np(*ks.knn_argmin_sharded_streamed(
            embed_for(engine), q, s, mesh, engine=engine, q_block=4,
            s_block=4))
    tq, ts = data["tie_q"], data["tie_s"]
    out["multi_chunk_ties"] = _np(*ks.knn_argmin_sharded_streamed(
        make_embed_fn("l2"), tq, ts, mesh, q_block=4, s_block=4,
        query_cache_bytes=8 * 192 * 4))
    for engine in ("gemm", "pallas", "taps"):
        out[f"topk_{engine}"] = _np(*ks.knn_topk_sharded_streamed(
            embed_for(engine), q, s, mesh, k=5, engine=engine, q_block=4,
            s_block=4, with_info=True))
    # featurisation work: each rank featurises its query shares and its
    # synthetic shard once per chunk
    timer = knn.PhaseTimer(mesh.device)
    ks.knn_argmin_sharded_streamed(make_embed_fn("l2"), data["q16"],
                                   data["s64"], mesh, q_block=8, s_block=4,
                                   timer=timer)
    out["featurize_calls"] = pmesh.gather_objects(
        len(timer._marks["featurize"]), mesh)
    # the planner's s_block need not divide the shard
    out["nondivisor"] = _np(*ks.knn_argmin_sharded_streamed(
        make_embed_fn("l2"), data["q6"], data["s36"], mesh, q_block=8,
        s_block=5))
    # two-pass on the mesh: the certificate catches the near-tie and the
    # sharded fallback fixes it; far decoys certify
    for name in ("adv", "far"):
        d, i, cert, n_fb = ks.knn_argmin_two_pass_mesh(
            embed_lo, embed_hi, data[f"{name}_q"], data[f"{name}_s"], mesh,
            k=3, engine="gemm", q_block=8, s_block=4, cert_eta=1e-2,
            return_cert=True)
        out[f"two_pass_{name}"] = _np(d, i) + (cert, n_fb)
    for engine in ENGINES:
        lo = embed_for(engine)
        d, i, cert, n_fb = ks.knn_argmin_two_pass_mesh(
            lo, make_embed_fn("l2"), data["q7"], data["s29"], mesh, k=3,
            engine=engine, q_block=8, s_block=4, return_cert=True)
        out[f"two_pass_{engine}"] = _np(d, i) + (cert, n_fb)
    # an OOM forced on one rank: the cache allocation (rank 0), a query
    # share (the last rank) and a synthetic fold (rank 1 % size); every
    # rank halves alike and the result equals the unforced run
    last = mesh.size - 1
    real_alloc, real_fold = knn._alloc_cache, knn._fold_block
    embed = OneShotOOM(make_embed_fn("l2"), last, at=2)  # 1: the probe
    knn._alloc_cache = OneShotOOM(real_alloc, 0)
    knn._fold_block = OneShotOOM(real_fold, 1 % mesh.size, at=2)
    try:
        info: dict = {}
        res = ks.knn_argmin_sharded_streamed(
            embed, data["q32"], data["s32"], mesh, engine="exact",
            q_block=16, s_block=8, query_cache_bytes=32 * 192 * 4,
            info=info)
    finally:
        knn._alloc_cache, knn._fold_block = real_alloc, real_fold
    out["oom"] = _np(*res)
    out["oom_halvings"] = _halvings(info, mesh)
    out["oom_clean"] = _np(*ks.knn_argmin_sharded_streamed(
        make_embed_fn("l2"), data["q32"], data["s32"], mesh, engine="exact",
        q_block=16, s_block=8, query_cache_bytes=32 * 192 * 4))

    # one rank fails staging its first query share for the all-gather, or
    # twice in a row featurising its first synthetic block (a sweep holds
    # no collective: the others take its s_block at the chunk's end)
    def run(embed):
        return lambda info: ks.knn_argmin_sharded_streamed(
            embed, data["q32"], data["s32"], mesh, engine="exact",
            q_block=16, s_block=8, info=info)

    out["oom_staging"] = _forced(mesh, run(make_embed_fn("l2")), pmesh,
                                 "_to_wire")
    first = data["s32"][pmesh.shard_rows(32, mesh, 8)[0]] \
        if mesh.rank == 1 % mesh.size else None
    twice = OneShotOOM(OneShotOOM(make_embed_fn("l2"), 1 % mesh.size,
                                  row=first), 1 % mesh.size, row=first)
    out["oom_sweep"] = _forced(mesh, run(twice))
    # query reuse across calls: the second call over the same queries
    # skips their featurisation on every rank
    holder: dict = {}
    info1: dict = {}
    ks.knn_argmin_sharded_streamed(make_embed_fn("l2"), q, s, mesh,
                                   q_block=4, s_block=4, query_reuse=holder)
    again = ks.knn_argmin_sharded_streamed(
        make_embed_fn("l2"), q, s, mesh, q_block=4, s_block=4,
        query_reuse=holder, info=info1)
    out["reuse"] = _np(*again) + (pmesh.gather_objects(
        info1["query_reused"], mesh),)
    # the planner's budget: every rank plans from the least share
    budget = ks._budget(mesh)
    out["budget"] = pmesh.gather_objects(
        budget(1000 * (mesh.rank + 1)), mesh)
    out["stats"] = dict(mesh.stats)
    return out


# ---------------------------------------------------------------------------
# ring layout and the resident-shard searches
# ---------------------------------------------------------------------------

def ring_cases(data: dict) -> dict:
    mesh = multihost.global_mesh()
    out: dict = {"size": mesh.size}
    q, s = data["q"], data["s"]
    for engine in ENGINES:
        out[f"ring_{engine}"] = _np(*ks.knn_argmin_ring_streamed(
            embed_for(engine), q, s, mesh, engine=engine, q_block=4,
            s_block=4))
    out["ring_ties"] = _np(*ks.knn_argmin_ring_streamed(
        make_embed_fn("l2"), data["tie_q"], data["tie_s"], mesh, q_block=4,
        s_block=4))
    timer = knn.PhaseTimer(mesh.device)
    out["ring_once"] = _np(*ks.knn_argmin_ring_streamed(
        make_embed_fn("l2"), data["q16"], data["s64"], mesh, q_block=2,
        s_block=4, timer=timer))
    out["ring_featurize_calls"] = pmesh.gather_objects(
        len(timer._marks["featurize"]), mesh)
    # an OOM in one rank's hop: every rank gives the step up and halves
    real_fold = knn._fold_block
    knn._fold_block = OneShotOOM(real_fold, mesh.size - 1, at=2)
    try:
        info: dict = {}
        out["ring_oom"] = _np(*ks.knn_argmin_ring_streamed(
            make_embed_fn("l2"), data["q37"], data["s37"], mesh,
            engine="exact", q_block=5, s_block=5, info=info))
    finally:
        knn._fold_block = real_fold
    out["ring_oom_halvings"] = _halvings(info, mesh)

    # the last rank fails featurising its second home block, staging a
    # hop, or landing a received block
    def ring(embed):
        return lambda info: ks.knn_argmin_ring_streamed(
            embed, data["q37"], data["s37"], mesh, engine="exact",
            q_block=5, s_block=5, info=info)

    last = mesh.size - 1
    home = pmesh.shard_rows(37, mesh, 5)[0]
    row = data["s37"][home + 5] if mesh.rank == last else None
    out["ring_oom_featurise"] = _forced(
        mesh, ring(OneShotOOM(make_embed_fn("l2"), last, row=row)))
    for site, name in (("staging", "_to_wire"), ("landing", "_from_wire")):
        out[f"ring_oom_{site}"] = _forced(mesh, ring(make_embed_fn("l2")),
                                          pmesh, name, at=3)
    out["ring_nondivisor"] = _np(*ks.knn_argmin_ring_streamed(
        make_embed_fn("l2"), data["q37"], data["s37"], mesh, engine="exact",
        q_block=5, s_block=5))
    for name in ("res64", "res60"):
        syn, queries = data[f"{name}_s"], data[f"{name}_q"]
        out[f"resident_{name}"] = _np(*ks.knn_argmin_sharded(
            make_embed_fn("l2"), queries, syn, mesh, q_block=4, s_block=4))
    out["resident_tie"] = _np(*ks.knn_argmin_sharded(
        make_embed_fn("l2"), data["rt_q"], data["rt_s"], mesh,
        engine="exact", q_block=4, s_block=4))
    for name in ("rr64", "rr57"):
        out[f"resident_ring_{name}"] = _np(*ks.knn_argmin_ring(
            lambda x: torch.as_tensor(x).float(), data[f"{name}_q"],
            data[f"{name}_s"], mesh, q_block=4, s_block=4))
    return out


# ---------------------------------------------------------------------------
# wire-up
# ---------------------------------------------------------------------------

def wireup_cases() -> dict:
    rank, world = multihost.initialize()  # the group is up: a no-op
    mesh = multihost.global_mesh()
    errors = {}
    for n in (world + 1, world - 1):
        try:
            multihost.global_mesh(n)
        except ValueError as e:
            errors[n] = str(e)
    rows = torch.full((3, 2), float(rank))
    x = torch.arange(4.0) + 10 * rank
    y = x.clone() if rank == 0 else torch.zeros(4)
    pmesh.replicate(y, mesh)
    moved, = pmesh.ring_shift([x], mesh).wait()
    dp = pmesh.data_parallel_mesh((world,), ("data",), device="cpu")
    return {"initialize": pmesh.gather_objects((rank, world), mesh),
            "data_parallel": (pmesh.data_parallel_mesh((1,)) is None,
                              dp.size, dp.axis, dp.rank == rank),
            "mesh": (mesh.size, mesh.share, mesh.backend, str(mesh.device)),
            "single": multihost.global_mesh(1) is None,
            "errors": errors,
            "gathered": multihost.gather_to_host(rows, mesh, n=2 * world - 1),
            "replicated": pmesh.gather_objects(y.tolist(), mesh),
            "ring": pmesh.gather_objects(moved.tolist(), mesh),
            "any": (pmesh.any_rank(rank == world - 1, mesh),
                    pmesh.any_rank(False, mesh)),
            "shares": pmesh.gather_objects(
                pmesh.shard_rows(7, mesh), mesh),
            "batch": pmesh.gather_objects(
                pmesh.shard_batch(list(range(7)), mesh), mesh)}


def fail_on(rank: int) -> None:
    """Rank ``rank`` raises; the others wait on it in a collective."""
    if dist.get_rank() == rank:
        raise ValueError(f"planted failure on rank {rank}")
    dist.barrier()


def deadlock() -> None:
    """Rank 0 waits for a message rank 1 never sends."""
    if dist.get_rank() == 0:
        dist.recv(torch.zeros(1), src=1)
    else:
        import time
        time.sleep(120)


def attack_cases(cfgs: dict, syn, pos, neg) -> dict:
    """``attack_arrays`` on the group's mesh for every config."""
    from ganleaks_tpu_torch.attack.fbb import attack_arrays

    mesh = multihost.global_mesh()
    out = {}
    for name, cfg in cfgs.items():
        r = attack_arrays(cfg, syn, pos, neg, device="cpu", mesh=mesh)
        out[name] = {k: r[k] for k in ("pos_loss", "pos_nn_idx", "neg_loss",
                                       "neg_nn_idx")}
        out[name]["ranks"] = r["ranks"]
    return out


def fid_case(images1, images2, batch_size: int) -> dict:
    from ganleaks_tpu_torch.ops import fid

    mesh = multihost.global_mesh()
    model = fid.init_inception_params(0)
    acts = fid.get_activations(model, images1, batch_size, device="cpu",
                               mesh=mesh)
    tail = fid.get_activations(model, images1, batch_size,
                               drop_remainder=False, device="cpu",
                               mesh=mesh)
    value = fid.fid_from_image_sets(model, images1, images2, batch_size,
                                    method="eigh", device="cpu", mesh=mesh)
    return {"acts": acts, "tail": tail, "fid": value,
            "same": pmesh.gather_objects(float(acts.sum()), mesh)}
