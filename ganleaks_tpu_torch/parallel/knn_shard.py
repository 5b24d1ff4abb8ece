"""Multi-GPU kNN — the attack's scaling axis (port of
``ganleaks_tpu.parallel.knn_shard``), one process per device over
``torch.distributed`` (``parallel/mesh``).

Two layouts over a 1-D mesh, each rank running the port's single-device
engines and kernels on its share:

* sharded — the synthetic set split into contiguous shards, the queries
  on every rank. Each rank folds its shard; the (min, argmin) states are
  all-gathered and the first shard attaining the minimum wins, so equal
  distances resolve to the smallest global index (``torch.min``'s rule):
  the single-device search's indices exactly.
* ring — both sets split. Query shards stay; synthetic shards rotate to
  the next rank by paired send/receive, each block's transfer running
  while this rank folds it. Blocks arrive in rotated order, so the ranks
  merge them by (distance, global index) explicitly (:func:`_lex_merge`).

:func:`knn_argmin_sharded` and :func:`knn_argmin_ring` search resident
shards, featurising per block (small sets; the dry run). The streamed
searches run the single-device loop (``ops/knn._stream_search``) on each
rank with :class:`~ganleaks_tpu_torch.ops.knn.RankHooks`: the planner's
budget agreed over the ranks (ranks sharing a card split its budget), an
out-of-memory on any rank halving every rank's block alike before the next
collective (``_stream_search`` says where), and

* :func:`knn_argmin_sharded_streamed` / :func:`knn_topk_sharded_streamed`:
  each query block featurised a share per rank and all-gathered into the
  cache every rank holds, each rank sweeping only its synthetic shard,
  the states merged at each chunk's end (top-k: a device-major stable
  concatenation, then the k first);
* :func:`knn_argmin_ring_streamed`: each rank featurises its home shard's
  blocks once and the EMBEDDED blocks rotate;
* :func:`knn_argmin_two_pass_mesh`: sharded top-k pass 1, the candidate
  union re-ranked on every rank through K1 on float32, the certificate's
  fallback re-searched sharded through K1.

Engines: the single-device ones, each rank's search built by
``ops/knn.search_spec``. The JAX mesh searches map 'pallas' to 'gemm';
here 'pallas' keeps the port's fused kernels (K1, K3) on every rank
(ROADMAP C).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from ganleaks_tpu_torch.ops.knn import (PhaseTimer, RankHooks,
                                        _as_device_block, _fold_block,
                                        _stream_search, check_engine,
                                        knn_argmin_two_pass, pad_rows,
                                        search_spec, sq_norms)
from ganleaks_tpu_torch.parallel.mesh import (Mesh, RingTransfer, RowGather,
                                              all_gather_rows, any_rank,
                                              gather_state,
                                              reduce_max_tensor,
                                              reduce_scalar, ring_shift,
                                              shard_rows)


def _pad_to(x, rows: int):
    """``x`` (numpy or torch) zero-padded on axis 0 to ``rows`` rows."""
    short = rows - len(x)
    if short <= 0:
        return x
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.zeros((short,) + x.shape[1:], x.dtype)])
    return torch.cat([x, x.new_zeros((short,) + tuple(x.shape[1:]))])


def _lex_merge(run_d, run_i, bd, bi):
    """Lexicographic (distance, global index) merge — shards arrive in
    per-rank ROTATED order, so first-index ties must be explicit."""
    better = (bd < run_d) | ((bd == run_d) & (bi < run_i))
    return torch.where(better, bd, run_d), torch.where(better, bi, run_i)


def _first_shard(d: torch.Tensor, i: torch.Tensor):
    """(size, rows) per-rank states -> the first rank's entry among those
    attaining each row's minimum (contiguous shards: the smallest global
    index)."""
    best = torch.argmin(d, dim=0, keepdim=True)
    return d.gather(0, best)[0], i.gather(0, best)[0]


# ---------------------------------------------------------------------------
# resident shards, featurised per block (small sets; the dry run)
# ---------------------------------------------------------------------------

def _local_search(embed_fn, queries, syn_shard, n_valid_local: int,
                  engine: str, q_block: int, s_block: int, idx_offset: int,
                  device: torch.device):
    """Blocked search of ``queries`` against one resident shard (padded;
    its first ``n_valid_local`` rows real): (min distance, global argmin)
    for every query row."""
    out_d, out_i = [], []
    n_s = len(syn_shard)
    with torch.inference_mode():
        for qs in range(0, len(queries), q_block):
            emb_q = embed_fn(_as_device_block(queries, qs, q_block, device))
            rq = sq_norms(emb_q)
            run_min = torch.full((emb_q.shape[0],), torch.inf,
                                 device=device)
            run_idx = torch.zeros(emb_q.shape[0], dtype=torch.int32,
                                  device=device)
            for ss in range(0, n_s, s_block):
                blk = pad_rows(_as_device_block(syn_shard, ss, s_block,
                                                device), s_block)
                n_valid = min(max(n_valid_local - ss, 0), s_block)
                run_min, run_idx = _fold_block(run_min, run_idx, emb_q, rq,
                                               embed_fn(blk), ss, n_valid,
                                               engine)
            out_d.append(run_min)
            out_i.append(run_idx + idx_offset)
    return torch.cat(out_d), torch.cat(out_i)


def _check_fold_engine(engine: str) -> None:
    if engine not in ("gemm", "exact"):
        raise ValueError(f"unknown resident-shard kNN engine {engine!r}; "
                         f"expected 'gemm' or 'exact'")


def knn_argmin_sharded(embed_fn, queries, syn, mesh: Mesh, *,
                       engine: str = "gemm", q_block: int = 2048,
                       s_block: int = 2048
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Generated-set-sharded 1-NN, the queries on every rank: each rank
    searches its resident shard, then the per-rank (min, argmin) states
    are all-gathered and the first shard attaining the minimum wins. The
    result is on every rank."""
    _check_fold_engine(engine)
    start, stop, per = shard_rows(len(syn), mesh)
    shard = _pad_to(syn[start:stop], per)
    d, i = _local_search(embed_fn, queries, shard, stop - start, engine,
                         q_block, min(s_block, per), start, mesh.device)
    return _first_shard(*gather_state(d, i, mesh))


def knn_argmin_ring(embed_fn, queries, syn, mesh: Mesh, *,
                    engine: str = "gemm", q_block: int = 2048,
                    s_block: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Ring-pass 1-NN: query shards stay, generated IMAGE shards rotate to
    the next rank; after ``size`` steps every query shard has folded
    every generated shard, no rank ever holding more than one shard of
    each set. The result, gathered, is on every rank."""
    _check_fold_engine(engine)
    n_q, n_s = len(queries), len(syn)
    q0, q1, q_per = shard_rows(n_q, mesh)
    s0, s1, s_per = shard_rows(n_s, mesh)
    q_loc = _pad_to(queries[q0:q1], q_per)
    s_cur = _as_device_block(_pad_to(syn[s0:s1], s_per), 0, s_per,
                             mesh.device)
    run_d = run_i = None
    for t in range(mesh.size):
        # after t rotations this rank holds the shard born on (rank - t)
        origin = (mesh.rank - t) % mesh.size
        n_valid = min(max(n_s - origin * s_per, 0), s_per)
        d, i = _local_search(embed_fn, q_loc, s_cur, n_valid, engine,
                             q_block, min(s_block, s_per), origin * s_per,
                             mesh.device)
        run_d, run_i = (d, i) if run_d is None else _lex_merge(run_d, run_i,
                                                               d, i)
        if t != mesh.size - 1:
            s_cur, = ring_shift([s_cur], mesh).wait()
    return (all_gather_rows(run_d, mesh)[:n_q],
            all_gather_rows(run_i, mesh)[:n_q])


# ---------------------------------------------------------------------------
# streamed searches
# ---------------------------------------------------------------------------

def _budget(mesh: Mesh) -> Callable:
    """The planner's budget agreed over the ranks: this rank's share of
    its card (ranks on one card split it), the least over the ranks."""
    def budget(capacity: int | None) -> int | None:
        if capacity is None:  # off the card: every rank plans without one
            return None
        return int(reduce_scalar(capacity // mesh.share, mesh, "min"))
    return budget


def _hooks(mesh: Mesh, **kw) -> RankHooks:
    return RankHooks(rank=mesh.rank, size=mesh.size,
                     least=lambda n: int(reduce_scalar(n, mesh, "min")),
                     budget=_budget(mesh), **kw)


def _combine_argmin(mesh: Mesh) -> Callable:
    def combine(state):
        return _first_shard(*gather_state(state[0], state[1], mesh))
    return combine


def _combine_topk(mesh: Mesh) -> Callable:
    """Per-rank top-k states -> the global top-k: the ranks' lists
    concatenated device-major (earlier shards first), a stable sort, the
    first k — the first-index tie-break across shards. With the
    certificate's info the query norms are the ranks' common ones and
    ``rs_max`` the largest over the ranks."""
    def combine(state):
        d, i = gather_state(state[0], state[1], mesh)  # (size, rows, k)
        size, rows, k = d.shape
        cat_d = d.permute(1, 0, 2).reshape(rows, size * k)
        cat_i = i.permute(1, 0, 2).reshape(rows, size * k)
        d_sorted, pos = torch.sort(cat_d, dim=1, stable=True)
        out = (d_sorted[:, :k], torch.gather(cat_i, 1, pos[:, :k]))
        if len(state) > 2:
            out += (state[2],
                    reduce_max_tensor(state[3].reshape(1), mesh)[0])
        return out
    return combine


def _sharded_search(embed_fn, combine: Callable, queries, syn, mesh: Mesh,
                    *, engine: str, q_block: int, s_block: int,
                    query_cache_bytes: int, timer, auto_plan: bool,
                    query_reuse, reuse_siblings, info, k: int | None = None,
                    with_info: bool = False) -> tuple:
    """Run the search of ``engine`` (``ops/knn.search_spec``; top-``k``
    where ``k`` is given) with the synthetic set sharded and the queries
    featurised a share per rank."""
    check_engine(engine)
    n_s = len(syn)
    if n_s == 0:
        raise ValueError("empty synthetic set")
    timer = timer or PhaseTimer(mesh.device)
    spec = search_spec(embed_fn, queries, engine, mesh.device, timer, k=k,
                       with_info=with_info)
    spec = spec._replace(signature=spec.signature
                         + ("mesh-sharded", mesh.size))
    start, stop, per = shard_rows(n_s, mesh, s_block)
    # query blocks split over the ranks: a whole share per rank
    q_block = max(mesh.size, -(-q_block // mesh.size) * mesh.size)
    return _stream_search(
        spec, queries, syn[start:stop], q_block=q_block, s_block=s_block,
        query_cache_bytes=query_cache_bytes, device=mesh.device,
        timer=timer, auto_plan=auto_plan, query_reuse=query_reuse,
        reuse_siblings=reuse_siblings, info=info,
        ranks=_hooks(mesh, col_offset=start, sweep_rows=per,
                     gather=lambda t: RowGather(t, mesh),
                     combine=combine))


def knn_argmin_sharded_streamed(embed_fn, queries, syn, mesh: Mesh, *,
                                engine: str = "gemm", q_block: int = 2048,
                                s_block: int = 2048,
                                query_cache_bytes: int = 8 << 30,
                                timer: PhaseTimer | None = None,
                                auto_plan: bool = True,
                                query_reuse: dict | None = None,
                                reuse_siblings: tuple = (),
                                info: dict | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN at single-device engine parity with the synthetic set sharded
    (contiguous shards, ``shard_rows``): each rank featurises only its
    shard (once per query chunk) and a ``1/size`` share of every query
    block, all-gathered into the chunked query cache each rank holds;
    then the first-shard merge. ``engine`` 'taps' / 'taps-int8' expects
    the parts featuriser (``ops/distance.make_embed_parts_fn``). The
    result is on every rank: the single-device search's indices, the
    first index winning ties across shards."""
    return _sharded_search(
        embed_fn, _combine_argmin(mesh), queries, syn, mesh, engine=engine,
        q_block=q_block, s_block=s_block,
        query_cache_bytes=query_cache_bytes, timer=timer,
        auto_plan=auto_plan, query_reuse=query_reuse,
        reuse_siblings=reuse_siblings, info=info)


def knn_topk_sharded_streamed(embed_fn, queries, syn, mesh: Mesh, *,
                              k: int = 8, engine: str = "gemm",
                              q_block: int = 2048, s_block: int = 2048,
                              query_cache_bytes: int = 8 << 30,
                              with_info: bool = False,
                              timer: PhaseTimer | None = None,
                              auto_plan: bool = True,
                              query_reuse: dict | None = None,
                              reuse_siblings: tuple = (),
                              info: dict | None = None) -> tuple:
    """Per-query k smallest distances and their indices on a mesh (pass 1
    of :func:`knn_argmin_two_pass_mesh`), streamed like
    :func:`knn_argmin_sharded_streamed`; the per-rank lists merge by the
    first-index-stable device-major concatenation. ``with_info`` appends
    ``(rq, rs_max)`` for the certificate."""
    return _sharded_search(
        embed_fn, _combine_topk(mesh), queries, syn, mesh, engine=engine,
        k=k, with_info=with_info, q_block=q_block, s_block=s_block,
        query_cache_bytes=query_cache_bytes, timer=timer,
        auto_plan=auto_plan, query_reuse=query_reuse,
        reuse_siblings=reuse_siblings, info=info)


def knn_argmin_two_pass_mesh(embed_lo, embed_hi, queries, syn, mesh: Mesh,
                             **kw):
    """Two-pass exact-index mode on a mesh (``ops/knn.
    knn_argmin_two_pass`` laid out over the ranks, same arguments): the
    sharded streamed top-k under ``embed_lo`` as pass 1, the candidate
    union re-ranked on every rank under the float32 ``embed_hi`` through
    K1 ('exact' where asked), the same runtime certificate, and the
    uncertified queries re-searched sharded against the full set through
    K1. Every rank returns the whole result."""
    return knn_argmin_two_pass(
        embed_lo, embed_hi, queries, syn, device=mesh.device,
        topk_search=functools.partial(knn_topk_sharded_streamed, mesh=mesh),
        argmin_search=functools.partial(knn_argmin_sharded_streamed,
                                        mesh=mesh), **kw)


def knn_argmin_ring_streamed(embed_fn, queries, syn, mesh: Mesh, *,
                             engine: str = "gemm", q_block: int = 2048,
                             s_block: int = 2048,
                             query_cache_bytes: int = 8 << 30,
                             timer: PhaseTimer | None = None,
                             auto_plan: bool = True,
                             query_reuse: dict | None = None,
                             reuse_siblings: tuple = (),
                             info: dict | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ring-pass 1-NN at streamed-engine parity: each rank caches its
    query shard's embeddings (chunked, as ``ops/knn``), featurises each
    block of its home synthetic shard ONCE, and the embedded block makes
    ``size - 1`` hops to the next rank, each hop's transfer running while
    this rank folds the block (:class:`~ganleaks_tpu_torch.parallel.mesh.
    RingTransfer`); the hops merge by (distance, global index). The 'fold'
    spans of ``timer`` time the folds alone; the hops' waits and copies
    are in ``mesh.stats``. Per-rank
    memory: a shard of each set, the shard's query cache and two embedded
    blocks — flat in both set sizes. The result, gathered, is on every
    rank. ``query_reuse`` holds this rank's query-shard cache (its
    fingerprint tagged with the layout, the world and the rank)."""
    check_engine(engine)
    n_q, n_s = len(queries), len(syn)
    if n_s == 0:
        raise ValueError("empty synthetic set")
    device = mesh.device
    timer = timer or PhaseTimer(device)
    q0, q1, q_per = shard_rows(n_q, mesh, q_block)
    s0, s1, s_per = shard_rows(n_s, mesh, s_block)
    # every rank holds q_per query rows: padding is tail-only, so the
    # gathered rows keep the global order and the first n_q are real
    q_loc = _pad_to(queries[q0:q1], q_per)
    spec = search_spec(embed_fn, q_loc, engine, device, timer)

    fold, init_state = spec.fold, spec.init_state

    def shard_len(origin: int) -> int:
        return min(max(n_s - origin * s_per, 0), s_per)

    def ring_fold(state, cache, rq, s_emb, rs, ss, n_valid):
        """Fold the home block at ``ss`` and the ``size - 1`` blocks it
        meets on its way round. Every step that can run out of memory
        (staging a hop, folding, landing the received block) is agreed
        before the next hop is posted, so an OOM on one rank makes every
        rank raise it at the same step; the caller keeps ``state``."""
        run_d, run_i = state
        cur, hop, failed = [s_emb, rs], None, False
        try:
            fresh = init_state(rq.shape[0])
            if mesh.size > 1:
                hop = RingTransfer(cur, mesh)
        except torch.cuda.OutOfMemoryError:
            failed = True
        for t in range(mesh.size):
            if t < mesh.size - 1:  # before the next hop: all alike
                if any_rank(failed, mesh):
                    raise torch.cuda.OutOfMemoryError(
                        "ring step out of device memory on a rank")
                hop.start()  # runs while this rank folds cur
            origin = (mesh.rank - t) % mesh.size
            valid = min(max(shard_len(origin) - ss, 0), cur[0].shape[0])
            try:
                if valid and not failed:
                    tok = timer.start("fold")
                    blk = fold(fresh, cache, rq, cur[0], cur[1],
                               origin * s_per + ss, valid)
                    run_d, run_i = _lex_merge(run_d, run_i, *blk)
                    timer.stop(tok)
            except torch.cuda.OutOfMemoryError:
                failed = True
            if t < mesh.size - 1:
                hop.finish()  # every posted hop completes on every rank
                try:
                    cur = hop.land()
                    hop = (RingTransfer(cur, mesh) if t + 2 < mesh.size
                           else None)
                except torch.cuda.OutOfMemoryError:
                    failed = True
        if any_rank(failed, mesh):
            raise torch.cuda.OutOfMemoryError(
                "ring step out of device memory on a rank")
        return run_d, run_i

    spec = spec._replace(fold=ring_fold, signature=spec.signature
                         + ("ring", mesh.size, mesh.rank))
    d, i = _stream_search(
        spec, q_loc, syn[s0:s1], q_block=q_block, s_block=s_block,
        query_cache_bytes=query_cache_bytes, device=device, timer=timer,
        auto_plan=auto_plan, query_reuse=query_reuse,
        reuse_siblings=reuse_siblings, info=info,
        ranks=_hooks(mesh, sweep_rows=s_per, exchanges=True))
    return (all_gather_rows(d, mesh)[:n_q], all_gather_rows(i, mesh)[:n_q])
