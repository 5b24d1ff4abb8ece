"""Blocked nearest-neighbour search over embedding vectors (port of
``ganleaks_tpu.ops.knn``): 1-NN, top-k and the certified two-pass mode,
over flat embeddings and over tap-structured parts.

* The (queries x synthetic) distance matrix is never materialised whole:
  blocks are folded into a running (min, argmin) or a running top-k.
* The tie-break matches ``torch.min``: the FIRST index attaining the
  minimum wins — blocks are visited in index order, argmin updates use
  strict ``<`` and top-k merges are stable with running entries first.
* One entry point per search kind (``knn_argmin_streamed``,
  ``knn_topk_streamed``) takes every engine; ``search_spec`` alone turns
  an engine into its featuriser layout, cache dtype, fold and planner
  charges. Flat engines:
  - 'gemm'   : d = ||q||^2 + ||s||^2 - 2 q.s with ``torch.matmul``
               (float32 products; TF32 is off, ``device.set_f32_numerics``);
  - 'pallas' : the same math in the fused CUDA distance+argmin / top-k
               kernels (``ops/knn_fused``; the name is the JAX package's);
  - 'exact'  : d = sum((q - s)^2) elementwise, the reference's order.
* Parts engines ('taps' and 'taps-int8'): the featuriser writes every
  part into one (N, K) buffer in part order (``make_fast_parts_norms``,
  the tap epilogue kernel), so the cross term sum_l q_l.s_l is the flat
  dot and the float32/bfloat16 fold runs the fused kernels on that buffer
  unchanged; the int8 argmin fold runs the int8 fold kernel
  (``ops/knn_int8``: every part's exact s8 x s8 -> s32 dot on the tensor
  cores, scaled by the part's static dequantisation factor, and the
  argmin, in one kernel) where every part width is a multiple of 32 and
  K of 16 (``knn_int8.kernel_route``), else one s8 x s8 -> s32 product
  per part (``torch._int_mm``); the int8 top-k fold takes one product per
  part.
* Every streamed search shares one loop (``_stream_search``): the query
  embeddings are cached on the device in chunks of ``query_cache_bytes``
  and the synthetic set is featurised once per chunk. On the card the
  device-memory planner (``ops/stream_plan``) first turns the request into
  the cheapest schedule that fits (one sweep where it can); a
  ``torch.cuda.OutOfMemoryError`` halves only the dimension that failed
  and the search resumes without recomputing finished blocks; and
  ``query_reuse`` carries a one-chunk query cache across calls over the
  same query set (the fbb hyperparameter sweep).
"""

from __future__ import annotations

import functools
import hashlib
import time
import traceback
from typing import Callable, NamedTuple

import numpy as np
import torch

from ganleaks_tpu_torch.ops import stream_plan
from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                              knn_topk_fused, sq_norms)
from ganleaks_tpu_torch.ops.knn_int8 import (_fold_block_parts_q,
                                             _int8_cross, argmin_fold,
                                             kernel_route)
from ganleaks_tpu_torch.ops.lpips.bias_relu import (TOWER_COUNTERS,
                                                   tower_counts)
from ganleaks_tpu_torch.ops.stream_plan import (FOLD_BYTES_PER_PAIR,
                                                activation_bytes_per_row,
                                                plan_bytes, plan_stream)
from ganleaks_tpu_torch.utils.profiling import span

# the streamed searches' engines (:func:`search_spec`); the last two read
# a parts featuriser
ENGINES = ("gemm", "exact", "pallas", "taps", "taps-int8")
PARTS_ENGINES = ("taps", "taps-int8")
# the fused kernels tile a synthetic block themselves: the streamed
# searches cap their blocks here, since a larger one buys nothing
FUSED_S_BLOCK = 2048


def fold_s_block(s_block: int, fused_fold: bool) -> int:
    """The synthetic block a streamed search folds at when asked for
    ``s_block``: at most :data:`FUSED_S_BLOCK` for a fused fold."""
    return min(s_block, FUSED_S_BLOCK) if fused_fold else s_block


def truncate_to_batches(n_syn: int, batch_size: int) -> int:
    """Reference remainder-drop: only ``(n_syn // B) * B`` synthetic samples
    participate (``fbb.py:77``)."""
    return (n_syn // batch_size) * batch_size


def pad_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad axis 0 to a multiple of ``block``."""
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x


def _fold_block(run_min: torch.Tensor, run_idx: torch.Tensor,
                emb_q: torch.Tensor, rq: torch.Tensor,
                emb_s_blk: torch.Tensor, col0: int, n_valid: int,
                engine: str, rs: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one (q_block x s_block) distance tile into the running
    (min, argmin): rows ``>= n_valid`` of the block are masked to +inf, the
    block's first minimal column wins, and strict ``<`` keeps earlier
    blocks on ties. ``rs``: precomputed f32 squared norms of the block."""
    if engine == "gemm":
        if rs is None:
            rs = sq_norms(emb_s_blk)
        cross = emb_q.float() @ emb_s_blk.float().T
        d = rq[:, None] + rs[None, :] - 2.0 * cross
    elif engine == "exact":
        diff = emb_q[:, None, :].float() - emb_s_blk[None, :, :].float()
        d = torch.sum(torch.square(diff), dim=-1)
    else:
        raise ValueError(f"unknown kNN engine {engine!r} "
                         "(the fold supports 'gemm'/'exact')")
    local = torch.arange(emb_s_blk.shape[0], device=d.device)
    d = torch.where(local[None, :] < n_valid, d, torch.inf)
    blk_min, blk_arg = torch.min(d, dim=1)
    better = blk_min < run_min
    return (torch.where(better, blk_min, run_min),
            torch.where(better, col0 + blk_arg.to(torch.int32), run_idx))


def knn_argmin(emb_q: torch.Tensor, emb_s: torch.Tensor, *,
               engine: str = "gemm", q_block: int = 4096,
               s_block: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN distances (float32) and first-min indices (int32) of every
    query row among materialised synthetic embeddings ('gemm', 'pallas'
    or 'exact')."""
    if engine not in ("gemm", "pallas", "exact"):
        raise ValueError(f"unknown kNN engine {engine!r}; the materialised "
                         f"search supports 'gemm', 'pallas' and 'exact'")
    if engine == "pallas":
        return knn_argmin_fused(emb_q.contiguous(), emb_s.contiguous())
    n_q, n_s = emb_q.shape[0], emb_s.shape[0]
    s_block = min(s_block, max(1, n_s))
    outs_d, outs_i = [], []
    for start in range(0, n_q, q_block):
        q = emb_q[start:start + q_block]
        rq = sq_norms(q)
        run_min = torch.full((q.shape[0],), torch.inf, device=q.device)
        run_idx = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
        for col0 in range(0, n_s, s_block):
            blk = emb_s[col0:col0 + s_block]
            run_min, run_idx = _fold_block(run_min, run_idx, q, rq, blk,
                                           col0, blk.shape[0], engine)
        outs_d.append(run_min)
        outs_i.append(run_idx)
    return torch.cat(outs_d), torch.cat(outs_i)


def knn_argmin_reference_batched(emb_q: torch.Tensor, emb_s: torch.Tensor,
                                 batch_size: int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Strict-parity variant of :func:`knn_argmin`: the reference's
    remainder drop (``fbb.py:77``, :func:`truncate_to_batches`), then the
    elementwise 'exact' engine in blocks of ``batch_size``."""
    n_eff = truncate_to_batches(emb_s.shape[0], batch_size)
    return knn_argmin(emb_q, emb_s[:n_eff], engine="exact",
                      s_block=min(batch_size, n_eff) or 1)


class PhaseTimer:
    """Seconds spent in named phases of work queued on the device: CUDA
    events around each phase (read once, at :meth:`seconds`, so timing
    never stalls the queue) or the host clock on the CPU, which runs
    synchronously. Each phase is also the program's span of its name
    (``utils/profiling.span``), so a trace shows every block."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: dict[str, list] = {}

    def start(self, name: str):
        rng = span(name)
        rng.__enter__()
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return name, ev, rng
        return name, time.perf_counter(), rng

    def stop(self, token) -> None:
        name, t0, rng = token
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.setdefault(name, []).append((t0, ev))
        else:
            self._marks.setdefault(name, []).append(time.perf_counter() - t0)
        rng.__exit__(None, None, None)

    def seconds(self) -> dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
            return {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
                    for k, v in self._marks.items()}
        return {k: float(sum(v)) for k, v in self._marks.items()}


def _as_device_block(x, start: int, block: int, device: torch.device
                     ) -> torch.Tensor:
    blk = x[start:start + block]
    if isinstance(blk, np.ndarray):
        blk = torch.from_numpy(np.ascontiguousarray(blk))
    return blk.to(device, non_blocking=True)


def _block_fn(emb_norms: Callable, device: torch.device,
              timer: PhaseTimer) -> Callable:
    """``block_norms(x, start, block) -> (emb, f32 norms, n_valid)``: ship
    ``x[start:start + block]`` to the device, zero-pad it to ``block`` rows
    and featurise it with ``emb_norms(blk) -> (emb, norms)``, timed as
    'featurize'."""
    def block_norms(x, start: int, block: int):
        tok = timer.start("featurize")
        blk = _as_device_block(x, start, block, device)
        n_valid = blk.shape[0]
        e, r = emb_norms(pad_rows(blk, block))
        timer.stop(tok)
        return e, r, n_valid
    return block_norms


def _alloc_cache(padded: int, k_dim: int, cdtype: torch.dtype,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A chunk's query cache (``padded`` x ``k_dim`` of ``cdtype``) and its
    float32 norms: the allocation an over-ambitious cache fails at."""
    return (torch.empty((padded, k_dim), dtype=cdtype, device=device),
            torch.empty(padded, dtype=torch.float32, device=device))


def _release(device: torch.device, holders) -> None:
    """Before a retry: drop the held reuse caches, then hand the caching
    allocator's free blocks back so the retry can take them whole."""
    for h in holders:
        if h:
            h.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class JoinedRows:
    """Row sets read as one, in order, without joining them: what the
    streamed search reads of its queries (``len``, ``shape``, ``dtype``,
    ``nbytes``, rows by slice or index array), each row read in place from
    the set that holds it, in the dtype ``np.concatenate`` would give."""

    def __init__(self, *sets: np.ndarray):
        self.sets = sets
        sizes = [len(s) for s in sets]
        self.starts = np.cumsum([0] + sizes[:-1])
        self.ends = self.starts + sizes
        self.dtype = np.result_type(*sets)
        self.shape = (sum(sizes),) + tuple(sets[0].shape[1:])
        self.nbytes = int(np.prod(self.shape)) * self.dtype.itemsize

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, rows) -> np.ndarray:
        if isinstance(rows, slice):
            lo, hi, step = rows.indices(len(self))
            if step != 1:
                raise IndexError("JoinedRows takes slices of step 1")
            pieces = [s[max(lo - a, 0):max(hi - a, 0)]
                      for s, a in zip(self.sets, self.starts)]
        else:
            rows = np.asarray(rows)
            which = np.searchsorted(self.ends, rows, side="right")
            pieces = [self.sets[w][r - self.starts[w]][None]
                      for w, r in zip(which, rows)]
        return np.concatenate(pieces, axis=0, dtype=self.dtype)


def _fingerprint(queries, signature: tuple) -> tuple:
    """The key a held query cache is reused under: n_q, the embedding's
    signature (part shapes and dtypes, cache dtype) and a hash of the
    first row, the last row and 64 rows strided over the set — a set with
    a swapped middle row, or a reversed one, does not match. A
    :class:`JoinedRows` gives the key its joined array gives."""
    n_q = len(queries)
    rows = sorted({0, n_q - 1, *range(0, n_q, max(1, n_q // 64))})
    sample = queries[np.asarray(rows)]
    if isinstance(sample, torch.Tensor):
        sample = sample.cpu().numpy()
    digest = hashlib.sha256(np.ascontiguousarray(sample).tobytes())
    return (n_q, signature, digest.hexdigest())


def holds_queries(query_reuse: dict | None, queries) -> bool:
    """Whether ``query_reuse`` holds a cache of ``queries``: their count
    and hash match its :func:`_fingerprint` (the search also checks the
    embedding's signature)."""
    fp = (query_reuse or {}).get("fp")
    return fp is not None and _fingerprint(queries, fp[1]) == fp


def _halved(info: dict, dim: str, size: int, msg: str) -> None:
    """Record one OOM resume: the dimension halved and the size it
    reached."""
    info["oom_resumes"] += 1
    info["halvings"].append({"dim": dim, "to": size})
    print(f"[knn] {msg}")


def chunk_rows_for(cache_bytes: int, row_bytes: int, q_block: int) -> int:
    """Query rows a cache of ``cache_bytes`` holds per chunk: rounded DOWN
    to a ``q_block`` multiple (at least one block), so full featurise
    blocks tile each chunk and padding only appears at n_q."""
    return max(q_block, int(cache_bytes // row_bytes) // q_block * q_block)


def _padded(n_rows: int, q_block: int) -> int:
    """Rows of the cache that holds a chunk of ``n_rows``: whole
    ``q_block`` s."""
    return n_rows + (-n_rows) % q_block


class SearchPlan(NamedTuple):
    """The schedule of a streamed search (:func:`plan_search`): the query
    cache requested, the blocks, the query rows per chunk, and what they
    give over ``n_q`` rows, the rows of the first (largest) chunk's cache
    and the synthetic sweeps."""

    cache_bytes: int
    s_block: int
    q_block: int
    chunk_rows: int
    cache_rows: int
    sweeps: int


def plan_search(n_q: int, n_s: int, row_bytes: int, *, q_block: int,
                s_block: int, cache_bytes: int, charges: dict,
                capacity: int | None = None) -> SearchPlan:
    """The schedule :func:`_stream_search` starts from for ``n_q`` query
    rows of ``row_bytes`` over ``n_s`` synthetic rows: the blocks clamped
    to the sets (a fused fold's synthetic block also by
    :func:`fold_s_block`); with a ``capacity`` (bytes), the planner's
    cache and blocks (``ops/stream_plan.plan_stream``, charged
    ``charges``, :func:`_plan_charges`); then the chunks. Without one the
    request stands."""
    q_block = max(1, min(q_block, n_q))
    s_block = max(1, min(fold_s_block(s_block, charges["fused_fold"]), n_s))
    if capacity is not None:
        cache_bytes, s_block, q_block = plan_stream(
            n_q, row_bytes, q_block=q_block, s_block=s_block,
            cache_bytes=cache_bytes, capacity_bytes=capacity, **charges)
    chunk = chunk_rows_for(cache_bytes, row_bytes, q_block)
    return SearchPlan(cache_bytes, s_block, q_block, chunk,
                      _padded(min(chunk, n_q), q_block), -(-n_q // chunk))


class SearchSpec(NamedTuple):
    """What a streamed search folds (:func:`_stream_search`), as
    :func:`search_spec` builds it for an engine:
    ``block_norms(x, start, block) -> (emb, f32 norms, n_valid)``; the
    cached row width ``k_dim`` and dtype ``cdtype``; the state hooks
    ``init_state(padded_rows)``, ``fold(state, cache, rq, s_emb, rs, col0,
    n_valid)`` (a new state; a fold that fails leaves the old one intact)
    and ``take(state, n_rows) -> tuple of per-query outputs``; the
    planner's ``charges`` (:func:`_plan_charges`); the signature a held
    query cache is reused under; ``counters``, the fold's own counts
    (:data:`FOLD_COUNTERS`, bumped as blocks are folded), which the search
    copies into its ``info``; and for the two-pass mode, the L2 bound on
    a row's int8 error (``abs_err``, :func:`_quant_abs_err`) and the
    float32 engine that searches the candidates exactly
    (``exact_engine``)."""

    block_norms: Callable
    k_dim: int
    cdtype: torch.dtype
    init_state: Callable
    fold: Callable
    take: Callable
    charges: dict
    signature: tuple
    counters: dict
    abs_err: float
    exact_engine: str

    @property
    def row_bytes(self) -> int:
        """Bytes of one cached query row."""
        return self.k_dim * torch.empty((), dtype=self.cdtype).element_size()


# blocks of an int8 argmin search folded by the int8 fold kernel (its
# plain version on the CPU) and by the per-part chain (widths off the
# kernel's steps): every search's ``info`` has both, 0 where unused
FOLD_COUNTERS = ("int8_fold_kernel_blocks", "int8_fold_parts_blocks")


class RankHooks(NamedTuple):
    """What one rank of a search spread over several adds to
    :func:`_stream_search` (``parallel/knn_shard`` builds them).

    ``least(n)``: the least int ``n`` over the ranks (a flag's: whether
    it holds on every rank); ``budget(capacity)``: the planner's budget
    agreed over the ranks; ``col_offset``: the global index of this rank's
    first synthetic row; ``sweep_rows``: the synthetic rows every rank
    walks (its shard, padded to the largest: past its own rows a rank's
    blocks hold none); ``gather``: with queries replicated, each query
    block is featurised a ``1/size`` share per rank, and ``gather(rows)``
    stages a share for the all-gather, allocating all it needs, and
    returns an object whose ``into(dst)`` makes the collective and copies
    every rank's rows, in rank order, into the cache (``len``: the rows);
    ``combine(state)``: the state merged over the ranks at each chunk's
    end; ``exchanges``: the fold exchanges blocks with the other ranks, so
    it is also called on blocks past this rank's rows (zeros, ``n_valid``
    0), agrees its own out-of-memory errors before each exchange (raising
    the same error on every rank) and times its own 'fold' spans."""

    rank: int
    size: int
    least: Callable[[int], int]
    budget: Callable
    col_offset: int = 0
    sweep_rows: int | None = None
    gather: Callable | None = None
    combine: Callable | None = None
    exchanges: bool = False


def _stream_search(spec: SearchSpec, queries, syn, *, q_block: int,
                   s_block: int, query_cache_bytes: int,
                   device: torch.device, timer: PhaseTimer,
                   auto_plan: bool = True,
                   query_reuse: dict | None = None,
                   reuse_siblings: tuple = (), info: dict | None = None,
                   ranks: RankHooks | None = None) -> tuple:
    """The loop of every streamed search (flat or parts, argmin or
    top-k): featurise the queries chunk by chunk into a (rows,
    ``spec.k_dim``) cache of ``spec.cdtype`` with float32 norms ``rq``,
    sweep the synthetic set once per chunk (``N_q + N_s * ceil(N_q /
    chunk_rows)`` forwards), and fold every block into a running state
    (``spec``'s hooks; the folds are timed as 'fold'). Blocks are
    zero-padded to their block size and the padded tail masked by its
    valid-row count; the per-query outputs are concatenated over the
    chunks.

    With ``auto_plan`` the planner sets ``query_cache_bytes``, ``s_block``
    and ``q_block`` first, from the budget the card reports
    (:func:`plan_search`, charged ``spec.charges``); without it, or off
    the card, they stay as given.

    OOM resume (``torch.cuda.OutOfMemoryError`` only; every other error
    propagates). The caching allocator raises at the allocation that does
    not fit, before any work of the failed block is queued, so a resume
    keeps everything finished:
    * the cache allocation fails: halve ``chunk_rows`` (more sweeps); at
      one ``q_block`` per chunk, halve ``q_block``;
    * a query block fails: halve ``q_block`` and go on at the same row,
      keeping the rows already in the cache; writes are capped at the
      cache's end, since a halved block need not divide the rest;
    * a synthetic block (its featurisation or its fold) fails: halve
      ``s_block`` and go on at the same row with the running state; below
      one row, halve ``chunk_rows`` and restart the chunk;
    * at the smallest block the error is raised again.
    Each retry first drops the held reuse caches (``query_reuse`` and
    ``reuse_siblings``) and empties the allocator's cache. The JAX
    package's guards against failures that surface later (poisoned
    outputs found at a sync point, a runtime that stays broken after an
    OOM, a window of undrained blocks) have no counterpart: on CUDA an OOM
    surfaces at allocation, and the one stream reuses freed blocks in
    order.

    ``ranks`` (:class:`RankHooks`): this search is one rank of several.
    Ranks that disagree on a block size call their collectives in another
    order and hang, so every rank plans from the budget agreed over them
    (``ranks.budget``), the reuse decision is agreed, and every step that
    can run out of memory and precedes a collective is agreed before it
    (``ranks.least``): the cache allocation, each query share together
    with its staging for the all-gather, and on a ring each synthetic
    block's featurisation (the fold agrees its hops itself). An OOM there
    on any rank makes every rank halve alike. A sharded sweep holds no
    collective until the chunk's merge, so there a rank halves
    ``s_block`` alone, and once per chunk, before the merge, the ranks
    agree how it ended: every rank takes the least
    ``s_block`` (recording the halvings that reach it), restarts the chunk
    where any rank must, or raises where any rank cannot go on. Only the
    merges themselves (a few bytes per query row) are not guarded.

    ``query_reuse`` (a dict the caller keeps): when every query row fits
    one chunk, the verified cache is held there under
    :func:`_fingerprint` (with ``spec.signature``), and a later call over
    the same queries skips their featurisation. The planner counts a held
    cache of the same queries as budget (it is allocated, so the card does
    not report it free); one held for other queries is freed first.

    ``info`` (a dict) receives ``oom_resumes``, ``halvings`` (dimension
    and size reached, in order), the final blocks, the largest cache it
    held (``cache_bytes``), the number of synthetic ``sweeps``,
    ``query_reused``, the query rows it featurised into its cache and
    those a held cache served (``query_rows_featurised``,
    ``query_rows_reused``), the blocks folded per int8 route
    (:data:`FOLD_COUNTERS`), the LPIPS tower's convolution outputs its
    featurisation ran through the tower's kernel pass and through the
    PyTorch ops (``ops/lpips/bias_relu.TOWER_COUNTERS``) and the planner's
    budget (``capacity_bytes``:
    what the card reported plus a held cache of these queries; None
    without the planner).

    Spans (``utils/profiling.span``): ``knn.plan`` (the fingerprint, the
    budget and the plan; the drivers open one more around building the
    spec), ``knn.query_cache`` (a chunk's query featurisation, or the
    reuse hit), and the timer's ``featurize`` and ``fold`` per block."""
    n_q, n_s = len(queries), len(syn)
    n_sweep = n_s if ranks is None or ranks.sweep_rows is None \
        else ranks.sweep_rows
    if n_sweep == 0:
        raise ValueError("empty synthetic set")
    block_norms, k_dim, cdtype = spec.block_norms, spec.k_dim, spec.cdtype
    info = {} if info is None else info
    info.update(oom_resumes=0, halvings=[], query_rows_featurised=0,
                query_rows_reused=0, **dict.fromkeys(FOLD_COUNTERS, 0))
    tower0 = dict(tower_counts)
    row_bytes = spec.row_bytes
    with span("knn.plan"):
        fp = (_fingerprint(queries, (spec.signature, str(cdtype), k_dim))
              if query_reuse is not None else None)
        if query_reuse and query_reuse.get("fp") != fp:
            query_reuse.clear()  # another set's cache: free it first
        capacity = stream_plan.device_capacity(device) if auto_plan \
            else None
        if capacity is not None and query_reuse:
            # a held cache of these queries is already allocated, so the
            # card no longer counts it as free: credit it back
            capacity += (query_reuse["cache"].nbytes
                         + query_reuse["rq"].nbytes)
        if ranks is not None:
            capacity = ranks.budget(capacity)
        info.update(capacity_bytes=capacity)
        query_cache_bytes, s_block, q_block, chunk_rows, _, _ = plan_search(
            n_q, n_sweep, row_bytes, q_block=q_block, s_block=s_block,
            cache_bytes=query_cache_bytes, charges=spec.charges,
            capacity=capacity)
    holders = (query_reuse,) + tuple(reuse_siblings)
    s_block0 = s_block
    col_offset = 0 if ranks is None else ranks.col_offset
    gather = None if ranks is None else ranks.gather
    exchanges = ranks is not None and ranks.exchanges

    def attempt(fn):
        """``(fn(), None)``, or ``(None, the OOM)`` when it ran out of
        memory."""
        try:
            return fn(), None
        except torch.cuda.OutOfMemoryError as e:
            # keep the error, not the failed attempt's tensors: its frames
            # would pin them through the retry
            traceback.clear_frames(e.__traceback__)
            return None, e

    def agreed(fn):
        """:func:`attempt`; on one rank of several, the OOM when any rank
        ran out of memory."""
        out, err = attempt(fn)
        if ranks is not None and not ranks.least(err is None) \
                and err is None:
            err = torch.cuda.OutOfMemoryError("another rank ran out of "
                                              "device memory")
        return out, err

    def query_share(qs: int, q_block: int):
        """This rank's featurised rows of the query block at ``qs``: the
        whole block, or its ``1/size`` share (zeros past the queries),
        staged for ``gather``."""
        if gather is None:
            return block_norms(queries, qs, q_block)[:2]
        per = -(-q_block // ranks.size)
        lo = qs + ranks.rank * per
        if lo >= n_q:
            share = (torch.zeros((per, k_dim), dtype=cdtype, device=device),
                     torch.zeros(per, device=device))
        else:
            share = block_norms(queries, lo, per)[:2]
        return tuple(gather(t) for t in share)

    def featurise(ss: int, s_block: int):
        """The synthetic block at ``ss``: ``(emb, norms, n_valid)``, zeros
        past this shard where the fold exchanges blocks, else None."""
        if ss < n_s:
            return block_norms(syn, ss, s_block)
        if exchanges:
            return (torch.zeros((s_block, k_dim), dtype=cdtype,
                                device=device),
                    torch.zeros(s_block, device=device), 0)
        return None

    def fold(state, cache, rq, blk, ss: int):
        if blk is None:
            return state
        s_emb, rs, n_valid = blk
        if exchanges:  # the fold times its own spans, not its exchanges
            return spec.fold(state, cache, rq, s_emb, rs, col_offset + ss,
                             n_valid)
        tok = timer.start("fold")
        state = spec.fold(state, cache, rq, s_emb, rs, col_offset + ss,
                          n_valid)
        timer.stop(tok)
        return state

    def sweep_step(state, cache, rq, ss: int, s_block: int):
        """One synthetic block folded: ``(state, None)`` or ``(None, the
        OOM)``. Where the fold exchanges blocks, the featurisation is
        agreed before the fold's first exchange; the fold agrees its own
        errors."""
        if not exchanges:
            return attempt(lambda: fold(state, cache, rq,
                                        featurise(ss, s_block), ss))
        blk, err = agreed(lambda: featurise(ss, s_block))
        if err is not None:
            return None, err
        return attempt(lambda: fold(state, cache, rq, blk, ss))

    def shrink_chunk() -> int:
        return max(q_block, (chunk_rows // 2) // q_block * q_block)

    outs, sweeps, cache_rows = [], 0, 0
    qs0 = 0
    with torch.inference_mode():
        while qs0 < n_q:
            end = min(n_q, qs0 + chunk_rows)
            n_rows = end - qs0
            padded = _padded(n_rows, q_block)
            one_chunk = qs0 == 0 and end == n_q
            reused = (query_reuse is not None and one_chunk
                      and query_reuse.get("fp") == fp)
            if ranks is not None:  # every rank reuses, or none does
                reused = bool(ranks.least(reused))
            if query_reuse and not one_chunk:
                # a held cache never engages on a multi-chunk schedule:
                # drop it instead of pinning it through the search
                query_reuse.clear()
            if reused:
                with span("knn.query_cache"):  # the hit
                    padded = query_reuse["padded"]
                    cache, rq = query_reuse["cache"], query_reuse["rq"]
                info["query_rows_reused"] += n_rows
            else:
                got, err = agreed(lambda: _alloc_cache(padded, k_dim, cdtype,
                                                       device))
                if err is not None:
                    if chunk_rows > q_block:
                        chunk_rows = shrink_chunk()
                        dim, size = "chunk_rows", chunk_rows
                    elif q_block > 1:
                        # one q_block of rows itself does not fit
                        q_block = chunk_rows = q_block // 2
                        dim, size = "q_block", q_block
                    else:
                        raise err
                    _release(device, holders)
                    _halved(info, dim, size, f"query cache allocation OOM; "
                            f"{dim}={size} (more synthetic sweeps)")
                    continue
                cache, rq = got
                with span("knn.query_cache"):
                    qs = qs0
                    while qs < end:
                        got, err = agreed(lambda: query_share(qs, q_block))
                        if err is not None:
                            if q_block <= 1:
                                raise err
                            q_block //= 2
                            _release(device, holders)
                            _halved(info, "q_block", q_block,
                                    f"query featurize OOM; q_block={q_block} "
                                    f"(resuming at row {qs})")
                            continue
                        e, r = got
                        at = qs - qs0
                        n = min(len(e), padded - at)
                        if gather is None:
                            cache[at:at + n] = e[:n]
                            rq[at:at + n] = r[:n]
                        else:  # the collective, into the cache: no allocation
                            e.into(cache[at:at + n])
                            r.into(rq[at:at + n])
                        qs += n
                        del got, e, r
                info["query_rows_featurised"] += n_rows
                if query_reuse is not None and one_chunk:
                    query_reuse.clear()
                    query_reuse.update(fp=fp, padded=padded, cache=cache,
                                       rq=rq)
            cache_rows = max(cache_rows, padded)
            state = spec.init_state(padded)
            ss, restart, fatal = 0, False, None
            while ss < n_sweep:
                step = min(s_block, n_sweep - ss)
                new, err = sweep_step(state, cache, rq, ss, s_block)
                if err is None:
                    state = new
                    ss += step
                    continue
                new = None
                if s_block > 1:
                    s_block //= 2
                    _release(device, reuse_siblings)
                    _halved(info, "s_block", s_block,
                            f"synthetic stream OOM; s_block={s_block} "
                            f"(resuming at row {ss})")
                    continue
                # even one row does not fit next to the cache: the
                # pressure is the resident cache, so shrink it and
                # redo this chunk (a chunk of one q_block cannot
                # shrink further)
                if chunk_rows <= q_block or padded <= q_block:
                    fatal = err
                else:
                    restart = True
                break
            if ranks is not None:
                # how the chunk ended, agreed before the merge: -1 fatal,
                # 0 restart, else the s_block every rank goes on with
                least = ranks.least(-1 if fatal is not None
                                    else 0 if restart else s_block)
                if least < 0 and fatal is None:
                    fatal = torch.cuda.OutOfMemoryError(
                        "another rank ran out of device memory at one "
                        "synthetic row")
                restart = least == 0
                while least > 0 and s_block > least:
                    s_block //= 2
                    _halved(info, "s_block", s_block,
                            f"another rank's synthetic stream OOM; "
                            f"s_block={s_block} (from the next chunk)")
            if fatal is not None:
                raise fatal
            if restart:
                chunk_rows = shrink_chunk()
                s_block = s_block0
                del cache, rq, state
                _release(device, holders)
                _halved(info, "chunk_rows", chunk_rows,
                        f"synthetic stream OOM at s_block=1; "
                        f"chunk_rows={chunk_rows} (restarting the chunk)")
                continue
            sweeps += 1
            if ranks is not None and ranks.combine is not None:
                state = ranks.combine(state)
            outs.append(spec.take(state, n_rows))
            del cache, rq, state
            qs0 = end
    info.update(q_block=q_block, s_block=s_block,
                cache_bytes=cache_rows * row_bytes, sweeps=sweeps,
                query_reused=info["query_rows_reused"] > 0, **spec.counters,
                **{k: tower_counts[k] - tower0[k] for k in TOWER_COUNTERS})
    return tuple(torch.cat(cols) for cols in zip(*outs))


def _plan_charges(embed_fn: Callable, queries, fold_kind: str,
                  state_bytes_per_row: int) -> dict:
    """The planner's charges for a search of ``queries`` through
    ``embed_fn`` (its ``tower`` key; image rows NHWC) folded by
    ``fold_kind`` (``stream_plan.FOLD_BYTES_PER_PAIR``; the fused kinds
    are also charged K1 / K3's padded copies where rows pad)."""
    shape = tuple(queries.shape[1:])
    if len(shape) == 3:
        act = activation_bytes_per_row(getattr(embed_fn, "tower", None),
                                       shape)
    else:  # rows (tabular): the embedding in float32, twice
        act = int(np.prod(shape)) * 4 * 2
    return {"act_bytes_per_row": act,
            "fold_bytes_per_pair": FOLD_BYTES_PER_PAIR[fold_kind],
            "state_bytes_per_row": state_bytes_per_row,
            "fused_fold": fold_kind in ("fused", "topk_fused")}


def stream_need_bytes(embed_fn: Callable, queries, *, engine: str,
                      q_block: int, s_block: int, query_cache_bytes: int,
                      auto_plan: bool, device: torch.device) -> int:
    """Device bytes the streamed 1-NN search of ``queries`` through
    ``embed_fn`` on ``engine`` plans beside its image sets, as the planner
    charges them: every query row cached (one sweep), or the requested
    cache with ``auto_plan=False``, plus the stream's blocks and
    activations and, for the fused folds on rows that are not 16-byte
    multiples, K1's padded copies. The row width, cache dtype and charges
    are the search's own (:func:`search_spec`, which featurises one
    query)."""
    spec = search_spec(embed_fn, queries, engine, device,
                       PhaseTimer(torch.device(device)))
    n_q = len(queries)
    q_block = max(1, min(q_block, n_q))
    rows = n_q + (-n_q) % q_block
    if not auto_plan:
        rows = min(rows, max(q_block, query_cache_bytes // spec.row_bytes))
    return plan_bytes(rows, spec.row_bytes, s_block=s_block,
                      q_block=q_block, **spec.charges)


def _probe(embed_fn: Callable, queries, device: torch.device):
    """``embed_fn`` on the first query image (shapes and dtypes)."""
    with torch.inference_mode():
        return embed_fn(_as_device_block(queries, 0, 1, device))


def _flat_block_fn(embed_fn: Callable, device: torch.device,
                   timer: PhaseTimer) -> Callable:
    """Flat featurisation: the embedding as it comes (no demotion), with
    float32 norms taken from it before the cache write."""
    def emb_norms(blk):
        e = embed_fn(blk)
        return e, sq_norms(e)
    return _block_fn(emb_norms, device, timer)


def _argmin_state_hooks(device: torch.device):
    """init/take hooks of a running (min, argmin) per query."""
    def init_state(padded: int):
        return (torch.full((padded,), torch.inf, device=device),
                torch.zeros(padded, dtype=torch.int32, device=device))

    def take(state, n_rows: int):
        return state[0][:n_rows], state[1][:n_rows]

    return init_state, take


def _fold_fused(state, cache, rq, s_emb, rs, ss, n_valid):
    """Argmin fold through the fused distance+argmin kernel (the kernel
    masks by row count); strict ``<`` across blocks keeps the first
    index. Also the float32/bfloat16 parts fold: the parts sit in one
    (N, K) buffer in part order, so sum_l q_l.s_l is the flat dot."""
    run_min, run_idx = state
    d_blk, i_blk = knn_argmin_fused(cache, s_emb[:n_valid], rq=rq,
                                    rs=rs[:n_valid])
    better = d_blk < run_min
    return (torch.where(better, d_blk, run_min),
            torch.where(better, ss + i_blk, run_idx))


# ---------------------------------------------------------------------------
# top-k
# ---------------------------------------------------------------------------

def _merge_topk(run_d: torch.Tensor, run_i: torch.Tensor,
                blk_d: torch.Tensor, blk_i: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a block's candidates into the running top-k: a stable sort
    with the running entries (earlier global indices) first, so the
    first-index tie-break holds."""
    cat_d = torch.cat([run_d, blk_d], dim=1)
    cat_i = torch.cat([run_i, blk_i], dim=1)
    d_sorted, pos = torch.sort(cat_d, dim=1, stable=True)
    return d_sorted[:, :k], torch.gather(cat_i, 1, pos[:, :k])


def _masked_topk_merge(run_d, run_i, d, col0: int, n_valid: int, k: int):
    """Mask columns ``>= n_valid`` of a block's distances to +inf and merge
    them (global index ``col0 + column``) into the running top-k. Running
    lists start as (+inf, -1), so when fewer than k rows exist the
    trailing entries stay (+inf, -1)."""
    local = torch.arange(d.shape[1], device=d.device)
    d = torch.where(local[None, :] < n_valid, d, torch.inf)
    ids = (col0 + local).to(torch.int32).expand(d.shape[0], -1)
    return _merge_topk(run_d, run_i, d, ids, k)


def _fold_block_topk(run_d: torch.Tensor, run_i: torch.Tensor,
                     emb_q: torch.Tensor, rq: torch.Tensor,
                     emb_s_blk: torch.Tensor, col0: int, n_valid: int,
                     k: int, engine: str, rs: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one distance tile into a running per-query top-k (N_q, k),
    distance-ascending with the first-index tie-break: the stable merge
    keeps running entries before the block's columns, and column ids
    ascend, so among equal distances the earliest global index stays in
    front (``torch.min`` when the top-1 is read off)."""
    if engine == "gemm":
        if rs is None:
            rs = sq_norms(emb_s_blk)
        d = rq[:, None] + rs[None, :] - 2.0 * (emb_q.float()
                                               @ emb_s_blk.float().T)
    elif engine == "exact":
        diff = emb_q[:, None, :].float() - emb_s_blk[None, :, :].float()
        d = torch.sum(torch.square(diff), dim=-1)
    else:
        raise ValueError(f"unknown kNN engine {engine!r} "
                         "(the top-k fold supports 'gemm'/'exact')")
    return _masked_topk_merge(run_d, run_i, d, col0, n_valid, k)


def _fold_fused_topk(run_d, run_i, cache, rq, s_emb, rs, ss, n_valid, k):
    """Top-k fold through the fused distance+top-k kernel, whose (+inf, -1)
    fill keeps its index -1; on the parts buffer, the float32/bfloat16
    parts top-k fold."""
    blk_d, blk_i = knn_topk_fused(cache, s_emb[:n_valid], k, rq=rq,
                                  rs=rs[:n_valid])
    blk_i = torch.where(blk_i >= 0, blk_i + ss, blk_i)
    return _merge_topk(run_d, run_i, blk_d, blk_i, k)


def _topk_state_hooks(fold_one: Callable, k: int, with_info: bool,
                      device: torch.device):
    """init/fold/take hooks for the streamed top-k searches. With
    ``with_info`` the state also carries the per-query float32 norms
    (``rq``) and the running largest synthetic norm (``rs_max``, over
    whole blocks, padded rows included: an over-estimate is sound) — the
    inputs of the two-pass certificate (:func:`two_pass_certificate`)."""
    def init_state(padded: int):
        base = (torch.full((padded, k), torch.inf, device=device),
                torch.full((padded, k), -1, dtype=torch.int32,
                           device=device))
        if with_info:
            base += (torch.zeros(padded, device=device),
                     torch.zeros((), device=device))
        return base

    def fold(state, cache, rq, s_emb, rs, ss, n_valid):
        d, i = fold_one(state[0], state[1], cache, rq, s_emb, rs, ss,
                        n_valid)
        if with_info:
            return d, i, rq, torch.maximum(state[3], torch.max(rs))
        return d, i

    def take(state, n_rows: int):
        out = (state[0][:n_rows], state[1][:n_rows])
        if with_info:
            out += (state[2][:n_rows], state[3][None])
        return out

    return init_state, fold, take


# ---------------------------------------------------------------------------
# tap-structured parts ('taps', 'taps-int8')
# ---------------------------------------------------------------------------

def _fused_parts_norms(embed_fn: Callable, cdtype: torch.dtype,
                       bounds: tuple | None = None) -> Callable:
    """``blk -> (flat (N, K), f32 row norms, part widths)``: every part of
    ``embed_fn`` flattened into one buffer in part order — cast to
    ``cdtype``, or int8-quantised at the static per-part ``bounds`` — with
    the row norms summed part by part from the parts as embedded (before
    the cast or the int8 step). A featuriser that offers
    ``make_fast_parts_norms`` (the LPIPS parts: taps through the tap
    epilogue kernel) writes the buffer itself; otherwise the parts are
    flattened and concatenated here."""
    from ganleaks_tpu_torch.ops.distance import quantize_int8

    maker = getattr(embed_fn, "make_fast_parts_norms", None)
    if maker is not None:
        return maker(cdtype, bounds)

    def parts_norms(blk):
        parts = embed_fn(blk)
        qbs = bounds if bounds is not None else (None,) * len(parts)
        r, cols = None, []
        for p, qb in zip(parts, qbs):
            pr = torch.sum(torch.square(p.float()),
                           dim=tuple(range(1, p.dim())))
            r = pr if r is None else r + pr
            flat = p.reshape(p.shape[0], -1)
            cols.append(quantize_int8(flat, qb) if qb is not None
                        else flat.to(cdtype))
        return (torch.cat(cols, dim=1), r,
                tuple(c.shape[1] for c in cols))
    return parts_norms


def _quant_factors(bounds: tuple) -> tuple:
    """Per-part dequantisation factors of the int8 cross term."""
    return tuple((a / 127.0) ** 2 for a in bounds)


def _quant_abs_err(bounds: tuple, part_shapes) -> float:
    """Rigorous L2 bound on the per-row embedding error of round-to-nearest
    int8 quantisation: err/element <= a_l/254, so
    ||delta phi|| <= sqrt(sum_l K_l (a_l/254)^2). The two-pass
    certificate's absolute-error term."""
    total = 0.0
    for a, shp in zip(bounds, part_shapes):
        k = 1
        for dim in shp:
            k *= dim
        total += k * (a / 254.0) ** 2
    return float(np.sqrt(total))


def _part_bounds_for(embed_fn: Callable, queries,
                     device: torch.device | str = "cpu") -> tuple:
    """Static quantisation scales of ``embed_fn``'s parts, plus the
    int32-accumulator check: no part's s8 x s8 -> s32 dot may be able to
    overflow (e.g. the pixel part at >= 256x256 images could reach
    127^2 * H*W*C > 2^31 — a silent wrap, not an error). ``queries``: the
    query images (axis 0 = samples); a featuriser without
    ``part_int_dot_bound_fn`` is probed on the first one, on ``device``."""
    if not hasattr(embed_fn, "part_bound_fn"):
        raise ValueError(
            "engine 'taps-int8' needs embed_fn.part_bound_fn (per-part "
            "elementwise magnitude bounds; see "
            "ops/distance.make_embed_parts_fn)")
    shape = tuple(queries.shape[1:])
    bounds = tuple(embed_fn.part_bound_fn(shape))
    if hasattr(embed_fn, "part_int_dot_bound_fn"):
        dot_bounds = embed_fn.part_int_dot_bound_fn(shape)
    else:  # generic worst case: every element saturates
        probe = _probe(embed_fn, queries, torch.device(device))
        dot_bounds = [float(p[0].numel()) * 127.5 ** 2 for p in probe]
    check_int_dot_bounds(dot_bounds, shape)
    return bounds


def check_int_dot_bounds(dot_bounds, shape: tuple) -> None:
    """Raise ``ValueError`` where a part's s8 x s8 -> s32 cross dot can
    reach 2^31 (``dot_bounds``, one per part, at the input ``shape``): the
    int32 accumulator would wrap silently. ``attack/fbb.
    resolve_auto_engine`` asks the same from the shapes alone."""
    for i, db in enumerate(dot_bounds):
        if db >= 2.0 ** 31:
            raise ValueError(
                f"int8 engine disabled: part {i}'s cross dot can reach "
                f"{db:.3g} >= 2^31 and would silently wrap the int32 "
                f"accumulator at this input shape {shape}; use "
                f"engine='taps' (bf16) instead")


def _fold_block_topk_parts_q(run_d, run_i, q, rq, s, rs, col0: int,
                             n_valid: int, k: int, widths: tuple,
                             factors: tuple):
    """Top-k analog of :func:`_fold_block_parts_q` (the stable merge of
    :func:`_fold_block_topk`)."""
    d = rq[:, None] + rs[None, :] - 2.0 * _int8_cross(q, s, widths, factors)
    return _masked_topk_merge(run_d, run_i, d, col0, n_valid, k)


def _parts_setup(embed_fn: Callable, queries, bounds: tuple | None,
                 device: torch.device, timer: PhaseTimer):
    """(block_norms, K, cache dtype, widths, the query-reuse signature) of
    a parts featuriser; the cache dtype is the parts' own, int8 where
    quantised at ``bounds``."""
    probe = _probe(embed_fn, queries, device)
    widths = tuple(int(p[0].numel()) for p in probe)
    cdtype = torch.int8 if bounds is not None else probe[0].dtype
    parts_norms = _fused_parts_norms(embed_fn, cdtype, bounds)
    block_norms = _block_fn(lambda blk: parts_norms(blk)[:2], device, timer)
    signature = ("parts", widths, str(probe[0].dtype), bounds)
    return block_norms, sum(widths), cdtype, widths, signature


def _counted_int8_fold(widths: tuple, k_dim: int, factors: tuple,
                       counters: dict) -> Callable:
    """The int8 argmin fold of these part widths
    (``knn_int8.argmin_fold``: the int8 fold kernel where the widths take
    its route, else the per-part chain), counting its blocks under its
    route's :data:`FOLD_COUNTERS` key."""
    fold_q = argmin_fold(widths, k_dim)
    key = FOLD_COUNTERS[0] if kernel_route(widths, k_dim) \
        else FOLD_COUNTERS[1]

    def fold(state, cache, rq, s_emb, rs, ss, n_valid):
        out = fold_q(state[0], state[1], cache, rq, s_emb, rs, ss, n_valid,
                     widths, factors)
        counters[key] += 1
        return out
    return fold


# ---------------------------------------------------------------------------
# the search of an engine
# ---------------------------------------------------------------------------

def check_engine(engine: str) -> None:
    """The one refusal of an engine that is not one of :data:`ENGINES`,
    for every streamed search, on one device or on a mesh."""
    if engine not in ENGINES:
        raise ValueError(f"unknown kNN engine {engine!r}; expected one of "
                         f"{ENGINES}")


def search_spec(embed_fn: Callable, queries, engine: str,
                device: torch.device | str, timer: PhaseTimer, *,
                k: int | None = None, with_info: bool = False
                ) -> SearchSpec:
    """The :class:`SearchSpec` of the streamed search of ``queries``
    through ``embed_fn`` on ``engine``: the 1-NN search (``k`` None) or
    the top-``k`` one (``with_info`` appends ``(rq, rs_max)`` for the
    two-pass certificate). The only code that turns an engine into a
    search:

    * 'gemm', 'exact': the flat embedding cached as it comes (no
      demotion), folded by ``torch.matmul`` or elementwise
      (:func:`_fold_block`, :func:`_fold_block_topk`);
    * 'pallas': the same cache, folded by the fused kernels K1 / K3
      (:func:`_fold_fused`, :func:`_fold_fused_topk`);
    * 'taps': the parts featuriser's parts in one (N, K) buffer of their
      own dtype (:func:`_fused_parts_norms`), folded by K1 / K3;
    * 'taps-int8': the parts int8-quantised at static per-part scales
      (:func:`_part_bounds_for`, float32 norms from the unquantised
      parts), the argmin folded by ``knn_int8.argmin_fold`` (the int8
      fold kernel where every part width is a multiple of 32 and K of 16,
      else one int8 product per part; the same bits either way, counted
      per route in :data:`FOLD_COUNTERS`), the top-k by one int8 product
      per part (:func:`_fold_block_topk_parts_q`). Its scores are
      approximate with a rigorously bounded error (``abs_err``); exact
      results take :func:`knn_argmin_two_pass`.

    The planner is charged the fold's kind (``int8``, ``fused`` or
    ``gemm``, ``topk_`` before it for top-k), 8 bytes of state a query
    row (top-k: ``8 k + 4``) and, for K1 / K3, their padded copies
    (:func:`_plan_charges`). One query is featurised to learn the widths
    and dtype. An unknown engine raises :func:`check_engine`'s error."""
    check_engine(engine)
    device = torch.device(device)
    quantized = engine == "taps-int8"
    fused = engine in ("pallas", "taps")
    bounds = _part_bounds_for(embed_fn, queries, device) if quantized \
        else None
    if engine in PARTS_ENGINES:
        block_norms, k_dim, cdtype, widths, signature = _parts_setup(
            embed_fn, queries, bounds, device, timer)
    else:
        probe = _probe(embed_fn, queries, device)
        block_norms = _flat_block_fn(embed_fn, device, timer)
        k_dim, cdtype, signature = probe.shape[1], probe.dtype, ("flat",)
    factors = _quant_factors(bounds) if quantized else None
    kind = "int8" if quantized else "fused" if fused else "gemm"
    counters = dict.fromkeys(FOLD_COUNTERS, 0)
    if k is None:
        init_state, take = _argmin_state_hooks(device)
        if quantized:
            fold = _counted_int8_fold(widths, k_dim, factors, counters)
        elif fused:
            fold = _fold_fused
        else:
            def fold(state, cache, rq, s_emb, rs, ss, n_valid):
                return _fold_block(state[0], state[1], cache, rq, s_emb, ss,
                                   n_valid, engine, rs)
        state_bytes = 8
    else:
        if quantized:
            def fold_one(run_d, run_i, cache, rq, s_emb, rs, ss, n_valid):
                return _fold_block_topk_parts_q(run_d, run_i, cache, rq,
                                                s_emb, rs, ss, n_valid, k,
                                                widths, factors)
        elif fused:
            def fold_one(run_d, run_i, cache, rq, s_emb, rs, ss, n_valid):
                return _fold_fused_topk(run_d, run_i, cache, rq, s_emb, rs,
                                        ss, n_valid, k)
        else:
            def fold_one(run_d, run_i, cache, rq, s_emb, rs, ss, n_valid):
                return _fold_block_topk(run_d, run_i, cache, rq, s_emb, ss,
                                        n_valid, k, engine, rs)
        init_state, fold, take = _topk_state_hooks(fold_one, k, with_info,
                                                   device)
        kind, state_bytes = "topk_" + kind, 8 * k + 4
    abs_err = _quant_abs_err(bounds, [(w,) for w in widths]) \
        if quantized else 0.0
    return SearchSpec(block_norms, k_dim, cdtype, init_state, fold, take,
                      _plan_charges(embed_fn, queries, kind, state_bytes),
                      signature, counters, abs_err,
                      "exact" if engine == "exact" else "pallas")


def knn_argmin_streamed(embed_fn: Callable, queries, syn, *,
                        engine: str = "gemm", q_block: int = 2048,
                        s_block: int = 2048,
                        query_cache_bytes: int = 8 << 30,
                        device: torch.device | str = "cpu",
                        timer: PhaseTimer | None = None,
                        auto_plan: bool = True,
                        query_reuse: dict | None = None,
                        reuse_siblings: tuple = (),
                        info: dict | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN where embeddings are produced block by block — for feature
    spaces too large to materialise (LPIPS at 64x64 is 512,000 dims per
    image) — on any of :data:`ENGINES` (:func:`search_spec`; 'taps' and
    'taps-int8' take a parts featuriser, ``ops/distance.
    make_embed_parts_fn``).

    ``queries``/``syn``: image arrays (numpy, or torch on the host or on
    ``device``, axis 0 = samples), taken onto ``device`` one block at a
    time (``_stream_search``, which also documents ``auto_plan``'s
    planner, the OOM resume, ``query_reuse`` and ``info``). Query norms
    are float32, taken from the embedding before the cache write."""
    check_engine(engine)
    device = torch.device(device)
    if len(syn) == 0:
        raise ValueError("empty synthetic set")
    timer = timer or PhaseTimer(device)
    with span("knn.plan"):
        spec = search_spec(embed_fn, queries, engine, device, timer)
    return _stream_search(
        spec, queries, syn, q_block=q_block, s_block=s_block,
        query_cache_bytes=query_cache_bytes, device=device, timer=timer,
        auto_plan=auto_plan, query_reuse=query_reuse,
        reuse_siblings=reuse_siblings, info=info)


def knn_topk_streamed(embed_fn: Callable, queries, syn, *, k: int = 8,
                      engine: str = "gemm", q_block: int = 2048,
                      s_block: int = 2048,
                      query_cache_bytes: int = 8 << 30,
                      with_info: bool = False,
                      device: torch.device | str = "cpu",
                      timer: PhaseTimer | None = None,
                      auto_plan: bool = True,
                      query_reuse: dict | None = None,
                      reuse_siblings: tuple = (),
                      info: dict | None = None) -> tuple:
    """Per-query k smallest distances (float32 (N_q, k)) and their indices
    (int32, -1 past N_s), streamed like :func:`knn_argmin_streamed` on any
    of :data:`ENGINES`: pass 1 of the two-pass mode. ``with_info`` appends
    ``(rq, rs_max)`` for the two-pass certificate."""
    check_engine(engine)
    device = torch.device(device)
    if len(syn) == 0:
        raise ValueError("empty synthetic set")
    timer = timer or PhaseTimer(device)
    with span("knn.plan"):
        spec = search_spec(embed_fn, queries, engine, device, timer, k=k,
                           with_info=with_info)
    return _stream_search(
        spec, queries, syn, q_block=q_block, s_block=s_block,
        query_cache_bytes=query_cache_bytes, device=device, timer=timer,
        auto_plan=auto_plan, query_reuse=query_reuse,
        reuse_siblings=reuse_siblings, info=info)


# ---------------------------------------------------------------------------
# certified two-pass
# ---------------------------------------------------------------------------

def two_pass_certificate(d_exact: np.ndarray, topk_d: np.ndarray,
                         rq: np.ndarray, rs_max: float,
                         eta: float, abs_err: float = 0.0) -> np.ndarray:
    """Per-query certificate that the two-pass result equals the full
    exact search (True = certified).

    Model: the pass-1 embedding of any row x differs from the exact one by
    at most ``eta * ||phi(x)|| + abs_err`` in L2 (relative term: bf16 tower
    and stream; absolute term: int8 quantisation, rigorously bounded by
    :func:`_quant_abs_err`). With S := ||phi(q)|| + max_s ||phi(s)|| and
    A := eta*S + 2*abs_err, every (q, s) pair has

        |d_lo(q, s) - d(q, s)| <= eps_q := A * (2*S + A),

    so any synthetic row OUTSIDE the candidate union (approximate distance
    >= the query's k-th kept one, ``topk_max``) has true distance
    >= topk_max - eps_q. The re-ranked winner is certified exact —
    first-index tie-break included — iff its exact distance is STRICTLY
    below that bound. ``topk_max = inf`` (fewer than k rows: every row was
    a candidate) certifies trivially. ``eta`` is the one modelling
    assumption: a too-large eta only costs fallback work, a too-small one
    would certify what the model cannot guarantee."""
    rq = np.maximum(np.asarray(rq, np.float64), 0.0)
    topk_max = np.asarray(topk_d, np.float64)[:, -1]
    s = np.sqrt(rq) + np.sqrt(max(float(rs_max), 0.0))
    a = eta * s + 2.0 * abs_err
    eps = a * (2.0 * s + a)
    return ~np.isfinite(topk_max) | (np.asarray(d_exact, np.float64)
                                     < topk_max - eps)


def _default_cert_eta(demoted: bool) -> float:
    """2e-2 when pass 1 ran in reduced precision (bf16 tower error ~2e-3
    measured by the JAX package, 10x margin; on an H100, chip_smoke.py's
    north-star phase measures the port's at ~2.5e-3); 1e-6 when it was
    float32 throughout (accumulation-order noise)."""
    return 2e-2 if demoted else 1e-6


def _rerank_candidates(embed_hi: Callable, queries, syn, cand: np.ndarray,
                       *, engine: str, q_block: int, s_block: int,
                       query_cache_bytes: int, device: torch.device,
                       timer: PhaseTimer, **search
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank restricted to the candidate union: the float32
    ``embed_hi`` search on ``engine``, pass 1's ``exact_engine``
    (:func:`search_spec`): the fused distance+argmin kernel ('pallas';
    its two-level float32 sum stays within ~4e-6 of float64 at
    K = 512,000 where cuBLAS's SGEMM drifts to ~1.3e-4, ROADMAP C), or the
    elementwise 'exact' engine when that was asked for. Only the few
    candidate rows ship (a gather); blocks and cache shrink, since
    everything here is float32. ``search``: the streamed search's
    ``auto_plan``, reuse and ``info`` arguments; ``info`` also receives
    the size of the union, ``candidates``."""
    sub = syn[np.asarray(cand)]
    d, i_sub = knn_argmin_streamed(
        embed_hi, queries, sub, engine=engine, q_block=min(q_block, 1024),
        s_block=min(s_block, 1024, max(8, len(cand))),
        query_cache_bytes=min(query_cache_bytes, 2 << 30), device=device,
        timer=timer, **search)
    if search.get("info") is not None:
        search["info"]["candidates"] = len(cand)
    cand_t = torch.as_tensor(np.asarray(cand), dtype=torch.int32,
                             device=i_sub.device)
    return d, cand_t[i_sub.long()]


def knn_argmin_two_pass(embed_lo: Callable, embed_hi: Callable, queries,
                        syn, *, k: int = 8, engine: str = "gemm",
                        q_block: int = 2048, s_block: int = 2048,
                        query_cache_bytes: int = 8 << 30,
                        cert_eta: float | None = None,
                        return_cert: bool = False,
                        device: torch.device | str = "cpu",
                        timer: PhaseTimer | None = None,
                        auto_plan: bool = True,
                        query_reuse: dict | None = None,
                        rerank_reuse: dict | None = None,
                        info: dict | None = None,
                        topk_search: Callable | None = None,
                        argmin_search: Callable | None = None):
    """Throughput mode with exact-index re-ranking and a runtime exactness
    certificate.

    Pass 1 finds each query's top-``k`` candidates under the cheap
    embedding ``embed_lo`` (flat for 'gemm'/'pallas'/'exact'; parts for
    'taps' and, int8-quantised, 'taps-int8'); pass 2 re-runs the exact
    float32 search (``embed_hi``) over the UNION of the candidates
    (:func:`_rerank_candidates`). :func:`two_pass_certificate` checks per
    query from pass-1 norms that its true nearest row was in the union;
    uncertified queries are re-searched against the FULL synthetic set in
    float32 (printing how many). ``return_cert=True`` appends
    (certified mask, number of fallbacks).

    ``query_reuse`` / ``rerank_reuse`` hold pass 1's and the re-rank's
    query caches across calls (``_stream_search``); an OOM recovery in
    either search drops both, since the other one pins device memory the
    recovery needs. ``info`` receives each search's record (``pass1``,
    ``rerank``, ``fallback``) and their summed ``oom_resumes``. Its spans:
    ``knn.plan`` (pass 1's spec: the probe and the int8 error bound),
    ``knn.topk`` (pass
    1), ``knn.rerank`` (the union and its search), ``knn.certificate`` and
    ``knn.fallback``.

    ``topk_search`` / ``argmin_search``: pass 1's and the fallback's
    searches, ``(embed, queries, syn, **search arguments)``; by default
    this device's streamed ones (``parallel/knn_shard`` passes the
    sharded ones)."""
    device = torch.device(device)
    timer = timer or PhaseTimer(device)
    topk_search = topk_search or functools.partial(knn_topk_streamed,
                                                   device=device)
    argmin_search = argmin_search or functools.partial(knn_argmin_streamed,
                                                       device=device)
    with span("knn.plan"):
        spec = search_spec(embed_lo, queries, engine, device, timer, k=k)
    infos = {"pass1": {}, "rerank": {}}
    with span("knn.topk"):
        topk_d, top_i, rq, rs_max = topk_search(
            embed_lo, queries, syn, k=k, engine=engine, q_block=q_block,
            s_block=s_block, query_cache_bytes=query_cache_bytes,
            with_info=True, timer=timer, auto_plan=auto_plan,
            query_reuse=query_reuse, reuse_siblings=(rerank_reuse,),
            info=infos["pass1"])
    with span("knn.rerank"):
        top = top_i.cpu().numpy()
        cand = np.unique(top[top >= 0])  # -1 marks a slot past N_s
        d, idx = _rerank_candidates(
            embed_hi, queries, syn, cand, engine=spec.exact_engine,
            q_block=q_block,
            s_block=s_block, query_cache_bytes=query_cache_bytes,
            device=device, timer=timer, auto_plan=auto_plan,
            query_reuse=rerank_reuse, reuse_siblings=(query_reuse,),
            info=infos["rerank"])
    # reduced precision anywhere in pass 1 selects the wide eta: a bf16
    # (or float16) cache, or int8 parts (whose tower runs bf16)
    demoted = torch.empty((), dtype=spec.cdtype).element_size() < 4
    eta = cert_eta if cert_eta is not None else _default_cert_eta(demoted)
    with span("knn.certificate"):
        cert = two_pass_certificate(d.cpu().numpy(), topk_d.cpu().numpy(),
                                    rq.cpu().numpy(),
                                    float(rs_max.max().cpu()), eta,
                                    spec.abs_err)
    bad = np.nonzero(~cert)[0]
    if bad.size:
        print(f"[knn] two-pass certificate failed for {bad.size} "
              f"queries; exact-f32 fallback search")
        with span("knn.fallback"):
            d_fix, i_fix = argmin_search(
                embed_hi, queries[bad], syn, engine=spec.exact_engine,
                q_block=min(q_block, 1024), s_block=min(s_block, 1024),
                query_cache_bytes=min(query_cache_bytes, 2 << 30),
                timer=timer, auto_plan=auto_plan,
                reuse_siblings=(query_reuse, rerank_reuse),
                info=infos.setdefault("fallback", {}))
            bad_t = torch.as_tensor(bad, device=d.device)
            d, idx = d.clone(), idx.clone()
            d[bad_t] = d_fix
            idx[bad_t] = i_fix
    if info is not None:
        info.update(infos, oom_resumes=sum(r["oom_resumes"]
                                           for r in infos.values()))
    if return_cert:
        return d, idx, cert, int(bad.size)
    return d, idx
