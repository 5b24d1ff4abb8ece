"""Blocked 1-NN search over embedding vectors (port of the flat search of
``ganleaks_tpu.ops.knn``).

* The (queries x synthetic) distance matrix is never materialised whole:
  blocks are folded into a running (min, argmin).
* The tie-break matches ``torch.min``: the FIRST index attaining the
  minimum wins — blocks are visited in index order and updates use strict
  ``<``.
* Engines:
  - 'gemm'   : d = ||q||^2 + ||s||^2 - 2 q.s with ``torch.matmul``
               (float32 products; TF32 is off, ``device.set_f32_numerics``);
  - 'pallas' : the same math in the fused CUDA distance+argmin kernel
               (``ops/knn_fused``; the name is the JAX package's);
  - 'exact'  : d = sum((q - s)^2) elementwise, the reference's order.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ganleaks_tpu_torch.ops.knn_fused import knn_argmin_fused, sq_norms

ENGINES = ("gemm", "pallas", "exact")


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


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown kNN engine {engine!r}; the flat search "
                         f"supports {ENGINES}")


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
    query row among materialised synthetic embeddings."""
    _check_engine(engine)
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


class PhaseTimer:
    """Seconds spent in named phases of work queued on the device: CUDA
    events around each phase (read once, at :meth:`seconds`, so timing
    never stalls the queue) or the host clock on the CPU, which runs
    synchronously."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: dict[str, list] = {}

    def start(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return name, ev
        return name, time.perf_counter()

    def stop(self, token) -> None:
        name, t0 = token
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.setdefault(name, []).append((t0, ev))
        else:
            self._marks.setdefault(name, []).append(time.perf_counter() - t0)

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


def knn_argmin_streamed(embed_fn: Callable[[torch.Tensor], torch.Tensor],
                        queries, syn, *, engine: str = "gemm",
                        q_block: int = 2048, s_block: int = 2048,
                        query_cache_bytes: int = 8 << 30,
                        device: torch.device | str = "cpu",
                        timer: PhaseTimer | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN where embeddings are produced block by block — for feature
    spaces too large to materialise (LPIPS at 64x64 is 512,000 dims per
    image).

    ``queries``/``syn``: image arrays (numpy or torch, axis 0 = samples),
    shipped to ``device`` one block at a time. Query embeddings are cached
    on the device in chunks of ``query_cache_bytes``; the synthetic set is
    featurised once per chunk (``N_q + N_s * ceil(N_q / chunk_rows)``
    forwards). Blocks are zero-padded to their block size and the padded
    tail masked by its valid-row count. Query norms are float32, taken from
    the embedding before the cache-dtype cast.

    Left out of this port so far (ROADMAP): the OOM halving resume,
    cross-call query reuse and the device-memory planner.
    """
    _check_engine(engine)
    device = torch.device(device)
    if engine == "pallas":
        # the kernel tiles the block itself; a larger block buys nothing
        s_block = min(s_block, 2048)
    n_q, n_s = len(queries), len(syn)
    if n_s == 0:
        raise ValueError("empty synthetic set")
    q_block = max(1, min(q_block, n_q))
    s_block = max(1, min(s_block, n_s))
    timer = timer or PhaseTimer(device)

    def block_norms(x, start: int, block: int):
        tok = timer.start("featurize")
        blk = _as_device_block(x, start, block, device)
        n_valid = blk.shape[0]
        e = embed_fn(pad_rows(blk, block))
        r = sq_norms(e)
        timer.stop(tok)
        return e, r, n_valid

    with torch.inference_mode():
        probe = embed_fn(_as_device_block(queries, 0, 1, device))
        k_dim, cdtype = probe.shape[1], probe.dtype
        row_bytes = k_dim * probe.element_size()
        del probe
        # chunk_rows rounds DOWN to a q_block multiple, so full featurize
        # blocks tile each chunk and padding only appears at n_q
        chunk_rows = max(q_block,
                         int(query_cache_bytes // row_bytes)
                         // q_block * q_block)
        outs_d, outs_i = [], []
        for qs0 in range(0, n_q, chunk_rows):
            end = min(n_q, qs0 + chunk_rows)
            n_rows = end - qs0
            padded = n_rows + (-n_rows) % q_block
            cache = torch.empty((padded, k_dim), dtype=cdtype, device=device)
            rq = torch.empty(padded, dtype=torch.float32, device=device)
            for qs in range(qs0, end, q_block):
                e, r, _ = block_norms(queries, qs, q_block)
                cache[qs - qs0:qs - qs0 + q_block] = e
                rq[qs - qs0:qs - qs0 + q_block] = r
                del e
            run_min = torch.full((padded,), torch.inf, device=device)
            run_idx = torch.zeros(padded, dtype=torch.int32, device=device)
            for ss in range(0, n_s, s_block):
                s_emb, rs, n_valid = block_norms(syn, ss, s_block)
                tok = timer.start("fold")
                if engine == "pallas":
                    d_blk, i_blk = knn_argmin_fused(
                        cache, s_emb[:n_valid], rq=rq, rs=rs[:n_valid])
                    better = d_blk < run_min  # in order: first index kept
                    run_min = torch.where(better, d_blk, run_min)
                    run_idx = torch.where(better, ss + i_blk, run_idx)
                else:
                    run_min, run_idx = _fold_block(
                        run_min, run_idx, cache, rq, s_emb, ss, n_valid,
                        engine, rs)
                timer.stop(tok)
                del s_emb, rs
            outs_d.append(run_min[:n_rows])
            outs_i.append(run_idx[:n_rows])
            del cache, rq
    return torch.cat(outs_d), torch.cat(outs_i)
