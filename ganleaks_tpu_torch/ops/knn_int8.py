"""The int8 argmin fold of one synthetic block (the 'taps-int8' engine):
the hand-written Hopper kernel ``csrc/knn_int8_fold.cu`` and its plain
version, the per-part chain.

The fold takes the int8 query cache ``q`` (N_q, K), one int8 synthetic
block ``s`` whose first ``n_valid`` rows are real, their float32 norms, the
parts' widths (K = sum of them, in part order) and static dequantisation
factors, and the running (min, argmin) of every query row:

    cross = sum_l f_l * (q_l . s_l)    (float32, in part order)
    d     = rq + rs - 2 * cross

then the first minimal column of each row, merged into the running state
with strict ``<`` (earlier blocks keep ties).

* :func:`_fold_block_parts_q` is the plain version and the per-part path:
  one s8 x s8 -> s32 product per part (``torch._int_mm``), dequantised by
  its factor (float32 times the Python float, as torch multiplies), the
  float32 sums, the mask, ``torch.min`` and the running ``where``.
* :func:`int8_argmin_fold` launches the kernel on CUDA tensors: the same
  bits, with every part's exact int32 dot in ``wgmma`` accumulators,
  promoted in registers at each part's end, and the argmin in the
  epilogue; nothing of size N_q x n_valid reaches memory. On CPU tensors
  it runs the plain version. It never falls back: a CUDA tensor outside
  the kernel's contract, a failed build or launch raises.
* The route (:func:`kernel_route`) is decided from the widths alone: the
  kernel's part boundaries fall on its 32-byte K steps, so every width must
  be a multiple of :data:`STEP_K`, and TMA needs rows of 16-byte multiples.
  :func:`argmin_fold` makes that choice for every caller: the kernel's
  wrapper, or the per-part chain on every device.

The launch (:func:`launch_plan`) runs persistent CTAs, one per SM, in
clusters of :data:`CLUSTER` that share each synthetic tile of
:data:`TILE_COLS` rows; work items (``CLUSTER`` query tiles of 128 rows x
one synthetic tile) go round-robin to the clusters in bands of
:data:`BAND` query groups per synthetic tile (:func:`item_coords`, the
kernel's order). Launches count in ``int8_argmin_fold.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

STEP_K = 32       # K bytes per wgmma step: parts end on these
TILE_Q = 128      # query rows per CTA
TILE_COLS = 256   # synthetic rows per CTA tile (kTileS)
CLUSTER = 2       # CTAs per cluster along the queries (kCluster)
BAND = 8          # query groups per band of the item order
MAX_PARTS = 16    # kMaxParts of the kernel


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b.T`` of int8 rows a (M, K) and b (N, K) through
    ``torch._int_mm``. On CUDA it needs M > 16 and K, N multiples of 8:
    zero rows and columns pad the operands where they fall short (zeros add
    nothing to the dots; the padded rows are cut off)."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type == "cuda" and (m <= 16 or k % 8 or n % 8):
        pm, pk, pn = max(0, 17 - m), (-k) % 8, (-n) % 8
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
        b = torch.nn.functional.pad(b, (0, pk, 0, pn))
        return torch._int_mm(a, b.T)[:m, :n]
    return torch._int_mm(a, b.T)


def _int8_cross(q: torch.Tensor, s: torch.Tensor, widths: tuple,
                factors: tuple) -> torch.Tensor:
    """float32 sum_l f_l * (q_l . s_l) over the parts' column slices: one
    s8 x s8 -> s32 product per part, dequantised by its static factor."""
    cross, off = None, 0
    for w, f in zip(widths, factors):
        c = _int_dot(q[:, off:off + w], s[:, off:off + w]).float() * f
        cross = c if cross is None else cross + c
        off += w
    return cross


def _fold_block_parts_q(run_min, run_idx, q, rq, s, rs, col0: int,
                        n_valid: int, widths: tuple, factors: tuple):
    """int8 argmin fold: the dequantised per-part cross term, masking and
    the first-index tie-break as ``ops/knn._fold_block``."""
    d = rq[:, None] + rs[None, :] - 2.0 * _int8_cross(q, s, widths, factors)
    local = torch.arange(s.shape[0], device=d.device)
    d = torch.where(local[None, :] < n_valid, d, torch.inf)
    blk_min, blk_arg = torch.min(d, dim=1)
    better = blk_min < run_min
    return (torch.where(better, blk_min, run_min),
            torch.where(better, col0 + blk_arg.to(torch.int32), run_idx))


def kernel_route(widths: tuple, k_dim: int) -> bool:
    """Whether blocks of these part ``widths`` (K = ``k_dim``) fold in the
    kernel: every width a positive multiple of :data:`STEP_K`, at most
    :data:`MAX_PARTS` parts, K their sum and a multiple of 16."""
    return (0 < len(widths) <= MAX_PARTS
            and all(w > 0 and w % STEP_K == 0 for w in widths)
            and sum(widths) == k_dim and k_dim % 16 == 0)


def argmin_fold(widths: tuple, k_dim: int):
    """The int8 argmin fold for blocks of these part ``widths`` (K =
    ``k_dim``): :func:`int8_argmin_fold` where they take the kernel's route
    (:func:`kernel_route`), else the per-part chain
    :func:`_fold_block_parts_q`. Both take the same arguments and give the
    same bits."""
    return (int8_argmin_fold if kernel_route(tuple(widths), k_dim)
            else _fold_block_parts_q)


def part_table(widths: tuple, factors: tuple
               ) -> tuple[tuple[int, ...], tuple[float, ...]]:
    """What the kernel is handed for the parts: each part's end in k32
    steps (cumulative) and its factor as the float32 value torch
    multiplies a float32 tensor by for ``tensor * factor`` (the Python
    float rounded to nearest float32)."""
    ends = tuple(int(e) for e in np.cumsum([w // STEP_K for w in widths]))
    return ends, tuple(float(np.float32(f)) for f in factors)


def item_coords(it: int, n_qg: int, n_st: int, band: int
                ) -> tuple[int, int]:
    """Work item ``it`` -> (query group, synthetic tile), the kernel's
    order: bands of ``band`` query groups; within a band the query group
    varies fastest, then the synthetic tile."""
    per_band = band * n_st
    b, r = divmod(it, per_band)
    height = min(band, n_qg - b * band)
    st, qg = divmod(r, height)
    return b * band + qg, st


class FoldPlan(NamedTuple):
    """One launch: query groups (:data:`CLUSTER` query tiles each), synthetic
    tiles, work items, clusters and CTAs launched, and the workspace's
    float32 count (each CTA's cross terms)."""

    n_qg: int
    n_st: int
    items: int
    clusters: int
    grid: int
    ws_floats: int


def launch_plan(n_q: int, n_valid: int, max_clusters: int) -> FoldPlan:
    """The launch of one block's fold over ``n_q`` cached rows and
    ``n_valid`` synthetic rows: persistent clusters, as many as can be
    resident (``max_clusters``) and no more than there are items."""
    if max_clusters < 1:
        raise ValueError(f"the int8 fold kernel cannot be resident "
                         f"(max clusters {max_clusters})")
    n_qg = -(-n_q // (TILE_Q * CLUSTER))
    n_st = -(-n_valid // TILE_COLS)
    items = n_qg * n_st
    clusters = min(items, max_clusters)
    grid = clusters * CLUSTER
    return FoldPlan(n_qg, n_st, items, clusters, grid,
                    grid * 256 * (TILE_COLS // 2))


def _library():
    """The loaded ``csrc/knn_int8_fold.cu`` with its entries typed."""
    from ganleaks_tpu_torch.ops.cuda_build import load_library

    lib = load_library("knn_int8_fold")
    if not getattr(lib, "_ganleaks_typed", False):
        lib.knn_int8_fold_tile_cols.argtypes = []
        lib.knn_int8_fold_tile_cols.restype = ctypes.c_int
        lib.knn_int8_fold_cluster.argtypes = []
        lib.knn_int8_fold_cluster.restype = ctypes.c_int
        if (lib.knn_int8_fold_tile_cols(), lib.knn_int8_fold_cluster()) \
                != (TILE_COLS, CLUSTER):
            raise RuntimeError(f"csrc/knn_int8_fold.cu's tile is not "
                               f"{TILE_COLS} columns in clusters of "
                               f"{CLUSTER}")
        lib.knn_int8_fold_max_clusters.argtypes = []
        lib.knn_int8_fold_max_clusters.restype = ctypes.c_int
        lib.knn_int8_fold_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] + [ctypes.c_void_p] * 3)
        lib.knn_int8_fold_launch.restype = ctypes.c_int
        lib._ganleaks_typed = True
    return lib


_MAX_CLUSTERS: dict[int, int] = {}


def max_clusters(device: torch.device) -> int:
    """Clusters resident at once on ``device`` (the card's occupancy
    query, once per device)."""
    index = torch.device(device).index or 0
    if index not in _MAX_CLUSTERS:
        with torch.cuda.device(index):
            _MAX_CLUSTERS[index] = _library().knn_int8_fold_max_clusters()
    return _MAX_CLUSTERS[index]


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def int8_argmin_fold(run_min: torch.Tensor, run_idx: torch.Tensor,
                     q: torch.Tensor, rq: torch.Tensor, s: torch.Tensor,
                     rs: torch.Tensor, col0: int, n_valid: int,
                     widths: tuple, factors: tuple
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold the block ``s`` (rows ``>= n_valid`` ignored; its first row is
    column ``col0``) into the running ``(run_min, run_idx)`` of the rows
    of ``q``: a new (min float32, idx int32) pair, bit for bit
    :func:`_fold_block_parts_q`'s. The widths must take the kernel's
    route (:func:`kernel_route`; :func:`argmin_fold` chooses for a caller
    that may hold other widths). CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    n_q, k_dim = q.shape
    if not kernel_route(tuple(widths), k_dim):
        raise ValueError(f"part widths {tuple(widths)} (K = {k_dim}) are "
                         f"off the kernel's {STEP_K}-byte steps; fold them "
                         f"per part")
    if q.device.type == "cpu":
        return _fold_block_parts_q(run_min, run_idx, q, rq, s, rs, col0,
                                   n_valid, widths, factors)
    dev = q.device
    if n_valid <= 0 or n_valid > s.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside the block's "
                         f"{s.shape[0]} rows")
    _check("q", q, (n_q, k_dim), torch.int8, dev)
    _check("s", s, (s.shape[0], k_dim), torch.int8, dev)
    _check("rq", rq, (n_q,), torch.float32, dev)
    _check("rs", rs, (s.shape[0],), torch.float32, dev)
    _check("run_min", run_min, (n_q,), torch.float32, dev)
    _check("run_idx", run_idx, (n_q,), torch.int32, dev)
    if q.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("q and s must start on 16 bytes (TMA)")
    plan = launch_plan(n_q, n_valid, max_clusters(dev))
    ends, f32 = part_table(tuple(widths), tuple(factors))
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
    part_d = torch.empty((plan.n_st, n_q), dtype=torch.float32, device=dev)
    part_i = torch.empty((plan.n_st, n_q), dtype=torch.int32, device=dev)
    out_min = torch.empty_like(run_min)
    out_idx = torch.empty_like(run_idx)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn_int8_fold_launch(
            q.data_ptr(), s.data_ptr(), rq.data_ptr(),
            rs.data_ptr(), n_q, n_valid, k_dim, plan.grid, BAND,
            (ctypes.c_int * len(ends))(*ends),
            (ctypes.c_float * len(f32))(*f32), len(ends), ws.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), run_min.data_ptr(),
            run_idx.data_ptr(), int(col0), out_min.data_ptr(),
            out_idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_int8_fold kernel launch failed with CUDA "
                           f"error {err} (n_q={n_q}, n_valid={n_valid}, "
                           f"K={k_dim}, widths={tuple(widths)})")
    int8_argmin_fold.launches += 1
    return out_min, out_idx


int8_argmin_fold.launches = 0
