"""Fused distance + first-index argmin and fused distance + top-k: the
hand-written CUDA kernels ``csrc/knn_argmin.cu`` and ``csrc/knn_topk.cu``
and their plain PyTorch versions.

:func:`knn_argmin_fused` replaces
``ganleaks_tpu/ops/knn_pallas.py::knn_argmin_pallas`` (Pallas kernel
``_knn_kernel``): per query row, the nearest synthetic row under
``d = ||q||^2 + ||s||^2 - 2 q.s`` with the cross term accumulated in
float32 and ``torch.min``'s first-index tie-break; the distance matrix never
reaches memory. :func:`knn_topk_fused` replaces ``knn_topk_pallas``
(``_knn_topk_kernel``): the k smallest such distances per query, ascending,
the earliest index first among equals; when N_s < k the trailing entries
are (+inf, -1).

Bound on an H100 SXM (700 W): ``2*N_q*N_s*K`` operations against
``(N_q+N_s)*K`` input elements — at the attack's 2048 x 2048 block with
K = 512,000 about 2000 operations per byte read, far above the card's
balance point, so both kernels are bound by arithmetic. Both dtypes run
on the tensor cores, on one kernel per file templated on its tile: ``wgmma``
from shared memory that TMA fills through an mbarrier ring, one CTA per
SM, the accumulator promoted into a float32 register sum every 128 K
values. Two routes by dtype, sharing each kernel's span split and merge:

* float32 -> 'tf32x3' (``csrc/knn_tile_tf32x3.cuh``): each value split
  into TF32 hi and lo in shared memory, three TF32 products per
  multiply-add (lo.hi, hi.lo, hi.hi), which keeps float32's products to
  ~7e-7 of sum |a b| (plain TF32 would cut them to ~3 digits); floor
  26.0 ms at that block at 495 TFLOP/s (the CUDA cores' float32 floor is
  64.1 ms).
* bfloat16 -> 'wgmma' (``csrc/knn_tile_wgmma.cuh``): bf16 x bf16 -> f32,
  products exact in float32; floor 4.34 ms at 989 TFLOP/s.

TMA needs 16-byte rows (K % 4 == 0 for float32, K % 8 == 0 for bfloat16)
and a 16-byte-aligned base: other inputs go through an explicit
zero-padded copy (:func:`pad_k`), which leaves every dot product
unchanged.

Each wrapper launches its kernel for CUDA tensors, counting its launches in
``<wrapper>.launches`` and per route in ``<wrapper>.launches_by_route``
(``{"tf32x3": n, "wgmma": n}``); it takes the plain version only for
tensors on the CPU. It never falls back: a failed build, TMA map or launch
raises.
"""

from __future__ import annotations

import ctypes

import torch

# dtype -> (code of the C launch entry, route)
_ROUTES = {torch.float32: (0, "tf32x3"), torch.bfloat16: (1, "wgmma")}
TOPK_MAX_K = 128  # kMaxK of csrc/knn_topk.cu (running lists in shared memory)


def route(dtype: torch.dtype) -> str:
    """The tile that computes the cross term for embeddings of ``dtype``:
    'tf32x3' (float32) or 'wgmma' (bfloat16); anything else raises."""
    try:
        return _ROUTES[dtype][1]
    except KeyError:
        raise ValueError(f"q and s must share a dtype in float32/bfloat16, "
                         f"got {dtype}") from None


def pad_k(x: torch.Tensor) -> torch.Tensor:
    """``x`` (N, K) with K zero-padded to 16-byte rows (a multiple of 4
    float32 or 8 bfloat16 values), in a new tensor; ``x`` itself when its
    rows already are and start on 16 bytes (what TMA needs). Zero columns
    change no dot product and no norm."""
    pad = -x.shape[1] % (16 // x.element_size())
    if pad == 0 and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros((x.shape[0], x.shape[1] + pad))
    out[:, :x.shape[1]] = x
    return out


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Float32 squared row norms."""
    return torch.sum(torch.square(x.float()), dim=1)


def knn_argmin_plain(q: torch.Tensor, s: torch.Tensor,
                     rq: torch.Tensor | None = None,
                     rs: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the full distance matrix, then ``torch.min``
    along the synthetic axis (first index among equal minima). Returns
    (d float32 (N_q,), idx int32 (N_q,))."""
    rq = sq_norms(q) if rq is None else rq
    rs = sq_norms(s) if rs is None else rs
    d = rq[:, None] + rs[None, :] - 2.0 * (q.float() @ s.float().T)
    d_min, idx = torch.min(d, dim=1)
    return d_min, idx.to(torch.int32)


def _check_norms(r: torch.Tensor, n: int, like: torch.Tensor, name: str
                 ) -> torch.Tensor:
    if r.shape != (n,) or r.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 of shape ({n},), got "
                         f"{r.dtype} {tuple(r.shape)}")
    if r.device != like.device:
        raise ValueError(f"{name} is on {r.device}, the embeddings on "
                         f"{like.device}")
    if not r.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return r


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tiles_per_split(n_q: int, n_s: int, tile: int, n_sm: int) -> int:
    """Synthetic tiles per CTA; span ``j`` covers tiles
    ``[j * tps, min(n_tiles, (j + 1) * tps))``. Both tiles run one CTA per
    SM: the span length whose grid finishes in the fewest tile-times,
    ``waves x span``, the longer span among equals (fewer partials to
    merge)."""
    n_qt = -(-n_q // tile)
    n_st = -(-n_s // tile)

    def cost(tps: int) -> int:
        return -(-(n_qt * -(-n_st // tps)) // n_sm) * tps
    return min(range(1, n_st + 1), key=lambda tps: (cost(tps), -tps))


def launch_plan(q: torch.Tensor, n_s: int, tile: int = 128
                ) -> tuple[int, int]:
    """(tiles per split, splits) of a launch on CUDA ``q`` against ``n_s``
    synthetic rows."""
    tps = tiles_per_split(q.shape[0], n_s, tile, _sm_count(q.device))
    return tps, -(-(-(-n_s // tile)) // tps)


def _library(name: str, n_ints: int):
    """The loaded ``csrc/<name>.cu`` with its ``<name>_tile_rows`` and
    ``<name>_launch`` typed (``n_ints`` int arguments after the dtype code
    and four pointers, then five pointers)."""
    from ganleaks_tpu_torch.ops.cuda_build import load_library

    lib = load_library(name)
    if not getattr(lib, "_ganleaks_typed", False):
        rows = getattr(lib, f"{name}_tile_rows")
        rows.argtypes = []
        rows.restype = ctypes.c_int
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * n_ints + [ctypes.c_void_p] * 5)
        launch.restype = ctypes.c_int
        lib._ganleaks_typed = True
    return lib


def _check_pair(q: torch.Tensor, s: torch.Tensor) -> None:
    if q.dim() != 2 or s.dim() != 2 or q.shape[1] != s.shape[1]:
        raise ValueError(f"expected q (N_q, K) and s (N_s, K), got "
                         f"{tuple(q.shape)} and {tuple(s.shape)}")
    if q.dtype != s.dtype:
        raise ValueError(f"q and s must share a dtype in float32/bfloat16, "
                         f"got {q.dtype} and {s.dtype}")
    route(q.dtype)
    if q.device != s.device:
        raise ValueError(f"q is on {q.device}, s on {s.device}")
    if s.shape[0] == 0:
        raise ValueError("empty synthetic set")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda" and not (q.is_contiguous()
                                        and s.is_contiguous()):
        raise ValueError("q and s must be contiguous")


def _launch(fn, name: str, q: torch.Tensor, s: torch.Tensor,
            rq: torch.Tensor | None, rs: torch.Tensor | None, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/<name>.cu`` on CUDA ``q``/``s`` (``k``: the top-k
    list length, 0 for the argmin) and count the launch on ``fn``."""
    n_q, k_dim = q.shape
    n_s = s.shape[0]
    rq = sq_norms(q) if rq is None else _check_norms(rq, n_q, q, "rq")
    rs = sq_norms(s) if rs is None else _check_norms(rs, n_s, q, "rs")
    shape = (n_q, k) if k else (n_q,)
    d = torch.empty(shape, dtype=torch.float32, device=q.device)
    idx = torch.empty(shape, dtype=torch.int32, device=q.device)
    if n_q == 0:
        return d, idx
    code, tile_route = _ROUTES[q.dtype]
    q, s = pad_k(q), pad_k(s)
    lib = _library(name, 5 if k else 4)
    tile = getattr(lib, f"{name}_tile_rows")()
    tps, n_splits = launch_plan(q, n_s, tile)
    part_d = torch.empty((n_splits, *shape), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((n_splits, *shape), dtype=torch.int32,
                         device=q.device)
    ints = (n_q, n_s, q.shape[1], *((k,) if k else ()), tps)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            code, q.data_ptr(), s.data_ptr(), rq.data_ptr(), rs.data_ptr(),
            *ints, part_d.data_ptr(), part_i.data_ptr(), d.data_ptr(),
            idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err} (n_q={n_q}, n_s={n_s}, K={k_dim}, k={k}, "
                           f"{q.dtype}, {tile_route} tile)")
    fn.launches += 1
    fn.launches_by_route[tile_route] += 1
    return d, idx


def knn_argmin_fused(q: torch.Tensor, s: torch.Tensor, *,
                     rq: torch.Tensor | None = None,
                     rs: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN of every row of ``q`` (N_q, K) among the rows of ``s`` (N_s, K):
    (d float32 (N_q,), idx int32 (N_q,)), ``d`` the minimal
    ``rq + rs - 2 q.s`` and ``idx`` its first index.

    ``q`` and ``s``: contiguous, same device, float32 (3xTF32 tile) or
    bfloat16 (wgmma tile); products accumulate in float32 either way.
    ``rq``/``rs``: optional float32 squared row norms (computed from the
    embeddings when absent; the streamed search passes norms taken before a
    cache-dtype cast)."""
    _check_pair(q, s)
    if q.device.type == "cpu":
        return knn_argmin_plain(q, s, rq, rs)
    return _launch(knn_argmin_fused, "knn_argmin", q, s, rq, rs, 0)


knn_argmin_fused.launches = 0
knn_argmin_fused.launches_by_route = {"tf32x3": 0, "wgmma": 0}


def knn_topk_plain(q: torch.Tensor, s: torch.Tensor, k: int,
                   rq: torch.Tensor | None = None,
                   rs: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the full distance matrix, then a stable
    ascending sort along the synthetic axis (the earliest index first among
    equal distances) cut to ``k``. Returns (d float32 (N_q, k), idx int32
    (N_q, k)); when N_s < k the trailing entries are (+inf, -1)."""
    rq = sq_norms(q) if rq is None else rq
    rs = sq_norms(s) if rs is None else rs
    d = rq[:, None] + rs[None, :] - 2.0 * (q.float() @ s.float().T)
    d_sorted, idx = torch.sort(d, dim=1, stable=True)
    d_top = d.new_full((q.shape[0], k), torch.inf)
    i_top = torch.full((q.shape[0], k), -1, dtype=torch.int32,
                       device=q.device)
    n = min(k, s.shape[0])
    d_top[:, :n] = d_sorted[:, :n]
    i_top[:, :n] = idx[:, :n].to(torch.int32)
    return d_top, i_top


def knn_topk_fused(q: torch.Tensor, s: torch.Tensor, k: int, *,
                   rq: torch.Tensor | None = None,
                   rs: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest rows of ``s`` (N_s, K) for every row of ``q``
    (N_q, K): (d float32 (N_q, k), idx int32 (N_q, k)), ascending, the
    earliest index first among equal distances; (+inf, -1) past N_s.
    Inputs as for :func:`knn_argmin_fused`."""
    _check_pair(q, s)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if q.device.type == "cpu":
        return knn_topk_plain(q, s, k, rq, rs)
    if k > TOPK_MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's limit {TOPK_MAX_K}")
    return _launch(knn_topk_fused, "knn_topk", q, s, rq, rs, k)


knn_topk_fused.launches = 0
knn_topk_fused.launches_by_route = {"tf32x3": 0, "wgmma": 0}
