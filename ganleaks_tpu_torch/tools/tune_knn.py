"""Sweep the streamed nearest-neighbour fold over its engines and block
sizes on the card (port of the repository's ``tools/tune_knn.py``).

The distance+argmin stage alone, without the tower: ``--n_q`` query
embeddings and ``--s_rows`` synthetic ones of ``--k`` dims, drawn on the
device from a seeded ``torch.Generator``, folded block by block exactly
as the streamed search folds them (``ops/knn``), at ``s_block`` 2,048,
4,096 and 8,192 rows:

* 'gemm': float32 ``torch.matmul`` + ``min`` (``_fold_block``, the
  library);
* 'pallas' float32: K1 on the 3xTF32 tile (``_fold_fused``);
* 'pallas' bfloat16: K1 on the wgmma tile;
* 'taps-int8': the int8 parts fold over VGG16's 64-px widths when
  ``--k`` is 512,000, else one part, routed as the search routes it
  (``knn_int8.argmin_fold``): the int8 fold kernel
  (``ops/knn_int8.int8_argmin_fold``) where every width is a multiple of
  32 and K of 16 (``knn_int8.kernel_route``), else one ``torch._int_mm``
  per part (``knn_int8._fold_block_parts_q``).

Prints one JSON line per configuration: ms per sweep of the ``s_rows``
and per block, query-pairs/s, and whether the row is what the attack runs
at ``AttackConfig``'s defaults (``syn_block`` 8,192, which the fused
searches cap, ``ops/knn.fold_s_block``; 'auto' on the card is
'taps-int8'); the card's name and power limit on every line. K1's and
K3's tiles are compile-time constants: there is no tile to sweep.

    python -m ganleaks_tpu_torch.tools.tune_knn
    python -m ganleaks_tpu_torch.tools.tune_knn --device cpu --n_q 8 \\
        --s_rows 32 --k 64

``--device`` defaults to cuda and refuses without a GPU; ``--device cpu``
runs the plain versions.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.device import card_line, resolve_device
from ganleaks_tpu_torch.ops.distance import make_embed_fn, make_embed_parts_fn
from ganleaks_tpu_torch.ops.knn import (PARTS_ENGINES, PhaseTimer,
                                        _fold_block, _fold_fused,
                                        fold_s_block, search_spec)
from ganleaks_tpu_torch.ops.knn_fused import sq_norms
from ganleaks_tpu_torch.ops.knn_int8 import argmin_fold
from ganleaks_tpu_torch.utils.profiling import call_seconds

BLOCKS = (2048, 4096, 8192)
# VGG16 l2-lpips parts at 64 px: the pixels, then the five taps
VGG16_WIDTHS_64 = (12288, 262144, 131072, 65536, 32768, 8192)
CONFIGS = (("gemm", torch.float32), ("pallas", torch.float32),
           ("pallas", torch.bfloat16), ("taps-int8", torch.int8))


def _fold_fn(engine: str, q, rq, s, rs, s_block: int, widths, factors):
    """One sweep of ``s`` in blocks of ``s_block``, folded into a running
    (min, argmin) as the streamed search folds each block."""
    n_q, n_s = q.shape[0], s.shape[0]
    fold_q = argmin_fold(widths, q.shape[1])

    def sweep():
        state = (torch.full((n_q,), torch.inf, device=q.device),
                 torch.zeros(n_q, dtype=torch.int32, device=q.device))
        for col0 in range(0, n_s, s_block):
            blk, r = s[col0:col0 + s_block], rs[col0:col0 + s_block]
            n = blk.shape[0]
            if engine == "gemm":
                state = _fold_block(*state, q, rq, blk, col0, n, "gemm", r)
            elif engine == "pallas":
                state = _fold_fused(state, q, rq, blk, r, col0, n)
            else:
                state = fold_q(*state, q, rq, blk, r, col0, n, widths,
                               factors)
        return state
    return sweep


def _attack_block(engine: str, syn_block: int) -> int:
    """The synthetic block the attack's 1-NN search on ``engine`` folds at
    when asked for ``syn_block``: capped where its fold is fused
    (``ops/knn.fold_s_block``), as the search's own spec says
    (``ops/knn.search_spec``, built on one 8-px image through the pixel
    featuriser)."""
    maker = make_embed_parts_fn if engine in PARTS_ENGINES else make_embed_fn
    spec = search_spec(maker("l2"), np.zeros((1, 8, 8, 3), np.float32),
                       engine, "cpu", PhaseTimer(torch.device("cpu")))
    return fold_s_block(syn_block, spec.charges["fused_fold"])


def _embeddings(gen, n_q: int, n_s: int, k: int, dtype, device):
    """(q, rq, s, rs): rows N(0, 0.01^2) in float32 cast to ``dtype``, or
    int8 rows uniform in [-127, 127] (float32 norms of the values as
    folded: dequantised for int8)."""
    if dtype == torch.int8:
        q, s = (torch.randint(-127, 128, (n, k), generator=gen,
                              device=device, dtype=torch.int8)
                for n in (n_q, n_s))
        return q, sq_norms(q.float()), s, sq_norms(s.float())
    q, s = (torch.randn((n, k), generator=gen, device=device).mul_(0.01)
            .to(dtype) for n in (n_q, n_s))
    return q, sq_norms(q), s, sq_norms(s)


def sweep(n_q: int = 2000, s_rows: int = 8192, k: int = 512000,
          device=None, reps: int = 3, emit=None) -> list[dict]:
    """Time every (engine, dtype, s_block) of the module docstring; each
    record is passed to ``emit`` (default: printed as a JSON line)."""
    device = resolve_device(device)
    emit = emit or (lambda r: print(json.dumps(r), flush=True))
    head = {"tool": "tune_knn",
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "card": card_line(device), "n_q": n_q, "s_rows": s_rows, "k": k}
    widths = VGG16_WIDTHS_64 if k == sum(VGG16_WIDTHS_64) else (k,)
    factors = tuple(1.0 for _ in widths)
    cfg = AttackConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    with torch.inference_mode():
        for engine, dtype in CONFIGS:
            q, rq, s, rs = _embeddings(gen, n_q, s_rows, k, dtype, device)
            # the block the attack's search folds at the default syn_block
            default_block = _attack_block(engine, cfg.syn_block)
            for s_block in BLOCKS:
                fn = _fold_fn(engine, q, rq, s, rs, s_block, widths, factors)
                t = call_seconds(fn, device, reps)
                rec = {**head, "engine": engine,
                       "dtype": str(dtype).replace("torch.", ""),
                       "s_block": s_block, "ms": t * 1e3,
                       "ms_per_block": t * 1e3 / -(-s_rows // s_block),
                       "pairs_per_sec": n_q * s_rows / t,
                       "attack_default": s_block == default_block,
                       "auto": engine == "taps-int8"}
                emit(rec)
                out.append(rec)
            del q, rq, s, rs
            if device.type == "cuda":
                torch.cuda.empty_cache()
    best = max(out, key=lambda r: r["pairs_per_sec"])
    emit({**head, "best": {k_: best[k_] for k_ in
                           ("engine", "dtype", "s_block", "pairs_per_sec")}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_q", type=int, default=2000)
    ap.add_argument("--s_rows", type=int, default=8192)
    ap.add_argument("--k", type=int, default=512000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sweep(args.n_q, args.s_rows, args.k, args.device, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
