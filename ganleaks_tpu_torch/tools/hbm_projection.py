"""Static device-memory projection of an fbb attack on the card (port of
the repository's ``tools/hbm_projection.py``): before touching a card,
will ``n_q`` x ``n_syn`` at this resolution fit beside the query cache,
and how many synthetic featurise sweeps will the streamed search make?

Every number comes from the calls ``attack/fbb.attack_arrays`` makes to
plan: the featuriser it builds (``build_embed_fn``; 'auto' resolved as on
a card), the row width of its cache and the planner's charges (the
search's own spec, ``ops/knn.search_spec``), the one-sweep need that
decides whether the image sets are copied to the card
(``ops/knn.stream_need_bytes``, ``ops/stream_plan.sets_fit``) and the
schedule the streamed search starts from (``ops/knn.plan_search``, which runs
``ops/stream_plan.plan_stream``). The budget is what
``stream_plan.device_capacity`` would read on a card with ``--mem_gb``
GiB free before the attack (``stream_plan.capacity_of``, less the sets
where they are copied there), or ``--capacity_bytes`` exactly (a plan's
own ``capacity_bytes``, as ``attack_arrays`` returns it).

    python -m ganleaks_tpu_torch.tools.hbm_projection --n_q 20000 \\
        --n_syn 100000 --engine auto --store uint8

Host arithmetic and one featurised image on the CPU: no card needed.
Prints the row bytes, the cache, ``s_block``, ``q_block``, the sweeps,
the total and whether it fits; exits 1 where it does not.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

import numpy as np
import torch

from ganleaks_tpu_torch.attack.fbb import (build_embed_fn,
                                           resolve_auto_engine)
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.ops import stream_plan
from ganleaks_tpu_torch.ops.knn import (PARTS_ENGINES, PhaseTimer,
                                        plan_search, search_spec,
                                        stream_need_bytes)
from ganleaks_tpu_torch.ops.stream_plan import GIB

H100_MEM_GB = 80.0  # the H100 80GB HBM3's memory
STORE_BYTES = {"uint8": 1, "float32": 4}


def project(n_q: int, n_syn: int, resolution: int = 64,
            engine: str = "auto", dtype: str = "float32",
            store: str = "uint8", cache_gb: float = 8.0,
            q_block: int | None = None, s_block: int | None = None,
            mem_gb: float = H100_MEM_GB, capacity_bytes: int | None = None,
            tower_dtype: str | None = None) -> dict:
    """The plan ``attack_arrays`` makes for the l2-lpips attack on VGG16
    in this configuration (module docstring); blocks default to
    ``AttackConfig``'s."""
    cfg = AttackConfig(distance="l2-lpips", lpips_net="vgg", engine=engine,
                       dtype=dtype, resolution=resolution,
                       lpips_compute_dtype=tower_dtype,
                       query_cache_gb=cache_gb,
                       uint8_storage=store == "uint8")
    cfg = replace(cfg, query_block=q_block or cfg.query_block,
                  syn_block=s_block or cfg.syn_block)
    cfg = resolve_auto_engine(cfg, "cuda")
    embed = build_embed_fn(cfg, "cpu",
                           structured=cfg.engine in PARTS_ENGINES)
    # zero pages: only the row the planner featurises is ever touched
    queries = np.zeros((n_q, resolution, resolution, 3),
                       np.uint8 if store == "uint8" else np.float32)
    spec = search_spec(embed, queries, cfg.engine, "cpu",
                       PhaseTimer(torch.device("cpu")))
    row = spec.row_bytes
    sets = (n_q + n_syn) * resolution * resolution * 3 * STORE_BYTES[store]
    request = int(cfg.query_cache_gb * GIB)
    # attack_arrays._stage_sets: the sets go to the card where they fit
    # beside the search's one-sweep need ('auto' host_stream)
    need = stream_need_bytes(
        embed, queries, engine=cfg.engine, q_block=cfg.query_block,
        s_block=cfg.syn_block, query_cache_bytes=request,
        auto_plan=True, device="cpu")
    mem = int(mem_gb * GIB)
    on_device = stream_plan.sets_fit(sets, need, stream_plan.capacity_of(mem))
    if capacity_bytes is None:
        capacity_bytes = stream_plan.capacity_of(
            mem - (sets if on_device else 0))
    plan = plan_search(n_q, n_syn, row, q_block=cfg.query_block,
                       s_block=cfg.syn_block, cache_bytes=request,
                       charges=spec.charges, capacity=capacity_bytes)
    held = stream_plan.plan_bytes(plan.cache_rows, row,
                                  s_block=plan.s_block,
                                  q_block=plan.q_block, **spec.charges)
    return {"engine": cfg.engine, "dtype": cfg.dtype,
            "tower_dtype": cfg.lpips_compute_dtype or "float32",
            "row_bytes": row, "chunk_rows": plan.chunk_rows,
            "cache_rows": plan.cache_rows,
            "cache_bytes": plan.cache_rows * row,
            "planned_cache_bytes": plan.cache_bytes,
            "s_block": plan.s_block, "q_block": plan.q_block,
            "sweeps": plan.sweeps, "sets_bytes": sets,
            "sets_on_device": on_device, "plan_bytes": held,
            "capacity_bytes": capacity_bytes,
            "total_bytes": held + (sets if on_device else 0),
            "mem_bytes": mem, "fits": held <= capacity_bytes}


def _gib(x: float) -> str:
    return f"{x / GIB:8.2f} GiB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_q", type=int, default=20000)
    ap.add_argument("--n_syn", type=int, default=100000)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "gemm", "pallas", "exact", "taps",
                             "taps-int8"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--tower_dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="AttackConfig.lpips_compute_dtype (default: the "
                         "embedding's; 'auto' takes bfloat16)")
    ap.add_argument("--store", default="uint8", choices=sorted(STORE_BYTES))
    ap.add_argument("--cache_gb", type=float, default=8.0)
    ap.add_argument("--q_block", type=int, default=None,
                    help="default: AttackConfig.query_block")
    ap.add_argument("--s_block", type=int, default=None,
                    help="default: AttackConfig.syn_block")
    ap.add_argument("--mem_gb", type=float, default=H100_MEM_GB,
                    help="GiB free on the card before the attack (default "
                         "80: the H100 80GB HBM3)")
    ap.add_argument("--capacity_bytes", type=int, default=None,
                    help="the planner's budget exactly (a plan's "
                         "capacity_bytes); overrides --mem_gb")
    args = ap.parse_args(argv)
    p = project(args.n_q, args.n_syn, args.resolution, args.engine,
                args.dtype, args.store, args.cache_gb, args.q_block,
                args.s_block, args.mem_gb, args.capacity_bytes,
                args.tower_dtype)
    print(f"config: {args.n_q} x {args.n_syn} @{args.resolution} "
          f"engine={args.engine} -> {p['engine']} (embeddings "
          f"{p['dtype']}, tower {p['tower_dtype']}) store={args.store} "
          f"cache request {args.cache_gb} GiB")
    print(f"  cache row                   {p['row_bytes']:,} B")
    print(f"  plan: cache {p['cache_rows']:,} rows {_gib(p['cache_bytes'])}"
          f", s_block {p['s_block']}, q_block {p['q_block']}")
    print(f"  query chunk rows {p['chunk_rows']:,} -> synthetic featurise "
          f"sweeps: {p['sweeps']}")
    print(f"  image sets {_gib(p['sets_bytes'])} "
          f"({'on the card' if p['sets_on_device'] else 'host memory'})")
    print(f"  search (planner's charge)   {_gib(p['plan_bytes'])}")
    print(f"  TOTAL                       {_gib(p['total_bytes'])} of "
          f"{_gib(p['mem_bytes'])} (budget {_gib(p['capacity_bytes'])} "
          f"after the margin{' and the sets' if p['sets_on_device'] else ''}"
          f")")
    print("  fits:", p["fits"])
    return 0 if p["fits"] else 1


if __name__ == "__main__":
    sys.exit(main())
