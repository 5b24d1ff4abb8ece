"""Full-black-box membership-inference attack on a GPU (port of
``ganleaks_tpu.attack.fbb``; reference ``attack_models/fbb.py``).

For each query image (member 'pos' / non-member 'neg') the score is the
negated distance to its nearest neighbour in the generated set under
``l2`` or ``l2 + 0.2*LPIPS`` (``utils.py:153-177``). Each image is
featurised once (``ops/distance``, ``ops/lpips``) and the search is a
streamed 1-NN (``ops/knn``). Engines: 'gemm'/'exact' (torch folds),
'pallas' (the fused CUDA distance+argmin kernel on flat embeddings),
'taps' and 'taps-int8' (tap-structured parts written by the tap epilogue
kernel, folded by the fused kernel or by int8 products), and 'auto' (on
CUDA the JAX package's accelerator recipe: taps-int8 with a bf16 tower).
``two_pass=True`` re-ranks each engine's top-k candidates in float32 under
a runtime exactness certificate (``ops/knn.knn_argmin_two_pass``).

On several GPUs (``n_chips > 1`` under ``torchrun``, ``multihost=true``, or
the CLI's local launch; ``parallel/multihost``) the search runs on a mesh,
one process per device (``parallel/knn_shard``): ``shard_layout='sharded'``
(the synthetic set split; with ``two_pass``, the mesh two-pass mode) or
``'ring'`` (both sets split, embedded blocks rotating). Every rank gets
the results; rank 0 alone writes the artifacts and the metrics.

Artifacts (byte-compatible with the reference):
  ``pos_loss.npy``/``neg_loss.npy``  (N, 1) float64 nearest distances;
  ``pos_idx.npy``/``neg_idx.npy``    sequential 0..N-1 — the reference
      saves these counters, not the NN indices (``fbb.py:162,171``; the
      neg file even reuses ``len(pos_loss)``), with the TRUE indices saved
      as ``pos_nn_idx.npy``/``neg_nn_idx.npy``;
  closest-pair PNGs for the first 20 queries (``fbb.py:91-106``);
  ``params.txt``/``params.pkl``, ``metrics.jsonl``.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace

import numpy as np
import torch

from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.io.artifacts import (check_folder, dump_params,
                                             save_files)
from ganleaks_tpu_torch.io.images import to_uint8
from ganleaks_tpu_torch.io.native import encode_png
from ganleaks_tpu_torch.io.stream import HostImageSet
from ganleaks_tpu_torch.ops.distance import (make_embed_fn,
                                             make_embed_parts_fn)
from ganleaks_tpu_torch.ops.knn import (PARTS_ENGINES, PhaseTimer,
                                        _part_bounds_for,
                                        knn_argmin_streamed,
                                        knn_argmin_streamed_parts,
                                        knn_argmin_two_pass,
                                        stream_need_bytes,
                                        truncate_to_batches)
from ganleaks_tpu_torch.ops.stream_plan import (GIB, device_capacity,
                                                sets_fit)
from ganleaks_tpu_torch.parallel import multihost
from ganleaks_tpu_torch.parallel.mesh import Mesh
from ganleaks_tpu_torch.utils.logging import MetricsLogger, Throughput
from ganleaks_tpu_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r} is not supported; expected one of "
                         f"{sorted(_DTYPES)}") from None


def resolve_save_dir(cfg: AttackConfig) -> str:
    """``check_args`` save-dir layout (``fbb.py:42-67``)."""
    if cfg.params is not None and cfg.hyperparameter_search:
        subdir = cfg.syn_data_path.rstrip("/")
        exp_name = cfg.exp_name + "__" + subdir.split("/")[-2]
        save_dir = os.path.join(os.getcwd(), cfg.save_root, exp_name,
                                cfg.params)
    else:
        save_dir = os.path.join(os.getcwd(), cfg.save_root, cfg.exp_name)
    return check_folder(save_dir)


def build_embed_fn(cfg: AttackConfig, device: torch.device | str = "cpu",
                   structured: bool = False):
    """Featuriser for the configured distance — flat, or a list of parts
    with ``structured`` (the taps engines) — its LPIPS weights on
    ``device`` (``cfg.lpips_weights`` npz, else the seeded surrogate
    backbone with the real lin heads)."""
    dtype = _torch_dtype(cfg.dtype)
    maker = make_embed_parts_fn if structured else make_embed_fn
    if cfg.distance == "l2":
        return maker("l2", dtype=dtype)
    if cfg.distance != "l2-lpips":
        raise ValueError(f"unknown distance {cfg.distance!r}; "
                         "expected 'l2' or 'l2-lpips'")
    from ganleaks_tpu_torch.ops.lpips import (default_lpips_params,
                                              load_lpips_params,
                                              lpips_embed_fn,
                                              lpips_embed_parts_fn)
    if cfg.lpips_weights:
        model = load_lpips_params(cfg.lpips_weights)
    else:
        model = default_lpips_params(cfg.lpips_net)
    model = model.to(device).eval()
    cdt = _torch_dtype(cfg.lpips_compute_dtype) \
        if cfg.lpips_compute_dtype else None
    lp_maker = lpips_embed_parts_fn if structured else lpips_embed_fn
    return maker(
        "l2-lpips",
        lp_maker(model, weight=0.2, dtype=dtype, compute_dtype=cdt),
        dtype=dtype)


def resolve_auto_engine(cfg: AttackConfig,
                        device: torch.device | str = "cpu") -> AttackConfig:
    """``engine='auto'``: on CUDA the JAX package's accelerator recipe —
    taps-int8 parts with a bf16 tower (``dtype='bfloat16'``,
    ``lpips_compute_dtype`` defaulting to 'bfloat16'; add
    ``two_pass=True`` for certified-exact indices) — degraded to the bf16
    'taps' recipe where the int8 products could wrap their int32
    accumulator at this input shape (``ops/knn._part_bounds_for`` on one
    image; an explicit 'taps-int8' still raises there). Elsewhere the
    reference-parity float32 gemm fold. Other engines pass through. The
    check needs only shapes and the lin heads, so it runs on the CPU (in
    the span ``fbb.resolve_engine``)."""
    if cfg.engine != "auto":
        return cfg
    if torch.device(device).type != "cuda":
        return replace(cfg, engine="gemm")
    cfg = replace(cfg, engine="taps-int8", dtype="bfloat16",
                  lpips_compute_dtype=cfg.lpips_compute_dtype or "bfloat16")
    probe = np.zeros((1, cfg.resolution, cfg.resolution, 3),
                     np.uint8 if cfg.uint8_storage else np.float32)
    with span("fbb.resolve_engine"):
        try:
            _part_bounds_for(build_embed_fn(cfg, "cpu", structured=True),
                             probe)
        except ValueError:
            cfg = replace(cfg, engine="taps")
    return cfg


def _check_layout(cfg: AttackConfig, mesh: Mesh | None) -> None:
    """Refuse a layout name that does not exist, and two-pass on the ring
    (silently dropping either flag would betray the config)."""
    if cfg.shard_layout not in ("sharded", "ring"):
        raise ValueError(f"shard_layout must be 'sharded' or 'ring', "
                         f"got {cfg.shard_layout!r}")
    if mesh is not None and cfg.shard_layout == "ring" and cfg.two_pass:
        raise ValueError("two_pass + shard_layout='ring' is not supported; "
                         "use shard_layout='sharded'")


def _embeds(cfg: AttackConfig, device: torch.device, structured: bool,
            sweep_cache: dict | None) -> tuple:
    """(embed, embed_lo, embed_hi): the featurisers the configured search
    reads — ``embed`` flat or parts, or the two-pass pair — built once per
    sweep when ``sweep_cache`` holds them under the same configuration. A
    new featuriser drops every held query cache: the reuse fingerprints
    hash the raw query images, not their embeddings."""
    key = (cfg.engine, cfg.dtype, cfg.lpips_compute_dtype, cfg.two_pass,
           cfg.distance, cfg.lpips_net, cfg.lpips_weights, str(device))
    if sweep_cache is not None and sweep_cache.get("embed_key") == key:
        return sweep_cache["embeds"]
    embed = embed_lo = embed_hi = None
    if cfg.two_pass:
        # pass 1 on the bf16 tower and bf16 (or int8) embeddings, the
        # re-rank and the certificate fallback on the float32 ones
        embed_lo = build_embed_fn(
            replace(cfg, dtype="bfloat16", lpips_compute_dtype="bfloat16"),
            device, structured=structured)
        embed_hi = build_embed_fn(
            replace(cfg, dtype="float32", lpips_compute_dtype=None), device)
    else:
        embed = build_embed_fn(cfg, device, structured=structured)
    if sweep_cache is not None:
        for k in ("query_reuse", "query_reuse_lo", "query_reuse_hi"):
            sweep_cache.pop(k, None)
        sweep_cache.update(embed_key=key,
                           embeds=(embed, embed_lo, embed_hi))
    return embed, embed_lo, embed_hi


def _host_stream(cfg: AttackConfig, mesh: Mesh | None = None
                 ) -> bool | None:
    """``cfg.host_stream`` as True, False or None ('auto'). On a mesh
    (``n_chips > 1`` or ``multihost``) 'auto' is False — each rank copies
    the arrays to its device once, as the JAX package's mesh places them
    — and a pinned True raises (the mesh searches read arrays; dropping
    the pin would betray the config)."""
    on_mesh = mesh is not None or cfg.n_chips > 1 or cfg.multihost
    hs = cfg.host_stream
    if isinstance(hs, str):
        if hs.strip().lower() != "auto":
            raise ValueError(f"host_stream must be true/false/'auto', "
                             f"got {hs!r}")
        return False if on_mesh else None
    if hs and on_mesh:
        raise ValueError("host_stream=true is single-device only (the mesh "
                         "searches read arrays); use host_stream='auto' or "
                         "n_chips=1")
    return bool(hs)


def _stage_sets(cfg: AttackConfig, embed, queries: np.ndarray,
                syn, device: torch.device, mesh: Mesh | None = None
                ) -> tuple:
    """``(queries, syn, on_device)``: the image sets where the search reads
    them. On the card they are copied once when ``host_stream`` is False,
    or when it is 'auto' and they fit beside what the search plans
    (``ops/knn.stream_need_bytes``: one sweep's query cache, or the
    requested one without the planner); otherwise (``host_stream`` True,
    or 'auto' where they do not fit) they stay in host memory and the
    search ships one block at a time. A :class:`HostImageSet` (decoded
    block by block as the search reads it) always stays in host memory.
    On the CPU the arrays themselves."""
    hs = _host_stream(cfg, mesh)
    if device.type != "cuda" or hs or isinstance(syn, HostImageSet):
        return queries, syn, False
    if hs is None:
        need = stream_need_bytes(
            embed, queries, engine=cfg.engine, q_block=cfg.query_block,
            s_block=cfg.syn_block,
            query_cache_bytes=int(cfg.query_cache_gb * GIB),
            auto_plan=cfg.auto_plan, device=device)
        sets, cap = queries.nbytes + syn.nbytes, device_capacity(device)
        if not sets_fit(sets, need, cap):
            print(f"[fbb] the image sets ({sets / GIB:.2f} GiB) do not fit "
                  f"beside the search's {need / GIB:.2f} GiB (of "
                  f"{cap / GIB:.2f}): streaming blocks from host memory")
            return queries, syn, False
    return (torch.from_numpy(np.ascontiguousarray(queries)).to(device),
            torch.from_numpy(np.ascontiguousarray(syn)).to(device), True)


def attack_arrays(cfg: AttackConfig, syn, pos, neg,
                  device: torch.device | str | None = None,
                  logger: MetricsLogger | None = None,
                  sweep_cache: dict | None = None,
                  mesh: Mesh | None = None) -> dict:
    """Run the attack on NHWC image arrays (uint8 bytes or [-1, 1] floats;
    ``syn`` may be a :class:`HostImageSet`, decoded as the search reads
    it). Returns losses and true NN indices for both query
    sets, the query-pair rate, the device seconds spent featurising and
    folding, the host seconds of the set-up (``lpips_init_s``: building
    the featurisers; ``host_copy_s``: joining the query sets and, where
    they fit, copying both sets to the device once, ``sets_on_device``;
    :func:`_stage_sets`), the search's OOM resumes and its plan (with
    ``two_pass`` also the number of certificate fallbacks), and its
    ``counters``: ``query_rows_featurised`` and ``query_rows_reused``
    (query rows featurised into a search's cache, and served by a held
    one, summed over the call's searches: the two-pass mode's pass 1,
    re-rank and fallback each hold their own) and, with ``two_pass``,
    ``rerank_candidates`` (the size of the re-rank's candidate union).
    The logged record carries the same.

    Both query sets go through ONE synthetic sweep (concatenated on the
    query axis, split after): featurising the generated set dominates and
    would otherwise run twice (``fbb.py:156-171``).

    ``sweep_cache`` (a dict ``run_attack`` passes to every subdir of a
    hyperparameter search, ``fbb.py:113-123``) carries what the subdirs
    share: the featurisers and the featurised query caches
    (``ops/knn`` ``query_reuse``; separate holders for the two-pass pass
    1 and re-rank). The caller passes the same pos/neg every call; the
    searches check shapes and a content fingerprint.

    ``mesh`` (``parallel/mesh.Mesh``, every rank calling with the same
    arrays): the search runs on the mesh's ranks, on this rank's device,
    in ``cfg.shard_layout`` (``parallel/knn_shard``); every rank returns
    the whole result.

    The call is the span ``fbb.attack_arrays`` (``utils/profiling.span``);
    inside it ``fbb.resolve_engine``, ``fbb.embeds`` (what
    ``lpips_init_s`` times), ``fbb.stage_sets`` (``host_copy_s``), the
    search's spans (``ops/knn``) and ``fbb.readback``, the wait for the
    results."""
    with span("fbb.attack_arrays"):
        return _attack_arrays(cfg, syn, pos, neg, device, logger,
                              sweep_cache, mesh)


def _attack_arrays(cfg: AttackConfig, syn, pos, neg, device, logger,
                   sweep_cache: dict | None, mesh: Mesh | None) -> dict:
    """:func:`attack_arrays`."""
    device = resolve_device(device)
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"the mesh is on {mesh.device}, the attack on "
                             f"{device}")
        device = mesh.device
    logger = logger or MetricsLogger(echo=False)
    if cfg.engine == "auto":
        cfg = resolve_auto_engine(cfg, device)
        logger.log({"engine_resolved": cfg.engine, "dtype": cfg.dtype})
    _check_layout(cfg, mesh)
    structured = cfg.engine in PARTS_ENGINES

    if cfg.drop_remainder:  # strict parity with fbb.py:77
        n_keep = truncate_to_batches(len(syn), cfg.BATCH_SIZE)
        syn = (syn.limit(n_keep) if isinstance(syn, HostImageSet)
               else syn[:n_keep])

    meter = Throughput()
    timer = PhaseTimer(device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    with span("fbb.embeds"):
        embed, embed_lo, embed_hi = _embeds(cfg, device, structured,
                                            sweep_cache)
        sync()
    t1 = time.perf_counter()
    n_q = len(pos) + len(neg)
    with span("fbb.stage_sets"):
        queries, syn_d, on_device = _stage_sets(
            cfg, embed or embed_lo,
            np.concatenate([np.asarray(pos), np.asarray(neg)], axis=0),
            syn if isinstance(syn, HostImageSet) else np.asarray(syn),
            device, mesh)
        sync()
    t2 = time.perf_counter()
    holder = (lambda name: None if sweep_cache is None
              else sweep_cache.setdefault(name, {}))
    info: dict = {}
    common = dict(q_block=cfg.query_block, s_block=cfg.syn_block,
                  query_cache_bytes=int(cfg.query_cache_gb * (1 << 30)),
                  timer=timer, auto_plan=cfg.auto_plan, info=info)
    n_fallback = None
    stats0 = dict(mesh.stats) if mesh is not None else None
    if mesh is not None:
        from ganleaks_tpu_torch.parallel import knn_shard
        if cfg.shard_layout == "ring":
            d, i = knn_shard.knn_argmin_ring_streamed(
                embed, queries, syn_d, mesh, engine=cfg.engine,
                query_reuse=holder("query_reuse"), **common)
        elif cfg.two_pass:
            d, i, _cert, n_fallback = knn_shard.knn_argmin_two_pass_mesh(
                embed_lo, embed_hi, queries, syn_d, mesh,
                k=cfg.two_pass_k, engine=cfg.engine, return_cert=True,
                query_reuse=holder("query_reuse_lo"),
                rerank_reuse=holder("query_reuse_hi"), **common)
        else:
            d, i = knn_shard.knn_argmin_sharded_streamed(
                embed, queries, syn_d, mesh, engine=cfg.engine,
                query_reuse=holder("query_reuse"), **common)
    elif cfg.two_pass:
        d, i, _cert, n_fallback = knn_argmin_two_pass(
            embed_lo, embed_hi, queries, syn_d, k=cfg.two_pass_k,
            engine=cfg.engine, return_cert=True,
            query_reuse=holder("query_reuse_lo"),
            rerank_reuse=holder("query_reuse_hi"), device=device, **common)
    elif structured:
        d, i = knn_argmin_streamed_parts(
            embed, queries, syn_d, quantize=cfg.engine == "taps-int8",
            query_reuse=holder("query_reuse"), device=device, **common)
    else:
        d, i = knn_argmin_streamed(embed, queries, syn_d, engine=cfg.engine,
                                   query_reuse=holder("query_reuse"),
                                   device=device, **common)
    with span("fbb.readback"):
        loss = d.cpu().numpy().astype(np.float64)  # waits for the device
        nn = i.cpu().numpy()
        secs = timer.seconds()
    meter.add(n_q * len(syn))
    search = info.get("pass1", info)
    plan = {k: search[k] for k in ("cache_bytes", "s_block", "q_block",
                                   "sweeps", "query_reused")}
    searches = [info[k] for k in ("pass1", "rerank", "fallback")
                if k in info] or [info]
    counters = {k: sum(r[k] for r in searches)
                for k in ("query_rows_featurised", "query_rows_reused")}
    if "rerank" in info:
        counters["rerank_candidates"] = info["rerank"]["candidates"]
    # the planner's budget (None on the CPU or with auto_plan off)
    plan["capacity_bytes"] = search.get("capacity_bytes")
    n_pos = len(pos)
    out = {"pos_loss": loss[:n_pos], "pos_nn_idx": nn[:n_pos],
           "neg_loss": loss[n_pos:], "neg_nn_idx": nn[n_pos:],
           "query_pairs_per_sec": meter.rate(),
           "featurize_s": secs.get("featurize", 0.0),
           "fold_s": secs.get("fold", 0.0),
           "lpips_init_s": t1 - t0, "host_copy_s": t2 - t1,
           "oom_resumes": info["oom_resumes"], "plan": plan,
           "sets_on_device": on_device, "counters": counters}
    record = {k: out[k] for k in ("query_pairs_per_sec", "featurize_s",
                                  "fold_s", "lpips_init_s", "host_copy_s",
                                  "oom_resumes", "sets_on_device",
                                  "counters")}
    record.update(plan=plan, n_syn=len(syn), n_pos=n_pos, n_neg=len(neg),
                  engine=cfg.engine, device=str(device))
    if mesh is not None:
        out["ranks"] = record["ranks"] = {
            "size": mesh.size, "layout": cfg.shard_layout,
            "backend": mesh.backend,
            **{k: v - stats0[k] for k, v in mesh.stats.items()}}
    if n_fallback is not None:
        out["two_pass_fallbacks"] = record["two_pass_fallbacks"] = n_fallback
    logger.log(record)
    return out


def plot_closest_images(nn_idx: np.ndarray, queries: np.ndarray,
                        syn: np.ndarray, save_dir: str, class_type: str,
                        num: int = 20) -> None:
    """Query|NN side-by-side PNGs (``fbb.py:91-106``) through the port's
    encoder. uint8 input goes through the same float64 scale + floor chain
    as float input, so the pixels are identical either way."""
    num = min(num, len(queries))
    for i in range(num):
        pair = np.concatenate([queries[i], syn[int(nn_idx[i])]], axis=1)
        if pair.dtype == np.uint8:
            pair = (2.0 * (pair.astype(np.float64) / 255.0)
                    - 1.0).astype(np.float32)
        encode_png(to_uint8(pair, drange=(-1, 1)),
                   os.path.join(save_dir, f"{i}{class_type}.png"))


def _load_images(cfg: AttackConfig, path: str, limit: int | None = None,
                 streamable: bool = False):
    """One image set (``fbb.py:133-145``), resolved per path: an npz
    (read as is), or a PNG directory — as a :class:`HostImageSet` for the
    synthetic set (``streamable``) when ``host_stream`` is True, else
    decoded at once behind the disk cache (``io/diskcache``,
    ``decode_cache``). The JAX package's 'auto' streams wherever storage
    is uint8; here 'auto' loads at once and lets ``_stage_sets`` put the
    sets on the card where they fit (ROADMAP C)."""
    from ganleaks_tpu_torch.io.npz import (load_npz_images,
                                           resolve_input_format)

    dt = np.uint8 if cfg.uint8_storage else np.float32
    if resolve_input_format(path, cfg.input_format) == "npz":
        return load_npz_images(path, cfg.resolution, limit=limit, dtype=dt)
    if streamable and _host_stream(cfg):
        return HostImageSet(path, cfg.resolution, limit=limit, dtype=dt,
                            disk_cache=cfg.decode_cache)
    from ganleaks_tpu_torch.io.diskcache import load_image_dir_cached
    return load_image_dir_cached(path, cfg.resolution, limit=limit,
                                 dtype=dt, policy=cfg.decode_cache)


def run_attack(cfg: AttackConfig,
               device: torch.device | str | None = None) -> list[dict]:
    """Full driver, including the hyperparameter-search directory sweep
    (``fbb.py:111-179``): one attack per synthetic subdir, the query sets
    loaded once and, across several subdirs, featurised once
    (``attack_arrays``' ``sweep_cache``). Each result and its
    ``metrics.jsonl`` also carry ``ingest_s``, the seconds spent loading
    that subdir's images (and, for the first, the query sets). Each
    subdir's record carries the call's ``counters``: over a sweep the
    first subdir's show its queries featurised
    (``query_rows_featurised``) and every later one's show them reused
    (``query_rows_reused``).

    ``multihost`` or ``n_chips > 1`` joins the process group first
    (``parallel/multihost.initialize``: the ``GANLEAKS_*`` variables or
    ``torchrun``'s); ``n_chips > 1`` runs the search on the group's mesh
    of that many ranks, one per device (:func:`launch_attack` starts them
    on this host). Every rank runs the same attack on the same data; rank
    0 alone writes the artifacts and the metrics (the other ranks'
    ``save_dir`` is '')."""
    device = resolve_device(device)
    if cfg.multihost or cfg.n_chips > 1:
        multihost.initialize()  # a no-op without a launcher's world
    mesh = multihost.global_mesh(cfg.n_chips, device=device) \
        if cfg.n_chips > 1 else None
    _check_layout(cfg, mesh)
    is_main = multihost.process_index() == 0
    if cfg.hyperparameter_search:
        root = cfg.syn_data_path
        # hidden dirs are caches, never sweep experiments
        subdirs = sorted(
            os.path.join(root, o) for o in os.listdir(root)
            if os.path.isdir(os.path.join(root, o))
            and not o.startswith("."))
    else:
        subdirs = [cfg.syn_data_path]

    results = []
    sweep_cache: dict | None = {} if len(subdirs) > 1 else None
    pos = neg = None
    for subdir in subdirs:
        sub_cfg = replace(
            cfg, syn_data_path=subdir,
            params=(subdir.rstrip("/").split("/")[-1]
                    if cfg.hyperparameter_search else cfg.params))
        # resolve 'auto' before the params dump, so the artifact records
        # the configuration that produced the results
        was_auto = sub_cfg.engine == "auto"
        sub_cfg = resolve_auto_engine(sub_cfg, device)
        save_dir = resolve_save_dir(sub_cfg) if is_main else ""
        if is_main:
            dump_params(save_dir, sub_cfg)
        logger = MetricsLogger(os.path.join(save_dir, "metrics.jsonl")
                               if is_main else None, echo=is_main)
        if was_auto:
            logger.log({"engine_resolved": sub_cfg.engine,
                        "dtype": sub_cfg.dtype})

        t0 = time.perf_counter()
        syn = _load_images(sub_cfg, subdir, streamable=True)
        if pos is None:  # query sets are subdir-invariant: load once
            pos = _load_images(sub_cfg, sub_cfg.pos_data_dir,
                               limit=sub_cfg.data_num)
            neg = _load_images(sub_cfg, sub_cfg.neg_data_dir,
                               limit=sub_cfg.data_num)
        ingest_s = time.perf_counter() - t0
        logger.log({"ingest_s": ingest_s})

        out = attack_arrays(sub_cfg, syn, pos, neg, device=device,
                            logger=logger, sweep_cache=sweep_cache,
                            mesh=mesh)
        out["ingest_s"] = ingest_s
        out["save_dir"] = save_dir
        results.append(out)
        if not is_main:
            logger.close()
            continue

        seq_pos = np.arange(len(out["pos_loss"])).reshape(-1, 1)
        save_files(save_dir,
                   ["pos_loss", "pos_idx", "pos_nn_idx"],
                   [out["pos_loss"].reshape(-1, 1), seq_pos,
                    out["pos_nn_idx"].reshape(-1, 1)])
        # the reference reuses len(pos_loss) for the neg counter (fbb.py:171)
        save_files(save_dir,
                   ["neg_loss", "neg_idx", "neg_nn_idx"],
                   [out["neg_loss"].reshape(-1, 1), seq_pos,
                    out["neg_nn_idx"].reshape(-1, 1)])
        if sub_cfg.save_plots:
            plot_closest_images(out["pos_nn_idx"], pos, syn, save_dir, "pos")
            plot_closest_images(out["neg_nn_idx"], neg, syn, save_dir, "neg")
        logger.close()
    return results


def launch_attack(cfg: AttackConfig,
                  device: torch.device | str | None = None,
                  timeout_s: float = multihost.DEFAULT_TIMEOUT_S
                  ) -> list[dict]:
    """:func:`run_attack` on ``cfg.n_chips`` processes of this host, one
    per device (``parallel/multihost.launch``): on the card NCCL over
    ``cuda:0..n-1`` (refused where fewer cards are visible), on the CPU
    ``gloo``. Returns rank 0's results."""
    device = resolve_device(device)
    return multihost.launch(
        run_attack, cfg.n_chips, cfg, device.type,
        devices=multihost.local_devices(cfg.n_chips, device),
        timeout_s=timeout_s)
