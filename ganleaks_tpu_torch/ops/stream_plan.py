"""Device-memory planner of the streamed nearest-neighbour search
(``ops/knn._stream_search``): the port of the JAX package's
``_auto_stream_plan`` (``ganleaks_tpu/ops/knn.py:351-505``) with its
policy and return contract, ``(cache_bytes, s_block, q_block)``, and a
budget read from the card instead of the TPU's calibration.

The search caches every query row's embedding (``row_bytes``) on the
device in chunks of ``cache_bytes`` and featurises the whole synthetic set
once per chunk, so each extra chunk costs a full sweep of the tower. The
planner charges, per plan:

* the query cache and its float32 norms, ``rows * (row_bytes + 4)``;
* the fold state, ``rows * state_bytes_per_row``, and the fold's
  temporaries, ``rows * s_block * fold_bytes_per_pair`` (a float32
  distance block per int8 or gemm fold; nothing for the fused kernels);
* ``STREAM_BLOCKS`` in-flight blocks of embeddings,
  ``max(q_block, s_block) * row_bytes`` each;
* the tower's peak activation bytes per featurised row
  (:func:`activation_bytes_per_row`) times ``max(q_block, s_block)``;
* for a fused fold (``fused_fold``) whose rows are not 16-byte multiples,
  the zero-padded copies K1 / K3's wrapper makes of its inputs
  (``ops/knn_fused.pad_k``): the fold hands the kernel the whole cached
  chunk and one synthetic block, so ``(rows + s_block) *
  padded_row_bytes`` (:func:`pad_copy_bytes`). Rows of 16-byte multiples
  (VGG16, AlexNet and SqueezeNet parts, 64-px pixels) are passed as they
  are and charge nothing.

Policy, in order:
  1. cache every query row (one synthetic sweep) if that fits at
     ``s_block``, ``s_block/2``, ... (floor ``S_BLOCK_FLOOR``);
  2. otherwise shrink ``s_block`` first, then cap the requested cache so
     the plan fits (more sweeps);
  3. where one ``q_block`` of rows does not fit either (wide rows), shrink
     the blocks themselves (floor ``BLOCK_FLOOR`` rows each).

The budget (:func:`device_capacity`) is what the card can still hand out:
``torch.cuda.mem_get_info``'s free bytes plus what the caching allocator
holds but has not handed out, less ``margin_bytes``. Device-resident
inputs are already allocated, so they are never charged twice. The
planner is inert on the CPU (no capacity) unless the caller passes
``capacity_bytes`` — the tests do; ``AttackConfig.auto_plan=False`` keeps
fixed configurations for experiments.
"""

from __future__ import annotations

import torch

GIB = 1 << 30

# Peak bytes the featurisation of one block allocates per image row at
# 64x64x3, beyond the input block and the embeddings it returns: dequant,
# the tower's activations, cuDNN's workspaces and the tap epilogue's
# temporaries. The largest over blocks of 256-8,192 rows, over the flat and
# the parts featurisers and over 32, 64 and 128 px scaled to 64 px — the
# flat featuriser's concatenation and cuDNN's float32 workspaces at some
# shapes set most entries, so the parts engines are charged up to 2.5x
# what they use. `torch.cuda.max_memory_allocated` around one block
# (`python -m ganleaks_tpu_torch.tools.measure_stream_memory`) on one
# NVIDIA H100 80GB HBM3 at 700 W, torch 2.11.0+cu128; the tool's last line
# printed this table and FOLD_BYTES_PER_PAIR on that card.
# Keys: (LPIPS net, or None for the pixel-only 'l2' distance; tower dtype).
ACT_BYTES_PER_ROW_64 = {
    (None, "float32"): 196_608,
    ("vgg", "float32"): 9_699_328,
    ("vgg", "bfloat16"): 4_128_768,
    ("alex", "float32"): 3_801_088,
    ("alex", "bfloat16"): 458_752,
    ("squeeze", "float32"): 1_114_112,
    ("squeeze", "bfloat16"): 1_179_648,
    ("resnet", "float32"): 1_900_544,
    ("resnet", "bfloat16"): 917_504,
}
_ACT_RES = 64

# Temporaries of one fold per (query row x synthetic row) pair, rounded up
# to whole bytes; same tool, card and run, 4,096 cached rows x 2,048
# synthetic rows of VGG16's parts: the int8 parts fold and the gemm fold
# build float32 distance blocks, the top-k folds a sorted merge of the
# running list with the block, the fused kernels (K1, K3) only their
# per-row outputs.
FOLD_BYTES_PER_PAIR = {
    "fused": 1,
    "gemm": 16,
    "int8": 20,
    "topk_fused": 1,
    "topk_gemm": 29,
    "topk_int8": 29,
}

STREAM_BLOCKS = 2     # an embedding block being folded, the next one written
S_BLOCK_FLOOR = 512   # policy steps 1-2 never shrink s_block below this
BLOCK_FLOOR = 64      # step 3 never shrinks a block below this


def activation_bytes_per_row(tower, sample_shape) -> int:
    """The featuriser's peak bytes per row at ``sample_shape`` (H, W, C):
    the measured 64x64 charge of ``tower`` = (net or None, tower dtype),
    scaled by the pixel count (the activations of every layer scale with
    H*W). An unmeasured net or dtype takes the largest charge in the
    table."""
    h, w = int(sample_shape[0]), int(sample_shape[1])
    net, dtype = tower if tower is not None else (None, "float32")
    key = (net, str(dtype).replace("torch.", ""))
    per_row = ACT_BYTES_PER_ROW_64.get(key,
                                       max(ACT_BYTES_PER_ROW_64.values()))
    return -(-per_row * h * w // (_ACT_RES * _ACT_RES))


def margin_bytes(available: int) -> int:
    """Head room kept out of the plan: 1 GiB for what the CUDA context
    creates lazily during the search (cuBLAS and cuDNN handles and their
    first workspaces), plus 5% of the available bytes for the caching
    allocator's rounding and fragmentation."""
    return GIB + available // 20


def device_capacity(device: torch.device) -> int | None:
    """Bytes the search may still allocate on ``device``: free bytes plus
    those the caching allocator has reserved but not handed out, less
    :func:`margin_bytes`; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    available = free + (torch.cuda.memory_reserved(device)
                        - torch.cuda.memory_allocated(device))
    return max(0, available - margin_bytes(available))


def pad_copy_bytes(row_bytes: int, fused_fold: bool) -> int:
    """Bytes per row of the zero-padded copy ``knn_fused.pad_k`` makes of
    a fused fold's inputs: the row rounded up to 16 bytes where it is not
    a multiple of 16 (float32 K % 4, bfloat16 K % 8), else 0 (no copy:
    every block then starts on 16 bytes)."""
    if not fused_fold or row_bytes % 16 == 0:
        return 0
    return row_bytes + (-row_bytes) % 16


def _row_cost(row_bytes: int, s_block: int, state_bytes_per_row: int,
              fold_bytes_per_pair: int, pad_bytes: int) -> int:
    """Resident bytes per cached query row at ``s_block``."""
    return (row_bytes + 4 + state_bytes_per_row
            + fold_bytes_per_pair * s_block + pad_bytes)


def _overhead(row_bytes: int, s_block: int, q_block: int,
              act_bytes_per_row: int, pad_bytes: int) -> int:
    """The stream's in-flight blocks, one block's tower activations and
    the synthetic block's padded copy."""
    blk = max(s_block, q_block)
    return (STREAM_BLOCKS * blk * row_bytes + blk * act_bytes_per_row
            + s_block * pad_bytes)


def plan_bytes(rows: int, row_bytes: int, *, s_block: int, q_block: int,
               act_bytes_per_row: int, state_bytes_per_row: int = 8,
               fold_bytes_per_pair: int = 0, fused_fold: bool = False
               ) -> int:
    """Device bytes a plan holds with ``rows`` cached query rows, as
    :func:`plan_stream` charges them."""
    pad = pad_copy_bytes(row_bytes, fused_fold)
    return (rows * _row_cost(row_bytes, s_block, state_bytes_per_row,
                             fold_bytes_per_pair, pad)
            + _overhead(row_bytes, s_block, q_block, act_bytes_per_row, pad))


def plan_stream(n_q: int, row_bytes: int, *, q_block: int, s_block: int,
                cache_bytes: int, act_bytes_per_row: int,
                state_bytes_per_row: int = 8,
                fold_bytes_per_pair: int = 0,
                fused_fold: bool = False,
                capacity_bytes: int | None = None,
                device: torch.device | str | None = None,
                credit_bytes: int = 0) -> tuple[int, int, int]:
    """``(cache_bytes, s_block, q_block)`` for a search of ``n_q`` query
    rows of ``row_bytes`` each (module docstring). ``fused_fold``: the
    fold runs K1 / K3 (charged their padded copies). ``capacity_bytes``: the
    budget; None reads it from ``device`` (:func:`device_capacity`), and
    without a card the request comes back unchanged. ``credit_bytes``:
    memory the search already holds and will use for this plan (a held
    query cache it reuses), added to the budget. Prints one line when it
    changes the request."""
    if capacity_bytes is None:
        capacity_bytes = (device_capacity(device) if device is not None
                          else None)
        if capacity_bytes is None:
            return cache_bytes, s_block, q_block
    capacity_bytes += credit_bytes
    padded = n_q + (-n_q) % q_block
    pad = pad_copy_bytes(row_bytes, fused_fold)

    def cap_for(sb: int, qb: int) -> int:
        """The largest cache (bytes of whole rows) that fits at (sb, qb)."""
        rows = ((capacity_bytes
                 - _overhead(row_bytes, sb, qb, act_bytes_per_row, pad))
                // _row_cost(row_bytes, sb, state_bytes_per_row,
                             fold_bytes_per_pair, pad))
        return max(0, rows) * row_bytes

    need_one = padded * row_bytes
    sb = s_block
    while True:
        if need_one <= cap_for(sb, q_block):
            if need_one > cache_bytes or sb != s_block:
                print(f"[knn] auto plan: one-sweep schedule fits — query "
                      f"cache {need_one / GIB:.2f} GiB (requested "
                      f"{cache_bytes / GIB:.2f})"
                      + (f", s_block {s_block} -> {sb}" if sb != s_block
                         else "")
                      + " (AttackConfig.auto_plan=False for fixed configs)")
            return max(cache_bytes, need_one), sb, q_block
        if sb // 2 < S_BLOCK_FLOOR:
            break
        sb //= 2
    # one sweep is out of reach: fit the REQUESTED cache, shrinking s_block
    # first (an extra chunk costs a whole tower sweep, a smaller stream
    # block almost nothing)
    sb = s_block
    while cache_bytes > cap_for(sb, q_block) and sb // 2 >= S_BLOCK_FLOOR:
        sb //= 2
    qb = q_block
    cap = cap_for(sb, qb)
    while cap < qb * row_bytes and (qb > BLOCK_FLOOR or sb > BLOCK_FLOOR):
        # wide rows: one q_block of cache plus its activations exceeds the
        # budget — shrink the larger block
        if sb >= qb and sb > BLOCK_FLOOR:
            sb //= 2
        else:
            qb //= 2
        cap = cap_for(sb, qb)
    if cache_bytes > cap or qb != q_block:
        cap = max(qb * row_bytes, min(cap, cache_bytes))
        print(f"[knn] auto plan: requested cache {cache_bytes / GIB:.2f} "
              f"GiB cannot fit next to the stream; capping at "
              f"{cap / GIB:.2f} GiB, s_block {s_block} -> {sb}, q_block "
              f"{q_block} -> {qb} (more synthetic sweeps)")
        return cap, sb, qb
    if sb != s_block:
        print(f"[knn] auto plan: s_block {s_block} -> {sb} so the "
              f"{cache_bytes / GIB:.2f} GiB query cache fits")
    return cache_bytes, sb, qb
