"""The port's multi-device dry run (the attack's half of the JAX package's
``__graft_entry__.dryrun_multichip``): the sharded and the ring kNN on
``n`` ranks at tiny shapes, one process per rank, their indices asserted
equal to each other and to the single-process search.

    python -m ganleaks_tpu_torch.dryrun --n 2 --device cpu

Off the card the ranks are ``n`` ``gloo`` processes on the CPU. On the
card each rank takes ``cuda:r`` where there are ``n`` cards (NCCL); with
fewer, ranks share cards over ``gloo``. The training parts of the JAX dry
run (the data-parallel step, expert-parallel privGAN) come with the
trainers' multi-GPU slice.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ganleaks_tpu_torch.device import resolve_device

SEED = 0


def _dryrun_body() -> dict:
    """One rank: the resident-shard and the streamed searches of both
    layouts ('gemm'; the streamed ones also 'pallas': K1 on the card)."""
    from ganleaks_tpu_torch.ops.distance import make_embed_fn
    from ganleaks_tpu_torch.ops.knn import knn_argmin_streamed
    from ganleaks_tpu_torch.parallel import knn_shard
    from ganleaks_tpu_torch.parallel.multihost import global_mesh

    mesh = global_mesh()
    n = mesh.size
    rng = np.random.default_rng(SEED)
    syn = rng.standard_normal((4 * n, 8, 8, 3)).astype(np.float32)
    queries = rng.standard_normal((2 * n, 8, 8, 3)).astype(np.float32)
    embed = make_embed_fn("l2")
    _, want = knn_argmin_streamed(embed, queries, syn, q_block=2, s_block=2,
                                  device=mesh.device)
    got = {
        "sharded": knn_shard.knn_argmin_sharded(
            embed, queries, syn, mesh, q_block=2, s_block=2)[1],
        "ring": knn_shard.knn_argmin_ring(
            embed, queries, syn, mesh, q_block=2, s_block=2)[1]}
    for engine in ("gemm", "pallas"):
        got[f"sharded_streamed_{engine}"] = \
            knn_shard.knn_argmin_sharded_streamed(
                embed, queries, syn, mesh, engine=engine, q_block=2,
                s_block=2)[1]
        got[f"ring_streamed_{engine}"] = knn_shard.knn_argmin_ring_streamed(
            embed, queries, syn, mesh, engine=engine, q_block=2,
            s_block=2)[1]
    for name, idx in got.items():
        if not torch.equal(idx, want):
            raise AssertionError(f"dryrun: {name} indices {idx.tolist()} "
                                 f"!= single-process {want.tolist()}")
    return {"ranks": n, "backend": mesh.backend, "device": str(mesh.device),
            "indices": want.cpu().tolist(), "layouts": sorted(got)}


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     timeout_s: float = 600.0) -> dict:
    """Run the dry run on ``n_devices`` ranks
    (``parallel/multihost.launch``); raises if a rank fails or the indices
    differ. Returns rank 0's record."""
    from ganleaks_tpu_torch.parallel.multihost import launch

    dev = resolve_device(device)
    backend = "gloo"
    devices: list[str] | str = "cpu"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [f"cuda:{r % cards}" for r in range(n_devices)]
        backend = "nccl" if n_devices <= cards else "gloo"
    out = launch(_dryrun_body, n_devices, devices=devices, backend=backend,
                 timeout_s=timeout_s)
    print(f"dryrun_multichip ok on {n_devices} {dev.type} ranks "
          f"({out['backend']})")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
