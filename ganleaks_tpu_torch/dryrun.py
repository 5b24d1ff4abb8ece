"""The port's multi-device dry run (the JAX package's
``__graft_entry__.dryrun_multichip``): on ``n`` ranks at tiny shapes, one
process per rank,

1. the data-parallel DCGAN step (``parallel/dp``; 16 px, a global batch
   of 2n) against the single-process step on the same batch and draws,
   the replicas bit-identical;
2. and 3. the sharded and the ring kNN, their indices equal to each other
   and to the single-process search;
4. the expert-parallel privDCGAN step (``parallel/ep``; n splits, one a
   rank, the classifier's gate on): finite losses, the shared classifier
   moved and its replicas bit-identical.

    python -m ganleaks_tpu_torch.dryrun --n 2 --device cpu

Off the card the ranks are ``n`` ``gloo`` processes on the CPU. On the
card each rank takes ``cuda:r`` where there are ``n`` cards (NCCL); with
fewer, ranks share cards over ``gloo``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ganleaks_tpu_torch.device import resolve_device

SEED = 0


def _digests(modules) -> list[str]:
    import hashlib
    return [hashlib.sha1(b"".join(v.detach().cpu().numpy().tobytes()
                                  for v in m.state_dict().values()))
            .hexdigest() for m in modules]


def _check_replicas(mesh, modules, what: str) -> None:
    from ganleaks_tpu_torch.parallel.mesh import gather_objects
    ranks = gather_objects(_digests(modules), mesh)
    if any(d != ranks[0] for d in ranks):
        raise AssertionError(f"dryrun: the {what} replicas differ across "
                             f"ranks")


def _dp_step(mesh) -> dict:
    """Part 1: one data-parallel DCGAN step on a global batch of 2n rows
    against the single-process step on the same batch and draws (both on
    this rank): losses within rtol 1e-4, each net's update within 1% of
    the single process's (L2) and every parameter within 2 lr of it (one
    Adam step: rounding can flip the sign of a gradient at its noise
    floor), the replicas bit-identical."""
    from ganleaks_tpu_torch.config import DCGANConfig
    from ganleaks_tpu_torch.parallel.dp import DataParallel
    from ganleaks_tpu_torch.train import dcgan
    from ganleaks_tpu_torch.train.gan import dcgan_train_step

    cfg = DCGANConfig(batch_size=2 * mesh.size, ngf=8, ndf=8, nz=16,
                      image_size=16, seed=SEED)
    dev = mesh.device
    batch = (torch.rand(cfg.batch_size, 3, 16, 16, generator=torch.Generator()
                        .manual_seed(SEED)) * 2 - 1).to(dev)
    ranks, one = dcgan.build_state(cfg, dev), dcgan.build_state(cfg, dev)
    init = [p.detach().clone() for m in (one.gen, one.disc)
            for p in m.parameters()]
    dp = DataParallel(mesh, [ranks.gen, ranks.disc],
                      [ranks.opt_gen, ranks.opt_disc])
    got = dp.metrics(dp.run(dcgan_train_step, ranks, (batch,),
                            generator=torch.Generator(dev).manual_seed(1)))
    dp.close()
    want = dcgan_train_step(one, batch,
                            generator=torch.Generator(dev).manual_seed(1))
    for k, v in want.items():
        if abs(float(got[k]) - float(v)) > 1e-4 * abs(float(v)):
            raise AssertionError(f"dryrun: the data-parallel {k} "
                                 f"{float(got[k])} != one process's "
                                 f"{float(v)}")
    got_p = [p.detach() for m in (ranks.gen, ranks.disc)
             for p in m.parameters()]
    want_p = [p.detach() for m in (one.gen, one.disc)
              for p in m.parameters()]
    diff = max(float((a - b).abs().max()) for a, b in zip(got_p, want_p))
    rel = (sum(float((a - b).square().sum()) for a, b in zip(got_p, want_p))
           / sum(float((b - i).square().sum())
                 for b, i in zip(want_p, init))) ** 0.5
    if diff > 2 * cfg.lr or rel > 1e-2:
        raise AssertionError(f"dryrun: the data-parallel step is "
                             f"{diff / cfg.lr:.3g} lr (update {rel:.3g}, "
                             f"L2) off one process's")
    _check_replicas(mesh, [ranks.gen, ranks.disc], "data-parallel")
    return {"dp_losses": {k: float(v) for k, v in got.items()},
            "dp_max_param_diff_lr": diff / cfg.lr, "dp_update_rel": rel}


def _ep_step(mesh) -> dict:
    """Part 4: one expert-parallel privDCGAN step, a split per rank, the
    classifier's gate on: finite losses, the classifier moved, its
    replicas bit-identical."""
    from ganleaks_tpu_torch.config import DCGANConfig, PrivGANConfig
    from ganleaks_tpu_torch.parallel import ep
    from ganleaks_tpu_torch.train import priv

    n, dev = mesh.size, mesh.device
    state = ep.shard_split_state(priv.build_privdcgan_state(
        DCGANConfig(ngf=8, ndf=8, nz=16, image_size=16, seed=SEED + 3),
        PrivGANConfig(N_splits=n), dev), mesh)
    before = [p.detach().clone() for p in state.priv.parameters()]
    real = (torch.rand(n, 2, 3, 16, 16, generator=torch.Generator()
                       .manual_seed(SEED + 4)) * 2 - 1).to(dev)
    step = ep.make_ep_privdcgan_step(mesh, n, 0.5, dp_on=True)
    m = step(state, real, generator=torch.Generator(dev).manual_seed(4))
    losses = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"dryrun: EP privDCGAN losses {losses}")
    if not any(bool((p != b).any()) for p, b in
               zip(state.priv.parameters(), before)):
        raise AssertionError("dryrun: the EP step left the private "
                             "classifier as it was")
    _check_replicas(mesh, [state.priv], "EP private classifier")
    return {"ep_losses": losses}


def _dryrun_body() -> dict:
    """One rank: the data-parallel DCGAN step, the resident-shard and the
    streamed searches of both layouts ('gemm'; the streamed ones also
    'pallas': K1 on the card), the expert-parallel privDCGAN step."""
    from ganleaks_tpu_torch.ops.distance import make_embed_fn
    from ganleaks_tpu_torch.ops.knn import knn_argmin_streamed
    from ganleaks_tpu_torch.parallel import knn_shard
    from ganleaks_tpu_torch.parallel.multihost import global_mesh

    mesh = global_mesh()
    n = mesh.size
    trained = _dp_step(mesh)
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
            "indices": want.cpu().tolist(), "layouts": sorted(got),
            **trained, **_ep_step(mesh)}


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     timeout_s: float = 600.0) -> dict:
    """Run the dry run on ``n_devices`` ranks
    (``parallel/multihost.launch``); raises if a rank fails or a part's
    check does. Returns rank 0's record."""
    from ganleaks_tpu_torch.parallel.multihost import launch, launch_plan

    dev = resolve_device(device)
    devices, backend = launch_plan(n_devices, dev)
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
