"""Expert-parallel privGAN: one (generator, discriminator) split per rank
(port of ``ganleaks_tpu.parallel.ep``).

``train/priv``'s all-splits steps loop over the splits on one device;
here rank r of the mesh holds split r's generator and discriminator
(critic) and a replica of the shared private classifier. Per-split
computations stay on their rank; only the classifier crosses ranks, its
gradients (and, for privDCGAN, its BatchNorm running statistics)
averaged over the ranks (``pmean``), so its replicas stay equal.

The semantics are the JAX EP step's, not the all-splits step's:

* the draws are global-shaped — noise ``(S, B, nz)``, eps ``(S, B, 1, 1,
  1)``, the target labels ``(S, B)``, in the all-splits step's order from
  the same generator — and each rank takes its split's slice, so with the
  classifier's gate off the EP step computes the all-splits step;
* with the gate on, the classifier normalises each rank's B fakes with
  that rank's statistics: privDCGAN's BatchNorm and privPGGAN's minibatch
  std see B rows where the all-splits step puts all S * B fakes through
  one batch (``ganleaks_tpu/parallel/ep.py:12-20``; ROADMAP queue C).
  The loss, its gradient and the running statistics are the means over
  the ranks.

The port's statistics discipline holds: each generator runs forward
twice a step (its BatchNorm statistics advance twice), and the
classifier's train-mode forwards in the generator step run on copies of
its buffers.
"""

from __future__ import annotations

import torch

from ganleaks_tpu_torch.parallel.dp import reduce_gradients
from ganleaks_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                              replicate)
from ganleaks_tpu_torch.train.gan import bce_with_logits
from ganleaks_tpu_torch.train.pggan import gradient_penalty_fn
from ganleaks_tpu_torch.train.priv import (PrivGANState, _alpha,
                                           _other_split_labels,
                                           _running_stats_kept, _update,
                                           privgan_state,
                                           softmax_cross_entropy_on_probs)


def shard_split_state(state: PrivGANState, mesh: Mesh) -> PrivGANState:
    """Rank r's part of an all-splits ``state`` (one split per rank): split
    r's generator and discriminator, the classifier replicated from rank
    0, each with a fresh Adam of the state's hyperparameters."""
    if len(state.genS) != mesh.size:
        raise ValueError(f"{len(state.genS)} splits on {mesh.size} ranks: "
                         f"expert parallelism takes one split per rank")
    group = state.opt_gen.param_groups[0]
    p = next(state.priv.parameters())
    out = privgan_state([state.genS[mesh.rank]], [state.discS[mesh.rank]],
                        state.priv, group["lr"], *group["betas"], p.device,
                        p.dtype)
    replicate(out.priv, mesh)
    return out


def _check(mesh: Mesh, n_splits: int) -> None:
    if mesh.size != n_splits:
        raise ValueError(f"{n_splits} splits on a mesh of {mesh.size}: "
                         f"one split per rank")


def _priv_update(state: PrivGANState, mesh: Mesh, logits: torch.Tensor
                 ) -> torch.Tensor:
    """The classifier's update on this rank's fakes, labelled by this
    rank's split: its gradient averaged over the ranks (one flattened
    all-reduce), then its BatchNorm running statistics (one more, where
    it has any). Returns this rank's loss."""
    labels = torch.full((logits.shape[0],), mesh.rank, dtype=torch.long,
                        device=logits.device)
    loss = softmax_cross_entropy_on_probs(logits, labels)
    state.opt_priv.zero_grad(set_to_none=True)
    loss.backward()
    reduce_gradients(state.priv.parameters(), mesh, 1.0 / mesh.size)
    state.opt_priv.step()
    bufs = [b for b in state.priv.buffers() if b.is_floating_point()]
    if bufs:
        flat = all_reduce_sum(torch.cat([b.reshape(-1) for b in bufs]),
                              mesh) / mesh.size
        at = 0
        for b in bufs:
            b.copy_(flat[at:at + b.numel()].view_as(b))
            at += b.numel()
    return loss.detach()


def _mean_metrics(mesh: Mesh, names, losses) -> dict:
    """Each loss's mean over the ranks (one all-reduce)."""
    total = all_reduce_sum(torch.stack([x.detach().float()
                                        for x in losses]), mesh)
    return dict(zip(names, (total / mesh.size).unbind()))


def make_ep_privdcgan_step(mesh: Mesh, n_splits: int, privacy_ratio: float,
                           dp_on: bool):
    """The EP privDCGAN step on ``mesh`` (one split per rank,
    ``n_splits`` ranks): ``step(state, real, noise=None, gen_y=None,
    generator=None)`` on a :func:`shard_split_state` state and the global
    ``real`` (S, B, C, H, W); ``noise`` (S, B, nz) and ``gen_y`` (S, B)
    default to draws from ``generator`` (noise, then labels). Returns
    ``loss_d``, ``loss_dp`` (0 with the gate off) and ``loss_g``, each the
    mean over the splits, on every rank."""
    _check(mesh, n_splits)

    def step(state: PrivGANState, real: torch.Tensor,
             noise: torch.Tensor | None = None,
             gen_y: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> dict:
        gen, disc = state.genS[0], state.discS[0]
        batch, dev, r = real.shape[1], real.device, mesh.rank
        if noise is None:
            noise = torch.randn(n_splits, batch, gen.nz, generator=generator,
                                device=dev, dtype=real.dtype)
        if gen_y is None:
            gen_y = _other_split_labels(n_splits, batch, dev, generator)
        z, y = noise[r].to(dev), gen_y[r].to(dev)

        fake = gen(z).detach()
        loss_d = (bce_with_logits(disc(real[r]), 1.0)
                  + bce_with_logits(disc(fake), 0.0)) / 2.0
        _update(state.opt_disc, loss_d)

        loss_dp = (_priv_update(state, mesh, state.priv(fake)) if dp_on
                   else torch.zeros((), device=dev, dtype=real.dtype))

        priv = _running_stats_kept(state.priv)
        fake = gen(z)
        loss_g = (bce_with_logits(disc(fake), 1.0) + privacy_ratio
                  * softmax_cross_entropy_on_probs(priv(fake), y))
        _update(state.opt_gen, loss_g, list(gen.parameters()))
        state.step += 1
        return _mean_metrics(mesh, ("loss_d", "loss_dp", "loss_g"),
                             (loss_d, loss_dp, loss_g))

    return step


def make_ep_privpggan_step(mesh: Mesh, n_splits: int, privacy_ratio: float,
                           dp_on: bool, steps: int, lambda_gp: float = 10.0,
                           drift: float = 0.001):
    """The EP privPGGAN step at resolution ``steps`` (the same layout as
    :func:`make_ep_privdcgan_step`): ``step(state, real, alpha, noise=None,
    eps=None, gen_y=None, generator=None)`` on the global ``real`` (S, B,
    C, H, W) in its dtype; ``noise`` (S, B, nz), ``eps`` (S, B, 1, 1, 1)
    and ``gen_y`` (S, B) default to draws from ``generator`` (noise, eps,
    labels). Returns ``loss_critic``, ``loss_dp`` and ``loss_gen``, means
    over the splits."""
    _check(mesh, n_splits)

    def step(state: PrivGANState, real: torch.Tensor, alpha,
             noise: torch.Tensor | None = None,
             eps: torch.Tensor | None = None,
             gen_y: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> dict:
        gen, critic = state.genS[0], state.discS[0]
        batch, dev, dt, r = real.shape[1], real.device, real.dtype, mesh.rank
        if noise is None:
            noise = torch.randn(n_splits, batch, gen.nz, generator=generator,
                                device=dev, dtype=dt)
        if eps is None:
            eps = torch.rand(n_splits, batch, 1, 1, 1, generator=generator,
                             device=dev, dtype=dt)
        if gen_y is None:
            gen_y = _other_split_labels(n_splits, batch, dev, generator)
        z, e, y = noise[r].to(dev), eps[r].to(dev), gen_y[r].to(dev)
        a, real_r = _alpha(alpha, real), real[r]

        fake = gen(z, steps, a)
        fixed = fake.detach()
        c_real = critic(real_r, steps, a)
        gp = gradient_penalty_fn(critic, real_r, fixed, e, steps, a)
        loss_c = (-(c_real.mean() - critic(fixed, steps, a).mean())
                  + lambda_gp * gp + drift * c_real.square().mean())
        _update(state.opt_disc, loss_c)

        loss_dp = (_priv_update(state, mesh, state.priv(fixed, steps, a))
                   if dp_on else torch.zeros((), device=dev, dtype=dt))

        loss_g = (-critic(fake, steps, a).mean() + privacy_ratio
                  * softmax_cross_entropy_on_probs(
                      state.priv(fake, steps, a), y))
        _update(state.opt_gen, loss_g, list(gen.parameters()))
        state.step += 1
        return _mean_metrics(mesh, ("loss_critic", "loss_dp", "loss_gen"),
                             (loss_c, loss_dp, loss_g))

    return step
