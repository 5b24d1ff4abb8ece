"""privGAN victims, privDCGAN and privPGGAN (port of
``ganleaks_tpu.train.priv``; reference ``gan_models/dcgan/privDCGAN.py``,
``gan_models/pggan/privPGGAN.py``).

privGAN trains N (generator, discriminator) pairs on N disjoint splits of
the training set, plus one shared private classifier that learns which
split a fake came from; each generator is also rewarded for making the
classifier name another split (``privDCGAN.py:272-289``).

Layout: one module per split in ``nn.ModuleList``s, the reference's own
layout (``dcgan/model_torch.py:99-119``), looped over inside each step;
the JAX package stacks the splits on a leading axis and ``vmap``s them.
With disjoint parameters and Adam's elementwise update the loop computes
what the ``vmap`` computes. The JAX schedule is kept: every split trains
in each step, and the shared classifier sees all splits at once in each
step (DIVERGENCES.md).

Per privDCGAN step (:func:`privdcgan_train_step`), in order:

* fakes from every generator in train mode (each G's BatchNorm running
  statistics advance once);
* each discriminator on its split's real batch, then on its fakes
  (statistics chain real -> fake), loss ``(BCE(D(real), 1) + BCE(D(fake),
  0)) / 2``, summed over splits;
* with the gate on, the classifier once over all S*B fakes, split-major,
  labels ``repeat(arange(S), B)``: one batch's BatchNorm statistics over
  all splits;
* each generator again on the same noise (its statistics advance a second
  time, as the JAX step keeps them), its discriminator (updated, train
  mode: a third advance) and the classifier on this split's B fakes in
  train mode, whose running statistics do NOT move (the JAX step drops
  that update; here the forward runs on copies of the buffers); loss
  ``BCE(D(fake), 1) + privacy_ratio * CE(softmax(P(fake)), gen_y)``.

privPGGAN (:func:`privpggan_train_step`) is the PGGAN step per split (the
WGAN-GP critic loss with the drift term) with the same classifier update
and privacy term; it has no BatchNorm. It runs in the parameters' dtype
(float32 in training) whatever ``compute_dtype`` says, as the JAX step.

Replicated reference quirks: the private loss is cross-entropy over
softmax *probabilities* (:func:`softmax_cross_entropy_on_probs`); the
G-loss privacy term is on from the first step, ``dp_delay`` gates only
the classifier's updates: ``epoch > dp_delay`` for privDCGAN,
``4 * 2**steps >= dp_delay`` for privPGGAN.

Draws: weights on the CPU from ``torch.Generator().manual_seed(seed)``,
split i's generator and discriminator after split i-1's, the classifier
last; the step noise, eps, target labels and flips from a generator on
the run's device seeded with ``seed + 1``; sampling from ``seed + 2``.
The batches come from ``np.random.default_rng(seed)`` exactly as the JAX
loops draw them, so both packages train on the same batches. Like the
JAX trainers, these save no checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import log2

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganleaks_tpu_torch.config import DCGANConfig, PGGANConfig, PrivGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.io.data import load_train_images, random_hflip
from ganleaks_tpu_torch.io.images import nearest_resize
from ganleaks_tpu_torch.models import dcgan as dcgan_m
from ganleaks_tpu_torch.models import pggan as pggan_m
from ganleaks_tpu_torch.ops.nn import initialize_weights
from ganleaks_tpu_torch.train import dcgan
from ganleaks_tpu_torch.train.gan import bce_with_logits
from ganleaks_tpu_torch.train.pggan import (gradient_penalty_fn,
                                            pggan_weights_init)
from ganleaks_tpu_torch.train.state import adam_torch
from ganleaks_tpu_torch.utils.logging import MetricsLogger, Throughput


def check_mesh(cfg) -> None:
    """Refuse ``mesh_shape`` other than ``(1,)``: these trainers run on
    one device. The JAX trainers ignore ``mesh_shape``, which under
    ``torchrun`` would train one copy per rank; the splits' layout over
    ranks is ``parallel/ep`` (one split per rank)."""
    if tuple(cfg.mesh_shape) != (1,):
        raise NotImplementedError(
            f"mesh_shape {tuple(cfg.mesh_shape)}: the privGAN trainers run "
            f"on one device; for one split per rank use the expert-parallel "
            f"steps of ganleaks_tpu_torch/parallel/ep.py")


def softmax_cross_entropy_on_probs(logits: torch.Tensor,
                                   labels: torch.Tensor) -> torch.Tensor:
    """``CrossEntropyLoss`` applied to softmax outputs (the reference
    quirk, ``privDCGAN.py:146-147``): the probabilities are taken as
    logits, ``-mean(log_softmax(softmax(logits))[label])``."""
    return F.cross_entropy(torch.softmax(logits, dim=-1), labels.long())


@dataclass
class PrivGANState:
    genS: nn.ModuleList       # one generator per split
    discS: nn.ModuleList      # one discriminator (critic) per split
    priv: nn.Module           # the shared private classifier
    opt_gen: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer
    opt_priv: torch.optim.Optimizer
    step: int = 0


def split_dataset(images: np.ndarray, n_splits: int) -> np.ndarray:
    """Contiguous equal splits (``privDCGAN.py:102-114``): (N, ...) ->
    (n_splits, N / n_splits, ...)."""
    if len(images) % n_splits:
        raise ValueError(f"{len(images)} images do not divide into "
                         f"{n_splits} splits")
    return images.reshape(n_splits, len(images) // n_splits,
                          *images.shape[1:])


def privgan_state(gens, discs, priv: nn.Module, lr: float, beta1: float,
                  beta2: float, device: torch.device | str = "cpu",
                  dtype: torch.dtype = torch.float32) -> PrivGANState:
    """The nets (``gens`` / ``discs``: one per split) in train mode on
    ``device`` in ``dtype``, each group with its own Adam(lr, beta1,
    beta2), at step 0."""
    genS = nn.ModuleList(gens).to(device, dtype).train()
    discS = nn.ModuleList(discs).to(device, dtype).train()
    priv = priv.to(device, dtype).train()
    return PrivGANState(genS, discS, priv,
                        *(adam_torch(m.parameters(), lr, beta1, beta2)
                          for m in (genS, discS, priv)))


def _split_labels(n_splits: int, batch: int, device) -> torch.Tensor:
    return torch.arange(n_splits, device=device).repeat_interleave(batch)


def _other_split_labels(n_splits: int, batch: int, device,
                        generator: torch.Generator | None) -> torch.Tensor:
    """(S, B) target labels uniform over the OTHER splits: ``r + (r >=
    split)`` with ``r`` uniform on [0, S - 2]."""
    r = torch.randint(0, n_splits - 1, (n_splits, batch),
                      generator=generator, device=device)
    return r + (r >= torch.arange(n_splits, device=device)[:, None]).long()


def _running_stats_kept(module: nn.Module):
    """``module`` as a callable on copies of its buffers: its train-mode
    BatchNorms normalise by the batch's statistics and leave the module's
    running statistics as they were."""
    bufs = {k: b.clone() for k, b in module.named_buffers()}

    def call(*args):
        return torch.func.functional_call(module, bufs, args)
    return call


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor,
            params=None) -> None:
    opt.zero_grad(set_to_none=True)
    loss.backward(inputs=params)
    opt.step()


def _privacy_step(state: PrivGANState, fakes: list, apply) -> torch.Tensor:
    """The classifier's update on every split's fakes at once,
    split-major, labelled by split; returns its loss."""
    flat = torch.cat(fakes)
    labels = _split_labels(len(fakes), fakes[0].shape[0], flat.device)
    loss = softmax_cross_entropy_on_probs(apply(flat), labels)
    _update(state.opt_priv, loss)
    return loss.detach()


# ---------------------------------------------------------------------------
# privDCGAN
# ---------------------------------------------------------------------------

def priv_pretrain_step(state: PrivGANState, imgs: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """One update of the private classifier on real images labelled by
    split (``privDCGAN.py:139-153``), train mode; returns the loss."""
    loss = softmax_cross_entropy_on_probs(state.priv(imgs), labels)
    _update(state.opt_priv, loss)
    return loss.detach()


def privdcgan_train_step(state: PrivGANState, real: torch.Tensor,
                         privacy_ratio: float, dp_on: bool,
                         noise: torch.Tensor | None = None,
                         gen_y: torch.Tensor | None = None,
                         generator: torch.Generator | None = None) -> dict:
    """One all-splits step (module docstring) on ``real`` (S, B, C, H, W)
    in [-1, 1]. ``noise`` (S, B, nz) and ``gen_y`` (S, B) int default to
    draws from ``generator`` (noise, then labels). Returns ``loss_d`` and
    ``loss_g`` (means over splits) and ``loss_dp`` (0 with the gate
    off), device scalars."""
    n_splits, batch = real.shape[:2]
    dev = real.device
    if noise is None:
        noise = torch.randn(n_splits, batch, state.genS[0].nz,
                            generator=generator, device=dev,
                            dtype=real.dtype)
    if gen_y is None:
        gen_y = _other_split_labels(n_splits, batch, dev, generator)

    fakes = [g(z).detach() for g, z in zip(state.genS, noise)]
    losses_d = [(bce_with_logits(d(r), 1.0) + bce_with_logits(d(f), 0.0))
                / 2.0 for d, r, f in zip(state.discS, real, fakes)]
    _update(state.opt_disc, torch.stack(losses_d).sum())

    loss_dp = (_privacy_step(state, fakes, state.priv) if dp_on
               else torch.zeros((), device=dev, dtype=real.dtype))

    priv = _running_stats_kept(state.priv)
    losses_g = []
    for g, d, z, y in zip(state.genS, state.discS, noise, gen_y):
        fake = g(z)
        losses_g.append(bce_with_logits(d(fake), 1.0) + privacy_ratio
                        * softmax_cross_entropy_on_probs(priv(fake), y))
    _update(state.opt_gen, torch.stack(losses_g).sum(),
            list(state.genS.parameters()))
    state.step += 1
    return {"loss_d": torch.stack(losses_d).mean().detach(),
            "loss_dp": loss_dp,
            "loss_g": torch.stack(losses_g).mean().detach()}


def build_privdcgan_state(cfg: DCGANConfig, priv_cfg: PrivGANConfig,
                          device: torch.device | str = "cpu",
                          dtype: torch.dtype = torch.float32
                          ) -> PrivGANState:
    """Seeded generators, discriminators and classifier in train mode on
    ``device`` with their Adam optimisers (``privDCGAN.py:118-131``)."""
    init = torch.Generator().manual_seed(cfg.seed)
    gens, discs = [], []
    for _ in range(priv_cfg.N_splits):
        gens.append(initialize_weights(dcgan.make_generator(cfg), init))
        discs.append(initialize_weights(dcgan_m.Discriminator(
            ndf=cfg.ndf, image_size=cfg.image_size, nc=cfg.nc), init))
    priv = initialize_weights(dcgan_m.PrivateDiscriminator(
        ndf=cfg.ndf, n_splits=priv_cfg.N_splits, image_size=cfg.image_size,
        nc=cfg.nc), init)
    return privgan_state(gens, discs, priv, cfg.lr, cfg.beta1, cfg.beta2,
                         device, dtype)


def _on_device(images: np.ndarray, device) -> torch.Tensor:
    """NHWC float32 (any leading axes) -> the same as NCHW on ``device``."""
    nchw = np.moveaxis(np.asarray(images, np.float32), -1, -3)
    return torch.from_numpy(np.ascontiguousarray(nchw)).to(device)


def _take(splits: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """``splits[s, idx[s, b]]`` -> (S, B, ...)."""
    rows = torch.from_numpy(np.ascontiguousarray(idx)).to(splits.device)
    return splits[torch.arange(len(idx), device=splits.device)[:, None],
                  rows]


def train_privdcgan(cfg: DCGANConfig, priv_cfg: PrivGANConfig,
                    images: np.ndarray | None = None,
                    logger: MetricsLogger | None = None,
                    device: torch.device | str | None = None
                    ) -> PrivGANState:
    """The classifier's pretrain (``disc_epochs`` epochs over every image,
    the last batch short), then ``num_epochs`` epochs of all-splits steps
    at batch ``min(batch_size, T)`` with each split's remainder dropped
    (``privDCGAN.py:133-165,218-313``). ``images`` (NHWC float32 in
    [-1, 1]) default to ``cfg.data_path`` decoded."""
    device = resolve_device(device)
    check_mesh(cfg)
    logger = logger or MetricsLogger()
    if images is None:
        images = load_train_images(cfg.data_path, cfg.image_size)
    splits = split_dataset(images, priv_cfg.N_splits)
    s, t = splits.shape[:2]
    state = build_privdcgan_state(cfg, priv_cfg, device)
    host_rng = np.random.default_rng(cfg.seed)
    splits_t = _on_device(splits, device)
    flat = splits_t.reshape(s * t, *splits_t.shape[2:])
    flat_labels = _split_labels(s, t, device)

    for _ in range(priv_cfg.disc_epochs):
        perm = host_rng.permutation(s * t)
        for i in range(0, s * t, cfg.batch_size):
            idx = torch.from_numpy(perm[i:i + cfg.batch_size]).to(device)
            priv_pretrain_step(state, flat[idx], flat_labels[idx])

    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    batch = min(cfg.batch_size, t)
    meter = Throughput()
    for epoch in range(cfg.num_epochs):
        perms = np.stack([host_rng.permutation(t) for _ in range(s)])
        metrics = {}
        for i in range(0, t - batch + 1, batch):
            metrics = privdcgan_train_step(
                state, _take(splits_t, perms[:, i:i + batch]),
                priv_cfg.privacy_ratio, epoch > priv_cfg.dp_delay,
                generator=step_gen)
            meter.add(s * batch)
        logger.log({"epoch": epoch,
                    **{k: float(v) for k, v in metrics.items()},
                    "images_per_sec": meter.rate()}, step=state.step)
    return state


def generate_privdcgan(cfg: DCGANConfig, priv_cfg: PrivGANConfig,
                       state: PrivGANState, run_dir: str | None = None,
                       split: int = 0,
                       device: torch.device | str | None = None
                       ) -> dict[str, str]:
    """``num_generated`` images from split ``split``'s generator in
    batches of ``min(num_generated, 512)``, as the artifact triplet under
    ``<PATH_syn_data>/privDCGAN`` with ``dcgan_`` file names
    (``privDCGAN.py:187-215``)."""
    device = resolve_device(device)
    return dcgan.sample_artifacts(cfg, state.genS[split],
                                  min(cfg.num_generated, 512), run_dir,
                                  device, "privDCGAN", "dcgan")


# ---------------------------------------------------------------------------
# privPGGAN
# ---------------------------------------------------------------------------

def _alpha(alpha, like: torch.Tensor) -> torch.Tensor:
    """The fade-in as the JAX loop passes it: rounded to float32."""
    return torch.tensor(alpha, dtype=torch.float32,
                        device=like.device).to(like.dtype)


def _privpggan_pretrain_step(state: PrivGANState, imgs: torch.Tensor,
                             labels: torch.Tensor, alpha: float,
                             steps: int) -> torch.Tensor:
    """One update of the private critic on real images at resolution
    ``steps`` (``privPGGAN.py:285-308``); returns the loss."""
    logits = state.priv(imgs, steps, _alpha(alpha, imgs))
    loss = softmax_cross_entropy_on_probs(logits, labels)
    _update(state.opt_priv, loss)
    return loss.detach()


def privpggan_train_step(state: PrivGANState, real: torch.Tensor, alpha,
                         steps: int, privacy_ratio: float, dp_on: bool,
                         lambda_gp: float = 10.0, drift: float = 0.001,
                         noise: torch.Tensor | None = None,
                         eps: torch.Tensor | None = None,
                         gen_y: torch.Tensor | None = None,
                         generator: torch.Generator | None = None) -> dict:
    """One all-splits WGAN-GP step with the privacy term
    (``privPGGAN.py:141-234``) on ``real`` (S, B, C, H, W) at resolution
    ``steps`` and fade-in ``alpha``, in ``real``'s dtype. ``noise`` (S, B,
    nz), ``eps`` (S, B, 1, 1, 1) and ``gen_y`` (S, B) default to draws
    from ``generator`` (noise, eps, labels). Returns ``loss_critic``,
    ``loss_dp`` and ``loss_gen``, device scalars."""
    n_splits, batch = real.shape[:2]
    dev, dt = real.device, real.dtype
    if noise is None:
        noise = torch.randn(n_splits, batch, state.genS[0].nz,
                            generator=generator, device=dev, dtype=dt)
    if eps is None:
        eps = torch.rand(n_splits, batch, 1, 1, 1, generator=generator,
                         device=dev, dtype=dt)
    if gen_y is None:
        gen_y = _other_split_labels(n_splits, batch, dev, generator)
    a = _alpha(alpha, real)

    fakes = [g(z, steps, a) for g, z in zip(state.genS, noise)]
    fixed = [f.detach() for f in fakes]
    losses_c = []
    for c, r, f, e in zip(state.discS, real, fixed, eps):
        c_real = c(r, steps, a)
        gp = gradient_penalty_fn(c, r, f, e, steps, a)
        losses_c.append(-(c_real.mean() - c(f, steps, a).mean())
                        + lambda_gp * gp + drift * c_real.square().mean())
    _update(state.opt_disc, torch.stack(losses_c).sum())

    loss_dp = (_privacy_step(state, fixed,
                             lambda x: state.priv(x, steps, a))
               if dp_on else torch.zeros((), device=dev, dtype=dt))

    losses_g = [-c(f, steps, a).mean() + privacy_ratio
                * softmax_cross_entropy_on_probs(state.priv(f, steps, a), y)
                for c, f, y in zip(state.discS, fakes, gen_y)]
    _update(state.opt_gen, torch.stack(losses_g).sum(),
            list(state.genS.parameters()))
    state.step += 1
    return {"loss_critic": torch.stack(losses_c).mean().detach(),
            "loss_dp": loss_dp,
            "loss_gen": torch.stack(losses_g).mean().detach()}


def build_privpggan_state(cfg: PGGANConfig, priv_cfg: PrivGANConfig,
                          device: torch.device | str = "cpu",
                          dtype: torch.dtype = torch.float32,
                          max_steps: int | None = None) -> PrivGANState:
    """Seeded generators, critics and private critic (an ``N_splits``-wide
    PGGAN critic) with every layer up to ``max_steps`` (default:
    ``image_size``'s), Adam(lr, 0, 0.99) for all three
    (``privPGGAN.py:270-283``)."""
    max_steps = (int(log2(cfg.image_size / 4)) if max_steps is None
                 else max_steps)
    init = torch.Generator().manual_seed(cfg.seed)
    gens, critics = [], []
    for _ in range(priv_cfg.N_splits):
        gens.append(pggan_weights_init(pggan_m.Generator(
            cfg.nz, cfg.in_channels, cfg.nc, max_steps), init))
        critics.append(pggan_weights_init(pggan_m.Discriminator(
            cfg.in_channels, cfg.nc, max_steps), init))
    priv = pggan_weights_init(pggan_m.Discriminator(
        cfg.in_channels, cfg.nc, max_steps, priv_cfg.N_splits), init)
    return privgan_state(gens, critics, priv, cfg.lr, 0.0, 0.99, device,
                         dtype)


def train_privpggan(cfg: PGGANConfig, priv_cfg: PrivGANConfig,
                    images: np.ndarray | None = None,
                    logger: MetricsLogger | None = None,
                    device: torch.device | str | None = None
                    ) -> PrivGANState:
    """The private critic's pretrain at every resolution from 4 px, then
    the progressive all-splits loop from ``start_img_size``
    (``privPGGAN.py:285-360``), in float32. Per resolution: the images
    nearest-resized (the main PGGAN trainer's filter; the reference's
    privPGGAN loader resizes bilinearly, DIVERGENCES.md), batch
    ``min(batch_sizes[steps], T)``, each split's remainder dropped, every
    (split, image) mirrored with probability 1/2 when ``hflip``, and the
    fade-in ramped per batch from 1e-5 by ``batch / (num_epochs * 0.5 *
    T)``."""
    device = resolve_device(device)
    check_mesh(cfg)
    logger = logger or MetricsLogger()
    if images is None:
        images = load_train_images(cfg.data_path, cfg.image_size)
    s = priv_cfg.N_splits
    t = len(split_dataset(images, s)[0])
    max_steps = int(log2(cfg.image_size / 4))
    state = build_privpggan_state(cfg, priv_cfg, device,
                                  max_steps=max_steps)
    host_rng = np.random.default_rng(cfg.seed)

    def batch_of(steps: int) -> int:
        return cfg.batch_sizes[min(steps, len(cfg.batch_sizes) - 1)]

    flat_labels = _split_labels(s, t, device)
    n = s * t
    for steps in range(max_steps + 1):
        imgs = _on_device(nearest_resize(images, 4 * 2 ** steps), device)
        batch, alpha = batch_of(steps), 1e-5
        for _ in range(priv_cfg.disc_epochs):
            perm = host_rng.permutation(n)
            for i in range(0, n, batch):
                idx = torch.from_numpy(perm[i:i + batch]).to(device)
                _privpggan_pretrain_step(state, imgs[idx], flat_labels[idx],
                                         alpha, steps)
                alpha = min(alpha + len(idx)
                            / (priv_cfg.disc_epochs * 0.5 * n), 1.0)

    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    meter = Throughput()
    for steps in range(int(log2(cfg.start_img_size / 4)), max_steps + 1):
        res = _on_device(split_dataset(
            nearest_resize(images, 4 * 2 ** steps), s), device)
        batch, alpha, metrics = min(batch_of(steps), t), 1e-5, {}
        dp_on = 4 * 2 ** steps >= priv_cfg.dp_delay
        for _ in range(cfg.num_epochs):
            perms = np.stack([host_rng.permutation(t) for _ in range(s)])
            for i in range(0, t - batch + 1, batch):
                real = _take(res, perms[:, i:i + batch])
                if cfg.hflip:  # RandomHorizontalFlip(p=0.5), privPGGAN.py:91
                    real = random_hflip(real.flatten(0, 1),
                                        generator=step_gen).view_as(real)
                metrics = privpggan_train_step(
                    state, real, alpha, steps, priv_cfg.privacy_ratio,
                    dp_on, cfg.lambda_gp, cfg.drift, generator=step_gen)
                alpha = min(alpha + batch / (cfg.num_epochs * 0.5 * t), 1.0)
                meter.add(s * batch)
        logger.log({"resolution": 4 * 2 ** steps,
                    **{k: float(v) for k, v in metrics.items()},
                    "alpha": alpha, "images_per_sec": meter.rate()},
                   step=state.step)
    return state


def generate_privpggan(cfg: PGGANConfig, priv_cfg: PrivGANConfig,
                       state: PrivGANState, run_dir: str | None = None,
                       split: int = 0, steps: int | None = None,
                       device: torch.device | str | None = None
                       ) -> dict[str, str]:
    """``num_generated`` images from split ``split``'s generator at
    resolution ``steps`` (default ``image_size``'s) with alpha 1, batches
    of ``min(num_generated, 128)``, as the artifact triplet under
    ``<PATH_syn_data>/privPGGAN`` with ``pggan_`` file names
    (``privPGGAN.py:372-435``)."""
    device = resolve_device(device)
    steps = int(log2(cfg.image_size / 4)) if steps is None else steps
    return dcgan.sample_artifacts(
        cfg, pggan_m.AtResolution(state.genS[split], steps),
        min(cfg.num_generated, 128), run_dir, device, "privPGGAN", "pggan")
