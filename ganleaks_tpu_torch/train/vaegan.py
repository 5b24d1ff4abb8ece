"""VAE-GAN victim trainer (port of ``ganleaks_tpu.train.vaegan``; reference
``gan_models/vaegan/train.py:237-418``).

Three phases per iteration, each on a fresh batch (four per iteration):

1. the latent discriminator Dl: the encoder's codes labelled fake (0),
   prior noise labelled real (1), BCE (``train.py:299-327``);
2. the image discriminator D, twice: hinge terms ``relu(0.5 + D(real))``
   and ``relu(0.5 - D(G(z)))`` (``:332-354``, the reference's signs);
3. G and E together: ``mean(D(G(E(x)))) + BCE(Dl(E(x)), 1) + 0.005 *
   mean_batch(sum_pixels |x - G(E(x))|)`` (``criterionG``, ``:190-217``).

BCE is ``F.binary_cross_entropy``: its log clamp at -100 and its backward
denominator clamp at 1e-12 are what the JAX package's ``custom_vjp``
emulates, so a saturated Dl output gives a large finite gradient.

The modules and the four ``torch.optim.Adam`` update in place. Every
train-mode forward advances its BatchNorm statistics and spectral-norm
vectors, as in the JAX step (per iteration: D's ``u`` five times — real
and fake in each D step, once in the G+E step; G's twice; E's BatchNorm
twice). D's loss runs its real and fake forwards under
``ops.nn.spectral_chain``, so its gradient flows through both power
iterations as ``jax.grad`` does.

Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
(torch's default draws; the encoder's convs N(0, 0.02) and BatchNorm
scales N(1, 0.02), the reference's ``weights_init`` at ``train.py:267``);
the step draws (the encoders' eps, the prior noise, the D steps' noise)
come from a generator on the run's device seeded with ``seed + 1``, whose
state the checkpoint carries. A resumed run skips the batches the saved
epochs consumed, so it takes exactly the uninterrupted run's batches and
draws.

Checkpoints go to ``results/<exp_name>/``: ``checkpoint.pth`` (the four
nets under the reference's keys, the optimisers, the epoch and the draw
generator's state) every ``checkpoint_every`` epochs and at the end, and
with it ``netG.npz`` / ``netE.npz``: the JAX variables layout
(``{"params", "batch_stats"[, "spectral"]}``) that
``attack.reconstruction.run_reconstruction_attack`` reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ganleaks_tpu_torch.config import VAEGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.io.artifacts import check_folder, dump_params
from ganleaks_tpu_torch.io.data import DeviceDataset, epoch_batch_indices
from ganleaks_tpu_torch.io.images import load_image_dir
from ganleaks_tpu_torch.io.native import encode_png
from ganleaks_tpu_torch.models.vaegan import (Discriminator, DiscriminatorL,
                                              Encoder, Generator)
from ganleaks_tpu_torch.ops.nn import (BatchNormTorch, batch_draw,
                                       batch_loss, batch_mean, normal_init_,
                                       spectral_chain, torch_default_init)
from ganleaks_tpu_torch.parallel.dp import data_parallel
from ganleaks_tpu_torch.train.dcgan import (epoch_metrics, run_step,
                                            train_mesh)
from ganleaks_tpu_torch.train.sample import sample_to_host
from ganleaks_tpu_torch.train.state import adam_torch
from ganleaks_tpu_torch.utils.checkpoint import save_params_npz
from ganleaks_tpu_torch.utils.logging import MetricsLogger, tile_image_grid
from ganleaks_tpu_torch.weights import dump_jax_tree, vaegan_from_jax_variables

NETS = ("enc", "gen", "disc", "disc_l")


@dataclass
class VAEGANState:
    enc: Encoder
    gen: Generator
    disc: Discriminator       # the image discriminator
    disc_l: DiscriminatorL    # the latent discriminator
    opt_enc: torch.optim.Optimizer
    opt_gen: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer
    opt_disc_l: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0

    def nets(self) -> dict[str, nn.Module]:
        return {name: getattr(self, name) for name in NETS}

    def optimizers(self) -> dict[str, torch.optim.Optimizer]:
        return {name: getattr(self, f"opt_{name}") for name in NETS}


def bce(probs: torch.Tensor, target: float) -> torch.Tensor:
    """torch ``BCELoss`` on probabilities against a constant target."""
    return batch_loss(F.binary_cross_entropy, probs,
                      torch.full_like(probs, target))


def _draw(generator, like: torch.Tensor, z_dim: int) -> torch.Tensor:
    return batch_draw(lambda n: torch.randn(
        n, z_dim, generator=generator, device=like.device,
        dtype=like.dtype), like.shape[0])


def vaegan_train_step(state: VAEGANState, real_dl: torch.Tensor,
                      real_d1: torch.Tensor, real_d2: torch.Tensor,
                      real_g: torch.Tensor, draws: dict | None = None,
                      generator: torch.Generator | None = None) -> dict:
    """One iteration on four NCHW batches in [-1, 1]. ``draws`` may give
    any of ``eps_dl`` (the Dl step's encoder eps), ``noise_dl`` (its prior
    noise), ``noise_d`` (two latents, one per D step) and ``eps_g`` (the
    G+E step's encoder eps), each (N, z_dim); the rest are drawn from
    ``generator`` in that order. Returns the three losses (device
    scalars; ``loss_d`` of the second D step)."""
    enc, gen, disc, disc_l = state.enc, state.gen, state.disc, state.disc_l
    draws = dict(draws or {})
    z_dim = gen.z_dim
    for name, like in (("eps_dl", real_dl), ("noise_dl", real_dl)):
        if name not in draws:
            draws[name] = _draw(generator, like, z_dim)
    if "noise_d" not in draws:
        draws["noise_d"] = [_draw(generator, r, z_dim)
                            for r in (real_d1, real_d2)]
    if "eps_g" not in draws:
        draws["eps_g"] = _draw(generator, real_g, z_dim)

    # (1) Dl (train.py:299-327)
    with torch.no_grad():
        encoded = enc(real_dl, eps=draws["eps_dl"])
    loss_dl = bce(disc_l(encoded), 0.0) + bce(disc_l(draws["noise_dl"]), 1.0)
    state.opt_disc_l.zero_grad(set_to_none=True)
    loss_dl.backward()
    state.opt_disc_l.step()

    # (2) D, twice (train.py:332-354)
    for real_d, z in zip((real_d1, real_d2), draws["noise_d"]):
        with torch.no_grad():
            fake = gen(z)
        with spectral_chain(disc):
            out_real = disc(real_d)
            out_fake = disc(fake)
        loss_d = (batch_mean(F.relu(0.5 + out_real))
                  + batch_mean(F.relu(0.5 - out_fake)))
        state.opt_disc.zero_grad(set_to_none=True)
        loss_d.backward()
        state.opt_disc.step()

    # (3) G and E (train.py:359-385)
    encoded = enc(real_g, eps=draws["eps_g"])
    rec_fake = gen(encoded)
    rec = batch_mean((real_g.flatten(1) - rec_fake.flatten(1)).abs().sum(1))
    loss_g = (batch_mean(disc(rec_fake)) + bce(disc_l(encoded), 1.0)
              + 0.005 * rec)
    state.opt_gen.zero_grad(set_to_none=True)
    state.opt_enc.zero_grad(set_to_none=True)
    loss_g.backward(inputs=[*gen.parameters(), *enc.parameters()])
    state.opt_gen.step()
    state.opt_enc.step()
    state.step += 1
    return {"loss_dl": loss_dl.detach(), "loss_d": loss_d.detach(),
            "loss_g": loss_g.detach()}


def encoder_weights_init(enc: Encoder, generator: torch.Generator) -> None:
    """The reference's ``weights_init`` on the encoder (``ops.py:10-16``):
    every conv weight N(0, 0.02), every BatchNorm scale N(1, 0.02) (bn6 and
    bn7 included: ``apply`` recurses) and bias 0."""
    for m in enc.modules():
        if isinstance(m, nn.Conv2d):
            normal_init_(m.weight, 0.02, generator)
        elif isinstance(m, BatchNormTorch):
            with torch.no_grad():
                m.weight.normal_(1.0, 0.02, generator=generator)
                m.bias.zero_()


def build_state(cfg: VAEGANConfig, device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> VAEGANState:
    """Seeded networks in train mode on ``device`` and their Adam
    optimisers: E and G at lr 1e-4, D at 4e-4, Dl at 2e-4, all with betas
    (0, 0.9) (``train.py:279-282``)."""
    init = torch.Generator().manual_seed(cfg.seed)
    enc = torch_default_init(Encoder(cfg.z_dim, cfg.d), init)
    encoder_weights_init(enc, init)
    gen = torch_default_init(Generator(cfg.z_dim, cfg.d), init)
    disc = torch_default_init(Discriminator(cfg.d), init)
    disc_l = torch_default_init(DiscriminatorL(cfg.z_dim), init)
    nets = [m.to(device, dtype).train() for m in (enc, gen, disc, disc_l)]
    opts = [adam_torch(m.parameters(), lr, 0.0, 0.9)
            for m, lr in zip(nets, (1e-4, 1e-4, 4e-4, 2e-4))]
    return VAEGANState(*nets, *opts)


class VaeganImageDataset(DeviceDataset):
    """``CelebaDataseat`` (``train.py:221-233``): PNGs through the
    resize-variant reader (``io/images.read_image``: the stored bytes, or
    Pillow's default-filter resize, as ``2 * (x / 255) - 1``), not the
    trainers' bilinear one."""

    @classmethod
    def from_dir(cls, data_dir: str, resolution: int = 64, seed: int = 0,
                 device: torch.device | str = "cpu") -> "VaeganImageDataset":
        return cls(load_image_dir(data_dir, resolution, ext="png"), seed=seed,
                   device=device)


def forever_batch_indices(ds: DeviceDataset, batch_size: int):
    """The drop_last loader cycled forever (``train.py:260-262,305-309``):
    index vectors of ``ds``'s epoch permutations."""
    if len(ds) < batch_size:
        raise ValueError(f"{len(ds)} images do not fill one batch of "
                         f"{batch_size} (drop_last)")
    while True:
        yield from epoch_batch_indices(ds._rng, len(ds), batch_size,
                                       drop_last=True)


def save_checkpoint(save_dir: str, state: VAEGANState,
                    step_gen: torch.Generator) -> None:
    """``checkpoint.pth`` plus ``netG.npz`` / ``netE.npz``."""
    torch.save({"epoch": state.epoch, "step": state.step,
                "rng": step_gen.get_state(),
                **{name: m.state_dict() for name, m in state.nets().items()},
                **{f"opt_{name}": o.state_dict()
                   for name, o in state.optimizers().items()}},
               os.path.join(save_dir, "checkpoint.pth"))
    save_params_npz(os.path.join(save_dir, "netG.npz"),
                    dump_jax_tree(state.gen))
    save_params_npz(os.path.join(save_dir, "netE.npz"),
                    dump_jax_tree(state.enc))


def load_checkpoint(path: str, state: VAEGANState,
                    step_gen: torch.Generator) -> None:
    """Restore what :func:`save_checkpoint` wrote onto ``state`` and
    ``step_gen`` in place."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for name, m in state.nets().items():
        m.load_state_dict(ckpt[name])
    for name, o in state.optimizers().items():
        o.load_state_dict(ckpt[f"opt_{name}"])
    state.epoch, state.step = int(ckpt["epoch"]), int(ckpt["step"])
    step_gen.set_state(ckpt["rng"])


def train(cfg: VAEGANConfig, images: np.ndarray | None = None,
          logger: MetricsLogger | None = None, resume: bool = True,
          device: torch.device | str | None = None) -> VAEGANState:
    """The training loop (``train.py:284-414``): ``nepoch`` epochs of
    ``steps_per_epoch`` iterations; ``images`` (NHWC float32 in [-1, 1])
    default to the PNGs under ``cfg.data_path``. With ``resume`` an
    existing ``results/<exp_name>/checkpoint.pth`` is continued.

    Data-parallel as ``dcgan.train`` (JAX ``ganleaks_tpu/train/
    vaegan.py:254-280``): all four batches of an iteration shared, rank 0
    alone logging and writing the checkpoints, every rank resuming from
    rank 0's after a barrier. The spectral-norm power iteration needs no
    reduction: it reads the weights alone, which are replicated."""
    device = resolve_device(device)
    state = build_state(cfg, device)
    mesh = train_mesh(cfg, device)
    main = mesh is None or mesh.is_main
    save_dir = check_folder(os.path.join("results", cfg.exp_name))
    if main:
        dump_params(save_dir, cfg)
    if logger is None and main:
        logger = MetricsLogger(os.path.join(save_dir, "metrics.jsonl"))
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    ckpt_path = os.path.join(save_dir, "checkpoint.pth")
    if mesh is not None:  # a checkpoint rank 0 wrote before, on every rank
        dist.barrier(group=mesh.group)
    if resume and os.path.exists(ckpt_path):
        load_checkpoint(ckpt_path, state, step_gen)
        if main:
            print(f" [*] resumed from epoch {state.epoch}")
    dp = data_parallel(mesh, state.nets().values(),
                       state.optimizers().values())
    ds = (VaeganImageDataset.from_dir(cfg.data_path, cfg.image_size,
                                      cfg.seed, device)
          if images is None else DeviceDataset(images, cfg.seed, device))
    batches = forever_batch_indices(ds, cfg.batch_size)
    # skip what the saved epochs consumed: four batches an iteration
    for _ in range(4 * state.epoch * cfg.steps_per_epoch):
        next(batches)
    for epoch in range(state.epoch, cfg.nepoch):
        metrics = {}
        for _ in range(cfg.steps_per_epoch):
            b = [ds.images[torch.from_numpy(next(batches)).to(device)]
                 for _ in range(4)]
            metrics = run_step(dp, vaegan_train_step, state, b,
                               generator=step_gen)
        state.epoch = epoch + 1
        metrics = epoch_metrics(dp, metrics)
        if main:
            logger.log({"epoch": epoch, **metrics}, step=state.step)
            if epoch % cfg.checkpoint_every == 0:  # train.py:401-414
                save_checkpoint(save_dir, state, step_gen)
    if main:
        save_checkpoint(save_dir, state, step_gen)
    if dp is not None:
        dp.barrier()
        dp.close()
    return state


def load_generator(cfg: VAEGANConfig, path: str | None = None,
                   device: torch.device | str = "cpu") -> Generator:
    """The generator of ``results/<exp_name>/netG.npz`` (or ``path``: an
    npz or the JAX trainer's msgpack)."""
    from ganleaks_tpu_torch.utils.checkpoint import load_variables
    path = path or os.path.join("results", cfg.exp_name, "netG.npz")
    return vaegan_from_jax_variables("generator", load_variables(path),
                                     cfg.z_dim, cfg.d).to(device)


def sample(cfg: VAEGANConfig, state: VAEGANState | None, out_dir: str,
           device: torch.device | str | None = None) -> dict[str, str]:
    """``sample.py``: ``num_samples`` images in batches of 100 from a
    generator seeded with 1000 (the reference's seed) into
    ``generated.npz`` (``noise`` (N, z_dim), ``img_r01`` (N, H, W, C) in
    [0, 1]) and a 10x10 grid ``samples.png``; without a state the
    generator is read from ``netG.npz``."""
    device = resolve_device(device)
    gen = state.gen if state is not None else load_generator(cfg,
                                                             device=device)
    check_folder(out_dir)
    noise, img01 = sample_to_host(
        gen, cfg.num_samples, cfg.z_dim, 100,
        torch.Generator(device=device).manual_seed(1000), device)
    np.savez_compressed(os.path.join(out_dir, "generated.npz"), noise=noise,
                        img_r01=img01)
    save_grid(img01, os.path.join(out_dir, "samples.png"))
    return {"out_dir": out_dir}


def save_grid(imgs01: np.ndarray, path: str) -> None:
    """The first 100 NHWC images in [0, 1] as a 10x10 grid PNG, rounded,
    black where fewer (``vaegan/utils.py:110``)."""
    imgs = np.asarray(imgs01[:100], np.float32)
    pad = np.zeros((100 - len(imgs),) + imgs.shape[1:], np.float32)
    encode_png(tile_image_grid(np.concatenate([imgs, pad]), 10), path)
