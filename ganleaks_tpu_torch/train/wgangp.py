"""WGAN-GP victim trainer (port of ``ganleaks_tpu.train.wgangp``; reference
``gan_models/wgangp/train.py``).

Per batch: ``critic_iter`` critic updates, each on fresh noise and a fresh
``eps`` (``train.py:98-108``), then one generator update on the LAST fake
against the updated critic (``:111-115``). The critic sees the fake
detached; the generator's loss goes through the last fake's graph, so G's
BatchNorm running statistics advance ``critic_iter`` times per step, as in
the JAX step. The gradient penalty (``utils.py:4-24``) differentiates the
critic's score w.r.t. the interpolated images with
``torch.autograd.grad(create_graph=True)``; the critic's loss then
backpropagates through that gradient (a double backward).

As in the JAX package, training reads the configured image directory (the
reference's ``train.py:68`` overwrites it with a MIMIC matrix,
DIVERGENCES.md).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ganleaks_tpu_torch.config import WGANGPConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.io.data import load_train_images
from ganleaks_tpu_torch.models.wgangp import Critic
from ganleaks_tpu_torch.ops.nn import (batch_draw, batch_mean,
                                       initialize_weights)
from ganleaks_tpu_torch.parallel.dp import is_main
from ganleaks_tpu_torch.train import dcgan
from ganleaks_tpu_torch.train.gan import latent
from ganleaks_tpu_torch.train.state import GANState, adam_torch
from ganleaks_tpu_torch.utils.logging import MetricsLogger


def gradient_penalty_fn(critic, real: torch.Tensor, fake: torch.Tensor,
                        eps: torch.Tensor) -> torch.Tensor:
    """``((||grad_x critic(eps*real + (1-eps)*fake)||_2 - 1)^2).mean()``,
    differentiable w.r.t. the critic's parameters."""
    interp = (real * eps + fake * (1.0 - eps)).requires_grad_(True)
    grads, = torch.autograd.grad(critic(interp).sum(), interp,
                                 create_graph=True)
    norms = grads.flatten(1).square().sum(1).sqrt()
    return batch_mean((norms - 1.0).square())


def wgangp_train_step(state: GANState, real: torch.Tensor,
                      critic_iter: int = 5, lambda_gp: float = 10.0,
                      noise: Sequence[torch.Tensor] | None = None,
                      eps: Sequence[torch.Tensor] | None = None,
                      generator: torch.Generator | None = None) -> dict:
    """``critic_iter`` critic updates then one generator update on ``real``
    (NCHW in [-1, 1]). ``noise[t]`` (N, nz) and ``eps[t]`` (N, 1, 1, 1)
    default to draws from ``generator`` (noise, then eps, per critic
    update). Returns the last critic loss and the generator loss."""
    gen, critic = state.gen, state.disc
    b = real.shape[0]
    for t in range(critic_iter):
        z = noise[t] if noise is not None else latent(state, b, real,
                                                      generator)
        e = eps[t] if eps is not None else batch_draw(
            lambda n: torch.rand(n, 1, 1, 1, generator=generator,
                                 device=real.device, dtype=real.dtype), b)
        fake = gen(z)
        fixed = fake.detach()
        loss_c = (batch_mean(critic(fixed)) - batch_mean(critic(real))
                  + lambda_gp * gradient_penalty_fn(critic, real, fixed, e))
        state.opt_disc.zero_grad(set_to_none=True)
        loss_c.backward()
        state.opt_disc.step()

    loss_g = -batch_mean(critic(fake))
    state.opt_gen.zero_grad(set_to_none=True)
    loss_g.backward()
    state.opt_gen.step()
    state.step += 1
    return {"loss_critic": loss_c.detach(), "loss_gen": loss_g.detach()}


def build_state(cfg: WGANGPConfig, device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> GANState:
    """Seeded generator (DCGAN's) and critic in train mode on ``device``,
    with their Adam optimisers (``train.py:73-80``)."""
    init = torch.Generator().manual_seed(cfg.seed)
    gen = initialize_weights(dcgan.make_generator(cfg), init)
    critic = initialize_weights(Critic(ndf=cfg.ndf, nc=cfg.nc), init)
    gen = gen.to(device, dtype).train()
    critic = critic.to(device, dtype).train()
    return GANState(gen, critic,
                    adam_torch(gen.parameters(), cfg.lr, cfg.beta1,
                               cfg.beta2),
                    adam_torch(critic.parameters(), cfg.lr, cfg.beta1,
                               cfg.beta2))


def train(cfg: WGANGPConfig, images=None,
          logger: MetricsLogger | None = None,
          device: torch.device | str | None = None) -> GANState:
    """Train loop (``train.py:84-135``); saves ``generator.pth`` and
    ``critic.pth``. Data-parallel as :func:`dcgan.train` (JAX
    ``ganleaks_tpu/train/wgangp.py:120-131``): each critic update draws
    its noise and eps global-shaped."""
    device = resolve_device(device)
    state = build_state(cfg, device)
    dp = dcgan.data_parallel_of(cfg, device, [state.gen, state.disc],
                                [state.opt_gen, state.opt_disc])
    if logger is None and is_main(dp):
        logger = MetricsLogger(wandb_project=cfg.wandb,
                               image_dir=dcgan.resolve_grid_dir(cfg))
    if images is None:
        images = load_train_images(cfg.data_path, cfg.image_size)
    state = dcgan.fit(
        cfg, state, images,
        lambda s, b, g: wgangp_train_step(
            s, b, cfg.critic_iter, cfg.lambda_gp, generator=g),
        logger, device, dp)
    dcgan.save_nets(cfg, dp, "wgangp", {"generator": state.gen,
                                        "critic": state.disc})
    return state


def generate(cfg: WGANGPConfig, state: GANState | None = None,
             run_dir: str | None = None,
             device: torch.device | str | None = None) -> dict[str, str]:
    """The artifact triplet under ``<PATH_syn_data>/wgangp``
    (``train.py:153-174``), from the state or ``saved_model_name``."""
    return dcgan.generate(cfg, state, run_dir, device, model_name="wgangp")
