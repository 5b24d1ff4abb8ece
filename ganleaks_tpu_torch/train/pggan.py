"""Progressive GAN victim trainer (port of ``ganleaks_tpu.train.pggan``;
reference ``gan_models/pggan/train.py``).

For each resolution 4 * 2^steps from ``start_img_size`` to
``image_size``: the training images nearest-resized to it (PIL-exact,
``io/images.nearest_resize``), ``num_epochs`` epochs of shuffled batches
(``DeviceDataset(seed=cfg.seed + steps)``, the resolution's batch size),
each optionally mirrored (``io/data.random_hflip``), and the fade-in
``alpha`` ramped per batch from 1e-5 by ``batch / (num_epochs * 0.5 *
n)`` up to 1 (``train.py:134-135``); a sample grid per epoch
(``train.py:190-197``).

Per batch (``train.py:96-132``): one critic update with the WGAN-GP loss
and the drift term ``0.001 * E[critic(real)^2]``, then one generator
update against the updated critic on the same fake.

``compute_dtype`` "bfloat16" (the config's default) replaces the
reference's fp16 autocast and GradScaler as the JAX step does: the
networks run on bfloat16 copies of the float32 parameters
(``torch.func.functional_call``; the copy is differentiable, so the
gradients arrive in float32 at the master parameters), the noise, eps and
alpha are bfloat16 (alpha rounded through float32, as the JAX loop passes
it), and the losses and Adam stay in the parameters' dtype. Every layer
then computes in bfloat16 — ``torch.autocast`` would keep PixelNorm,
minibatch std, LeakyReLU and tanh in float32, another function. Any other
``compute_dtype`` equal to the parameters' runs them as they are.

Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
(WSConv weights N(0, 1) and biases 0, the initial transposed conv
torch's default); the flips and step draws come from a generator on the
run's device seeded with ``seed + 1``, the grid latents from ``seed + 3``,
the generation latents from ``seed + 2``.
"""

from __future__ import annotations

import os
from math import log2

import numpy as np
import torch
from torch import nn

from ganleaks_tpu_torch.config import PGGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.io.data import (DeviceDataset, load_train_images,
                                        random_hflip)
from ganleaks_tpu_torch.io.images import nearest_resize
from ganleaks_tpu_torch.models.pggan import (AtResolution, Discriminator,
                                             Generator)
from ganleaks_tpu_torch.ops.nn import (WSConv2d, batch_draw, batch_mean,
                                       fan_in, torch_conv_default_init_)
from ganleaks_tpu_torch.parallel.dp import is_main
from ganleaks_tpu_torch.train import dcgan
from ganleaks_tpu_torch.train.state import GANState, adam_torch
from ganleaks_tpu_torch.utils.checkpoint import load_state_dict
from ganleaks_tpu_torch.utils.logging import MetricsLogger, Throughput


def gradient_penalty_fn(critic, real: torch.Tensor, fake: torch.Tensor,
                        eps: torch.Tensor, steps: int, alpha
                        ) -> torch.Tensor:
    """PGGAN's gradient penalty (``pggan/utils.py:72-96``): the critic's
    score gradient at ``real * eps + fake.detach() * (1 - eps)``, its norm
    ``sqrt(sum g^2 + 1e-12)``, mean of ``(norm - 1)^2``; differentiable
    w.r.t. the critic's parameters (``create_graph=True``)."""
    interp = (real * eps + fake.detach() * (1.0 - eps)).requires_grad_(True)
    grads, = torch.autograd.grad(critic(interp, steps, alpha).sum(), interp,
                                 create_graph=True)
    norms = (grads.flatten(1).square().sum(1) + 1e-12).sqrt()
    return batch_mean((norms - 1.0).square())


def in_dtype(module: nn.Module, dtype: torch.dtype):
    """``module`` as a callable on ``dtype`` copies of its parameters (the
    module itself when they already have that dtype)."""
    if next(module.parameters()).dtype == dtype:
        return module
    params = {k: p.to(dtype) for k, p in module.named_parameters()}

    def call(*args):
        return torch.func.functional_call(module, params, args)
    return call


def pggan_train_step(state: GANState, real: torch.Tensor, alpha: float,
                     steps: int, lambda_gp: float = 10.0,
                     drift: float = 0.001, compute_dtype: str = "float32",
                     noise: torch.Tensor | None = None,
                     eps: torch.Tensor | None = None,
                     generator: torch.Generator | None = None) -> dict:
    """One critic and one generator update at resolution ``steps`` on
    ``real`` (NCHW in [-1, 1]); ``noise`` (N, nz) and ``eps`` (N, 1, 1,
    1), in the compute dtype, default to draws from ``generator`` (noise,
    then eps)."""
    gen, critic = state.gen, state.disc
    cdt = getattr(torch, compute_dtype)
    ldt = next(critic.parameters()).dtype
    b, dev = real.shape[0], real.device
    real_c = real.to(cdt)
    if noise is None:
        noise = batch_draw(lambda n: torch.randn(
            n, gen.nz, generator=generator, device=dev, dtype=cdt), b)
    if eps is None:
        eps = batch_draw(lambda n: torch.rand(
            n, 1, 1, 1, generator=generator, device=dev, dtype=cdt), b)
    alpha_c = torch.tensor(alpha, dtype=torch.float32, device=dev).to(cdt)

    fake = in_dtype(gen, cdt)(noise, steps, alpha_c)
    fixed = fake.detach()
    crit = in_dtype(critic, cdt)
    c_real = crit(real_c, steps, alpha_c).to(ldt)
    c_fake = crit(fixed, steps, alpha_c).to(ldt)
    gp = gradient_penalty_fn(crit, real_c, fixed, eps, steps, alpha_c)
    loss_c = (-(batch_mean(c_real) - batch_mean(c_fake))
              + lambda_gp * gp.to(ldt) + drift * batch_mean(c_real.square()))
    state.opt_disc.zero_grad(set_to_none=True)
    loss_c.backward()
    state.opt_disc.step()

    loss_g = -batch_mean(
        in_dtype(critic, cdt)(fake, steps, alpha_c).to(ldt))
    state.opt_gen.zero_grad(set_to_none=True)
    loss_g.backward(inputs=list(gen.parameters()))
    state.opt_gen.step()
    state.step += 1
    return {"loss_critic": loss_c.detach(), "loss_gen": loss_g.detach()}


def max_steps_of(cfg: PGGANConfig) -> int:
    return int(log2(cfg.image_size / 4))


def pggan_weights_init(model: nn.Module, generator: torch.Generator
                       ) -> nn.Module:
    """The reference's draws (``model_torch.py:8-22,55``) from
    ``generator`` in module order: every WSConv weight N(0, 1), its bias
    0; the initial transposed conv torch's default U(+-1/sqrt(fan_in))."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, WSConv2d):
                m.conv.weight.normal_(0.0, 1.0, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.ConvTranspose2d):
                for p in (m.weight, m.bias):
                    torch_conv_default_init_(p, fan_in(m.weight), generator)
    return model


def build_state(cfg: PGGANConfig, device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32,
                max_steps: int | None = None) -> GANState:
    """Seeded generator and critic with every layer up to ``max_steps``
    (default: ``image_size``'s) on ``device``, and their Adam optimisers
    with betas (0, 0.99) (``train.py:160-161``)."""
    max_steps = max_steps_of(cfg) if max_steps is None else max_steps
    init = torch.Generator().manual_seed(cfg.seed)
    gen = pggan_weights_init(
        Generator(cfg.nz, cfg.in_channels, cfg.nc, max_steps), init)
    critic = pggan_weights_init(
        Discriminator(cfg.in_channels, cfg.nc, max_steps), init)
    gen, critic = gen.to(device, dtype), critic.to(device, dtype)
    return GANState(gen, critic, adam_torch(gen.parameters(), cfg.lr, 0.0,
                                            0.99),
                    adam_torch(critic.parameters(), cfg.lr, 0.0, 0.99))


def train(cfg: PGGANConfig, images: np.ndarray | None = None,
          logger: MetricsLogger | None = None,
          device: torch.device | str | None = None) -> GANState:
    """The progressive loop (``train.py:145-206``); ``images`` (NHWC
    float32 in [-1, 1]) default to ``cfg.data_path`` decoded. Saves
    ``generator.pth`` and ``critic.pth`` under the reference's keys.
    Data-parallel as :func:`dcgan.train` (JAX
    ``ganleaks_tpu/train/pggan.py:160-198``): the flips drawn for the
    global batch before it is shared, the fade-in advanced by the global
    batch's rows, the minibatch std over the global batch (its sums in
    float32 on the bfloat16 path)."""
    device = resolve_device(device)
    max_steps = max_steps_of(cfg)
    state = build_state(cfg, device, max_steps=max_steps)
    dp = dcgan.data_parallel_of(cfg, device, [state.gen, state.disc],
                                [state.opt_gen, state.opt_disc])
    if logger is None and is_main(dp):
        logger = MetricsLogger(wandb_project=cfg.wandb,
                               image_dir=dcgan.resolve_grid_dir(cfg))
    if images is None:
        images = load_train_images(cfg.data_path, cfg.image_size)
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    grid_z = torch.randn(64, cfg.nz, generator=torch.Generator()
                         .manual_seed(cfg.seed + 3)).to(device)
    meter = Throughput()
    for steps in range(int(log2(cfg.start_img_size / 4)), max_steps + 1):
        batch_size = cfg.batch_sizes[min(steps, len(cfg.batch_sizes) - 1)]
        ds = DeviceDataset(nearest_resize(images, 4 * 2 ** steps),
                           seed=cfg.seed + steps, device=device)
        alpha, metrics = 1e-5, {}
        for _ in range(cfg.num_epochs):
            for batch in ds.epoch(batch_size):
                if cfg.hflip:  # on the global batch, before the shares
                    batch = random_hflip(batch, generator=step_gen)
                metrics = dcgan.run_step(
                    dp, pggan_train_step, state, (batch,), alpha, steps,
                    cfg.lambda_gp, cfg.drift, cfg.compute_dtype,
                    generator=step_gen)
                alpha = min(alpha + batch.shape[0]
                            / (cfg.num_epochs * 0.5 * len(ds)), 1.0)
                meter.add(batch.shape[0])
            if is_main(dp):
                dcgan.log_sample_grid(
                    logger, AtResolution(state.gen, steps, alpha), grid_z,
                    state.step)
        metrics = dcgan.epoch_metrics(dp, metrics)
        if is_main(dp):
            logger.log({"resolution": 4 * 2 ** steps, **metrics,
                        "alpha": alpha, "images_per_sec": meter.rate()},
                       step=state.step)
    dcgan.save_nets(cfg, dp, "pggan", {"generator": state.gen,
                                       "critic": state.disc})
    return state


def load_generator(cfg: PGGANConfig, model_dir: str,
                   device: torch.device | str = "cpu") -> Generator:
    """A saved ``generator.pth`` (the port's, or the reference's with every
    layer: ``max_steps`` is read from its RGB layers)."""
    sd = torch.load(os.path.join(model_dir, "generator.pth"),
                    map_location="cpu", weights_only=True)
    n_rgb = len({k.split(".")[1] for k in sd if k.startswith("rgb_layers.")})
    gen = Generator(cfg.nz, cfg.in_channels, cfg.nc, n_rgb - 1)
    return load_state_dict(gen, sd).to(device)


def generate(cfg: PGGANConfig, state: GANState | None = None,
             run_dir: str | None = None,
             device: torch.device | str | None = None,
             steps: int | None = None) -> dict[str, str]:
    """``num_generated`` images at resolution ``steps`` (default
    ``image_size``'s; the reference hardcodes 64 px, ``train.py:238``)
    with alpha 1, as the artifact triplet under ``<PATH_syn_data>/pggan``
    (``train.py:208-257``), from the state or ``saved_model_name``."""
    device = resolve_device(device)
    steps = max_steps_of(cfg) if steps is None else steps
    if state is not None:
        gen = state.gen
    elif cfg.saved_model_name:
        gen = load_generator(cfg, cfg.saved_model_name, device)
    else:
        raise ValueError("generate needs a trained state or "
                         "saved_model_name")
    return dcgan.sample_artifacts(
        cfg, AtResolution(gen, steps), min(cfg.num_generated, 128), run_dir,
        device, "pggan")
