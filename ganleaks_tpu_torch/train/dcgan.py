"""DCGAN victim trainer (port of ``ganleaks_tpu.train.dcgan``; reference
``gan_models/dcgan/train_torch.py``): config -> device dataset -> train
steps -> ``generator.pth`` / ``discriminator.pth`` under the reference's
keys -> batched sampling -> the reference's artifact triplet.

Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
(``ops/nn.initialize_weights``), so a run on the card and one on the CPU
start from the same parameters; the step noise comes from a generator on
the run's device seeded with ``seed + 1``, the sampling noise from one
seeded with ``seed + 2``, the grid noise from ``seed + 3`` (on the CPU).

``mesh_shape=(n,)`` trains data-parallel on the n ranks of the live
process group (``parallel/dp``; the CLI's local launch, ``torchrun`` or
``multihost``): each rank a share of every batch, the step the one
device step on the global batch (the JAX trainer's ``pjit``,
``ganleaks_tpu/train/dcgan.py:56-80``). Rank 0 alone logs and writes;
the others wait for it at a barrier.
"""

from __future__ import annotations

import math
import os

import torch

from ganleaks_tpu_torch.config import DCGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.io.artifacts import (check_folder, timestamp_dir,
                                             write_synthetic_artifacts)
from ganleaks_tpu_torch.io.data import DeviceDataset, load_train_images
from ganleaks_tpu_torch.models.dcgan import Discriminator, Generator
from ganleaks_tpu_torch.ops.nn import initialize_weights
from ganleaks_tpu_torch.parallel.dp import (DataParallel, data_parallel,
                                            is_main)
from ganleaks_tpu_torch.parallel import multihost
from ganleaks_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh
from ganleaks_tpu_torch.train.gan import dcgan_train_step
from ganleaks_tpu_torch.train.sample import sample_to_host
from ganleaks_tpu_torch.train.state import GANState, adam_torch
from ganleaks_tpu_torch.utils.checkpoint import (load_state_dict,
                                                 save_state_dict)
from ganleaks_tpu_torch.utils.logging import MetricsLogger, Throughput


def train_mesh(cfg, device: torch.device) -> Mesh | None:
    """The data-parallel mesh of ``cfg.mesh_shape``: None for one device;
    else the process group's (joined first: ``parallel/multihost.
    initialize``, a no-op without a launcher's world or the
    ``GANLEAKS_*`` variables), which must hold one rank per device
    (``parallel/mesh.data_parallel_mesh`` raises otherwise)."""
    if cfg.multihost or math.prod(cfg.mesh_shape) > 1:
        multihost.initialize()
    return data_parallel_mesh(tuple(cfg.mesh_shape), device=device)


def data_parallel_of(cfg, device: torch.device, modules, optimizers
                     ) -> DataParallel | None:
    """The :class:`DataParallel` of :func:`train_mesh`, ``modules``
    replicated from rank 0; None for one device."""
    return data_parallel(train_mesh(cfg, device), modules, optimizers)


def resolve_grid_dir(cfg) -> str | None:
    """Sample-grid sink: "auto" puts grids under the run's model dir."""
    if cfg.sample_grid_dir == "auto":
        return os.path.join(cfg.PATH, "sample_grids")
    return cfg.sample_grid_dir or None


def make_generator(cfg) -> Generator:
    return Generator(nz=cfg.nz, nc=cfg.nc, ngf=cfg.ngf,
                     image_size=cfg.image_size)


def build_state(cfg: DCGANConfig, device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> GANState:
    """Seeded networks in train mode on ``device`` and their Adam
    optimisers (``train_torch.py:76-83``)."""
    init = torch.Generator().manual_seed(cfg.seed)
    gen = initialize_weights(make_generator(cfg), init)
    disc = initialize_weights(
        Discriminator(ndf=cfg.ndf, image_size=cfg.image_size, nc=cfg.nc),
        init)
    gen = gen.to(device, dtype).train()
    disc = disc.to(device, dtype).train()
    return GANState(gen, disc,
                    adam_torch(gen.parameters(), cfg.lr, cfg.beta1,
                               cfg.beta2),
                    adam_torch(disc.parameters(), cfg.lr, cfg.beta1,
                               cfg.beta2))


def log_sample_grid(logger: MetricsLogger, gen, z: torch.Tensor,
                    step: int) -> None:
    """The per-epoch sample grid (``train_torch.py:125-127``); no-op
    without an image sink."""
    if logger.image_dir is None and logger._wandb is None:
        return
    was_training = gen.training
    gen.eval()
    with torch.inference_mode():
        img = ((gen(z) + 1.0) / 2.0).clamp_(0.0, 1.0)
    gen.train(was_training)
    logger.log_image_grid("samples", img.permute(0, 2, 3, 1).cpu().numpy(),
                          step=step)


def run_step(dp: DataParallel | None, step_fn, state, batches, *args,
             **kwargs):
    """``step_fn(state, *batches, *args, **kwargs)`` (``batches``: the
    step's global batches): on one device as it is, else data-parallel
    on this rank's shares (``DataParallel.run``)."""
    if dp is None:
        return step_fn(state, *batches, *args, **kwargs)
    return dp.run(step_fn, state, batches, *args, **kwargs)


def epoch_metrics(dp: DataParallel | None, metrics: dict) -> dict:
    """The last step's metrics as floats: on ranks, the global batch's
    (every rank takes part)."""
    if dp is not None:
        metrics = dp.metrics(metrics)
    return {k: float(v) for k, v in metrics.items()}


def fit(cfg, state: GANState, images, step_fn,
        logger: MetricsLogger | None, device: torch.device,
        dp: DataParallel | None = None) -> GANState:
    """The epoch loop shared by the DCGAN and WGAN-GP trainers:
    ``step_fn(state, batch, generator)`` per batch (data-parallel on this
    rank's share with ``dp``), one metrics record and one sample grid per
    epoch (by rank 0 alone)."""
    ds = DeviceDataset(images, seed=cfg.seed, device=device)
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    grid_z = torch.randn(64, cfg.nz, generator=torch.Generator()
                         .manual_seed(cfg.seed + 3)).to(device)
    meter = Throughput()
    for epoch in range(cfg.num_epochs):
        metrics = {}
        for batch in ds.epoch(cfg.batch_size):
            metrics = run_step(dp, step_fn, state, (batch,), step_gen)
            meter.add(batch.shape[0])
        metrics = epoch_metrics(dp, metrics)
        if is_main(dp):
            logger.log({"epoch": epoch, **metrics,
                        "images_per_sec": meter.rate()}, step=state.step)
            log_sample_grid(logger, state.gen, grid_z, state.step)
    return state


def save_nets(cfg, dp: DataParallel | None, model_name: str,
              nets: dict) -> None:
    """``<PATH>/<model_name>/<timestamp>/<name>.pth`` for each of ``nets``
    when ``cfg.save_model``, written by rank 0 alone; the other ranks
    wait at a barrier."""
    if cfg.save_model and is_main(dp):
        dirname = check_folder(timestamp_dir(os.path.join(cfg.PATH,
                                                          model_name)))
        for name, net in nets.items():
            save_state_dict(os.path.join(dirname, f"{name}.pth"), net)
    if dp is not None:
        dp.barrier()
        dp.close()


def train(cfg: DCGANConfig, images=None, logger: MetricsLogger | None = None,
          device: torch.device | str | None = None) -> GANState:
    """Train loop (``train_torch.py:88-136``); ``images`` (NHWC float32 in
    [-1, 1]) default to ``cfg.data_path`` decoded. Data-parallel over the
    process group's ranks when ``cfg.mesh_shape`` asks for several."""
    device = resolve_device(device)
    state = build_state(cfg, device)
    dp = data_parallel_of(cfg, device, [state.gen, state.disc],
                          [state.opt_gen, state.opt_disc])
    if logger is None and is_main(dp):
        logger = MetricsLogger(wandb_project=cfg.wandb,
                               image_dir=resolve_grid_dir(cfg))
    if images is None:
        images = load_train_images(cfg.data_path, cfg.image_size)
    state = fit(cfg, state, images,
                lambda s, b, g: dcgan_train_step(s, b, generator=g),
                logger, device, dp)
    save_nets(cfg, dp, "dcgan", {"generator": state.gen,
                                 "discriminator": state.disc})
    return state


def load_generator(cfg, model_dir: str, device: torch.device | str = "cpu"
                   ) -> Generator:
    """A saved ``generator.pth`` (the port's or the reference's) for
    generation-only mode (``train_torch.py:146-148``)."""
    gen = load_state_dict(make_generator(cfg),
                          os.path.join(model_dir, "generator.pth"))
    return gen.to(device)


def generate(cfg, state: GANState | None = None, run_dir: str | None = None,
             device: torch.device | str | None = None,
             model_name: str = "dcgan") -> dict[str, str]:
    """Sample ``num_generated`` images from the trained state, else from
    ``cfg.saved_model_name``, and write the artifact triplet under
    ``<PATH_syn_data>/<model_name>`` (``train_torch.py:150-174``)."""
    device = resolve_device(device)
    if state is not None:
        gen = state.gen
    elif cfg.saved_model_name:
        gen = load_generator(cfg, cfg.saved_model_name, device)
    else:
        raise ValueError("generate needs a trained state or "
                         "saved_model_name")
    return sample_artifacts(cfg, gen, min(cfg.num_generated, 512), run_dir,
                            device, model_name)


def sample_artifacts(cfg, gen, batch: int, run_dir: str | None,
                     device: torch.device | str, model_name: str,
                     prefix: str | None = None) -> dict[str, str]:
    """``cfg.num_generated`` samples of ``gen`` (z -> image) in batches of
    ``batch``, latents from a generator on ``device`` seeded with
    ``cfg.seed + 2``, written as the artifact triplet under
    ``<PATH_syn_data>/<model_name>`` with file names starting ``prefix``
    (default ``model_name``; privGAN writes ``privDCGAN/.../dcgan_*``)."""
    sample_gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)
    noise, imgs01 = sample_to_host(gen, cfg.num_generated, cfg.nz, batch,
                                   sample_gen, device)
    root = os.path.join(cfg.PATH_syn_data, model_name)
    return write_synthetic_artifacts(root, prefix or model_name, imgs01,
                                     noise, run_dir)
