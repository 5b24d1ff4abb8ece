"""medGAN victim trainer (port of ``ganleaks_tpu.train.medgan``; reference
``gan_models/medgan/train.py`` + ``utils.py``).

Phase 1 pretrains the autoencoder with the per-record summed BCE
(``utils.py:18-32``, ``train.py:125-148``). Phase 2 is the GAN loop: D
sees real records against ``decode(G(z))`` detached, then G minimises
``-log D(decode(G(z)))`` with the autoencoder co-optimised by an Adam at
lr 1e-4 (``train.py:112-114,150-199``).

* G runs once per step in train mode and its output serves both losses,
  so its BatchNorm statistics advance once (the JAX step's second forward
  discards its statistics: the same values).
* The G-side autoencoder Adam (``opt_ae_g``) holds every autoencoder
  parameter with the config's weight decay: the encoder, which gets no
  gradient there, still decays (its gradient is set to zero, as optax
  sees it), as in the JAX package.
* The reference's quirks stay: the discriminator's sigmoid output goes
  into BCE-with-logits (``utils.py:36-42``), and training batches are
  drawn with replacement (``RandomSampler(replacement=True)``,
  ``train.py:68``) — from ``np.random.default_rng(seed)``, the JAX
  package's sampler, so the batches are equal.

Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
(torch's default draws); the step noise comes from a generator on the
run's device seeded with ``seed + 1``, each evaluation's from one seeded
with ``seed + 2 + epoch``, generation's from one seeded with 1234 (the
reference's ``np.random.seed(1234)``). Generation thresholds the decoded
samples at 0.5 into ``synthetic.npy`` (``train.py:306-318``), which
``attack.tabular.run_tabular_attack`` reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ganleaks_tpu_torch.config import MedGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.io.artifacts import check_folder
from ganleaks_tpu_torch.io.tables import load_csv_dataset
from ganleaks_tpu_torch.models.medgan import (Autoencoder, Discriminator,
                                              Generator)
from ganleaks_tpu_torch.ops.nn import (batch_draw, batch_loss, batch_mean,
                                       torch_default_init)
from ganleaks_tpu_torch.parallel.dp import is_main
from ganleaks_tpu_torch.train.dcgan import (data_parallel_of, epoch_metrics,
                                            run_step, save_nets)
from ganleaks_tpu_torch.train.state import adam_torch
from ganleaks_tpu_torch.utils.logging import MetricsLogger

EPS = 1e-12


@dataclass
class MedGANState:
    gen: Generator
    disc: Discriminator
    ae: Autoencoder
    opt_gen: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer
    opt_ae: torch.optim.Optimizer     # the pretrain's, at the config's lr
    opt_ae_g: torch.optim.Optimizer   # the GAN step's, at lr 1e-4
    step: int = 0


# --- the reference's losses (medgan/utils.py) --------------------------------

def generator_loss(y_fake: torch.Tensor) -> torch.Tensor:
    """-mean(log(y_fake + eps)) (``utils.py:7-15``)."""
    return -batch_mean(torch.log(y_fake + EPS))


def autoencoder_loss(x_out: torch.Tensor, y_target: torch.Tensor,
                     binary: bool) -> torch.Tensor:
    """Summed over features, averaged over records (``utils.py:18-32``)."""
    if binary:
        term = (y_target * torch.log(x_out + EPS)
                + (1.0 - y_target) * torch.log(1.0 - x_out + EPS))
        return batch_mean(-term.sum(dim=1))
    return batch_mean((x_out - y_target).square().sum(dim=1))


def discriminator_loss(out_real: torch.Tensor,
                       out_fake: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits on the sigmoid outputs (``utils.py:36-42``)."""
    return (batch_loss(F.binary_cross_entropy_with_logits, out_real,
                       torch.ones_like(out_real))
            + batch_loss(F.binary_cross_entropy_with_logits, out_fake,
                         torch.zeros_like(out_fake)))


def discriminator_accuracy(pred: torch.Tensor, y_true: bool) -> float:
    """(``utils.py:46-56``)."""
    return float(((pred > 0.5) == y_true).float().mean())


# --- steps -------------------------------------------------------------------

def ae_pretrain_step(state: MedGANState, real: torch.Tensor,
                     binary: bool = True) -> dict:
    """One autoencoder update on ``real`` (N, D) with ``opt_ae``."""
    loss = autoencoder_loss(state.ae(real), real, binary)
    state.opt_ae.zero_grad(set_to_none=True)
    loss.backward()
    state.opt_ae.step()
    return {"a_loss": loss.detach()}


def medgan_train_step(state: MedGANState, real: torch.Tensor,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None) -> dict:
    """One D + G update on ``real`` (N, D); ``noise`` (N, latent)
    defaults to a draw from ``generator``."""
    gen, disc, ae = state.gen, state.disc, state.ae
    if noise is None:
        noise = batch_draw(lambda n: torch.randn(
            n, gen.z_dim, generator=generator, device=real.device,
            dtype=real.dtype), real.shape[0])
    dec = ae.decode(gen(noise))

    d_loss = discriminator_loss(disc(real), disc(dec.detach()))
    state.opt_disc.zero_grad(set_to_none=True)
    d_loss.backward()
    state.opt_disc.step()

    g_loss = generator_loss(disc(dec))
    state.opt_gen.zero_grad(set_to_none=True)
    state.opt_ae_g.zero_grad(set_to_none=True)
    g_loss.backward(inputs=[*gen.parameters(), *ae.decoder.parameters()])
    for p in ae.encoder.parameters():   # decays on a zero gradient
        p.grad = torch.zeros_like(p)
    state.opt_gen.step()
    state.opt_ae_g.step()
    state.step += 1
    return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}


# --- driver ------------------------------------------------------------------

def build_state(cfg: MedGANConfig, input_size: int,
                device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> MedGANState:
    """Seeded networks in train mode on ``device`` and their Adam
    optimisers (``train.py:108-114``): G, D and the pretrain at the
    config's lr, betas and weight decay; the G-side autoencoder Adam at
    lr 1e-4 with the same decay."""
    init = torch.Generator().manual_seed(cfg.seed)
    gen = torch_default_init(Generator(cfg.latent_dim, cfg.hidden_gen), init)
    disc = torch_default_init(Discriminator(
        input_size, cfg.hidden_disc1, cfg.hidden_disc2,
        cfg.minibatch_averaging), init)
    ae = torch_default_init(Autoencoder(input_size, cfg.hidden_gen,
                                        cfg.binary), init)
    gen, disc, ae = (m.to(device, dtype).train() for m in (gen, disc, ae))

    def adam(m, lr):
        return adam_torch(m.parameters(), lr, cfg.b1, cfg.b2,
                          cfg.weight_decay)

    return MedGANState(gen, disc, ae, adam(gen, cfg.lr), adam(disc, cfg.lr),
                       adam(ae, cfg.lr), adam(ae, 1e-4))


def train(cfg: MedGANConfig, data: np.ndarray | None = None,
          test_data: np.ndarray | None = None,
          logger: MetricsLogger | None = None,
          device: torch.device | str | None = None) -> MedGANState:
    """The pretrain, then the GAN loop (``train.py:116-245``); ``data`` and
    ``test_data`` (N, D) default to the CSV's 90/10 split. Each epoch is
    ``N // batch_size`` batches drawn with replacement. Saves
    ``generator.pth``, ``autoencoder.pth`` and ``discriminator.pth`` under
    the reference's keys. Data-parallel as ``dcgan.train`` (JAX
    ``ganleaks_tpu/train/medgan.py:185-215``), the pretrain and the GAN
    loop alike: every rank's host sampler is seeded alike and draws the
    global batch, of which it takes its share; rank 0 alone evaluates."""
    device = resolve_device(device)
    if data is None:
        data = load_csv_dataset(cfg.DATASETPATH, train=True)
        test_data = load_csv_dataset(cfg.DATASETPATH, train=False)
    rows = torch.from_numpy(np.asarray(data, np.float32)).to(device)
    n = len(rows)
    state = build_state(cfg, rows.shape[1], device)
    dp = data_parallel_of(cfg, device, [state.gen, state.disc, state.ae],
                          [state.opt_gen, state.opt_disc, state.opt_ae,
                           state.opt_ae_g])
    if logger is None and is_main(dp):
        logger = MetricsLogger()
    host_rng = np.random.default_rng(cfg.seed)
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    per_epoch = max(1, n // cfg.batch_size)

    def sample_batch() -> torch.Tensor:  # with replacement
        idx = host_rng.integers(0, n, size=min(cfg.batch_size, n))
        return rows[torch.from_numpy(idx).to(device)]

    metrics = {}
    for _ in range(cfg.n_epochs_pretrain * per_epoch):
        metrics = run_step(dp, ae_pretrain_step, state, (sample_batch(),),
                           cfg.binary)
    if metrics:
        metrics = epoch_metrics(dp, metrics)
        if is_main(dp):
            logger.log({"pretrain_a_loss": metrics["a_loss"]})
    for epoch in range(cfg.n_epochs):
        for _ in range(per_epoch):
            metrics = run_step(dp, medgan_train_step, state,
                               (sample_batch(),), generator=step_gen)
        if (epoch + 1) % 10 == 0 or epoch == cfg.n_epochs - 1:
            rec = epoch_metrics(dp, metrics)
            if is_main(dp):
                if test_data is not None:
                    rec.update(evaluate(cfg, state, test_data, epoch,
                                        device))
                logger.log({"epoch": epoch + 1, **rec}, step=state.step)
    save_nets(cfg, dp, "medgan", {"generator": state.gen,
                                  "autoencoder": state.ae,
                                  "discriminator": state.disc})
    return state


def _decoded_samples(state: MedGANState, z: torch.Tensor) -> torch.Tensor:
    """``decode(G(z))`` with G at its running statistics; modes restored."""
    was = state.gen.training
    state.gen.eval()
    try:
        with torch.no_grad():
            return state.ae.decode(state.gen(z))
    finally:
        state.gen.train(was)


def evaluate(cfg: MedGANConfig, state: MedGANState, test_data: np.ndarray,
             epoch: int, device: torch.device | str = "cpu") -> dict:
    """Test metrics on the first batch of ``test_data``
    (``train.py:201-231``)."""
    dtype = next(state.gen.parameters()).dtype
    test = torch.as_tensor(np.asarray(test_data[:cfg.batch_size]),
                           device=device, dtype=dtype)
    z = torch.randn(test.shape[0], cfg.latent_dim, device=device,
                    dtype=dtype, generator=torch.Generator(device=device)
                    .manual_seed(cfg.seed + 2 + epoch))
    with torch.no_grad():
        out_fake = state.disc(_decoded_samples(state, z))
        out_real = state.disc(test)
        recon = state.ae(test)
    return {
        "d_loss_test": float(discriminator_loss(out_real, out_fake)),
        "g_loss_test": float(generator_loss(out_fake)),
        "a_loss_test": float(autoencoder_loss(recon, test, cfg.binary)),
        "accuracy_real": discriminator_accuracy(out_real, True),
        "accuracy_fake": discriminator_accuracy(out_fake, False),
    }


def generate(cfg: MedGANConfig, state: MedGANState,
             out_dir: str | None = None,
             device: torch.device | str | None = None) -> np.ndarray:
    """``generate_N`` decoded samples thresholded at 0.5 into a binary
    float32 matrix, saved as ``<out_dir or PATH>/synthetic.npy``
    (``train.py:247-318``)."""
    device = resolve_device(device)
    dtype = next(state.gen.parameters()).dtype
    z = torch.randn(cfg.generate_N, cfg.latent_dim, device=device,
                    dtype=dtype,
                    generator=torch.Generator(device=device).manual_seed(1234))
    samples = (_decoded_samples(state, z) >= 0.5).float().cpu().numpy()
    out_dir = check_folder(out_dir or cfg.PATH)
    np.save(os.path.join(out_dir, "synthetic.npy"), samples,
            allow_pickle=False)
    return samples


def dimension_wise_probability(real: np.ndarray, syn: np.ndarray
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature Bernoulli means for the evaluation scatter
    (``train.py:320-340``)."""
    n = min(len(real), len(syn))
    return real[:n].mean(axis=0), syn[:n].mean(axis=0)
