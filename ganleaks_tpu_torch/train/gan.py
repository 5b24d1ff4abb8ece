"""The DCGAN training step (port of ``ganleaks_tpu.train.gan``; reference
``gan_models/dcgan/train_torch.py:93-113``), in the reference's torch
idiom:

* ``fake`` comes from one train-mode generator forward per step on fresh
  noise (``:95-96``), so G's BatchNorm running statistics advance once;
* the discriminator sees ``fake.detach()`` and ``real`` in two forwards,
  loss ``(BCE(D(real), 1) + BCE(D(fake), 0)) / 2`` (``:99-106``);
* the generator's loss is ``BCE(D(fake), 1)`` against the UPDATED
  discriminator on the same fake (``:109-113``), a third D forward.

The JAX step re-applies G inside its loss with the same noise and
parameters, which gives the same fake and discards that forward's
statistics: the two steps compute the same thing. BCE is taken from
logits (the reference's Sigmoid + BCELoss clamps the log at -100 instead).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ganleaks_tpu_torch.ops.nn import batch_draw, batch_loss
from ganleaks_tpu_torch.train.state import GANState


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    return batch_loss(F.binary_cross_entropy_with_logits, logits,
                      torch.full_like(logits, target))


def latent(state: GANState, batch: int, like: torch.Tensor,
           generator: torch.Generator | None) -> torch.Tensor:
    """One (batch, nz) standard normal draw on ``like``'s device (on the
    batch axis, this rank's rows of the global batch's draw)."""
    return batch_draw(lambda n: torch.randn(
        n, state.gen.nz, generator=generator, device=like.device,
        dtype=like.dtype), batch)


def dcgan_train_step(state: GANState, real: torch.Tensor,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None) -> dict:
    """One D + G update on ``real`` (NCHW in [-1, 1]); ``noise`` (N, nz)
    defaults to a draw from ``generator``. Returns the two losses (device
    scalars)."""
    gen, disc = state.gen, state.disc
    if noise is None:
        noise = latent(state, real.shape[0], real, generator)
    fake = gen(noise)

    loss_d = (bce_with_logits(disc(real), 1.0)
              + bce_with_logits(disc(fake.detach()), 0.0)) / 2.0
    state.opt_disc.zero_grad(set_to_none=True)
    loss_d.backward()
    state.opt_disc.step()

    loss_g = bce_with_logits(disc(fake), 1.0)
    state.opt_gen.zero_grad(set_to_none=True)
    loss_g.backward()
    state.opt_gen.step()
    state.step += 1
    return {"loss_disc": loss_d.detach(), "loss_gen": loss_g.detach()}
