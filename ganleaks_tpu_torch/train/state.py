"""Train state of a GAN victim (port of ``ganleaks_tpu.train.state``): the
two networks, their optimisers and the step count. The JAX package keeps
them as one pytree a pure step maps to the next; here the step updates
the modules and optimisers in place, as the reference does
(``train_torch.py:76-83``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class GANState:
    gen: nn.Module
    disc: nn.Module                # the discriminator or the critic
    opt_gen: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer
    step: int = 0


def adam_torch(params, lr: float, beta1: float, beta2: float,
               weight_decay: float = 0.0, eps: float = 1e-8
               ) -> torch.optim.Adam:
    """``torch.optim.Adam``, the optimiser the JAX package's
    ``adam_torch`` reproduces: ``weight_decay`` is L2 added to the
    gradient before the moments (not decoupled AdamW)."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=eps,
                            weight_decay=weight_decay)
