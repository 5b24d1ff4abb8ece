"""LPIPS lin-head training on 2AFC human judgments, on ``torch.optim``
(port of ``ganleaks_tpu.ops.lpips.train2afc``):

* :class:`Dist2Logit` (``networks_basic.py:184-199``): 5 -> 32 -> 32 -> 1
  over ``(d0, d1, d0-d1, d0/(d1+eps), d1/(d0+eps))``, LeakyReLU(0.2) and a
  final sigmoid — a distance pair to a predicted human judgment in [0, 1];
* :func:`bce_ranking_loss` (``networks_basic.py:202-219``): BCE between
  that prediction and the judge fraction (the reference's ``judge*2-1`` /
  ``(judge+1)/2`` round trip cancels); ``binary_cross_entropy`` clamps its
  log terms at -100 as the reference's ``nn.BCELoss`` does;
* the train step (``dist_model.py:166-196``): two LPIPS forwards with the
  lin-head dropout active (p = 0.5, ``networks_basic.py:121,228``),
  Adam(lr, betas=(0.5, 0.999)) over the lin heads and the rank net
  (``dist_model.py:98-101``), then ``clamp_weights`` projecting every 1x1
  conv of the LPIPS net to >= 0 (``dist_model.py:172-175``): the lin
  heads, and under ``tune_backbone`` the tower's 1x1 convs (squeeze and
  resnet have some); the rank net is not clamped;
* :func:`linear_lr_schedule` (``dist_model.py:244-251``) and
  :func:`compute_accuracy` (``dist_model.py:208-212``).

The model trains in place: the lin-head buffers (and under
``tune_backbone`` the conv parameters) require grad only inside a step.
Dropout masks come from an explicit ``torch.Generator``; the step takes
them as arguments, so two runs given the same masks take the same step.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganleaks_tpu_torch.ops.lpips.backbones import tap_shapes
from ganleaks_tpu_torch.ops.lpips.lpips import LPIPS, normalize_tensor


# ---------------------------------------------------------------------------
# Dist2LogitLayer / BCERankingLoss
# ---------------------------------------------------------------------------

class Dist2Logit(nn.Module):
    """Predicted P(human prefers p1) from a distance pair. Weights and
    biases are drawn as torch's default init does (uniform in
    ``±1/sqrt(fan_in)``), from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, chn_mid: int = 32, seed: int = 0):
        super().__init__()
        self.model = nn.Sequential(
            nn.Linear(5, chn_mid), nn.LeakyReLU(0.2),
            nn.Linear(chn_mid, chn_mid), nn.LeakyReLU(0.2),
            nn.Linear(chn_mid, 1), nn.Sigmoid())
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for lin in self.linears:
                bound = 1.0 / float(np.sqrt(lin.in_features))
                lin.weight.uniform_(-bound, bound, generator=g)
                lin.bias.uniform_(-bound, bound, generator=g)

    @property
    def linears(self) -> list[nn.Linear]:
        return [m for m in self.model if isinstance(m, nn.Linear)]

    def forward(self, d0: torch.Tensor, d1: torch.Tensor,
                eps: float = 0.1) -> torch.Tensor:
        """``d0``/``d1``: (N,) distances -> (N,) probabilities."""
        x = torch.stack([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)],
                        dim=-1)
        return self.model(x)[..., 0]


def bce_ranking_loss(rank: Dist2Logit, d0: torch.Tensor, d1: torch.Tensor,
                     judge: torch.Tensor) -> torch.Tensor:
    """Mean BCE between ``rank(d0, d1)`` and ``judge`` in [0, 1]."""
    p = rank(d0, d1)
    return F.binary_cross_entropy(p, judge.to(p.dtype).reshape(p.shape))


def compute_accuracy(d0s, d1s, judges) -> float:
    """Fraction of (weighted) human agreement with the metric's ranking
    (``dist_model.py:208-212``): ties count toward p0."""
    d1_lt_d0 = (np.asarray(d1s) < np.asarray(d0s)).astype(np.float64)
    j = np.asarray(judges, np.float64).reshape(d1_lt_d0.shape)
    return float(np.mean(d1_lt_d0 * j + (1.0 - d1_lt_d0) * (1.0 - j)))


def linear_lr_schedule(lr: float, epochs: int, decay_epochs: int,
                       epoch: int) -> float:
    """Constant for ``epochs``, then ``lr/decay_epochs`` subtracted at the
    END of each decay epoch (``dist_model.py:244-251``): the first decay
    epoch still trains at ``lr``, the last at ``lr/decay_epochs``, never
    at 0; floored at 0 when over-called."""
    if epoch < epochs or decay_epochs <= 0:
        return lr
    return max(0.0, lr * (1.0 - (epoch - epochs) / decay_epochs))


# ---------------------------------------------------------------------------
# training-mode LPIPS forward (lin-head dropout active)
# ---------------------------------------------------------------------------

def dropout_masks(model: LPIPS, x_shape: tuple, generator: torch.Generator,
                  device: torch.device | str) -> list[torch.Tensor]:
    """One keep mask per tap (p = 0.5), shaped like the taps of a batch of
    ``x_shape`` (N, H, W, C), drawn on the generator's device and moved to
    ``device``."""
    masks = []
    for h, w, c in tap_shapes(model.net, tuple(x_shape[1:])):
        u = torch.rand((x_shape[0], h, w, c), generator=generator,
                       device=generator.device)
        masks.append((u < 0.5).to(device))
    return masks


def lpips_pair_train(model: LPIPS, x: torch.Tensor, y: torch.Tensor,
                     keep: list[torch.Tensor]) -> torch.Tensor:
    """``lpips_pair`` with the net-lin training dropout: NetLinLayer is
    ``Dropout(p=0.5)`` then the 1x1 conv (``networks_basic.py:228``), so
    each squared-difference map is masked by ``keep`` and doubled before
    the lin head."""
    fx = model.features(x)
    fy = model.features(y)
    val = 0.0
    for fl_x, fl_y, w, k in zip(fx, fy, model.lins, keep):
        diff = torch.square(normalize_tensor(fl_x) - normalize_tensor(fl_y))
        diff = torch.where(k, diff * 2.0, torch.zeros_like(diff))
        lin = torch.sum(diff * w.to(diff.dtype), dim=-1)
        val = val + torch.mean(lin, dim=(1, 2))
    return val


def loss_2afc(model: LPIPS, rank: Dist2Logit, batch: dict, keep0: list,
              keep1: list) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(loss, d0, d1) of one batch of tensors ``ref``/``p0``/``p1``/
    ``judge`` under the given dropout masks."""
    d0 = lpips_pair_train(model, batch["ref"], batch["p0"], keep0)
    d1 = lpips_pair_train(model, batch["ref"], batch["p1"], keep1)
    return bce_ranking_loss(rank, d0, d1, batch["judge"]), d0, d1


@contextlib.contextmanager
def _trainable(model: LPIPS, tune_backbone: bool):
    """Lin heads (and under ``tune_backbone`` the tower) require grad
    inside; the flags are restored on exit."""
    convs = list(model.tower.parameters())
    saved = [p.requires_grad for p in convs]
    for b in model.lins:
        b.requires_grad_(True)
    for p in convs:
        p.requires_grad_(tune_backbone)
    try:
        yield
    finally:
        for b in model.lins:
            b.requires_grad_(False)
        for p, r in zip(convs, saved):
            p.requires_grad_(r)


def clamp_weights(model: LPIPS, tune_backbone: bool = False) -> None:
    """``clamp_weights`` (``dist_model.py:172-175``): every 1x1 conv of the
    LPIPS net to >= 0 — the lin heads, and under ``tune_backbone`` the
    tower's 1x1 conv kernels (not their biases)."""
    with torch.no_grad():
        for b in model.lins:
            b.clamp_(min=0.0)
        if tune_backbone:
            for conv in model.tower.convs:
                if conv.kernel_size == (1, 1):
                    conv.weight.clamp_(min=0.0)


def make_2afc_step(model: LPIPS, rank: Dist2Logit, *,
                   tune_backbone: bool = False, beta1: float = 0.5):
    """``(step, opt)``: ``step(batch, lr, keep0, keep1) -> (loss, d0, d1)``
    takes one Adam step at ``lr`` on the lin heads, the rank net and under
    ``tune_backbone`` the tower, then clamps; ``batch`` holds tensors on
    the model's device."""
    params = list(model.lins) + list(rank.parameters())
    if tune_backbone:
        params += list(model.tower.parameters())
    opt = torch.optim.Adam(params, lr=0.0, betas=(beta1, 0.999))

    def step(batch: dict, lr: float, keep0: list, keep1: list):
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        with _trainable(model, tune_backbone):
            loss, d0, d1 = loss_2afc(model, rank, batch, keep0, keep1)
            loss.backward()
            opt.step()
        clamp_weights(model, tune_backbone)
        return loss.detach(), d0.detach(), d1.detach()

    return step, opt


def train_2afc(model: LPIPS, triplet_batches, *, epochs: int = 5,
               decay_epochs: int = 5, lr: float = 1e-4, beta1: float = 0.5,
               seed: int = 0, tune_backbone: bool = False,
               rank: Dist2Logit | None = None,
               generator: torch.Generator | None = None):
    """Train ``model``'s lin heads (+ the rank net; + the tower under
    ``tune_backbone``) in place on 2AFC judgments, on the model's device.

    ``triplet_batches``: a sequence (or a callable returning an iterable)
    of dicts of numpy arrays ``ref``/``p0``/``p1`` (NHWC in [-1, 1] or
    uint8) and ``judge`` in [0, 1]. Runs ``epochs`` at ``lr``, then
    ``decay_epochs`` of linear decay. Dropout masks are drawn from
    ``generator`` (default: one seeded with ``seed`` on the model's
    device); ``rank`` defaults to ``Dist2Logit(seed=seed)``.

    Returns ``(model, rank, history)`` with per-epoch
    ``{"loss", "acc", "lr"}`` rows."""
    dev = model.shift.device
    if rank is None:
        rank = Dist2Logit(seed=seed).to(device=dev, dtype=model.shift.dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    step, _ = make_2afc_step(model, rank, tune_backbone=tune_backbone,
                             beta1=beta1)
    history = []
    for epoch in range(epochs + max(0, decay_epochs)):
        cur_lr = linear_lr_schedule(lr, epochs, decay_epochs, epoch)
        batches = (triplet_batches() if callable(triplet_batches)
                   else triplet_batches)
        losses, d0s, d1s, gts = [], [], [], []
        for batch in batches:
            dev_batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                         for k, v in batch.items()}
            shape = tuple(dev_batch["ref"].shape)
            keep0 = dropout_masks(model, shape, generator, dev)
            keep1 = dropout_masks(model, shape, generator, dev)
            loss, d0, d1 = step(dev_batch, cur_lr, keep0, keep1)
            losses.append(float(loss))
            d0s.append(d0.cpu().numpy())
            d1s.append(d1.cpu().numpy())
            gts.append(np.asarray(batch["judge"]).reshape(-1))
        history.append({"loss": float(np.mean(losses)),
                        "acc": compute_accuracy(np.concatenate(d0s),
                                                np.concatenate(d1s),
                                                np.concatenate(gts)),
                        "lr": cur_lr})
    return model, rank, history
