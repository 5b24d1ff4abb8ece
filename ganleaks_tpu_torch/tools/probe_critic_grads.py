"""Where the generator step's gradient leaves float64 in the DCGAN and
WGAN-GP victims (configs' widths, 64 px): from the same seeded weights,
seeded noise through the generator (train mode) and the discriminator /
critic layer by layer, and the G loss's gradient at every layer's input
(L2 relative to float64 on the CPU, the worst of ``--steps`` draws) in
float32 on the device with cuDNN (the trainers' numerics) and, on the
card, without it.

The input of ``disc.0`` is the gradient the generator receives; a layer
whose input reads far worse than its output is where the error enters.

    python -m ganleaks_tpu_torch.tools.probe_critic_grads
    python -m ganleaks_tpu_torch.tools.probe_critic_grads --device cpu \\
        --batch 2 --steps 1

Prints one JSON line per victim (on the card with the card's name and
power limit, as ``nvidia-smi`` gives them).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ganleaks_tpu_torch.config import DCGANConfig, WGANGPConfig
from ganleaks_tpu_torch.device import card_line, resolve_device
from ganleaks_tpu_torch.train import dcgan, wgangp
from ganleaks_tpu_torch.train.gan import bce_with_logits

KINDS = ("dcgan", "wgangp")
SEED = 0  # the weights' and the noise's


def _input_grads(kind: str, cfg, noise: list, dev, dtype) -> list[dict]:
    """Per draw: layer name -> the G loss's gradient at its input."""
    state = (dcgan if kind == "dcgan" else wgangp).build_state(cfg, dev,
                                                               dtype)
    layers = [(n, m) for n, m in state.disc.named_modules()
              if n and not list(m.children())]
    out = []
    for z in noise:
        x, ins = state.gen(torch.from_numpy(z).to(dev, dtype)), []
        for _, layer in layers:
            x.retain_grad()
            ins.append(x)
            x = layer(x)
        score = x.reshape(x.shape[0])
        loss = (bce_with_logits(score, 1.0) if kind == "dcgan"
                else -score.mean())
        loss.backward()
        out.append({n: t.grad.double().cpu().numpy()
                    for (n, _), t in zip(layers, ins)})
    return out


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    norm = float(np.linalg.norm(want))
    diff = float(np.linalg.norm(got - want))
    return diff / norm if norm else (0.0 if diff == 0.0 else float("inf"))


def probe(kind: str, device: str | None = None, batch: int = 8,
          steps: int = 3) -> dict:
    """``{"victim", "batch", "steps", "input_grad": {layer: {label:
    error}}}`` with labels ``f32`` (cuDNN as the trainers run it) and, on
    the card, ``f32_no_cudnn``."""
    dev = resolve_device(device)
    cfg = (DCGANConfig(seed=SEED) if kind == "dcgan"
           else WGANGPConfig(seed=SEED))
    rng = np.random.default_rng(SEED)
    noise = [rng.standard_normal((batch, cfg.nz)).astype(np.float32)
             for _ in range(steps)]
    ref = _input_grads(kind, cfg, noise, "cpu", torch.float64)
    labels = (("f32", True), ("f32_no_cudnn", False)) if dev.type == "cuda" \
        else (("f32", True),)
    before = torch.backends.cudnn.enabled
    out: dict = {}
    try:
        for label, cudnn in labels:
            torch.backends.cudnn.enabled = cudnn
            got = _input_grads(kind, cfg, noise, dev, torch.float32)
            for name in ref[0]:
                out.setdefault(name, {})[label] = max(
                    _rel_l2(g[name], r[name]) for g, r in zip(got, ref))
    finally:
        torch.backends.cudnn.enabled = before
    return {"victim": kind, "batch": batch, "steps": steps,
            "device": str(dev), "input_grad": out}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    card = card_line(resolve_device(args.device))
    recs = []
    for kind in KINDS:
        rec = probe(kind, args.device, args.batch, args.steps)
        if card is not None:
            rec["card"] = card
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
