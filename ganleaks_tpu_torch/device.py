"""Device choice and numerics setup for the port's entry points."""

from __future__ import annotations

import torch


def set_f32_numerics() -> None:
    """Turn TF32 off for float32 matmuls and convolutions.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); the parity path against the JAX package needs true float32 in
    the VGG tower and in the gemm fold."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for ``cpu``. With no GPU and no explicit ``device="cpu"`` this raises;
    it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    set_f32_numerics()
    return dev


def card_line(device: str | torch.device) -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (every time a tool
    reports is taken beside it); None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
