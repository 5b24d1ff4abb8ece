"""The one traffic generator: image sets drawn on the card from the seed,
with the parameters of a workload file's ``traffic``.

An image is a random ``layout`` x ``layout`` grid of RGB bytes, upsampled
to the resolution, plus uniform pixel noise in [-``pixel_noise``,
``pixel_noise``] (the distribution of the program's ``chip_smoke``
``north_star_images``, copied). The members and the non-members are drawn
once a run. Each call's synthetic set is drawn anew from (seed, call
index), and ``planted`` members chosen at random get a noisy copy (noise
in [-``copy_noise``, ``copy_noise``]) in random slots of it, as a victim
that memorised them would generate.

Traffic keys: ``members``, ``non_members``, ``synthetic``, ``planted``,
``layout``, ``pixel_noise``, ``copy_noise``.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 8192  # images drawn per step: bounds the int16 temporaries
WINDOW, WARMUP = 2, 4  # the synthetic sets' streams of a seed


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    words = np.random.SeedSequence([seed % 2 ** 64, *tags]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, device, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def draw_images(gen: torch.Generator, n: int, res: int, traffic: dict,
                device) -> torch.Tensor:
    """``n`` uint8 NHWC images on ``device``."""
    lay, noise = traffic["layout"], traffic["pixel_noise"]
    if res % lay:
        raise ValueError(f"layout {lay} does not divide resolution {res}")
    out = torch.empty((n, res, res, 3), dtype=torch.uint8, device=device)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        base = torch.randint(0, 256, (m, lay, lay, 3), generator=gen,
                             device=device, dtype=torch.int16)
        up = base.repeat_interleave(res // lay, 1).repeat_interleave(
            res // lay, 2)
        up += torch.randint(-noise, noise + 1, up.shape, generator=gen,
                            device=device, dtype=torch.int16)
        out[lo:lo + m] = up.clamp_(0, 255).to(torch.uint8)
    return out


def queries(traffic: dict, res: int, seed: int, device
            ) -> tuple[np.ndarray, np.ndarray]:
    """(members, non-members) as host uint8 arrays."""
    gen = generator(seed, device, 1)
    pos = draw_images(gen, traffic["members"], res, traffic, device)
    neg = draw_images(gen, traffic["non_members"], res, traffic, device)
    return pos.cpu().numpy(), neg.cpu().numpy()


def synthetic(traffic: dict, res: int, seed: int, call: int,
              members: np.ndarray, device, stream: int = WINDOW
              ) -> torch.Tensor:
    """Call ``call``'s synthetic set on ``device``, the members' noisy
    copies planted; ``stream`` WARMUP draws the warm-up calls' sets,
    which no window call sees."""
    gen = generator(seed, device, stream, call)
    n, k = traffic["synthetic"], traffic["planted"]
    syn = draw_images(gen, n, res, traffic, device)
    if k:
        slots = torch.randperm(n, generator=gen, device=device)[:k]
        which = torch.randperm(len(members), generator=gen,
                               device=device)[:k]
        src = torch.from_numpy(members).to(device)[which].to(torch.int16)
        noise = traffic["copy_noise"]
        src += torch.randint(-noise, noise + 1, src.shape, generator=gen,
                             device=device, dtype=torch.int16)
        syn[slots] = src.clamp_(0, 255).to(torch.uint8)
    return syn


def checksum(images: torch.Tensor) -> int:
    """The sum of a set's bytes: a regenerated set must match it."""
    return int(images.sum(dtype=torch.int64))
