"""VAE-GAN victim training CLI on the GPU (reference entry points:
``gan_models/vaegan/train.py`` and ``sample.py``).

    python -m ganleaks_tpu_torch.cli.train_vaegan data_path=data/train \
        exp_name=vaegan nepoch=100

Checkpoints, ``netG.npz`` / ``netE.npz`` (what ``cli.reconstruction``
reads) and the metrics go to ``results/<exp_name>/``; a run resumes from
its ``checkpoint.pth``. ``training=false`` samples the saved ``netG.npz``.
``--device cpu`` (or ``main(argv, device="cpu")``) runs on the CPU.

``mesh_shape=[n]`` trains data-parallel on n ranks (``parallel/dp``),
started here on this host (rank r on ``cuda:r % cards``: NCCL where
each has a card of its own, else ``gloo``; ``--device cpu``: ``gloo``
on the CPU), or the ranks of ``torchrun --nproc_per_node n -m
ganleaks_tpu_torch.cli.train_vaegan mesh_shape=[n] ...`` (``multihost=true``
with the ``GANLEAKS_*`` variables across hosts). Rank 0 alone writes
and samples.
"""

import os

from ganleaks_tpu_torch.cli.common import parse_config, train_on_ranks
from ganleaks_tpu_torch.config import VAEGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.parallel import multihost
from ganleaks_tpu_torch.train import vaegan


def _run(cfg, device) -> None:
    """Train (on every rank), then sample (rank 0)."""
    state = vaegan.train(cfg, device=device) if cfg.training else None
    if cfg.generate and multihost.process_index() == 0:
        out = vaegan.sample(cfg, state, os.path.join(
            "results", cfg.exp_name, "samples"), device=device)
        print(f"samples: {out['out_dir']}/generated.npz")


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(VAEGANConfig, argv,
                               "VAE-GAN victim training (GPU)", device)
    train_on_ranks(_run, cfg, resolve_device(device))


if __name__ == "__main__":
    main()
