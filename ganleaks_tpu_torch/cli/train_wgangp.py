"""WGAN-GP victim training CLI on the GPU (reference entry point:
``gan_models/wgangp/train.py``).

    python -m ganleaks_tpu_torch.cli.train_wgangp data_path=data/train

``training=false saved_model_name=<run dir>`` samples a saved
``generator.pth``. ``--device cpu`` (or ``main(argv, device="cpu")``) runs
on the CPU.

``mesh_shape=[n]`` trains data-parallel on n ranks (``parallel/dp``),
started here on this host (rank r on ``cuda:r % cards``: NCCL where
each has a card of its own, else ``gloo``; ``--device cpu``: ``gloo``
on the CPU), or the ranks of ``torchrun --nproc_per_node n -m
ganleaks_tpu_torch.cli.train_wgangp mesh_shape=[n] ...`` (``multihost=true``
with the ``GANLEAKS_*`` variables across hosts). Rank 0 alone writes
and samples.
"""

from ganleaks_tpu_torch.cli.common import parse_config, train_on_ranks
from ganleaks_tpu_torch.config import WGANGPConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.parallel import multihost
from ganleaks_tpu_torch.train import wgangp


def _run(cfg, device) -> None:
    """Train (on every rank), then sample (rank 0)."""
    state = wgangp.train(cfg, device=device) if cfg.training else None
    if cfg.generate and multihost.process_index() == 0:
        dirs = wgangp.generate(cfg, state, device=device)
        print(f"synthetic data: {dirs['png_images']}")


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(WGANGPConfig, argv,
                               "WGAN-GP victim training (GPU)", device)
    train_on_ranks(_run, cfg, resolve_device(device))


if __name__ == "__main__":
    main()
