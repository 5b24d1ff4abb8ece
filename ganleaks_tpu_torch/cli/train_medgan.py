"""medGAN victim training CLI on the GPU (reference entry point:
``gan_models/medgan/train.py``).

    python -m ganleaks_tpu_torch.cli.train_medgan \
        DATASETPATH=data/mimic.csv n_epochs=1000

Trains on the CSV's 90% split (read without pandas), saves the three nets
under ``<PATH>/medgan/<timestamp>/`` and writes ``<PATH>/synthetic.npy``,
the tabular attack's synthetic rows. The reference asserts that training
and generation are exclusive (``train.py:123,249``); like the JAX
package, this trains and then generates in one run. ``--device cpu`` (or
``main(argv, device="cpu")``) runs on the CPU.

``mesh_shape=[n]`` trains data-parallel on n ranks (``parallel/dp``),
started here on this host (rank r on ``cuda:r % cards``: NCCL where
each has a card of its own, else ``gloo``; ``--device cpu``: ``gloo``
on the CPU), or the ranks of ``torchrun --nproc_per_node n -m
ganleaks_tpu_torch.cli.train_medgan mesh_shape=[n] ...`` (``multihost=true``
with the ``GANLEAKS_*`` variables across hosts). Rank 0 alone writes
and samples.
"""

import os

from ganleaks_tpu_torch.cli.common import parse_config, train_on_ranks
from ganleaks_tpu_torch.config import MedGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.parallel import multihost
from ganleaks_tpu_torch.train import medgan


def _run(cfg, device) -> None:
    """Train (on every rank), then sample (rank 0)."""
    state = medgan.train(cfg, device=device) if cfg.training else None
    if (cfg.generate and state is not None
            and multihost.process_index() == 0):
        medgan.generate(cfg, state, device=device)
        print(f"synthetic data: {os.path.join(cfg.PATH, 'synthetic.npy')}")


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(MedGANConfig, argv,
                               "medGAN victim training (GPU)", device)
    train_on_ranks(_run, cfg, resolve_device(device))


if __name__ == "__main__":
    main()
