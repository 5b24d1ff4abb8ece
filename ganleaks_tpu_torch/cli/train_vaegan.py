"""VAE-GAN victim training CLI on the GPU (reference entry points:
``gan_models/vaegan/train.py`` and ``sample.py``).

    python -m ganleaks_tpu_torch.cli.train_vaegan data_path=data/train \
        exp_name=vaegan nepoch=100

Checkpoints, ``netG.npz`` / ``netE.npz`` (what ``cli.reconstruction``
reads) and the metrics go to ``results/<exp_name>/``; a run resumes from
its ``checkpoint.pth``. ``training=false`` samples the saved ``netG.npz``.
``--device cpu`` (or ``main(argv, device="cpu")``) runs on the CPU.
"""

import os

from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import VAEGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.train import vaegan


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(VAEGANConfig, argv,
                               "VAE-GAN victim training (GPU)", device)
    device = resolve_device(device)
    state = vaegan.train(cfg, device=device) if cfg.training else None
    if cfg.generate:
        out = vaegan.sample(cfg, state, os.path.join(
            "results", cfg.exp_name, "samples"), device=device)
        print(f"samples: {out['out_dir']}/generated.npz")


if __name__ == "__main__":
    main()
