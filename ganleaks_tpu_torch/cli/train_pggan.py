"""PGGAN victim training CLI on the GPU (reference entry point:
``gan_models/pggan/train.py``).

    python -m ganleaks_tpu_torch.cli.train_pggan data_path=data/train \
        num_epochs=30 compute_dtype=bfloat16

``training=false saved_model_name=<run dir>`` samples a saved
``generator.pth`` (the port's or the reference's). ``--device cpu`` (or
``main(argv, device="cpu")``) runs on the CPU.
"""

from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import PGGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.train import pggan


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(PGGANConfig, argv,
                               "Progressive GAN victim training (GPU)",
                               device)
    device = resolve_device(device)
    state = pggan.train(cfg, device=device) if cfg.training else None
    if cfg.generate:
        dirs = pggan.generate(cfg, state, device=device)
        print(f"synthetic data: {dirs['png_images']}")


if __name__ == "__main__":
    main()
