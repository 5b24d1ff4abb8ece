"""WGAN-GP victim training CLI on the GPU (reference entry point:
``gan_models/wgangp/train.py``).

    python -m ganleaks_tpu_torch.cli.train_wgangp data_path=data/train

``training=false saved_model_name=<run dir>`` samples a saved
``generator.pth``. ``--device cpu`` (or ``main(argv, device="cpu")``) runs
on the CPU.
"""

from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import WGANGPConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.train import wgangp


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(WGANGPConfig, argv,
                               "WGAN-GP victim training (GPU)", device)
    device = resolve_device(device)
    state = wgangp.train(cfg, device=device) if cfg.training else None
    if cfg.generate:
        dirs = wgangp.generate(cfg, state, device=device)
        print(f"synthetic data: {dirs['png_images']}")


if __name__ == "__main__":
    main()
