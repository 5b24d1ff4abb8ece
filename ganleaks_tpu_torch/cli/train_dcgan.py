"""DCGAN victim training CLI on the GPU (reference entry point:
``gan_models/dcgan/train_torch.py``).

    python -m ganleaks_tpu_torch.cli.train_dcgan --local_config dcgan.yaml \
        data_path=data/train num_epochs=100

``training=false saved_model_name=<run dir>`` samples a saved
``generator.pth`` (the port's or the reference's). ``--device cpu`` (or
``main(argv, device="cpu")``) runs on the CPU.
"""

from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import DCGANConfig
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.train import dcgan


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(DCGANConfig, argv,
                               "DCGAN victim training (GPU)", device)
    device = resolve_device(device)
    state = dcgan.train(cfg, device=device) if cfg.training else None
    if cfg.generate:
        dirs = dcgan.generate(cfg, state, device=device)
        print(f"synthetic data: {dirs['png_images']}")


if __name__ == "__main__":
    main()
