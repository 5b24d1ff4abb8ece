"""privDCGAN victim training CLI on the GPU (reference entry point:
``gan_models/dcgan/privDCGAN.py``), with the grid sweep
(``privDCGAN.py:73-92``).

    python -m ganleaks_tpu_torch.cli.train_privdcgan \
        --local_config configs/dcgan_config.yaml \
        --grid configs/privgan_grid.yaml data_path=data/train dp_delay=10

``key=value`` overrides go to ``DCGANConfig`` or ``PrivGANConfig`` by
name; each grid point writes its synthetic set under
``<PATH_syn_data>/privDCGAN/<keys>/<values>``. ``--device cpu`` (or
``main(argv, device="cpu")``) runs on the CPU.
"""

from ganleaks_tpu_torch.cli.common import priv_main
from ganleaks_tpu_torch.config import DCGANConfig
from ganleaks_tpu_torch.train import priv


def main(argv=None, device=None) -> None:
    priv_main(DCGANConfig, priv.train_privdcgan, priv.generate_privdcgan,
              "privDCGAN", argv, device)


if __name__ == "__main__":
    main()
