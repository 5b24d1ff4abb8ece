"""privPGGAN victim training CLI on the GPU (reference entry point:
``gan_models/pggan/privPGGAN.py``), with the grid sweep
(``privPGGAN.py:248-266``).

    python -m ganleaks_tpu_torch.cli.train_privpggan \
        --local_config configs/pggan_config.yaml \
        --grid configs/privgan_grid.yaml data_path=data/train dp_delay=16

``key=value`` overrides go to ``PGGANConfig`` or ``PrivGANConfig`` by
name; each grid point writes its synthetic set under
``<PATH_syn_data>/privPGGAN/<keys>/<values>``. The step runs in float32
whatever ``compute_dtype`` says. ``--device cpu`` (or
``main(argv, device="cpu")``) runs on the CPU.
"""

from ganleaks_tpu_torch.cli.common import priv_main
from ganleaks_tpu_torch.config import PGGANConfig
from ganleaks_tpu_torch.train import priv


def main(argv=None, device=None) -> None:
    priv_main(PGGANConfig, priv.train_privpggan, priv.generate_privpggan,
              "privPGGAN", argv, device)


if __name__ == "__main__":
    main()
