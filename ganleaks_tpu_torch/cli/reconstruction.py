"""Reconstruction-attack CLI on the GPU (BASELINE config #3; the artifact
layout mirrors ``attack_models/fbb.py`` so ``cli.eval_roc`` evaluates the
run unchanged).

    python -m ganleaks_tpu_torch.cli.reconstruction --local_config recon.yaml \
        netE=runs/vaegan/netE.msgpack netG=runs/vaegan/netG.msgpack

``netE`` / ``netG`` also take npz files: the port's VAE-GAN trainer's, or
a reference checkpoint converted by ``python -m
ganleaks_tpu_torch.tools.convert_victim --model vaegan --part encoder``.
``--device cpu`` (or ``main(argv, device="cpu")``) runs on the CPU.
"""

from ganleaks_tpu_torch.attack.reconstruction import run_reconstruction_attack
from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import ReconstructionConfig


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(
        ReconstructionConfig, argv,
        "encoder-seeded reconstruction MI attack (GPU)", device)
    out = run_reconstruction_attack(cfg, device)
    print(f"saved {out['save_dir']}  "
          f"({out['queries_per_sec']:.3g} queries/sec)")


if __name__ == "__main__":
    main()
