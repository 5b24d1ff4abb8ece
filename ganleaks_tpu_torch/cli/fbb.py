"""fbb attack CLI on the GPU (reference entry point: ``attack_models/fbb.py``).

    python -m ganleaks_tpu_torch.cli.fbb --local_config config_attack_fbb.yaml \
        syn_data_path=syn/png_images/run1 distance=l2-lpips engine=pallas

``engine=pallas`` selects the fused CUDA distance+argmin kernel, as the
same name selects the fused Pallas kernel in the JAX package. ``--device
cpu`` (or ``main(argv, device="cpu")``) runs on the CPU.
"""

from ganleaks_tpu_torch.attack.fbb import run_attack
from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import AttackConfig


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(AttackConfig, argv,
                               "full-black-box MI attack (GPU)",
                               device)
    for r in run_attack(cfg, device):
        print(f"saved {r['save_dir']}  "
              f"({r['query_pairs_per_sec']:.3g} query-pairs/sec)")


if __name__ == "__main__":
    main()
