"""Tabular fbb attack CLI on the GPU (medGAN path; BASELINE config #4),
writing the fbb artifact layout so ``cli.eval_roc`` runs unchanged:

    python -m ganleaks_tpu_torch.cli.fbb_tabular \
        syn_data_path=syn_data/medgan/run1/synthetic.npy \
        dataset_csv=data/MIMIC_III/mimic.csv engine=pallas
    python -m ganleaks_tpu_torch.cli.eval_roc \
        result_load_dir=fbb_attack/fbb_tabular_debug

``engine=pallas`` selects the fused CUDA distance+argmin kernel.
``--device cpu`` (or ``main(argv, device="cpu")``) runs on the CPU.
"""

from ganleaks_tpu_torch.attack.tabular import run_tabular_attack
from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import TabularAttackConfig


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(
        TabularAttackConfig, argv,
        "full-black-box MI attack on tabular records (GPU)", device)
    out = run_tabular_attack(cfg, device)
    print(f"saved {out['save_dir']}  "
          f"({out['query_pairs_per_sec']:.3g} query-pairs/sec)")


if __name__ == "__main__":
    main()
