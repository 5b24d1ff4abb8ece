"""ROC evaluation CLI (reference entry point: ``attack_models/eval_roc.py``).

    python -m ganleaks_tpu_torch.cli.eval_roc --local_config attack_eval.yaml \
        result_load_dir=fbb_attack/exp1

The evaluation itself runs on the host; like every entry point it asks
for the GPU unless given ``--device cpu`` (or ``main(argv,
device="cpu")``).
"""

from ganleaks_tpu_torch.attack.eval_roc import evaluate_and_plot
from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import EvalConfig
from ganleaks_tpu_torch.device import resolve_device


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(EvalConfig, argv,
                               "attack ROC evaluation", device)
    resolve_device(device)
    out = evaluate_and_plot(cfg)
    print(f"The AUC ROC value of {cfg.attack_type} attack is: "
          f"{out['auc']:.3f}")
    print(f"The precision of {cfg.attack_type} attack is: "
          f"{out['precision']:.3f}")
    if "auc_calibrated" in out:
        print(f"The AUC ROC value of calibrated {cfg.attack_type} attack "
              f"is: {out['auc_calibrated']:.3f}")


if __name__ == "__main__":
    main()
