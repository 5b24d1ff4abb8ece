"""fbb attack CLI on the GPU (reference entry point: ``attack_models/fbb.py``).

    python -m ganleaks_tpu_torch.cli.fbb --local_config config_attack_fbb.yaml \
        syn_data_path=syn/png_images/run1 distance=l2-lpips engine=pallas

``engine=pallas`` selects the fused CUDA distance+argmin kernel, as the
same name selects the fused Pallas kernel in the JAX package. ``--device
cpu`` (or ``main(argv, device="cpu")``) runs on the CPU.

Several GPUs (``parallel/multihost``):

* ``n_chips=N`` alone: N processes on this host, one per card (NCCL over
  ``cuda:0..N-1``; refused where fewer are visible); with ``--device cpu``
  N ``gloo`` processes on the CPU;
* under ``torchrun --nproc_per_node N -m ganleaks_tpu_torch.cli.fbb
  n_chips=N ...``, or with ``multihost=true`` and ``GANLEAKS_COORDINATOR``
  / ``GANLEAKS_NUM_PROCESSES`` / ``GANLEAKS_PROCESS_ID`` set on each host:
  the processes the launcher started run in place.

Only rank 0 writes the artifacts and prints the results.
"""

from ganleaks_tpu_torch.attack.fbb import launch_attack, run_attack
from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.parallel import multihost


def main(argv=None, device=None) -> None:
    cfg, device = parse_config(AttackConfig, argv,
                               "full-black-box MI attack (GPU)",
                               device)
    if cfg.n_chips > 1 and not cfg.multihost and not multihost.in_group():
        results = launch_attack(cfg, device)
    else:
        results = run_attack(cfg, device)
    if multihost.process_index() != 0:
        return
    for r in results:
        print(f"saved {r['save_dir']}  "
              f"({r['query_pairs_per_sec']:.3g} query-pairs/sec)")


if __name__ == "__main__":
    main()
