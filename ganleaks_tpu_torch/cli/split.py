"""CelebA member / non-member split CLI (port of ``ganleaks_tpu.cli.split``;
reference entry point ``z_split.py``).

    python -m ganleaks_tpu_torch.cli.split --local_config split.yaml \
        input_dir=data/img_align_celeba num_images=10020

Host work (Pillow reads the JPEG sources, the port's codec writes the
PNGs): it runs the same with any ``--device``.
"""

from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import SplitConfig
from ganleaks_tpu_torch.tools.z_split import run_split


def main(argv=None) -> dict[str, int]:
    cfg, _device = parse_config(SplitConfig, argv,
                                "CelebA member/non-member split")
    counts = run_split(cfg)
    print(f"members: {counts['members']}  "
          f"non-members: {counts['non_members']}")
    return counts


if __name__ == "__main__":
    main()
