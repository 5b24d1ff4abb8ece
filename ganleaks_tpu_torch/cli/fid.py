"""FID CLI on the GPU (reference entry point: ``z_fid.py:320-334``).

    python -m ganleaks_tpu_torch.cli.fid path1 path2 [--weights inception.npz]

Each path is an image directory, an image npz or an npz of ``mu``/``sigma``.
``--weights`` takes the InceptionV3 npz of the JAX package's schema (what
``ganleaks_tpu.tools.convert_inception`` writes from torchvision's
weights); without it the tower is the seeded surrogate and the FID is a
relative metric only. ``--device cpu`` (or ``main(argv, device="cpu")``)
runs on the CPU.
"""

from __future__ import annotations

import argparse

from ganleaks_tpu_torch.cli.common import add_device_argument
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.ops.fid import (SQRTM_METHODS, fid_from_paths,
                                        init_inception_params)


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", type=str, nargs=2,
                    help="image dirs, image npz or .npz statistic files")
    ap.add_argument("--weights", default=None,
                    help="InceptionV3 npz in the JAX package's schema "
                         "(tools/convert_inception.py); surrogate otherwise")
    ap.add_argument("--batch_size", type=int, default=50)
    ap.add_argument("--sqrtm", default="newton-schulz", choices=SQRTM_METHODS)
    ap.add_argument("--n_chips", type=int, default=1,
                    help="devices to shard the featurisation over; only 1 "
                         "is ported")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    # refuse before building the tower when the card is missing
    device = resolve_device(device or args.device)
    if args.n_chips > 1:
        raise NotImplementedError(
            "multi-GPU featurisation is not ported yet (ROADMAP M12)")

    if args.weights:
        from ganleaks_tpu_torch.utils.checkpoint import load_params_npz
        from ganleaks_tpu_torch.weights import inception_from_jax_params

        variables = load_params_npz(args.weights)
        model = inception_from_jax_params(variables)
    else:
        print("# using surrogate InceptionV3 weights (relative FID only); "
              "convert torchvision weights for standard numbers")
        model = init_inception_params()
    value = fid_from_paths(model, args.path[0], args.path[1],
                           args.batch_size, args.sqrtm, device=device)
    print("FID: ", value)


if __name__ == "__main__":
    main()
