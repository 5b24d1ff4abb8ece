"""FID CLI on the GPU (reference entry point: ``z_fid.py:320-334``).

    python -m ganleaks_tpu_torch.cli.fid path1 path2 [--weights inception.npz]

Each path is an image directory, an image npz or an npz of ``mu``/``sigma``.
``--weights`` takes the InceptionV3 npz of the JAX package's schema (what
``python -m ganleaks_tpu_torch.tools.convert_inception`` writes from
torchvision's weights, on the card's machine too); without it the tower
is the seeded surrogate and the FID is a relative metric only. ``--device cpu`` (or ``main(argv, device="cpu")``)
runs on the CPU.

``--n_chips N`` splits each Inception batch over N ranks, one per device,
the activations all-gathered in image order: N processes on this host
(NCCL over ``cuda:0..N-1``, or ``gloo`` with ``--device cpu``), or, under
``torchrun`` (or the ``GANLEAKS_*`` variables of ``parallel/multihost``),
the launcher's processes in place. Rank 0 prints the FID.
"""

from __future__ import annotations

import argparse

from ganleaks_tpu_torch.cli.common import add_device_argument
from ganleaks_tpu_torch.device import resolve_device
from ganleaks_tpu_torch.ops.fid import (SQRTM_METHODS, fid_from_paths,
                                        init_inception_params)
from ganleaks_tpu_torch.parallel import multihost


def _fid(args, device: str) -> float:
    """The FID of ``args`` on this process: on the group's mesh of
    ``args.n_chips`` ranks when there are several."""
    mesh = None
    if args.n_chips > 1:
        multihost.initialize()
        mesh = multihost.global_mesh(args.n_chips, device=device)
    if args.weights:
        from ganleaks_tpu_torch.utils.checkpoint import load_params_npz
        from ganleaks_tpu_torch.weights import inception_from_jax_params

        variables = load_params_npz(args.weights)
        model = inception_from_jax_params(variables)
    else:
        if multihost.process_index() == 0:
            print("# using surrogate InceptionV3 weights (relative FID "
                  "only); convert torchvision weights for standard numbers")
        model = init_inception_params()
    return fid_from_paths(model, args.path[0], args.path[1],
                          args.batch_size, args.sqrtm, device=device,
                          mesh=mesh)


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", type=str, nargs=2,
                    help="image dirs, image npz or .npz statistic files")
    ap.add_argument("--weights", default=None,
                    help="InceptionV3 npz in the JAX package's schema "
                         "(ganleaks_tpu_torch.tools.convert_inception); "
                         "surrogate otherwise")
    ap.add_argument("--batch_size", type=int, default=50)
    ap.add_argument("--sqrtm", default="newton-schulz", choices=SQRTM_METHODS)
    ap.add_argument("--n_chips", type=int, default=1,
                    help="devices to split each Inception batch over, one "
                         "process each")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    # refuse before building the tower when the card is missing
    device = resolve_device(device or args.device)
    if args.n_chips > 1 and not multihost.in_group():
        value = multihost.launch(
            _fid, args.n_chips, args, device.type,
            devices=multihost.local_devices(args.n_chips, device),
            timeout_s=multihost.DEFAULT_TIMEOUT_S)
    else:
        value = _fid(args, device.type)
    if multihost.process_index() == 0:
        print("FID: ", value)


if __name__ == "__main__":
    main()
