"""torchvision ``inception_v3`` state dict -> the InceptionV3 pool_3
parameter npz both packages read (port of
``ganleaks_tpu.tools.convert_inception``; it imports no JAX, so it runs on
the card's machine).

With torchvision's weights file (``inception_v3_google-*.pth``, which
this repository does not ship or download) FID is the standard one;
``cli/fid.py`` and ``ops/fid`` take the npz as ``weights``
(``weights.inception_from_jax_params``), and so does the JAX package.
The port's ``weights.inception_from_torchvision_state_dict`` also loads
the state dict directly.

Usage:
    python -m ganleaks_tpu_torch.tools.convert_inception \
        --state_dict inception_v3_google.pth --out inception_pool3.npz
"""

from __future__ import annotations

import argparse

from ganleaks_tpu_torch import weights


def convert_state_dict(sd: dict) -> dict:
    """The flax variables of the tower (``ops/inception.py``'s module
    names) from a torchvision state dict: loaded into the port's tower,
    which refuses unknown and missing keys, and written with
    ``weights.inception_to_jax_params``."""
    return weights.inception_to_jax_params(
        weights.inception_from_torchvision_state_dict(sd))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="torchvision inception_v3 state dict -> pool_3 npz")
    ap.add_argument("--state_dict", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from ganleaks_tpu_torch.utils.checkpoint import save_params_npz

    # torchvision's file is a plain state dict; a whole pickled module
    # needs the full unpickler, which runs code from the file
    try:
        sd = torch.load(args.state_dict, map_location="cpu")
    except Exception:
        sd = torch.load(args.state_dict, map_location="cpu",
                        weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    save_params_npz(args.out, convert_state_dict(sd))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
