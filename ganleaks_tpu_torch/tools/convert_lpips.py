"""Convert torch LPIPS weights into the LPIPS npz schema that both
packages read (the port's counterpart of
``ganleaks_tpu/tools/convert_lpips.py``).

The reference builds LPIPS from two weight sources
(``lpips_pytorch/models/dist_model.py:63-75``): a torchvision backbone
state dict (vgg16 / alexnet ``features.*``, squeezenet1_1's fire modules,
resnet18's convs and BatchNorms) and the 7 KB lin-head file
(``lin{i}.model.1.weight``, shape (1, C, 1, 1)). Both are plain dicts of
tensors here; torchvision is never imported.

resnet18's eval-mode BatchNorms (eps 1e-5) are folded into the conv before
each in float64 and rounded to float32 once; the JAX converter folds in
float32, so the two files may differ by a rounding in the last place.

Usage:
    python -m ganleaks_tpu_torch.tools.convert_lpips \\
        --net alex --backbone alexnet.pth --out lpips_alex.npz
    # surrogate backbone, real lin heads:
    python -m ganleaks_tpu_torch.tools.convert_lpips \\
        --net vgg --lin vgg_lin.pth --out lpips_vgg_surrogate.npz --seed 0
"""

from __future__ import annotations

import argparse

import numpy as np

# torchvision features.* conv indices per net
VGG16_FEATURE_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
ALEXNET_FEATURE_IDX = [0, 3, 6, 8, 10]
SQUEEZE_FIRE_IDX = [3, 4, 6, 7, 9, 10, 11, 12]  # squeezenet1_1 features
BN_EPS = 1e-5


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _entry(w: np.ndarray, b: np.ndarray) -> dict:
    """{"kernel": HWIO float32, "bias": float32} from an OIHW kernel."""
    return {"kernel": np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(2, 3, 1, 0)),
            "bias": np.asarray(b, np.float32)}


def _conv_entry(sd: dict, prefix: str) -> dict:
    return _entry(_np(sd[f"{prefix}.weight"]), _np(sd[f"{prefix}.bias"]))


def _bn_folded(sd: dict, conv_key: str, bn_key: str) -> dict:
    """Fold an eval-mode BatchNorm into the bias-free conv before it:
    kernel' = w * gamma / sqrt(var + eps) per output channel,
    bias' = beta - mean * gamma / sqrt(var + eps), in float64."""
    w = _np(sd[f"{conv_key}.weight"]).astype(np.float64)
    g, b, mu, var = (_np(sd[f"{bn_key}.{k}"]).astype(np.float64)
                     for k in ("weight", "bias", "running_mean",
                               "running_var"))
    a = g / np.sqrt(var + BN_EPS)
    return _entry(w * a[:, None, None, None], b - mu * a)


def convert_backbone_state_dict(sd: dict, net: str) -> list[dict]:
    """torchvision state dict -> the flat HWIO conv list in the towers'
    traversal order (``backbones.Tower.convs``): vgg/alex read
    ``features.{i}``, squeeze each fire module's three convs, resnet18
    folds every BatchNorm into its conv."""
    if net == "squeeze":
        convs = [_conv_entry(sd, "features.0")]
        for i in SQUEEZE_FIRE_IDX:
            for part in ("squeeze", "expand1x1", "expand3x3"):
                convs.append(_conv_entry(sd, f"features.{i}.{part}"))
        return convs
    if net in ("resnet", "resnet18"):
        convs = [_bn_folded(sd, "conv1", "bn1")]
        for layer in ("layer1", "layer2", "layer3", "layer4"):
            for blk in range(2):
                pre = f"{layer}.{blk}"
                convs.append(_bn_folded(sd, f"{pre}.conv1", f"{pre}.bn1"))
                convs.append(_bn_folded(sd, f"{pre}.conv2", f"{pre}.bn2"))
                if f"{pre}.downsample.0.weight" in sd:
                    convs.append(_bn_folded(sd, f"{pre}.downsample.0",
                                            f"{pre}.downsample.1"))
        return convs
    if net in ("vgg", "vgg16"):
        idxs = VGG16_FEATURE_IDX
    elif net == "alex":
        idxs = ALEXNET_FEATURE_IDX
    else:
        raise ValueError(f"unknown LPIPS backbone {net!r}")
    return [_conv_entry(sd, f"features.{i}") for i in idxs]


def convert_lin_state_dict(sd: dict) -> list[np.ndarray]:
    """``lin{i}.model.1.weight`` (1, C, 1, 1) -> (C,) vectors; warns about
    negative weights (the embedding path clamps them to 0)."""
    lins = []
    i = 0
    while f"lin{i}.model.1.weight" in sd:
        w = _np(sd[f"lin{i}.model.1.weight"]).astype(np.float32).reshape(-1)
        if (w < 0).any():
            print(f"WARNING: lin{i} has {(w < 0).sum()} negative weights; "
                  "they will be clamped to 0 in the embedding path")
        lins.append(w)
        i += 1
    if not lins:
        raise ValueError("no lin{i}.model.1.weight keys found")
    return lins


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="vgg",
                    choices=["vgg", "alex", "squeeze", "resnet18"])
    ap.add_argument("--backbone", default=None,
                    help="torchvision state-dict .pth (omit for surrogate)")
    ap.add_argument("--lin", default=None,
                    help="LPIPS lin-head .pth (e.g. the reference's vgg.pth)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0,
                    help="surrogate backbone seed when --backbone omitted")
    args = ap.parse_args(argv)

    import torch

    from ganleaks_tpu_torch.ops.lpips.lpips import (init_lpips_params,
                                                    save_lpips_params)
    from ganleaks_tpu_torch.weights import (lpips_from_jax_params,
                                            lpips_to_jax_params)

    lins = None
    if args.lin:
        lins = convert_lin_state_dict(
            torch.load(args.lin, map_location="cpu"))
    model = init_lpips_params(args.seed, args.net, lin_weights=lins)
    if args.backbone:
        sd = torch.load(args.backbone, map_location="cpu")
        params = lpips_to_jax_params(model)
        params["convs"] = convert_backbone_state_dict(sd, args.net)
        model = lpips_from_jax_params(params)
    save_lpips_params(args.out, model)
    print(f"wrote {args.out} (net={args.net}, "
          f"backbone={'converted' if args.backbone else 'surrogate'})")


if __name__ == "__main__":
    main()
