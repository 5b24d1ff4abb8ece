"""Carry LPIPS weights between the JAX package and the port.

The JAX package holds LPIPS params as ``{"net", "convs": [{"kernel": HWIO,
"bias": (O,)}], "lins": [(C,)]}`` (``ganleaks_tpu/ops/lpips/lpips.py:74``,
saved to npz by ``save_lpips_params``). These functions take that dict with
numpy (or any array-like) leaves and build the port's :class:`LPIPS`
module, transposing the kernels HWIO -> OIHW, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from ganleaks_tpu_torch.ops.lpips.lpips import LPIPS


def lpips_from_jax_params(params: dict) -> LPIPS:
    """The port's LPIPS module from the JAX params layout."""
    model = LPIPS(str(params["net"]))
    convs = model.tower.convs
    if len(params["convs"]) != len(convs):
        raise ValueError(f"{len(params['convs'])} convs in the params, the "
                         f"{model.net} tower has {len(convs)}")
    with torch.no_grad():
        for conv, p in zip(convs, params["convs"]):
            kernel = np.asarray(p["kernel"], np.float32)
            oihw = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
            if oihw.shape != conv.weight.shape:
                raise ValueError(f"kernel {kernel.shape} (HWIO) does not "
                                 f"fit conv {tuple(conv.weight.shape)}")
            conv.weight.copy_(oihw)
            conv.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))
        for buf, lin in zip(model.lins, params["lins"]):
            buf.copy_(torch.tensor(np.asarray(lin, np.float32).reshape(-1)))
    return model


def lpips_to_jax_params(model: LPIPS) -> dict:
    """The JAX params layout (numpy leaves) of the port's module."""
    convs = []
    for conv in model.tower.convs:
        w = conv.weight.detach().cpu().numpy()
        convs.append({"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                      "bias": conv.bias.detach().cpu().numpy().copy()})
    lins = [lin.detach().cpu().numpy().copy() for lin in model.lins]
    return {"net": model.net, "convs": convs, "lins": lins}
