"""Carry weights between the JAX package and the port.

* LPIPS: the JAX params ``{"net", "convs": [{"kernel": HWIO, "bias": (O,)}],
  "lins": [(C,)]}`` (``ganleaks_tpu/ops/lpips/lpips.py:74``, saved to npz
  by ``save_lpips_params``) <-> the port's :class:`LPIPS`.
* InceptionV3 pool_3: the flax variables ``{"params", "batch_stats"}`` of
  ``ganleaks_tpu.ops.inception.InceptionV3Pool3`` (conv kernels HWIO, BN
  ``scale``/``bias`` and ``mean``/``var``) <-> the port's tower; and a
  torchvision-layout state dict (what ``tools/convert_inception.py``
  converts), ``fc.*`` and ``AuxLogits.*`` skipped. One weights file
  serves both packages.
* VAE-GAN encoder and generator: the variables ``{"params",
  "batch_stats", "spectral"}`` that the JAX trainer saves and
  ``tools/convert_victim.py`` writes <-> the port's modules
  (:func:`load_jax_tree` / :func:`dump_jax_tree`).

Leaves are numpy (or any array-like); kernels are transposed HWIO -> OIHW
(conv), HWIO -> IOHW (transposed conv, ``transpose(2, 3, 0, 1)``) and
(in, out) -> (out, in) (dense).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ganleaks_tpu_torch.ops.inception import BasicConv2d, InceptionV3Pool3
from ganleaks_tpu_torch.ops.lpips.lpips import LPIPS
from ganleaks_tpu_torch.ops.nn import BatchNormTorch, SNConvTranspose2d


def _copy(dst: torch.Tensor, src, name: str) -> None:
    val = torch.from_numpy(np.ascontiguousarray(np.asarray(src, np.float32)))
    if val.shape != dst.shape:
        raise ValueError(f"{name}: shape {tuple(val.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(val)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# InceptionV3 pool_3
# ---------------------------------------------------------------------------

def _subtree(tree: dict, dotted: str) -> dict:
    node = tree
    for part in dotted.split("."):
        try:
            node = node[part]
        except KeyError:
            raise KeyError(f"{dotted}: no {part!r} in the parameter "
                           f"tree") from None
    return node


def inception_from_jax_params(variables: dict) -> InceptionV3Pool3:
    """The port's tower (on the CPU, eval mode) from the flax variables
    ``{"params", "batch_stats"}`` of the JAX ``InceptionV3Pool3`` — also
    what ``tools/convert_inception.py`` writes and ``load_params_npz``
    reads back."""
    model = InceptionV3Pool3()
    params = variables["params"]
    stats = variables["batch_stats"]
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, BasicConv2d):
                continue
            p, s = _subtree(params, name), _subtree(stats, name)
            _copy(mod.conv.weight,
                  np.asarray(p["conv"]).transpose(3, 2, 0, 1), name)
            _copy(mod.bn.weight, p["bn"]["scale"], name)
            _copy(mod.bn.bias, p["bn"]["bias"], name)
            _copy(mod.bn.running_mean, s["bn"]["mean"], name)
            _copy(mod.bn.running_var, s["bn"]["var"], name)
    return model.eval()


def inception_to_jax_params(model: InceptionV3Pool3) -> dict:
    """The flax variables layout (numpy leaves) of the port's tower."""
    params: dict = {}
    stats: dict = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, BasicConv2d):
            continue
        p, s = params, stats
        for part in name.split("."):
            p, s = p.setdefault(part, {}), s.setdefault(part, {})
        p["conv"] = np.ascontiguousarray(
            _np(mod.conv.weight).transpose(2, 3, 1, 0))
        p["bn"] = {"scale": _np(mod.bn.weight), "bias": _np(mod.bn.bias)}
        s["bn"] = {"mean": _np(mod.bn.running_mean),
                   "var": _np(mod.bn.running_var)}
    return {"params": params, "batch_stats": stats}


def inception_from_torchvision_state_dict(sd: dict) -> InceptionV3Pool3:
    """The port's tower from a torchvision ``inception_v3`` state dict
    (tensors or arrays); ``fc.*`` and ``AuxLogits.*`` are not part of the
    pool_3 tower and are skipped, ``num_batches_tracked`` is optional."""
    model = InceptionV3Pool3()
    own = model.state_dict()
    kept = {k: v for k, v in sd.items()
            if k.split(".")[0] not in ("fc", "AuxLogits")}
    unknown = sorted(set(kept) - set(own))
    missing = sorted(k for k in set(own) - set(kept)
                     if not k.endswith("num_batches_tracked"))
    if unknown or missing:
        raise KeyError(f"not an inception_v3 state dict: unknown keys "
                       f"{unknown[:5]}, missing keys {missing[:5]}")
    with torch.no_grad():
        for key, val in kept.items():
            if key.endswith("num_batches_tracked"):
                continue
            src = val.detach().cpu().numpy() if hasattr(val, "detach") \
                else val
            _copy(own[key], src, key)
    return model.eval()


# ---------------------------------------------------------------------------
# VAE-GAN
# ---------------------------------------------------------------------------

def load_jax_tree(module: nn.Module, params: dict,
                  batch_stats: dict | None = None,
                  spectral: dict | None = None, path: str = "") -> None:
    """Copy a flax variables subtree onto ``module`` (built from the layers
    of ``ops/nn``), child by child under the same names."""
    batch_stats = batch_stats or {}
    spectral = spectral or {}
    with torch.no_grad():
        if isinstance(module, BatchNormTorch):
            _copy(module.weight, params["bn"]["scale"], path)
            _copy(module.bias, params["bn"]["bias"], path)
            _copy(module.running_mean, batch_stats["bn"]["mean"], path)
            _copy(module.running_var, batch_stats["bn"]["var"], path)
            return
        if isinstance(module, (SNConvTranspose2d, nn.ConvTranspose2d)):
            _copy(module.weight,
                  np.asarray(params["kernel"]).transpose(2, 3, 0, 1), path)
            _copy(module.bias, params["bias"], path)
            if isinstance(module, SNConvTranspose2d):
                _copy(module.u, spectral["u"], path)
                _copy(module.v, spectral["v"], path)
            return
        if isinstance(module, nn.Conv2d):
            _copy(module.weight,
                  np.asarray(params["kernel"]).transpose(3, 2, 0, 1), path)
            _copy(module.bias, params["bias"], path)
            return
        if isinstance(module, nn.Linear):
            _copy(module.weight, np.asarray(params["kernel"]).T, path)
            _copy(module.bias, params["bias"], path)
            return
        for name, param in module.named_parameters(recurse=False):
            _copy(param, np.asarray(params[name]).reshape(param.shape),
                  f"{path}.{name}")
    for name, child in module.named_children():
        if name not in params:
            raise KeyError(f"{path or type(module).__name__}: no {name!r} in "
                           f"the parameter tree")
        load_jax_tree(child, params[name], batch_stats.get(name),
                      spectral.get(name), f"{path}.{name}" if path else name)


def dump_jax_tree(module: nn.Module) -> dict:
    """Inverse of :func:`load_jax_tree`: ``{"params", "batch_stats",
    "spectral"}`` with numpy leaves (empty collections left out)."""
    params: dict = {}
    stats: dict = {}
    spectral: dict = {}
    if isinstance(module, BatchNormTorch):
        params["bn"] = {"scale": _np(module.weight),
                        "bias": _np(module.bias)}
        stats["bn"] = {"mean": _np(module.running_mean),
                       "var": _np(module.running_var)}
    elif isinstance(module, (SNConvTranspose2d, nn.ConvTranspose2d)):
        params["kernel"] = np.ascontiguousarray(
            _np(module.weight).transpose(2, 3, 0, 1))
        params["bias"] = _np(module.bias)
        if isinstance(module, SNConvTranspose2d):
            spectral.update(u=_np(module.u), v=_np(module.v))
    elif isinstance(module, nn.Conv2d):
        params["kernel"] = np.ascontiguousarray(
            _np(module.weight).transpose(2, 3, 1, 0))
        params["bias"] = _np(module.bias)
    elif isinstance(module, nn.Linear):
        params["kernel"] = np.ascontiguousarray(_np(module.weight).T)
        params["bias"] = _np(module.bias)
    else:
        for name, param in module.named_parameters(recurse=False):
            params[name] = _np(param)
        for name, child in module.named_children():
            sub = dump_jax_tree(child)
            for coll, tree in (("params", params), ("batch_stats", stats),
                               ("spectral", spectral)):
                if coll in sub:
                    tree[name] = sub[coll]
    out = {"params": params, "batch_stats": stats, "spectral": spectral}
    return {k: v for k, v in out.items() if v}


def _vaegan_dims(kind: str, params: dict) -> tuple[int, int]:
    if kind == "encoder":
        return (int(np.shape(params["fc1_1"]["kernel"])[1]),
                int(np.shape(params["cv1"]["kernel"])[3]))
    if kind == "generator":
        return (int(np.shape(params["deconv1"]["kernel"])[2]),
                int(np.shape(params["deconv5"]["kernel"])[2]))
    raise ValueError(f"kind must be 'encoder' or 'generator', got {kind!r}")


def vaegan_from_jax_variables(kind: str, variables: dict,
                              z_dim: int | None = None,
                              d: int | None = None) -> nn.Module:
    """The port's VAE-GAN ``Encoder`` or ``Generator`` (``kind``), on the
    CPU in eval mode, from flax variables ``{"params", "batch_stats"
    [, "spectral"]}``. ``z_dim`` and ``d`` are read from the kernels'
    shapes; when given they must agree."""
    from ganleaks_tpu_torch.models.vaegan import Encoder, Generator

    params = variables["params"]
    got = _vaegan_dims(kind, params)
    for name, want, have in (("z_dim", z_dim, got[0]), ("d", d, got[1])):
        if want is not None and want != have:
            raise ValueError(f"{kind} weights have {name}={have}, the "
                             f"configuration says {want}")
    model = (Encoder if kind == "encoder" else Generator)(*got)
    load_jax_tree(model, params, variables.get("batch_stats"),
                  variables.get("spectral"))
    return model.eval()
