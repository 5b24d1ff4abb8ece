"""Carry weights between the JAX package and the port.

* LPIPS: the JAX params ``{"net", "convs": [{"kernel": HWIO, "bias": (O,)}],
  "lins": [(C,)]}`` (``ganleaks_tpu/ops/lpips/lpips.py:74``, saved to npz
  by ``save_lpips_params``) <-> the port's :class:`LPIPS`.
* InceptionV3 pool_3: the flax variables ``{"params", "batch_stats"}`` of
  ``ganleaks_tpu.ops.inception.InceptionV3Pool3`` (conv kernels HWIO, BN
  ``scale``/``bias`` and ``mean``/``var``) <-> the port's tower; and a
  torchvision-layout state dict (what either package's
  ``tools/convert_inception.py`` converts), ``fc.*`` and ``AuxLogits.*``
  skipped. One weights file serves both packages.
* VAE-GAN encoder, generator and both discriminators: the variables
  ``{"params", "batch_stats", "spectral"}`` that the JAX trainer saves
  and either package's ``tools/convert_victim.py`` writes <-> the port's
  modules (:func:`load_jax_tree` / :func:`dump_jax_tree`), whose own keys
  are the reference's.
* DCGAN / WGAN-GP generator, discriminator and critic: the JAX trainers'
  ``{"params", "batch_stats"}`` (``block{i}_conv``, ``block{i}/bn``,
  ``block{i}_in``, ``to_img``, ``from_img``, ``head``) <-> the port's
  modules, whose own keys are the reference's state-dict keys.
* medGAN generator, autoencoder and discriminator (``block{1,2}_fc``,
  ``block{1,2}/bn``; ``enc``, ``dec``; ``fc1..3``) and the PGGAN
  generator and critic (``initial_convt``, ``initial_conv``, ``rgb{i}``,
  ``prog{i}``, ``final_conv{1,2,3}``: ``init_progressive``'s union tree)
  <-> the port's modules under the reference's keys, layer by layer as
  for DCGAN.
* privGAN: the JAX ``PrivGANState``'s generators and discriminators,
  stacked on a leading split axis, and its shared private classifier <->
  the port's per-split ``nn.ModuleList``s and classifier
  (:func:`privgan_from_jax_state` / :func:`privgan_to_jax_state`).

Leaves are numpy (or any array-like); kernels are transposed HWIO -> OIHW
(conv), HWIO -> IOHW (transposed conv, ``transpose(2, 3, 0, 1)``: the JAX
layer convolves with the spatially flipped kernel, which is the
definition of the transposed convolution, so no flip is applied here) and
(in, out) -> (out, in) (dense); BatchNorm and InstanceNorm scale/bias ->
weight/bias, BatchNorm mean/var -> running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ganleaks_tpu_torch.ops.inception import BasicConv2d, InceptionV3Pool3
from ganleaks_tpu_torch.ops.lpips.lpips import LPIPS
from ganleaks_tpu_torch.ops.nn import (BatchNormTorch, ChannelsToLinear,
                                       InstanceNorm2d,
                                       SNConvTranspose2d, SpectralLayer)


def _copy(dst: torch.Tensor, src, name: str) -> None:
    val = torch.from_numpy(np.array(src, np.float32))
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

def _kernel_to_torch(module: SpectralLayer, kernel) -> np.ndarray:
    """A spectral-norm layer's JAX kernel in its torch weight layout:
    HWIO -> IOHW (transposed conv), HWIO -> OIHW (conv), (in, out) ->
    (out, in) (dense)."""
    kernel = np.asarray(kernel)
    if kernel.ndim == 2:
        return kernel.T
    return kernel.transpose((2, 3, 0, 1) if isinstance(
        module, SNConvTranspose2d) else (3, 2, 0, 1))


def _kernel_to_jax(module: SpectralLayer, weight: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_kernel_to_torch`."""
    if weight.ndim == 2:
        return np.ascontiguousarray(weight.T)
    return np.ascontiguousarray(weight.transpose(
        (2, 3, 0, 1) if isinstance(module, SNConvTranspose2d)
        else (2, 3, 1, 0)))


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
        if isinstance(module, InstanceNorm2d):
            _copy(module.weight, params["scale"], path)
            _copy(module.bias, params["bias"], path)
            return
        if isinstance(module, SpectralLayer):
            _copy(module.weight, _kernel_to_torch(module, params["kernel"]),
                  path)
            _copy(module.bias, params["bias"], path)
            _copy(module.u, spectral["u"], path)
            _copy(module.v, spectral["v"], path)
            return
        if isinstance(module, nn.ConvTranspose2d):
            _copy(module.weight,
                  np.asarray(params["kernel"]).transpose(2, 3, 0, 1), path)
            if module.bias is not None:
                _copy(module.bias, params["bias"], path)
            return
        if isinstance(module, nn.Conv2d):
            _copy(module.weight,
                  np.asarray(params["kernel"]).transpose(3, 2, 0, 1), path)
            if module.bias is not None:
                _copy(module.bias, params["bias"], path)
            return
        if isinstance(module, nn.Linear):
            if isinstance(module, ChannelsToLinear):
                params = params["linear"]
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
    elif isinstance(module, InstanceNorm2d):
        params.update(scale=_np(module.weight), bias=_np(module.bias))
    elif isinstance(module, SpectralLayer):
        params["kernel"] = _kernel_to_jax(module, _np(module.weight))
        params["bias"] = _np(module.bias)
        spectral.update(u=_np(module.u), v=_np(module.v))
    elif isinstance(module, nn.ConvTranspose2d):
        params["kernel"] = np.ascontiguousarray(
            _np(module.weight).transpose(2, 3, 0, 1))
        if module.bias is not None:
            params["bias"] = _np(module.bias)
    elif isinstance(module, nn.Conv2d):
        params["kernel"] = np.ascontiguousarray(
            _np(module.weight).transpose(2, 3, 1, 0))
        if module.bias is not None:
            params["bias"] = _np(module.bias)
    elif isinstance(module, nn.Linear):
        lin = params.setdefault("linear", {}) if isinstance(
            module, ChannelsToLinear) else params
        lin["kernel"] = np.ascontiguousarray(_np(module.weight).T)
        lin["bias"] = _np(module.bias)
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


VAEGAN_KINDS = ("encoder", "generator", "discriminator",
                "discriminator_l")


def _vaegan_dims(kind: str, params: dict) -> tuple[int, ...]:
    """Constructor arguments read from the kernels' shapes: (z_dim, d),
    (d,) for the image discriminator, (z_dim,) for the latent one."""
    if kind == "encoder":
        return (int(np.shape(params["fc1_1"]["kernel"])[1]),
                int(np.shape(params["cv1"]["kernel"])[3]))
    if kind == "generator":
        return (int(np.shape(params["deconv1"]["kernel"])[2]),
                int(np.shape(params["deconv5"]["kernel"])[2]))
    if kind == "discriminator":
        return (int(np.shape(params["conv1"]["kernel"])[3]),)
    if kind == "discriminator_l":
        return (int(np.shape(params["fc1"]["kernel"])[0]),)
    raise ValueError(f"kind must be one of {VAEGAN_KINDS}, got {kind!r}")


def vaegan_from_jax_variables(kind: str, variables: dict,
                              z_dim: int | None = None,
                              d: int | None = None) -> nn.Module:
    """The port's VAE-GAN ``Encoder``, ``Generator``, ``Discriminator`` or
    ``DiscriminatorL`` (``kind``: one of :data:`VAEGAN_KINDS`), on the CPU
    in eval mode, from flax variables ``{"params"[, "batch_stats"][,
    "spectral"]}`` (the JAX trainer's, train-mode statistics included).
    ``z_dim`` and ``d`` are read from the kernels' shapes; when given they
    must agree."""
    from ganleaks_tpu_torch.models import vaegan

    params = variables["params"]
    got = _vaegan_dims(kind, params)
    names = {"encoder": ("z_dim", "d"), "generator": ("z_dim", "d"),
             "discriminator": ("d",), "discriminator_l": ("z_dim",)}[kind]
    for name, have in zip(names, got):
        want = {"z_dim": z_dim, "d": d}[name]
        if want is not None and want != have:
            raise ValueError(f"{kind} weights have {name}={have}, the "
                             f"configuration says {want}")
    cls = {"encoder": vaegan.Encoder, "generator": vaegan.Generator,
           "discriminator": vaegan.Discriminator,
           "discriminator_l": vaegan.DiscriminatorL}[kind]
    model = cls(*got)
    load_jax_tree(model, params, variables.get("batch_stats"),
                  variables.get("spectral"))
    return model.eval()


vaegan_to_jax_variables = dump_jax_tree


# ---------------------------------------------------------------------------
# DCGAN / WGAN-GP
# ---------------------------------------------------------------------------

def _gan_layers(model: nn.Module) -> list[tuple[str, nn.Module]]:
    """(JAX variable name, layer) for every weighted layer of a port
    ``Generator`` (``block{i}_conv``, ``block{i}`` BatchNorm, ``to_img``),
    ``Discriminator`` (``from_img``, ``block{j}_conv``, ``block{j}``,
    ``head``) or ``Critic`` (``block{j}_in`` for its InstanceNorms)."""
    if hasattr(model, "gen"):
        *blocks, to_img, _tanh = model.gen
        out = []
        for i, (conv, bn, _relu) in enumerate(blocks):
            out += [(f"block{i}_conv", conv), (f"block{i}", bn)]
        return out + [("to_img", to_img)]
    from_img, _act, *blocks, head = model.disc
    out = [("from_img", from_img)]
    for j, (conv, norm, _act) in enumerate(blocks):
        name = f"block{j}_in" if isinstance(norm, InstanceNorm2d) \
            else f"block{j}"
        out += [(f"block{j}_conv", conv), (name, norm)]
    return out + [("head", head)]


def _medgan_layers(model: nn.Module) -> list[tuple[str, nn.Module]]:
    from ganleaks_tpu_torch.models import medgan
    if isinstance(model, medgan.Generator):
        return [("block1_fc", model.gen_block1[0]),
                ("block1", model.gen_block1[1]),
                ("block2_fc", model.gen_block2[0]),
                ("block2", model.gen_block2[1])]
    if isinstance(model, medgan.Autoencoder):
        return [("enc", model.encoder[0]), ("dec", model.decoder[0])]
    return [(f"fc{j + 1}", model.disc[i]) for j, i in enumerate((0, 2, 4))]


def _pggan_layers(model: nn.Module) -> list[tuple[str, nn.Module]]:
    from ganleaks_tpu_torch.models import pggan
    out = [(f"rgb{k}", m) for k, m in model.rgb_layers.named_children()]
    out += [(f"prog{k}", m) for k, m in model.prog_blocks.named_children()]
    if isinstance(model, pggan.Generator):
        return [("initial_convt", model.initial[1]),
                ("initial_conv", model.initial[3])] + out
    return out + [(f"final_conv{j + 1}", model.final_block[i])
                  for j, i in enumerate((0, 2, 4))]


def _jax_layers(model: nn.Module) -> list[tuple[str, nn.Module]]:
    """(JAX variable name, layer) of a port DCGAN, WGAN-GP, medGAN or
    PGGAN module."""
    from ganleaks_tpu_torch.models import medgan, pggan
    if isinstance(model, (medgan.Generator, medgan.Autoencoder,
                          medgan.Discriminator)):
        return _medgan_layers(model)
    if isinstance(model, (pggan.Generator, pggan.Discriminator)):
        return _pggan_layers(model)
    return _gan_layers(model)


def gan_load_jax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Copy the JAX trainer's ``{"params"[, "batch_stats"]}`` onto a port
    DCGAN, WGAN-GP, medGAN or PGGAN module (:func:`load_jax_tree` layer by
    layer); every layer of the module must be in the variables."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    for name, layer in _jax_layers(model):
        if name not in params:
            raise KeyError(f"no {name!r} in the parameter tree")
        load_jax_tree(layer, params[name], stats.get(name), path=name)
    return model


def gan_to_jax_variables(model: nn.Module) -> dict:
    """The JAX trainer's ``{"params", "batch_stats"}`` (numpy leaves) of a
    port module as :func:`gan_load_jax_variables` reads them;
    ``batch_stats`` is left out for nets without BatchNorm."""
    params: dict = {}
    stats: dict = {}
    for name, layer in _jax_layers(model):
        sub = dump_jax_tree(layer)
        params[name] = sub["params"]
        if "batch_stats" in sub:
            stats[name] = sub["batch_stats"]
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def _dcgan_dims(kind: str, params: dict) -> dict:
    """Constructor arguments read from the kernels' shapes (HWIO)."""
    n_blocks = sum(k.startswith("block") and k.endswith("_conv")
                   for k in params)
    if kind == "generator":
        cin = np.shape(params["to_img"]["kernel"])[2]
        return {"nz": int(np.shape(params["block0_conv"]["kernel"])[2]),
                "nc": int(np.shape(params["to_img"]["kernel"])[3]),
                "ngf": int(cin) // 2, "image_size": 8 * 2 ** (n_blocks - 1)}
    shape = np.shape(params["from_img"]["kernel"])
    dims = {"ndf": int(shape[3]), "nc": int(shape[2])}
    if kind == "discriminator":
        dims["image_size"] = 8 * 2 ** n_blocks
    elif kind != "critic":
        raise ValueError(f"kind must be 'generator', 'discriminator' or "
                         f"'critic', got {kind!r}")
    return dims


def dcgan_from_jax_variables(kind: str, variables: dict) -> nn.Module:
    """The port's DCGAN ``Generator``, ``Discriminator`` or privGAN
    ``PrivateDiscriminator`` (``kind``: "generator", "discriminator" or
    "private"), on the CPU in eval mode, from the JAX trainer's variables;
    widths, latent size, image size and the private head's split count are
    read from the kernels."""
    from ganleaks_tpu_torch.models.dcgan import (Discriminator, Generator,
                                                 PrivateDiscriminator)

    if kind == "private":
        p = variables["params"]
        model = PrivateDiscriminator(
            n_splits=int(np.shape(p["head"]["kernel"])[3]),
            **_dcgan_dims("discriminator", p))
        return gan_load_jax_variables(model, variables).eval()
    if kind not in ("generator", "discriminator"):
        raise ValueError(f"kind must be 'generator', 'discriminator' or "
                         f"'private', got {kind!r}")
    cls = Generator if kind == "generator" else Discriminator
    model = cls(**_dcgan_dims(kind, variables["params"]))
    return gan_load_jax_variables(model, variables).eval()


def wgangp_from_jax_variables(kind: str, variables: dict) -> nn.Module:
    """The port's WGAN-GP ``Generator`` (DCGAN's) or ``Critic``
    (``kind``), on the CPU in eval mode, from the JAX trainer's
    variables."""
    from ganleaks_tpu_torch.models.wgangp import Critic

    if kind == "generator":
        return dcgan_from_jax_variables(kind, variables)
    if kind != "critic":
        raise ValueError(f"kind must be 'generator' or 'critic', "
                         f"got {kind!r}")
    model = Critic(**_dcgan_dims(kind, variables["params"]))
    return gan_load_jax_variables(model, variables).eval()


dcgan_to_jax_variables = wgangp_to_jax_variables = gan_to_jax_variables


# ---------------------------------------------------------------------------
# medGAN / PGGAN
# ---------------------------------------------------------------------------

def medgan_from_jax_variables(kind: str, variables: dict,
                              binary: bool = True,
                              minibatch_average: bool = True) -> nn.Module:
    """The port's medGAN ``Generator``, ``Autoencoder`` or
    ``Discriminator`` (``kind``: "gen", "ae" or "disc", the JAX trainer's
    names) on the CPU in eval mode; widths are read from the kernels,
    ``binary`` and ``minibatch_average`` (which the weights cannot show)
    are the config's."""
    from ganleaks_tpu_torch.models import medgan

    p = variables["params"]

    def shape(name):
        return np.shape(p[name]["kernel"])

    if kind == "gen":
        model = medgan.Generator(shape("block1_fc")[0], shape("block1_fc")[1],
                                 shape("block2_fc")[1])
    elif kind == "ae":
        model = medgan.Autoencoder(shape("enc")[0], shape("enc")[1], binary)
    elif kind == "disc":
        width = shape("fc1")[0]
        model = medgan.Discriminator(
            width // 2 if minibatch_average else width, shape("fc1")[1],
            shape("fc2")[1], minibatch_average)
    else:
        raise ValueError(f"kind must be 'gen', 'ae' or 'disc', got {kind!r}")
    return gan_load_jax_variables(model, variables).eval()


def pggan_from_jax_variables(kind: str, variables: dict) -> nn.Module:
    """The port's PGGAN ``Generator`` or ``Discriminator`` (``kind``:
    "generator" or "critic") on the CPU from the JAX trainer's
    ``{"params"}`` (``init_progressive``'s union over every step up to the
    tree's largest); nz, in_channels, nc, max_steps and the critic's
    output count (privGAN's private critic: ``n_splits``) are read from
    the kernels."""
    from ganleaks_tpu_torch.models import pggan

    p = variables["params"]
    n_rgb = sum(k.startswith("rgb") for k in p)
    if kind == "generator":
        convt = np.shape(p["initial_convt"]["kernel"])
        model = pggan.Generator(convt[2], convt[3],
                                np.shape(p["rgb0"]["conv"]["kernel"])[3],
                                n_rgb - 1)
    elif kind == "critic":
        model = pggan.Discriminator(
            np.shape(p["final_conv2"]["conv"]["kernel"])[3],
            np.shape(p[f"rgb{pggan.N_BLOCKS}"]["conv"]["kernel"])[2],
            n_rgb - 1, np.shape(p["final_conv3"]["conv"]["kernel"])[3])
    else:
        raise ValueError(f"kind must be 'generator' or 'critic', got "
                         f"{kind!r}")
    return gan_load_jax_variables(model, variables).eval()


medgan_to_jax_variables = pggan_to_jax_variables = gan_to_jax_variables


# ---------------------------------------------------------------------------
# privGAN
# ---------------------------------------------------------------------------

def _split(tree, i: int):
    """Split ``i`` of a tree whose leaves carry a leading split axis."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _split(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _first_leaf(tree):
    while isinstance(tree, dict) or hasattr(tree, "items"):
        tree = next(iter(tree.values()))
    return tree


def _stack(trees: list):
    """The inverse of :func:`_split` over a list of equal trees."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def privgan_from_jax_state(kind: str, genS: dict, discS: dict, priv: dict
                           ) -> tuple[nn.ModuleList, nn.ModuleList,
                                      nn.Module]:
    """The JAX ``PrivGANState``'s nets as the port's (generators,
    discriminators, private classifier), on the CPU in eval mode. ``kind``:
    "dcgan" or "pggan"; ``genS`` / ``discS``: the stacked variables
    (``{"params"[, "batch_stats"]}``, every leaf with a leading split
    axis); ``priv``: the classifier's variables. Each split's sizes are
    read from its own slice (the stacked kernels carry the split on axis
    0, so ``nz`` sits on axis 3 there)."""
    loaders = {"dcgan": (dcgan_from_jax_variables,
                         ("generator", "discriminator", "private")),
               "pggan": (pggan_from_jax_variables,
                         ("generator", "critic", "critic"))}
    if kind not in loaders:
        raise ValueError(f"kind must be 'dcgan' or 'pggan', got {kind!r}")
    load, parts = loaders[kind]
    n = len(_first_leaf(genS["params"]))
    nets = [nn.ModuleList([load(part, _split(tree, i)) for i in range(n)])
            for part, tree in zip(parts, (genS, discS))]
    return nets[0], nets[1], load(parts[2], priv)


def privgan_to_jax_state(genS: nn.ModuleList, discS: nn.ModuleList,
                         priv: nn.Module) -> tuple[dict, dict, dict]:
    """(stacked generators' variables, stacked discriminators' variables,
    the classifier's variables), numpy leaves, as
    :func:`privgan_from_jax_state` reads them."""
    return (_stack([gan_to_jax_variables(m) for m in genS]),
            _stack([gan_to_jax_variables(m) for m in discS]),
            gan_to_jax_variables(priv))
