"""Reference-trained victim checkpoints (``.pth`` state dicts) -> the
npz parameter files both packages read (port of
``ganleaks_tpu.tools.convert_victim``; it imports no JAX, so it runs on
the card's machine).

The npz holds the JAX trainers' variable trees (``{"params",
"batch_stats"[, "spectral"]}``, leaves keyed by their ``/``-joined path,
``utils/checkpoint.save_params_npz``): what the reconstruction attack's
``netE`` / ``netG`` and ``weights.*_from_jax_variables`` read, and what
the JAX package loads.

Each converter builds the port's module at the sizes its state dict's
shapes give, loads the dict into it by name (the port's modules carry the
reference's keys; ``utils/checkpoint.load_state_dict`` refuses unknown
and missing keys) and writes the module's variables with the bridge in
``weights`` (``gan_to_jax_variables``, ``vaegan_to_jax_variables``), where
the key layout lives.

Usage:
    python -m ganleaks_tpu_torch.tools.convert_victim \
        --model dcgan --part generator --pth generator.pth --out gen.npz
"""

from __future__ import annotations

import argparse
import re

from ganleaks_tpu_torch import weights
from ganleaks_tpu_torch.models import dcgan, medgan, pggan, vaegan, wgangp
from ganleaks_tpu_torch.utils.checkpoint import load_state_dict


def _shape(sd: dict, key: str) -> tuple[int, ...]:
    return tuple(int(n) for n in sd[key].shape)


def _count(sd: dict, pattern: str) -> int:
    """Number of the state dict's keys that match ``pattern`` in full."""
    return sum(re.fullmatch(pattern, k) is not None for k in sd)


# --- module sizes read from the reference's shapes ---------------------------

def _dcgan_generator(sd: dict) -> dcgan.Generator:
    """``gen.{i}.0.weight`` (ConvTranspose2d, IOHW) per block, then the
    final ConvTranspose2d (``dcgan/model_torch.py:75-96``); also WGAN-GP's
    generator."""
    n = _count(sd, r"gen\.\d+\.0\.weight")
    to_img = _shape(sd, f"gen.{n}.weight")
    return dcgan.Generator(nz=_shape(sd, "gen.0.0.weight")[0], nc=to_img[1],
                           ngf=to_img[0] // 2, image_size=8 * 2 ** (n - 1))


def _dcgan_discriminator(sd: dict) -> dcgan.Discriminator:
    """``disc.0`` (Conv2d, OIHW), then one ``disc.{i}.0`` conv per block
    (``model_torch.py:25-47``)."""
    ndf, nc = _shape(sd, "disc.0.weight")[:2]
    n = _count(sd, r"disc\.\d+\.0\.weight")
    return dcgan.Discriminator(ndf=ndf, nc=nc, image_size=8 * 2 ** n)


def _wgangp_critic(sd: dict) -> wgangp.Critic:
    ndf, nc = _shape(sd, "disc.0.weight")[:2]
    return wgangp.Critic(ndf=ndf, nc=nc)


def _pggan_steps(sd: dict) -> int:
    return _count(sd, r"rgb_layers\.\d+\.conv\.weight") - 1


def _pggan_generator(sd: dict) -> pggan.Generator:
    """``initial.1`` (ConvTranspose2d, IOHW), one ``rgb_layers.{i}`` per
    resolution (``pggan/model_torch.py:49-72``)."""
    nz, in_channels = _shape(sd, "initial.1.weight")[:2]
    return pggan.Generator(nz, in_channels,
                           _shape(sd, "rgb_layers.0.conv.weight")[0],
                           _pggan_steps(sd))


def _pggan_discriminator(sd: dict) -> pggan.Discriminator:
    """The critic (``model_torch.py:91-115``), also privPGGAN's private
    classifier: the same trunk, its ``final_block.4`` head as wide as the
    splits."""
    return pggan.Discriminator(
        _shape(sd, "final_block.0.conv.weight")[0],
        _shape(sd, f"rgb_layers.{pggan.N_BLOCKS}.conv.weight")[1],
        _pggan_steps(sd), _shape(sd, "final_block.4.conv.weight")[0])


def _vaegan_generator(sd: dict) -> vaegan.Generator:
    """``deconv1`` (spectral-norm ConvTranspose2d, ``weight_bar`` IOHW)
    takes z, ``deconv5`` maps d channels to the image
    (``vaegan/train.py:110-124``)."""
    return vaegan.Generator(_shape(sd, "deconv1.module.weight_bar")[0],
                            _shape(sd, "deconv5.weight")[0])


def _vaegan_encoder(sd: dict) -> vaegan.Encoder:
    """``fc1_1`` (Linear, (out, in)) gives z, ``cv1`` gives d
    (``vaegan/train.py:61-106``)."""
    return vaegan.Encoder(_shape(sd, "fc1_1.weight")[0],
                          _shape(sd, "cv1.weight")[0])


def _medgan_gen(sd: dict) -> medgan.Generator:
    hidden, z_dim = _shape(sd, "gen_block1.0.weight")
    return medgan.Generator(z_dim, hidden,
                            _shape(sd, "gen_block2.0.weight")[0])


def _medgan_ae(sd: dict) -> medgan.Autoencoder:
    hidden, size = _shape(sd, "encoder.0.weight")
    return medgan.Autoencoder(size, hidden)


def _medgan_disc(sd: dict) -> medgan.Discriminator:
    """Built without the minibatch average, which widens only the input
    that ``disc.0``'s shape already gives."""
    hidden1, width = _shape(sd, "disc.0.weight")
    return medgan.Discriminator(width, hidden1,
                                _shape(sd, "disc.2.weight")[0],
                                minibatch_average=False)


def _converter(build, to_variables=weights.gan_to_jax_variables):
    """State dict -> the variables of the module ``build`` sizes from it."""
    def convert(sd: dict) -> dict:
        return to_variables(load_state_dict(build(sd), sd))
    return convert


convert_dcgan_generator = _converter(_dcgan_generator)
convert_dcgan_discriminator = _converter(_dcgan_discriminator)
convert_wgangp_critic = _converter(_wgangp_critic)
convert_pggan_generator = _converter(_pggan_generator)
convert_pggan_discriminator = _converter(_pggan_discriminator)
convert_vaegan_generator = _converter(_vaegan_generator,
                                      weights.vaegan_to_jax_variables)
convert_vaegan_encoder = _converter(_vaegan_encoder,
                                    weights.vaegan_to_jax_variables)
_MEDGAN = {"gen": _converter(_medgan_gen), "ae": _converter(_medgan_ae),
           "disc": _converter(_medgan_disc)}


def convert_medgan(sd_gen: dict | None = None, sd_ae: dict | None = None,
                   sd_disc: dict | None = None) -> dict:
    """medGAN's parts (``medgan/model.py``) that are given, under the JAX
    trainer's names."""
    given = {"gen": sd_gen, "ae": sd_ae, "disc": sd_disc}
    return {part: _MEDGAN[part](sd) for part, sd in given.items()
            if sd is not None}


def _maybe_state_dict(obj):
    """The reference saves VAE-GAN nets both as state dicts inside the
    periodic checkpoint (``vaegan/train.py:401-410``) and as whole pickled
    modules ``netG.pt``/``netE.pt`` (``:412-414``)."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


CONVERTERS = {
    ("dcgan", "generator"): convert_dcgan_generator,
    ("dcgan", "discriminator"): convert_dcgan_discriminator,
    ("wgangp", "generator"): convert_dcgan_generator,
    ("wgangp", "critic"): convert_wgangp_critic,
    ("pggan", "generator"): convert_pggan_generator,
    ("pggan", "critic"): convert_pggan_discriminator,
    ("pggan", "discriminator"): convert_pggan_discriminator,
    ("vaegan", "generator"): convert_vaegan_generator,
    ("vaegan", "encoder"): convert_vaegan_encoder,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="reference victim .pth -> parameter npz")
    ap.add_argument("--model", required=True,
                    choices=["dcgan", "wgangp", "medgan", "pggan",
                             "vaegan"])
    ap.add_argument("--part", required=True)
    ap.add_argument("--pth", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from ganleaks_tpu_torch.utils.checkpoint import save_params_npz

    # a plain state dict loads under weights_only; VAE-GAN's netG.pt /
    # netE.pt are whole pickled modules (vaegan/train.py:412-414) and need
    # the full unpickler, which runs code from the file: convert only
    # checkpoints you trust
    try:
        sd = torch.load(args.pth, map_location="cpu")
    except Exception:
        sd = torch.load(args.pth, map_location="cpu", weights_only=False)
    sd = _maybe_state_dict(sd)
    if args.model == "medgan":
        variables = convert_medgan(**{f"sd_{args.part}": sd})[args.part]
    else:
        variables = CONVERTERS[(args.model, args.part)](sd)
    save_params_npz(args.out, variables)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
