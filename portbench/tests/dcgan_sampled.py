"""A configuration module of the tests, added to a copy of the benchmark
as a file (``modules/dcgan_sampled.py``) to show that a configuration
can bring its own network, image source and reference: the fbb attack of
the default module on a set that each call samples from a seeded DCGAN
victim through the program's own entry points
(``models/dcgan.Generator``, ``train/sample.sample_to_host``).

The configuration's ``generator`` holds ``nz``, ``ngf`` and the sampling
``batch``. The generator's weights are drawn from the seed (uniform
kernels of bound sqrt(6 / fan_in), fan_in the inputs that reach one
output; batch-norm scales, shifts and running
statistics uniform about identity; the last layer's shift is its bias)
and handed to the program by its state-dict names. A call's input is the seed of its latents; the
reference draws the same latents and runs a plain float32 forward of
the same generator (DCGAN, Radford et al. 2016: a 4x4 transposed
convolution from the latent, then stride-2 transposed convolutions with
batch norm at its running statistics and ReLU, halving the channels, and
a last one to RGB with tanh). Both sides take the images to bytes by one
rule, ``floor(255 x + 0.5)`` of ``(tanh + 1) / 2``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import reference, traffic
from portbench.modules import lpips

EPS = 1e-5  # batch norm's


class Source:
    """The seed of a call's latents and the number of images it yields."""

    def __init__(self, seed: int, n: int):
        self.seed, self.n = seed, n

    def __len__(self) -> int:
        return self.n


def layers(nz: int, ngf: int, res: int) -> list[tuple[int, int, int, int]]:
    """(in, out, stride, padding) of each 4x4 transposed convolution."""
    n_mid = int(math.log2(res // 8))
    chans = [ngf * 2 ** (n_mid + 1)] + [ngf * 2 ** (n_mid - k)
                                        for k in range(n_mid)]
    out, cin = [], nz
    for i, c in enumerate(chans):
        out.append((cin, c, 1 if i == 0 else 2, 0 if i == 0 else 1))
        cin = c
    return out + [(cin, 3, 2, 1)]


def make_generator(gen: dict, res: int, seed: int, device) -> list[dict]:
    """Each layer's weights, float32 on ``device``, drawn in one call."""
    shapes = layers(gen["nz"], gen["ngf"], res)
    sizes = [ci * co * 16 + 4 * co for ci, co, _s, _p in shapes]
    flat = torch.rand(sum(sizes), generator=traffic.generator(
        seed, device, 5), device=device) * 2.0 - 1.0
    out, off = [], 0
    for (ci, co, s, p), size in zip(shapes, sizes):
        w = flat[off:off + ci * co * 16].view(ci, co, 4, 4)
        v = flat[off + ci * co * 16:off + size].view(4, co)
        fan_in = ci if s == 1 else ci * 4  # inputs reaching one output
        out.append({"weight": w * math.sqrt(6.0 / fan_in),
                    "gamma": 1.0 + 0.1 * v[0], "beta": 0.1 * v[1],
                    "mean": 0.1 * v[2], "var": 1.0 + 0.5 * v[3],
                    "stride": s, "padding": p})
        off += size
    return out


def state_dict(layers_: list[dict]) -> dict:
    """The weights under the program's ``models/dcgan`` names."""
    sd = {}
    for i, lay in enumerate(layers_[:-1]):
        sd[f"gen.{i}.0.weight"] = lay["weight"]
        sd[f"gen.{i}.1.weight"] = lay["gamma"]
        sd[f"gen.{i}.1.bias"] = lay["beta"]
        sd[f"gen.{i}.1.running_mean"] = lay["mean"]
        sd[f"gen.{i}.1.running_var"] = lay["var"]
    last = layers_[-1]
    sd[f"gen.{len(layers_) - 1}.weight"] = last["weight"]
    sd[f"gen.{len(layers_) - 1}.bias"] = last["beta"]
    return sd


def plain_forward(layers_: list[dict], z: torch.Tensor) -> torch.Tensor:
    """Images in [0, 1], NCHW float32 (TF32 off)."""
    reference.strict_float32()
    h = z.reshape(z.shape[0], -1, 1, 1)
    for lay in layers_[:-1]:
        h = F.conv_transpose2d(h, lay["weight"], None, lay["stride"],
                               lay["padding"])
        c = (1, -1, 1, 1)
        h = ((h - lay["mean"].view(c)) / torch.sqrt(lay["var"].view(c) + EPS)
             * lay["gamma"].view(c) + lay["beta"].view(c))
        h = torch.relu(h)
    last = layers_[-1]
    h = torch.tanh(F.conv_transpose2d(h, last["weight"], last["beta"],
                                      last["stride"], last["padding"]))
    return ((h + 1.0) / 2.0).clamp(0.0, 1.0)


class Bench(lpips.Bench):
    def __init__(self, config, workload, seed, device, tmp):
        super().__init__(config, workload, seed, device, tmp)
        from ganleaks_tpu_torch.models.dcgan import Generator
        from ganleaks_tpu_torch.train.sample import sample_to_host

        g = config["generator"]
        self.nz, self.batch = g["nz"], g["batch"]
        self.layers = make_generator(g, self.res, seed, device)
        self.gen = Generator(nz=g["nz"], ngf=g["ngf"],
                             image_size=self.res).to(device)
        self.gen.load_state_dict(state_dict(self.layers))
        self._sample = sample_to_host

    def _source(self, call: int, stream: int) -> Source:
        return Source(traffic.sub_seed(self.seed, stream, call),
                      self.spec["synthetic"])

    def call_input(self, call, stream):
        source = self._source(call, stream)
        self._k2 = self._tap_epilogue.launches
        return source, source.seed

    def timed_call(self, source, logger):
        gen = torch.Generator(device=self.device).manual_seed(source.seed)
        _z, images = self._sample(self.gen, source.n, self.nz, self.batch,
                                  generator=gen, device=self.device)
        syn = (images * 255.0 + 0.5).astype(np.uint8)
        return self._fbb.attack_arrays(
            self.cfg, syn, self.pos, self.neg, device=self.device,
            sweep_cache=self.sweep, logger=logger)

    def reference_set(self, call, checksum):
        source = self._source(call, traffic.WINDOW)
        gen = torch.Generator(device=self.device).manual_seed(source.seed)
        out = []
        for lo in range(0, source.n, self.batch):
            z = torch.randn(min(self.batch, source.n - lo), self.nz,
                            generator=gen, device=self.device)
            img = plain_forward(self.layers, z).permute(0, 2, 3, 1)
            out.append((img * 255.0 + 0.5).to(torch.uint8))
        return torch.cat(out), int(checksum is not None
                                   and checksum != source.seed)


def least_seconds(config: dict, call: dict, peaks: dict) -> float:
    """The default module's call, plus sampling the set: the generator's
    multiply-adds (each input position of a transposed convolution
    scattered into a 4x4 window of every output channel) at the float32
    peak."""
    g, res = config["generator"], config["resolution"]
    macs, side = 0, 1
    for ci, co, stride, _p in layers(g["nz"], g["ngf"], res):
        macs += side * side * ci * co * 16
        side = 4 if stride == 1 else side * 2
    return (lpips.least_seconds(config, call, peaks)
            + 2 * macs * call["n_s"] / peaks["float32"])
