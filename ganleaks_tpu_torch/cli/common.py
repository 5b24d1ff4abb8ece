"""Shared CLI plumbing: every entry point takes ``--local_config <yaml>``
plus ``key=value`` overrides (each value parsed by its field's type in
``config``), and ``--device`` (``cuda`` unless ``cpu`` is asked for; never
chosen by what the machine has). The privGAN trainers also take
``--grid <yaml>`` (:func:`priv_main`); the other victim trainers start
their ranks through :func:`train_on_ranks`."""

from __future__ import annotations

import argparse
from typing import Type, TypeVar

from ganleaks_tpu_torch.config import (PrivGANConfig, apply_overrides,
                                       expand_grid, load_config, sweep_tag)

T = TypeVar("T")


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the entry point runs (default cuda; "
                         "without a GPU it refuses unless given cpu)")


def _parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--local_config", default=None,
                    help="YAML file whose keys override the defaults")
    add_device_argument(ap)
    ap.add_argument("overrides", nargs="*",
                    help="key=value overrides (applied after the YAML)")
    return ap


def _overrides(ap: argparse.ArgumentParser, items: list[str]) -> dict:
    for item in items:
        if "=" not in item:
            ap.error(f"override {item!r} is not key=value")
    return dict(item.split("=", 1) for item in items)


def parse_config(cls: Type[T], argv: list[str] | None = None,
                 description: str = "",
                 device: str | None = None) -> tuple[T, str]:
    """Return ``(config, device)``; a ``device`` the Python caller passes
    wins over the ``--device`` flag."""
    ap = _parser(description)
    ns = ap.parse_args(argv)
    over = _overrides(ap, ns.overrides)
    return load_config(cls, ns.local_config, over), device or ns.device


def train_on_ranks(run, cfg, device) -> None:
    """A victim trainer's CLI body ``run(cfg, device_type)``, a
    module-level function: in this process, or — ``mesh_shape=[n]`` with n
    > 1 when training, outside a process group and without ``multihost``
    — on n local ranks (``parallel/multihost.launch``; on the card rank r
    on ``cuda:r % cards``, NCCL where each has a card of its own, else
    ``gloo``; ``--device cpu``: ``gloo`` on the CPU). Under ``torchrun``
    or with ``multihost=true`` the trainer joins the group itself."""
    import math

    from ganleaks_tpu_torch.parallel import multihost

    n = math.prod(cfg.mesh_shape)
    if (n > 1 and cfg.training and not cfg.multihost
            and not multihost.in_group()):
        devices, backend = multihost.launch_plan(n, device)
        multihost.launch(run, n, cfg, device.type, devices=devices,
                         backend=backend,
                         timeout_s=multihost.DEFAULT_TIMEOUT_S)
    else:
        run(cfg, device.type)


def priv_main(cls: type, train_fn, generate_fn, name: str,
              argv: list[str] | None = None, device: str | None = None
              ) -> None:
    """A privGAN trainer's CLI (``privDCGAN.py:73-92``): ``key=value``
    overrides go to the model config ``cls`` (after ``--local_config``) or
    to ``PrivGANConfig`` by field name; ``--grid <yaml>`` of list-valued
    privGAN fields runs ``train_fn`` once per point of its product, then
    ``generate_fn`` (when ``generate``) into the run directory
    ``<keys>/<values>`` (``config.sweep_tag``)."""
    from ganleaks_tpu_torch.device import resolve_device

    ap = _parser(f"{name} victim training (GPU)")
    ap.add_argument("--grid", default=None,
                    help="YAML of list-valued privGAN fields to sweep")
    ns = ap.parse_args(argv)
    over = _overrides(ap, ns.overrides)
    priv_keys = PrivGANConfig.__dataclass_fields__
    cfg = load_config(cls, ns.local_config,
                      {k: v for k, v in over.items() if k not in priv_keys})
    base = load_config(PrivGANConfig, None,
                       {k: v for k, v in over.items() if k in priv_keys})
    device = resolve_device(device or ns.device)
    experiments = [{}]
    if ns.grid:
        import yaml
        with open(ns.grid) as f:
            experiments = list(expand_grid(yaml.safe_load(f)))
    for exp in experiments:
        pcfg = apply_overrides(base, exp)
        tag = sweep_tag(exp)
        print(f"=== {name} {tag} {pcfg} ===")
        state = train_fn(cfg, pcfg, device=device)
        if cfg.generate:
            run_dir = "/".join(t for t in tag if t) or None
            dirs = generate_fn(cfg, pcfg, state, run_dir, device=device)
            print(f"synthetic data: {dirs['png_images']}")
