"""Shared CLI plumbing: every entry point takes ``--local_config <yaml>``
plus ``key=value`` overrides (each value parsed by its field's type in
``config``), and ``--device`` (``cuda`` unless ``cpu`` is asked for; never
chosen by what the machine has)."""

from __future__ import annotations

import argparse
from typing import Type, TypeVar

from ganleaks_tpu_torch.config import load_config

T = TypeVar("T")


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the entry point runs (default cuda; "
                         "without a GPU it refuses unless given cpu)")


def parse_config(cls: Type[T], argv: list[str] | None = None,
                 description: str = "",
                 device: str | None = None) -> tuple[T, str]:
    """Return ``(config, device)``; a ``device`` the Python caller passes
    wins over the ``--device`` flag."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--local_config", default=None,
                    help="YAML file whose keys override the defaults")
    add_device_argument(ap)
    ap.add_argument("overrides", nargs="*",
                    help="key=value overrides (applied after the YAML)")
    ns = ap.parse_args(argv)
    over = {}
    for item in ns.overrides:
        if "=" not in item:
            ap.error(f"override {item!r} is not key=value")
    for item in ns.overrides:
        k, v = item.split("=", 1)
        over[k] = v
    return load_config(cls, ns.local_config, over), device or ns.device
