"""Shared CLI plumbing: every entry point takes ``--local_config <yaml>``
plus ``key=value`` overrides (each value parsed by its field's type in
``config``)."""

from __future__ import annotations

import argparse
from typing import Type, TypeVar

from ganleaks_tpu_torch.config import load_config

T = TypeVar("T")


def parse_config(cls: Type[T], argv: list[str] | None = None,
                 description: str = "") -> T:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--local_config", default=None,
                    help="YAML file whose keys override the defaults")
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
    return load_config(cls, ns.local_config, over)

