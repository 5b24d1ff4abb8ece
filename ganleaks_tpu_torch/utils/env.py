"""Boolean environment-flag convention (copy of ``ganleaks_tpu.utils.env``).

Unset, empty and ``'0'`` mean OFF, anything else means ON.
"""

from __future__ import annotations

import os


def env_flag(name: str) -> bool:
    """True iff the environment flag ``name`` is set (not '', not '0')."""
    return os.environ.get(name, "") not in ("", "0")
