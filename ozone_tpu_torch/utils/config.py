"""Environment knobs.

A copy of the two parsers of `ozone_tpu/utils/config.py` the port reads
its knobs through: unset, empty or malformed values fall back to the
default instead of raising.
"""

from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    """Float environment knob with a safe fallback."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    """Integer environment knob with a safe fallback."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default
