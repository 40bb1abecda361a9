"""Environment knobs.

A copy of the two parsers of `ozone_tpu/utils/config.py` the port reads
its knobs through (unset, empty or malformed values fall back to the
default instead of raising), and of its size parser (`parse_size`, the
CLI's quotas).
"""

from __future__ import annotations

import os
import re

_SIZE_RE = re.compile(r"^\s*([\d.]+)\s*([kmgtp]?i?b?)\s*$", re.I)
_SIZE_MULT = {
    "": 1, "b": 1,
    "k": 1024, "kb": 1024, "kib": 1024,
    "m": 1024**2, "mb": 1024**2, "mib": 1024**2,
    "g": 1024**3, "gb": 1024**3, "gib": 1024**3,
    "t": 1024**4, "tb": 1024**4, "tib": 1024**4,
    "p": 1024**5, "pb": 1024**5, "pib": 1024**5,
}


def parse_size(v) -> int:
    """'10MB', '1.5g', '4096' or a number -> bytes (binary units)."""
    if isinstance(v, (int, float)):
        return int(v)
    m = _SIZE_RE.match(str(v))
    if not m:
        raise ValueError(f"cannot parse size {v!r}")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).lower()])


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
