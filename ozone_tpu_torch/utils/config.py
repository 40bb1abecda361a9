"""Typed configuration and environment knobs.

Port of `ozone_tpu/utils/config.py`: the two parsers the port reads its
knobs through (unset, empty or malformed values fall back to the default
instead of raising), the size and duration parsers ("64MB", "30s"), and
the reference's typed configuration (the reference's @Config groups as
dataclasses whose fields carry their key, description and tags): values
resolve from defaults < a JSON config file < the environment
(OZONE_TPU_ prefixed) < overrides (`OzoneConfiguration`),
`generate_defaults` emits the documented defaults file (`getconf`), and
`ReconfigurationHandler` applies registered keys live (the metadata
daemon's `/reconfig`).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, Optional, Type, TypeVar, get_type_hints

T = TypeVar("T")

_SIZE_RE = re.compile(r"^\s*([\d.]+)\s*([kmgtp]?i?b?)\s*$", re.I)
_SIZE_MULT = {
    "": 1, "b": 1,
    "k": 1024, "kb": 1024, "kib": 1024,
    "m": 1024**2, "mb": 1024**2, "mib": 1024**2,
    "g": 1024**3, "gb": 1024**3, "gib": 1024**3,
    "t": 1024**4, "tb": 1024**4, "tib": 1024**4,
    "p": 1024**5, "pb": 1024**5, "pib": 1024**5,
}
_TIME_RE = re.compile(r"^\s*([\d.]+)\s*(ms|s|m|h|d)?\s*$", re.I)
_TIME_MULT = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
              None: 1.0, "": 1.0}


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


def parse_duration(v) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    m = _TIME_RE.match(str(v))
    if not m:
        raise ValueError(f"cannot parse duration {v!r}")
    return float(m.group(1)) * _TIME_MULT[(m.group(2) or "").lower()]


def conf(key: str, description: str = "", tags: tuple[str, ...] = (),
         kind: str = "auto", **kw):
    """Field factory carrying config metadata (@Config analog)."""
    meta = {"key": key, "description": description, "tags": tags,
            "kind": kind}
    return field(metadata=meta, **kw)


def _convert(raw: Any, ftype: Any, kind: str) -> Any:
    if kind == "size":
        return parse_size(raw)
    if kind == "duration":
        return parse_duration(raw)
    if ftype is bool:
        if isinstance(raw, bool):
            return raw
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    if ftype is int:
        return int(raw)
    if ftype is float:
        return float(raw)
    return raw


class OzoneConfiguration:
    """Layered key/value source: defaults < file < env < overrides."""

    ENV_PREFIX = "OZONE_TPU_"

    def __init__(self, config_file: Optional[Path] = None,
                 overrides: Optional[dict[str, Any]] = None):
        self._file_values: dict[str, Any] = {}
        if config_file and Path(config_file).exists():
            self._file_values = json.loads(Path(config_file).read_text())
        self._overrides = dict(overrides or {})

    def raw(self, key: str) -> Optional[Any]:
        if key in self._overrides:
            return self._overrides[key]
        env_key = self.ENV_PREFIX + key.upper().replace(".", "_").replace("-", "_")
        if env_key in os.environ:
            return os.environ[env_key]
        return self._file_values.get(key)

    def set(self, key: str, value: Any) -> None:
        self._overrides[key] = value

    def get_object(self, cls: Type[T]) -> T:
        """Materialize a config dataclass (ConfigurationReflectionUtil
        analog)."""
        hints = get_type_hints(cls)
        kwargs = {}
        for f in fields(cls):
            key = f.metadata.get("key")
            if not key:
                continue
            raw = self.raw(key)
            if raw is not None:
                kwargs[f.name] = _convert(
                    raw, hints.get(f.name), f.metadata.get("kind", "auto")
                )
        return cls(**kwargs)


def generate_defaults(groups: list[type]) -> str:
    """Emit the documented defaults file (ConfigFileGenerator analog)."""
    out: dict[str, Any] = {}
    lines = ["# ozone-tpu generated defaults", "#"]
    for g in groups:
        lines.append(f"# --- {g.__name__}: {(g.__doc__ or '').strip()}")
        inst = g()
        for f in fields(g):
            key = f.metadata.get("key")
            if not key:
                continue
            val = getattr(inst, f.name)
            desc = f.metadata.get("description", "")
            lines.append(f"#   {key} (default: {val!r}) - {desc}")
            out[key] = val
    return "\n".join(lines) + "\n" + json.dumps(out, indent=2, sort_keys=True)


class ReconfigurationHandler:
    """Live reconfiguration (reference: ReconfigureProtocol.proto +
    ReconfigurableConfig, doc feature/Reconfigurability.md): services
    register reconfigurable keys with an apply callback (and optional
    validator); `reconfigure` validates, updates the layered config's
    override tier, and applies — no restart. Non-registered keys are
    rejected, like the reference's getReconfigurableProperties contract.
    """

    def __init__(self, conf_obj: "OzoneConfiguration"):
        self.conf = conf_obj
        self._props: dict[str, dict] = {}

    def register(self, key: str, apply, validator=None,
                 description: str = "") -> None:
        self._props[key] = {
            "apply": apply,
            "validator": validator,
            "description": description,
        }

    def properties(self) -> list[dict]:
        return [
            {"key": k, "description": p["description"],
             "current": self.conf.raw(k)}
            for k, p in sorted(self._props.items())
        ]

    def reconfigure(self, key: str, value: Any) -> dict:
        p = self._props.get(key)
        if p is None:
            raise KeyError(f"{key} is not reconfigurable")
        if p["validator"] is not None:
            value = p["validator"](value)
        old = self.conf.raw(key)
        self.conf.set(key, value)
        p["apply"](value)
        return {"key": key, "old": old, "new": value}


# ------------------------------------------------------------- config groups
@dataclass
class ClientConfig:
    """Client-side IO settings (reference OzoneClientConfig analog)."""

    checksum_type: str = conf(
        "client.checksum.type",
        "Checksum type: NONE/CRC32/CRC32C/SHA256/MD5",
        default="CRC32C",
    )
    bytes_per_checksum: int = conf(
        "client.bytes.per.checksum",
        "Bytes covered by one checksum slice",
        kind="size",
        default=16 * 1024,
    )
    stripe_batch: int = conf(
        "client.ec.stripe.batch",
        "Stripes batched per device encode dispatch",
        default=8,
    )
    max_retries: int = conf(
        "client.max.retries", "Stripe/chunk write retries", default=3
    )


@dataclass
class ScmConfig:
    """SCM settings."""

    container_size: int = conf(
        "scm.container.size", "Container size", kind="size",
        default=5 * 1024**3,
    )
    min_datanodes: int = conf(
        "scm.safemode.min.datanodes",
        "Datanodes required to exit safemode",
        default=1,
    )
    stale_node_interval: float = conf(
        "scm.stale.node.interval", "Heartbeat age before STALE",
        kind="duration", default=9.0,
    )
    dead_node_interval: float = conf(
        "scm.dead.node.interval", "Heartbeat age before DEAD",
        kind="duration", default=30.0,
    )


@dataclass
class DatanodeConfig:
    """Datanode settings."""

    num_volumes: int = conf(
        "dn.volumes", "Storage volumes per datanode", default=1
    )
    heartbeat_interval: float = conf(
        "dn.heartbeat.interval", "Heartbeat period", kind="duration",
        default=1.0,
    )


@dataclass
class OmConfig:
    """OM settings."""

    block_size: int = conf(
        "om.block.size", "Logical block (group) size", kind="size",
        default=16 * 1024 * 1024,
    )
    flush_batch: int = conf(
        "om.db.flush.batch",
        "Metadata double-buffer flush batch size",
        default=64,
    )


ALL_GROUPS = [ClientConfig, ScmConfig, DatanodeConfig, OmConfig]
