"""Coder options: the EC schema and its string form.

Port of `CoderOptions` from `ozone_tpu/codec/api.py` (the analog of the
reference's ECReplicationConfig, hdds/client/ECReplicationConfig.java:
35-136). The raw coder SPI classes are not ported: the port's coding
runs through codec/fused.py.
"""

from __future__ import annotations

from dataclasses import dataclass

#: codec families a CoderOptions string may name
KNOWN_FAMILIES = ("lrc", "rs", "xor")


@dataclass(frozen=True)
class CoderOptions:
    """Schema for one coder instance: data units, parity units, codec
    name, and the EC cell size (1 MiB default). String form parses/prints
    as e.g. "rs-6-3-1024k".

    LRC schemes carry local-group geometry: `local_groups` (> 0 only for
    codec "lrc") splits the k data units into that many equal groups, the
    first `local_groups` parity units are the per-group XOR locals and the
    rest are global parities. String form "lrc-k-l-r[-cell]".
    """

    data_units: int
    parity_units: int
    codec: str = "rs"
    cell_size: int = 1024 * 1024
    local_groups: int = 0

    def __post_init__(self):
        if self.data_units < 1 or self.parity_units < 1:
            raise ValueError(f"bad EC schema {self}")
        if self.data_units + self.parity_units >= 256:
            raise ValueError("k+p must be < 256 for GF(2^8) RS")
        if self.codec == "lrc":
            if self.local_groups < 1:
                raise ValueError("lrc codec needs local_groups >= 1")
            if self.data_units % self.local_groups != 0:
                raise ValueError(
                    f"lrc data units ({self.data_units}) must divide into "
                    f"{self.local_groups} equal local groups")
            if self.parity_units <= self.local_groups:
                raise ValueError(
                    "lrc needs at least one global parity "
                    f"(parity_units={self.parity_units} <= "
                    f"local_groups={self.local_groups})")
        elif self.local_groups:
            raise ValueError(
                f"local_groups only applies to the lrc codec, not "
                f"{self.codec!r}")

    @property
    def all_units(self) -> int:
        return self.data_units + self.parity_units

    @property
    def global_parities(self) -> int:
        """Parity units that span all data units (p for RS/XOR, r for LRC)."""
        return self.parity_units - self.local_groups

    @property
    def group_size(self) -> int:
        """Data units per local group (LRC); equals data_units otherwise."""
        if self.local_groups:
            return self.data_units // self.local_groups
        return self.data_units

    @staticmethod
    def _parse_cell(t: str) -> int:
        if t.endswith("k"):
            return int(t[:-1]) * 1024
        if t.endswith("m"):
            return int(t[:-1]) * 1024 * 1024
        return int(t)

    @classmethod
    def parse(cls, s: str) -> "CoderOptions":
        """Parse "rs-6-3-1024k" / "xor-2-1-4096" / "lrc-12-2-2[-1m]" forms."""
        parts = s.strip().lower().split("-")
        codec = parts[0] if parts else ""
        if codec not in KNOWN_FAMILIES:
            raise ValueError(
                f"unknown EC codec {codec!r} in {s!r}; supported "
                f"families: {', '.join(KNOWN_FAMILIES)}")
        if codec == "lrc":
            if len(parts) not in (4, 5):
                raise ValueError(
                    f"cannot parse LRC config {s!r} (want lrc-k-l-r[-cell])")
            k, l, r = int(parts[1]), int(parts[2]), int(parts[3])
            cell = cls._parse_cell(parts[4]) if len(parts) == 5 else 1024 * 1024
            return cls(k, l + r, codec, cell, local_groups=l)
        if len(parts) not in (3, 4):
            raise ValueError(f"cannot parse EC config {s!r}")
        k, p = int(parts[1]), int(parts[2])
        cell = cls._parse_cell(parts[3]) if len(parts) == 4 else 1024 * 1024
        return cls(k, p, codec, cell)

    def __str__(self) -> str:
        if self.cell_size % (1024 * 1024) == 0:
            t = f"{self.cell_size // (1024 * 1024)}m"
        elif self.cell_size % 1024 == 0:
            t = f"{self.cell_size // 1024}k"
        else:
            t = str(self.cell_size)
        if self.codec == "lrc":
            return (f"lrc-{self.data_units}-{self.local_groups}-"
                    f"{self.global_parities}-{t}")
        return f"{self.codec}-{self.data_units}-{self.parity_units}-{t}"
