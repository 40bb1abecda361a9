"""Raw erasure coder SPI: the EC schema and the encoder/decoder base classes.

Port of `ozone_tpu/codec/api.py`. `CoderOptions` is the analog of the
reference's ECReplicationConfig (hdds/client/ECReplicationConfig.java:
35-136); `RawErasureEncoder`/`RawErasureDecoder` mirror the reference's
RawErasureEncoder/RawErasureDecoder with an array-first contract:

- encode(data) takes uint8 arrays shaped [k, C] or batched [B, k, C] and
  returns parity shaped [p, C] / [B, p, C].
- decode(inputs, erased) takes a length-(k+p) sequence with None holes
  (at least k present) and returns the reconstructed units in `erased`
  order.

Inputs and outputs are numpy arrays; a backend that runs on a device
(codec/torch_coder.py) copies them there and back. The backends register
in codec/registry.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

#: codec families the registry always provides; a CoderOptions string
#: may name these or any family registered since (registry.known_families)
KNOWN_FAMILIES = ("dummy", "lrc", "rs", "xor")


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
        """Parse "rs-6-3-1024k" / "xor-2-1-4096" / "lrc-12-2-2[-1m]" forms.

        The codec name is checked against the registered families at
        parse time, so a typo fails here with the supported list."""
        parts = s.strip().lower().split("-")
        codec = parts[0] if parts else ""
        # function-local: the registry imports this module, and reading
        # the families must not create it (that would import backends)
        from ozone_tpu_torch.codec.registry import known_families

        families = known_families()
        if codec not in families:
            raise ValueError(
                f"unknown EC codec {codec!r} in {s!r}; supported "
                f"families: {', '.join(families)}")
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


def _as_batched(arr: np.ndarray, units: int) -> tuple[np.ndarray, bool]:
    """Normalize [units, C] -> [1, units, C]; return (arr, was_unbatched)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected uint8 buffers, got {arr.dtype}")
    if arr.ndim == 2:
        if arr.shape[0] != units:
            raise ValueError(f"expected {units} units, got {arr.shape[0]}")
        return arr[None], True
    if arr.ndim == 3:
        if arr.shape[1] != units:
            raise ValueError(f"expected {units} units, got {arr.shape[1]}")
        return arr, False
    raise ValueError(f"expected [units,C] or [B,units,C], got shape {arr.shape}")


class RawErasureEncoder:
    """Base encoder. Subclasses implement do_encode on [B, k, C]."""

    def __init__(self, options: CoderOptions):
        self.options = options

    @property
    def k(self) -> int:
        return self.options.data_units

    @property
    def p(self) -> int:
        return self.options.parity_units

    def encode(self, data: np.ndarray | Sequence[np.ndarray]) -> np.ndarray:
        """data: [k, C] or [B, k, C] (or sequence of k equal-length buffers)
        -> parity [p, C] or [B, p, C]."""
        if not isinstance(data, np.ndarray):
            data = np.stack([np.asarray(d, dtype=np.uint8) for d in data])
        batched, squeeze = _as_batched(data, self.k)
        out = self.do_encode(batched)
        return out[0] if squeeze else out

    def do_encode(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def release(self) -> None:
        """Free coder resources (reference RawErasureEncoder.release())."""


def check_decode_inputs(options: CoderOptions,
                        inputs: Sequence[Optional[np.ndarray]],
                        erased_indexes: Sequence[int]) -> tuple[list[int], list[int]]:
    """Validate a decode call's inputs against `options` with the
    reference's messages; returns (erased, available unit indexes)."""
    n = options.all_units
    if len(inputs) != n:
        raise ValueError(f"inputs must have length {n}, got {len(inputs)}")
    erased = [int(e) for e in erased_indexes]
    if not erased:
        raise ValueError("erased_indexes must not be empty")
    for e in erased:
        if not 0 <= e < n:
            raise ValueError(f"erased index {e} out of range")
        if inputs[e] is not None:
            raise ValueError(f"erased index {e} has a non-null input")
    return erased, [i for i, b in enumerate(inputs) if b is not None]


def dense_valid(inputs: Sequence[Optional[np.ndarray]],
                valid: list[int]) -> tuple[np.ndarray, bool]:
    """The `valid` units stacked as [B, v, C] (a view across the unit axis
    for [B, C] units, not contiguous), and whether they were unbatched."""
    dense = np.stack([np.asarray(inputs[i], dtype=np.uint8) for i in valid])
    if dense.ndim == 2:
        return dense[None], True
    if dense.ndim == 3:
        return np.swapaxes(dense, 0, 1), False
    raise ValueError(f"bad input rank {dense.ndim}")


class RawErasureDecoder:
    """Base decoder. Subclasses implement do_decode on dense valid inputs."""

    def __init__(self, options: CoderOptions):
        self.options = options

    @property
    def k(self) -> int:
        return self.options.data_units

    @property
    def p(self) -> int:
        return self.options.parity_units

    def decode(
        self,
        inputs: Sequence[Optional[np.ndarray]],
        erased_indexes: Sequence[int],
    ) -> np.ndarray:
        """Reconstruct `erased_indexes` units.

        inputs: length k+p, None for unavailable units, each present unit
        [C] or [B, C]. Returns [len(erased), C] / [B, len(erased), C].
        The valid set is the first k available units.
        """
        erased, avail = check_decode_inputs(self.options, inputs,
                                            erased_indexes)
        if len(avail) < self.k:
            raise ValueError(
                f"need at least {self.k} available units, have {len(avail)}"
            )
        valid = avail[: self.k]
        dense, squeeze = dense_valid(inputs, valid)
        out = self.do_decode(dense, valid, erased)
        return out[0] if squeeze else out

    def do_decode(
        self, valid_data: np.ndarray, valid: list[int], erased: list[int]
    ) -> np.ndarray:
        """valid_data: [B, k, C] in valid-index order -> [B, len(erased), C]."""
        raise NotImplementedError

    def release(self) -> None:
        """Free coder resources."""
