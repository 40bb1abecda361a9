"""PyTorch/CUDA erasure coder: the raw coder SPI on the fused kernel.

Counterpart of `ozone_tpu/codec/jax_coder.py`. Two device functions carry
it, each one launch of the fused kernel (`codec/fused_kernel.py`,
`csrc/fused_encode_crc.cu`) with no CRC rows:

- `gf_apply(data [B, k, C], matrix [r, k]) -> [B, r, C]`, the GF(2^8)
  matrix apply, stands for `jax_coder.gf_apply` and `_gf_apply_jit`:
  encode with the Cauchy parity rows, decode with a per-pattern
  recovery matrix (rs_math.decode_matrix);
- `xor_reduce(units [B, k, C]) -> [B, 1, C]`, the bytewise XOR over the
  unit axis, stands for `_xor_reduce_jit`: the same kernel with an
  all-ones [1, k] matrix.

With no CRC rows the kernel's slice is only how a cell splits across
blocks, so a launch cuts each cell into the largest slices of at most
one 4 KiB tile that divide it (`apply_slice`): a 1 MiB cell runs as 256
blocks, not one. A CPU tensor runs the plain versions (`gf_apply_plain`,
`xor_reduce_plain`); a CUDA tensor launches the kernel or raises.

The SPI classes at the bottom take and return numpy arrays and copy
them to `device` and back ("cuda" by default; the constructor raises
when CUDA is absent, "cpu" runs the plain versions). A build or launch
error raises from encode/decode, never from the constructor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ozone_tpu_torch.codec import rs_math
from ozone_tpu_torch.codec.api import CoderOptions, RawErasureDecoder, RawErasureEncoder
from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.codec.fused_kernel import (
    MAX_P,
    MAX_TILE,
    MIN_TILE,
    LaunchCounter,
    fused_encode_crc,
    gf_apply_plain,
)

#: kernel launches of each form in this process (a CPU call counts none)
apply_launches = LaunchCounter()
xor_launches = LaunchCounter()


@lru_cache(maxsize=256)
def apply_slice(cell: int) -> int:
    """The kernel slice a no-CRC launch cuts a `cell`-byte row into: the
    cell itself up to one tile, else its largest divisor that is a
    multiple of 16 between 512 and 4096 (whole 16-byte vectors, no
    padding), else the cell."""
    if cell <= MAX_TILE:
        return cell
    for d in range(MAX_TILE, MIN_TILE - 1, -16):
        if cell % d == 0:
            return d
    return cell


def xor_reduce_plain(units: torch.Tensor) -> torch.Tensor:
    """uint8 [B, k, C] -> [B, 1, C], the XOR of the k units, on any device."""
    out = units[:, 0].clone()
    for j in range(1, units.shape[1]):
        out ^= units[:, j]
    return out[:, None]


def gf_apply(data: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """uint8 units [B, k, C] x GF(2^8) matrix [r, k] (same device) ->
    uint8 [B, r, C]: one kernel launch on a CUDA tensor, `gf_apply_plain`
    on a CPU tensor."""
    out, _ = fused_encode_crc(data, matrix, None, apply_slice(data.shape[-1]))
    if data.device.type == "cuda":
        apply_launches.add()
    return out


@lru_cache(maxsize=64)
def _ones(k: int, device: torch.device) -> torch.Tensor:
    return torch.ones((1, k), dtype=torch.uint8, device=device)


def xor_reduce(units: torch.Tensor) -> torch.Tensor:
    """uint8 [B, k, C] -> [B, 1, C], the bytewise XOR over the unit axis:
    one kernel launch with an all-ones [1, k] matrix on a CUDA tensor,
    `xor_reduce_plain` on a CPU tensor."""
    if not isinstance(units, torch.Tensor) or units.dim() != 3:
        raise ValueError("want units [B, k, C] as a torch tensor")
    if units.device.type == "cpu":
        if units.dtype != torch.uint8:
            raise TypeError(f"want uint8 units, got {units.dtype}")
        return xor_reduce_plain(units)
    out, _ = fused_encode_crc(units, _ones(units.shape[1], units.device), None,
                              apply_slice(units.shape[-1]))
    xor_launches.add()
    return out


def encode_fn(options: CoderOptions, device="cuda"):
    """(pure_fn, matrix): pure_fn(data [B, k, C], matrix) -> parity
    [B, p, C] on the device of `data`; `matrix` is the Cauchy parity
    generator [p, k] on `device`."""
    dev = resolve_device(device)
    pm = rs_math.parity_matrix(options.data_units, options.parity_units)
    return gf_apply, torch.from_numpy(pm).to(dev)


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    # a decoder's [B, C] inputs arrive as a strided view across units:
    # the kernel takes contiguous rows only
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint8)).to(dev)


def _check_rows(rows: int) -> None:
    if rows > MAX_P:
        raise ValueError(f"the kernel writes at most {MAX_P} rows, not {rows}")


class TorchRSEncoder(RawErasureEncoder):
    def __init__(self, options: CoderOptions, device="cuda"):
        super().__init__(options)
        _check_rows(self.p)
        self.device = resolve_device(device)
        _, self._matrix = encode_fn(options, self.device)

    def do_encode(self, data: np.ndarray) -> np.ndarray:
        return gf_apply(_to_device(data, self.device), self._matrix).cpu().numpy()


class TorchRSDecoder(RawErasureDecoder):
    def __init__(self, options: CoderOptions, device="cuda"):
        super().__init__(options)
        _check_rows(self.p)
        self.device = resolve_device(device)
        #: (valid, erased) -> the [e, k] recovery matrix on the device
        self._cache: dict[tuple, torch.Tensor] = {}

    def _matrix(self, valid: list[int], erased: list[int]) -> torch.Tensor:
        key = (tuple(valid), tuple(erased))
        m = self._cache.get(key)
        if m is None:
            dm = rs_math.decode_matrix(self.k, self.p, erased, valid)
            m = self._cache[key] = torch.from_numpy(dm).to(self.device)
        return m

    def do_decode(self, valid_data, valid, erased):
        m = self._matrix(valid, erased)
        return gf_apply(_to_device(valid_data, self.device), m).cpu().numpy()


class TorchXOREncoder(RawErasureEncoder):
    """XOR single parity on the device (reference XORRawEncoder.java)."""

    def __init__(self, options: CoderOptions, device="cuda"):
        if options.parity_units != 1:
            raise ValueError("XOR codec supports exactly one parity unit")
        super().__init__(options)
        self.device = resolve_device(device)

    def do_encode(self, data: np.ndarray) -> np.ndarray:
        return xor_reduce(_to_device(data, self.device)).cpu().numpy()


class TorchXORDecoder(RawErasureDecoder):
    def __init__(self, options: CoderOptions, device="cuda"):
        if options.parity_units != 1:
            raise ValueError("XOR codec supports exactly one parity unit")
        super().__init__(options)
        self.device = resolve_device(device)

    def do_decode(self, valid_data, valid, erased):
        if len(erased) != 1:
            raise ValueError("XOR can reconstruct exactly one erased unit")
        return xor_reduce(_to_device(valid_data, self.device)).cpu().numpy()
