"""Fused EC encode + CRC, decode + CRC and XOR(1)->RS re-encode + CRC: one
device pass per stripe batch.

Port of `ozone_tpu/codec/fused.py`. The encoder takes a stripe batch
[B, k, C] and returns the parity [B, p, C] and the CRC of every
bytes_per_checksum slice of all k+p units [B, k+p, C / bpc]. The decoder
takes the v valid units of a batch [B, v, C] and returns the e erased
units [B, e, C] and their slice CRCs [B, e, C / bpc]. The re-encoder
takes an XOR(1) group [B, k, C] with the XOR parity in the lost data
unit's slot and returns the recovered unit with the RS parity
[B, 1+p, C], the CRCs of its k inputs [B, k, S] and of its 1+p outputs
[B, 1+p, S]. Each is one launch of the fused kernel
(codec/fused_kernel.py) with the coding matrix as its runtime argument:
the parity generator for encode, a per-pattern [e, v] recovery matrix for
decode, the composed [1+p, k] matrix for re-encode, so a new pattern
builds a small matrix, never a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ozone_tpu_torch.codec import lrc_math, rs_math
from ozone_tpu_torch.codec.gf256 import gf_matmul
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused_kernel import fused_encode_crc
from ozone_tpu_torch.utils import checksum as hostsum
from ozone_tpu_torch.utils.checksum import ChecksumType

_POLY = {
    ChecksumType.CRC32: hostsum.CRC32_POLY,
    ChecksumType.CRC32C: hostsum.CRC32C_POLY,
}


def effective_bpc(cell_size: int, bytes_per_checksum: int) -> int:
    """Clamp bytes-per-checksum so cells divide into whole slices: a bpc
    larger than the cell (or not dividing it) degrades to one checksum
    per cell."""
    if bytes_per_checksum <= 0:
        return cell_size
    if bytes_per_checksum <= cell_size and cell_size % bytes_per_checksum == 0:
        return bytes_per_checksum
    return cell_size


@dataclass(frozen=True)
class FusedSpec:
    options: CoderOptions
    checksum: ChecksumType = ChecksumType.CRC32C
    bytes_per_checksum: int = 16 * 1024

    def __post_init__(self):
        object.__setattr__(
            self,
            "bytes_per_checksum",
            effective_bpc(self.options.cell_size, self.bytes_per_checksum),
        )


def _parity_matrix(options: CoderOptions) -> np.ndarray:
    """p x k GF(2^8) parity generator: Cauchy for RS, the all-ones row for
    XOR single parity; LRC stacks its l local XOR rows on its r global
    Cauchy rows (lrc_math.parity_matrix), so all its parities are one
    launch."""
    if options.codec == "xor":
        if options.parity_units != 1:
            raise ValueError("xor codec has exactly one parity unit")
        return np.ones((1, options.data_units), dtype=np.uint8)
    if options.codec == "lrc":
        return lrc_math.parity_matrix(options)
    return rs_math.parity_matrix(options.data_units, options.parity_units)


def _decode_matrix(options: CoderOptions, valid: list[int],
                   erased: list[int]) -> np.ndarray:
    """e x len(valid) GF(2^8) recovery matrix. RS inverts the surviving
    k x k submatrix; XOR recovers its one erasable unit as the XOR of the
    k others. LRC solves over any spanning read set (len(valid) may be
    the local group's size instead of k, lrc_math.recovery_rows); the
    kernel takes the narrower matrix as it is."""
    if options.codec == "lrc":
        return lrc_math.recovery_rows(options, list(valid), list(erased))
    if options.codec == "xor":
        if len(erased) != 1:
            raise ValueError("xor codec recovers at most one erasure")
        if len(valid) != options.data_units:
            raise ValueError("xor decode needs all other units")
        if erased[0] == options.data_units:
            # the parity itself: re-encode from the k data units
            return np.ones((1, options.data_units), dtype=np.uint8)
        return np.ones((1, len(valid)), dtype=np.uint8)
    return rs_math.decode_matrix(
        options.data_units, options.parity_units, list(erased), list(valid))


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; CUDA must be present
    unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path")
    return dev


def _to_device(units, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor of units as a uint8 tensor on `dev`, copied
    without blocking (asynchronously when the host memory is pinned)."""
    if not isinstance(units, torch.Tensor):
        units = torch.from_numpy(np.ascontiguousarray(units, dtype=np.uint8))
    return units.to(dev, non_blocking=True)


def make_fused_encoder(spec: FusedSpec, device="cuda"):
    """fn(data uint8 [B, k, C]) -> (parity uint8 [B, p, C],
    crcs int32 [B, k+p, C // bpc]), both torch tensors on `device`; CRC
    words are uint32 bit patterns (`.numpy().view(np.uint32)`), and the
    CRC tensor is [B, k+p, 0] when the checksum is not CRC32/CRC32C.
    `data` may be a numpy array or a tensor; host data goes to the device
    with a non-blocking copy (asynchronous when it is pinned)."""
    dev = resolve_device(device)
    matrix = torch.from_numpy(_parity_matrix(spec.options)).to(dev)
    poly = _POLY.get(spec.checksum)
    bpc = spec.bytes_per_checksum

    def fn(data):
        data = _to_device(data, dev)
        parity, crcs = fused_encode_crc(data, matrix, poly, bpc)
        if poly is None:
            b, k = data.shape[:2]
            crcs = torch.zeros((b, k + parity.shape[1], 0), dtype=torch.int32,
                               device=dev)
        return parity, crcs

    return fn


@lru_cache(maxsize=512)
def _decode_plan_cached(options: CoderOptions, valid: tuple, erased: tuple,
                        device: torch.device) -> torch.Tensor:
    """The [e, v] uint8 recovery matrix of one erasure pattern, on
    `device`. Cheap to build (a k x k GF inversion and one small copy);
    every pattern shares the one kernel library."""
    dm = _decode_matrix(options, list(valid), list(erased))
    return torch.from_numpy(dm).to(device)


def decode_plan_cache_size() -> int:
    """Decode plans (erasure patterns x devices) currently cached."""
    return _decode_plan_cached.cache_info().currsize


def make_fused_decoder(spec: FusedSpec, valid: list[int], erased: list[int],
                       device="cuda"):
    """fn(valid_units uint8 [B, v, C]) -> (rec uint8 [B, e, C],
    crcs int32 [B, e, C // bpc]), both torch tensors on `device`. `valid`
    lists the unit indexes of the v rows supplied, `erased` the units to
    rebuild, in output order. CRC words are uint32 bit patterns, and the
    CRC tensor is [B, e, 0] when the checksum is not CRC32/CRC32C. Host
    input goes to the device with a non-blocking copy (asynchronous when
    it is pinned)."""
    dev = resolve_device(device)
    matrix = _decode_plan_cached(spec.options, tuple(valid), tuple(erased), dev)
    poly = _POLY.get(spec.checksum)
    bpc = spec.bytes_per_checksum

    def fn(valid_units):
        valid_units = _to_device(valid_units, dev)
        rec, crcs = fused_encode_crc(valid_units, matrix, poly, bpc,
                                     crc_in=False)
        if poly is None:
            crcs = torch.zeros(rec.shape[:2] + (0,), dtype=torch.int32,
                               device=dev)
        return rec, crcs

    return fn


def _reencode_matrix(options: CoderOptions, lost: int) -> np.ndarray:
    """[1+p, k] GF(2^8) matrix of XOR(1)-decode composed with RS-encode:
    M = [D[lost]; P D], where D is the k x k XOR-decode matrix (identity
    rows for the survivors, the all-ones row for slot `lost`, which holds
    the XOR parity: over GF(2) the lost unit is the XOR of all k slots)
    and P the Cauchy parity matrix."""
    k, p = options.data_units, options.parity_units
    if not 0 <= lost < k:
        raise ValueError(f"lost unit {lost} is not a data unit of {k}")
    d = np.eye(k, dtype=np.uint8)
    d[lost, :] = 1
    pm = rs_math.parity_matrix(k, p)
    return np.vstack([d[lost:lost + 1], gf_matmul(pm, d)])


@lru_cache(maxsize=64)
def _reencode_plan_cached(options: CoderOptions, lost: int,
                          device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_reencode_matrix(options, lost)).to(device)


def make_fused_reencoder(spec: FusedSpec, lost: int = 0, device="cuda"):
    """fn(units uint8 [B, k, C]) -> (out uint8 [B, 1+p, C],
    units_crcs int32 [B, k, S], out_crcs int32 [B, 1+p, S]), torch tensors
    on `device`, S = C // bpc (0 when the checksum is not CRC32/CRC32C).

    `units` carries the XOR(1) group with data unit `lost` replaced by the
    XOR parity in its slot. One launch (crc_in and crc_out) recovers the
    lost unit (out[:, 0]), computes the RS parity of the full group
    (out[:, 1:]) and checksums every input and output; its [B, k+1+p, S]
    CRC rows, inputs first, are split into the two CRC tensors.
    `reencode_layout_crcs` assembles the k+p EC-layout order on the host;
    units_crcs[:, lost] checksums the XOR parity slot and goes unused."""
    dev = resolve_device(device)
    matrix = _reencode_plan_cached(spec.options, int(lost), dev)
    poly = _POLY.get(spec.checksum)
    bpc = spec.bytes_per_checksum
    k = spec.options.data_units

    def fn(units):
        units = _to_device(units, dev)
        out, crcs = fused_encode_crc(units, matrix, poly, bpc)
        if poly is None:
            empty = torch.zeros((units.shape[0], 0, 0), dtype=torch.int32,
                                device=dev)
            return out, empty, empty
        return out, crcs[:, :k], crcs[:, k:]

    return fn


def reencode_layout_crcs(units_crcs: np.ndarray, out_crcs: np.ndarray,
                         lost: int) -> np.ndarray:
    """Assemble re-encode CRCs into EC layout order [B, k+p, S]: data
    units 0..k-1 (the recovered unit in slot `lost`), then parity."""
    return np.concatenate(
        [units_crcs[:, :lost], out_crcs[:, :1],
         units_crcs[:, lost + 1:], out_crcs[:, 1:]],
        axis=1,
    )
