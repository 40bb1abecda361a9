"""Fused EC encode + CRC pass: one device pass per stripe batch.

Port of the encode half of `ozone_tpu/codec/fused.py`. The encoder takes
a stripe batch [B, k, C] and returns the parity [B, p, C] and the CRC of
every bytes_per_checksum slice of all k+p units [B, k+p, C / bpc], from
one launch of the fused kernel (codec/fused_kernel.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ozone_tpu_torch.codec import rs_math
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
    XOR single parity."""
    if options.codec == "xor":
        if options.parity_units != 1:
            raise ValueError("xor codec has exactly one parity unit")
        return np.ones((1, options.data_units), dtype=np.uint8)
    if options.codec == "lrc":
        raise NotImplementedError("the lrc codec is not ported yet")
    return rs_math.parity_matrix(options.data_units, options.parity_units)


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; CUDA must be present
    unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path")
    return dev


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
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        data = data.to(dev, non_blocking=True)
        parity, crcs = fused_encode_crc(data, matrix, poly, bpc)
        if poly is None:
            b, k = data.shape[:2]
            crcs = torch.zeros((b, k + parity.shape[1], 0), dtype=torch.int32,
                               device=dev)
        return parity, crcs

    return fn
