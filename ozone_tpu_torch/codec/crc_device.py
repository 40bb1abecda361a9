"""CRC32/CRC32C of fixed-size slices as a GF(2) product, in PyTorch.

Port of `ozone_tpu/codec/crc_device.py`. A reflected CRC is affine over
GF(2): crc(M) = L(M) xor Z_n, where L is linear and Z_n = crc(0^n). L(M)
is the XOR of one 32-bit contribution per set message bit, so a slice's
CRC is (message_bits @ K) mod 2 against a constant K [n*8, 32]. The
constants come from utils/checksum._linear_parts, the same code that backs
the host CRC.

`crc_slices_plain` is the plain version the CUDA kernel
(codec/fused_kernel.py) is held against; `make_crc_fn` launches that
kernel with no coding rows on a CUDA tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ozone_tpu_torch.utils import checksum as hostsum


@lru_cache(maxsize=32)
def crc_constants(n_bytes: int, poly: int) -> tuple[np.ndarray, int]:
    """(K bit matrix [n*8, 32] int8 in message-bit order, zeros_crc)."""
    k32, zeros_crc = hostsum._linear_parts(n_bytes, poly)
    bits = ((k32[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int8)
    return bits, zeros_crc


@lru_cache(maxsize=32)
def crc_constants_planemajor(n_bytes: int, poly: int) -> tuple[np.ndarray, int]:
    """(K [8, n, 32] int8 indexed [bit, byte_pos, crc_bit], zeros_crc): the
    row order `ozone_tpu`'s device code contracts against."""
    k, zeros_crc = crc_constants(n_bytes, poly)
    return k.reshape(n_bytes, 8, 32).transpose(1, 0, 2).copy(), zeros_crc


def crc_slices_plain(cells: torch.Tensor, k_planes, zeros_crc: int) -> torch.Tensor:
    """uint8 cells [..., C] -> int32 CRC words [..., C // n] (uint32 bit
    patterns) for n-byte slices; k_planes is crc_constants_planemajor(n,
    poly)[0] as numpy or a tensor.

    The contraction runs in float32: every product is 0 or 1 and every
    partial sum an integer of at most 8n < 2^24, so it is exact (inputs 0
    and 1 are exact in TF32 too)."""
    k_planes = torch.as_tensor(k_planes, device=cells.device)
    _, n, _ = k_planes.shape
    c = cells.shape[-1]
    if c % n:
        raise ValueError(f"cell {c} does not divide into {n}-byte slices")
    shifts = torch.arange(8, dtype=torch.uint8, device=cells.device)
    # byte-major bits [..., C, 8] keep each slice's bits contiguous, so the
    # plane-major constant is reordered once instead of the data
    bits = ((cells[..., None] >> shifts) & 1).to(torch.float32)
    bits = bits.reshape(*cells.shape[:-1], c // n, n * 8)
    k_bytes = k_planes.permute(1, 0, 2).reshape(n * 8, 32).to(torch.float32)
    acc = (bits @ k_bytes).to(torch.int64) & 1  # [..., S, 32]
    weights = torch.ones(32, dtype=torch.int64, device=cells.device) << torch.arange(
        32, device=cells.device)
    words = (acc * weights).sum(-1) ^ zeros_crc
    return words.to(torch.int32)  # wraps to the same 32-bit pattern


def make_crc_fn(slice_bytes: int, poly: int = hostsum.CRC32C_POLY):
    """fn(cells uint8 [..., C]) -> int32 CRC words [..., C // slice_bytes].

    On a CUDA tensor this launches the fused kernel with no coding rows;
    on a CPU tensor it runs its plain version."""
    from ozone_tpu_torch.codec import fused_kernel

    empty = np.zeros((0, 1), dtype=np.uint8)

    def fn(cells: torch.Tensor) -> torch.Tensor:
        lead, c = cells.shape[:-1], cells.shape[-1]
        flat = cells.reshape(-1, 1, c)
        matrix = torch.from_numpy(empty).to(cells.device)
        _, crcs = fused_kernel.fused_encode_crc(
            flat, matrix, poly, slice_bytes, crc_in=True, crc_out=False)
        return crcs.reshape(*lead, c // slice_bytes)

    return fn
