"""CRC32C (Castagnoli: reflected polynomial 0x82F63B78, register preset
and final XOR 0xFFFFFFFF), as Ozone stores it per bytes-per-checksum slice.

`crc32c` is the definition, one byte at a time. `slice_crcs` computes many
slices of one length at once: the CRC is affine in the message, so a
slice's CRC is the XOR of one table entry per byte (that byte's
contribution from its position) with the CRC of a zero slice; the
position tables are built from the one-byte table by shifting in zeros.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

POLY = 0x82F63B78
MASK = 0xFFFFFFFF


@lru_cache(maxsize=1)
def byte_table() -> np.ndarray:
    """[256] uint32: the register after one byte b from a zero register."""
    out = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        out[b] = c
    return out.astype(np.uint32)


def crc32c(data) -> int:
    """CRC32C of a bytes-like object, byte by byte."""
    table = byte_table()
    c = MASK
    for b in bytes(data):
        c = int(table[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c ^ MASK


@lru_cache(maxsize=4)
def _position_tables(length: int) -> tuple[np.ndarray, int]:
    """([length, 256] uint32 contributions of byte b at position i, the
    CRC of `length` zero bytes)."""
    table = byte_table().astype(np.uint64)
    out = np.zeros((length, 256), dtype=np.uint64)
    cur = table.copy()
    # the last byte is shifted by no zeros, the first by length - 1
    for n in range(length):
        out[length - 1 - n] = cur
        cur = (cur >> 8) ^ table[(cur & 0xFF).astype(np.int64)]
    return out.astype(np.uint32), crc32c(bytes(length))


_device_tables: dict = {}


def slice_crcs(slices: torch.Tensor, block: int = 256) -> torch.Tensor:
    """int64 [N] CRC32C of each row of uint8 [N, L] (on any device)."""
    n, length = slices.shape
    key = (length, str(slices.device))
    if key not in _device_tables:
        tabs, zero_crc = _position_tables(length)
        flat = torch.from_numpy(tabs.astype(np.int64).reshape(-1))
        _device_tables[key] = (flat.to(slices.device), zero_crc)
    flat, zero_crc = _device_tables[key]
    base = torch.arange(length, device=slices.device, dtype=torch.int64) * 256
    out = torch.empty(n, dtype=torch.int64, device=slices.device)
    for r0 in range(0, n, block):
        rows = slices[r0:r0 + block].to(torch.int64)
        vals = flat[rows + base]
        width = length
        while width > 1:
            if width % 2:
                vals = torch.cat([vals, torch.zeros_like(vals[:, :1])], dim=1)
                width += 1
            half = width // 2
            vals = vals[:, :half] ^ vals[:, half:width]
            width = half
        out[r0:r0 + block] = vals[:, 0] ^ zero_crc
    return out


def cell_crcs(cells: torch.Tensor, bpc: int) -> torch.Tensor:
    """int64 [..., C // bpc] CRC32C per bpc slice of uint8 [..., C]."""
    c = cells.shape[-1]
    if c % bpc:
        raise ValueError(f"cell {c} is not a whole number of {bpc}-byte slices")
    lead = cells.shape[:-1]
    flat = cells.reshape(-1, bpc)
    return slice_crcs(flat).reshape(*lead, c // bpc)
