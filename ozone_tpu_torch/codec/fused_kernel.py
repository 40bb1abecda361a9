"""Fused GF(2^8) matrix apply + slice CRC: the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of `ozone_tpu/codec/pallas_kernel.py` (and of the XLA program
`ozone_tpu/codec/fused._fused_encode_cached.fn`, which computes the same
function). `fused_encode_crc(data [B, k, C], matrix [p, k])` returns

    out  uint8 [B, p, C]   out[b, i] = XOR_j matrix[i, j] * data[b, j]
    crcs int32 [B, R, S]   CRC words (uint32 bit patterns) of every
                           slice_bytes piece of the k inputs (crc_in) and
                           the p outputs (crc_out), inputs first; S = C /
                           slice_bytes, R = 0 when poly is None.

The matrix is a runtime argument, so encode, decode and re-encode share
one kernel. A CUDA tensor launches `csrc/fused_encode_crc.cu`; a CPU
tensor runs `fused_encode_crc_plain`. Nothing falls back from one to the
other.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch

from ozone_tpu_torch import cuda_build
from ozone_tpu_torch.codec.bitlin import expand_coding_matrix
from ozone_tpu_torch.codec.crc_device import crc_constants_planemajor, crc_slices_plain
from ozone_tpu_torch.utils import checksum as hostsum

#: limits of the kernel (csrc/fused_encode_crc.cu): output rows held in
#: registers, and the shared memory, static and dynamic, one block may
#: take on Hopper
MAX_P = 16
MAX_SMEM_BYTES = 232448
#: the kernel's lanes per warp, and the bounds of its per-row tile
LANES = 32
MIN_TILE, MAX_TILE = LANES * 16, 4096


class LaunchCounter:
    """Thread-safe count of kernel launches (writers run on many threads):
    `count` since the last `reset()`, `total` since start. A caller that
    counts its own dispatches passes the increment to `tallied()`; the
    next launch on its thread runs it inside the same critical section,
    so a reader that holds `held()` sees a launch and its dispatch
    counted both or neither. Only the increments share the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.count = 0
        self.total = 0

    def held(self):
        return self._lock

    def add(self) -> None:
        with self._lock:
            self.count += 1
            self.total += 1
            tally = getattr(self._local, "tally", None)
            if tally is not None:
                self._local.tally = None
                tally()

    @contextlib.contextmanager
    def tallied(self, tally: Callable[[], None]):
        """Run `tally` with the first launch this thread makes inside the
        block; if it makes none (a CPU tensor runs the plain version),
        run it when the block ends without an error."""
        self._local.tally = tally
        ok = False
        try:
            yield
            ok = True
        finally:
            pending, self._local.tally = self._local.tally, None
            if ok and pending is not None:
                pending()

    def reset(self) -> None:
        with self._lock:
            self.count = 0


#: launches of the fused encode+CRC kernel in this process
launches = LaunchCounter()


# ------------------------------------------------------------------ plain
def gf_apply_plain(data: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """uint8 [B, k, C] x GF(2^8) matrix [r, k] -> uint8 [B, r, C], in
    `ozone_tpu.codec.jax_coder.gf_apply`'s formulation: expand to bits,
    multiply by the bit-expanded matrix, keep the low bit, pack. The
    product runs in float32, exact since every sum is at most 8k < 2^24."""
    b, k, c = data.shape
    a_bits = torch.from_numpy(expand_coding_matrix(matrix.cpu().numpy()))
    a_bits = a_bits.to(device=data.device, dtype=torch.float32)  # [8k, 8r]
    r = a_bits.shape[1] // 8
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data[:, :, None, :] >> shifts[:, None]) & 1).to(torch.float32)
    acc = a_bits.T @ bits.reshape(b, 8 * k, c)  # [B, 8r, C]
    pbits = (acc.to(torch.int32) & 1).reshape(b, r, 8, c)
    return (pbits << shifts.to(torch.int32)[:, None]).sum(2).to(torch.uint8)


def fused_encode_crc_plain(data: torch.Tensor, matrix: torch.Tensor,
                           poly: Optional[int], slice_bytes: int,
                           crc_in: bool = True, crc_out: bool = True):
    """The plain PyTorch version of the kernel: same contract as
    `fused_encode_crc`, on any device."""
    b, _, c = data.shape
    out = gf_apply_plain(data, matrix)
    rows = []
    if poly is not None:
        k_planes, zeros_crc = crc_constants_planemajor(slice_bytes, poly)
        if crc_in:
            rows.append(crc_slices_plain(data, k_planes, zeros_crc))
        if crc_out:
            rows.append(crc_slices_plain(out, k_planes, zeros_crc))
    if not rows:
        return out, torch.zeros((b, 0, c // slice_bytes), dtype=torch.int32,
                                device=data.device)
    return out, torch.cat(rows, dim=1)


# ----------------------------------------------------------------- kernel
@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_encode_crc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_encode_crc.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                     ctypes.c_uint, p]
    lib.fused_encode_crc.restype = i
    lib.fused_encode_crc_error.argtypes = [i]
    lib.fused_encode_crc_error.restype = ctypes.c_char_p
    lib.fused_encode_crc_smem_bytes.argtypes = [i, i, i, i]
    lib.fused_encode_crc_smem_bytes.restype = ctypes.c_longlong
    lib.fused_encode_crc_blocks_per_sm.argtypes = [i, i, i, i]
    lib.fused_encode_crc_blocks_per_sm.restype = i
    return lib


def kernel_tile(slice_bytes: int) -> int:
    """Bytes per row of one tile of the kernel for this slice length: the
    slice rounded up to 512, at most 4096 (`make_layout` in the source)."""
    return min(-(-slice_bytes // MIN_TILE) * MIN_TILE, MAX_TILE)


def advance_lengths(slice_bytes: int) -> tuple[int, ...]:
    """Zero-byte lengths of the kernel's six advance operators, in order:
    the per-tile gap a lane skips (tile - piece), then the five fold
    levels piece, 2 piece, ..., 16 piece, where piece = tile / 32."""
    tile = kernel_tile(slice_bytes)
    piece = tile // LANES
    return (tile - piece,) + tuple(piece << i for i in range(5))


@lru_cache(maxsize=64)
def kernel_constants(poly: int, slice_bytes: int) -> np.ndarray:
    """uint32 [256 + 6*32]: the reflected CRC's byte table, then the 32x32
    GF(2) operators "advance a zero-init CRC state through L zero bytes"
    for the L of `advance_lengths(slice_bytes)` (column i = image of bit
    i). For a 16 KiB slice (4 KiB tiles, 128-byte lane pieces) that is
    L = 3968, then 128, 256, 512, 1024, 2048."""
    tab = hostsum._table(poly)
    lengths = advance_lengths(slice_bytes)
    ops = {}
    x = np.uint32(1) << np.arange(32, dtype=np.uint32)
    done = 0
    for n in sorted(set(lengths)):
        for _ in range(n - done):
            x = (x >> np.uint32(8)) ^ tab[x & np.uint32(0xFF)]
        done = n
        ops[n] = x.copy()
    return np.concatenate([tab.astype(np.uint32), *(ops[n] for n in lengths)])


@lru_cache(maxsize=64)
def _device_constants(poly: int, slice_bytes: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_constants(poly, slice_bytes).view(np.int32)).to(device)


def _check(data: torch.Tensor, matrix: torch.Tensor, slice_bytes: int) -> None:
    if not isinstance(data, torch.Tensor) or not isinstance(matrix, torch.Tensor):
        raise TypeError("data and matrix must be torch tensors")
    if data.dtype != torch.uint8 or matrix.dtype != torch.uint8:
        raise TypeError(f"want uint8 data and matrix, got {data.dtype}, "
                        f"{matrix.dtype}")
    if data.dim() != 3 or matrix.dim() != 2:
        raise ValueError(f"want data [B, k, C] and matrix [p, k], got "
                         f"{tuple(data.shape)}, {tuple(matrix.shape)}")
    b, k, c = data.shape
    if matrix.shape[1] != k or k < 1:
        raise ValueError(f"matrix {tuple(matrix.shape)} does not take {k} units")
    if matrix.shape[0] > MAX_P:
        raise ValueError(f"at most {MAX_P} output rows, got {matrix.shape[0]}")
    if slice_bytes < 1 or c % slice_bytes:
        raise ValueError(f"cell {c} does not divide into {slice_bytes}-byte slices")
    if matrix.device != data.device:
        raise ValueError(f"matrix on {matrix.device}, data on {data.device}")
    if not data.is_contiguous() or not matrix.is_contiguous():
        raise ValueError("data and matrix must be contiguous")


def kernel_occupancy(k: int, p: int, slice_bytes: int, rows: int) -> tuple[int, int]:
    """(shared memory bytes per block, blocks per SM on the current card)
    of the kernel for this shape; needs the CUDA build."""
    lib = _lib()
    return (lib.fused_encode_crc_smem_bytes(k, p, slice_bytes, rows),
            lib.fused_encode_crc_blocks_per_sm(k, p, slice_bytes, rows))


def fused_encode_crc(data: torch.Tensor, matrix: torch.Tensor,
                     poly: Optional[int], slice_bytes: int,
                     crc_in: bool = True, crc_out: bool = True):
    """(out uint8 [B, p, C], crcs int32 [B, R, C // slice_bytes]); see the
    module docstring. Launches the CUDA kernel for a CUDA tensor, runs the
    plain version for a CPU tensor, and raises for anything else."""
    _check(data, matrix, slice_bytes)
    if data.device.type == "cpu":
        return fused_encode_crc_plain(data, matrix, poly, slice_bytes,
                                      crc_in, crc_out)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    b, k, c = data.shape
    p = matrix.shape[0]
    crc_in, crc_out = poly is not None and crc_in, poly is not None and crc_out
    rows = k * crc_in + p * crc_out
    lib = _lib()
    smem = lib.fused_encode_crc_smem_bytes(k, p, slice_bytes, rows)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"k={k}, p={p}, slice={slice_bytes} needs {smem} B "
                         f"of shared memory; a block has {MAX_SMEM_BYTES}")
    if b * (c // slice_bytes) >= 2**31:
        raise ValueError("batch too large for one launch")
    out = torch.empty((b, p, c), dtype=torch.uint8, device=data.device)
    crcs = torch.empty((b, rows, c // slice_bytes), dtype=torch.int32,
                       device=data.device)
    if b == 0:
        return out, crcs
    zeros_crc = 0
    if rows:
        zeros_crc = hostsum._linear_parts(slice_bytes, poly)[1]
    consts = _device_constants(poly or hostsum.CRC32C_POLY, slice_bytes, data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.fused_encode_crc(
            data.data_ptr(), matrix.data_ptr(), out.data_ptr(),
            crcs.data_ptr(), consts.data_ptr(), b, k, p, c, slice_bytes,
            int(crc_in), int(crc_out), zeros_crc, stream)
    if err:
        raise RuntimeError("fused_encode_crc launch failed: "
                           + lib.fused_encode_crc_error(err).decode())
    launches.add()
    return out, crcs
