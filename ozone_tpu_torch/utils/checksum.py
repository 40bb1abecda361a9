"""Host-side checksums: CRC32 / CRC32C / SHA256 / MD5 over chunk slices.

Port of `ozone_tpu/utils/checksum.py`. CRC32C runs on the SSE4.2 crc32
instruction through the port's own host library (`csrc/host_crc32c.cpp`,
built by `cuda_build` with g++ at first use and loaded with ctypes, which
releases the interpreter lock for the call); on a host with no compiler
it runs the numpy linear decomposition (crc = L(M) xor crc(0^N)), by
bytes through a position table for the whole slices of a chunk and by
bits for other large inputs, and the table-driven loop for small ones.
CRC32 is zlib. The same `_table` backs the CUDA kernel's byte table and
its zero-advance operators (codec/fused_kernel.py), so device and host
CRCs share one definition.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import threading
import zlib
from dataclasses import dataclass
from enum import Enum
from functools import lru_cache

import numpy as np

log = logging.getLogger(__name__)

#: Reflected polynomials.
CRC32_POLY = 0xEDB88320  # IEEE, matches zlib.crc32
CRC32C_POLY = 0x82F63B78  # Castagnoli, matches java.util.zip.CRC32C


@lru_cache(maxsize=None)
def _table(poly: int) -> np.ndarray:
    """256-entry byte-step table for a reflected CRC."""
    t = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        t[i] = c
    return t.astype(np.uint32)


def crc_table_driven(data, poly: int, crc: int = 0) -> int:
    """Classic table-driven reflected CRC with init/xorout 0xFFFFFFFF.

    `crc` is the running *finalized* value of previous data (0 for none),
    matching zlib.crc32's incremental contract.
    """
    tab = _table(poly)
    state = crc ^ 0xFFFFFFFF
    for b in np.asarray(data, dtype=np.uint8).reshape(-1).tolist():
        state = (state >> 8) ^ int(tab[(state ^ b) & 0xFF])
    return state ^ 0xFFFFFFFF


@lru_cache(maxsize=64)
def _linear_parts(n: int, poly: int) -> tuple[np.ndarray, int]:
    """(contribution vector K32 [n*8] uint32, crc_of_n_zero_bytes).

    K32[i] = linear-CRC contribution of message bit i (byte i//8, bit i%8
    LSB-first) for an n-byte message:  crc(M) = XOR_{set bits} K32[i] ^ Z_n.
    Built by iterating the one-zero-byte advance backwards from the last
    byte: contribution columns of byte j satisfy C[j-1] = step(C[j]).
    """
    tab = _table(poly).astype(np.uint32)
    k = np.zeros((n, 8), dtype=np.uint32)
    cur = tab[(1 << np.arange(8)).astype(np.uint8)]  # [8] uint32
    if n > 0:
        k[n - 1] = cur
        for j in range(n - 2, -1, -1):
            cur = (cur >> np.uint32(8)) ^ tab[cur & np.uint32(0xFF)]
            k[j] = cur
    s = 0xFFFFFFFF
    for _ in range(n):
        s = (s >> 8) ^ int(tab[s & 0xFF])
    zeros_crc = s ^ 0xFFFFFFFF
    return k.reshape(n * 8), zeros_crc


def crc_linear(data, poly: int) -> int:
    """Vectorized CRC via the linear decomposition (single shot, init/xorout
    0xFFFFFFFF). Bit-exact with crc_table_driven."""
    data = np.asarray(data, dtype=np.uint8).reshape(-1)
    k32, zeros_crc = _linear_parts(data.size, poly)
    sel = k32[np.unpackbits(data, bitorder="little").astype(bool)]
    if sel.size:
        return int(np.bitwise_xor.reduce(sel)) ^ zeros_crc
    return zeros_crc


#: longest slice `crc_slices` serves from a byte-position table (its table
#: takes 1 KiB per byte of slice: 16 MiB at 16 KiB)
POSITION_TABLE_MAX = 16 * 1024


_position_lock = threading.Lock()


def _position_table(n: int, poly: int) -> tuple[np.ndarray, np.ndarray, np.uint32]:
    # one thread builds a table while the others wait (reader threads all
    # verify at once, and a table takes ~0.1 s to build)
    with _position_lock:
        return _build_position_table(n, poly)


@lru_cache(maxsize=4)
def _build_position_table(n: int, poly: int) -> tuple[np.ndarray, np.ndarray, np.uint32]:
    """(T [n * 256] uint32, row offsets [n] int32, crc of n zero bytes):
    `_linear_parts` by bytes instead of bits. T[256 i + b] is the linear
    CRC contribution of byte value b at position i of an n-byte message,
    so crc(M) = XOR_i T[256 i + M[i]] ^ crc(0^n): one gather per byte."""
    tab = _table(poly)
    t = np.empty((n, 256), dtype=np.uint32)
    cur = tab.copy()
    t[n - 1] = cur
    for i in range(n - 2, -1, -1):
        cur = (cur >> np.uint32(8)) ^ tab[cur & np.uint32(0xFF)]
        t[i] = cur
    rows = np.arange(n, dtype=np.int32) * 256
    return t.reshape(-1), rows, np.uint32(_linear_parts(n, poly)[1])


def crc_slices(data, n: int, poly: int) -> np.ndarray:
    """uint32 CRC (init/xorout 0xFFFFFFFF) of every n-byte slice of
    `data`, whose size is a multiple of n, for n <= POSITION_TABLE_MAX.
    Bit-exact with crc_table_driven; numpy releases the interpreter lock
    in the gather and the reduce, so threads verifying chunks overlap."""
    table, rows, zeros_crc = _position_table(n, poly)
    slices = np.asarray(data, dtype=np.uint8).reshape(-1, n)
    return np.bitwise_xor.reduce(table[rows + slices], axis=1) ^ zeros_crc


_native = False  # tri-state: False = not loaded yet, None = unavailable
_native_lock = threading.Lock()
_numpy_forced = False


def _native_lib():
    """The host CRC32C library, built and loaded on first use; None on a
    host where it cannot be built (no compiler), which then keeps the
    numpy route, as the reference does without its native library."""
    global _native
    if _native is False:
        with _native_lock:
            if _native is False:
                try:
                    from ozone_tpu_torch import cuda_build

                    lib = cuda_build.load("host_crc32c")
                    p, i64 = ctypes.c_void_p, ctypes.c_int64
                    lib.crc32c_hw.argtypes = [p, i64, ctypes.c_uint32]
                    lib.crc32c_hw.restype = ctypes.c_uint32
                    lib.crc32c_slices.argtypes = [p, i64, i64, p]
                    lib.crc32c_slices.restype = None
                    lib.native_probe.argtypes = []
                    lib.native_probe.restype = ctypes.c_int
                    _native = lib
                except Exception as e:  # noqa: BLE001 - the numpy route
                    log.warning("host CRC32C library unavailable, using "
                                "numpy: %s", e)
                    _native = None
    return None if _numpy_forced else _native


def native_probe() -> int:
    """What the loaded host library computes CRC32C with: 2 (AVX2 host
    build) or 1 (SSE4.2 crc32 instruction), 0 for its bitwise loop, -1
    when no library is loaded (the numpy route)."""
    lib = _native_lib()
    return -1 if lib is None else int(lib.native_probe())


def route() -> str:
    """"native" when CRC32C runs in the host library, else "numpy"."""
    return "numpy" if _native_lib() is None else "native"


@contextlib.contextmanager
def numpy_route():
    """Run CRC32C on the numpy route inside the block, whether or not the
    host library is loaded (to hold the two routes against each other)."""
    global _numpy_forced
    prev, _numpy_forced = _numpy_forced, True
    try:
        yield
    finally:
        _numpy_forced = prev


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli): the host library's hardware CRC when it is
    loaded; else the numpy linear decomposition for a fresh CRC over more
    than 256 bytes and the table loop otherwise."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    lib = _native_lib()
    if lib is not None:
        return int(lib.crc32c_hw(data.ctypes.data, data.size, crc))
    if crc == 0 and data.size > 256:
        return crc_linear(data, CRC32C_POLY)
    return crc_table_driven(data, CRC32C_POLY, crc)


def crc32c_slices(data, bpc: int) -> np.ndarray:
    """uint32 CRC32C of every bpc-byte slice of `data`, the last one as
    short as `data` leaves it: one call into the host library, or the
    numpy route (whole slices by position table up to POSITION_TABLE_MAX
    bytes, the rest one by one)."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = -(-data.size // bpc)
    lib = _native_lib()
    if lib is not None:
        out = np.empty(n, dtype=np.uint32)
        if n:
            lib.crc32c_slices(data.ctypes.data, data.size, bpc,
                              out.ctypes.data)
        return out
    whole = data.size - data.size % bpc
    if 0 < whole and bpc <= POSITION_TABLE_MAX:
        head = crc_slices(data[:whole], bpc, CRC32C_POLY)
    else:
        whole = 0
        head = np.empty(0, dtype=np.uint32)
    tail = [crc32c(data[o:o + bpc]) for o in range(whole, data.size, bpc)]
    return np.concatenate([head, np.asarray(tail, dtype=np.uint32)])


def crc32(data, crc: int = 0) -> int:
    """CRC32 (IEEE), zlib-compatible and computed by zlib."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    return int(zlib.crc32(memoryview(data), crc))


class ChecksumType(Enum):
    NONE = "NONE"
    CRC32 = "CRC32"
    CRC32C = "CRC32C"
    SHA256 = "SHA256"
    MD5 = "MD5"


@dataclass(frozen=True)
class ChecksumData:
    """Per-chunk checksum list: one entry per bytesPerChecksum slice
    (reference ozone/common/ChecksumData.java)."""

    type: ChecksumType
    bytes_per_checksum: int
    checksums: tuple[bytes, ...] = ()

    def to_lists(self) -> dict:
        return {
            "type": self.type.value,
            "bytes_per_checksum": self.bytes_per_checksum,
            "checksums": [c.hex() for c in self.checksums],
        }

    @classmethod
    def from_lists(cls, d: dict) -> "ChecksumData":
        return cls(
            ChecksumType(d["type"]),
            int(d["bytes_per_checksum"]),
            tuple(bytes.fromhex(c) for c in d["checksums"]),
        )


class ChecksumError(Exception):
    pass


class Checksum:
    """Compute/verify slice-wise checksums over a chunk buffer
    (reference Checksum.computeChecksum / verifyChecksum:247-276)."""

    def __init__(self, type_: ChecksumType = ChecksumType.CRC32C,
                 bytes_per_checksum: int = 16 * 1024):
        self.type = type_
        self.bpc = bytes_per_checksum

    def _one(self, piece: np.ndarray) -> bytes:
        if self.type is ChecksumType.CRC32:
            return int(crc32(piece)).to_bytes(4, "big")
        if self.type is ChecksumType.CRC32C:
            return int(crc32c(piece)).to_bytes(4, "big")
        if self.type is ChecksumType.SHA256:
            return hashlib.sha256(piece.tobytes()).digest()
        if self.type is ChecksumType.MD5:
            return hashlib.md5(piece.tobytes()).digest()
        raise ValueError(self.type)

    def compute(self, data) -> ChecksumData:
        if self.type is ChecksumType.NONE:
            return ChecksumData(self.type, self.bpc)
        data = np.asarray(data, dtype=np.uint8).reshape(-1)
        if self.type is ChecksumType.CRC32C:
            # every slice in one call, the short tail included
            return ChecksumData(self.type, self.bpc, tuple(
                int(v).to_bytes(4, "big")
                for v in crc32c_slices(data, self.bpc).tolist()))
        return ChecksumData(self.type, self.bpc, tuple(
            self._one(data[o:o + self.bpc])
            for o in range(0, data.size, self.bpc)))

    def verify(self, data, expected: ChecksumData, offset_hint: str = "") -> None:
        if expected.type is ChecksumType.NONE:
            return
        actual = Checksum(expected.type, expected.bytes_per_checksum).compute(data)
        if actual.checksums != expected.checksums:
            bad = [
                i
                for i, (a, e) in enumerate(
                    zip(actual.checksums, expected.checksums)
                )
                if a != e
            ]
            raise ChecksumError(
                f"checksum mismatch {offset_hint} at slices {bad[:8]} "
                f"(type={expected.type.value})"
            )
