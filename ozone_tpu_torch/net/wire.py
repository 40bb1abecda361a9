"""Wire format of the RPC datapath: JSON header + raw payload bytes.

Port of `ozone_tpu/net/wire.py`, byte for byte the same frames: a 4-byte
big-endian header length, the compact JSON header, then the raw payload,
so bulk data is never re-encoded. `pack_parts` hands the same frame over
as (prefix, payload view) so the transport can send the payload without
joining it into one buffer; `pack` joins them (one copy of the payload).
"""

from __future__ import annotations

import json
import struct
from typing import Any, Optional

import numpy as np

_LEN = struct.Struct("!I")


def _body(payload) -> memoryview | bytes:
    if isinstance(payload, np.ndarray):
        # zero-copy for the hot shape (contiguous uint8)
        return (memoryview(payload) if payload.dtype == np.uint8
                and payload.flags.c_contiguous else payload.tobytes())
    return payload  # bytes / bytearray / memoryview


def pack_parts(meta: dict[str, Any], payload=None) -> tuple:
    """The frame as a tuple of buffers: (length + header,) or
    (length + header, payload view). b"".join of it equals `pack`."""
    h = json.dumps(meta, separators=(",", ":")).encode()
    prefix = _LEN.pack(len(h)) + h
    if payload is None:
        return (prefix,)
    return (prefix, _body(payload))


def pack(meta: dict[str, Any], payload: Optional[bytes | np.ndarray] = None) -> bytes:
    return b"".join(pack_parts(meta, payload))


def unpack(buf) -> tuple[dict[str, Any], memoryview]:
    (hlen,) = _LEN.unpack_from(buf, 0)
    meta = json.loads(bytes(buf[4 : 4 + hlen]).decode())
    return meta, memoryview(buf)[4 + hlen :]


def payload_array(view: memoryview) -> np.ndarray:
    return np.frombuffer(view, dtype=np.uint8)
