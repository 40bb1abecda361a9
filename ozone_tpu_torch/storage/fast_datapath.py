"""The datanode's native chunk datapath: the C++ sidecar wired into a Datanode.

Port of `ozone_tpu/storage/fast_datapath.py`. The native listener
(`csrc/datapath.cpp`, built by `cuda_build.load("datapath")`) owns the
per-chunk work (frame parse, pwrite, pread, CRC32C verify, fsync) of the
bulk verbs, and this module keeps the control plane in Python through
three callbacks, each run once per stream:

- auth: the block token (with a verifier on: the stream's header must
  carry a token for its block and mode, or the stream is refused with
  BLOCK_TOKEN_VERIFICATION_FAILED before a byte lands), container
  resolution, writability and the single-writer fence, and the block
  file's path;
- done: the piggybacked block commit (`Datanode.put_block`), the
  stream, chunk and byte counters the RPC verbs keep, and the native
  lane's own stream counters (`native_write_streams`,
  `native_read_streams`);
- fail: a read-side checksum failure marks the container unhealthy
  (`Datanode.on_read_error`).

The chunk bytes land exactly where the RPC verbs put them (one file per
block, chunks at their offsets, zero-filled short reads), and a sync
stream is fsynced by the native side before the commit callback runs.
The token check runs in Python, once per stream. Left out: the
reference's layout gate; the lane is plaintext (TLS is the next slice).
A sidecar whose library cannot be built, or whose listener cannot bind,
raises: a datanode asked for the native datapath never serves the RPC
verbs alone in its place.
"""

from __future__ import annotations

import ctypes
import json
import logging
import threading
from typing import Optional

from ozone_tpu_torch import cuda_build
from ozone_tpu_torch.storage.ids import (
    IO_EXCEPTION,
    BlockData,
    BlockID,
    StorageError,
)
from ozone_tpu_torch.utils import security

log = logging.getLogger(__name__)

#: the error code of a sidecar that cannot be built, loaded or bound
NATIVE_DATAPATH_UNAVAILABLE = "NATIVE_DATAPATH_UNAVAILABLE"

_AUTH_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32)
_DONE_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ctypes.c_int32, ctypes.c_uint64, ctypes.c_uint32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32)
_FAIL_CB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32)

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: callbacks of stopped sidecars: dp_stop leaves a handler that is still
#: running after its bounded wait behind, and that handler may call them
_retired_cbs: list = []


def load_lib() -> ctypes.CDLL:
    """The sidecar's library, built from `csrc/datapath.cpp` on first use,
    with its C interface typed. Raises when it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load("datapath")
        lib.dp_start.restype = ctypes.c_void_p
        lib.dp_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 _AUTH_CB, _DONE_CB, _FAIL_CB]
        lib.dp_port.restype = ctypes.c_int
        lib.dp_port.argtypes = [ctypes.c_void_p]
        lib.dp_uds.restype = ctypes.c_int
        lib.dp_uds.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.dp_stop.argtypes = [ctypes.c_void_p]
        # the native arena's capsule API
        lib.dp_buf_lease.restype = ctypes.c_void_p
        lib.dp_buf_lease.argtypes = [ctypes.c_uint64]
        lib.dp_buf_data.restype = ctypes.c_void_p
        lib.dp_buf_data.argtypes = [ctypes.c_void_p]
        lib.dp_buf_cap.restype = ctypes.c_uint64
        lib.dp_buf_cap.argtypes = [ctypes.c_void_p]
        lib.dp_buf_retain.argtypes = [ctypes.c_void_p]
        lib.dp_buf_release.argtypes = [ctypes.c_void_p]
        lib.dp_pool_stat.restype = ctypes.c_uint64
        lib.dp_pool_stat.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def native_pool_stats() -> dict:
    """The C++ arena's counters (the Python half is `codec/hostmem.py`)."""
    lib = load_lib()
    return {"leased_bytes": int(lib.dp_pool_stat(0)),
            "free_bytes": int(lib.dp_pool_stat(1)),
            "high_water_bytes": int(lib.dp_pool_stat(2))}


def _pack_out(out, cap: int, ok: bool, body: bytes) -> int:
    n = 1 + len(body)
    if n > cap:
        return -1
    out[0] = 1 if ok else 0
    if body:
        ctypes.memmove(ctypes.addressof(out.contents) + 1, body, len(body))
    return n


def _error_body(code: str, message: str) -> bytes:
    return json.dumps({"error": {"code": code, "message": message}}).encode()


class DatapathSidecar:
    """One native listener per datanode process."""

    def __init__(self, dn, host: str = "127.0.0.1", port: int = 0,
                 verifier=None):
        self.dn = dn
        #: the datanode's BlockTokenVerifier (shared with its RPC lanes)
        self.verifier = verifier
        self.host = host
        self._want_port = port
        self.port: Optional[int] = None
        #: abstract unix socket name ("@...") of the co-located lane, or
        #: None when the native side could not set one up
        self.uds: Optional[str] = None
        self._handle = None
        # the ctypes wrappers must outlive the listener: a collected
        # callback called from a C++ thread is a crash
        self._cbs = (_AUTH_CB(self._auth), _DONE_CB(self._done),
                     _FAIL_CB(self._fail))

    # ------------------------------------------------------------ callbacks
    @staticmethod
    def _hdr(hdr, hdr_len: int) -> dict:
        return json.loads(ctypes.string_at(hdr, hdr_len))

    def _auth(self, hdr, hdr_len, is_write, out, out_cap) -> int:
        try:
            m = self._hdr(hdr, hdr_len)
            block_id = BlockID.from_json(m["block_id"])
            security.gate(self.verifier, "native", m.get("token"),
                          block_id=block_id,
                          mode=security.AccessMode.WRITE if is_write
                          else security.AccessMode.READ)
            c = self.dn.containers.get(block_id.container_id)
            if is_write:
                c.require_writable()
                self.dn._fence(c, block_id, m.get("writer"))
            return _pack_out(out, out_cap, True,
                             str(c.chunks.block_path(block_id)).encode())
        except StorageError as e:
            return _pack_out(out, out_cap, False, _error_body(e.code, e.msg))
        except Exception as e:  # noqa: BLE001 - must never unwind into C++
            log.exception("datapath auth failed")
            return _pack_out(out, out_cap, False,
                             _error_body(IO_EXCEPTION, str(e)))

    def _done(self, hdr, hdr_len, is_write, nbytes, nchunks, out,
              out_cap) -> int:
        try:
            m = self._hdr(hdr, hdr_len)
            block_id = BlockID.from_json(m["block_id"])
            mx = self.dn.metrics
            if is_write:
                mx.counter("native_write_streams").inc()
                mx.counter("batched_write_streams").inc()
                mx.counter("batched_write_chunks").inc(int(nchunks))
                mx.counter("bytes_written").inc(int(nbytes))
                self.dn.mutation_count += 1
                commit = m.get("commit")
                if commit is not None:
                    bd = BlockData.from_json(commit)
                    if bd.block_id != block_id:
                        raise StorageError(
                            "INVALID_ARGUMENT",
                            f"commit names {bd.block_id}, stream wrote "
                            f"{block_id}")
                    # a sync stream was fsynced before this callback
                    self.dn.put_block(bd, sync=False, writer=m.get("writer"))
            else:
                mx.counter("native_read_streams").inc()
                mx.counter("batched_read_streams").inc()
                mx.counter("batched_read_chunks").inc(int(nchunks))
                mx.counter("bytes_read").inc(int(nbytes))
            return _pack_out(out, out_cap, True, b"")
        except StorageError as e:
            return _pack_out(out, out_cap, False, _error_body(e.code, e.msg))
        except Exception as e:  # noqa: BLE001 - must never unwind into C++
            log.exception("datapath commit failed")
            return _pack_out(out, out_cap, False,
                             _error_body(IO_EXCEPTION, str(e)))

    def _fail(self, hdr, hdr_len) -> None:
        try:
            m = self._hdr(hdr, hdr_len)
            block_id = BlockID.from_json(m["block_id"])
            c = self.dn.containers.get(block_id.container_id)
            self.dn.metrics.counter("checksum_failures").inc()
            self.dn.on_read_error(c)
        except Exception:  # noqa: BLE001 - must never unwind into C++
            log.exception("datapath fail-report failed")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        """Build or load the library and listen; the TCP port. Raises
        NATIVE_DATAPATH_UNAVAILABLE when either fails."""
        try:
            lib = load_lib()
        except (RuntimeError, OSError) as e:
            raise StorageError(NATIVE_DATAPATH_UNAVAILABLE,
                               f"native datapath library: {e}") from e
        self._handle = lib.dp_start(self.host.encode(), self._want_port,
                                    *self._cbs)
        if not self._handle:
            raise StorageError(
                NATIVE_DATAPATH_UNAVAILABLE,
                f"native datapath failed to bind {self.host}:"
                f"{self._want_port}")
        self.port = lib.dp_port(self._handle)
        buf = ctypes.create_string_buffer(128)
        n = lib.dp_uds(self._handle, buf, len(buf))
        self.uds = buf.raw[:n].decode() if n > 0 else None
        log.info("native datapath listening on %s:%d uds=%s (dn=%s)",
                 self.host, self.port, self.uds, self.dn.id)
        return self.port

    def advertise(self) -> dict:
        """GetDatapathInfo's answer: the TCP port, and the abstract unix
        socket a co-located client prefers."""
        return {"port": self.port, "uds": self.uds}

    def stop(self) -> None:
        if self._handle is not None:
            load_lib().dp_stop(self._handle)
            _retired_cbs.append(self._cbs)
            self._handle = None
            self.port = None
            self.uds = None
