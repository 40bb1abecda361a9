"""Datanode client that carries the bulk verbs over the native datapath.

Port of `ozone_tpu/client/native_dn.py`. `NativeDatanodeClient` extends
`RpcDatanodeClient`: the control-plane verbs stay on the RPC, and the
bulk verbs (`write_chunks_commit`, `write_chunk`, `read_chunks`,
`read_chunk`) go to the datanode's C++ listener (`csrc/datapath.cpp`,
served by `storage/fast_datapath.py`) when the datanode advertises one
through `GetDatapathInfo`. A co-located client takes the sidecar's
abstract unix socket, others its TCP port.

A write leaves as one gathered `sendmsg` of every frame header and payload
view; a read lands whole in one pooled lease (`codec/hostmem.py`), and its
chunks are views into it. Errors in the middle of a stream surface as
StorageError like the RPC's, so the writers' exclude and retry logic does
not care which lane ran.

When the lane cannot be had (discovery fails, the datanode advertises no
port, the connect fails, or a read asks for a check the sidecar cannot
make), the verb runs over the RPC, as in the reference, but every such
call is counted in `datapath.native_fallbacks` and the first is logged.
A failed connect makes the next call discover again, so a restarted
datanode's new sidecar is found. `OZONE_TPU_NATIVE_DATAPATH=0`, or
`native=False`, keeps the client on the RPC (not counted). Each stream's
header carries the block token of its factory's `TokenStore`, which the
sidecar's auth callback verifies once per stream. With `tls` the lane
is off (the reference's rule: a mutual-TLS cluster keeps every verb on
the authenticated RPC). Before a datanode finalizes its layout
(RATIS_STREAMING_WRITE), its sidecar refuses write streams with
NOT_SUPPORTED_OPERATION_PRIOR_FINALIZATION: a single-chunk write then
runs as the RPC's WriteChunk (the verb predates the gate), a batched one
raises for the writer to downgrade, and each such refusal is counted per
client (`layout_downgrades`) and in `datapath.layout_downgrades`. Before
each native stream the client consults `net/partition.py` with the
datanode's RPC address and the verb, as `RpcChannel` does, so one block,
delay or verb rule covers both lanes.

Frames (must match `csrc/datapath.cpp`): u32 length | u8 tag | body,
little-endian; checksums travel as the u32 values of the stored
big-endian CRC words.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import sys
import threading
import time
from typing import Optional

import numpy as np

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.net.dn_service import RpcDatanodeClient
from ozone_tpu_torch.net.rpc import RpcChannel
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.checksum import ChecksumType

log = logging.getLogger(__name__)

_T_WHDR, _T_CHUNK, _T_END = 0x01, 0x02, 0x03
_T_RHDR, _T_RCHUNK = 0x05, 0x06
_T_STATUS, _T_DATA = 0x81, 0x82

_FRAME = struct.Struct("<IB")
_CHUNK_HDR = struct.Struct("<QI")
_RCHUNK_HDR = struct.Struct("<QIBII")

_MAX_FRAME = 256 * 1024 * 1024  # must match datapath.cpp
try:
    _IOV_MAX = os.sysconf("SC_IOV_MAX")
    if _IOV_MAX <= 0:
        _IOV_MAX = 1024
except (AttributeError, OSError, ValueError):
    _IOV_MAX = 1024

#: sockets kept per client; the EC fan-out drives one unit stream per
#: datanode, so per-datanode concurrency is low
_POOL_CAP = 4

#: bulk-verb calls that ran over the RPC although the native lane was on
_FALLBACKS = hostmem.METRICS.counter("native_fallbacks")
#: native write streams a datanode refused before finalizing its layout
_LAYOUT_DOWNGRADES = hostmem.METRICS.counter("layout_downgrades")


def enabled() -> bool:
    """The native lane is on unless OZONE_TPU_NATIVE_DATAPATH=0."""
    return os.environ.get("OZONE_TPU_NATIVE_DATAPATH", "1") != "0"


def _env_seconds(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _connect_timeout_s() -> float:
    """Connect budget; the operation's deadline caps it further."""
    return _env_seconds("OZONE_TPU_CONNECT_TIMEOUT_S", 20.0)


def _io_timeout_s() -> float:
    """Per-request socket budget when no operation deadline is set."""
    return _env_seconds("OZONE_TPU_IO_TIMEOUT_S", 120.0)


def _sendmsg_all(sock: socket.socket, parts: list) -> None:
    """One gathered `sendmsg` for a whole request, in batches of IOV_MAX:
    frame headers and payload views leave with no copy in a few syscalls
    instead of two writes per chunk."""
    mv = [p if isinstance(p, memoryview) else memoryview(p) for p in parts]
    i = 0
    while i < len(mv):
        batch = mv[i:i + _IOV_MAX]
        sent = sock.sendmsg(batch)
        j = 0
        while j < len(batch) and sent >= len(batch[j]):
            sent -= len(batch[j])
            j += 1
        i += j
        if j < len(batch) and sent:
            mv[i] = batch[j][sent:]


class _Conn:
    def __init__(self, host: str, port: int, uds: Optional[str] = None):
        # a spent operation budget raises DEADLINE_EXCEEDED here
        timeout = resilience.op_timeout(_connect_timeout_s(), "connect")
        self.sock = None
        if uds:
            # co-located lane: the sidecar's abstract unix socket skips
            # the loopback device; a name from another host fails to
            # connect and TCP is taken
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.settimeout(timeout)
                s.connect("\0" + uds[1:] if uds.startswith("@") else uds)
                self.sock = s
            except OSError:
                s.close()
        if self.sock is None:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # deep buffers: each full buffer is a client/server switch
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, opt, 8 * 1024 * 1024)
            except OSError:  # ozlint: allow[error-swallowing] -- the kernel may cap or refuse; either is fine
                pass
        self._scratch = bytearray(4096)

    def arm(self, verb: str) -> None:
        """Per-request IO timeout, from what is left of the operation's
        deadline when one is set."""
        self.sock.settimeout(resilience.op_timeout(_io_timeout_s(), verb))

    def recv_exact_into(self, view: memoryview) -> None:
        got, n = 0, len(view)
        while got < n:
            r = self.sock.recv_into(view[got:], n - got)
            if r == 0:
                raise ConnectionError("native datapath peer closed")
            got += r

    def recv_exact(self, n: int) -> memoryview:
        """Control-frame receive into the connection's scratch; the view is
        valid until the next receive."""
        if n > len(self._scratch):
            self._scratch = bytearray(max(n, 4096))
        view = memoryview(self._scratch)[:n]
        self.recv_exact_into(view)
        return view

    def recv_frame(self) -> tuple[int, memoryview]:
        n, tag = _FRAME.unpack(self.recv_exact(5))
        if n > _MAX_FRAME:
            raise ConnectionError(f"oversized frame {n}")
        return tag, (self.recv_exact(n) if n else memoryview(b""))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:  # ozlint: allow[error-swallowing] -- best-effort teardown
            pass


class NativeDatanodeClient(RpcDatanodeClient):
    def __init__(self, dn_id: str, address: str,
                 native: Optional[bool] = None, tokens=None, tls=None):
        super().__init__(dn_id, address, tokens=tokens, tls=tls)
        #: the native lane is asked for: `native`, or the environment's;
        #: never under TLS (the sidecar is a plaintext side channel, so a
        #: mutual-TLS cluster keeps every verb on the authenticated RPC,
        #: as the reference does)
        self._np_enabled = (enabled() if native is None else native) \
            and tls is None
        self._np_port: Optional[int] = None
        self._np_uds: Optional[str] = None
        self._np_probed = False
        self._np_why = ""
        self._np_lock = threading.Lock()
        self._pool: list[_Conn] = []
        self._host = address.rsplit(":", 1)[0]
        self._fallback_logged = False
        #: native write streams this datanode refused pre-finalize
        self.layout_downgrades = 0

    # ------------------------------------------------------------ discovery
    def _lane(self, verb: str) -> Optional[int]:
        """The native port for this call, or None (counted as a fallback
        when the lane is on) to run it over the RPC."""
        if not self._np_enabled:
            return None
        with self._np_lock:
            if not self._np_probed:
                try:
                    m, _ = self._call("GetDatapathInfo", {})
                except (StorageError, OSError) as e:
                    # unreachable: discover again on the next call
                    self._np_why = f"discovery failed: {e}"
                else:
                    self._np_probed = True
                    self._np_port = m.get("port")
                    self._np_uds = m.get("uds")
                    self._np_why = "the datanode advertises no native port"
            port = self._np_port if self._np_probed else None
            why = self._np_why
        if port is None:
            self._fallback(verb, why)
        return port

    def _check_partition(self, verb: str) -> None:
        """Injected faults for one native stream, keyed by the datanode's
        RPC address as the RPC lane's are: a drop raises UNAVAILABLE, a
        delay blocks like a slow link."""
        from ozone_tpu_torch.net import partition

        drop, d = partition.consult(self.address, verb, None)
        if drop:
            raise StorageError(
                "UNAVAILABLE",
                f"native datapath to {self.address}: injected partition")
        if d > 0:
            time.sleep(d)  # ozlint: allow[deadline-propagation] -- injected chaos latency must block like a real slow link (net/partition.py delay rule)

    def _fallback(self, verb: str, why: str) -> None:
        _FALLBACKS.inc()
        if not self._fallback_logged:
            self._fallback_logged = True
            log.warning("native datapath to %s (%s) not taken for %s: %s; "
                        "the bulk verbs run over the RPC (counted in "
                        "datapath.native_fallbacks)", self.dn_id,
                        self.address, verb, why)

    def _forget_native(self, why: str) -> None:
        """The listener went away: drop pooled sockets and discover again
        on the next call."""
        with self._np_lock:
            self._np_probed = False
            self._np_port = None
            self._np_why = why
            pool, self._pool = self._pool, []
        for c in pool:
            c.close()

    # ------------------------------------------------------------ transport
    def _checkout(self, port: int) -> _Conn:
        while True:
            with self._np_lock:
                conn = self._pool.pop() if self._pool else None
                uds = self._np_uds
            if conn is None:
                return _Conn(self._host, port, uds=uds)
            if RpcChannel._alive(conn.sock):
                return conn
            conn.close()  # the sidecar closed it, or it is out of step

    def _checkin(self, conn: _Conn) -> None:
        with self._np_lock:
            if len(self._pool) < _POOL_CAP and self._np_port is not None:
                self._pool.append(conn)
                return
        conn.close()

    def _connect(self, port: int, verb: str) -> Optional[_Conn]:
        try:
            return self._checkout(port)
        except OSError as e:
            why = f"connect failed: {e}"
            self._forget_native(why)
            self._fallback(verb, why)
            return None

    @staticmethod
    def _status(body) -> None:
        m = json.loads(bytes(body)) if len(body) else {}  # ozlint: allow[datapath-no-copy] -- control-plane STATUS JSON, not payload
        err = m.get("error")
        if err:
            raise StorageError(err.get("code", "IO_EXCEPTION"),
                               err.get("message", ""))

    def _unavailable(self, e: Exception) -> StorageError:
        return StorageError("UNAVAILABLE",
                            f"native datapath to {self.address}: {e}")

    # ------------------------------------------------------------ write path
    def _count_downgrade(self, e: StorageError) -> None:
        """Count a pre-finalize refusal of a native write (raises
        anything else)."""
        from ozone_tpu_torch.utils.upgrade import PRE_FINALIZE_ERROR

        if e.code != PRE_FINALIZE_ERROR:
            raise e
        self.layout_downgrades += 1
        _LAYOUT_DOWNGRADES.inc()

    def write_chunks_commit(self, block_id, chunks, commit=None,
                            sync=False, writer=None):
        port = self._lane("WriteChunksCommit")
        try:
            native = port is not None and self._native_write(
                port, "WriteChunksCommit", block_id, chunks, commit, sync,
                writer)
        except StorageError as e:
            # the batched verb is layout-gated on both lanes: the writer
            # downgrades to per-chunk verbs
            self._count_downgrade(e)
            raise
        if not native:
            super().write_chunks_commit(block_id, chunks, commit=commit,
                                        sync=sync, writer=writer)

    def write_chunk(self, block_id, info, data, sync=False, writer=None):
        port = self._lane("WriteChunk")
        try:
            native = port is not None and self._native_write(
                port, "WriteChunk", block_id, [(info, data)], None, sync,
                writer)
        except StorageError as e:
            # the RPC's WriteChunk predates the layout gate
            self._count_downgrade(e)
            native = False
        if not native:
            super().write_chunk(block_id, info, data, sync=sync,
                                writer=writer)

    def _native_write(self, port: int, verb: str, block_id, chunks, commit,
                      sync: bool, writer) -> bool:
        """One write stream over the native lane; False (counted) when the
        listener cannot be reached, for the caller to take the RPC."""
        meta = {"op": "write", "block_id": block_id.to_json(),
                "sync": bool(sync), **self._btok(block_id)}
        if writer is not None:
            meta["writer"] = writer
        if commit is not None:
            meta["commit"] = commit.to_json()
        hdr = json.dumps(meta, separators=(",", ":")).encode()
        # every length is checked before the first frame leaves: a raise
        # in the middle of a stream would leave the server in its chunk
        # loop and the connection out of step
        views = []
        for info, data in chunks:
            view = _payload_view(data)
            if len(view) != info.length:
                raise StorageError(
                    "INVALID_WRITE_SIZE",
                    f"chunk {info.name}: data {len(view)} != declared "
                    f"{info.length}")
            views.append(view)
        self._check_partition(verb)
        conn = self._connect(port, verb)
        if conn is None:
            return False
        completed = False  # STATUS received: the framing is in step
        try:
            conn.arm(verb)
            # the whole request leaves in one gathered sendmsg
            parts: list = [_FRAME.pack(len(hdr), _T_WHDR), hdr]
            payload_bytes = 0
            for (info, _), view in zip(chunks, views):
                parts.append(_FRAME.pack(12 + info.length, _T_CHUNK)
                             + _CHUNK_HDR.pack(info.offset, info.length))
                if info.length:
                    parts.append(view)
                payload_bytes += info.length
            parts.append(_FRAME.pack(1, _T_END) + (b"\x01" if sync
                                                   else b"\x00"))
            _sendmsg_all(conn.sock, parts)
            hostmem.count_move(payload_bytes)
            tag, body = conn.recv_frame()
            if tag != _T_STATUS:
                raise ConnectionError(f"unexpected frame tag {tag:#x}")
            completed = True
            self._status(body)
        except (OSError, ConnectionError) as e:
            conn.close()
            raise self._unavailable(e) from e
        except StorageError:
            # a server error after a whole exchange leaves the connection
            # in step; a local one in the middle of a stream does not
            if completed:
                self._checkin(conn)
            else:
                conn.close()
            raise
        self._checkin(conn)
        return True

    # ------------------------------------------------------------- read path
    def read_chunks(self, block_id, infos, verify=False):
        out = self._native_read("ReadChunks", block_id, infos, verify)
        if out is None:
            return super().read_chunks(block_id, infos, verify=verify)
        return out

    def read_chunk(self, block_id, info, verify=False):
        out = self._native_read("ReadChunk", block_id, [info], verify)
        if out is None:
            return super().read_chunk(block_id, info, verify=verify)
        return out[0]

    def _native_read(self, verb: str, block_id, infos, verify: bool):
        """One read stream over the native lane: the chunks, or None
        (counted) when the lane cannot serve it, for the caller to take
        the RPC."""
        port = self._lane(verb)
        if port is not None and verify and not _natively_verifiable(infos):
            self._fallback(verb, "the sidecar verifies CRC32C checksums only")
            return None
        if port is None:
            return None
        self._check_partition(verb)
        conn = self._connect(port, verb)
        if conn is None:
            return None
        hdr = json.dumps({"op": "read", "block_id": block_id.to_json(),
                          **self._btok(block_id)},
                         separators=(",", ":")).encode()
        # the whole answer (DATA frames and the closing STATUS) lands in
        # one pooled lease; the chunks are views at their frame offsets,
        # and the lease goes back to the pool when the last one dies
        payload_total = sum(int(i.length) for i in infos)
        lease = hostmem.pool().lease(payload_total + 5 * (len(infos) + 1)
                                     + 256)
        slab = lease.view
        filled = 0

        def fill(upto: int) -> None:
            nonlocal filled
            while filled < upto:
                r = conn.sock.recv_into(slab[filled:])
                if r == 0:
                    raise ConnectionError("native datapath peer closed")
                filled += r

        def status_body(pos: int, n: int):
            # a STATUS fits the slab's margin; a long error message spills
            # into a buffer of its own
            if pos + n <= len(slab):
                fill(pos + n)
                return slab[pos:pos + n]
            body = bytearray(n)
            have = filled - pos
            body[:have] = slab[pos:filled]
            conn.recv_exact_into(memoryview(body)[have:])
            return body

        out = []
        try:
            conn.arm(verb)
            parts: list = [_FRAME.pack(len(hdr), _T_RHDR), hdr]
            for info in infos:
                body = _rchunk_body(info, verify)
                parts += [_FRAME.pack(len(body), _T_RCHUNK), body]
            parts.append(_FRAME.pack(0, _T_END))
            _sendmsg_all(conn.sock, parts)
            pos = 0
            for idx in range(len(infos) + 1):
                fill(pos + 5)
                n, tag = _FRAME.unpack(slab[pos:pos + 5])
                pos += 5
                if n > _MAX_FRAME:
                    raise ConnectionError(f"oversized frame {n}")
                if tag == _T_STATUS:
                    self._status(status_body(pos, n))  # raises on an error
                    if idx != len(infos):
                        raise ConnectionError("short native read stream")
                    break
                if idx == len(infos) or tag != _T_DATA:
                    raise ConnectionError(f"unexpected frame tag {tag:#x}")
                if n != infos[idx].length:
                    raise ConnectionError(
                        f"DATA frame {n} B != requested {infos[idx].length} B")
                fill(pos + n)
                out.append(lease.array(length=n, offset=pos) if n
                           else np.empty(0, dtype=np.uint8))
                pos += n
            hostmem.count_move(payload_total)
        except (OSError, ConnectionError) as e:
            conn.close()
            out.clear()  # the traceback pins this frame: drop the views
            raise self._unavailable(e) from e
        except StorageError:
            # a server error in the middle of a stream: framing unknown
            conn.close()
            out.clear()
            raise
        else:
            self._checkin(conn)
        finally:
            # the views keep the buffer alive; on an error it goes back now
            lease.release()
        return out

    def close(self):
        with self._np_lock:
            pool, self._pool = self._pool, []
        for c in pool:
            c.close()
        super().close()


def _payload_view(data) -> memoryview:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return memoryview(data).cast("B")
    arr = np.asarray(data)
    if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
        # a hidden full copy: counted, and warned once per call site
        caller = sys._getframe(1)
        hostmem.count_copy(
            int(arr.nbytes),
            site=(f"{os.path.basename(caller.f_code.co_filename)}:"
                  f"{caller.f_lineno}"))
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
    return memoryview(arr.reshape(-1))


def _natively_verifiable(infos) -> bool:
    """The sidecar verifies CRC32C only."""
    return all(i.checksum.type in (ChecksumType.CRC32C, ChecksumType.NONE)
               or not i.checksum.checksums for i in infos)


def _rchunk_body(info, verify: bool) -> bytes:
    cks = info.checksum
    crcs: list[int] = []
    vtype = 0
    if verify and cks.checksums and cks.type is ChecksumType.CRC32C:
        vtype = 1
        crcs = [int.from_bytes(c, "big") for c in cks.checksums]
    return _RCHUNK_HDR.pack(info.offset, info.length, vtype,
                            cks.bytes_per_checksum if vtype else 0,
                            len(crcs)) + struct.pack(f"<{len(crcs)}I", *crcs)
