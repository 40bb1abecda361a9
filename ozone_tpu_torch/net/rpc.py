"""RPC plumbing on the standard library: byte-level services over TCP.

Port of `ozone_tpu/net/rpc.py` (the reference's XceiverServerGrpc /
XceiverClientGrpc role). The reference rides gRPC; this module uses only
`socket`, `selectors`, `threading` and `struct`, and keeps its surface:
services register python callables per method name, requests and
responses are raw bytes in the `net/wire.py` format, and an error the
server raised comes back to the client as a `StorageError` with its own
code. A refused connection, a reset, a peer that dies mid-frame or a
timeout becomes UNAVAILABLE.

On the socket every message is one frame: a 1-byte tag and a 4-byte
big-endian length, then the body. A call opens with a CALL frame (a JSON
header naming the method, its kind and the trace context); a unary or
server-streaming call sends its request as one DATA frame, a
client-streaming call any number of DATA frames closed by END. The
server answers a unary or client-streaming call with one DATA or ERROR
frame, and a server-streaming call with DATA frames closed by END (or an
ERROR in their place). A client stream is always read to its END, even
when the handler fails early, so a connection never falls out of step;
a connection on which an exchange did not end cleanly is closed, never
pooled. Clients keep idle connections per channel; the server hands one
call at a time from a connection to a worker pool of the reference's
size (16) and watches idle connections with a selector.

TLS (the reference's grpc.tls.enabled mode): `RpcServer(tls=...,
mutual=True)` wraps each accepted connection in the material's server
context (a `utils/ca.py` TlsMaterial or RotatingTls, whose context is
read at every accept, so a renewed certificate serves the next
handshake); the handshake runs on a worker under its own deadline, never
on the selector thread, so a silent or slow peer holds no other
connection up. `mutual` requires a client certificate that chains to the
CA bundle. After each call a TLS connection whose next frame already
sits decrypted in the SSL buffer (`pending()`) is served at once, since
its socket would never turn readable for the selector. With a
`crl_provider` the server checks the peer certificate's serial on every
call and answers CERTIFICATE_REVOKED (the reference's code) for a
revoked one. `RpcChannel(address, tls=..., server_name=...)` dials TLS
with its role's chain and checks the server's name (`server_name`, or
"localhost", the SAN every certificate carries). A handshake the peer
refuses, or a TLS 1.3 client certificate it turns away at the first
read, is UNAVAILABLE, as the reference's gRPC status; nothing retries in
plaintext. `FailoverChannels` drops its channels when the material's
`version` changes. The `rpc` registry's `tls_handshake` histogram times
each client handshake.

Left out: admission control and partition injection.
"""

from __future__ import annotations

import contextlib
import json
import logging
import selectors
import socket
import ssl
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.metrics import registry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)

#: client TLS handshakes (`tls_handshake` seconds)
METRICS = registry("rpc")

#: the reference's grpc.max_send/receive_message_length
MAX_MESSAGE = 128 * 1024 * 1024

_HDR = struct.Struct("!BI")
CALL, DATA, END, ERROR = 1, 2, 3, 4
UNARY, CLIENT_STREAM, SERVER_STREAM = "unary", "client_stream", "server_stream"
#: socket send and receive buffers: a 1 MiB chunk crosses in a few
#: system calls
_SOCK_BUF = 4 * 1024 * 1024
#: pieces below this size are joined into one send; larger ones go out as
#: views of their own
_COALESCE = 256 * 1024

Method = Callable[[bytes], bytes]


class _Transport(Exception):
    """The connection failed (refused, reset, closed mid-frame, timed out)."""


class _Closed(_Transport):
    """The peer closed the connection between frames."""


def _parts(msg) -> list:
    """The buffers of a message: bytes stay bytes (headers, small replies),
    anything else becomes a flat byte view."""
    out = []
    for p in (msg if isinstance(msg, (tuple, list)) else (msg,)):
        out.append(p if isinstance(p, bytes) else memoryview(p).cast("B"))
    return out


def _tune(sock: socket.socket) -> None:
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF)


def _settimeout(sock: socket.socket, t_end: Optional[float]) -> None:
    if t_end is None:
        sock.settimeout(None)
        return
    left = t_end - time.monotonic()
    if left <= 0:
        raise _Transport("deadline exceeded")
    sock.settimeout(left)


def _send(sock: socket.socket, frames: list[tuple[int, list]],
          t_end: Optional[float]) -> None:
    """Send frames [(tag, parts)]: small pieces joined, large ones sent as
    they are (sendall of a memoryview copies nothing in user space). A
    payload view small enough to be joined is one counted host copy."""
    pending: list = []

    def flush():
        if pending:
            sock.sendall(b"".join(pending))
            pending.clear()

    try:
        _settimeout(sock, t_end)
        for tag, parts in frames:
            n = sum(len(p) for p in parts)
            if n > MAX_MESSAGE:
                raise StorageError(
                    "IO_EXCEPTION",
                    f"RESOURCE_EXHAUSTED: message of {n} B exceeds the "
                    f"{MAX_MESSAGE} B limit")
            pending.append(_HDR.pack(tag, n))
            for p in parts:
                if len(p) < _COALESCE:
                    if not isinstance(p, bytes):
                        hostmem.count_copy(len(p), site="rpc._send",
                                           warn=False)
                    pending.append(p)
                else:
                    flush()
                    sock.sendall(p)
        flush()
    except OSError as e:
        raise _Transport(f"send failed: {e!r}") from e


def _recv_into(sock: socket.socket, view: memoryview, t_end) -> int:
    got = 0
    while got < len(view):
        _settimeout(sock, t_end)
        try:
            k = sock.recv_into(view[got:])
        except OSError as e:
            raise _Transport(f"receive failed: {e!r}") from e
        if k == 0:
            return got
        got += k
    return got


def _recv_frame(sock: socket.socket, t_end: Optional[float]) -> tuple[int, bytearray]:
    """One frame, its body received into one preallocated bytearray."""
    hdr = bytearray(_HDR.size)
    got = _recv_into(sock, memoryview(hdr), t_end)
    if got == 0:
        raise _Closed("connection closed by peer")
    if got < _HDR.size:
        raise _Transport("connection closed mid-frame header")
    tag, n = _HDR.unpack(hdr)
    if n > MAX_MESSAGE:
        raise _Transport(f"frame of {n} B exceeds the {MAX_MESSAGE} B limit")
    body = bytearray(n)
    if _recv_into(sock, memoryview(body), t_end) < n:
        raise _Transport(f"connection closed mid-frame ({n} B frame)")
    return tag, body


def _error_body(code: str, message: str) -> bytes:
    return json.dumps({"code": code, "message": message}).encode()


# ------------------------------------------------------------------ server
class _FrameIter:
    """The DATA frames of one client stream, up to its END."""

    def __init__(self, conn: socket.socket, t_end):
        self._conn = conn
        self._t_end = t_end
        self.done = False
        self.broken = False

    def __iter__(self):
        return self

    def __next__(self) -> bytearray:
        if self.done:
            raise StopIteration
        try:
            tag, body = _recv_frame(self._conn, self._t_end)
        except _Transport:
            self.broken = True
            raise
        if tag == END:
            self.done = True
            raise StopIteration
        if tag != DATA:
            self.broken = True
            raise _Transport(f"unexpected frame tag {tag} in a client stream")
        return body

    def drain(self) -> None:
        for _ in self:
            pass


#: DER certificate -> serial, for the per-call revocation check (bounded)
_SERIAL_CACHE: dict = {}


def _peer_serial(conn) -> Optional[int]:
    der = conn.getpeercert(binary_form=True)
    if not der:
        return None
    serial = _SERIAL_CACHE.get(der)
    if serial is None:
        from cryptography import x509

        serial = x509.load_der_x509_certificate(der).serial_number
        if len(_SERIAL_CACHE) > 256:
            _SERIAL_CACHE.clear()
        _SERIAL_CACHE[der] = serial
    return serial


class RpcServer:
    """One listening socket hosting any number of named services; with
    `tls`, over TLS (client certificates required unless `mutual=False`)."""

    #: longest a call may take to arrive or be answered on one connection
    CALL_TIMEOUT_S = 600.0
    #: longest a TLS handshake may take once the client's hello arrived
    HANDSHAKE_TIMEOUT_S = 10.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 16, tls=None, mutual: bool = True):
        self._tls = tls
        self._mutual = mutual
        self.tls_enabled = tls is not None
        #: callable() -> set of revoked certificate serials, read on every
        #: call so a new CRL applies at once; None = no revocation check
        self.crl_provider = None
        #: TLS connections accepted whose handshake has not run yet
        self._handshaking: set = set()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        _tune(self._sock)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._methods: dict[str, tuple[str, Callable]] = {}
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix=f"rpc-{self.port}")
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._ready: deque = deque()
        self._lock = threading.Condition()
        self._conns: set = set()
        self._active: set = set()
        self._stopped = threading.Event()
        self._io: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def add_service(self, service_name: str, methods: dict[str, Method],
                    stream_methods: Optional[dict] = None,
                    server_stream_methods: Optional[dict] = None) -> None:
        for kind, table in ((UNARY, methods),
                            (CLIENT_STREAM, stream_methods or {}),
                            (SERVER_STREAM, server_stream_methods or {})):
            for name, fn in table.items():
                self._methods[f"/{service_name}/{name}"] = (kind, fn)

    def start(self) -> None:
        self._sel.register(self._sock, selectors.EVENT_READ)
        self._sel.register(self._wake_r, selectors.EVENT_READ)
        self._io = threading.Thread(target=self._io_loop, daemon=True,
                                    name=f"rpc-io-{self.port}")
        self._io.start()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except OSError:  # the server is stopping
            pass

    def _io_loop(self) -> None:
        while not self._stopped.is_set():
            for key, _ in self._sel.select(timeout=1.0):
                obj = key.fileobj
                if obj is self._sock:
                    try:
                        conn, _ = self._sock.accept()
                    except OSError:
                        continue
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    if self._tls is not None:
                        try:
                            conn = self._tls.server_context(
                                self._mutual).wrap_socket(
                                conn, server_side=True,
                                do_handshake_on_connect=False)
                        except (OSError, ValueError):
                            conn.close()
                            continue
                    with self._lock:
                        if self._tls is not None:
                            # the handshake runs on a worker once the
                            # client's hello makes the socket readable
                            self._handshaking.add(conn)
                        self._conns.add(conn)
                    self._sel.register(conn, selectors.EVENT_READ)
                elif obj is self._wake_r:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except BlockingIOError:
                        pass
                else:
                    self._sel.unregister(obj)
                    with self._lock:
                        self._active.add(obj)
                    try:
                        self._pool.submit(self._serve_one, obj)
                    except RuntimeError:  # pool shut down: stopping
                        self._drop(obj)
            while self._ready:
                conn = self._ready.popleft()
                if self._stopped.is_set():
                    self._drop(conn)
                else:
                    self._sel.register(conn, selectors.EVENT_READ)

    def _drop(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.discard(conn)
            self._active.discard(conn)
            self._handshaking.discard(conn)
            self._lock.notify_all()
        try:
            conn.close()
        except OSError:
            pass

    def _handshake(self, conn) -> bool:
        """Run a TLS connection's handshake under its deadline; False when
        it failed (a plaintext peer, an untrusted or missing certificate,
        a peer that went silent mid-handshake)."""
        try:
            conn.settimeout(self.HANDSHAKE_TIMEOUT_S)
            conn.do_handshake()
        except (OSError, ValueError) as e:
            log.debug("rpc server %s: TLS handshake failed: %r",
                      self.address, e)
            return False
        with self._lock:
            self._handshaking.discard(conn)
        return True

    def _serve_one(self, conn: socket.socket) -> None:
        keep = False
        try:
            if conn in self._handshaking:
                # the call follows on its own; an idle socket goes back to
                # the selector rather than holding this worker
                keep = self._handshake(conn)
            else:
                keep = self._handle_call(conn)
            # a TLS connection's next frame may already be decrypted in
            # the SSL buffer, where the selector cannot see it
            while keep and not self._stopped.is_set() \
                    and isinstance(conn, ssl.SSLSocket) \
                    and conn.pending() > 0:
                keep = self._handle_call(conn)
        except _Transport:
            keep = False
        except Exception:
            keep = False
            log.exception("rpc server %s: connection failed", self.address)
        if keep and not self._stopped.is_set():
            with self._lock:
                self._active.discard(conn)
                self._lock.notify_all()
            self._ready.append(conn)
            self._wake()
        else:
            self._drop(conn)

    def _handle_call(self, conn: socket.socket) -> bool:
        """Serve one call; True when the connection is still in step."""
        t_end = time.monotonic() + self.CALL_TIMEOUT_S
        try:
            tag, body = _recv_frame(conn, t_end)
        except _Closed:
            return False
        if tag != CALL:
            return False
        hdr = json.loads(bytes(body).decode())
        key, kind, ctx = hdr["m"], hdr["k"], hdr.get("t", "")
        request = frames = None
        if kind == CLIENT_STREAM:
            frames = _FrameIter(conn, t_end)
        else:
            tag, request = _recv_frame(conn, t_end)
            if tag != DATA:
                return False
        entry = self._methods.get(key)
        if entry is None or entry[0] != kind:
            if frames is not None:
                frames.drain()
            _send(conn, [(ERROR, [_error_body(
                "IO_EXCEPTION", f"UNIMPLEMENTED: no {kind} method {key}")])],
                t_end)
            return True
        revoked = self._revoked(conn)
        if revoked is not None:
            if frames is not None:
                frames.drain()
            _send(conn, [(ERROR, [_error_body(
                "CERTIFICATE_REVOKED", f"serial {revoked} is revoked")])],
                t_end)
            return True
        fn = entry[1]
        tracer = Tracer.instance()
        try:
            with tracer.activate(ctx), tracer.span(f"server:{key}"):
                if kind == SERVER_STREAM:
                    for out in fn(request):
                        _send(conn, [(DATA, _parts(out))], t_end)
                    _send(conn, [(END, [])], t_end)
                    return True
                out = fn(frames if frames is not None else request)
                if frames is not None:
                    frames.drain()
        except _Transport:
            raise
        except Exception as e:
            if frames is not None:
                if frames.broken:
                    return False
                frames.drain()
            if isinstance(e, StorageError):
                err = _error_body(e.code, e.msg)
            else:
                log.exception("rpc %s failed", key)
                err = _error_body("IO_EXCEPTION", str(e))
            _send(conn, [(ERROR, [err])], t_end)
            return True
        _send(conn, [(DATA, _parts(out))], t_end)
        return True

    def _revoked(self, conn) -> Optional[int]:
        """The peer certificate's serial when the CRL lists it (the
        handshake cannot consult a live CRL, so every call does)."""
        if self.crl_provider is None or not isinstance(conn, ssl.SSLSocket):
            return None
        crl = self.crl_provider()
        if not crl:
            return None
        serial = _peer_serial(conn)
        return serial if serial is not None and serial in crl else None

    def stop(self, grace: Optional[float] = 0.5) -> None:
        """Stop accepting, close idle connections, let calls in flight
        finish for `grace` seconds, then cut their connections."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._wake()
        if self._io is not None:
            self._io.join(timeout=5)
        for sock in (self._sock, self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass
        self._sel.close()
        with self._lock:
            idle = [c for c in self._conns if c not in self._active]
        for c in idle:
            self._drop(c)
        self._pool.shutdown(wait=False)
        t_end = time.monotonic() + (grace or 0)
        with self._lock:
            while self._active and time.monotonic() < t_end:
                self._lock.wait(timeout=max(0.0, t_end - time.monotonic()))
            busy = list(self._active)
        for c in busy:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        with self._lock:
            t_end = time.monotonic() + 5
            while self._active and time.monotonic() < t_end:
                self._lock.wait(timeout=max(0.0, t_end - time.monotonic()))


# ------------------------------------------------------------------ client
class RpcChannel:
    """Client side of one server address: calls on pooled connections;
    with `tls`, over TLS presenting this role's certificate and checking
    the server's name (`server_name`, or "localhost")."""

    #: idle connections kept per channel
    MAX_IDLE = 32
    CONNECT_TIMEOUT_S = 10.0

    def __init__(self, address: str, tls=None,
                 server_name: Optional[str] = None, traced: bool = True):
        self.address = address
        self._tls = tls
        #: False: calls open no client span (the span exporter's own
        #: channel must not trace the tracing plane)
        self.traced = traced
        self._server_name = server_name or "localhost"
        host, _, port = address.rpartition(":")
        self._target = (host or "127.0.0.1", int(port))
        self._idle: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        #: True once any call on this channel reached the server; a channel
        #: that never connected is the kind FailoverChannels.invalidate
        #: drops
        self.ever_connected = False

    # -- connections
    @staticmethod
    def _alive(sock: socket.socket) -> bool:
        """An idle pooled connection is usable when nothing is waiting on
        it: EOF means the server closed it, stray bytes that it is out of
        step."""
        if isinstance(sock, ssl.SSLSocket):
            return RpcChannel._tls_alive(sock)
        try:
            sock.setblocking(False)
            try:
                sock.recv(1, socket.MSG_PEEK)
                return False
            except BlockingIOError:
                return True
            finally:
                sock.setblocking(True)
        except OSError:
            return False

    @staticmethod
    def _tls_alive(sock: ssl.SSLSocket) -> bool:
        """The same check on TLS, which takes no MSG_PEEK: decrypted bytes
        waiting, EOF, or application data on a non-blocking read mean the
        connection is out of step (any byte read is the discarded
        connection's); a read that wants more (a record that is not
        application data, or nothing) means it is usable."""
        if sock.pending() > 0:
            return False
        try:
            sock.setblocking(False)
            try:
                sock.recv(1)
                return False  # data or EOF
            except (ssl.SSLWantReadError, ssl.SSLWantWriteError,
                    BlockingIOError):
                return True
            finally:
                sock.setblocking(True)
        except (OSError, ValueError):
            return False

    def _acquire(self, t_end: Optional[float]) -> socket.socket:
        while True:
            with self._lock:
                sock = self._idle.pop() if self._idle else None
            if sock is None:
                break
            if self._alive(sock):
                return sock
            sock.close()
        left = self.CONNECT_TIMEOUT_S if t_end is None else min(
            self.CONNECT_TIMEOUT_S, t_end - time.monotonic())
        if left <= 0:
            raise _Transport("deadline exceeded before connecting")
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        _tune(sock)
        sock.settimeout(left)
        try:
            sock.connect(self._target)
        except OSError as e:
            sock.close()
            raise _Transport(f"connect failed: {e!r}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._tls is not None:
            sock = self._wrap(sock, t_end)
        return sock

    def _wrap(self, sock: socket.socket, t_end) -> ssl.SSLSocket:
        """The TLS handshake on a new connection, within the connect
        deadline; a refusal is a transport failure, never a plaintext
        retry."""
        t0 = time.perf_counter()
        try:
            tls_sock = self._tls.client_context().wrap_socket(
                sock, server_hostname=self._server_name,
                do_handshake_on_connect=False)
            left = self.CONNECT_TIMEOUT_S if t_end is None else min(
                self.CONNECT_TIMEOUT_S, t_end - time.monotonic())
            tls_sock.settimeout(max(left, 0.001))
            tls_sock.do_handshake()
        except (OSError, ValueError) as e:
            sock.close()
            raise _Transport(f"TLS handshake failed: {e!r}") from e
        METRICS.histogram("tls_handshake").observe(time.perf_counter() - t0)
        return tls_sock

    def _release(self, sock: socket.socket, ok: bool) -> None:
        if ok:
            with self._lock:
                if not self._closed and len(self._idle) < self.MAX_IDLE:
                    self._idle.append(sock)
                    return
        try:
            sock.close()
        except OSError:
            pass

    # -- errors
    def _unavailable(self, key: str, e: Exception) -> StorageError:
        return StorageError("UNAVAILABLE", f"rpc {key} to {self.address}: {e}")

    def _server_error(self, body: bytes) -> StorageError:
        self.ever_connected = True
        d = json.loads(bytes(body).decode())
        return StorageError(d.get("code", "IO_EXCEPTION"), d.get("message", ""))

    @staticmethod
    def _call_header(key: str, kind: str) -> bytes:
        return json.dumps({"m": key, "k": kind,
                           "t": Tracer.instance().inject()},
                          separators=(",", ":")).encode()

    @staticmethod
    def _deadline(timeout: Optional[float]) -> Optional[float]:
        return None if timeout is None else time.monotonic() + timeout

    def _span(self, key: str):
        if not self.traced:
            return contextlib.nullcontext()
        return Tracer.instance().span(f"client:{key}", address=self.address)

    # -- calls
    def call(self, service: str, method: str, request,
             timeout: Optional[float] = 30.0) -> bytearray:
        return self._one_answer(service, method, UNARY, [request], timeout)

    def call_streaming(self, service: str, method: str, frames: Iterable,
                       timeout: Optional[float] = 120.0) -> bytearray:
        """Client-streaming call: send every frame of `frames`, get one
        response (the zero-round-trip-per-chunk write path)."""
        return self._one_answer(service, method, CLIENT_STREAM, frames,
                                timeout)

    def _one_answer(self, service: str, method: str, kind: str,
                    frames: Iterable, timeout: Optional[float]) -> bytearray:
        """A unary call (one request frame) or a client stream (any number,
        then END), answered by one DATA or ERROR frame."""
        key = f"/{service}/{method}"
        t_end = self._deadline(timeout)
        with self._span(key):
            sock = None
            ok = False
            try:
                sock = self._acquire(t_end)
                head = [(CALL, [self._call_header(key, kind)])]
                if kind == UNARY:  # header and request in one send
                    (request,) = frames
                    _send(sock, head + [(DATA, _parts(request))], t_end)
                else:
                    _send(sock, head, t_end)
                    for f in frames:
                        _send(sock, [(DATA, _parts(f))], t_end)
                    _send(sock, [(END, [])], t_end)
                tag, body = _recv_frame(sock, t_end)
                ok = tag in (DATA, ERROR)
            except _Transport as e:
                raise self._unavailable(key, e) from e
            finally:
                if sock is not None:
                    self._release(sock, ok)
            if not ok:
                raise self._unavailable(key, f"unexpected frame tag {tag}")
            if tag == ERROR:
                raise self._server_error(body)
            self.ever_connected = True
            return body

    def call_server_stream(self, service: str, method: str, request,
                           timeout: Optional[float] = 300.0):
        """Server-streaming call: one request, the response frames yielded
        as they arrive (large downloads never buffer in one message)."""
        key = f"/{service}/{method}"
        t_end = self._deadline(timeout)
        with self._span(key):
            sock = None
            ok = False
            try:
                sock = self._acquire(t_end)
                _send(sock, [(CALL, [self._call_header(key, SERVER_STREAM)]),
                             (DATA, _parts(request))], t_end)
                while True:
                    tag, body = _recv_frame(sock, t_end)
                    if tag == DATA:
                        self.ever_connected = True
                        yield body
                    elif tag == END:
                        ok = True
                        return
                    elif tag == ERROR:
                        ok = True
                        raise self._server_error(body)
                    else:
                        raise _Transport(f"unexpected frame tag {tag}")
            except _Transport as e:
                raise self._unavailable(key, e) from e
            finally:
                if sock is not None:
                    self._release(sock, ok)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for s in idle:
            try:
                s.close()
            except OSError:
                pass


class FailoverChannels:
    """Address-list channel pool for failover clients (the reference's
    OMFailoverProxyProvider plumbing, `ozone_tpu/net/rpc.py:406-525`):
    comma-list parsing, a thread-safe lazily built channel cache, and a
    sticky index that follows leader hints or rotates on unreachable
    replicas. Shared by the remote OM and SCM clients."""

    def __init__(self, address: str, tls=None):
        self.addresses = [a.strip() for a in address.split(",")
                          if a.strip()]
        if not self.addresses:
            raise ValueError("empty address list")
        self._tls = tls
        #: the material's version (RotatingTls) the cached channels were
        #: made under: a renewal retires them, parked until close() since
        #: a call in flight may still be on one
        self._tls_ver = getattr(tls, "version", None)
        self._chs: dict[str, RpcChannel] = {}
        #: channels of replicas retired by reconcile(); closed with the pool
        self._retired: list[RpcChannel] = []
        self._idx = 0
        self._lock = threading.Lock()

    @property
    def current(self) -> str:
        with self._lock:
            return self.addresses[self._idx]

    def channel(self, addr: Optional[str] = None) -> tuple[str, RpcChannel]:
        with self._lock:
            ver = getattr(self._tls, "version", None)
            if ver != self._tls_ver:
                self._retired.extend(self._chs.values())
                self._chs.clear()
                self._tls_ver = ver
            a = addr if addr is not None else self.addresses[self._idx]
            ch = self._chs.get(a)
            if ch is None:
                ch = self._chs[a] = RpcChannel(a, tls=self._tls)
            return a, ch

    def rotate(self) -> None:
        with self._lock:
            self._idx = (self._idx + 1) % len(self.addresses)

    def invalidate(self, addr: str) -> None:
        """Drop and close the cached channel of an unreachable replica
        that never connected; a once-healthy channel is kept."""
        with self._lock:
            ch = self._chs.get(addr)
            if ch is None or ch.ever_connected:
                return
            del self._chs[addr]
        ch.close()

    def reconcile(self, ring: list) -> None:
        """Adopt a server-shipped membership as the address list; the
        sticky index stays on the replica in use when it survives."""
        ring = [a.strip() for a in ring if a and a.strip()]
        if not ring:
            return
        with self._lock:
            if set(ring) == set(self.addresses):
                return
            cur = self.addresses[self._idx]
            self.addresses[:] = dict.fromkeys(ring)
            self._idx = (self.addresses.index(cur)
                         if cur in self.addresses else 0)
            self._retired.extend(self._chs.pop(a) for a in list(self._chs)
                                 if a not in self.addresses)

    def follow_hint(self, addr: Optional[str]) -> None:
        """Pin to a hinted leader address; a hint that is unknown or points
        back at the current replica rotates instead."""
        with self._lock:
            if addr and addr in self.addresses:
                i = self.addresses.index(addr)
                if i != self._idx:
                    self._idx = i
                    return
            self._idx = (self._idx + 1) % len(self.addresses)

    def close(self) -> None:
        with self._lock:
            chans = list(self._chs.values()) + self._retired
            self._chs.clear()
            self._retired = []
        for ch in chans:
            ch.close()
