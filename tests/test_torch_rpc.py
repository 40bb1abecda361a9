"""The port's standard-library RPC against `ozone_tpu`'s gRPC plumbing, on
the CPU.

The wire frames are byte for byte the reference's; unary,
client-streaming and server-streaming calls round-trip; a server-raised
StorageError keeps its code; a refused connection, a stopped server and a
peer that dies mid-frame give UNAVAILABLE and never leave a pooled
connection out of step; FailoverChannels and the retry policies follow
the reference's sequences exactly.
"""

import json
import random
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest

from ozone_tpu.client import resilience as j_resilience
from ozone_tpu.net import rpc as j_rpc
from ozone_tpu.net import wire as j_wire
from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.net import rpc, wire
from ozone_tpu_torch.storage.ids import StorageError

#: every wait in this file is bounded by this many seconds
WAIT_S = 10.0

_rng = np.random.default_rng(7)
_DATA = _rng.integers(0, 256, 5000, dtype=np.uint8)
PAYLOADS = {
    "none": None,
    "numpy": _DATA,
    "bytes": _DATA.tobytes(),
    "memoryview": memoryview(_DATA.tobytes()),
    "bytearray": bytearray(_DATA.tobytes()),
    "numpy_strided": _DATA[::2],
    "numpy_int32": _DATA[:4000].view(np.int32),
    "empty": b"",
}
META = {"block_id": {"container_id": 3, "local_id": 9}, "verify": True,
        "chunks": [{"name": "c0", "offset": 0, "length": 5000}],
        "unicode": "ключ/κλειδί"}


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_pack_matches_reference(kind):
    payload = PAYLOADS[kind]
    got = wire.pack(META, payload)
    assert got == j_wire.pack(META, payload)
    assert b"".join(bytes(p) for p in wire.pack_parts(META, payload)) == got
    meta, body = wire.unpack(bytearray(got))
    j_meta, j_body = j_wire.unpack(got)
    assert meta == j_meta == META
    assert bytes(body) == bytes(j_body)
    assert np.array_equal(wire.payload_array(body),
                          j_wire.payload_array(j_body))


# ----------------------------------------------------------------- servers
@pytest.fixture
def server():
    s = rpc.RpcServer()

    def boom(req):
        m, _ = wire.unpack(req)
        raise StorageError(m["code"], "raised by the handler")

    def crash(req):
        raise ValueError("not a StorageError")

    def total(frames):
        it = iter(frames)
        head, _ = wire.unpack(next(it))
        n = 0
        for i, f in enumerate(it):
            if head.get("fail_at") == i:
                raise StorageError("CHECKSUM_MISMATCH", f"frame {i}")
            n += len(f)
        return wire.pack({"bytes": n})

    def numbers(req):
        m, _ = wire.unpack(req)
        for i in range(m["n"]):
            if m.get("fail_at") == i:
                raise StorageError("NO_SUCH_BLOCK", f"item {i}")
            yield wire.pack_parts({"i": i}, np.full(m["size"], i % 251,
                                                    np.uint8))

    s.add_service("T", {"Echo": lambda r: r, "Boom": boom, "Crash": crash},
                  stream_methods={"Total": total},
                  server_stream_methods={"Numbers": numbers})
    s.start()
    yield s
    s.stop()


def test_unary_client_and_server_streams(server):
    ch = rpc.RpcChannel(server.address)
    try:
        big = _rng.integers(0, 256, 3 * 1024 * 1024 + 17, dtype=np.uint8)
        out = ch.call("T", "Echo", wire.pack_parts({"k": 1}, big))
        m, body = wire.unpack(out)
        assert m == {"k": 1} and np.array_equal(wire.payload_array(body), big)
        frames = [wire.pack({})] + [wire.pack_parts({"c": i}, big[:1 << 20])
                                    for i in range(5)] + [b"", b"xyz"]
        m, _ = wire.unpack(ch.call_streaming("T", "Total", frames))
        n_frame = len(wire.pack({"c": 0}, big[:1 << 20]))
        assert m == {"bytes": 5 * n_frame + 3}
        got = list(ch.call_server_stream(
            "T", "Numbers", wire.pack({"n": 4, "size": 300_000})))
        assert [wire.unpack(f)[0] for f in got] == [{"i": i} for i in range(4)]
        for i, f in enumerate(got):
            assert np.all(wire.payload_array(wire.unpack(f)[1]) == i)
        # every exchange ended cleanly: one pooled connection served them
        assert len(ch._idle) == 1 and ch.ever_connected
    finally:
        ch.close()


def test_server_errors_keep_their_code(server):
    ch = rpc.RpcChannel(server.address)
    try:
        for code in ("KEY_NOT_FOUND", "CONTAINER_NOT_FOUND", "SERVER_BUSY"):
            with pytest.raises(StorageError) as ei:
                ch.call("T", "Boom", wire.pack({"code": code}))
            assert ei.value.code == code
            assert ei.value.msg == "raised by the handler"
        with pytest.raises(StorageError) as ei:
            ch.call("T", "Crash", b"")
        assert ei.value.code == "IO_EXCEPTION"
        assert "not a StorageError" in ei.value.msg
        with pytest.raises(StorageError) as ei:
            ch.call("T", "Missing", b"")
        assert ei.value.code == "IO_EXCEPTION" and "UNIMPLEMENTED" in ei.value.msg
        # a stream the handler refuses early is still read to its end, so
        # the pooled connection stays in step for the next call
        frames = [wire.pack({"fail_at": 1})] + [b"x" * 1000] * 50
        with pytest.raises(StorageError) as ei:
            ch.call_streaming("T", "Total", frames)
        assert ei.value.code == "CHECKSUM_MISMATCH"
        with pytest.raises(StorageError) as ei:
            list(ch.call_server_stream(
                "T", "Numbers", wire.pack({"n": 5, "size": 10, "fail_at": 2})))
        assert ei.value.code == "NO_SUCH_BLOCK"
        assert bytes(ch.call("T", "Echo", b"after")) == b"after"
        assert len(ch._idle) == 1 and ch.ever_connected
    finally:
        ch.close()


def test_refused_connection_is_unavailable():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens on it now
    ch = rpc.RpcChannel(f"127.0.0.1:{port}")
    for call in (lambda: ch.call("T", "Echo", b"x"),
                 lambda: ch.call_streaming("T", "Total", [b"x"]),
                 lambda: list(ch.call_server_stream("T", "Numbers", b"x"))):
        with pytest.raises(StorageError) as ei:
            call()
        assert ei.value.code == "UNAVAILABLE"
    assert not ch.ever_connected


def _half_frame_server(frames_before: int):
    """A peer that reads one call, answers `frames_before` whole DATA frames
    and then half of one, and dies."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.settimeout(WAIT_S)

    def run():
        conn, _ = lsock.accept()
        conn.settimeout(WAIT_S)
        conn.recv(65536)
        whole = struct.pack("!BI", rpc.DATA, 4) + b"good"
        conn.sendall(whole * frames_before
                     + struct.pack("!BI", rpc.DATA, 1000) + b"only part")
        conn.close()
        lsock.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return f"127.0.0.1:{lsock.getsockname()[1]}", t


@pytest.mark.parametrize("kind", ["unary", "server_stream"])
def test_peer_dying_mid_frame_is_unavailable(kind):
    addr, t = _half_frame_server(1 if kind == "server_stream" else 0)
    ch = rpc.RpcChannel(addr)
    got = []
    with pytest.raises(StorageError) as ei:
        if kind == "unary":
            ch.call("T", "Echo", b"x", timeout=WAIT_S)
        else:
            for f in ch.call_server_stream("T", "Numbers", b"x",
                                           timeout=WAIT_S):
                got.append(bytes(f))
    t.join(WAIT_S)
    assert ei.value.code == "UNAVAILABLE"
    assert "mid-frame" in ei.value.msg
    assert got == ([b"good"] if kind == "server_stream" else [])
    assert ch._idle == []  # the broken connection was not pooled


def test_stopped_server_is_unavailable_and_a_new_one_is_redialled():
    s = rpc.RpcServer()
    s.add_service("T", {"Echo": lambda r: r})
    s.start()
    port = s.port
    ch = rpc.RpcChannel(s.address)
    assert bytes(ch.call("T", "Echo", b"a")) == b"a"
    assert len(ch._idle) == 1
    s.stop()
    with pytest.raises(StorageError) as ei:
        ch.call("T", "Echo", b"b")
    assert ei.value.code == "UNAVAILABLE"
    # the same port again (SO_REUSEADDR): the stale pooled connection is
    # noticed before use and a fresh one dialled
    s2 = rpc.RpcServer(port=port)
    s2.add_service("T", {"Echo": lambda r: r})
    s2.start()
    try:
        assert bytes(ch.call("T", "Echo", b"c")) == b"c"
    finally:
        ch.close()
        s2.stop()


def test_many_idle_connections_do_not_hold_workers(server):
    """More idle pooled connections than the 16 workers: the selector
    holds idle connections, so calls keep being served; 40 threads with a
    short switch interval keep every answer with its own call."""
    chans = [rpc.RpcChannel(server.address) for _ in range(40)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for i, ch in enumerate(chans):
            assert bytes(ch.call("T", "Echo", b"%d" % i, timeout=WAIT_S)) \
                == b"%d" % i
        errors = []

        def worker(ch, i):
            try:
                for j in range(5):
                    out = ch.call("T", "Echo", wire.pack({"i": i, "j": j}),
                                  timeout=WAIT_S)
                    assert wire.unpack(out)[0] == {"i": i, "j": j}
            except Exception as e:  # noqa: BLE001 - collected
                errors.append(e)

        ts = [threading.Thread(target=worker, args=(ch, i))
              for i, ch in enumerate(chans)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
        assert errors == [] and not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
        for ch in chans:
            ch.close()


def test_message_limit_and_counted_copies(server, monkeypatch):
    ch = rpc.RpcChannel(server.address)
    try:
        monkeypatch.setattr(rpc, "MAX_MESSAGE", 1000)
        with pytest.raises(StorageError) as ei:
            ch.call("T", "Echo", b"x" * 1001)
        assert ei.value.code == "IO_EXCEPTION" and "RESOURCE_EXHAUSTED" in \
            ei.value.msg
        monkeypatch.undo()
        # a small payload view is joined into the send (one counted copy);
        # a large one goes out as it is
        before = hostmem.METRICS.counter("bytes_copied").value
        ch.call("T", "Echo", wire.pack_parts({}, _DATA))
        mid = hostmem.METRICS.counter("bytes_copied").value
        ch.call("T", "Echo", wire.pack_parts({}, np.zeros(1 << 20, np.uint8)))
        after = hostmem.METRICS.counter("bytes_copied").value
        assert mid - before >= _DATA.size
        # the 1 MiB request is sent without a copy (the echoed reply is a
        # bytearray view, also sent as it is)
        assert after == mid
    finally:
        ch.close()


# ---------------------------------------------------------------- failover
SEQUENCES = [
    [("rotate",), ("rotate",), ("rotate",), ("rotate",)],
    [("hint", "b:2"), ("hint", "b:2"), ("hint", "zz:9"), ("hint", None),
     ("hint", "a:1")],
    [("rotate",), ("reconcile", ["c:3", "d:4"]), ("rotate",),
     ("reconcile", ["d:4", "e:5", "c:3"]), ("hint", "e:5"),
     ("reconcile", []), ("reconcile", ["x:1"]), ("rotate",)],
    [("channel",), ("invalidate", "a:1"), ("rotate",), ("channel",),
     ("hint", "c:3"), ("invalidate", "c:3"), ("channel",)],
]


@pytest.mark.parametrize("seq", range(len(SEQUENCES)))
def test_failover_channels_follow_the_reference(seq):
    mine = rpc.FailoverChannels(" a:1, b:2 ,c:3,")
    ref = j_rpc.FailoverChannels(" a:1, b:2 ,c:3,")
    try:
        trace_mine, trace_ref = [], []
        for op, *arg in SEQUENCES[seq]:
            for pool, trace in ((mine, trace_mine), (ref, trace_ref)):
                if op == "rotate":
                    pool.rotate()
                elif op == "hint":
                    pool.follow_hint(arg[0])
                elif op == "reconcile":
                    pool.reconcile(arg[0])
                elif op == "invalidate":
                    pool.invalidate(arg[0])
                else:
                    trace.append(pool.channel()[0])
                trace.append((pool.current, list(pool.addresses),
                              sorted(pool._chs)))
        assert trace_mine == trace_ref
    finally:
        mine.close()
        ref.close()


def test_empty_address_list_is_refused():
    for mod in (rpc, j_rpc):
        with pytest.raises(ValueError):
            mod.FailoverChannels(" , ")


# ------------------------------------------------------------------- retry
@pytest.mark.parametrize("seed", [0, 1, 31337])
@pytest.mark.parametrize("policy", ["failover", "default", "floor"])
def test_retry_schedule_matches_reference(seed, policy, monkeypatch):
    def make(mod):
        if policy == "failover":
            return mod.failover_retry_policy(9)
        if policy == "default":
            return mod.RetryPolicy()
        return mod.RetryPolicy(base_s=0.1, cap_s=2.0, max_attempts=6,
                               floor_fraction=0.25)

    mine, ref = make(resilience), make(j_resilience)
    assert [mine.backoff_s(a, random.Random(seed + a)) for a in range(12)] \
        == [ref.backoff_s(a, random.Random(seed + a)) for a in range(12)]
    slept = {"mine": [], "ref": []}
    for name, mod, p in (("mine", resilience, mine),
                         ("ref", j_resilience, ref)):
        monkeypatch.setattr(mod.time, "sleep", slept[name].append)
        rng = random.Random(seed)
        go = [p.sleep(a, rng=rng, floor_s=0.5 if a == 2 else None)
              for a in range(p.max_attempts + 1)]
        slept[name].append(go)
        monkeypatch.undo()
    assert slept["mine"] == slept["ref"]


def test_retry_sleep_is_clipped_by_the_deadline(monkeypatch):
    out = {}
    for name, mod in (("mine", resilience), ("ref", j_resilience)):
        naps = []
        monkeypatch.setattr(mod.time, "sleep", naps.append)
        with mod.start("op", seconds=0.05):
            go = mod.RetryPolicy(base_s=1.0, cap_s=1.0).sleep(
                0, rng=random.Random(3))
        monkeypatch.undo()
        out[name] = (go, len(naps), all(n <= 0.05 for n in naps))
    assert out["mine"] == out["ref"] == (True, 1, True)
    with resilience.start("op", seconds=1e-9):
        time.sleep(0.001)
        with pytest.raises(StorageError) as ei:
            resilience.check_deadline("om_failover")
    assert ei.value.code == resilience.DEADLINE_EXCEEDED


@pytest.mark.parametrize("msg", [
    "om overloaded (queue full); retry_after_s=1.250",
    "retry_after_s=99", "no hint here", "retry_after_s=x"])
def test_server_pushback_floor_matches_reference(msg):
    busy = StorageError(resilience.SERVER_BUSY, msg)
    j_busy = j_resilience.StorageError(j_resilience.SERVER_BUSY, msg)
    assert resilience.server_pushback_floor(busy, "om") == \
        j_resilience.server_pushback_floor(j_busy, "om")
    assert resilience.server_pushback_floor(
        StorageError("UNAVAILABLE", msg)) is None


def test_error_body_is_the_reference_detail():
    """The ERROR frame carries the same {code, message} JSON the reference
    puts in its gRPC status detail."""
    assert json.loads(rpc._error_body("KEY_NOT_FOUND", "v/b/k")) == \
        {"code": "KEY_NOT_FOUND", "message": "v/b/k"}
