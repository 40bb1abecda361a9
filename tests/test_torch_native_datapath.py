"""The port's native chunk datapath against `ozone_tpu`, on the CPU.

Mirrors tests/test_native_datapath.py on the port's sidecar
(`ozone_tpu_torch/csrc/datapath.cpp`, built here with g++ through
`cuda_build`, `storage/fast_datapath.py`) and its client
(`client/native_dn.py`): a write/read roundtrip, native bytes equal to
the RPC's and to what `ozone_tpu`'s in-process Datanode writes for the
same seeded chunks, CHECKSUM_MISMATCH marking the container unhealthy, the
write fence, a commit naming another block and a missing container with
the reference's error codes, and the RPC fallback when no sidecar runs,
counted. Beyond the reference's tests: the client's frames are byte for
byte the reference client's, a datanode daemon whose sidecar cannot be
built or bound raises, and a refused size leaves the connection usable.
The block-token and partition cases wait for those modules.
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from ozone_tpu.client import native_dn as j_native_dn
from ozone_tpu.storage import ids as j_ids
from ozone_tpu.storage.datanode import Datanode as JDatanode
from ozone_tpu.utils import checksum as j_checksum
from ozone_tpu_torch.client.native_dn import NativeDatanodeClient
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.net import daemons
from ozone_tpu_torch.net.dn_service import DatanodeRpcService, RpcDatanodeClient
from ozone_tpu_torch.net.rpc import RpcServer
from ozone_tpu_torch.storage import fast_datapath
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.fast_datapath import DatapathSidecar
from ozone_tpu_torch.storage.ids import BlockData, BlockID, ChunkInfo, StorageError
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

BPC = 16 * 1024


@pytest.fixture()
def cluster(tmp_path):
    """One datanode served by the RPC and the native sidecar, wired as the
    daemon wires them (no SCM)."""
    dn = Datanode(tmp_path / "dn", dn_id="dn0")
    dn.create_container(1)
    server = RpcServer()
    sidecar = DatapathSidecar(dn)
    assert sidecar.start() > 0
    DatanodeRpcService(dn, server, datapath_port=sidecar.advertise)
    server.start()
    client = NativeDatanodeClient("dn0", server.address)
    yield dn, client, sidecar
    client.close()
    sidecar.stop()
    server.stop()
    dn.close()


def _payload(seed: int, n: int = 256 * 1024) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _fallbacks() -> int:
    return hostmem.METRICS.counter("native_fallbacks").value


def test_native_write_read_roundtrip(cluster):
    dn, client, sidecar = cluster
    assert client._lane("probe") == sidecar.port
    data = _payload(1)
    cs = Checksum(ChecksumType.CRC32C, BPC).compute(data)
    bid = BlockID(1, 1)
    infos = [ChunkInfo(f"c{j}", j * data.size, data.size, cs) for j in range(3)]
    f0 = _fallbacks()
    client.write_chunks_commit(bid, [(i, data) for i in infos],
                               commit=BlockData(bid, infos), sync=True)
    # committed through the Python control plane
    assert [c.name for c in dn.get_block(bid).chunks] == ["c0", "c1", "c2"]
    out = client.read_chunks(bid, infos, verify=True)
    assert len(out) == 3
    for arr in out:
        np.testing.assert_array_equal(arr, data)
    np.testing.assert_array_equal(client.read_chunk(bid, infos[1], verify=True),
                                  data)
    assert dn.metrics.counter("batched_write_streams").value == 1
    assert dn.metrics.counter("batched_read_streams").value == 2
    assert _fallbacks() == f0


def test_native_bytes_equal_rpc_and_reference(cluster, tmp_path):
    """Seeded chunks written over the native lane, over the RPC and into
    `ozone_tpu`'s in-process Datanode give equal block files and equal
    committed BlockData; either lane reads the other's bytes."""
    dn, client, _ = cluster
    rng = np.random.default_rng(2)
    sizes = [64 * 1024, 64 * 1024, 5000]
    datas = [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
    offs = np.cumsum([0] + sizes[:-1]).tolist()
    cks = Checksum(ChecksumType.CRC32C, BPC)
    infos = [ChunkInfo(f"c{j}", o, d.size, cks.compute(d))
             for j, (o, d) in enumerate(zip(offs, datas))]
    b_native, b_rpc = BlockID(1, 10), BlockID(1, 11)
    client.write_chunks_commit(b_native, list(zip(infos, datas)),
                               commit=BlockData(b_native, infos))
    rpc = RpcDatanodeClient("dn0", client.address)
    try:
        rpc.write_chunks_commit(b_rpc, list(zip(infos, datas)),
                                commit=BlockData(b_rpc, infos))
        got = rpc.read_chunks(b_native, infos, verify=True)
    finally:
        rpc.close()
    for g, d in zip(got, datas):
        np.testing.assert_array_equal(g, d)
    for g, d in zip(client.read_chunks(b_rpc, infos, verify=True), datas):
        np.testing.assert_array_equal(g, d)

    jdn = JDatanode(tmp_path / "jdn", dn_id="dn0")
    try:
        jdn.create_container(1)
        jck = j_checksum.Checksum(j_checksum.ChecksumType.CRC32C, BPC)
        jbid = j_ids.BlockID(1, 10)
        jinfos = [j_ids.ChunkInfo(f"c{j}", o, d.size, jck.compute(d))
                  for j, (o, d) in enumerate(zip(offs, datas))]
        for i, d in zip(jinfos, datas):
            jdn.write_chunk(jbid, i, d)
        jdn.put_block(j_ids.BlockData(jbid, jinfos))
        ref_file = jdn.containers.get(1).chunks.block_path(jbid).read_bytes()
        ref_block = jdn.get_block(jbid).to_json()
    finally:
        jdn.close()
    chunks = dn.containers.get(1).chunks
    assert chunks.block_path(b_native).read_bytes() == ref_file
    assert chunks.block_path(b_rpc).read_bytes() == ref_file
    assert dn.get_block(b_native).to_json() == ref_block
    assert dn.get_block(b_rpc).to_json()["chunks"] == ref_block["chunks"]


def test_native_read_checksum_mismatch_marks_unhealthy(cluster):
    dn, client, _ = cluster
    data = _payload(3, 32 * 1024)
    cs = Checksum(ChecksumType.CRC32C, BPC).compute(data)
    bid = BlockID(1, 20)
    info = ChunkInfo("c0", 0, data.size, cs)
    client.write_chunk(bid, info, data)
    path = dn.containers.get(1).chunks.block_path(bid)
    raw = bytearray(path.read_bytes())
    raw[100] ^= 0xFF
    path.write_bytes(bytes(raw))
    mutations = dn.mutation_count
    with pytest.raises(StorageError) as ei:
        client.read_chunk(bid, info, verify=True)
    assert ei.value.code == "CHECKSUM_MISMATCH"
    assert dn.containers.get(1).state.value == "UNHEALTHY"
    assert dn.metrics.counter("checksum_failures").value == 1
    assert dn.mutation_count > mutations  # the next report carries it


def test_native_write_fence(cluster):
    """A second writer streaming into an owned block is refused before any
    byte lands, with the RPC verbs' code."""
    dn, client, _ = cluster
    data = _payload(4, 16 * 1024)
    info = ChunkInfo("c0", 0, data.size,
                     Checksum(ChecksumType.CRC32C, BPC).compute(data))
    bid = BlockID(1, 30)
    client.write_chunks_commit(bid, [(info, data)], writer="w1")
    with pytest.raises(StorageError) as ei:
        client.write_chunks_commit(bid, [(info, data)], writer="w2")
    assert ei.value.code == j_ids.BLOCK_WRITE_CONFLICT == "BLOCK_WRITE_CONFLICT"
    assert dn.metrics.counter("write_fence_violations").value == 1


def test_native_commit_id_mismatch_refused(cluster):
    _, client, _ = cluster
    data = _payload(5, 4096)
    info = ChunkInfo("c0", 0, data.size,
                     Checksum(ChecksumType.CRC32C, BPC).compute(data))
    with pytest.raises(StorageError) as ei:
        client.write_chunks_commit(BlockID(1, 40), [(info, data)],
                                   commit=BlockData(BlockID(1, 41), [info]))
    assert ei.value.code == "INVALID_ARGUMENT"


def test_native_missing_container(cluster):
    _, client, _ = cluster
    data = _payload(6, 4096)
    info = ChunkInfo("c0", 0, data.size,
                     Checksum(ChecksumType.CRC32C).compute(data))
    with pytest.raises(StorageError) as ei:
        client.write_chunks_commit(BlockID(999, 1), [(info, data)])
    assert ei.value.code == j_ids.CONTAINER_NOT_FOUND == "CONTAINER_NOT_FOUND"
    # the connection survives an early refusal (the server drains to END)
    bid = BlockID(1, 50)
    client.write_chunks_commit(bid, [(info, data)],
                               commit=BlockData(bid, [info]))
    assert len(client._pool) == 1


def test_refused_size_leaves_the_connection_in_step(cluster):
    """A chunk whose data does not match its declared length is refused
    before the first frame leaves, so the pooled connection stays usable."""
    dn, client, _ = cluster
    data = _payload(7, 8192)
    info = ChunkInfo("c0", 0, data.size,
                     Checksum(ChecksumType.CRC32C, BPC).compute(data))
    bid = BlockID(1, 60)
    client.write_chunks_commit(bid, [(info, data)])
    with pytest.raises(StorageError) as ei:
        client.write_chunks_commit(bid, [(info, data[:-1])])
    assert ei.value.code == "INVALID_WRITE_SIZE"
    client.write_chunks_commit(bid, [(info, data)],
                               commit=BlockData(bid, [info]))
    np.testing.assert_array_equal(client.read_chunk(bid, info, verify=True),
                                  data)
    assert dn.metrics.counter("batched_write_streams").value == 2


def test_fallback_when_no_sidecar_is_counted(tmp_path):
    """A datanode that advertises no native port serves every bulk verb
    over the RPC through the same client, and each such call is counted."""
    dn = Datanode(tmp_path / "dn", dn_id="dn0")
    dn.create_container(1)
    server = RpcServer()
    DatanodeRpcService(dn, server)  # no datapath provider
    server.start()
    client = NativeDatanodeClient("dn0", server.address)
    try:
        f0 = _fallbacks()
        data = _payload(8, 8192)
        info = ChunkInfo("c0", 0, data.size,
                         Checksum(ChecksumType.CRC32C, BPC).compute(data))
        bid = BlockID(1, 1)
        client.write_chunks_commit(bid, [(info, data)],
                                   commit=BlockData(bid, [info]))
        np.testing.assert_array_equal(
            client.read_chunk(bid, info, verify=True), data)
        assert _fallbacks() == f0 + 2
        assert dn.metrics.counter("batched_write_streams").value == 1
    finally:
        client.close()
        server.stop()
        dn.close()


def test_connect_failure_falls_back_and_rediscovers(cluster):
    """The sidecar goes away: the next call runs over the RPC (counted) and
    a restarted sidecar on a new port is found by the call after."""
    dn, client, sidecar = cluster
    data = _payload(9, 4096)
    info = ChunkInfo("c0", 0, data.size,
                     Checksum(ChecksumType.CRC32C, BPC).compute(data))
    bid = BlockID(1, 70)
    client.write_chunks_commit(bid, [(info, data)], commit=BlockData(bid, [info]))
    sidecar.stop()
    client._np_uds = None  # the abstract socket name dies with its listener
    f0 = _fallbacks()
    np.testing.assert_array_equal(client.read_chunk(bid, info), data)
    assert _fallbacks() == f0 + 1
    assert sidecar.start() > 0
    streams = dn.metrics.counter("batched_read_streams").value
    np.testing.assert_array_equal(client.read_chunk(bid, info), data)
    assert _fallbacks() == f0 + 1
    assert dn.metrics.counter("batched_read_streams").value == streams + 1


def test_stop_returns_with_idle_pooled_connections(cluster):
    """dp_stop returns within its bounded wait while a client holds idle
    pooled connections (its acceptors and idle handlers poll the stop
    flag), and the client's next call falls back instead of hanging."""
    dn, client, sidecar = cluster
    data = _payload(11, 4096)
    info = ChunkInfo("c0", 0, data.size,
                     Checksum(ChecksumType.CRC32C, BPC).compute(data))
    bid = BlockID(1, 80)
    client.write_chunks_commit(bid, [(info, data)], commit=BlockData(bid, [info]))
    client.read_chunk(bid, info)
    assert client._pool
    t0 = time.perf_counter()
    sidecar.stop()
    assert time.perf_counter() - t0 < 1.5
    f0 = _fallbacks()
    np.testing.assert_array_equal(client.read_chunk(bid, info), data)
    assert _fallbacks() == f0 + 1


# ------------------------------------------------------- frames on the wire
def _fake_sidecar(reply: bytes):
    """A listener that records one request (frames up to END) and answers
    `reply`; returns (port, recorded bytes, thread)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = bytearray()

    def recv_exact(c, n):
        buf = bytearray()
        while len(buf) < n:
            part = c.recv(n - len(buf))
            assert part
            buf += part
        return bytes(buf)

    def run():
        c, _ = srv.accept()
        with c:
            while True:
                head = recv_exact(c, 5)
                n, tag = struct.unpack("<IB", head)
                got.extend(head + (recv_exact(c, n) if n else b""))
                if tag == 0x03:
                    break
            c.sendall(reply)
        srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv.getsockname()[1], got, t


def _point_at(client, port):
    client._np_probed, client._np_port, client._np_uds = True, port, None
    if hasattr(client, "_np_enabled"):
        client._np_enabled = True
    return client


def _status(body: bytes = b"{}") -> bytes:
    return struct.pack("<IB", len(body), 0x81) + body


def test_frames_equal_the_reference_clients():
    """The port's write and read requests are byte for byte the reference
    client's, and both equal frames built from the reference's _FRAME,
    _CHUNK_HDR and _rchunk_body."""
    data = _payload(10, 40_000)
    cks = Checksum(ChecksumType.CRC32C, BPC)
    jck = j_checksum.Checksum(j_checksum.ChecksumType.CRC32C, BPC)
    split = [(0, 32_768), (32_768, 40_000 - 32_768)]
    infos = [ChunkInfo(f"c{j}", o, n, cks.compute(data[o:o + n]))
             for j, (o, n) in enumerate(split)]
    jinfos = [j_ids.ChunkInfo(f"c{j}", o, n, jck.compute(data[o:o + n]))
              for j, (o, n) in enumerate(split)]
    bid, jbid = BlockID(3, 9), j_ids.BlockID(3, 9)
    pairs = [(i, data[o:o + n]) for i, (o, n) in zip(infos, split)]
    jpairs = [(i, data[o:o + n]) for i, (o, n) in zip(jinfos, split)]

    def capture(make, call, reply):
        port, got, t = _fake_sidecar(reply)
        c = _point_at(make(), port)
        try:
            out = call(c)
        finally:
            t.join(10)
            c.close()
        return bytes(got), out

    writes = []
    for make, p, b, mk_bd in (
            (lambda: NativeDatanodeClient("dn0", "127.0.0.1:1"), pairs, bid,
             BlockData),
            (lambda: j_native_dn.NativeDatanodeClient("dn0", "127.0.0.1:1"),
             jpairs, jbid, j_ids.BlockData)):
        writes.append(capture(make, lambda c: c.write_chunks_commit(
            b, p, commit=mk_bd(b, [i for i, _ in p]), sync=True, writer="w"),
            _status())[0])
    assert writes[0] == writes[1]
    F, H = j_native_dn._FRAME, j_native_dn._CHUNK_HDR
    hdr = json.dumps({"op": "write", "block_id": jbid.to_json(), "sync": True,
                      "writer": "w",
                      "commit": j_ids.BlockData(jbid, jinfos).to_json()},
                     separators=(",", ":")).encode()
    assert writes[0] == F.pack(len(hdr), 0x01) + hdr + b"".join(
        F.pack(12 + n, 0x02) + H.pack(o, n) + data[o:o + n].tobytes()
        for o, n in split) + F.pack(1, 0x03) + b"\x01"

    reply = b"".join(struct.pack("<IB", n, 0x82) + data[o:o + n].tobytes()
                     for o, n in split) + _status()
    reads = []
    for make, ii, b in (
            (lambda: NativeDatanodeClient("dn0", "127.0.0.1:1"), infos, bid),
            (lambda: j_native_dn.NativeDatanodeClient("dn0", "127.0.0.1:1"),
             jinfos, jbid)):
        got, out = capture(make, lambda c: c.read_chunks(b, ii, verify=True),
                           reply)
        assert [o.tobytes() for o in out] == [d.tobytes() for _, d in pairs]
        reads.append(got)
    assert reads[0] == reads[1]
    rhdr = b'{"op":"read","block_id":{"container_id":3,"local_id":9}}'
    want = F.pack(len(rhdr), 0x05) + rhdr + b"".join(
        F.pack(len(r), 0x06) + r
        for r in (j_native_dn._rchunk_body(i, True) for i in jinfos)
    ) + F.pack(0, 0x03)
    assert reads[0] == want


# ---------------------------------------------- no quiet RPC-only daemon
def test_daemon_raises_when_the_library_cannot_be_built(tmp_path, monkeypatch):
    def broken(name):
        raise RuntimeError(f"compiling csrc/{name} failed")

    monkeypatch.setattr(fast_datapath, "_lib", None)
    monkeypatch.setattr(fast_datapath.cuda_build, "load", broken)
    with pytest.raises(StorageError) as ei:
        daemons.DatanodeDaemon(tmp_path / "dn", "dn0", "127.0.0.1:1",
                               device="cpu")
    assert ei.value.code == fast_datapath.NATIVE_DATAPATH_UNAVAILABLE


def test_sidecar_raises_when_it_cannot_bind(tmp_path):
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    dn = Datanode(tmp_path / "dn", dn_id="dn0")
    try:
        with pytest.raises(StorageError) as ei:
            DatapathSidecar(dn, port=taken.getsockname()[1]).start()
        assert ei.value.code == fast_datapath.NATIVE_DATAPATH_UNAVAILABLE
    finally:
        taken.close()
        dn.close()


def test_daemon_advertises_its_sidecar_unless_turned_off(tmp_path, monkeypatch):
    d = daemons.DatanodeDaemon(tmp_path / "a", "dn0", "127.0.0.1:1",
                               device="cpu")
    d.server.start()
    try:
        lane = d.advertise()
        assert lane["port"] > 0 and lane["uds"].startswith("@ozone-dp.")
        assert RpcDatanodeClient("dn0", d.address)._call(
            "GetDatapathInfo", {})[0] == lane
    finally:
        d.server.stop()
        d.stop_datapath()
        d.dn.close()
    monkeypatch.setenv("OZONE_TPU_NATIVE_DATAPATH", "0")
    d = daemons.DatanodeDaemon(tmp_path / "b", "dn1", "127.0.0.1:1",
                               device="cpu")
    try:
        assert d.datapath is None and d.advertise() is None
    finally:
        d.server.stop()
        d.dn.close()
