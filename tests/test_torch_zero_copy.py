"""Zero-copy datapath invariants of the port, on the CPU.

Mirrors tests/test_zero_copy.py on `ozone_tpu_torch/codec/hostmem.py`
and the native lane (`client/native_dn.py` over `storage/fast_datapath.py`),
through the process-wide `datapath` registry:

1. at most one host copy per chunk per direction on PUT and GET over the
   native lane, for the client's verbs and for an EC key written and read
   through daemons;
2. byte-exactness through recycled pool slabs, with refused requests in
   between;
3. leases go back to the pool after a mid-stream error, and the pool's
   high-water mark stays on its plateau over repeated GETs.

The pool's size classes and `as_array` are held equal to
`ozone_tpu.codec.hostmem` on the same inputs.
"""

import gc
import time

import numpy as np
import pytest
import torch

from ozone_tpu.codec import hostmem as j_hostmem
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.native_dn import NativeDatanodeClient
from ozone_tpu_torch.client.ozone_client import OzoneClient
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
from ozone_tpu_torch.net.dn_service import DatanodeRpcService
from ozone_tpu_torch.net.om_service import RemoteOmClient
from ozone_tpu_torch.net.rpc import RpcServer
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.fast_datapath import (
    DatapathSidecar,
    load_lib,
    native_pool_stats,
)
from ozone_tpu_torch.storage.ids import BlockData, BlockID, ChunkInfo, StorageError
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType


@pytest.fixture()
def cluster(tmp_path):
    dn = Datanode(tmp_path / "dn", dn_id="dn0")
    dn.create_container(1)
    server = RpcServer()
    sidecar = DatapathSidecar(dn)
    sidecar.start()
    DatanodeRpcService(dn, server, datapath_port=sidecar.advertise)
    server.start()
    client = NativeDatanodeClient("dn0", server.address)
    yield dn, client
    client.close()
    sidecar.stop()
    server.stop()
    dn.close()


def _chunks(seed: int, n_chunks: int, size: int):
    rng = np.random.default_rng(seed)
    cs = Checksum(ChecksumType.CRC32C, 16 * 1024)
    infos, datas = [], []
    for j in range(n_chunks):
        d = rng.integers(0, 256, size, dtype=np.uint8)
        infos.append(ChunkInfo(f"c{j}", j * size, size, cs.compute(d)))
        datas.append(d)
    return infos, datas


class _CopyMeter:
    """Deltas of the datapath registry across a with-block."""

    NAMES = ("copies", "bytes_copied", "bytes_moved", "native_fallbacks")

    def __enter__(self):
        self._v0 = {n: hostmem.METRICS.counter(n).value for n in self.NAMES}
        return self

    def __exit__(self, *exc):
        for n in self.NAMES:
            setattr(self, n, hostmem.METRICS.counter(n).value - self._v0[n])


def _drain_leases():
    """Collect dropped views so their finalizers return their leases."""
    gc.collect()


# ------------------------------------------------ copies per chunk (the bar)
def test_put_host_copies_per_chunk_at_most_one(cluster):
    _, client = cluster
    n_chunks, size = 8, 256 * 1024
    infos, datas = _chunks(1, n_chunks, size)
    bid = BlockID(1, 1)
    with _CopyMeter() as m:
        client.write_chunks_commit(bid, list(zip(infos, datas)),
                                   commit=BlockData(bid, infos), sync=True)
    assert m.copies <= n_chunks
    assert m.bytes_moved == n_chunks * size
    assert m.bytes_copied <= n_chunks * size
    assert m.native_fallbacks == 0


def test_get_host_copies_per_chunk_at_most_one(cluster):
    _, client = cluster
    n_chunks, size = 8, 256 * 1024
    infos, datas = _chunks(2, n_chunks, size)
    bid = BlockID(1, 2)
    client.write_chunks_commit(bid, list(zip(infos, datas)),
                               commit=BlockData(bid, infos))
    with _CopyMeter() as m:
        out = client.read_chunks(bid, infos, verify=True)
    assert m.copies <= n_chunks
    assert m.bytes_moved == n_chunks * size
    assert m.native_fallbacks == 0
    for got, want in zip(out, datas):
        np.testing.assert_array_equal(got, want)


def test_ec_key_through_daemons_copies_per_chunk(tmp_path, monkeypatch):
    """An rs-3-2-4096 key PUT and GET through five datanode daemons: every
    chunk byte, parity included, moves over the native lane, with at most
    one host copy per chunk per direction and no fallback."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    meta = ScmOmDaemon(tmp_path / "om.db", block_size=16 * 4096,
                       container_size=1024 * 1024, stale_after_s=1000.0,
                       dead_after_s=2000.0, background_interval_s=0.2)
    meta.start()
    dns = [DatanodeDaemon(tmp_path / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.1, device="cpu")
           for i in range(5)]
    clients = DatanodeClientFactory()
    om = RemoteOmClient(meta.address, clients=clients)
    try:
        for d in dns:
            d.start()
        t_end = time.monotonic() + 20
        while len(meta.scm.nodes.healthy_in_service()) < 5:
            assert time.monotonic() < t_end, "datanodes did not register"
            time.sleep(0.05)
        bucket = OzoneClient(om, clients, device="cpu").create_volume(
            "v").create_bucket("b", replication="rs-3-2-4096")
        data = np.random.default_rng(3).integers(0, 256, 3 * 4096 * 20,
                                                 dtype=np.uint8)
        chunks = 5 * 20  # 20 full stripes, k + p = 5 cells each
        with _CopyMeter() as put:
            bucket.write_key("k", data)
        with _CopyMeter() as get:
            got = bucket.read_key("k")
        np.testing.assert_array_equal(got, data)
        assert put.bytes_moved == 5 * data.size // 3
        assert put.copies <= chunks and put.native_fallbacks == 0
        assert get.bytes_moved >= data.size
        assert get.copies <= chunks and get.native_fallbacks == 0
        assert sum(d.dn.metrics.counter("batched_write_streams").value
                   for d in dns) > 0
    finally:
        om.close()
        clients.close()
        for d in dns:
            d.stop()
        meta.stop()
        torch.set_num_threads(n_threads)


# ------------------------------------------- byte-exactness under reuse
def test_pooled_reuse_byte_exact_with_refusals(cluster):
    """PUT and GET through recycled slabs at odd sizes, with refused
    requests in between: a reused buffer never leaks an earlier request's
    bytes, and every lease goes home."""
    _, client = cluster
    rng = np.random.default_rng(3)
    cs = Checksum(ChecksumType.CRC32C, 16 * 1024)
    _drain_leases()
    base = hostmem.pool().stats()["leased_count"]
    for i in range(40):
        n = int(rng.integers(1, 96)) * 1024 + int(rng.integers(0, 17))
        data = rng.integers(0, 256, n, dtype=np.uint8)
        info = ChunkInfo("c0", 0, n, cs.compute(data))
        bid = BlockID(1, 100 + i)
        client.write_chunks_commit(bid, [(info, data)], writer="w",
                                   commit=BlockData(bid, [info]))
        if i % 9 == 4:
            with pytest.raises(StorageError):  # fenced: another writer
                client.write_chunks_commit(bid, [(info, data)], writer="x")
            with pytest.raises(StorageError):  # no such container
                client.read_chunks(BlockID(99, 1), [info])
        got = client.read_chunks(bid, [info], verify=True)[0]
        np.testing.assert_array_equal(got, data)
        del got
    _drain_leases()
    assert hostmem.pool().stats()["leased_count"] == base


# --------------------------------------------------- lease return paths
def test_midstream_error_returns_leases_to_pool(cluster):
    """A CHECKSUM_MISMATCH halfway through a batched read ends the stream;
    the slab and every view handed out before it go back to the pool."""
    dn, client = cluster
    n_chunks, size = 4, 64 * 1024
    infos, datas = _chunks(4, n_chunks, size)
    bid = BlockID(1, 200)
    client.write_chunks_commit(bid, list(zip(infos, datas)),
                               commit=BlockData(bid, infos))
    path = dn.containers.get(1).chunks.block_path(bid)
    raw = bytearray(path.read_bytes())
    raw[2 * size + 17] ^= 0xFF
    path.write_bytes(bytes(raw))
    _drain_leases()
    base = hostmem.pool().stats()["leased_count"]
    with pytest.raises(StorageError) as ei:
        client.read_chunks(bid, infos, verify=True)
    assert ei.value.code == "CHECKSUM_MISMATCH"
    _drain_leases()
    assert hostmem.pool().stats()["leased_count"] == base


def test_pool_high_water_stable_over_repeated_gets(cluster):
    """300 GETs through the pooled read path leave the pool's high-water
    mark on its plateau, and every lease back on the free lists."""
    _, client = cluster
    infos, datas = _chunks(5, 1, 64 * 1024)
    bid = BlockID(1, 300)
    client.write_chunks_commit(bid, list(zip(infos, datas)),
                               commit=BlockData(bid, infos))
    for _ in range(20):  # reach the plateau
        client.read_chunks(bid, infos, verify=True)
    _drain_leases()
    plateau = hostmem.pool().stats()
    for _ in range(300):
        out = client.read_chunks(bid, infos, verify=True)
        del out
    _drain_leases()
    end = hostmem.pool().stats()
    assert end["high_water_bytes"] == plateau["high_water_bytes"]
    assert end["leased_count"] == plateau["leased_count"]
    np.testing.assert_array_equal(
        client.read_chunks(bid, infos, verify=True)[0], datas[0])


def test_native_arena_capsule_roundtrip():
    """The C++ arena's capsule API: lease, retain and release show in
    dp_pool_stat, and the buffer recycles."""
    lib = load_lib()
    s0 = native_pool_stats()
    buf = lib.dp_buf_lease(100 * 1024)
    assert buf
    assert lib.dp_buf_cap(buf) == 128 * 1024
    assert lib.dp_buf_data(buf) % 4096 == 0  # page-aligned
    s1 = native_pool_stats()
    assert s1["leased_bytes"] == s0["leased_bytes"] + 128 * 1024
    lib.dp_buf_retain(buf)
    lib.dp_buf_release(buf)
    assert native_pool_stats()["leased_bytes"] == s1["leased_bytes"]
    lib.dp_buf_release(buf)
    s3 = native_pool_stats()
    assert s3["leased_bytes"] == s0["leased_bytes"]
    assert s3["high_water_bytes"] >= s1["leased_bytes"]


# ------------------------------------------------- hostmem unit surface
def test_pool_size_classes_and_reuse():
    p = hostmem.HostBufferPool(max_retained=1 << 20, max_class=1 << 18,
                               min_class=4096)
    a = p.lease(5000)
    assert a.cap == 8192  # the next power-of-two class
    mm = a._mm
    a.release()
    b = p.lease(6000)
    assert b._mm is mm, "a freed buffer of the same class is reused"
    b.release()
    assert p.stats()["leased_count"] == 0
    big = p.lease((1 << 18) + 1)  # above max_class: transient
    big.release()
    assert p.stats()["free_bytes"] <= 1 << 20
    p.trim()
    assert p.stats()["free_bytes"] == 0


@pytest.mark.parametrize("sizes", [
    [0, 1, 4096, 4097, 5000, 65536, 1 << 18, (1 << 18) + 1, 3 << 20],
    [100, 100, 9000, 9000, 70000],
])
def test_pool_classes_and_stats_equal_the_reference(sizes):
    """The same leases and releases give the same capacities and stats as
    `ozone_tpu.codec.hostmem.HostBufferPool`."""
    kw = dict(max_retained=1 << 20, max_class=1 << 18, min_class=4096)
    pools = (hostmem.HostBufferPool(**kw), j_hostmem.HostBufferPool(**kw))
    leases = [[p.lease(n) for n in sizes] for p in pools]
    assert [x.cap for x in leases[0]] == [x.cap for x in leases[1]]
    assert pools[0].stats() == pools[1].stats()
    for ls in leases:
        for x in ls[::2]:
            x.release()
    assert pools[0].stats() == pools[1].stats()
    for ls in leases:
        for x in ls[1::2]:
            x.release()
    assert pools[0].stats() == pools[1].stats()


def test_lease_refcount_pins_arrays():
    p = hostmem.HostBufferPool(max_retained=1 << 20)
    lease = p.lease(4096)
    lease.view[:4] = b"abcd"
    arr = lease.array(length=4)
    lease.release()  # the creator's reference is gone; the array pins it
    assert p.stats()["leased_count"] == 1
    assert arr.tobytes() == b"abcd"
    del arr
    gc.collect()
    assert p.stats()["leased_count"] == 0
    with pytest.raises(RuntimeError):
        lease.release()


def test_as_array_zero_copy_and_counted_fallback():
    c0 = hostmem.METRICS.counter("copies").value
    raw = bytearray(b"\x01\x02\x03\x04")
    v = hostmem.as_array(raw)
    assert hostmem.METRICS.counter("copies").value == c0
    raw[0] = 9
    assert v[0] == 9, "as_array aliases its source"
    arr = np.arange(16, dtype=np.uint8).reshape(4, 4)[:, ::2]
    flat = hostmem.as_array(arr)  # non-contiguous: one counted copy
    assert hostmem.METRICS.counter("copies").value == c0 + 1
    assert flat.size == arr.size


@pytest.mark.parametrize("make", [
    lambda: b"\x00\x01\xfe\xff" * 9,
    lambda: bytearray(range(256)),
    lambda: memoryview(bytes(range(200)))[10:150],
    lambda: np.arange(64, dtype=np.uint8),
    lambda: np.arange(64, dtype=np.uint8).reshape(8, 8).T,
    lambda: np.arange(48, dtype=np.uint16),
    lambda: memoryview(np.arange(32, dtype=np.uint8).reshape(4, 8)[:, ::2]),
])
def test_as_array_equals_the_reference(make):
    ours, ref = hostmem.as_array(make()), j_hostmem.as_array(make())
    assert ours.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


def test_copy_ratio_gauge_tracks_registry():
    hostmem.count_move(1000)
    moved = hostmem.METRICS.counter("bytes_moved").value
    copied = hostmem.METRICS.counter("bytes_copied").value
    assert abs(hostmem.METRICS.gauge("copy_ratio").value
               - copied / moved) < 1e-9


def test_to_device_on_the_cpu():
    moved = hostmem.METRICS.counter("bytes_moved").value
    data = np.arange(8192, dtype=np.uint8)
    t = hostmem.to_device(data, "cpu")
    assert t.dtype == torch.uint8 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), data)
    assert hostmem.METRICS.counter("bytes_moved").value == moved + 8192
    t2 = hostmem.to_device(bytes(range(256)), torch.device("cpu"))
    assert t2.tolist() == list(range(256))
