"""The port's EC key write against `ozone_tpu`'s, end to end on the CPU.

The same keys go through the port's ECKeyWriter into port Datanodes and
through the JAX ECKeyWriter (direct dispatch) into JAX Datanodes, with the
same naive group allocator. The returned groups, every stored chunk's
bytes and every stored ChecksumData must be equal.
"""

import itertools

import numpy as np
import pytest

from ozone_tpu.client import dn_client as j_dn_client
from ozone_tpu.client import ec_writer as j_ec_writer
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.scm import pipeline as j_pipeline
from ozone_tpu.storage import datanode as j_datanode
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.utils.checksum import Checksum as JChecksum
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch.client import dn_client, ec_writer
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.scm import pipeline
from ozone_tpu_torch.storage import datanode
from ozone_tpu_torch.storage.ids import StorageError

CELL = 4096
K, P = 3, 2
N_DN = 6


class MiniEC:
    """n datanodes of one implementation + a naive group allocator."""

    def __init__(self, root, mods, opts, n_dn=N_DN):
        dn_mod, client_mod, pipe_mod, writer_mod = mods
        self.opts, self.pipe_mod, self.writer_mod = opts, pipe_mod, writer_mod
        self.dns = [dn_mod.Datanode(root / f"dn{i}", dn_id=f"dn{i}")
                    for i in range(n_dn)]
        self.clients = client_mod.DatanodeClientFactory()
        for dn in self.dns:
            self.clients.register_local(dn)
        self._cid = itertools.count(1)
        self._lid = itertools.count(1)

    def allocate(self, excluded):
        n = self.opts.all_units
        nodes = [d.id for d in self.dns if d.id not in excluded][:n]
        if len(nodes) < n:
            raise RuntimeError("not enough nodes")
        return self.writer_mod.BlockGroup(
            container_id=next(self._cid), local_id=next(self._lid),
            pipeline=self.pipe_mod.Pipeline(
                self.pipe_mod.ReplicationConfig.from_ec(self.opts), nodes))

    def write(self, data, **kw):
        w = self.writer_mod.ECKeyWriter(
            self.opts, self.allocate, self.clients, block_size=4 * CELL,
            bytes_per_checksum=1024, stripe_batch=3, **kw)
        rng = np.random.default_rng(123)  # uneven pieces exercise buffering
        pos = 0
        while pos < data.size:
            n = min(int(rng.integers(1, 3 * CELL)), data.size - pos)
            w.write(data[pos:pos + n])
            pos += n
        groups = w.close()
        assert w.bytes_written == data.size
        return groups

    def stored(self, groups):
        """[(group identity, [(unit, chunk json, bytes)])] as stored."""
        out = []
        for g in groups:
            units = []
            for u, dn_id in enumerate(g.pipeline.nodes):
                dn = self.dns[int(dn_id[2:])]
                try:
                    block = dn.get_block(g.block_id)
                except (StorageError, JStorageError):
                    continue
                for info in block.chunks:
                    units.append((u, info.to_json(),
                                  dn.read_chunk(g.block_id, info, verify=True)
                                  .tobytes()))
            out.append(((g.container_id, g.local_id, g.length,
                         list(g.pipeline.nodes)), units))
        return out

    def close(self):
        for d in self.dns:
            d.close()


@pytest.fixture
def clusters(tmp_path, monkeypatch):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")  # JAX direct dispatch
    port = MiniEC(tmp_path / "port", (datanode, dn_client, pipeline, ec_writer),
                  CoderOptions(K, P, "rs", cell_size=CELL))
    ref = MiniEC(tmp_path / "ref",
                 (j_datanode, j_dn_client, j_pipeline, j_ec_writer),
                 JOptions(K, P, "rs", cell_size=CELL))
    yield port, ref
    port.close()
    ref.close()


@pytest.mark.parametrize("size", [
    0,
    1,
    CELL - 1,  # partial cell: host CRC
    K * CELL + 1,  # one stripe + 1
    4 * K * CELL * 2 + 5 * CELL + 77,  # more than one block group
])
def test_key_write_matches_reference(clusters, size):
    port, ref = clusters
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)
    groups = port.write(data, device="cpu")
    jgroups = ref.write(data)
    assert [g.length for g in groups] == [g.length for g in jgroups]
    assert sum(g.length for g in groups) == size
    assert port.stored(groups) == ref.stored(jgroups)
    # the data units hold the key's bytes in stripe order
    got = bytearray()
    for g in groups:
        per_unit = [b"".join(c for u2, _, c in port.stored([g])[0][1] if u2 == u)
                    for u in range(K)]
        for s in range(-(-g.length // (K * CELL))):
            for u in range(K):
                got += per_unit[u][s * CELL:(s + 1) * CELL]
    assert bytes(got) == data.tobytes()


def test_failed_node_replays_like_reference(clusters):
    """A member that fails every chunk write is excluded and the run
    replays into a fresh group, in both writers alike."""
    port, ref = clusters
    for c in (port, ref):
        client = c.clients.get("dn1")
        err = StorageError if c is port else JStorageError

        def refuse(*a, _err=err, **kw):
            raise _err("IO_EXCEPTION", "disk gone")

        client.write_chunk = refuse
    data = np.random.default_rng(7).integers(0, 256, 5 * K * CELL + 9,
                                             dtype=np.uint8)
    groups = port.write(data, device="cpu")
    jgroups = ref.write(data)
    assert all("dn1" not in g.pipeline.nodes for g in groups)
    assert [g.length for g in groups] == [g.length for g in jgroups]
    assert port.stored(groups) == ref.stored(jgroups)


def test_writer_rejects_hsync_and_bad_block_size(clusters):
    port, _ = clusters
    w = ec_writer.ECKeyWriter(port.opts, port.allocate, port.clients,
                              block_size=4 * CELL, device="cpu")
    with pytest.raises(StorageError):
        w.hsync()
    with pytest.raises(ValueError):
        ec_writer.ECKeyWriter(port.opts, port.allocate, port.clients,
                              block_size=CELL + 1, device="cpu")


@pytest.mark.parametrize("size,expect", [
    (0, [0, 0, 0]), (CELL + 5, [CELL, 5, 0]), (7 * CELL, [3 * CELL, 2 * CELL, 2 * CELL]),
])
def test_block_and_cell_lengths(size, expect):
    assert ec_writer.block_lengths(size, K, CELL) == expect
    assert ec_writer.block_lengths(size, K, CELL) == \
        j_ec_writer.block_lengths(size, K, CELL)
    for s in range(3):
        assert ec_writer.cell_lengths(size, s, K, CELL) == \
            j_ec_writer.cell_lengths(size, s, K, CELL)


def test_dispatch_spans_and_closed_container(clusters):
    """One codec:device_dispatch span per writer dispatch; a container
    closed under the writer is a reallocation signal, not a node fault."""
    from ozone_tpu_torch.utils.tracing import Tracer

    port, _ = clusters
    before = len(Tracer.instance().traces("codec:device_dispatch"))
    w = ec_writer.ECKeyWriter(port.opts, port.allocate, port.clients,
                              block_size=4 * CELL, bytes_per_checksum=1024,
                              stripe_batch=2, device="cpu")
    data = np.random.default_rng(3).integers(0, 256, 6 * K * CELL, dtype=np.uint8)
    w.write(data[:2 * K * CELL])  # one dispatch, held in flight
    first = w._pending[0]
    w.write(data[2 * K * CELL:4 * K * CELL])  # writes the first batch
    port.dns[0].close_container(w._group.container_id)
    w.write(data[4 * K * CELL:])
    groups = w.close()
    assert first[0].index == 0
    assert w.dispatches == 3
    assert len(Tracer.instance().traces("codec:device_dispatch")) - before == 3
    assert sum(g.length for g in groups) == data.size
    assert len({g.container_id for g in groups}) == len(groups) >= 2
    assert all("dn0" in g.pipeline.nodes for g in groups)  # not excluded


@pytest.mark.parametrize("batched", [True, False])
def test_write_unit_batched_and_stream(tmp_path, batched):
    """The unit helpers land the same chunks through the batched verb and,
    for a client without it, through per-chunk verbs."""
    from ozone_tpu_torch.storage.ids import BlockData, BlockID
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    dn = datanode.Datanode(tmp_path / "dn", dn_id="dn0")
    client = dn_client.LocalDatanodeClient(dn)
    if not batched:
        def refuse(*a, **kw):
            raise StorageError("IO_EXCEPTION", "UNIMPLEMENTED: no batched verb")

        client.write_chunks_commit = refuse
    dn.create_container(1)
    bid = BlockID(1, 1)
    cells = np.random.default_rng(5).integers(0, 256, (3, CELL), dtype=np.uint8)
    host = Checksum(ChecksumType.CRC32C, 1024)
    crcs = np.array([[int.from_bytes(c, "big") for c in host.compute(row).checksums]
                     for row in cells], dtype=np.uint32)
    pairs = dn_client.build_chunk_pairs(bid, [0, 1, 2], cells, crcs,
                                        2 * CELL + 100, CELL, 1024,
                                        ChecksumType.CRC32C, host)
    assert [p[0].length for p in pairs] == [CELL, CELL, 100]
    dn_client.write_unit_stream(client, bid, pairs[:1])
    dn_client.write_unit_batched(client, bid, pairs[1:],
                                 BlockData(bid, [p[0] for p in pairs]))
    for info, data in pairs:
        assert np.array_equal(dn.read_chunk(bid, info, verify=True), data)
    assert [c.length for c in dn.get_block(bid).chunks] == [CELL, CELL, 100]
    assert getattr(client, "_stream_downgraded", False) is not batched
    jpairs = j_dn_client.build_chunk_pairs(
        bid, [0, 1, 2], cells, crcs, 2 * CELL + 100, CELL, 1024,
        JChecksumType.CRC32C, JChecksum(JChecksumType.CRC32C, 1024))
    assert [p[0].to_json() for p in pairs] == [p[0].to_json() for p in jpairs]
    dn.close()
