"""The port's offline reconstruction against `ozone_tpu`'s, on the CPU.

The cases of tests/test_reconstruction.py, on the dual cluster of
test_torch_ec_write.py with two spare datanodes: lost replicas are
rebuilt onto the spares by each implementation's coordinator, and the
rebuilt chunks (bytes and ChecksumData) must be equal between the two
and to the lost unit's source chunks; the targets are CLOSED with the
lost replica index, and the key reads back through them.
"""

import contextlib

import numpy as np
import pytest

from ozone_tpu.client import dn_client as j_dn_client
from ozone_tpu.client import ec_reader as j_ec_reader
from ozone_tpu.client import ec_writer as j_ec_writer
from ozone_tpu.client.resilience import HealthRegistry as JHealthRegistry
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.scm import pipeline as j_pipeline
from ozone_tpu.storage import datanode as j_datanode
from ozone_tpu.storage import reconstruction as j_reconstruction
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu_torch.client import dn_client, ec_reader, ec_writer
from ozone_tpu_torch.client.resilience import HealthRegistry
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.scm import pipeline
from ozone_tpu_torch.storage import datanode, reconstruction
from ozone_tpu_torch.storage.ids import ContainerState, StorageError
from tests.test_torch_ec_write import CELL, K, P, MiniEC

SPARES = ["dn5", "dn6"]


@pytest.fixture
def wide(tmp_path, monkeypatch):
    """Port and JAX clusters of seven datanodes: five for the group, two
    spares; decode batches of 3 stripes."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    monkeypatch.setenv("OZONE_TPU_DECODE_BATCH", "3")
    port = MiniEC(tmp_path / "port", (datanode, dn_client, pipeline, ec_writer),
                  CoderOptions(K, P, "rs", cell_size=CELL), n_dn=7)
    ref = MiniEC(tmp_path / "ref",
                 (j_datanode, j_dn_client, j_pipeline, j_ec_writer),
                 JOptions(K, P, "rs", cell_size=CELL), n_dn=7)
    yield port, ref
    port.close()
    ref.close()


def _write(port, ref, size, seed):
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8)
    g, jg = port.write(data, device="cpu")[0], ref.write(data)[0]
    return data, g, jg


def _reconstruct(cluster, mod, group, lost, **kw):
    """Drop the lost units' replicas, rebuild them onto the spares."""
    for u in lost:
        cluster.dns[int(group.pipeline.nodes[u][2:])].delete_container(
            group.container_id, force=True)
    sources = {u + 1: group.pipeline.nodes[u]
               for u in range(cluster.opts.all_units) if u not in lost}
    targets = {u + 1: dn for u, dn in zip(lost, SPARES)}
    cmd = mod.ReconstructionCommand(group.container_id, cluster.opts,
                                    sources, targets)
    coord = mod.ECReconstructionCoordinator(cluster.clients,
                                            bytes_per_checksum=1024, **kw)
    coord.reconstruct_container_group(cmd)
    return coord


def _rebuilt(cluster, group, lost):
    """[(replica index, state, [(chunk json, bytes)])] on the spares."""
    out = []
    for u, dn_id in zip(lost, SPARES):
        dn = cluster.dns[int(dn_id[2:])]
        c = dn.containers.get(group.container_id)
        blk = dn.get_block(group.block_id)
        assert blk.block_group_length == group.length
        out.append((c.replica_index, c.state.value,
                    [(i.to_json(), dn.read_chunk(group.block_id, i,
                                                 verify=True).tobytes())
                     for i in blk.chunks]))
    return out


@pytest.mark.parametrize("lost,size", [
    ([1], 7 * CELL + 123),  # a data unit, partial tail chunk
    ([0, 4], 6 * CELL),  # one data unit, one parity unit
    ([2, 3], 4 * K * CELL),  # a full group: two pipelined batches
])
def test_reconstruction_matches_reference(wide, lost, size):
    port, ref = wide
    data, g, jg = _write(port, ref, size, seed=len(lost) + size)
    source = [[(i.to_json(), port.dns[int(g.pipeline.nodes[u][2:])]
                .read_chunk(g.block_id, i).tobytes())
               for i in port.dns[int(g.pipeline.nodes[u][2:])]
               .get_block(g.block_id).chunks] for u in lost]
    coord = _reconstruct(port, reconstruction, g, lost, device="cpu")
    _reconstruct(ref, j_reconstruction, jg, lost)
    got = _rebuilt(port, g, lost)
    assert got == _rebuilt(ref, jg, lost)
    for (index, state, chunks), u, src in zip(got, lost, source):
        assert (index, state) == (u + 1, ContainerState.CLOSED.value)
        assert [c[1] for c in chunks] == [c[1] for c in src]  # bytes
        assert [c[0]["checksum"] for c in chunks] == \
            [c[0]["checksum"] for c in src]
    stripes = -(-g.length // (K * CELL))
    assert coord.metrics.counter("decode_dispatches").value == -(-stripes // 3)
    # the key reads back through the rebuilt replicas, with as many other
    # units taken out as the code allows
    extra = [u for u in range(K + P) if u not in lost][:P - len(lost)]
    for u in extra:
        port.dns[int(g.pipeline.nodes[u][2:])].delete_container(
            g.container_id, force=True)
    for u, dn_id in zip(lost, SPARES):
        g.pipeline.nodes[u] = dn_id
    reader = ec_reader.ECBlockGroupReader(g, port.opts, port.clients,
                                          bytes_per_checksum=1024, device="cpu")
    assert np.array_equal(reader.read_all(), data[:g.length])
    assert j_ec_reader.unit_true_lengths(jg, ref.opts) == \
        ec_reader.unit_true_lengths(g, port.opts)


def test_reconstruction_failure_cleans_up(wide):
    """A source failing mid-repair fails the job, and the RECOVERING
    target containers are deleted, in both."""
    port, ref = wide
    _data, g, jg = _write(port, ref, 4 * K * CELL, seed=2)
    for c, grp, mod, err, kw in ((port, g, reconstruction, StorageError,
                                  {"device": "cpu"}),
                                 (ref, jg, j_reconstruction, JStorageError, {})):
        client = c.clients.get(grp.pipeline.nodes[2])

        def broken(*a, _err=err, **kw2):
            raise _err("CHECKSUM_MISMATCH", "corrupt replica")

        client.read_chunk = broken
        # units 0 and 1 lost and unit 2 unreadable: fewer than k left
        with pytest.raises(Exception):
            _reconstruct(c, mod, grp, [0, 1], **kw)
        for dn_id in SPARES:
            with pytest.raises((StorageError, JStorageError)):
                c.dns[int(dn_id[2:])].containers.get(grp.container_id)


def test_coordinator_lists_blocks_from_a_healthy_source(wide):
    """Block listing skips a source that cannot answer."""
    port, ref = wide
    data, g, _jg = _write(port, ref, 2 * K * CELL + 5, seed=4)
    client = port.clients.get(g.pipeline.nodes[1])

    def down(*a, **kw):
        raise StorageError("UNAVAILABLE", "node down")

    client.list_blocks = down
    _reconstruct(port, reconstruction, g, [0], device="cpu")
    g.pipeline.nodes[0] = SPARES[0]
    reader = ec_reader.ECBlockGroupReader(g, port.opts, port.clients,
                                          bytes_per_checksum=1024, device="cpu")
    assert np.array_equal(reader.read_all(), data[:g.length])


@pytest.mark.parametrize("lost", [[0, 3], [0, 1]])
def test_short_group_rebuilds_from_known_zero_units(wide, lost):
    """A group shorter than a stripe: unit 2 holds no bytes, so the writer
    made no block for it. The port rebuilds the lost units from the other
    survivors and the known-zero unit 2, and lists the container's blocks
    from every source, so the empty unit 2 listing first hides no block.
    The reference rebuilds no block: with units 0 and 3 lost it counts
    unit 2 as unreachable and fails the job (cleaning up its targets);
    with units 0 and 1 lost it lists from unit 2 only and finds nothing."""
    port, ref = wide
    data, g, jg = _write(port, ref, CELL + 77, seed=5)
    # no latency history: the sources list in replica-index order
    port.clients.health, ref.clients.health = HealthRegistry(), JHealthRegistry()
    source = []
    for u in lost:
        dn = port.dns[int(g.pipeline.nodes[u][2:])]
        source.append(dn.read_chunk(g.block_id, dn.get_block(g.block_id).chunks[0]))
    _reconstruct(port, reconstruction, g, lost, device="cpu")
    with contextlib.suppress(j_ec_reader.InsufficientLocationsError):
        _reconstruct(ref, j_reconstruction, jg, lost)
    for dn_id in SPARES:
        with pytest.raises(JStorageError):
            ref.dns[int(dn_id[2:])].get_block(jg.block_id)
    for (index, state, chunks), u, src in zip(_rebuilt(port, g, lost), lost, source):
        assert (index, state) == (u + 1, ContainerState.CLOSED.value)
        assert [c[1] for c in chunks] == [src.tobytes()]
    for u, dn_id in zip(lost, SPARES):
        g.pipeline.nodes[u] = dn_id
    reader = ec_reader.ECBlockGroupReader(g, port.opts, port.clients,
                                          bytes_per_checksum=1024, device="cpu")
    assert np.array_equal(reader.read_all(), data)
