"""The port's EC reads against `ozone_tpu`'s, end to end on the CPU.

The same keys go through each implementation's writer into its own
datanodes (the dual cluster of test_torch_ec_write.py). The port's
ECBlockGroupReader (device="cpu": the kernel's plain version) and the JAX
reader (per-operation pipeline, codec service off) must return the same
bytes, equal to the source: whole and ranged, healthy and degraded, and
under a unit failing mid-read or straggling past its hedge delay.
"""

import threading

import numpy as np
import pytest

from ozone_tpu.client import ec_reader as j_ec_reader
from ozone_tpu.client.resilience import HealthRegistry as JHealthRegistry
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu_torch.client import ec_reader
from ozone_tpu_torch.client.resilience import HealthRegistry
from ozone_tpu_torch.codec import fused_kernel
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType
from tests.test_torch_ec_write import CELL, K, clusters  # noqa: F401

ROW = K * CELL
#: two groups of 4 stripes, then a partial stripe in a third
SIZE = 2 * 4 * ROW + CELL + 77


@pytest.fixture
def keyed(clusters, monkeypatch):  # noqa: F811
    """(port, ref, data, port groups, ref groups), with decode batches of
    3 stripes so a 4-stripe group decodes in two pipelined batches."""
    monkeypatch.setenv("OZONE_TPU_DECODE_BATCH", "3")
    port, ref = clusters
    data = np.random.default_rng(11).integers(0, 256, SIZE, dtype=np.uint8)
    groups, jgroups = port.write(data, device="cpu"), ref.write(data)
    assert [(g.container_id, g.length, g.pipeline.nodes) for g in groups] == \
        [(g.container_id, g.length, g.pipeline.nodes) for g in jgroups]
    return port, ref, data, groups, jgroups


def _readers(port, ref, g, jg, checksum="CRC32C"):
    return (ec_reader.ECBlockGroupReader(
                g, port.opts, port.clients, checksum=ChecksumType[checksum],
                bytes_per_checksum=1024, device="cpu"),
            j_ec_reader.ECBlockGroupReader(
                jg, ref.opts, ref.clients,
                checksum=j_ec_reader.ChecksumType[checksum],
                bytes_per_checksum=1024))


def _lose(cluster, group, units):
    for u in units:
        dn = cluster.dns[int(group.pipeline.nodes[u][2:])]
        dn.delete_container(group.container_id, force=True)


def _starts(groups):
    return np.cumsum([0] + [g.length for g in groups])


def test_read_all_matches_reference(keyed):
    port, ref, data, groups, jgroups = keyed
    launched = fused_kernel.launches.count
    for g, jg, start in zip(groups, jgroups, _starts(groups)):
        r, jr = _readers(port, ref, g, jg)
        got = r.read_all()
        assert np.array_equal(got, jr.read_all())
        assert np.array_equal(got, data[start:start + g.length])
        assert r.dispatches == 0  # a healthy read decodes nothing
    assert fused_kernel.launches.count == launched  # CPU: no kernel


RANGES = [(0, 1), (CELL - 3, 7), (ROW - 5, 10), (2 * ROW + 100, ROW + 200),
          (CELL, 3 * ROW + CELL), (0, 4 * ROW)]


@pytest.mark.parametrize("lost", [[], [0], [1, 2]])
@pytest.mark.parametrize("offset,length", RANGES)
def test_ranged_read_matches_reference(keyed, lost, offset, length):
    """Ranges across cell and stripe boundaries, healthy and degraded."""
    port, ref, data, groups, jgroups = keyed
    g, jg = groups[0], jgroups[0]
    _lose(port, g, lost)
    _lose(ref, jg, lost)
    r, jr = _readers(port, ref, g, jg)
    got = r.read(offset, length)
    assert np.array_equal(got, data[offset:offset + length])
    assert np.array_equal(got, jr.read(offset, length))
    assert r.dispatches == 0 or lost


@pytest.mark.parametrize("lost", [[0], [4], [1, 2], [0, 3], [2, 4]])
def test_degraded_read_matches_reference(keyed, lost):
    """One or two units lost, data and parity, in every group; the partial
    tail group included. Each decode batch is one dispatch."""
    port, ref, data, groups, jgroups = keyed
    for g, jg, start in zip(groups, jgroups, _starts(groups)):
        _lose(port, g, lost)
        _lose(ref, jg, lost)
        r, jr = _readers(port, ref, g, jg)
        lengths = ec_reader.unit_true_lengths(g, port.opts)
        got = r.read_all()
        assert np.array_equal(got, data[start:start + g.length])
        if len([u for u, n in enumerate(lengths) if n and u not in lost]) < K:
            # the tail group with units 0 and 3 lost: only units 1 and 4
            # hold bytes. The reference counts the empty unit 2, which has
            # no block, as unreachable and gives up; the port knows it
            # holds zeros and decodes
            with pytest.raises(j_ec_reader.InsufficientLocationsError):
                jr.read_all()
        else:
            assert np.array_equal(got, jr.read_all())
        # stripes where a lost data unit holds bytes, 3 to a batch
        rebuilt = [s for s in range(r.num_stripes)
                   if any(s * ROW + u * CELL < g.length for u in lost if u < K)]
        assert r.dispatches == -(-len(rebuilt) // 3)
    # the tail group: its last stripe decodes zeros past the true length
    tail = ec_reader.unit_true_lengths(groups[-1], port.opts)
    assert tail == j_ec_reader.unit_true_lengths(jgroups[-1], ref.opts)
    assert tail == [CELL, 77, 0, CELL, CELL]


@pytest.mark.parametrize("checksum", ["CRC32C", "CRC32", "NONE"])
@pytest.mark.parametrize("targets", [[1], [0, 4], [3, 2]])
def test_recover_cells_with_crcs_matches_reference(keyed, checksum, targets):
    port, ref, data, groups, jgroups = keyed
    g, jg = groups[0], jgroups[0]
    r, jr = _readers(port, ref, g, jg, checksum)
    rec, crcs = r.recover_cells_with_crcs(targets)
    jrec, jcrcs = jr.recover_cells_with_crcs(targets)
    assert crcs.dtype == np.uint32 and jcrcs.dtype == np.uint32
    assert np.array_equal(rec, jrec) and np.array_equal(crcs, jcrcs)
    assert crcs.shape == (4, len(targets),
                          CELL // 1024 if checksum != "NONE" else 0)
    assert r.dispatches == 2  # 4 stripes in batches of 3
    # the recovered cells are the stored units, and the CRCs theirs
    host = Checksum(ChecksumType[checksum], 1024)
    for ti, u in enumerate(targets):
        dn = port.dns[int(g.pipeline.nodes[u][2:])]
        for info in dn.get_block(g.block_id).chunks:
            s = info.offset // CELL
            assert np.array_equal(rec[s, ti, :info.length],
                                  dn.read_chunk(g.block_id, info))
            if checksum != "NONE":
                want = [int.from_bytes(c, "big") for c in
                        host.compute(rec[s, ti]).checksums]
                assert crcs[s, ti].tolist() == want


def test_unit_failing_mid_read_is_excluded(keyed):
    """A unit whose reads start failing mid-read is excluded, its cells
    rebuilt, and the read still returns the source bytes, in both."""
    port, ref, data, groups, jgroups = keyed
    g, jg = groups[0], jgroups[0]
    readers = _readers(port, ref, g, jg)
    for c, err in ((port, StorageError), (ref, JStorageError)):
        client = c.clients.get(g.pipeline.nodes[1])
        real, calls = client.read_chunk, [0]

        def flaky(*a, _real=real, _calls=calls, _err=err, **kw):
            _calls[0] += 1
            if _calls[0] > 2:
                raise _err("IO_EXCEPTION", "disk gone")
            return _real(*a, **kw)

        client.read_chunk = flaky
    for r in readers:
        assert np.array_equal(r.read_all(), data[:g.length])
        assert 1 in r._failed
    assert readers[0].dispatches > 0


def test_straggler_hedge_wins_deterministically(keyed):
    """A unit whose reads block (on an event, not a sleep) loses to the
    decode-from-parity hedge fired after the hedge floor; the unit is then
    excluded and rebuilt in one batched decode."""
    port, ref, data, groups, jgroups = keyed
    g, jg = groups[1], jgroups[1]
    release = threading.Event()
    try:
        for c, health in ((port, HealthRegistry(hedge_floor_s=0.05)),
                          (ref, JHealthRegistry(hedge_floor_s=0.05))):
            c.clients.health = health
            client = c.clients.get(g.pipeline.nodes[2])
            real = client.read_chunk

            def stuck(*a, _real=real, **kw):
                release.wait(timeout=60)
                return _real(*a, **kw)

            client.read_chunk = stuck
        r, jr = _readers(port, ref, g, jg)
        start = _starts(groups)[1]
        for reader in (r, jr):
            assert np.array_equal(reader.read_all(),
                                  data[start:start + g.length])
            assert 2 in reader._failed
        assert r.dispatches >= 2  # the hedge's decode, then the batches
    finally:
        release.set()


def test_insufficient_locations_with_p_plus_one_lost(keyed):
    port, ref, data, groups, jgroups = keyed
    g, jg = groups[0], jgroups[0]
    _lose(port, g, [0, 2, 4])
    _lose(ref, jg, [0, 2, 4])
    r, jr = _readers(port, ref, g, jg)
    with pytest.raises(ec_reader.InsufficientLocationsError):
        r.read_all()
    with pytest.raises(j_ec_reader.InsufficientLocationsError):
        jr.read_all()
    with pytest.raises(ec_reader.InsufficientLocationsError):
        r.recover_cells([0])
