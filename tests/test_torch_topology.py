"""The port's network topology and nearest-first reads against
`ozone_tpu`'s, on the CPU.

Mirrors tests/test_topology.py: tree distances, the stable nearest-first
sort, the client factory's ordering, a replicated read that asks the
nearest replica first, and an EC degraded read whose survivor choice
(and so the decode's recovery matrix) takes the near units. Each case
runs both packages on the same inputs and compares their answers.
"""

import itertools

import numpy as np
import pytest
import torch

from ozone_tpu.client import ec_reader as j_ec_reader
from ozone_tpu.client.dn_client import DatanodeClientFactory as JFactory
from ozone_tpu.client.ec_writer import BlockGroup as JBlockGroup
from ozone_tpu.codec.api import CoderOptions as JCoderOptions
from ozone_tpu.scm import topology as j_topology
from ozone_tpu.scm.pipeline import Pipeline as JPipeline
from ozone_tpu.scm.pipeline import ReplicationConfig as JReplicationConfig
from ozone_tpu.storage.datanode import Datanode as JDatanode
from ozone_tpu_torch.client import ec_reader
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ec_writer import BlockGroup, ECKeyWriter
from ozone_tpu_torch.client.replicated import ReplicatedKeyReader
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.scm import topology
from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import BlockData, BlockID, ChunkInfo
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

LOCATIONS = [None, "", "/r1", "/dc1/r1", "/dc1/r2", "/dc2/r1", "/dc2/r9",
             "/dc1/r1/sub", "r1"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ distance
@pytest.mark.parametrize("node_a,node_b", [(None, None), ("a", "a"),
                                           ("a", "b")])
def test_distance_tree_edges(node_a, node_b):
    """Every pair of locations, as the same node and as two: the port's
    distance equals the reference's, and the reference test's values
    hold."""
    for a, b in itertools.product(LOCATIONS, repeat=2):
        assert topology.distance(a, b, node_a, node_b) == \
            j_topology.distance(a, b, node_a, node_b), (a, b)
        assert topology.norm_location(a) == j_topology.norm_location(a)
    assert topology.distance("/dc1/r1", "/dc1/r1", "a", "a") == 0
    assert topology.distance("/dc1/r1", "/dc1/r1", "a", "b") == 2
    assert topology.distance("/dc1/r1", "/dc1/r2") == 4
    assert topology.distance("/dc1/r1", "/dc2/r9") == 6
    assert topology.distance("/r1", "/dc1/r1") == 5
    assert topology.distance(None, "/dc1/r1") == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_by_distance_orders_and_is_stable(seed):
    """Seeded node lists (unknown locations, ties, the reader itself):
    the same order on both packages; and the reference test's cases."""
    rng = np.random.default_rng(seed)
    locs = {f"n{i}": LOCATIONS[int(rng.integers(2, len(LOCATIONS)))]
            for i in range(12)}
    nodes = [f"n{i}" for i in rng.permutation(16)]  # n12..n15: unknown
    for reader, me in (("/dc1/r1", None), ("/dc2/r1", "n3"), (None, "n5")):
        assert topology.sort_by_distance(reader, nodes, locs, me) == \
            j_topology.sort_by_distance(reader, nodes, locs, me)
    locs = {"far": "/dc2/r1", "same-rack": "/dc1/r1", "same-dc": "/dc1/r2",
            "also-same-rack": "/dc1/r1"}
    assert topology.sort_by_distance(
        "/dc1/r1", ["far", "same-rack", "same-dc", "also-same-rack"],
        locs) == ["same-rack", "also-same-rack", "same-dc", "far"]
    assert topology.sort_by_distance(
        "/dc1/r1", ["x", "same-rack", "y"], locs) == ["same-rack", "x", "y"]
    assert topology.sort_by_distance(
        "/dc1/r1", ["same-rack", "me"], {**locs, "me": "/dc1/r1"},
        reader_node="me") == ["me", "same-rack"]


def test_factory_nearest_first():
    out = []
    for f in (DatanodeClientFactory(), JFactory()):
        seen = [f.nearest_first(["b", "a"])]  # no topology: input order
        f.learn_locations({"a": "/dc1/r1", "b": "/dc2/r1", "c": "/dc1/r2"})
        seen.append(f.nearest_first(["b", "c", "a"]))  # no position yet
        f.location = "/dc1/r1"
        seen.append(f.nearest_first(["b", "c", "a"]))
        f.location, f.node_id = None, "c"
        seen.append(f.nearest_first(["b", "c", "a"]))
        f.close()
        out.append(seen)
    assert out[0] == out[1]
    assert out[0][0] == ["b", "a"] and out[0][2] == ["a", "c", "b"]


# ------------------------------------------------------- read-path ordering
class _Recording(DatanodeClientFactory):
    """A factory whose get() records which datanode is asked."""

    def __init__(self):
        super().__init__()
        self.asked: list[str] = []

    def get(self, dn_id):
        self.asked.append(dn_id)
        return super().get(dn_id)


class _JRecording(JFactory):
    def __init__(self):
        super().__init__()
        self.asked: list[str] = []

    def get(self, dn_id):
        self.asked.append(dn_id)
        return super().get(dn_id)


@pytest.mark.parametrize("reader_loc,first", [("/dc1/r1", "dn2"),
                                              ("/dc2/r1", "dn0"),
                                              ("/dc1/r2", "dn1")])
def test_replicated_read_prefers_nearest(tmp_path, reader_loc, first):
    """Three replicas on three locations: the port's reader asks the
    topology-nearest first, as the reference's does, and reads the bytes."""
    from ozone_tpu.client.replicated import ReplicatedKeyReader as JReader
    from ozone_tpu.storage import ids as j_ids
    from ozone_tpu.utils import checksum as j_checksum

    data = np.arange(256, dtype=np.uint8)
    locs = {"dn0": "/dc2/r1", "dn1": "/dc1/r2", "dn2": "/dc1/r1"}
    asked, got = [], []
    for port in (True, False):
        ids = None if port else j_ids
        ck = Checksum if port else j_checksum.Checksum
        ct = ChecksumType if port else j_checksum.ChecksumType
        cs = ck(ct.CRC32C, 4096).compute(data)
        mk = (lambda *a: ChunkInfo(*a)) if port else j_ids.ChunkInfo
        info = mk("c0", 0, data.size, cs)
        bid = BlockID(1, 1) if port else ids.BlockID(1, 1)
        clients = _Recording() if port else _JRecording()
        dns = []
        for i in range(3):
            cls = Datanode if port else JDatanode
            dn = cls(tmp_path / ("p" if port else "j") / f"dn{i}",
                     dn_id=f"dn{i}")
            dns.append(dn)
            clients.register_local(dn)
            dn.create_container(1)
            dn.write_chunk(bid, info, data)
            dn.put_block((BlockData if port else ids.BlockData)(bid, [info]))
        pipe = (Pipeline(ReplicationConfig.parse("RATIS/THREE"),
                         ["dn0", "dn1", "dn2"]) if port else
                JPipeline(JReplicationConfig.parse("RATIS/THREE"),
                          ["dn0", "dn1", "dn2"]))
        group = (BlockGroup if port else JBlockGroup)(
            container_id=1, local_id=1, pipeline=pipe, length=data.size)
        clients.learn_locations(locs)
        clients.location = reader_loc
        reader = ReplicatedKeyReader(group, clients) if port else \
            JReader(group, clients)
        got.append(bytes(reader.read_all()))
        asked.append(clients.asked[0])
        for dn in dns:
            dn.close()
    assert got == [data.tobytes()] * 2
    assert asked == [first, first]


@pytest.mark.parametrize("lost,locs", [
    # the reference test: the reader sits beside the parity nodes d3/d4
    (0, {"d0": "/dc9/r9", "d1": "/dc2/r1", "d2": "/dc2/r1",
         "d3": "/dc1/r1", "d4": "/dc1/r1"}),
    (1, {"d0": "/dc1/r1", "d1": "/dc9/r9", "d2": "/dc2/r1",
         "d3": "/dc2/r1", "d4": "/dc1/r1"}),
])
def test_ec_degraded_read_prefers_near_survivors(tmp_path, lost, locs):
    """An rs-3-2 key written by the port; one data unit unavailable. The
    port's survivor choice equals the reference reader's over the same
    stored units (the reference's datanodes open the port's volumes), it
    takes the units next to the reader, and the degraded read through the
    decode is byte-exact."""
    opts = CoderOptions.parse("rs-3-2-4096")
    roots = [tmp_path / f"d{i}" for i in range(5)]
    dns = [Datanode(r, dn_id=f"d{i}") for i, r in enumerate(roots)]
    clients = _Recording()
    for dn in dns:
        clients.register_local(dn)
    pipe = Pipeline(ReplicationConfig.parse("rs-3-2-4096"),
                    [f"d{i}" for i in range(5)])

    def allocate(excluded, excluded_containers=()):
        return BlockGroup(container_id=1, local_id=1, pipeline=pipe)

    data = np.random.default_rng(lost).integers(0, 256, 30_000,
                                                dtype=np.uint8)
    w = ECKeyWriter(opts, allocate, clients, block_size=8 * 4096,
                    device="cpu")
    w.write(data)
    g = w.close()[0]
    for dn in dns:
        dn.close()
    # the reference's survivor choice over the same stored units
    jdns = [JDatanode(r, dn_id=f"d{i}") for i, r in enumerate(roots)]
    jclients = JFactory()
    for dn in jdns:
        jclients.register_local(dn)
    jclients.learn_locations(locs)
    jclients.location = "/dc1/r1"
    jg = JBlockGroup(container_id=1, local_id=1, length=g.length,
                     pipeline=JPipeline(
                         JReplicationConfig.parse("rs-3-2-4096"),
                         list(pipe.nodes)))
    jreader = j_ec_reader.ECBlockGroupReader(
        jg, JCoderOptions.parse("rs-3-2-4096"), jclients)
    jreader._failed.add(lost)
    j_valid = jreader._choose_valid([lost])
    for dn in jdns:
        dn.close()
    dns = [Datanode(r, dn_id=f"d{i}") for i, r in enumerate(roots)]
    clients = _Recording()
    for dn in dns:
        clients.register_local(dn)
    clients.learn_locations(locs)
    clients.location = "/dc1/r1"
    reader = ec_reader.ECBlockGroupReader(g, opts, clients, device="cpu")
    reader._failed.add(lost)
    valid = reader._choose_valid([lost])
    assert valid == j_valid
    near = {u for u in range(5) if locs[f"d{u}"] == "/dc1/r1" and u != lost}
    assert set(valid) >= near, valid
    assert np.array_equal(reader.read_all(), data)
    for dn in dns:
        dn.close()
