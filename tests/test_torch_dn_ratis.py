"""The port's datanode Raft pipelines, its SCM store and its sequence ids,
held against the reference.

`ContainerStateMachine` answers one request sequence (creates, commits
with and without the data phase, put-block, close, an unknown verb) with
the reference's results and error codes, CHUNK_DATA_MISSING and the
unhealthy replica included. A RATIS/THREE key goes through the pipeline
ring in process (all members, a follower hit first, one member down) and
over the port's RPC, and the raft transport elects and commits over real
servers. `ScmStore` files cross-load between the packages, and
`SequenceIdGenerator` issues the reference's ids on one script.
"""

import itertools

import numpy as np
import pytest

import ozone_tpu.scm.scm_store as j_scm_store
import ozone_tpu.scm.sequence_id as j_seq
import ozone_tpu.storage.datanode as j_datanode
import ozone_tpu.storage.ids as j_ids
import ozone_tpu.storage.ratis as j_ratis
import ozone_tpu_torch.scm.scm_store as t_scm_store
import ozone_tpu_torch.scm.sequence_id as t_seq
import ozone_tpu_torch.storage.datanode as t_datanode
import ozone_tpu_torch.storage.ids as t_ids
import ozone_tpu_torch.storage.ratis as t_ratis
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ec_writer import BlockGroup
from ozone_tpu_torch.client.ratis_client import (
    RatisKeyWriter,
    XceiverClientRatis,
)
from ozone_tpu_torch.client.replicated import ReplicatedKeyReader
from ozone_tpu_torch.consensus.raft import (
    InProcessTransport,
    RaftConfig,
    RaftNode,
)
from ozone_tpu_torch.net.raft_transport import RaftRpcService, RpcRaftTransport
from ozone_tpu_torch.net.ratis_service import (
    RatisClientFactory,
    RatisRpcService,
)
from ozone_tpu_torch.net.rpc import RpcServer
from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import ContainerState, StorageError
from ozone_tpu_torch.storage.ratis import RatisXceiverServer

FAST = RaftConfig(heartbeat_interval_s=0.05, election_timeout_s=(0.15, 0.3))


# ------------------------------------------------------ state machine
def _sm_run(datanode_mod, ids_mod, ratis_mod, root) -> list:
    """One request sequence through a package's ContainerStateMachine:
    each step's result, or its error code, and the container states."""
    dn = datanode_mod.Datanode(root, dn_id="dn0")
    sm = ratis_mod.ContainerStateMachine(dn)
    bid = ids_mod.BlockID(1, 1)
    data = np.arange(100, dtype=np.uint8)
    info = ids_mod.ChunkInfo("c0", 0, 100)
    out = []

    def step(req, data_phase=None):
        if data_phase is not None:
            dn.write_chunk(*data_phase)
        try:
            out.append(("ok", sm.apply(req)))
        except ids_mod.StorageError as e:
            out.append(("error", e.code))

    commit = {"verb": "write_chunk_commit", "block_id": bid.to_json(),
              "offset": 0, "length": 100}
    step({"verb": "create_container", "container_id": 1})
    step({"verb": "create_container", "container_id": 1})  # re-apply
    step(commit, data_phase=(bid, info, data))
    step({"verb": "put_block",
          "block": ids_mod.BlockData(bid, [info]).to_json()})
    step({"verb": "close_container", "container_id": 1})
    step({"verb": "write_chunk_commit", "block_id": bid.to_json(),
          "offset": 100, "length": 50})  # into a closed container
    step({"verb": "create_container", "container_id": 2})
    step({"verb": "write_chunk_commit",
          "block_id": ids_mod.BlockID(2, 7).to_json(), "offset": 0,
          "length": 4096})  # missed the data phase
    step({"verb": "frobnicate"})
    out.append(("states", [(c.id, c.state.value)
                           for c in dn.list_containers()]))
    out.append(("committed", dn.get_committed_block_length(bid)))
    out.append(("snapshot", sm.snapshot()))
    dn.close()
    return out


def test_state_machine_results_and_codes_equal_reference(tmp_path):
    ref = _sm_run(j_datanode, j_ids, j_ratis, tmp_path / "ref")
    port = _sm_run(t_datanode, t_ids, t_ratis, tmp_path / "port")
    assert port == ref
    codes = [v for k, v in port if k == "error"]
    assert codes == ["INVALID_CONTAINER_STATE", "CHUNK_DATA_MISSING",
                     "UNSUPPORTED_REQUEST"]
    assert ("states", [(1, "CLOSED"), (2, "UNHEALTHY")]) in port


# ---------------------------------------------- in-process pipeline ring
@pytest.fixture
def ring(tmp_path):
    """Three datanodes sharing one pipeline raft group, in process, with
    dn0 elected by hand."""
    transport = InProcessTransport()
    ids = ["dn0", "dn1", "dn2"]
    dns, xceivers = [], []
    for name in ids:
        dn = Datanode(tmp_path / name, dn_id=name)
        dns.append(dn)
        xceivers.append(RatisXceiverServer(dn, tmp_path / name, "",
                                           config=FAST, auto_timers=False))
    pipeline = Pipeline(ReplicationConfig.parse("RATIS/THREE"), ids)
    for xc in xceivers:
        xc.join(pipeline.id, {i: "" for i in ids}, transport=transport)
    assert xceivers[0].get(pipeline.id).start_election()
    yield dns, xceivers, pipeline
    for xc in xceivers:
        xc.stop()
    for dn in dns:
        dn.close()


#: local ids never repeat across writes (the datanode's write fence
#: refuses a second writer into an existing block file)
_local_ids = itertools.count(1)


def _clients(dns, xceivers):
    clients = DatanodeClientFactory()
    ratis = RatisClientFactory()
    for dn, xc in zip(dns, xceivers):
        clients.register_local(dn)
        ratis.register_local(xc, dn.id)
    return clients, ratis


def test_pipeline_write_replicates_to_all(ring):
    dns, xceivers, pipeline = ring
    clients, ratis = _clients(dns, xceivers)
    payload = np.random.default_rng(7).integers(0, 256, 300_000,
                                                dtype=np.uint8)
    w = RatisKeyWriter(lambda excluded: BlockGroup(
        container_id=1, local_id=next(_local_ids), pipeline=pipeline),
        clients, ratis, chunk_size=64 * 1024)
    w.write(payload)
    groups = w.close()
    out = np.concatenate([ReplicatedKeyReader(g, clients).read_all()
                          for g in groups])
    assert np.array_equal(out, payload)
    for g in groups:  # every member holds the same committed history
        assert {dn.get_committed_block_length(g.block_id)
                for dn in dns} == {g.length}


def test_not_leader_rejected_and_hint_followed(ring):
    dns, xceivers, pipeline = ring
    with pytest.raises(StorageError) as ei:
        xceivers[1].submit(pipeline.id, {"verb": "create_container",
                                         "container_id": 9})
    assert (ei.value.code, ei.value.msg) == ("NOT_LEADER", "dn0")
    _, ratis = _clients(dns, xceivers)
    x = XceiverClientRatis(pipeline, ratis)
    x._leader = "dn1"  # a wrong guess on purpose
    assert x.submit({"verb": "create_container", "container_id": 9})["ok"]
    assert x._leader == "dn0"


def test_write_succeeds_with_minority_member_down(ring):
    """One of three members dead: the data phase reaches a majority, the
    commit goes through, the watch degrades to MAJORITY, and the member
    that missed the bytes poisons its replica when it applies the log."""
    dns, xceivers, pipeline = ring
    leader = xceivers[0].get(pipeline.id)
    leader.transport.down.add("dn2")

    class DeadClient:
        dn_id = "dn2"

        def __getattr__(self, name):
            def down(*a, **k):
                raise StorageError("IO_EXCEPTION", "dn2 is down")

            return down

    clients, ratis = _clients(dns[:2], xceivers[:2])
    clients._local["dn2"] = DeadClient()
    payload = np.random.default_rng(9).integers(0, 256, 100_000,
                                                dtype=np.uint8)
    w = RatisKeyWriter(lambda excluded: BlockGroup(
        container_id=1, local_id=next(_local_ids), pipeline=pipeline),
        clients, ratis, chunk_size=32 * 1024, watch_timeout_s=0.5)
    w.write(payload)
    groups = w.close()
    assert np.array_equal(ReplicatedKeyReader(groups[0], clients).read_all(),
                          payload)
    for dn in dns[:2]:
        assert dn.get_committed_block_length(groups[0].block_id) \
            == groups[0].length
    leader.transport.heal()
    leader.tick()
    assert dns[2].containers.get(1).state is ContainerState.UNHEALTHY
    assert w._xceivers[pipeline.id]._degraded  # the degrade is sticky


# ------------------------------------------------------------ over the RPC
def test_rpc_raft_transport_election_and_commit(tmp_path):
    """Three raft peers on real RpcServers: elect, commit, and go on
    around a stopped peer."""
    ids = ["a", "b", "c"]
    servers, services, nodes = {}, {}, {}
    states = {nid: [] for nid in ids}
    for nid in ids:
        srv = RpcServer("127.0.0.1", 0)
        services[nid] = RaftRpcService(srv)
        srv.start()
        servers[nid] = srv
    addrs = {nid: servers[nid].address for nid in ids}
    for nid in ids:
        nodes[nid] = RaftNode(nid, [p for p in ids if p != nid],
                              tmp_path / nid, states[nid].append,
                              config=FAST,
                              transport=RpcRaftTransport("g1", addrs))
        services[nid].register("g1", nodes[nid])
    try:
        assert nodes["a"].start_election()
        assert nodes["a"].propose({"k": 1}) is None
        nodes["a"].tick()
        assert states["a"] == states["b"] == states["c"] == [{"k": 1}]
        services["c"].unregister("g1")
        servers["c"].stop()
        nodes["a"].propose({"k": 2})
        nodes["a"].tick()
        assert states["b"][-1] == {"k": 2}
    finally:
        for nid in ids:
            nodes[nid].stop()
            nodes[nid].transport.close()
        for nid in ("a", "b"):
            servers[nid].stop()


def test_rpc_ratis_pipeline_end_to_end(tmp_path):
    """Three datanodes with RatisXceiverServers over the port's RPC (raft
    RPCs and the client's Submit/Watch on the wire), timers on: a key
    written through RatisKeyWriter reads back from every member."""
    from ozone_tpu_torch.net.dn_service import DatanodeRpcService

    ids = ["dn0", "dn1", "dn2"]
    dns, xcs, servers = [], [], []
    for name in ids:
        dn = Datanode(tmp_path / name, dn_id=name)
        srv = RpcServer("127.0.0.1", 0)
        xc = RatisXceiverServer(dn, tmp_path / name, "",
                                rpc_service=RaftRpcService(srv), config=FAST)
        RatisRpcService(xc, srv)
        DatanodeRpcService(dn, srv)
        srv.start()
        dns.append(dn)
        xcs.append(xc)
        servers.append(srv)
    addrs = {name: srv.address for name, srv in zip(ids, servers)}
    pipeline = Pipeline(ReplicationConfig.parse("RATIS/THREE"), ids)
    clients = DatanodeClientFactory(native_datapath=False)
    try:
        for xc in xcs:
            xc.join(pipeline.id, addrs)
        for name, addr in addrs.items():
            clients.register_remote(name, addr)
        ratis = RatisClientFactory(address_source=clients.remote_address)
        payload = np.random.default_rng(11).integers(0, 256, 200_000,
                                                     dtype=np.uint8)
        w = RatisKeyWriter(lambda excluded: BlockGroup(
            container_id=3, local_id=next(_local_ids), pipeline=pipeline),
            clients, ratis, chunk_size=64 * 1024)
        w.write(payload)
        groups = w.close()  # the ALL watch: applied on every member
        for dn in dns:
            assert dn.get_committed_block_length(groups[0].block_id) \
                == groups[0].length
        out = ReplicatedKeyReader(groups[0], clients).read_all()
        assert np.array_equal(out, payload)
        ratis.close()
    finally:
        clients.close()
        for xc in xcs:
            xc.stop()
        for srv in servers:
            srv.stop()
        for dn in dns:
            dn.close()


# --------------------------------------------- SCM store and sequence ids
def _scm_store_rows(st) -> None:
    row = {"id": 1, "replication": "rs-3-2-4096",
           "nodes": ["dn0", "dn1", "dn2", "dn3", "dn4"], "pipeline_id": 4,
           "state": "OPEN", "used_bytes": 4096}
    st.save_container(row, counters=(2, 7))
    st.save_container(dict(row, state="CLOSED", used_bytes=8192),
                      counters=(2, 9))
    st.save_counters((5, 1009), pipeline_floor=17)


def test_scm_store_port_rows_load_in_the_reference(tmp_path):
    """Container rows, id counters and the pipeline floor the port
    writes load the same in the reference's store."""
    st = t_scm_store.ScmStore(tmp_path / "scm.db")
    _scm_store_rows(st)
    want = st.load()
    st.close()
    ref = j_scm_store.ScmStore(tmp_path / "scm.db")
    assert ref.load() == want
    assert (want["next_container_id"], want["next_local_id"],
            want["pipeline_floor"]) == (5, 1009, 17)
    ref.close()


def test_scm_store_reference_rows_load_in_the_port(tmp_path):
    """A store the reference wrote, node states and service rows too,
    loads the same in the port's."""
    ref = j_scm_store.ScmStore(tmp_path / "scm.db")
    _scm_store_rows(ref)
    ref.save_node_op_state("dn3", "DECOMMISSIONING")
    ref.save_service_state("balancer", {"running": False})
    want = ref.load()
    ref.close()
    st = t_scm_store.ScmStore(tmp_path / "scm.db")
    assert st.load() == want
    assert want["node_op_states"] == {"dn3": "DECOMMISSIONING"}
    st.close()


def _seq_script(mod) -> list:
    """next/release/invalidate on one generator over a fake ring whose
    committed floor moves like the container manager's."""
    floor = {"block": 1, "container": 1, "pipeline": 1}
    reserved = []

    def reserve(kind, count):
        lo = floor[kind]
        floor[kind] = lo + count
        reserved.append((kind, lo, lo + count))
        return lo, lo + count

    gen = mod.SequenceIdGenerator(reserve, {"block": 4, "container": 2})
    out = [gen.next("block") for _ in range(6)]
    ep = gen.epoch
    cid = gen.next("container")
    gen.release("container", cid, epoch=ep)
    out.append(gen.next("container"))  # the released id comes back
    gen.invalidate()  # a leader change burns the batches
    gen.release("container", cid, epoch=ep)  # stale epoch: dropped
    out += [gen.next("container"), gen.next("block"), gen.next("pipeline")]
    return out + reserved


def test_sequence_ids_equal_reference():
    assert _seq_script(t_seq) == _seq_script(j_seq)
    assert _seq_script(t_seq)[:6] == [1, 2, 3, 4, 5, 6]
