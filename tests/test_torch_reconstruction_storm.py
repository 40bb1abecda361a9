"""The port's reconstruction storm, on the CPU.

The two drills of `tests/test_reconstruction_storm.py` on the port's
`MiniOzoneCluster`: kill the datanode holding the most EC replicas,
repair every container it held through one shared coordinator, and
check each rebuilt block byte-exact; a container past its parity is
counted unrecoverable and skipped. The CPU gives the storm no mesh
executor, so its coalescing proof reads the shared codec service, where
the storm's decode batches meet (tests/test_torch_mesh_consumers.py runs
a storm through an executor). Then a port and a JAX cluster with the same
placement seed run the same storm: the plan (container ids, sources,
targets) and the rebuilt chunks with their CRCs must be equal.
"""

import numpy as np
import pytest
import torch

from ozone_tpu.client.reconstruction import ReconstructionStorm as JStorm
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.client.reconstruction import ReconstructionStorm
from ozone_tpu_torch.codec import service as codec_service
from ozone_tpu_torch.scm.pipeline import ReplicationType
from ozone_tpu_torch.storage.ids import ContainerState, StorageError
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

#: rs-3-2, 4 KiB cells; keys of exactly 8 full stripes
CELL = 4096
KEY_BYTES = 8 * 3 * CELL


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain PyTorch versions run at test sizes on one thread: the
    suite runs in several worker processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cluster(root):
    # one block group (~96 KiB) per container: each key lands in a fresh
    # container, spreading many containers across the fleet
    return MiniOzoneCluster(root, num_datanodes=8, container_size=100 * 1024,
                            stale_after_s=1000.0, dead_after_s=2000.0,
                            placement_seed=42, device="cpu")


@pytest.fixture
def cluster(tmp_path):
    c = _port_cluster(tmp_path)
    yield c
    c.close()


def _ec_containers_by_dn(scm):
    held: dict[str, list] = {}
    for c in scm.containers.containers():
        if c.replication.type.name != ReplicationType.EC.name:
            continue  # (a JAX cluster's containers carry the JAX enum)
        for dn_id in c.replicas:
            held.setdefault(dn_id, []).append(c)
    return held


def _write_keys(cluster, n, seed):
    bucket = cluster.client().create_volume("storm").create_bucket(
        "b", replication=f"rs-3-2-{CELL}")
    rng = np.random.default_rng(seed)
    for i in range(n):
        bucket.write_key(f"k{i}", rng.integers(0, 256, KEY_BYTES, dtype=np.uint8))
    cluster.heartbeat_all()  # container reports -> SCM replica maps


def _victim(cluster):
    held = _ec_containers_by_dn(cluster.scm)
    victim = max(held, key=lambda d: len(held[d]))
    return victim, held[victim]


def test_storm_repairs_dead_datanode_byte_exact(cluster):
    _write_keys(cluster, 16, seed=42)
    victim, victim_containers = _victim(cluster)
    assert len(victim_containers) >= 8, \
        f"drill needs >= 8 containers on one node, got {len(victim_containers)}"

    # every chunk the victim holds, per container: the ground truth
    victim_dn = cluster.datanode(victim)
    victim_idx: dict[int, int] = {}
    truth: dict[int, list] = {}
    for c in victim_containers:
        victim_idx[c.id] = c.replicas[victim].replica_index
        blocks = []
        for bd in victim_dn.list_blocks(c.id):
            chunks = [victim_dn.read_chunk(bd.block_id, info)
                      for info in bd.chunks]
            blocks.append((bd.block_id, bd.block_group_length, chunks))
        assert blocks, f"victim replica of container {c.id} is empty"
        truth[c.id] = blocks

    cluster.stop_datanode(victim)
    codec_service.reset_for_tests()
    svc0 = codec_service.METRICS.snapshot()
    storm = ReconstructionStorm(cluster.scm, cluster.clients, device="cpu")
    report = storm.repair_datanode(victim)
    svc = {k: codec_service.METRICS.snapshot().get(k, 0) - svc0.get(k, 0)
           for k in ("submissions", "dispatches", "stripes_dispatched")}

    assert report.containers_planned == len(victim_containers)
    assert report.ok, f"storm failures: {report.failures}"
    assert report.containers_unrecoverable == 0
    # no mesh executor on the CPU: the mesh fields stay 0, and the batches
    # went through the codec service, never more dispatches than batches
    assert (report.mesh_dispatches, report.mesh_stripes,
            report.mesh_coalesced_ops, report.mesh_multi_op_dispatches,
            report.mesh_max_inflight) == (0, 0, 0, 0, 0)
    assert svc["submissions"] >= report.containers_repaired
    assert 0 < svc["dispatches"] <= svc["submissions"]
    assert svc["stripes_dispatched"] >= 8 * report.containers_repaired

    # every block of every replica the victim held exists again on a
    # surviving node at the same replica index, chunk for chunk, and
    # verifies against its stored checksums
    for c in victim_containers:
        idx = victim_idx[c.id]
        home = None
        for dn in cluster.datanodes:
            if dn.id == victim:
                continue
            try:
                rep = dn.containers.get(c.id)
            except StorageError:
                continue
            if rep.replica_index == idx:
                home = dn
                break
        assert home is not None, \
            f"container {c.id} index {idx} never re-materialized"
        assert home.containers.get(c.id).state is ContainerState.CLOSED
        for block_id, group_len, chunks in truth[c.id]:
            blk = home.get_block(block_id)
            assert blk.block_group_length == group_len
            assert len(blk.chunks) == len(chunks)
            for info, want in zip(blk.chunks, chunks):
                got = home.read_chunk(block_id, info, verify=True)
                assert np.array_equal(got, want), (
                    f"container {c.id} block {block_id} chunk "
                    f"{info.offset} diverged after reconstruction")


def test_storm_skips_unrecoverable_and_reports(cluster):
    """A container with more erased indexes than parity is counted
    unrecoverable and skipped: the storm never wedges on a lost cause."""
    _write_keys(cluster, 1, seed=7)
    c = next(iter(cluster.scm.containers.containers()))
    holders = sorted(c.replicas)
    # wipe 2 sibling replicas beyond the one we kill: 3 of 5 gone > p=2
    victim = holders[0]
    for dn_id in holders[1:3]:
        cluster.datanode(dn_id).delete_container(c.id, force=True)
        del c.replicas[dn_id]
    cluster.stop_datanode(victim)

    report = ReconstructionStorm(cluster.scm, cluster.clients,
                                 device="cpu").repair_datanode(victim)
    assert report.containers_unrecoverable == 1
    assert report.containers_planned == 0
    assert report.ok  # nothing planned, nothing failed


def test_storm_takes_no_executor(cluster):
    """On the CPU the storm takes no mesh executor of its own accord (no
    CUDA device, none installed); one passed in reaches the coordinator."""
    storm = ReconstructionStorm(cluster.scm, cluster.clients, device="cpu")
    assert storm.executor is None and storm.coordinator.executor is None
    ex = object()
    storm = ReconstructionStorm(cluster.scm, cluster.clients, executor=ex,
                                device="cpu")
    assert storm.executor is ex and storm.coordinator.executor is ex


def _plan_rows(cmds):
    return [(c.container_id, str(c.replication), dict(c.sources),
             dict(c.targets)) for c in cmds]


def _rebuilt(cluster, cmds, errors):
    """[(container, index, block, chunk json, bytes)] of every rebuilt
    replica, read verified from its target."""
    out = []
    for cmd in cmds:
        for idx, dn_id in sorted(cmd.targets.items()):
            dn = cluster.datanode(dn_id)
            for bd in dn.list_blocks(cmd.container_id):
                for info in bd.chunks:
                    try:
                        data = dn.read_chunk(bd.block_id, info, verify=True)
                    except errors:
                        data = None
                    out.append((cmd.container_id, idx, bd.block_id.local_id,
                                info.to_json(), None if data is None
                                else data.tobytes()))
    return out


def test_storm_plan_and_rebuilt_chunks_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    port = _port_cluster(tmp_path / "port")
    ref = JCluster(tmp_path / "ref", num_datanodes=8, container_size=100 * 1024,
                   stale_after_s=1000.0, dead_after_s=2000.0, placement_seed=42)
    try:
        results = []
        for c, storm_cls, kw, errors in (
                (port, ReconstructionStorm, {"device": "cpu"}, StorageError),
                (ref, JStorm, {}, JStorageError)):
            _write_keys(c, 10, seed=9)
            victim, held = _victim(c)
            c.stop_datanode(victim)
            storm = storm_cls(c.scm, c.clients, **kw)
            plans = []
            plan = storm.plan
            storm.plan = lambda dn_id: plans.append(plan(dn_id)) or plans[-1]
            report = storm.repair_datanode(victim)
            cmds, = plans
            assert report.ok and report.containers_planned == len(held)
            results.append((victim, _plan_rows(cmds), _rebuilt(c, cmds, errors)))
        got, want = results
        assert got[0] == want[0]
        assert got[1] == want[1]
        assert len(got[1]) >= 5
        assert got[2] == want[2]
        assert all(b is not None for *_, b in got[2])
    finally:
        port.close()
        ref.close()


def test_storm_plans_a_node_the_scm_declared_dead(tmp_path):
    """Once the liveness sweep declares the victim DEAD, the SCM forgets
    its replicas. The port's SCM keeps the ids of the containers it forgot
    and the storm plans every one of them; the reference's planner reads
    the replica map alone and finds none."""
    from ozone_tpu.scm.node_manager import NodeState as JNodeState
    from ozone_tpu_torch.scm.node_manager import NodeState

    port = _port_cluster(tmp_path / "port")
    ref = JCluster(tmp_path / "ref", num_datanodes=8, container_size=100 * 1024,
                   stale_after_s=1000.0, dead_after_s=2000.0, placement_seed=42)
    try:
        planned = []
        for c, storm_cls, kw, dead in (
                (port, ReconstructionStorm, {"device": "cpu"}, NodeState.DEAD),
                (ref, JStorm, {}, JNodeState.DEAD)):
            _write_keys(c, 10, seed=9)
            victim, held = _victim(c)
            c.stop_datanode(victim)
            c.scm.nodes.get(victim).last_heartbeat = -1e9
            c.scm.nodes.check_liveness()
            assert c.scm.nodes.get(victim).state is dead
            assert not _ec_containers_by_dn(c.scm).get(victim)
            storm = storm_cls(c.scm, c.clients, **kw)
            planned.append((len(held), _plan_rows(storm.plan(victim))))
        (n_port, port_plan), (n_ref, ref_plan) = planned
        assert n_port == n_ref >= 5
        assert len(port_plan) == n_port and ref_plan == []
        report = ReconstructionStorm(port.scm, port.clients,
                                     device="cpu").repair_datanode(victim)
        assert report.ok and report.containers_repaired == n_port
    finally:
        port.close()
        ref.close()
