"""The rest of the port's SCM against `ozone_tpu`'s, on the CPU.

Each case runs the port and the reference on the same seeded inputs and
compares what they decide: placement draws, op states and the commands
they queue, the drain monitor's verdicts, the balancer's moves and its
persisted state across a restart and an HA follower, the admin verbs'
answers, the replication census, the command lease watcher, and the
datanode's volume checker and chooser. Mirrors tests/test_scm_services.py
(balancer, drain), tests/test_scm_persistence.py (balancer state),
tests/test_storage.py (volume chooser, volume failure) and
tests/test_observability_extras.py (EventWatcher). Over the wire:
tests/test_distributed.py's volume failure (the SCM's plan on both, the
rebuild on the port's daemons) and its decommission across an SCM
restart (both packages' daemons), and the `admin` CLI verbs of both
packages against their own daemons.

Two departures on purpose are pinned here with both sides: the port's
balancer queues a move's source delete only once the target reports the
copy, and the port's replication manager plans again the indexes of a
copy whose draining source died. Two faults the packages share are
pinned the same way: the excess replica's delete queued on every scan,
and a copy planned off a draining node that stopped, never planned
again before the node is DEAD.
"""

import contextlib
import io
import json
import shutil
import time
import types

import numpy as np
import pytest

from ozone_tpu.codec.api import CoderOptions as JCoderOptions
from ozone_tpu.net import daemons as j_daemons
from ozone_tpu.net.scm_service import GrpcScmClient as JScmClient
from ozone_tpu.scm import balancer as j_balancer
from ozone_tpu.scm import container_manager as j_cm
from ozone_tpu.scm import decommission as j_decommission
from ozone_tpu.scm import node_manager as j_nm
from ozone_tpu.scm import pipeline as j_pipeline
from ozone_tpu.scm import placement as j_placement
from ozone_tpu.scm import replication_manager as j_rm
from ozone_tpu.scm import scm as j_scm
from ozone_tpu.storage import datanode as j_datanode
from ozone_tpu.storage import ids as j_ids
from ozone_tpu.utils import checksum as j_checksum
from ozone_tpu.utils import events as j_events
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ozone_client import OzoneClient
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.net import daemons
from ozone_tpu_torch.net.om_service import RemoteOmClient
from ozone_tpu_torch.net.scm_service import RemoteScmClient
from ozone_tpu_torch.scm import balancer, decommission, placement, scm
from ozone_tpu_torch.scm import container_manager as cm
from ozone_tpu_torch.scm import node_manager as nm
from ozone_tpu_torch.scm import pipeline
from ozone_tpu_torch.scm import replication_manager as rm
from ozone_tpu_torch.storage import datanode
from ozone_tpu_torch.storage import ids
from ozone_tpu_torch.utils import checksum, events

PORT = types.SimpleNamespace(
    nm=nm, placement=placement, cm=cm, rm=rm, balancer=balancer,
    decommission=decommission, scm=scm, pipeline=pipeline, ids=ids,
    datanode=datanode, checksum=checksum, events=events,
    CoderOptions=CoderOptions, name="port")
REF = types.SimpleNamespace(
    nm=j_nm, placement=j_placement, cm=j_cm, rm=j_rm, balancer=j_balancer,
    decommission=j_decommission, scm=j_scm, pipeline=j_pipeline, ids=j_ids,
    datanode=j_datanode, checksum=j_checksum, events=j_events,
    CoderOptions=JCoderOptions, name="reference")
BOTH = (PORT, REF)


def _both(fn):
    """fn(package) on the port, then on the reference."""
    return [fn(p) for p in BOTH]


def _commands(nodes) -> dict:
    """Every node's queued commands, as comparable tuples."""
    out = {}
    for n in nodes.nodes():
        cmds = []
        for c in nodes._commands.get(n.dn_id, []):
            if isinstance(c, dict):
                cmds.append(("dict", tuple(sorted(c.items()))))
            else:
                d = dict(vars(c))
                d.pop("replication", None)
                cmds.append((type(c).__name__, tuple(sorted(
                    (k, tuple(sorted(v.items())) if isinstance(v, dict) else v)
                    for k, v in d.items()))))
        out[n.dn_id] = cmds
    return out


def _mini_scm(p, n=6, racks=1, capacity=1000):
    """The reference test's SCM parts: n nodes, rack-scatter placement
    seeded with 7, a small container size."""
    nodes = p.nm.NodeManager()
    for i in range(n):
        nodes.register(f"dn{i}", rack=f"/r{i % racks}",
                       capacity_bytes=capacity)
    pl = p.placement.RackScatterPlacement(nodes, seed=7)
    containers = p.cm.ContainerManager(nodes, pl, container_size=10_000)
    return nodes, pl, containers


def _closed_ec(p, containers, ec="rs-3-2-4096", excluded=None):
    """An EC container allocated and CLOSED with every index reported."""
    opts = p.CoderOptions.parse(ec)
    g = containers.allocate_block(p.pipeline.ReplicationConfig.from_ec(opts),
                                  100, excluded=excluded)
    c = containers.get(g.container_id)
    c.state = p.ids.ContainerState.CLOSED
    for i, dn in enumerate(g.pipeline.nodes):
        c.replicas[dn] = p.cm.ContainerReplica(dn, "CLOSED", i + 1)
    return g, c


# ---------------------------------------------------------------- placement
@pytest.mark.parametrize("policy", ["RandomPlacement", "CapacityPlacement",
                                    "RackScatterPlacement"])
@pytest.mark.parametrize("seed", [0, 7])
def test_placement_draws_equal_the_reference(policy, seed):
    """Seeded draws of every policy over skewed usage, three racks, an
    excluded node, a draining node and a storage-dead node: the same
    nodes, call for call, and the same refusal when too few remain."""
    def run(p):
        nodes = p.nm.NodeManager()
        for i in range(9):
            nodes.register(f"dn{i}", rack=f"/r{i % 3}", capacity_bytes=1000)
            nodes.get(f"dn{i}").used_bytes = (i * 137) % 1000
        nodes.get("dn4").op_state = p.nm.NodeOperationalState.DECOMMISSIONING
        nodes.get("dn5").healthy_volumes = 0
        pol = getattr(p.placement, policy)(nodes, seed=seed)
        picks = [[n.dn_id for n in pol.choose(k, excluded=["dn0"])]
                 for k in (1, 3, 2, 5, 6)]
        try:
            pol.choose(7)
            refused = None
        except p.placement.PlacementError as e:
            refused = str(e)
        return picks, refused

    port, ref = _both(run)
    assert port == ref
    assert all(not {"dn0", "dn4", "dn5"} & set(p) for p in port[0])


def test_rack_scatter_validate():
    cases = [(r, t, c) for r in range(5) for t in range(5) for c in (1, 3, 9)]
    assert [placement.RackScatterPlacement.validate(*x) for x in cases] == \
        [j_placement.RackScatterPlacement.validate(*x) for x in cases]


# --------------------------------------------------------------- op states
def test_op_state_commands_seeds_and_persistence(tmp_path):
    """set_op_state queues the set-op-state command and persists through
    the hook; seeded records win over a node's echo at registration; an
    unknown echo leaves the node IN_SERVICE."""
    def run(p):
        nodes = p.nm.NodeManager()
        seen = []
        nodes.on_op_state_change = lambda dn, st: seen.append((dn, st))
        nodes.seed_op_states({"dn1": "DECOMMISSIONING"})
        nodes.register("dn0")
        nodes.register("dn1", op_state="IN_MAINTENANCE")
        nodes.register("dn2", op_state="IN_MAINTENANCE")
        nodes.register("dn3", op_state="BOGUS")
        nodes.set_op_state("dn0", p.nm.NodeOperationalState.IN_MAINTENANCE)
        nodes.set_op_state("dn1", p.nm.NodeOperationalState.IN_SERVICE)
        states = {n.dn_id: n.op_state.value for n in nodes.nodes()}
        return (states, seen, _commands(nodes),
                [nodes.pending_commands(f"dn{i}") for i in range(4)],
                dict(nodes._seeded_op),
                [n.dn_id for n in nodes.nodes(p.nm.NodeState.HEALTHY)])

    port, ref = _both(run)
    assert port == ref
    assert port[0] == {"dn0": "IN_MAINTENANCE", "dn1": "IN_SERVICE",
                       "dn2": "IN_MAINTENANCE", "dn3": "IN_SERVICE"}


def test_decommission_drain_flow():
    """The reference test on both: a draining holder is copied, not
    rebuilt; the monitor finalizes once the copy is reported."""
    def run(p):
        nodes, pl, containers = _mini_scm(p)
        rmgr = p.rm.ReplicationManager(containers, nodes, pl)
        mon = p.decommission.DecommissionMonitor(nodes, containers, rmgr)
        g, c = _closed_ec(p, containers)
        victim = g.pipeline.nodes[0]
        mon.start_decommission(victim)
        rep = rmgr.run_once()
        count = p.rm.ECReplicaCount(c, nodes)
        cmds = _commands(nodes)
        reps = [x for dn in cmds for x in nodes._commands[dn]
                if isinstance(x, p.rm.ReplicateCommand)]
        first = mon.run_once()
        c.replicas[reps[0].target] = p.cm.ContainerReplica(
            reps[0].target, "CLOSED", 1)
        second = mon.run_once()
        return (list(g.pipeline.nodes), rep.under_replicated == [c.id],
                dict(count.draining), count.missing_indexes, cmds,
                [(r.source, r.target, r.replica_index) for r in reps],
                first, second, nodes.get(victim).op_state.value)

    port, ref = _both(run)
    assert port == ref
    assert port[6] == [] and port[7] == [port[0][0]]
    assert port[8] == "DECOMMISSIONED"


def test_maintenance_and_recommission_trim_the_excess():
    """A node in maintenance is copied off like a draining one; once it
    is recommissioned its replica counts again and the excess is
    deleted, on both."""
    def run(p):
        nodes, pl, containers = _mini_scm(p, n=7)
        rmgr = p.rm.ReplicationManager(containers, nodes, pl)
        mon = p.decommission.DecommissionMonitor(nodes, containers, rmgr)
        g, c = _closed_ec(p, containers)
        victim = g.pipeline.nodes[2]
        mon.start_maintenance(victim)
        rmgr.run_once()
        copies = [(dn, x.source, x.replica_index)
                  for dn, q in nodes._commands.items() for x in q
                  if isinstance(x, p.rm.ReplicateCommand)]
        for dn, _, idx in copies:
            c.replicas[dn] = p.cm.ContainerReplica(dn, "CLOSED", idx)
        mon.recommission(victim)
        for q in nodes._commands.values():
            q.clear()
        rep = rmgr.run_once()
        return copies, rep.over_replicated, _commands(nodes), mon.run_once()

    port, ref = _both(run)
    assert port == ref
    assert port[0] and port[1]


# ----------------------------------------------------- shared faults pinned
def test_excess_delete_is_queued_on_every_scan():
    """Shared fault: the excess replica's DeleteReplicaCommand is queued
    again on each scan until a report drops the replica, so the second
    one reaches a datanode that already deleted it."""
    def run(p):
        nodes, pl, containers = _mini_scm(p, n=7)
        rmgr = p.rm.ReplicationManager(containers, nodes, pl)
        g, c = _closed_ec(p, containers)
        spare = next(n.dn_id for n in nodes.nodes()
                     if n.dn_id not in g.pipeline.nodes)
        c.replicas[spare] = p.cm.ContainerReplica(spare, "CLOSED", 3)
        rmgr.run_once()
        rmgr.run_once()
        return _commands(nodes)

    port, ref = _both(run)
    assert port == ref
    deletes = [x for q in port.values() for x in q
               if x[0] == "DeleteReplicaCommand"]
    assert len(deletes) == 2


def test_copy_off_a_stopped_draining_node():
    """A copy is planned off a draining holder, which then stops: its
    ReplicateCommand fails on the target (not modelled here) and neither
    package plans again while the node is only STALE (shared fault).
    Once the node is DEAD the port drops that plan and rebuilds the index
    by decode; the reference keeps it pending (departure on purpose)."""
    def run(p):
        t = [0.0]
        nodes = p.nm.NodeManager(stale_after_s=5, dead_after_s=10,
                                 clock=lambda: t[0])
        for i in range(7):
            nodes.register(f"dn{i}", capacity_bytes=1000)
        s = types.SimpleNamespace(nodes=nodes)
        pl = p.placement.RackScatterPlacement(nodes, seed=7)
        containers = p.cm.ContainerManager(nodes, pl, container_size=10_000)
        rmgr = p.rm.ReplicationManager(containers, nodes, pl)
        mon = p.decommission.DecommissionMonitor(nodes, containers, rmgr)
        g, c = _closed_ec(p, containers)
        victim = g.pipeline.nodes[1]
        mon.start_decommission(victim)
        rmgr.run_once()
        planned = _commands(nodes)
        for q in nodes._commands.values():
            q.clear()
        t[0] = 6.0  # the victim stopped heartbeating: STALE
        for n in nodes.nodes():
            if n.dn_id != victim:
                nodes.process_heartbeat(n.dn_id)
        nodes.check_liveness()
        rmgr.run_once()
        stale = (nodes.get(victim).state.value, _commands(nodes))
        t[0] = 12.0  # DEAD: the SCM forgets its replicas
        for n in nodes.nodes():
            if n.dn_id != victim:
                nodes.process_heartbeat(n.dn_id)
        nodes.check_liveness()
        containers.remove_replicas_of_node(victim)
        if p is PORT:
            rmgr.node_dead(victim)  # the SCM's dead-node handler calls it
        rmgr.run_once()
        dead = [(dn, type(x).__name__) for dn, q in nodes._commands.items()
                for x in q]
        del s
        return planned, stale, dead

    port, ref = _both(run)
    assert port[0] == ref[0] and port[1] == ref[1]
    assert port[1][0] == "STALE"
    assert not any(port[1][1].values())  # no new plan while STALE
    assert ref[2] == []  # the reference waits on its pending copy
    assert [kind for _, kind in port[2]] == ["ReconstructionCommand"]


def test_dead_node_handler_drops_its_plans(tmp_path):
    """The port SCM's dead-node event drops the pending plans that name
    the node, so the next scan plans again (the reference keeps them)."""
    s = scm.StorageContainerManager(stale_after_s=1e6, dead_after_s=2e6)
    for i in range(6):
        s.register_datanode(f"dn{i}", capacity_bytes=1000)
    s.safemode.force(False)
    g, c = _closed_ec(PORT, s.containers)
    victim = g.pipeline.nodes[0]
    s.apply_admin_op("decommission", victim)
    s.replication.run_once()
    assert s.replication._pending_nodes
    s.nodes.get(victim).last_heartbeat = -1e9
    s.nodes.check_liveness()
    assert not any(victim in v for v in s.replication._pending_nodes.values())
    s.stop()


# ----------------------------------------------------------------- balancer
def _hot_cold(p):
    nodes, pl, containers = _mini_scm(p, n=4)
    g = containers.allocate_block(p.pipeline.ReplicationConfig.parse("RATIS/1"), 100,
                                  excluded=["dn1", "dn2", "dn3"])
    c = containers.get(g.container_id)
    c.used_bytes = 500
    c.state = p.ids.ContainerState.CLOSED
    c.replicas["dn0"] = p.cm.ContainerReplica("dn0", "CLOSED", 0)
    nodes.get("dn0").used_bytes = 900
    for d in ("dn1", "dn2"):
        nodes.get(d).used_bytes = 500
    nodes.get("dn3").used_bytes = 50
    return nodes, containers, c


def test_balancer_moves_from_hot_to_cold():
    """The same move on both: dn0 (hot) to dn3 (cold). The reference
    queues the source's delete with the copy; the port queues it once
    the target reports the copy (departure on purpose), and completes the
    move when the source's replica is gone."""
    def run(p):
        nodes, containers, c = _hot_cold(p)
        bal = p.balancer.ContainerBalancer(
            containers, nodes, p.balancer.BalancerConfig(threshold=0.1))
        moves = bal.run_iteration()
        queued = (nodes.pending_commands("dn3"),
                  nodes.pending_commands("dn0"))
        again = bal.run_iteration()  # dn0 still reports hot
        return ([(m.container_id, m.replica_index, m.source, m.target,
                  m.size) for m in moves], *queued, len(again), bal, nodes, c)

    port, ref = _both(run)
    assert port[0] == ref[0] == [(port[6].id, 0, "dn0", "dn3", 500)]
    assert ref[1:3] == (1, 1) and port[1:3] == (1, 0)
    # the reference moves the container again from its still-hot source;
    # the port holds a container with a move in flight
    assert ref[3] == 1 and port[3] == 0
    bal, nodes, c = port[4], port[5], port[6]
    assert bal.moving(c.id, 0) and bal.settle() == []
    c.replicas["dn3"] = cm.ContainerReplica("dn3", "CLOSED", 0)
    assert bal.settle() == [] and nodes.pending_commands("dn0") == 1
    del c.replicas["dn0"]
    done = bal.settle()
    assert [(m.source, m.target) for m in done] == [("dn0", "dn3")]
    assert not bal.moving(c.id, 0)


def _imbalanced_scm(p, db):
    """The reference test's SCM: one hot node holding a movable CLOSED
    container."""
    s = p.scm.StorageContainerManager(db_path=db, stale_after_s=1e6,
                                      dead_after_s=2e6, min_datanodes=1)
    for i in range(4):
        s.register_datanode(f"dn{i}", capacity_bytes=1000)
    g = s.containers.allocate_block(p.pipeline.ReplicationConfig.parse("RATIS/1"),
                                    100, excluded=["dn1", "dn2", "dn3"])
    c = s.containers.get(g.container_id)
    c.used_bytes = 500
    s.containers.mark_closed(c.id)
    c.replicas["dn0"] = p.cm.ContainerReplica("dn0", "CLOSED", 0)
    s.nodes.get("dn0").used_bytes = 900
    s.nodes.get("dn1").used_bytes = 500
    s.nodes.get("dn2").used_bytes = 500
    s.nodes.get("dn3").used_bytes = 50
    s.safemode.force(False)
    return s


def test_balancer_state_survives_restart(tmp_path):
    """The balancer's config and progress persist in the SCM store: a
    restarted SCM comes back balancing with the operator's config, and a
    stopped one stays stopped, with the same answers on both."""
    def run(p):
        db = tmp_path / p.name / "scm.db"
        db.parent.mkdir()
        s = _imbalanced_scm(p, db)
        out = [s.apply_admin_op("balancer-start",
                                {"threshold": 0.2,
                                 "max_moves_per_iteration": 3})]
        s.run_background_once()
        out.append(s.balancer_status())
        s.stop()
        s2 = p.scm.StorageContainerManager(db_path=db, stale_after_s=1e6,
                                           dead_after_s=2e6)
        out += [s2.balancer_enabled, s2.balancer_status(),
                s2.balancer.config.max_moves_per_iteration,
                s2.apply_admin_op("balancer-stop")]
        s2.stop()
        s3 = p.scm.StorageContainerManager(db_path=db, stale_after_s=1e6,
                                           dead_after_s=2e6)
        out += [s3.balancer_enabled, s3.balancer_status(),
                s3.containers.service_state("balancer")]
        s3.stop()
        return out

    port, ref = _both(run)
    assert port == ref
    assert port[1]["running"] and port[1]["moves_scheduled"] == 1
    assert port[2] is True and port[3]["threshold"] == 0.2
    assert port[6] is False and port[7]["iterations"] == 1


def test_balancer_state_replicates_to_ha_follower(tmp_path):
    """The balancer's row rides the SCM's replicated mutation log: a
    promoted follower resumes with the operator's config and progress."""
    from ozone_tpu.scm.ha import ReplicatedSCM as JReplicatedSCM
    from ozone_tpu_torch.scm.ha import ReplicatedSCM

    def run(p):
        ha = ReplicatedSCM if p is PORT else JReplicatedSCM
        root = tmp_path / p.name
        root.mkdir()
        leader_scm = _imbalanced_scm(p, root / "a.db")
        follower_scm = p.scm.StorageContainerManager(
            db_path=root / "b.db", stale_after_s=1e6, dead_after_s=2e6,
            min_datanodes=1)
        leader = ha(leader_scm, root / "a.wal", "scm-a", is_leader=True)
        follower = ha(follower_scm, root / "b.wal", "scm-b")
        follower.bootstrap_from(leader)
        leader_scm.apply_admin_op("balancer-start", {"threshold": 0.25})
        leader_scm.run_background_once()
        out = [follower_scm.balancer_enabled, follower_scm.balancer_status()]
        follower.promote()
        follower_scm.safemode.force(False)
        follower_scm.run_background_once()
        out += [follower_scm.balancer.config.threshold,
                follower_scm.balancer_status(),
                follower_scm.containers.snapshot_state()["service_states"]]
        leader_scm.stop()
        follower_scm.stop()
        return out

    port, ref = _both(run)
    assert port == ref
    assert port[0] is True and port[2] == 0.25
    assert port[3]["iterations"] == 1


# -------------------------------------------------------------- admin verbs
def _admin_script(p, tmp):
    """The mutating and read-only admin verbs, with their error codes."""
    s = p.scm.StorageContainerManager(db_path=tmp / "scm.db",
                                      stale_after_s=1e6, dead_after_s=2e6,
                                      placement_seed=3)
    for i in range(7):
        s.register_datanode(f"dn{i}", rack=f"/r{i % 2}", capacity_bytes=1000)
    s.safemode.force(False)
    ec = p.pipeline.ReplicationConfig.from_ec(
        p.CoderOptions.parse("rs-3-2-4096"))
    g = s.allocate_block(ec, 100)
    out = []

    def call(op, target=None):
        try:
            r = dict(s.apply_admin_op(op, target))
            r.pop("pipeline", None)  # a process-wide counter
            # the reference's pipeline safemode rules are not ported
            for k in ("pipelines_total", "pipelines_healthy",
                      "pipelines_with_member"):
                r.pop(k, None)
            out.append((op, r))
        except (ids.StorageError, j_ids.StorageError) as e:
            out.append((op, e.code))

    call("decommission", "dn1")
    call("maintenance", "dn2")
    call("recommission", "dn2")
    call("decommission", "nope")
    call("close-pipeline", g.pipeline.id)
    call("close-pipeline", 987654)
    call("close-pipeline", "x")
    call("close-container", g.container_id)
    call("safemode-enter")
    call("safemode-exit")
    call("balancer-start", {"threshold": 0.3, "max_moves_per_iteration": 2})
    call("balancer-stop")
    call("no-such-op")
    s.run_background_once()
    states = {n.dn_id: n.op_state.value for n in s.nodes.nodes()}
    stored = s.containers.node_op_states()
    s.stop()
    return out, states, stored


def test_admin_verbs_answer_as_the_reference(tmp_path):
    port, ref = _both(lambda p: _admin_script(
        p, (tmp_path / p.name).mkdir() or tmp_path / p.name))
    assert port == ref
    assert port[1]["dn1"] in ("DECOMMISSIONING", "DECOMMISSIONED")
    assert port[2] == {"dn1": port[1]["dn1"]}


def test_finalize_upgrade_waits_for_the_upgrade_slice(tmp_path):
    """finalize-upgrade answers as the reference's does on a store
    written at an older layout: the SCM finalizes, persists the latest
    version and queues a finalize command for every datanode."""
    import json

    from ozone_tpu.scm import scm as ref_scm

    def run(mod, root):
        root.mkdir()
        (root / "layout_version.json").write_text(
            json.dumps({"layout_version": 2, "finalized": False}))
        s = mod.StorageContainerManager(db_path=root / "scm.db")
        s.register_datanode("dn0")
        before = s.layout.metadata_version
        out = s.apply_admin_op("finalize-upgrade")
        again = s.apply_admin_op("finalize-upgrade")
        cmds = s.nodes.process_heartbeat("dn0", 0)
        s.stop()
        return (before, out, again, cmds,
                json.loads((root / "layout_version.json").read_text()))

    got = run(scm, tmp_path / "port")
    assert got == run(ref_scm, tmp_path / "ref")
    assert got[0] == 2 and got[1]["scm"] == "FINALIZATION_DONE"
    assert got[2]["scm"] == "ALREADY_FINALIZED"
    assert {"type": "finalize"} in got[3]
    assert got[4] == {"layout_version": 5, "finalized": True}


def test_replication_status_equals_the_recon_census(tmp_path):
    """`admin replicationmanager`: the port's census equals the counts of
    the reference's Recon container-health view on the same SCM state."""
    from ozone_tpu.recon.recon import ReconScmView

    def run(p):
        nodes, pl, containers = _mini_scm(p, n=8)
        s = types.SimpleNamespace(nodes=nodes, containers=containers)
        g1, c1 = _closed_ec(p, containers)  # healthy
        g2, c2 = _closed_ec(p, containers)  # under: one index lost
        del c2.replicas[g2.pipeline.nodes[0]]
        g3, c3 = _closed_ec(p, containers)  # over: an extra index 2
        spare = next(n.dn_id for n in nodes.nodes()
                     if n.dn_id not in c3.replicas)
        c3.replicas[spare] = p.cm.ContainerReplica(spare, "CLOSED", 2)
        g4, c4 = _closed_ec(p, containers)  # missing: three lost
        for dn in g4.pipeline.nodes[:3]:
            del c4.replicas[dn]
        r = containers.allocate_block(p.pipeline.ReplicationConfig.parse("RATIS/THREE"),
                                      100)
        cr = containers.get(r.container_id)
        cr.state = p.ids.ContainerState.CLOSED
        cr.replicas[r.pipeline.nodes[0]] = p.cm.ContainerReplica(
            r.pipeline.nodes[0], "CLOSED", 0)
        if p is PORT:
            return scm.StorageContainerManager.replication_status(s)
        return {k: len(v)
                for k, v in ReconScmView(s).container_health().items()}

    port, ref = _both(run)
    assert port == ref == {"healthy": 1, "under_replicated": 2,
                           "over_replicated": 1, "missing": 1}


# ------------------------------------------------------------- EventWatcher
def test_event_watcher_completion_and_lease_retry():
    """The reference test on both, on a fake clock."""
    def run(p):
        t = [0.0]
        q = p.events.EventQueue()
        started, timed_out = [], []
        q.subscribe("cmd", started.append)
        w = p.events.EventWatcher(q, "cmd", "cmd-done", lease_timeout_s=0.05,
                                  on_timeout=timed_out.append, max_retries=2)
        w._time = lambda: t[0]
        w.watch("a", {"id": "a"})
        q.publish("cmd-done", "a")
        out = [w.pending_count(), w.check_leases(), list(started)]
        w.watch("b", {"id": "b"})
        for _ in range(3):
            t[0] += 0.06
            out.append((w.check_leases(), len(started)))
        out += [list(timed_out), w.pending_count()]
        return out

    port, ref = _both(run)
    assert port == ref
    assert port[-2] == [{"id": "b"}] and port[-3] == (["b"], 4)


def test_event_watcher_rewatch_during_expiry_keeps_fresh_lease():
    def run(p):
        t = [0.0]
        q = p.events.EventQueue()
        timed_out = []
        w = p.events.EventWatcher(q, "cmd", "cmd-done", lease_timeout_s=0.01,
                                  on_timeout=timed_out.append, max_retries=0)
        w._time = lambda: t[0]
        w.watch("x", {"gen": 1})
        t[0] += 0.02
        q.publish("cmd-done", "x")
        w.watch("x", {"gen": 2})
        out = [w.check_leases(), list(timed_out), w.pending_count()]
        t[0] += 0.02
        out += [w.check_leases(), list(timed_out)]
        return out

    port, ref = _both(run)
    assert port == ref == [[], [], 1, ["x"], [{"gen": 2}]]


# --------------------------------------------------------- volume checker
def _fill(p, dn, cid, nblocks):
    data = np.ones(8192, np.uint8)
    cs = p.checksum.Checksum(p.checksum.ChecksumType.CRC32C, 4096).compute(
        data)
    dn.create_container(cid)
    for i in range(nblocks):
        info = p.ids.ChunkInfo("c0", 0, data.size, cs)
        dn.write_chunk(p.ids.BlockID(cid, i), info, data)
        dn.put_block(p.ids.BlockData(p.ids.BlockID(cid, i), [info]))


def test_capacity_volume_chooser(tmp_path):
    """Skewed volumes: new containers avoid the heavy one under
    "capacity"; round-robin stays the default. Same volume per container
    on both."""
    def run(p):
        root = tmp_path / p.name
        dn = p.datanode.Datanode(root / "dn", num_volumes=3,
                                 volume_policy="capacity")
        _fill(p, dn, 1, 6)
        heavy = next(v for v in dn.volumes if dn._volume_used(v) > 0)
        placed = [dn.volumes.index(heavy)]
        for cid in (2, 3):
            _fill(p, dn, cid, 1)
            c = dn.containers.get(cid)
            assert c.db is not heavy.db
            placed.append(next(i for i, v in enumerate(dn.volumes)
                               if v.db is c.db))
        used = [dn._volume_used(v) for v in dn.volumes]
        rr = p.datanode.Datanode(root / "dn2", num_volumes=2)
        rr.create_container(10)
        rr.create_container(11)
        rr_vols = [next(i for i, v in enumerate(rr.volumes)
                        if v.db is rr.containers.get(c).db) for c in (10, 11)]
        dn.close()
        rr.close()
        return placed, used, rr_vols

    port, ref = _both(run)
    assert port == ref
    assert sorted(port[2]) == [0, 1]


def test_volume_failure_drops_replicas_and_placement(tmp_path):
    """A failed disk's replicas leave the set and the report, new
    containers land on the survivor only, and a node with no healthy
    volume refuses with IO_EXCEPTION: the same on both."""
    def run(p):
        dn = p.datanode.Datanode(tmp_path / p.name / "dn", "dnv",
                                 num_volumes=2)
        c1, c2 = dn.create_container(1), dn.create_container(2)
        out = [c1.db is not c2.db, dn.check_volumes()]
        vol0 = dn.volumes[0]
        victims = [c.id for c in (c1, c2) if c.db is vol0.db]
        shutil.rmtree(vol0.root)
        failed = dn.check_volumes()
        out += [[f.replace(str(tmp_path / p.name), "") for f in failed],
                vol0.failed, dn.healthy_volume_count, victims,
                sorted(c.id for c in dn.list_containers()),
                sorted(r["container_id"] for r in dn.container_report()),
                dn.check_volumes()]
        out.append([dn.create_container(cid).db is dn.volumes[1].db
                    for cid in (10, 11, 12)])
        dn.volumes[1].failed = True
        try:
            dn.create_container(99)
            out.append(None)
        except (ids.StorageError, j_ids.StorageError) as e:
            out.append(e.code)
        dn.close()
        return out

    port, ref = _both(run)
    assert port == ref
    assert port[1] == [] and port[3] is True and port[4] == 1
    assert port[-2] == [True] * 3 and port[-1] == "IO_EXCEPTION"


def test_fence_violation_queues_an_on_demand_scan(tmp_path):
    """A second writer on a bound block is refused and the container is
    queued for a scan once; the queue drains in order, on both."""
    def run(p):
        dn = p.datanode.Datanode(tmp_path / p.name / "dn", "dnf")
        dn.create_container(5)
        dn.create_container(3)
        data = np.zeros(100, np.uint8)
        cs = p.checksum.Checksum(p.checksum.ChecksumType.CRC32C,
                                 4096).compute(data)
        info = p.ids.ChunkInfo("c0", 0, 100, cs)
        codes = []
        for cid in (5, 3, 5):
            bid = p.ids.BlockID(cid, 1)
            dn.write_chunk(bid, info, data, writer="w1")
            try:
                dn.write_chunk(bid, info, data, writer="w2")
            except (ids.StorageError, j_ids.StorageError) as e:
                codes.append(e.code)
        out = [codes, dn.pop_scan_requests(), dn.pop_scan_requests()]
        dn.request_scan(7)
        out.append(dn.pop_scan_requests())
        dn.close()
        return out

    port, ref = _both(run)
    assert port == ref
    assert port[1] == [3, 5] and port[2] == []


# ------------------------------------------------------------ over the wire
#: every wait below is bounded by this many seconds (the reference's
#: rebuild wait, tests/test_distributed.py)
WAIT_S = 20.0


def _wait(what, cond, timeout_s=WAIT_S, detail=None):
    t_end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > t_end:
            seen = f"; {detail()}" if detail is not None else ""
            raise AssertionError(f"{what} within {timeout_s} s{seen}")
        time.sleep(0.1)


@pytest.fixture
def quiet(monkeypatch):
    """The direct codec route and one torch thread for the port's side."""
    import torch

    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(is_port: bool, root, **kw):
    mod = daemons if is_port else j_daemons
    extra = {"device": "cpu"} if is_port else {}
    m = mod.ScmOmDaemon(root / "om.db", stale_after_s=1000.0,
                        dead_after_s=2000.0, **extra, **kw)
    m.start()
    return m


def _datanodes(port: bool, root, meta, n, **kw):
    mod = daemons if port else j_daemons
    extra = {"device": "cpu"} if port else {}
    out = []
    for i in range(n):
        d = mod.DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                               **extra, **kw)
        d.start()
        out.append(d)
    return out


def test_failed_volume_plan_equals_the_reference():
    """A member's only volume fails: its next report drops the replica and
    carries healthy_volumes=0. Both SCMs keep the node HEALTHY, plan the
    same ReconstructionCommand (sources, targets) and leave the node out
    of the next allocation."""
    def run(p):
        s = p.scm.StorageContainerManager(stale_after_s=1e6,
                                          dead_after_s=2e6,
                                          placement_seed=11)
        for i in range(7):
            s.register_datanode(f"dn{i}", rack=f"/r{i % 3}",
                                capacity_bytes=1000)
        ec = p.pipeline.ReplicationConfig.from_ec(
            p.CoderOptions.parse("rs-3-2-4096"))
        g = s.allocate_block(ec, 100)
        for i, dn in enumerate(g.pipeline.nodes):
            s.heartbeat(dn, container_report=[{
                "container_id": g.container_id, "state": "CLOSED",
                "replica_index": i + 1, "block_count": 1,
                "used_bytes": 100}])
        victim = g.pipeline.nodes[1]
        s.heartbeat(victim, container_report=[], healthy_volumes=0)
        s.run_background_once()
        cmds = {}
        for n in s.nodes.nodes():
            for c in s.nodes._commands.get(n.dn_id, []):
                if isinstance(c, p.rm.ReplicateCommand) or \
                        type(c).__name__ == "ReconstructionCommand":
                    cmds[n.dn_id] = (type(c).__name__, c.container_id,
                                     dict(c.sources), dict(c.targets))
        node = s.nodes.get(victim)
        nxt = s.allocate_block(ec, 100, excluded=[])
        s.stop()
        return (list(g.pipeline.nodes), cmds, node.state.value,
                node.healthy_volumes, victim in nxt.pipeline.nodes)

    port, ref = _both(run)
    assert port == ref
    assert port[2] == "HEALTHY" and port[3] == 0 and port[4] is False
    (_, (kind, _, _, targets)), = port[1].items()
    assert kind == "ReconstructionCommand" and list(targets) == [2]


def test_volume_failure_triggers_reconstruction(tmp_path, quiet):
    """Over the port's daemons: a datanode's volume fails its disk check,
    its replicas leave the next report, the node stays HEALTHY, and the
    SCM's reconstruction rebuilds the lost unit elsewhere from the report
    delta: every rebuilt chunk and its CRC words equal the lost one's
    (and the reference's CRC32C of the rebuilt bytes), and the key reads
    back byte-exact through the rebuilt replica."""
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader

    meta = _meta(True, tmp_path, block_size=4 * 4096,
                 container_size=1024 * 1024, background_interval_s=0.2)
    dns = _datanodes(True, tmp_path, meta, 6, heartbeat_interval_s=0.2)
    clients = DatanodeClientFactory()
    oz = OzoneClient(RemoteOmClient(meta.address, clients=clients), clients,
                     device="cpu")
    try:
        b = oz.create_volume("vvf").create_bucket("b", replication="rs-3-2-4096")
        data = np.random.default_rng(5).integers(0, 256, 40_000,
                                                 dtype=np.uint8)
        b.write_key("k", data)
        groups = oz.om.key_block_groups(oz.om.lookup_key("vvf", "b", "k"))

        def indexes(skip=None):
            return {g.container_id: sorted(
                r.replica_index for dn, r in meta.scm.containers.get(
                    g.container_id).replicas.items() if dn != skip)
                for g in groups}

        def whole(skip=None):
            return all(v == [1, 2, 3, 4, 5] for v in indexes(skip).values())

        # close only once the SCM holds every replica, and fail the volume
        # only once the groups are CLOSED there (ROADMAP Queue 3)
        _wait("the SCM's replica map", whole, detail=indexes)
        for g in groups:
            for d in dns:
                if d.dn.id in g.pipeline.nodes:
                    try:
                        d.dn.close_container(g.container_id)
                    except ids.StorageError:
                        pass
        _wait("the groups CLOSED on the SCM", lambda: whole() and all(
            meta.scm.containers.get(g.container_id).state.name == "CLOSED"
            for g in groups))
        victim_id = groups[0].pipeline.nodes[1]
        victim = next(d for d in dns if d.dn.id == victim_id)
        bid = ids.BlockID(groups[0].container_id, groups[0].local_id)
        lost = [(ch.offset, ch.length, ch.checksum.checksums,
                 victim.dn.read_chunk(bid, ch).tobytes())
                for ch in victim.dn.get_block(bid).chunks]
        vol = victim.dn.volumes[0]
        shutil.rmtree(vol.root)
        assert victim.dn.check_volumes() == [str(vol.root)]
        assert victim.dn.container_report() == []
        _wait("the rebuild from the report delta",
              lambda: whole(victim_id),
              detail=lambda: (indexes(victim_id),
                              {d.dn.id: d.failed_commands for d in dns}))
        node = meta.scm.nodes.get(victim_id)
        assert node.state.name == "HEALTHY" and node.healthy_volumes == 0
        c = meta.scm.containers.get(groups[0].container_id)
        holder = next(dn for dn, r in c.replicas.items()
                      if r.replica_index == 2 and dn != victim_id)
        hdn = next(d for d in dns if d.dn.id == holder).dn
        rebuilt = [(ch.offset, ch.length, ch.checksum.checksums,
                    hdn.read_chunk(bid, ch, verify=True).tobytes())
                   for ch in hdn.get_block(bid).chunks]
        assert rebuilt == lost
        jck = j_checksum.Checksum(j_checksum.ChecksumType.CRC32C, 16 * 1024)
        assert [jck.compute(np.frombuffer(x[3], np.uint8)).checksums
                for x in rebuilt] == [x[2] for x in rebuilt]
        for g in groups:  # read through the replicas' current homes
            cc = meta.scm.containers.get(g.container_id)
            for dn, r in cc.replicas.items():
                if dn != victim_id:
                    g.pipeline.nodes[r.replica_index - 1] = dn
        for d in dns:
            clients.update_remote(d.dn.id, d.address)
        parts = [ECBlockGroupReader(
            g, CoderOptions.parse("rs-3-2-4096"), clients,
            bytes_per_checksum=16 * 1024, device="cpu").read_all()
            for g in groups]
        assert np.array_equal(np.concatenate(parts)[:data.size], data)
        assert not any(d.failed_commands for d in dns)
    finally:
        oz.om.close()
        clients.close()
        for d in dns:
            d.stop()
        meta.stop()


def test_decommission_survives_scm_restart(tmp_path):
    """The node persists its op state (set-op-state) and echoes it at
    registration; the restarted SCM's store seeds it first: the same on
    both packages' daemons, run one after the other."""
    out = []
    for port in (True, False):
        root = tmp_path / ("port" if port else "ref")
        root.mkdir()
        # a long background interval: the monitor must not finalize the
        # container-less node mid-test
        metas = [_meta(port, root, background_interval_s=1000.0)]
        dns = _datanodes(port, root, metas[0], 3, heartbeat_interval_s=0.1)
        try:
            addr = metas[0].address
            client = (RemoteScmClient if port else JScmClient)(addr)
            answer = client.admin("decommission", "dn1")
            _wait("the op state persisted on dn1",
                  lambda: dns[1]._op_state == "DECOMMISSIONING")
            client.close()
            metas.pop().stop()
            meta2 = _meta(port, root, port=int(addr.rsplit(":", 1)[1]),
                          background_interval_s=1000.0)
            metas.append(meta2)
            seeded = dict(meta2.scm.nodes._seeded_op)
            _wait("dn1 registered again",
                  lambda: meta2.scm.nodes.get("dn1") is not None)
            _wait("dn0 registered again",
                  lambda: meta2.scm.nodes.get("dn0") is not None)
            out.append((answer, seeded,
                        meta2.scm.nodes.get("dn1").op_state.value,
                        meta2.scm.nodes.get("dn0").op_state.value,
                        json.loads((root / "dn1" / "op_state.json")
                                   .read_text())))
        finally:
            for d in dns:
                d.stop()
            for m in metas:
                m.stop()
    assert out[0] == out[1]
    assert out[0][1] == {"dn1": "DECOMMISSIONING"}
    assert out[0][2:4] == ("DECOMMISSIONING", "IN_SERVICE")


def _cli(port: bool, *argv):
    """The CLI's entry point in this process: (exit code, JSON or stderr)."""
    from ozone_tpu.tools import cli as j_cli
    from ozone_tpu_torch.tools import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = (cli if port else j_cli).main(list(argv))
    return rc, (json.loads(out.getvalue()) if rc == 0
                else err.getvalue().split(":")[0])


def test_admin_cli_verbs(tmp_path):
    """`admin datanode|pipeline|balancer|replicationmanager|safemode`
    through each package's CLI against its own daemons: the same answers
    (pipeline ids, process-wide counters, left out) and usage errors."""
    runs = []
    for port in (True, False):
        root = tmp_path / ("port" if port else "ref")
        root.mkdir()
        # the SCM's loops run only where the script says: the balancer's
        # iteration count is part of the answers
        meta = _meta(port, root, background_interval_s=1000.0)
        dns = _datanodes(port, root, meta, 3, heartbeat_interval_s=0.2)
        om = meta.address
        try:
            _wait("3 datanodes", lambda: len(meta.scm.nodes.nodes()) == 3)
            seen = []
            for argv in (
                    ("datanode", "list"),
                    ("datanode", "decommission", "dn2"),
                    ("datanode", "maintenance", "dn1"),
                    ("datanode", "recommission", "dn1"),
                    ("datanode", "decommission"),
                    ("datanode", "decommission", "nope"),
                    ("balancer", "start", "--threshold", "0.2",
                     "--max-moves", "3", "--max-size", "4096"),
                    ("balancer", "status"),
                    ("balancer", "status", "--threshold", "0.1"),
                    ("balancer", "stop"),
                    ("pipeline", "list"),
                    ("pipeline", "close"),
                    ("pipeline", "close", "424242"),
                    ("replicationmanager",),
                    ("safemode", "enter"),
                    ("safemode", "status"),
                    ("safemode", "exit")):
                rc, ans = _cli(port, "admin", *argv, "--om", om)
                if isinstance(ans, dict):
                    for k in ("pipelines_total", "pipelines_healthy",
                              "pipelines_with_member"):
                        ans.pop(k, None)  # pipeline rules: not ported
                if argv == ("datanode", "list"):
                    ans = sorted((n["dn_id"], n["state"], n["op_state"])
                                 for n in ans)
                if argv == ("pipeline", "list"):
                    ans = [p["nodes"] for p in ans["pipelines"]]
                seen.append((argv, rc, ans))
            meta.scm.decommission_monitor.run_once()  # dn2 holds nothing
            seen.append(_cli(port, "admin", "datanode", "list", "--om", om)[1]
                        [2]["op_state"])
            runs.append(seen)
        finally:
            for d in dns:
                d.stop()
            meta.stop()
    assert runs[0] == runs[1]
    by = {x[0]: x[1:] for x in runs[0][:-1]}
    assert by[("datanode", "decommission")] == (2, "error")
    assert by[("datanode", "decommission", "nope")] == (1, "error NODE_NOT_FOUND")
    assert by[("balancer", "status")][1]["threshold"] == 0.2
    assert runs[0][-1] == "DECOMMISSIONED"


def test_create_existing_container_leaves_no_stray(tmp_path):
    """A create of a container already held is refused before a disk is
    touched: the datanode starts again with one copy of it. The
    reference's create writes a descriptor on the next volume first, and
    the stray copy makes its restart refuse (a departure on purpose)."""
    def run(p):
        root = tmp_path / p.name / "dn"
        dn = p.datanode.Datanode(root, "dns", num_volumes=2)
        dn.create_container(7, replica_index=3)
        try:
            dn.create_container(7, replica_index=3)
            code = None
        except (ids.StorageError, j_ids.StorageError) as e:
            code = e.code
        dn.close()
        try:
            again = p.datanode.Datanode(root, "dns", num_volumes=2)
            held = [(c.id, c.replica_index) for c in again.list_containers()]
            again.close()
        except (ids.StorageError, j_ids.StorageError) as e:
            held = e.code
        return code, held

    port, ref = _both(run)
    assert port == ("CONTAINER_EXISTS", [(7, 3)])
    assert ref == ("CONTAINER_EXISTS", "CONTAINER_EXISTS")


def test_lookup_points_units_at_their_homes(tmp_path, quiet):
    """After the SCM rebuilt a dead node's unit elsewhere, a lookup names
    the unit's new home (upstream's refreshPipeline on lookup); the
    stored key row keeps the write's placement, which the reference's
    lookup hands out. The key reads back byte-exact."""
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

    cluster = MiniOzoneCluster(tmp_path, num_datanodes=7, block_size=4 * 4096,
                               stale_after_s=1e6, dead_after_s=2e6,
                               placement_seed=42, device="cpu")
    try:
        oz = cluster.client()
        b = oz.create_volume("v").create_bucket("b", replication="rs-3-2-4096")
        data = np.random.default_rng(3).integers(0, 256, 30_000, dtype=np.uint8)
        b.write_key("k", data)
        row = cluster.om.lookup_key("v", "b", "k")
        g = row["block_groups"][0]
        for dn in cluster.datanodes:
            if dn.id in g["nodes"]:
                dn.close_container(int(g["container_id"]))
        cluster.tick()
        victim = g["nodes"][1]
        cluster.stop_datanode(victim)
        cluster.scm.nodes.get(victim).last_heartbeat = -1e9
        cluster.scm.nodes.check_liveness()
        cluster.tick(3)
        moved0 = cluster.om.metrics.counter("units_relocated").value
        info = cluster.om.lookup_key("v", "b", "k")
        nodes = info["block_groups"][0]["nodes"]
        c = cluster.scm.containers.get(int(g["container_id"]))
        home = next(dn for dn, r in c.replicas.items() if r.replica_index == 2)
        assert nodes[1] == home != victim
        assert [n for i, n in enumerate(nodes) if i != 1] == \
            [n for i, n in enumerate(g["nodes"]) if i != 1]
        assert cluster.om.metrics.counter("units_relocated").value == moved0 + 1
        stored = cluster.om.store.get("keys", "/v/b/k")
        assert stored["block_groups"][0]["nodes"] == g["nodes"]
        assert np.array_equal(b.read_key("k"), data)
    finally:
        cluster.close()


def test_on_demand_scan_drains_writer_free_containers(tmp_path, quiet,
                                                      monkeypatch):
    """A write-fence violation queues its container; the datanode daemon
    scrubs it once it is writer-free and keeps an OPEN one queued (the
    reference daemon's `_drain_scan_requests`)."""
    monkeypatch.setenv("OZONE_TPU_NATIVE_DATAPATH", "0")
    d = daemons.DatanodeDaemon(tmp_path / "dn", "dnq", "127.0.0.1:1",
                               device="cpu", scan_interval_s=0)
    scanned = []
    monkeypatch.setattr(d._scrubber, "scrub_container",
                        lambda dn, cid: scanned.append(cid) or [])
    try:
        data = np.zeros(100, np.uint8)
        info = ids.ChunkInfo("c0", 0, 100, checksum.Checksum(
            checksum.ChecksumType.CRC32C, 4096).compute(data))
        for cid in (4, 9):
            d.dn.create_container(cid)
            d.dn.write_chunk(ids.BlockID(cid, 1), info, data, writer="w1")
            with pytest.raises(ids.StorageError):
                d.dn.write_chunk(ids.BlockID(cid, 1), info, data, writer="w2")
        d.dn.close_container(9)
        d._drain_scan_requests()
        assert scanned == [9] and d.dn.pop_scan_requests() == [4]
        d.dn.request_scan(4)
        d.dn.close_container(4)
        d._drain_scan_requests()
        assert scanned == [9, 4] and d.dn.pop_scan_requests() == []
    finally:
        d.stop()


def test_plans_wait_for_every_member_report_after_close():
    """A container closes on its first CLOSED report while one member's
    report is late. The reference plans that member's index as lost at
    once (its ReconstructionCommand would meet CONTAINER_EXISTS); the
    port waits until every HEALTHY member has reported since the close,
    then has nothing to plan (a departure on purpose, ROADMAP Queue 3)."""
    def run(p):
        s = p.scm.StorageContainerManager(stale_after_s=1e6, dead_after_s=2e6,
                                          placement_seed=5)
        for i in range(7):
            s.register_datanode(f"dn{i}", capacity_bytes=1000)
        ec = p.pipeline.ReplicationConfig.from_ec(
            p.CoderOptions.parse("rs-3-2-4096"))
        g = s.allocate_block(ec, 100)
        late = g.pipeline.nodes[3]

        def report(dn, state):
            s.heartbeat(dn, container_report=[{
                "container_id": g.container_id, "state": state,
                "replica_index": g.pipeline.nodes.index(dn) + 1,
                "block_count": 1, "used_bytes": 100}])

        for dn in g.pipeline.nodes:
            if dn != late:
                report(dn, "CLOSED")
        s.replication.run_once()
        planned = sorted((dn, type(c).__name__) for dn, q in
                         s.nodes._commands.items() for c in q
                         if type(c).__name__ == "ReconstructionCommand")
        for q in s.nodes._commands.values():
            q.clear()
        report(late, "CLOSED")
        s.replication.run_once()
        after = [c for q in s.nodes._commands.values() for c in q
                 if type(c).__name__ == "ReconstructionCommand"]
        s.stop()
        return s.containers.get(g.container_id).state.value, planned, after

    port, ref = _both(run)
    assert port[0] == ref[0] == "CLOSED"
    assert len(ref[1]) == 1 and port[1] == []
    assert port[2] == []


# ------------------------------------- safemode's pipeline rules (slice 22)
def _restarted_scm(p, tmp, members=3):
    """An SCM with a RATIS/THREE pipeline in its store, restarted: the
    pipeline is recovered OPEN and gates safemode."""
    db = tmp / f"{p.name}-scm.db"
    s = p.scm.StorageContainerManager(db_path=db, stale_after_s=1e6,
                                      dead_after_s=2e6)
    for i in range(members):
        s.register_datanode(f"dn{i}")
    s.allocate_block(p.pipeline.ReplicationConfig.parse("RATIS/THREE"), 500)
    s.stop()
    return db, p.scm.StorageContainerManager(db_path=db, stale_after_s=1e6,
                                             dead_after_s=2e6)


def test_pipeline_safemode_rules_gate_until_members_return(tmp_path):
    """HealthyPipelineSafeModeRule and OneReplicaPipelineSafeModeRule: a
    recovered pipeline holds safemode until its members re-register; one
    member back satisfies the one-replica rule, not the healthy one."""
    def run(p):
        _, s = _restarted_scm(p, tmp_path)
        s.register_datanode("dn0")
        out = [s.safemode.status(), s.safemode.in_safemode()]
        s.register_datanode("dn1")
        s.register_datanode("dn2")
        out += [s.safemode.in_safemode(), s.safemode.status()]
        s.stop()
        return out

    port, ref = _both(run)
    assert port == ref
    assert port[0]["pipelines_total"] == 1 and port[0]["pipelines_with_member"] == 1
    assert port[1] is True and port[2] is False
    assert port[3]["pipelines_healthy"] == 1


def test_safemode_exit_is_one_way_and_prunes_dead_pipelines(tmp_path):
    def run(p):
        db, s = _restarted_scm(p, tmp_path)
        for i in range(3):
            s.register_datanode(f"dn{i}")
        out = [s.safemode.in_safemode()]
        s.nodes.get("dn0").state = p.nm.NodeState.STALE
        out.append(s.safemode.in_safemode())  # exit latched
        s.stop()
        s3 = p.scm.StorageContainerManager(db_path=db, stale_after_s=1e6,
                                           dead_after_s=2e6)
        s3.register_datanode("dnX")
        out.append(s3.safemode.in_safemode())
        for pl in list(s3.containers.pipelines()):
            s3.containers._pipelines.pop(pl.id)
        out.append(s3.safemode.in_safemode())
        s3.stop()
        return out

    port, ref = _both(run)
    assert port == ref == [False, False, True, False]


def test_dead_member_closes_pipeline_and_releases_safemode(tmp_path):
    def run(p):
        _, s = _restarted_scm(p, tmp_path)
        s.register_datanode("dnX")
        out = [s.safemode.in_safemode()]
        for pl in s.containers.pipelines():
            pl.state = p.pipeline.PipelineState.CLOSED
        out.append(s.safemode.in_safemode())
        out.append(s.safemode.status()["pipelines_total"])
        s.stop()
        return out

    port, ref = _both(run)
    assert port == ref == [True, False, 0]


def test_safemode_defaults_are_the_references():
    from ozone_tpu.scm.safemode import SafeModeConfig as JConfig
    from ozone_tpu_torch.scm.safemode import SafeModeConfig

    assert SafeModeConfig() == SafeModeConfig(**vars(JConfig()))
    assert (SafeModeConfig().healthy_pipeline_fraction,
            SafeModeConfig().one_replica_pipeline_fraction) == (0.10, 0.90)


# --------------------------------- container transfer codecs (slice 22)
def _seed_packer_dn(p, root, name="dn0"):
    dn = p.datanode.Datanode(root / name, dn_id=name)
    dn.create_container(1)
    data = np.random.default_rng(0).integers(0, 256, 200_000, dtype=np.uint8)
    info = p.ids.ChunkInfo("c0", 0, data.size)
    dn.write_chunk(p.ids.BlockID(1, 1), info, data)
    dn.put_block(p.ids.BlockData(p.ids.BlockID(1, 1), [info]))
    dn.close_container(1)
    return dn, data


def _codecs():
    from ozone_tpu_torch.storage import container_packer as cp

    return cp.available_codecs()


@pytest.mark.parametrize("codec", _codecs())
def test_packer_roundtrip_every_codec(tmp_path, codec):
    from ozone_tpu_torch.storage import container_packer as cp

    src, data = _seed_packer_dn(PORT, tmp_path, "src")
    blob = cp.export_container(src.get_container(1), compression=codec)
    dst = datanode.Datanode(tmp_path / "dst", dn_id="dst")
    c = cp.import_container(dst, blob)
    got = dst.read_chunk(ids.BlockID(1, 1), c.get_block(ids.BlockID(1, 1)).chunks[0])
    np.testing.assert_array_equal(got, data)
    src.close()
    dst.close()


def test_zstd_beats_none_on_size(tmp_path):
    from ozone_tpu_torch.storage import container_packer as cp

    if "zstd" not in cp.available_codecs():
        pytest.skip("no zstandard in this interpreter")
    src, _ = _seed_packer_dn(PORT, tmp_path, "src")
    plain = cp.export_container(src.get_container(1), compression="none")
    z = cp.export_container(src.get_container(1), compression="zstd")
    assert len(z) < len(plain) and z[:4] == cp._ZSTD_MAGIC
    src.close()


def test_lz4_frames_when_the_module_imports(tmp_path):
    from ozone_tpu_torch.storage import container_packer as cp

    if "lz4" not in cp.available_codecs():
        pytest.skip("no lz4 in this interpreter")
    src, data = _seed_packer_dn(PORT, tmp_path, "src")
    blob = cp.export_container(src.get_container(1), compression="lz4")
    assert blob[:4] == cp._LZ4_MAGIC
    dst = datanode.Datanode(tmp_path / "dst", dn_id="dst")
    c = cp.import_container(dst, blob)
    got = dst.read_chunk(ids.BlockID(1, 1), c.get_block(ids.BlockID(1, 1)).chunks[0])
    np.testing.assert_array_equal(got, data)
    src.close()
    dst.close()


def test_negotiation_prefers_best_mutual():
    from ozone_tpu.storage import container_packer as j_cp
    from ozone_tpu_torch.storage import container_packer as cp

    ours = cp.available_codecs()
    assert ours == j_cp.available_codecs()
    assert cp.negotiate_codec(list(ours)) == ours[0]
    for offer in (list(ours), ["gzip", "none"], ["none"], None, [],
                  ["snappy-unknown"], ["lz4", "gzip"], ["zstd"]):
        assert cp.negotiate_codec(offer) == j_cp.negotiate_codec(offer), offer
    assert cp.negotiate_codec(None) == "gzip"
    assert cp.negotiate_codec(["snappy-unknown"]) == "gzip"


def test_unsupported_codec_refused_with_code(tmp_path, monkeypatch):
    from ozone_tpu_torch.storage import container_packer as cp

    if "zstd" not in cp.available_codecs():
        pytest.skip("no zstandard in this interpreter")
    src, _ = _seed_packer_dn(PORT, tmp_path, "src")
    blob = cp.export_container(src.get_container(1), compression="zstd")
    monkeypatch.setattr(cp, "_zstd", lambda: None)  # the receiver lacks zstd
    dst = datanode.Datanode(tmp_path / "dst", dn_id="dst")
    with pytest.raises(ids.StorageError) as ei:
        cp.import_container(dst, blob)
    assert ei.value.code == cp.UNSUPPORTED_COMPRESSION
    assert dst.list_containers() == []
    src.close()
    dst.close()


def test_export_over_rpc_negotiates_and_falls_back_to_gzip(tmp_path, monkeypatch):
    """Over the wire: the server picks the best codec both sides have and
    import identifies it by its magic; a receiver that cannot decompress
    the sender's codec answers UNSUPPORTED_COMPRESSION and the sender
    retries with gzip."""
    from ozone_tpu_torch.net.dn_service import DatanodeRpcService, RpcDatanodeClient
    from ozone_tpu_torch.net.rpc import RpcServer
    from ozone_tpu_torch.storage import container_packer as cp

    src, data = _seed_packer_dn(PORT, tmp_path, "src")
    dst = datanode.Datanode(tmp_path / "dst", dn_id="dst")
    servers = []
    for dn in (src, dst):
        s = RpcServer()
        DatanodeRpcService(dn, s)
        s.start()
        servers.append(s)
    a = RpcDatanodeClient("src", servers[0].address)
    b = RpcDatanodeClient("dst", servers[1].address)
    try:
        blob = a.export_container(1)
        want = cp.available_codecs()[0]
        magic = {"zstd": cp._ZSTD_MAGIC, "lz4": cp._LZ4_MAGIC}.get(want)
        if magic is not None:
            assert blob[:4] == magic
        fallback = want == "zstd"
        if fallback:
            import threading

            real = cp._zstd

            def receiver_without_zstd():
                # the receiving server's workers have no zstd; the sender,
                # which recompresses, has
                if threading.current_thread().name.startswith("rpc-"):
                    return None
                return real()

            monkeypatch.setattr(cp, "_zstd", receiver_without_zstd)
        recompressed = []
        compress = cp.compress_blob
        monkeypatch.setattr(cp, "compress_blob", lambda name, d: (
            recompressed.append(name), compress(name, d))[1])
        assert b.import_container(blob, container_id=1) == 1
        # the refused zstd upload was sent again as gzip
        assert recompressed == (["gzip"] if fallback else [])
        got = dst.read_chunk(ids.BlockID(1, 1),
                             dst.get_container(1).get_block(ids.BlockID(1, 1)).chunks[0])
        np.testing.assert_array_equal(got, data)
    finally:
        a.close()
        b.close()
        for s in servers:
            s.stop()
        src.close()
        dst.close()


def test_rebuild_may_target_the_unhealthy_holder():
    """Shared fault (ROADMAP Queue 3): a unit whose replica a scrub marked
    UNHEALTHY is planned for rebuild with targets chosen outside the
    present holders only, so the node that holds the UNHEALTHY replica
    can be chosen; with every node in the group it is the only choice,
    and its import meets CONTAINER_EXISTS. Both packages plan alike."""
    def run(p):
        nodes, pl, containers = _mini_scm(p, n=5)
        rmgr = p.rm.ReplicationManager(containers, nodes, pl)
        g, c = _closed_ec(p, containers)
        sick = g.pipeline.nodes[1]
        c.replicas[sick] = p.cm.ContainerReplica(sick, "UNHEALTHY", 2)
        rmgr.run_once()
        return sick, _commands(nodes)

    (p_sick, port), (j_sick, ref) = _both(run)
    assert port == ref and p_sick == j_sick
    recon = [x for x in port[p_sick] if x[0] == "ReconstructionCommand"]
    assert len(recon) == 1
    assert ("targets", ((2, p_sick),)) in recon[0][1]
