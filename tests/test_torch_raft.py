"""The port's Raft core and its Raft-backed OM and SCM, held against the
reference.

Mirrors `tests/test_raft.py` case for case: every scenario runs on the
reference (`ozone_tpu`) and on the port (`ozone_tpu_torch`) from the same
seeded `random` state, with elections driven by hand (timers off), and
the two packages must produce the same trace: each node's log as
(term, data) pairs, the applied state machines, the roles and terms.
On top of the mirror, one scripted sequence of elections, partitions,
membership changes and a leadership transfer must commit the same
entries at the same terms in the same order on both, and `RaftStorage`
directories written by either package load in the other.
"""

import json
import random
import threading
import time
import types

import pytest

import ozone_tpu.consensus.raft as j_raft
import ozone_tpu.om.ha as j_om_ha
import ozone_tpu.om.om as j_om
import ozone_tpu.om.requests as j_rq
import ozone_tpu.scm.ha as j_scm_ha
import ozone_tpu.scm.pipeline as j_pipeline
import ozone_tpu.scm.scm as j_scm
import ozone_tpu_torch.consensus.raft as t_raft
import ozone_tpu_torch.om.ha as t_om_ha
import ozone_tpu_torch.om.om as t_om
import ozone_tpu_torch.om.requests as t_rq
import ozone_tpu_torch.scm.ha as t_scm_ha
import ozone_tpu_torch.scm.pipeline as t_pipeline
import ozone_tpu_torch.scm.scm as t_scm


def _pkg(raft, om_ha, om, rq, scm_ha, pipeline, scm, **om_kw):
    return types.SimpleNamespace(
        InProcessTransport=raft.InProcessTransport,
        NotRaftLeaderError=raft.NotRaftLeaderError,
        RaftConfig=raft.RaftConfig, RaftNode=raft.RaftNode,
        RaftStorage=raft.RaftStorage,
        OMFailoverProxy=om_ha.OMFailoverProxy,
        RaftOzoneManager=om_ha.RaftOzoneManager,
        OzoneManager=lambda path, scm_: om.OzoneManager(path, scm_, **om_kw),
        rq=rq, RaftSCM=scm_ha.RaftSCM,
        SCMFailoverProxy=scm_ha.SCMFailoverProxy,
        ReplicationConfig=pipeline.ReplicationConfig,
        StorageContainerManager=scm.StorageContainerManager)


REF = _pkg(j_raft, j_om_ha, j_om, j_rq, j_scm_ha, j_pipeline, j_scm)
PORT = _pkg(t_raft, t_om_ha, t_om, t_rq, t_scm_ha, t_pipeline, t_scm,
            device="cpu")


def both(tmp_path, scenario, seed: int = 0):
    """Run `scenario(pkg, root)` on the reference, then on the port, from
    the same random state; their traces must be equal. Returns it."""
    traces = []
    for name, pkg in (("ref", REF), ("port", PORT)):
        random.seed(seed)
        traces.append(scenario(pkg, tmp_path / name))
    assert traces[1] == traces[0]
    return traces[1]


def log_of(node) -> list:
    """A node's log as (index, term, data), from its snapshot point."""
    st = node.storage
    return [(st.snapshot_index + 1 + i, e["term"], e["data"])
            for i, e in enumerate(st.entries)]


def trace(nodes, states=None) -> dict:
    return {
        "logs": [log_of(n) for n in nodes],
        "terms": [n.storage.term for n in nodes],
        "roles": [n.role for n in nodes],
        "commit": [n.commit_index for n in nodes],
        "applied": [n.last_applied for n in nodes],
        "states": states,
    }


def make_cluster(P, root, n=3, config=None):
    """n RaftNodes over one in-process transport; each applies into its
    own list so the replicas' state machines can be compared."""
    transport = P.InProcessTransport()
    states: list[list] = [[] for _ in range(n)]
    ids = [f"n{i}" for i in range(n)]
    nodes = [
        P.RaftNode(nid, ids, root / nid, states[i].append,
                   snapshot_fn=(lambda s=states[i]: list(s)),
                   restore_fn=(lambda d, s=states[i]: (s.clear(),
                                                       s.extend(d))),
                   config=config or P.RaftConfig(), transport=transport)
        for i, nid in enumerate(ids)
    ]
    return nodes, states, transport


def _swallow(fn):
    try:
        fn()
    except Exception:
        pass


def _noop_free(entries) -> list:
    return [e["data"] for e in entries
            if not (isinstance(e["data"], dict) and e["data"].get("_noop"))]


# ------------------------------------------------------------ the core
def test_election_and_quorum_commit(tmp_path):
    def run(P, root):
        nodes, states, _ = make_cluster(P, root)
        assert nodes[0].start_election()
        assert nodes[0].is_leader and nodes[0].storage.term == 1
        nodes[0].propose("a")
        nodes[0].propose("b")
        assert states[0] == ["a", "b"]
        nodes[0].tick()
        assert states[1] == states[2] == ["a", "b"]
        return trace(nodes, states)

    both(tmp_path, run)


def test_followers_reject_writes(tmp_path):
    def run(P, root):
        nodes, _, _ = make_cluster(P, root)
        nodes[0].start_election()
        with pytest.raises(P.NotRaftLeaderError) as ei:
            nodes[1].propose("x")
        return ei.value.leader_hint, trace(nodes)

    assert both(tmp_path, run)[0] == "n0"


def test_higher_term_wins_and_old_leader_steps_down(tmp_path):
    def run(P, root):
        nodes, _, _ = make_cluster(P, root)
        nodes[0].start_election()
        nodes[0].propose("a")
        nodes[0].tick()
        assert nodes[1].start_election()
        nodes[1].tick()
        assert not nodes[0].is_leader
        assert nodes[0].storage.term == nodes[1].storage.term
        return trace(nodes)

    both(tmp_path, run)


def test_stale_log_candidate_loses(tmp_path):
    def run(P, root):
        nodes, _, transport = make_cluster(P, root)
        nodes[0].start_election()
        transport.partition("n0", "n2")
        nodes[0].propose("a")
        nodes[0].propose("b")
        transport.heal()
        assert not nodes[2].start_election()  # its log is behind
        assert nodes[1].start_election()
        return trace(nodes)

    both(tmp_path, run)


def test_partition_minority_leader_cannot_commit(tmp_path):
    def run(P, root):
        nodes, states, transport = make_cluster(P, root)
        nodes[0].start_election()
        nodes[0].propose("a")
        nodes[0].tick()
        transport.partition("n0", "n1")
        transport.partition("n0", "n2")
        with pytest.raises(TimeoutError):
            nodes[0].propose("lost", timeout=0.3)
        assert nodes[1].start_election()
        nodes[1].propose("c")
        nodes[1].tick()
        assert states[1] == states[2] == ["a", "c"]
        # heal: the old leader's conflicting entry is truncated
        transport.heal()
        nodes[1].tick()
        nodes[1].tick()
        assert not nodes[0].is_leader
        assert states[0] == ["a", "c"]
        assert _noop_free(nodes[0].storage.entries) == ["a", "c"]
        return trace(nodes, states)

    both(tmp_path, run)


def test_restart_recovers_term_and_log(tmp_path):
    def run(P, root):
        nodes, _, transport = make_cluster(P, root)
        nodes[0].start_election()
        nodes[0].propose("a")
        nodes[0].propose("b")
        term = nodes[0].storage.term
        applied = []
        n0b = P.RaftNode("n0", ["n0", "n1", "n2"], root / "n0",
                         applied.append, transport=transport)
        assert n0b.storage.term == term
        assert n0b.storage.last_index == nodes[0].storage.last_index
        assert n0b.start_election()
        n0b.propose("c")
        assert applied == ["a", "b", "c"]
        return trace([n0b, *nodes[1:]], applied)

    both(tmp_path, run)


def test_snapshot_compaction_and_lagging_follower(tmp_path):
    def run(P, root):
        nodes, states, transport = make_cluster(
            P, root, config=P.RaftConfig(snapshot_trailing=0))
        nodes[0].start_election()
        transport.partition("n0", "n2")
        transport.partition("n1", "n2")
        for x in "abcdef":
            nodes[0].propose(x)
        nodes[0].tick()
        nodes[0].take_snapshot()
        assert nodes[0].storage.snapshot_index > 0
        assert nodes[0].storage.entries == []
        transport.heal()  # n2 is behind the horizon: snapshot install
        nodes[0].tick()
        nodes[0].propose("g")
        nodes[0].tick()
        assert "".join(states[2]) == "abcdefg"
        return trace(nodes, states), nodes[2].storage.snapshot_index

    both(tmp_path, run)


def test_timer_driven_election_after_leader_death(tmp_path):
    """Timers on, the leader dies, the survivors elect and commit. Timing
    decides which node wins, so the packages are held to the same end
    state, not the same leader."""

    def run(P, root):
        nodes, states, transport = make_cluster(P, root)
        for n in nodes:
            n.start_timers()

        def propose_retrying(candidates, value, timeout_s=15.0):
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                # a timed-out propose may still have committed
                if any(value in s for s in states):
                    ldr = next((n for n in candidates if n.is_leader), None)
                    return ldr or candidates[0]
                ldr = next((n for n in candidates if n.is_leader), None)
                if ldr is None:
                    time.sleep(0.02)
                    continue
                try:
                    ldr.propose(value, timeout=5.0)
                    return ldr
                except Exception:
                    time.sleep(0.05)
            raise AssertionError(f"could not commit {value!r} in time")

        try:
            leader = propose_retrying(nodes, "a")
            transport.down.add(leader.node_id)
            survivors = [n for n in nodes if n is not leader]
            new_leader = propose_retrying(survivors, "b")
            idx = nodes.index(new_leader)
            deadline = time.monotonic() + 5.0
            while states[idx] != ["a", "b"] and time.monotonic() < deadline:
                time.sleep(0.02)
            return states[idx], new_leader is not leader
        finally:
            for n in nodes:
                n.stop()

    assert both(tmp_path, run) == (["a", "b"], True)


# --------------------------------------------------- Raft OM and SCM
def test_raft_om_cluster(tmp_path):
    def run(P, root):
        scms = []
        for _ in range(3):
            scm = P.StorageContainerManager(stale_after_s=1e6,
                                            dead_after_s=2e6)
            for d in range(5):
                scm.register_datanode(f"dn{d}")
            scms.append(scm)
        transport = P.InProcessTransport()
        ids = ["om0", "om1", "om2"]
        reps = [P.RaftOzoneManager(P.OzoneManager(root / f"{nid}/om.db",
                                                  scms[i]),
                                   root / f"{nid}/raft", nid, ids,
                                   transport=transport)
                for i, nid in enumerate(ids)]
        reps[0].node.start_election()
        proxy = P.OMFailoverProxy(reps)
        proxy.submit(P.rq.CreateVolume("v"))
        proxy.submit(P.rq.CreateBucket("v", "b", "rs-3-2-4096"))
        reps[0].node.tick()
        for r in reps:
            assert r.om.bucket_info("v", "b")["replication"] == "rs-3-2-4096"
        with pytest.raises(P.rq.OMError) as ei:
            proxy.submit(P.rq.CreateVolume("v"))
        reps[1].node.start_election()
        proxy.submit(P.rq.CreateVolume("v2"))
        reps[1].node.tick()
        vols = [[v["name"] for v in r.om.list_volumes()] for r in reps]
        # the requests' timestamps differ between runs: compare the types
        logs = [[(i, t, d.get("type") if isinstance(d, dict) else d)
                 for i, t, d in log_of(r.node)] for r in reps]
        for r in reps:
            r.stop()
        return vols, logs, ei.value.code

    vols, _, code = both(tmp_path, run)
    assert vols == [["v", "v2"]] * 3 and code == "VOLUME_ALREADY_EXISTS"


def _mk_scm(P, n_dn=5):
    scm = P.StorageContainerManager(min_datanodes=1, placement_seed=7)
    for i in range(n_dn):
        scm.register_datanode(f"dn{i}", rack=f"/rack{i % 3}",
                              capacity_bytes=10**12)
        scm.heartbeat(f"dn{i}", container_report=[])
    return scm


def _group(g) -> tuple:
    return g.container_id, g.local_id, list(g.pipeline.nodes)


def _containers(rep) -> list:
    return sorted((c.id, c.state.value, c.used_bytes, list(c.pipeline.nodes))
                  for c in rep.scm.containers.containers())


def test_fetch_state_reapplies_entries_reverted_by_a_stale_snapshot(
        tmp_path):
    """A fetched state older than the local apply position moves the
    position down and replays the reverted tail from the local log."""

    def run(P, root):
        nodes, states, transport = make_cluster(P, root)
        n0 = nodes[0]
        assert n0.start_election()
        for v in "abcde":
            n0.propose(v)
        stale = {"ok": True, "term": n0.storage.term, "applied": 3,
                 "data": states[0][:2]}
        orig = transport.send
        transport.send = lambda peer, verb, req: (
            stale if verb == "fetch_state" else orig(peer, verb, req))
        try:
            assert n0.fetch_state_from("n1")
        finally:
            transport.send = orig
        assert states[0] == list("abcde") and n0.last_applied == 6
        return trace(nodes, states)

    both(tmp_path, run)


def test_raft_scm_deposed_leader_resyncs(tmp_path):
    """A minority-partitioned SCM leader whose allocation never reached a
    quorum drops the phantom container when it rejoins."""

    def run(P, root):
        transport = P.InProcessTransport()
        ids = ["scm0", "scm1", "scm2"]
        reps = [P.RaftSCM(_mk_scm(P), root / nid, nid, ids,
                          transport=transport, ack_timeout_s=1.0)
                for nid in ids]
        try:
            reps[0].node.start_election()
            proxy = P.SCMFailoverProxy(reps)
            repl = P.ReplicationConfig.parse("rs-3-2-1024k")
            first = _group(proxy.submit("allocate_block", repl, 1 << 20))
            reps[0].node.tick()
            transport.partition("scm0", "scm1")
            transport.partition("scm0", "scm2")
            with pytest.raises(Exception):
                reps[0].submit("allocate_block", repl, 1 << 20)
            assert reps[1].node.start_election()
            second = _group(proxy.submit("allocate_block", repl, 1 << 20))
            reps[1].node.tick()
            transport.heal()
            reps[1].node.tick()
            want = _containers(reps[1])
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if [c[0] for c in _containers(reps[0])] == \
                        [c[0] for c in want] and not reps[0]._needs_resync:
                    break
                time.sleep(0.05)
            return first, second, [c[0] for c in _containers(reps[0])], \
                [c[0] for c in want]
        finally:
            for r in reps:
                r.stop()

    first, second, have, want = both(tmp_path, run)
    assert have == want


def test_raft_scm_cluster(tmp_path):
    def run(P, root):
        transport = P.InProcessTransport()
        ids = ["scm0", "scm1", "scm2"]
        reps = [P.RaftSCM(_mk_scm(P), root / nid, nid, ids,
                          transport=transport) for nid in ids]
        try:
            reps[0].node.start_election()
            proxy = P.SCMFailoverProxy(reps)
            repl = P.ReplicationConfig.parse("rs-3-2-1024k")
            blk = proxy.submit("allocate_block", repl, 1 << 20)
            reps[0].node.tick()
            for r in reps:
                assert r.scm.containers.get(blk.container_id).id \
                    == blk.container_id
            reps[1].node.start_election()
            blk2 = proxy.submit("allocate_block", repl, 1 << 20)
            assert blk2.local_id != blk.local_id
            assert blk2.container_id >= blk.container_id
            reps[1].node.tick()
            return _group(blk), _group(blk2), [_containers(r) for r in reps]
        finally:
            for r in reps:
                r.stop()

    both(tmp_path, run)


# ------------------------------------------------ membership change
def _add_node(P, root, transport, states, nid):
    """A fresh empty node joining an existing transport."""
    states.append([])
    s = states[-1]
    return P.RaftNode(nid, [nid], root / nid, s.append,
                      snapshot_fn=(lambda s=s: list(s)),
                      restore_fn=(lambda d, s=s: (s.clear(), s.extend(d))),
                      transport=transport)


def test_membership_add_grows_ring(tmp_path):
    def run(P, root):
        nodes, states, transport = make_cluster(P, root)
        leader = nodes[0]
        assert leader.start_election()
        leader.propose("before")
        for i in (3, 4):
            nodes.append(_add_node(P, root, transport, states, f"n{i}"))
            assert f"n{i}" in leader.change_membership(add=f"n{i}")
            leader.propose(f"during-{i}")
        leader.propose("after")
        leader.tick()
        assert len(leader.members) == 5
        for st in states:
            assert st == ["before", "during-3", "during-4", "after"]
        assert leader.commit_index == leader.last_applied
        return trace(nodes, states)

    both(tmp_path, run)


def test_membership_config_survives_restart(tmp_path):
    def run(P, root):
        nodes, states, transport = make_cluster(P, root)
        leader = nodes[0]
        assert leader.start_election()
        nodes.append(_add_node(P, root, transport, states, "n3"))
        leader.change_membership(add="n3")
        leader.propose("x")
        leader.tick()
        assert len(nodes[3].members) == 4
        r = P.RaftNode("n3", ["n3"], root / "n3", states[3].append,
                       transport=P.InProcessTransport())
        return sorted(r.members), trace(nodes, states)

    assert both(tmp_path, run)[0] == ["n0", "n1", "n2", "n3"]


@pytest.mark.parametrize("case", ["config_at", "crash_repair",
                                  "install_drops_above", "compact_crash",
                                  "legacy_files"])
def test_storage_cases(tmp_path, case):
    """The five RaftStorage cases of the reference suite (config_at at
    the snapshot base, config crash repair, a snapshot install dropping
    configs above it, a crash mid-compaction, pre-header files), each on
    both packages with the same observations."""

    def run(P, root):
        st = P.RaftStorage(root / "s") if case != "legacy_files" else None
        if case == "config_at":
            st.record_config(5, {"a": "", "b": ""})
            st.record_config(12, {"a": "", "b": "", "c": ""})
            assert st.config_at(12) == st.members
            return [st.config_at(i) for i in (4, 5, 11, 12)]
        if case == "crash_repair":
            ring = {"n0": "", "n1": "", "n2": "127.0.0.1:7"}
            st.append([{"term": 1, "data": {"_config": {"members": ring}}}])
            st2 = P.RaftStorage(root / "s")
            assert st2.members == ring
            return st2.config_history, P.RaftStorage(root / "s").members
        if case == "install_drops_above":
            st.record_config(3, {"a": ""})
            st.record_config(8, {"a": "", "b": ""})
            st.install_snapshot(5, 2, {"s": 1}, members=None)
            return st.members, st.config_history
        if case == "compact_crash":
            st.append([{"term": 1, "data": i} for i in range(6)])
            st.snapshot_index, st.snapshot_term = 4, 1
            st.snapshot_data = {"upto": 4}
            st.persist_snapshot()  # ...and crash before the log and meta
            st2 = P.RaftStorage(root / "s")
            assert [e["data"] for e in st2.entries] == [4, 5]
            return (st2.snapshot_index, st2.snapshot_term,
                    st2.snapshot_data, st2.last_index, st2.term_at(5))
        d = root / "s"
        d.mkdir(parents=True)
        (d / "meta.json").write_text(json.dumps(
            {"term": 3, "voted_for": "n1", "snapshot_index": 2,
             "snapshot_term": 1, "config_history": []}))
        (d / "snapshot.json").write_text(json.dumps(["a", "b"]))
        (d / "log.jsonl").write_text(json.dumps({"term": 2, "data": "c"})
                                     + "\n")
        st = P.RaftStorage(d)
        assert st.entry_at(3)["data"] == "c"
        return st.term, st.snapshot_index, st.snapshot_data, st.last_index

    both(tmp_path, run)


def test_membership_restart_replays_config(tmp_path):
    def run(P, root):
        class RecordingTransport(P.InProcessTransport):
            def __init__(self):
                super().__init__()
                self.peers: dict = {}

            def set_peer(self, node_id, addr):
                self.peers[node_id] = addr

        transport = RecordingTransport()
        states: list[list] = [[] for _ in range(3)]
        ids = ["n0", "n1", "n2"]
        nodes = [P.RaftNode(nid, ids, root / nid, states[i].append,
                            transport=transport)
                 for i, nid in enumerate(ids)]
        assert nodes[0].start_election()
        _add_node(P, root, transport, states, "n3")
        nodes[0].change_membership(add="n3", address="127.0.0.1:7777")
        nodes[0].propose("x")
        nodes[0].tick()
        rt = RecordingTransport()
        r = P.RaftNode("n0", ids, root / "n0", states[0].append,
                       transport=rt)
        seen: list[dict] = []
        r.on_config = seen.append
        return rt.peers, seen

    peers, seen = both(tmp_path, run)
    assert peers.get("n3") == "127.0.0.1:7777"
    assert set(seen[0]) == {"n0", "n1", "n2", "n3"}


def test_membership_revert_notifies_on_config(tmp_path):
    def run(P, root):
        nodes, states, transport = make_cluster(P, root)
        leader = nodes[0]
        assert leader.start_election()
        leader.propose("a")
        rings: list[dict] = []
        leader.on_config = rings.append
        transport.partition("n0", "n1")
        transport.partition("n0", "n2")
        _swallow(lambda: leader.change_membership(
            add="n9", address="127.0.0.1:9999", timeout=0.2))
        assert rings and "n9" in rings[-1]
        assert nodes[1].start_election()
        nodes[1].propose("b")
        transport.heal()
        nodes[1].tick()
        nodes[1].tick()
        assert "n9" not in leader.members and "n9" not in rings[-1]
        return rings, trace(nodes, states)

    both(tmp_path, run)


def test_membership_remove_shrinks_quorum(tmp_path):
    def run(P, root):
        nodes, states, transport = make_cluster(P, root)
        leader = nodes[0]
        assert leader.start_election()
        leader.propose("a")
        members = leader.change_membership(remove="n2")
        assert nodes[2].start_election() is False
        leader.propose("b")
        leader.tick()
        assert states[0] == states[1] == ["a", "b"]
        with pytest.raises(ValueError):
            leader.change_membership(remove="n0")
        return sorted(members), trace(nodes, states)

    assert both(tmp_path, run)[0] == ["n0", "n1"]


def test_membership_snapshot_bootstraps_new_node(tmp_path):
    def run(P, root):
        nodes, states, transport = make_cluster(
            P, root, config=P.RaftConfig(snapshot_trailing=2))
        leader = nodes[0]
        assert leader.start_election()
        for i in range(10):
            leader.propose(f"e{i}")
        leader.take_snapshot()
        assert leader.storage.snapshot_index > 0
        n3 = _add_node(P, root, transport, states, "n3")
        leader.change_membership(add="n3")
        leader.propose("tail")
        leader.tick()
        assert states[3] == [f"e{i}" for i in range(10)] + ["tail"]
        return sorted(n3.members), trace([*nodes, n3], states)

    both(tmp_path, run)


def test_membership_change_serialized(tmp_path):
    def run(P, root):
        nodes, _, transport = make_cluster(P, root)
        leader = nodes[0]
        assert leader.start_election()
        transport.partition("n0", "n1")
        transport.partition("n0", "n2")
        t = threading.Thread(target=lambda: _swallow(
            lambda: leader.change_membership(remove="n2", timeout=0.2)))
        t.start()
        t.join()
        with pytest.raises((RuntimeError, P.NotRaftLeaderError)) as ei:
            leader.change_membership(remove="n1", timeout=0.2)
        transport.heal()
        return type(ei.value).__name__, log_of(leader)

    both(tmp_path, run)


def test_leadership_transfer(tmp_path):
    def run(P, root):
        nodes, states, _ = make_cluster(P, root)
        assert nodes[0].start_election()
        for i in range(5):
            nodes[0].propose({"v": i})
        assert nodes[0].transfer_leadership("n1")
        assert nodes[1].role == "leader" and nodes[0].role != "leader"
        nodes[1].propose({"v": 99})
        assert states[1][-1] == {"v": 99}
        assert nodes[1].transfer_leadership("n1")
        with pytest.raises(ValueError):
            nodes[1].transfer_leadership("nope")
        with pytest.raises(P.NotRaftLeaderError):
            nodes[0].transfer_leadership("n2")
        return trace(nodes, states)

    both(tmp_path, run)


def test_leadership_transfer_catches_target_up(tmp_path):
    def run(P, root):
        nodes, states, transport = make_cluster(P, root)
        assert nodes[0].start_election()
        nodes[0].propose({"v": 0})
        transport.partition("n0", "n2")
        transport.partition("n1", "n2")
        for i in range(1, 4):
            nodes[0].propose({"v": i})
        transport.heal()
        assert nodes[0].transfer_leadership("n2")
        assert nodes[2].role == "leader"
        nodes[2].propose({"v": 4})
        assert [e["v"] for e in states[2]] == [0, 1, 2, 3, 4]
        return trace(nodes, states)

    both(tmp_path, run)


# ------------------------------------------------- beyond the mirror
def test_scripted_sequence_commits_same_entries(tmp_path):
    """One scripted history on five nodes: elections, a partitioned
    leader's lost tail, a removal, an add, a compaction, a transfer. Both
    packages commit the same entries at the same terms in the same
    order, and their commit indexes and applied states agree."""

    def run(P, root):
        nodes, states, transport = make_cluster(
            P, root, n=5, config=P.RaftConfig(snapshot_trailing=3))
        assert nodes[0].start_election()
        for i in range(4):
            nodes[0].propose({"k": i})
        transport.partition("n0", "n1")
        transport.partition("n0", "n2")
        transport.partition("n0", "n3")
        transport.partition("n0", "n4")
        _swallow(lambda: nodes[0].propose("lost", timeout=0.2))
        assert nodes[3].start_election()
        for i in range(4, 8):
            nodes[3].propose({"k": i})
        transport.heal()
        nodes[3].tick()
        nodes[3].change_membership(remove="n1")
        nodes[3].propose({"k": 8})
        nodes[3].take_snapshot()
        nodes.append(_add_node(P, root, transport, states, "n5"))
        nodes[3].change_membership(add="n5")
        assert nodes[3].transfer_leadership("n2")
        for i in range(9, 12):
            nodes[2].propose({"k": i})
        nodes[2].tick()
        committed = [[(i, t, d) for i, t, d in log_of(n)
                      if i <= n.commit_index] for n in nodes]
        return committed, trace(nodes, states)

    committed, tr = both(tmp_path, run)
    assert tr["states"][2] == [{"k": i} for i in range(12)]


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_storage_directories_cross_load(tmp_path, writer, reader):
    """A node directory written by one package (a term and vote, a config
    change, a compaction with its snapshot, entries past it) loads in the
    other with the same term, vote, snapshot, configs and log, and the
    files are byte-identical once both re-persist them."""
    random.seed(0)
    nodes, states, _ = make_cluster(writer, tmp_path / "w",
                                    config=writer.RaftConfig(
                                        snapshot_trailing=1))
    assert nodes[0].start_election()
    for i in range(6):
        nodes[0].propose({"v": i})
    nodes[0].change_membership(add="n3", address="127.0.0.1:7")
    nodes[0].take_snapshot()
    nodes[0].propose({"v": 6})
    nodes[0].storage.close()
    d = tmp_path / "w" / "n0"
    before = {p.name: p.read_bytes() for p in d.iterdir()}
    st = reader.RaftStorage(d)
    w = writer.RaftStorage(d)
    assert (st.term, st.voted_for, st.snapshot_index, st.snapshot_term,
            st.snapshot_data, st.config_history, st.entries) == \
        (w.term, w.voted_for, w.snapshot_index, w.snapshot_term,
         w.snapshot_data, w.config_history, w.entries)
    assert st.last_index == nodes[0].storage.last_index
    st.persist_meta()
    st.persist_snapshot()
    after = {p.name: p.read_bytes() for p in d.iterdir()}
    assert after == before
    # the reader resumes the node: same term, log and applied state
    applied: list = []
    node = reader.RaftNode("n0", ["n0", "n1", "n2"], d, applied.append,
                           restore_fn=lambda data: applied.extend(data),
                           transport=reader.InProcessTransport())
    assert node.storage.term == nodes[0].storage.term
    assert set(node.members) == {"n0", "n1", "n2", "n3"}
    assert applied == states[0][:len(applied)]
    node.stop()
