"""The port's metadata ring (OM and SCM on one Raft ring) held against the
reference.

- An in-process ring of three on `InProcessTransport`, driven by hand
  (timers off), per package: the same requests before and after the
  leader stops, a failover, a compaction and the old leader's revival
  (caught up by snapshot install). Every replica's OM key rows
  (placement aside) and SCM id floors and containers equal the
  reference ring's.
- The lifecycle checkpoint's rejection codes at a ring term above 0,
  through the ring, equal the reference's, and the followers hold the
  leader's state row.
- One port `MiniOzoneHACluster` (three ScmOmDaemons on the port's RPC,
  five DatanodeDaemons, rs-3-2-4096 on the CPU codec): PUT, the leader
  stopped, GET byte-exact; followers answer with the leader's address;
  any replica answers ring-status.
- FSO through the in-process ring (a tree, a directory rename, a
  recursive delete whose purge batches replicate, a failover and a
  revival): every replica's tree equals the reference ring's; and on the
  daemon ring a renamed FSO tree read from the new leader after the old
  one stopped.
- The follower read gate's answers on a ring equal the reference's.
- The promote-mode replicas (`ReplicatedOzoneManager`, `ReplicatedSCM`)
  on one script each: the same answers, indexes and state as the
  reference's.
"""

import random
import time
import types

import numpy as np
import pytest

import ozone_tpu.consensus.meta_ring as j_meta_ring
import ozone_tpu.consensus.raft as j_raft
import ozone_tpu.lifecycle.service as j_lc
import ozone_tpu.om.fso as j_fso
import ozone_tpu.om.om as j_om
import ozone_tpu.om.requests as j_rq
import ozone_tpu.scm.scm as j_scm
import ozone_tpu_torch.consensus.meta_ring as t_meta_ring
import ozone_tpu_torch.consensus.raft as t_raft
import ozone_tpu_torch.lifecycle.service as t_lc
import ozone_tpu_torch.om.fso as t_fso
import ozone_tpu_torch.om.om as t_om
import ozone_tpu_torch.om.requests as t_rq
import ozone_tpu_torch.scm.scm as t_scm
from ozone_tpu_torch.storage.ids import StorageError

#: the bounded wait of every daemon-level step here
WAIT_S = 15.0

REF = types.SimpleNamespace(raft=j_raft, ring=j_meta_ring, om=j_om, rq=j_rq,
                            scm=j_scm, lc=j_lc, fso=j_fso, om_kw={})
PORT = types.SimpleNamespace(raft=t_raft, ring=t_meta_ring, om=t_om,
                             rq=t_rq, scm=t_scm, lc=t_lc, fso=t_fso,
                             om_kw={"device": "cpu"})
IDS = ["m0", "m1", "m2"]


class Ring:
    """Three MetaHARing replicas of one package over one in-process
    transport; a replica can be stopped and revived from its files."""

    def __init__(self, P, root):
        self.P, self.root = P, root
        self.transport = P.raft.InProcessTransport()
        self.reps = {mid: self._make(mid) for mid in IDS}

    def _make(self, mid):
        P = self.P
        scm = P.scm.StorageContainerManager(
            min_datanodes=1, placement_seed=7, stale_after_s=1e6,
            dead_after_s=2e6, db_path=self.root / mid / "scm.db")
        for d in range(5):
            scm.register_datanode(f"dn{d}", rack=f"/rack{d % 3}",
                                  capacity_bytes=10**12)
            scm.heartbeat(f"dn{d}", container_report=[])
        om = P.om.OzoneManager(self.root / mid / "om.db", scm, **P.om_kw)
        rep = P.ring.MetaHARing(
            om, scm, self.root / mid / "raft", mid, IDS,
            transport=self.transport, ack_timeout_s=5.0,
            config=P.raft.RaftConfig(snapshot_trailing=2))
        om.submit = rep.submit_om  # every OM write through the ring
        return rep

    def stop(self, mid):
        self.transport.down.add(mid)
        rep = self.reps.pop(mid)
        rep.stop()
        rep.om.close()

    def revive(self, mid):
        self.transport.down.discard(mid)
        self.reps[mid] = self._make(mid)

    def put(self, leader, name, size):
        om = self.reps[leader].om
        s = om.open_key("v", "b", name)
        g = om.allocate_block(s)
        self.reps[leader]._await_records()  # the daemon's SCM barrier
        g.length = size
        om.commit_key(s, [g], size)

    def tick(self, leader, n=2):
        for _ in range(n):
            self.reps[leader].node.tick()

    def stop_all(self):
        for mid in list(self.reps):
            self.stop(mid)


def _key_rows(rep) -> list:
    """The keys table without what differs run to run: timestamps, object
    ids and placement (nodes, pipeline ids)."""
    rows = []
    for k, v in rep.om.store.iterate("keys"):
        v = {f: x for f, x in v.items()
             if f not in ("created", "modified", "object_id")}
        v["block_groups"] = [
            {f: x for f, x in g.items() if f not in ("nodes", "pipeline_id")}
            for g in v.get("block_groups", [])]
        rows.append((k, v))
    return rows


def _scm_state(rep) -> dict:
    cm = rep.scm.containers
    return {"floors": {k: cm.peek_id_floor(k)
                       for k in ("container", "block", "pipeline")},
            "containers": sorted((c.id, c.state.value, c.used_bytes)
                                 for c in cm.containers())}


def _ring_history(P, root) -> dict:
    ring = Ring(P, root)
    try:
        assert ring.reps["m0"].node.start_election()
        om = ring.reps["m0"].om
        om.create_volume("v")
        om.create_bucket("v", "b", "rs-3-2-4096")
        for i in range(3):
            ring.put("m0", f"k{i}", 1000 * (i + 1))
        ring.tick("m0")
        before = {m: (_key_rows(r), _scm_state(r))
                  for m, r in ring.reps.items()}
        # the leader stops; m1 takes over and the ring writes on
        ring.stop("m0")
        assert ring.reps["m1"].node.start_election()
        for i in range(3, 5):
            ring.put("m1", f"k{i}", 1000 * (i + 1))
        ring.reps["m1"].om.delete_key("v", "b", "k0")
        ring.tick("m1")
        # compaction behind the apply point: the revived replica can
        # only catch up by snapshot install
        ring.reps["m1"].node.take_snapshot()
        ring.put("m1", "k5", 6000)
        ring.revive("m0")
        ring.tick("m1", 3)
        leader = ring.reps["m1"]
        assert ring.reps["m0"].node.last_applied == leader.node.last_applied
        after = {m: (_key_rows(r), _scm_state(r))
                 for m, r in ring.reps.items()}
        terms = sorted(r.node.storage.term for r in ring.reps.values())
        return {"before": before, "after": after, "terms": terms,
                "status": leader.ring_status()["members"]}
    finally:
        ring.stop_all()


def test_ring_state_equals_reference_across_failover(tmp_path):
    random.seed(0)
    ref = _ring_history(REF, tmp_path / "ref")
    random.seed(0)
    port = _ring_history(PORT, tmp_path / "port")
    assert port == ref
    # within the ring every replica holds the same state
    for phase in ("before", "after"):
        states = list(port[phase].values())
        assert all(s == states[0] for s in states)
    keys = [k for k, _ in port["after"]["m0"][0]]
    assert keys == [f"/v/b/k{i}" for i in range(1, 6)]


def _fso_tree(rep) -> dict:
    """A replica's FSO namespace without its run-random object ids: the
    file walk, every directory's listing and the deletion queues."""
    om = rep.om
    dirs = [""] + [k["path"] for k in om.list_status("v", "f", "")
                   if k["type"] == "DIRECTORY"]
    listing = {}
    while dirs:
        d = dirs.pop()
        rows = om.list_status("v", "f", d)
        listing[d] = [(r["type"], r["path"], r.get("size")) for r in rows]
        dirs += [r["path"] for r in rows if r["type"] == "DIRECTORY"]
    return {"files": [(k["name"], k["size"])
                      for k in om.list_keys("v", "f")],
            "listing": listing,
            "deleted_dirs": len(list(om.store.iterate("deleted_dirs"))),
            "deleted_keys": sorted(k.rsplit(":", 1)[0].rsplit("/", 1)[1]
                                   for k, _ in om.store.iterate(
                                       "deleted_keys"))}


def _fso_ring_history(P, root) -> dict:
    """FSO writes through the ring: a tree, a directory rename and a
    recursive delete whose purge batches replicate; the leader stops and
    the new leader and the revived replica hold the same tree."""
    fso = P.fso
    ring = Ring(P, root)
    try:
        assert ring.reps["m0"].node.start_election()
        om = ring.reps["m0"].om
        om.create_volume("v")
        om.create_bucket("v", "f", "rs-3-2-4096", "FILE_SYSTEM_OPTIMIZED")
        for i, path in enumerate(("a/b/c/f0", "a/b/f1", "a/f2", "x/y/f3",
                                  "x/f4")):
            s = om.open_key("v", "f", path)
            g = om.allocate_block(s)
            ring.reps["m0"]._await_records()
            g.length = 100 * (i + 1)
            om.commit_key(s, [g], g.length)
        om.create_directory("v", "f", "a/b/empty")
        om.rename_key("v", "f", "a/b", "a/moved")
        om.delete_directory("v", "f", "x", recursive=True)
        fso.DirectoryDeletingService(om).run_once(limit=2)
        ring.tick("m0")
        before = {m: _fso_tree(r) for m, r in ring.reps.items()}
        ring.stop("m0")
        assert ring.reps["m1"].node.start_election()
        om1 = ring.reps["m1"].om
        fso.DirectoryDeletingService(om1).run_to_completion()
        om1.rename_key("v", "f", "a/moved/c", "a/c2")
        ring.revive("m0")
        ring.tick("m1", 3)
        after = {m: _fso_tree(r) for m, r in ring.reps.items()}
        return {"before": before, "after": after}
    finally:
        ring.stop_all()


def test_fso_on_the_ring_equals_reference_across_failover(tmp_path):
    random.seed(0)
    ref = _fso_ring_history(REF, tmp_path / "ref")
    random.seed(0)
    port = _fso_ring_history(PORT, tmp_path / "port")
    assert port == ref
    for phase in ("before", "after"):
        states = list(port[phase].values())
        assert all(st == states[0] for st in states), phase
    after = port["after"]["m0"]
    assert after["files"] == [("a/c2/f0", 100), ("a/f2", 300),
                              ("a/moved/f1", 200)]
    assert after["deleted_dirs"] == 0
    assert after["deleted_keys"] == ["f3", "f4"]


def _fence_codes(P, root) -> dict:
    """LifecycleCheckpoint steps around the ring's term T after a
    failover, through the ring; each step's code and state row, the
    followers' rows, and a sweep's fence on the leader and a follower."""
    ring = Ring(P, root)
    try:
        assert ring.reps["m0"].node.start_election()
        ring.stop("m0")
        assert ring.reps["m1"].node.start_election()
        leader, follower = ring.reps["m1"], ring.reps["m2"]
        t = leader.node.storage.term
        steps = [
            dict(term=t, cursor={"bucket": "/v/b", "after": "x"}),
            dict(term=t, fence=True),
            dict(term=t, cursor={"bucket": "/v/b", "after": "k1"},
                 stats={"keys_scanned": 1}),
            dict(term=t + 1, cursor={"bucket": "/v/b", "after": "k2"}),
            dict(term=t - 1, fence=True),
            dict(term=t, fence=True),
            dict(term=t + 2, fence=True),
            dict(term=t, cursor={}),
            dict(term=t + 1, fence=True),
            dict(term=t + 2, cursor={}, stats={"keys_scanned": 2}),
        ]
        seen = []
        for kw in steps:
            try:
                leader.submit_om(P.rq.LifecycleCheckpoint(**kw))
                code = None
            except P.rq.OMError as e:
                code = e.code
            row = dict(leader.om.store.get("system", "lifecycle_state")
                       or {})
            row.get("stats", {}).pop("updated", None)
            seen.append((code, row))
        ring.tick("m1")
        follower_row = follower.om.store.get("system", "lifecycle_state")
        assert follower_row == leader.om.store.get("system",
                                                   "lifecycle_state")
        svc = {m: P.lc.LifecycleService(
            r.om, term_fn=lambda r=r: r.node.storage.term,
            leader_fn=lambda r=r: r.is_ready) for m, r in ring.reps.items()}
        swept = svc["m1"].run_once()
        skipped = svc["m2"].run_once()
        return {"term": t, "seen": seen,
                "swept": {k: swept.get(k) for k in ("fenced", "complete")},
                "skipped": skipped}
    finally:
        ring.stop_all()


def test_lifecycle_rejection_codes_above_term_zero(tmp_path):
    random.seed(0)
    ref = _fence_codes(REF, tmp_path / "ref")
    random.seed(0)
    port = _fence_codes(PORT, tmp_path / "port")
    assert port == ref
    assert port["term"] >= 2
    F = t_rq.LIFECYCLE_FENCED
    assert [c for c, _ in port["seen"]] == [F, None, None, F, F, None, None,
                                            F, F, None]
    # the sweeper at the ring's term t is fenced out by the t + 2 fence
    assert port["swept"]["fenced"] is True
    assert port["skipped"] == {"skipped": "not_leader"}


def _read_gate_answers(P, root) -> list:
    """FollowerReadGate on a follower and on the leader of a ring, for a
    read verb, a write verb and read-your-writes floors around the
    follower's applied index (a wide lease: the test's pace is not the
    point)."""
    import ozone_tpu.om.sharding.leases as j_leases
    import ozone_tpu_torch.om.sharding.leases as t_leases

    leases = t_leases if P is PORT else j_leases
    ring = Ring(P, root)
    try:
        leader, follower = ring.reps["m0"], ring.reps["m1"]
        assert leader.node.start_election()
        leader.om.create_volume("v")
        ring.tick("m0")
        out = []
        for rep in (follower, leader):
            gate = leases.FollowerReadGate(rep.node, lease_s=60.0)
            applied = rep.node.last_applied
            out.append([gate.try_serve(verb, floor) for verb, floor in (
                ("LookupKey", 0), ("ListVolumes", applied),
                ("ListVolumes", applied + 1), ("CreateVolume", 0))])
        return out
    finally:
        ring.stop_all()


def test_follower_read_gate_equals_reference(tmp_path):
    ref = _read_gate_answers(REF, tmp_path / "ref")
    port = _read_gate_answers(PORT, tmp_path / "port")
    assert port == ref
    # a follower with a live lease answers reads up to its applied
    # index; the leader holds no follower lease; writes never pass
    assert port == [[True, True, False, False], [False] * 4]


# ---------------------------------------------------- the daemon ring
@pytest.fixture(scope="module")
def ha_cluster(tmp_path_factory):
    from ozone_tpu_torch.testing.minicluster import MiniOzoneHACluster

    c = MiniOzoneHACluster(tmp_path_factory.mktemp("ha"), num_meta=3,
                           num_datanodes=5, block_size=256 * 1024,
                           device="cpu")
    yield c
    c.shutdown()


def _wait(what, cond):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} within {WAIT_S} s")


def test_ha_put_leader_stop_get(ha_cluster):
    c = ha_cluster
    oz = c.client()
    payload = np.random.default_rng(2).integers(0, 256, 150_000,
                                                dtype=np.uint8).tobytes()
    oz.create_volume("v")
    b = oz.get_volume("v").create_bucket("b", replication="rs-3-2-4096")
    b.write_key("k1", payload)
    leader = c.await_leader(timeout=WAIT_S)
    c.stop_meta(leader)
    new_leader = c.await_leader(timeout=WAIT_S)
    assert new_leader != leader
    assert b.read_key("k1").tobytes() == payload  # from the new leader
    b.write_key("k2", payload[::-1])
    assert b.read_key("k2").tobytes() == payload[::-1]
    # the new leader's SCM knows the containers of the key written
    # before the failover (its decision records committed before the ack)
    survivor = c.metas[new_leader]
    info = survivor.om.lookup_key("v", "b", "k1")
    for g in survivor.om.key_block_groups(info):
        assert survivor.scm.containers.get_or_none(g.container_id)
    # the old leader comes back and catches up from the ring
    c.revive_meta(leader)
    revived = c.metas[leader]
    _wait("the revived replica caught up", lambda: revived.ha.node.last_applied
          >= c.metas[new_leader].ha.node.last_applied)
    assert {k["name"] for k in revived.om.list_keys("v", "b")} \
        >= {"k1", "k2"}
    oz.om.close()
    oz.clients.close()


def test_fso_rename_survives_a_leader_change(ha_cluster):
    """An FSO tree written through the daemon ring: a directory renamed,
    the leader stopped; the new leader serves the renamed tree, its
    files byte-exact, and a directory-deleting pass of its own."""
    c = ha_cluster
    oz = c.client()
    om = oz.om
    oz.create_volume("fv")
    om.create_bucket("fv", "fb", "rs-3-2-4096", "FILE_SYSTEM_OPTIMIZED")
    b = oz.get_volume("fv").get_bucket("fb")
    data = {f"d/e/f{i}": np.random.default_rng(i).integers(
        0, 256, 20_000 + i, dtype=np.uint8).tobytes() for i in range(3)}
    for k, v in data.items():
        b.write_key(k, v)
    om.create_directory("fv", "fb", "gone/x")
    om.rename_key("fv", "fb", "d", "renamed")
    om.delete_directory("fv", "fb", "gone", recursive=True)
    leader = c.await_leader(timeout=WAIT_S)
    c.stop_meta(leader)
    new_leader = c.await_leader(timeout=WAIT_S)
    assert new_leader != leader
    assert [(e["type"], e["path"]) for e in
            om.list_status("fv", "fb", "renamed/e")] == [
        ("FILE", f"renamed/e/f{i}") for i in range(3)]
    for k, v in data.items():
        assert b.read_key(k.replace("d/", "renamed/", 1)).tobytes() == v
    survivor = c.metas[new_leader].om
    _wait("the new leader's directory-deleting pass",
          lambda: not list(survivor.store.iterate("deleted_dirs")))
    c.revive_meta(leader)
    revived = c.metas[leader]
    _wait("the revived replica caught up", lambda: revived.ha.node
          .last_applied >= c.metas[new_leader].ha.node.last_applied)
    assert [k["name"] for k in revived.om.list_keys("fv", "fb")] == [
        f"renamed/e/f{i}" for i in range(3)]
    oz.om.close()
    oz.clients.close()


def test_followers_answer_with_the_leader_address(ha_cluster):
    """A follower refuses an OM write and an SCM allocation with the
    leader's address; a failover client follows it. Leadership may move
    between resolving it and the call under load, so the pick is made
    again (at most five times) until a follower answered."""
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    c = ha_cluster
    codes = None
    for attempt in range(5):
        leader = c.await_leader(timeout=WAIT_S)
        follower = next(m for m in c.metas if m != leader)
        om = RemoteOmClient(c.peers[follower])
        scm = RemoteScmClient(c.peers[follower])
        try:
            got = []
            for call in (lambda: om.create_volume(f"nope{attempt}"),
                         lambda: scm.allocate_block("rs-3-2-4096", 4096)):
                try:
                    call()
                    got.append(None)
                except StorageError as e:
                    got.append((e.code, e.msg))
        finally:
            om.close()
            scm.close()
        if c.metas[follower].ha.is_leader or None in got:
            continue  # leadership moved onto the pick mid-call
        codes = got
        break
    assert codes is not None, "leadership moved on every attempt"
    addr = c.peers[leader]
    # the OM client's retries end in IO_EXCEPTION naming the last answer
    assert codes[0] == ("OM_NOT_LEADER", addr) or (
        codes[0][0] == "IO_EXCEPTION"
        and f"OM_NOT_LEADER: {addr}" in codes[0][1]), codes
    assert codes[1] == ("SCM_NOT_LEADER", addr)
    scm = RemoteScmClient(",".join(c.peers[m] for m in c.metas))
    group, _ = scm.allocate_block("rs-3-2-4096", 4096)
    assert group["container_id"] >= 1
    scm.close()


def test_ring_status_from_any_replica(ha_cluster):
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    c = ha_cluster
    c.await_leader(timeout=WAIT_S)
    leaders = set()
    for mid in c.metas:
        scm = RemoteScmClient(c.peers[mid])
        try:
            st = scm.admin("ring-status")
        finally:
            scm.close()
        assert st["replica_id"] == mid
        assert st["members"] == sorted(c.peers)
        assert st["role"] in ("LEADER", "FOLLOWER")
        if st["role"] == "LEADER":
            assert st["leader"] == mid
        if st["leader"] is not None:
            leaders.add(st["leader"])
    assert len(leaders) == 1, leaders


# ------------------------------ single-leader replication (promote mode)
def _om_ha_script(pkg_ha, pkg_om, pkg_scm, rq, root) -> dict:
    """ReplicatedOzoneManager on one script: replication to followers, a
    follower's refusal, WAL replay into a fresh store, failover by
    promote() and a follower closing a gap."""
    scm = pkg_scm.StorageContainerManager(stale_after_s=1e6, dead_after_s=2e6)
    for i in range(5):
        scm.register_datanode(f"dn{i}")
    kw = {"device": "cpu"} if pkg_om is t_om else {}

    def replica(name, leader=False):
        om = pkg_om.OzoneManager(root / name / "om.db", scm, **kw)
        return pkg_ha.ReplicatedOzoneManager(om, root / name / "wal.jsonl",
                                             name, is_leader=leader)

    leader, f1, f2 = replica("om1", True), replica("om2"), replica("om3")
    leader.peers, f1.peers, f2.peers = [f1], [leader, f2], [leader, f1]
    proxy = pkg_ha.OMFailoverProxy([leader, f1])
    proxy.submit(rq.CreateVolume("v"))
    proxy.submit(rq.CreateBucket("v", "b", "rs-3-2-4096"))
    refused = None
    try:
        f1.submit(rq.CreateVolume("nope"))
    except pkg_ha.NotLeaderError:
        refused = "NotLeaderError"
    leader.peers = [f1, f2]  # f2 missed two entries: the gap is pulled
    proxy.submit(rq.CreateBucket("v", "b2"))
    f1.promote()
    proxy.submit(rq.CreateBucket("v", "b3"))
    leader.catch_up()
    fresh = pkg_om.OzoneManager(root / "fresh" / "om.db", scm, **kw)
    replay = pkg_ha.ReplicatedOzoneManager(fresh, root / "om2" / "wal.jsonl",
                                           "om2r")
    out = {
        "refused": refused,
        "applied": [r.applied_index for r in (leader, f1, f2, replay)],
        "leaders": [r.is_leader for r in (leader, f1, f2)],
        "buckets": [sorted(b["name"] for b in r.om.list_buckets("v"))
                    for r in (leader, f1, f2, replay)],
        "wal": [e["request"]["type"] for e in f1.wal.read_from(0)],
    }
    for r in (leader, f1, f2, replay):
        r.wal.close()
        r.om.close()
    return out


def test_replicated_om_equals_reference(tmp_path):
    from ozone_tpu.om import ha as j_om_ha
    from ozone_tpu_torch.om import ha as t_om_ha

    ref = _om_ha_script(j_om_ha, j_om, j_scm, j_rq, tmp_path / "ref")
    port = _om_ha_script(t_om_ha, t_om, t_scm, t_rq, tmp_path / "port")
    assert port == ref
    assert port["buckets"][1] == ["b", "b2", "b3"] and port["applied"] == \
        [4, 4, 4, 4]


def _scm_ha_script(pkg_ha, pkg_scm, pkg_pipeline, root) -> dict:
    """ReplicatedSCM on one script: followers apply the leader's
    allocations, a follower refuses, promote() never reissues an id, the
    proxy finds the leader, a fresh follower bootstraps from a snapshot
    and tails the log, and a WAL replay restores the state."""

    def make_scm():
        scm = pkg_scm.StorageContainerManager(min_datanodes=1,
                                              placement_seed=7)
        for i in range(5):
            scm.register_datanode(f"dn{i}", rack=f"/rack{i % 3}",
                                  capacity_bytes=10**12)
            scm.heartbeat(f"dn{i}", container_report=[])
        return scm

    reps = [pkg_ha.ReplicatedSCM(make_scm(), root / f"scm{i}.wal",
                                 f"scm{i}", is_leader=(i == 0))
            for i in range(3)]
    for r in reps:
        r.peers = [p for p in reps if p is not r]
    leader, f1, f2 = reps
    repl = pkg_pipeline.ReplicationConfig.parse("rs-3-2-1024k")
    first = [leader.submit("allocate_block", repl, 1 << 20) for _ in range(3)]
    refused = None
    try:
        f1.submit("allocate_block", repl, 1 << 20)
    except Exception as e:
        refused = type(e).__name__
    fresh = pkg_ha.ReplicatedSCM(make_scm(), root / "scm9.wal", "scm9")
    fresh.bootstrap_from(leader)
    proxy = pkg_ha.SCMFailoverProxy([f2, f1, leader])
    f1.promote()
    more = [proxy.submit("allocate_block", repl, 5 * (1 << 30))
            for _ in range(2)]
    restarted = pkg_ha.ReplicatedSCM(make_scm(), root / "scm1.wal", "scm1r")
    state = [sorted((c.id, c.state.value, c.used_bytes, list(c.pipeline.nodes))
                    for c in r.scm.containers.containers())
             for r in (leader, f1, f2, fresh, restarted)]
    return {"first": [(g.container_id, g.local_id) for g in first],
            "more": [(g.container_id, g.local_id) for g in more],
            "refused": refused,
            "applied": [r.applied_index for r in (leader, f1, f2, fresh)],
            "state": state}


def test_replicated_scm_equals_reference(tmp_path):
    import ozone_tpu.scm.ha as j_scm_ha
    import ozone_tpu.scm.pipeline as j_pipeline
    import ozone_tpu_torch.scm.ha as t_scm_ha
    import ozone_tpu_torch.scm.pipeline as t_pipeline

    ref = _scm_ha_script(j_scm_ha, j_scm, j_pipeline, tmp_path / "ref")
    port = _scm_ha_script(t_scm_ha, t_scm, t_pipeline, tmp_path / "port")
    assert port == ref
    assert not set(port["first"]) & set(port["more"])
    assert port["refused"] == "NotLeaderError"
    # the promoted leader's peers and its replayed WAL hold its state
    # (the snapshot-bootstrapped follower tails the old leader only)
    leader, f1, f2, _, restarted = port["state"]
    assert leader == f1 == f2 == restarted
