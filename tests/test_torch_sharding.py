"""The port's sharded metadata plane against `ozone_tpu`'s, on the CPU.

Each of the 18 tests of `tests/test_om_sharding.py` runs here on the
port (`device="cpu"`): routing and the SHARD_MOVED retry, the
cross-shard 2PC under coordinator crashes and a shard-leader kill,
`migrate_slot`, follower reads and their staleness bound, the RPC plane
(`MiniShardedCluster`) and `shardd` processes. Then differential tests
with `ozone_tpu` as the oracle, every comparison exact: `slot_for` and
the shard map's JSON over a grid; one facade sequence on both packages'
plain planes (every shard's `volumes`, `buckets`, `keys` and `system`
rows and every error code); a coordinator crash at each phase (journal
and intent rows, and `recover`'s answer); one RS(3,2) key written
through each plane over a small `MiniOzoneCluster` (stored units and CRC
words); the verbs the facade sends to shard 0 and the RPC router routes
(FSO's across shards); a migrated FSO bucket, whose `dir_ids` rows stay
behind in both packages; `ImportRow` in the update journal; the router's
mutual TLS; and the entry points' device.
"""

import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import ozone_tpu.om.requests as j_rq
import ozone_tpu.om.sharding.plane as j_plane
import ozone_tpu.om.sharding.shardmap as j_shardmap
import ozone_tpu.om.sharding.txn as j_txn
import ozone_tpu_torch.om.requests as t_rq
import ozone_tpu_torch.om.sharding.plane as t_plane
import ozone_tpu_torch.om.sharding.shardmap as t_shardmap
import ozone_tpu_torch.om.sharding.txn as t_txn
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.metadata import key_key
from ozone_tpu_torch.om.sharding.leases import READ_LEASE_S
from ozone_tpu_torch.om.sharding.plane import ShardedMetaPlane
from ozone_tpu_torch.om.sharding.shardmap import (
    SHARD_MOVED,
    ShardMap,
    slot_for,
)
from ozone_tpu_torch.om.sharding.txn import ShardPrepare, TxnJournal
from ozone_tpu_torch.utils.metrics import registry

METRICS = registry("om.shard")
EC = "rs-3-2-4096"
REF = types.SimpleNamespace(name="ref", plane=j_plane, shardmap=j_shardmap,
                            txn=j_txn, rq=j_rq, kw={})
PORT = types.SimpleNamespace(name="port", plane=t_plane, shardmap=t_shardmap,
                             txn=t_txn, rq=t_rq, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain PyTorch versions run on one thread: the suite runs in
    several worker processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane(tmp_path, **kw):
    return ShardedMetaPlane(tmp_path, device="cpu", **kw)


def _bucket_on(m: ShardMap, volume: str, shard_id: str,
               prefix: str = "b") -> str:
    """A bucket name whose slot hashes onto `shard_id` (the reference
    test's helper)."""
    for i in range(10_000):
        name = f"{prefix}{i}"
        if m.shard_for(volume, name) == shard_id:
            return name
    raise AssertionError(f"no bucket hashes to {shard_id}")


def _put_meta(facade, volume: str, bucket: str, key: str,
              size: int = 0) -> None:
    s = facade.open_key(volume, bucket, key)
    facade.commit_key(s, [], size)


# ================================================ the reference's 18 tests
# ---------------------------------------------------------------- shard map
def test_slot_math_partitions_namespace():
    m = ShardMap.uniform(["s0", "s1", "s2", "s3"])
    owned = [m.owned_slots(s) for s in m.shards]
    assert sorted(sum(owned, [])) == list(range(m.slot_count))
    assert all(owned)
    assert m.shard_for("v", "b") == m.shard_for("v", "b")
    assert slot_for("v", "b") == slot_for("v", "b")
    assert 0 <= slot_for("v", "b") < m.slot_count


def test_move_slot_bumps_epoch_and_reassigns():
    m = ShardMap.uniform(["s0", "s1"])
    slot = m.owned_slots("s0")[0]
    m2 = m.move_slot(slot, "s1")
    assert m2.epoch == m.epoch + 1
    assert slot in m2.owned_slots("s1")
    assert slot not in m2.owned_slots("s0")
    assert ShardMap.from_json(m2.to_json()).owned_slots("s1") \
        == m2.owned_slots("s1")


# ---------------------------------------------------------------- routing
def test_plain_plane_routes_to_owning_shard(tmp_path):
    plane = _plane(tmp_path, n_shards=2)
    try:
        m = plane.current_map()
        f = plane.facade
        f.create_volume("v")
        b0 = _bucket_on(m, "v", "s0")
        b1 = _bucket_on(m, "v", "s1")
        f.create_bucket("v", b0, replication="RATIS/1")
        f.create_bucket("v", b1, replication="RATIS/1")
        _put_meta(f, "v", b0, "k0")
        _put_meta(f, "v", b1, "k1")
        s0 = plane.shards["s0"].om.store
        s1 = plane.shards["s1"].om.store
        assert s0.get("keys", key_key("v", b0, "k0")) is not None
        assert s0.get("keys", key_key("v", b1, "k1")) is None
        assert s1.get("keys", key_key("v", b1, "k1")) is not None
        assert s1.get("keys", key_key("v", b0, "k0")) is None
        assert f.lookup_key("v", b0, "k0")["name"] == "k0"
        assert f.lookup_key("v", b1, "k1")["name"] == "k1"
        assert {b["name"] for b in f.list_buckets("v")} == {b0, b1}
    finally:
        plane.close()


def test_misrouted_write_rejected_shard_moved(tmp_path):
    plane = _plane(tmp_path, n_shards=2)
    try:
        m = plane.current_map()
        plane.facade.create_volume("v")
        b0 = _bucket_on(m, "v", "s0")
        with pytest.raises(rq.OMError) as ei:
            plane.shards["s1"].om.create_bucket(
                "v", b0, replication="RATIS/1")
        assert ei.value.code == SHARD_MOVED
    finally:
        plane.close()


def test_epoch_bump_mid_op_retries_through_refreshed_map(tmp_path):
    plane = _plane(tmp_path, n_shards=2)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        b0 = _bucket_on(m, "v", "s0")
        f.create_bucket("v", b0, replication="RATIS/1")
        _put_meta(f, "v", b0, "k", size=7)
        moved = METRICS.counter("moved_rejections").value
        plane.migrate_slot(slot_for("v", b0), "s1")
        info = f.lookup_key("v", b0, "k")
        assert info["name"] == "k" and int(info["size"]) == 7
        assert METRICS.counter("moved_rejections").value > moved
        _put_meta(f, "v", b0, "k2")
        assert {k["name"] for k in f.list_keys("v", b0)} >= {"k", "k2"}
    finally:
        plane.close()


# ------------------------------------------------------------ cross-shard 2PC
def test_cross_shard_rename_moves_key_exactly_once(tmp_path):
    plane = _plane(tmp_path, n_shards=2)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        src = _bucket_on(m, "v", "s0")
        dst = _bucket_on(m, "v", "s1")
        f.create_bucket("v", src, replication="RATIS/1")
        f.create_bucket("v", dst, replication="RATIS/1")
        _put_meta(f, "v", src, "old", size=11)
        info = f.rename_key_cross("v", src, "old", dst, "new")
        assert info["name"] == "new"
        assert f.lookup_key("v", dst, "new")["size"] == 11
        with pytest.raises(rq.OMError):
            f.lookup_key("v", src, "old")
        assert not list(plane.root.store.iterate("system", "txn/"))
        for sid in plane.shard_ids:
            assert not list(plane.shards[sid].om.store.iterate(
                "system", "txn_intent/"))
    finally:
        plane.close()


def test_cross_shard_rename_aborts_clean_on_dst_conflict(tmp_path):
    plane = _plane(tmp_path, n_shards=2)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        src = _bucket_on(m, "v", "s0")
        dst = _bucket_on(m, "v", "s1")
        f.create_bucket("v", src, replication="RATIS/1")
        f.create_bucket("v", dst, replication="RATIS/1")
        _put_meta(f, "v", src, "k", size=5)
        _put_meta(f, "v", dst, "taken", size=3)
        with pytest.raises(rq.OMError):
            f.rename_key_cross("v", src, "k", dst, "taken")
        assert f.lookup_key("v", src, "k")["size"] == 5
        assert f.lookup_key("v", dst, "taken")["size"] == 3
        assert not list(plane.root.store.iterate("system", "txn/"))
    finally:
        plane.close()


def _rename_record(m, src, dst, key="k", new_key="n"):
    return {"kind": "rename", "volume": "v", "src_bucket": src,
            "key": key, "dst_bucket": dst, "new_key": new_key,
            "src_shard": "s0", "dst_shard": "s1", "epoch": m.epoch}


def test_coordinator_crash_before_decide_presumed_abort(tmp_path):
    """A coordinator crash after the source prepare, before the
    decision: recover() aborts and restores the key."""
    plane = _plane(tmp_path, n_shards=2)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        src = _bucket_on(m, "v", "s0")
        dst = _bucket_on(m, "v", "s1")
        f.create_bucket("v", src, replication="RATIS/1")
        f.create_bucket("v", dst, replication="RATIS/1")
        _put_meta(f, "v", src, "k", size=9)
        plane.root.submit(TxnJournal("t-crash", "begin",
                                     _rename_record(m, src, dst)))
        plane.shards["s0"].submit(ShardPrepare(
            "t-crash", "rename_src",
            {"volume": "v", "bucket": src, "key": "k"}, epoch=m.epoch))
        with pytest.raises(rq.OMError):
            f.lookup_key("v", src, "k")
        resolved = plane.recover()
        assert [r["txn_id"] for r in resolved] == ["t-crash"]
        assert f.lookup_key("v", src, "k")["size"] == 9
        with pytest.raises(rq.OMError):
            f.lookup_key("v", dst, "n")
        assert not list(plane.root.store.iterate("system", "txn/"))
    finally:
        plane.close()


def test_coordinator_crash_after_decide_commits_on_recovery(tmp_path):
    plane = _plane(tmp_path, n_shards=2)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        src = _bucket_on(m, "v", "s0")
        dst = _bucket_on(m, "v", "s1")
        f.create_bucket("v", src, replication="RATIS/1")
        f.create_bucket("v", dst, replication="RATIS/1")
        _put_meta(f, "v", src, "k", size=13)
        rec = _rename_record(m, src, dst)
        plane.root.submit(TxnJournal("t-c2", "begin", rec))
        info = plane.shards["s0"].submit(ShardPrepare(
            "t-c2", "rename_src",
            {"volume": "v", "bucket": src, "key": "k"}, epoch=m.epoch))
        plane.shards["s1"].submit(ShardPrepare(
            "t-c2", "rename_dst",
            {"volume": "v", "bucket": dst, "new_key": "n", "info": info},
            epoch=m.epoch))
        plane.root.submit(TxnJournal("t-c2", "decide-commit", rec))
        plane.recover()
        assert f.lookup_key("v", dst, "n")["size"] == 13
        with pytest.raises(rq.OMError):
            f.lookup_key("v", src, "k")
        assert not list(plane.root.store.iterate("system", "txn/"))
    finally:
        plane.close()


def test_stale_epoch_prepare_fenced(tmp_path):
    plane = _plane(tmp_path, n_shards=2)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        b0 = _bucket_on(m, "v", "s0")
        f.create_bucket("v", b0, replication="RATIS/1")
        _put_meta(f, "v", b0, "k")
        other = next(s for s in plane.current_map().owned_slots("s0")
                     if s != slot_for("v", b0))
        plane.migrate_slot(other, "s1")
        with pytest.raises(rq.OMError) as ei:
            plane.shards["s0"].submit(ShardPrepare(
                "t-stale", "rename_src",
                {"volume": "v", "bucket": b0, "key": "k"}, epoch=m.epoch))
        assert ei.value.code == SHARD_MOVED
        assert not list(plane.shards["s0"].om.store.iterate(
            "system", "txn_intent/"))
    finally:
        plane.close()


def test_cross_shard_bucket_link_resolves_across_rings(tmp_path):
    plane = _plane(tmp_path, n_shards=2)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        src = _bucket_on(m, "v", "s0")
        f.create_bucket("v", src, replication="RATIS/1")
        _put_meta(f, "v", src, "k", size=4)
        link = _bucket_on(m, "v", "s1", prefix="ln")
        f.create_bucket_link("v", src, "v", link)
        assert f.resolve_bucket("v", link) == ("v", src)
        assert f.lookup_key("v", link, "k")["size"] == 4
        assert f.bucket_info("v", link)["replication"] == "RATIS/1"
    finally:
        plane.close()


# -------------------------------------------------- ring mode: leader kills
def test_ring_shard_survives_leader_kill(tmp_path):
    plane = _plane(tmp_path, n_shards=2, mode="ring", replicas=3)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        b0 = _bucket_on(m, "v", "s0")
        f.create_bucket("v", b0, replication="RATIS/1")
        _put_meta(f, "v", b0, "before")
        killed = plane.shards["s0"].kill_leader()
        _put_meta(f, "v", b0, "after")
        assert plane.shards["s0"].await_leader().node.node_id != killed
        assert {k["name"] for k in f.list_keys("v", b0)} \
            == {"before", "after"}
    finally:
        plane.close()


def test_leader_kill_mid_cross_shard_rename_both_or_neither(tmp_path):
    """kill -9 the source shard's leader after its prepare replicated:
    the staged intent survives the failover, the commit lands on the new
    leader, and the key is visible under exactly one name."""
    plane = _plane(tmp_path, n_shards=2, mode="ring", replicas=3)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        src = _bucket_on(m, "v", "s0")
        dst = _bucket_on(m, "v", "s1")
        f.create_bucket("v", src, replication="RATIS/1")
        f.create_bucket("v", dst, replication="RATIS/1")
        _put_meta(f, "v", src, "old", size=21)
        real = plane.coordinator._shard_submit
        state = {"killed": False}

        def kill_after_src_prepare(sid, request):
            result = real(sid, request)
            if isinstance(request, ShardPrepare) \
                    and request.op == "rename_src" and not state["killed"]:
                state["killed"] = True
                plane.shards["s0"].kill_leader()
            return result

        plane.coordinator._shard_submit = kill_after_src_prepare
        info = f.rename_key_cross("v", src, "old", dst, "new")
        assert state["killed"], "drill never fired"
        assert info["name"] == "new" and int(info["size"]) == 21
        assert f.lookup_key("v", dst, "new")["size"] == 21
        with pytest.raises(rq.OMError):
            f.lookup_key("v", src, "old")
        for sid in plane.shard_ids:
            assert not list(plane.shards[sid].om.store.iterate(
                "system", "txn_intent/"))
    finally:
        plane.close()


# ------------------------------------------------------- data-path readback
def test_cross_shard_rename_byte_exact_readback(tmp_path):
    """After a coordinator crash and recovery, then a real cross-shard
    rename, the key reads back byte-exact under its new name."""
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

    mini = MiniOzoneCluster(tmp_path / "data", num_datanodes=5,
                            block_size=256 * 1024, device="cpu")
    plane = ShardedMetaPlane(tmp_path / "meta", n_shards=2, scm=mini.scm,
                             clients=mini.clients, device="cpu")
    try:
        oz = plane.client(mini.clients)
        oz.create_volume("v")
        m = plane.current_map()
        src = _bucket_on(m, "v", "s0")
        dst = _bucket_on(m, "v", "s1")
        vol = oz.get_volume("v")
        vol.create_bucket(src, replication="RATIS/THREE")
        vol.create_bucket(dst, replication="RATIS/THREE")
        payload = np.random.default_rng(7).integers(0, 256, 700_000,
                                                    dtype=np.uint8)
        vol.get_bucket(src).write_key("blob", payload)
        plane.root.submit(TxnJournal("t-io", "begin", _rename_record(
            m, src, dst, "blob", "moved")))
        plane.shards["s0"].submit(ShardPrepare(
            "t-io", "rename_src",
            {"volume": "v", "bucket": src, "key": "blob"}, epoch=m.epoch))
        plane.recover()
        np.testing.assert_array_equal(
            vol.get_bucket(src).read_key("blob"), payload)
        plane.facade.rename_key_cross("v", src, "blob", dst, "moved")
        np.testing.assert_array_equal(
            vol.get_bucket(dst).read_key("moved"), payload)
        with pytest.raises(rq.OMError):
            plane.facade.lookup_key("v", src, "blob")
    finally:
        plane.close()
        mini.close()


# ---------------------------------------------------------- follower reads
def test_follower_reads_serve_mix_and_bound_staleness(tmp_path, monkeypatch):
    monkeypatch.setenv("OZONE_TPU_OM_FOLLOWER_READS", "1")
    # timers off: elections are driven on demand, so a killed leader's
    # followers are not re-leased by a fast re-election before the
    # staleness assertion can observe the refusal
    plane = _plane(tmp_path, n_shards=1, mode="ring", replicas=3,
                   follower_reads=True, timers=False)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        b0 = _bucket_on(m, "v", "s0")
        f.create_bucket("v", b0, replication="RATIS/1")
        _put_meta(f, "v", b0, "k", size=3)
        hits0 = METRICS.counter("follower_read_hits").value
        for _ in range(10):
            assert f.lookup_key("v", b0, "k")["size"] == 3
        hits = METRICS.counter("follower_read_hits").value - hits0
        assert hits >= 8, f"only {hits}/10 reads served by followers"
        leader = plane.shards["s0"].await_leader().node.node_id
        assert any(r.node.node_id == leader and r.node.is_leader
                   for r in plane.shards["s0"].replicas)
        plane.shards["s0"].kill_leader()
        time.sleep(READ_LEASE_S + 0.1)
        misses0 = METRICS.counter("follower_read_misses").value
        assert f.lookup_key("v", b0, "k")["size"] == 3
        assert METRICS.counter("follower_read_misses").value > misses0
    finally:
        plane.close()


def test_follower_read_hit_rate_over_80_percent(tmp_path, monkeypatch):
    """The ommg lookup/list mix is served >= 80% by followers."""
    monkeypatch.setenv("OZONE_TPU_OM_FOLLOWER_READS", "1")
    from ozone_tpu_torch.tools import freon

    plane = _plane(tmp_path, n_shards=2, mode="ring", replicas=3,
                   follower_reads=True)
    try:
        h0 = METRICS.counter("follower_read_hits").value
        m0 = METRICS.counter("follower_read_misses").value
        freon.ommg(plane.client(), n_ops=200, threads=4, mix="rl",
                   buckets=4)
        hits = METRICS.counter("follower_read_hits").value - h0
        misses = METRICS.counter("follower_read_misses").value - m0
        assert hits + misses > 0
        rate = hits / (hits + misses)
        assert rate >= 0.8, f"follower-read hit rate {rate:.2f}"
    finally:
        plane.close()


# --------------------------------------------------------------- over the RPC
def test_minisharded_cluster_routes_and_rebalances(tmp_path):
    """Per-shard daemons with replicated shard configs, a shard-aware
    client routing by the fetched map, and a live rebalance the client
    rides out through SHARD_MOVED and a refetch."""
    from ozone_tpu_torch.testing.minicluster import MiniShardedCluster

    cluster = MiniShardedCluster(tmp_path, n_shards=2, device="cpu")
    om = None
    try:
        om = cluster.om_client()
        om.create_volume("v")
        b0 = _bucket_on(cluster.map, "v", "s0")
        om.create_bucket("v", b0, replication="RATIS/1")
        s = om.open_key("v", b0, "k")
        om.commit_key(s, [], 0)
        assert [k["name"] for k in om.list_keys("v", b0)] == ["k"]
        cluster.move_slot(slot_for("v", b0), "s1")
        assert [k["name"] for k in om.list_keys("v", b0)] == ["k"]
        s = om.open_key("v", b0, "k2")
        om.commit_key(s, [], 0)
        assert {k["name"] for k in om.list_keys("v", b0)} == {"k", "k2"}
    finally:
        if om is not None:
            om.close()
        cluster.shutdown()


def _free_ports(n):
    from ozone_tpu_torch.testing.minicluster import free_ports

    return free_ports(n)


def _await_shards(book, timeout_s=120.0):
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    deadline = time.time() + timeout_s
    while time.time() < deadline:
        ready = 0
        for a in book.values():
            c = RemoteOmClient(a, shard_aware=False)
            try:
                if c.get_shard_map():
                    ready += 1
            except Exception:
                pass
            finally:
                c.close()
        if ready == len(book):
            return
        time.sleep(0.3)
    raise TimeoutError("shardd processes never became ready")


@pytest.mark.serial
def test_shardd_processes_route_and_stop_clean(tmp_path):
    """One `ozone_tpu_torch.tools.shardd` process per shard, a
    shard-aware client routing across them, `admin shards map` through
    the CLI, and exit 0 on SIGTERM."""
    import json

    from ozone_tpu_torch.net.om_service import RemoteOmClient

    book = {f"s{i}": f"127.0.0.1:{p}" for i, p in enumerate(_free_ports(2))}
    arg = ",".join(f"{k}={v}" for k, v in book.items())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ozone_tpu_torch.tools.shardd",
         "--base", str(tmp_path / sid), "--shard-id", sid,
         "--shards", arg, "--device", "cpu"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for sid in book]
    om = None
    try:
        _await_shards(book)
        om = RemoteOmClient(",".join(book.values()), shard_aware=True)
        om.create_volume("v")
        m = ShardMap.from_json(om.get_shard_map())
        for sid in book:
            b = _bucket_on(m, "v", sid)
            om.create_bucket("v", b, replication="RATIS/1")
            s = om.open_key("v", b, "k")
            om.commit_key(s, [], 0)
            assert [k["name"] for k in om.list_keys("v", b)] == ["k"]
        out = subprocess.run(
            [sys.executable, "-m", "ozone_tpu_torch.tools", "admin",
             "shards", "map", "--om", book["s1"]], env=env,
            capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        shown = json.loads(out.stdout)
        assert shown["epoch"] == 1 and shown["addresses"] == book
        assert shown["slots_per_shard"] == {"s0": 32, "s1": 32}
    finally:
        if om is not None:
            om.close()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=30) == 0


# ========================================== against ozone_tpu as the oracle
_NAMES = [("v", "b"), ("vol1", "bucket-0"), ("freon-vol", "freon-meta-3"),
          ("s3v", "a" * 63), ("ünï", "cödé"), ("", ""), ("v", "b0"),
          ("v", "ln17"), ("x" * 200, "y")]


@pytest.mark.parametrize("slot_count", [1, 7, 16, 64, 1024])
def test_slot_for_matches_reference(slot_count):
    names = _NAMES + [("v", f"b{i}") for i in range(300)]
    assert [t_shardmap.slot_for(v, b, slot_count) for v, b in names] == \
        [j_shardmap.slot_for(v, b, slot_count) for v, b in names]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("slot_count", [16, 64])
def test_shard_map_json_matches_reference(n_shards, slot_count):
    ids = [f"s{i}" for i in range(n_shards)]
    book = {sid: f"127.0.0.1:{9860 + i}" for i, sid in enumerate(ids)}
    maps = [pkg.shardmap.ShardMap.uniform(ids, epoch=3, addresses=book,
                                          slot_count=slot_count)
            for pkg in (PORT, REF)]
    for step in range(6):
        got, want = (m.to_json() for m in maps)
        assert got == want
        assert [maps[0].shard_for(v, b) for v, b in _NAMES] == \
            [maps[1].shard_for(v, b) for v, b in _NAMES]
        assert [maps[0].owned_slots(s) for s in ids] == \
            [maps[1].owned_slots(s) for s in ids]
        slot, to = (7 * step + 3) % slot_count, ids[(step + 1) % n_shards]
        maps = [m.move_slot(slot, to) for m in maps]
        maps = [pkg.shardmap.ShardMap.from_json(m.to_json())
                for pkg, m in zip((PORT, REF), maps)]


#: row fields that differ between runs by design (timestamps, object ids)
_VOLATILE = ("created", "modified", "object_id", "mtime")


def _stable(row):
    """A row without its volatile fields, at any depth (an intent row
    holds the key row it staged)."""
    if isinstance(row, dict):
        return {f: _stable(v) for f, v in row.items() if f not in _VOLATILE}
    if isinstance(row, list):
        return [_stable(v) for v in row]
    return row


def _rows(store, table):
    return [(k, _stable(row)) for k, row in store.iterate(table)
            # the rolling digest covers the object ids
            if not (table == "system" and k.startswith("__digest"))]


def _dump(plane):
    return {sid: {t: _rows(plane.shards[sid].om.store, t)
                  for t in ("volumes", "buckets", "keys", "system")}
            for sid in plane.shard_ids}


def _code(fn):
    try:
        fn()
    except Exception as e:  # both packages' OMError
        return getattr(e, "code", type(e).__name__)
    return None


def _facade_script(pkg, tmp_path, n_shards):
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name,
                                       n_shards=n_shards, **pkg.kw)
    try:
        f = plane.facade
        m = plane.current_map()
        ids = plane.shard_ids
        f.create_volume("v")
        bs = [_bucket_on(m, "v", sid) for sid in ids]
        for b in bs:
            f.create_bucket("v", b, replication="RATIS/1")
        for i, b in enumerate(bs):
            for j in range(3):
                _put_meta(f, "v", b, f"k{j}", size=10 * i + j)
        codes = [
            _code(lambda: f.lookup_key("v", bs[0], "missing")),
            _code(lambda: f.create_bucket("v", bs[0])),
            _code(lambda: plane.shards[ids[-1]].om.create_bucket(
                "v", bs[0], replication="RATIS/1")),
            _code(lambda: plane.shards[ids[-1]].om.lookup_key(
                "v", bs[0], "k0")),
            _code(lambda: f.delete_volume("v")),
            _code(lambda: f.rename_key_cross("v", bs[0], "k0", bs[-1],
                                             "k1")),
        ]
        moved = f.rename_key_cross("v", bs[0], "k0", bs[-1], "from0")
        f.rename_key("v", bs[-1], "k2", "k2r")
        link = _bucket_on(m, "v", ids[-1], prefix="ln")
        f.create_bucket_link("v", bs[0], "v", link)
        same = _bucket_on(m, "v", ids[0], prefix="lx")
        f.create_bucket_link("v", bs[0], "v", same)
        codes += [
            _code(lambda: f.create_bucket_link("v", "nope", "v",
                                               _bucket_on(m, "v", ids[-1],
                                                          prefix="lz"))),
            _code(lambda: f.rename_key_cross("v", bs[0], "k1", link, "z")),
        ]
        seen = [f.lookup_key("v", link, "k2")["size"],
                f.bucket_info("v", link)["replication"],
                sorted(b["name"] for b in f.list_buckets("v"))]
        plane.migrate_slot(slot_for("v", bs[0]), ids[-1])
        seen.append(sorted(k["name"] for k in f.list_keys("v", bs[0])))
        _put_meta(f, "v", bs[0], "after-move", size=99)
        f.delete_key("v", bs[-1], "k1")
        codes.append(_code(lambda: f.lookup_key("v", bs[-1], "k1")))
        moved = {k: v for k, v in moved.items() if k not in _VOLATILE}
        return {"rows": _dump(plane),
                "root": _rows(plane.root.store, "system"),
                "map": plane.current_map().to_json(), "codes": codes,
                "seen": seen, "moved": moved}
    finally:
        plane.close()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_facade_sequence_matches_reference(tmp_path, n_shards):
    """Volumes, buckets, keys, a cross-shard rename and link, a same-shard
    link, failures and a slot migration, on both packages' plain planes:
    every shard's rows and every error code equal."""
    got = _facade_script(PORT, tmp_path, n_shards)
    want = _facade_script(REF, tmp_path, n_shards)
    assert got["codes"] == want["codes"]
    assert got["codes"][:4] == ["KEY_NOT_FOUND", "BUCKET_ALREADY_EXISTS",
                                SHARD_MOVED, SHARD_MOVED]
    assert got == want


#: (phase label, steps run before the crash); the steps are the
#: coordinator's own, in order
_PHASES = {
    "begun": ["begin"],
    "src_prepared": ["begin", "prep_src"],
    "both_prepared": ["begin", "prep_src", "prep_dst"],
    "decided_commit": ["begin", "prep_src", "prep_dst", "decide_commit"],
    "src_committed": ["begin", "prep_src", "prep_dst", "decide_commit",
                      "commit_src"],
    "decided_abort": ["begin", "prep_src", "decide_abort"],
    "src_aborted": ["begin", "prep_src", "decide_abort", "abort_src"],
    "link_src_prepared": ["link_begin", "link_prep_src"],
    "link_decided": ["link_begin", "link_prep_src", "link_prep_dst",
                     "link_decide_commit"],
}


def _crash_script(pkg, tmp_path, steps):
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name, n_shards=2,
                                       **pkg.kw)
    T = pkg.txn
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        src = _bucket_on(m, "v", "s0")
        dst = _bucket_on(m, "v", "s1")
        link = _bucket_on(m, "v", "s1", prefix="ln")
        f.create_bucket("v", src, replication="RATIS/1")
        f.create_bucket("v", dst, replication="RATIS/1")
        _put_meta(f, "v", src, "k", size=17)
        rec = _rename_record(m, src, dst)
        lrec = {"kind": "link", "volume": "v", "bucket": link,
                "source_volume": "v", "source_bucket": src,
                "src_shard": "s0", "dst_shard": "s1", "epoch": m.epoch}
        create = pkg.rq.CreateBucket("v", link, created=1.0,
                                     source_volume="v", source_bucket=src)
        s0, s1, root = plane.shards["s0"], plane.shards["s1"], plane.root
        info = {}
        run = {
            "begin": lambda: root.submit(T.TxnJournal("t", "begin", rec)),
            "prep_src": lambda: info.update(s0.submit(T.ShardPrepare(
                "t", "rename_src", {"volume": "v", "bucket": src,
                                    "key": "k"}, epoch=m.epoch))),
            "prep_dst": lambda: s1.submit(T.ShardPrepare(
                "t", "rename_dst", {"volume": "v", "bucket": dst,
                                    "new_key": "n", "info": dict(info)},
                epoch=m.epoch)),
            "decide_commit": lambda: root.submit(
                T.TxnJournal("t", "decide-commit", rec)),
            "commit_src": lambda: s0.submit(T.ShardCommit("t", m.epoch)),
            "decide_abort": lambda: root.submit(
                T.TxnJournal("t", "decide-abort", rec)),
            "abort_src": lambda: s0.submit(T.ShardAbort("t", m.epoch)),
            "link_begin": lambda: root.submit(
                T.TxnJournal("t", "begin", lrec)),
            "link_prep_src": lambda: s0.submit(T.ShardPrepare(
                "t", "link_src", {"volume": "v", "bucket": src},
                epoch=m.epoch)),
            "link_prep_dst": lambda: s1.submit(T.ShardPrepare(
                "t", "link_dst", {"volume": "v", "bucket": link,
                                  "request": create.to_json()},
                epoch=m.epoch)),
            "link_decide_commit": lambda: root.submit(
                T.TxnJournal("t", "decide-commit", lrec)),
        }
        for step in steps:
            run[step]()
        before = {"journal": _rows(root.store, "system"),
                  "shards": _dump(plane)}
        resolved = plane.recover()
        after = {"journal": _rows(root.store, "system"),
                 "shards": _dump(plane), "resolved": resolved,
                 "again": plane.recover(),
                 "lookups": [_code(lambda: f.lookup_key("v", src, "k")),
                             _code(lambda: f.lookup_key("v", dst, "n")),
                             _code(lambda: f.bucket_info("v", link))]}
        return before, after
    finally:
        plane.close()


@pytest.mark.parametrize("phase", sorted(_PHASES))
def test_coordinator_crash_at_each_phase_matches_reference(tmp_path, phase):
    """The coordinator's writes replayed up to a crash point: the journal
    and intent rows, `recover`'s answer and the outcome equal the
    reference's; a second recover finds nothing."""
    got = _crash_script(PORT, tmp_path, _PHASES[phase])
    want = _crash_script(REF, tmp_path, _PHASES[phase])
    assert got == want
    before, after = got
    assert [r["txn_id"] for r in after["resolved"]] == ["t"]
    assert after["again"] == []
    assert not any(k.startswith(("txn/", "txn_intent/"))
                   for sid in after["shards"]
                   for k, _ in after["shards"][sid]["system"])
    committed = "decided_commit" in phase or "committed" in phase \
        or phase == "link_decided"
    if phase.startswith("link"):
        assert (after["lookups"][2] is None) == committed
    else:
        assert (after["lookups"][1] is None) == committed
        assert (after["lookups"][0] is None) != committed


def _ec_script(pkg, Cluster, tmp_path, data):
    from test_torch_control_plane import key_row, stored_chunks

    mini = Cluster(tmp_path / pkg.name / "data", num_datanodes=5,
                   block_size=64 * 1024, container_size=4 * 1024 * 1024,
                   stale_after_s=1000.0, dead_after_s=2000.0,
                   placement_seed=42, **pkg.kw)
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name / "meta",
                                       n_shards=2, scm=mini.scm,
                                       clients=mini.clients, **pkg.kw)
    try:
        oz = plane.client(mini.clients)
        oz.create_volume("v")
        m = plane.current_map()
        out = []
        for sid in plane.shard_ids:
            b = _bucket_on(m, "v", sid)
            bucket = oz.get_volume("v").create_bucket(b, replication=EC)
            bucket.write_key("k", data)
            info = plane.facade.lookup_key("v", b, "k")
            assert np.array_equal(bucket.read_key("k"), data)
            out.append((key_row(info), stored_chunks(mini, info)))
        plane.facade.rename_key_cross("v", _bucket_on(m, "v", "s0"), "k",
                                      _bucket_on(m, "v", "s1"), "k-moved")
        info = plane.facade.lookup_key("v", _bucket_on(m, "v", "s1"),
                                       "k-moved")
        out.append((key_row(info), stored_chunks(mini, info)))
        return out
    finally:
        plane.close()
        mini.close()


def test_ec_key_through_plane_matches_reference(tmp_path, monkeypatch):
    """One RS(3,2) key through each shard of each package's plane over a
    small MiniOzoneCluster (placement_seed 42), then a cross-shard
    rename: key rows, stored units and CRC words equal, and the renamed
    key's block groups are the source key's."""
    from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    data = np.random.default_rng(3).integers(0, 256, 3 * 64 * 1024 + 4097,
                                             dtype=np.uint8)
    got = _ec_script(PORT, MiniOzoneCluster, tmp_path, data)
    want = _ec_script(REF, JCluster, tmp_path, data)
    assert got == want
    assert len(got) == 3 and all(chunks for _, chunks in got)
    assert got[2][1] == got[0][1]  # the rename moved no data


def _fso_script(pkg, tmp_path):
    """FSO verbs on an FSO bucket owned by shard 1: through the facade
    (shard 0's OM, as `__getattr__` sends them) and through each package's
    RPC router."""
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name / "plane",
                                       n_shards=2, **pkg.kw)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        b1 = _bucket_on(m, "v", "s1", prefix="fso")
        b0 = _bucket_on(m, "v", "s0", prefix="fso")
        for b in (b0, b1):
            f.create_bucket("v", b, replication="RATIS/1",
                            layout="FILE_SYSTEM_OPTIMIZED")
        facade = [_code(lambda: f.create_directory("v", b1, "a/b")),
                  _code(lambda: f.get_file_status("v", b1, "a")),
                  _code(lambda: f.list_status("v", b1, "")),
                  _code(lambda: f.create_directory("v", b0, "a/b")),
                  _code(lambda: f.get_file_status("v", b0, "a")),
                  [s["name"] for s in f.list_status("v", b0, "a")]]
    finally:
        plane.close()
    return facade


def _fso_rpc_script(name, tmp_path):
    """The same FSO verbs over each package's MiniShardedCluster."""
    if name == "port":
        from ozone_tpu_torch.testing.minicluster import MiniShardedCluster

        cluster = MiniShardedCluster(tmp_path / name / "rpc", n_shards=2,
                                     device="cpu")
    else:
        from ozone_tpu.testing.minicluster import MiniShardedCluster

        cluster = MiniShardedCluster(tmp_path / name / "rpc", n_shards=2)
    om = cluster.om_client()
    try:
        om.create_volume("v")
        out = []
        for sid in ("s0", "s1"):
            b = _bucket_on(cluster.map, "v", sid, prefix="fso")
            om.create_bucket("v", b, replication="RATIS/1",
                             layout="FILE_SYSTEM_OPTIMIZED")
            om.create_directory("v", b, "a/b")
            st = om.get_file_status("v", b, "a")
            out.append((st["type"], st["name"],
                        [s["name"] for s in om.list_status("v", b, "a")]))
            stores = {s: sorted(k for k, _ in
                                cluster.daemons[s].om.store.iterate("dirs"))
                      for s in ("s0", "s1")}
            out.append({s: len(v) for s, v in stores.items()})
        return out
    finally:
        om.close()
        cluster.shutdown()


def test_unrouted_verbs_and_fso_across_shards_match_reference(tmp_path):
    """The facade sends FSO verbs to shard 0: on a bucket shard 1 owns
    they answer SHARD_MOVED, on shard 0's they work, in both packages.
    The RPC router routes them by (volume, bucket): over each package's
    MiniShardedCluster CreateDirectory, GetFileStatus and ListStatus land
    on the owning shard for buckets of both shards."""
    got, want = _fso_script(PORT, tmp_path), _fso_script(REF, tmp_path)
    assert got == want
    assert got[:3] == [SHARD_MOVED] * 3 and got[3:5] == [None, None]
    got = _fso_rpc_script("port", tmp_path)
    want = _fso_rpc_script("ref", tmp_path)
    assert got == want
    assert got[0][0] == "DIRECTORY" and got[1] == {"s0": 2, "s1": 0}
    assert got[3] == {"s0": 2, "s1": 2}


def _migrate_fso_script(pkg, tmp_path):
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name, n_shards=2,
                                       **pkg.kw)
    try:
        m = plane.current_map()
        s0 = plane.shards["s0"]
        s0.om.create_volume("v")
        plane.shards["s1"].om.create_volume("v")
        b = _bucket_on(m, "v", "s0", prefix="fso")
        s0.om.create_bucket("v", b, replication="RATIS/1",
                            layout="FILE_SYSTEM_OPTIMIZED")
        s0.om.create_directory("v", b, "a/b")
        before = {t: len(list(s0.om.store.iterate(t)))
                  for t in ("dirs", "dir_ids")}
        plane.migrate_slot(slot_for("v", b), "s1")
        s1 = plane.shards["s1"].om
        after = {t: len(list(s1.store.iterate(t)))
                 for t in ("dirs", "dir_ids")}
        return [before, after,
                s1.get_file_status("v", b, "a/b")["type"],
                _code(lambda: s1.create_directory("v", b, "a/b/c")),
                _code(lambda: _put_meta(s1, "v", b, "a/b/f", size=3)),
                _code(lambda: s1.get_file_status("v", b, "a/b/f"))]
    finally:
        plane.close()


def test_migrated_fso_bucket_leaves_dir_ids_behind_like_reference(tmp_path):
    """`_MIGRATE_TABLES` leaves out `dir_ids` (and `prefixes`) in both
    packages: a migrated FSO bucket's directories resolve on the new
    owner, but their object-id index rows stay on the old one, so the
    commit of a file under a migrated directory is refused
    (DIRECTORY_NOT_FOUND: the parent looks deleted) and its blocks go to
    the purge chain. A fault the port shares with the reference (ROADMAP
    Queue 3), pinned on both."""
    got = _migrate_fso_script(PORT, tmp_path)
    want = _migrate_fso_script(REF, tmp_path)
    assert got == want
    assert got[0] == {"dirs": 2, "dir_ids": 2}
    assert got[1] == {"dirs": 2, "dir_ids": 0}
    assert got[2] == "DIRECTORY" and got[3] is None
    # the shared fault: the file's commit is refused on the new owner
    assert got[4:] == ["DIRECTORY_NOT_FOUND", "KEY_NOT_FOUND"]


def _import_journal_script(pkg, tmp_path):
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name, n_shards=2,
                                       **pkg.kw)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        b = _bucket_on(m, "v", "s0")
        f.create_bucket("v", b, replication="RATIS/1")
        _put_meta(f, "v", b, "k", size=5)
        dst = plane.shards["s1"].om.store
        seq = dst.get_updates_since(0)[1]
        plane.migrate_slot(slot_for("v", b), "s1")
        ups, _, complete = dst.get_updates_since(seq)
        return complete, sorted((table, key, _stable(row))
                                for _, table, key, row in ups)
    finally:
        plane.close()


def test_import_row_journals_like_reference(tmp_path):
    """A migrated slot's rows land in the receiving shard's update
    journal as ordinary puts, in both packages: a journal tailer (the geo
    shipper, a snapshot diff) there sees the migrated key as a commit."""
    got = _import_journal_script(PORT, tmp_path)
    want = _import_journal_script(REF, tmp_path)
    assert got == want
    assert got[0] and any(t == "keys" for t, _, _ in got[1])


def test_router_pools_dial_with_the_clients_tls(tmp_path):
    """Over two secure shard daemons (mutual TLS, the second enrolled at
    the first's CA), a shard-aware client with a certificate routes to
    both shards through pools that carry its TLS identity; a plaintext
    dial is refused, directly and through a router built without TLS."""
    pytest.importorskip("cryptography")
    from ozone_tpu_torch.net.daemons import ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.om.sharding.router import ShardRouter
    from ozone_tpu_torch.storage.ids import StorageError
    from ozone_tpu_torch.utils.ca import CertificateClient

    secret = "shard-enroll"
    ports = _free_ports(3)
    book = {"s0": f"127.0.0.1:{ports[0]}", "s1": f"127.0.0.1:{ports[1]}"}
    m = ShardMap.uniform(["s0", "s1"], addresses=book)
    daemons = []
    try:
        for sid in ("s0", "s1"):
            kw = (dict(enroll_port=ports[2]) if sid == "s0"
                  else dict(ca_address=daemons[0].enroll_address))
            d = ScmOmDaemon(
                tmp_path / sid / "om.db", port=int(book[sid].split(":")[1]),
                stale_after_s=1000.0, dead_after_s=2000.0,
                background_interval_s=0.5, device="cpu", secure=True,
                enrollment_secret=secret,
                shard_config={"epoch": 1, "shard_id": sid, "slot_count": 64,
                              "owned": m.owned_slots(sid)},
                shard_map=m.to_json(), **kw)
            d.start()
            daemons.append(d)
        cc = CertificateClient(tmp_path / "cli", "client-cli")
        cc.enroll_remote(daemons[0].enroll_address, secret=secret)
        tls = cc.tls()
        om = RemoteOmClient(",".join(book.values()), tls=tls,
                            shard_aware=True)
        try:
            om.create_volume("v")
            for sid in ("s0", "s1"):
                b = _bucket_on(m, "v", sid)
                om.create_bucket("v", b, replication="RATIS/1")
                s = om.open_key("v", b, "k")
                om.commit_key(s, [], 0)
                assert daemons[int(sid[1])].om.store.get(
                    "keys", key_key("v", b, "k")) is not None
            assert all(p._tls is tls for p in om._router.pools.values())
        finally:
            om.close()
        plain = RemoteOmClient(book["s1"], shard_aware=False)
        try:
            with pytest.raises(StorageError):
                plain.get_shard_map()
        finally:
            plain.close()
        router = ShardRouter(m.to_json())
        try:
            _, pool = router.route("BucketInfo", {"volume": "v",
                                                  "bucket": "b0"})
            with pytest.raises(StorageError):
                pool.channel()[1].call("ozone.tpu.OmService", "GetShardMap",
                                       b"", timeout=5.0)
        finally:
            router.close()
    finally:
        for d in daemons:
            d.stop()


def test_sharding_entry_points_take_the_card_by_default():
    """The plane and MiniShardedCluster default to "cuda" and raise
    without it; every OM they build carries the caller's device."""
    import tempfile

    from ozone_tpu_torch.testing.minicluster import MiniShardedCluster

    assert not torch.cuda.is_available()
    for make in (lambda: ShardedMetaPlane(tempfile.mkdtemp()),
                 lambda: MiniShardedCluster(tempfile.mkdtemp())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with tempfile.TemporaryDirectory() as d:
        plane = ShardedMetaPlane(d, n_shards=2, device="cpu")
        try:
            assert plane.client().device == torch.device("cpu")
            assert {str(plane.shards[s].om.device) for s in plane.shard_ids} \
                == {"cpu"}
        finally:
            plane.close()


def _stale_commit_script(pkg, tmp_path):
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name, n_shards=2,
                                       **pkg.kw)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        b = _bucket_on(m, "v", "s0")
        f.create_bucket("v", b, replication="RATIS/1")
        s = f.open_key("v", b, "k")  # opened on s0
        plane.migrate_slot(slot_for("v", b), "s1")
        commit = _code(lambda: f.commit_key(s, [], 7))  # a stale map
        return [commit, _code(lambda: f.lookup_key("v", b, "k")),
                [k for k, _ in plane.shards["s0"].om.store.iterate("keys")],
                [k for k, _ in plane.shards["s1"].om.store.iterate("keys")]]
    finally:
        plane.close()


def test_commit_racing_a_migration_lands_on_the_new_owner(tmp_path):
    """A key opened before its slot migrates and committed through a
    facade still holding the old map: the reference's commit_key has no
    shard gate, so the commit lands on the old owner and the acknowledged
    key is lost to readers of the new one. The port gates the commit:
    SHARD_MOVED, a map refresh, and the commit lands on the new owner,
    which holds the copied open-key row. A departure on purpose (ROADMAP
    Queue 3), pinned on both sides."""
    got = _stale_commit_script(PORT, tmp_path)
    want = _stale_commit_script(REF, tmp_path)
    assert want == [None, "KEY_NOT_FOUND", ["/v/b0/k"], []]
    assert got == [None, None, [], ["/v/b0/k"]]


def _slab(sid: str, length: int) -> dict:
    """A metadata-only slab directory (ring-entry semantics only)."""
    return {"slab_id": sid, "replication": EC, "length": length,
            "block_groups": [{"container_id": 1, "local_id": 1,
                              "nodes": ["dn0", "dn1", "dn2", "dn3", "dn4"]}]}


def _commit_keys_script(pkg, tmp_path):
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name, n_shards=2,
                                       **pkg.kw)
    try:
        f = plane.facade
        m = plane.current_map()
        f.create_volume("v")
        b1 = _bucket_on(m, "v", "s1")
        f.create_bucket("v", b1, replication=EC)
        f.set_bucket_smallobj("v", b1)
        out = f.commit_keys("v", b1, _slab("r" * 16, 2_000),
                            [{"key": "k", "offset": 0, "length": 2_000,
                              "crc": 0}])
        sk = f"/v/{b1}/{'r' * 16}"
        return [out, f.lookup_key("v", b1, "k")["needle"]["slab"],
                [plane.shards[s].om.store.get("slabs", sk) is not None
                 for s in ("s0", "s1")]]
    finally:
        plane.close()


def test_commit_keys_routes_to_owning_shard_like_reference(tmp_path):
    """The small-object path's batched commit (the reference's
    `test_small_objects.py` case, held against it): the slab row and the
    key row land on the shard that owns the bucket, not shard 0."""
    got = _commit_keys_script(PORT, tmp_path)
    want = _commit_keys_script(REF, tmp_path)
    assert got == want
    assert got[0]["committed"] == ["k"] and got[1:] == ["r" * 16,
                                                         [False, True]]


def test_follower_reads_serve_inline_gets(tmp_path, monkeypatch):
    """An inline key's GET is complete from its row: on a ring shard
    with follower reads, lease holders answer >= 8 of 10 (the reference's
    `test_small_objects.py` case)."""
    import base64

    monkeypatch.setenv("OZONE_TPU_OM_FOLLOWER_READS", "1")
    plane = _plane(tmp_path, n_shards=1, mode="ring", replicas=3,
                   follower_reads=True, timers=False)
    try:
        f = plane.facade
        f.create_volume("v")
        f.create_bucket("v", "b", replication=EC)
        f.set_bucket_smallobj("v", "b")
        data = np.random.default_rng(5).integers(0, 256, 1_500,
                                                 dtype=np.uint8).tobytes()
        f.put_inline_key("v", "b", "k", data)
        hits0 = METRICS.counter("follower_read_hits").value
        for _ in range(10):
            assert base64.b64decode(f.lookup_key("v", "b", "k")["inline"]) \
                == data
        hits = METRICS.counter("follower_read_hits").value - hits0
        assert hits >= 8, f"only {hits}/10 inline GETs follower-served"
    finally:
        plane.close()


_THREAD_SIGTERM = """
import signal, sys, threading, time

def fire():
    # once main() has installed its handler and is waiting, SIGTERM goes
    # to this thread, not to the main one
    while signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
        time.sleep(0.05)
    time.sleep(0.5)
    signal.pthread_kill(threading.get_ident(), signal.SIGTERM)

threading.Thread(target=fire, daemon=True).start()
from {pkg}.tools.shardd import main
sys.exit(main(sys.argv[1:]))
"""


@pytest.mark.serial
def test_shardd_stops_on_a_sigterm_to_any_thread(tmp_path):
    """A SIGTERM that the kernel hands to one of shardd's threads: the
    reference's main thread waits without a timeout and never runs the
    handler (it is still up 8 s later); the port's timed wait runs it
    and exits 0. A departure on purpose (ROADMAP Queue 3), pinned on
    both sides."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    procs = {}
    for pkg in ("ozone_tpu_torch", "ozone_tpu"):
        book = f"s0=127.0.0.1:{_free_ports(1)[0]}"
        argv = ["--base", str(tmp_path / pkg), "--shard-id", "s0", "--shards",
                book] + (["--device", "cpu"] if pkg == "ozone_tpu_torch" else [])
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", _THREAD_SIGTERM.format(pkg=pkg), *argv],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        assert procs["ozone_tpu_torch"].wait(timeout=120) == 0
        from ozone_tpu.net.om_service import GrpcOmClient

        deadline = time.time() + 120
        while True:  # the reference's shard is up ...
            c = GrpcOmClient(book.split("=")[1], shard_aware=False)
            try:
                if c.get_shard_map():
                    break
            except Exception:
                assert time.time() < deadline, "the reference never came up"
                time.sleep(0.3)
            finally:
                c.close()
        time.sleep(8)  # ... past its handler's install and the signal
        assert procs["ozone_tpu"].poll() is None
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_shard_ring_daemons_serve_lease_reads(tmp_path, monkeypatch):
    """One shard as a 3-replica daemon ring over the RPC with follower
    reads on: the leader installs the shard config and map from its
    background loop (the deferred HA install), every replica answers
    GetShardMap, the router sends each read first to its round robin's
    replica with the client's applied floor, and lease-holding followers
    answer some of them; every answer is right."""
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.testing.minicluster import (
        await_meta_leader,
        make_meta_daemon,
    )

    monkeypatch.setenv("OZONE_TPU_OM_FOLLOWER_READS", "1")
    peers = {f"m{i}": f"127.0.0.1:{p}" for i, p in enumerate(_free_ports(3))}
    m = ShardMap.uniform(["s0"], addresses={"s0": ",".join(peers.values())})
    cfg = {"epoch": 1, "shard_id": "s0", "slot_count": 64,
           "owned": m.owned_slots("s0")}
    metas = {mid: make_meta_daemon(tmp_path, i, peers, device="cpu",
                                   shard_config=cfg, shard_map=m.to_json())
             for i, mid in enumerate(peers)}
    om = None
    try:
        for d in metas.values():
            d.start()
        await_meta_leader(metas)
        assert all(d.ha.push_commit_on_write for d in metas.values())
        deadline = time.time() + 30
        while not all(d.om.store.get("system", "shard_map")
                      for d in metas.values()):
            assert time.time() < deadline, "the shard map never replicated"
            time.sleep(0.1)
        om = RemoteOmClient(",".join(peers.values()), shard_aware=True)
        om.create_volume("v")
        om.create_bucket("v", "b", replication="RATIS/1")
        s = om.open_key("v", "b", "k")
        om.commit_key(s, [], 9)
        hits0 = METRICS.counter("follower_read_hits").value
        for _ in range(30):
            assert om.lookup_key("v", "b", "k")["size"] == 9
            assert [k["name"] for k in om.list_keys("v", "b")] == ["k"]
        assert METRICS.counter("follower_read_hits").value > hits0
        assert om._router.floor("s0") > 0
    finally:
        if om is not None:
            om.close()
        for d in metas.values():
            d.stop()


def _deposed_write_script(pkg, tmp_path):
    """A ring shard whose leader answers the facade's next write as a
    deposed leader does (NotRaftLeaderError), once."""
    plane = pkg.plane.ShardedMetaPlane(tmp_path / pkg.name, n_shards=1,
                                       mode="ring", replicas=3, timers=False,
                                       **pkg.kw)
    try:
        f = plane.facade
        f.create_volume("v")
        ring = plane.shards["s0"].await_leader()
        real = ring.om.submit
        hits = []

        def deposed_once(request):
            if not hits:
                hits.append(type(request).__name__)
                raise pkg.NotLeader(ring.node.node_id, None)
            return real(request)

        ring.om.submit = deposed_once
        out = [_code(lambda: f.create_bucket("v", "b",
                                              replication="RATIS/1")),
               _code(lambda: f.bucket_info("v", "b"))]
        return out + hits
    finally:
        plane.close()


def test_facade_write_retries_a_deposed_leader(tmp_path):
    """A write that reaches a ring shard's leader just as it is deposed:
    the reference's facade raises NotRaftLeaderError to its caller (a
    spontaneous election under ommg's load does this), the port's tries
    again on the shard's leader, as the plane's own submits do. A
    departure on purpose (ROADMAP Queue 3), pinned on both sides."""
    from ozone_tpu.consensus.raft import NotRaftLeaderError as JNotLeader
    from ozone_tpu_torch.consensus.raft import NotRaftLeaderError

    port = types.SimpleNamespace(**vars(PORT), NotLeader=NotRaftLeaderError)
    ref = types.SimpleNamespace(**vars(REF), NotLeader=JNotLeader)
    assert _deposed_write_script(port, tmp_path) == [None, None, "CreateBucket"]
    assert _deposed_write_script(ref, tmp_path) == [
        "NotRaftLeaderError", "BUCKET_NOT_FOUND", "CreateBucket"]
