"""Network-partition and verb-rule injection in the port, held against the
reference's.

`tests/test_partition.py`'s twelve scenarios on the port's RPC, raft
transport, daemons and clients (the blockade and byteman analogs), then:
the same seeded partition and rule sequence answered alike by both
packages' `consult`; the port's `clear` dropping verb rules (a departure:
the reference's leaves them); the lock-free answer with nothing injected;
one rule covering both datanode lanes; and ROADMAP Queue 3 item 5 made
deterministic with verb rules, pinned on both packages.
"""

import random
import time

import numpy as np
import pytest

from ozone_tpu.net import partition as j_partition
from ozone_tpu_torch.net import partition
from ozone_tpu_torch.net.rpc import RpcChannel, RpcServer
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.testing.minicluster import (
    await_meta_leader as _await_leader,
    free_ports,
    make_meta_daemon as _make_meta,
)

N_META = 3


def _clear_both():
    partition.clear()
    j_partition.clear()  # the reference's clear keeps the verb rules
    for r in j_partition.rules():
        j_partition.remove_rule(r["id"])


@pytest.fixture(autouse=True)
def _clean_partitions():
    _clear_both()
    yield
    _clear_both()


def _echo_server():
    server = RpcServer()
    server.add_service("echo", {"Echo": lambda b: b})
    server.start()
    return server


def test_blocked_channel_fails_like_a_cut_wire():
    server = _echo_server()
    try:
        ch = RpcChannel(server.address)
        assert bytes(ch.call("echo", "Echo", b"hi")) == b"hi"
        partition.block(server.address)
        with pytest.raises(StorageError) as ei:
            ch.call("echo", "Echo", b"hi")
        assert ei.value.code == "UNAVAILABLE"
        partition.heal(server.address)
        assert bytes(ch.call("echo", "Echo", b"hi")) == b"hi"
        ch.close()
    finally:
        server.stop()


def test_owner_scoped_block_only_cuts_tagged_channels():
    server = _echo_server()
    try:
        tagged = RpcChannel(server.address, owner="m0")
        plain = RpcChannel(server.address)
        partition.block(server.address, owner="m0")
        with pytest.raises(StorageError):
            tagged.call("echo", "Echo", b"x")
        assert bytes(plain.call("echo", "Echo", b"x")) == b"x"
        tagged.close()
        plain.close()
    finally:
        server.stop()


def test_insight_rpc_controls_partitions():
    """Partition, Heal and PartitionList on a daemon's insight service
    (how a drill between processes cuts links)."""
    from ozone_tpu_torch.utils.insight import InsightClient, InsightService

    server = RpcServer()
    InsightService(server, "test")
    server.start()
    try:
        cli = InsightClient(server.address)
        cli.partition("10.0.0.9:1234")
        assert partition.is_blocked("10.0.0.9:1234")
        assert [tuple(x) for x in cli.partition_list()] == \
            [("*", "10.0.0.9:1234")]
        cli.partition("10.0.0.9:1235", owner="m1")
        assert partition.is_blocked("10.0.0.9:1235", owner="m1")
        assert not partition.is_blocked("10.0.0.9:1235", owner="m2")
        cli.heal("10.0.0.9:1234")
        assert not partition.is_blocked("10.0.0.9:1234")
        cli.heal()  # no dst: clear everything
        assert cli.partition_list() == []
        with pytest.raises(StorageError) as ei:
            cli.heal(owner="m1")  # an owner without a dst is refused
        assert ei.value.code == "INVALID"
        with pytest.raises(StorageError):
            cli.partition("")
        cli.close()
    finally:
        server.stop()


def test_leader_isolation_elects_new_leader_and_heals(tmp_path):
    """The SCM/OM-isolation blockade scenario: both directions of the raft
    links between the leader and its followers cut; the majority elects a
    new leader and serves; the isolated one commits nothing; the heal
    deposes it and it catches up."""
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    ports = free_ports(N_META)
    peers = {f"m{i}": f"127.0.0.1:{ports[i]}" for i in range(N_META)}
    metas = {}
    try:
        for i in range(N_META):
            d = _make_meta(tmp_path, i, peers, device="cpu")
            d.start()
            metas[f"m{i}"] = d
        old = _await_leader(metas)
        followers = [m for m in metas if m != old]
        for f in followers:
            partition.block(peers[old], owner=f)   # f -> old
            partition.block(peers[f], owner=old)   # old -> f
        new = _await_leader(metas, timeout=15.0, among=followers)
        assert new != old
        om = RemoteOmClient(",".join(peers[f] for f in followers))
        om.create_volume("pv")
        assert "pv" in [v["name"] for v in om.list_volumes()]
        assert "pv" not in [v["name"] for v in metas[old].om.list_volumes()]
        partition.clear()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            vols = [v["name"] for v in metas[old].om.list_volumes()]
            if "pv" in vols and not metas[old].ha.is_leader:
                break
            time.sleep(0.1)
        assert "pv" in [v["name"] for v in metas[old].om.list_volumes()]
        assert not metas[old].ha.is_leader
        _await_leader(metas)
        om.close()
    finally:
        for d in metas.values():
            d.stop()


def _daemon_cluster(tmp_path, n, block_size):
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    meta = ScmOmDaemon(tmp_path / "om.db", block_size=block_size,
                       stale_after_s=1000.0, dead_after_s=2000.0,
                       background_interval_s=0.5)
    meta.start()
    dns = [DatanodeDaemon(tmp_path / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.2, device="cpu")
           for i in range(n)]
    for d in dns:
        d.start()
    clients = DatanodeClientFactory()
    oz = OzoneClient(RemoteOmClient(meta.address, clients=clients), clients,
                     device="cpu")
    return meta, dns, oz


def _stop(meta, dns, oz):
    oz.om.close()
    oz.clients.close()
    for d in dns:
        d.stop()
    meta.stop()


def test_ec_writes_and_reads_survive_partitioned_datanode(tmp_path):
    """The datanode-isolation scenario on the datapath: with the client's
    link to one datanode cut, EC writes exclude it, reads of a key with a
    unit there decode; the heal restores direct reads."""
    meta, dns, oz = _daemon_cluster(tmp_path, 6, 4 * 4096)
    try:
        b = oz.create_volume("v").create_bucket("b", replication="rs-3-2-4096")
        rng = np.random.default_rng(0)
        pre = rng.integers(0, 256, 30_000, dtype=np.uint8)
        b.write_key("pre", pre)
        victim = oz.om.lookup_key("v", "b", "pre")["block_groups"][0]["nodes"][0]
        partition.block(dns[[d.dn.id for d in dns].index(victim)].address)
        assert np.array_equal(b.read_key("pre"), pre)
        during = rng.integers(0, 256, 25_000, dtype=np.uint8)
        b.write_key("during", during)
        assert np.array_equal(b.read_key("during"), during)
        nodes = {n for g in oz.om.lookup_key("v", "b", "during")["block_groups"]
                 for n in g["nodes"]}
        assert victim not in nodes
        partition.clear()
        assert np.array_equal(b.read_key("pre"), pre)
    finally:
        _stop(meta, dns, oz)


def test_replicated_writes_survive_partitioned_datanode(tmp_path):
    """STANDALONE/ONE writes reallocate away from a member whose link is
    cut when its group is made."""
    meta, dns, oz = _daemon_cluster(tmp_path, 3, 4 * 4096)
    try:
        b = oz.create_volume("v").create_bucket(
            "b", replication="STANDALONE/ONE")
        partition.block(dns[0].address)
        rng = np.random.default_rng(1)
        for i in range(4):
            data = rng.integers(0, 256, 6_000, dtype=np.uint8)
            b.write_key(f"k{i}", data)
            assert np.array_equal(b.read_key(f"k{i}"), data)
            nodes = {n for g in oz.om.lookup_key("v", "b", f"k{i}")["block_groups"]
                     for n in g["nodes"]}
            assert dns[0].dn.id not in nodes
    finally:
        _stop(meta, dns, oz)


def test_block_rollover_survives_partitioned_datanode(tmp_path):
    """A key over several blocks keeps writing when a rollover allocation
    lands on a partitioned member."""
    from ozone_tpu_torch.client.replicated import ReplicatedKeyWriter

    meta, dns, oz = _daemon_cluster(tmp_path, 3, 2 * 4096)
    try:
        b = oz.create_volume("v").create_bucket(
            "b", replication="STANDALONE/ONE")
        partition.block(dns[1].address)
        data = np.random.default_rng(2).integers(0, 256, 40_000, dtype=np.uint8)
        om = oz.om
        session = om.open_key("v", "b", "multi")
        writer = ReplicatedKeyWriter(
            lambda excluded, ec=(): om.allocate_block(session, excluded, ec),
            oz.clients, block_size=8192, chunk_size=4096)
        writer.write(data)
        groups = writer.close()
        om.commit_key(session, groups, writer.bytes_written)
        assert np.array_equal(b.read_key("multi"), data)
        rows = om.lookup_key("v", "b", "multi")["block_groups"]
        assert len(rows) >= 3
        assert all(dns[1].dn.id not in g["nodes"] for g in rows)
    finally:
        _stop(meta, dns, oz)


def test_delay_injection_slows_but_does_not_break():
    """The slow-network scenario: a delayed link works, slowly; a delay
    past the caller's deadline fails like a slow link; heal removes it."""
    server = _echo_server()
    try:
        ch = RpcChannel(server.address)
        ch.call("echo", "Echo", b"x")
        partition.delay(server.address, 0.25)
        t0 = time.perf_counter()
        assert bytes(ch.call("echo", "Echo", b"x")) == b"x"
        slow = time.perf_counter() - t0
        assert slow >= 0.25
        with pytest.raises(StorageError) as ei:
            ch.call("echo", "Echo", b"x", timeout=0.05)
        assert ei.value.code == "UNAVAILABLE"
        partition.heal(server.address)
        t0 = time.perf_counter()
        ch.call("echo", "Echo", b"x")
        assert time.perf_counter() - t0 < slow / 2
        ch.close()
    finally:
        server.stop()


def test_delay_remote_control_plane():
    from ozone_tpu_torch.utils.insight import InsightClient, InsightService

    server = RpcServer()
    InsightService(server, "test")
    server.start()
    try:
        cli = InsightClient(server.address)
        cli.delay("10.0.0.9:1", 0.5)
        assert partition.delay_for("10.0.0.9:1") == 0.5
        assert [tuple(x) for x in cli.delays()] == [("*", "10.0.0.9:1", 0.5)]
        cli.heal("10.0.0.9:1")
        assert partition.delay_for("10.0.0.9:1") == 0.0
        cli.close()
    finally:
        server.stop()


def test_verb_rule_matching_and_expiry():
    """Method-boundary rules: verb-scoped, count-limited (fail the first
    N), folded with the address tables."""
    rid = partition.add_rule(dst="a:1", verb="Watch", drop_pct=100, count=2)
    assert partition.consult("a:1", "/svc/Watch", None) == (True, 0.0)
    assert partition.consult("a:1", "/svc/Submit", None) == (False, 0.0)
    assert partition.consult("b:2", "/svc/Watch", None) == (False, 0.0)
    assert partition.consult("a:1", "/svc/Watch", None) == (True, 0.0)
    assert partition.consult("a:1", "/svc/Watch", None) == (False, 0.0)
    assert all(r["id"] != rid for r in partition.rules())
    partition.add_rule(verb="Watch", delay_s=0.4)
    partition.delay("a:1", 0.1)
    assert partition.consult("a:1", "/svc/Watch", None) == (False, 0.4)
    assert partition.consult("a:1", "/svc/Other", None) == (False, 0.1)


def test_verb_rule_fires_through_rpc_channel():
    server = RpcServer()
    server.add_service("t.Svc", {"Echo": lambda req: req,
                                 "Other": lambda req: req})
    server.start()
    try:
        ch = RpcChannel(server.address)
        assert bytes(ch.call("t.Svc", "Echo", b"x")) == b"x"
        partition.add_rule(dst=server.address, verb="Echo", drop_pct=100,
                           count=1)
        with pytest.raises(StorageError) as ei:
            ch.call("t.Svc", "Echo", b"x")
        assert ei.value.code == "UNAVAILABLE"
        assert bytes(ch.call("t.Svc", "Other", b"y")) == b"y"
        assert bytes(ch.call("t.Svc", "Echo", b"x")) == b"x"  # expired
        # client- and server-streaming calls consult the rules too
        partition.block(server.address)
        with pytest.raises(StorageError):
            ch.call_streaming("t.Svc", "Echo", [b"a"])
        with pytest.raises(StorageError):
            list(ch.call_server_stream("t.Svc", "Echo", b"a"))
        ch.close()
    finally:
        server.stop()


def test_watch_downgrade_deterministic_slow_follower(tmp_path):
    """A verb rule failing raft append_entries to ONE follower (and its own
    votes) reproduces the slow-follower interleaving: watchForCommit(ALL)
    times out and degrades to MAJORITY, the write completes, and removing
    the rules lets ALL complete again."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.client.ratis_client import XceiverClientRatis
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.ratis_service import RatisClientFactory
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig

    meta = ScmOmDaemon(tmp_path / "om.db", stale_after_s=1000.0,
                       dead_after_s=2000.0)
    meta.start()
    dns = [DatanodeDaemon(tmp_path / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.1, device="cpu")
           for i in range(3)]
    for d in dns:
        d.start()
    try:
        clients = DatanodeClientFactory()
        om = RemoteOmClient(meta.address, clients=clients)
        scm = RemoteScmClient(meta.address)
        for dn_id, addr in scm.node_addresses().items():
            clients.register_remote(dn_id, addr)
        ratis = RatisClientFactory(address_source=clients.remote_address)
        oz = OzoneClient(om, clients, ratis_clients=ratis, device="cpu")
        oz.create_volume("v")
        b = oz.get_volume("v").create_bucket("b", replication="RATIS/THREE")
        b.write_key("k0", np.random.default_rng(1).integers(
            0, 256, 50_000, dtype=np.uint8))
        g = oz.om.lookup_key("v", "b", "k0")["block_groups"][0]
        pipeline = Pipeline(ReplicationConfig.parse("RATIS/THREE"), list(g["nodes"]),
                            id=int(g["pipeline_id"]))
        x = XceiverClientRatis(pipeline, ratis)
        x.submit({"verb": "create_container", "container_id": 776})
        follower = next(n for n in pipeline.nodes if n != x._leader)
        rules = [partition.add_rule(dst=clients.remote_address(follower),
                                    verb="append_entries", drop_pct=100),
                 partition.add_rule(owner=follower, verb="request_vote",
                                    drop_pct=100)]
        idx = int(x.submit({"verb": "create_container",
                            "container_id": 777})["index"])
        assert not x._degraded
        assert int(x.watch_for_commit(idx, timeout=1.5)["index"]) >= idx
        assert x._degraded, "watch(ALL) should have degraded to MAJORITY"
        assert int(x.watch_for_commit(idx, timeout=1.5)["index"]) >= idx
        for r in rules:
            partition.remove_rule(r)
        fresh = XceiverClientRatis(pipeline, ratis)
        deadline = time.monotonic() + 20
        while True:
            try:
                fresh.watch_for_commit(idx, timeout=2.0)
                assert not fresh._degraded
                break
            except StorageError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.5)
        ratis.close()
        scm.close()
        om.close()
        clients.close()
    finally:
        for d in dns:
            d.stop()
        meta.stop()


# ------------------------------------------------------ against ozone_tpu
def _sequence(p, seed: int) -> list:
    """A seeded script of partitions, delays, heals and rules, and the
    consult answer after each step."""
    rng = random.Random(seed)
    dsts = ["a:1", "b:2", "c:3"]
    owners = [p.ANY, "m0", "m1"]
    verbs = ["AppendEntries", "WriteChunksCommit", "Echo"]
    out = []
    for step in range(60):
        op = rng.choice(["block", "delay", "heal", "rule", "probe", "probe"])
        dst, owner = rng.choice(dsts), rng.choice(owners)
        if op == "block":
            p.block(dst, owner)
        elif op == "delay":
            p.delay(dst, rng.choice([0.1, 0.25]), owner)
        elif op == "heal":
            p.heal(dst, owner)
        elif op == "rule":
            p.add_rule(dst=rng.choice(dsts + [p.ANY]),
                       verb=rng.choice(verbs + [p.ANY]),
                       owner=rng.choice(owners),
                       delay_s=rng.choice([0.0, 0.3]),
                       drop_pct=rng.choice([0.0, 50.0, 100.0]),
                       count=rng.choice([None, 1, 2, 3]),
                       seed=step)
        for d in dsts:
            for o in (None, "m0", "m1"):
                for v in (None, "/svc/AppendEntries", "/svc/Echo"):
                    out.append((step, d, o, v, p.consult(d, v, o)))
        out.append((step, p.blocked(), p.delayed(),
                    [{k: r[k] for k in r if k != "id"} for r in p.rules()]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consult_answers_equal_the_reference(seed):
    got = _sequence(partition, seed)
    _clear_both()
    want = _sequence(j_partition, seed)
    assert got == want


def test_clear_drops_verb_rules_unlike_the_reference():
    """A departure on purpose: the port's clear also drops the verb rules,
    so a rule a failed drill left behind does not fire in what runs next;
    the reference's clear keeps them."""
    for p in (partition, j_partition):
        p.add_rule(verb="Echo", drop_pct=100)
        p.block("a:1")
        p.clear()
    assert partition.rules() == [] and partition.consult("x:1", "/s/Echo") \
        == (False, 0.0)
    assert len(j_partition.rules()) == 1 and \
        j_partition.consult("x:1", "/s/Echo") == (True, 0.0)


def test_consult_takes_no_lock_with_nothing_injected(monkeypatch):
    class Refuse:
        def __enter__(self):
            raise AssertionError("consult took the lock")

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(partition, "_lock", Refuse())
    assert partition.consult("a:1", "/svc/Echo", "m0") == (False, 0.0)


def test_one_rule_covers_both_datanode_lanes(tmp_path):
    """A rule keyed by the datanode's RPC address fires on the native
    sidecar's stream and on the RPC verb alike."""
    from ozone_tpu_torch.client.native_dn import NativeDatanodeClient
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.storage.ids import BlockData, BlockID, ChunkInfo
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    meta = ScmOmDaemon(tmp_path / "om.db")
    meta.start()
    d = DatanodeDaemon(tmp_path / "dn0", "dn0", meta.address, device="cpu")
    d.start()
    data = np.arange(4096, dtype=np.uint8)
    cs = Checksum(ChecksumType.CRC32C, 1024).compute(data)
    try:
        for native in (True, False):
            c = NativeDatanodeClient("dn0", d.address, native=native)
            cid = 11 if native else 12
            c.create_container(cid)
            bid = BlockID(cid, 1)
            pairs = [(ChunkInfo("c0", 0, data.size, cs), data)]
            rid = partition.add_rule(dst=d.address, verb="WriteChunksCommit",
                                     drop_pct=100, count=1)
            with pytest.raises(StorageError) as ei:
                c.write_chunks_commit(bid, pairs,
                                      commit=BlockData(bid, [pairs[0][0]]))
            assert ei.value.code == "UNAVAILABLE"
            assert all(r["id"] != rid for r in partition.rules())
            c.write_chunks_commit(bid, pairs, commit=BlockData(bid, [pairs[0][0]]))
            partition.block(d.address)
            with pytest.raises(StorageError):
                c.read_chunks(bid, [pairs[0][0]])
            partition.heal(d.address)
            got = c.read_chunks(bid, [pairs[0][0]])
            assert np.array_equal(np.asarray(got[0]), data)
            c.close()
        assert d.dn.metrics.counter("native_write_streams").value >= 1
    finally:
        d.stop()
        meta.stop()


# ------------------------------------- ROADMAP Queue 3 item 5, both sides
def _retried_create(tmp_path, pkg) -> tuple:
    """Three metadata replicas; the followers' votes dropped (no election
    can depose the leader) and the leader's append_entries delayed 0.6 s by
    verb rules, so the ring commits a CreateBucket only after its caller,
    waiting 0.2 s on the wire, has given up on the answer (the cut
    connection of the fault). The caller's retry meets its own write:
    BUCKET_ALREADY_EXISTS."""
    ports = free_ports(N_META)
    peers = {f"m{i}": f"127.0.0.1:{ports[i]}" for i in range(N_META)}
    metas = {}
    try:
        for i in range(N_META):
            kw = {"device": "cpu"} if pkg.name == "port" else {}
            d = pkg.make_meta(tmp_path / pkg.name, i, peers, **kw)
            d.start()
            metas[f"m{i}"] = d
        lead = pkg.await_leader(metas)
        om = pkg.om_client(peers[lead])
        om.create_volume("v")
        for m in metas:
            if m != lead:
                pkg.partition.add_rule(owner=m, verb="request_vote",
                                       drop_pct=100)
        pkg.partition.add_rule(owner=lead, verb="append_entries", delay_s=0.6)
        _, ch = om._pool.channel()
        call = ch.call
        ch.call = lambda service, method, req, timeout=None: call(
            service, method, req, timeout=0.2)
        first = None
        try:
            om.create_bucket("v", "b")
        except Exception as e:  # noqa: BLE001 - the unanswered attempt
            first = getattr(e, "code", type(e).__name__)
        finally:
            ch.call = call
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(bk["name"] == "b"
                   for bk in metas[lead].om.list_buckets("v")):
                break
            time.sleep(0.05)
        took = any(bk["name"] == "b" for bk in metas[lead].om.list_buckets("v"))
        try:
            om.create_bucket("v", "b")
            second = "OK"
        except Exception as e:  # noqa: BLE001 - the retry's answer
            second = getattr(e, "code", type(e).__name__)
        still_leader = metas[lead].ha.is_leader
        om.close()
        return first, took, second, still_leader
    finally:
        for d in metas.values():
            d.stop()


def test_retried_write_meets_its_own_commit_on_both_packages(tmp_path):
    """ROADMAP Queue 3 item 5, deterministic: a write whose answer never
    reached its caller took effect, and its retry answers
    BUCKET_ALREADY_EXISTS in both packages (shared, kept: neither has a
    retry cache)."""
    import types

    from ozone_tpu.net.om_service import GrpcOmClient
    from ozone_tpu.testing import minicluster as j_mini
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    port = types.SimpleNamespace(
        name="port", make_meta=_make_meta, await_leader=_await_leader,
        om_client=RemoteOmClient, partition=partition)
    ref = types.SimpleNamespace(
        name="ref", make_meta=j_mini.make_meta_daemon,
        await_leader=j_mini.await_meta_leader, om_client=GrpcOmClient,
        partition=j_partition)
    got = _retried_create(tmp_path, port)
    _clear_both()
    want = _retried_create(tmp_path, ref)
    assert got == want == ("UNAVAILABLE", True, "BUCKET_ALREADY_EXISTS", True)


def test_cli_insight_partition_verbs():
    """`insight partition|delay|partitions|heal` through the CLI against a
    daemon's insight service; heal --owner without --dst is refused."""
    import contextlib
    import io
    import json

    from ozone_tpu_torch.tools import cli
    from ozone_tpu_torch.utils.insight import InsightService

    server = RpcServer()
    InsightService(server, "test")
    server.start()

    def run(*argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["insight", *argv, "--address", server.address])
        return rc, out.getvalue(), err.getvalue()

    try:
        rc, out, _ = run("partition", "--dst", "10.0.0.1:1", "--owner", "m0")
        assert rc == 0 and json.loads(out) == {"blocked": [["m0", "10.0.0.1:1"]]}
        rc, out, _ = run("delay", "--dst", "10.0.0.2:2", "--seconds", "0.3")
        assert rc == 0 and json.loads(out)["delayed"] == [["*", "10.0.0.2:2", 0.3]]
        rc, out, _ = run("partitions")
        assert json.loads(out) == {"blocked": [["m0", "10.0.0.1:1"]],
                                   "delayed": [["*", "10.0.0.2:2", 0.3]]}
        assert run("partition")[0] == 1
        assert run("heal", "--owner", "m0")[0] == 1
        rc, out, _ = run("heal", "--dst", "10.0.0.1:1", "--owner", "m0")
        assert rc == 0 and json.loads(out) == {"blocked": []}
        rc, out, _ = run("heal")
        assert rc == 0 and partition.delayed() == []
    finally:
        server.stop()
