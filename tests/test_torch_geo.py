"""Geo replication of the port against `ozone_tpu`'s, on the CPU.

Each test of `tests/test_replication_geo.py` but the Recon endpoint's
runs here as one script on each package: the rule model and the S3 XML
codec on both modules, the cluster cases on a (source, destination) pair
of each package's `MiniOzoneCluster`s with the destination registered in
process, as the reference's `pair` fixture builds it. The answers (cycle
stats, destination names, bytes and markers, error codes) must be equal,
and the reference test's own expectations must hold on the port's. Then:
the `replication` metric family's names; the replication bandwidth cap
(the reference's `Throttle` tests and a datanode daemon's cap on the
exports it serves and pulls); a differential test (a seeded sequence of
puts, overwrites, deletes, renames, snapshots and destination-side
overwrites under a prefix rule and a scheme-converting rule, with a cycle
after each step, on both packages); a TDE bucket shipped into a
destination bucket under its own key; one cycle between two port daemon
clusters over mutual TLS; the port's departure for a cursor from before
the store's restart, beside the reference's fault; and the slice as a
whole (`chip_smoke.geo_path` in miniature: rs-3-2-4096 at the source,
rs-2-1-4096 at the destination, the shipper over the RPC, a source
datanode stopped so the bootstrap decodes through the plain version).
"""

import re
import time
import types
import urllib.error
import urllib.request
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import ozone_tpu.om.requests as j_rq
import ozone_tpu.replication_geo.rules as j_rules
import ozone_tpu.replication_geo.shipper as j_geo
import ozone_tpu_torch.om.requests as t_rq
import ozone_tpu_torch.replication_geo.rules as t_rules
import ozone_tpu_torch.replication_geo.shipper as t_geo
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

EC = "rs-3-2-4096"
REF = types.SimpleNamespace(name="ref", geo=j_geo, Cluster=JCluster, kw={})
PORT = types.SimpleNamespace(name="port", geo=t_geo, Cluster=MiniOzoneCluster,
                             kw={"device": "cpu"})
#: the cycle stats both packages must count alike
STATS = ("keys_shipped", "deletes_shipped", "conflicts", "in_sync",
         "skipped", "failed", "bootstrapped", "complete")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _stats(s: dict) -> dict:
    return {k: s.get(k) for k in STATS if k in s} | (
        {"journal_gap": True} if s.get("journal_gap") else {})


def _code(fn):
    """The OMError code `fn` raises, or None."""
    try:
        fn()
    except (j_rq.OMError, t_rq.OMError) as e:
        return e.code
    return None


def _mini(P, root):
    return P.Cluster(root, num_datanodes=6, block_size=8 * 4096,
                     container_size=4 * 1024 * 1024, stale_after_s=1000.0,
                     dead_after_s=2000.0, **P.kw)


def pair_both(tmp_path, name, script):
    """`script(P, src, dst, endpoint)` on each package's pair; equal
    answers, the port's returned."""
    out = {}
    for P in (REF, PORT):
        src = _mini(P, tmp_path / P.name / "src")
        dst = _mini(P, tmp_path / P.name / "dst")
        endpoint = f"dst-{name}-{P.name}"
        P.geo.register_inprocess(endpoint, dst.client)
        try:
            out[P.name] = script(P, src, dst, endpoint)
        finally:
            P.geo.unregister_inprocess(endpoint)
            src.close()
            dst.close()
    assert out["port"] == out["ref"]
    return out["port"]


def _set_rule(src, endpoint, volume="v", bucket="b", **kw):
    src.om.set_bucket_geo_replication(volume, bucket, [{
        "id": kw.pop("id", "r1"), "endpoint": endpoint, **kw}])


def _read(cluster, volume, bucket, key):
    return cluster.client().get_volume(volume).get_bucket(bucket).read_key(key)


# ---------------------------------------------------------------- rules
def test_rule_validation():
    def script(R):
        ok = [R.ReplicationRule("r", endpoint="127.0.0.1:9860").validate()
              .to_json(),
              R.ReplicationRule("r", endpoint="ep", scheme=EC).validate()
              .to_json(),
              R.ReplicationRule("r", endpoint="ep", scheme="RATIS/THREE")
              .validate().to_json()]
        bad = []
        for fn in (lambda: R.ReplicationRule("", endpoint="ep").validate(),
                   lambda: R.ReplicationRule("r").validate(),
                   lambda: R.ReplicationRule("r", endpoint="ep",
                                             scheme="junk").validate(),
                   lambda: R.validate_rules(
                       [R.ReplicationRule("r", endpoint="ep").to_json()] * 2)):
            with pytest.raises(R.GeoReplicationError) as ei:
                fn()
            bad.append(str(ei.value))
        return ok, bad

    port, ref = script(t_rules), script(j_rules)
    assert port[0] == ref[0]
    # the same refusals; a bad scheme's message quotes the parser's own
    # words, which may differ, so that one compares by its prefix
    assert port[1][:2] + port[1][3:] == ref[1][:2] + ref[1][3:]
    assert port[1][2].split(": ")[:2] == ref[1][2].split(": ")[:2]


XML_BODY = b"""<?xml version="1.0"?>
<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">
  <Role></Role>
  <Rule>
    <ID>mirror</ID><Priority>2</Priority><Status>Enabled</Status>
    <Filter><Prefix>logs/</Prefix></Filter>
    <Destination>
      <Bucket>arn:aws:s3:10.0.0.2:9860::mirror-bucket</Bucket>
      <StorageClass>STANDARD_IA</StorageClass>
    </Destination>
  </Rule>
  <Rule>
    <ID>explicit</ID><Priority>1</Priority><Status>Disabled</Status>
    <Prefix>tmp/</Prefix>
    <Destination>
      <Endpoint>10.0.0.3:9860</Endpoint><Bucket>other</Bucket>
      <StorageClass>rs-3-2-4096</StorageClass>
    </Destination>
  </Rule>
  <Rule>
    <ID>renamed</ID><Priority>3</Priority>
    <Destination>
      <Bucket>arn:aws:s3:10.0.0.4:9860::drvol/drbucket</Bucket>
    </Destination>
  </Rule>
</ReplicationConfiguration>"""


def test_s3_xml_roundtrip_and_endpoint_forms():
    rules = t_rules.rules_from_s3_xml(XML_BODY, default_target="rs-6-3-1024k")
    assert rules == j_rules.rules_from_s3_xml(XML_BODY,
                                              default_target="rs-6-3-1024k")
    assert [r["id"] for r in rules] == ["explicit", "mirror", "renamed"]
    assert (rules[0]["endpoint"], rules[0]["bucket"], rules[0]["scheme"],
            rules[0]["enabled"]) == ("10.0.0.3:9860", "other", EC, False)
    assert (rules[1]["endpoint"], rules[1]["bucket"], rules[1]["scheme"],
            rules[1]["prefix"]) == ("10.0.0.2:9860", "mirror-bucket",
                                    "rs-6-3-1024k", "logs/")
    assert (rules[2]["volume"], rules[2]["bucket"], rules[2]["scheme"]) == \
        ("drvol", "drbucket", "")
    # the GET body: the same bytes from both packages, and it re-parses
    body = t_rules.rules_to_s3_xml(rules)
    assert body == j_rules.rules_to_s3_xml(rules)
    assert t_rules.rules_from_s3_xml(body) == rules
    assert t_rules.first_match(
        [t_rules.ReplicationRule.from_json(r) for r in rules],
        "logs/x").rule_id == "mirror"  # "explicit" is disabled


@pytest.mark.parametrize("body", [
    b"<junk",
    b"<ReplicationConfiguration/>",
    b"<ReplicationConfiguration><Rule><ID>x</ID></Rule>"
    b"</ReplicationConfiguration>",
    b"<ReplicationConfiguration><Rule><ID>x</ID><Destination>"
    b"<Bucket>arn:aws:s3:::plain</Bucket></Destination></Rule>"
    b"</ReplicationConfiguration>",
])
def test_s3_xml_rejects(body):
    msgs = []
    for R in (t_rules, j_rules):
        with pytest.raises(R.GeoReplicationError) as ei:
            R.rules_from_s3_xml(body)
        msgs.append(str(ei.value))
    if b"<junk" not in body:  # the XML parser's own message may differ
        assert msgs[0] == msgs[1]


def test_checkpoint_fencing_applies_alike(tmp_path):
    """GeoCheckpoint on each package's store: the same rows and the same
    refusals, through to_json/from_json (the ring's wire form)."""
    from ozone_tpu.om.metadata import OMMetadataStore as JStore
    from ozone_tpu_torch.om.metadata import OMMetadataStore as TStore

    steps = [dict(term=1, fence=True), dict(term=1, cursor={"txid": 5},
                                            stats={"keys_shipped": 2}),
             dict(term=2, fence=True), dict(term=1, cursor={"txid": 9}),
             dict(term=2, cursor={"txid": 9}, bootstrapped=["/v/b"]),
             dict(term=1, fence=True), dict(term=2, cursor={"txid": 12})]
    out = {}
    for name, rq, Store in (("ref", j_rq, JStore), ("port", t_rq, TStore)):
        store = Store(tmp_path / name / "om.db")
        rows = []
        for kw in steps:
            req = rq.OMRequest.from_json(rq.GeoCheckpoint(**kw).to_json())
            try:
                req.apply(store)
                rows.append(store.get("system", "geo_state"))
            except rq.OMError as e:
                rows.append(e.code)
        out[name] = rows
        store.close()
    assert out["port"] == out["ref"]
    assert out["port"][3] == out["port"][5] == t_rq.GEO_FENCED
    assert out["port"][-1] == {"term": 2, "cursor": {"txid": 12},
                               "bootstrapped": ["/v/b"],
                               "stats": {"keys_shipped": 2}}


# --------------------------------------------------------- convergence
def test_two_cluster_convergence_puts_overwrites_deletes(tmp_path):
    """Puts, overwrites and deletes converge byte-exact at the destination;
    the scheme-converting bucket lands EC (the port's through the codec
    service's bulk class); the lag goes back to 0."""
    from ozone_tpu_torch.codec import service as codec_service

    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        src.om.create_bucket("v", "ec", "RATIS/THREE")
        _set_rule(src, endpoint, bucket="b")
        src.om.set_bucket_geo_replication("v", "ec", [{
            "id": "conv", "endpoint": endpoint, "scheme": EC}])
        vb = sc.get_volume("v").get_bucket("b")
        ve = sc.get_volume("v").get_bucket("ec")
        data = {f"k{i}": _payload(20_000 + i, seed=i) for i in range(6)}
        bulk0 = codec_service.METRICS.histogram(
            "queue_wait_bulk_seconds").count
        for name, d in data.items():
            vb.write_key(name, d)
            ve.write_key(name, d)
        s1 = src.om.run_geo_once()
        data["k0"] = _payload(9_000, seed=100)
        data["k3"] = _payload(31_000, seed=101)
        for name in ("k0", "k3"):
            vb.write_key(name, data[name])
            ve.write_key(name, data[name])
        vb.delete_key("k1")
        ve.delete_key("k1")
        del data["k1"]
        s2 = src.om.run_geo_once()
        exact, marked = True, True
        for bname in ("b", "ec"):
            db = dst.client().get_volume("v").get_bucket(bname)
            for name, d in data.items():
                info = dst.om.lookup_key("v", bname, name)
                exact &= np.array_equal(db.read_key_info(info), d)
                marked &= (info["metadata"][P.geo.GEO_META_OID]
                           == src.om.lookup_key("v", bname, name)
                           ["object_id"])
        if P is PORT:
            assert codec_service.METRICS.histogram(
                "queue_wait_bulk_seconds").count > bulk0
        return (_stats(s1), _stats(s2), exact, marked,
                [_code(lambda b=b: dst.om.lookup_key("v", b, "k1"))
                 for b in ("b", "ec")],
                str(dst.om.lookup_key("v", "ec", "k0")["replication"]),
                str(dst.om.lookup_key("v", "b", "k0")["replication"]),
                src.om.geo_status()["lag"]["entries"],
                src.om.geo_status()["lag"]["seconds"])

    s1, s2, exact, marked, gone, ec_repl, b_repl, entries, secs = \
        pair_both(tmp_path, "conv", script)
    assert s1["complete"] and s1["failed"] == 0 and s1["keys_shipped"] >= 12
    assert s2["complete"] and s2["keys_shipped"] >= 4
    assert s2["deletes_shipped"] == 2
    assert exact and marked and gone == ["KEY_NOT_FOUND"] * 2
    assert ec_repl == EC and b_repl.startswith("RATIS")
    assert (entries, secs) == (0, 0.0)
    assert t_geo.METRICS.gauge("lag_entries").value == 0


def test_bootstrap_ships_preexisting_keys(tmp_path):
    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        d = _payload(12_345, seed=7)
        sc.get_volume("v").get_bucket("b").write_key("old-key", d)
        _set_rule(src, endpoint)  # installed after the write
        s1 = src.om.run_geo_once()
        got = _read(dst, "v", "b", "old-key")
        return _stats(s1), np.array_equal(got, d), \
            _stats(src.om.run_geo_once())

    s1, exact, s2 = pair_both(tmp_path, "boot", script)
    assert s1["bootstrapped"] == 1 and exact
    assert s2["bootstrapped"] == 0 and s2["keys_shipped"] == 0


def test_prefix_filter_and_rename_routing(tmp_path):
    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        src.om.set_bucket_geo_replication("v", "b", [{
            "id": "r1", "endpoint": endpoint, "prefix": "ship/",
            "bucket": "mirror", "volume": "dr"}])
        b = sc.get_volume("v").get_bucket("b")
        b.write_key("ship/yes", _payload(5000, seed=1))
        b.write_key("keep/no", _payload(5000, seed=2))
        s = src.om.run_geo_once()
        return (_stats(s), dst.om.lookup_key("dr", "mirror", "ship/yes")
                ["size"], _code(lambda: dst.om.lookup_key("dr", "mirror",
                                                          "keep/no")))

    s, size, missing = pair_both(tmp_path, "prefix", script)
    assert s["keys_shipped"] == 1 and size == 5000
    assert missing == "KEY_NOT_FOUND"


# ------------------------------------------------- idempotence / crash
def test_replay_idempotent_after_crash_before_checkpoint(tmp_path):
    """A shipper killed after it replayed a page but before its cursor
    committed: a fresh shipper re-applies the page as a no-op, and a
    deleted key stays deleted."""
    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        _set_rule(src, endpoint)
        b = sc.get_volume("v").get_bucket("b")
        d = _payload(22_222, seed=3)
        b.write_key("crashy", d)
        b.write_key("doomed", _payload(4_000, seed=4))
        src.om.run_geo_once()
        b.delete_key("doomed")
        b.write_key("crashy", d)

        class _Die(RuntimeError):
            pass

        s1 = P.geo.ReplicationShipper(src.om, clients=src.clients, **P.kw)
        orig = s1._checkpoint

        def crashing_checkpoint(term, cursor, **kw):
            if not kw.get("fence"):
                raise _Die("killed before the cursor committed")
            return orig(term, cursor, **kw)

        s1._checkpoint = crashing_checkpoint
        with pytest.raises(_Die):
            s1.run_once()
        landed = dst.om.lookup_key("v", "b", "crashy")["object_id"]
        cursor0 = (src.om.store.get("system", "geo_state") or {}).get("cursor")
        stats = P.geo.ReplicationShipper(src.om, clients=src.clients,
                                         **P.kw).run_once()
        cursor1 = (src.om.store.get("system", "geo_state") or {}).get("cursor")
        return (_stats(stats),
                dst.om.lookup_key("v", "b", "crashy")["object_id"] == landed,
                np.array_equal(_read(dst, "v", "b", "crashy"), d),
                _code(lambda: dst.om.lookup_key("v", "b", "doomed")),
                cursor1 != cursor0)

    stats, same_version, exact, doomed, moved = pair_both(tmp_path, "crash",
                                                          script)
    assert stats["complete"] and stats["failed"] == 0
    assert stats["keys_shipped"] == 0 and stats["in_sync"] >= 1
    assert same_version and exact and moved
    assert doomed == "KEY_NOT_FOUND"


def test_term_fencing_rejects_deposed_shipper(tmp_path):
    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        _set_rule(src, endpoint)
        kw = dict(clients=src.clients, **P.kw)
        old = P.geo.ReplicationShipper(src.om, term_fn=lambda: 1, **kw)
        new = P.geo.ReplicationShipper(src.om, term_fn=lambda: 2, **kw)
        first = (old.run_once()["complete"], new.run_once()["complete"])
        sc.get_volume("v").get_bucket("b").write_key(
            "late", _payload(1000, seed=5))
        fenced = old.run_once().get("fenced")
        term = int(src.om.store.get("system", "geo_state")["term"])
        s = new.run_once()
        oid = dst.om.lookup_key("v", "b", "late")["object_id"]
        again = new.run_once()["keys_shipped"]
        return (first, fenced, term, _stats(s), again,
                dst.om.lookup_key("v", "b", "late")["object_id"] == oid,
                np.array_equal(_read(dst, "v", "b", "late"),
                               _payload(1000, seed=5)))

    first, fenced, term, s, again, stable, exact = pair_both(
        tmp_path, "fence", script)
    assert first == (True, True) and fenced is True and term == 2
    assert s["complete"] and s["failed"] == 0
    assert again == 0 and stable and exact


# --------------------------------------------------------- LWW conflicts
def test_destination_overwrite_beats_stale_replay(tmp_path):
    def script(P, src, dst, endpoint):
        sc, dc = src.client(), dst.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        _set_rule(src, endpoint)
        b = sc.get_volume("v").get_bucket("b")
        b.write_key("contested", _payload(6000, seed=10))
        dc.create_volume("v")
        dst.om.create_bucket("v", "b", "RATIS/THREE")
        newer = _payload(7000, seed=11)
        dc.get_volume("v").get_bucket("b").write_key("contested", newer)
        s1 = src.om.run_geo_once()
        kept1 = np.array_equal(_read(dst, "v", "b", "contested"), newer)
        b.write_key("local-at-dest", _payload(100, seed=12))
        src.om.run_geo_once()
        local = _payload(200, seed=13)
        dc.get_volume("v").get_bucket("b").write_key("local-at-dest", local)
        b.delete_key("local-at-dest")
        s2 = src.om.run_geo_once()
        kept2 = np.array_equal(_read(dst, "v", "b", "local-at-dest"), local)
        return _stats(s1), kept1, _stats(s2), kept2

    s1, kept1, s2, kept2 = pair_both(tmp_path, "lww", script)
    assert s1["conflicts"] >= 1 and kept1
    assert s2["conflicts"] >= 1 and kept2


def test_source_overwrite_beats_stale_destination_replica(tmp_path):
    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        _set_rule(src, endpoint)
        b = sc.get_volume("v").get_bucket("b")
        b.write_key("k", _payload(1000, seed=20))
        src.om.run_geo_once()
        v2 = _payload(2000, seed=21)
        b.write_key("k", v2)
        s = src.om.run_geo_once()
        return _stats(s), np.array_equal(_read(dst, "v", "b", "k"), v2)

    s, exact = pair_both(tmp_path, "lww2", script)
    assert s["keys_shipped"] == 1 and exact


# ----------------------------------------------------- journal gap path
def _roll_journal(src):
    """The journal's retention rolling past the cursor."""
    with src.om.store._lock:
        src.om.store._updates.clear()
        src.om.store._txid += 10


def test_journal_gap_reconciles_and_retires_stale_replicas(tmp_path):
    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        _set_rule(src, endpoint)
        b = sc.get_volume("v").get_bucket("b")
        b.write_key("stays", _payload(3000, seed=30))
        b.write_key("goes", _payload(3000, seed=31))
        src.om.run_geo_once()
        b.delete_key("goes")
        d2 = _payload(4000, seed=32)
        b.write_key("fresh", d2)
        _roll_journal(src)
        s = src.om.run_geo_once()
        return (_stats(s), np.array_equal(_read(dst, "v", "b", "fresh"), d2),
                _code(lambda: dst.om.lookup_key("v", "b", "goes")),
                dst.om.lookup_key("v", "b", "stays")["size"])

    s, exact, goes, stays = pair_both(tmp_path, "gap", script)
    assert s.get("journal_gap") is True and exact
    assert goes == "KEY_NOT_FOUND" and stays == 3000


def test_fan_in_reconcile_never_retires_other_sources(tmp_path):
    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        for bname in ("b1", "b2"):
            src.om.create_bucket("v", bname, "RATIS/THREE")
            src.om.set_bucket_geo_replication("v", bname, [{
                "id": "fan", "endpoint": endpoint, "bucket": "shared"}])
        d1, d2 = _payload(3000, seed=50), _payload(3000, seed=51)
        b1 = sc.get_volume("v").get_bucket("b1")
        b2 = sc.get_volume("v").get_bucket("b2")
        b1.write_key("from-b1", d1)
        b2.write_key("from-b2", d2)
        src.om.run_geo_once()
        _roll_journal(src)
        s = src.om.run_geo_once()
        both = (np.array_equal(_read(dst, "v", "shared", "from-b1"), d1),
                np.array_equal(_read(dst, "v", "shared", "from-b2"), d2))
        b2.write_key("contest", d2)
        src.om.run_geo_once()
        b1.write_key("contest", d1)
        src.om.run_geo_once()
        b1.delete_key("contest")
        s2 = src.om.run_geo_once()
        try:
            row = dst.om.lookup_key("v", "shared", "contest")
            owner = (row.get("metadata") or {}).get("geo-src")
        except (j_rq.OMError, t_rq.OMError):
            owner = None
        return _stats(s), both, _stats(s2), owner

    s, both, s2, owner = pair_both(tmp_path, "fan", script)
    assert s.get("journal_gap") is True and s["deletes_shipped"] == 0
    assert both == (True, True)
    # a b1 tombstone retires only a b1-shipped row, never b2's data
    assert owner == "/v/b2" or (owner is None and s2["deletes_shipped"] >= 1)


# --------------------------------------------------------------- guards
def test_fso_bucket_rejected(tmp_path):
    def script(P, src, dst, endpoint):
        src.client().create_volume("v")
        src.om.create_bucket("v", "fso", "RATIS/THREE",
                             layout="FILE_SYSTEM_OPTIMIZED")
        return _code(lambda: _set_rule(src, endpoint, bucket="fso"))

    assert pair_both(tmp_path, "fso", script) == "INVALID_REQUEST"


def test_failed_destination_stalls_cursor_not_silently_skips(tmp_path):
    """A key that cannot reach its destination aborts the cycle without
    checkpointing its page. The port's unreachable destination is a
    closed loopback port (the reference's test names a host that does not
    resolve)."""
    src = _mini(PORT, tmp_path / "src")
    try:
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        _set_rule(src, "127.0.0.1:1")
        sc.get_volume("v").get_bucket("b").write_key("k",
                                                     _payload(100, seed=40))
        s = t_geo.ReplicationShipper(src.om, clients=src.clients,
                                     device="cpu")
        with pytest.raises(Exception):
            s.run_once()
        state = src.om.store.get("system", "geo_state") or {}
        assert not state.get("bootstrapped")
        assert not state.get("cursor")
        row = src.om.set_bucket_geo_replication(
            "v", "b", [{"id": "r1", "endpoint": "dst-elsewhere"}])
        assert row["geo_replication"][0]["endpoint"] == "dst-elsewhere"
    finally:
        src.close()


# ------------------------------------------------------------- gateway
def test_s3_gateway_replication_verbs(tmp_path):
    """The same requests against both gateways: the same statuses, error
    codes and GET bodies."""
    from ozone_tpu.gateway.s3 import S3Gateway as JGateway
    from ozone_tpu_torch.gateway.s3 import S3Gateway as TGateway

    body = ("<ReplicationConfiguration><Role></Role><Rule><ID>dr</ID>"
            "<Status>Enabled</Status><Filter><Prefix>logs/</Prefix></Filter>"
            "<Destination><Bucket>arn:aws:s3:10.9.9.9:9860::mirror</Bucket>"
            "<StorageClass>GLACIER</StorageClass></Destination></Rule>"
            "</ReplicationConfiguration>").encode()
    script = [("PUT", "/geo-b", None), ("GET", "/geo-b?replication", None),
              ("PUT", "/geo-b?replication", body),
              ("GET", "/geo-b?replication", None),
              ("PUT", "/geo-b?replication", b"<junk"),
              ("DELETE", "/geo-b?replication", None),
              ("GET", "/geo-b?replication", None),
              ("GET", "/nobucket?replication", None),
              ("PUT", "/fsob?replication", body)]
    out = {}
    for name, Gateway, P in (("ref", JGateway, REF), ("port", TGateway, PORT)):
        src = _mini(P, tmp_path / name)
        client = src.client()
        gw = Gateway(client, replication="RATIS/THREE")
        gw.start()
        answers = []
        try:
            for method, path, data in script:
                if path.startswith("/fsob"):
                    src.om.create_bucket("s3v", "fsob", "RATIS/THREE",
                                         layout="FILE_SYSTEM_OPTIMIZED")
                try:
                    r = urllib.request.urlopen(urllib.request.Request(
                        f"http://{gw.address}{path}", data=data,
                        method=method), timeout=30)
                    status, text = r.status, r.read()
                except urllib.error.HTTPError as e:
                    status, text = e.code, e.read()
                codes = re.findall(rb"<Code>(\w+)</Code>", text)
                answers.append((status, codes, text if status == 200
                                and method == "GET" else b""))
        finally:
            gw.stop()
            src.close()
        out[name] = answers
    assert out["port"] == out["ref"]
    statuses = [a[0] for a in out["port"]]
    assert statuses == [200, 404, 200, 200, 400, 204, 404, 404, 400]
    assert out["port"][1][1] == [b"ReplicationConfigurationNotFoundError"]
    assert out["port"][4][1] == [b"MalformedXML"]
    assert out["port"][8][1] == [b"InvalidRequest"]
    tree = ET.fromstring(out["port"][3][2])
    texts = {e.tag.rpartition("}")[2]: e.text for e in tree.iter()}
    assert texts["ID"] == "dr"
    assert texts["Bucket"] == "arn:aws:s3:10.9.9.9:9860::mirror"
    assert texts["StorageClass"].startswith("rs-")


# ----------------------------------------------------------- freon geo
def test_freon_geo_churn_converges(tmp_path):
    from ozone_tpu.tools import freon as j_freon
    from ozone_tpu_torch.tools import freon as t_freon

    def script(P, src, dst, endpoint):
        fr = t_freon if P is PORT else j_freon
        s = fr.geo(src.client(), endpoint, n_keys=12, size=6_000,
                   threads=2, dest_client=dst.client()).summary()
        return {k: s[k] for k in ("failures", "verify_failures", "shipped",
                                  "deletes_shipped", "conflicts",
                                  "ship_bytes", "lag_entries")}

    s = pair_both(tmp_path, "freon", script)
    assert s["failures"] == 0 and s["verify_failures"] == 0
    assert s["shipped"] >= 1 and s["deletes_shipped"] >= 1
    assert s["lag_entries"] == 0


# --------------------------------------------------------------- metrics
def test_replication_metric_names_match_the_reference():
    """The port's shipper writes the reference's `replication` counters,
    gauges and timer (the family `tests/test_observability.py` holds)."""
    import inspect

    def names(mod):
        src = inspect.getsource(mod)
        return {kind: set(re.findall(rf'METRICS\.{kind}\("(\w+)"\)', src))
                for kind in ("counter", "gauge", "timer")}

    port = names(t_geo)
    assert port == names(j_geo)
    assert port == {
        "counter": {"keys_shipped", "bytes_shipped", "deletes_shipped",
                    "conflicts", "ship_failures", "pages_shipped",
                    "leader_fences", "bootstraps", "journal_gaps",
                    "cycles"},
        "gauge": {"lag_entries", "lag_seconds"},
        "timer": {"ship_seconds"},
    }
    assert t_geo.METRICS.name == "replication"
    t_geo.METRICS.timer("ship_seconds").update(0.0)
    assert "ship_seconds_mean_s" in t_geo.METRICS.snapshot()


# ------------------------------------------------- replication throttle
def test_throttle_paces_and_records():
    from ozone_tpu_torch.utils.metrics import MetricsRegistry
    from ozone_tpu_torch.utils.throttle import Throttle

    mx = MetricsRegistry("t")
    th = Throttle(1024 * 1024, metrics=mx)  # 1 MiB/s
    t0 = time.monotonic()
    for _ in range(4):
        th.take(256 * 1024)  # 1 MiB, the burst covers 0.25 s of it
    dt = time.monotonic() - t0
    assert dt >= 0.6, f"cap did not bite: {dt:.2f}s for 1 MiB at 1 MiB/s"
    assert mx.counter("replication_throttle_ms").value > 0
    assert mx.counter("replication_throttled_bytes").value == 1024 * 1024


def test_replicate_command_honors_cap(tmp_path):
    """A datanode daemon's `replication_bandwidth_mbps` paces the copies
    it pulls (a ReplicateCommand) and the exports it serves; the CLI's
    `datanode --replication-bandwidth-mbps` sets it."""
    from ozone_tpu_torch.net.daemons import DatanodeDaemon
    from ozone_tpu_torch.scm.replication_manager import ReplicateCommand
    from ozone_tpu_torch.storage.ids import BlockData, BlockID, ChunkInfo
    from ozone_tpu_torch.tools.cli import build_parser

    cap = 100 / 1024  # 100 KiB/s
    data = _payload(200_000)

    def daemon(name, mbps):
        # never started: no SCM is dialed; only the RPC server serves
        return DatanodeDaemon(tmp_path / name, name, "127.0.0.1:1",
                              device="cpu", replication_bandwidth_mbps=mbps)

    made = []
    try:
        for n, (src_cap, dst_cap) in enumerate(((None, cap), (cap, None))):
            src, dst = daemon(f"src{n}", src_cap), daemon(f"dst{n}", dst_cap)
            made += [src, dst]
            src.dn.create_container(1)
            info = ChunkInfo("c0", 0, data.size)
            src.dn.write_chunk(BlockID(1, 1), info, data)
            src.dn.put_block(BlockData(BlockID(1, 1), [info]))
            src.dn.close_container(1)
            src.server.start()
            dst.clients.register_remote(src.dn.id, src.address)
            t0 = time.monotonic()
            dst._replicate(ReplicateCommand(1, src.dn.id, dst.dn.id))
            dt = time.monotonic() - t0
            # 200 KB at 100 KiB/s with a 0.25 s burst: >= ~1.7 s
            assert dt >= 1.2, f"the copy ignored the cap: {dt:.2f}s"
            capped = dst if dst_cap else src
            assert capped.dn.metrics.counter(
                "replication_throttle_ms").value > 0
            got = dst.dn.read_chunk(BlockID(1, 1), dst.dn.containers.get(1)
                                    .get_block(BlockID(1, 1)).chunks[0])
            assert np.array_equal(got, data)
    finally:
        for d in made:
            d.server.stop()
            d.stop_datapath()
            d.scm.close()
            d.clients.close()
            d.dn.close()
    args = build_parser().parse_args(
        ["datanode", "--root", "r", "--scm", "s",
         "--replication-bandwidth-mbps", "5"])
    assert args.replication_bandwidth_mbps == 5.0


# ------------------------------------------------------------ differential
def _diff_ops(seed: int, n: int) -> list:
    """A seeded op sequence over key names (decided once, for both)."""
    rng = np.random.default_rng(seed)
    live: list = []
    snaps = 0
    ops = [("put", "p/a", 3000), ("put", "q/a", 5000), ("put", "q/b", 4100)]
    live += ["p/a", "q/a", "q/b"]
    kinds = ["put", "overwrite", "delete", "rename", "dest_overwrite",
             "snapshot"]
    weights = np.array([4, 3, 2, 2, 2, 1], float)
    for i in range(n):
        kind = kinds[rng.choice(len(kinds), p=weights / weights.sum())]
        if kind != "put" and not live:
            kind = "put"
        size = int(rng.integers(100, 9000))
        if kind == "put":
            name = f"{'pq'[int(rng.integers(2))]}/k{i}"
            live.append(name)
            ops.append(("put", name, size))
        elif kind == "snapshot":
            if snaps < 2:
                snaps += 1
                ops.append(("snapshot", f"s{snaps}", 0))
        else:
            name = live[int(rng.integers(len(live)))]
            if kind == "delete":
                live.remove(name)
            elif kind == "rename":
                live.remove(name)
                new = f"{name.split('/')[0]}/r{i}"
                live.append(new)
                ops.append(("rename", name, new))
                continue
            ops.append((kind, name, size))
    return ops


def test_differential_geo_sequence(tmp_path):
    """A seeded sequence of puts, overwrites, deletes, renames, snapshots
    of the ruled bucket and destination-side overwrites, under a prefix
    rule (p/ -> bucket `pp`) and a scheme-converting rule (the rest, to
    RS(3,2)), with a cycle after each step on both packages: every cycle's
    stats, each destination bucket's names and bytes, each destination
    key's geo-src marker and whether its geo-src-oid names the source
    row's current object id are equal."""
    ops = _diff_ops(2019, 24)

    def script(P, src, dst, endpoint):
        sc, dc = src.client(), dst.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        src.om.set_bucket_geo_replication("v", "b", [
            {"id": "pre", "endpoint": endpoint, "prefix": "p/",
             "bucket": "pp"},
            {"id": "all", "endpoint": endpoint, "scheme": EC}])
        b = sc.get_volume("v").get_bucket("b")
        cycles = []
        for n, (kind, name, arg) in enumerate(ops):
            if kind in ("put", "overwrite"):
                b.write_key(name, _payload(arg, seed=n))
            elif kind == "delete":
                b.delete_key(name)
            elif kind == "rename":
                src.om.rename_key("v", "b", name, arg)
            elif kind == "snapshot":
                src.om.create_snapshot("v", "b", name)
            else:  # dest_overwrite: a source overwrite, then a later one
                # at the destination before the cycle (a stale replay)
                b.write_key(name, _payload(arg, seed=n))
                dbk = "pp" if name.startswith("p/") else "b"
                if _code(lambda: dst.om.lookup_key("v", dbk, name)) is None:
                    dc.get_volume("v").get_bucket(dbk).write_key(
                        name, _payload(arg, seed=1000 + n))
            cycles.append(_stats(src.om.run_geo_once()))
        state = {}
        for dbk in ("pp", "b"):
            db = dc.get_volume("v").get_bucket(dbk)
            for info in dst.om.list_keys("v", dbk):
                meta = info.get("metadata") or {}
                sk = info["name"]
                cur = None
                if _code(lambda: src.om.lookup_key("v", "b", sk)) is None:
                    cur = src.om.lookup_key("v", "b", sk)["object_id"]
                state[(dbk, sk)] = (
                    db.read_key_info(dst.om.lookup_key("v", dbk, sk))
                    .tobytes(), meta.get("geo-src"),
                    meta.get("geo-src-oid") == cur,
                    str(info.get("replication")))
        return cycles, state

    cycles, state = pair_both(tmp_path, "diff", script)
    assert all(c["failed"] == 0 and c["complete"] for c in cycles)
    assert sum(c["keys_shipped"] for c in cycles) > 0
    assert sum(c["deletes_shipped"] for c in cycles) > 0
    assert sum(c["conflicts"] for c in cycles) > 0
    assert {k[0] for k in state} == {"pp", "b"}
    assert all(v[3] == EC for k, v in state.items() if k[0] == "b"
               and v[1] is not None)


# -------------------------------------------------------- TDE, clusters
def test_tde_bucket_ships_into_destination_key(tmp_path):
    """A TDE source bucket ships into a destination bucket under its own
    master key: the destination reads the source's bytes, and its row's
    envelope is the destination KMS's, as the reference answers."""
    def script(P, src, dst, endpoint):
        src.om.kms_create_key("src-key")
        dst.om.kms_create_key("dst-key")
        sc, dc = src.client(), dst.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "enc", "RATIS/THREE",
                             encryption_key="src-key")
        dc.create_volume("v")
        dst.om.create_bucket("v", "enc", "RATIS/THREE",
                             encryption_key="dst-key")
        _set_rule(src, endpoint, bucket="enc")
        d = _payload(50_000, seed=60)
        sc.get_volume("v").get_bucket("enc").write_key("secret", d)
        s = src.om.run_geo_once()
        sinfo = src.om.lookup_key("v", "enc", "secret")
        dinfo = dst.om.lookup_key("v", "enc", "secret")
        return (_stats(s), np.array_equal(_read(dst, "v", "enc", "secret"), d),
                sinfo["encryption"]["master"], dinfo["encryption"]["master"],
                sinfo["encryption"]["edek"] != dinfo["encryption"]["edek"],
                sorted(dinfo["metadata"]))

    s, exact, smaster, dmaster, rewrapped, meta = pair_both(tmp_path, "tde",
                                                            script)
    assert s["keys_shipped"] == 1 and exact
    assert (smaster, dmaster, rewrapped) == ("src-key", "dst-key", True)
    assert meta == ["geo-src", "geo-src-mtime", "geo-src-oid"]


def test_shipper_dials_destination_over_mutual_tls(tmp_path):
    """One cycle between two port daemon clusters enrolled at one CA: the
    source daemon's shipper dials the destination with its own TLS
    identity (a plaintext dial would be refused)."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.utils.ca import CertificateClient

    secret = "geo-enroll"
    kw = dict(block_size=64 * 1024, background_interval_s=0.2, device="cpu",
              secure=True, enrollment_secret=secret)
    started = []
    src = ScmOmDaemon(tmp_path / "src" / "om.db", **kw)
    started.append(src)
    try:
        src.start()
        ca = src.enroll_address
        dst = ScmOmDaemon(tmp_path / "dst" / "om.db", ca_address=ca, **kw)
        started.append(dst)
        dst.start()
        for meta, name in ((src, "sdn"), (dst, "ddn")):
            d = DatanodeDaemon(tmp_path / name, name, meta.address,
                               heartbeat_interval_s=0.2, device="cpu",
                               ca_address=ca, enrollment_secret=secret)
            started.append(d)
            d.start()
        cc = CertificateClient(tmp_path / "cc", "client-geo")
        cc.enroll_remote(ca, secret=secret)
        tls = cc.tls()

        def client(meta):
            f = DatanodeClientFactory()
            f.tls = tls
            return OzoneClient(RemoteOmClient(meta.address, clients=f,
                                              tls=tls), f, device="cpu")

        sc, dc = client(src), client(dst)
        deadline = time.monotonic() + 20
        while src.scm.nodes.get("sdn") is None \
                or dst.scm.nodes.get("ddn") is None:
            assert time.monotonic() < deadline, "datanodes did not register"
            time.sleep(0.05)
        sc.create_volume("v")
        sc.om.create_bucket("v", "b", "RATIS/ONE")
        d = _payload(30_000, seed=70)
        sc.get_volume("v").get_bucket("b").write_key("k", d)
        src.om.set_bucket_geo_replication("v", "b", [{
            "id": "r", "endpoint": dst.address}])
        s = src.om.run_geo_once()
        assert s["keys_shipped"] == 1 and s["failed"] == 0
        remote = src.geo.remote(dst.address)
        assert remote.oz.om.tls is src.tls and remote.oz.clients.tls is src.tls
        assert np.array_equal(dc.get_volume("v").get_bucket("b").read_key("k"),
                              d)
        for c in (sc, dc):
            c.om.close()
            c.clients.close()
    finally:
        for x in reversed(started):
            x.stop()


def test_cursor_from_before_a_restart_reconciles(tmp_path):
    """The store's txids restart at 0 with its process, so the durable
    cursor then lies past the journal's head. The port reads that as a
    journal gap and reconciles (a departure on purpose); the reference
    reads it as "nothing pending" and skips the commits below it (a fault
    of the reference, kept there)."""
    def script(P, src, dst, endpoint):
        sc = src.client()
        sc.create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        _set_rule(src, endpoint)
        b = sc.get_volume("v").get_bucket("b")
        for i in range(4):
            b.write_key(f"k{i}", _payload(1000, seed=i))
        src.om.run_geo_once()
        with src.om.store._lock:  # what a restart of the process leaves
            src.om.store._updates.clear()
            src.om.store._txid = 0
        b.write_key("after", _payload(2000, seed=9))
        b.delete_key("k0")
        s = src.om.run_geo_once()
        return (_stats(s),
                _code(lambda: dst.om.lookup_key("v", "b", "after")),
                _code(lambda: dst.om.lookup_key("v", "b", "k0")),
                src.om.geo_status()["lag"]["entries"])

    out = {}
    for P in (REF, PORT):
        src = _mini(P, tmp_path / P.name / "src")
        dst = _mini(P, tmp_path / P.name / "dst")
        ep = f"dst-restart-{P.name}"
        P.geo.register_inprocess(ep, dst.client)
        try:
            out[P.name] = script(P, src, dst, ep)
        finally:
            P.geo.unregister_inprocess(ep)
            src.close()
            dst.close()
    stats, after, k0, lag = out["port"]
    assert stats["journal_gap"] is True
    assert (stats["keys_shipped"], stats["deletes_shipped"]) == (1, 1)
    assert (after, k0, lag) == (None, "KEY_NOT_FOUND", 0)
    r_stats, r_after, r_k0, _ = out["ref"]
    assert (r_stats["keys_shipped"], r_after, r_k0) == (0, "KEY_NOT_FOUND",
                                                        None)


def test_geo_slice_on_the_cpu():
    """The slice as a whole: `chip_smoke.geo_path` in miniature between
    two port daemon clusters (rs-3-2-4096 at the source, rs-2-1-4096 at
    the destination), the shipper dialing the destination over
    RemoteOmClient, the bootstrap of (e) decoding around a stopped source
    datanode through the plain version; every destination key byte-exact,
    every checked unit and CRC equal to the numpy coder's."""
    import chip_smoke

    out = chip_smoke.geo_path(
        torch.device("cpu"), 4096, 16 * 1024, 0, src_scheme="rs-3-2-4096",
        dst_scheme="rs-2-1-4096", n_dn=6, n_dst=4, n_big=3, big_cells=16,
        n_logs=6, log_cells=2, n_src2=2, freon_keys=6, processes=False)
    assert out["forms"]["degraded_decode"] > 0
    assert out["forms"]["degraded_encode"] > 0
    assert out["converge_s"] < 60
