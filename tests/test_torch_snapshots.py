"""Bucket snapshots of the port against `ozone_tpu`'s, on the CPU.

Each test of `tests/test_snapshot_cow.py` and the snapshot tests of
`tests/test_upgrade_snapshots.py` runs as one script on each package (an
`OzoneManager` over a bare SCM, or a `MiniOzoneCluster` with
placement_seed=42 and the same seeded bytes, or the daemons over each
package's RPC); the answers must be equal, and the reference test's own
expectations must hold on the port's. Rows are compared without what
differs run to run by design (ids and timestamps), except in the
differential test, where the port applies the very requests the
reference pre-executed, so every row must be the same JSON. Also: the
port reads the snapshots of a database the reference wrote (materialized
ones included); the slice as a whole (a `.snapshot/` GET of a deleted
key decoding around a stopped datanode through the plain kernel
version); snapshot lookups pointing units at their current homes (the
port's departure); GDPR keys under a snapshot; and the pre-image call
sites, one for one with the reference's.
"""

import dataclasses
import re
import shutil
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import ozone_tpu.om.requests as j_rq
import ozone_tpu_torch.om.requests as t_rq
from ozone_tpu.om.om import OzoneManager as JOM
from ozone_tpu.om.snapshots import SnapshotManager as JSM
from ozone_tpu.scm.scm import StorageContainerManager as JSCM
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.om.om import OzoneManager as TOM
from ozone_tpu_torch.om.snapshots import SnapshotManager as TSM
from ozone_tpu_torch.scm.scm import StorageContainerManager as TSCM
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

EC = "rs-3-2-4096"
FSO = "FILE_SYSTEM_OPTIMIZED"
REF = types.SimpleNamespace(name="ref", rq=j_rq, OM=JOM, SM=JSM, SCM=JSCM,
                            kw={})
PORT = types.SimpleNamespace(name="port", rq=t_rq, OM=TOM, SM=TSM, SCM=TSCM,
                             kw={"device": "cpu"})
#: fields that differ between two runs of one script by design
VOLATILE = ("object_id", "parent_id", "created", "modified", "ts",
            "pipeline_id", "snap_id", "previous", "job_id", "file_id",
            "upload_id", "client_id")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def strip(x):
    """A row, list or tuple without the volatile fields (a diff report's
    own keys, "modified" among them, stay)."""
    if isinstance(x, (list, tuple)):
        return type(x)(strip(r) for r in x)
    if isinstance(x, dict):
        report = {"added", "deleted"} <= set(x)
        return {k: strip(v) for k, v in x.items()
                if report or k not in VOLATILE}
    return x


def code(fn):
    """The OMError code `fn` raises, or None."""
    try:
        fn()
    except (j_rq.OMError, t_rq.OMError) as e:
        return e.code
    return None


def _bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


# ------------------------------------------------ OM over a bare SCM
def _om(P, root):
    scm = P.SCM(stale_after_s=1e6, dead_after_s=2e6)
    for i in range(5):
        scm.register_datanode(f"dn{i}")
    om = P.OM(root / "om.db", scm, **P.kw)
    om.create_volume("v")
    om.create_bucket("v", "b", EC)
    om.create_bucket("v", "f", EC, layout=FSO)
    return om


def om_both(tmp_path, script):
    """`script(P, om)` on each package's OM; equal answers, the port's
    returned."""
    out = {}
    for P in (REF, PORT):
        om = _om(P, tmp_path / P.name)
        try:
            out[P.name] = strip(script(P, om))
        finally:
            om.close()
    assert out["port"] == out["ref"]
    return out["port"]


def _commit(om, key, size=10, bucket="b"):
    s = om.open_key("v", bucket, key)
    om.commit_key(s, [], size)


def _overlay_rows(P, om, snap_id, bucket="b"):
    p = P.rq.snap_prefix("v", bucket, snap_id) + "/"
    return {k[len(p):]: v for k, v in om.store.iterate("keys", p)}


def _names(rows):
    return sorted(k["name"] for k in rows)


# ---------------------------------------- tests/test_snapshot_cow.py
def test_create_is_o_snapshots_not_o_bucket(tmp_path):
    def script(P, om):
        for i in range(50):
            _commit(om, f"k{i}")
        info = om.create_snapshot("v", "b", "s1")
        sm = P.SM(om)
        return (info["cow"], _overlay_rows(P, om, info["snap_id"]),
                len(sm.list_keys("v", "b", "s1")),
                sm.lookup_key("v", "b", "s1", "k7")["name"])

    assert om_both(tmp_path, script) == (True, {}, 50, "k7")


def test_overwrite_preserves_first_image_only(tmp_path):
    def script(P, om):
        _commit(om, "k", size=10)
        info = om.create_snapshot("v", "b", "s1")
        _commit(om, "k", size=20)
        _commit(om, "k", size=30)
        sm = P.SM(om)
        return (sm.lookup_key("v", "b", "s1", "k")["size"],
                om.lookup_key("v", "b", "k")["size"],
                len(_overlay_rows(P, om, info["snap_id"])))

    assert om_both(tmp_path, script) == (10, 30, 1)


def test_new_key_after_snapshot_gets_absent_marker(tmp_path):
    def script(P, om):
        _commit(om, "old")
        info = om.create_snapshot("v", "b", "s1")
        _commit(om, "born-later")
        sm = P.SM(om)
        return (_names(sm.list_keys("v", "b", "s1")),
                code(lambda: sm.lookup_key("v", "b", "s1", "born-later")),
                om.lookup_key("v", "b", "born-later")["name"],
                _overlay_rows(P, om, info["snap_id"]))

    names, err, live, rows = om_both(tmp_path, script)
    assert names == ["old"] and err == "KEY_NOT_FOUND" and live == "born-later"
    assert list(rows.values()) == [{"__absent__": True}]


def test_delete_and_rename_preserve(tmp_path):
    def script(P, om):
        _commit(om, "gone", size=5)
        _commit(om, "moved", size=6)
        om.create_snapshot("v", "b", "s1")
        om.delete_key("v", "b", "gone")
        om.rename_key("v", "b", "moved", "now-here")
        sm = P.SM(om)
        return (sm.lookup_key("v", "b", "s1", "gone")["size"],
                sm.lookup_key("v", "b", "s1", "moved")["size"],
                code(lambda: sm.lookup_key("v", "b", "s1", "now-here")),
                sm.snapshot_diff("v", "b", "s1"))

    gone, moved, err, diff = om_both(tmp_path, script)
    assert (gone, moved, err) == (5, 6, "KEY_NOT_FOUND")
    assert diff["deleted"] == ["gone"]
    assert diff["renamed"] == [["moved", "now-here"]]


def test_chained_snapshots_resolve_oldest_overlay(tmp_path):
    def script(P, om):
        _commit(om, "k", size=1)
        om.create_snapshot("v", "b", "s1")
        _commit(om, "k", size=2)
        om.create_snapshot("v", "b", "s2")
        _commit(om, "k", size=3)
        om.create_snapshot("v", "b", "s3")
        sm = P.SM(om)
        return ([sm.lookup_key("v", "b", s, "k")["size"]
                 for s in ("s1", "s2", "s3")],
                om.lookup_key("v", "b", "k")["size"])

    assert om_both(tmp_path, script) == ([1, 2, 3], 3)


def test_delete_snapshot_merges_down(tmp_path):
    def script(P, om):
        _commit(om, "k", size=1)
        _commit(om, "stay", size=7)
        om.create_snapshot("v", "b", "s1")
        om.create_snapshot("v", "b", "s2")
        _commit(om, "k", size=2)  # the pre-image lands in s2
        om.delete_snapshot("v", "b", "s2")  # and merges down into s1
        sm = P.SM(om)
        out = (sm.lookup_key("v", "b", "s1", "k")["size"],
               sm.lookup_key("v", "b", "s1", "stay")["size"])
        om.delete_snapshot("v", "b", "s1")
        return out + (om.list_snapshots("v", "b"),
                      [k for k, _ in om.store.iterate("keys", "/.snapshot/")])

    assert om_both(tmp_path, script) == (1, 7, [], [])


def test_delete_snapshot_does_not_clobber_older_entry(tmp_path):
    def script(P, om):
        _commit(om, "k", size=1)
        om.create_snapshot("v", "b", "s1")
        _commit(om, "k", size=2)
        om.create_snapshot("v", "b", "s2")
        _commit(om, "k", size=3)
        om.delete_snapshot("v", "b", "s2")
        return P.SM(om).lookup_key("v", "b", "s1", "k")["size"]

    assert om_both(tmp_path, script) == 1


def test_attrs_and_acl_mutations_preserve(tmp_path):
    def script(P, om):
        _commit(om, "k")
        om.create_snapshot("v", "b", "s1")
        om.set_key_attrs("v", "b", "k", {"owner": "root"})
        om.modify_acl("key", "v", "b", "k", "add", ["user:alice:rw"])
        sm = P.SM(om)
        snap = sm.lookup_key("v", "b", "s1", "k")
        live = om.lookup_key("v", "b", "k")
        return (snap.get("attrs", {}), live["attrs"], snap["acls"],
                live["acls"])

    snap_attrs, live_attrs, snap_acls, live_acls = om_both(tmp_path, script)
    assert "owner" not in snap_attrs and live_attrs["owner"] == "root"
    assert len(live_acls) == len(snap_acls) + 1


def _materialize(P, om, name, created):
    """A materialized snapshot as pre-copy-on-write code built them."""
    import uuid

    sid = uuid.uuid4().hex[:12]
    store, base = om.store, "/v/b/"
    for k, v in list(store.iterate("keys", base)):
        store.put("keys", f"{P.rq.snap_prefix('v', 'b', sid)}/"
                          f"{k[len(base):]}", v, journal=False)
    store.put("open_keys", P.rq.snapmeta_key("v", "b", name), {
        "volume": "v", "bucket": "b", "name": name, "snap_id": sid,
        "created": created, "previous": None,
    })


def test_mixed_materialized_and_cow_chain(tmp_path):
    def script(P, om):
        _commit(om, "k", size=1)
        _materialize(P, om, "mat", time.time() - 10)
        _commit(om, "k", size=2)
        info2 = om.create_snapshot("v", "b", "cow")
        _commit(om, "k", size=3)
        _commit(om, "post-mat")
        sm = P.SM(om)
        out = [info2["cow"], sm.lookup_key("v", "b", "mat", "k")["size"],
               _names(sm.list_keys("v", "b", "mat")),
               code(lambda: sm.lookup_key("v", "b", "mat", "post-mat")),
               sm.lookup_key("v", "b", "cow", "k")["size"]]
        om.delete_snapshot("v", "b", "cow")
        return out + [_names(sm.list_keys("v", "b", "mat")),
                      sm.lookup_key("v", "b", "mat", "k")["size"]]

    assert om_both(tmp_path, script) == [True, 1, ["k"], "KEY_NOT_FOUND", 2,
                                         ["k"], 1]


def test_overlay_diff_vs_live_and_between_snapshots(tmp_path):
    def script(P, om):
        for i in range(5):
            _commit(om, f"k{i}", size=1)
        om.create_snapshot("v", "b", "s1")
        om.delete_key("v", "b", "k0")
        _commit(om, "k1", size=9)
        _commit(om, "new1")
        om.create_snapshot("v", "b", "s2")
        _commit(om, "after-s2")
        sm = P.SM(om)
        om.store._updates.clear()  # the overlay path specifically
        om.store.snapshot_markers.clear()
        return (sm.snapshot_diff("v", "b", "s1", "s2"),
                sm.snapshot_diff("v", "b", "s1"))

    d, d_live = om_both(tmp_path, script)
    assert d["mode"] == "overlay" and d["deleted"] == ["k0"]
    assert d["modified"] == ["k1"] and d["added"] == ["new1"]
    assert d_live["mode"] == "overlay"
    assert set(d_live["added"]) == {"new1", "after-s2"}


def test_fso_create_is_o_snapshots(tmp_path):
    def script(P, om):
        for i in range(30):
            _commit(om, f"d{i % 3}/x{i}", bucket="f")
        info = om.create_snapshot("v", "f", "s1")
        sm = P.SM(om)
        return (info["cow"], info["fso"],
                _overlay_rows(P, om, info["snap_id"], "f"),
                len(sm.list_keys("v", "f", "s1")),
                sm.lookup_key("v", "f", "s1", "d1/x1")["size"])

    assert om_both(tmp_path, script) == (True, True, {}, 30, 10)


def test_fso_snapshot_survives_directory_rename(tmp_path):
    def script(P, om):
        _commit(om, "proj/deep/a", size=5, bucket="f")
        _commit(om, "proj/deep/b", size=6, bucket="f")
        om.rename_key("v", "f", "proj", "renamed")
        om.create_snapshot("v", "f", "s1")
        om.rename_key("v", "f", "renamed", "moved-again")
        sm = P.SM(om)
        return (_names(sm.list_keys("v", "f", "s1")),
                sm.lookup_key("v", "f", "s1", "renamed/deep/a")["size"],
                code(lambda: sm.lookup_key("v", "f", "s1",
                                           "moved-again/deep/a")),
                _names(om.list_keys("v", "f")),
                sorted(sm.snapshot_diff("v", "f", "s1")["renamed"]))

    names, size, err, live, renamed = om_both(tmp_path, script)
    assert names == ["renamed/deep/a", "renamed/deep/b"] and size == 5
    assert err == "KEY_NOT_FOUND"
    assert live == ["moved-again/deep/a", "moved-again/deep/b"]
    assert renamed == [["renamed/deep/a", "moved-again/deep/a"],
                       ["renamed/deep/b", "moved-again/deep/b"]]


def test_fso_delete_and_new_files_after_snapshot(tmp_path):
    def script(P, om):
        _commit(om, "dir/old", size=3, bucket="f")
        om.create_snapshot("v", "f", "s1")
        om.delete_key("v", "f", "dir/old")
        _commit(om, "dir/new", size=4, bucket="f")
        sm = P.SM(om)
        return (_names(sm.list_keys("v", "f", "s1")),
                sm.lookup_key("v", "f", "s1", "dir/old")["size"],
                code(lambda: sm.lookup_key("v", "f", "s1", "dir/new")),
                sm.snapshot_diff("v", "f", "s1"))

    names, size, err, d = om_both(tmp_path, script)
    assert names == ["dir/old"] and size == 3 and err == "KEY_NOT_FOUND"
    assert d["deleted"] == ["dir/old"] and d["added"] == ["dir/new"]


def test_fso_chained_snapshots_and_delete_merge(tmp_path):
    def script(P, om):
        _commit(om, "a/k", size=1, bucket="f")
        om.create_snapshot("v", "f", "s1")
        om.create_snapshot("v", "f", "s2")
        _commit(om, "a/k", size=2, bucket="f")
        om.delete_snapshot("v", "f", "s2")
        size = P.SM(om).lookup_key("v", "f", "s1", "a/k")["size"]
        om.delete_snapshot("v", "f", "s1")
        return size, [k for k, _ in om.store.iterate("keys", "/.snapshot/")]

    assert om_both(tmp_path, script) == (1, [])


# ------------------------------------ tests/test_upgrade_snapshots.py
def _cluster(P, root, **over):
    kw = dict(num_datanodes=5, block_size=8 * 4096,
              container_size=4 * 1024 * 1024, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    kw.update(over)
    if P is PORT:
        return MiniOzoneCluster(root, device="cpu", **kw)
    return JCluster(root, **kw)


def cl_both(tmp_path, monkeypatch, script, **over):
    """`script(P, cluster)` on each package's MiniOzoneCluster; equal
    answers, the port's returned."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    out = {}
    for P in (REF, PORT):
        c = _cluster(P, tmp_path / P.name, **over)
        try:
            out[P.name] = strip(script(P, c))
        finally:
            c.close()
    assert out["port"] == out["ref"]
    return out["port"]


def test_snapshot_create_read_diff(tmp_path, monkeypatch):
    d1, d2 = _bytes(9000, 0), _bytes(5000, 1)

    def script(P, c):
        b = c.client().create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k1", d1)
        b.write_key("k2", d2)
        sm = P.SM(c.om)
        s1 = sm.create_snapshot("v", "b", "snap1")
        listed = [s.name for s in sm.list_snapshots("v", "b")]
        b.delete_key("k1")
        b.write_key("k3", _bytes(100, 2))
        b.write_key("k2", _bytes(7777, 3))
        snap_keys = _names(sm.list_keys("v", "b", "snap1"))
        info = sm.lookup_key("v", "b", "snap1", "k1")
        # the snapshot's block groups still read back
        same = np.array_equal(b.read_key_info(info), d1)
        diff = sm.snapshot_diff("v", "b", "snap1")
        s2 = sm.create_snapshot("v", "b", "snap2")
        diff2 = sm.snapshot_diff("v", "b", "snap1", "snap2")
        sm.delete_snapshot("v", "b", "snap1")
        return (listed, snap_keys, info["size"], same, diff,
                s2.previous == s1.snap_id, diff2,
                code(lambda: sm.get_snapshot("v", "b", "snap1")),
                _names(b.list_keys()))

    (listed, snap_keys, size, same, diff, chained, diff2, err,
     live) = cl_both(tmp_path, monkeypatch, script)
    assert listed == ["snap1"] and snap_keys == ["k1", "k2"]
    assert size == 9000 and same and chained
    assert (diff["added"], diff["deleted"], diff["modified"]) == \
        (["k3"], ["k1"], ["k2"])
    assert diff2["added"] == ["k3"] and diff2["deleted"] == ["k1"]
    assert err == "SNAPSHOT_NOT_FOUND" and live == ["k2", "k3"]


def test_snapshot_surface_over_grpc_and_dot_snapshot_reads(tmp_path,
                                                            monkeypatch):
    """The snapshot verbs over each package's RPC, and .snapshot/ reads:
    whole, positioned, and through the filesystem adapter."""
    import ozone_tpu.net.daemons as j_daemons
    import ozone_tpu_torch.net.daemons as t_daemons
    from ozone_tpu.client.dn_client import DatanodeClientFactory as JFactory
    from ozone_tpu.client.ozone_client import OzoneClient as JOzoneClient
    from ozone_tpu.gateway.fs import OzoneFileSystem as JFs
    from ozone_tpu.net.om_service import GrpcOmClient
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.gateway.fs import OzoneFileSystem
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    v1, v2 = _bytes(9_000, 0), _bytes(4_000, 1)
    out = {}
    for P in (REF, PORT):
        mod = t_daemons if P is PORT else j_daemons
        root = tmp_path / P.name
        meta = mod.ScmOmDaemon(root / "om.db", block_size=4 * 4096,
                               stale_after_s=1000.0, dead_after_s=2000.0,
                               background_interval_s=0.5, **P.kw)
        meta.start()
        dns = [mod.DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                                  heartbeat_interval_s=0.2, **P.kw)
               for i in range(5)]
        for d in dns:
            d.start()
        try:
            if P is PORT:
                clients = DatanodeClientFactory()
                oz = OzoneClient(RemoteOmClient(meta.address,
                                                clients=clients),
                                 clients, device="cpu")
                fs_cls = OzoneFileSystem
            else:
                clients = JFactory()
                oz = JOzoneClient(GrpcOmClient(meta.address,
                                               clients=clients), clients)
                fs_cls = JFs
            b = oz.create_volume("v").create_bucket("b", replication=EC)
            b.write_key("k", v1)
            snap = oz.om.create_snapshot("v", "b", "s1")
            b.write_key("k", v2)
            b.write_key("new", v2)
            got = (np.array_equal(b.read_key("k"), v2),
                   np.array_equal(b.read_key(".snapshot/s1/k"), v1),
                   np.array_equal(b.read_key_range(".snapshot/s1/k", 100, 57),
                                  v1[100:157]),
                   fs_cls(b).read_range(".snapshot/s1/k", 8_000, None)
                   == v1[8_000:].tobytes())
            names = [s["name"] for s in oz.om.list_snapshots("v", "b")]
            diff = oz.om.snapshot_diff("v", "b", "s1")
            keys = _names(oz.om.snapshot_keys("v", "b", "s1"))
            oz.om.delete_snapshot("v", "b", "s1")
            out[P.name] = strip((snap["name"], got, names, diff, keys,
                                 oz.om.list_snapshots("v", "b")))
            oz.om.close()
        finally:
            for d in dns:
                d.stop()
            meta.stop()
    assert out["port"] == out["ref"]
    name, got, names, diff, keys, after = out["port"]
    assert name == "s1" and all(got) and names == ["s1"]
    assert "new" in diff["added"] and "k" in diff["modified"]
    assert keys == ["k"] and after == []


def test_snapshots_replicate_across_ha_ring(tmp_path):
    """CreateSnapshot rides the replicated log: every replica of the
    port's metadata ring holds the snapshot, as the reference's do."""
    from ozone_tpu.net.om_service import GrpcOmClient
    from ozone_tpu.testing import minicluster as j_mc
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.testing import minicluster as t_mc

    out = {}
    for P in (REF, PORT):
        mc = t_mc if P is PORT else j_mc
        ports = mc.free_ports(3)
        peers = {f"m{i}": f"127.0.0.1:{ports[i]}" for i in range(3)}
        metas = {}
        try:
            for i in range(3):
                d = mc.make_meta_daemon(tmp_path / P.name, i, peers, **P.kw)
                d.start()
                metas[f"m{i}"] = d
            mc.await_meta_leader(metas)
            cls = RemoteOmClient if P is PORT else GrpcOmClient
            om = cls(",".join(peers.values()))
            om.create_volume("v")
            om.create_bucket("v", "b", EC)
            om.create_snapshot("v", "b", "snapA")
            deadline = time.time() + 10
            while time.time() < deadline:
                try:
                    if all([s["name"] for s in d.om.list_snapshots("v", "b")]
                           == ["snapA"] for d in metas.values()):
                        break
                except (j_rq.OMError, t_rq.OMError):
                    pass  # a follower has not applied the bucket yet
                time.sleep(0.1)
            out[P.name] = {mid: [s["name"] for s in
                                 d.om.list_snapshots("v", "b")]
                           for mid, d in metas.items()}
            om.close()
        finally:
            for d in metas.values():
                d.stop()
    assert out["port"] == out["ref"] == {m: ["snapA"]
                                         for m in ("m0", "m1", "m2")}


def test_fso_bucket_snapshot_covers_files(tmp_path, monkeypatch):
    v1 = _bytes(6_000, 3)

    def script(P, c):
        oz = c.client()
        oz.create_volume("v")
        oz.om.create_bucket("v", "fso", EC, FSO)
        b = oz.get_volume("v").get_bucket("fso")
        b.write_key("dir/a", v1)
        oz.om.create_snapshot("v", "fso", "s1")
        b.delete_key("dir/a")
        return (_names(oz.om.snapshot_keys("v", "fso", "s1")),
                np.array_equal(b.read_key(".snapshot/s1/dir/a"), v1),
                oz.om.snapshot_diff("v", "fso", "s1")["deleted"])

    assert cl_both(tmp_path, monkeypatch, script) == (["dir/a"], True,
                                                      ["dir/a"])


def test_snapshot_path_without_key_component_errors_cleanly(tmp_path,
                                                            monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k", np.zeros(10, np.uint8))
        oz.om.create_snapshot("v", "b", "s1")
        return (code(lambda: b.read_key(".snapshot/s1")),
                code(lambda: b.read_key_range(".snapshot/s1/", 0, 1)))

    assert cl_both(tmp_path, monkeypatch, script) == ("KEY_NOT_FOUND",
                                                      "KEY_NOT_FOUND")


def test_snapshot_name_validation(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication=EC)
        return [code(lambda: oz.om.create_snapshot("v", "b", bad))
                for bad in ("", "a/b")]

    assert cl_both(tmp_path, monkeypatch, script) == \
        ["INVALID_SNAPSHOT_NAME"] * 2


def test_incremental_diff_100k_keys_10_changes(tmp_path, monkeypatch):
    """A 100k-key bucket with 10 changes diffs in O(changes) off the
    journal; with the journal gone, the overlay union gives the same
    answer, also in O(changes)."""

    def script(P, c):
        c.client().create_volume("vbig").create_bucket("big", replication=EC)
        store = c.om.store
        for i in range(100_000):
            store.put("keys", f"/vbig/big/k{i:06d}",
                      {"name": f"k{i:06d}", "size": 1, "modified": 0.0,
                       "block_groups": []})
        sm = P.SM(c.om)
        sm.create_snapshot("vbig", "big", "s1")

        def put(k, v):
            P.rq.preserve_preimage(store, "vbig", "big", k)
            store.put("keys", k, v)

        def delete(k):
            P.rq.preserve_preimage(store, "vbig", "big", k)
            store.delete("keys", k)

        for i in range(4):
            put(f"/vbig/big/new{i}", {"name": f"new{i}", "size": 2,
                                      "modified": 1.0, "block_groups": []})
        for i in range(3):
            delete(f"/vbig/big/k{i:06d}")
        for i in range(3, 6):
            put(f"/vbig/big/k{i:06d}", {"name": f"k{i:06d}", "size": 9,
                                        "modified": 2.0, "block_groups": []})
        t0 = time.time()
        diff = sm.snapshot_diff("vbig", "big", "s1")
        dt_inc = time.time() - t0
        sm.create_snapshot("vbig", "big", "s2")
        diff2 = sm.snapshot_diff("vbig", "big", "s1", "s2")
        store._updates.clear()
        store.snapshot_markers.clear()
        t0 = time.time()
        full = sm.snapshot_diff("vbig", "big", "s1", "s2")
        dt_full = time.time() - t0
        assert dt_inc < 1.0 and dt_full < 1.0, (P.name, dt_inc, dt_full)
        return diff, diff2, full

    diff, diff2, full = cl_both(tmp_path, monkeypatch, script)
    assert diff["mode"] == "incremental" and diff["keys_examined"] == 10
    assert diff["added"] == [f"new{i}" for i in range(4)]
    assert diff["deleted"] == [f"k{i:06d}" for i in range(3)]
    assert diff["modified"] == [f"k{i:06d}" for i in range(3, 6)]
    assert diff2["mode"] == "incremental"
    assert full["mode"] == "overlay" and full["keys_examined"] == 10
    for d in (diff2, full):
        assert (d["added"], d["deleted"], d["modified"]) == \
            (diff["added"], diff["deleted"], diff["modified"])


def test_snapdiff_rename_entries_obs_incremental(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("vr").create_bucket("rb", replication=EC)
        rng = np.random.default_rng(5)
        b.write_key("keep", rng.integers(0, 256, 100, dtype=np.uint8))
        b.write_key("old-name", rng.integers(0, 256, 200, dtype=np.uint8))
        sm = P.SM(c.om)
        sm.create_snapshot("vr", "rb", "r1")
        c.om.rename_key("vr", "rb", "old-name", "new-name")
        d1 = sm.snapshot_diff("vr", "rb", "r1")
        b.delete_key("keep")
        b.write_key("keep", rng.integers(0, 256, 50, dtype=np.uint8))
        return d1, sm.snapshot_diff("vr", "rb", "r1")

    d1, d2 = cl_both(tmp_path, monkeypatch, script)
    assert d1["mode"] == "incremental"
    assert d1["renamed"] == [["old-name", "new-name"]]
    assert d1["added"] == [] and d1["deleted"] == []
    assert d2["renamed"] == [["old-name", "new-name"]]
    assert d2["modified"] == ["keep"]


def test_snapdiff_fso_directory_rename(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        oz.create_volume("vr2")
        c.om.create_bucket("vr2", "fb", EC, layout=FSO)
        b = oz.get_volume("vr2").get_bucket("fb")
        rng = np.random.default_rng(6)
        for name in ("dir/a", "dir/b", "top"):
            b.write_key(name, rng.integers(0, 256, 64, dtype=np.uint8))
        sm = P.SM(c.om)
        sm.create_snapshot("vr2", "fb", "f1")
        c.om.rename_key("vr2", "fb", "dir", "moved")
        b.write_key("moved/c", rng.integers(0, 256, 64, dtype=np.uint8))
        sm.create_snapshot("vr2", "fb", "f2")
        return (_names(sm.list_keys("vr2", "fb", "f2")),
                sm.snapshot_diff("vr2", "fb", "f1", "f2"))

    names, d = cl_both(tmp_path, monkeypatch, script)
    assert names == ["moved/a", "moved/b", "moved/c", "top"]
    assert d["renamed"] == [["dir/a", "moved/a"], ["dir/b", "moved/b"]]
    assert d["added"] == ["moved/c"]
    assert d["deleted"] == [] and d["modified"] == []
    assert d["mode"] == "full"


def _wait_job(job_fn):
    job = job_fn()
    deadline = time.time() + 30
    while job["status"] == "IN_PROGRESS" and time.time() < deadline:
        time.sleep(0.02)
        job = job_fn()
    assert job["status"] == "DONE", job
    return job


def test_snapshot_diff_paged_jobs(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("vdj").create_bucket("b", replication=EC)
        for i in range(7):
            b.write_key(f"k{i}", _bytes(2000, i))
        om = c.om
        om.create_snapshot("vdj", "b", "s1")
        b.delete_key("k0")
        b.rename_key("k1", "k1-moved")
        b.write_key("k2", _bytes(2500, 99))
        b.write_key("k7", _bytes(2000, 7))
        om.create_snapshot("vdj", "b", "s2")
        job = _wait_job(lambda: om.snapshot_diff_submit("vdj", "b", "s1",
                                                        "s2"))
        reused = om.snapshot_diff_submit("vdj", "b", "s1",
                                         "s2")["job_id"] == job["job_id"]
        seen, token, sizes = [], "", []
        while True:
            page = om.snapshot_diff_page(job["job_id"], token, 2)
            sizes.append(len(page["entries"]))
            seen.extend(page["entries"])
            token = page["next_token"]
            if not token:
                break
        errs = (code(lambda: om.snapshot_diff_page("nope")),
                code(lambda: om.snapshot_diff_page(job["job_id"],
                                                   token="xyz")),
                code(lambda: om.snapshot_diff_submit("vdj", "b", "no-snap")))
        return reused, seen, sizes, page["total"], errs

    reused, seen, sizes, total, errs = cl_both(tmp_path, monkeypatch, script)
    assert reused and max(sizes) <= 2 and len(seen) == total == 4
    ops = {e["op"]: e for e in seen}
    assert ops["DELETE"]["key"] == "k0" and ops["MODIFY"]["key"] == "k2"
    assert ops["RENAME"] == {"op": "RENAME", "key": "k1",
                             "target": "k1-moved"}
    assert ops["ADD"]["key"] == "k7"
    assert errs == ("INVALID_REQUEST", "INVALID_REQUEST",
                    "SNAPSHOT_NOT_FOUND")


def test_snapshot_diff_job_staleness_and_retry(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("vdj2").create_bucket("b", replication=EC)
        rng = np.random.default_rng(1)
        b.write_key("a", rng.integers(0, 256, 1000, dtype=np.uint8))
        om = c.om
        om.create_snapshot("vdj2", "b", "s1")
        b.write_key("b1", rng.integers(0, 256, 1000, dtype=np.uint8))
        om.create_snapshot("vdj2", "b", "s2")
        j1 = _wait_job(lambda: om.snapshot_diff_submit("vdj2", "b", "s1",
                                                       "s2"))
        om.delete_snapshot("vdj2", "b", "s2")
        b.write_key("b2", rng.integers(0, 256, 1000, dtype=np.uint8))
        om.create_snapshot("vdj2", "b", "s2")
        j2 = _wait_job(lambda: om.snapshot_diff_submit("vdj2", "b", "s1",
                                                       "s2"))
        om.delete_snapshot("vdj2", "b", "s1")
        j3 = om.snapshot_diff_submit("vdj2", "b", "s1", "s2")
        paged = om.snapshot_diff_page(j2["job_id"], "", 10)["total"]
        om.create_snapshot("vdj2", "b", "s3")
        l1 = _wait_job(lambda: om.snapshot_diff_submit("vdj2", "b", "s3"))
        b.write_key("c", rng.integers(0, 256, 1000, dtype=np.uint8))
        l2 = _wait_job(lambda: om.snapshot_diff_submit("vdj2", "b", "s3"))
        return (j1["total"], j2["job_id"] != j1["job_id"], j2["total"],
                j3["job_id"] == j2["job_id"], paged,
                l2["job_id"] != l1["job_id"], l2["total"] - l1["total"])

    assert cl_both(tmp_path, monkeypatch, script) == (1, True, 2, True, 2,
                                                      True, 1)


# ----------------------------------------------------- across packages
def test_differential_request_sequence(tmp_path):
    """A seeded sequence of puts, overwrites, deletes, renames, FSO
    directory renames, multipart completes, ACL and attribute changes and
    snapshot creates, renames and deletes goes through the reference's
    OM; each request it pre-executed is applied, as the same JSON, to the
    port's store. Every snapshot's listing, lookups and diffs, and the
    rows under /.snapshot/ and /.snapmeta/, are then exactly equal."""
    ref, port = _om(REF, tmp_path / "ref"), _om(PORT, tmp_path / "port")
    orig = ref.submit

    def mirrored(req):
        try:
            out, err = orig(req), None
        except j_rq.OMError as e:
            out, err = None, e
        d = req.to_json()
        # the fields the reference carries and never reads (CommitKey's
        # checksum_type, say) are not on the port's request
        names = {f.name for f in dataclasses.fields(
            t_rq._REQUEST_TYPES[d["type"]])}
        preq = t_rq.OMRequest.from_json(
            {k: v for k, v in d.items() if k == "type" or k in names})
        try:
            with port._lock, port.store.atomic():
                preq.apply(port.store)
            perr = None
        except t_rq.OMError as e:
            perr = e.code
        assert perr == (err.code if err else None), type(req).__name__
        if err is not None:
            raise err
        return out

    ref.submit = mirrored
    rng = np.random.default_rng(1234)
    obs, fso_files, snaps, counter = [], [], {"b": [], "f": []}, [0]

    def fresh(prefix):
        counter[0] += 1
        return f"{prefix}{counter[0]}"

    def put(bucket, key):
        s = ref.open_key("v", bucket, key)
        ref.commit_key(s, [], int(rng.integers(1, 10_000)))

    ops = ["put", "overwrite", "delete", "rename", "fso_put", "fso_dir",
           "fso_delete", "mpu", "acl", "attrs", "snap", "snap_rename",
           "snap_delete"]
    weights = np.array([4, 3, 2, 2, 4, 1, 1, 1, 1, 1, 2, 1, 1], float)
    seen = set()
    for _ in range(160):
        op = ops[int(rng.choice(len(ops), p=weights / weights.sum()))]
        seen.add(op)
        if op == "put" or (op in ("overwrite", "delete", "rename", "acl",
                                  "attrs", "mpu") and not obs):
            k = fresh("k")
            put("b", k)
            obs.append(k)
        elif op == "overwrite":
            put("b", obs[int(rng.integers(len(obs)))])
        elif op == "delete":
            ref.delete_key("v", "b", obs.pop(int(rng.integers(len(obs)))))
        elif op == "rename":
            i = int(rng.integers(len(obs)))
            new = fresh("r")
            ref.rename_key("v", "b", obs[i], new)
            obs[i] = new
        elif op == "fso_put" or (op in ("fso_dir", "fso_delete")
                                 and not fso_files):
            path = f"d{int(rng.integers(3))}/e{int(rng.integers(2))}/" \
                   f"{fresh('f')}"
            put("f", path)
            fso_files.append(path)
        elif op == "fso_dir":
            top = fso_files[int(rng.integers(len(fso_files)))].split("/")[0]
            new = fresh("D")
            ref.rename_key("v", "f", top, new)
            fso_files = [new + p[len(top):] if p.split("/")[0] == top else p
                         for p in fso_files]
        elif op == "fso_delete":
            ref.delete_key("v", "f", fso_files.pop(
                int(rng.integers(len(fso_files)))))
        elif op == "mpu":
            k = obs[int(rng.integers(len(obs)))]
            uid = ref.initiate_multipart_upload("v", "b", k)
            s = ref.open_multipart_part("v", "b", k, uid)
            ref.commit_multipart_part(s, 1, [], 4096, "etag-1")
            ref.complete_multipart_upload(
                "v", "b", k, uid, [{"part_number": 1, "etag": "etag-1"}])
        elif op == "acl":
            ref.modify_acl("key", "v", "b", obs[int(rng.integers(len(obs)))],
                           "add", [f"user:u{int(rng.integers(5))}:rw"])
        elif op == "attrs":
            ref.set_key_attrs("v", "b", obs[int(rng.integers(len(obs)))],
                              {"owner": f"o{int(rng.integers(5))}"})
        else:
            bucket = "b" if rng.random() < 0.6 else "f"
            names = snaps[bucket]
            if op == "snap" or not names:
                n = fresh("s")
                ref.create_snapshot("v", bucket, n)
                names.append(n)
            elif op == "snap_rename":
                i = int(rng.integers(len(names)))
                new = fresh("t")
                ref.rename_snapshot("v", bucket, names[i], new)
                names[i] = new
            else:
                ref.delete_snapshot("v", bucket,
                                    names.pop(int(rng.integers(len(names)))))
    try:
        assert seen == set(ops) and snaps["b"] and snaps["f"]
        for table, prefix in (("keys", "/.snapshot/"),
                              ("open_keys", "/.snapmeta/"),
                              ("files", "/.snapshot/"),
                              ("keys", "/v/"), ("files", "/v/"),
                              ("dirs", "/v/")):
            assert dict(ref.store.iterate(table, prefix)) == \
                dict(port.store.iterate(table, prefix)), (table, prefix)
        rsm, psm = JSM(ref), TSM(port)
        for bucket, names in snaps.items():
            assert strip(ref.list_snapshots("v", bucket)) == \
                strip(port.list_snapshots("v", bucket))
            for n in names:
                rows = rsm.list_keys("v", bucket, n)
                assert rows == psm.list_keys("v", bucket, n)
                for row in rows:
                    assert rsm.lookup_key("v", bucket, n, row["name"]) == \
                        psm.lookup_key("v", bucket, n, row["name"])
                assert rsm.snapshot_diff("v", bucket, n) == \
                    psm.snapshot_diff("v", bucket, n)
                for m in names:
                    if m != n:
                        assert rsm.snapshot_diff("v", bucket, n, m) == \
                            psm.snapshot_diff("v", bucket, n, m)
    finally:
        ref.close()
        port.close()


def test_port_reads_reference_written_snapshots(tmp_path):
    """A database the reference wrote, with a materialized snapshot and
    copy-on-write OBS and FSO snapshots over later mutations, opened by
    the port's OM: every listing, lookup and diff equals the reference
    OM's over a copy of the same database."""
    ref = _om(REF, tmp_path / "w")
    for i in range(6):
        _commit(ref, f"k{i}", size=i + 1)
        _commit(ref, f"d/e{i % 2}/f{i}", size=i + 1, bucket="f")
    _materialize(REF, ref, "mat", time.time() - 10)
    ref.create_snapshot("v", "b", "s1")
    ref.create_snapshot("v", "f", "fs1")
    _commit(ref, "k0", size=99)
    ref.delete_key("v", "b", "k1")
    ref.rename_key("v", "b", "k2", "k2b")
    _commit(ref, "k9")
    ref.rename_key("v", "f", "d", "d2")
    ref.delete_key("v", "f", "d2/e0/f0")
    ref.create_snapshot("v", "b", "s2")
    ref.close()
    for side in ("a", "b"):
        (tmp_path / side).mkdir()
        for f in (tmp_path / "w").iterdir():
            shutil.copy(f, tmp_path / side / f.name)
    a = JOM(tmp_path / "a" / "om.db", JSCM())
    b = TOM(tmp_path / "b" / "om.db", TSCM(), device="cpu")
    try:
        asm, bsm = JSM(a), TSM(b)
        for bucket, names in (("b", ["mat", "s1", "s2"]), ("f", ["fs1"])):
            for n in names:
                rows = asm.list_keys("v", bucket, n)
                assert rows and rows == bsm.list_keys("v", bucket, n)
                for row in rows:
                    assert asm.lookup_key("v", bucket, n, row["name"]) == \
                        bsm.lookup_key("v", bucket, n, row["name"])
                assert asm.snapshot_diff("v", bucket, n) == \
                    bsm.snapshot_diff("v", bucket, n)
        assert asm.snapshot_diff("v", "b", "s1", "s2") == \
            bsm.snapshot_diff("v", "b", "s1", "s2")
        assert bsm.lookup_key("v", "b", "mat", "k0")["size"] == 1
        assert bsm.lookup_key("v", "b", "s1", "k1")["size"] == 2
        assert sorted(r["name"] for r in bsm.list_keys("v", "f", "fs1")) == \
            [f"d/e{i % 2}/f{i}" for i in (0, 2, 4, 1, 3, 5)]
    finally:
        a.close()
        b.close()


def test_slice_snapshot_read_decodes_around_stopped_datanode(tmp_path,
                                                             monkeypatch):
    """Write, snapshot, delete, stop the datanode of a data unit: the
    .snapshot/ GET of the deleted key decodes through the plain kernel
    version on the port and returns the source bytes, as the reference's
    cluster does from the same seed and placement."""
    from ozone_tpu_torch.client import ec_reader as t_reader

    readers = []
    init = t_reader.ECBlockGroupReader.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        readers.append(self)

    monkeypatch.setattr(t_reader.ECBlockGroupReader, "__init__", spy)
    data = _bytes(50_000, 11)

    def script(P, c):
        b = c.client().create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k", data)
        c.om.create_snapshot("v", "b", "s1")
        b.delete_key("k")
        info = c.om.snapshot_lookup_key("v", "b", "s1", "k")
        victim = info["block_groups"][0]["nodes"][0]
        c.stop_datanode(victim)
        readers.clear()
        got = c.client().get_volume("v").get_bucket("b").read_key(
            ".snapshot/s1/k")
        return victim, np.array_equal(got, data)

    assert cl_both(tmp_path, monkeypatch, script)[1]
    # the readers of the last (the port's) run decoded
    assert readers and sum(r.dispatches for r in readers) > 0


def test_deferred_purge_keeps_snapshot_blocks(tmp_path, monkeypatch):
    """While a snapshot names a deleted key, the key-deleting service
    defers it and its chunks still serve a degraded .snapshot/ GET; once
    the last snapshot is gone the service purges it."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    data = _bytes(50_000, 11)
    c = _cluster(PORT, tmp_path)
    try:
        b = c.client().create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k", data)
        c.om.create_snapshot("v", "b", "s1")
        b.delete_key("k")
        assert c.om.run_key_deleting_service_once() == 0
        assert len(list(c.om.store.iterate("deleted_keys"))) == 1
        info = c.om.snapshot_lookup_key("v", "b", "s1", "k")
        c.stop_datanode(info["block_groups"][0]["nodes"][0])
        assert np.array_equal(b.read_key(".snapshot/s1/k"), data)
        c.om.delete_snapshot("v", "b", "s1")
        assert c.om.run_key_deleting_service_once() == 1
        assert list(c.om.store.iterate("deleted_keys")) == []
    finally:
        c.close()


def test_snapshot_lookup_points_units_at_their_homes(tmp_path, monkeypatch):
    """The port's departure, extended to snapshots: after the SCM rebuilt
    a dead node's unit elsewhere, a snapshot lookup of a deleted key
    names the unit's new home, as the port's live lookup does; the
    snapshot row keeps the write's placement. The .snapshot/ read is
    byte-exact, and the key's blocks outlive the key-deleting service
    while the snapshot exists."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    c = MiniOzoneCluster(tmp_path, num_datanodes=7, block_size=4 * 4096,
                         stale_after_s=1e6, dead_after_s=2e6,
                         placement_seed=42, device="cpu")
    try:
        b = c.client().create_volume("v").create_bucket("b", replication=EC)
        data = _bytes(30_000, 3)
        b.write_key("k", data)
        c.om.create_snapshot("v", "b", "s1")
        b.delete_key("k")
        g = c.om.snapshot_lookup_key("v", "b", "s1", "k")["block_groups"][0]
        for dn in c.datanodes:
            if dn.id in g["nodes"]:
                dn.close_container(int(g["container_id"]))
        c.tick()
        victim = g["nodes"][1]
        c.stop_datanode(victim)
        c.scm.nodes.get(victim).last_heartbeat = -1e9
        c.scm.nodes.check_liveness()
        c.tick(3)
        moved0 = c.om.metrics.counter("units_relocated").value
        nodes = c.om.snapshot_lookup_key(
            "v", "b", "s1", "k")["block_groups"][0]["nodes"]
        cont = c.scm.containers.get(int(g["container_id"]))
        home = next(dn for dn, r in cont.replicas.items()
                    if r.replica_index == 2)
        assert nodes[1] == home != victim
        assert [n for i, n in enumerate(nodes) if i != 1] == \
            [n for i, n in enumerate(g["nodes"]) if i != 1]
        assert c.om.metrics.counter("units_relocated").value == moved0 + 1
        assert g["nodes"][1] == victim  # the stored snapshot row
        assert np.array_equal(b.read_key(".snapshot/s1/k"), data)
    finally:
        c.close()


def test_gdpr_key_under_snapshot(tmp_path, monkeypatch):
    """An overwrite or delete of a GDPR key erases its secret right after
    the pre-image is kept: the snapshot's copy keeps the secret, so the
    .snapshot/ read returns the old bytes in both packages, while the
    purge chain's rows are erased."""
    pytest.importorskip("cryptography")
    a, b_ = _bytes(12_000, 20), _bytes(9_000, 21)

    def script(P, c):
        oz = c.client()
        oz.create_volume("gv")
        c.om.create_bucket("gv", "g", EC, gdpr=True)
        b = oz.get_volume("gv").get_bucket("g")
        b.write_key("over", a)
        b.write_key("gone", b_)
        c.om.create_snapshot("gv", "g", "s1")
        b.write_key("over", _bytes(5_000, 22))
        b.delete_key("gone")
        rows = [v for _, v in c.om.store.iterate("keys", "/.snapshot/")]
        erased = [v["encryption"] for _, v in
                  c.om.store.iterate("deleted_keys")]
        return (np.array_equal(b.read_key(".snapshot/s1/over"), a),
                np.array_equal(b.read_key(".snapshot/s1/gone"), b_),
                sorted("gdpr_secret" in r["encryption"] for r in rows),
                erased)

    over, gone, kept, erased = cl_both(tmp_path, monkeypatch, script)
    assert over and gone and kept == [True, True]
    assert erased == [{"erased": True}] * 2


_SITE = re.compile(r"\b(preserve_preimage|preserve_fso_preimage)\(")


@pytest.mark.parametrize("rel", ["om/requests.py", "om/fso.py",
                                 "om/multipart.py", "om/sharding/txn.py"])
def test_preimage_sites_match_reference(rel):
    """Every pre-image call site of the reference has its counterpart in
    the port: the same calls, in the same request classes, in order."""
    def sites(pkg):
        src = (Path(__file__).resolve().parents[1] / pkg / rel).read_text()
        out, cls = [], None
        for line in src.splitlines():
            m = re.match(r"(?:class|def) (\w+)", line)
            if m:
                cls = m.group(1)
            if not line.lstrip().startswith("def "):
                out += [(cls, f) for f in _SITE.findall(line)]
        return sorted(out)

    ref, port = sites("ozone_tpu"), sites("ozone_tpu_torch")
    assert ref and port == ref


def test_snapshot_cli_verbs(tmp_path):
    """`sh snapshot create|list|info|rename|diff|delete` and a
    .snapshot/ `sh key get` as CLI processes against the port's daemons;
    the paged diff streams the same entries as the synchronous one."""
    import json
    import os
    import subprocess
    import sys

    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), JAX_PLATFORMS="cpu",
               OZONE_TPU_CODEC_SERVICE="0")

    def cli(*args):
        p = subprocess.run([sys.executable, "-m", "ozone_tpu_torch.tools",
                            *args, "--om", meta.address], capture_output=True,
                           text=True, env=env, timeout=120)
        assert p.returncode == 0, p.stderr
        return p.stdout

    meta = ScmOmDaemon(tmp_path / "om.db", block_size=4 * 4096,
                       stale_after_s=1000.0, dead_after_s=2000.0,
                       background_interval_s=0.5, device="cpu")
    meta.start()
    dns = [DatanodeDaemon(tmp_path / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.2, device="cpu")
           for i in range(5)]
    for d in dns:
        d.start()
    try:
        src, out = tmp_path / "in.bin", tmp_path / "out.bin"
        v1 = _bytes(9_000, 1).tobytes()
        src.write_bytes(v1)
        cli("sh", "volume", "create", "/v")
        cli("sh", "bucket", "create", "/v/b", "--replication", EC)
        cli("sh", "key", "put", "/v/b/k", str(src), "--device", "cpu")
        cli("sh", "key", "put", "/v/b/gone", str(src), "--device", "cpu")
        assert json.loads(cli("sh", "snapshot", "create", "/v/b",
                              "--name", "s1"))["cow"] is True
        src.write_bytes(_bytes(4_000, 2).tobytes())
        cli("sh", "key", "put", "/v/b/k", str(src), "--device", "cpu")
        cli("sh", "key", "delete", "/v/b/gone")
        cli("sh", "key", "get", "/v/b/.snapshot/s1/gone", str(out),
            "--device", "cpu")
        assert out.read_bytes() == v1
        cli("sh", "snapshot", "rename", "/v/b", "--name", "s1", "--to", "s9")
        assert [s["name"] for s in json.loads(
            cli("sh", "snapshot", "list", "/v/b"))] == ["s9"]
        assert json.loads(cli("sh", "snapshot", "info", "/v/b", "--name",
                              "s9"))["name"] == "s9"
        diff = json.loads(cli("sh", "snapshot", "diff", "/v/b", "--name",
                              "s9"))
        assert (diff["deleted"], diff["modified"]) == (["gone"], ["k"])
        paged = [json.loads(x) for x in cli(
            "sh", "snapshot", "diff", "/v/b", "--name", "s9",
            "--page-size", "1").splitlines()]
        assert paged == [{"op": "DELETE", "key": "gone"},
                         {"op": "MODIFY", "key": "k"}]
        cli("sh", "snapshot", "delete", "/v/b", "--name", "s9")
        assert json.loads(cli("sh", "snapshot", "list", "/v/b")) == []
    finally:
        for d in dns:
            d.stop()
        meta.stop()
