"""The operator's repair tools in the port's CLI: `fsck`, `repair` and
`debug`, held against the reference's.

Mirrors `tests/test_insight_repair.py`'s orphan detection, offline db
surgery and offline container verbs, and `tests/test_tools.py`'s fsck,
container export/import and its guards, on a daemon cluster of the port
(5 datanodes, rs-3-2-4096, the plain PyTorch coder). Then the same
faults on both packages' clusters give the same fsck summaries and
orphan reports; `debug ldb`, `container-list` and `container-inspect`
print the same rows on equal stores; and each package reads what the
other wrote: an OM db after `repair transaction --apply`, a container
tarball, a `dbgen` store.
"""

import contextlib
import io
import json
import shutil
import time

import numpy as np
import pytest

from ozone_tpu_torch.storage.ids import BlockData, BlockID, ChunkInfo, StorageError
from ozone_tpu_torch.tools import cli

EC = "rs-3-2-4096"


def _run(main, *argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _port_cluster(root, n=5):
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    meta = ScmOmDaemon(root / "om.db", stale_after_s=1000.0,
                       dead_after_s=2000.0, background_interval_s=0.5)
    meta.start()
    dns = [DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.2, device="cpu")
           for i in range(n)]
    for d in dns:
        d.start()
    clients = DatanodeClientFactory()
    for d in dns:
        clients.register_remote(d.dn.id, d.address)
    oz = OzoneClient(RemoteOmClient(meta.address, clients=clients), clients,
                     device="cpu")
    return meta, dns, oz


def _ref_cluster(root, n=5):
    from ozone_tpu.client.dn_client import DatanodeClientFactory
    from ozone_tpu.client.ozone_client import OzoneClient
    from ozone_tpu.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu.net.om_service import GrpcOmClient

    meta = ScmOmDaemon(root / "om.db", stale_after_s=1000.0,
                       dead_after_s=2000.0, background_interval_s=0.5)
    meta.start()
    dns = [DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.2) for i in range(n)]
    for d in dns:
        d.start()
    clients = DatanodeClientFactory()
    for d in dns:
        clients.register_remote(d.dn.id, d.address)
    oz = OzoneClient(GrpcOmClient(meta.address, clients=clients), clients)
    return meta, dns, oz


def _await_replica(scm, cid: int, dn_id: str) -> None:
    """Until the SCM lists dn_id's replica of cid (a report has landed):
    `repair orphans` walks the replicas the SCM knows."""
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        for c in scm.list_containers():
            if c["id"] == cid and dn_id in {r["dn_id"] for r in c["replicas"]}:
                return
        time.sleep(0.05)
    raise AssertionError(f"no report of {dn_id}'s replica of {cid}")


def _stop(meta, dns, oz):
    oz.om.close()
    oz.clients.close()
    for d in dns:
        d.stop()
    meta.stop()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    meta, dns, oz = _port_cluster(tmp_path_factory.mktemp("repair"))
    yield meta, dns, oz
    _stop(meta, dns, oz)


def test_orphan_block_detection_and_reclaim(cluster):
    """`repair orphans`: a block no key references is reported; --delete
    leaves it while its container is OPEN and reclaims it once CLOSED."""
    meta, dns, oz = cluster
    b = oz.create_volume("repvol").create_bucket("rb", replication=EC)
    b.write_key("legit", np.arange(9000, dtype=np.uint8) % 251)
    g = oz.om.lookup_key("repvol", "rb", "legit")["block_groups"][0]
    cid, dn_id = int(g["container_id"]), g["nodes"][0]
    oz.clients.get(dn_id).put_block(BlockData(BlockID(cid, 999_999), chunks=[]))
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    scm = RemoteScmClient(meta.address)
    _await_replica(scm, cid, dn_id)
    rc, out, _ = _run(cli.main, "repair", "orphans", "--om", meta.address)
    rep = json.loads(out)
    assert rc == 0 and [(o["container_id"], o["local_id"], o["datanode"])
                        for o in rep["orphans"]] == [(cid, 999_999, dn_id)]
    rc, out, _ = _run(cli.main, "repair", "orphans", "--delete", "--om",
                      meta.address)
    assert [o["action"] for o in json.loads(out)["orphans"]] == \
        ["skipped-open-container"]
    scm.admin("close-container", str(cid))
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and next(
            c for c in scm.list_containers() if c["id"] == cid)["state"] != "CLOSED":
        time.sleep(0.1)
    scm.close()
    rc, out, _ = _run(cli.main, "repair", "orphans", "--delete", "--om",
                      meta.address)
    assert [o["action"] for o in json.loads(out)["orphans"]] == ["deleted"]
    assert all(blk.block_id.local_id != 999_999
               for blk in oz.clients.get(dn_id).list_blocks(cid))
    assert np.array_equal(b.read_key("legit"), np.arange(9000, dtype=np.uint8) % 251)


def test_fsck_classifies_key_health(tmp_path):
    """fsck walks the namespace: HEALTHY, then DEGRADED with one unit's
    datanode stopped, UNRECOVERABLE (exit 1) past p."""
    meta, dns, oz = _port_cluster(tmp_path)
    try:
        b = oz.create_volume("fv").create_bucket("fb", replication=EC)
        b.write_key("k", np.random.default_rng(0).integers(
            0, 256, 20_000, dtype=np.uint8))
        rc, out, _ = _run(cli.main, "fsck", "--om", meta.address,
                          "--volume", "fv")
        assert rc == 0 and json.loads(out)["keys"]["HEALTHY"] == 1
        nodes = oz.om.lookup_key("fv", "fb", "k")["block_groups"][0]["nodes"]
        by_id = {d.dn.id: d for d in dns}
        by_id[nodes[0]].stop()
        rc, out, _ = _run(cli.main, "fsck", "--om", meta.address)
        rep = json.loads(out)
        assert rc == 0 and rep["keys"]["DEGRADED"] == 1
        assert rep["issues"][0]["missing_units"][0]["datanode"] == nodes[0]
        for n in nodes[1:3]:
            by_id[n].stop()
        rc, out, _ = _run(cli.main, "fsck", "--om", meta.address)
        assert rc == 1 and json.loads(out)["keys"]["UNRECOVERABLE"] == 1
    finally:
        _stop(meta, dns, oz)


def test_fsck_expects_only_the_data_units_that_hold_bytes(tmp_path):
    """A short EC group wrote only its first data unit: losing an empty
    unit's node leaves the key HEALTHY."""
    meta, dns, oz = _port_cluster(tmp_path)
    try:
        b = oz.create_volume("sv").create_bucket("sb", replication=EC)
        b.write_key("tiny", np.arange(100, dtype=np.uint8))
        nodes = oz.om.lookup_key("sv", "sb", "tiny")["block_groups"][0]["nodes"]
        next(d for d in dns if d.dn.id == nodes[2]).stop()  # unit 2: no bytes
        rc, out, _ = _run(cli.main, "fsck", "--om", meta.address)
        assert rc == 0 and json.loads(out)["keys"] == {
            "HEALTHY": 1, "DEGRADED": 0, "UNRECOVERABLE": 0}
    finally:
        _stop(meta, dns, oz)


def test_debug_chunk_info_and_verify_replicas(cluster):
    meta, dns, oz = cluster
    b = oz.create_volume("dv").create_bucket("db", replication=EC)
    b.write_key("k", np.random.default_rng(5).integers(0, 256, 15_000,
                                                       dtype=np.uint8))
    rc, out, _ = _run(cli.main, "debug", "chunk-info", "/dv/db/k", "--om",
                      meta.address)
    info = json.loads(out)
    assert rc == 0 and len(info) == 1 and len(info[0]["replicas"]) == 5
    assert all(isinstance(r, dict) and r["chunks"]
               for r in info[0]["replicas"].values())
    rc, out, _ = _run(cli.main, "debug", "verify-replicas", "/dv/db/k", "--om",
                      meta.address)
    assert rc == 0 and {r["status"] for r in json.loads(out)} == {"ok"}
    rc, _, err = _run(cli.main, "debug", "chunk-info", "--om", meta.address)
    assert rc == 1 and "requires a target" in err


def test_debug_container_export_import_roundtrip(cluster, tmp_path):
    """A replica's backup and restore over the replication stream: export
    the tarball from one datanode, import it onto another, read the same
    bytes back."""
    meta, dns, oz = cluster
    b = oz.create_volume("xv").create_bucket("xb", replication="STANDALONE/ONE")
    data = np.random.default_rng(3).integers(0, 256, 20_000, dtype=np.uint8)
    b.write_key("k", data)
    g = oz.om.lookup_key("xv", "xb", "k")["block_groups"][0]
    src, cid = g["nodes"][0], int(g["container_id"])
    oz.clients.get(src).close_container(cid)
    target = next(d.dn.id for d in dns if d.dn.id != src)
    tar = tmp_path / "c.tar"
    rc, out, _ = _run(cli.main, "debug", "export-container", str(cid), "--dn",
                      src, "--file", str(tar), "--om", meta.address)
    assert rc == 0 and tar.stat().st_size > 0 and f"from {src}" in out
    rc, out, _ = _run(cli.main, "debug", "import-container", str(cid), "--dn",
                      target, "--file", str(tar), "--om", meta.address)
    assert rc == 0 and f"imported container {cid} on {target}" in out
    s_blocks = oz.clients.get(src).list_blocks(cid)
    d_blocks = oz.clients.get(target).list_blocks(cid)
    assert len(s_blocks) == len(d_blocks) > 0
    for sb, db in zip(s_blocks, d_blocks):
        for sc, dc in zip(sb.chunks, db.chunks):
            assert np.array_equal(oz.clients.get(src).read_chunk(sb.block_id, sc),
                                  oz.clients.get(target).read_chunk(db.block_id, dc))
    rc, _, err = _run(cli.main, "debug", "export-container", "abc", "--dn", src,
                      "--file", str(tar), "--om", meta.address)
    assert rc == 1 and "numeric" in err
    rc, _, err = _run(cli.main, "debug", "import-container", str(cid), "--dn",
                      "nope", "--file", str(tar), "--om", meta.address)
    assert rc == 1 and "unknown datanode" in err


def test_export_rejects_open_container_and_import_cleans_up(cluster):
    meta, dns, oz = cluster
    b = oz.create_volume("ev").create_bucket("eb", replication="STANDALONE/ONE")
    b.write_key("k", np.random.default_rng(4).integers(0, 256, 5_000,
                                                       dtype=np.uint8))
    g = oz.om.lookup_key("ev", "eb", "k")["block_groups"][0]
    dn, cid = g["nodes"][0], int(g["container_id"])
    c = oz.clients.get(dn)
    with pytest.raises(StorageError) as ei:
        c.export_container(cid)
    assert ei.value.code == "INVALID_CONTAINER_STATE"
    c.close_container(cid)
    blob = c.export_container(cid)
    c.delete_container(cid, force=True)
    with pytest.raises(StorageError):
        c.import_container(blob[: len(blob) // 2])
    assert c.import_container(blob) == cid


def test_repair_quota_rebuilds_the_counters(cluster):
    meta, dns, oz = cluster
    b = oz.create_volume("qv").create_bucket("qb", replication=EC)
    b.write_key("a", np.zeros(3000, dtype=np.uint8))
    b.write_key("b", np.zeros(5000, dtype=np.uint8))
    rc, out, _ = _run(cli.main, "repair", "quota", "--volume", "qv", "--om",
                      meta.address)
    rep = json.loads(out)
    assert rc == 0 and rep["volume_key_count"] == 2
    assert rep["volume_used_bytes"] == 8000
    rc, _, err = _run(cli.main, "repair", "quota", "--om", meta.address)
    assert rc == 1 and "--volume" in err


def _om_with_snapshots(pkg_om, pkg_scm, path):
    scm = pkg_scm.StorageContainerManager(stale_after_s=1e6, dead_after_s=2e6)
    for i in range(5):
        scm.register_datanode(f"dn{i}")
    kw = {"device": "cpu"} if pkg_om.__name__.startswith("ozone_tpu_torch") else {}
    om = pkg_om.OzoneManager(path, scm, **kw)
    om.create_volume("v")
    om.create_bucket("v", "b", "rs-3-2-4096")
    s1 = om.create_snapshot("v", "b", "s1")
    om.create_snapshot("v", "b", "s2")
    om.store.put("system", "raft_applied", {"index": 41})
    om.store.flush()
    om.close()
    return s1


def test_repair_snapshot_chain_and_transaction_offline(tmp_path):
    """Offline db surgery: a dry run changes nothing; --apply re-points a
    snapshot's chain link and resets the raft applied marker."""
    from ozone_tpu_torch.om import om as p_om
    from ozone_tpu_torch.om.metadata import OMMetadataStore
    from ozone_tpu_torch.om.requests import snapmeta_key
    from ozone_tpu_torch.scm import scm as p_scm

    s1 = _om_with_snapshots(p_om, p_scm, tmp_path / "om.db")
    db = str(tmp_path / "om.db")

    def prev():
        st = OMMetadataStore(tmp_path / "om.db")
        try:
            return st.get("open_keys", snapmeta_key("v", "b", "s2"))["previous"]
        finally:
            st.close()

    base = ["repair", "snapshot-chain", "--db", db, "--path", "/v/b",
            "--name", "s2"]
    assert _run(cli.main, *base, "--previous", "none")[0] == 0
    assert prev() == s1["snap_id"]
    assert _run(cli.main, *base, "--previous", "none", "--apply")[0] == 0
    assert prev() is None
    assert _run(cli.main, *base, "--previous", s1["snap_id"], "--apply")[0] == 0
    assert _run(cli.main, *base, "--previous", "bogus", "--apply")[0] == 1
    assert _run(cli.main, *base, "--apply")[0] == 2
    assert prev() == s1["snap_id"]
    rc, out, _ = _run(cli.main, "repair", "transaction", "--db", db)
    assert rc == 0 and json.loads(out) == {"raft_applied": {"index": 41},
                                           "new_index": None, "applied": False}
    assert _run(cli.main, "repair", "transaction", "--db", db, "--index", "7",
                "--apply")[0] == 0
    st = OMMetadataStore(tmp_path / "om.db")
    assert st.get("system", "raft_applied")["index"] == 7
    st.close()
    assert _run(cli.main, "repair", "transaction", "--db",
                str(tmp_path / "missing.db"))[0] == 2
    assert not (tmp_path / "missing.db").exists()


def _seed_dn_root(pkg_dn, pkg_ids, pkg_cs, root):
    dn = pkg_dn.Datanode(root, "dx", num_volumes=2)
    data = np.random.default_rng(3).integers(0, 256, 5000, dtype=np.uint8)
    for cid in (1, 2):
        dn.create_container(cid)
        bid = pkg_ids.BlockID(cid, 1)
        info = pkg_ids.ChunkInfo("c0", 0, data.size, pkg_cs.Checksum().compute(data))
        dn.write_chunk(bid, info, data)
        dn.put_block(pkg_ids.BlockData(bid, [info], data.size))
    dn.close()


def test_debug_container_offline_verbs(tmp_path):
    """`debug container-list|container-inspect --root`: strictly read-only
    over a stopped datanode's volumes."""
    from ozone_tpu_torch.storage import datanode, ids
    from ozone_tpu_torch.utils import checksum

    root = tmp_path / "dnroot"
    _seed_dn_root(datanode, ids, checksum, root)
    rc, out, _ = _run(cli.main, "debug", "container-list", "--root", str(root))
    rows = json.loads(out)
    assert rc == 0 and [r["id"] for r in rows] == [1, 2]
    assert all(r["blocks"] == 1 and r["used_bytes"] == 5000 for r in rows)
    rc, out, _ = _run(cli.main, "debug", "container-inspect", "1", "--root",
                      str(root))
    ins = json.loads(out)
    assert rc == 0 and ins["blocks"][0]["length"] == 5000 and ins["scan_errors"] == []
    assert _run(cli.main, "debug", "container-list", "--root",
                str(tmp_path / "nope"))[0] == 2
    assert _run(cli.main, "debug", "container-inspect", "abc", "--root",
                str(root))[0] == 2
    assert _run(cli.main, "debug", "container-inspect", "777", "--root",
                str(root))[0] == 1
    shutil.rmtree(root / "vol1")
    (root / "vol3").mkdir()
    rc, out, _ = _run(cli.main, "debug", "container-list", "--root", str(root))
    assert rc == 0 and len(json.loads(out)) >= 1
    assert not (root / "vol1").exists() and list((root / "vol3").iterdir()) == []
    bad = root / "vol0" / "containers" / "42"
    bad.mkdir(parents=True)
    (bad / "container.json").write_text('{"id": 42, "sta')
    rc, out, err = _run(cli.main, "debug", "container-list", "--root", str(root))
    assert rc == 0 and 42 not in [r["id"] for r in json.loads(out)]
    assert "bad descriptor" in err
    shutil.rmtree(bad)
    chunkless = root / "vol0" / "containers" / "43"
    chunkless.mkdir(parents=True)
    (chunkless / "container.json").write_text(json.dumps(
        {"id": 43, "state": "OPEN", "replica_index": 0, "created_at": 0}))
    assert _run(cli.main, "debug", "container-list", "--root", str(root))[0] == 0
    assert not (chunkless / "chunks").exists()


def test_inspect_reports_corruption_and_changes_nothing(tmp_path):
    """A flipped byte shows as a scan error; the replica is not marked
    UNHEALTHY and neither the volume db nor the descriptor changes."""
    from ozone_tpu_torch.storage import datanode, ids
    from ozone_tpu_torch.utils import checksum

    root = tmp_path / "dnroot"
    _seed_dn_root(datanode, ids, checksum, root)
    block = next((root / "vol0" / "containers" / "1" / "chunks").glob("*.block"))
    raw = bytearray(block.read_bytes())
    raw[7] ^= 0xFF
    block.write_bytes(bytes(raw))
    db = root / "vol0" / "metadata.db"
    desc = root / "vol0" / "containers" / "1" / "container.json"
    before = (db.stat().st_mtime_ns, desc.read_text())
    rc, out, _ = _run(cli.main, "debug", "container-inspect", "1", "--root",
                      str(root))
    ins = json.loads(out)
    assert rc == 0 and len(ins["scan_errors"]) == 1 and ins["state"] == "OPEN"
    assert (db.stat().st_mtime_ns, desc.read_text()) == before


def test_readonly_volume_refuses_writes(tmp_path):
    from ozone_tpu_torch.storage import datanode, ids
    from ozone_tpu_torch.storage.container import HddsVolume
    from ozone_tpu_torch.utils import checksum

    root = tmp_path / "dnroot"
    _seed_dn_root(datanode, ids, checksum, root)
    v = HddsVolume(root / "vol0", readonly=True)
    try:
        c = next(iter(v.load_containers()))
        with pytest.raises(StorageError):
            c.chunks.write_chunk(BlockID(c.id, 9), ChunkInfo("x", 0, 1),
                                 np.zeros(1, dtype=np.uint8))
        with pytest.raises(StorageError):
            v.db.put_block(BlockData(BlockID(c.id, 9), []))
    finally:
        v.close()
    assert not (tmp_path / "ghost").exists()
    with pytest.raises(StorageError):
        HddsVolume(tmp_path / "ghost", readonly=True)
    assert not (tmp_path / "ghost" / "containers").exists()


# --------------------------------------------------------- against ozone_tpu
def _fsck_and_orphans(root, pkg):
    """Three full-stripe keys, an orphan block beside the first, then fsck
    with one datanode down and with three down, and the orphan report."""
    make, main, block_data, block_id, scm_client = pkg
    meta, dns, oz = make(root)
    try:
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        rng = np.random.default_rng(11)
        for i in range(3):
            b.write_key(f"k{i}", rng.integers(0, 256, 3 * 4096 + 500 * i,
                                              dtype=np.uint8))
        g = oz.om.lookup_key("v", "b", "k0")["block_groups"][0]
        cid, host = int(g["container_id"]), g["nodes"][1]
        oz.clients.get(host).put_block(block_data(block_id(cid, 777_777),
                                                  chunks=[]))
        scm = scm_client(meta.address)
        _await_replica(scm, cid, host)
        scm.close()
        out = []
        _, text, _ = _run(main, "repair", "orphans", "--delete", "--om",
                          meta.address)
        out.append(sorted((o["local_id"], o["datanode"] == host,
                           o["container_state"], o["action"])
                          for o in json.loads(text)["orphans"]))
        nodes = g["nodes"]
        by_id = {d.dn.id: d for d in dns}
        by_id[nodes[0]].stop()
        rc, text, _ = _run(main, "fsck", "--om", meta.address)
        rep = json.loads(text)
        out.append((rc, rep["keys"], sorted(
            (x["key"], x["state"], sorted({m["datanode"] for m in x["missing_units"]}))
            for x in rep["issues"])))
        for n in nodes[1:3]:
            by_id[n].stop()
        rc, text, _ = _run(main, "fsck", "--om", meta.address)
        rep = json.loads(text)
        out.append((rc, rep["keys"], sorted((x["key"], x["state"])
                                            for x in rep["issues"])))
        return out, nodes
    finally:
        oz.om.close()
        oz.clients.close()
        for d in dns:
            with contextlib.suppress(Exception):
                d.stop()
        meta.stop()


def test_fsck_and_orphans_equal_the_reference(tmp_path):
    from ozone_tpu.storage.ids import BlockData as JBlockData
    from ozone_tpu.net.scm_service import GrpcScmClient
    from ozone_tpu.storage.ids import BlockID as JBlockID
    from ozone_tpu.tools import cli as j_cli
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    got, p_nodes = _fsck_and_orphans(
        tmp_path / "port",
        (_port_cluster, cli.main, BlockData, BlockID, RemoteScmClient))
    want, j_nodes = _fsck_and_orphans(
        tmp_path / "ref",
        (_ref_cluster, j_cli.main, JBlockData, JBlockID, GrpcScmClient))

    def named(res, nodes):  # datanode ids by unit position
        pos = {n: f"unit{i}" for i, n in enumerate(nodes)}
        orphans, one, three = res
        return orphans, (one[0], one[1], [(k, s, [pos[d] for d in ds])
                                          for k, s, ds in one[2]]), three

    assert named(got, p_nodes) == named(want, j_nodes)
    orphans, one, three = named(got, p_nodes)
    assert orphans == [(777_777, True, "OPEN", "skipped-open-container")]
    assert one[1] == {"HEALTHY": 0, "DEGRADED": 3, "UNRECOVERABLE": 0}
    assert three[0] == 1 and three[1]["UNRECOVERABLE"] == 3


def test_debug_rows_equal_the_reference(tmp_path):
    """`debug ldb`, `container-list` and `container-inspect` print the same
    rows on equal stores (paths aside)."""
    from ozone_tpu.storage import datanode as j_datanode
    from ozone_tpu.storage import ids as j_ids
    from ozone_tpu.tools import cli as j_cli
    from ozone_tpu.utils import checksum as j_checksum
    from ozone_tpu_torch.storage import datanode, ids
    from ozone_tpu_torch.utils import checksum

    _seed_dn_root(datanode, ids, checksum, tmp_path / "p")
    _seed_dn_root(j_datanode, j_ids, j_checksum, tmp_path / "j")

    def rows(main, root):
        _, lst, _ = _run(main, "debug", "container-list", "--root", str(root))
        _, ins, _ = _run(main, "debug", "container-inspect", "2", "--root",
                         str(root))
        lst, ins = json.loads(lst), json.loads(ins)
        for r in lst + [ins]:
            r.pop("path")
        return lst, ins

    assert rows(cli.main, tmp_path / "p") == rows(j_cli.main, tmp_path / "j")
    from ozone_tpu.om import om as j_om
    from ozone_tpu.scm import scm as j_scm
    from ozone_tpu_torch.om import om as p_om
    from ozone_tpu_torch.scm import scm as p_scm

    _om_with_snapshots(p_om, p_scm, tmp_path / "p.db")
    _om_with_snapshots(j_om, j_scm, tmp_path / "j.db")

    def ldb(main, db, table):
        _, text, _ = _run(main, "debug", "ldb", str(db), "--table", table)
        out = []
        for ln in text.splitlines():
            r = json.loads(ln)
            v = r["value"]
            out.append((r["key"], sorted(k for k in v) if isinstance(v, dict)
                        else v))
        return out

    for table in ("volumes", "buckets", "system"):
        assert ldb(cli.main, tmp_path / "p.db", table) == \
            ldb(j_cli.main, tmp_path / "j.db", table)


# ----------------------------------------------------- state carried across
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_repair_transaction_on_the_other_packages_db(tmp_path, writer):
    from ozone_tpu.om import om as j_om
    from ozone_tpu.om.metadata import OMMetadataStore as JStore
    from ozone_tpu.scm import scm as j_scm
    from ozone_tpu.tools import cli as j_cli
    from ozone_tpu_torch.om import om as p_om
    from ozone_tpu_torch.om.metadata import OMMetadataStore
    from ozone_tpu_torch.scm import scm as p_scm

    db = tmp_path / "om.db"
    if writer == "port":
        _om_with_snapshots(p_om, p_scm, db)
        main, store = j_cli.main, JStore
    else:
        _om_with_snapshots(j_om, j_scm, db)
        main, store = cli.main, OMMetadataStore
    assert _run(main, "repair", "transaction", "--db", str(db), "--index", "5",
                "--apply")[0] == 0
    st = store(db)
    try:
        assert st.get("system", "raft_applied") == {"index": 5}
        assert st.get("volumes", "/v")["name"] == "v"
    finally:
        st.close()


@pytest.mark.parametrize("exporter", ["port", "reference"])
def test_container_tarball_crosses_packages(tmp_path, exporter):
    """A tarball `debug export-container` would carry (the packer's, every
    codec both sides have) unpacks in the other package's datanode."""
    from ozone_tpu.storage import container_packer as j_cp
    from ozone_tpu.storage import datanode as j_datanode
    from ozone_tpu.storage import ids as j_ids
    from ozone_tpu.utils import checksum as j_checksum
    from ozone_tpu_torch.storage import container_packer as cp
    from ozone_tpu_torch.storage import datanode, ids
    from ozone_tpu_torch.utils import checksum

    sides = {"port": (datanode, ids, checksum, cp),
             "reference": (j_datanode, j_ids, j_checksum, j_cp)}
    src_pkg = sides[exporter]
    dst_pkg = sides["reference" if exporter == "port" else "port"]
    _seed_dn_root(*src_pkg[:3], tmp_path / "src")
    src = src_pkg[0].Datanode(tmp_path / "src", "dx", num_volumes=2)
    dst = dst_pkg[0].Datanode(tmp_path / "dst", "dy")
    try:
        src.close_container(1)
        common = [c for c in src_pkg[3].available_codecs()
                  if c in dst_pkg[3].available_codecs()]
        for codec in common:
            blob = src_pkg[3].export_container(src.get_container(1),
                                               compression=codec)
            c = dst_pkg[3].import_container(dst, blob)
            bid = dst_pkg[1].BlockID(1, 1)
            got = dst.read_chunk(bid, c.get_block(bid).chunks[0], verify=True)
            want = src.read_chunk(src_pkg[1].BlockID(1, 1), src.get_container(1)
                                  .get_block(src_pkg[1].BlockID(1, 1)).chunks[0])
            assert np.array_equal(np.asarray(got), np.asarray(want))
            dst.delete_container(1, force=True)
    finally:
        src.close()
        dst.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_dbgen_store_reads_in_the_other_package(tmp_path, writer):
    """freon dbgen's store: the other package's OM store reads every row,
    and the port's om_scale measures a store its own dbgen wrote."""
    from ozone_tpu.om.metadata import OMMetadataStore as JStore
    from ozone_tpu.om.metadata import key_key as j_key_key
    from ozone_tpu.tools import freon as j_freon
    from ozone_tpu_torch.om.metadata import OMMetadataStore, key_key
    from ozone_tpu_torch.tools import freon

    db = tmp_path / "gen.db"
    if writer == "port":
        assert freon.dbgen(db, n_keys=600).failures == 0
        store, kk = JStore(db), j_key_key
    else:
        assert j_freon.dbgen(db, n_keys=600).failures == 0
        store, kk = OMMetadataStore(db), key_key
    try:
        assert len(list(store.iterate("keys"))) == 600
        row = store.get("keys", kk("genvol", "genbucket", "gen/0/key-599"))
        assert row["size"] == 1024 and row["replication"] == "rs-6-3-1024k"
        assert store.get("buckets", "/genvol/genbucket")["name"] == "genbucket"
    finally:
        store.close()


def test_om_scale_measures_a_dbgen_store(tmp_path):
    from ozone_tpu_torch.tools import om_scale

    rc, out, _ = _run(om_scale.main, "--keys", "1500", "--db",
                      str(tmp_path / "s.db"), "--lookups", "50", "--commits",
                      "50")
    rep = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and rep["keys"] == 1500
    assert rep["repair_key_count"] >= 1550 and rep["snapdiff_entries"] == 10
    assert rep["snapdiff_mode"] == "incremental"
