"""The port's Recon against `ozone_tpu`'s on the CPU.

Mirrors of the reference's Recon tests (tests/test_csi_recon.py: the
delta-fed container-key and namespace-summary indexes, their rebuild
when the journal is trimmed, the warehouse, table insights, unhealthy
containers, the UI contract and `admin namespace summary`;
tests/test_observability.py's endpoint walk; the lifecycle and geo
panels of tests/test_lifecycle.py and tests/test_replication_geo.py),
on the port's minicluster with device="cpu". Beyond them: the same
seeded writes into both packages' miniclusters give equal Recon views
(namespace, file-size histogram, du, container to keys, unhealthy
containers after a datanode dies), and each package reads the other's
`recon.db`.
"""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ozone_tpu.recon import recon as ref_recon
from ozone_tpu.testing.minicluster import MiniOzoneCluster as RefCluster
from ozone_tpu_torch.recon.recon import (
    ContainerKeyIndex,
    NSSummaryIndex,
    ReconScmView,
    ReconServer,
    ReconWarehouse,
    TableInsights,
)
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

EC = "rs-3-2-4096"


@pytest.fixture(autouse=True)
def _quiet_codec(monkeypatch):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mini(root, n=5, **kw):
    return MiniOzoneCluster(root, num_datanodes=n, block_size=8 * 4096,
                            container_size=4 * 1024 * 1024,
                            stale_after_s=1000.0, dead_after_s=2000.0,
                            device="cpu", **kw)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = _mini(tmp_path_factory.mktemp("recon"))
    yield c
    c.close()


def _get(addr, path):
    return json.loads(urllib.request.urlopen(f"http://{addr}{path}",
                                             timeout=10).read())


def _write_keys(cluster, bucket, names):
    oz = cluster.client()
    try:
        vol = oz.create_volume("rv")
    except Exception:  # noqa: BLE001 - made by an earlier test
        vol = oz.get_volume("rv")
    try:
        b = vol.create_bucket(bucket, replication=EC)
    except Exception:  # noqa: BLE001
        b = vol.get_bucket(bucket)
    for n in names:
        b.write_key(n, np.arange(5000, dtype=np.uint8) % 251)
    return b


# -------------------------------------------------------------- the indexes
def test_container_key_index_incremental(cluster):
    b = _write_keys(cluster, "idx", ["a", "b"])
    idx = ContainerKeyIndex(cluster.om)
    paths = {p for ps in idx.container_key_map().values() for p in ps}
    assert any(p.endswith("/a") for p in paths)
    rebuilds = idx.full_rebuilds
    b.write_key("c", np.zeros(100, np.uint8))
    paths = {p for ps in idx.container_key_map().values() for p in ps}
    assert any(p.endswith("/c") for p in paths)
    assert idx.full_rebuilds == rebuilds
    b.delete_key("c")
    paths = {p for ps in idx.container_key_map().values() for p in ps}
    assert not any(p.endswith("/c") for p in paths)
    assert idx.full_rebuilds == rebuilds


def test_container_key_index_fso_paths(cluster):
    oz = cluster.client()
    try:
        vol = oz.create_volume("rv")
    except Exception:  # noqa: BLE001
        vol = oz.get_volume("rv")
    cluster.om.create_bucket("rv", "fsob", EC, "FILE_SYSTEM_OPTIMIZED")
    vol.get_bucket("fsob").write_key("deep/nested/file.dat",
                                     np.ones(2048, np.uint8))
    idx = ContainerKeyIndex(cluster.om)
    paths = {p for ps in idx.container_key_map().values() for p in ps}
    assert "/rv/fsob/deep/nested/file.dat" in paths


def test_index_rebuild_when_journal_trimmed(cluster):
    _write_keys(cluster, "trim", ["x"])
    idx = ContainerKeyIndex(cluster.om)
    rebuilds = idx.full_rebuilds
    store = cluster.om.store
    store._updates = store._updates[-1:] if store._updates else []
    idx._txid = 0
    idx.refresh()
    assert idx.full_rebuilds == rebuilds + 1
    ns = NSSummaryIndex(cluster.om)
    ns_rebuilds = ns.full_rebuilds
    ns._txid = 0
    ns.refresh()
    assert ns.full_rebuilds == ns_rebuilds + 1


def test_warehouse_history(cluster, tmp_path):
    _write_keys(cluster, "wh", ["k1", "k2"])
    recon = ReconServer(cluster.om, cluster.scm,
                        db_path=tmp_path / "recon.db")
    recon.start()
    try:
        recon.run_tasks_once()
        recon.run_tasks_once()
        hist = recon.warehouse.history("namespace")
        assert len(hist) == 2 and hist[0]["keys"] >= 2
        assert len(_get(recon.address, "/api/history/namespace")) == 2
        keymap = _get(recon.address, "/api/containers/keys")
        assert any(any(p.endswith("/k1") for p in ps)
                   for ps in keymap.values())
    finally:
        recon.stop()


def test_warehouse_persists_across_restart(tmp_path):
    db = tmp_path / "persist.db"
    w = ReconWarehouse(db)
    w.record("namespace", {"keys": 7})
    w.close()
    w2 = ReconWarehouse(db)
    assert w2.latest("namespace")["keys"] == 7
    w2.close()


def test_get_updates_since_contract(cluster):
    store = cluster.om.store
    _, txid, _ = store.get_updates_since(store.txid)
    _write_keys(cluster, "delta", ["d1"])
    updates2, txid2, complete2 = store.get_updates_since(txid)
    assert complete2
    assert txid2 > txid
    assert all(u[0] > txid for u in updates2)


def test_nssummary_fso_du(cluster):
    oz = cluster.client()
    try:
        vol = oz.create_volume("rv")
    except Exception:  # noqa: BLE001
        vol = oz.get_volume("rv")
    cluster.om.create_bucket("rv", "nsfso", EC, "FILE_SYSTEM_OPTIMIZED")
    b = vol.get_bucket("nsfso")
    b.write_key("a/one.dat", np.zeros(1000, np.uint8))
    b.write_key("a/b/two.dat", np.zeros(2000, np.uint8))
    b.write_key("top.dat", np.zeros(400, np.uint8))
    ns = NSSummaryIndex(cluster.om)
    root = ns.du("/rv/nsfso")
    assert root["files"] == 1 and root["bytes"] == 400
    assert root["total_files"] == 3 and root["total_bytes"] == 3400
    a = ns.du("/rv/nsfso/a")
    assert a["files"] == 1 and a["total_files"] == 2
    assert a["total_bytes"] == 3000
    assert [c["path"] for c in a["children"]] == ["/rv/nsfso/a/b"]
    rebuilds = ns.full_rebuilds
    b.write_key("a/b/three.dat", np.zeros(500, np.uint8))
    assert ns.du("/rv/nsfso/a/b")["total_bytes"] == 2500
    b.delete_key("a/b/three.dat")
    assert ns.du("/rv/nsfso/a/b")["total_bytes"] == 2000
    assert ns.full_rebuilds == rebuilds
    with pytest.raises(KeyError):
        ns.du("/rv/nsfso/nope")


def test_nssummary_obs_and_volume_rollup(cluster):
    _write_keys(cluster, "nsobs", ["p/x", "p/y"])
    ns = NSSummaryIndex(cluster.om)
    b = ns.du("/rv/nsobs")
    assert b["total_files"] == 2 and b["total_bytes"] == 10000
    vol = ns.du("/rv")
    assert any(c["path"] == "/rv/nsobs" for c in vol["children"])
    assert vol["total_files"] >= 2


def test_table_insights(cluster):
    _write_keys(cluster, "ins", ["k1", "k2"])
    ti = TableInsights(cluster.om)
    counts = ti.table_counts()
    assert counts["keys"] >= 2
    assert counts["volumes"] >= 1 and counts["buckets"] >= 1
    # the row count is the materialised one, cache and sqlite merged
    for t in ("keys", "volumes", "buckets", "open_keys"):
        assert counts[t] == sum(1 for _ in cluster.om.store.iterate(t))
    sess = cluster.om.open_key("rv", "ins", "leaked", replication=EC)
    rows = ti.open_keys()
    assert any("leaked" in r["key"] for r in rows)
    assert all(r["age_s"] >= 0 for r in rows)
    del sess
    cluster.client().get_volume("rv").get_bucket("ins").delete_key("k1")
    assert any("k1" in r["key"] for r in ti.deleted_keys())


def test_unhealthy_containers_endpoint(cluster, tmp_path):
    _write_keys(cluster, "uh", ["k"])
    recon = ReconServer(cluster.om, cluster.scm, db_path=tmp_path / "r.db")
    recon.start()
    try:
        rows = _get(recon.address, "/api/containers/unhealthy")
        if rows:
            assert all("states" in r and "replicas" in r for r in rows)
        none = _get(recon.address,
                    "/api/containers/unhealthy?state=MISSING")
        assert none == [] or all("MISSING" in r["states"] for r in none)
        assert _get(recon.address, "/api/insights/tables")["keys"] >= 1
        du = _get(recon.address, "/api/nssummary?path=/rv/uh")
        assert du["total_files"] >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(recon.address, "/api/nssummary?path=/rv/zzz/q")
        assert ei.value.code == 404
    finally:
        recon.stop()


def test_unhealthy_detail_under_replication(cluster):
    from ozone_tpu_torch.storage.ids import ContainerState

    _write_keys(cluster, "uh2", ["kk"])
    cluster.heartbeat_all()
    view = ReconScmView(cluster.scm)
    c = next(c for c in cluster.scm.containers.containers() if c.replicas)
    dn, saved = next(iter(c.replicas.items()))
    prev_state = c.state
    c.state = ContainerState.CLOSED
    del c.replicas[dn]
    try:
        row = next(r for r in view.unhealthy_containers("UNDER_REPLICATED")
                   if r["container"] == c.id)
        assert "UNDER_REPLICATED" in row["states"]
        assert row["actual"] == row["expected"] - 1
        assert all(rep["dn"] != dn for rep in row["replicas"])
        if row["replication"].startswith("rs"):
            assert len(row["missing_indexes"]) == 1
    finally:
        c.replicas[dn] = saved
        c.state = prev_state


def test_recon_ui_contract(cluster, tmp_path):
    recon = ReconServer(cluster.om, cluster.scm, db_path=tmp_path / "ui.db")
    recon.start()
    try:
        html = urllib.request.urlopen(
            f"http://{recon.address}/").read().decode()
        urls = sorted(set(re.findall(r'fetch\(\s*"(/api/[^"?]+)', html)))
        assert urls and any("nssummary" in u for u in urls), urls
        for u in urls:
            full = u + ("?path=/" if "nssummary" in u else "")
            assert urllib.request.urlopen(
                f"http://{recon.address}{full}").status == 200, u
        ids = set(re.findall(r'getElementById\("([^"]+)"\)', html))
        ids |= {x.split(" ")[0] for x in
                re.findall(r'querySelector\("#([^" ]+)', html)}
        missing = [i for i in ids
                   if f'id="{i}"' not in html and i != "du-root"]
        assert not missing, missing
    finally:
        recon.stop()


def test_admin_namespace_summary_cli(tmp_path, capsys):
    from ozone_tpu_torch.net.daemons import ScmOmDaemon
    from ozone_tpu_torch.tools.cli import main as cli_main
    from ozone_tpu_torch.utils.tracing import Tracer

    meta = ScmOmDaemon(tmp_path / "om.db", stale_after_s=1e6,
                       dead_after_s=2e6, recon_port=0, recon_interval_s=0.2,
                       background_interval_s=0.1, device="cpu")
    meta.start()
    try:
        om = meta.om
        om.create_volume("nsv")
        om.create_bucket("nsv", "b", EC)
        s = om.open_key("nsv", "b", "k0")
        om.commit_key(s, [], 0)
        recon_http = meta.recon.address
        deadline = time.monotonic() + 15
        out = None
        while time.monotonic() < deadline:
            rc = cli_main(["admin", "namespace", "summary", "/nsv/b",
                           "--http", recon_http])
            raw = capsys.readouterr().out
            if rc == 0 and raw.strip():
                d = json.loads(raw)
                if d.get("total_files") == 1:
                    out = d
                    break
            time.sleep(0.3)
        assert out is not None, "summary never showed the committed key"
        assert out["total_bytes"] == 0
        # the daemon's cadence records task runs in its warehouse
        deadline = time.monotonic() + 15
        while not meta.recon.warehouse.history("namespace") \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert meta.recon.warehouse.history("namespace")
        assert cli_main(["admin", "namespace", "du", "/nsv/b",
                         "--http", recon_http]) == 2
        capsys.readouterr()
        assert cli_main(["admin", "namespace", "summary", "/nsv/b"]) == 2
    finally:
        meta.stop()
        Tracer.instance()._export_q = None


# ------------------------------------------------------------ the panels
def test_recon_endpoints(tmp_path, monkeypatch):
    c = _mini(tmp_path)
    try:
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        rng = np.random.default_rng(0)
        for i, size in enumerate((100, 5000, 60_000)):
            b.write_key(f"k{i}", rng.integers(0, 256, size, dtype=np.uint8))
        c.tick()
        recon = ReconServer(c.om, c.scm)
        recon.start()
        try:
            a = recon.address
            ns = _get(a, "/api/namespace")
            assert ns["keys"] == 3 and ns["bytes"] == 65_100
            assert sum(_get(a, "/api/filesizes").values()) == 3
            ck = _get(a, "/api/containers/keys")
            assert any("/v/b/k2" in keys for keys in ck.values())
            assert not _get(a, "/api/containers/health")["missing"]
            assert len(_get(a, "/api/nodes")) == 5
            assert _get(a, "/api/heatmap")["cells"] == [
                {"volume": "v", "bucket": "b", "keys": 3, "bytes": 65_100}]
            monkeypatch.setenv("OZONE_TPU_TRACE_SLO_CLIENT_PUT_MS", "0")
            b.write_key("k3", rng.integers(0, 256, 100, dtype=np.uint8))
            sl = _get(a, "/api/traces/slow")
            tid = next(t["traceId"] for t in sl["traces"]
                       if t["root"] == "client:put")
            detail = _get(a, "/api/traces/slow?id=" + tid)
            assert detail["criticalPath"] and detail["spans"]
            assert sum(s["micros"] for s in detail["criticalPath"]) > 0
            assert set(_get(a, "/api/admission")) == {"enabled", "hops",
                                                      "counters"}
            from ozone_tpu_torch import admission

            admission.reset_for_tests()
            try:
                ctl = admission.controller("gateway")
                with ctl.admit():
                    ad = _get(a, "/api/admission")
                assert ad["hops"]["gateway"]["inflight"] == 1
                assert ad["counters"]["gateway_admitted"] >= 1
            finally:
                admission.reset_for_tests()
            sm = _get(a, "/api/smallobj")
            assert set(sm) == {"counters", "slabs", "knobs"}
            assert _get(a, "/api/shards")["sharded"] is False
            page = urllib.request.urlopen(f"http://{a}/").read().decode()
            assert "Namespace heat" in page and "/api/heatmap" in page
            assert "Slow requests" in page and "/api/traces/slow" in page
            assert "Admission control" in page and "/api/admission" in page
            prom = urllib.request.urlopen(f"http://{a}/prom").read().decode()
            assert "om_" in prom
        finally:
            recon.stop()
    finally:
        c.close()


def test_recon_lifecycle_endpoint(tmp_path):
    from ozone_tpu_torch.lifecycle.policy import ACTION_TRANSITION
    from ozone_tpu_torch.om import requests as rq

    c = _mini(tmp_path, n=6)
    try:
        c.om.submit(rq.CreateVolume("v"))
        c.om.create_bucket("v", "b", replication="RATIS/THREE")
        c.om.set_bucket_lifecycle("v", "b", [
            {"id": "warm", "prefix": "", "age_days": 1,
             "action": ACTION_TRANSITION, "target": EC}])
        recon = ReconServer(c.om, c.scm)
        recon.start()
        try:
            out = _get(recon.address, "/api/lifecycle")
            assert out["buckets"][0]["rules"][0]["id"] == "warm"
            assert "metrics" in out
            cx = _get(recon.address, "/api/codec")
            if cx.get("enabled") is False:
                assert set(cx) == {"enabled"}
            elif cx.get("started") is False:
                assert set(cx) == {"enabled", "started"}
            else:
                for want in ("fill_ratio", "ops_per_dispatch",
                             "queue_depth", "linger_ms", "weights"):
                    assert want in cx, want
            # the reference's answer before its executor starts (on one
            # device it never does): enabled, not started, the spill knobs
            from ozone_tpu.parallel import mesh_executor

            mx = _get(recon.address, "/api/mesh")
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(mesh_executor, "_executor", None)
                assert mx == ref_recon.ReconServer.mesh_view(recon)
            assert mx == {"enabled": True, "started": False,
                          "spill_enabled": False, "spill_watermark": 64}
            page = urllib.request.urlopen(
                f"http://{recon.address}/").read().decode()
            assert "Lifecycle tiering" in page and "/api/lifecycle" in page
            assert "Codec service" in page and "/api/codec" in page
            assert "Mesh executor" in page and "/api/mesh" in page
        finally:
            recon.stop()
    finally:
        c.close()


def test_recon_replication_endpoint(tmp_path, request):
    from ozone_tpu_torch.replication_geo import shipper as geo

    src = _mini(tmp_path / "src", n=6)
    dst = _mini(tmp_path / "dst", n=6)
    endpoint = f"dst-{request.node.name}"
    geo.register_inprocess(endpoint, dst.client)
    try:
        src.client().create_volume("v")
        src.om.create_bucket("v", "b", "RATIS/THREE")
        src.om.set_bucket_geo_replication("v", "b", [
            {"id": "r1", "endpoint": endpoint, "prefix": "logs/"}])
        recon = ReconServer(src.om, src.scm)
        recon.start()
        try:
            out = _get(recon.address, "/api/replication")
            assert out["buckets"][0]["rules"][0]["endpoint"] == endpoint
            assert "lag" in out and "entries" in out["lag"]
            assert "metrics" in out
            page = urllib.request.urlopen(
                f"http://{recon.address}/", timeout=10).read().decode()
            assert "Geo replication" in page and "/api/replication" in page
        finally:
            recon.stop()
    finally:
        geo.unregister_inprocess(endpoint)
        src.close()
        dst.close()


# ------------------------------------------------- against the reference
def _views(c, recon_mod, fso: bool):
    """Recon's views of one cluster, through one package's Recon."""
    tasks = recon_mod.ReconTasks(c.om)
    ns = recon_mod.NSSummaryIndex(c.om)
    ck = recon_mod.ContainerKeyIndex(c.om)
    scm = recon_mod.ReconScmView(c.scm)
    du = [ns.du(p) for p in ("/", "/v", "/v/b", "/v/f")]
    if fso:
        du += [ns.du("/v/f/d0"), ns.du("/v/f/d0/e")]
    for d in du:
        # children come in object-id order, and object ids are random in
        # both packages
        d["children"].sort(key=lambda ch: ch["path"])
    return {"namespace": tasks.namespace_summary(),
            "filesizes": tasks.file_size_histogram(),
            "du": du,
            "container_keys": ck.container_key_map(),
            "health": scm.container_health(),
            "unhealthy": scm.unhealthy_containers(),
            "tables": recon_mod.TableInsights(c.om).table_counts(),
            "nodes": [{k: v for k, v in n.items()} for n in
                      scm.node_table()]}


@pytest.mark.parametrize("seed", [0, 1])
def test_recon_views_equal_reference(tmp_path, seed):
    """The same seeded writes into both packages' miniclusters: equal
    namespace summaries, file-size histograms, du answers (OBS and FSO),
    container-to-key maps, table counts and node tables; and after a
    datanode dies with its containers closed, equal container health and
    unhealthy-container rows (missing indexes included)."""
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(1, 40_000, 8)]
    names = [f"k{i}/{int(x)}" for i, x in enumerate(rng.integers(0, 99, 8))]
    unit = int(rng.integers(0, 5))

    def run(port):
        root = tmp_path / ("port" if port else "ref")
        kw = dict(num_datanodes=6, block_size=8 * 4096,
                  container_size=4 * 1024 * 1024, stale_after_s=1000.0,
                  dead_after_s=2000.0, placement_seed=42)
        c = (MiniOzoneCluster(root, device="cpu", **kw) if port
             else RefCluster(root, **kw))
        mod = __import__("ozone_tpu_torch.recon.recon", fromlist=["x"]) \
            if port else ref_recon
        try:
            oz = c.client()
            v = oz.create_volume("v")
            b = v.create_bucket("b", replication=EC)
            c.om.create_bucket("v", "f", EC, "FILE_SYSTEM_OPTIMIZED")
            f = v.get_bucket("f")
            data = np.random.default_rng(seed + 100)
            for name, size in zip(names, sizes):
                payload = data.integers(0, 256, size, dtype=np.uint8)
                b.write_key(name, payload)
                f.write_key(f"d0/e/{name}" if size % 2 else f"d0/{name}",
                            payload)
            b.delete_key(names[0])
            c.heartbeat_all()
            before = _views(c, mod, True)
            for dn in c.datanodes:
                for cont in list(dn.containers):
                    dn.close_container(cont.id)
            c.tick()
            # the datanode of one unit of the first container dies
            victim = c.scm.containers.containers()[0].pipeline.nodes[unit]
            c.stop_datanode(victim)
            c.scm.nodes.get(victim).last_heartbeat = -1e9
            c.scm.nodes.check_liveness()
            after = _views(c, mod, True)
            for view in (before, after):
                # pipeline ids are process-wide counters; names of the
                # nodes' last heartbeat times differ by clock
                view["nodes"] = [{k: n[k] for k in
                                  ("dn_id", "rack", "state", "op_state",
                                   "capacity_bytes", "layout_version")}
                                 for n in view["nodes"]]
            return before, after
        finally:
            c.close()

    got = run(True)
    want = run(False)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[0]["namespace"]["keys"] == 2 * len(names) - 1
    assert got[1]["unhealthy"], "a dead datanode's containers are unhealthy"


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_recon_db_read_across(cluster, tmp_path, writer):
    """Each package reads the other's `recon.db`: a warehouse written by
    one package's task run answers the same history through the
    other's."""
    _write_keys(cluster, "xdb", ["a", "b"])
    db = tmp_path / "recon.db"
    if writer == "port":
        recon = ReconServer(cluster.om, cluster.scm, db_path=db)
        recon.run_tasks_once()
        recon.stop()
    else:
        w = ref_recon.ReconWarehouse(db)
        w.record("namespace", ReconServer(cluster.om, cluster.scm)
                 .tasks.namespace_summary())
        w.record("filesizes", {"buckets": {"<=2^13": 2}})
        w.close()
    port_w = ReconWarehouse(db)
    ref_w = ref_recon.ReconWarehouse(db)
    try:
        for kind in ("namespace", "filesizes", "container_health", "nodes",
                     "table_counts"):
            assert port_w.history(kind) == ref_w.history(kind)
        assert port_w.latest("namespace")["keys"] >= 2
    finally:
        port_w.close()
        ref_w.close()
