"""Upgrade finalization on the port, held against `ozone_tpu` on the CPU.

Mirrors of the reference's upgrade tests (tests/test_upgrade_snapshots.py:
the layout manager, its downgrade clamp, finalization over the daemons,
the OM, datanode, native-sidecar and S3 gates, mixed-version datanodes,
the downgrade drill and the metadata ring), with device="cpu" on the
port's side. Beyond them: the same seeded request sequence through both
packages' OM and SCM over an old layout gives the same refusal codes,
upgrade status dicts and finalize answers, and each package reads the
other's `layout_version.json`.
"""

import datetime
import json
import time
import unittest.mock as mock
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ozone_tpu.om import om as ref_om
from ozone_tpu.om.requests import OMError as RefOMError
from ozone_tpu.scm import scm as ref_scm
from ozone_tpu.utils import upgrade as ref_ug
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.native_dn import NativeDatanodeClient
from ozone_tpu_torch.client.ozone_client import OzoneClient
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.gateway.s3 import S3Gateway
from ozone_tpu_torch.gateway.s3_auth import sign_request_streaming
from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
from ozone_tpu_torch.net.dn_service import RpcDatanodeClient
from ozone_tpu_torch.net.om_service import RemoteOmClient
from ozone_tpu_torch.net.scm_service import RemoteScmClient
from ozone_tpu_torch.om import om as port_om
from ozone_tpu_torch.om.requests import OMError
from ozone_tpu_torch.scm import scm as port_scm
from ozone_tpu_torch.storage.ids import BlockID, ChunkInfo, StorageError
from ozone_tpu_torch.utils import upgrade as ug
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType
from ozone_tpu_torch.utils.metrics import registry
from ozone_tpu_torch.utils.upgrade import (
    FEATURES,
    FinalizationState,
    LayoutVersionManager,
    UpgradeFinalizer,
)

EC = "rs-3-2-4096"
PRE = "NOT_SUPPORTED_OPERATION_PRIOR_FINALIZATION"
#: every wait in this file is bounded by this many seconds
WAIT_S = 15.0


@pytest.fixture(autouse=True)
def _quiet_codec(monkeypatch):
    """Direct codec route and one torch thread (the plain versions must
    not oversubscribe the cores the suite's timing tests share)."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed_layout(path, version):
    path.mkdir(parents=True, exist_ok=True)
    (path / "layout_version.json").write_text(
        json.dumps({"layout_version": version}))


def _wait(pred, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _client(meta):
    clients = DatanodeClientFactory()
    return OzoneClient(RemoteOmClient(meta.address, clients=clients),
                       clients, device="cpu")


def _meta(root, **kw):
    m = ScmOmDaemon(root / "om.db", stale_after_s=1000.0,
                    dead_after_s=2000.0, background_interval_s=0.3,
                    device="cpu", **kw)
    m.start()
    return m


def _dns(root, meta, n, **kw):
    out = [DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.1, device="cpu", **kw)
           for i in range(n)]
    for d in out:
        d.start()
    return out


# ------------------------------------------------------ the layout manager
def test_fresh_install_is_finalized(tmp_path):
    m = LayoutVersionManager(tmp_path / "VERSION")
    assert not m.needs_finalization()
    fin = UpgradeFinalizer(m)
    assert fin.finalize() is FinalizationState.ALREADY_FINALIZED


def test_upgrade_gating_and_finalize(tmp_path):
    old = LayoutVersionManager(tmp_path / "VERSION", software_version=0)
    assert old.metadata_version == 0
    m = LayoutVersionManager(tmp_path / "VERSION")
    assert m.metadata_version == 0
    assert m.needs_finalization()
    ec_feature = next(f for f in FEATURES if f.name == "EC_DEVICE_CODEC")
    with pytest.raises(RuntimeError):
        m.check_allowed(ec_feature)
    ran = []
    fin = UpgradeFinalizer(m)
    fin.register_action(ec_feature, lambda: ran.append("ec"))
    assert fin.finalize() is FinalizationState.FINALIZATION_DONE
    assert ran == ["ec"]
    assert not m.needs_finalization()
    m.check_allowed(ec_feature)
    assert not LayoutVersionManager(tmp_path / "VERSION").needs_finalization()


def test_downgrade_allowed_pre_finalize_refused_after(tmp_path):
    LayoutVersionManager(tmp_path / "VERSION")
    old = LayoutVersionManager(tmp_path / "VERSION", software_version=0)
    assert old.metadata_version == 0
    ec = next(f for f in FEATURES if f.name == "EC_DEVICE_CODEC")
    assert not old.is_allowed(ec)
    again = LayoutVersionManager(tmp_path / "VERSION")
    assert again.metadata_version == again.software_version

    older = LayoutVersionManager(tmp_path / "V2", software_version=1)
    older.metadata_version = 0
    older._persist()
    m = LayoutVersionManager(tmp_path / "V2", software_version=1)
    assert m.needs_finalization()
    assert UpgradeFinalizer(m).finalize() is FinalizationState.FINALIZATION_DONE
    with pytest.raises(RuntimeError, match="post-finalize"):
        LayoutVersionManager(tmp_path / "V2", software_version=0)


def test_catalog_is_the_references():
    """The same features, versions, gated requests and error code."""
    assert [(f.name, f.version) for f in ug.FEATURES] == \
        [(f.name, f.version) for f in ref_ug.FEATURES]
    assert ug.LATEST_VERSION == ref_ug.LATEST_VERSION
    assert {k: v.name for k, v in ug.GATED_OM_REQUESTS.items()} == \
        {k: v.name for k, v in ref_ug.GATED_OM_REQUESTS.items()}
    assert ug.PRE_FINALIZE_ERROR == ref_ug.PRE_FINALIZE_ERROR == PRE


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("stored,software,finalize", [
    (0, None, False), (2, None, True), (None, 3, False), (1, 1, True)])
def test_layout_file_read_across(tmp_path, writer, reader, stored, software,
                                 finalize):
    """Each package reads the other's `layout_version.json`: the same
    versions, finalized marker, clamp and file bytes after a finalize."""
    mods = {"port": ug, "ref": ref_ug}
    path = tmp_path / "layout_version.json"
    w = mods[writer]
    if stored is None:
        w.LayoutVersionManager(path)  # a fresh install's file
    else:
        m = w.LayoutVersionManager(path, software_version=stored)
        if finalize:
            m.metadata_version = 0
            m._persist()
            w.UpgradeFinalizer(m).finalize()
    written = path.read_bytes()

    def view(mod):
        path.write_bytes(written)
        kw = {} if software is None else {"software_version": software}
        try:
            m = mod.LayoutVersionManager(path, **kw)
        except RuntimeError as e:
            return ("refused", "post-finalize" in str(e))
        fin = mod.UpgradeFinalizer(m)
        status = fin.status()
        state = fin.finalize().value
        return (m.metadata_version, m.persisted_version, m.finalized_marker,
                status, state, path.read_bytes())

    assert view(mods[reader]) == view(mods[writer])


# ------------------------------------------ OM and SCM against the reference
def _om_pair(root, pkg_scm, pkg_om, version, port):
    _seed_layout(root, version)
    scm = pkg_scm.StorageContainerManager(db_path=root / "scm.db")
    kw = {"device": "cpu"} if port else {}
    return scm, pkg_om.OzoneManager(root / "om.db", scm, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refusals_and_status_equal_reference(tmp_path, seed):
    """The same seeded request sequence through both packages' OM and
    SCM over an old layout: every refusal code, the upgrade status
    before and after, the finalize answers and the snapshots made after
    it are equal."""
    rng = np.random.default_rng(seed)
    version = int(rng.integers(0, 3))
    names = [f"s{int(x)}" for x in rng.integers(0, 1000, 4)]
    ops = [str(x) for x in rng.choice(
        ["create", "rename", "delete", "status"], 8)]

    def run(port):
        pkg_scm, pkg_om = (port_scm, port_om) if port else (ref_scm, ref_om)
        scm, om = _om_pair(tmp_path / ("port" if port else "ref"), pkg_scm,
                           pkg_om, version, port)
        out = []

        def attempt(fn):
            try:
                fn()
                return "ok"
            except (OMError, RefOMError) as e:
                return e.code

        try:
            om.create_volume("v")
            om.create_bucket("v", "b", EC)
            for phase in range(2):
                for op, name in zip(ops, names * 2):
                    if op == "create":
                        out.append(attempt(
                            lambda: om.create_snapshot("v", "b", name)))
                    elif op == "rename":
                        out.append(attempt(lambda: om.rename_snapshot(
                            "v", "b", name, name + "r")))
                    elif op == "delete":
                        out.append(attempt(
                            lambda: om.delete_snapshot("v", "b", name)))
                    else:
                        out.append(om.upgrade_status())
                out.append(scm.finalizer.status())
                if phase == 0:
                    out.append(scm.apply_admin_op("finalize-upgrade"))
            out.append(sorted(s["name"] for s in
                              om.list_snapshots("v", "b")))
        finally:
            om.close()
            scm.stop()
        return out

    got = run(True)
    assert got == run(False)
    first = got[:len(ops)]
    if version < ug.BUCKET_SNAPSHOTS.version:
        assert all(r == PRE for r in first
                   if isinstance(r, str) and r != "ok")
        assert "ok" not in first


def test_scm_upgrade_status_verb_equals_reference(tmp_path):
    """`admin upgrade` over the wire: the SCM service's `upgrade-status`
    and the heartbeat-reported layout in the node table, port against
    reference, before and after `finalize-upgrade`; and the service's
    Recon census verbs."""
    from ozone_tpu.net import daemons as j_daemons
    from ozone_tpu.net.scm_service import GrpcScmClient

    def run(port):
        root = tmp_path / ("port" if port else "ref")
        _seed_layout(root, 2)
        _seed_layout(root / "dn0", 0)
        kw = {"device": "cpu"} if port else {}
        mod = __import__("ozone_tpu_torch.net.daemons",
                         fromlist=["x"]) if port else j_daemons
        meta = mod.ScmOmDaemon(root / "om.db", stale_after_s=1000.0,
                               dead_after_s=2000.0, **kw)
        meta.start()
        dn = mod.DatanodeDaemon(root / "dn0", "dn0", meta.address,
                                heartbeat_interval_s=0.1, **kw)
        dn.start()
        scm = (RemoteScmClient if port else GrpcScmClient)(meta.address)
        try:
            _wait(lambda: [n["layout_version"] for n in
                           scm.status()["nodes"]] == [0], "a heartbeat")
            before = scm.admin("upgrade-status")
            fin = scm.admin("finalize-upgrade")
            _wait(lambda: [n["layout_version"] for n in
                           scm.status()["nodes"]] == [ug.LATEST_VERSION],
                  "the finalized datanode's heartbeat")
            # Recon's census through the SCM service, on no containers
            return (before, fin, scm.admin("upgrade-status"),
                    scm.admin("replication-status"),
                    scm.admin("container-report"))
        finally:
            scm.close()
            dn.stop()
            meta.stop()

    got = run(True)
    assert got == run(False)
    assert got[0]["needs_finalization"] and not got[2]["needs_finalization"]


# ------------------------------------------------------------- the daemons
def test_finalize_upgrade_propagates_to_datanodes(tmp_path):
    _seed_layout(tmp_path / "dn0", 0)
    _seed_layout(tmp_path, 0)
    meta = _meta(tmp_path)
    dns = _dns(tmp_path, meta, 2)
    scm = RemoteScmClient(meta.address)
    try:
        assert dns[0].layout.metadata_version == 0
        assert dns[0].layout.needs_finalization()
        assert meta.scm.layout.metadata_version == 0
        out = scm.admin("finalize-upgrade")
        assert out["scm"] == "FINALIZATION_DONE"
        assert out["datanodes_notified"] == 2
        _wait(lambda: all(not d.layout.needs_finalization() for d in dns),
              "the datanodes to finalize")
        assert all(d.layout.metadata_version == ug.LATEST_VERSION
                   for d in dns)
        _wait(lambda: all(n.layout_version == ug.LATEST_VERSION
                          for n in meta.scm.nodes.nodes()),
              "the node table")
        assert json.loads((tmp_path / "dn0" / "layout_version.json")
                          .read_text())["layout_version"] == \
            ug.LATEST_VERSION
    finally:
        scm.close()
        for d in dns:
            d.stop()
        meta.stop()


def test_layout_feature_gating_pre_finalize(tmp_path):
    """On new software over old (v2) metadata the snapshot verbs (OM),
    StreamWriteBlock and WriteChunksCommit (datanode RPC), a native
    sidecar write stream and aws-chunked uploads (S3) are refused until
    `finalize-upgrade`; then all of them work."""
    for i in range(5):
        _seed_layout(tmp_path / f"dn{i}", 2)
    _seed_layout(tmp_path, 2)
    meta = _meta(tmp_path, block_size=4 * 4096)
    dns = _dns(tmp_path, meta, 5)
    gw = nat = None
    oz = _client(meta)
    c = RpcDatanodeClient("dn0", dns[0].address)
    scm = RemoteScmClient(meta.address)
    try:
        oz.create_volume("v").create_bucket("b", replication=EC)
        with pytest.raises((OMError, StorageError)) as ei:
            oz.om.create_snapshot("v", "b", "s1")
        assert ei.value.code == PRE
        with pytest.raises((OMError, StorageError)) as ei:
            oz.om.rename_snapshot("v", "b", "s1", "s2")
        assert ei.value.code == PRE

        c.create_container(42, replica_index=1)
        with pytest.raises(StorageError) as se:
            c.stream_write_block(BlockID(42, 1), [b"x" * 100])
        assert se.value.code == PRE
        # the sidecar refuses a native write stream before a byte lands;
        # the single-chunk write downgrades to the RPC's WriteChunk
        nat = NativeDatanodeClient("dn0", dns[0].address)
        before = hostmem.METRICS.counter("layout_downgrades").value
        data = np.arange(4096, dtype=np.uint8)
        cs = Checksum(ChecksumType.CRC32C, 4096).compute(data)
        nat.write_chunk(BlockID(42, 2), ChunkInfo("c0", 0, 4096, cs), data)
        assert nat.layout_downgrades == 1
        assert hostmem.METRICS.counter("layout_downgrades").value == \
            before + 1
        assert dns[0].dn.metrics.counter("native_write_streams").value == 0

        gw = S3Gateway(oz, replication=EC)
        gw.upgrade_cache_ttl_s = 0.0
        gw.start()
        secret = meta.om.get_s3_secret("u1")
        urllib.request.urlopen(urllib.request.Request(
            f"http://{gw.address}/cb", method="PUT"))
        url = f"http://{gw.address}/cb/chunked"
        now = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")

        def chunked_put():
            headers, body = sign_request_streaming(
                "u1", secret, "PUT", url,
                {"host": gw.address, "x-amz-date": now}, b"p" * 50_000,
                chunk_size=16 * 1024)
            return urllib.request.urlopen(urllib.request.Request(
                url, data=body, method="PUT", headers=headers))

        with pytest.raises(urllib.error.HTTPError) as he:
            chunked_put()
        assert he.value.code == 501
        with pytest.raises((OMError, StorageError)):
            oz.om.lookup_key("s3v", "cb", "chunked")

        assert scm.admin("finalize-upgrade")["scm"] == "FINALIZATION_DONE"
        _wait(lambda: all(not d.layout.needs_finalization() for d in dns),
              "the datanodes to finalize")
        oz.om.create_snapshot("v", "b", "s1")
        assert c.stream_write_block(BlockID(42, 1), [b"x" * 100]).length \
            == 100
        nat.write_chunk(BlockID(42, 3), ChunkInfo("c0", 0, 4096, cs), data)
        assert dns[0].dn.metrics.counter("native_write_streams").value == 1
        assert nat.layout_downgrades == 1
        assert chunked_put().status == 200
    finally:
        if gw is not None:
            gw.stop()
        c.close()
        if nat is not None:
            nat.close()
        scm.close()
        oz.clients.close()
        oz.om.close()
        for d in dns:
            d.stop()
        meta.stop()


def test_layout_gating_mixed_version_datanodes(tmp_path):
    for d in ("dn0", "dn1"):
        _seed_layout(tmp_path / d, 2)
    meta = _meta(tmp_path)
    dns = [DatanodeDaemon(tmp_path / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.1, device="cpu")
           for i in range(2)]
    # dn1 runs old software: its manager cannot finalize past v2
    dns[1].layout.software_version = 2
    dns[1].finalizer.manager = dns[1].layout
    for d in dns:
        d.start()
    scm = RemoteScmClient(meta.address)
    try:
        scm.admin("finalize-upgrade")
        _wait(lambda: dns[0].layout.metadata_version == ug.LATEST_VERSION,
              "dn0 to finalize")
        assert dns[1].layout.metadata_version == 2
        for i in (0, 1):
            c = RpcDatanodeClient(f"dn{i}", dns[i].address)
            c.create_container(7 + i, replica_index=1)
            if i == 0:
                assert c.stream_write_block(
                    BlockID(7, 1), [b"y" * 10]).length == 10
            else:
                with pytest.raises(StorageError) as se:
                    c.stream_write_block(BlockID(8, 1), [b"y" * 10])
                assert se.value.code == PRE
            c.close()
    finally:
        scm.close()
        for d in dns:
            d.stop()
        meta.stop()


def test_pre_finalize_datanode_downgrade_drill(tmp_path):
    """Boot at new software, write; restart one datanode at older
    software: it starts clamped (never refuses to start), writes keep
    flowing with that member downgraded to per-chunk verbs (counted for
    it), and re-upgrading restores the recorded version."""
    meta = _meta(tmp_path)
    dns = {d.dn.id: d for d in _dns(tmp_path, meta, 5)}
    oz = _client(meta)
    try:
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        data = np.arange(50_000, dtype=np.uint8) % 251
        b.write_key("before", data)

        old_sw = ug.RATIS_STREAMING_WRITE.version - 1
        dns["dn0"].stop()
        real = ug.LayoutVersionManager

        def older_binary(path, software_version=old_sw):
            return real(path, software_version=old_sw)

        with mock.patch.object(ug, "LayoutVersionManager", older_binary):
            dns["dn0"] = DatanodeDaemon(tmp_path / "dn0", "dn0",
                                        meta.address,
                                        heartbeat_interval_s=0.1,
                                        device="cpu")
        dns["dn0"].start()
        assert dns["dn0"].layout.metadata_version == old_sw
        assert dns["dn0"].layout.persisted_version == ug.LATEST_VERSION
        time.sleep(1.0)  # the re-registration heartbeat
        refused = registry("ec.writer").counter("batch_downgrades")
        before = refused.value
        b.write_key("after-downgrade", data)
        np.testing.assert_array_equal(b.read_key("before"), data)
        np.testing.assert_array_equal(b.read_key("after-downgrade"), data)
        # rs-3-2 on five datanodes: dn0 holds a unit of the key, refused
        # the batched verb, and only it did
        info = oz.om.lookup_key("v", "b", "after-downgrade")
        assert "dn0" in info["block_groups"][0]["nodes"]
        assert refused.value == before + 1

        dns["dn0"].stop()
        dns["dn0"] = DatanodeDaemon(tmp_path / "dn0", "dn0", meta.address,
                                    heartbeat_interval_s=0.1, device="cpu")
        dns["dn0"].start()
        assert dns["dn0"].layout.metadata_version == ug.LATEST_VERSION
        time.sleep(1.0)
        b.write_key("after-reupgrade", data)
        np.testing.assert_array_equal(b.read_key("after-reupgrade"), data)
    finally:
        oz.clients.close()
        oz.om.close()
        for d in dns.values():
            d.stop()
        meta.stop()


def test_layout_gating_across_ha_ring(tmp_path):
    from ozone_tpu_torch.testing.minicluster import (
        await_meta_leader,
        free_ports,
        make_meta_daemon,
    )

    ports = free_ports(3)
    peers = {f"m{i}": f"127.0.0.1:{ports[i]}" for i in range(3)}
    for i in range(3):
        _seed_layout(tmp_path / f"meta{i}", 2)
    metas = {}
    om = scm = None
    try:
        for i in range(3):
            d = make_meta_daemon(tmp_path, i, peers, device="cpu")
            d.start()
            metas[f"m{i}"] = d
        await_meta_leader(metas)
        oms = ",".join(peers.values())
        om = RemoteOmClient(oms)
        om.create_volume("v")
        om.create_bucket("v", "b", EC)
        with pytest.raises((OMError, StorageError)) as ei:
            om.create_snapshot("v", "b", "s1")
        assert ei.value.code == PRE

        scm = RemoteScmClient(oms)
        scm.admin("finalize-upgrade")
        _wait(lambda: all(m.scm.layout.metadata_version == ug.LATEST_VERSION
                          for m in metas.values()), "every replica")
        om.create_snapshot("v", "b", "s1")

        leader = next(m for m in metas.values() if m.ha.is_leader)
        leader.stop()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            try:
                om.create_snapshot("v", "b", "s2")
                break
            except StorageError:
                time.sleep(0.3)
        assert [s["name"] for s in om.list_snapshots("v", "b")] == \
            ["s1", "s2"]
    finally:
        for c in (scm, om):
            if c is not None:
                c.close()
        for m in metas.values():
            try:
                m.stop()
            except Exception:  # noqa: BLE001 - the stopped leader
                pass


def test_gate_refusal_is_audited_unlike_reference(tmp_path):
    """A departure: the port's OM audits its layout gate's refusal as a
    FAILURE record (the audit log holds every refusal before
    finalization); the reference refuses before its audited block and
    writes none."""
    import logging

    records = {}

    class Grab(logging.Handler):
        def emit(self, record):
            records.setdefault(self.side, []).append(
                json.loads(record.getMessage()))

    logger = logging.getLogger("audit.om")
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        for port in (True, False):
            pkg_scm, pkg_om = (port_scm, port_om) if port else (ref_scm, ref_om)
            scm, om = _om_pair(tmp_path / ("port" if port else "ref"),
                               pkg_scm, pkg_om, 2, port)
            h = Grab(level=logging.INFO)
            h.side = "port" if port else "ref"
            logger.addHandler(h)
            try:
                om.create_volume("v")
                om.create_bucket("v", "b", EC)
                with pytest.raises((OMError, RefOMError)) as ei:
                    om.create_snapshot("v", "b", "s1")
                assert ei.value.code == PRE
            finally:
                logger.removeHandler(h)
                om.close()
                scm.stop()
    finally:
        logger.setLevel(old)
    fails = {side: [(r["action"], r.get("error")) for r in recs
                    if r["result"] == "FAILURE"]
             for side, recs in records.items()}
    assert fails == {"port": [("CreateSnapshot", PRE)], "ref": []}
    assert [r["action"] for r in records["port"]
            if r["result"] == "SUCCESS"] == \
        [r["action"] for r in records["ref"]] == ["CreateVolume",
                                                   "CreateBucket"]
