"""Quotas, volume ownership, bucket replication and the upgrade quiesce of
the port against `ozone_tpu`'s, on the CPU.

Each test of `tests/test_quota.py`, and `test_volume_owner_transfer` of
`tests/test_acl_tenant.py`, runs as one script on a port and a reference
`MiniOzoneCluster` (placement_seed=42, the same seeded bytes) or OM; the
usage counters, quota rows and error codes must be equal, and the
reference test's own expectations must hold on the port's answers. The
quota, owner, replication and prepare verbs also run over the port's RPC
and CLI.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import ozone_tpu.om.fso as j_fso
import ozone_tpu.om.requests as j_rq
import ozone_tpu_torch.om.fso as t_fso
import ozone_tpu_torch.om.requests as t_rq
from ozone_tpu.om.om import OzoneManager as JOM
from ozone_tpu.scm.scm import StorageContainerManager as JSCM
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.om.om import OzoneManager as TOM
from ozone_tpu_torch.scm.scm import StorageContainerManager as TSCM
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

EC = "rs-3-2-4096"
REF = types.SimpleNamespace(name="ref", fso=j_fso, rq=j_rq)
PORT = types.SimpleNamespace(name="port", fso=t_fso, rq=t_rq)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def code(fn):
    """The OMError code `fn` raises, or None."""
    try:
        fn()
    except (j_rq.OMError, t_rq.OMError) as e:
        return e.code
    return None


def both(tmp_path, monkeypatch, script):
    """`script(P, cluster)` on each package's MiniOzoneCluster; equal
    answers, the port's returned."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    out = {}
    for P in (REF, PORT):
        kw = dict(num_datanodes=5, block_size=4 * 4096,
                  container_size=1024 * 1024, stale_after_s=1000.0,
                  dead_after_s=2000.0, placement_seed=42)
        root = tmp_path / P.name
        c = (MiniOzoneCluster(root, device="cpu", **kw) if P is PORT
             else JCluster(root, **kw))
        try:
            out[P.name] = script(P, c)
        finally:
            c.close()
    assert out["port"] == out["ref"]
    return out["port"]


def _usage(row):
    return row.get("used_bytes", 0), row.get("key_count", 0)


def test_bucket_space_quota_enforced(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        oz.om.set_quota("v", "b", quota_bytes=10_000)
        b.write_key("ok", _data(8_000))
        err = code(lambda: b.write_key("too-big", _data(5_000, 1)))
        after_refusal = oz.om.bucket_info("v", "b")["used_bytes"]
        b.delete_key("ok")
        b.write_key("fits", _data(5_000, 1))
        return err, after_refusal, oz.om.bucket_info("v", "b")["used_bytes"]

    assert both(tmp_path, monkeypatch, script) == ("QUOTA_EXCEEDED", 8_000,
                                                   5_000)


def test_namespace_quota_enforced(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        oz.om.set_quota("v", "b", quota_namespace=2)
        b.write_key("k1", _data(100))
        b.write_key("k2", _data(100, 1))
        err = code(lambda: b.write_key("k3", _data(100, 2)))
        b.write_key("k2", _data(200, 3))  # an overwrite is no new name
        return err, oz.om.bucket_info("v", "b")["key_count"]

    assert both(tmp_path, monkeypatch, script) == ("QUOTA_EXCEEDED", 2)


def test_volume_quota_spans_buckets(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        vol = oz.create_volume("v")
        b1 = vol.create_bucket("b1", replication=EC)
        b2 = vol.create_bucket("b2", replication=EC)
        oz.om.set_quota("v", quota_bytes=10_000)
        b1.write_key("k", _data(6_000))
        err = code(lambda: b2.write_key("k", _data(6_000, 1)))
        b2.write_key("k", _data(3_000, 1))
        return err, oz.om.volume_info("v")["used_bytes"]

    assert both(tmp_path, monkeypatch, script) == ("QUOTA_EXCEEDED", 9_000)


def test_usage_accounting_overwrite_and_multipart(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k", _data(5_000))
        b.write_key("k", _data(2_000, 1))  # an overwrite shrinks usage
        shrunk = oz.om.bucket_info("v", "b")["used_bytes"]
        mpu = b.initiate_multipart_upload("big")
        mpu.write_part(1, _data(6_000, 2))
        mpu.write_part(2, _data(6_000, 3))
        mpu.complete()
        return shrunk, _usage(oz.om.bucket_info("v", "b"))

    assert both(tmp_path, monkeypatch, script) == (2_000, (14_000, 2))


def test_hsync_stream_charges_incrementally(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b",
                                                replication="RATIS/THREE")
        oz.om.set_quota("v", "b", quota_bytes=30_000)
        h = b.open_key("k")
        h.write(_data(10_000))
        h.hsync()
        seen = [oz.om.bucket_info("v", "b")["used_bytes"]]
        h.write(_data(10_000, 1))
        h.hsync()
        seen.append(oz.om.bucket_info("v", "b")["used_bytes"])
        h.close()
        return seen, _usage(oz.om.bucket_info("v", "b"))

    assert both(tmp_path, monkeypatch, script) == ([10_000, 20_000],
                                                   (20_000, 1))


def test_quota_repair_recomputes_from_tables(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k1", _data(4_000))
        b.write_key("k2", _data(6_000, 1))
        oz.om.set_quota("v", "b")  # a no-op write keeps the row's shape
        store = c.om.store
        row = store.get("buckets", "/v/b")
        row["used_bytes"] = 999_999  # drift
        store.put("buckets", "/v/b", row)
        out = oz.om.repair_quota("v")
        return (out["buckets"]["/v/b"],
                oz.om.bucket_info("v", "b")["used_bytes"],
                oz.om.volume_info("v")["used_bytes"])

    assert both(tmp_path, monkeypatch, script) == (
        {"used_bytes": 10_000, "key_count": 2}, 10_000, 10_000)


def test_fso_files_count_against_quota(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        oz.create_volume("v")
        oz.om.create_bucket("v", "fso", "RATIS/THREE",
                            "FILE_SYSTEM_OPTIMIZED")
        b = oz.get_volume("v").get_bucket("fso")
        oz.om.set_quota("v", "fso", quota_bytes=5_000)
        b.write_key("d/f1", _data(3_000))
        err = code(lambda: b.write_key("d/f2", _data(3_000, 1)))
        used = oz.om.bucket_info("v", "fso")["used_bytes"]
        oz.om.delete_directory("v", "fso", "d", recursive=True)
        P.fso.DirectoryDeletingService(c.om).run_to_completion()
        return err, used, _usage(oz.om.bucket_info("v", "fso"))

    assert both(tmp_path, monkeypatch, script) == ("QUOTA_EXCEEDED", 3_000,
                                                   (0, 0))


def test_setquota_preserves_other_dimension(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication=EC)
        oz.om.set_quota("v", "b", quota_namespace=7)
        oz.om.set_quota("v", "b", quota_bytes=1_000)
        i1 = oz.om.bucket_info("v", "b")
        oz.om.set_quota("v", "b", quota_namespace=-1)  # an explicit clear
        i2 = oz.om.bucket_info("v", "b")
        return [(i["quota_namespace"], i["quota_bytes"]) for i in (i1, i2)]

    assert both(tmp_path, monkeypatch, script) == [(7, 1_000), (-1, 1_000)]


def test_volume_namespace_quota_enforced(tmp_path, monkeypatch):
    def script(P, c):
        oz = c.client()
        vol = oz.create_volume("v")
        b1 = vol.create_bucket("b1", replication=EC)
        b2 = vol.create_bucket("b2", replication=EC)
        oz.om.set_quota("v", quota_namespace=2)
        b1.write_key("k1", _data(100))
        b2.write_key("k2", _data(100, 1))
        err = code(lambda: b1.write_key("k3", _data(100, 2)))
        return err, oz.om.volume_info("v")["key_count"]

    assert both(tmp_path, monkeypatch, script) == ("QUOTA_EXCEEDED", 2)


def test_mpu_complete_quota_failure_leaves_upload_retryable(tmp_path,
                                                           monkeypatch):
    data = _data(8_000, 9)

    def script(P, c):
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        oz.om.set_quota("v", "b", quota_bytes=5_000)
        mpu = b.initiate_multipart_upload("big")
        mpu.write_part(1, data[:4_000])
        mpu.write_part(2, data[4_000:])
        err = code(mpu.complete)
        oz.om.set_quota("v", "b", quota_bytes=-1)
        mpu.complete()
        return err, np.array_equal(b.read_key("big"), data)

    assert both(tmp_path, monkeypatch, script) == ("QUOTA_EXCEEDED", True)


def test_volume_owner_transfer(tmp_path):
    """`sh volume update --user`: the owner or a superuser transfers;
    anyone else is refused once ACLs are on."""
    out = {}
    for name, OM, SCM in (("ref", JOM, JSCM), ("port", TOM, TSCM)):
        scm = SCM(stale_after_s=1e6, dead_after_s=2e6)
        om = OM(tmp_path / name / "om.db", scm)
        om.create_volume("v1", owner="owner1")
        try:
            seen = [om.set_volume_owner("v1", "owner2")["owner"]]
            om.enable_acls(superusers=("root",))
            with om.user_context("mallory"):
                seen.append(code(lambda: om.set_volume_owner("v1",
                                                             "mallory")))
            with om.user_context("owner2"):
                seen.append(om.set_volume_owner("v1", "owner3")["owner"])
            with om.user_context("root"):
                seen.append(om.set_volume_owner("v1", "owner4")["owner"])
            seen.append(om.volume_info("v1")["owner"])
            seen.append(code(lambda: om.set_volume_owner("v1", "")))
            out[name] = seen
        finally:
            om.close()
    assert out["port"] == out["ref"] == [
        "owner2", "PERMISSION_DENIED", "owner3", "owner4", "owner4",
        "INVALID_REQUEST"]


def test_bucket_replication_and_prepare_verbs(tmp_path):
    """SetBucketReplication changes the default of later keys only; a bad
    scheme is refused; prepare refuses writes until cancelprepare."""
    out = {}
    for name, OM, SCM in (("ref", JOM, JSCM), ("port", TOM, TSCM)):
        scm = SCM(stale_after_s=1e6, dead_after_s=2e6)
        om = OM(tmp_path / name / "om.db", scm)
        try:
            om.create_volume("v")
            om.create_bucket("v", "b", EC)
            seen = [om.set_bucket_replication("v", "b",
                                              "rs-6-3-1024k")["replication"]]
            try:
                om.set_bucket_replication("v", "b", "nonsense")
                seen.append(None)
            except Exception as e:  # noqa: BLE001 - each package's parser
                seen.append(type(e).__name__)
            om.prepare()
            seen.append(om.prepared)
            seen.append(code(lambda: om.create_volume("w")))
            om.cancel_prepare()
            om.create_volume("w")
            seen.append(om.prepared)
            out[name] = seen
        finally:
            om.close()
    assert out["port"] == out["ref"]
    assert out["port"][0] == "rs-6-3-1024k" and out["port"][2:] == [
        True, "OM_PREPARED", False]


def _cli(*args, timeout=60):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-m", "ozone_tpu_torch.tools",
                        *args], capture_output=True, text=True, env=env,
                       timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def test_quota_owner_prepare_over_rpc_and_cli(tmp_path):
    """The quota, owner, replication and quiesce verbs over the port's
    RPC, as CLI processes against a metadata daemon."""
    from ozone_tpu_torch.net.daemons import ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    meta = ScmOmDaemon(tmp_path / "om.db", stale_after_s=1000.0,
                       dead_after_s=2000.0, device="cpu")
    meta.start()
    om = RemoteOmClient(meta.address)
    try:
        a = ("--om", meta.address)
        assert _cli("sh", "volume", "create", "/v", *a)[0] == 0
        assert _cli("sh", "bucket", "create", "/v/b", "--replication", EC,
                    *a)[0] == 0
        rc, out, _ = _cli("sh", "bucket", "setquota", "/v/b", "--quota",
                          "10KB", "--namespace-quota", "3", *a)
        assert rc == 0 and json.loads(out)["quota_bytes"] == 10 * 1024
        assert om.bucket_info("v", "b")["quota_namespace"] == 3
        rc, out, _ = _cli("sh", "volume", "setquota", "/v", "--quota",
                          "clear", *a)
        assert rc == 0 and json.loads(out)["quota_bytes"] == -1
        rc, out, _ = _cli("sh", "volume", "update", "/v", "--user", "alice",
                          *a)
        assert rc == 0 and om.volume_info("v")["owner"] == "alice"
        rc, out, _ = _cli("sh", "bucket", "set-replication", "/v/b",
                          "--replication", "rs-6-3-1024k", *a)
        assert rc == 0 and json.loads(out)["replication"] == "rs-6-3-1024k"
        assert om.repair_quota("v")["volume_key_count"] == 0
        rc, out, _ = _cli("admin", "om", "prepare", *a)
        assert rc == 0 and om.prepare_status() == {"prepared": True}
        rc, _, err = _cli("sh", "volume", "create", "/w", *a)
        assert rc == 1 and "OM_PREPARED" in err
        assert _cli("admin", "om", "cancelprepare", *a)[0] == 0
        rc, out, _ = _cli("admin", "om", "status", *a)
        assert rc == 0 and json.loads(out) == {"prepared": False}
        assert _cli("sh", "volume", "create", "/w", *a)[0] == 0
    finally:
        om.close()
        meta.stop()
