"""The port's hsync and lease recovery against `ozone_tpu`'s, on the CPU.

Each test of `tests/test_hsync.py` runs as one script on a port
`MiniOzoneCluster` (device="cpu") and a JAX one with the same seeded
bytes: the synced lengths a second reader sees, the bytes, the error
codes (the stale writer's refusal, EC's NOT_SUPPORTED_OPERATION), the
deleted-key and open-key tables and the open-files listing must be
equal, and the reference test's expectations must hold on the port.
"""

import types

import numpy as np
import pytest
import torch

import ozone_tpu.gateway.fs as j_fs
import ozone_tpu.om.requests as j_rq
import ozone_tpu_torch.gateway.fs as t_fs
import ozone_tpu_torch.om.requests as t_rq
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.om.om import OzoneManager
from ozone_tpu_torch.scm.scm import StorageContainerManager
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

EC = "rs-3-2-4096"
RATIS = "RATIS/THREE"
REF = types.SimpleNamespace(fs=j_fs, name="ref")
PORT = types.SimpleNamespace(fs=t_fs, name="port")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(tmp_path, monkeypatch, script):
    """Run `script(cluster, oz, P)` on each package; equal answers."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    kw = dict(num_datanodes=5, block_size=4 * 4096,
              container_size=1024 * 1024, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    out = {}
    for P in (REF, PORT):
        root = tmp_path / P.name
        c = (MiniOzoneCluster(root, device="cpu", **kw) if P is PORT
             else JCluster(root, **kw))
        try:
            out[P.name] = script(c, c.client(), P)
        finally:
            c.close()
    assert out["port"] == out["ref"]
    return out["port"]


def code(fn):
    """The error code `fn` raises (either package's OMError or
    StorageError), or None."""
    try:
        fn()
    except (j_rq.OMError, t_rq.OMError, JStorageError, StorageError) as e:
        return e.code
    return None


def _bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _bucket(oz, repl=RATIS):
    return oz.create_volume("v").create_bucket("b", replication=repl)


def test_hsync_visible_at_synced_length_then_final_commit(tmp_path,
                                                          monkeypatch):
    data = _bytes(40_000)

    def script(c, oz, P):
        b = _bucket(oz)
        h = b.open_key("k")
        h.write(data[:25_000])
        h.hsync()
        synced = b.read_key("k").tobytes()
        h.write(data[25_000:])
        h.close()
        return synced, b.read_key("k").tobytes()

    synced, final = both(tmp_path, monkeypatch, script)
    assert synced == data[:25_000].tobytes() and final == data.tobytes()


def test_repeated_hsync_does_not_purge_live_blocks(tmp_path, monkeypatch):
    data = _bytes(60_000, seed=1)

    def script(c, oz, P):
        b = _bucket(oz)
        h = b.open_key("k")
        seen = []
        for i in range(3):
            h.write(data[i * 20_000:(i + 1) * 20_000])
            h.hsync()
            seen.append(b.read_key("k").tobytes())
        h.close()
        return (seen, b.read_key("k").tobytes(),
                list(c.om.store.iterate("deleted_keys")),
                list(c.om.store.iterate("open_keys")))

    seen, final, deleted, open_keys = both(tmp_path, monkeypatch, script)
    assert seen == [data[:(i + 1) * 20_000].tobytes() for i in range(3)]
    assert final == data.tobytes() and deleted == [] and open_keys == []


def test_hsync_overwrite_enqueues_old_version_once(tmp_path, monkeypatch):
    def script(c, oz, P):
        b = _bucket(oz)
        b.write_key("k", _bytes(10_000, seed=2))
        h = b.open_key("k")
        h.write(_bytes(5_000, seed=3))
        h.hsync()
        h.hsync()
        h.close()
        return len(list(c.om.store.iterate("deleted_keys")))

    assert both(tmp_path, monkeypatch, script) == 1


def test_ec_key_rejects_hsync(tmp_path, monkeypatch):
    def script(c, oz, P):
        b = _bucket(oz, EC)
        h = b.open_key("k")
        h.write(_bytes(1_000, seed=4))
        got = code(h.hsync)
        h.close()
        return got, b.read_key("k").tobytes()

    got, data = both(tmp_path, monkeypatch, script)
    assert got == "NOT_SUPPORTED_OPERATION"
    assert data == _bytes(1_000, seed=4).tobytes()


def test_recover_lease_seals_abandoned_write_and_fences_writer(tmp_path,
                                                               monkeypatch):
    data = _bytes(30_000, seed=5)

    def script(c, oz, P):
        b = _bucket(oz)
        h = b.open_key("k")
        h.write(data[:18_000])
        h.hsync()
        out = oz.om.recover_lease("v", "b", "k")
        info = oz.om.lookup_key("v", "b", "k")
        sealed = b.read_key("k").tobytes()
        h.write(data[18_000:])
        return (out["recovered"], "hsync_client_id" in info, sealed,
                code(h.close), b.read_key("k").tobytes())

    rec, has_lease, sealed, fenced, after = both(tmp_path, monkeypatch,
                                                 script)
    assert rec is True and not has_lease and fenced == "KEY_NOT_FOUND"
    assert sealed == after == data[:18_000].tobytes()


def test_recover_lease_discards_never_hsynced_session(tmp_path, monkeypatch):
    def script(c, oz, P):
        b = _bucket(oz)
        h = b.open_key("k")
        h.write(_bytes(9_000, seed=6))
        out = oz.om.recover_lease("v", "b", "k")
        return (out, code(lambda: oz.om.lookup_key("v", "b", "k")),
                code(lambda: oz.om.recover_lease("v", "b", "nope")))

    assert both(tmp_path, monkeypatch, script) == (
        {"recovered": False, "key": None}, "KEY_NOT_FOUND", "KEY_NOT_FOUND")


def test_hsync_and_recover_lease_on_fso_bucket(tmp_path, monkeypatch):
    data = _bytes(22_000, seed=7)

    def script(c, oz, P):
        oz.create_volume("v")
        oz.om.create_bucket("v", "fso", RATIS, "FILE_SYSTEM_OPTIMIZED")
        b = oz.get_volume("v").get_bucket("fso")
        h = b.open_key("dir/sub/f")
        h.write(data[:12_000])
        h.hsync()
        synced = b.read_key("dir/sub/f").tobytes()
        listed = [(e["key"], e["hsync"]) for e in
                  oz.om.list_open_files("v", "fso")["open_files"]]
        out = oz.om.recover_lease("v", "fso", "dir/sub/f")
        sealed = b.read_key("dir/sub/f").tobytes()
        h.write(data[12_000:])
        return synced, listed, out["recovered"], sealed, code(h.close)

    synced, listed, rec, sealed, fenced = both(tmp_path, monkeypatch, script)
    assert synced == sealed == data[:12_000].tobytes()
    assert listed == [("dir/sub/f", True)] and rec is True
    assert fenced == "KEY_NOT_FOUND"


def test_cleanup_service_seals_expired_hsynced_sessions(tmp_path,
                                                        monkeypatch):
    data = _bytes(8_000, seed=8)

    def script(c, oz, P):
        b = _bucket(oz)
        h = b.open_key("k")
        h.write(data)
        h.hsync()
        n = c.om.run_open_key_cleanup_once(max_age_s=0.0)
        info = oz.om.lookup_key("v", "b", "k")
        return (n, "hsync_client_id" in info, b.read_key("k").tobytes(),
                list(c.om.store.iterate("open_keys")))

    assert both(tmp_path, monkeypatch, script) == (1, False, data.tobytes(),
                                                   [])


def test_fs_adapter_recover_lease(tmp_path, monkeypatch):
    def script(c, oz, P):
        oz.create_volume("v")
        oz.om.create_bucket("v", "fso", RATIS, "FILE_SYSTEM_OPTIMIZED")
        b = oz.get_volume("v").get_bucket("fso")
        fs = P.fs.OzoneFileSystem(b)
        h = b.open_key("d/f")
        h.write(_bytes(5_000, seed=9))
        h.hsync()
        return fs.recover_lease("/d/f")

    assert both(tmp_path, monkeypatch, script) is True


def test_delete_of_hsynced_key_fences_the_writer(tmp_path, monkeypatch):
    def script(c, oz, P):
        b = _bucket(oz)
        data = _bytes(12_000, seed=10)
        h = b.open_key("k")
        h.write(data)
        h.hsync()
        b.delete_key("k")
        h.write(data)
        return code(h.close), code(lambda: oz.om.lookup_key("v", "b", "k"))

    assert both(tmp_path, monkeypatch, script) == ("KEY_NOT_FOUND",
                                                   "KEY_NOT_FOUND")


def test_overwrite_of_hsynced_key_fences_the_stale_writer(tmp_path,
                                                          monkeypatch):
    fresh = _bytes(4_000, seed=12)

    def script(c, oz, P):
        b = _bucket(oz)
        stale = b.open_key("k")
        stale.write(_bytes(6_000, seed=11))
        stale.hsync()
        b.write_key("k", fresh)
        stale.write(_bytes(1_000, seed=13))
        return code(stale.close), b.read_key("k").tobytes()

    assert both(tmp_path, monkeypatch, script) == ("KEY_NOT_FOUND",
                                                   fresh.tobytes())


def test_recover_lease_ignores_slash_extended_neighbors(tmp_path,
                                                        monkeypatch):
    def script(c, oz, P):
        b = _bucket(oz)
        neighbor = b.open_key("logs/part-1")
        neighbor.write(_bytes(3_000, seed=14))
        target = b.open_key("logs")
        target.write(_bytes(2_000, seed=15))
        target.hsync()
        rec = oz.om.recover_lease("v", "b", "logs")["recovered"]
        neighbor.close()
        return rec, b.read_key("logs/part-1").size

    assert both(tmp_path, monkeypatch, script) == (True, 3_000)


def test_cleanup_spares_actively_syncing_writer(tmp_path, monkeypatch):
    def script(c, oz, P):
        b = _bucket(oz)
        h = b.open_key("k")
        h.write(_bytes(2_000, seed=16))
        h.hsync()
        n = c.om.run_open_key_cleanup_once(max_age_s=3600.0)
        h.write(_bytes(2_000, seed=17))
        h.hsync()
        h.close()
        return n, b.read_key("k").size

    assert both(tmp_path, monkeypatch, script) == (0, 4_000)


def test_list_open_files_pages_and_reflects_lease_state(tmp_path,
                                                        monkeypatch):
    def script(c, oz, P):
        b = _bucket(oz)
        om = c.om
        handles = [b.open_key(f"open{i}") for i in range(5)]
        handles[0].write(_bytes(3000))
        handles[0].hsync()
        out = om.list_open_files("v", "b")
        by_key = {e["key"]: (e["hsync"], e["size"])
                  for e in out["open_files"]}
        page1 = om.list_open_files("v", "b", limit=3)
        page2 = om.list_open_files("v", "b", limit=3,
                                   start_after=page1["continuation"])
        pages = [(len(p["open_files"]), p["truncated"])
                 for p in (page1, page2)]
        stitched = len({e["open_key"] for e in
                        page1["open_files"] + page2["open_files"]})
        n_prefix = len(om.list_open_files("v", "b",
                                          prefix="open1")["open_files"])
        handles[1].close()
        om.recover_lease("v", "b", "open0")
        names = sorted(e["key"] for e in
                       om.list_open_files("v", "b")["open_files"])
        for h in handles[2:]:
            h.close()
        return (out["truncated"], by_key, pages, stitched, n_prefix, names,
                om.list_open_files("v", "b")["open_files"],
                code(lambda: om.list_open_files("v", "b", limit=0)))

    (trunc, by_key, pages, stitched, n_prefix, names, empty,
     refused) = both(tmp_path, monkeypatch, script)
    assert not trunc and set(by_key) == {f"open{i}" for i in range(5)}
    assert by_key["open0"] == (True, 3000) and by_key["open1"][0] is False
    assert pages == [(3, True), (2, False)] and stitched == 5
    assert n_prefix == 1 and names == ["open2", "open3", "open4"]
    assert empty == [] and refused == "INVALID_REQUEST"


def test_list_open_files_excludes_snapshot_metadata(tmp_path, monkeypatch):
    """Snapshot chain rows ride the open_keys table but are not open
    files: the port's OM opens a store the reference wrote with a
    snapshot and lists no open file, as the reference does."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    ref = JCluster(tmp_path / "ref", num_datanodes=5, block_size=4 * 4096,
                   container_size=1024 * 1024, stale_after_s=1000.0,
                   dead_after_s=2000.0)
    oz = ref.client()
    oz.create_volume("vs").create_bucket("bs", replication=RATIS).write_key(
        "k1", _bytes(1000))
    ref.om.create_snapshot("vs", "bs", "snap1")
    want = ref.om.list_open_files()
    assert any(k.startswith("/.snapmeta/")
               for k, _ in ref.om.store.iterate("open_keys"))
    ref.close()
    om = OzoneManager(tmp_path / "ref" / "om" / "om.db",
                      StorageContainerManager(placement_seed=42),
                      device="cpu")
    try:
        assert om.list_open_files() == want
        assert want["open_files"] == []
        assert om.run_open_key_cleanup_once(max_age_s=0.0) == 0
    finally:
        om.close()


@pytest.mark.parametrize("limit", [0, -1])
def test_list_open_files_rejects_nonpositive_limit(tmp_path, monkeypatch,
                                                   limit):
    def script(c, oz, P):
        return code(lambda: c.om.list_open_files("v", "b", limit=limit))

    assert both(tmp_path, monkeypatch, script) == "INVALID_REQUEST"
