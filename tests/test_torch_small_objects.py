"""The port's small-object path against `ozone_tpu`'s, on the CPU.

Mirrors tests/test_small_objects.py case for case where the case needs
neither the filesystem layout's tables nor a metadata ring (the sharded
commit and the follower reads wait for those ports): routing at the
inline and needle thresholds, byte-exact reads of all three paths,
coalescing of concurrent PUTs into shared slabs, the crash drills, the
needle CRC gate, `CommitKeys` (all-or-nothing quota, last-wins
duplicates, the skipped-key fence), compaction with the old slab's
release, the per-key replication check, the FSO refusal and a seeded
churn. A port `MiniOzoneCluster(device="cpu")` and a JAX one, both
seeded, run each case; where the outcome is deterministic (not the
packer's timing) the key rows, slab rows, `CommitKeys` answers,
compaction stats and error codes must be equal. Beyond the reference's
tests: the packer's `SERVER_BUSY` refusal at its queue bound, and freon
`tinyg` with and without the packer.

The codec service is off and torch runs one thread, as in the port's
other cluster tests: the suite's timing-sensitive tests share the cores.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ozone_tpu import admission as j_admission
from ozone_tpu.client import slab as j_slab
from ozone_tpu.codec import service as j_service
from ozone_tpu.om import requests as j_rq
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu.tools import freon as j_freon
from ozone_tpu_torch import admission
from ozone_tpu_torch.client import slab
from ozone_tpu_torch.codec import service
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.om.metadata import key_key
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
from ozone_tpu_torch.tools import freon

EC = "rs-3-2-4096"
KW = dict(num_datanodes=5, stale_after_s=1000.0, dead_after_s=2000.0,
          placement_seed=42)
#: a key row's fields that differ between runs by design
_VOLATILE = ("object_id", "created", "modified")


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    monkeypatch.setenv("OZONE_TPU_MESH", "0")
    service.reset_for_tests()
    j_service.reset_for_tests()
    admission.reset_for_tests()
    j_admission.reset_for_tests()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    service.reset_for_tests()
    j_service.reset_for_tests()


@pytest.fixture
def clusters(tmp_path):
    port = MiniOzoneCluster(tmp_path / "port", device="cpu", **KW)
    ref = JCluster(tmp_path / "ref", **KW)
    yield port, ref
    port.close()
    ref.close()


def _is_port(c) -> bool:
    return isinstance(c, MiniOzoneCluster)


def _rq(c):
    return rq if _is_port(c) else j_rq


def _bucket(c):
    """A fresh client's handle of an EC bucket opted into small objects."""
    oz = c.client()
    oz.create_volume("v")
    b = oz.get_volume("v").create_bucket("b", replication=EC)
    c.om.set_bucket_smallobj("v", "b")
    return b


def _payload(size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8)


def code(fn):
    try:
        fn()
    except (rq.OMError, j_rq.OMError, StorageError, JStorageError) as e:
        return e.code
    return None


def _parallel_put(bucket, items):
    """Concurrent write_key calls; returns {key: exception}."""
    errs: dict = {}

    def one(k, v):
        try:
            bucket.write_key(k, v)
        except Exception as e:  # noqa: BLE001 - collected for asserts
            errs[k] = e

    ts = [threading.Thread(target=one, args=(k, v)) for k, v in items]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return errs


def _row(info: dict, slab_ids: dict) -> dict:
    """A key row without its run-dependent fields; slab ids renamed by
    first appearance; pipeline ids (process-wide counters) dropped."""
    row = {k: v for k, v in info.items() if k not in _VOLATILE}
    if row.get("needle"):
        nd = dict(row["needle"])
        nd["slab"] = slab_ids.setdefault(nd["slab"], f"slab{len(slab_ids)}")
        row["needle"] = nd
    row["block_groups"] = [{k: v for k, v in g.items() if k != "pipeline_id"}
                           for g in info.get("block_groups", [])]
    return row


def _slab_row(srow: dict, slab_ids: dict, offsets: bool = True) -> dict:
    """A slab row without its run-dependent fields; `offsets=False` also
    drops the needles' offsets (the packer's queue order is the threads'
    arrival order)."""
    drop = ("oid",) if offsets else ("oid", "off")
    row = {k: v for k, v in srow.items() if k not in ("slab_id", "created")}
    row["slab"] = slab_ids.setdefault(srow["slab_id"],
                                      f"slab{len(slab_ids)}")
    row["needles"] = {k: {f: x for f, x in n.items() if f not in drop}
                      for k, n in srow["needles"].items()}
    row["block_groups"] = [{k: v for k, v in g.items() if k != "pipeline_id"}
                           for g in srow["block_groups"]]
    return row


def _stored(c, names) -> list:
    """Each key's normalized row (as lookup_key answers it) and bytes,
    and the slab rows of the bucket."""
    ids: dict = {}
    b = c.client().get_volume("v").get_bucket("b")
    keys = [(_row(c.om.lookup_key("v", "b", k), ids),
             b.read_key(k).tobytes()) for k in names]
    slabs = sorted((_slab_row(s, ids) for s in c.om.list_slabs("v", "b")),
                   key=lambda r: r["slab"])
    return keys, slabs


# ------------------------------------------------------ threshold routing
def test_threshold_routing_three_paths_byte_exact(clusters):
    cases = {
        "tiny": _payload(2_000, 1),       # <= inline_max (4096)
        "small": _payload(20_000, 2),     # <= needle_max (256 KiB)
        "big": _payload(500_000, 3),      # the stripe path
        "edge-inline": _payload(4096, 4),
        "edge-needle": _payload(4097, 5),
        "edge-big": _payload(256 * 1024 + 1, 6),
    }
    out = []
    for c in clusters:
        b = _bucket(c)
        for k, v in cases.items():
            b.write_key(k, v)
        # an explicit per-key replication opts out of the tiny-key path
        b.write_key("forced", cases["tiny"], EC)
        om = c.om
        kinds = {}
        for k in list(cases) + ["forced"]:
            info = om.lookup_key("v", "b", k)
            kinds[k] = ("inline" if info.get("inline") is not None
                        else "needle" if info.get("needle") else "stripe")
        for k, v in cases.items():
            np.testing.assert_array_equal(b.read_key(k), v)
            np.testing.assert_array_equal(
                b.read_key_range(k, 100, 1000), v[100:1100])
        out.append((kinds, _stored(c, list(cases) + ["forced"])))
    assert out[0] == out[1]
    assert out[0][0] == {"tiny": "inline", "small": "needle",
                         "big": "stripe", "edge-inline": "inline",
                         "edge-needle": "needle", "edge-big": "stripe",
                         "forced": "stripe"}


def test_inline_size_served_from_om_and_size_gate(clusters):
    out = []
    for c in clusters:
        b = _bucket(c)
        b.write_key("k", _payload(1_000, 7))
        info = c.om.lookup_key("v", "b", "k")
        # the leader gates inline bloat: an oversized inline PUT is a
        # typed refusal
        huge = code(lambda: c.om.put_inline_key(
            "v", "b", "huge", _payload(64 * 1024, 8).tobytes()))
        c.om.create_bucket("v", "plain", replication=EC)
        plain = code(lambda: c.om.put_inline_key("v", "plain", "k", b"x"))
        out.append((_row(info, {}), huge, plain))
    assert out[0] == out[1]
    assert out[0][1:] == (rq.INVALID_REQUEST, rq.SMALLOBJ_NOT_SUPPORTED)


def test_smallobj_opt_in_out_and_thresholds(clusters):
    out = []
    for c in clusters:
        om = c.om
        om.create_volume("v")
        om.create_bucket("v", "b", replication=EC)
        rows = [om.set_bucket_smallobj("v", "b", inline_max=100,
                                       needle_max=1000)["smallobj"]]
        bad = code(lambda: om.set_bucket_smallobj(
            "v", "b", inline_max=2000, needle_max=1000))
        rows.append(om.smallobj_conf(om.bucket_info("v", "b")))
        rows.append(om.set_bucket_smallobj("v", "b").get("smallobj"))
        rows.append(om.smallobj_conf(om.bucket_info("v", "b")))
        off = om.set_bucket_smallobj("v", "b", enabled=False)
        missing = code(lambda: om.set_bucket_smallobj("v", "nob"))
        out.append((rows, bad, "smallobj" in off, missing))
    assert out[0] == out[1]
    assert out[0][1:] == (rq.INVALID_REQUEST, False, rq.BUCKET_NOT_FOUND)


# ------------------------------------------------------------ coalescing
def test_concurrent_puts_coalesce_into_shared_slabs(clusters, monkeypatch):
    monkeypatch.setenv("OZONE_TPU_SLAB_LINGER_MS", "100")
    n = 16
    items = [(f"n-{i}", _payload(12_000, 10 + i)) for i in range(n)]
    for c, mod in zip(clusters, (slab, j_slab)):
        b = _bucket(c)
        batches0 = mod.METRICS.counter("commit_batches").value
        assert _parallel_put(b, items) == {}
        slabs = {c.om.lookup_key("v", "b", k)["needle"]["slab"]
                 for k, _ in items}
        assert len(slabs) <= n // 4, \
            f"{n} concurrent tiny PUTs used {len(slabs)} slabs"
        # one CommitKeys per slab, not per key
        assert mod.METRICS.counter("commit_batches").value - batches0 \
            == len(slabs)
        for k, v in items:
            np.testing.assert_array_equal(b.read_key(k), v)


def _fill_then_flush(c, b, items) -> None:
    """Enqueue every item on the bucket's client packer (a linger long
    enough that nothing flushes on its own), then flush from here: one
    slab of exactly these needles, whatever the threads' timing."""
    packer = b.client.packer
    ts = [threading.Thread(target=b.write_key, args=(k, v))
          for k, v in items]
    for t in ts:
        t.start()
    t_end = time.monotonic() + 20
    while packer._pending < len(items):
        assert time.monotonic() < t_end, "needles never queued"
        time.sleep(0.01)
    packer.flush()
    for t in ts:
        t.join()


def test_compaction_rewrites_survivors_and_releases_blocks(
        clusters, monkeypatch):
    monkeypatch.setenv("OZONE_TPU_SLAB_LINGER_MS", "60000")
    items = [(f"c-{i}", _payload(11_000, 90 + i)) for i in range(10)]
    out = []
    for c in clusters:
        om = c.om
        b = _bucket(c)
        _fill_then_flush(c, b, items)
        slabs0 = {om.lookup_key("v", "b", k)["needle"]["slab"]
                  for k, _ in items}
        assert len(slabs0) == 1
        before = [_slab_row(s, {}, offsets=False)
                  for s in om.list_slabs("v", "b")]
        for k, _ in items[:6]:
            b.delete_key(k)
        # the purge pass books the dead needles' bytes on the slab row;
        # the shared blocks are not handed to the SCM
        om.run_key_deleting_service_once()
        dead = [(s["dead_count"], s["dead_bytes"])
                for s in om.list_slabs("v", "b")]
        pending0 = c.scm.deleted_blocks.pending_count()
        monkeypatch.setenv("OZONE_TPU_SLAB_DEAD_RATIO", "0.5")
        stats = om.run_slab_compaction_once()
        for k, v in items[6:]:
            info = om.lookup_key("v", "b", k)
            assert info["needle"]["slab"] not in slabs0
            np.testing.assert_array_equal(b.read_key(k), v)
        retired = [code(lambda sid=sid: om.slab_info("v", "b", sid))
                   for sid in slabs0]
        gone = [code(lambda k=k: om.lookup_key("v", "b", k))
                for k, _ in items[:6]]
        released = c.scm.deleted_blocks.pending_count() - pending0
        again = om.run_slab_compaction_once()  # nothing left past the ratio
        out.append((before, dead, stats, retired, gone, released, again,
                    _stored(c, [k for k, _ in items[6:]])))
    assert out[0] == out[1]
    stats = out[0][2]
    assert stats["compacted"] == 1 and stats["needles_rewritten"] == 4
    assert stats["blocks_released"] >= 1 and stats["conflicts"] == 0
    assert out[0][1] == [(6, 6 * 11_000)]
    assert out[0][3] == [rq.KEY_NOT_FOUND] and out[0][4] == \
        [rq.KEY_NOT_FOUND] * 6


def test_compaction_fence_loses_to_a_user_overwrite(clusters, monkeypatch):
    """A survivor overwritten between the compaction's read and its
    commit is skipped (a conflict), and the user's bytes stay."""
    monkeypatch.setenv("OZONE_TPU_SLAB_LINGER_MS", "60000")
    monkeypatch.setenv("OZONE_TPU_SLAB_DEAD_RATIO", "0.3")
    items = [(f"f-{i}", _payload(9_000, 200 + i)) for i in range(4)]
    newer = _payload(2_000, 999)
    out = []
    for c in clusters:
        om = c.om
        b = _bucket(c)
        _fill_then_flush(c, b, items)
        b.delete_key("f-0")
        b.delete_key("f-1")
        om.run_key_deleting_service_once()
        mod = slab if _is_port(c) else j_slab
        real = mod.SlabPacker._write_and_commit_fenced

        def racing(self, q, fences, real=real, b=b):
            # the user's overwrite lands (inline) after the compaction
            # read the survivors and before its commit
            b.write_key("f-3", newer)
            return real(self, q, fences)

        monkeypatch.setattr(mod.SlabPacker, "_write_and_commit_fenced",
                            racing)
        stats = om.run_slab_compaction_once()
        monkeypatch.setattr(mod.SlabPacker, "_write_and_commit_fenced", real)
        np.testing.assert_array_equal(b.read_key("f-3"), newer)
        np.testing.assert_array_equal(b.read_key("f-2"), items[2][1])
        out.append((stats, _stored(c, ["f-2", "f-3"])))
    assert out[0] == out[1]
    assert out[0][0]["conflicts"] == 1 and out[0][0]["needles_rewritten"] == 1


# ------------------------------------------------------------ crash drills
def test_acked_keys_survive_packer_crash(clusters):
    items = [(f"a-{i}", _payload(9_000, 40 + i)) for i in range(8)]
    for c in clusters:
        b = _bucket(c)
        assert _parallel_put(b, items) == {}
        # "kill -9": abandon the client and its packer; a fresh client
        # reads every acknowledged key
        fresh = c.client().get_volume("v").get_bucket("b")
        for k, v in items:
            np.testing.assert_array_equal(fresh.read_key(k), v)


def test_commit_crash_mid_flush_leaves_unacked_keys_absent(
        clusters, monkeypatch):
    items = [(f"u-{i}", _payload(9_000, 60 + i)) for i in range(4)]
    out = []
    for c in clusters:
        om = c.om
        b = _bucket(c)
        real = om.commit_keys

        def boom(*a, **kw):
            raise RuntimeError("a crash between the EC write and the commit")

        monkeypatch.setattr(om, "commit_keys", boom)
        errs = _parallel_put(b, items)
        assert set(errs) == {k for k, _ in items}  # nothing falsely acked
        absent = [code(lambda k=k: om.lookup_key("v", "b", k))
                  for k, _ in items]
        monkeypatch.setattr(om, "commit_keys", real)
        assert _parallel_put(b, items) == {}
        for k, v in items:
            np.testing.assert_array_equal(b.read_key(k), v)
        out.append(absent)
    assert out[0] == out[1] == [rq.KEY_NOT_FOUND] * 4


def test_needle_crc_gate_refuses_torn_needle(clusters):
    out = []
    for c in clusters:
        b = _bucket(c)
        data = _payload(10_000, 77)
        b.write_key("torn", data)
        kk = key_key("v", "b", "torn")
        row = c.om.store.get("keys", kk)
        # a torn needle: the committed entry no longer matches the bytes
        row["needle"]["crc"] = int(row["needle"]["crc"]) ^ 0xDEADBEEF
        c.om.store.put("keys", kk, row)
        out.append(code(lambda: b.read_key("torn")))
    assert out[0] == out[1] == slab.NEEDLE_CRC_MISMATCH


def test_packer_refuses_past_its_queue_bound(clusters, monkeypatch):
    """The pending set is bounded: past it a PUT is refused with the
    admission layer's SERVER_BUSY and a retry-after hint; the queued
    needles still land."""
    monkeypatch.setenv("OZONE_TPU_SLAB_LINGER_MS", "60000")
    monkeypatch.setenv("OZONE_TPU_SLAB_QUEUE", "3")
    items = [(f"q-{i}", _payload(5_000, 300 + i)) for i in range(3)]
    out = []
    for c in clusters:
        b = _bucket(c)
        packer = b.client.packer
        ts = [threading.Thread(target=b.write_key, args=(k, v))
              for k, v in items]
        for t in ts:
            t.start()
        t_end = time.monotonic() + 20
        while packer._pending < 3:
            assert time.monotonic() < t_end
            time.sleep(0.01)
        with pytest.raises((StorageError, JStorageError)) as ei:
            b.write_key("q-over", _payload(5_000, 400))
        hint = (admission if _is_port(c) else j_admission
                ).retry_after_hint(str(ei.value))
        packer.flush()
        for t in ts:
            t.join()
        for k, v in items:
            np.testing.assert_array_equal(b.read_key(k), v)
        out.append((ei.value.code, hint, code(
            lambda: c.om.lookup_key("v", "b", "q-over"))))
    assert out[0] == out[1]
    assert out[0][0] == "SERVER_BUSY" and out[0][1] > 0
    assert out[0][2] == rq.KEY_NOT_FOUND


# ---------------------------------------------------- CommitKeys semantics
def _slab(sid: str, length: int) -> dict:
    # a metadata-only slab directory: these cases are about the request
    return {"slab_id": sid, "replication": EC, "length": length,
            "block_groups": [{"container_id": 1, "local_id": 1,
                              "nodes": ["dn0", "dn1", "dn2", "dn3",
                                        "dn4"]}]}


def _entry(key: str, offset: int, length: int, **kw) -> dict:
    return {"key": key, "offset": offset, "length": length, "crc": 0, **kw}


def _set_quota(c, quota_bytes: int) -> None:
    """The bucket's space quota as the reference's SetQuota writes it
    (the port has no quota verbs yet)."""
    row = c.om.store.get("buckets", "/v/b")
    row["quota_bytes"] = quota_bytes
    c.om.store.put("buckets", "/v/b", row)


def test_commit_keys_quota_is_all_or_nothing(clusters):
    out = []
    for c in clusters:
        om = c.om
        _bucket(c)
        _set_quota(c, 10_000)
        over = code(lambda: om.commit_keys(
            "v", "b", _slab("s" * 16, 18_000),
            [_entry("q-0", 0, 9_000), _entry("q-1", 9_000, 9_000)]))
        absent = [code(lambda k=k: om.lookup_key("v", "b", k))
                  for k in ("q-0", "q-1")]
        unsealed = code(lambda: om.slab_info("v", "b", "s" * 16))
        used = int(om.bucket_info("v", "b").get("used_bytes", 0))
        _set_quota(c, -1)
        ok = om.commit_keys("v", "b", _slab("s" * 16, 18_000),
                            [_entry("q-0", 0, 9_000),
                             _entry("q-1", 9_000, 9_000)])
        again = code(lambda: om.commit_keys(
            "v", "b", _slab("s" * 16, 1), [_entry("q-2", 0, 1)]))
        nogroups = code(lambda: om.commit_keys(
            "v", "b", {"slab_id": "x" * 16}, [_entry("q-3", 0, 1)]))
        b = om.bucket_info("v", "b")
        out.append((over, absent, unsealed, used, ok, again, nogroups,
                    b.get("used_bytes"), b.get("key_count")))
    assert out[0] == out[1]
    assert out[0][:4] == (rq.QUOTA_EXCEEDED, [rq.KEY_NOT_FOUND] * 2,
                          rq.KEY_NOT_FOUND, 0)
    assert out[0][5:7] == (rq.INVALID_REQUEST, rq.INVALID_REQUEST)


def test_commit_keys_duplicate_key_last_wins(clusters):
    out = []
    for c in clusters:
        om = c.om
        _bucket(c)
        res = om.commit_keys("v", "b", _slab("d" * 16, 8_000),
                             [_entry("dup", 0, 3_000),
                              _entry("dup", 3_000, 5_000)])
        info = om.lookup_key("v", "b", "dup")
        srow = om.slab_info("v", "b", "d" * 16)
        out.append((res, _row(info, {}), _slab_row(srow, {})))
    assert out[0] == out[1]
    res, info, srow = out[0]
    assert res["committed"] == ["dup"] and res["skipped"] == ["dup"]
    assert info["needle"]["offset"] == 3_000 and info["size"] == 5_000
    # the superseded needle's bytes are born dead
    assert srow["dead_bytes"] == 3_000 and srow["dead_count"] == 1


def test_commit_keys_fence_skips_entry_not_batch(clusters):
    out = []
    for c in clusters:
        om = c.om
        b = _bucket(c)
        b.write_key("live", _payload(3_000, 9))  # inline, generation 1
        live = om.lookup_key("v", "b", "live")
        res = om.commit_keys(
            "v", "b", _slab("f" * 16, 16_000),
            [_entry("fenced", 0, 4_000, expect_object_id="gone"),
             _entry("clean", 4_000, 4_000),
             _entry("live", 8_000, 4_000,
                    expect_object_id=live["object_id"],
                    expect_generation=live["generation"]),
             _entry("stale-gen", 12_000, 4_000,
                    expect_object_id=live["object_id"],
                    expect_generation=live["generation"] + 5)])
        fenced = code(lambda: om.lookup_key("v", "b", "fenced"))
        out.append((res, fenced,
                    _row(om.lookup_key("v", "b", "clean"), {}),
                    _row(om.lookup_key("v", "b", "live"), {}),
                    _slab_row(om.slab_info("v", "b", "f" * 16), {})))
    assert out[0] == out[1]
    res = out[0][0]
    assert res["committed"] == ["clean", "live"]
    assert res["skipped"] == ["fenced", "stale-gen"]
    assert out[0][1] == rq.KEY_NOT_FOUND


def test_dead_needles_and_retire_slab(clusters):
    out = []
    for c in clusters:
        om, mod = c.om, _rq(c)
        _bucket(c)
        om.commit_keys("v", "b", _slab("r" * 16, 6_000),
                       [_entry("r-0", 0, 2_000), _entry("r-1", 2_000, 2_000),
                        _entry("r-2", 4_000, 2_000)])
        om.delete_key("v", "b", "r-0")
        om.commit_keys("v", "b", _slab("t" * 16, 2_500),
                       [_entry("r-1", 0, 2_500)])  # overwrite: r-1 dies
        purged = om.run_key_deleting_service_once()
        rows = [_slab_row(om.slab_info("v", "b", s * 16), {})
                for s in "rt"]
        retired = _slab_row(om.submit(mod.RetireSlab("v", "b", "r" * 16)),
                            {})
        twice = code(lambda: om.submit(mod.RetireSlab("v", "b", "r" * 16)))
        # accounting against a retired slab is a no-op
        noop = om.submit(mod.AccountDeadNeedles("v", "b", "r" * 16, 1, 10))
        out.append((purged, rows, retired, twice, noop,
                    len(list(om.store.iterate("deleted_keys")))))
    assert out[0] == out[1]
    assert out[0][1][0]["dead_count"] == 2
    assert out[0][1][0]["dead_bytes"] == 4_000
    assert out[0][3] == rq.KEY_NOT_FOUND and out[0][4] is None


# --------------------------------------- per-key replication PUT validation
def test_bad_per_key_replication_is_typed_and_leaves_no_orphan(clusters):
    out = []
    for c in clusters:
        om = c.om
        b = _bucket(c)
        open0 = len(list(om.store.iterate("open_keys")))
        with pytest.raises((rq.OMError, j_rq.OMError)) as ei:
            b.write_key("bad", _payload(10_000, 3), "rs-zeppelin-9000")
        assert "rs-zeppelin-9000" in str(ei.value)
        out.append((ei.value.code,
                    len(list(om.store.iterate("open_keys"))) - open0,
                    code(lambda: om.lookup_key("v", "b", "bad"))))
    assert out[0] == out[1] == (rq.INVALID_REQUEST, 0, rq.KEY_NOT_FOUND)


def test_fso_bucket_refuses_smallobj(clusters):
    out = []
    for c in clusters:
        om = c.om
        om.create_volume("v")
        if _is_port(c):
            # the port serves no FSO bucket: its row, as the reference
            # writes it
            om.create_bucket("v", "fso", replication=EC)
            row = dict(om.store.get("buckets", "/v/fso"),
                       layout="FILE_SYSTEM_OPTIMIZED")
            om.store.put("buckets", "/v/fso", row)
        else:
            om.create_bucket("v", "fso", replication=EC,
                             layout="FILE_SYSTEM_OPTIMIZED")
        out.append(code(lambda: om.set_bucket_smallobj("v", "fso")))
    assert out[0] == out[1] == rq.SMALLOBJ_NOT_SUPPORTED


# ------------------------------------------------------------ churn, freon
def test_tiny_key_churn_mixed_sizes(clusters):
    """A seeded churn of inline and needle writes, overwrites and
    deletes; every surviving key byte-exact and every deleted one gone,
    with the same key rows on both sides."""
    out = []
    for c in clusters:
        rng = np.random.default_rng(1729)
        om = c.om
        b = _bucket(c)
        live: dict = {}
        for n in range(60):
            i = int(rng.integers(0, 20))
            key = f"churn-{i}"
            if key in live and rng.random() < 0.3:
                b.delete_key(key)
                del live[key]
                continue
            size = int(rng.choice([800, 3_000, 9_000, 40_000]))
            data = _payload(size, 1000 + n)
            b.write_key(key, data)
            live[key] = data
        om.run_key_deleting_service_once()
        for key, want in live.items():
            np.testing.assert_array_equal(b.read_key(key), want)
        gone = [f"churn-{i}" for i in range(20) if f"churn-{i}" not in live]
        codes = [code(lambda k=k: om.lookup_key("v", "b", k)) for k in gone]
        keys, slabs = _stored(c, sorted(live))
        out.append((keys, sorted((s["dead_count"], s["dead_bytes"],
                                  s["length"]) for s in slabs), codes))
    assert out[0] == out[1]
    assert set(out[0][2]) <= {rq.KEY_NOT_FOUND}


@pytest.mark.parametrize("packer", [True, False])
def test_tinyg_with_and_without_the_packer(clusters, packer):
    out = []
    for c, mod in zip(clusters, (freon, j_freon)):
        rep = mod.tinyg(c.client(), n_keys=40, size=4 * 1024, threads=4,
                        replication=EC, packer=packer, mix=True).summary()
        out.append({k: rep[k] for k in ("packer", "inline_keys",
                                         "needle_keys", "regular_keys",
                                         "verify_failures", "ops",
                                         "failures")})
    assert out[0] == out[1]
    if packer:
        assert out[0]["inline_keys"] == 38 and out[0]["needle_keys"] == 2
    else:
        assert out[0]["regular_keys"] == 40
    assert out[0]["verify_failures"] == 0
