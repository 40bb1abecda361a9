"""The port's lifecycle tiering against `ozone_tpu`'s, on the CPU.

Mirrors tests/test_lifecycle.py case for case where the case needs no
metadata ring (the Recon panel is not ported): the rule model and its
S3 XML codec, rules on the bucket row, the sweep (transition, expiry,
the old blocks' release), many keys per device dispatch, the rewrite
fence, the term fence across a deposed sweeper, the expiry fence, the
sweep deadline and the follower gate, and the gateway's `?lifecycle`.
A port `MiniOzoneCluster(device="cpu")` and a JAX one, both seeded, take
the same keys and rules: stats (`transitioned`, `conflicts`, `failed`,
`skipped`, `bytes`, `dispatches`), bytes read back, key rows, every
chunk the datanodes store with its CRC words (so parity and CRCs are
exact), bucket rows and the `system/lifecycle_state` row must be equal.
Beyond the reference's tests: a sweep over replicated, XOR(6,1) and
short keys; the deadline striking mid-batch, where the cursor must not
pass the keys left unprocessed; and the term-0 checkpoint rejection
codes.
"""

import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ozone_tpu.client import resilience as j_resilience
from ozone_tpu.codec import service as j_service
from ozone_tpu.gateway.s3 import S3Gateway as JS3Gateway
from ozone_tpu.lifecycle import policy as j_policy
from ozone_tpu.lifecycle.service import LifecycleService as JService
from ozone_tpu.om import requests as j_rq
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.codec import service
from ozone_tpu_torch.gateway.s3 import S3Gateway
from ozone_tpu_torch.lifecycle import policy
from ozone_tpu_torch.lifecycle.service import LifecycleService
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.storage.ids import BlockID, StorageError
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
from test_torch_control_plane import key_row, stored_chunks

EC = "rs-3-2-4096"
KW = dict(num_datanodes=6, block_size=8 * 4096,
          container_size=4 * 1024 * 1024, stale_after_s=1000.0,
          dead_after_s=2000.0, placement_seed=42)
#: the sweep stats both sides must agree on (the rest are timings)
STATS = ("keys_scanned", "transitioned", "conflicts", "failed", "expired",
         "skipped", "bytes", "dispatches", "complete")


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    """Direct codec route unless a test asks for the service, no mesh
    lane on the reference's side (the port has none yet), and one torch
    thread: the suite's timing-sensitive tests share the cores."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    monkeypatch.setenv("OZONE_TPU_MESH", "0")
    service.reset_for_tests()
    j_service.reset_for_tests()
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


def sweeper(c, **kw):
    if _is_port(c):
        return LifecycleService(c.om, clients=c.clients, device="cpu", **kw)
    return JService(c.om, clients=c.clients, **kw)


def code(fn):
    """The error code fn raises, or None."""
    try:
        fn()
    except (rq.OMError, j_rq.OMError, StorageError, JStorageError) as e:
        return e.code
    return None


def _write_keys(c, bucket, names, size=30_000, seed=0, replication=None):
    b = c.client().get_volume("v").get_bucket(bucket)
    rng = np.random.default_rng(seed)
    out = {}
    for name in names:
        d = rng.integers(0, 256, size, dtype=np.uint8)
        b.write_key(name, d, replication)
        out[name] = d
    return b, out


def _stats(stats: dict) -> dict:
    return {k: stats.get(k) for k in STATS}


def _state_row(c) -> dict:
    row = dict(c.om.store.get("system", "lifecycle_state") or {})
    if "stats" in row:
        row["stats"] = {k: v for k, v in row["stats"].items()
                        if k != "updated"}
    return row


def _bucket_row(c, vol="v", bucket="b") -> dict:
    row = dict(c.om.bucket_info(vol, bucket))
    row.pop("created", None)
    return row


def _keys_state(c, b, names) -> list:
    """(key row, bytes read, stored chunks) of each key."""
    out = []
    for name in names:
        info = c.om.lookup_key("v", "b", name)
        out.append((key_row(info), b.read_key(name).tobytes(),
                    stored_chunks(c, info)))
    return out


# ------------------------------------------------------------------ policy
VALID = [
    dict(rule_id="r", prefix="a/", age_days=3,
         action=policy.ACTION_TRANSITION, target=EC),
    dict(rule_id="r", age_days=0, action=policy.ACTION_EXPIRE),
]
INVALID = [
    dict(rule_id="", action=policy.ACTION_EXPIRE),
    dict(rule_id="r", action="SHRED"),
    dict(rule_id="r", age_days=-1, action=policy.ACTION_EXPIRE),
    # a transition target must be an EC scheme
    dict(rule_id="r", action=policy.ACTION_TRANSITION, target="RATIS/THREE"),
]


@pytest.mark.parametrize("kw", VALID + INVALID)
def test_rule_validation(kw):
    def check(mod):
        try:
            return mod.LifecycleRule(**kw).validate().to_json()
        except mod.LifecycleError as e:
            return ("LifecycleError", str(e))

    got, want = check(policy), check(j_policy)
    assert got == want
    assert (kw in INVALID) == isinstance(got, tuple)


LIFECYCLE_XML = b"""<?xml version="1.0"?>
<LifecycleConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">
  <Rule>
    <ID>warm</ID>
    <Filter><Prefix>logs/</Prefix></Filter>
    <Status>Enabled</Status>
    <Transition><Days>30</Days>
      <StorageClass>STANDARD_IA</StorageClass></Transition>
    <Expiration><Days>90</Days></Expiration>
  </Rule>
  <Rule>
    <ID>pinned</ID>
    <Prefix>cold/</Prefix>
    <Status>Disabled</Status>
    <Transition><Days>1.5</Days>
      <StorageClass>rs-3-2-4096</StorageClass></Transition>
  </Rule>
</LifecycleConfiguration>"""


def test_s3_xml_roundtrip_and_mapping():
    rules = policy.rules_from_s3_xml(LIFECYCLE_XML,
                                     default_target="rs-6-3-1024k")
    assert rules == j_policy.rules_from_s3_xml(
        LIFECYCLE_XML, default_target="rs-6-3-1024k")
    # a combined rule splits into transition + expiration
    assert [r["action"] for r in rules] == [
        policy.ACTION_TRANSITION, policy.ACTION_EXPIRE,
        policy.ACTION_TRANSITION]
    # a warm AWS class maps to the default scheme; a literal one passes
    assert rules[0]["target"] == "rs-6-3-1024k"
    assert rules[2]["target"] == "rs-3-2-4096"
    assert rules[2]["enabled"] is False
    # the rendered XML is the reference's, byte for byte, and re-parses
    xml = policy.rules_to_s3_xml(rules)
    assert xml == j_policy.rules_to_s3_xml(rules)
    assert policy.rules_from_s3_xml(
        xml, default_target="rs-6-3-1024k") == rules


@pytest.mark.parametrize("body", [
    b"<LifecycleConfiguration/>",
    b"not xml at all",
    # Date schedules are not supported
    b"<LifecycleConfiguration><Rule><ID>x</ID>"
    b"<Transition><Date>2026-01-01</Date></Transition>"
    b"</Rule></LifecycleConfiguration>",
    b"<LifecycleConfiguration><Rule><ID>x</ID><Status>Enabled</Status>"
    b"</Rule></LifecycleConfiguration>",
    b"<LifecycleConfiguration><Rule><ID>x</ID><Expiration></Expiration>"
    b"</Rule></LifecycleConfiguration>",
    b"<LifecycleConfiguration><Rule><ID>x</ID><Transition><Days>1</Days>"
    b"<StorageClass>RATIS/THREE</StorageClass></Transition>"
    b"</Rule></LifecycleConfiguration>",
])
def test_s3_xml_rejections(body):
    with pytest.raises(policy.LifecycleError) as got:
        policy.rules_from_s3_xml(body)
    with pytest.raises(j_policy.LifecycleError) as want:
        j_policy.rules_from_s3_xml(body)
    assert str(got.value) == str(want.value)


def test_rules_persist_in_bucket_metadata(clusters):
    rules = [{"id": "r0", "prefix": "p/", "age_days": 2,
              "action": policy.ACTION_TRANSITION, "target": EC}]
    out = []
    for c in clusters:
        om = c.om
        om.create_volume("v")
        om.create_bucket("v", "b", replication="RATIS/THREE")
        om.set_bucket_lifecycle("v", "b", rules)
        got = om.get_bucket_lifecycle("v", "b")
        assert om.bucket_info("v", "b")["lifecycle"] == got
        bad = code(lambda: om.set_bucket_lifecycle(
            "v", "b", [{"id": "bad", "action": "SHRED"}]))
        om.delete_bucket_lifecycle("v", "b")
        cleared = om.get_bucket_lifecycle("v", "b")
        # an FSO bucket refuses rules (the sweeper walks the flat key
        # table); the port serves no FSO bucket, so its row is written
        # as the reference writes it
        if _is_port(c):
            row = dict(om.store.get("buckets", "/v/b"), name="fso",
                       layout="FILE_SYSTEM_OPTIMIZED")
            om.store.put("buckets", "/v/fso", row)
        else:
            om.create_bucket("v", "fso", replication="RATIS/THREE",
                             layout="FILE_SYSTEM_OPTIMIZED")
        fso = code(lambda: om.set_bucket_lifecycle("v", "fso", rules))
        missing = code(lambda: om.set_bucket_lifecycle("v", "nob", rules))
        out.append((got, bad, cleared, fso, missing, _bucket_row(c)))
    assert out[0] == out[1]
    assert out[0][1:5] == (rq.INVALID_REQUEST, [], rq.INVALID_REQUEST,
                           rq.BUCKET_NOT_FOUND)


# --------------------------------------------------------- sweep datapath
def test_sweep_transitions_expires_and_reclaims(clusters):
    out = []
    names = [f"cold-{i}" for i in range(4)]
    for c in clusters:
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication="RATIS/THREE")
        b, datas = _write_keys(c, "b", names)
        hot = np.arange(9000, dtype=np.uint64).astype(np.uint8)
        b.write_key("hot-x", hot)
        b.write_key("ttl-1", hot)
        c.om.set_bucket_lifecycle("v", "b", [
            {"id": "warm", "prefix": "cold-", "age_days": 0,
             "action": policy.ACTION_TRANSITION, "target": EC},
            {"id": "ttl", "prefix": "ttl-", "age_days": 0,
             "action": policy.ACTION_EXPIRE},
        ])
        old = c.om.key_block_groups(c.om.lookup_key("v", "b", "cold-0"))
        svc = sweeper(c)
        stats = svc.run_once()
        assert stats["complete"] and stats["transitioned"] == 4
        assert stats["expired"] == 1 and stats["failed"] == 0
        for name, want in datas.items():
            assert c.om.lookup_key("v", "b", name)["replication"] == EC
            assert np.array_equal(b.read_key(name), want)
        assert c.om.lookup_key(
            "v", "b", "hot-x")["replication"].startswith("RATIS")
        gone = code(lambda: c.om.lookup_key("v", "b", "ttl-1"))
        # the old replicated blocks retire through the SCM's deletion log
        # (queued after the commit), delivered on heartbeats
        pending = c.scm.deleted_blocks.pending_count()
        assert pending > 0
        c.tick(rounds=2)
        assert c.scm.deleted_blocks.pending_count() == 0
        g = old[0]
        bid = BlockID(g.container_id, g.local_id)
        for dn_id in g.pipeline.nodes:
            assert code(lambda: c.clients.get(dn_id).get_block(bid)) \
                == "NO_SUCH_BLOCK"
        again = svc.run_once()  # idempotent
        out.append((_stats(stats), gone, pending, _stats(again),
                    _keys_state(c, b, names + ["hot-x"]), _state_row(c),
                    _bucket_row(c)))
    assert out[0] == out[1]


def test_sweep_replicated_xor_and_short_keys(tmp_path):
    """Replicated keys (whole and short groups) and XOR(6,1) keys tiered
    to RS(6,3) in one sweep: the replicated ones through the packed
    windows, the XOR ones through the fused re-encode."""
    kw = dict(KW, num_datanodes=10)
    sides = (MiniOzoneCluster(tmp_path / "port", device="cpu", **kw),
             JCluster(tmp_path / "ref", **kw))
    target = "rs-6-3-4096"
    sizes = {"r-whole": 2 * 6 * 4096, "r-short": 6 * 4096 + 1234,
             "r-tiny": 777, "r-two-groups": 6 * 8 * 4096 + 5000,
             "x-0": 3 * 6 * 4096, "x-1": 6 * 4096 + 7}
    out = []
    try:
        for c in sides:
            oz = c.client()
            oz.create_volume("v").create_bucket("b",
                                                replication="RATIS/THREE")
            b = oz.get_volume("v").get_bucket("b")
            datas = {}
            for i, (name, size) in enumerate(sizes.items()):
                d = np.random.default_rng(50 + i).integers(
                    0, 256, size, dtype=np.uint8)
                b.write_key(name, d, "xor-6-1-4096"
                            if name.startswith("x-") else None)
                datas[name] = d
            c.om.set_bucket_lifecycle("v", "b", [
                {"id": "warm", "prefix": "", "age_days": 0,
                 "action": policy.ACTION_TRANSITION, "target": target}])
            stats = sweeper(c).run_once()
            for name, want in datas.items():
                assert c.om.lookup_key("v", "b", name)["replication"] \
                    == target
                assert np.array_equal(b.read_key(name), want), name
            out.append((_stats(stats), _keys_state(c, b, list(sizes)),
                        _state_row(c)))
    finally:
        for c in sides:
            c.close()
    assert out[0] == out[1]
    stats = out[0][0]
    assert stats["transitioned"] == 6 and stats["failed"] == 0
    assert stats["bytes"] == sum(sizes.values())


@pytest.mark.parametrize("route", ["direct", "service"])
def test_many_keys_share_device_dispatches(clusters, monkeypatch, route):
    """Many small keys per device submission: 10 keys of 2 stripes at a
    window of 8 are 3 dispatches, on the direct route and on the codec
    service (where the service's own dispatch count moves the same on
    both sides)."""
    monkeypatch.setenv("OZONE_TPU_TIER_BATCH", "8")
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE",
                       "1" if route == "service" else "0")
    out = []
    names = [f"cold-{i}" for i in range(10)]
    for c, svc_mod in zip(clusters, (service, j_service)):
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication="RATIS/THREE")
        # 24576 bytes = exactly 2 rs-3-2-4096 stripes per key
        b, datas = _write_keys(c, "b", names, size=24576)
        c.om.set_bucket_lifecycle("v", "b", [
            {"id": "warm", "prefix": "cold-", "age_days": 0,
             "action": policy.ACTION_TRANSITION, "target": EC}])
        d0 = svc_mod.METRICS.counter("dispatches").value
        stats = sweeper(c).run_once()
        launched = svc_mod.METRICS.counter("dispatches").value - d0
        for name, want in datas.items():
            assert np.array_equal(b.read_key(name), want)
        out.append((_stats(stats), launched, _keys_state(c, b, names)))
    assert out[0] == out[1]
    assert out[0][0]["transitioned"] == 10
    assert out[0][0]["dispatches"] == 3
    assert out[0][1] == (3 if route == "service" else 0)


def test_transition_conflict_fence_preserves_user_write(clusters):
    """A user overwrite racing the transition wins: the fenced commit
    loses (conflicts 1), its EC blocks ride the deletion chain."""
    out = []
    newer = np.full(5000, 7, np.uint8)
    for c in clusters:
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication="RATIS/THREE")
        b, _ = _write_keys(c, "b", ["cold-0"])
        c.om.set_bucket_lifecycle("v", "b", [
            {"id": "warm", "prefix": "cold-", "age_days": 0,
             "action": policy.ACTION_TRANSITION, "target": EC}])
        svc = sweeper(c)
        svc.executor().pre_commit_hook = \
            lambda ks, b=b: b.write_key(ks.key, newer)
        stats = svc.run_once()
        assert stats["conflicts"] == 1 and stats["transitioned"] == 0
        info = c.om.lookup_key("v", "b", "cold-0")
        assert info["replication"].startswith("RATIS")
        assert np.array_equal(b.read_key("cold-0"), newer)
        discarded = [v for _, v in c.om.store.iterate("deleted_keys")
                     if v.get("replication") == EC]
        assert discarded or c.scm.deleted_blocks.pending_count() > 0
        c.tick(rounds=2)
        assert c.scm.deleted_blocks.pending_count() == 0
        out.append((_stats(stats), _keys_state(c, b, ["cold-0"])))
    assert out[0] == out[1]


def test_deposed_sweeper_is_fenced_exactly_once(clusters):
    """A sweeper of term 1 stops mid-namespace (abandoned, as a crash
    leaves it); the term-2 sweeper fences, resumes from the cursor and
    finishes; the deposed one's next sweep is refused and applies
    nothing."""
    out = []
    names = [f"cold-{i}" for i in range(6)]
    for c in clusters:
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication="RATIS/THREE")
        b, datas = _write_keys(c, "b", names)
        c.om.set_bucket_lifecycle("v", "b", [
            {"id": "warm", "prefix": "cold-", "age_days": 0,
             "action": policy.ACTION_TRANSITION, "target": EC}])
        old = sweeper(c, term_fn=lambda: 1, page=2)
        stats1 = old.run_once(max_keys=2)
        assert 0 < stats1["transitioned"] <= 2 and not stats1["complete"]
        mid = (c.om.lifecycle_status()["in_progress"], _state_row(c))
        new = sweeper(c, term_fn=lambda: 2, page=2)
        stats2 = new.run_once()
        assert stats2["complete"]
        assert stats1["transitioned"] + stats2["transitioned"] == 6
        for name, want in datas.items():
            assert c.om.lookup_key("v", "b", name)["replication"] == EC
            assert np.array_equal(b.read_key(name), want)
        stats3 = old.run_once()
        assert stats3.get("fenced") is True and stats3["transitioned"] == 0
        late = code(lambda: c.om.submit(
            (rq if _is_port(c) else j_rq).LifecycleCheckpoint(
                term=1, cursor={"bucket": "/v/b", "after": ""})))
        st = c.om.lifecycle_status()
        out.append((_stats(stats1), mid, _stats(stats2), _stats(stats3),
                    late, st["term"], st["in_progress"], _state_row(c),
                    _keys_state(c, b, names)))
    assert out[0] == out[1]
    assert out[0][4] == rq.LIFECYCLE_FENCED
    assert out[0][5:7] == (2, False)


def test_term0_checkpoint_rejection_codes(clusters):
    """With no ring every sweeper runs at term 0; the checkpoint's fence
    answers the reference's codes at term 0 and around it."""
    steps = [
        dict(term=0, cursor={"bucket": "/v/b", "after": "x"}),  # unfenced
        dict(term=0, fence=True),
        dict(term=0, cursor={"bucket": "/v/b", "after": "k1"},
             stats={"keys_scanned": 1}),
        dict(term=1, cursor={"bucket": "/v/b", "after": "k2"}),
        dict(term=-1, fence=True),
        dict(term=0, fence=True),  # re-fencing the same term is allowed
        dict(term=3, fence=True),
        dict(term=0, cursor={}),
        dict(term=2, fence=True),
        dict(term=3, cursor={}, stats={"keys_scanned": 2}),
    ]
    out = []
    for c in clusters:
        mod = rq if _is_port(c) else j_rq
        seen = []
        for kw in steps:
            seen.append((code(lambda: c.om.submit(
                mod.LifecycleCheckpoint(**kw))), _state_row(c)))
        out.append(seen)
    assert out[0] == out[1]
    assert [s[0] for s in out[0]] == [
        rq.LIFECYCLE_FENCED, None, None, rq.LIFECYCLE_FENCED,
        rq.LIFECYCLE_FENCED, None, None, rq.LIFECYCLE_FENCED,
        rq.LIFECYCLE_FENCED, None]


def test_expire_fence_spares_concurrent_overwrite(clusters):
    out = []
    fresh = np.full(4000, 9, np.uint8)
    for c in clusters:
        mod = rq if _is_port(c) else j_rq
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication="RATIS/THREE")
        b, _ = _write_keys(c, "b", ["ttl-x"])
        stale_oid = c.om.lookup_key("v", "b", "ttl-x")["object_id"]
        b.write_key("ttl-x", fresh)  # a user overwrite after the scan
        fenced = code(lambda: c.om.submit(mod.DeleteKey(
            "v", "b", "ttl-x", expect_object_id=stale_oid)))
        assert np.array_equal(b.read_key("ttl-x"), fresh)
        oid = c.om.lookup_key("v", "b", "ttl-x")["object_id"]
        c.om.submit(mod.DeleteKey("v", "b", "ttl-x", expect_object_id=oid))
        gone = code(lambda: c.om.lookup_key("v", "b", "ttl-x"))
        via_om = code(lambda: c.om.delete_key("v", "b", "ttl-x",
                                              expect_object_id=oid))
        out.append((fenced, gone, via_om))
    assert out[0] == out[1] == (rq.KEY_MODIFIED, rq.KEY_NOT_FOUND,
                                rq.KEY_NOT_FOUND)


def test_sweep_deadline_bounds_work_and_resumes(clusters):
    out = []
    names = [f"cold-{i}" for i in range(4)]
    for c in clusters:
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication="RATIS/THREE")
        b, datas = _write_keys(c, "b", names)
        c.om.set_bucket_lifecycle("v", "b", [
            {"id": "warm", "prefix": "cold-", "age_days": 0,
             "action": policy.ACTION_TRANSITION, "target": EC}])
        stats = sweeper(c, sweep_deadline_s=1e-6).run_once()
        assert stats.get("deadline_exceeded") is True
        assert stats["transitioned"] == 0
        stats2 = sweeper(c).run_once()
        assert stats2["complete"] and stats2["transitioned"] == 4
        out.append((_stats(stats), _stats(stats2), _state_row(c),
                    _keys_state(c, b, names)))
    assert out[0] == out[1]


def test_deadline_mid_batch_keeps_the_cursor(clusters, monkeypatch):
    """The budget runs out after the first key's commit (the hook spends
    it), with the next key half packed: the sweep books the one
    transition and stops, and its cursor does not pass the keys it left;
    the next sweep transitions exactly those."""
    monkeypatch.setenv("OZONE_TPU_TIER_BATCH", "1")
    out = []
    names = [f"cold-{i}" for i in range(4)]
    for c in clusters:
        res = resilience if _is_port(c) else j_resilience
        oz = c.client()
        oz.create_volume("v").create_bucket("b", replication="RATIS/THREE")
        # 3 stripes each: the second key is mid-pack at the first commit
        b, datas = _write_keys(c, "b", names, size=3 * 3 * 4096)
        c.om.set_bucket_lifecycle("v", "b", [
            {"id": "warm", "prefix": "cold-", "age_days": 0,
             "action": policy.ACTION_TRANSITION, "target": EC}])
        svc = sweeper(c, sweep_deadline_s=600.0)

        def spend(ks, res=res):
            res.current().t_end = time.monotonic()

        svc.executor().pre_commit_hook = spend
        stats = svc.run_once()
        cursor = c.om.lifecycle_status()["cursor"]
        assert stats.get("deadline_exceeded") is True
        assert stats["transitioned"] == 1 and stats["failed"] == 0
        assert cursor == {}  # the page was never checkpointed
        reps = [c.om.lookup_key("v", "b", n)["replication"] for n in names]
        svc.executor().pre_commit_hook = None
        stats2 = svc.run_once()
        assert stats2["complete"] and stats2["transitioned"] == 3
        out.append((_stats(stats), cursor, reps, _stats(stats2),
                    _keys_state(c, b, names), _state_row(c)))
    assert out[0] == out[1]
    assert out[0][2] == [EC] + ["RATIS/THREE"] * 3


def test_follower_never_sweeps():
    class _Om:  # the service must bail before touching anything
        def __getattr__(self, name):  # pragma: no cover
            raise AssertionError("follower touched OM state")

    for cls in (LifecycleService, JService):
        svc = cls(_Om(), leader_fn=lambda: False)
        assert svc.run_once() == {"skipped": "not_leader"}
        assert svc.compact_slabs_once() == {"skipped": "not_leader"}


# ------------------------------------------------------------- S3 surface
def _http(method, url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _s3_code(body: bytes) -> str:
    import re

    m = re.search(rb"<Code>([^<]*)</Code>", body)
    return m.group(1).decode() if m else ""


def test_s3_lifecycle_api_end_to_end(clusters):
    """The rules go in and out through the gateway's `?lifecycle` (PUT,
    GET, DELETE), keys written through the gateway tier and expire, and
    the gateway reads them back byte-exact, on both gateways."""
    body = (b'<LifecycleConfiguration>'
            b'<Rule><ID>warm</ID><Filter><Prefix>cold/</Prefix>'
            b'</Filter><Status>Enabled</Status>'
            b'<Transition><Days>0</Days>'
            b'<StorageClass>rs-3-2-4096</StorageClass></Transition>'
            b'</Rule>'
            b'<Rule><ID>ttl</ID><Filter><Prefix>ttl/</Prefix>'
            b'</Filter><Status>Enabled</Status>'
            b'<Expiration><Days>0</Days></Expiration></Rule>'
            b'</LifecycleConfiguration>')
    rng = np.random.default_rng(3)
    payloads = {f"cold/{i}": rng.integers(0, 256, 40_000,
                                          dtype=np.uint8).tobytes()
                for i in range(3)}
    out = []
    for c in clusters:
        gw = (S3Gateway if _is_port(c) else JS3Gateway)(
            c.client(), replication="RATIS/THREE")
        gw.start()
        try:
            base = f"http://{gw.address}"
            seen = [_http("PUT", f"{base}/tierb")[0],
                    _http("GET", f"{base}/tierb?lifecycle"),  # none yet
                    _http("PUT", f"{base}/tierb?lifecycle", data=body)]
            status, got = _http("GET", f"{base}/tierb?lifecycle")
            seen.append((status, got))
            assert status == 200
            rt = policy.rules_from_s3_xml(got)
            assert {r["id"] for r in rt} == {"warm", "ttl"}
            assert rt[0]["target"] == EC
            for k, v in payloads.items():
                seen.append(_http("PUT", f"{base}/tierb/{k}", data=v)[0])
            seen.append(_http("PUT", f"{base}/tierb/ttl/x",
                              data=b"doomed")[0])
            seen.append(_http("PUT", f"{base}/tierb/keep/x",
                              data=b"hot stays")[0])
            stats = sweeper(c).run_once()
            assert stats["transitioned"] == 3 and stats["expired"] == 1
            seen.append(_stats(stats))
            for k, v in payloads.items():
                assert _http("GET", f"{base}/tierb/{k}") == (200, v), k
                assert c.om.lookup_key("s3v", "tierb", k)["replication"] \
                    == EC
            seen.append(_http("GET", f"{base}/tierb/keep/x"))
            status, got = _http("GET", f"{base}/tierb/ttl/x")
            seen.append((status, _s3_code(got)))
            # a ranged GET of a tiered key decodes only covering cells
            seen.append(_http("GET", f"{base}/tierb/cold/0",
                              headers={"Range": "bytes=100-199"}))
            seen.append(_http("DELETE", f"{base}/tierb?lifecycle")[0])
            status, got = _http("GET", f"{base}/tierb?lifecycle")
            seen.append((status, _s3_code(got)))
            status, got = _http("PUT", f"{base}/tierb?lifecycle",
                                data=b"<junk")
            seen.append((status, _s3_code(got)))
            status, got = _http("GET", f"{base}/nobucket?lifecycle")
            seen.append((status, _s3_code(got)))
        finally:
            gw.stop()
        # an error answer compares by its S3 code (its message and
        # request id differ between the gateways)
        out.append([(s[0], _s3_code(s[1])) if isinstance(s, tuple)
                    and isinstance(s[1], bytes) and s[0] >= 400 else s
                    for s in seen])
    assert out[0] == out[1]
    assert out[0][1] == (404, "NoSuchLifecycleConfiguration")
    assert out[0][-5] == (206, payloads["cold/0"][100:200])
    assert out[0][-4:] == [204, (404, "NoSuchLifecycleConfiguration"),
                           (400, "MalformedXML"), (404, "NoSuchBucket")]
