"""The port's block and container tokens against `ozone_tpu`'s, on the CPU.

`ozone_tpu_torch/utils/security.py` beside `ozone_tpu/utils/security.py`:
the same key material and a pinned clock give byte-equal payloads, token
dicts and signatures; the verifiers decide alike (and fail with the same
messages) over a grid of scope, mode, subject, expiry, key rotation and
tampering; the key managers rotate, activate, export and import alike;
and the client's TokenStore caches, refreshes and self-issues as the
reference's does. Tolerance is exact equality throughout.
"""

import itertools
import time

import numpy as np
import pytest

from ozone_tpu.client import dn_client as j_dn_client
from ozone_tpu.storage.ids import BlockID as JBlockID
from ozone_tpu.utils import security as jsec
from ozone_tpu_torch.client import dn_client as t_dn_client
from ozone_tpu_torch.storage.ids import BlockID as TBlockID
from ozone_tpu_torch.utils import security as tsec

NOW = 1_760_000_000.123456
SIDES = ((jsec, JBlockID), (tsec, TBlockID))


@pytest.fixture
def clock(monkeypatch):
    """A pinned wall clock both packages read through `time.time`."""
    state = {"t": NOW}
    monkeypatch.setattr(time, "time", lambda: state["t"])
    return state


def _keys(seed: int, n: int = 2) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"key_id": f"k{seed}-{i}",
             "material": rng.integers(0, 256, 32, dtype=np.uint8).tobytes().hex(),
             "created": NOW - 100.0 * (n - i), "expires": NOW + 7200.0}
            for i in range(n)]


def _managers(keys, **kw):
    out = []
    for sec, _ in SIDES:
        m = sec.SecretKeyManager(generate=False, **kw)
        m.import_keys(keys)
        out.append(m)
    return out


MODES = [["READ"], ["WRITE"], ["READ", "WRITE"], ["WRITE", "READ"]]


@pytest.mark.parametrize("scope,modes,owner,cid,lid", [
    (scope, modes, owner, cid, lid)
    for scope in ("b", "c")
    for modes in MODES
    for owner in ("client", "dn", "alice", "")
    for cid, lid in ((1, 1), (7, 123456789012))
])
def test_tokens_byte_equal(clock, scope, modes, owner, cid, lid):
    """Same keys, same clock: the same token dict, field for field, and
    the same signature, for block and container tokens."""
    keys = _keys(cid * 31 + lid % 97)
    toks = []
    for (sec, bid_cls), mgr in zip(SIDES, _managers(keys)):
        iss = sec.BlockTokenIssuer(mgr, token_lifetime_s=600.0)
        ms = [sec.AccessMode(m) for m in modes]
        if scope == "b":
            toks.append(iss.issue(bid_cls(cid, lid), ms, owner=owner))
        else:
            toks.append(iss.issue_container(cid, ms, owner=owner))
    assert toks[0] == toks[1]
    assert toks[0]["key_id"] == keys[-1]["key_id"]
    assert toks[0]["expiry"] == round(NOW + 600.0, 3)


@pytest.mark.parametrize("expiry", [NOW, NOW + 0.0004, NOW + 0.0005,
                                    NOW + 123.4567891, 1e10 + 0.1])
def test_payload_bytes_equal(expiry):
    """The signed bytes: canonical JSON, sorted keys and modes, the expiry
    rounded to milliseconds."""
    for subject in ({"container_id": 3, "local_id": 9}, 3):
        a = jsec._payload("b", subject, [jsec.AccessMode.WRITE,
                                         jsec.AccessMode.READ],
                          "o", expiry, "kid")
        b = tsec._payload("b", subject, [tsec.AccessMode.WRITE,
                                         tsec.AccessMode.READ],
                          "o", expiry, "kid")
        assert a == b


def _tamper(tok: dict, how: str) -> dict:
    t = dict(tok)
    if how == "sig":
        t["sig"] = ("0" if t["sig"][0] != "0" else "1") + t["sig"][1:]
    elif how == "owner":
        t["owner"] = "mallory"
    elif how == "modes":
        t["modes"] = ["READ", "WRITE"]
    elif how == "expiry":
        t["expiry"] = t["expiry"] + 3600.0
    elif how == "key":
        t["key_id"] = "unknown"
    elif how == "badmode":
        t["modes"] = ["READ", "EXEC"]
    elif how == "scope":
        t["scope"] = "c" if t.get("scope", "b") == "b" else "b"
    elif how == "noscope":
        t.pop("scope")
    return t


def _decide(fn):
    try:
        fn()
        return "ok"
    except (jsec.TokenError, tsec.TokenError) as e:
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("granted,asked,same_block,age,tamper,rotated", [
    (g, a, sb, age, tm, rot)
    for g, a in (("READ", "READ"), ("READ", "WRITE"), ("WRITE", "WRITE"),
                 ("RW", "READ"), ("RW", "WRITE"))
    for sb in (True, False)
    for age in (0.0, 599.0, 601.0)
    for tm in ("none", "sig", "owner", "modes", "expiry", "key", "badmode",
               "scope", "noscope")
    for rot in (False, True)
    # keep the grid at ~360 cases: every tamper on the fresh, same-block case
    if tm == "none" or (sb and age == 0.0)
])
def test_verifier_decisions_equal(clock, granted, asked, same_block, age,
                                  tamper, rotated):
    """A block token issued under one key and checked after `age` seconds,
    perhaps after a rotation, for the same or another block, tampered or
    not: both verifiers accept or refuse alike, with the same message."""
    keys = _keys(5)
    out = []
    for (sec, bid_cls), mgr in zip(SIDES, _managers(keys)):
        iss = sec.BlockTokenIssuer(mgr, token_lifetime_s=600.0)
        modes = ([sec.AccessMode.READ, sec.AccessMode.WRITE] if granted == "RW"
                 else [sec.AccessMode(granted)])
        tok = _tamper(iss.issue(bid_cls(4, 44), modes), tamper)
        if rotated:  # a new key arrives: tokens under the old one still verify
            mgr.import_keys(_keys(6, 1))
        ver = sec.BlockTokenVerifier(mgr)
        clock["t"] = NOW + age
        target = bid_cls(4, 44) if same_block else bid_cls(4, 45)
        out.append(_decide(lambda: ver.verify(tok, target,
                                              sec.AccessMode(asked))))
        clock["t"] = NOW
    assert out[0] == out[1]


@pytest.mark.parametrize("case", ["ok", "other", "read_only", "block_as_container",
                                  "missing", "disabled"])
def test_container_verifier_equal(clock, case):
    keys = _keys(8)
    out = []
    for (sec, bid_cls), mgr in zip(SIDES, _managers(keys)):
        iss = sec.BlockTokenIssuer(mgr)
        ver = sec.BlockTokenVerifier(mgr, enabled=case != "disabled")
        tok = iss.issue_container(12)
        cid, mode = 12, sec.AccessMode.WRITE
        if case == "other":
            cid = 13
        elif case == "read_only":
            tok = iss.issue_container(12, [sec.AccessMode.READ])
        elif case == "block_as_container":
            tok = iss.issue(bid_cls(12, 1), [sec.AccessMode.WRITE])
        elif case == "missing":
            tok = None
        out.append(_decide(lambda: ver.verify_container(tok, cid, mode)))
    assert out[0] == out[1]
    assert (out[0] == "ok") == (case in ("ok", "disabled"))


def test_no_key_fails_closed(clock):
    """An enabled verifier with no key refuses every token (the datanode's
    window between tokens turning on and the first key arriving)."""
    keys = _keys(9)
    out = []
    for (sec, bid_cls), mgr in zip(SIDES, _managers(keys)):
        tok = sec.BlockTokenIssuer(mgr).issue(bid_cls(1, 2),
                                              [sec.AccessMode.READ])
        empty = sec.BlockTokenVerifier(sec.SecretKeyManager(generate=False))
        out.append(_decide(lambda: empty.verify(tok, bid_cls(1, 2),
                                                sec.AccessMode.READ)))
    assert out[0] == out[1] == "TokenError: unknown/expired secret key"


def test_key_manager_rotation_and_activation(clock, monkeypatch):
    """rotate, current with an activation delay, needs_rotation, new_key,
    export and the pruning of expired keys, step by step alike."""
    counter = itertools.count()
    fake_hex = lambda n: f"{next(counter):0{2 * n}x}"  # noqa: E731
    fake_bytes = lambda n: bytes([next(counter) % 256]) * n  # noqa: E731
    views = []
    for sec, _ in SIDES:
        monkeypatch.setattr(sec.secrets, "token_hex", fake_hex)
        monkeypatch.setattr(sec.secrets, "token_bytes", fake_bytes)
        clock["t"] = NOW
        m = sec.SecretKeyManager(rotation_s=50.0, lifetime_s=120.0,
                                 activation_s=10.0)
        seen = [m.current().to_json(), m.needs_rotation()]
        clock["t"] = NOW + 5.0
        m.rotate()
        seen += [m.current().to_json(), m.needs_rotation()]  # not active yet
        clock["t"] = NOW + 16.0
        seen += [m.current().to_json()]  # the new key is active now
        clock["t"] = NOW + 60.0
        seen += [m.needs_rotation(), m.new_key().to_json()]
        clock["t"] = NOW + 121.0
        m.rotate()  # the first key expired: pruned
        seen += [sorted(k["key_id"] for k in m.export_keys()),
                 m.current().key_id]
        views.append(seen)
        counter = itertools.count()  # the same random stream for each side
    assert views[0] == views[1]


def test_import_prunes_and_promotes(clock):
    keys = _keys(11, 3)
    keys[0]["expires"] = NOW - 1.0  # already expired: dropped on import
    mgrs = _managers(keys)
    assert [sorted(m._keys) for m in mgrs][0] == [sorted(m._keys)
                                                  for m in mgrs][1]
    assert mgrs[0].current().to_json() == mgrs[1].current().to_json()
    assert mgrs[1].current().key_id == keys[-1]["key_id"]
    assert mgrs[1].get(keys[0]["key_id"]) is None


@pytest.mark.parametrize("remaining,has_issuer", [
    (600.0, False), (600.0, True), (14.0, False), (14.0, True),
    (16.0, True), (None, True), (None, False)])
def test_token_store_equal(clock, remaining, has_issuer):
    """The client's cache: a cached token is used until less than 15 s of
    it remains; then (or when none is cached) the issuer, if any, signs a
    fresh one as owner "dn", which is cached in turn."""
    keys = _keys(12)
    out = []
    for (sec, bid_cls), mgr, mod in zip(SIDES, _managers(keys),
                                        (j_dn_client, t_dn_client)):
        store = mod.TokenStore(sec.BlockTokenIssuer(mgr) if has_issuer
                               else None)
        bid = bid_cls(3, 4)
        if remaining is not None:
            tok = sec.BlockTokenIssuer(mgr, token_lifetime_s=remaining).issue(
                bid, [sec.AccessMode.READ], owner="om")
            store.put_block_token(bid, tok)
            store.put_container_token(3, sec.BlockTokenIssuer(
                mgr, token_lifetime_s=remaining).issue_container(3))
        got = (store.block_token(bid), store.container_token(3),
               store.block_token(bid_cls(3, 5)))
        out.append(got)
    assert out[0] == out[1]


def test_gate_refuses_with_the_reference_code(clock):
    """The lanes' shared gate: a refusal is StorageError
    BLOCK_TOKEN_VERIFICATION_FAILED with the verifier's message, counted
    per lane and timed; a disabled verifier lets everything through."""
    from ozone_tpu.storage.ids import BLOCK_TOKEN_VERIFICATION_FAILED as J
    from ozone_tpu_torch.storage.ids import (
        BLOCK_TOKEN_VERIFICATION_FAILED,
        StorageError,
    )

    assert BLOCK_TOKEN_VERIFICATION_FAILED == J
    mgr = tsec.SecretKeyManager(generate=False)
    mgr.import_keys(_keys(13))
    ver = tsec.BlockTokenVerifier(mgr)
    refused = tsec.METRICS.counter("refused_test").value
    n = tsec.METRICS.histogram("verify_test").count
    with pytest.raises(StorageError) as e:
        tsec.gate(ver, "test", None, block_id=TBlockID(1, 1))
    assert (e.value.code, e.value.msg) == (BLOCK_TOKEN_VERIFICATION_FAILED,
                                           "missing block token")
    tok = tsec.BlockTokenIssuer(mgr).issue_container(5)
    tsec.gate(ver, "test", tok, container_id=5)
    assert tsec.METRICS.counter("refused_test").value == refused + 1
    assert tsec.METRICS.histogram("verify_test").count == n + 2
    ver.enabled = False
    tsec.gate(ver, "test", None, block_id=TBlockID(1, 1))
    tsec.gate(None, "test", None, container_id=1)


def test_scm_rotation_direct_and_through_the_ring(clock):
    """The SCM mints its first key when tokens are on (none otherwise),
    rotates when due, and under HA hands the new key to the ring hook
    instead of installing it; the ring's apply of `import-secret-key`
    installs it on every replica. Both packages alike."""
    from ozone_tpu.scm.scm import StorageContainerManager as JScm
    from ozone_tpu_torch.scm.scm import StorageContainerManager as TScm

    out = []
    for Scm in (TScm, JScm):
        off = Scm(stale_after_s=1e6, dead_after_s=2e6)
        off.ensure_secret_key()
        on = Scm(stale_after_s=1e6, dead_after_s=2e6, block_tokens=True)
        on.ensure_secret_key()
        first = on.secret_keys.current()
        on.ensure_secret_key()  # not due: no new key
        ring = []
        on.on_secret_rotate = ring.append
        clock["t"] = NOW + 3601.0
        on.ensure_secret_key()  # due: handed to the ring, not installed
        kept = on.secret_keys.current().key_id == first.key_id
        applied = on.apply_admin_op("import-secret-key", ring[0].to_json())
        replica = Scm(stale_after_s=1e6, dead_after_s=2e6, block_tokens=True)
        replica.apply_admin_op("import-secret-key", ring[0].to_json())
        out.append((off.secret_keys.export_keys(), len(ring), kept,
                    applied == {"key_id": ring[0].key_id},
                    sorted(k["key_id"] for k in on.secret_keys.export_keys())
                    == sorted([first.key_id, ring[0].key_id]),
                    replica.secret_keys.get(ring[0].key_id) is not None,
                    on.secret_keys.activation_s))
        clock["t"] = NOW
    assert out[0] == out[1] == ([], 1, True, True, True, True, 10.0)
