"""The port's native ACLs against `ozone_tpu`'s, on the CPU.

`ozone_tpu_torch/om/acl.py` beside `ozone_tpu/om/acl.py`, and the ACL
verbs of both OMs: `OzoneAcl` parse, str and JSON; add, remove and the
DEFAULT-scope inheritance; `NativeAuthorizer.check` over a seeded grid of
grant chains (volume, bucket, prefixes, key), users, groups, rights and
scopes (and a hypothesis search over the same space); every OM verb the
reference checks, allowed or denied with the same code for the same
caller; ModifyAcl's refusals; FSO key grants; and the ACL verbs over
each package's RPC with the caller identity on the wire. Tolerance is
exact equality throughout.
"""

import itertools

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ozone_tpu.om import acl as j_acl
from ozone_tpu.om import requests as j_rq
from ozone_tpu.om.om import OzoneManager as JOzoneManager
from ozone_tpu.scm.scm import StorageContainerManager as JScm
from ozone_tpu_torch.om import acl as t_acl
from ozone_tpu_torch.om import requests as t_rq
from ozone_tpu_torch.om.om import OzoneManager as TOzoneManager
from ozone_tpu_torch.scm.scm import StorageContainerManager as TScm

EC = "rs-3-2-4096"
ACL_STRINGS = [
    "user:alice:rwl[DEFAULT]", "user:alice:r", "group:devs:wcd[ACCESS]",
    "world::a", "world::r[DEFAULT]", "user:bob:xy", "group:ops:a[DEFAULT]",
    "user:carol:rwcldxy", "USER:dave:l", "user::r", "group:g:cl[access]",
]
BAD_STRINGS = ["user:alice", "user:a:b:c", "robot:x:r", "user:x:q",
               "user:x:r[WHENEVER]"]


def _oms(tmp_path):
    out = []
    for name, Scm, Om in (("port", TScm, TOzoneManager),
                          ("ref", JScm, JOzoneManager)):
        scm = Scm(stale_after_s=1e6, dead_after_s=2e6)
        for i in range(5):
            scm.register_datanode(f"dn{i}")
        om = Om(tmp_path / name / "om.db", scm)
        om.create_volume("v1", owner="owner1")
        om.create_bucket("v1", "b1", EC)
        out.append(om)
    return out


@pytest.fixture
def oms(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    pair = _oms(tmp_path)
    yield pair
    for om in pair:
        om.close()


def _outcome(fn):
    """'ok' and the result, or the error's type name and code."""
    try:
        return ("ok", fn())
    except (t_rq.OMError, j_rq.OMError) as e:
        return (type(e).__name__, e.code)
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("s", ACL_STRINGS + BAD_STRINGS)
def test_parse_str_json_equal(s):
    got = [_outcome(lambda: (str(m.OzoneAcl.parse(s)),
                             m.OzoneAcl.parse(s).to_json(),
                             str(m.OzoneAcl.from_json(
                                 m.OzoneAcl.parse(s).to_json()))))
           for m in (t_acl, j_acl)]
    assert got[0] == got[1]
    assert (got[0][0] == "ok") == (s in ACL_STRINGS)


@pytest.mark.parametrize("seed", range(12))
def test_add_remove_inherit_equal(seed):
    """A seeded sequence of adds and removes on one stored list, each
    step's (list, changed) equal, and its DEFAULT grants inherited alike;
    `normalize_acls` takes strings, dicts and objects alike."""
    rng = np.random.default_rng(seed)
    steps = [(rng.choice(["add", "remove"]),
              ACL_STRINGS[rng.integers(len(ACL_STRINGS))])
             for _ in range(10)]
    seen = []
    for m in (t_acl, j_acl):
        acls, trace = [], []
        for op, s in steps:
            fn = m.add_acl if op == "add" else m.remove_acl
            acls, ch = fn(acls, m.OzoneAcl.parse(s))
            trace.append((list(acls), ch))
        trace.append(m.inherit_defaults(acls))
        trace.append(m.normalize_acls([ACL_STRINGS[seed % 5],
                                       m.OzoneAcl.parse(ACL_STRINGS[1]),
                                       {"type": "world", "rights": ["r"]}]))
        trace.append(m.prefix_key("v", "b", "logs" if seed % 2 else "logs/"))
        seen.append(trace)
    assert seen[0] == seen[1]


def test_rights_and_enums_equal():
    for ta, ja in ((t_acl.ACLRight, j_acl.ACLRight),
                   (t_acl.ACLIdentityType, j_acl.ACLIdentityType),
                   (t_acl.ACLScope, j_acl.ACLScope)):
        assert [(e.name, e.value) for e in ta] == \
            [(e.name, e.value) for e in ja]


USERS = ["alice", "bob", "carol", "owner1", "root", "eve"]
GROUPS = [(), ("devs",), ("ops",), ("devs", "ops")]
RIGHTS = [r.name for r in t_acl.ACLRight]


def _grant_chain(rng) -> list:
    """Random grants on v1, b1, two prefixes and key k (ACCESS and
    DEFAULT), as (obj_type, path, acl string)."""
    out = []
    for obj, path in (("volume", ""), ("bucket", ""), ("prefix", "logs/"),
                      ("prefix", "logs/secret/"), ("key", "logs/secret/k")):
        for _ in range(int(rng.integers(0, 3))):
            who = rng.choice(["user:alice", "user:bob", "group:devs",
                              "group:ops", "world:"])
            letters = "".join(sorted(set(rng.choice(list("rwcldxy"),
                                                    int(rng.integers(1, 4))))))
            scope = rng.choice(["", "[DEFAULT]"])
            out.append((obj, path, f"{who}:{letters}{scope}"))
    return out


def _apply_chain(om, chain):
    s = om.open_key("v1", "b1", "logs/secret/k")
    om.commit_key(s, [], 0)
    for obj, path, acl in chain:
        om.modify_acl(obj, "v1", "b1" if obj != "volume" else "", path,
                      op="add", acls=[acl])


def _decisions(om, keys) -> list:
    om.enable_acls()
    return [_outcome(lambda: om.check_access("v1", "b1", key, right,
                                             user=user, groups=groups))
            for key in keys for user in USERS for groups in GROUPS
            for right in RIGHTS]


@pytest.mark.parametrize("seed", range(16))
def test_authorizer_decisions_equal(oms, seed):
    """Seeded grant chains: every (key, user, groups, right) decision of
    the port's authorizer equals the reference's (the deepest object
    that names the caller decides; owner and superuser always pass)."""
    chain = _grant_chain(np.random.default_rng(seed))
    keys = [None, "logs/app.log", "logs/secret/k", "logs/secret/x", "other"]
    got = []
    for om in oms:
        _apply_chain(om, chain)
        got.append(_decisions(om, keys))
    assert got[0] == got[1]


@settings(max_examples=25, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(grants=st.lists(st.tuples(
    st.sampled_from(["volume", "bucket", "prefix", "key"]),
    st.sampled_from(["user:alice", "user:bob", "group:devs", "world:"]),
    st.sets(st.sampled_from(list("rwcldxy")), min_size=1),
    st.sampled_from(["", "[DEFAULT]"])), max_size=6),
    user=st.sampled_from(USERS), groups=st.sampled_from(GROUPS),
    right=st.sampled_from(RIGHTS))
def test_authorizer_hypothesis(tmp_path_factory, grants, user, groups, right):
    root = tmp_path_factory.mktemp("acl-hyp")
    (root / "port").mkdir()
    (root / "ref").mkdir()
    pair = _oms(root)
    try:
        got = []
        for om in pair:
            _apply_chain(om, [
                (obj, "logs/" if obj == "prefix" else
                 "logs/secret/k" if obj == "key" else "",
                 f"{who}:{''.join(sorted(letters))}{scope}")
                for obj, who, letters, scope in grants])
            om.enable_acls()
            got.append([_outcome(lambda: om.check_access(
                "v1", "b1", key, right, user=user, groups=groups))
                for key in (None, "logs/secret/k", "zzz")])
        assert got[0] == got[1]
    finally:
        for om in pair:
            om.close()


VERBS = {
    "list_keys": lambda om: [k["name"] for k in om.list_keys("v1", "b1")],
    "open_key": lambda om: om.open_key("v1", "b1", "k1").key,
    "lookup_key": lambda om: om.lookup_key("v1", "b1", "k0")["name"],
    "delete_key": lambda om: om.delete_key("v1", "b1", "k0"),
    "rename_key": lambda om: om.rename_key("v1", "b1", "k0", "k9"),
    "set_key_attrs": lambda om: sorted(om.set_key_attrs(
        "v1", "b1", "k0", {"owner": "x"})),
    "create_bucket": lambda om: om.create_bucket("v1", "b7", EC),
    "delete_bucket": lambda om: om.delete_bucket("v1", "b1"),
    "set_bucket_attrs": lambda om: sorted(om.set_bucket_attrs(
        "v1", "b1", {"owner": "x"})),
    "create_volume": lambda om: om.create_volume("v9"),
    "delete_volume": lambda om: om.delete_volume("v1"),
    "create_tenant": lambda om: om.create_tenant("t9"),
    "modify_acl": lambda om: om.modify_acl("bucket", "v1", "b1", op="add",
                                           acls=["user:z:r"]),
    "get_acls": lambda om: om.get_acls("bucket", "v1", "b1"),
    "set_bucket_lifecycle": lambda om: om.set_bucket_lifecycle(
        "v1", "b1", [])["name"],
    "set_bucket_smallobj": lambda om: om.set_bucket_smallobj(
        "v1", "b1")["name"],
}
GRANTS = {"alice": "user:alice:rcl", "bob": "user:bob:wd",
          "carol": "user:carol:xy", "mallory": None}


@pytest.mark.parametrize("verb", sorted(VERBS))
@pytest.mark.parametrize("user", sorted(GRANTS))
def test_om_verbs_allowed_or_denied_alike(oms, verb, user):
    """Each checked OM verb, called as a user holding some rights on the
    bucket: allowed or refused with PERMISSION_DENIED on both OMs."""
    got = []
    for om in oms:
        s = om.open_key("v1", "b1", "k0")
        om.commit_key(s, [], 0)
        if GRANTS[user]:
            om.modify_acl("bucket", "v1", "b1", op="add",
                          acls=[GRANTS[user]])
        om.enable_acls()
        with om.user_context(user):
            got.append(_outcome(lambda: VERBS[verb](om)))
    assert got[0] == got[1]


def test_modify_acl_refusals_equal(oms):
    cases = [
        lambda om: om.modify_acl("bucket", "v1", "nope", op="add",
                                 acls=["user:u:r"]),
        lambda om: om.modify_acl("badtype", "v1", op="add",
                                 acls=["user:u:r"]),
        lambda om: om.modify_acl("key", "v1", "b1", "k-missing", op="add",
                                 acls=["user:u:r"]),
        lambda om: om.modify_acl("bucket", "v1", "b1", op="REPLACE",
                                 acls=["user:u:r"]),
        lambda om: om.modify_acl("volume", "nov", op="add",
                                 acls=["user:u:r"]),
        lambda om: om.get_acls("key", "v1", "b1", "k-missing"),
        lambda om: om.get_acls("prefix", "v1", "b1", "none/"),
        lambda om: om.modify_acl("bucket", "v1", "b1", op="set",
                                 acls=["user:u:r", "world::l"]),
        lambda om: om.get_acls("bucket", "v1", "b1"),
        lambda om: om.modify_acl("bucket", "v1", "b1", op="remove",
                                 acls=["user:u:r"]),
        lambda om: om.modify_acl("bucket", "v1", "b1", op="remove",
                                 acls=["user:u:r"]),
    ]
    got = [[_outcome(lambda: c(om)) for c in cases] for om in oms]
    assert got[0] == got[1]


def test_default_scope_inheritance_equal(oms):
    """DEFAULT grants on the volume reach a new bucket, those on the bucket
    a new key, as ACCESS grants; an open's explicit ACLs win over them."""
    got = []
    for om in oms:
        om.modify_acl("volume", "v1", op="add",
                      acls=["user:team:rwcl[DEFAULT]"])
        om.create_bucket("v1", "b2", EC)
        om.modify_acl("bucket", "v1", "b2", op="add",
                      acls=["group:g:r[DEFAULT]"])
        s = om.open_key("v1", "b2", "k")
        om.commit_key(s, [], 0)
        s = om.open_key("v1", "b2", "explicit", acls=[
            t_acl.OzoneAcl.parse("user:x:r").to_json()])
        om.commit_key(s, [], 0)
        got.append([om.get_acls("bucket", "v1", "b2"),
                    om.get_acls("bucket", "v1", "b1"),
                    om.get_acls("key", "v1", "b2", "k"),
                    om.get_acls("key", "v1", "b2", "explicit")])
    assert got[0] == got[1]


def test_fso_key_acls_equal(oms):
    got = []
    for om in oms:
        om.create_bucket("v1", "fso", EC, layout="FILE_SYSTEM_OPTIMIZED")
        s = om.open_key("v1", "fso", "dir/sub/file.txt")
        om.commit_key(s, [], 0)
        s = om.open_key("v1", "fso", "dir/explicit", acls=[
            t_acl.OzoneAcl.parse("user:y:rw").to_json()])
        om.commit_key(s, [], 0)
        changed = om.modify_acl("key", "v1", "fso", "dir/sub/file.txt",
                                op="add", acls=["user:fred:r"])
        om.enable_acls()
        got.append([changed,
                    om.get_acls("key", "v1", "fso", "dir/sub/file.txt"),
                    om.get_acls("key", "v1", "fso", "dir/explicit"),
                    _outcome(lambda: om.check_access(
                        "v1", "fso", "dir/sub/file.txt", "READ",
                        user="fred")),
                    _outcome(lambda: om.check_access(
                        "v1", "fso", "dir/sub/file.txt", "WRITE",
                        user="fred"))])
    assert got[0] == got[1]
    assert got[0][3][0] == "ok" and got[0][4] == ("ACLDeniedError",
                                                 "PERMISSION_DENIED")


def test_requests_roundtrip_wire_form():
    """The replicated requests of the slice read back their own wire form,
    and the port's forms equal the reference's field for field."""
    def reqs(rq):
        return [
            rq.ModifyAcl("bucket", "v", "b", op="add", acls=[
                {"type": "user", "name": "x", "rights": ["r"],
                 "scope": "ACCESS"}]),
            rq.SetBucketAcl("v", "b", [{"grantee": "*",
                                        "permission": "READ"}]),
            rq.CreateTenant("t", "t", "root", created=1.0),
            rq.DeleteTenant("t"),
            rq.AssignUserToTenant("t", "u", access_id="t$u",
                                  secret="s" * 40),
            rq.RevokeUserAccessId("t$u"),
            rq.NewDTokenMasterKey("k", "00" * 32, 1.0, 2.0),
            rq.StoreDelegationToken({"token_id": "x"}, 3.0),
            rq.RenewDelegationToken("x", "r", 4.0, 5.0),
            rq.CancelDelegationToken("x", "o"),
            rq.PurgeExpiredDTokens(6.0),
            rq.CreateMasterKey("mk", rotate=True, material="00" * 32),
        ]

    for rq in (t_rq, j_rq):
        for r in reqs(rq):
            assert rq.OMRequest.from_json(r.to_json()) == r
    assert [r.to_json() for r in reqs(t_rq)] == \
        [r.to_json() for r in reqs(j_rq)]
    # an open's wire form carries its explicit ACLs and its encryption
    # bundle on both sides
    t = t_rq.OpenKey("v", "b", "k", "c", EC, acls=["a"],
                     encryption={"iv": "00" * 16}).to_json()
    j = j_rq.OpenKey("v", "b", "k", "c", EC, acls=["a"],
                     encryption={"iv": "00" * 16}).to_json()
    assert t == j


def test_acl_verbs_over_the_rpc(tmp_path):
    """ModifyAcl, GetAcls and CheckAccess over each package's RPC, with
    the caller identity bound by the client's user_context: the same
    answers and denial codes."""
    from ozone_tpu.net.daemons import ScmOmDaemon as JDaemon
    from ozone_tpu.net.om_service import GrpcOmClient
    from ozone_tpu_torch.net.daemons import ScmOmDaemon as TDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    got = []
    for Daemon, Client, kw in ((TDaemon, RemoteOmClient, {"device": "cpu"}),
                               (JDaemon, GrpcOmClient, {})):
        meta = Daemon(tmp_path / Daemon.__module__ / "om.db",
                      stale_after_s=1e6, dead_after_s=2e6, **kw)
        meta.start()
        try:
            om = Client(meta.address)
            om.create_volume("v")
            om.create_bucket("v", "b", EC)
            meta.om.enable_acls()
            out = [om.modify_acl("bucket", "v", "b", op="add",
                                 acls=["user:alice:lr"]),
                   om.get_acls("bucket", "v", "b")]
            with om.user_context("alice"):
                out.append(_rpc_outcome(lambda: om.list_keys("v", "b")))
                out.append(_rpc_outcome(lambda: om.delete_bucket("v", "b")))
                out.append(_rpc_outcome(lambda: om.check_access(
                    "v", "b", None, "READ")))
                out.append(_rpc_outcome(lambda: om.create_volume("va")))
            out.append(_rpc_outcome(lambda: om.check_access(
                "v", "b", None, "WRITE", user="bob")))
            out.append(_rpc_outcome(lambda: om.list_keys("v", "b")))
            om.close()
            got.append(out)
        finally:
            meta.stop()
    assert got[0] == got[1]
    assert [x[1] for x in got[0][2:]] == [
        [], "PERMISSION_DENIED", None, "PERMISSION_DENIED",
        "PERMISSION_DENIED", []]


def _rpc_outcome(fn):
    from ozone_tpu.storage.ids import StorageError as JStorageError
    from ozone_tpu_torch.storage.ids import StorageError

    try:
        return ("ok", fn())
    except (StorageError, JStorageError) as e:
        return ("StorageError", e.code)


def test_grid_sizes():
    """The decision grid is what the docstrings say: every user, group
    set and right at each key of the chain."""
    assert len(list(itertools.product(USERS, GROUPS, RIGHTS))) == 168
