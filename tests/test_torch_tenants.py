"""The port's tenants and delegation tokens against `ozone_tpu`'s, on the CPU.

Both OMs in process, with the clock and the `secrets` stream pinned where
a verb draws on them: tenant creation, user assignment (the access id and
its S3 secret), revocation and deletion give the same rows and the same
error codes; the delegation tokens' identifiers and signatures are
byte-equal, and get, verify, renew, cancel and purge answer alike,
refusals included (a tampered token, the wrong renewer, an expired
token, an anonymous remote renewal, and a caller that a token
authenticated asking for another). Over each package's RPC: the admin
verbs, a token authenticating a second client, and the CLI's `tenant`,
`acl` and `sh token` verbs. The S3 gateway's access id -> tenant ->
volume resolution and its 60 s cache. Tolerance is exact equality.
"""

import contextlib
import getpass
import io
import itertools
import json
import secrets
import time

import numpy as np
import pytest

from ozone_tpu.om import dtokens as j_dtokens
from ozone_tpu.om import requests as j_rq
from ozone_tpu.om.om import OzoneManager as JOzoneManager
from ozone_tpu.scm.scm import StorageContainerManager as JScm
from ozone_tpu_torch.om import dtokens as t_dtokens
from ozone_tpu_torch.om import requests as t_rq
from ozone_tpu_torch.om.om import OzoneManager as TOzoneManager
from ozone_tpu_torch.scm.scm import StorageContainerManager as TScm

EC = "rs-3-2-4096"
NOW = 1_760_000_000.5


@pytest.fixture
def oms(tmp_path):
    out = []
    for name, Scm, Om in (("port", TScm, TOzoneManager),
                          ("ref", JScm, JOzoneManager)):
        scm = Scm(stale_after_s=1e6, dead_after_s=2e6)
        for i in range(5):
            scm.register_datanode(f"dn{i}")
        (tmp_path / name).mkdir()
        out.append(Om(tmp_path / name / "om.db", scm))
    yield out
    for om in out:
        om.close()


@contextlib.contextmanager
def pinned(monkeypatch, t=NOW):
    """The clock and the `secrets` stream, restarted for each side."""
    state = {"t": t}
    monkeypatch.setattr(time, "time", lambda: state["t"])

    def reset():
        counter = itertools.count(1)
        monkeypatch.setattr(secrets, "token_hex",
                            lambda n=32: f"{next(counter):0{2 * n}x}")
        monkeypatch.setattr(secrets, "token_bytes",
                            lambda n=32: bytes([next(counter) % 256]) * n)
        state["t"] = t

    state["reset"] = reset
    yield state


def _outcome(fn):
    try:
        return ("ok", fn())
    except (t_rq.OMError, j_rq.OMError) as e:
        return (e.code, e.msg)


def _tenant_script(om) -> list:
    return [
        _outcome(lambda: om.create_tenant("acme")),
        _outcome(lambda: om.create_tenant("acme")),
        _outcome(lambda: om.create_tenant("sneaky", volume="acme")),
        _outcome(lambda: om.create_tenant("corp", volume="corpvol",
                                          owner="boss")),
        _outcome(lambda: om.volume_info("corpvol")),
        _outcome(lambda: om.list_tenants()),
        _outcome(lambda: om.tenant_assign_user("acme", "alice")),
        _outcome(lambda: om.tenant_assign_user("acme", "alice")),
        _outcome(lambda: om.tenant_assign_user("acme", "bob", "acme-bob")),
        _outcome(lambda: om.tenant_assign_user("nope", "carol")),
        _outcome(lambda: om.get_s3_secret("acme$alice", create=False)),
        _outcome(lambda: om.tenant_for_access_id("acme$alice")),
        _outcome(lambda: om.tenant_for_access_id("acme-bob")),
        _outcome(lambda: om.tenant_for_access_id("stranger")),
        _outcome(lambda: sorted(u["access_id"]
                                for u in om.list_tenant_users("acme"))),
        _outcome(lambda: om.delete_tenant("acme")),
        _outcome(lambda: om.tenant_revoke_access("acme$alice")),
        _outcome(lambda: om.tenant_revoke_access("acme$alice")),
        _outcome(lambda: om.get_s3_secret("acme$alice", create=False)),
        _outcome(lambda: om.tenant_revoke_access("acme-bob")),
        _outcome(lambda: om.delete_tenant("acme")),
        _outcome(lambda: om.delete_tenant("acme")),
        _outcome(lambda: om.list_tenants()),
    ]


def test_tenant_lifecycle_equal(oms, monkeypatch):
    got = []
    with pinned(monkeypatch) as clock:
        for om in oms:
            clock["reset"]()
            got.append(_tenant_script(om))
    assert got[0] == got[1]
    assert [x[0] for x in got[0]] == [
        "ok", "TENANT_ALREADY_EXISTS", "VOLUME_ALREADY_EXISTS", "ok", "ok",
        "ok", "ok", "ACCESS_ID_ALREADY_EXISTS", "ok", "TENANT_NOT_FOUND",
        "ok", "ok", "ok", "ok", "ok", "TENANT_NOT_EMPTY", "ok",
        "ACCESS_ID_NOT_FOUND", "ok", "ok", "ok", "TENANT_NOT_FOUND", "ok"]


def test_tenant_admin_verbs_need_a_superuser(oms):
    """With ACLs on, a bound non-superuser is refused every tenant admin
    verb with the same code; root and unbound callers pass."""
    got = []
    for om in oms:
        om.enable_acls(("root",))
        out = []
        with om.user_context("alice"):
            out += [_outcome(lambda: om.create_tenant("t1")),
                    _outcome(lambda: om.tenant_assign_user("t1", "u")),
                    _outcome(lambda: om.delete_tenant("t1"))]
        with om.user_context("root"):
            out.append(_outcome(lambda: om.create_tenant("t1")))
        out.append(_outcome(lambda: om.tenant_assign_user("t1", "u")[
            "access_id"]))
        with om.user_context("alice"):
            out.append(_outcome(lambda: om.tenant_revoke_access("t1$u")))
        got.append(out)
    assert got[0] == got[1]
    assert got[0][0][0] == "PERMISSION_DENIED" and got[0][4] == ("ok", "t1$u")


def _dtoken_script(om, clock) -> list:
    out = []
    with om.user_context("alice"):
        tok = om.get_delegation_token("yarn")
    out.append(tok)
    out.append(om.verify_delegation_token(tok))
    out.append(om.store.get("dtoken_keys", tok["key_id"]))
    for bad in (dict(tok, owner="mallory"), dict(tok, sig="0" * 64),
                {k: v for k, v in tok.items() if k != "renewer"},
                dict(tok, key_id="nokey"), "not-a-dict"):
        out.append(_outcome(lambda: om.verify_delegation_token(bad)))
        out.append(_outcome(lambda: om.renew_delegation_token(bad)))
    with om.user_context("mallory"):
        out.append(_outcome(lambda: om.renew_delegation_token(tok)))
        out.append(_outcome(lambda: om.cancel_delegation_token(tok)))
    with om.user_context("alice"):  # the owner may not renew
        out.append(_outcome(lambda: om.renew_delegation_token(tok)))
    clock["t"] += 100.0
    with om.user_context("yarn"):
        out.append(_outcome(lambda: om.renew_delegation_token(tok)))
    # a caller a token authenticated may not mint another
    with om.user_context("alice", via_token=True):
        out.append(_outcome(lambda: om.get_delegation_token("yarn")))
    # a remote call with no identity may not renew or cancel
    with om.user_context(None):
        out.append(_outcome(lambda: om.renew_delegation_token(tok)))
        out.append(_outcome(lambda: om.cancel_delegation_token(tok)))
    # in process, unbound: acts as the renewer (renew) or owner (cancel)
    out.append(_outcome(lambda: om.renew_delegation_token(tok)))
    with om.user_context("bob"):
        tok2 = om.get_delegation_token("yarn")
    om.dtoken_renew_interval_s = 10.0
    tok3 = om.get_delegation_token("yarn", owner="svc")
    out += [tok2, tok3]
    clock["t"] += 20.0  # tok3's renewable expiry lapses
    out.append(_outcome(lambda: om.verify_delegation_token(tok3)))
    with om.user_context("yarn"):
        out.append(_outcome(lambda: om.renew_delegation_token(tok3)))
        out.append(_outcome(lambda: om.cancel_delegation_token(tok)))
    out.append(_outcome(lambda: om.verify_delegation_token(tok)))
    out.append(_outcome(lambda: om.run_dtoken_cleanup_once()))
    out.append(sorted(k for k, _ in om.store.iterate("delegation_tokens")))
    clock["t"] += 8 * 24 * 3600.0  # past every max date and key expiry
    out.append(_outcome(lambda: om.run_dtoken_cleanup_once()))
    out.append(sorted(k for k, _ in om.store.iterate("dtoken_keys")))
    out.append(_outcome(lambda: om.get_delegation_token("yarn")))
    return out


def test_delegation_tokens_byte_equal(oms, monkeypatch):
    """The same script on both OMs with the clock and the secrets stream
    pinned: every token, row, renewal and refusal equal."""
    got = []
    with pinned(monkeypatch) as clock:
        for om in oms:
            clock["reset"]()
            got.append(_dtoken_script(om, clock))
    assert got[0] == got[1]
    tok = got[0][0]
    assert tok["owner"] == "alice" and tok["issue"] == round(NOW, 3)
    codes = [x[0] for x in got[0] if isinstance(x, tuple)]
    assert set(codes) == {"ok", "TOKEN_ERROR"}


@pytest.mark.parametrize("seed", range(8))
def test_canonical_and_sign_equal(seed):
    rng = np.random.default_rng(seed)
    ident = {"owner": f"u{rng.integers(100)}", "renewer": "yarn",
             "real_user": "r", "issue": float(rng.random() * 1e9),
             "max_date": round(float(rng.random() * 2e9), 3),
             "token_id": f"{int(rng.integers(1 << 30)):08x}",
             "key_id": "k", "extra": "ignored"}
    material = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    assert t_dtokens.canonical(ident) == j_dtokens.canonical(ident)
    assert t_dtokens.sign(material, ident) == j_dtokens.sign(material, ident)
    assert t_dtokens.IDENT_FIELDS == j_dtokens.IDENT_FIELDS


def test_tokens_survive_an_om_restart(oms, tmp_path):
    for om, Om, name in zip(oms, (TOzoneManager, JOzoneManager),
                            ("port", "ref")):
        with om.user_context("alice"):
            tok = om.get_delegation_token("yarn")
        om.close()
        om2 = Om(tmp_path / name / "om.db", om.scm)
        try:
            assert om2.verify_delegation_token(tok)["owner"] == "alice"
        finally:
            om2.close()
        om.store = om2.store  # the fixture closes it again, harmlessly


def _rpc(fn):
    from ozone_tpu.storage.ids import StorageError as JStorageError
    from ozone_tpu_torch.storage.ids import StorageError

    try:
        return ("ok", fn())
    except (StorageError, JStorageError) as e:
        return (e.code, e.msg)


def test_over_the_rpc(tmp_path):
    """Each package's daemon and remote client: tenant admin verbs, a
    delegation token got as alice and used by a second client (a listing
    under alice's grant), the token-authenticated refusal, renew by the
    renewer, cancel, and the cancelled token refused."""
    from ozone_tpu.net.daemons import ScmOmDaemon as JDaemon
    from ozone_tpu.net.om_service import GrpcOmClient
    from ozone_tpu_torch.net.daemons import ScmOmDaemon as TDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    got = []
    for Daemon, Client, kw in (
            (TDaemon, RemoteOmClient, {"device": "cpu",
                                       "acl_enabled": True}),
            (JDaemon, GrpcOmClient, {})):
        meta = Daemon(tmp_path / Daemon.__module__ / "om.db",
                      stale_after_s=1e6, dead_after_s=2e6, **kw)
        if not meta.om.acl_enabled:
            meta.om.enable_acls(("root",))
        meta.start()
        try:
            admin = Client(meta.address)
            out = []
            with admin.user_context("root"):
                admin.create_tenant("corp")
                out.append(sorted(admin.tenant_assign_user("corp", "bob")))
                out.append(admin.tenant_for_access_id("corp$bob")["volume"])
                admin.create_bucket("corp", "b", EC)
                admin.modify_acl("bucket", "corp", "b", op="add",
                                 acls=["user:alice:l"])
            with admin.user_context("alice"):
                tok = admin.get_delegation_token("yarn")
                out.append(_rpc(lambda: admin.create_tenant("x")))
            job = Client(meta.address, token=tok)
            with job.user_context("root"):  # the token outranks the field
                out.append(_rpc(lambda: job.list_keys("corp", "b")))
                out.append(_rpc(lambda: job.delete_bucket("corp", "b")))
                out.append(_rpc(lambda: job.get_delegation_token("yarn")))
            forged = Client(meta.address, token=dict(tok, owner="root"))
            out.append(_rpc(lambda: forged.list_keys("corp", "b")))
            with admin.user_context("yarn"):
                out.append(_rpc(lambda: admin.renew_delegation_token(tok)
                                > tok["issue"]))
            out.append(_rpc(lambda: admin.renew_delegation_token(tok)))
            with admin.user_context("alice"):
                out.append(_rpc(lambda: admin.cancel_delegation_token(tok)))
            out.append(_rpc(lambda: job.list_keys("corp", "b")))
            for c in (admin, job, forged):
                c.close()
            got.append(out)
        finally:
            meta.stop()
    assert got[0] == got[1]
    assert got[0][2][0] == "PERMISSION_DENIED"
    assert got[0][3] == ("ok", [])
    assert [x[0] for x in got[0][4:]] == [
        "PERMISSION_DENIED", "TOKEN_ERROR", "TOKEN_ERROR", "ok",
        "TOKEN_ERROR", "ok", "TOKEN_ERROR"]


def _cli(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_tenant_acl_and_token_verbs(tmp_path):
    """The CLI's `tenant`, `acl` and `sh token` verbs against each
    package's daemon: the same exit codes and the same answers (the
    minted secret and token ids aside)."""
    from ozone_tpu.net.daemons import ScmOmDaemon as JDaemon
    from ozone_tpu.tools import cli as j_cli
    from ozone_tpu_torch.net.daemons import ScmOmDaemon as TDaemon
    from ozone_tpu_torch.tools import cli as t_cli

    got = []
    for Daemon, main, kw in ((TDaemon, t_cli.main, {"device": "cpu"}),
                             (JDaemon, j_cli.main, {})):
        meta = Daemon(tmp_path / Daemon.__module__ / "om.db",
                      stale_after_s=1e6, dead_after_s=2e6, **kw)
        meta.start()
        om = ["--om", meta.address]
        tokf = str(tmp_path / f"{Daemon.__module__}.token")
        try:
            out = []
            for argv in (["tenant", "create", "acme"],
                         ["tenant", "list"],
                         ["tenant", "assign", "acme", "--user", "alice"],
                         ["tenant", "users", "acme"],
                         ["tenant", "delete", "acme"],
                         ["sh", "volume", "create", "/v"],
                         ["sh", "bucket", "create", "/v/b", "--replication",
                          EC],
                         ["acl", "bucket", "add", "/v/b", "-a",
                          "user:alice:rl", "-a", "group:g:w[DEFAULT]"],
                         ["acl", "bucket", "add", "/v/b", "-a",
                          "user:alice:r"],
                         ["acl", "bucket", "get", "/v/b"],
                         ["acl", "prefix", "add", "/v/b/logs", "-a",
                          "world::l"],
                         ["acl", "prefix", "get", "/v/b/logs"],
                         # the login user renews its own token
                         ["sh", "token", "get", "--renewer",
                          getpass.getuser(), "--token", tokf],
                         ["sh", "token", "print", "--token", tokf],
                         ["sh", "token", "renew", "--token", tokf],
                         ["sh", "token", "cancel", "--token", tokf],
                         ["sh", "token", "renew", "--token", tokf]):
                rc, text = _cli(main, argv + om)
                if argv[:2] in (["tenant", "assign"], ["tenant", "list"],
                                ["tenant", "users"], ["sh", "token"]):
                    try:
                        obj = json.loads(text)
                        text = sorted(obj if isinstance(obj, dict)
                                      else obj[0])
                    except ValueError:
                        text = text.replace(tokf, "<file>")
                out.append((rc, text))
            got.append(out)
        finally:
            meta.stop()
    assert got[0] == got[1]
    # a tenant with users refuses deletion; a cancelled token, renewal
    assert [rc for rc, _ in got[0]] == [0] * 4 + [1] + [0] * 11 + [1]


def test_gateway_resolves_tenants_through_a_cache(oms):
    """Access id -> tenant -> volume, cached for 60 s on both gateways:
    one OM lookup for two requests, the untenanted world on s3v."""
    from ozone_tpu.client.dn_client import DatanodeClientFactory as JFactory
    from ozone_tpu.client.ozone_client import OzoneClient as JOzoneClient
    from ozone_tpu.gateway.s3 import S3Gateway as JS3Gateway
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.gateway.s3 import S3Gateway

    got = []
    for om, make in zip(oms, (
            lambda om: S3Gateway(OzoneClient(om, DatanodeClientFactory(),
                                             device="cpu")),
            lambda om: JS3Gateway(JOzoneClient(om, JFactory())))):
        gw = make(om)
        om.create_tenant("acme")
        om.tenant_assign_user("acme", "alice")
        calls = []
        real = om.tenant_for_access_id
        om.tenant_for_access_id = lambda a: (calls.append(a), real(a))[1]
        try:
            got.append([gw._volume_for("acme$alice"),
                        gw._volume_for("acme$alice"),
                        gw._volume_for("plain"), gw._tenant_cache_ttl_s,
                        calls])
        finally:
            del om.tenant_for_access_id
            gw._httpd.server_close()
    assert got[0] == got[1] == [["acme", "acme", "s3v", 60.0,
                                 ["acme$alice", "plain"]]][0]
