"""A token-enforcing, ACL-checking cluster of the port's daemons against
`ozone_tpu`'s, on the CPU.

Each side runs an ScmOmDaemon with block tokens (`insecure_secrets`: the
keys ride Register and Heartbeat in the clear) and the native authorizer
on, and DatanodeDaemons on loopback, each with its native sidecar. On
every datanode lane (the RPC verbs, the native sidecar, a RATIS/THREE
pipeline's Submit) the same bad requests (no token, a forged signature,
an expired token, a READ token used to write, block A's token on block
B, a container token for another container) are refused with the same
code and message on both sides, and the container is left as it was. A
datanode that learned tokens are on but holds no key refuses everything
(fails closed) until the keys arrive. The slice whole: two tenants' S3
PUTs and GETs through a gateway with require_auth, the SCM-driven
reconstruction of a dead datanode's units (the datanode signs its own
repair traffic), and a degraded GET, each with the same answers, the
same parity and CRC words per unit and every byte read back. Tolerance
is exact equality throughout.
"""

import time

import numpy as np
import pytest
import torch

from ozone_tpu import admission as j_admission
from ozone_tpu.client.dn_client import DatanodeClientFactory as JFactory
from ozone_tpu.client.native_dn import NativeDatanodeClient as JNative
from ozone_tpu.client.ozone_client import OzoneClient as JOzoneClient
from ozone_tpu.gateway.s3 import S3Gateway as JS3Gateway
from ozone_tpu.net import daemons as j_daemons
from ozone_tpu.net.dn_service import GrpcDatanodeClient
from ozone_tpu.net.om_service import GrpcOmClient
from ozone_tpu.net.ratis_service import GrpcRatisClient
from ozone_tpu.net.ratis_service import RatisClientFactory as JRatisFactory
from ozone_tpu.storage import ids as j_ids
from ozone_tpu.utils import checksum as j_checksum
from ozone_tpu.utils import security as j_sec
from ozone_tpu_torch import admission
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.native_dn import NativeDatanodeClient
from ozone_tpu_torch.client.ozone_client import OzoneClient
from ozone_tpu_torch.gateway.s3 import S3Gateway
from ozone_tpu_torch.gateway.s3_auth import request_headers
from ozone_tpu_torch.net import daemons
from ozone_tpu_torch.net.dn_service import RpcDatanodeClient
from ozone_tpu_torch.net.om_service import RemoteOmClient
from ozone_tpu_torch.net.ratis_service import RatisClientFactory
from ozone_tpu_torch.net.ratis_service import RemoteRatisClient
from ozone_tpu_torch.storage import ids as t_ids
from ozone_tpu_torch.utils import checksum as t_checksum
from ozone_tpu_torch.utils import security as t_sec

EC = "rs-3-2-4096"
WAIT_S = 20.0
CODE = "BLOCK_TOKEN_VERIFICATION_FAILED"


@pytest.fixture(autouse=True)
def _quiet_codec(monkeypatch):
    """Direct codec route and one torch thread (as tests/test_torch_daemons
    runs its clusters)."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait(what: str, cond, timeout_s: float = WAIT_S) -> None:
    t_end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"{what} within {timeout_s} s")
        time.sleep(0.05)


def _data(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


class Side:
    """One secure cluster, the port's or the reference's, and a client."""

    def __init__(self, port: bool, root, n_dn=6, distribute=True):
        mod = daemons if port else j_daemons
        self.port = port
        self.ids = t_ids if port else j_ids
        self.sec = t_sec if port else j_sec
        self.checksum = t_checksum if port else j_checksum
        kw = {"device": "cpu"} if port else {}
        self.meta = mod.ScmOmDaemon(
            root / "om.db", block_size=4 * 4096, container_size=1024 * 1024,
            stale_after_s=1000.0, dead_after_s=2000.0,
            background_interval_s=0.2, block_tokens=True,
            insecure_secrets=True,
            **(dict(kw, acl_enabled=True) if port else {}))
        if not port:
            self.meta.om.enable_acls(("root",))
        self.meta.scm_service.distribute_secrets = distribute
        self.meta.start()
        self.dns = [mod.DatanodeDaemon(root / f"dn{i}", f"dn{i}",
                                       self.meta.address,
                                       heartbeat_interval_s=0.2, **kw)
                    for i in range(n_dn)]
        for d in self.dns:
            d.start()
        _wait("every verifier on", lambda: all(d.verifier.enabled
                                              for d in self.dns))
        self.oz = self.client()

    def client(self):
        if self.port:
            f = DatanodeClientFactory()
            return OzoneClient(
                RemoteOmClient(self.meta.address, clients=f), f,
                device="cpu",
                ratis_clients=RatisClientFactory(
                    address_source=f.remote_address))
        f = JFactory()
        return JOzoneClient(GrpcOmClient(self.meta.address, clients=f), f,
                            ratis_clients=JRatisFactory(
                                address_source=f.remote_address))

    def daemon(self, dn_id):
        return next(d for d in self.dns if d.dn.id == dn_id)

    def issuer(self, lifetime=600.0):
        return self.sec.BlockTokenIssuer(self.meta.scm.secret_keys,
                                         token_lifetime_s=lifetime)

    def rpc(self, d, tokens=None):
        cls = RpcDatanodeClient if self.port else GrpcDatanodeClient
        return cls(d.dn.id, d.address, tokens=tokens)

    def native(self, d, tokens):
        cls = NativeDatanodeClient if self.port else JNative
        return cls(d.dn.id, d.address, tokens=tokens)

    def ratis(self, d):
        cls = RemoteRatisClient if self.port else GrpcRatisClient
        return cls(d.dn.id, d.address)

    def stop(self):
        for d in self.dns:
            d.stop()
        self.meta.stop()


class Fixed:
    """A TokenStore that hands out one chosen token for everything."""

    def __init__(self, tok):
        self.tok = tok

    def block_token(self, block_id):
        return self.tok

    def container_token(self, container_id):
        return self.tok


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("secure")
    mp = pytest.MonkeyPatch()
    mp.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    sides = []
    try:
        for port in (True, False):
            s = Side(port, root / ("port" if port else "ref"))
            sides.append(s)
            b = s.oz.create_volume("v").create_bucket("b", replication=EC)
            b.write_key("k", _data(1, 40_000))
            r = s.oz.get_volume("v").create_bucket("r",
                                                   replication="RATIS/THREE")
            r.write_key("k", _data(2, 20_000))
        yield sides
    finally:
        for s in sides:
            s.stop()
        mp.undo()


def _info(s, bid):
    """A chunk descriptor of `bid` (a read names one)."""
    ck = s.checksum.Checksum(s.checksum.ChecksumType.CRC32C, 4096)
    return s.ids.ChunkInfo(f"{bid}_chunk_0", 0, 4096,
                           ck.compute(np.zeros(4096, np.uint8)))


def _group(s, bucket):
    info = s.oz.om.lookup_key("v", bucket, "k")
    return s.oz.om.key_block_groups(info)[0]


def _bad_token(s, case, bid, cid):
    """(token, block id to aim at) for one refusal case."""
    A = s.sec.AccessMode
    other = s.ids.BlockID(bid.container_id, bid.local_id + 7)
    if case == "none":
        return None, bid
    if case == "forged":
        tok = dict(s.issuer().issue(bid, [A.READ, A.WRITE]))
        tok["sig"] = ("0" if tok["sig"][0] != "0" else "1") + tok["sig"][1:]
        return tok, bid
    if case == "expired":
        return s.issuer(lifetime=-60.0).issue(bid, [A.READ, A.WRITE]), bid
    if case == "read_for_write":
        return s.issuer().issue(bid, [A.READ]), bid
    if case == "other_block":
        return s.issuer().issue(other, [A.READ, A.WRITE]), bid
    return s.issuer().issue_container(cid + 1000), bid  # other_container


def _state(s, d, cid, bid):
    """What a refused request must not change: the container's state and
    blocks, and whether the aimed-at block exists."""
    c = d.dn.containers.get(cid)
    blocks = sorted((b.block_id.local_id, len(b.chunks))
                    for b in d.dn.list_blocks(cid))
    try:
        d.dn.get_block(bid)
        exists = True
    except Exception:  # noqa: BLE001 - NO_SUCH_BLOCK on either side
        exists = False
    return c.state.value, blocks, exists


CASES = ["none", "forged", "expired", "read_for_write", "other_block",
         "other_container"]


@pytest.mark.parametrize("lane", ["rpc", "native", "ratis"])
@pytest.mark.parametrize("case", CASES)
def test_lane_refusals(pair, lane, case):
    """One bad request on one lane of each cluster: refused with
    BLOCK_TOKEN_VERIFICATION_FAILED and the verifier's message (equal on
    both sides), nothing changed in the container."""
    answers = []
    for s in pair:
        g = _group(s, "r" if lane == "ratis" else "b")
        cid = g.container_id
        fresh = s.ids.BlockID(cid, g.local_id + 10_000)
        d = s.daemon(g.pipeline.nodes[0])
        tok, bid = _bad_token(s, case, fresh, cid)
        before = _state(s, d, cid, bid)
        data = _data(3, 4096)
        ck = s.checksum.Checksum(s.checksum.ChecksumType.CRC32C, 4096)
        info = s.ids.ChunkInfo(f"{bid}_chunk_0", 0, 4096, ck.compute(data))
        rpc_calls = d.dn.metrics.counter("rpc_chunk_calls").value
        with pytest.raises(Exception) as e:
            if lane == "rpc":
                c = s.rpc(d, Fixed(tok))
                try:
                    if case == "other_container":
                        c.close_container(cid)
                    else:
                        c.write_chunk(bid, info, data)
                finally:
                    c.close()
            elif lane == "native":
                c = s.native(d, Fixed(tok))
                try:
                    c.write_chunks_commit(
                        bid, [(info, data)],
                        commit=s.ids.BlockData(bid, [info]))
                finally:
                    c.close()
            else:
                c = s.ratis(d)
                if case == "other_container":
                    req = {"verb": "close_container", "container_id": cid,
                           "container_token": tok}
                else:
                    req = {"verb": "write_chunk_commit",
                           "block_id": bid.to_json(), "offset": 0,
                           "length": 4096}
                    if tok is not None:
                        req["token"] = tok
                c.submit(g.pipeline.id, req, timeout=5.0)
        answers.append((e.value.code, e.value.msg))
        assert _state(s, d, cid, bid) == before
        if lane == "native":  # the sidecar refused it, not the RPC
            assert d.dn.metrics.counter("rpc_chunk_calls").value == rpc_calls
    assert answers[0] == answers[1]
    assert answers[0][0] == CODE


def test_lane_refusals_are_counted_per_lane(pair):
    """The port counts and times every check per lane (`security`
    registry): the refusals above landed on the lanes they were sent to."""
    port = pair[0]
    g = _group(port, "b")
    d = port.daemon(g.pipeline.nodes[0])
    bid = port.ids.BlockID(g.container_id, g.local_id + 20_000)
    for lane in ("rpc", "native"):
        before = t_sec.METRICS.counter(f"refused_{lane}").value
        c = port.rpc(d) if lane == "rpc" else port.native(d, Fixed(None))
        with pytest.raises(t_ids.StorageError):
            c.get_block(bid) if lane == "rpc" else \
                c.read_chunks(bid, [_info(port, bid)])
        c.close()
        assert t_sec.METRICS.counter(f"refused_{lane}").value == before + 1
        assert t_sec.METRICS.histogram(f"verify_{lane}").count > 0


def test_tokened_verbs_served(pair):
    """With the tokens the OM granted, every lane serves: the keys read
    back over the native lane, a datanode's own RPC client with a token
    store, and the RATIS key through its ring."""
    out = []
    for s in pair:
        oz = s.client()
        got = [oz.get_volume("v").get_bucket(b).read_key("k").tobytes()
               for b in ("b", "r")]
        out.append(got)
    assert out[0] == out[1]
    assert out[0] == [_data(1, 40_000).tobytes(), _data(2, 20_000).tobytes()]


def test_datanodes_fail_closed_until_keys_arrive(tmp_path):
    """A cluster whose SCM does not hand the keys out yet: every datanode
    turned its verifier on at the first answer that said tokens are on,
    and refuses even an OM-minted token on every lane ("unknown/expired
    secret key"); once the keys ride the heartbeats, the same token
    passes the check (the verb then answers CONTAINER_NOT_FOUND)."""
    answers = []
    for port in (True, False):
        s = Side(port, tmp_path / ("port" if port else "ref"), n_dn=1,
                 distribute=False)
        try:
            d = s.dns[0]
            assert d.verifier.enabled and not d.secrets.export_keys()
            bid = s.ids.BlockID(1, 1)
            tok = s.issuer().issue(bid, [s.sec.AccessMode.READ,
                                         s.sec.AccessMode.WRITE])
            refusals = []
            rpc = s.rpc(d, Fixed(tok))
            native = s.native(d, Fixed(tok))
            for call in (lambda: rpc.get_block(bid),
                         lambda: native.read_chunks(bid, [_info(s, bid)]),
                         lambda: s.ratis(d).submit(
                             7, {"verb": "write_chunk_commit",
                                 "block_id": bid.to_json(), "offset": 0,
                                 "length": 1, "token": tok}, timeout=2.0)):
                with pytest.raises(Exception) as e:
                    call()
                refusals.append((e.value.code, e.value.msg))
            s.meta.scm_service.distribute_secrets = True
            _wait("the keys on the datanode",
                  lambda: d.secrets.get(tok["key_id"]) is not None)
            with pytest.raises(Exception) as e:
                rpc.get_block(bid)
            refusals.append(e.value.code)
            rpc.close()
            native.close()
            answers.append(refusals)
        finally:
            s.stop()
    assert answers[0] == answers[1]
    assert answers[0][:3] == [(CODE, "unknown/expired secret key")] * 3
    assert answers[0][3] == "CONTAINER_NOT_FOUND"


# ------------------------------------------------------------ the slice whole
class S3:
    """A SigV4 client of one gateway (the port's signer for both)."""

    def __init__(self, gw, access_id, secret):
        import http.client

        self.gw, self.access_id, self.secret = gw, access_id, secret
        self.conn = http.client.HTTPConnection(gw.address, timeout=60)

    def req(self, method, path, body=b"", extra=None, sign=True):
        hdrs, body = request_headers(
            self.gw.address, method, path, body, extra,
            self.access_id if sign else None, self.secret, False)
        self.conn.request(method, path, body=body, headers=hdrs)
        r = self.conn.getresponse()
        data = r.read()
        if r.getheader("Connection", "").lower() == "close":
            self.conn.close()
        return r.status, data


def _units(s, info) -> list:
    """[(group, unit, offset, length, CRC words)] of a key, per unit
    index (placement-independent)."""
    out = []
    for gi, g in enumerate(info["block_groups"]):
        bid = s.ids.BlockID(int(g["container_id"]), int(g["local_id"]))
        for u, dn_id in enumerate(g["nodes"]):
            d = s.daemon(dn_id)
            try:
                block = d.dn.get_block(bid)
            except Exception:  # noqa: BLE001 - a unit the data never reached
                continue
            out += [(gi, u, c.offset, c.length, c.checksum.checksums)
                    for c in block.chunks]
    return out


def _slice(s) -> dict:
    """Two tenants' S3 traffic, the token-signed repair of a dead
    datanode, then a degraded GET; what a reader sees."""
    om = s.meta.om  # in-process admin, as an operator's superuser
    out: dict = {}
    om.create_tenant("t1")
    om.create_tenant("t2")
    creds = {t: om.tenant_assign_user(t, "alice") for t in ("t1", "t2")}
    out["access_ids"] = sorted(c["access_id"] for c in creds.values())
    gw = (S3Gateway(s.oz, replication=EC, require_auth=True) if s.port
          else JS3Gateway(s.oz, replication=EC, require_auth=True))
    gw.start()
    try:
        c1 = S3(gw, creds["t1"]["access_id"], creds["t1"]["secret"])
        c2 = S3(gw, creds["t2"]["access_id"], creds["t2"]["secret"])
        answers = [c1.req("PUT", "/alpha")[0], c2.req("PUT", "/beta")[0],
                   c1.req("PUT", "/alpha/k", _data(4, 30_000).tobytes())[0],
                   c2.req("PUT", "/beta/k", _data(5, 25_000).tobytes())[0]]
        # each tenant sees its own namespace: the other's bucket is not
        # there (NoSuchBucket), and the listing names its buckets only
        answers += [c1.req("GET", "/beta/k")[0], c2.req("PUT", "/alpha/x",
                                                        b"x")[0],
                    c1.req("GET", "/")[1].count(b"<Bucket>"),
                    c1.req("GET", "/alpha/k", sign=False)[0]]
        out["answers"] = answers
        out["tenant_volumes"] = [om.tenant_for_access_id(
            c["access_id"])["volume"] for c in creds.values()]
        infos = [om.lookup_key("t1", "alpha", "k"),
                 om.lookup_key("t2", "beta", "k")]
        out["units"] = [_units(s, i) for i in infos]
        out["get"] = [c1.req("GET", "/alpha/k")[1], c2.req("GET", "/beta/k")[1]]
        # the repair: a holder of unit 1 dies once the SCM holds every
        # replica of the closed groups; the SCM plans, a datanode rebuilds
        # with the tokens it signs itself
        groups = s.oz.om.key_block_groups(infos[0])
        for g in groups:
            for d in s.dns:
                if d.dn.id in g.pipeline.nodes:
                    try:
                        d.dn.close_container(g.container_id)
                    except Exception:  # noqa: BLE001 - already closed
                        pass

        def indexes(skip=None):
            return [sorted(r.replica_index for dn, r in s.meta.scm.containers
                           .get(g.container_id).replicas.items()
                           if dn != skip) for g in groups]

        _wait("the SCM's replica map",
              lambda: all(v == [1, 2, 3, 4, 5] for v in indexes()) and all(
                  s.meta.scm.containers.get(g.container_id).state.name
                  == "CLOSED" for g in groups))
        victim_id = groups[0].pipeline.nodes[1]
        victim = s.daemon(victim_id)
        bid = s.ids.BlockID(groups[0].container_id, groups[0].local_id)
        lost = [(ch.offset, ch.length, ch.checksum.checksums,
                 victim.dn.read_chunk(bid, ch).tobytes())
                for ch in victim.dn.get_block(bid).chunks]
        victim.stop()
        s.meta.scm.nodes.get(victim_id).last_heartbeat = -1e9
        s.meta.scm.nodes.check_liveness()
        _wait("the token-signed reconstruction",
              lambda: all(v == [1, 2, 3, 4, 5] for v in indexes(victim_id)),
              timeout_s=40.0)
        c = s.meta.scm.containers.get(groups[0].container_id)
        holder = next(dn for dn, r in c.replicas.items()
                      if r.replica_index == 2 and dn != victim_id)
        hd = s.daemon(holder).dn
        rebuilt = [(ch.offset, ch.length, ch.checksum.checksums,
                    hd.read_chunk(bid, ch, verify=True).tobytes())
                   for ch in hd.get_block(bid).chunks]
        out["rebuilt_equals_lost"] = rebuilt == lost
        out["lost"] = lost
        out["repair_failed"] = [d.failed_commands for d in s.dns
                                if getattr(d, "failed_commands", None)]
        # degraded: with the victim, unit 0's holder down too (the key
        # row still names the victim: readers decode units 0 and 1)
        s.daemon(groups[0].pipeline.nodes[0]).stop()
        out["degraded"] = c1.req("GET", "/alpha/k")[1]
    finally:
        gw.stop()
    return out


def test_two_tenants_repair_and_degraded_get(tmp_path):
    """The slice whole on each side, one after the other: tenants' S3
    traffic under require_auth, a dead datanode's units rebuilt by the
    SCM's reconstruction with self-signed tokens, a degraded GET. Equal
    answers, unit CRC words, rebuilt bytes; every byte read back."""
    admission.reset_for_tests()
    j_admission.reset_for_tests()
    results = []
    for port in (True, False):
        s = Side(port, tmp_path / ("port" if port else "ref"), n_dn=6)
        try:
            results.append(_slice(s))
        finally:
            s.stop()
    port, ref = results
    assert port == ref
    assert port["answers"] == [200, 200, 200, 200, 404, 404, 1, 403]
    assert port["tenant_volumes"] == ["t1", "t2"]
    assert port["get"] == [_data(4, 30_000).tobytes(),
                           _data(5, 25_000).tobytes()]
    assert port["degraded"] == _data(4, 30_000).tobytes()
    assert port["rebuilt_equals_lost"] and port["repair_failed"] == []


# ------------------------------------------------------ mutual TLS (secure)
#: the reference's full posture (tests/test_block_tokens.py): mutual TLS on
#: every channel, the CA in the SCM, datanodes enrolled over the plaintext
#: CSR endpoint under a bootstrap secret, block tokens on the datapath
#: whose keys ride only the mutual-TLS channels
ENROLL_SECRET = "drill-secret"


@pytest.fixture(scope="module")
def secure_cluster(tmp_path_factory):
    pytest.importorskip("cryptography")
    root = tmp_path_factory.mktemp("mtls")
    meta = daemons.ScmOmDaemon(
        root / "om.db", block_size=4 * 4096, container_size=1024 * 1024,
        stale_after_s=1000.0, dead_after_s=2000.0,
        background_interval_s=0.2, block_tokens=True, secure=True,
        enrollment_secret=ENROLL_SECRET, device="cpu")
    meta.start()
    dns = []
    try:
        for i in range(5):  # the reference's five: a repair targets the victim
            d = daemons.DatanodeDaemon(
                root / f"dn{i}", f"dn{i}", meta.address,
                heartbeat_interval_s=0.2, ca_address=meta.enroll_address,
                enrollment_secret=ENROLL_SECRET, device="cpu")
            d.start()
            dns.append(d)
        _wait("every datanode enforcing, with the keys", lambda: all(
            d.verifier.enabled and d.secrets.current() is not None
            for d in dns))
        yield meta, dns
    finally:
        for d in dns:
            d.stop()
        meta.stop()


@pytest.fixture(scope="module")
def client_tls(secure_cluster, tmp_path_factory):
    """An enrolled client certificate: the ticket onto the wire, apart
    from any token (an authenticated caller may still be unauthorized)."""
    from ozone_tpu_torch.utils.ca import CertificateClient

    meta, _ = secure_cluster
    cc = CertificateClient(tmp_path_factory.mktemp("cli"), "client-cli")
    cc.enroll_remote(meta.enroll_address, secret=ENROLL_SECRET)
    return cc.tls()


def _secure_client(meta, tls):
    clients = DatanodeClientFactory()
    clients.tls = tls
    return OzoneClient(RemoteOmClient(meta.address, clients=clients, tls=tls),
                       clients, device="cpu")


def _first_unit(meta, dns, oz, volume, bucket, key):
    info = oz.om.lookup_key(volume, bucket, key)
    g = info["block_groups"][0]
    bid = t_ids.BlockID(int(g["container_id"]), int(g["local_id"]))
    dn_id = g["nodes"][0]
    return bid, dn_id, next(d.address for d in dns if d.dn.id == dn_id)


def test_secure_enforcement_active_on_datanodes(secure_cluster, tmp_path):
    """Tokens on, every server on mutual TLS with the CRL checked, the
    keys delivered over it, and no native sidecar anywhere."""
    meta, dns = secure_cluster
    assert meta.scm.block_tokens and meta.om.token_issuer is not None
    assert meta.server.tls_enabled and meta.scm_service.distribute_secrets
    assert meta.ca is not None and meta.enroll_address
    for d in dns:
        assert d.verifier.enabled and d.secrets.current() is not None
        assert d.server.tls_enabled and d.server.crl_provider is not None
        assert d.datapath is None and d.advertise() is None
    with pytest.raises(ValueError):
        # open CSR signing would admit any caller: a secret is required
        daemons.ScmOmDaemon(tmp_path / "om.db", block_tokens=True,
                            secure=True, device="cpu")


def test_secure_tokened_write_and_read(secure_cluster, client_tls):
    """The client path over mutual TLS, plain and TDE: allocations carry
    WRITE tokens, lookups READ tokens, every chunk rides the RPC lane."""
    meta, dns = secure_cluster
    oz = _secure_client(meta, client_tls)
    try:
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        data = _data(3, 50_000)
        b.write_key("k", data)
        assert np.array_equal(b.read_key("k"), data)
        with oz.om.user_context("root"):
            oz.om.kms_create_key("mk1")
        oz.om.create_bucket("v", "enc", EC, encryption_key="mk1")
        e = oz.get_volume("v").get_bucket("enc")
        e.write_key("k", data)
        assert np.array_equal(e.read_key("k"), data)
        assert np.array_equal(e.read_key_range("k", 4095, 20_000),
                              data[4095:24_095])
        lanes = [d.lane_counts() for d in dns]
        assert sum(c["rpc_chunk_calls"] for c in lanes) > 0
        assert sum(c["native_write_streams"] + c["native_read_streams"]
                   for c in lanes) == 0
    finally:
        oz.om.close()
        oz.clients.close()


def test_secure_untokened_write_refused(secure_cluster, client_tls):
    """An authenticated caller (through the handshake) without tokens
    writes nothing."""
    meta, dns = secure_cluster
    c = RpcDatanodeClient("dn0", dns[0].address, tls=client_tls)
    data = np.zeros(512, dtype=np.uint8)
    cs = t_checksum.Checksum(t_checksum.ChecksumType.CRC32C, 4096).compute(data)
    info = t_ids.ChunkInfo("c0", 0, data.size, cs)
    try:
        with pytest.raises(t_ids.StorageError) as e:
            c.create_container(7777)
        assert e.value.code == CODE
        with pytest.raises(t_ids.StorageError) as e:
            c.write_chunk(t_ids.BlockID(7777, 1), info, data)
        assert e.value.code == CODE
    finally:
        c.close()


def test_secure_untokened_read_refused(secure_cluster, client_tls):
    meta, dns = secure_cluster
    oz = _secure_client(meta, client_tls)
    try:
        oz.get_volume("v").get_bucket("b").write_key("r", _data(4, 9_000))
        bid, dn_id, addr = _first_unit(meta, dns, oz, "v", "b", "r")
    finally:
        oz.om.close()
        oz.clients.close()
    c = RpcDatanodeClient(dn_id, addr, tls=client_tls)  # no token store
    try:
        for fn in (lambda: c.get_block(bid),
                   lambda: c.list_blocks(bid.container_id),
                   lambda: c.get_committed_block_length(bid)):
            with pytest.raises(t_ids.StorageError) as e:
                fn()
            assert e.value.code == CODE
    finally:
        c.close()


@pytest.mark.parametrize("case", ["wrong-block", "expired", "read-to-write"])
def test_secure_bad_tokens_refused(secure_cluster, client_tls, case):
    """A real token for another block, an expired one, and a READ token
    used to write: each BLOCK_TOKEN_VERIFICATION_FAILED over mutual TLS."""
    from ozone_tpu_torch.client.dn_client import TokenStore

    meta, dns = secure_cluster
    oz = _secure_client(meta, client_tls)
    try:
        oz.get_volume("v").get_bucket("b").write_key("t", _data(5, 9_000))
        bid, dn_id, addr = _first_unit(meta, dns, oz, "v", "b", "t")
    finally:
        oz.om.close()
        oz.clients.close()
    read = [t_sec.AccessMode.READ]
    if case == "wrong-block":
        other = t_ids.BlockID(bid.container_id, bid.local_id + 999)
        tok = meta.om.token_issuer.issue(other, read)
    elif case == "expired":
        tok = t_sec.BlockTokenIssuer(meta.scm.secret_keys,
                                     token_lifetime_s=-1.0).issue(bid, read)
    else:
        tok = meta.om.token_issuer.issue(bid, read)
    store = TokenStore()
    store.put_block_token(bid, tok)
    c = RpcDatanodeClient(dn_id, addr, tokens=store, tls=client_tls)
    try:
        if case == "read-to-write":
            c.get_block(bid)  # READ is fine
            data = np.zeros(16, dtype=np.uint8)
            cs = t_checksum.Checksum(t_checksum.ChecksumType.CRC32C,
                                     4096).compute(data)
            fn = lambda: c.write_chunk(  # noqa: E731
                bid, t_ids.ChunkInfo("cx", 10**9, 16, cs), data)
        else:
            fn = lambda: c.get_block(bid)  # noqa: E731
        with pytest.raises(t_ids.StorageError) as e:
            fn()
        assert e.value.code == CODE
    finally:
        c.close()


def test_secure_uncertified_caller_rejected_at_transport(secure_cluster):
    """No CA-issued certificate: the handshake itself fails, so the caller
    never reaches a verb, let alone Register and the keys; the refusal
    is UNAVAILABLE (the reference's gRPC status), never a plaintext
    retry."""
    from ozone_tpu_torch.net.scm_service import RemoteScmClient

    meta, dns = secure_cluster
    c = RpcDatanodeClient("dn0", dns[0].address)  # plaintext channel
    with pytest.raises(t_ids.StorageError) as e:
        c.echo(b"hi")
    assert e.value.code in ("UNAVAILABLE", "IO_EXCEPTION")
    c.close()
    scm = RemoteScmClient(meta.address)
    with pytest.raises(t_ids.StorageError):
        scm.register("evil", "127.0.0.1:1", rack="/r")
    assert not scm.security.get("secret_keys")
    scm.close()


def test_secure_bad_enrollment_secret_refused(secure_cluster, tmp_path):
    from ozone_tpu_torch.utils.ca import CertificateClient

    meta, _ = secure_cluster
    cc = CertificateClient(tmp_path / "rogue", "client-rogue")
    with pytest.raises(t_ids.StorageError) as e:
        cc.enroll_remote(meta.enroll_address, secret="wrong")
    assert e.value.code == "IO_EXCEPTION"
    assert not cc.enrolled


def test_secure_live_cert_renewal(secure_cluster, client_tls):
    """A datanode's certificate forced into the grace window renews over
    the enrollment endpoint, and tokened traffic keeps flowing over the
    renewed identity with no restart."""
    meta, dns = secure_cluster
    d = dns[0]
    assert d.cert_renewal is not None and meta.cert_renewal is not None
    old = d.cert_client.cert.serial_number
    assert d.cert_renewal.check_once() is False
    d.cert_client.install(
        meta.ca.sign_csr(d.cert_client.make_csr(), valid_days=0),
        meta.ca.root_pem)
    d.tls.reload()
    assert d.cert_renewal.check_once() is True
    assert d.cert_client.cert.serial_number != old
    assert d.cert_client.remaining_fraction() > 0.9
    oz = _secure_client(meta, client_tls)
    try:
        b = oz.create_volume("vrenew").create_bucket("b", replication=EC)
        data = _data(9, 30_000)
        b.write_key("post-renewal", data)
        assert np.array_equal(b.read_key("post-renewal"), data)
    finally:
        oz.om.close()
        oz.clients.close()


def test_secure_reconstruction_self_signs(secure_cluster, client_tls):
    """Datanode-to-datanode repair over mutual TLS signs its own tokens:
    a replica deleted under a closed container is rebuilt by the SCM's
    reconstruction, and the key reads back."""
    meta, dns = secure_cluster
    oz = _secure_client(meta, client_tls)
    try:
        b = oz.get_volume("v").get_bucket("b")
        data = _data(4, 30_000)
        b.write_key("k2", data)
        info = oz.om.lookup_key("v", "b", "k2")
        g = info["block_groups"][0]
        cid = int(g["container_id"])
        for d in dns:
            if d.dn.id in g["nodes"]:
                try:
                    d.dn.close_container(cid)
                except t_ids.StorageError:
                    pass
        victim = next(d for d in dns if d.dn.id == g["nodes"][0])
        victim.dn.delete_container(cid, force=True)

        def rebuilt():
            return any(c0.id == cid for c0 in victim.dn.list_containers())

        _wait("the reconstruction restored the replica", rebuilt, 30.0)
        assert np.array_equal(b.read_key("k2"), data)
    finally:
        oz.om.close()
        oz.clients.close()


def test_secure_revoked_client_refused(secure_cluster, tmp_path):
    """`admin cert-revoke` on the CA's replica: the revoked client's next
    call is CERTIFICATE_REVOKED there at once and on a datanode after its
    trust refresh; `cert-list` marks it."""
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.utils.ca import CertificateClient

    meta, dns = secure_cluster
    cc = CertificateClient(tmp_path / "doomed", "client-doomed")
    cc.enroll_remote(meta.enroll_address, secret=ENROLL_SECRET)
    tls = cc.tls()
    scm = RemoteScmClient(meta.address, tls=tls)
    dn = RpcDatanodeClient(dns[1].dn.id, dns[1].address, tls=tls)
    admin = RemoteScmClient(meta.address, tls=cc_admin(meta, tmp_path))
    try:
        assert scm.status()["nodes"]
        assert bytes(dn.echo(b"x")) == b"x"
        out = admin.admin("cert-revoke", str(tls.serial()))["result"]
        assert tls.serial() in out["crl"] and "warning" not in out
        listed = {r["serial"]: r["revoked"]
                  for r in admin.admin("cert-list")["result"]}
        assert listed[tls.serial()] is True
        with pytest.raises(t_ids.StorageError) as e:
            scm.status()
        assert e.value.code == "CERTIFICATE_REVOKED"
        dns[1].cert_renewal.check_once()  # its trust refresh
        with pytest.raises(t_ids.StorageError) as e:
            dn.echo(b"y")
        assert e.value.code == "CERTIFICATE_REVOKED"
        assert admin.status()["nodes"]  # everyone else is served
    finally:
        scm.close()
        dn.close()
        admin.close()


def cc_admin(meta, tmp_path):
    """An operator's own client certificate."""
    from ozone_tpu_torch.utils.ca import CertificateClient

    cc = CertificateClient(tmp_path / "admin", "client-admin")
    cc.enroll_remote(meta.enroll_address, secret=ENROLL_SECRET)
    return cc.tls()


def test_secure_ha_ring_failover(tmp_path):
    """Three ScmOmDaemons on one ring over mutual TLS: the replicas enroll
    at the primordial one (which alone hosts the CA), the ring dials its
    peers by id, block tokens ride it, and a leader's loss hands over
    with every certificate and token still good."""
    from ozone_tpu_torch.testing.minicluster import MiniOzoneHACluster

    c = MiniOzoneHACluster(tmp_path, num_meta=3, num_datanodes=5,
                           device="cpu", secure=True, block_tokens=True)
    oz = None
    try:
        assert [m.ca is not None for m in c.metas.values()] == \
            [True, False, False]
        assert all(m.server.tls_enabled for m in c.metas.values())
        assert all(d.tls is not None and d.datapath is None
                   for d in c.datanodes)
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        data = _data(31, 40_000)
        b.write_key("k", data)
        leader = c.await_leader()
        c.stop_meta(leader)
        c.await_leader()
        b.write_key("k2", data[::-1].copy())
        assert np.array_equal(b.read_key("k"), data)
        assert np.array_equal(b.read_key("k2"), data[::-1])
        _wait("every datanode still enforcing", lambda: all(
            d.verifier.enabled and d.secrets.current() is not None
            for d in c.datanodes))
        c.revive_meta(leader)
        assert c.metas[leader].tls is not None
    finally:
        if oz is not None:
            oz.om.close()
            oz.clients.close()
        c.shutdown()
