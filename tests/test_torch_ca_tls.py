"""x509 CA, enrollment and mutual TLS on the port's RPC, against `ozone_tpu`.

The 14 tests of the reference's `tests/test_ca_tls.py` on the port's
`utils/ca.py` and `net/rpc.py` (the standard library's `ssl` in place of
gRPC's credentials): root persistence, SAN passthrough, a tampered CSR,
mutual TLS end to end, a certificate-less and an untrusted client
refused, the renewal window, renewal with a fresh key, live renewal with
no dropped call, root rotation with its two-root bundle, the failover
pool rebuilt on a new identity, a failed renewal that leaves the files
matched, the enrollment MAC required and verified, a second rotation
refused, and live revocation (CERTIFICATE_REVOKED per call).

Across the packages: certificate directories written by either package's
CA and clients load in the other's classes and serve its own RPC (a
port server and client on the reference's files; a reference gRPC server
and channel on the port's), and the enrollment MACs are equal for a
pinned secret and payload. The TLS hazards of a selector server: a
pipelined second call already decrypted in the SSL buffer is served, a
silent client holds no one else up, and a pooled TLS connection's
liveness check answers without raising.
"""

import socket
import ssl
import threading
import time

import pytest

pytest.importorskip("cryptography")

from cryptography import x509  # noqa: E402

from ozone_tpu_torch.net import rpc  # noqa: E402
from ozone_tpu_torch.net.rpc import RpcChannel, RpcServer  # noqa: E402
from ozone_tpu_torch.storage.ids import StorageError  # noqa: E402
from ozone_tpu_torch.utils.ca import (  # noqa: E402
    CertificateAuthority,
    CertificateClient,
)


def _echo_service():
    return {"Echo": lambda req: b"echo:" + bytes(req)}


def _serve(tls, mutual=True, crl=None):
    srv = RpcServer(port=0, tls=tls, mutual=mutual)
    srv.crl_provider = crl
    srv.add_service("Test", _echo_service())
    srv.start()
    return srv


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """A CA, a server and a client certificate shared by the read-only
    tests (P-256 keys are cheap, the module scope keeps the suite short)."""
    d = tmp_path_factory.mktemp("pki")
    ca = CertificateAuthority(d / "ca")
    srv = CertificateClient(d / "srv", "datanode-srv")
    cli = CertificateClient(d / "cli", "client-cli")
    srv.enroll(ca)
    cli.enroll(ca)
    return ca, srv, cli


def test_root_ca_persistence(tmp_path):
    ca1 = CertificateAuthority(tmp_path / "ca", cluster_id="c1")
    ca2 = CertificateAuthority(tmp_path / "ca")
    assert ca1.root_pem == ca2.root_pem
    cert = x509.load_pem_x509_certificate(ca1.root_pem)
    assert cert.extensions.get_extension_for_class(
        x509.BasicConstraints).value.ca


def test_enrollment_issues_leaf_with_sans(tmp_path):
    ca = CertificateAuthority(tmp_path / "ca")
    cc = CertificateClient(tmp_path / "dn1", "datanode-dn1",
                           hostnames=["localhost", "127.0.0.1", "dn1.rack0"])
    cc.enroll(ca)
    assert cc.enrolled
    cert = x509.load_pem_x509_certificate(cc.cert_path.read_bytes())
    assert cert.issuer == x509.load_pem_x509_certificate(ca.root_pem).subject
    san = cert.extensions.get_extension_for_class(
        x509.SubjectAlternativeName).value
    assert "dn1.rack0" in san.get_values_for_type(x509.DNSName)
    assert not cert.extensions.get_extension_for_class(
        x509.BasicConstraints).value.ca
    assert (cc.key_path.stat().st_mode & 0o777) == 0o600


def test_csr_tamper_rejected(tmp_path):
    ca = CertificateAuthority(tmp_path / "ca")
    with pytest.raises(ValueError):
        ca.sign_csr(b"-----BEGIN CERTIFICATE REQUEST-----\nnope\n"
                    b"-----END CERTIFICATE REQUEST-----\n")


def test_mtls_end_to_end(pki):
    _, server_cc, client_cc = pki
    srv = _serve(server_cc.tls())
    try:
        assert srv.tls_enabled
        ch = RpcChannel(srv.address, tls=client_cc.tls(),
                        server_name="localhost")
        assert ch.call("Test", "Echo", b"hi") == b"echo:hi"
        # a message of many TLS records crosses whole
        big = bytes(range(256)) * 8192
        assert ch.call("Test", "Echo", big) == b"echo:" + big
        ch.close()
    finally:
        srv.stop()


class _NoCert:
    """A TLS client that trusts the CA but presents no certificate."""

    def __init__(self, ca_pem):
        self.ca_pem = ca_pem

    def client_context(self):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(cadata=self.ca_pem.decode())
        return ctx


def test_mutual_mode_rejects_certless_client(pki):
    """TLS 1.3 finishes the client's side of the handshake; the refusal
    shows at its first read, as UNAVAILABLE (the reference's gRPC
    status). No plaintext retry."""
    ca, server_cc, _ = pki
    srv = _serve(server_cc.tls(), mutual=True)
    try:
        ch = RpcChannel(srv.address, tls=_NoCert(ca.root_pem))
        with pytest.raises(StorageError) as e:
            ch.call("Test", "Echo", b"hi", timeout=3.0)
        assert e.value.code == "UNAVAILABLE"
        ch.close()
        # and a plaintext caller gets no answer either
        with pytest.raises(StorageError) as e:
            RpcChannel(srv.address).call("Test", "Echo", b"hi", timeout=3.0)
        assert e.value.code == "UNAVAILABLE"
        # server-auth-only TLS serves the certificate-less client
        srv2 = _serve(server_cc.tls(), mutual=False)
        try:
            ch = RpcChannel(srv2.address, tls=_NoCert(ca.root_pem))
            assert ch.call("Test", "Echo", b"ok") == b"echo:ok"
            ch.close()
        finally:
            srv2.stop()
    finally:
        srv.stop()


def test_untrusted_ca_rejected(tmp_path, pki):
    _, server_cc, _ = pki
    rogue = CertificateAuthority(tmp_path / "rogue")
    rogue_cc = CertificateClient(tmp_path / "rcli", "client-rogue")
    rogue_cc.enroll(rogue)
    srv = _serve(server_cc.tls())
    try:
        ch = RpcChannel(srv.address, tls=rogue_cc.tls(),
                        server_name="localhost")
        with pytest.raises(StorageError) as e:
            ch.call("Test", "Echo", b"hi", timeout=3.0)
        assert e.value.code == "UNAVAILABLE"
        ch.close()
    finally:
        srv.stop()


def test_renewal_grace_window_math(tmp_path):
    ca = CertificateAuthority(tmp_path / "ca")
    cc = CertificateClient(tmp_path / "dn", "datanode-dn")
    cc.enroll(ca)
    assert not cc.needs_renewal(threshold=0.25)
    assert 0.9 < cc.remaining_fraction() <= 1.0
    cc.install(ca.sign_csr(cc.make_csr(), valid_days=0), ca.root_pem)
    assert cc.needs_renewal(threshold=0.25)


def test_renew_mints_fresh_key_and_serial(tmp_path, pki):
    ca, _, cli = pki
    cc = CertificateClient(tmp_path / "dn", "datanode-dn")
    cc.enroll(ca)
    old_serial = cc.cert.serial_number
    old_key = cc.key_path.read_bytes()
    cc.renew(ca)
    assert cc.cert.serial_number != old_serial
    assert cc.key_path.read_bytes() != old_key
    srv = _serve(cc.tls())
    try:
        ch = RpcChannel(srv.address, tls=cli.tls(), server_name="localhost")
        assert ch.call("Test", "Echo", b"hi") == b"echo:hi"
        ch.close()
    finally:
        srv.stop()


def test_live_renewal_no_dropped_rpcs(tmp_path, pki):
    """Calls flow while the server's certificate is renewed: the existing
    connection keeps working, and a new handshake gets the new one."""
    from ozone_tpu_torch.utils.ca import CertRenewalService

    ca, _, client_cc = pki
    server_cc = CertificateClient(tmp_path / "srv", "datanode-srv")
    server_cc.enroll(ca)
    rot = server_cc.rotating_tls()
    srv = _serve(rot)
    renewal = CertRenewalService(rot, lambda: server_cc.renew(ca),
                                 threshold=0.25)
    stop = threading.Event()
    failures = []

    def traffic():
        ch = RpcChannel(srv.address, tls=client_cc.tls())
        while not stop.is_set():
            try:
                ch.call("Test", "Echo", b"t")
            except StorageError as e:  # pragma: no cover - the failure
                failures.append(e)
        ch.close()

    try:
        ch = RpcChannel(srv.address, tls=client_cc.tls(),
                        server_name="localhost")
        assert ch.call("Test", "Echo", b"a") == b"echo:a"
        assert renewal.check_once() is False
        t = threading.Thread(target=traffic)
        t.start()
        server_cc.install(ca.sign_csr(server_cc.make_csr(), valid_days=0),
                          ca.root_pem)
        rot.reload()
        assert renewal.check_once() is True
        assert renewal.renewals == 1
        assert ch.call("Test", "Echo", b"b") == b"echo:b"
        ch.close()
        ch2 = RpcChannel(srv.address, tls=client_cc.tls(),
                         server_name="localhost")
        assert ch2.call("Test", "Echo", b"c") == b"echo:c"
        # the new handshake was served the renewed certificate
        (sock,) = ch2._idle
        assert x509.load_der_x509_certificate(
            sock.getpeercert(binary_form=True)).serial_number == \
            server_cc.cert.serial_number
        ch2.close()
        assert server_cc.remaining_fraction() > 0.9
        stop.set()
        t.join()
        assert failures == []
    finally:
        stop.set()
        srv.stop()


def test_root_ca_rotation_trust_bundle(tmp_path):
    ca = CertificateAuthority(tmp_path / "ca")
    old_root = x509.load_pem_x509_certificate(ca.root_pem)
    server_cc = CertificateClient(tmp_path / "srv", "datanode-srv")
    server_cc.enroll(ca)
    ca.rotate_root()
    new_root = x509.load_pem_x509_certificate(ca.root_pem)
    assert new_root.serial_number != old_root.serial_number
    assert ca.root_pem.count(b"BEGIN CERTIFICATE") == 2
    assert server_cc.refresh_trust(ca) is True
    assert server_cc.refresh_trust(ca) is False
    client_cc = CertificateClient(tmp_path / "cli", "client-cli")
    client_cc.enroll(ca)
    rot = server_cc.rotating_tls()
    srv = _serve(rot)
    try:
        ch = RpcChannel(srv.address, tls=client_cc.tls(),
                        server_name="localhost")
        assert ch.call("Test", "Echo", b"x") == b"echo:x"
        ch.close()
        server_cc.renew(ca)
        rot.reload()
        ch2 = RpcChannel(srv.address, tls=client_cc.tls(),
                         server_name="localhost")
        assert ch2.call("Test", "Echo", b"y") == b"echo:y"
        ch2.close()
        assert server_cc.cert.issuer == new_root.subject
    finally:
        srv.stop()
    ca.retire_previous_root()
    assert ca.root_pem.count(b"BEGIN CERTIFICATE") == 1


def test_failover_pool_drops_channels_on_cert_rotation(tmp_path, pki):
    from ozone_tpu_torch.net.rpc import FailoverChannels

    ca, server_cc, _ = pki
    client_cc = CertificateClient(tmp_path / "cli", "client-cli")
    client_cc.enroll(ca)
    srv = _serve(server_cc.tls())
    try:
        rot = client_cc.rotating_tls()
        pool = FailoverChannels(srv.address, tls=rot)
        _, ch1 = pool.channel()
        _, same = pool.channel()
        assert ch1 is same
        assert ch1.call("Test", "Echo", b"1") == b"echo:1"
        client_cc.renew(ca)
        rot.reload()
        _, ch2 = pool.channel()
        assert ch2 is not ch1
        assert ch2.call("Test", "Echo", b"2") == b"echo:2"
        pool.close()
    finally:
        srv.stop()


def test_failed_renewal_leaves_matched_key_and_cert(tmp_path, pki):
    ca, _, cli = pki
    cc = CertificateClient(tmp_path / "srv", "datanode-srv")
    cc.enroll(ca)
    key_before = cc.key_path.read_bytes()
    cert_before = cc.cert_path.read_bytes()
    with pytest.raises(Exception):
        cc.renew_remote("127.0.0.1:1")  # nothing listens there
    assert cc.key_path.read_bytes() == key_before
    assert cc.cert_path.read_bytes() == cert_before
    srv = _serve(cc.tls())
    try:
        ch = RpcChannel(srv.address, tls=cli.tls(), server_name="localhost")
        assert ch.call("Test", "Echo", b"ok") == b"echo:ok"
        ch.close()
    finally:
        srv.stop()


def test_enrollment_response_mac_required(tmp_path):
    from ozone_tpu_torch.utils.ca import EnrollmentService

    ca = CertificateAuthority(tmp_path / "ca")
    srv = RpcServer(port=0)
    EnrollmentService(ca, srv, secret=None)  # the server never MACs
    srv.start()
    try:
        cc = CertificateClient(tmp_path / "dn", "datanode-dn")
        with pytest.raises(PermissionError):
            cc.enroll_remote(srv.address, secret="client-has-secret")
        assert not cc.enrolled
        with pytest.raises(PermissionError):
            cc.refresh_trust_remote(srv.address, secret="client-has-secret")
    finally:
        srv.stop()


def test_enrollment_response_mac_roundtrip(tmp_path):
    from ozone_tpu_torch.utils.ca import EnrollmentService

    ca = CertificateAuthority(tmp_path / "ca")
    srv = RpcServer(port=0)
    EnrollmentService(ca, srv, secret="s3cr3t")
    srv.start()
    try:
        cc = CertificateClient(tmp_path / "dn", "datanode-dn")
        cc.enroll_remote(srv.address, secret="s3cr3t")
        assert cc.enrolled
        old_serial = cc.cert.serial_number
        cc.renew_remote(srv.address, secret="s3cr3t")
        assert cc.cert.serial_number != old_serial
        assert cc.refresh_trust_remote(srv.address, secret="s3cr3t") is False
        ca.rotate_root()
        assert cc.refresh_trust_remote(srv.address, secret="s3cr3t") is True
        # a wrong secret: the reference's refusal (IO_EXCEPTION)
        rogue = CertificateClient(tmp_path / "rogue", "client-rogue")
        with pytest.raises(StorageError) as e:
            rogue.enroll_remote(srv.address, secret="wrong")
        assert e.value.code == "IO_EXCEPTION"
        assert "bad enrollment secret" in e.value.msg
        assert not rogue.enrolled
    finally:
        srv.stop()


def test_double_root_rotation_refused(tmp_path):
    ca = CertificateAuthority(tmp_path / "ca")
    ca.rotate_root()
    with pytest.raises(RuntimeError):
        ca.rotate_root()
    ca.retire_previous_root()
    ca.rotate_root()
    assert ca.generation == 2


def test_cert_revocation_enforced_live(tmp_path):
    from ozone_tpu_torch.utils.ca import EnrollmentService

    ca = CertificateAuthority(tmp_path / "ca")
    server_cc = CertificateClient(tmp_path / "srv", "datanode-srv")
    good_cc = CertificateClient(tmp_path / "good", "client-good")
    bad_cc = CertificateClient(tmp_path / "bad", "client-bad")
    for cc in (server_cc, good_cc, bad_cc):
        cc.enroll(ca)
    issued = ca.issued()
    assert len(issued) == 3 and not any(r["revoked"] for r in issued)
    bad_serial = bad_cc.cert.serial_number
    assert any(r["serial"] == bad_serial for r in issued)
    rot = server_cc.rotating_tls()
    srv = _serve(rot, crl=rot.crl)
    try:
        chb = RpcChannel(srv.address, tls=bad_cc.tls(),
                         server_name="localhost")
        assert chb.call("Test", "Echo", b"ok") == b"echo:ok"
        ca.revoke(bad_serial)
        with pytest.raises(ValueError):
            ca.revoke(12345)  # never issued here
        assert server_cc.refresh_trust(ca) is True
        rot.reload()
        with pytest.raises(StorageError) as ei:
            chb.call("Test", "Echo", b"again")
        assert ei.value.code == "CERTIFICATE_REVOKED"
        # the connection stays in step: the next call is refused the same
        with pytest.raises(StorageError) as ei:
            chb.call("Test", "Echo", b"again")
        assert ei.value.code == "CERTIFICATE_REVOKED"
        chb.close()
        chg = RpcChannel(srv.address, tls=good_cc.tls(),
                         server_name="localhost")
        assert chg.call("Test", "Echo", b"fine") == b"echo:fine"
        chg.close()
    finally:
        srv.stop()
    esrv = RpcServer(port=0)
    EnrollmentService(ca, esrv, secret="s")
    esrv.start()
    try:
        late = CertificateClient(tmp_path / "late", "client-late")
        late.enroll_remote(esrv.address, secret="s")
        assert bad_serial in late.crl()
        assert late.refresh_trust_remote(esrv.address, secret="s") is False
    finally:
        esrv.stop()


# ------------------------------------------------------ across the packages
def test_reference_pki_serves_port_rpc(tmp_path):
    """The reference's CA and clients write their directories; the port's
    classes load them (same root, same key, same certificate) and serve a
    port server that a port client calls."""
    from ozone_tpu.utils import ca as j_ca

    jca = j_ca.CertificateAuthority(tmp_path / "ca")
    j_ca.CertificateClient(tmp_path / "srv", "datanode-srv").enroll(jca)
    j_ca.CertificateClient(tmp_path / "cli", "client-cli").enroll(jca)
    ca = CertificateAuthority(tmp_path / "ca")
    assert ca.root_pem == jca.root_pem and ca.generation == jca.generation
    srv_cc = CertificateClient(tmp_path / "srv", "datanode-srv")
    cli_cc = CertificateClient(tmp_path / "cli", "client-cli")
    assert srv_cc.enrolled and cli_cc.enrolled
    jsrv = j_ca.CertificateClient(tmp_path / "srv", "datanode-srv")
    assert srv_cc.tls().cert_pem == jsrv.tls().cert_pem
    assert srv_cc.tls().key_pem == jsrv.tls().key_pem
    srv = _serve(srv_cc.tls())
    try:
        ch = RpcChannel(srv.address, tls=cli_cc.tls())
        assert ch.call("Test", "Echo", b"x") == b"echo:x"
        ch.close()
    finally:
        srv.stop()
    # the port's CA keeps issuing into the reference's ledger
    leaf = CertificateClient(tmp_path / "late", "client-late")
    leaf.enroll(ca)
    assert [r["serial"] for r in jca.issued()][-1] == leaf.cert.serial_number
    ca.revoke(leaf.cert.serial_number)
    assert leaf.cert.serial_number in jca.crl()


def test_port_pki_serves_reference_rpc(tmp_path):
    """The other way round: the port writes the directories, the
    reference's classes load them and serve a gRPC server its channel
    calls."""
    from ozone_tpu.net.rpc import RpcChannel as JChannel
    from ozone_tpu.net.rpc import RpcServer as JServer
    from ozone_tpu.utils import ca as j_ca

    ca = CertificateAuthority(tmp_path / "ca")
    ca.rotate_root()  # a generation file and a two-root bundle too
    CertificateClient(tmp_path / "srv", "datanode-srv").enroll(ca)
    CertificateClient(tmp_path / "cli", "client-cli").enroll(ca)
    jca = j_ca.CertificateAuthority(tmp_path / "ca")
    assert jca.root_pem == ca.root_pem and jca.generation == 1
    jsrv_cc = j_ca.CertificateClient(tmp_path / "srv", "datanode-srv")
    jcli_cc = j_ca.CertificateClient(tmp_path / "cli", "client-cli")
    srv = JServer(port=0, tls=jsrv_cc.tls())
    srv.add_service("Test", {"Echo": lambda req: b"echo:" + req})
    srv.start()
    try:
        ch = JChannel(srv.address, tls=jcli_cc.tls(), server_name="localhost")
        assert ch.call("Test", "Echo", b"y", timeout=10.0) == b"echo:y"
        ch.close()
    finally:
        srv.stop()


def test_enrollment_mac_equals_reference(tmp_path):
    """The response MAC is the reference's for a pinned secret and payload
    (both sides of the enrollment plane, each accepting the other's), and
    a port endpoint's answer passes the reference client's check."""
    import hmac
    import json

    from ozone_tpu.utils import ca as j_ca

    from ozone_tpu_torch.utils.ca import EnrollmentService, mac

    secret, payload = "pinned-secret", b"csr" + b"cert" + b"ca" + b"[1, 2]"
    jsvc = j_ca.EnrollmentService.__new__(j_ca.EnrollmentService)
    jsvc.secret = secret
    pinned = hmac.new(b"pinned-secret", b"enroll:" + payload,
                      "sha256").hexdigest()
    assert mac(secret, b"enroll:", payload) == \
        jsvc._mac(b"enroll:", payload) == pinned
    assert mac(None, b"root:", payload) is None
    j_ca.CertificateClient._require_mac(secret, b"root:", payload,
                                        mac(secret, b"root:", payload))
    CertificateClient._require_mac(secret, b"root:", payload,
                                   jsvc._mac(b"root:", payload))
    with pytest.raises(PermissionError):
        CertificateClient._require_mac(secret, b"root:", payload,
                                       mac(secret, b"enroll:", payload))
    # the MAC'd answer of a port endpoint passes the reference's check
    ca = CertificateAuthority(tmp_path / "pca")
    srv = RpcServer(port=0)
    EnrollmentService(ca, srv, secret=secret)
    srv.start()
    try:
        from ozone_tpu_torch.net import wire

        ch = RpcChannel(srv.address)
        m, _ = wire.unpack(ch.call("ozone.tpu.CertEnrollment", "RootCert",
                                   wire.pack({"nonce": "n0"})))
        ch.close()
        j_ca.CertificateClient._require_mac(
            secret, b"root:",
            b"n0" + m["ca"].encode() + json.dumps(sorted(m["crl"])).encode(),
            m["mac"])
    finally:
        srv.stop()


# ------------------------------------------------------ the TLS hazards
def test_pipelined_call_in_the_ssl_buffer_is_served(pki):
    """Two calls sent in one TLS record: after the first, the second sits
    decrypted in the server's SSL buffer, where its socket never turns
    readable; the server serves it at once."""
    _, server_cc, client_cc = pki
    srv = _serve(server_cc.tls())
    try:
        raw = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        sock = client_cc.tls().client_context().wrap_socket(
            raw, server_hostname="localhost")
        sock.settimeout(5)

        def call(body: bytes) -> bytes:
            hdr = RpcChannel._call_header("/Test/Echo", rpc.UNARY)
            return (rpc._HDR.pack(rpc.CALL, len(hdr)) + hdr
                    + rpc._HDR.pack(rpc.DATA, len(body)) + body)

        sock.sendall(call(b"one") + call(b"two"))
        t_end = time.monotonic() + 5
        got = [rpc._recv_frame(sock, t_end) for _ in range(2)]
        assert [(t, bytes(b)) for t, b in got] == \
            [(rpc.DATA, b"echo:one"), (rpc.DATA, b"echo:two")]
        sock.close()
    finally:
        srv.stop()


def test_silent_client_does_not_stall_others(pki):
    """Connections that never send a hello (or stop inside one) take no
    worker: every other client's calls are answered at once."""
    _, server_cc, client_cc = pki
    srv = RpcServer(port=0, max_workers=2, tls=server_cc.tls())
    srv.add_service("Test", _echo_service())
    srv.start()
    silent = [socket.create_connection(("127.0.0.1", srv.port))
              for _ in range(4)]
    try:
        t0 = time.perf_counter()
        for i in range(3):
            ch = RpcChannel(srv.address, tls=client_cc.tls())
            assert ch.call("Test", "Echo", b"%d" % i, timeout=5) == \
                b"echo:%d" % i
            ch.close()
        assert time.perf_counter() - t0 < 4.0
    finally:
        for s in silent:
            s.close()
        srv.stop()


def test_pooled_tls_liveness_check_does_not_raise(pki):
    """The pool's liveness check on a TLS socket (no MSG_PEEK there):
    usable after a call, dead once the server went away, and never a
    raise; the channel reconnects by itself."""
    _, server_cc, client_cc = pki
    srv = _serve(server_cc.tls())
    ch = RpcChannel(srv.address, tls=client_cc.tls())
    try:
        assert ch.call("Test", "Echo", b"a") == b"echo:a"
        (sock,) = ch._idle
        assert isinstance(sock, ssl.SSLSocket)
        assert RpcChannel._alive(sock) is True
        assert ch.call("Test", "Echo", b"b") == b"echo:b"
        assert ch._idle == [sock]  # the same pooled connection served it
        n = rpc.METRICS.histogram("tls_handshake").count
        port = srv.port
    finally:
        srv.stop()
    time.sleep(0.1)
    assert RpcChannel._alive(sock) is False
    srv = RpcServer(port=port, tls=server_cc.tls())
    srv.add_service("Test", _echo_service())
    srv.start()
    try:
        assert ch.call("Test", "Echo", b"c") == b"echo:c"
        assert rpc.METRICS.histogram("tls_handshake").count == n + 1
    finally:
        ch.close()
        srv.stop()
