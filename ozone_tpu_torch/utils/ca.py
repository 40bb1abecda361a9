"""x509 certificate authority, per-role certificate clients and TLS material.

Port of `ozone_tpu/utils/ca.py` (the reference's hdds/security/x509: the
SCM hosts a root CA; every role runs a certificate client that makes a
key pair, submits a CSR to the SCM's CA and stores the signed chain; the
RPC servers and channels then run TLS with mutual authentication), whole.

- `CertificateAuthority`: a self-signed P-256 root under `root_dir`
  (`ca.key.pem`, `ca.cert.pem`, `generation`), root rotation with the
  previous root kept in the trust bundle (`ca.cert.prev.pem`) until
  `retire_previous_root`, `sign_csr` (leaf certificates with serverAuth
  and clientAuth, the CSR's SANs), the issued log (`issued.json`) and the
  CRL (`crl.json`).
- `CertificateClient`: key pair and CSR, `install`, in-process `enroll`
  and `renew`, `enroll_remote` / `renew_remote` / `refresh_trust_remote`
  over the plaintext enrollment endpoint, whose responses carry an HMAC
  under the bootstrap secret (a client holding the secret refuses an
  answer without a matching one). Files: `<role>.key.pem` (0600),
  `<role>.cert.pem`, `ca.cert.pem`, `crl.json` under the role's
  directory, the reference's layout, so either package reads the other's.
- `EnrollmentService`: `SignCsr` and `RootCert` on its own RPC server.
- `RotatingTls` and `CertRenewalService`: a live view that a renewal or a
  trust refresh reloads (servers hand the new identity out on the next
  handshake, channel pools compare `version`), and the renewal loop.
- `TlsMaterial`: the PEM bundle. The reference's gRPC credential builders
  become `ssl.SSLContext` builders: `server_context(mutual)` asks for and
  verifies a client certificate against the CA bundle when `mutual`
  (CERT_REQUIRED), and `client_context()` holds the CA bundle and this
  role's chain and checks the server's name. `SSLContext.load_cert_chain`
  reads files, so a context is built from a private temporary file that
  is removed once loaded; each material builds its contexts once.

`cryptography` is imported where it is used: a secure daemon or a CA
raises when it is missing (`require_cryptography`), nothing falls back.
"""

from __future__ import annotations

import datetime
import hmac
import ipaddress
import json
import logging
import os
import ssl
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_ONE_DAY = datetime.timedelta(days=1)

ENROLL_SERVICE = "ozone.tpu.CertEnrollment"


def require_cryptography(what: str) -> None:
    try:
        import cryptography  # noqa: F401
    except ImportError:
        raise RuntimeError(
            f"{what} requires the `cryptography` module, which is not "
            "installed here; install it or run without secure mode "
            "(secure=False)") from None


def _write_private(path: Path, data: bytes) -> None:
    """An owner-only private-key file."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)


def _name(common_name: str, org: str = "ozone-tpu"):
    from cryptography import x509
    from cryptography.x509.oid import NameOID

    return x509.Name([
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, org),
        x509.NameAttribute(NameOID.COMMON_NAME, common_name),
    ])


def _new_key():
    # P-256: small certificates, fast handshakes (the reference's choice)
    from cryptography.hazmat.primitives.asymmetric import ec

    return ec.generate_private_key(ec.SECP256R1())


def _pem_key(key) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def _load_key(pem: bytes):
    from cryptography.hazmat.primitives import serialization

    return serialization.load_pem_private_key(pem, password=None)


def _cert_pem(cert) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return cert.public_bytes(serialization.Encoding.PEM)


def mac(secret: Optional[str], domain: bytes, payload: bytes) -> Optional[str]:
    """The enrollment plane's response MAC: HMAC-SHA256 under the bootstrap
    secret over domain + payload (None without a secret)."""
    if secret is None:
        return None
    return hmac.new(secret.encode(), domain + payload, "sha256").hexdigest()


class CertificateAuthority:
    """Self-signed root CA (the SCM's DefaultCAServer). Leaves carry
    clientAuth and serverAuth, so one certificate serves a role's server
    and client sides."""

    def __init__(self, root_dir: Path, cluster_id: str = "ozone-tpu",
                 valid_days: int = 3650):
        require_cryptography("CertificateAuthority (secure mode)")
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes

        self.root_dir = Path(root_dir)
        self.root_dir.mkdir(parents=True, exist_ok=True)
        self.valid_days = valid_days
        self.cluster_id = cluster_id
        #: serializes issued.json / crl.json read-modify-writes (the
        #: enrollment endpoint signs from its worker pool)
        self._ledger_lock = threading.Lock()
        key_path = self.root_dir / "ca.key.pem"
        cert_path = self.root_dir / "ca.cert.pem"
        gen_path = self.root_dir / "generation"
        self.generation = (int(gen_path.read_text())
                           if gen_path.exists() else 0)
        if key_path.exists() and cert_path.exists():
            self.key = _load_key(key_path.read_bytes())
            self.cert = x509.load_pem_x509_certificate(cert_path.read_bytes())
            return
        self.key = _new_key()
        now = datetime.datetime.now(datetime.timezone.utc)
        # each rotation generation gets its own subject: trust stores pick
        # anchors by subject, and two roots of one subject would verify
        # against whichever key is found first
        suffix = f"-g{self.generation}" if self.generation else ""
        name = _name(f"{cluster_id}-root-ca{suffix}")
        self.cert = (
            x509.CertificateBuilder()
            .subject_name(name)
            .issuer_name(name)
            .public_key(self.key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + datetime.timedelta(days=valid_days))
            .add_extension(x509.BasicConstraints(ca=True, path_length=1),
                           critical=True)
            .add_extension(
                x509.KeyUsage(
                    digital_signature=True, key_cert_sign=True,
                    crl_sign=True, content_commitment=False,
                    key_encipherment=False, data_encipherment=False,
                    key_agreement=False, encipher_only=False,
                    decipher_only=False),
                critical=True)
            .sign(self.key, hashes.SHA256())
        )
        _write_private(key_path, _pem_key(self.key))
        cert_path.write_bytes(_cert_pem(self.cert))

    @property
    def root_pem(self) -> bytes:
        """The trust bundle: the active root, and the previous one while a
        rotation is in flight."""
        pem = _cert_pem(self.cert)
        prev = self.root_dir / "ca.cert.prev.pem"
        if prev.exists():
            pem += prev.read_bytes()
        return pem

    def rotate_root(self) -> None:
        """Mint a new root; the old one stays in the trust bundle until
        `retire_previous_root`. A second rotation before that is refused:
        it would drop an anchor that live leaves may still chain to."""
        prev = self.root_dir / "ca.cert.prev.pem"
        if prev.exists():
            raise RuntimeError(
                "root rotation already in flight: previous root not "
                "yet retired (call retire_previous_root once every "
                "leaf has renewed under the new root)")
        old_cert = self.root_dir / "ca.cert.pem"
        prev.write_bytes(old_cert.read_bytes())
        (self.root_dir / "generation").write_text(str(self.generation + 1))
        (self.root_dir / "ca.key.pem").unlink()
        old_cert.unlink()
        self.__init__(self.root_dir, cluster_id=self.cluster_id,
                      valid_days=self.valid_days)

    def retire_previous_root(self) -> None:
        prev = self.root_dir / "ca.cert.prev.pem"
        if prev.exists():
            prev.unlink()

    def sign_csr(self, csr_pem: bytes, valid_days: int = 398) -> bytes:
        """A leaf certificate for a CSR (DefaultApprover: the subject and
        the SANs are the CSR's)."""
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes
        from cryptography.x509.oid import ExtendedKeyUsageOID

        csr = x509.load_pem_x509_csr(csr_pem)
        if not csr.is_signature_valid:
            raise ValueError("CSR signature invalid")
        now = datetime.datetime.now(datetime.timezone.utc)
        builder = (
            x509.CertificateBuilder()
            .subject_name(csr.subject)
            .issuer_name(self.cert.subject)
            .public_key(csr.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + datetime.timedelta(days=valid_days))
            .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                           critical=True)
            .add_extension(
                x509.ExtendedKeyUsage([
                    ExtendedKeyUsageOID.SERVER_AUTH,
                    ExtendedKeyUsageOID.CLIENT_AUTH,
                ]),
                critical=False)
        )
        try:
            san = csr.extensions.get_extension_for_class(
                x509.SubjectAlternativeName)
            builder = builder.add_extension(san.value, critical=False)
        except x509.ExtensionNotFound:
            pass
        cert = builder.sign(self.key, hashes.SHA256())
        self._log_issued(cert, csr.subject)
        return _cert_pem(cert)

    # --------------------------------------------------- issued certs / CRL
    def _issued_path(self) -> Path:
        return self.root_dir / "issued.json"

    def _crl_path(self) -> Path:
        return self.root_dir / "crl.json"

    def _log_issued(self, cert, subject) -> None:
        with self._ledger_lock:
            p = self._issued_path()
            rows = json.loads(p.read_text()) if p.exists() else []
            rows.append({
                "serial": cert.serial_number,
                "subject": subject.rfc4514_string(),
                "not_after": cert.not_valid_after_utc.isoformat(),
            })
            p.write_text(json.dumps(rows))

    def issued(self) -> list[dict]:
        p = self._issued_path()
        rows = json.loads(p.read_text()) if p.exists() else []
        crl = self.crl()
        for r in rows:
            r["revoked"] = r["serial"] in crl
        return rows

    def crl(self) -> set:
        p = self._crl_path()
        return set(json.loads(p.read_text())) if p.exists() else set()

    def revoke(self, serial: int) -> None:
        """Put a leaf's serial on the CRL. It reaches the servers with the
        MAC'd trust refresh; each checks it on every call."""
        with self._ledger_lock:
            p = self._issued_path()
            rows = json.loads(p.read_text()) if p.exists() else []
            if not any(r["serial"] == serial for r in rows):
                raise ValueError(f"serial {serial} was never issued here")
            crl = self.crl()
            crl.add(serial)
            self._crl_path().write_text(json.dumps(sorted(crl)))


class CertificateClient:
    """Per-role certificate client (DNCertificateClient /
    OMCertificateClient): key pair, CSR, enrollment, PEMs on disk."""

    def __init__(self, role_dir: Path, role: str,
                 hostnames: Optional[list[str]] = None,
                 valid_days: int = 398):
        require_cryptography("CertificateClient (secure mode)")
        self.role_dir = Path(role_dir)
        self.role_dir.mkdir(parents=True, exist_ok=True)
        self.role = role
        self.hostnames = hostnames or ["localhost", "127.0.0.1"]
        #: the leaf lifetime asked for at enrollment and renewal
        self.valid_days = valid_days
        self.key_path = self.role_dir / f"{role}.key.pem"
        self.cert_path = self.role_dir / f"{role}.cert.pem"
        self.ca_path = self.role_dir / "ca.cert.pem"
        if self.key_path.exists():
            self.key = _load_key(self.key_path.read_bytes())
        else:
            self.key = _new_key()
            _write_private(self.key_path, _pem_key(self.key))

    def make_csr(self, key=None) -> bytes:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes

        sans = []
        for h in self.hostnames:
            try:
                sans.append(x509.IPAddress(ipaddress.ip_address(h)))
            except ValueError:
                sans.append(x509.DNSName(h))
        csr = (
            x509.CertificateSigningRequestBuilder()
            .subject_name(_name(self.role))
            .add_extension(x509.SubjectAlternativeName(sans), critical=False)
            .sign(key or self.key, hashes.SHA256())
        )
        from cryptography.hazmat.primitives import serialization

        return csr.public_bytes(serialization.Encoding.PEM)

    def install(self, cert_pem: bytes, ca_pem: bytes,
                crl: Optional[list] = None) -> None:
        self.cert_path.write_bytes(cert_pem)
        self.ca_path.write_bytes(ca_pem)
        if crl is not None:
            self._install_crl(crl)

    @property
    def crl_path(self) -> Path:
        return self.role_dir / "crl.json"

    def crl(self) -> set:
        p = self.crl_path
        return set(json.loads(p.read_text())) if p.exists() else set()

    def _install_crl(self, crl: list) -> bool:
        new = set(crl)
        if new == self.crl():
            return False
        self.crl_path.write_text(json.dumps(sorted(new)))
        return True

    def enroll(self, ca: CertificateAuthority) -> None:
        """In-process enrollment (a role beside the CA, or tests)."""
        self.install(ca.sign_csr(self.make_csr(), valid_days=self.valid_days),
                     ca.root_pem, crl=sorted(ca.crl()))

    @staticmethod
    def _require_mac(secret: Optional[str], domain: bytes,
                     payload: bytes, got: Optional[str]) -> None:
        """A client holding the bootstrap secret refuses an answer whose
        MAC is missing or wrong: the enrollment plane is plaintext, and an
        unauthenticated answer would let a man in the middle hand over a
        rogue CA bundle."""
        if secret is None:
            return
        expect = mac(secret, domain, payload)
        if not (got and hmac.compare_digest(expect, got)):
            raise PermissionError(
                "enrollment response failed authentication (missing or "
                "bad response MAC) — possible MITM on the CSR channel")

    @staticmethod
    def _enroll_call(address: str, method: str, meta: dict) -> dict:
        from ozone_tpu_torch.net import wire
        from ozone_tpu_torch.net.rpc import RpcChannel

        ch = RpcChannel(address)
        try:
            m, _ = wire.unpack(ch.call(ENROLL_SERVICE, method,
                                       wire.pack(meta)))
        finally:
            ch.close()
        return m

    def _sign_csr_remote(self, address: str, csr: bytes,
                         secret: Optional[str]) -> tuple[bytes, bytes, list]:
        m = self._enroll_call(address, "SignCsr",
                              {"csr": csr.decode(), "secret": secret})
        cert, ca_pem = m["cert"].encode(), m["ca"].encode()
        crl = m.get("crl", [])
        self._require_mac(
            secret, b"enroll:",
            csr + cert + ca_pem + json.dumps(sorted(crl)).encode(),
            m.get("mac"))
        return cert, ca_pem, crl

    def enroll_remote(self, address: str,
                      secret: Optional[str] = None) -> None:
        """Enroll at the CA's plaintext enrollment endpoint
        (SCMSecurityProtocol getDataNodeCertificate): the shared bootstrap
        secret gates signing on the server and authenticates the answer
        here."""
        csr = self.make_csr()
        cert, ca_pem, crl = self._sign_csr_remote(address, csr, secret)
        self.install(cert, ca_pem, crl=crl)

    @property
    def enrolled(self) -> bool:
        return self.cert_path.exists() and self.ca_path.exists()

    # ------------------------------------------------------- lifecycle
    @property
    def cert(self):
        from cryptography import x509

        return x509.load_pem_x509_certificate(self.cert_path.read_bytes())

    @property
    def expires_at(self) -> datetime.datetime:
        return self.cert.not_valid_after_utc

    def remaining_fraction(self) -> float:
        """The share of the certificate's lifetime still ahead (0 =
        expired)."""
        c = self.cert
        now = datetime.datetime.now(datetime.timezone.utc)
        total = (c.not_valid_after_utc - c.not_valid_before_utc).total_seconds()
        left = (c.not_valid_after_utc - now).total_seconds()
        return max(0.0, left / total) if total > 0 else 0.0

    def needs_renewal(self, threshold: float = 0.25) -> bool:
        return self.enrolled and self.remaining_fraction() < threshold

    def _commit_renewal(self, new_key, cert_pem: bytes,
                        ca_pem: bytes) -> None:
        """Persist a renewal once the CA signed: until then the fresh key
        lives only in memory, so a failed renewal leaves the files'
        key and certificate matched."""
        _write_private(self.key_path, _pem_key(new_key))
        self.key = new_key
        self.install(cert_pem, ca_pem)

    def renew(self, ca: CertificateAuthority) -> None:
        # a fresh key pair each renewal, as the reference's clients do
        new_key = _new_key()
        cert = ca.sign_csr(self.make_csr(key=new_key),
                           valid_days=self.valid_days)
        self._commit_renewal(new_key, cert, ca.root_pem)
        self._install_crl(sorted(ca.crl()))

    def renew_remote(self, address: str,
                     secret: Optional[str] = None) -> None:
        new_key = _new_key()
        csr = self.make_csr(key=new_key)
        cert, ca_pem, crl = self._sign_csr_remote(address, csr, secret)
        self._commit_renewal(new_key, cert, ca_pem)
        self._install_crl(crl)

    def refresh_trust(self, ca: CertificateAuthority) -> bool:
        """Adopt the CA's current trust bundle and CRL; True when either
        changed."""
        crl_changed = self._install_crl(sorted(ca.crl()))
        return self._install_trust(ca.root_pem) or crl_changed

    def refresh_trust_remote(self, address: str,
                             secret: Optional[str] = None) -> bool:
        """The periodic trust refresh, challenge-response authenticated
        with a secret (a client nonce, an HMAC'd answer)."""
        nonce = os.urandom(16).hex()
        m = self._enroll_call(address, "RootCert", {"nonce": nonce})
        bundle = m["ca"].encode()
        crl = m.get("crl", [])
        self._require_mac(
            secret, b"root:",
            nonce.encode() + bundle + json.dumps(sorted(crl)).encode(),
            m.get("mac"))
        crl_changed = self._install_crl(crl)
        return self._install_trust(bundle) or crl_changed

    def _install_trust(self, bundle: bytes) -> bool:
        if self.ca_path.exists() and self.ca_path.read_bytes() == bundle:
            return False
        self.ca_path.write_bytes(bundle)
        return True

    def tls(self) -> "TlsMaterial":
        if not self.enrolled:
            raise RuntimeError(f"{self.role}: not enrolled")
        return TlsMaterial(
            key_pem=self.key_path.read_bytes(),
            cert_pem=self.cert_path.read_bytes(),
            ca_pem=self.ca_path.read_bytes(),
        )

    def rotating_tls(self) -> "RotatingTls":
        return RotatingTls(self)


class EnrollmentService:
    """The CSR-signing endpoint, served in plaintext on its own RPC server
    (a fresh datanode has no certificate yet, so it cannot reach the mTLS
    plane); an optional shared `secret` gates who may get one, and every
    answer carries its MAC."""

    def __init__(self, ca: CertificateAuthority, server,
                 secret: Optional[str] = None, leaf_valid_days: int = 398):
        self.ca = ca
        self.secret = secret
        self.leaf_valid_days = leaf_valid_days
        server.add_service(ENROLL_SERVICE, {
            "SignCsr": self._sign,
            "RootCert": self._root,
        })

    def _sign(self, req) -> bytes:
        from ozone_tpu_torch.net import wire

        m, _ = wire.unpack(req)
        if self.secret is not None and not hmac.compare_digest(
                str(m.get("secret") or ""), self.secret):
            # the reference's refusal: IO_EXCEPTION on the wire
            raise PermissionError("bad enrollment secret")
        csr = m["csr"].encode()
        cert = self.ca.sign_csr(csr, valid_days=self.leaf_valid_days)
        ca_pem = self.ca.root_pem
        crl = sorted(self.ca.crl())
        return wire.pack({
            "cert": cert.decode(),
            "ca": ca_pem.decode(),
            "crl": crl,
            "mac": mac(self.secret, b"enroll:",
                       csr + cert + ca_pem + json.dumps(crl).encode()),
        })

    def _root(self, req) -> bytes:
        from ozone_tpu_torch.net import wire

        m, _ = wire.unpack(req)
        nonce = str(m.get("nonce") or "")
        bundle = self.ca.root_pem
        crl = sorted(self.ca.crl())
        return wire.pack({
            "ca": bundle.decode(),
            "crl": crl,
            "mac": mac(self.secret, b"root:",
                       nonce.encode() + bundle + json.dumps(crl).encode()),
        })


def _context(material: "TlsMaterial", server: bool,
             mutual: bool) -> ssl.SSLContext:
    """An SSLContext holding the material's chain (loaded from a private
    temporary file, removed once read) and its CA bundle."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER if server
                         else ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    fd, path = tempfile.mkstemp(prefix="ozone-tls-", suffix=".pem")
    try:
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(material.cert_pem + b"\n" + material.key_pem)
        ctx.load_cert_chain(path)
    finally:
        os.unlink(path)
    if server:
        # no session resumption: every connection is one full handshake,
        # and no post-handshake ticket lands on an idle pooled socket
        ctx.num_tickets = 0
        if mutual:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(cadata=material.ca_pem.decode())
        else:
            ctx.verify_mode = ssl.CERT_NONE
    else:
        ctx.check_hostname = True
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cadata=material.ca_pem.decode())
    return ctx


@dataclass(frozen=True)
class TlsMaterial:
    """A role's PEM bundle and the SSLContexts built from it (the
    SecurityConfig / GrpcTlsConfig role). `mutual` servers require a
    client certificate that chains to the bundle."""

    key_pem: bytes
    cert_pem: bytes
    ca_pem: bytes
    _ctx: dict = field(default_factory=dict, compare=False, repr=False)

    def server_context(self, mutual: bool = True) -> ssl.SSLContext:
        key = ("server", mutual)
        ctx = self._ctx.get(key)
        if ctx is None:
            ctx = self._ctx[key] = _context(self, True, mutual)
        return ctx

    def client_context(self) -> ssl.SSLContext:
        ctx = self._ctx.get("client")
        if ctx is None:
            ctx = self._ctx["client"] = _context(self, False, True)
        return ctx

    def serial(self) -> int:
        from cryptography import x509

        return x509.load_pem_x509_certificate(self.cert_pem).serial_number


class RotatingTls:
    """A live TLS view over a CertificateClient (the reference's
    certificate reload): servers built on it hand out the current
    identity on each new handshake, and channel pools compare `version`
    to drop connections that present a retired one."""

    def __init__(self, client: CertificateClient):
        self._client = client
        self._version = 0
        self._cached = client.tls()
        self._crl = client.crl()

    @property
    def version(self) -> int:
        return self._version

    def current(self) -> TlsMaterial:
        return self._cached

    def reload(self) -> None:
        """Re-read the PEMs and the CRL after a renewal, a rotation or a
        revocation."""
        self._cached = self._client.tls()
        self._crl = self._client.crl()
        self._version += 1

    def crl(self) -> set:
        """The revoked serials (the live view a server's crl_provider
        reads)."""
        return self._crl

    def server_context(self, mutual: bool = True) -> ssl.SSLContext:
        return self._cached.server_context(mutual)

    def client_context(self) -> ssl.SSLContext:
        return self._cached.client_context()


class CertRenewalService:
    """Background renewal (DefaultCertificateClient's renewal monitor):
    wakes every `check_interval_s`, refreshes the trust bundle and CRL
    (when a `trust_fn` is given), renews inside the grace window, and
    reloads the live view, so servers serve the new identity on the next
    handshake with no restart and no dropped call."""

    def __init__(self, tls: RotatingTls, renew_fn, trust_fn=None,
                 check_interval_s: float = 60.0, threshold: float = 0.25):
        self.tls = tls
        self.renew_fn = renew_fn
        #: () -> bool: refreshes the trust bundle and CRL, True on change
        self.trust_fn = trust_fn
        self.check_interval_s = check_interval_s
        self.threshold = threshold
        self.renewals = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cert-renewal")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def check_once(self) -> bool:
        """One check (the loop's body); True when a renewal happened."""
        if self.trust_fn is not None and self.trust_fn():
            # the bundle or the CRL changed: serve it at once
            self.tls.reload()
        if not self._client_needs_renewal():
            return False
        self.renew_fn()
        self.tls.reload()
        self.renewals += 1
        log.info("cert renewed for %s; now valid until %s",
                 self.tls._client.role, self.tls._client.expires_at)
        return True

    def _client_needs_renewal(self) -> bool:
        try:
            return self.tls._client.needs_renewal(self.threshold)
        except Exception:  # an unreadable certificate: renewal retries
            log.exception("certificate check failed")
            return False

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.check_once()
            except Exception:
                log.exception("certificate renewal failed; will retry")
