"""S3-compatible REST gateway.

Port of `ozone_tpu/gateway/s3.py` (the reference's s3gateway: stateless
endpoints in front of the object store client, `ObjectEndpoint` PUT and
GET with ranges and multipart upload, `BucketEndpoint` listings and
multi-delete, `Gateway` main). Buckets live in the `s3v` volume. Upload
state lives in the OM's multipart table (`om/multipart.py`), so the
gateway holds none. Every PUT and part is encoded by the fused kernel
through the client's EC writer, and a GET with units lost decodes
through it; `client.device` says where ("cuda" launches the kernel).

Auth (`_authenticate`, enforced with require_auth=True): SigV4 against
the OM's S3 secrets, by header, by presigned URL, and for aws-chunked
streaming bodies chunk by chunk (`gateway/s3_auth.py`). Admission
(`admission/`) charges the tenant by the declared Content-Length before
the body is read and bounds the requests in flight; a refusal answers
503 `SlowDown` with `Retry-After`.

Bucket `?lifecycle` PUT, GET and DELETE translate the AWS
LifecycleConfiguration XML to and from the OM's rules
(`lifecycle/policy.py`, the reference's tiering extension; warm storage
classes map to this gateway's RS scheme). Bucket `?replication` does the
same for the AWS ReplicationConfiguration and the geo replication rules
(`replication_geo/rules.py`, the reference's extension: the ARN's region
slot, or an `<Endpoint>`, names the destination cluster): a malformed
configuration answers 400 MalformedXML, an FSO bucket 400
InvalidRequest, and a bucket without rules 404
ReplicationConfigurationNotFoundError.

Tenants (the reference's OMMultiTenantManager): an authenticated access
id resolves to its tenant's volume, which is the request's bucket
namespace (cached for 60 s); other access ids and anonymous requests
use `s3v`. Admission charges the resolved volume, so a tenant's access
ids share one budget. Bucket `?acl` GET and PUT (a canned `x-amz-acl`
or an AccessControlPolicy body) keep the S3 grants on the bucket row;
under require_auth an anonymous GET or HEAD passes where the bucket
grants READ to everyone (`*`), and a mutation where it grants WRITE
(`_anonymous_allowed`); everything else anonymous is refused (403).
Object `?acl` GET renders the effective policy (owner FULL_CONTROL and
the bucket's public grants); object grants do not exist, so its PUT
answers 501, as the reference's does. aws-chunked uploads are gated on
the `S3_CHUNKED_UPLOAD` layout feature, read from the OM's upgrade status
(cached for `upgrade_cache_ttl_s`, 5 s): before the cluster finalizes,
such a PUT answers 501 NotImplemented and writes nothing (a failed status
read lets it through, as the reference's does: an unreachable OM fails
the upload anyway). Encrypted (TDE and GDPR) buckets, multipart uploads
included, are served through the client, which encrypts and decrypts. The
wire protocol (paths, query verbs, XML bodies, ETags) follows S3.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import logging
import math
import threading
import time
import xml.etree.ElementTree as ET
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, quote as _url_quote, unquote, urlparse

import numpy as np

from ozone_tpu_torch import admission
from ozone_tpu_torch.client.ozone_client import MultipartUpload, OzoneClient
from ozone_tpu_torch.gateway.s3_auth import (
    STREAMING,
    AuthError,
    decode_aws_chunked,
    parse_authorization,
    parse_query_auth,
    verify_presigned,
    verify_request,
)
from ozone_tpu_torch.om.requests import OMError
from ozone_tpu_torch.scm.pipeline import ReplicationConfig, ReplicationType
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.tracing import Tracer

# an in-process OzoneManager raises OMError, a remote OM StorageError with
# the same codes: the gateway maps both alike
_OM_ERRORS = (OMError, StorageError)

log = logging.getLogger(__name__)

S3_VOLUME = "s3v"
_NS = "http://s3.amazonaws.com/doc/2006-03-01/"

#: OM error code -> (S3 code, HTTP status); anything else is a 500
_ERROR_MAP = {
    "KEY_NOT_FOUND": ("NoSuchKey", 404),
    "BUCKET_NOT_FOUND": ("NoSuchBucket", 404),
    "BUCKET_ALREADY_EXISTS": ("BucketAlreadyExists", 409),
    "BUCKET_NOT_EMPTY": ("BucketNotEmpty", 409),
    "NO_SUCH_MULTIPART_UPLOAD": ("NoSuchUpload", 404),
    "INVALID_PART": ("InvalidPart", 400),
    "QUOTA_EXCEEDED": ("QuotaExceeded", 403),
    # a deterministic refusal is the client's error: a 500 would make
    # SDKs retry a request that can never succeed
    "INVALID_REQUEST": ("InvalidRequest", 400),
    # admission pushback in S3's throttling words, so SDKs back off
    "SERVER_BUSY": ("SlowDown", 503),
}

#: bucket sub-resources answered 501: S3 features the store lacks
_UNSUPPORTED_BUCKET_SUBS = (
    "policy", "website", "cors",
    "encryption", "accelerate", "requestPayment", "logging", "notification",
    "inventory", "analytics", "metrics", "intelligent-tiering",
    "ownershipControls", "publicAccessBlock")


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def _iso_now() -> str:
    return _iso_ts(time.time())


def _iso_ts(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.000Z")


def _opaque_token(key: str) -> str:
    """A ListObjectsV2 continuation token: opaque to clients, it wraps the
    resume key (which may hold XML-hostile bytes) as base64url behind a
    version prefix and a CRC32 tag, so a raw key that looks like a token
    is never misread. The reference's format: either gateway resumes the
    other's listing."""
    raw = key.encode()
    tag = zlib.crc32(raw).to_bytes(4, "big")
    return "t2:" + base64.urlsafe_b64encode(tag + raw).decode()


def _parse_token(token: str) -> str:
    """The resume key of a token; anything else is taken as a raw key."""
    if token.startswith("t2:"):
        try:
            blob = base64.urlsafe_b64decode(token[3:])
            if (len(blob) >= 4
                    and zlib.crc32(blob[4:]).to_bytes(4, "big") == blob[:4]):
                return blob[4:].decode()
        except Exception:  # noqa: BLE001 - malformed: treat as raw
            pass
    return token


def _esc_fn(q: dict):
    """?encoding-type=url handling shared by every listing verb: returns
    (enc_url, esc) where esc URL-encodes key-derived response strings so
    XML-hostile bytes survive the round trip."""
    enc_url = q.get("encoding-type", [""])[0] == "url"
    return enc_url, ((lambda s: _url_quote(s, safe="/")) if enc_url
                     else (lambda s: s))


def _err(code: str, message: str, status: int) -> tuple[int, bytes]:
    e = ET.Element("Error")
    ET.SubElement(e, "Code").text = code
    ET.SubElement(e, "Message").text = message
    return status, _xml(e)


def _unread_body_closes(h) -> None:
    """An error answered before the body was read (an admission refusal
    by the declared length) ends the connection: the unread bytes would
    otherwise be taken for the next request on it."""
    if not hasattr(h, "_cached_body") and int(
            h.headers.get("Content-Length") or 0):
        h.close_connection = True


class S3Gateway:
    def __init__(self, client: OzoneClient, host: str = "127.0.0.1",
                 port: int = 0, replication: str = "rs-6-3-1024k",
                 require_auth: bool = False,
                 max_clock_skew_s: float = 900.0,
                 domain: Optional[str] = None):
        self.client = client
        self.replication = replication
        #: virtual-host-style addressing: a Host of <bucket>.<domain>
        #: routes to that bucket with the path holding only the key;
        #: None = path-style only
        self.domain = domain
        #: True: every request must carry SigV4; False: unsigned requests
        #: run as the gateway, presented signatures are still checked
        self.require_auth = require_auth
        #: signed-request freshness window (AWS: 15 min); 0 turns it off
        self.max_clock_skew_s = max_clock_skew_s
        # the layout-feature view, refreshed from the OM on a short TTL
        self._upgrade_cache: Optional[dict] = None
        self._upgrade_cache_t = 0.0
        self.upgrade_cache_ttl_s = 5.0
        try:
            client.om.create_volume(S3_VOLUME)
        except _OM_ERRORS:
            pass
        # the request's bucket namespace: s3v, or the authenticated
        # access id's tenant volume; each request runs on its own thread
        self._request_ctx = threading.local()
        #: access id -> (volume, expiry): tenant assignment is rare, so a
        #: short cache keeps a request at one OM round trip (the secret)
        self._tenant_cache: dict = {}
        self._tenant_cache_ttl_s = 60.0
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("s3: " + fmt, *args)

            def _reply(self, status: int, body=b"",
                       headers: Optional[dict] = None):
                # body: bytes, or a uint8 array sent as it is (no copy)
                view = memoryview(body).cast("B")
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(view.nbytes))
                if self.close_connection:
                    self.send_header("Connection", "close")
                self.end_headers()
                # a HEAD answer has no body: one written would be read
                # as the next response on a keep-alive connection
                if view.nbytes and self.command != "HEAD":
                    self.wfile.write(view)

            def _body(self) -> bytes:
                # read once, so the signature check and the operation can
                # both consume it; every early error drains it first, or
                # its bytes would be taken for the next request on a
                # keep-alive connection
                if not hasattr(self, "_cached_body"):
                    n = int(self.headers.get("Content-Length", 0))
                    self._cached_body = self.rfile.read(n) if n else b""
                return self._cached_body

            def _dispatch(self, method: str):
                # the handler persists across a keep-alive connection's
                # requests: drop the previous request's body
                self.__dict__.pop("_cached_body", None)
                with Tracer.instance().span("s3:request", method=method):
                    gateway._route(self, method)

            def do_GET(self):
                self._dispatch("GET")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

            def do_HEAD(self):
                self._dispatch("HEAD")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self.host = host
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="s3-gateway", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------- routing
    def _authenticate(self, h, method: str) -> Optional[str]:
        """SigV4 against the OM's S3 secrets; the authenticated access id,
        or None for an anonymous request. Header auth, presigned URLs and
        aws-chunked bodies (chunk signatures chained from the seed)."""
        u = urlparse(h.path)
        header = h.headers.get("Authorization")
        if not header:
            # a real parameter check: a query that merely contains the
            # text (a prefix filter) is not a presigned URL
            if "X-Amz-Signature" in parse_qs(u.query):
                return self._authenticate_presigned(h, method, u)
            if str(h.headers.get("x-amz-content-sha256", "")) == STREAMING:
                # no seed signature to verify the chunks against, and the
                # framing would be stored as object data
                raise AuthError("InvalidRequest",
                                "aws-chunked streaming requires SigV4")
            return None
        auth = parse_authorization(header)
        secret = self.client.om.get_s3_secret(auth.access_id, create=False)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", auth.access_id)
        verify_request(
            secret, method, u.path, u.query, dict(h.headers), h._body(),
            auth, max_skew_s=self.max_clock_skew_s or None)
        if str(h.headers.get("x-amz-content-sha256", "")) == STREAMING:
            if not self._feature_allowed("S3_CHUNKED_UPLOAD"):
                # a layout-gated gateway feature: refused until the
                # cluster finalizes
                raise AuthError(
                    "NotImplemented",
                    "aws-chunked uploads need layout feature "
                    "S3_CHUNKED_UPLOAD; cluster is not finalized")
            # verify the chunk chain; the operation gets the decoded
            # payload, whose declared length must match
            amz_date = str(h.headers.get("x-amz-date", ""))
            decoded = decode_aws_chunked(h._body(), secret, auth, amz_date,
                                         auth.signature)
            declared = h.headers.get("x-amz-decoded-content-length")
            if declared is not None:
                try:
                    expect = int(declared)
                except ValueError:
                    raise AuthError(
                        "InvalidArgument",
                        f"bad x-amz-decoded-content-length: {declared!r}")
                if expect != len(decoded):
                    raise AuthError("IncompleteBody",
                                    f"decoded {len(decoded)} != {declared}")
            h._cached_body = decoded
        return auth.access_id

    def _feature_allowed(self, name: str) -> bool:
        """Is a layout-gated feature finalized cluster-wide? The OM's
        UpgradeStatus with a short cache; open when the status cannot be
        read (gating matters only while a reachable cluster is mid
        upgrade)."""
        now = time.monotonic()
        if (self._upgrade_cache is None
                or now - self._upgrade_cache_t > self.upgrade_cache_ttl_s):
            try:
                self._upgrade_cache = self.client.om.upgrade_status()
                self._upgrade_cache_t = now
            except Exception:  # noqa: BLE001
                return True
        feats = {f["name"]: f.get("allowed", True)
                 for f in self._upgrade_cache.get("features", [])}
        return bool(feats.get(name, True))

    def _authenticate_presigned(self, h, method: str, u) -> str:
        if str(h.headers.get("x-amz-content-sha256", "")) == STREAMING:
            # a presigned URL signs UNSIGNED-PAYLOAD: no seed to chain
            # chunk signatures from
            raise AuthError("InvalidRequest",
                            "aws-chunked streaming cannot be presigned")
        parsed = parse_query_auth(u.query)
        auth = parsed[0]
        secret = self.client.om.get_s3_secret(auth.access_id, create=False)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", auth.access_id)
        # the real request headers: X-Amz-SignedHeaders picks which enter
        # the canonical request
        headers = {k.lower(): v for k, v in h.headers.items()}
        headers.setdefault("host", "")
        return verify_presigned(
            secret, method, u.path, u.query, headers, parsed=parsed,
            max_skew_s=self.max_clock_skew_s or None)

    def _public_grants(self, bucket: str) -> set:
        try:
            acl = self.client.om.get_bucket_acl(self._vol, bucket)
        except _OM_ERRORS:
            return set()
        return {g.get("permission") for g in acl if g.get("grantee") == "*"}

    def _anonymous_allowed(self, method: str, bucket: str) -> bool:
        """An anonymous request passes where the bucket grants everyone
        the right: READ for GET and HEAD, WRITE for the rest."""
        grants = self._public_grants(bucket)
        if "FULL_CONTROL" in grants:
            return True
        if method in ("GET", "HEAD"):
            return "READ" in grants
        return "WRITE" in grants

    @property
    def _vol(self) -> str:
        return getattr(self._request_ctx, "volume", S3_VOLUME)

    def _volume_for(self, access_id: str) -> str:
        now = time.monotonic()
        hit = self._tenant_cache.get(access_id)
        if hit is not None and hit[1] > now:
            return hit[0]
        tenant = self.client.om.tenant_for_access_id(access_id)
        vol = tenant["volume"] if tenant is not None else S3_VOLUME
        self._tenant_cache[access_id] = (vol, now + self._tenant_cache_ttl_s)
        return vol

    def _vhost_bucket(self, h) -> Optional[str]:
        """The bucket of virtual-host-style addressing, Host =
        <bucket>.<domain> (the port is ignored; the bare domain stays
        path-style)."""
        if self.domain is None:
            return None
        host = (h.headers.get("Host") or "").split(":")[0]
        suffix = "." + self.domain
        if host.endswith(suffix) and len(host) > len(suffix):
            return host[: -len(suffix)]
        return None

    def _route(self, h, method: str) -> None:
        u = urlparse(h.path)
        q = parse_qs(u.query, keep_blank_values=True)
        parts = [unquote(p) for p in u.path.strip("/").split("/") if p]
        vbucket = self._vhost_bucket(h)
        if vbucket is not None:
            parts = [vbucket] + parts
        try:
            principal = self._authenticate(h, method)
            self._request_ctx.volume = (
                self._volume_for(principal) if principal is not None
                else S3_VOLUME)
            if principal is None and self.require_auth:
                # anonymous: only where the bucket's public grants allow
                if not (parts and self._anonymous_allowed(method, parts[0])):
                    h._body()
                    h._reply(*_err("AccessDenied", "anonymous access", 403))
                    return
            # the admission key is the resolved volume: a tenant's access
            # ids share its budget (and the untenanted world shares s3v);
            # looked up per request so reset_for_tests() re-reads knobs
            tenant = self._vol
            ctl = admission.controller("gateway")
            with admission.tenant_context(tenant):
                # charge by the declared length before reading the body:
                # a refusal must cost less than the work it sheds
                nbytes = (int(h.headers.get("Content-Length") or 0)
                          if method in ("PUT", "POST") else 0)
                ctl.charge(tenant, nbytes,
                           priority=admission.ambient_qos())
                with ctl.admit():
                    if not parts:
                        self._list_buckets(h)
                        return
                    bucket, key = parts[0], "/".join(parts[1:])
                    if not key:
                        self._bucket_op(h, method, bucket, q)
                    else:
                        self._object_op(h, method, bucket, key, q)
        except AuthError as e:
            _unread_body_closes(h)
            status = (400 if "Malformed" in e.code or e.code in
                      ("InvalidRequest", "InvalidArgument", "IncompleteBody",
                       "AuthorizationQueryParametersError")
                      else 501 if e.code == "NotImplemented" else 403)
            h._reply(*_err(e.code, str(e), status))
        except _OM_ERRORS as e:
            _unread_body_closes(h)
            code = _ERROR_MAP.get(e.code, ("InternalError", 500))
            headers = None
            if e.code == "SERVER_BUSY":
                # Retry-After is whole seconds (RFC 9110), rounded up so
                # the client never comes back before the hint
                hint = admission.retry_after_hint(str(e)) or 1.0
                headers = {"Retry-After": str(max(1, math.ceil(hint)))}
            status, body = _err(code[0], str(e), code[1])
            h._reply(status, body, headers)
        except Exception as e:  # noqa: BLE001
            _unread_body_closes(h)
            log.exception("s3 %s %s failed", method, h.path)
            h._reply(*_err("InternalError", str(e), 500))

    # ------------------------------------------------------------- buckets
    def _default_ec_target(self) -> str:
        """The scheme warm storage classes map to: this gateway's when it
        is an RS scheme, else the cluster default."""
        try:
            conf = ReplicationConfig.parse(self.replication)
        except ValueError:
            return "rs-6-3-1024k"
        return (self.replication if conf.type is ReplicationType.EC
                and conf.ec.codec == "rs" else "rs-6-3-1024k")

    def _bucket_lifecycle_op(self, h, method: str, bucket: str) -> None:
        """`?lifecycle`: PUT parses the AWS LifecycleConfiguration into the
        OM's rules, GET renders them back, DELETE clears them."""
        from ozone_tpu_torch.lifecycle.policy import (
            LifecycleError,
            rules_from_s3_xml,
            rules_to_s3_xml,
        )

        om = self.client.om
        if method in ("PUT", "POST", "DELETE"):
            body = h._body()  # drained before any call that may raise
        if method == "PUT":
            try:
                rules = rules_from_s3_xml(
                    body, default_target=self._default_ec_target())
            except LifecycleError as e:
                h._reply(*_err("MalformedXML", str(e), 400))
                return
            om.set_bucket_lifecycle(self._vol, bucket, rules)
            h._reply(200)
        elif method == "GET":
            rules = om.get_bucket_lifecycle(self._vol, bucket)
            if not rules:
                h._reply(*_err(
                    "NoSuchLifecycleConfiguration",
                    "The lifecycle configuration does not exist", 404))
                return
            h._reply(200, rules_to_s3_xml(rules),
                     {"Content-Type": "application/xml"})
        elif method == "DELETE":
            om.delete_bucket_lifecycle(self._vol, bucket)
            h._reply(204)
        else:
            h._reply(*_err("MethodNotAllowed", method, 405))

    def _bucket_replication_op(self, h, method: str, bucket: str) -> None:
        """`?replication`: PUT parses the AWS ReplicationConfiguration
        into the OM's geo replication rules, GET renders them back (404
        when the bucket has none), DELETE clears them."""
        from ozone_tpu_torch.replication_geo.rules import (
            GeoReplicationError,
            rules_from_s3_xml,
            rules_to_s3_xml,
        )

        om = self.client.om
        if method in ("PUT", "POST", "DELETE"):
            body = h._body()  # drained before any call that may raise
        if method == "PUT":
            try:
                rules = rules_from_s3_xml(
                    body, default_target=self._default_ec_target())
            except GeoReplicationError as e:
                h._reply(*_err("MalformedXML", str(e), 400))
                return
            om.set_bucket_geo_replication(self._vol, bucket, rules)
            h._reply(200)
        elif method == "GET":
            rules = om.get_bucket_geo_replication(self._vol, bucket)
            if not rules:
                h._reply(*_err(
                    "ReplicationConfigurationNotFoundError",
                    "The replication configuration was not found", 404))
                return
            h._reply(200, rules_to_s3_xml(rules),
                     {"Content-Type": "application/xml"})
        elif method == "DELETE":
            om.delete_bucket_geo_replication(self._vol, bucket)
            h._reply(204)
        else:
            h._reply(*_err("MethodNotAllowed", method, 405))

    def _list_buckets(self, h) -> None:
        root = ET.Element("ListAllMyBucketsResult", xmlns=_NS)
        buckets = ET.SubElement(root, "Buckets")
        for b in self.client.om.list_buckets(self._vol):
            be = ET.SubElement(buckets, "Bucket")
            ET.SubElement(be, "Name").text = b["name"]
            ET.SubElement(be, "CreationDate").text = str(b.get("created", ""))
        h._reply(200, _xml(root), {"Content-Type": "application/xml"})

    def _not_implemented(self, h, method: str, bucket: str, what: str,
                         key: Optional[str] = None) -> None:
        """501 for a sub-resource the port does not serve, after the body
        is drained and the bucket (or key) is found (404 first)."""
        if method in ("PUT", "POST", "DELETE"):
            h._body()
        if key is None:
            self.client.om.bucket_info(self._vol, bucket)
        else:
            self.client.om.lookup_key(self._vol, bucket, key)
        h._reply(*_err("NotImplemented", f"{what} is not supported", 501))

    _CANNED_ACLS = {
        "private": [],
        "public-read": [{"grantee": "*", "permission": "READ"}],
        "public-read-write": [
            {"grantee": "*", "permission": "READ"},
            {"grantee": "*", "permission": "WRITE"},
        ],
    }

    def _bucket_acl_op(self, h, method: str, bucket: str) -> None:
        """Bucket `?acl` (BucketEndpoint's get and put ACL): the S3 grants
        on the bucket row."""
        om = self.client.om
        if method == "GET":
            acl = om.get_bucket_acl(self._vol, bucket)
            root = ET.Element("AccessControlPolicy", xmlns=_NS)
            owner = ET.SubElement(root, "Owner")
            ET.SubElement(owner, "ID").text = "owner"
            grants = ET.SubElement(root, "AccessControlList")
            for g in acl or [{"grantee": "owner",
                              "permission": "FULL_CONTROL"}]:
                ge = ET.SubElement(grants, "Grant")
                gr = ET.SubElement(ge, "Grantee")
                ET.SubElement(gr, "ID").text = g["grantee"]
                ET.SubElement(ge, "Permission").text = g["permission"]
            h._reply(200, _xml(root), {"Content-Type": "application/xml"})
        elif method == "PUT":
            canned = h.headers.get("x-amz-acl")
            if canned is not None:
                h._body()
                if canned not in self._CANNED_ACLS:
                    h._reply(*_err("InvalidArgument", canned, 400))
                    return
                acl = self._CANNED_ACLS[canned]
            else:
                try:
                    acl = self._parse_acl_body(h._body())
                except (ET.ParseError, KeyError) as e:
                    h._reply(*_err("MalformedACLError", str(e), 400))
                    return
            om.set_bucket_acl(self._vol, bucket, acl)
            h._reply(200)
        else:
            h._body()
            h._reply(*_err("MethodNotAllowed", method, 405))

    @staticmethod
    def _parse_acl_body(body: bytes) -> list[dict]:
        acl = []
        if not body:
            return acl
        for ge in ET.fromstring(body).iter():
            if ge.tag.rpartition("}")[2] != "Grant":
                continue
            fields = {c.tag.rpartition("}")[2]: c for c in ge}
            grantee = fields.get("Grantee")
            gid = ""
            if grantee is not None:
                for c in grantee:
                    if c.tag.rpartition("}")[2] in ("ID", "URI"):
                        gid = (c.text or "").rpartition("/")[2]
            if gid in ("AllUsers",):
                gid = "*"
            acl.append({
                "grantee": gid,
                "permission": (fields["Permission"].text or "").strip(),
            })
        return acl

    def _object_acl(self, h, method: str, bucket: str, key: str) -> None:
        """Object `?acl`: object grants do not exist (as in the
        reference), so GET renders the effective policy (owner
        FULL_CONTROL and the bucket's public grants) and PUT answers 501
        instead of accepting grants that could never be enforced."""
        if method == "GET":
            self.client.om.lookup_key(self._vol, bucket, key)  # 404s
            root = ET.Element("AccessControlPolicy", xmlns=_NS)
            owner = ET.SubElement(root, "Owner")
            ET.SubElement(owner, "ID").text = "ozone"
            acl = ET.SubElement(root, "AccessControlList")

            def grant(grantee, perm):
                g = ET.SubElement(acl, "Grant")
                ge = ET.SubElement(g, "Grantee")
                xsi = "{http://www.w3.org/2001/XMLSchema-instance}type"
                if grantee == "*":
                    # the AWS Group shape: clients spot public access by
                    # the AllUsers URI
                    ge.set(xsi, "Group")
                    ET.SubElement(ge, "URI").text = (
                        "http://acs.amazonaws.com/groups/global/AllUsers")
                else:
                    ge.set(xsi, "CanonicalUser")
                    ET.SubElement(ge, "ID").text = grantee
                ET.SubElement(g, "Permission").text = perm

            grant("ozone", "FULL_CONTROL")
            for p in sorted(self._public_grants(bucket)):
                grant("*", p)
            h._reply(200, _xml(root), {"Content-Type": "application/xml"})
        elif method == "PUT":
            h._body()
            h._reply(*_err("NotImplemented",
                           "object ACLs are bucket-derived", 501))
        else:
            h._body()
            h._reply(*_err("MethodNotAllowed", method, 405))

    def _bucket_op(self, h, method: str, bucket: str, q) -> None:
        om = self.client.om
        if "acl" in q:
            self._bucket_acl_op(h, method, bucket)
            return
        if "tagging" in q:
            # object tagging is served, bucket tagging is not: answer the
            # AWS way instead of a ListBucketResult
            om.bucket_info(self._vol, bucket)  # 404 on a missing bucket
            if method == "GET":
                h._reply(*_err("NoSuchTagSet",
                               "no tag set on this bucket", 404))
            else:
                h._body()
                h._reply(*_err("NotImplemented",
                               "bucket tagging is not supported", 501))
            return
        if method == "GET" and "location" in q:
            # the SDKs' handshake: one region
            om.bucket_info(self._vol, bucket)
            root = ET.Element("LocationConstraint", xmlns=_NS)
            root.text = "us-east-1"
            h._reply(200, _xml(root), {"Content-Type": "application/xml"})
            return
        if method == "PUT" and "versioning" in q:
            om.bucket_info(self._vol, bucket)
            # not wired to object versions: fail loudly, not a silent 200
            h._reply(*_err("NotImplemented",
                           "bucket versioning is not supported", 501))
            return
        if method == "GET" and "versioning" in q:
            info = om.bucket_info(self._vol, bucket)
            root = ET.Element("VersioningConfiguration", xmlns=_NS)
            if info.get("versioning"):
                ET.SubElement(root, "Status").text = "Enabled"
            h._reply(200, _xml(root), {"Content-Type": "application/xml"})
            return
        if method == "GET" and "uploads" in q:
            self._list_uploads(h, bucket, q)
            return
        if "lifecycle" in q:
            self._bucket_lifecycle_op(h, method, bucket)
            return
        if "replication" in q:
            self._bucket_replication_op(h, method, bucket)
            return
        # the sub-resources the store does not serve answer 501 instead
        # of falling through to a bucket create or list: a silent 200
        # would make `aws s3api put-bucket-policy` look as if it worked
        for sub in _UNSUPPORTED_BUCKET_SUBS:
            if sub in q:
                self._not_implemented(h, method, bucket, f"bucket {sub}")
                return
        if method == "PUT":
            try:
                om.create_bucket(self._vol, bucket, self.replication)
            except _OM_ERRORS as e:
                # S3 answers success when the owner re-creates a bucket
                if e.code != "BUCKET_ALREADY_EXISTS":
                    raise
            h._reply(200, headers={"Location": f"/{bucket}"})
        elif method == "DELETE":
            om.delete_bucket(self._vol, bucket)
            h._reply(204)
        elif method == "GET":
            self._list_objects(h, bucket, q)
        elif method == "POST" and "delete" in q:
            self._multi_delete(h, bucket)
        elif method == "HEAD":
            om.bucket_info(self._vol, bucket)
            h._reply(200)
        else:
            h._reply(*_err("MethodNotAllowed", method, 405))

    def _list_uploads(self, h, bucket: str, q) -> None:
        """GET /bucket?uploads — ListMultipartUploads (BucketEndpoint
        ?uploads listing, BucketEndpoint.java:325): every in-progress
        upload in (key, uploadId) order, with prefix filtering,
        delimiter -> CommonPrefixes grouping, key-marker /
        upload-id-marker resume, and max-uploads truncation."""
        om = self.client.om
        om.bucket_info(self._vol, bucket)  # NoSuchBucket -> 404
        prefix = q.get("prefix", [""])[0]
        delim = q.get("delimiter", [""])[0]
        try:
            max_uploads = int(q.get("max-uploads", ["1000"])[0])
        except ValueError:
            max_uploads = -1
        if not 1 <= max_uploads <= 1000:
            # AWS bounds MaxUploads to 1-1000; clamping 0 to "truncated
            # with empty markers" would spin paginating clients forever
            h._reply(*_err("InvalidArgument", "max-uploads must be in "
                           "1..1000", 400))
            return
        key_marker = q.get("key-marker", [""])[0]
        id_marker = q.get("upload-id-marker", [""])[0]
        # the OM scan bounds by STORE key (/vol/bucket/<key>/<uploadId>)
        # — a superset when the prefix crosses the key/uploadId
        # boundary (key "a" matches prefix "a/"); re-check the key name
        entries = [
            m for m in om.list_multipart_uploads(self._vol, bucket, prefix)
            if m["name"].startswith(prefix)
        ]
        # AWS ordering: ascending key, then ascending uploadId
        entries.sort(key=lambda m: (m["name"], m["upload_id"]))
        uploads: list[dict] = []
        common: list[str] = []
        truncated = False
        for m in entries:
            name, uid = m["name"], m["upload_id"]
            if key_marker:
                # resume AFTER the marker pair: without an
                # upload-id-marker the whole marker key is consumed;
                # with one, later uploads of that key still list
                if name < key_marker or (
                        name == key_marker
                        and (not id_marker or uid <= id_marker)):
                    continue
            if delim:
                rest = name[len(prefix):]
                cut = rest.find(delim)
                if cut >= 0:
                    cp = prefix + rest[: cut + len(delim)]
                    # a key-marker equal to (or past) a served group's
                    # prefix consumes the group, like V1 NextMarker
                    if key_marker and cp <= key_marker:
                        continue
                    if common and common[-1] == cp:
                        continue
                    if len(uploads) + len(common) >= max_uploads:
                        truncated = True
                        break
                    common.append(cp)
                    continue
            if len(uploads) + len(common) >= max_uploads:
                truncated = True
                break
            uploads.append(m)
        # ?encoding-type=url: same contract as ListObjects — keys,
        # prefixes and key markers answer URL-encoded
        enc_url, esc = _esc_fn(q)
        root = ET.Element("ListMultipartUploadsResult", xmlns=_NS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "KeyMarker").text = esc(key_marker)
        ET.SubElement(root, "UploadIdMarker").text = id_marker
        if enc_url:
            ET.SubElement(root, "EncodingType").text = "url"
        if truncated:
            # next markers name the last entity served; a CommonPrefix
            # resumes key-only (uploads inside it were never listed)
            last_key = uploads[-1]["name"] if uploads else ""
            last_cp = common[-1] if common else ""
            if last_cp > last_key:
                ET.SubElement(root, "NextKeyMarker").text = esc(last_cp)
                ET.SubElement(root, "NextUploadIdMarker").text = ""
            else:
                ET.SubElement(root, "NextKeyMarker").text = esc(last_key)
                ET.SubElement(root, "NextUploadIdMarker").text = (
                    uploads[-1]["upload_id"])
        ET.SubElement(root, "Prefix").text = esc(prefix)
        if delim:
            ET.SubElement(root, "Delimiter").text = esc(delim)
        ET.SubElement(root, "MaxUploads").text = str(max_uploads)
        ET.SubElement(root, "IsTruncated").text = (
            "true" if truncated else "false")
        for m in uploads:
            u = ET.SubElement(root, "Upload")
            ET.SubElement(u, "Key").text = esc(m["name"])
            ET.SubElement(u, "UploadId").text = m["upload_id"]
            owner = ET.SubElement(u, "Owner")
            ET.SubElement(owner, "ID").text = "ozone"
            init = ET.SubElement(u, "Initiator")
            ET.SubElement(init, "ID").text = "ozone"
            ET.SubElement(u, "StorageClass").text = "STANDARD"
            ET.SubElement(u, "Initiated").text = _iso_ts(
                m.get("created", 0.0))
        for cp in common:
            e = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(e, "Prefix").text = esc(cp)
        h._reply(200, _xml(root), {"Content-Type": "application/xml"})

    def _list_objects(self, h, bucket: str, q) -> None:
        """ListObjects V2 AND V1 over one paging engine: prefix,
        delimiter -> CommonPrefixes grouping, max-keys truncation.
        V2 (?list-type=2) resumes via NextContinuationToken /
        start-after; V1 (no list-type — older SDKs) resumes via
        ?marker and reports Marker/NextMarker instead of
        KeyCount/ContinuationToken (BucketEndpoint list semantics)."""
        om = self.client.om
        v1 = q.get("list-type", [""])[0] != "2"
        prefix = q.get("prefix", [""])[0]
        delim = q.get("delimiter", [""])[0]
        try:
            max_keys = max(0, int(q.get("max-keys", ["1000"])[0]))
        except ValueError:
            h._reply(*_err("InvalidArgument", "bad max-keys", 400))
            return
        marker = q.get("marker", [""])[0]
        # both resume cursors emit entities in key order, so the
        # group-already-served check below treats them identically
        token = (marker if v1
                 else _parse_token(
                     q.get("continuation-token", [""])[0]))
        after = token or q.get("start-after", [""])[0]
        contents: list[dict] = []
        common: list[str] = []
        truncated = False
        next_token = ""
        # both layouts page server-side now (OBS: bounded store scan;
        # FSO: pruned path-order tree walk) — fetch windows until the
        # entity budget fills or the listing runs dry, so a large
        # rolled-up group is skipped inside THIS request, not bounced
        # back to the client
        window = (max_keys + 1) if max_keys else 0
        cursor = after
        while max_keys:  # AWS: MaxKeys=0 returns empty, not truncated
            keys = om.list_keys(self._vol, bucket, prefix,
                                start_after=cursor,
                                limit=window or None)
            for k in keys:
                name = k["name"]
                if delim:
                    rest = name[len(prefix):]
                    cut = rest.find(delim)
                    if cut >= 0:  # group under the rolled-up prefix
                        cp = prefix + rest[: cut + len(delim)]
                        # V2 continuation tokens are SERVER-issued and
                        # emit entities in key order, so cp <= token
                        # means the group was served on a prior page.
                        # V1 markers are client-arbitrary (like raw
                        # start-after): only a marker EQUAL to the
                        # prefix consumes the group (AWS NextMarker
                        # semantics); a marker inside the group must
                        # still emit its CommonPrefix.
                        if token and (cp == token
                                      or (not v1 and cp <= token)):
                            continue
                        if common and common[-1] == cp:
                            continue
                        if len(contents) + len(common) >= max_keys:
                            truncated = True
                            break
                        common.append(cp)
                        continue
                if len(contents) + len(common) >= max_keys:
                    truncated = True
                    break
                contents.append(k)
            if truncated or not window or len(keys) < window:
                break
            cursor = keys[-1]["name"]
        if truncated:
            next_token = (contents[-1]["name"] if contents else "")
            last_cp = common[-1] if common else ""
            next_token = max(next_token, last_cp)
        # ?encoding-type=url (boto3 sends it by default): key-derived
        # strings in the RESPONSE are URL-encoded, so keys containing
        # XML-hostile characters (newlines, control bytes) survive the
        # round trip; the EncodingType element tells the SDK to decode
        enc_url, esc = _esc_fn(q)
        root = ET.Element("ListBucketResult", xmlns=_NS)
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = esc(prefix)
        if enc_url:
            ET.SubElement(root, "EncodingType").text = "url"
        if delim:
            ET.SubElement(root, "Delimiter").text = esc(delim)
        if v1:
            ET.SubElement(root, "Marker").text = esc(marker)
        else:
            ET.SubElement(root, "KeyCount").text = str(
                len(contents) + len(common))
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        ET.SubElement(root, "IsTruncated").text = (
            "true" if truncated else "false")
        if truncated and next_token:
            # V1 NextMarker is a KEY (encoding-type applies); the V2
            # token is opaque and safe for any key bytes
            ET.SubElement(root,
                          "NextMarker" if v1
                          else "NextContinuationToken").text = \
                esc(next_token) if v1 else _opaque_token(next_token)
        for k in contents:
            c = ET.SubElement(root, "Contents")
            ET.SubElement(c, "Key").text = esc(k["name"])
            ET.SubElement(c, "Size").text = str(k["size"])
            ET.SubElement(c, "LastModified").text = str(k.get("modified", ""))
        for cp in common:
            e = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(e, "Prefix").text = esc(cp)
        h._reply(200, _xml(root), {"Content-Type": "application/xml"})

    def _multi_delete(self, h, bucket: str) -> None:
        """POST /bucket?delete (BucketEndpoint multi-delete): per-key
        success/error entries, quiet-mode suppression of successes."""
        try:
            tree = ET.fromstring(h._body())
        except ET.ParseError as e:
            h._reply(*_err("MalformedXML", str(e), 400))
            return
        quiet = (tree.findtext("{*}Quiet") or
                 tree.findtext("Quiet") or "").lower() == "true"
        names = [
            el.findtext("{*}Key") or el.findtext("Key") or ""
            for el in list(tree.iter("{%s}Object" % _NS)) +
            list(tree.iter("Object"))
        ]
        bh = self._bucket_handle(bucket)
        root = ET.Element("DeleteResult", xmlns=_NS)
        for name in names:
            if not name:
                continue
            try:
                bh.delete_key(name)
                if not quiet:
                    d = ET.SubElement(root, "Deleted")
                    ET.SubElement(d, "Key").text = name
            except _OM_ERRORS as e:
                # S3 treats deleting a missing key as success
                if e.code == "KEY_NOT_FOUND":
                    if not quiet:
                        d = ET.SubElement(root, "Deleted")
                        ET.SubElement(d, "Key").text = name
                else:
                    er = ET.SubElement(root, "Error")
                    ET.SubElement(er, "Key").text = name
                    ET.SubElement(er, "Code").text = e.code
                    ET.SubElement(er, "Message").text = str(e)
        h._reply(200, _xml(root), {"Content-Type": "application/xml"})

    # ------------------------------------------------------------- objects
    def _bucket_handle(self, bucket: str):
        return self.client.get_volume(self._vol).get_bucket(bucket)

    def _object_op(self, h, method: str, bucket: str, key: str, q) -> None:
        if method == "POST" and "uploads" in q:
            self._mpu_initiate(h, bucket, key)
        elif method == "PUT" and "uploadId" in q:
            self._mpu_part(h, bucket, key, q)
        elif method == "POST" and "uploadId" in q:
            self._mpu_complete(h, bucket, key, q)
        elif method == "DELETE" and "uploadId" in q:
            self._mpu_abort(h, bucket, key, q)
        elif method == "GET" and "uploadId" in q:
            self._mpu_list_parts(h, bucket, key, q)
        elif "acl" in q:
            self._object_acl(h, method, bucket, key)
        elif "tagging" in q:
            self._object_tagging(h, method, bucket, key)
        elif method == "PUT":
            self._put_object(h, bucket, key)
        elif method == "GET":
            self._get_object(h, bucket, key)
        elif method == "HEAD":
            self._head_object(h, bucket, key)
        elif method == "DELETE":
            self._bucket_handle(bucket).delete_key(key)
            h._reply(204)
        else:
            h._reply(*_err("MethodNotAllowed", method, 405))

    @staticmethod
    def _validate_tags(tags: dict) -> Optional[str]:
        """AWS tag restrictions: <=10 tags per object, key <=128 chars,
        value <=256, no duplicate keys (dict dedupes already)."""
        if len(tags) > 10:
            return "object tags cannot exceed 10"
        for k, v in tags.items():
            if not k or len(k) > 128:
                return f"invalid tag key {k!r}"
            if len(v) > 256:
                return f"tag value too long for {k!r}"
        return None

    def _object_tagging(self, h, method: str, bucket: str,
                        key: str) -> None:
        """?tagging sub-resource (ObjectEndpoint PUT/GET/DELETE tagging;
        S3 PutObjectTagging family). Tags live on the key row's attrs,
        replicated like every other key mutation."""
        om = self.client.om
        if method == "PUT":
            try:
                # bytes straight in: ET honors XML encoding decls, and
                # a bad .decode() here would 500 instead of 400
                root = ET.fromstring(h._body())
                tags = {
                    t.findtext(f"{{{_NS}}}Key", t.findtext("Key", "")):
                    t.findtext(f"{{{_NS}}}Value", t.findtext("Value", ""))
                    for ts in (root.findall(f"{{{_NS}}}TagSet")
                               or root.findall("TagSet"))
                    for t in (ts.findall(f"{{{_NS}}}Tag")
                              or ts.findall("Tag"))
                }
            except ET.ParseError as e:
                h._reply(*_err("MalformedXML", str(e), 400))
                return
            bad = self._validate_tags(tags)
            if bad:
                h._reply(*_err("InvalidTag", bad, 400))
                return
            om.set_key_attrs(self._vol, bucket, key, {"tags": tags})
            h._reply(200)
        elif method == "GET":
            info = om.lookup_key(self._vol, bucket, key)
            tags = (info.get("attrs") or {}).get("tags", {})
            root = ET.Element("Tagging", xmlns=_NS)
            ts = ET.SubElement(root, "TagSet")
            for k, v in sorted(tags.items()):
                t = ET.SubElement(ts, "Tag")
                ET.SubElement(t, "Key").text = k
                ET.SubElement(t, "Value").text = v
            h._reply(200, _xml(root),
                     {"Content-Type": "application/xml"})
        elif method == "DELETE":
            om.set_key_attrs(self._vol, bucket, key, {"tags": None})
            h._reply(204)
        else:
            h._reply(*_err("MethodNotAllowed", method, 405))

    def _parse_copy_source(self, h) -> Optional[tuple[str, str]]:
        """x-amz-copy-source: '/bucket/key' or 'bucket/key' (URL-encoded).
        Returns (bucket, key) or None when the header is absent."""
        src = h.headers.get("x-amz-copy-source")
        if not src:
            return None
        src = unquote(src).lstrip("/")
        b, _, k = src.partition("/")
        if not b or not k:
            raise ValueError(src)
        return b, k

    def _put_object(self, h, bucket: str, key: str) -> None:
        try:
            src = self._parse_copy_source(h)
        except ValueError as e:
            h._reply(*_err("InvalidArgument",
                           f"bad x-amz-copy-source: {e}", 400))
            return
        if src is not None:  # CopyObject (ObjectEndpoint.put copyHeader)
            h._body()  # drain any (ignored) request body
            src_info = self.client.om.lookup_key(self._vol, src[0], src[1])
            data = self._bucket_handle(src[0]).read_key_info(src_info)
            # metadata directive: COPY (default) carries the source
            # object's user metadata; REPLACE takes this request's
            if (h.headers.get("x-amz-metadata-directive", "COPY")
                    .upper() == "REPLACE"):
                meta = self._user_metadata(h)
            else:
                meta = src_info.get("metadata") or {}
            # tagging directive: COPY (default) carries the source's
            # tags; REPLACE takes this request's x-amz-tagging header
            if (h.headers.get("x-amz-tagging-directive", "COPY")
                    .upper() == "REPLACE"):
                tags = {k: v[0] for k, v in parse_qs(
                    h.headers.get("x-amz-tagging", ""),
                    keep_blank_values=True).items()}
            else:
                tags = (src_info.get("attrs") or {}).get("tags", {})
            self._bucket_handle(bucket).write_key(key, data, metadata=meta)
            if tags:
                self.client.om.set_key_attrs(self._vol, bucket, key,
                                             {"tags": tags})
            etag = hashlib.md5(data).hexdigest()
            root = ET.Element("CopyObjectResult", xmlns=_NS)
            ET.SubElement(root, "ETag").text = f'"{etag}"'
            ET.SubElement(root, "LastModified").text = _iso_now()
            h._reply(200, _xml(root), {"Content-Type": "application/xml"})
            return
        tags = None
        hdr = h.headers.get("x-amz-tagging")
        if hdr:
            # query-string-encoded tags on the PUT itself
            tags = {k: v[0] for k, v in parse_qs(
                hdr, keep_blank_values=True).items()}
            bad = self._validate_tags(tags)
            if bad:
                h._body()  # drain, or keep-alive desyncs on early 400
                h._reply(*_err("InvalidTag", bad, 400))
                return
        body = h._body()
        self._bucket_handle(bucket).write_key(
            key, np.frombuffer(body, np.uint8),
            metadata=self._user_metadata(h),
        )
        if tags:
            self.client.om.set_key_attrs(self._vol, bucket, key,
                                         {"tags": tags})
        etag = hashlib.md5(body).hexdigest()
        h._reply(200, headers={"ETag": f'"{etag}"'})

    @staticmethod
    def _user_metadata(h) -> dict:
        """x-amz-meta-* request headers -> user metadata map (stored on
        the key like the reference's custom-metadata support)."""
        out = {}
        for name, value in h.headers.items():
            low = name.lower()
            if low.startswith("x-amz-meta-"):
                out[low[len("x-amz-meta-"):]] = value
        return out

    @staticmethod
    def _meta_headers_from(info: dict) -> dict:
        return {
            f"x-amz-meta-{k}": str(v)
            for k, v in (info.get("metadata") or {}).items()
        }

    def _get_object(self, h, bucket: str, key: str) -> None:
        # one lookup serves metadata headers AND the block list
        info = self.client.om.lookup_key(self._vol, bucket, key)
        bh = self._bucket_handle(bucket)
        meta = self._meta_headers_from(info)
        size = int(info["size"])
        rng = h.headers.get("Range")
        ranged = False
        lo = hi = 0
        if rng and rng.startswith("bytes="):
            lo_s, _, hi_s = rng[6:].partition("-")
            if not lo_s:  # suffix form bytes=-N: the LAST N bytes
                n = int(hi_s)
                lo = max(0, size - n)
                hi = size - 1
                ranged = True
            else:
                lo = int(lo_s)
                if hi_s and int(hi_s) < lo:
                    # client-sent inverted range-spec: RFC 9110
                    # §14.1.1 says the Range header is invalid and
                    # MUST be ignored (full 200 body), matching real
                    # S3 — not a 416
                    ranged = False
                else:
                    hi = int(hi_s) if hi_s else size - 1
                    ranged = True
            if ranged and lo >= size:
                # unsatisfiable range: 416 with the star form, never a
                # 206 whose Content-Range would carry hi < lo (S3 /
                # RFC 9110 §14.4 semantics)
                status, body = _err(
                    "InvalidRange",
                    "The requested range is not satisfiable", 416)
                h._reply(status, body,
                         {"Content-Range": f"bytes */{size}"})
                return
        if ranged:
            # a ranged GET reads only the covering cells or chunks
            hi = min(hi, size - 1)
            part = bh.read_key_info_range(info, lo, hi - lo + 1)
            h._reply(
                206,
                part,
                {
                    "Content-Type": "application/octet-stream",
                    "Content-Range": f"bytes {lo}-{hi}/{size}",
                    **meta,
                },
            )
        else:
            h._reply(200, bh.read_key_info(info),
                     {"Content-Type": "application/octet-stream", **meta})

    def _head_object(self, h, bucket: str, key: str) -> None:
        """HEAD must report the real object size in Content-Length with no
        body (S3 semantics; SDKs size objects this way before ranged
        GETs), so the reply is hand-rolled instead of using _reply."""
        info = self.client.om.lookup_key(self._vol, bucket, key)
        h.send_response(200)
        h.send_header("Content-Type", "application/octet-stream")
        h.send_header("Content-Length", str(info["size"]))
        for k, v in (info.get("metadata") or {}).items():
            h.send_header(f"x-amz-meta-{k}", str(v))
        h.end_headers()

    # ------------------------------------------------------------- multipart
    # Backed by the OM multipart table (om/multipart.py), the reference's
    # design: the gateway is stateless, upload state survives restarts,
    # and parts stream through the normal EC/replicated datapath.
    def _mpu_initiate(self, h, bucket: str, key: str) -> None:
        mpu = self._bucket_handle(bucket).initiate_multipart_upload(
            key, metadata=self._user_metadata(h))
        root = ET.Element("InitiateMultipartUploadResult", xmlns=_NS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = mpu.upload_id
        h._reply(200, _xml(root), {"Content-Type": "application/xml"})

    def _mpu_handle(self, bucket: str, key: str, q) -> MultipartUpload:
        # no existence check: the OM's own call raises
        # NO_SUCH_MULTIPART_UPLOAD (a 404), saving a round trip per part
        upload_id = q["uploadId"][0]
        return MultipartUpload(self._bucket_handle(bucket), key, upload_id)

    def _mpu_part(self, h, bucket: str, key: str, q) -> None:
        mpu = self._mpu_handle(bucket, key, q)
        part_no = int(q.get("partNumber", ["1"])[0])
        try:
            src = self._parse_copy_source(h)
        except ValueError as e:
            h._reply(*_err("InvalidArgument",
                           f"bad x-amz-copy-source: {e}", 400))
            return
        if src is not None:  # UploadPartCopy (ObjectEndpoint copy-part)
            h._body()
            data = self._bucket_handle(src[0]).read_key(src[1])
            rng = h.headers.get("x-amz-copy-source-range")
            if rng:
                # AWS requires the full bytes=<lo>-<hi> form here (no
                # open-ended or suffix ranges) and rejects bounds that
                # fall outside the source object
                lo_s, dash, hi_s = rng.removeprefix("bytes=").partition("-")
                if (not rng.startswith("bytes=") or not dash
                        or not lo_s.isdigit() or not hi_s.isdigit()):
                    h._reply(*_err(
                        "InvalidArgument",
                        f"bad x-amz-copy-source-range: {rng}", 400))
                    return
                lo, hi = int(lo_s), int(hi_s)
                if lo > hi or hi >= len(data):
                    h._reply(*_err(
                        "InvalidRange",
                        f"range {lo}-{hi} outside source of "
                        f"{len(data)} bytes", 416))
                    return
                data = data[lo : hi + 1]
            etag = mpu.write_part(part_no, data)
            root = ET.Element("CopyPartResult", xmlns=_NS)
            ET.SubElement(root, "ETag").text = f'"{etag}"'
            ET.SubElement(root, "LastModified").text = _iso_now()
            h._reply(200, _xml(root), {"Content-Type": "application/xml"})
            return
        body = h._body()
        etag = mpu.write_part(part_no, np.frombuffer(body, np.uint8))
        h._reply(200, headers={"ETag": f'"{etag}"'})

    def _mpu_complete(self, h, bucket: str, key: str, q) -> None:
        mpu = self._mpu_handle(bucket, key, q)
        # parts may be listed in the XML body; default to all uploaded
        parts = None
        body = h._body()
        if body:
            listed = []
            for pe in ET.fromstring(body):
                if pe.tag.rpartition("}")[2] != "Part":
                    continue
                fields = {c.tag.rpartition("}")[2]: (c.text or "") for c in pe}
                listed.append({
                    "part_number": int(fields["PartNumber"]),
                    "etag": fields.get("ETag", "").strip('"'),
                })
            parts = listed or None
        if parts is None:
            parts = [
                {"part_number": p["part_number"], "etag": p["etag"]}
                for p in mpu.list_parts()
            ]
        info = mpu.complete(parts)
        root = ET.Element("CompleteMultipartUploadResult", xmlns=_NS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "ETag").text = f'"{info["etag"]}"'
        h._reply(200, _xml(root), {"Content-Type": "application/xml"})

    def _mpu_abort(self, h, bucket: str, key: str, q) -> None:
        mpu = self._mpu_handle(bucket, key, q)
        mpu.abort()
        h._reply(204)

    def _mpu_list_parts(self, h, bucket: str, key: str, q) -> None:
        mpu = self._mpu_handle(bucket, key, q)
        root = ET.Element("ListPartsResult", xmlns=_NS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = mpu.upload_id
        for p in mpu.list_parts():
            pe = ET.SubElement(root, "Part")
            ET.SubElement(pe, "PartNumber").text = str(p["part_number"])
            ET.SubElement(pe, "ETag").text = f'"{p["etag"]}"'
            ET.SubElement(pe, "Size").text = str(p["size"])
        h._reply(200, _xml(root), {"Content-Type": "application/xml"})
