"""AWS Signature V4: the verifier the S3 gateway runs, and the signers its
clients use.

Port of `ozone_tpu/gateway/s3_auth.py` (the reference's s3gateway
AuthorizationFilter -> AWSSignatureProcessor): the canonical request,
the string to sign, the signing key

    kSigning = HMAC(HMAC(HMAC(HMAC("AWS4" + secret, date), region),
                         service), "aws4_request")

and the signature HMAC(kSigning, string-to-sign), for the three SigV4
carriages: the Authorization header (with the signed payload hash and an
optional clock-skew window), presigned URLs (query parameters, at most 7
days), and aws-chunked streaming bodies (each chunk's signature chained
from the previous one). The client halves (`sign_request`,
`presign_url`, `encode_aws_chunked`, `sign_request_streaming`, and
`request_headers` over them) are what the tests, freon's `s3kg` and
`chip_smoke.py` use as an S3 client. Standard library only.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse
from dataclasses import dataclass
from typing import Optional

UNSIGNED = "UNSIGNED-PAYLOAD"
ALGORITHM = "AWS4-HMAC-SHA256"
#: x-amz-content-sha256 value announcing an aws-chunked signed-payload
#: stream (ObjectEndpointStreaming in the reference)
STREAMING = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"


class AuthError(Exception):
    def __init__(self, code: str, msg: str = ""):
        super().__init__(f"{code}: {msg}" if msg else code)
        self.code = code


@dataclass
class ParsedAuth:
    access_id: str
    date: str  # yyyymmdd credential-scope date
    region: str
    service: str
    signed_headers: list[str]
    signature: str


def parse_authorization(header: str) -> ParsedAuth:
    """Parse `AWS4-HMAC-SHA256 Credential=AKID/date/region/svc/aws4_request,
    SignedHeaders=a;b;c, Signature=hex`."""
    if not header.startswith(ALGORITHM):
        raise AuthError("InvalidArgument", "unsupported auth scheme")
    fields = {}
    for part in header[len(ALGORITHM):].split(","):
        k, _, v = part.strip().partition("=")
        fields[k] = v
    try:
        cred = fields["Credential"].split("/")
        access_id, date, region, service, terminator = cred
        if terminator != "aws4_request":
            raise ValueError(terminator)
        return ParsedAuth(
            access_id=access_id,
            date=date,
            region=region,
            service=service,
            signed_headers=fields["SignedHeaders"].split(";"),
            signature=fields["Signature"].lower(),
        )
    except (KeyError, ValueError) as e:
        raise AuthError("AuthorizationHeaderMalformed", str(e))


def _uri_encode(s: str, is_path: bool = False) -> str:
    # AWS canonical encoding: unreserved chars stay, '/' kept in paths
    return urllib.parse.quote(s, safe="/-_.~" if is_path else "-_.~")


def canonical_request(
    method: str,
    path: str,
    query: str,
    headers: dict,
    signed_headers: list[str],
    payload_hash: str,
) -> str:
    # canonical URI: each path segment URI-encoded
    segments = path.split("/")
    canon_path = "/".join(_uri_encode(urllib.parse.unquote(s)) for s in segments)
    if not canon_path.startswith("/"):
        canon_path = "/" + canon_path
    # canonical query: decode then re-encode, sort by name then value
    pairs = []
    if query:
        for item in query.split("&"):
            if not item:
                continue
            k, _, v = item.partition("=")
            pairs.append(
                (_uri_encode(urllib.parse.unquote_plus(k)),
                 _uri_encode(urllib.parse.unquote_plus(v)))
            )
    canon_query = "&".join(f"{k}={v}" for k, v in sorted(pairs))
    lower = {k.lower(): v for k, v in headers.items()}
    canon_headers = "".join(
        f"{h}:{' '.join(str(lower.get(h, '')).split())}\n"
        for h in signed_headers
    )
    return "\n".join(
        [
            method.upper(),
            canon_path,
            canon_query,
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join(
        [
            ALGORITHM,
            amz_date,
            scope,
            hashlib.sha256(canon_req.encode()).hexdigest(),
        ]
    )


def signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    def h(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = h(("AWS4" + secret).encode(), date)
    k = h(k, region)
    k = h(k, service)
    return h(k, "aws4_request")


def compute_signature(
    secret: str,
    method: str,
    path: str,
    query: str,
    headers: dict,
    auth: ParsedAuth,
    payload_hash: str,
) -> str:
    canon = canonical_request(
        method, path, query, headers, auth.signed_headers, payload_hash
    )
    lower = {k.lower(): v for k, v in headers.items()}
    amz_date = str(lower.get("x-amz-date") or lower.get("date") or "")
    scope = f"{auth.date}/{auth.region}/{auth.service}/aws4_request"
    sts = string_to_sign(amz_date, scope, canon)
    key = signing_key(secret, auth.date, auth.region, auth.service)
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


def verify_request(
    secret: str,
    method: str,
    path: str,
    query: str,
    headers: dict,
    body: bytes,
    auth: ParsedAuth,
    max_skew_s: Optional[float] = None,
) -> None:
    """Raise AuthError unless the request signature matches. With
    max_skew_s set, the signed x-amz-date must be within that window of
    the server clock (AWS enforces 15 minutes), so captured requests
    cannot be replayed verbatim later."""
    lower = {k.lower(): v for k, v in headers.items()}
    if max_skew_s is not None:
        import calendar
        import time as _time

        amz_date = str(lower.get("x-amz-date") or lower.get("date") or "")
        try:
            t = calendar.timegm(
                _time.strptime(amz_date, "%Y%m%dT%H%M%SZ")
            )
        except ValueError:
            raise AuthError("AccessDenied", f"bad x-amz-date {amz_date!r}")
        if abs(_time.time() - t) > max_skew_s:
            raise AuthError("RequestTimeTooSkewed", amz_date)
    claimed = str(lower.get("x-amz-content-sha256", ""))
    if claimed in (UNSIGNED, STREAMING):
        # STREAMING: the header signature covers the literal marker; the
        # per-chunk signatures are verified by decode_aws_chunked
        payload_hash = claimed
    elif claimed:
        # always check the claimed hash — including against an empty
        # body, or a stripped-body replay of a signed PUT would verify
        if claimed != hashlib.sha256(body).hexdigest():
            raise AuthError("XAmzContentSHA256Mismatch", "payload hash")
        payload_hash = claimed
    else:
        payload_hash = hashlib.sha256(body).hexdigest()
    expected = compute_signature(
        secret, method, path, query, headers, auth, payload_hash
    )
    if not hmac.compare_digest(expected, auth.signature):
        raise AuthError("SignatureDoesNotMatch", "signature mismatch")


# ------------------------------------------------------------ presigned URLs
def parse_query_auth(query: str) -> tuple[ParsedAuth, str, int]:
    """Parse query-parameter SigV4 (presigned URL): returns (auth,
    amz_date, expires_s). Reference: AWSSignatureProcessor's query-param
    branch feeding the same verification as header auth."""
    q = dict(
        (k, urllib.parse.unquote_plus(v))
        for k, _, v in (item.partition("=")
                        for item in query.split("&") if item)
    )
    if q.get("X-Amz-Algorithm") != ALGORITHM:
        raise AuthError("InvalidArgument", "unsupported query auth")
    try:
        cred = q["X-Amz-Credential"].split("/")
        access_id, date, region, service, terminator = cred
        if terminator != "aws4_request":
            raise ValueError(terminator)
        expires = int(q.get("X-Amz-Expires", "0"))
        if not 0 <= expires <= 604800:
            # AWS caps presigned validity at 7 days; without a bound a
            # leaked URL minted with a huge Expires never dies
            raise AuthError("AuthorizationQueryParametersError",
                            "X-Amz-Expires must be 0..604800")
        return (
            ParsedAuth(
                access_id=access_id,
                date=date,
                region=region,
                service=service,
                signed_headers=q["X-Amz-SignedHeaders"].split(";"),
                signature=q["X-Amz-Signature"].lower(),
            ),
            q["X-Amz-Date"],
            expires,
        )
    except (KeyError, ValueError) as e:
        raise AuthError("AuthorizationQueryParametersError", str(e))


def verify_presigned(
    secret: str,
    method: str,
    path: str,
    query: str,
    headers: dict,
    now: Optional[float] = None,
    parsed: Optional[tuple[ParsedAuth, str, int]] = None,
    max_skew_s: Optional[float] = None,
) -> str:
    """Verify a presigned-URL request; returns the access id. The
    canonical query is every parameter EXCEPT X-Amz-Signature, the
    payload is UNSIGNED-PAYLOAD, and X-Amz-Date + X-Amz-Expires bound
    the validity window (the AWS documentation's presigned example is
    the reference vector). `parsed` takes an already-parsed
    parse_query_auth result so callers don't parse twice."""
    import calendar
    import time as _time

    auth, amz_date, expires = parsed or parse_query_auth(query)
    try:
        t = calendar.timegm(_time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        raise AuthError("AccessDenied", f"bad X-Amz-Date {amz_date!r}")
    now_s = now if now is not None else _time.time()
    if t > now_s + (max_skew_s if max_skew_s is not None else 900):
        # a future-dated presign would extend validity past Expires
        raise AuthError("AccessDenied", "X-Amz-Date is in the future")
    if now_s > t + expires:
        raise AuthError("AccessDenied", "Request has expired")
    canon_query = "&".join(
        item for item in query.split("&")
        if item and not item.startswith("X-Amz-Signature=")
    )
    canon = canonical_request(
        method, path, canon_query, headers, auth.signed_headers, UNSIGNED
    )
    scope = f"{auth.date}/{auth.region}/{auth.service}/aws4_request"
    sts = string_to_sign(amz_date, scope, canon)
    key = signing_key(secret, auth.date, auth.region, auth.service)
    expected = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expected, auth.signature):
        raise AuthError("SignatureDoesNotMatch", "presigned signature")
    return auth.access_id


def presign_url(
    access_id: str,
    secret: str,
    method: str,
    url: str,
    expires_s: int = 3600,
    amz_date: Optional[str] = None,
    region: str = "us-east-1",
    service: str = "s3",
) -> str:
    """Produce a presigned URL (client half; the gateway's `sh s3
    presign` analog of `aws s3 presign`)."""
    import time as _time

    u = urllib.parse.urlsplit(url)
    if amz_date is None:
        amz_date = _time.strftime("%Y%m%dT%H%M%SZ", _time.gmtime())
    date = amz_date[:8]
    cred = f"{access_id}/{date}/{region}/{service}/aws4_request"
    params = [
        ("X-Amz-Algorithm", ALGORITHM),
        ("X-Amz-Credential", cred),
        ("X-Amz-Date", amz_date),
        ("X-Amz-Expires", str(expires_s)),
        ("X-Amz-SignedHeaders", "host"),
    ]
    base_q = [item for item in u.query.split("&") if item]
    all_q = base_q + [
        f"{k}={urllib.parse.quote(v, safe='-_.~')}" for k, v in params
    ]
    query = "&".join(all_q)
    host = u.netloc
    canon = canonical_request(
        method, u.path or "/", query, {"host": host}, ["host"], UNSIGNED
    )
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign(amz_date, scope, canon)
    key = signing_key(secret, date, region, service)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return (
        f"{u.scheme or 'http'}://{host}{u.path}?{query}"
        f"&X-Amz-Signature={sig}"
    )


# --------------------------------------------------------- aws-chunked body
def _chunk_signature(key: bytes, amz_date: str, scope: str,
                     prev_sig: str, data: bytes) -> str:
    """AWS4-HMAC-SHA256-PAYLOAD chunk signature: chains the previous
    signature so chunks cannot be reordered/replayed (checked against
    the official streaming-upload doc vectors in tests)."""
    sts = "\n".join(
        [
            "AWS4-HMAC-SHA256-PAYLOAD",
            amz_date,
            scope,
            prev_sig,
            hashlib.sha256(b"").hexdigest(),
            hashlib.sha256(data).hexdigest(),
        ]
    )
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


def decode_aws_chunked(
    body: bytes,
    secret: str,
    auth: ParsedAuth,
    amz_date: str,
    seed_signature: str,
) -> bytes:
    """Decode + verify an aws-chunked signed payload. Every chunk's
    signature must chain from the seed (the Authorization header's
    signature); any mismatch or framing error rejects the whole body."""
    key = signing_key(secret, auth.date, auth.region, auth.service)
    scope = f"{auth.date}/{auth.region}/{auth.service}/aws4_request"
    out = bytearray()
    prev = seed_signature
    pos = 0
    while True:
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise AuthError("IncompleteBody", "missing chunk header")
        header = body[pos:nl].decode("ascii", "replace")
        size_hex, _, ext = header.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise AuthError("IncompleteBody", f"bad chunk size {size_hex!r}")
        sig = ""
        if ext.startswith("chunk-signature="):
            sig = ext[len("chunk-signature="):].strip().lower()
        data = body[nl + 2: nl + 2 + size]
        if len(data) != size:
            raise AuthError("IncompleteBody", "truncated chunk")
        expect = _chunk_signature(key, amz_date, scope, prev, data)
        if not hmac.compare_digest(expect, sig):
            raise AuthError("SignatureDoesNotMatch",
                            f"chunk at offset {pos}")
        prev = expect
        pos = nl + 2 + size
        if body[pos:pos + 2] == b"\r\n":
            pos += 2
        if size == 0:
            return bytes(out)
        out.extend(data)


def encode_aws_chunked(
    data: bytes,
    secret: str,
    auth: ParsedAuth,
    amz_date: str,
    seed_signature: str,
    chunk_size: int = 64 * 1024,
) -> bytes:
    """Client half: produce the aws-chunked signed body (tests + any
    in-framework S3 client doing streaming PUTs)."""
    key = signing_key(secret, auth.date, auth.region, auth.service)
    scope = f"{auth.date}/{auth.region}/{auth.service}/aws4_request"
    out = bytearray()
    prev = seed_signature
    offsets = list(range(0, len(data), chunk_size)) if data else []
    for off in offsets + [len(data)]:
        chunk = data[off:off + chunk_size] if off < len(data) else b""
        sig = _chunk_signature(key, amz_date, scope, prev, chunk)
        out += (f"{len(chunk):x};chunk-signature={sig}\r\n").encode()
        out += chunk + b"\r\n"
        prev = sig
        if not chunk:
            break
    return bytes(out)


# --------------------------------------------------------------- test-side
def sign_request(
    access_id: str,
    secret: str,
    method: str,
    url: str,
    headers: dict,
    body: bytes = b"",
    region: str = "us-east-1",
    service: str = "s3",
) -> dict:
    """Produce the Authorization (+payload hash) headers for a request —
    the client half of SigV4, used by tests and by in-framework callers
    of a secured gateway."""
    u = urllib.parse.urlsplit(url)
    lower = {k.lower(): v for k, v in headers.items()}
    amz_date = str(lower.get("x-amz-date") or lower.get("date") or "")
    date = amz_date[:8]
    payload_hash = hashlib.sha256(body).hexdigest()
    out = dict(headers)
    out["x-amz-content-sha256"] = payload_hash
    lower["x-amz-content-sha256"] = payload_hash
    signed = sorted(lower)
    auth = ParsedAuth(access_id, date, region, service, signed, "")
    sig = compute_signature(
        secret, method, u.path or "/", u.query, lower, auth, payload_hash
    )
    out["Authorization"] = (
        f"{ALGORITHM} Credential={access_id}/{date}/{region}/{service}/"
        f"aws4_request, SignedHeaders={';'.join(signed)}, Signature={sig}"
    )
    return out


def sign_request_streaming(
    access_id: str,
    secret: str,
    method: str,
    url: str,
    headers: dict,
    body: bytes,
    chunk_size: int = 64 * 1024,
    region: str = "us-east-1",
    service: str = "s3",
) -> tuple[dict, bytes]:
    """Client half of the aws-chunked streaming upload: returns
    (headers, encoded_body). The header signature covers the STREAMING
    marker + the declared decoded length; each chunk then chains its own
    signature from it (ObjectEndpointStreaming's wire format)."""
    u = urllib.parse.urlsplit(url)
    lower = {k.lower(): v for k, v in headers.items()}
    amz_date = str(lower.get("x-amz-date") or "")
    date = amz_date[:8]
    out = dict(headers)
    out["x-amz-content-sha256"] = STREAMING
    out["content-encoding"] = "aws-chunked"
    out["x-amz-decoded-content-length"] = str(len(body))
    lower.update({
        "x-amz-content-sha256": STREAMING,
        "content-encoding": "aws-chunked",
        "x-amz-decoded-content-length": str(len(body)),
    })
    signed = sorted(lower)
    auth = ParsedAuth(access_id, date, region, service, signed, "")
    seed = compute_signature(
        secret, method, u.path or "/", u.query, lower, auth, STREAMING
    )
    out["Authorization"] = (
        f"{ALGORITHM} Credential={access_id}/{date}/{region}/{service}/"
        f"aws4_request, SignedHeaders={';'.join(signed)}, Signature={seed}"
    )
    encoded = encode_aws_chunked(body, secret, auth, amz_date, seed,
                                 chunk_size)
    return out, encoded


def request_headers(
    endpoint: str,
    method: str,
    path: str,
    body: bytes = b"",
    extra: Optional[dict] = None,
    access_id: Optional[str] = None,
    secret: Optional[str] = None,
    streaming: bool = False,
    chunk_size: int = 64 * 1024,
) -> tuple[dict, bytes]:
    """(headers, body to send) of one request to the gateway at
    `endpoint` ("host:port"): `host` and `x-amz-date` (now), `extra`,
    then SigV4 with the payload hash signed, or aws-chunked with
    `streaming`; unsigned without an `access_id`."""
    headers = {"host": endpoint,
               "x-amz-date": time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()),
               **(extra or {})}
    if access_id is None:
        return headers, body
    url = f"http://{endpoint}{path}"
    if streaming:
        return sign_request_streaming(access_id, secret, method, url,
                                      headers, body, chunk_size)
    return sign_request(access_id, secret, method, url, headers, body), body
