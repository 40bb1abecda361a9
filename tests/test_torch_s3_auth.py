"""The port's SigV4 (`ozone_tpu_torch/gateway/s3_auth.py`) against
`ozone_tpu/gateway/s3_auth.py`, on seeded requests.

Each signer must produce the same strings, keys and signatures as the
reference, each verifier must accept what the other side signed and
refuse a tampered request with the same error code: header auth with
the payload hash, presigned URLs (expiry, future dates, the 7-day cap),
aws-chunked bodies (encode, decode, a flipped byte, truncation), clock
skew and malformed headers; and the port's client helper
`request_headers` signs what the reference verifies. The tolerance is
exact equality.
"""

import hashlib
import time

import numpy as np
import pytest

from ozone_tpu.gateway import s3_auth as ref
from ozone_tpu_torch.gateway import s3_auth as port

SEEDS = list(range(8))
_PATH_CHARS = list("abcXYZ019-_.~ /%+=!é")


def _amz_date(t: float) -> str:
    return time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(t))


def _case(seed: int) -> dict:
    """One request made from the seed: method, URL with odd path and
    query bytes, extra headers, a body, a secret and a signing time."""
    rng = np.random.default_rng(seed)

    def word(n):
        return "".join(rng.choice(_PATH_CHARS, n))

    path = "/" + "/".join(word(int(rng.integers(1, 8)))
                          for _ in range(int(rng.integers(1, 4))))
    query = "&".join(f"{word(3).strip() or 'q'}={word(4)}"
                     for _ in range(int(rng.integers(0, 3))))
    body = rng.integers(0, 256, int(rng.integers(0, 3000)),
                        dtype=np.uint8).tobytes()
    t = time.time() - float(rng.integers(0, 600))
    headers = {"host": f"127.0.0.1:{int(rng.integers(1024, 65535))}",
               "x-amz-date": _amz_date(t)}
    if rng.integers(0, 2):
        headers["x-amz-meta-color"] = f"  {word(5)}  with   spaces "
    return {
        "method": ["GET", "PUT", "POST", "DELETE", "HEAD"][seed % 5],
        "url": f"http://{headers['host']}{path}" + (f"?{query}" if query
                                                   else ""),
        "path": path, "query": query, "headers": headers, "body": body,
        "secret": rng.bytes(20).hex(), "access": f"AK{seed:04d}",
        "t": t, "chunk": int(rng.integers(1, 5)) * 512,
    }


def _code(fn):
    """The AuthError code fn raises (either package's), or None."""
    try:
        fn()
    except (ref.AuthError, port.AuthError) as e:
        return e.code
    return None


def test_aws_documentation_vectors():
    """The AWS SigV4 documentation's worked example (IAM ListUsers,
    20150830): the port's signing key and signature are the published
    values."""
    secret = "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
    assert port.signing_key(secret, "20150830", "us-east-1", "iam").hex() == \
        "c4afb1cc5771d871763a393e44b703571b55cc28424d1a5e86da6ed3c154a4b9"
    headers = {
        "content-type": "application/x-www-form-urlencoded; charset=utf-8",
        "host": "iam.amazonaws.com", "x-amz-date": "20150830T123600Z"}
    auth = port.ParsedAuth("AKIDEXAMPLE", "20150830", "us-east-1", "iam",
                           ["content-type", "host", "x-amz-date"], "")
    sig = port.compute_signature(
        secret, "GET", "/", "Action=ListUsers&Version=2010-05-08", headers,
        auth, hashlib.sha256(b"").hexdigest())
    assert sig == ("5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b"
                   "5924a6f2b5d7")


@pytest.mark.parametrize("seed", SEEDS)
def test_canonical_request_key_and_signature_equal(seed):
    c = _case(seed)
    signed = sorted(c["headers"])
    payload = hashlib.sha256(c["body"]).hexdigest()
    args = (c["method"], c["path"], c["query"], c["headers"], signed,
            payload)
    assert port.canonical_request(*args) == ref.canonical_request(*args)
    date = c["headers"]["x-amz-date"][:8]
    assert port.signing_key(c["secret"], date, "us-east-1", "s3") == \
        ref.signing_key(c["secret"], date, "us-east-1", "s3")
    canon = ref.canonical_request(*args)
    scope = f"{date}/us-east-1/s3/aws4_request"
    assert port.string_to_sign(c["headers"]["x-amz-date"], scope, canon) == \
        ref.string_to_sign(c["headers"]["x-amz-date"], scope, canon)
    pa = port.ParsedAuth(c["access"], date, "us-east-1", "s3", signed, "")
    ra = ref.ParsedAuth(c["access"], date, "us-east-1", "s3", signed, "")
    assert port.compute_signature(c["secret"], c["method"], c["path"],
                                  c["query"], c["headers"], pa, payload) == \
        ref.compute_signature(c["secret"], c["method"], c["path"],
                              c["query"], c["headers"], ra, payload)


@pytest.mark.parametrize("seed", SEEDS)
def test_header_auth_signs_equal_and_verifies_across(seed):
    """sign_request gives the same headers in both packages; each
    verifier accepts the other's signature (with the skew window), and
    a changed body, secret or header is refused with the same code."""
    c = _case(seed)
    args = (c["access"], c["secret"], c["method"], c["url"], c["headers"],
            c["body"])
    signed = port.sign_request(*args)
    assert signed == ref.sign_request(*args)
    for verifier, parser in ((port, ref), (ref, port)):
        auth = parser.parse_authorization(signed["Authorization"])
        assert verifier.verify_request(
            c["secret"], c["method"], c["path"], c["query"], signed,
            c["body"], auth, max_skew_s=900) is None
    for change in ("body", "secret", "header", "hash"):
        headers, body, secret = dict(signed), c["body"], c["secret"]
        if change == "body":
            body = body + b"x"
        elif change == "secret":
            secret = secret[::-1]
        elif change == "header":
            headers["host"] = "10.0.0.1:1"
        else:
            headers["x-amz-content-sha256"] = "UNSIGNED-PAYLOAD"
        codes = [_code(lambda m=m: m.verify_request(
            secret, c["method"], c["path"], c["query"], headers, body,
            m.parse_authorization(headers["Authorization"])))
            for m in (port, ref)]
        assert codes[0] == codes[1] and codes[0] is not None, (change, codes)


@pytest.mark.parametrize("seed", SEEDS)
def test_clock_skew_and_malformed_headers(seed):
    c = _case(seed)
    old = dict(c["headers"], **{"x-amz-date": _amz_date(c["t"] - 3600)})
    for headers, want in ((old, "RequestTimeTooSkewed"),
                          (dict(c["headers"], **{"x-amz-date": "garbage"}),
                           "AccessDenied")):
        signed = ref.sign_request(c["access"], c["secret"], c["method"],
                                  c["url"], headers, c["body"])
        codes = [_code(lambda m=m: m.verify_request(
            c["secret"], c["method"], c["path"], c["query"], signed,
            c["body"], m.parse_authorization(signed["Authorization"]),
            max_skew_s=900)) for m in (port, ref)]
        assert codes == [want, want]
    good = ref.sign_request(c["access"], c["secret"], c["method"], c["url"],
                            c["headers"], c["body"])["Authorization"]
    for bad in ("Basic abc", good.replace("aws4_request", "aws5_request"),
                good.replace("SignedHeaders=", "Signed="),
                good.replace(f"Credential={c['access']}/", "Credential=")):
        assert _code(lambda: port.parse_authorization(bad)) == \
            _code(lambda: ref.parse_authorization(bad)) is not None, bad


@pytest.mark.parametrize("seed", SEEDS)
def test_presigned_urls(seed):
    """presign_url gives the same URL; each verifier accepts the other's;
    expired, future-dated, over-long and tampered URLs get the same code."""
    c = _case(seed)
    expires = 60 + 100 * seed
    amz = c["headers"]["x-amz-date"]
    url = port.presign_url(c["access"], c["secret"], c["method"], c["url"],
                           expires, amz_date=amz)
    assert url == ref.presign_url(c["access"], c["secret"], c["method"],
                                  c["url"], expires, amz_date=amz)
    query = url.split("?", 1)[1]
    path = url.split("://", 1)[1].split("/", 1)[1].split("?")[0]
    headers = {"host": c["headers"]["host"]}
    now = c["t"] + expires / 2
    for m in (port, ref):
        assert m.verify_presigned(c["secret"], c["method"], "/" + path,
                                  query, headers, now=now) == c["access"]
    tampered = query.replace("X-Amz-Signature=", "X-Amz-Signature=0")
    for q, when in ((query, c["t"] + expires + 1),   # expired
                    (query, c["t"] - 3600),           # dated in the future
                    (tampered, now),
                    (query.replace(f"X-Amz-Expires={expires}",
                                   "X-Amz-Expires=999999"), now)):
        codes = [_code(lambda m=m: m.verify_presigned(
            c["secret"], c["method"], "/" + path, q, headers, now=when))
            for m in (port, ref)]
        assert codes[0] == codes[1] and codes[0] is not None, codes


@pytest.mark.parametrize("seed", SEEDS)
def test_aws_chunked_bodies(seed):
    """sign_request_streaming gives the same headers and framed body;
    both decoders return the payload; a flipped byte, a cut body or a
    wrong seed is refused with the same code."""
    c = _case(seed)
    headers, framed = port.sign_request_streaming(
        c["access"], c["secret"], "PUT", c["url"], c["headers"], c["body"],
        chunk_size=c["chunk"])
    assert (headers, framed) == ref.sign_request_streaming(
        c["access"], c["secret"], "PUT", c["url"], c["headers"], c["body"],
        chunk_size=c["chunk"])
    auth = ref.parse_authorization(headers["Authorization"])
    amz = c["headers"]["x-amz-date"]
    for m in (port, ref):
        assert m.decode_aws_chunked(framed, c["secret"], auth, amz,
                                    auth.signature) == c["body"]
        assert m.verify_request(c["secret"], "PUT", c["path"], c["query"],
                                headers, framed, auth) is None
    assert port.encode_aws_chunked(c["body"], c["secret"], auth, amz,
                                   auth.signature, c["chunk"]) == framed
    flipped = bytearray(framed)
    flipped[len(framed) // 2] ^= 1
    for body, seed_sig in ((bytes(flipped), auth.signature),
                           (framed[:len(framed) - 7], auth.signature),
                           (framed, "0" * 64),
                           (b"zz;chunk-signature=00\r\n", auth.signature)):
        codes = [_code(lambda m=m: m.decode_aws_chunked(
            body, c["secret"], auth, amz, seed_sig)) for m in (port, ref)]
        assert codes[0] == codes[1] and codes[0] is not None, codes


@pytest.mark.parametrize("seed", SEEDS)
def test_request_headers_verify_under_the_reference(seed):
    """The port's client helper (`request_headers`: host and date from
    now, then the signer) makes requests the reference's verifier
    accepts, by header and aws-chunked; without an access id it signs
    nothing."""
    c = _case(seed)
    endpoint = c["headers"]["host"]
    target = c["path"] + (f"?{c['query']}" if c["query"] else "")
    headers, body = port.request_headers(
        endpoint, c["method"], target, c["body"], {"x-amz-meta-k": "v"},
        c["access"], c["secret"])
    assert body == c["body"] and headers["host"] == endpoint
    assert headers["x-amz-meta-k"] == "v"
    auth = ref.parse_authorization(headers["Authorization"])
    assert auth.access_id == c["access"]
    assert ref.verify_request(c["secret"], c["method"], c["path"],
                              c["query"], headers, body, auth,
                              max_skew_s=900) is None
    headers, framed = port.request_headers(
        endpoint, "PUT", target, c["body"], None, c["access"], c["secret"],
        streaming=True, chunk_size=c["chunk"])
    auth = ref.parse_authorization(headers["Authorization"])
    assert ref.decode_aws_chunked(framed, c["secret"], auth,
                                  headers["x-amz-date"],
                                  auth.signature) == c["body"]
    plain, body = port.request_headers(endpoint, "GET", target, c["body"])
    assert body == c["body"] and set(plain) == {"host", "x-amz-date"}
