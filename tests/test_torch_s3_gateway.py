"""The port's S3 gateway against `ozone_tpu`'s, over HTTP, on the CPU.

A port `S3Gateway` over a port `MiniOzoneCluster` (device="cpu") and the
reference's over a JAX `MiniOzoneCluster`, both with 5 datanodes,
rs-3-2-4096 and require_auth, each get the same HTTP request script on
one keep-alive connection, every request SigV4-signed with the same
secret (set through SetS3Secret on both OMs): buckets and their
sub-resources, PUTs with metadata and tags, GETs whole, ranged, suffix
and unsatisfiable, HEAD, ListObjects v1 and v2 with a delimiter, paging
and url encoding, CopyObject, multipart with UploadPartCopy and bad
completes, ListMultipartUploads, multi-delete, aws-chunked and presigned
requests, and the refusals of unsigned and badly signed requests. The
status, ETag, Content-Range, Content-Length, x-amz-meta-* and
Retry-After headers and the bodies (XML with random ids and times
replaced) must be equal. Then: a degraded GET with two datanodes stopped
on both; admission's 503 SlowDown with Retry-After, each knob on alone;
the answers where the port departs from the reference on purpose (501
for ?acl, ?lifecycle, ?replication); and the port-only short-group GET.
"""

import hashlib
import http.client
import re
import time
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from ozone_tpu import admission as j_admission
from ozone_tpu.gateway import s3 as j_s3
from ozone_tpu.om.requests import SetS3Secret as JSetS3Secret
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu.utils.metrics import registry as j_registry
from ozone_tpu_torch import admission
from ozone_tpu_torch.gateway import s3 as p_s3
from ozone_tpu_torch.gateway.s3_auth import (
    presign_url,
    sign_request,
    sign_request_streaming,
)
from ozone_tpu_torch.om.requests import SetS3Secret
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
from ozone_tpu_torch.utils.metrics import registry as p_registry

EC = "rs-3-2-4096"
ACCESS, SECRET = "tester", "5ec12e7" * 8
#: a group of rs-3-2-4096 with 32 KiB blocks holds 3 x 32 KiB of data
GROUP = 3 * 8 * 4096
HEADERS = ("etag", "content-range", "content-length", "retry-after")
#: XML elements whose text is random or a time by design
RANDOM_TEXT = {"LastModified", "Initiated", "CreationDate"}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One gateway over its cluster, and a keep-alive connection to it."""

    def __init__(self, cluster, gateway_cls, secret_req):
        self.cluster = cluster
        cluster.om.submit(secret_req(ACCESS, SECRET))
        self.gw = gateway_cls(cluster.client(), replication=EC,
                              require_auth=True)
        self.gw.start()
        self.conn = http.client.HTTPConnection(self.gw.address, timeout=60)
        #: upload ids in the order this side issued them
        self.uploads: list[str] = []

    def url(self, path: str) -> str:
        return f"http://{self.gw.address}{path}"

    def req(self, method, path, body=b"", headers=None, sign=True,
            secret=SECRET, streaming=False, last=False):
        """(status, headers, body) of one request on the connection;
        `last` ends the connection after it."""
        path = path.replace("{uid}", self.uploads[-1] if self.uploads else "")
        hdrs = {"host": self.gw.address,
                "x-amz-date": time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()),
                **(headers or {})}
        if streaming:
            hdrs, body = sign_request_streaming(
                ACCESS, secret, method, self.url(path), hdrs, body,
                chunk_size=4096)
        elif sign:
            hdrs = sign_request(ACCESS, secret, method, self.url(path), hdrs,
                                body)
        self.conn.request(method, path, body=body, headers=hdrs)
        r = self.conn.getresponse()
        data = r.read()
        if r.getheader("Connection", "").lower() == "close" \
                or method == "HEAD" or last:
            # the reference writes an error body after a HEAD answer:
            # a new connection keeps it from the next response
            self.conn.close()
        out = {k: r.getheader(k) for k in HEADERS if r.getheader(k)}
        if method != "HEAD":
            assert int(out["content-length"]) == len(data)
        out.update({k.lower(): v for k, v in r.getheaders()
                    if k.lower().startswith("x-amz-meta-")})
        if b"<UploadId>" in data and b"InitiateMultipartUpload" in data:
            self.uploads.append(re.search(rb"<UploadId>([^<]+)<", data)
                                .group(1).decode())
        return r.status, out, data

    def normalize(self, resp):
        """Random ids and times in XML bodies replaced by placeholders."""
        status, headers, data = resp
        text = data.decode("utf-8", "replace")
        for i, uid in enumerate(self.uploads):
            text = text.replace(uid, f"upload-{i}")
        if text.startswith("<?xml"):
            # the length of an XML body follows its times: checked
            # against the body in req() instead
            headers = dict(headers, **{"content-length": "xml"})
            root = ET.fromstring(text.encode())
            for el in root.iter():
                if el.tag.rpartition("}")[2] in RANDOM_TEXT:
                    el.text = "*"
            text = ET.tostring(root).decode()
        return status, headers, text

    def close(self):
        self.conn.close()
        self.gw.stop()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    kw = dict(num_datanodes=5, block_size=8 * 4096,
              container_size=4 * 1024 * 1024, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    root = tmp_path_factory.mktemp("torch-s3")
    admission.reset_for_tests()
    j_admission.reset_for_tests()
    port = Side(MiniOzoneCluster(root / "port", device="cpu", **kw),
                p_s3.S3Gateway, SetS3Secret)
    ref = Side(JCluster(root / "ref", **kw), j_s3.S3Gateway, JSetS3Secret)
    yield port, ref
    for s in (port, ref):
        s.close()
        s.cluster.close()


def _data(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


BODIES = {"a/1": _data(1, 0), "a/2": _data(2, 1), "b/1": _data(3, 12288),
          "c": _data(4, 30_000), "d e+f": _data(5, 2 * GROUP)}
PARTS = [_data(10, 20_000), _data(11, 7_000), _data(12, 5)]


def _complete_xml(etags: list[tuple[int, str]]) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in etags) + "</CompleteMultipartUpload>").encode()


def script(s: Side) -> list:
    """The request script; every response normalized."""
    out = []

    def r(*a, **kw):
        out.append(s.normalize(s.req(*a, **kw)))
        return out[-1]

    r("PUT", "/bkt")
    r("PUT", "/bkt")                               # re-create: 200
    r("HEAD", "/bkt")
    r("HEAD", "/nobkt")
    for sub in ("location", "versioning", "tagging", "uploads"):
        r("GET", f"/bkt?{sub}")
    r("PUT", "/bkt?versioning", b"<VersioningConfiguration/>")
    r("PUT", "/bkt?tagging", b"<Tagging/>")
    r("PUT", "/bkt?policy", b'{"Version": "2012-10-17"}')
    r("GET", "/nobkt?location")
    r("GET", "/")
    for i, (name, body) in enumerate(BODIES.items()):
        r("PUT", f"/bkt/{name.replace(' ', '%20').replace('+', '%2B')}",
          body, {"x-amz-meta-idx": str(i), "x-amz-meta-Color": "Blue"})
    r("PUT", "/bkt/tagged", b"t", {"x-amz-tagging": "k1=v1&k2="})
    r("PUT", "/bkt/badtag", b"t", {"x-amz-tagging": "&".join(
        f"k{i}=v" for i in range(11))})
    r("PUT", "/nobkt/x", b"body of a missing bucket")
    for name in BODIES:
        path = f"/bkt/{name.replace(' ', '%20').replace('+', '%2B')}"
        r("GET", path)
        r("HEAD", path)
    for rng in ("bytes=0-99", "bytes=100-", "bytes=-500", "bytes=5-2",
                "bytes=29990-40000", "bytes=30000-", "bytes=-99999"):
        r("GET", "/bkt/c", headers={"Range": rng})
    r("GET", "/bkt/nokey")
    for q in ("list-type=2", "list-type=2&delimiter=/",
              "list-type=2&max-keys=2", "list-type=2&prefix=a/",
              "list-type=2&max-keys=0", "list-type=2&max-keys=x",
              "delimiter=/&max-keys=1", "marker=a/2",
              "list-type=2&encoding-type=url",
              "list-type=2&start-after=b/1"):
        r("GET", f"/bkt?{q}")
    token = re.search(r"NextContinuationToken>([^<]+)<",
                      r("GET", "/bkt?list-type=2&max-keys=1&delimiter=/")[2])
    r("GET", f"/bkt?list-type=2&max-keys=2&delimiter=/"
             f"&continuation-token={token.group(1)}")
    # object tagging
    r("PUT", "/bkt/c?tagging", b"<Tagging><TagSet><Tag><Key>t</Key>"
      b"<Value>1</Value></Tag></TagSet></Tagging>")
    r("GET", "/bkt/c?tagging")
    r("PUT", "/bkt/c?tagging", b"<Tagging><TagSet>")     # malformed
    r("GET", "/bkt/tagged?tagging")
    # CopyObject, both directives
    r("PUT", "/bkt/copy1", headers={"x-amz-copy-source": "/bkt/c"})
    r("PUT", "/bkt/copy2", headers={
        "x-amz-copy-source": "bkt/c", "x-amz-metadata-directive": "REPLACE",
        "x-amz-meta-new": "yes", "x-amz-tagging-directive": "REPLACE",
        "x-amz-tagging": "z=9"})
    r("PUT", "/bkt/copy3", headers={"x-amz-copy-source": "bkt"})
    for name in ("copy1", "copy2"):
        r("GET", f"/bkt/{name}")
        r("GET", f"/bkt/{name}?tagging")
    # multipart: parts out of order, a copied part, bad completes
    r("POST", "/bkt/mp?uploads", headers={"x-amz-meta-m": "1"})
    etags = {}
    for n in (3, 1, 2):
        etags[n] = r("PUT", f"/bkt/mp?partNumber={n}&uploadId={{uid}}",
                     PARTS[n - 1])[1]["etag"]
    cp = r("PUT", "/bkt/mp?partNumber=4&uploadId={uid}", headers={
        "x-amz-copy-source": "/bkt/c",
        "x-amz-copy-source-range": "bytes=100-5099"})
    etags[4] = re.search(r"ETag>([^<]+)<", cp[2]).group(1)
    for bad in ("bytes=5-", "bytes=10-5", "bytes=0-30000", "items=0-1"):
        r("PUT", "/bkt/mp?partNumber=5&uploadId={uid}", headers={
            "x-amz-copy-source": "/bkt/c", "x-amz-copy-source-range": bad})
    r("GET", "/bkt/mp?uploadId={uid}")
    r("POST", "/bkt/other?uploads")
    r("POST", "/bkt/a/deep?uploads")
    for q in ("uploads", "uploads&prefix=a", "uploads&delimiter=/",
              "uploads&max-uploads=1", "uploads&max-uploads=0",
              "uploads&encoding-type=url"):
        r("GET", f"/bkt?{q}")
    r("DELETE", "/bkt/a/deep?uploadId={uid}")
    r("DELETE", "/bkt/a/deep?uploadId={uid}")            # NoSuchUpload
    r("POST", "/bkt/mp?uploadId=" + s.uploads[0],
      _complete_xml([(2, etags[2]), (1, etags[1])]))     # out of order
    r("POST", "/bkt/mp?uploadId=" + s.uploads[0],
      _complete_xml([(1, '"' + "0" * 32 + '"')]))        # bad ETag
    r("POST", "/bkt/mp?uploadId=" + s.uploads[0],
      _complete_xml(sorted(etags.items())))
    r("GET", "/bkt/mp")
    r("HEAD", "/bkt/mp")
    r("GET", "/bkt/mp", headers={"Range": "bytes=19990-27009"})
    r("GET", "/bkt/mp?uploadId=" + s.uploads[0])          # NoSuchUpload
    # multi-delete, quiet and not
    r("POST", "/bkt?delete", b"<Delete><Object><Key>a/1</Key></Object>"
      b"<Object><Key>gone</Key></Object></Delete>")
    r("POST", "/bkt?delete", b"<Delete><Quiet>true</Quiet><Object><Key>a/2"
      b"</Key></Object></Delete>")
    r("POST", "/bkt?delete", b"<Delete><Object>")
    # aws-chunked and presigned
    r("PUT", "/bkt/chunked", _data(20, 10_000), streaming=True)
    r("GET", "/bkt/chunked")
    # refusals: unsigned, bad signature, unknown access id (the reference
    # leaves a refused anonymous body unread: a new connection after it)
    r("PUT", "/bkt/anon", b"x", sign=False, last=True)
    r("GET", "/bkt/c", sign=False)
    r("PUT", "/bkt/forged", b"y", secret="0" * 56)
    r("PUT", "/bkt/forged", b"y", streaming=True, secret="0" * 56)
    r("DELETE", "/bkt")                                  # not empty
    r("DELETE", "/bkt/c")
    r("GET", "/bkt/c")
    return out


def test_request_script_matches_reference(sides):
    port, ref = sides
    got, want = script(port), script(ref)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    # and the answers are the right ones, not only equal
    for name in ("b/1", "d e+f"):
        st, _, data = port.req(
            "GET", f"/bkt/{name.replace(' ', '%20').replace('+', '%2B')}")
        assert st == 200 and data == BODIES[name]
        st, headers, _ = port.req("PUT", "/bkt/again", data)
        assert headers["etag"] == f'"{hashlib.md5(data).hexdigest()}"'
    copied = _data(4, 30_000)[100:5100]
    assert port.req("GET", "/bkt/mp")[2] == b"".join(PARTS) + copied
    md5s = [hashlib.md5(p).hexdigest() for p in (*PARTS, copied)]
    composite = hashlib.md5("".join(md5s).encode()).hexdigest() + "-4"
    complete = [t for t in got if "CompleteMultipartUploadResult" in t[2]]
    assert len(complete) == 1 and f'"{composite}"' in complete[0][2]


def test_presigned_get_matches_reference(sides):
    """A presigned GET, valid and tampered, through both gateways."""
    out = []
    for s in sides:
        s.req("PUT", "/pre")
        s.req("PUT", "/pre/obj", _data(30, 5000))
        url = presign_url(ACCESS, SECRET, "GET", s.url("/pre/obj"), 300)
        path = url.split(s.gw.address, 1)[1]
        out.append([s.normalize(s.req("GET", p, sign=False)) for p in
                    (path, path.replace("X-Amz-Signature=",
                                        "X-Amz-Signature=1"))])
    assert out[0] == out[1]
    assert out[0][0][0] == 200 and out[0][0][2] == _data(30, 5000).decode(
        "utf-8", "replace")
    assert out[0][1][0] == 403 and "SignatureDoesNotMatch" in out[0][1][2]


def _holders(cluster, info, units) -> list[str]:
    """The datanodes holding `units` of the key's first block group."""
    return [info["block_groups"][0]["nodes"][u] for u in units]


def test_degraded_get_with_two_datanodes_stopped(sides):
    """Two datanodes holding data units of every group of the key stop:
    both gateways answer the whole key and a range byte-exact (full
    groups, so every lost unit holds bytes)."""
    body = _data(40, 2 * GROUP)
    got = []
    for s in sides:
        s.req("PUT", "/deg")
        s.req("PUT", "/deg/k", body)
        info = s.cluster.om.lookup_key("s3v", "deg", "k")
        down = _holders(s.cluster, info, (0, 1))
        for dn in down:
            s.cluster.stop_datanode(dn)
        try:
            got.append([s.normalize(s.req("GET", "/deg/k", headers=h))
                        for h in ({}, {"Range": "bytes=1000-60000"})])
        finally:
            for dn in down:
                s.cluster.restart_datanode(dn)
    assert got[0] == got[1]
    assert got[0][0][0] == 200 and got[0][1][0] == 206


def test_port_degraded_get_of_short_groups(sides):
    """Port only: a multipart key of short groups (a 5 B part leaves
    units 1 and 2 of its group empty) read with unit 0's and unit 3's
    datanodes stopped: unit 0 is decoded from the empty units 1 and 2
    and parity unit 4. The port reads an empty unit as known zeros (the
    reference's reader counts it unreachable and raises: ROADMAP Queue
    3)."""
    port, _ = sides
    port.req("PUT", "/short")
    port.req("POST", "/short/k?uploads")
    parts = [_data(50, 5), _data(51, 4096 + 7)]
    for n, p in enumerate(parts, 1):
        port.req("PUT", f"/short/k?partNumber={n}&uploadId={{uid}}", p)
    assert port.req("POST", "/short/k?uploadId={uid}")[0] == 200
    info = port.cluster.om.lookup_key("s3v", "short", "k")
    assert len(info["block_groups"]) == 2
    down = _holders(port.cluster, info, (0, 3))
    for dn in down:
        port.cluster.stop_datanode(dn)
    try:
        st, _, data = port.req("GET", "/short/k")
    finally:
        for dn in down:
            port.cluster.restart_datanode(dn)
    assert st == 200 and data == b"".join(parts)


#: an admitted PUT, in the shape of ADMISSION's answers
OK = (200, None, None, None, None)
#: admission cases: the OZONE_TPU_ADMIT_* knobs each sets (the reference's
#: names), and the answers to its four PUTs, as (status, Retry-After, S3
#: code, refusal reason, hint): "queue" holds the gate for the first
#: three; the bucket cases' hint follows the clock and is left out
ADMISSION = {
    "queue": ({"QUEUE_GATEWAY": "1"},
              [(503, "1", "SlowDown", "queue", 0.25)] * 3 + [OK]),
    "retry_after": ({"QUEUE_GATEWAY": "1", "RETRY_AFTER_S_GATEWAY": "2.5"},
                    [(503, "3", "SlowDown", "queue", 2.5)] * 3 + [OK]),
    "ops": ({"OPS_GATEWAY": "2", "BURST_S": "1"},
            [OK] * 2 + [(503, "1", "SlowDown", "ops", None)]),
    "bytes": ({"BYTES_GATEWAY": "1000", "BURST_S": "1"},
              [OK] * 2 + [(503, "1", "SlowDown", "bytes", None)]),
    "slo_p99_bulk": ({"SLO_P99_MS_GATEWAY": "0.001", "CLASS": "s3v=bulk"},
                     [(503, "1", "SlowDown", "slo_p99", 0.25)] * 4),
    "slo_p99_interactive": ({"SLO_P99_MS_GATEWAY": "0.001",
                             "CLASS": "other=bulk"}, [OK] * 4),
    "slo_codec_depth": ({"SLO_CODEC_DEPTH_GATEWAY": "2", "CLASS": "s3v=bulk"},
                        [(503, "1", "SlowDown", "slo_codec_depth", 0.25)] * 4),
}


@pytest.mark.parametrize("gate", list(ADMISSION))
def test_admission_slowdown_matches_reference(sides, monkeypatch, gate):
    """Each admission knob, turned on alone, answers the same 503
    SlowDown with Retry-After, refusal reason and hint in both gateways:
    a full in-flight gate (with the default and a set hint), a spent ops
    or bytes bucket (a 900 B PUT against 1000 B/s), and the SLO shedder
    over the client PUT P99 and the codec backlog, which refuses only a
    tenant whose class is bulk."""
    knobs, want = ADMISSION[gate]
    for name, value in knobs.items():
        monkeypatch.setenv(f"OZONE_TPU_ADMIT_{name}", value)
    out = []
    try:
        for s, adm, reg in zip(sides, (admission, j_admission),
                               (p_registry, j_registry)):
            adm.reset_for_tests()
            ctl = adm.controller("gateway")
            if gate.startswith("slo_p99"):
                # a PUT slower than the 1 us budget on record
                reg("client.ops").histogram("put_seconds").observe(0.01)
            reg("codec.service").gauge("queue_depth").set(
                5 if gate == "slo_codec_depth" else 0)
            if ctl.gate.limit == 1:
                assert ctl.gate.try_enter()       # one request in flight
            resp = []
            for path, body in (("/adm", b""), ("/adm/k", b"z" * 900),
                               ("/adm/k", b"z" * 900), ("/adm", b"")):
                if len(resp) == len(want):
                    break
                if ctl.gate.limit == 1 and len(resp) == 3:
                    ctl.gate.exit()
                # a new connection each: the reference leaves a refused
                # body unread on the connection
                s.conn.close()
                st, h, b = s.req("PUT", path, body)
                if st != 503:
                    resp.append((st,) + OK[1:])
                    continue
                reason = re.search(rb"overloaded \((\w+)\)", b).group(1)
                resp.append((st, h.get("retry-after"),
                             re.search(rb"<Code>(\w+)<", b).group(1).decode(),
                             reason.decode(),
                             None if gate in ("ops", "bytes")
                             else adm.retry_after_hint(b.decode())))
            out.append(resp)
            for reason in {w[3] for w in want if w[3]}:
                assert adm.METRICS.counter(
                    f"gateway_rejected_{reason}").value >= 1
    finally:
        for reg in (p_registry, j_registry):
            reg("codec.service").gauge("queue_depth").set(0)
        admission.reset_for_tests()
        j_admission.reset_for_tests()
    assert out[0] == out[1]
    assert out[0] == want


def test_port_refusal_drains_the_body(sides):
    """Port only: an unsigned PUT refused under require_auth leaves the
    keep-alive connection fit for the next request."""
    port, _ = sides
    port.req("PUT", "/drain")
    port.req("PUT", "/drain/o", b"kept")
    st, _, data = port.req("PUT", "/drain/anon", b"x" * 1000, sign=False)
    assert st == 403 and b"AccessDenied" in data
    assert port.req("GET", "/drain/o")[:3:2] == (200, b"kept")


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/dep?acl", b""),
    ("PUT", "/dep?acl", b"<AccessControlPolicy/>"),
    ("GET", "/dep?lifecycle", b""),
    ("PUT", "/dep?lifecycle", b"<LifecycleConfiguration/>"),
    ("DELETE", "/dep?replication", b""),
    ("PUT", "/dep?replication", b"<ReplicationConfiguration/>"),
    ("GET", "/dep/o?acl", b""),
    ("PUT", "/dep/o?acl", b"<AccessControlPolicy/>"),
])
def test_port_departures_answer_501(sides, method, path, body):
    """Where the port has no module yet (ACLs, lifecycle, geo
    replication) it answers 501 NotImplemented as Apache Ozone 1.5 does,
    after draining the body, so the keep-alive connection serves the
    next request."""
    port, _ = sides
    port.req("PUT", "/dep")
    port.req("PUT", "/dep/o", b"o")
    st, _, data = port.req(method, path, body)
    assert st == 501 and b"<Code>NotImplemented</Code>" in data
    assert port.req("GET", "/dep/o")[2] == b"o"
    assert port.req(method, path.replace("/dep", "/nodep", 1), body)[0] == 404
