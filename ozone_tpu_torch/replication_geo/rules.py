"""Geo replication rules and the S3 `?replication` XML codec.

Port of `ozone_tpu/replication_geo/rules.py`, line for line: a bucket's
cross-cluster replication rules (prefix filter, destination cluster
endpoint, optional destination volume and bucket, optional destination
replication scheme) ride the bucket row (`geo_replication`), so they
replicate through the metadata ring like lifecycle rules. The S3
gateway's Put/Get/DeleteBucketReplication translate the AWS
ReplicationConfiguration to and from these dicts, and the shipper
(`shipper.py`) evaluates the same model.

Destination addressing rides the AWS shapes:

- ``<Bucket>arn:aws:s3:HOST:PORT::mirror</Bucket>``: the ARN's region
  slot carries the destination cluster endpoint, and its resource slot
  may carry a volume rename as ``volume/bucket``;
- ``<Destination><Endpoint>HOST:PORT</Endpoint><Bucket>mirror</Bucket>``,
  the explicit form.

``<StorageClass>`` maps as the lifecycle codec's does: a warm AWS class
becomes the gateway's EC scheme, a literal scheme ("rs-3-2-1024k",
"RATIS/THREE") passes through, and absent keeps the source key's
scheme. A scheme-converting rule re-encodes through the destination
client's EC writer, on the codec service's bulk class.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass

#: S3 StorageClass names accepted as "the destination's warm tier",
#: mapped to the default EC scheme at parse time (same set as
#: lifecycle/policy.py — one tiering vocabulary across both codecs)
_WARM_CLASSES = ("STANDARD_IA", "GLACIER", "GLACIER_IR", "DEEP_ARCHIVE",
                 "INTELLIGENT_TIERING", "ONEZONE_IA")

_NS = "http://s3.amazonaws.com/doc/2006-03-01/"
_ARN_PREFIX = "arn:aws:s3:"


class GeoReplicationError(ValueError):
    """Invalid rule / configuration (maps to S3 MalformedXML /
    InvalidArgument at the gateway)."""


@dataclass
class ReplicationRule:
    rule_id: str
    #: destination cluster endpoint — "host:port" (possibly a
    #: comma-separated OM-HA replica list) or an in-process test handle
    #: registered via shipper.register_inprocess
    endpoint: str = ""
    prefix: str = ""
    #: destination bucket name; "" = same name as the source bucket
    bucket: str = ""
    #: destination volume; "" = same volume name as the source
    volume: str = ""
    #: destination replication scheme; "" = keep the source key's scheme
    scheme: str = ""
    enabled: bool = True

    def validate(self) -> "ReplicationRule":
        if not self.rule_id:
            raise GeoReplicationError("rule needs a non-empty id")
        if not self.endpoint:
            raise GeoReplicationError(
                f"rule {self.rule_id!r} needs a destination cluster "
                "endpoint (host:port)")
        if self.scheme:
            from ozone_tpu_torch.scm.pipeline import ReplicationConfig

            try:
                ReplicationConfig.parse(self.scheme)
            except ValueError as e:
                raise GeoReplicationError(
                    f"rule {self.rule_id!r}: bad destination scheme "
                    f"{self.scheme!r}: {e}")
        return self

    def matches(self, key: str) -> bool:
        return self.enabled and key.startswith(self.prefix)

    def to_json(self) -> dict:
        return {
            "id": self.rule_id,
            "endpoint": self.endpoint,
            "prefix": self.prefix,
            "bucket": self.bucket,
            "volume": self.volume,
            "scheme": self.scheme,
            "enabled": self.enabled,
        }

    @staticmethod
    def from_json(d: dict) -> "ReplicationRule":
        return ReplicationRule(
            rule_id=str(d.get("id", "")),
            endpoint=str(d.get("endpoint", "")),
            prefix=str(d.get("prefix", "")),
            bucket=str(d.get("bucket", "")),
            volume=str(d.get("volume", "")),
            scheme=str(d.get("scheme", "")),
            enabled=bool(d.get("enabled", True)),
        ).validate()


def validate_rules(rules: list[dict]) -> list[dict]:
    """Validate a rule list (wire dicts) and return the normalized
    dicts; raises GeoReplicationError on any bad rule or duplicate id."""
    out = []
    seen: set[str] = set()
    for d in rules:
        r = ReplicationRule.from_json(d)
        if r.rule_id in seen:
            raise GeoReplicationError(f"duplicate rule id {r.rule_id!r}")
        seen.add(r.rule_id)
        out.append(r.to_json())
    return out


def first_match(rules: list[ReplicationRule],
                key: str) -> ReplicationRule | None:
    """The first enabled rule whose prefix matches (rule order is the
    operator's priority order, like S3's)."""
    for r in rules:
        if r.matches(key):
            return r
    return None


# ------------------------------------------------------------- S3 XML
def _text(el: ET.Element, name: str) -> str:
    """Namespace-tolerant child text (AWS SDKs send the 2006-03-01
    namespace, hand-rolled clients usually don't)."""
    v = el.findtext(f"{{{_NS}}}{name}")
    if v is None:
        v = el.findtext(name)
    return (v or "").strip()


def _children(el: ET.Element, name: str) -> list[ET.Element]:
    return el.findall(f"{{{_NS}}}{name}") or el.findall(name)


def _parse_destination(rid: str, dest: ET.Element,
                       default_target: str
                       ) -> tuple[str, str, str, str]:
    """(endpoint, volume, bucket, scheme) from a <Destination>
    element. The ARN resource slot optionally carries a destination
    volume rename as `volume/bucket` — the GET codec renders rules
    that way, so a GET body re-PUTs without dropping the volume."""
    arn = _text(dest, "Bucket")
    endpoint = _text(dest, "Endpoint")
    bucket = ""
    if arn.startswith(_ARN_PREFIX):
        # arn:aws:s3:<endpoint>::<[volume/]bucket> — the endpoint
        # itself holds a colon (host:port), so split on the "::"
        # account separator
        rest = arn[len(_ARN_PREFIX):]
        ep, sep, bucket = rest.rpartition("::")
        if not sep:
            raise GeoReplicationError(
                f"rule {rid!r}: destination ARN {arn!r} carries no "
                "cluster endpoint (expected "
                "arn:aws:s3:HOST:PORT::bucket)")
        endpoint = endpoint or ep
    elif arn:
        bucket = arn  # bare name: endpoint must come from <Endpoint>
    if not endpoint:
        raise GeoReplicationError(
            f"rule {rid!r}: Destination needs a cluster endpoint "
            "(arn:aws:s3:HOST:PORT::bucket or an <Endpoint> element)")
    volume, sep, rest = bucket.partition("/")
    volume, bucket = (volume, rest) if sep else ("", bucket)
    sc = _text(dest, "StorageClass")
    scheme = "" if not sc else (default_target if sc in _WARM_CLASSES
                                else sc)
    return endpoint, volume, bucket, scheme


def rules_from_s3_xml(body: bytes,
                      default_target: str = "rs-6-3-1024k") -> list[dict]:
    """Parse a PutBucketReplication body into rule dicts. ``<Role>`` is
    accepted and ignored (no IAM here); ``<Priority>`` orders rules
    (lower first, AWS semantics); rules without one keep document
    order after all prioritized rules."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise GeoReplicationError(f"malformed XML: {e}")
    rule_els = _children(root, "Rule")
    if not rule_els:
        raise GeoReplicationError(
            "ReplicationConfiguration needs >= 1 Rule")
    parsed: list[tuple[float, int, dict]] = []
    for i, rel in enumerate(rule_els):
        rid = _text(rel, "ID") or f"rule-{i}"
        status = _text(rel, "Status") or "Enabled"
        prefix = _text(rel, "Prefix")
        for fel in _children(rel, "Filter"):
            prefix = _text(fel, "Prefix") or prefix
        dests = _children(rel, "Destination")
        if not dests:
            raise GeoReplicationError(
                f"rule {rid!r} has no Destination")
        endpoint, volume, bucket, scheme = _parse_destination(
            rid, dests[0], default_target)
        prio = _text(rel, "Priority")
        try:
            order = float(prio) if prio else float("inf")
        except ValueError:
            raise GeoReplicationError(
                f"rule {rid!r}: bad Priority {prio!r}")
        parsed.append((order, i, ReplicationRule(
            rule_id=rid, endpoint=endpoint, prefix=prefix,
            bucket=bucket, volume=volume, scheme=scheme,
            enabled=status.lower() == "enabled",
        ).validate().to_json()))
    parsed.sort(key=lambda t: (t[0], t[1]))
    return validate_rules([d for _, _, d in parsed])


def rules_to_s3_xml(rules: list[dict]) -> bytes:
    """Render stored rules as a GetBucketReplication body — rule order
    becomes explicit Priority so a GET body re-PUTs stably."""
    root = ET.Element("ReplicationConfiguration", xmlns=_NS)
    ET.SubElement(root, "Role").text = ""
    for n, d in enumerate(rules):
        r = ReplicationRule.from_json(d)
        rel = ET.SubElement(root, "Rule")
        ET.SubElement(rel, "ID").text = r.rule_id
        ET.SubElement(rel, "Priority").text = str(n + 1)
        ET.SubElement(rel, "Status").text = (
            "Enabled" if r.enabled else "Disabled")
        fel = ET.SubElement(rel, "Filter")
        ET.SubElement(fel, "Prefix").text = r.prefix
        dest = ET.SubElement(rel, "Destination")
        resource = (f"{r.volume}/{r.bucket}" if r.volume else r.bucket)
        ET.SubElement(dest, "Bucket").text = (
            f"{_ARN_PREFIX}{r.endpoint}::{resource}")
        if r.scheme:
            ET.SubElement(dest, "StorageClass").text = r.scheme
    return (b'<?xml version="1.0" encoding="UTF-8"?>'
            + ET.tostring(root))
