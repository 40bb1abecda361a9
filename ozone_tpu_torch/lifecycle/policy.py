"""Lifecycle rule model and the S3 LifecycleConfiguration XML codec.

Port of `ozone_tpu/lifecycle/policy.py`, unchanged in behaviour:
per-bucket rules (prefix filter, age threshold, action) ride the OM
bucket row; the S3 gateway's Put/Get/DeleteBucketLifecycleConfiguration
translate between the AWS XML shape and this model, and the sweeper
(`lifecycle/service.py`) evaluates the same model. Apache Ozone 1.5 has
no bucket lifecycle; this is the reference's own tiering extension.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

ACTION_TRANSITION = "TRANSITION_TO_EC"
ACTION_EXPIRE = "EXPIRE"
_ACTIONS = (ACTION_TRANSITION, ACTION_EXPIRE)

#: S3 StorageClass names accepted as "the bucket's warm tier": mapped to
#: the gateway/cluster default EC scheme at parse time. A literal scheme
#: string ("rs-6-3-1024k") passes through verbatim, so operators can pin
#: an exact layout per rule.
_WARM_CLASSES = ("STANDARD_IA", "GLACIER", "GLACIER_IR", "DEEP_ARCHIVE",
                 "INTELLIGENT_TIERING", "ONEZONE_IA")

_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


class LifecycleError(ValueError):
    """Invalid rule / configuration (maps to S3 MalformedXML /
    InvalidArgument at the gateway)."""


@dataclass
class LifecycleRule:
    rule_id: str
    prefix: str = ""
    age_days: float = 0.0
    action: str = ACTION_TRANSITION
    #: EC replication scheme for TRANSITION_TO_EC rules
    target: str = "rs-6-3-1024k"
    enabled: bool = True

    def validate(self) -> "LifecycleRule":
        if not self.rule_id:
            raise LifecycleError("rule needs a non-empty id")
        if self.action not in _ACTIONS:
            raise LifecycleError(
                f"unknown action {self.action!r} (expected one of "
                f"{_ACTIONS})")
        if self.age_days < 0:
            raise LifecycleError(f"age_days must be >= 0, got "
                                 f"{self.age_days}")
        if self.action == ACTION_TRANSITION:
            from ozone_tpu_torch.scm.pipeline import (
                ReplicationConfig,
                ReplicationType,
            )

            conf = ReplicationConfig.parse(self.target)  # raises on junk
            if conf.type is not ReplicationType.EC:
                raise LifecycleError(
                    f"transition target must be an EC scheme, got "
                    f"{self.target!r}")
        return self

    def matches(self, key: str, age_s: float) -> bool:
        return (self.enabled and key.startswith(self.prefix)
                and age_s >= self.age_days * 86400.0)

    def to_json(self) -> dict:
        return {
            "id": self.rule_id,
            "prefix": self.prefix,
            "age_days": self.age_days,
            "action": self.action,
            "target": self.target,
            "enabled": self.enabled,
        }

    @staticmethod
    def from_json(d: dict) -> "LifecycleRule":
        return LifecycleRule(
            rule_id=str(d.get("id", "")),
            prefix=str(d.get("prefix", "")),
            age_days=float(d.get("age_days", 0.0)),
            action=str(d.get("action", ACTION_TRANSITION)),
            target=str(d.get("target", "rs-6-3-1024k")),
            enabled=bool(d.get("enabled", True)),
        ).validate()


def validate_rules(rules: list[dict]) -> list[dict]:
    """Validate a rule list (wire dicts) and return the normalized
    dicts; raises LifecycleError on any bad rule or duplicate id."""
    out = []
    seen: set[str] = set()
    for d in rules:
        r = LifecycleRule.from_json(d)
        if r.rule_id in seen:
            raise LifecycleError(f"duplicate rule id {r.rule_id!r}")
        seen.add(r.rule_id)
        out.append(r.to_json())
    return out


def first_match(rules: list[LifecycleRule], key: str,
                age_s: float) -> LifecycleRule | None:
    """The first enabled rule whose prefix+age match (rule order is the
    operator's priority order, like S3's)."""
    for r in rules:
        if r.matches(key, age_s):
            return r
    return None


# ------------------------------------------------------------- S3 XML
def _text(el: ET.Element, name: str) -> str:
    """Namespace-tolerant child text: AWS SDKs send the 2006-03-01
    namespace, hand-rolled clients usually don't."""
    v = el.findtext(f"{{{_NS}}}{name}")
    if v is None:
        v = el.findtext(name)
    return (v or "").strip()


def _children(el: ET.Element, name: str) -> list[ET.Element]:
    return el.findall(f"{{{_NS}}}{name}") or el.findall(name)


def rules_from_s3_xml(body: bytes,
                      default_target: str = "rs-6-3-1024k") -> list[dict]:
    """Parse a PutBucketLifecycleConfiguration body into rule dicts.

    One <Rule> with both <Transition> and <Expiration> becomes two
    internal rules sharing the id with a suffix (the model keeps one
    action per rule so the sweeper's first-match walk stays simple).
    <StorageClass> accepts either an AWS warm class (mapped to
    `default_target`) or a literal EC scheme string.
    """
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise LifecycleError(f"malformed XML: {e}")
    out: list[dict] = []
    rule_els = _children(root, "Rule")
    if not rule_els:
        raise LifecycleError("LifecycleConfiguration needs >= 1 Rule")
    for i, rel in enumerate(rule_els):
        rid = _text(rel, "ID") or f"rule-{i}"
        status = _text(rel, "Status") or "Enabled"
        enabled = status.lower() == "enabled"
        prefix = _text(rel, "Prefix")
        for fel in _children(rel, "Filter"):
            prefix = _text(fel, "Prefix") or prefix
        actions = 0
        for tel in _children(rel, "Transition"):
            days = _text(tel, "Days")
            if not days:
                raise LifecycleError(
                    f"rule {rid!r}: Transition needs <Days> (Date "
                    "schedules are not supported)")
            sc = _text(tel, "StorageClass")
            target = (default_target if not sc or sc in _WARM_CLASSES
                      else sc)
            out.append(LifecycleRule(
                rule_id=rid if not actions else f"{rid}#transition",
                prefix=prefix, age_days=float(days),
                action=ACTION_TRANSITION, target=target,
                enabled=enabled).validate().to_json())
            actions += 1
        for eel in _children(rel, "Expiration"):
            days = _text(eel, "Days")
            if not days:
                raise LifecycleError(
                    f"rule {rid!r}: Expiration needs <Days>")
            out.append(LifecycleRule(
                rule_id=rid if not actions else f"{rid}#expire",
                prefix=prefix, age_days=float(days),
                action=ACTION_EXPIRE, enabled=enabled)
                .validate().to_json())
            actions += 1
        if not actions:
            raise LifecycleError(
                f"rule {rid!r} has neither Transition nor Expiration")
    return validate_rules(out)


def rules_to_s3_xml(rules: list[dict]) -> bytes:
    """Render stored rules as a GetBucketLifecycleConfiguration body —
    one <Rule> per internal rule (a combined PUT round-trips as its
    split form; ids keep the #suffix so re-PUTting the GET body is
    stable)."""
    root = ET.Element("LifecycleConfiguration", xmlns=_NS)
    for d in rules:
        r = LifecycleRule.from_json(d)
        rel = ET.SubElement(root, "Rule")
        ET.SubElement(rel, "ID").text = r.rule_id
        fel = ET.SubElement(rel, "Filter")
        ET.SubElement(fel, "Prefix").text = r.prefix
        ET.SubElement(rel, "Status").text = (
            "Enabled" if r.enabled else "Disabled")
        if r.action == ACTION_TRANSITION:
            tel = ET.SubElement(rel, "Transition")
            days = ET.SubElement(tel, "Days")
            days.text = str(int(r.age_days) if float(r.age_days)
                            .is_integer() else r.age_days)
            ET.SubElement(tel, "StorageClass").text = r.target
        else:
            eel = ET.SubElement(rel, "Expiration")
            days = ET.SubElement(eel, "Days")
            days.text = str(int(r.age_days) if float(r.age_days)
                            .is_integer() else r.age_days)
    return (b'<?xml version="1.0" encoding="UTF-8"?>'
            + ET.tostring(root))
