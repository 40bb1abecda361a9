"""Native ACLs: volume, bucket, key and prefix grants, and the authorizer.

Port of `ozone_tpu/om/acl.py` (the reference's ACL stack: `OzoneAcl`, a
grant of rights to a USER, GROUP or WORLD identity with ACCESS or DEFAULT
scope; `PrefixManagerImpl`, grants on path prefixes with longest-prefix
match; `OzoneNativeAuthorizer`, consulted by every OM request when
`ozone.acl.enabled` is on, off by default as there).

Volume, bucket and key rows carry an `acls` list of the JSON form of a
grant; prefix grants live in the `prefixes` table keyed
`/vol/bucket/prefix/`. DEFAULT grants on a parent become ACCESS grants on
a child made beneath it (`inherit_defaults`, the reference's
OzoneAclUtil.inheritDefaultAcls). Strings, JSON and decisions are the
reference's, grant for grant.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Iterable, Optional

from ozone_tpu_torch.om.metadata import OMMetadataStore, bucket_key, volume_key


class ACLRight(Enum):
    READ = "r"
    WRITE = "w"
    CREATE = "c"
    LIST = "l"
    DELETE = "d"
    READ_ACL = "x"
    WRITE_ACL = "y"

    @classmethod
    def all(cls) -> frozenset["ACLRight"]:
        return frozenset(cls)


_RIGHT_BY_LETTER = {r.value: r for r in ACLRight}


class ACLIdentityType(Enum):
    USER = "user"
    GROUP = "group"
    WORLD = "world"


class ACLScope(Enum):
    ACCESS = "ACCESS"
    DEFAULT = "DEFAULT"


@dataclass(frozen=True)
class OzoneAcl:
    """One grant. String form matches the reference CLI:
    `user:alice:rwcl[ACCESS]`, `world::r` (scope defaults to ACCESS),
    rights letter `a` = all."""

    id_type: ACLIdentityType
    name: str  # empty for WORLD
    rights: frozenset[ACLRight]
    scope: ACLScope = ACLScope.ACCESS

    @classmethod
    def parse(cls, s: str) -> "OzoneAcl":
        scope = ACLScope.ACCESS
        if s.endswith("]") and "[" in s:
            s, _, sc = s[:-1].rpartition("[")
            scope = ACLScope(sc.upper())
        parts = s.split(":")
        if len(parts) != 3:
            raise ValueError(f"acl must be type:name:rights, got {s!r}")
        t, name, letters = parts
        if letters == "a":
            rights = ACLRight.all()
        else:
            rights = frozenset(_RIGHT_BY_LETTER[ch] for ch in letters)
        return cls(ACLIdentityType(t.lower()), name, rights, scope)

    def __str__(self) -> str:
        letters = ("a" if self.rights == ACLRight.all() else
                   "".join(sorted(r.value for r in self.rights)))
        return f"{self.id_type.value}:{self.name}:{letters}[{self.scope.value}]"

    def to_json(self) -> dict:
        return {
            "type": self.id_type.value,
            "name": self.name,
            "rights": sorted(r.value for r in self.rights),
            "scope": self.scope.value,
        }

    @classmethod
    def from_json(cls, d: dict) -> "OzoneAcl":
        return cls(
            ACLIdentityType(d["type"]),
            d.get("name", ""),
            frozenset(_RIGHT_BY_LETTER[x] for x in d["rights"]),
            ACLScope(d.get("scope", "ACCESS")),
        )

    def matches(self, user: str, groups: Iterable[str]) -> bool:
        if self.id_type is ACLIdentityType.WORLD:
            return True
        if self.id_type is ACLIdentityType.USER:
            return self.name == user
        return self.name in set(groups)


def add_acl(acls: list[dict], new: OzoneAcl) -> tuple[list[dict], bool]:
    """Merge a grant into a stored acl list (rights union per identity,
    reference OzoneAclUtil.addAcl). Returns (updated, changed)."""
    out = []
    merged = False
    changed = False
    for d in acls:
        a = OzoneAcl.from_json(d)
        if (a.id_type, a.name, a.scope) == (new.id_type, new.name, new.scope):
            u = OzoneAcl(a.id_type, a.name, a.rights | new.rights, a.scope)
            changed = u.rights != a.rights
            out.append(u.to_json())
            merged = True
        else:
            out.append(d)
    if not merged:
        out.append(new.to_json())
        changed = True
    return out, changed


def remove_acl(acls: list[dict], gone: OzoneAcl) -> tuple[list[dict], bool]:
    """Subtract rights; identities left with no rights drop out."""
    out = []
    changed = False
    for d in acls:
        a = OzoneAcl.from_json(d)
        if (a.id_type, a.name, a.scope) == (gone.id_type, gone.name,
                                            gone.scope):
            kept = a.rights - gone.rights
            changed = changed or kept != a.rights
            if kept:
                out.append(OzoneAcl(a.id_type, a.name, kept, a.scope).to_json())
        else:
            out.append(d)
    return out, changed


def inherit_defaults(parent_acls: list[dict]) -> list[dict]:
    """DEFAULT grants on the parent become ACCESS grants on a new child
    (OzoneAclUtil.inheritDefaultAcls)."""
    out = []
    for d in parent_acls:
        a = OzoneAcl.from_json(d)
        if a.scope is ACLScope.DEFAULT:
            out.append(OzoneAcl(a.id_type, a.name, a.rights,
                                ACLScope.ACCESS).to_json())
    return out


def prefix_key(volume: str, bucket: str, prefix: str) -> str:
    if not prefix.endswith("/"):
        prefix += "/"
    return f"/{volume}/{bucket}/{prefix}"


def normalize_acls(acls: Optional[Iterable]) -> list[dict]:
    """OzoneAcl objects, CLI strings or JSON dicts -> JSON dicts (the OM
    and the remote OM client share it)."""
    out: list[dict] = []
    for a in acls or []:
        if isinstance(a, OzoneAcl):
            out.append(a.to_json())
        elif isinstance(a, str):
            out.append(OzoneAcl.parse(a).to_json())
        else:
            out.append(a)
    return out


class NativeAuthorizer:
    """OzoneNativeAuthorizer analog: evaluates a requested right against
    the grant chain volume -> bucket -> longest matching prefixes -> key.

    Semantics follow the reference: the owner of the volume and the
    superuser always pass; otherwise the *deepest* object that carries
    explicit ACCESS grants for the caller decides; prefix grants override
    bucket grants for keys underneath them.
    """

    def __init__(self, store: OMMetadataStore, superusers: Iterable[str] = ("root",)):
        self.store = store
        self.superusers = set(superusers)

    def _explicit(self, acls: Optional[list], user: str,
                  groups: Iterable[str], right: ACLRight) -> Optional[bool]:
        """True/False if any grant names this caller, None if no grant
        mentions them at this level."""
        if not acls:
            return None
        mentioned = False
        for d in acls:
            a = OzoneAcl.from_json(d)
            if a.scope is not ACLScope.ACCESS:
                continue
            if a.matches(user, groups):
                mentioned = True
                if right in a.rights:
                    return True
        return False if mentioned else None

    def check(self, volume: str, bucket: Optional[str], key: Optional[str],
              user: str, groups: Iterable[str], right: ACLRight) -> bool:
        if user in self.superusers:
            return True
        vrow = self.store.get("volumes", volume_key(volume))
        if vrow is None:
            return False
        if vrow.get("owner") == user:
            return True
        decision = self._explicit(vrow.get("acls"), user, groups, right)
        if bucket is not None:
            brow = self.store.get("buckets", bucket_key(volume, bucket))
            if brow is not None:
                d = self._explicit(brow.get("acls"), user, groups, right)
                if d is not None:
                    decision = d
                if brow.get("owner") == user:
                    return True
        if key is not None:
            # longest-prefix-first scan of prefix grants under the bucket
            base = f"/{volume}/{bucket}/"
            best_len = -1
            for pk, prow in self.store.iterate("prefixes", base):
                p = pk[len(base):]
                if (key + "/").startswith(p) and len(p) > best_len:
                    d = self._explicit(prow.get("acls"), user, groups, right)
                    if d is not None:
                        decision = d
                        best_len = len(p)
            # key row: flat table for OBS, parent-id-keyed files for FSO
            # (same resolution as requests._acl_target)
            from ozone_tpu_torch.om import requests as rq

            try:
                table, k = rq._acl_target(self.store, "key", volume,
                                          bucket, key)
                krow = self.store.get(table, k)
            except rq.OMError:
                krow = None
            if krow is not None:
                d = self._explicit(krow.get("acls"), user, groups, right)
                if d is not None:
                    decision = d
        return bool(decision)


from ozone_tpu_torch.om.requests import OMError, PERMISSION_DENIED  # noqa: E402


class ACLDeniedError(OMError):
    """An OMError (code PERMISSION_DENIED), so a denial crosses the RPC's
    error mapping and the clients' failover as any OM error does."""

    def __init__(self, user: str, right: ACLRight, path: str):
        super().__init__(PERMISSION_DENIED,
                         f"user {user} lacks {right.name} on {path}")
        self.user = user
        self.right = right
        self.path = path
