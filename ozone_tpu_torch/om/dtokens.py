"""OM delegation tokens: HMAC-signed identity tokens kept in the store.

Port of `ozone_tpu/om/dtokens.py` (the reference's
OzoneDelegationTokenSecretManager and OzoneTokenIdentifier): a caller
authenticated once gets a token naming an owner and a renewer; the token
then authenticates later OM calls, its renewer renews it up to a hard
max lifetime, and its owner or renewer cancels it. The rotating master
keys and the live tokens are rows of the replicated tables `dtoken_keys`
and `delegation_tokens`, changed only by OM requests, so every replica of
the metadata ring verifies alike.

The signed identifier is a flat dict (owner, renewer, real_user, issue,
max_date, token_id, key_id); the signature is HMAC-SHA256 under the
master key of its canonical JSON. The renewable expiry is server state
(the row), not signed: a renewal updates the row, never the token.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time
from typing import Any, Optional

#: identifier fields covered by the signature, in canonical order
IDENT_FIELDS = ("owner", "renewer", "real_user", "issue", "max_date",
                "token_id", "key_id")

TOKEN_ERROR = "TOKEN_ERROR"


class DTokenError(Exception):
    def __init__(self, msg: str):
        super().__init__(msg)
        self.msg = msg


def canonical(ident: dict) -> bytes:
    return json.dumps(
        {f: ident.get(f) for f in IDENT_FIELDS},
        sort_keys=True, separators=(",", ":"),
    ).encode()


def sign(material: bytes, ident: dict) -> str:
    return hmac.new(material, canonical(ident), hashlib.sha256).hexdigest()


def current_key(store, now: Optional[float] = None) -> Optional[dict]:
    """Newest unexpired master key, or None. Deterministic given `now`
    (request apply paths pass the request's own timestamp)."""
    now = time.time() if now is None else now
    best = None
    for _, row in store.iterate("dtoken_keys"):
        if row["expires"] <= now:
            continue
        if best is None or row["created"] > best["created"]:
            best = row
    return best


def check_signature(store, token: Any) -> dict:
    """Signature + shape check only (no liveness): raises DTokenError or
    returns the token dict. Used before renew/cancel so a forged token
    can never reach the replicated log."""
    if not isinstance(token, dict):
        raise DTokenError("malformed delegation token")
    for f in IDENT_FIELDS:
        if f not in token:
            raise DTokenError(f"delegation token missing field {f!r}")
    key = store.get("dtoken_keys", str(token["key_id"]))
    if key is None:
        raise DTokenError("delegation token signed by unknown master key")
    expect = sign(bytes.fromhex(key["material"]), token)
    if not hmac.compare_digest(expect, str(token.get("sig", ""))):
        raise DTokenError("bad delegation token signature")
    return token


def verify(store, token: Any, now: Optional[float] = None) -> dict:
    """Full verification: signature, live row, renewable expiry. Returns
    the STORED row (authoritative owner/renewer/expiry)."""
    check_signature(store, token)
    row = store.get("delegation_tokens", str(token["token_id"]))
    if row is None:
        raise DTokenError("delegation token cancelled or unknown")
    now = time.time() if now is None else now
    if row["expiry"] < now:
        raise DTokenError("delegation token expired (renew lapsed)")
    if row["max_date"] < now:
        raise DTokenError("delegation token past max lifetime")
    return row
