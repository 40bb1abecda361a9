"""Block and container tokens: HMAC-signed capabilities for datanode verbs.

Port of `ozone_tpu/utils/security.py` (the reference's hdds security:
the symmetric SecretKeyManager rotating HMAC keys in the SCM,
OzoneBlockTokenSecretManager and ContainerTokenSecretManager issuing
tokens that ride every datanode request, BlockTokenVerifier checking
mode, expiry, subject and signature on the datanode). A token grants
READ and/or WRITE on one block (scope "b") or one container (scope "c")
for a bounded lifetime, and verifies against any key that has not
expired, so a rotation never breaks tokens in flight.

Payloads and signatures are byte-identical to the reference's for the
same key material and clock: the signed bytes are canonical JSON (sorted
keys, no spaces, sorted modes, the expiry rounded to milliseconds).
Standard library only (`hmac`, `hashlib`, `secrets`, `json`).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import secrets
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Optional

from ozone_tpu_torch.storage.ids import (
    BLOCK_TOKEN_VERIFICATION_FAILED,
    BlockID,
    StorageError,
)
from ozone_tpu_torch.utils.metrics import registry

#: token checks on the datanode lanes ("rpc", "native", "ratis"):
#: `verify_<lane>` histograms of seconds per check and `refused_<lane>`
#: counters
METRICS = registry("security")


class AccessMode(Enum):
    READ = "READ"
    WRITE = "WRITE"


class TokenError(Exception):
    pass


@dataclass(frozen=True)
class SecretKey:
    key_id: str
    material: bytes
    created: float
    expires: float

    def to_json(self) -> dict:
        return {
            "key_id": self.key_id,
            "material": self.material.hex(),
            "created": self.created,
            "expires": self.expires,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SecretKey":
        return cls(d["key_id"], bytes.fromhex(d["material"]),
                   float(d["created"]), float(d["expires"]))


class SecretKeyManager:
    """Rotating symmetric keys (security/symmetric/SecretKeyManager.java).

    `generate=False` builds an empty manager that holds only imported
    keys: the datanode's verifier state, fed by the SCM on its register
    and heartbeat answers."""

    def __init__(self, rotation_s: float = 3600.0, lifetime_s: float = 7200.0,
                 generate: bool = True, activation_s: float = 0.0):
        self.rotation_s = rotation_s
        self.lifetime_s = lifetime_s
        #: a new key becomes the signing key only this many seconds after
        #: it was made: verifiers learn keys on the next heartbeat, and a
        #: token signed with a key no datanode holds yet would be refused.
        #: Verification takes every live key at once; only signing waits
        self.activation_s = activation_s
        self._keys: dict[str, SecretKey] = {}
        self._current: Optional[SecretKey] = None
        self._lock = threading.Lock()
        if generate:
            self.rotate()

    def rotate(self) -> SecretKey:
        with self._lock:
            now = time.time()
            k = SecretKey(
                key_id=secrets.token_hex(8),
                material=secrets.token_bytes(32),
                created=now,
                expires=now + self.lifetime_s,
            )
            self._keys[k.key_id] = k
            self._current = k
            for kid in [k2 for k2, v in self._keys.items()
                        if v.expires < now]:
                del self._keys[kid]
            return k

    def current(self) -> Optional[SecretKey]:
        """The signing key: the newest key past its activation delay, or
        the newest key at all when none is (the first key signs at once)."""
        with self._lock:
            if self._current is None or self.activation_s <= 0:
                return self._current
            cutoff = time.time() - self.activation_s
            eligible = [k for k in self._keys.values()
                        if k.created <= cutoff]
            if not eligible:
                return self._current
            return max(eligible, key=lambda k: k.created)

    def get(self, key_id: str) -> Optional[SecretKey]:
        return self._keys.get(key_id)

    def import_key(self, key: SecretKey) -> None:
        """Install a key made elsewhere (SCM -> datanode, or a rotation
        applied from the metadata ring). The newest key becomes the
        signing key; expired keys are dropped here, since a verifier's
        manager never rotates."""
        with self._lock:
            self._keys[key.key_id] = key
            if self._current is None or key.created > self._current.created:
                self._current = key
            now = time.time()
            for kid in [k2 for k2, v in self._keys.items()
                        if v.expires < now]:
                del self._keys[kid]

    def needs_rotation(self) -> bool:
        cur = self._current
        return cur is None or time.time() - cur.created > self.rotation_s

    def new_key(self) -> SecretKey:
        """A fresh key, not installed: under HA the leader makes it, the
        ring replicates it and every replica installs it on apply."""
        now = time.time()
        return SecretKey(
            key_id=secrets.token_hex(8),
            material=secrets.token_bytes(32),
            created=now,
            expires=now + self.lifetime_s,
        )

    def export_keys(self) -> list[dict]:
        """Every live key, for distribution to verifiers."""
        now = time.time()
        with self._lock:
            return [k.to_json() for k in self._keys.values()
                    if k.expires >= now]

    def import_keys(self, keys: list[dict]) -> None:
        for d in keys:
            self.import_key(SecretKey.from_json(d))


def _payload(scope: str, subject, modes: list[AccessMode], owner: str,
             expiry: float, key_id: str) -> bytes:
    """The signed bytes. `scope` keeps block ("b") and container ("c")
    tokens apart, so neither can be replayed as the other."""
    return json.dumps(
        {
            "s": scope,
            "b": subject,
            "m": sorted(m.value for m in modes),
            "o": owner,
            "e": round(expiry, 3),
            "k": key_id,
        },
        sort_keys=True,
        separators=(",", ":"),
    ).encode()


class BlockTokenIssuer:
    """Token minting on the OM and the SCM. A datanode builds one over
    its imported keys to sign its own repair traffic (the reference's
    ec/reconstruction/TokenHelper)."""

    def __init__(self, secrets_mgr: SecretKeyManager,
                 token_lifetime_s: float = 600.0):
        self.secrets = secrets_mgr
        self.lifetime = token_lifetime_s

    def _sign(self, scope: str, subject, modes: list[AccessMode],
              owner: str) -> dict:
        key = self.secrets.current()
        if key is None:
            raise TokenError("no signing key available")
        expiry = time.time() + self.lifetime
        payload = _payload(scope, subject, modes, owner, expiry, key.key_id)
        sig = hmac.new(key.material, payload, hashlib.sha256).hexdigest()
        return {
            "scope": scope,
            "subject": subject,
            "modes": sorted(m.value for m in modes),
            "owner": owner,
            "expiry": round(expiry, 3),
            "key_id": key.key_id,
            "sig": sig,
        }

    def issue(self, block_id: BlockID, modes: list[AccessMode],
              owner: str = "client") -> dict:
        return self._sign("b", block_id.to_json(), modes, owner)

    def issue_container(self, container_id: int,
                        modes: Optional[list[AccessMode]] = None,
                        owner: str = "client") -> dict:
        return self._sign("c", int(container_id),
                          modes or [AccessMode.READ, AccessMode.WRITE],
                          owner)


class BlockTokenVerifier:
    """Datanode-side verification (BlockTokenVerifier.java)."""

    def __init__(self, secrets_mgr: SecretKeyManager, enabled: bool = True):
        self.secrets = secrets_mgr
        self.enabled = enabled

    def _check(self, token: Optional[dict], scope: str, subject,
               what: str, mode: AccessMode) -> None:
        if not self.enabled:
            return
        if token is None:
            raise TokenError(f"missing {what} token")
        if token.get("scope", "b") != scope:
            raise TokenError(f"not a {what} token")
        if token.get("expiry", 0) < time.time():
            raise TokenError(f"{what} token expired")
        if mode.value not in token.get("modes", []):
            raise TokenError(f"token lacks {mode.value} access")
        if token.get("subject") != subject:
            raise TokenError(
                f"token is for {token.get('subject')}, not {subject}")
        key = self.secrets.get(token.get("key_id", ""))
        if key is None:
            raise TokenError("unknown/expired secret key")
        try:
            modes = [AccessMode(m) for m in token["modes"]]
        except ValueError as e:
            raise TokenError(f"malformed token mode: {e}")
        payload = _payload(scope, subject, modes, token.get("owner", ""),
                           token["expiry"], token["key_id"])
        expect = hmac.new(key.material, payload, hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expect, token.get("sig", "")):
            raise TokenError("bad token signature")

    def verify(self, token: Optional[dict], block_id: BlockID,
               mode: AccessMode) -> None:
        self._check(token, "b", block_id.to_json(), "block", mode)

    def verify_container(self, token: Optional[dict], container_id: int,
                         mode: AccessMode = AccessMode.WRITE) -> None:
        self._check(token, "c", int(container_id), "container", mode)


def gate(verifier: Optional[BlockTokenVerifier], lane: str, token,
         block_id: Optional[BlockID] = None,
         container_id: Optional[int] = None,
         mode: AccessMode = AccessMode.WRITE) -> None:
    """A datanode lane's check of one request: the block token on
    `block_id`, or the container token on `container_id`. Refuses with
    BLOCK_TOKEN_VERIFICATION_FAILED before the verb runs; a no-op while
    the verifier is off (an insecure cluster)."""
    if verifier is None or not verifier.enabled:
        return
    t0 = time.perf_counter()
    try:
        if block_id is not None:
            verifier.verify(token, block_id, mode)
        else:
            verifier.verify_container(token, int(container_id), mode)
    except TokenError as e:
        METRICS.counter(f"refused_{lane}").inc()
        raise StorageError(BLOCK_TOKEN_VERIFICATION_FAILED, str(e))
    finally:
        METRICS.histogram(f"verify_{lane}").observe(time.perf_counter() - t0)
