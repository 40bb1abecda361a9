"""KMS: master keys, envelope encryption and the datapath's stream cipher.

Port of `ozone_tpu/utils/kms.py` (the reference's OzoneKMSUtil,
KMSClientProvider and BucketEncryptionKeyInfo roles), whole. A bucket is
created against a named master key; every key write gets a fresh data
encryption key (DEK), stored only wrapped (the EDEK: the DEK under the
master key with AES-GCM, the master's name as associated data, so a
tampered EDEK or a wrong master raises). Readers unwrap the EDEK through
the metadata server (access-checked) and decrypt client-side. The
datanodes, checksums, scrubber, reconstruction and tiering see
ciphertext only, so nothing below the client changes.

The master keys live in the OM's replicated store (`system` rows under
`kms/mk/`), rotated by admin verbs; a rotation appends a version and old
EDEKs name the version that wrapped them. GDPR buckets store a per-key
plaintext secret in the key row instead, destroyed in the apply that
deletes the key (crypto-erasure, `om/requests.erase_gdpr_secret`).

The stream cipher is AES-256-CTR at any byte offset: the counter is the
IV plus the offset's block index, taken mod 2^128, and an offset inside a
block generates and drops the keystream of its partial block, so a
writer in several calls, an hsync'd prefix and a ranged read line up on
one keystream. AES runs on the host through `cryptography`, imported
where it is used; a bucket that needs it raises when it is missing.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

MASTER_PREFIX = "kms/mk/"


def _aesgcm(key: bytes):
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    return AESGCM(key)


def ctr_crypt(data, key: bytes, iv: bytes, offset: int = 0) -> np.ndarray:
    """Encrypt or decrypt (one operation) a byte stream at any byte
    `offset` with AES-256-CTR, byte for byte the reference's. The input is
    read in place and the output written into one preallocated array
    (`update_into`): a new bytes object per call costs more than the
    cipher on a large key."""
    from cryptography.hazmat.primitives.ciphers import (
        Cipher,
        algorithms,
        modes,
    )

    pad = offset % 16
    base = int.from_bytes(iv, "big") + (offset - pad) // 16
    counter = (base % (1 << 128)).to_bytes(16, "big")
    enc = Cipher(algorithms.AES(key), modes.CTR(counter)).encryptor()
    view = memoryview(np.ascontiguousarray(data, np.uint8)
                      if isinstance(data, np.ndarray) else data).cast("B")
    if pad:
        # the partial leading block's keystream, generated and dropped
        enc.update_into(b"\x00" * pad, bytearray(pad + 15))
    # update_into asks for room for a block beyond the input
    out = np.empty(len(view) + 15, np.uint8)
    n = enc.update_into(view, out)
    enc.finalize()
    return out[:n]


class KeyProvider:
    """Master-key store and EDEK wrap/unwrap over the OM's replicated
    metadata (the DefaultKeyProvider / KMSClientProvider role)."""

    def __init__(self, store):
        self.store = store  # OMMetadataStore ("system" table)

    def _row(self, name: str) -> Optional[dict]:
        return self.store.get("system", MASTER_PREFIX + name)

    def master_key_names(self) -> list[str]:
        return [k[len(MASTER_PREFIX):]
                for k, _ in self.store.iterate("system", MASTER_PREFIX)]

    @staticmethod
    def _missing(name) -> Exception:
        # an OMError, so the daemons answer with a clean code
        from ozone_tpu_torch.om.requests import INVALID_REQUEST, OMError

        return OMError(INVALID_REQUEST, f"no master key {name!r}")

    def master_info(self, name: str) -> dict:
        row = self._row(name)
        if row is None:
            raise self._missing(name)
        return {"name": name, "versions": len(row["versions"])}

    def generate_edek(self, master: str) -> dict:
        """A fresh DEK wrapped under the master key's current version
        (generateEncryptedKey), as the key row's bundle; the plaintext DEK
        never persists."""
        row = self._row(master)
        if row is None:
            raise self._missing(master)
        version = len(row["versions"]) - 1
        mk = bytes.fromhex(row["versions"][version])
        dek = os.urandom(32)
        nonce = os.urandom(12)
        wrapped = _aesgcm(mk).encrypt(nonce, dek, master.encode())
        return {
            "master": master,
            "version": version,
            "nonce": nonce.hex(),
            "edek": wrapped.hex(),
            "iv": os.urandom(16).hex(),  # the data stream's CTR IV
        }

    def unwrap_edek(self, bundle: dict) -> bytes:
        """EDEK -> DEK (decryptEncryptedKey); GCM refuses a tampered EDEK
        or a wrong master."""
        row = self._row(bundle["master"])
        if row is None:
            raise self._missing(bundle["master"])
        mk = bytes.fromhex(row["versions"][int(bundle["version"])])
        return _aesgcm(mk).decrypt(
            bytes.fromhex(bundle["nonce"]),
            bytes.fromhex(bundle["edek"]),
            bundle["master"].encode(),
        )
