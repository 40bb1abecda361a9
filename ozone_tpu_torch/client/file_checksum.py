"""Composite file checksums from stored chunk CRCs — no data reads.

Port of `ozone_tpu/client/file_checksum.py` (the reference's
ECFileChecksumHelper / ReplicatedFileChecksumHelper: a composite CRC over
stripes): the whole-key checksum is composed from the per-slice CRCs the
datanodes already store in block metadata, so comparing two copies of a
key (distcp-style) costs a few metadata RPCs instead of a full read. For
an EC key those are the CRC words the fused encode kernel wrote.

The composition rule is the standard CRC combine over GF(2) (zlib's
crc32_combine construction): crc(A||B) derives from crc(A), crc(B) and
len(B) by multiplying crc(A) with the x^(8*len(B)) operator modulo the
polynomial. Works for any reflected CRC; CRC32C here.
"""

from __future__ import annotations

import logging
from functools import lru_cache

from ozone_tpu_torch.scm.pipeline import ReplicationConfig, ReplicationType
from ozone_tpu_torch.storage.ids import BlockID, StorageError
from ozone_tpu_torch.utils.checksum import (
    CRC32_POLY,
    CRC32C_POLY,
    ChecksumType,
)

log = logging.getLogger(__name__)

_POLYS = {
    ChecksumType.CRC32: CRC32_POLY,
    ChecksumType.CRC32C: CRC32C_POLY,
}


def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, mat[n]) for n in range(32)]


def _zeros_shift(crc: int, len2: int, poly: int) -> int:
    """`crc` advanced over `len2` zero bytes (the zlib crc32_combine
    squaring loop, without its final xor)."""
    # operator matrix for one zero BIT (reflected): row n maps bit n
    odd = [poly] + [1 << (n - 1) for n in range(1, 32)]
    even = _gf2_matrix_square(odd)   # 2 zero bits
    odd = _gf2_matrix_square(even)   # 4 zero bits
    while True:
        even = _gf2_matrix_square(odd)  # 8 bits = 1 zero byte, then 4x up
        if len2 & 1:
            crc = _gf2_matrix_times(even, crc)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_matrix_square(even)
        if len2 & 1:
            crc = _gf2_matrix_times(odd, crc)
        len2 >>= 1
        if not len2:
            break
    return crc


@lru_cache(maxsize=64)
def _zeros_operator(len2: int, poly: int) -> tuple:
    """The GF(2) operator of `len2` zero bytes, one column per bit: a key
    of many equal slices builds it once instead of once per slice."""
    return tuple(_zeros_shift(1 << n, len2, poly) for n in range(32))


def crc_combine(crc1: int, crc2: int, len2: int, poly: int) -> int:
    """crc(A||B) from crc(A), crc(B), len(B bytes) for a reflected-
    polynomial CRC with the usual ~0 init / ~0 final-xor convention —
    the zlib crc32_combine construction, parameterized by polynomial."""
    if len2 == 0:
        return crc1
    return _gf2_matrix_times(_zeros_operator(len2, poly), crc1) ^ crc2


def composite_crc(parts: list[tuple[int, int]], poly: int) -> int:
    """Fold [(crc, length), ...] in order into one composite CRC."""
    if not parts:
        return 0
    crc, _ = parts[0]
    for c, ln in parts[1:]:
        crc = crc_combine(crc, c, ln, poly)
    return crc


def _chunk_slices(chunk) -> list[tuple[int, int]]:
    """Per-slice (crc, length) pairs of one chunk, in byte order."""
    cd = chunk.checksum
    bpc = cd.bytes_per_checksum
    out = []
    remaining = chunk.length
    for raw in cd.checksums:
        take = min(bpc, remaining)
        out.append((int.from_bytes(raw, "big"), take))
        remaining -= take
    return out


def file_checksum(client, volume: str, bucket: str, key: str) -> dict:
    """Compose the whole-key CRC from stored chunk checksums.

    Returns {"algorithm": "COMPOSITE-CRC32C", "checksum": "<hex>",
    "length": n}. Replicated keys walk blocks in order (any live
    replica); EC keys walk the stripe traversal: for each stripe, the
    cell chunks of the k data units in unit order, the byte order of the
    original stream. It works from the key row's JSON groups, so it
    needs no codec (and no torch)."""
    info = client.om.lookup_key(volume, bucket, key)
    groups = info.get("block_groups", [])
    from ozone_tpu_torch.client.dn_client import register_tokens

    register_tokens(client.clients, groups)  # READ tokens from the lookup
    repl = ReplicationConfig.parse(info.get("replication") or "rs-6-3-1024k")
    ctype = ChecksumType(info.get("checksum_type", "CRC32C"))
    poly = _POLYS.get(ctype)
    if poly is None:
        raise ValueError(f"no composite checksum for {ctype}")
    parts: list[tuple[int, int]] = []
    if repl.type is ReplicationType.EC:
        parts.extend(_ec_parts(client, groups, repl))
    else:
        parts.extend(_replicated_parts(client, groups))
    total = sum(ln for _, ln in parts)
    if total != info["size"]:
        # a short composition means metadata was unreachable somewhere; a
        # plausible-but-wrong checksum would poison integrity comparisons
        raise RuntimeError(
            f"composed {total} bytes of checksums for a {info['size']}-byte"
            f" key {volume}/{bucket}/{key}: block metadata incomplete"
        )
    crc = composite_crc(parts, poly)
    return {
        "algorithm": f"COMPOSITE-{ctype.value}",
        "checksum": f"{crc:08x}",
        "length": total,
    }


def _block_id(g: dict) -> BlockID:
    return BlockID(int(g["container_id"]), int(g["local_id"]))


def _replicated_parts(client, groups) -> list[tuple[int, int]]:
    parts = []
    for g in groups:
        bd = None
        last = None
        for dn_id in g["nodes"]:
            try:
                bd = client.clients.get(dn_id).get_block(_block_id(g))
                break
            except Exception as e:  # noqa: BLE001 - replica failover
                last = e
        if bd is None:
            raise RuntimeError(
                f"no replica served block {_block_id(g)}: {last}")
        for chunk in sorted(bd.chunks, key=lambda c: c.offset):
            parts.extend(_chunk_slices(chunk))
    return parts


def _ec_parts(client, groups, repl) -> list[tuple[int, int]]:
    k = repl.ec.data_units
    parts = []
    for g in groups:
        # one block per data unit, indexed by pipeline position
        unit_chunks: list[dict[int, object]] = []
        for u in range(k):
            dn_id = g["nodes"][u]
            try:
                bd = client.clients.get(dn_id).get_block(_block_id(g))
                unit_chunks.append({c.offset: c for c in bd.chunks})
            except StorageError as e:
                # a short key never wrote to trailing units
                # (NO_SUCH_BLOCK); anything else is an unreachable unit
                # and must fail loudly, not silently shorten the compose
                if e.code != "NO_SUCH_BLOCK":
                    raise
                unit_chunks.append({})
        offsets = sorted({o for uc in unit_chunks for o in uc})
        for off in offsets:  # stripe traversal: unit order within stripe
            for u in range(k):
                chunk = unit_chunks[u].get(off)
                if chunk is not None:
                    parts.extend(_chunk_slices(chunk))
    return parts
