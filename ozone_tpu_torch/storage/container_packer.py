"""Container export and import as tarballs.

Port of `ozone_tpu/storage/container_packer.py` (the reference's
TarContainerPacker, used by the datanode-to-datanode replication
stream): a container replica travels as one archive of its descriptor,
its block records and its chunk files, with a negotiated compression
matrix (the reference's CopyContainerCompression: every codec this
interpreter can both compress and decompress is offered, zstd and lz4
when their modules import, gzip and none always). Import never needs the
codec's name on the wire: each codec's frame magic identifies it. A peer
that receives a codec it cannot decompress raises
UNSUPPORTED_COMPRESSION, and the sender retries with gzip
(`net/dn_service.RpcDatanodeClient.import_container`).
"""

from __future__ import annotations

import io
import json
import tarfile
from typing import Optional

from ozone_tpu_torch.storage.container import Container
from ozone_tpu_torch.storage.ids import (
    INVALID_CONTAINER_STATE,
    BlockData,
    ContainerState,
    StorageError,
)

UNSUPPORTED_COMPRESSION = "UNSUPPORTED_COMPRESSION"

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_LZ4_MAGIC = b"\x04\x22\x4d\x18"

#: preference order when negotiating (the best ratio and speed first)
CODEC_PREFERENCE = ("zstd", "lz4", "gzip", "none")


def _zstd():
    try:
        import zstandard

        return zstandard
    except ImportError:
        return None


def _lz4():
    try:
        import lz4.frame

        return lz4.frame
    except ImportError:
        return None


def available_codecs() -> tuple[str, ...]:
    """The codecs this interpreter can both compress and decompress."""
    out = []
    if _zstd() is not None:
        out.append("zstd")
    if _lz4() is not None:
        out.append("lz4")
    out.extend(["gzip", "none"])
    return tuple(out)


def negotiate_codec(accept) -> str:
    """The first codec both sides have, in preference order; `accept` is
    the peer's offer (missing or empty means gzip, the wire default)."""
    accept = [a for a in (accept or []) if a]
    if not accept:
        return "gzip"
    ours = set(available_codecs())
    for name in CODEC_PREFERENCE:
        if name in ours and name in accept:
            return name
    return "none" if "none" in accept else "gzip"


def compress_blob(name: str, data: bytes) -> bytes:
    if name == "none":
        return data
    if name == "gzip":
        import gzip

        return gzip.compress(data, compresslevel=1)
    if name == "zstd":
        z = _zstd()
        if z is None:
            raise StorageError(UNSUPPORTED_COMPRESSION, "zstd unavailable")
        return z.ZstdCompressor().compress(data)
    if name == "lz4":
        l4 = _lz4()
        if l4 is None:
            raise StorageError(UNSUPPORTED_COMPRESSION, "lz4 unavailable")
        return l4.compress(data)
    raise StorageError(UNSUPPORTED_COMPRESSION, f"unknown codec {name}")


def sniff_decompress(data) -> bytes:
    """Identify the codec by its frame magic and decompress; a plain tar
    (or gzip, which tarfile reads itself) passes through."""
    head = bytes(data[:4])
    if head == _ZSTD_MAGIC:
        z = _zstd()
        if z is None:
            raise StorageError(
                UNSUPPORTED_COMPRESSION,
                "peer sent zstd; this node cannot decompress it")
        return z.ZstdDecompressor().decompress(data,
                                               max_output_size=2 ** 32)
    if head == _LZ4_MAGIC:
        l4 = _lz4()
        if l4 is None:
            raise StorageError(
                UNSUPPORTED_COMPRESSION,
                "peer sent lz4; this node cannot decompress it")
        return l4.decompress(data)
    return data


def export_container(container: Container,
                     compression: str = "none") -> bytes:
    """Pack a closed replica: descriptor, block records, chunk files. An
    OPEN replica mid-write would snapshot torn chunks, so only closed ones
    export."""
    if container.state not in (ContainerState.CLOSED,
                               ContainerState.QUASI_CLOSED):
        raise StorageError(
            INVALID_CONTAINER_STATE,
            f"container {container.id} is {container.state.value}; only "
            "closed replicas export (close it first)")
    if compression not in CODEC_PREFERENCE:
        raise StorageError(UNSUPPORTED_COMPRESSION,
                           f"unknown codec {compression}")
    # gzip keeps tarfile's own framing; the other codecs wrap a plain tar
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf,
                      mode="w:gz" if compression == "gzip" else "w") as tar:
        for name, obj in (
            ("container.json", {"id": container.id,
                                "replica_index": container.replica_index,
                                "state": container.state.value}),
            ("blocks.json", [b.to_json() for b in container.list_blocks()]),
        ):
            raw = json.dumps(obj).encode()
            info = tarfile.TarInfo(name)
            info.size = len(raw)
            tar.addfile(info, io.BytesIO(raw))
        for f in sorted(container.chunks.chunks_dir.glob("*.block")):
            tar.add(str(f), arcname=f"chunks/{f.name}")
    out = buf.getvalue()
    if compression in ("none", "gzip"):
        return out
    return compress_blob(compression, out)


def import_container(dn, data: bytes,
                     replica_index: Optional[int] = None,
                     expect_id: Optional[int] = None) -> Container:
    """Unpack a replica onto a datanode; it lands CLOSED. A failure after
    the RECOVERING container was created removes that container (only one
    this import created), so the import can be retried."""
    created: Optional[Container] = None
    try:
        with tarfile.open(fileobj=io.BytesIO(sniff_decompress(data)),
                          mode="r:*") as tar:
            desc = json.loads(tar.extractfile("container.json").read())
            if expect_id is not None and int(desc["id"]) != int(expect_id):
                raise StorageError(
                    "CONTAINER_ID_MISMATCH",
                    f"tarball is container {desc['id']}, not {expect_id}")
            blocks = json.loads(tar.extractfile("blocks.json").read())
            created = dn.create_container(
                int(desc["id"]),
                replica_index=(replica_index if replica_index is not None
                               else int(desc.get("replica_index", 0))),
                state=ContainerState.RECOVERING)
            c = created
            c.chunks.chunks_dir.mkdir(parents=True, exist_ok=True)
            for member in tar.getmembers():
                if member.name.startswith("chunks/") and member.isfile():
                    dest = c.chunks.chunks_dir / member.name[len("chunks/"):]
                    with open(dest, "wb") as out:
                        out.write(tar.extractfile(member).read())
            for b in blocks:
                c.put_block(BlockData.from_json(b))
            c.close()
        return c
    except Exception:
        if created is not None:
            try:
                dn.delete_container(created.id, force=True)
            except StorageError:  # ozlint: allow[error-swallowing] -- best-effort cleanup of the half-imported container; the original error re-raises below
                pass
        raise
