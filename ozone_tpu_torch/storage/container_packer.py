"""Container export and import as tarballs.

Port of `ozone_tpu/storage/container_packer.py` (the reference's
TarContainerPacker, used by the datanode-to-datanode replication
stream): a container replica travels as one archive of its descriptor,
its block records and its chunk files. The compression matrix is gzip
and none, which every Python offers; the reference's zstd and lz4 are
left out. Import never needs the codec's name: gzip's magic identifies
it.
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

#: preference order when negotiating
CODEC_PREFERENCE = ("gzip", "none")


def available_codecs() -> tuple[str, ...]:
    return CODEC_PREFERENCE


def negotiate_codec(accept) -> str:
    """First mutually available codec in preference order; an empty offer
    means gzip, the wire default."""
    accept = [a for a in (accept or []) if a]
    if not accept:
        return "gzip"
    for name in CODEC_PREFERENCE:
        if name in accept:
            return name
    return "gzip"


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
    return buf.getvalue()


def import_container(dn, data: bytes,
                     replica_index: Optional[int] = None,
                     expect_id: Optional[int] = None) -> Container:
    """Unpack a replica onto a datanode; it lands CLOSED. A failure after
    the RECOVERING container was created removes that container (only one
    this import created), so the import can be retried."""
    created: Optional[Container] = None
    try:
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:*") as tar:
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
            except StorageError:
                pass
        raise
