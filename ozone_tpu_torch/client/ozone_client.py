"""OzoneClient: the user-facing object-store API.

Port of `ozone_tpu/client/ozone_client.py` (the reference's OzoneClient ->
ObjectStore -> OzoneVolume -> OzoneBucket -> key operations): volume and
bucket CRUD, and key writes and reads that take the EC datapath or the
replicated one by the key's replication config, as `_make_writer` and
the group reader choose. EC encodes and decodes run on `device` ("cuda"
launches the fused kernel and raises when CUDA is absent; "cpu" runs its
plain version). `om` is duck-typed, as in the reference: an in-process
`OzoneManager`, or a `net/om_service.RemoteOmClient` that talks to a
metadata daemon, with the datanode factory resolving the remote
addresses the OM's answers carry. Multipart uploads write each part
through the same datapath as a key (`MultipartUpload`). A tenant context
set by the S3 gateway (`admission.tenant_context`) gives the writers and
readers their QoS class, as in the reference. On a bucket opted into
small objects, a PUT without an explicit replication takes the tiny-key
path: at or under `inline_max` bytes the value rides the OM key row
(`put_inline_key`), at or under `needle_max` it goes through the
process-wide `client/slab.SlabPacker` (`OzoneClient.packer`); a GET of
either reads the row or slices the needle out of its slab behind the
needle's CRC gate. With `ratis_clients` (a
`net/ratis_service.RatisClientFactory`) a RATIS key of factor > 1 is
written through the pipeline's Raft ring (`client/ratis_client.py`), as
in the reference. A write handle's `hsync` commits the durable prefix
mid-write (replicated keys; an EC writer refuses it). `file_checksum`
composes the whole-key CRC from the chunk CRCs the datanodes store
(`client/file_checksum.py`); `rename_key`, the fenced `rewrite_key` and
`copy_key` are the `sh key` verbs of the same names. Left out for later
slices: encryption (and so encrypted multipart uploads) and snapshot
paths.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Optional

import numpy as np

from ozone_tpu_torch import admission
from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
from ozone_tpu_torch.client.ec_writer import ECKeyWriter
from ozone_tpu_torch.client.replicated import (
    ReplicatedKeyReader,
    ReplicatedKeyWriter,
)
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.om.om import OpenKeySession, OzoneManager
from ozone_tpu_torch.scm.pipeline import ReplicationType
from ozone_tpu_torch.utils.checksum import ChecksumType
from ozone_tpu_torch.utils.metrics import registry
from ozone_tpu_torch.utils.tracing import Tracer

#: end-to-end client operation latency (PUT and GET histograms)
METRICS = registry("client.ops")


class KeyWriteHandle:
    """Streaming write handle; commits the key on close."""

    def __init__(self, session: OpenKeySession, om: OzoneManager, writer):
        self._session = session
        self._om = om
        self._writer = writer
        self._committed = False

    def write(self, data) -> None:
        self._writer.write(data)

    def hsync(self) -> None:
        """Make everything written so far durable and readable while the
        stream stays open (KeyOutputStream.hsync): flush to the datanodes,
        then commit the key at the synced length with the session kept
        alive. EC keys refuse it, as in the reference."""
        groups = self._writer.hsync()
        with Tracer.instance().span("om:commit", hsync=True):
            self._om.hsync_key(self._session, groups,
                               self._writer.bytes_written)

    def close(self) -> None:
        if self._committed:
            return
        groups = self._writer.close()
        with Tracer.instance().span("om:commit", key=self._session.key):
            self._om.commit_key(self._session, groups,
                                self._writer.bytes_written)
        self._committed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()


class MultipartUpload:
    """Client handle of one multipart upload (the reference's
    createMultipartKey flow): each part streams through the same EC or
    replicated datapath as a whole key, and the complete stitches the
    parts at the OM."""

    def __init__(self, bucket: "OzoneBucket", key: str, upload_id: str):
        self.bucket = bucket
        self.key = key
        self.upload_id = upload_id
        self._etags: dict[int, str] = {}

    def write_part(self, part_number: int, data) -> str:
        om = self.bucket.client.om
        session = om.open_multipart_part(
            self.bucket.volume, self.bucket.name, self.key, self.upload_id)
        writer = self.bucket._make_writer(session)
        # the MD5 reads the caller's buffer in place (no copy of the part)
        view = hostmem.as_array(data)
        etag = hashlib.md5(view).hexdigest()
        writer.write(view)
        groups = writer.close()
        om.commit_multipart_part(session, part_number, groups,
                                 writer.bytes_written, etag)
        self._etags[part_number] = etag
        return etag

    def complete(self, parts: Optional[list[dict]] = None) -> dict:
        if parts is None:
            parts = [{"part_number": n, "etag": self._etags[n]}
                     for n in sorted(self._etags)]
        return self.bucket.client.om.complete_multipart_upload(
            self.bucket.volume, self.bucket.name, self.key, self.upload_id,
            parts)

    def abort(self) -> None:
        self.bucket.client.om.abort_multipart_upload(
            self.bucket.volume, self.bucket.name, self.key, self.upload_id)

    def list_parts(self) -> list[dict]:
        return self.bucket.client.om.list_parts(
            self.bucket.volume, self.bucket.name, self.key, self.upload_id)


class OzoneBucket:
    def __init__(self, client: "OzoneClient", volume: str, name: str):
        self.client = client
        self.volume = volume
        self.name = name
        #: the bucket's small-object thresholds, fetched once (False =
        #: not fetched yet, None = the bucket never opted in)
        self._smallobj = False

    def _make_writer(self, session: OpenKeySession):
        om = self.client.om

        def allocate(excluded, excluded_containers=()):
            return om.allocate_block(session, excluded, excluded_containers)

        if session.replication.type is ReplicationType.EC:
            return ECKeyWriter(
                session.replication.ec,
                allocate,
                self.client.clients,
                block_size=om.block_size,
                checksum=ChecksumType(session.checksum_type),
                bytes_per_checksum=session.bytes_per_checksum,
                device=self.client.device,
                # a gateway's tenant context wins over the client's class
                qos_class=admission.ambient_qos(self.client.qos_class),
            )
        if (session.replication.type is ReplicationType.RATIS
                and session.replication.factor > 1
                and self.client.ratis_clients is not None):
            from ozone_tpu_torch.client.ratis_client import RatisKeyWriter

            return RatisKeyWriter(
                allocate,
                self.client.clients,
                self.client.ratis_clients,
                block_size=om.block_size,
                checksum=ChecksumType(session.checksum_type),
                bytes_per_checksum=session.bytes_per_checksum,
            )
        return ReplicatedKeyWriter(
            allocate,
            self.client.clients,
            block_size=om.block_size,
            checksum=ChecksumType(session.checksum_type),
            bytes_per_checksum=session.bytes_per_checksum,
        )

    def initiate_multipart_upload(
        self, key: str, replication: Optional[str] = None,
        metadata: Optional[dict] = None,
    ) -> MultipartUpload:
        upload_id = self.client.om.initiate_multipart_upload(
            self.volume, self.name, key, replication, metadata=metadata)
        return MultipartUpload(self, key, upload_id)

    def open_key(self, key: str, replication: Optional[str] = None,
                 metadata: Optional[dict] = None) -> KeyWriteHandle:
        om = self.client.om
        with Tracer.instance().span("om:open_key", key=key):
            session = om.open_key(self.volume, self.name, key, replication,
                                  metadata=metadata)
        return KeyWriteHandle(session, om, self._make_writer(session))

    def _smallobj_conf(self) -> Optional[dict]:
        """The bucket's small-object thresholds, fetched once per handle
        (a cached miss keeps the regular PUT at no extra OM call)."""
        if self._smallobj is False:
            from ozone_tpu_torch.client.slab import smallobj_conf

            self._smallobj = smallobj_conf(
                self.client.om.bucket_info(self.volume, self.name))
        return self._smallobj

    def write_key(self, key: str, data,
                  replication: Optional[str] = None,
                  metadata: Optional[dict] = None) -> None:
        # one operation deadline (OZONE_TPU_OP_DEADLINE_S, opt-in) spans
        # the open, every stripe or chunk RPC and the commit
        t0 = time.perf_counter()
        with Tracer.instance().span("client:put", volume=self.volume,
                                    bucket=self.name, key=key) as sp:
            with resilience.start("key_write"):
                # tiny-object routing: only for scheme-default writes on
                # an opted-in bucket (an explicit per-key replication
                # always takes the stripe path)
                conf = None if replication else self._smallobj_conf()
                if conf is not None:
                    raw = (data.tobytes() if isinstance(data, np.ndarray)
                           else bytes(data))
                    if len(raw) <= conf["inline_max"]:
                        self.client.om.put_inline_key(
                            self.volume, self.name, key, raw,
                            metadata=metadata)
                        raw = None
                    elif len(raw) <= conf["needle_max"]:
                        self.client.packer.put(
                            self.volume, self.name, key, raw,
                            metadata=metadata)
                        raw = None
                    if raw is None:
                        METRICS.histogram("put_seconds").observe(
                            time.perf_counter() - t0, sp.trace_id)
                        return
                with self.open_key(key, replication,
                                   metadata=metadata) as h:
                    h.write(data)
        METRICS.histogram("put_seconds").observe(
            time.perf_counter() - t0, sp.trace_id)

    def lookup_key_info(self, key: str) -> dict:
        """The key's info row (snapshot paths are not ported)."""
        return self.client.om.lookup_key(self.volume, self.name, key)

    def read_key(self, key: str) -> np.ndarray:
        return self.read_key_info(self.lookup_key_info(key))

    def read_key_info(self, info: dict) -> np.ndarray:
        """A key's bytes from already-fetched key info."""
        return self.read_key_info_range(info, 0, int(info["size"]))

    def read_key_range(self, key: str, offset: int,
                       length: int) -> np.ndarray:
        """Positioned read of [offset, offset+length) in key space."""
        return self.read_key_info_range(
            self.client.om.lookup_key(self.volume, self.name, key),
            offset, length)

    def read_key_info_range(self, info: dict, offset: int,
                            length: int) -> np.ndarray:
        """Positioned read: only the block groups, and within them only
        the cells or chunks, that cover [offset, offset+length) are
        read."""
        size = int(info["size"])
        if offset < 0 or length < 0 or offset + length > size:
            raise ValueError(f"range [{offset},{offset + length}) out of "
                             f"bounds for size {size}")
        if info.get("encryption"):
            raise ValueError("encrypted keys are not served by this port")
        t0 = time.perf_counter()
        with Tracer.instance().span("client:get", volume=self.volume,
                                    bucket=self.name,
                                    key=info.get("name", ""),
                                    bytes=length) as sp:
            with resilience.start("key_read"):
                if info.get("inline") is not None:
                    out = self._read_inline(info, offset, length)
                elif info.get("needle"):
                    out = self._read_needle(info, offset, length)
                else:
                    out = self._read_groups_range(info, offset, length)
        METRICS.histogram("get_seconds").observe(
            time.perf_counter() - t0, sp.trace_id)
        return out

    @staticmethod
    def _read_inline(info: dict, offset: int, length: int) -> np.ndarray:
        """An inline value's GET: the bytes rode the OM key row."""
        import base64

        from ozone_tpu_torch.client.slab import METRICS as SMALLOBJ

        raw = base64.b64decode(info["inline"])
        SMALLOBJ.counter("inline_gets").inc()
        return np.frombuffer(raw, np.uint8)[offset:offset + length].copy()

    def _read_needle(self, info: dict, offset: int,
                     length: int) -> np.ndarray:
        """A needle's GET: the whole needle is sliced out of its slab with
        ranged group reads, so its commit-time CRC can gate the answer; a
        torn or mis-pointed needle is an error, never bytes."""
        from ozone_tpu_torch.client.slab import (
            METRICS as SMALLOBJ,
            NEEDLE_CRC_MISMATCH,
        )
        from ozone_tpu_torch.om.requests import OMError
        from ozone_tpu_torch.utils.checksum import crc32c

        nd = info["needle"]
        whole = self._read_groups_range(info, int(nd["offset"]),
                                        int(nd["length"]))
        if int(crc32c(whole)) != int(nd["crc"]):
            SMALLOBJ.counter("needle_crc_errors").inc()
            raise OMError(
                NEEDLE_CRC_MISMATCH,
                f"needle {info.get('key', '')} in slab {nd['slab']} "
                f"failed its CRC gate")
        SMALLOBJ.counter("needle_gets").inc()
        return whole[offset:offset + length].copy()

    def _read_groups_range(self, info: dict, offset: int,
                           length: int) -> np.ndarray:
        parts: list[np.ndarray] = []
        pos = 0  # the current group's start offset in key space
        for g in self.client.om.key_block_groups(info):
            a = max(offset, pos)
            b = min(offset + length, pos + g.length)
            if a < b:
                if g.pipeline.replication.type is ReplicationType.EC:
                    reader = ECBlockGroupReader(
                        g,
                        g.pipeline.replication.ec,
                        self.client.clients,
                        checksum=ChecksumType(
                            info.get("checksum_type", "CRC32C")),
                        bytes_per_checksum=info.get(
                            "bytes_per_checksum", 16 * 1024),
                        device=self.client.device,
                        qos_class=admission.ambient_qos(
                            self.client.qos_class),
                    )
                else:
                    reader = ReplicatedKeyReader(g, self.client.clients)
                parts.append(reader.read(a - pos, b - a))
            pos += g.length
        out = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        if out.size != length:
            raise ValueError(f"key groups cover {out.size} of {length} B")
        return out

    def file_checksum(self, key: str) -> dict:
        """Composite whole-key checksum from the stored chunk CRCs; no
        data is read (getFileChecksum)."""
        from ozone_tpu_torch.client.file_checksum import file_checksum

        return file_checksum(self.client, self.volume, self.name, key)

    def rewrite_key(self, key: str, replication: str) -> None:
        """Re-write a key's data in place under another replication config
        (`sh key rewrite`). Fenced: the commit carries the source's object
        id and generation, and a key overwritten meanwhile refuses it with
        KEY_MODIFIED, its new blocks discarded."""
        info = self.client.om.lookup_key(self.volume, self.name, key)
        data = self.read_key_info(info)
        h = self.open_key(key, replication, metadata=info.get("metadata"))
        h._session.expect_object_id = info.get("object_id", "")
        h._session.expect_generation = int(info.get("generation", 0))
        h.write(data)
        h.close()

    def copy_key(self, key: str, dst_bucket: "OzoneBucket", dst_key: str,
                 replication: Optional[str] = None) -> None:
        """Key copy (`sh key cp`): read once, write under the destination
        bucket's (or an explicit) replication config."""
        info = self.client.om.lookup_key(self.volume, self.name, key)
        dst_bucket.write_key(dst_key, self.read_key_info(info),
                             replication=replication,
                             metadata=info.get("metadata"))

    def delete_key(self, key: str) -> None:
        self.client.om.delete_key(self.volume, self.name, key)

    def rename_key(self, key: str, new_key: str) -> None:
        self.client.om.rename_key(self.volume, self.name, key, new_key)

    def list_keys(self, prefix: str = "") -> list[dict]:
        return self.client.om.list_keys(self.volume, self.name, prefix)


class OzoneVolume:
    def __init__(self, client: "OzoneClient", name: str):
        self.client = client
        self.name = name

    def create_bucket(self, bucket: str,
                      replication: str = "rs-6-3-1024k") -> OzoneBucket:
        self.client.om.create_bucket(self.name, bucket, replication)
        return OzoneBucket(self.client, self.name, bucket)

    def get_bucket(self, bucket: str) -> OzoneBucket:
        self.client.om.bucket_info(self.name, bucket)
        return OzoneBucket(self.client, self.name, bucket)

    def list_buckets(self) -> list[dict]:
        return self.client.om.list_buckets(self.name)


class OzoneClient:
    """Entry point (the ObjectStore analog). `om` is an `OzoneManager` or a
    remote OM client; `device` is where the EC writers and readers run the
    codec; `qos_class` the codec service's scheduling class of this
    client's batches; `ratis_clients` (optional) orders RATIS/THREE writes
    through the pipeline's Raft ring."""

    def __init__(self, om: OzoneManager, clients: DatanodeClientFactory,
                 device="cuda", qos_class: str = "interactive",
                 ratis_clients=None):
        self.om = om
        self.clients = clients
        self.ratis_clients = ratis_clients
        self.device = resolve_device(device)
        self.qos_class = qos_class
        self._packer = None
        self._packer_lock = threading.Lock()

    @property
    def packer(self):
        """The process-wide needle packer, started on the first small PUT;
        its flushes ride the codec service's bulk class on this client's
        device."""
        with self._packer_lock:  # concurrent first PUTs share one packer
            if self._packer is None:
                from ozone_tpu_torch.client.slab import SlabPacker

                self._packer = SlabPacker(self.om, self.clients,
                                          qos_class="bulk",
                                          device=self.device)
            return self._packer

    def create_volume(self, volume: str) -> OzoneVolume:
        self.om.create_volume(volume)
        return OzoneVolume(self, volume)

    def get_volume(self, volume: str) -> OzoneVolume:
        self.om.volume_info(volume)
        return OzoneVolume(self, volume)

    def list_volumes(self) -> list[dict]:
        return self.om.list_volumes()
