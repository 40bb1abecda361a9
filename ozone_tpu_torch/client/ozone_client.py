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
addresses the OM's answers carry. Left out for later slices: the Raft-ordered replicated
writer, small objects (inline values and slabs), multipart uploads,
encryption, snapshot paths, admission QoS, file checksums, rename,
rewrite and copy.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
from ozone_tpu_torch.client.ec_writer import ECKeyWriter
from ozone_tpu_torch.client.replicated import (
    ReplicatedKeyReader,
    ReplicatedKeyWriter,
)
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


class OzoneBucket:
    def __init__(self, client: "OzoneClient", volume: str, name: str):
        self.client = client
        self.volume = volume
        self.name = name

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
                qos_class=self.client.qos_class,
            )
        return ReplicatedKeyWriter(
            allocate,
            self.client.clients,
            block_size=om.block_size,
            checksum=ChecksumType(session.checksum_type),
            bytes_per_checksum=session.bytes_per_checksum,
        )

    def open_key(self, key: str,
                 replication: Optional[str] = None) -> KeyWriteHandle:
        om = self.client.om
        with Tracer.instance().span("om:open_key", key=key):
            session = om.open_key(self.volume, self.name, key, replication)
        return KeyWriteHandle(session, om, self._make_writer(session))

    def write_key(self, key: str, data,
                  replication: Optional[str] = None) -> None:
        # one operation deadline (OZONE_TPU_OP_DEADLINE_S, opt-in) spans
        # the open, every stripe or chunk RPC and the commit
        t0 = time.perf_counter()
        with Tracer.instance().span("client:put", volume=self.volume,
                                    bucket=self.name, key=key) as sp:
            with resilience.start("key_write"):
                with self.open_key(key, replication) as h:
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
        if info.get("inline") is not None or info.get("needle") \
                or info.get("encryption"):
            raise ValueError("small-object and encrypted keys are not "
                             "served by this port")
        t0 = time.perf_counter()
        with Tracer.instance().span("client:get", volume=self.volume,
                                    bucket=self.name,
                                    key=info.get("name", ""),
                                    bytes=length) as sp:
            with resilience.start("key_read"):
                out = self._read_groups_range(info, offset, length)
        METRICS.histogram("get_seconds").observe(
            time.perf_counter() - t0, sp.trace_id)
        return out

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
                        qos_class=self.client.qos_class,
                    )
                else:
                    reader = ReplicatedKeyReader(g, self.client.clients)
                parts.append(reader.read(a - pos, b - a))
            pos += g.length
        out = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        if out.size != length:
            raise ValueError(f"key groups cover {out.size} of {length} B")
        return out

    def delete_key(self, key: str) -> None:
        self.client.om.delete_key(self.volume, self.name, key)

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
    client's batches."""

    def __init__(self, om: OzoneManager, clients: DatanodeClientFactory,
                 device="cuda", qos_class: str = "interactive"):
        self.om = om
        self.clients = clients
        self.device = resolve_device(device)
        self.qos_class = qos_class

    def create_volume(self, volume: str) -> OzoneVolume:
        self.om.create_volume(volume)
        return OzoneVolume(self, volume)

    def get_volume(self, volume: str) -> OzoneVolume:
        self.om.volume_info(volume)
        return OzoneVolume(self, volume)

    def list_volumes(self) -> list[dict]:
        return self.om.list_volumes()
