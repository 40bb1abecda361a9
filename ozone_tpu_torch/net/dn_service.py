"""Datanode RPC service and its remote client.

Port of `ozone_tpu/net/dn_service.py` (the reference's
DatanodeClientProtocol verbs served the way XceiverServerGrpc ->
HddsDispatcher does): `DatanodeRpcService` is `DatanodeGrpcService` and
`RpcDatanodeClient` is `GrpcDatanodeClient`, with the same method names
on the wire. The client is a drop-in datanode client
(`client/dn_client.py`), so the EC writer, reader and reconstruction
coordinator work unchanged across processes. `GetDatapathInfo` answers
the native datapath sidecar's port and unix socket
(`storage/fast_datapath.py`), which `client/native_dn.py` takes for the
bulk verbs. Left out: block and container tokens, layout-version gating
and the replication throttle.
"""

from __future__ import annotations

import numpy as np

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import RpcChannel, RpcServer
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import (
    BlockData,
    BlockID,
    ChunkInfo,
    ContainerState,
    StorageError,
)
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

SERVICE = "ozone.tpu.DatanodeService"

#: frames of a container tarball on the wire
_EXPORT_FRAME = 4 * 1024 * 1024


class DatanodeRpcService:
    """The HddsDispatcher boundary: every externally reachable verb."""

    def __init__(self, dn: Datanode, server: RpcServer, datapath_port=None):
        self.dn = dn
        #: callable() -> the native sidecar's advertisement ({"port",
        #: "uds"}) or None: clients discover the native lane through
        #: GetDatapathInfo and take the RPC verbs when it answers no port
        self.datapath_port = datapath_port
        server.add_service(
            SERVICE,
            {
                "GetDatapathInfo": self._datapath_info,
                "CreateContainer": self._create_container,
                "CloseContainer": self._close_container,
                "DeleteContainer": self._delete_container,
                "WriteChunk": self._write_chunk,
                "ReadChunk": self._read_chunk,
                "PutBlock": self._put_block,
                "GetBlock": self._get_block,
                "ListBlock": self._list_block,
                "GetCommittedBlockLength": self._committed_len,
                "DeleteBlock": self._delete_block,
                "Echo": lambda req: req,
            },
            stream_methods={
                "StreamWriteBlock": self._stream_write_block,
                "WriteChunksCommit": self._write_chunks_commit,
                "ImportContainer": self._import_container,
            },
            server_stream_methods={
                "ExportContainer": self._export_container,
                "ReadChunks": self._read_chunks,
            },
        )

    def _stream_write_block(self, frames) -> bytes:
        """Streaming block write (the Ratis DataStream path): frame 0 is the
        header {block_id, chunk_size, sync, checksum_type,
        bytes_per_checksum}, every later frame a raw payload slab. Chunks
        are cut here at chunk_size and written as they arrive, and one
        PutBlock commits them; the answer is the committed BlockData."""
        self._count_chunk_call()
        it = iter(frames)
        header, _ = wire.unpack(next(it))
        block_id = BlockID.from_json(header["block_id"])
        chunk_size = int(header.get("chunk_size", 4 * 1024 * 1024))
        if chunk_size <= 0:
            raise StorageError("INVALID_ARGUMENT",
                               f"chunk_size must be positive: {chunk_size}")
        sync = bool(header.get("sync", False))
        cksum = Checksum(ChecksumType(header.get("checksum_type", "CRC32C")),
                         int(header.get("bytes_per_checksum", 16 * 1024)))
        chunks: list[ChunkInfo] = []
        offset = 0
        # slabs are held as views and cut at chunk boundaries: a chunk
        # inside one slab is never copied, a chunk straddling slabs is
        # joined once (counted)
        pending: list[memoryview] = []
        pending_bytes = 0

        def cut(n: int) -> np.ndarray:
            nonlocal pending_bytes
            take: list[memoryview] = []
            need = n
            while need:
                v = pending[0]
                if len(v) <= need:
                    take.append(pending.pop(0))
                    need -= len(v)
                else:
                    take.append(v[:need])
                    pending[0] = v[need:]
                    need = 0
            pending_bytes -= n
            if len(take) == 1:
                return hostmem.as_array(take[0])
            hostmem.count_copy(n, site="dn_service._stream_write_block",
                               warn=False)
            return hostmem.as_array(b"".join(take))

        def flush(final: bool) -> None:
            nonlocal offset
            while pending_bytes >= chunk_size or (final and pending_bytes):
                part = cut(min(chunk_size, pending_bytes))
                info = ChunkInfo(name=f"{block_id}_chunk_{len(chunks)}",
                                 offset=offset, length=int(part.size),
                                 checksum=cksum.compute(part))
                self.dn.write_chunk(block_id, info, part, sync=sync,
                                    writer=header.get("writer"))
                chunks.append(info)
                offset += int(part.size)

        for frame in it:
            if len(frame):
                pending.append(memoryview(frame).cast("B"))
                pending_bytes += len(frame)
            flush(final=False)
        flush(final=True)
        bd = BlockData(block_id, chunks)
        self.dn.put_block(bd, sync=sync, writer=header.get("writer"))
        return wire.pack({"block": bd.to_json()})

    def _write_chunks_commit(self, frames) -> bytes:
        """Chunk writes with a piggybacked block commit in one client
        stream: frame 0 is the header {block_id, writer?, sync?, commit?},
        every later frame wire.pack({chunk}, payload). The client cut the
        chunks and computed their checksums; the commit applies only after
        every chunk landed."""
        self._count_chunk_call()
        it = iter(frames)
        header, _ = wire.unpack(next(it))
        block_id = BlockID.from_json(header["block_id"])
        sync = bool(header.get("sync", False))
        writer = header.get("writer")
        self.dn.metrics.counter("batched_write_streams").inc()
        n_chunks = 0
        for frame in it:
            m, payload = wire.unpack(frame)
            self.dn.write_chunk(block_id, ChunkInfo.from_json(m["chunk"]),
                                wire.payload_array(payload), sync=sync,
                                writer=writer)
            n_chunks += 1
        self.dn.metrics.counter("batched_write_chunks").inc(n_chunks)
        commit = header.get("commit")
        if commit is not None:
            bd = BlockData.from_json(commit)
            if bd.block_id != block_id:
                raise StorageError(
                    "INVALID_ARGUMENT",
                    f"commit names {bd.block_id}, stream wrote {block_id}")
            self.dn.put_block(bd, sync=sync, writer=writer)
        return wire.pack({})

    def _count_chunk_call(self) -> None:
        """Chunk bytes served over the RPC (the native lane's streams are
        counted by the sidecar)."""
        self.dn.metrics.counter("rpc_chunk_calls").inc()

    def _datapath_info(self, req) -> bytes:
        v = self.datapath_port() if self.datapath_port else None
        return wire.pack(v if isinstance(v, dict) else {"port": v})

    def _create_container(self, req) -> bytes:
        m, _ = wire.unpack(req)
        self.dn.create_container(m["container_id"], m.get("replica_index", 0),
                                 ContainerState(m.get("state", "OPEN")))
        return wire.pack({})

    def _close_container(self, req) -> bytes:
        m, _ = wire.unpack(req)
        self.dn.close_container(m["container_id"])
        return wire.pack({})

    def _delete_container(self, req) -> bytes:
        m, _ = wire.unpack(req)
        self.dn.delete_container(m["container_id"], m.get("force", False))
        return wire.pack({})

    def _write_chunk(self, req) -> bytes:
        self._count_chunk_call()
        m, payload = wire.unpack(req)
        self.dn.write_chunk(BlockID.from_json(m["block_id"]),
                            ChunkInfo.from_json(m["chunk"]),
                            wire.payload_array(payload),
                            sync=m.get("sync", False), writer=m.get("writer"))
        return wire.pack({})

    def _export_container(self, req):
        """The packed container streamed in frames (the replication
        download stream): a header frame {container_id, size,
        compression}, then the tarball. The codec is negotiated from the
        client's `accept` list."""
        from ozone_tpu_torch.storage.container_packer import (
            export_container,
            negotiate_codec,
        )

        m, _ = wire.unpack(req)
        c = self.dn.containers.get(int(m["container_id"]))
        if "accept" in m:
            codec = negotiate_codec(m["accept"])
        else:
            codec = "gzip" if m.get("compress", True) else "none"
        data = memoryview(export_container(c, compression=codec))
        yield wire.pack({"container_id": c.id, "size": len(data),
                         "compression": codec})
        for off in range(0, len(data), _EXPORT_FRAME):
            yield data[off:off + _EXPORT_FRAME]

    def _import_container(self, frames) -> bytes:
        """Unpack a client-streamed container tarball onto this datanode:
        frame 0 carries the metadata, the rest the tarball."""
        from ozone_tpu_torch.storage.container_packer import import_container

        it = iter(frames)
        m, _ = wire.unpack(next(it))
        data = b"".join(it)  # one assembly copy
        c = import_container(self.dn, data,
                             replica_index=m.get("replica_index"),
                             expect_id=m.get("container_id"))
        return wire.pack({"container_id": c.id})

    def _read_chunk(self, req):
        self._count_chunk_call()
        m, _ = wire.unpack(req)
        data = self.dn.read_chunk(BlockID.from_json(m["block_id"]),
                                  ChunkInfo.from_json(m["chunk"]),
                                  verify=m.get("verify", False))
        return wire.pack_parts({}, data)

    def _read_chunks(self, req):
        """Server-streamed batch read: one payload frame per named chunk,
        in request order (the read-side twin of WriteChunksCommit)."""
        self._count_chunk_call()
        m, _ = wire.unpack(req)
        block_id = BlockID.from_json(m["block_id"])
        verify = m.get("verify", False)
        self.dn.metrics.counter("batched_read_streams").inc()
        self.dn.metrics.counter("batched_read_chunks").inc(len(m["chunks"]))
        for ch in m["chunks"]:
            data = self.dn.read_chunk(block_id, ChunkInfo.from_json(ch),
                                      verify=verify)
            yield wire.pack_parts({}, data)

    def _put_block(self, req) -> bytes:
        m, _ = wire.unpack(req)
        self.dn.put_block(BlockData.from_json(m["block"]),
                          sync=m.get("sync", False), writer=m.get("writer"))
        return wire.pack({})

    def _get_block(self, req) -> bytes:
        m, _ = wire.unpack(req)
        bd = self.dn.get_block(BlockID.from_json(m["block_id"]))
        return wire.pack({"block": bd.to_json()})

    def _list_block(self, req) -> bytes:
        m, _ = wire.unpack(req)
        blocks = self.dn.list_blocks(m["container_id"])
        return wire.pack({"blocks": [b.to_json() for b in blocks]})

    def _committed_len(self, req) -> bytes:
        m, _ = wire.unpack(req)
        n = self.dn.get_committed_block_length(BlockID.from_json(m["block_id"]))
        return wire.pack({"length": n})

    def _delete_block(self, req) -> bytes:
        m, _ = wire.unpack(req)
        self.dn.delete_block(BlockID.from_json(m["block_id"]))
        return wire.pack({})


class RpcDatanodeClient:
    """Remote datanode client (the ECXceiverClientGrpc analog)."""

    #: per-verb default timeouts, capped by the ambient operation deadline
    _UNARY_TIMEOUT_S = 30.0
    _STREAM_TIMEOUT_S = 120.0
    _BULK_STREAM_TIMEOUT_S = 300.0

    def __init__(self, dn_id: str, address: str):
        self.dn_id = dn_id
        self.address = address
        self._ch = RpcChannel(address)

    def _call(self, method: str, meta: dict,
              payload=None) -> tuple[dict, memoryview]:
        resp = self._ch.call(
            SERVICE, method, wire.pack_parts(meta, payload),
            timeout=resilience.op_timeout(self._UNARY_TIMEOUT_S, method))
        return wire.unpack(resp)

    def create_container(self, container_id, replica_index=0,
                         state=ContainerState.OPEN):
        self._call("CreateContainer", {"container_id": container_id,
                                       "replica_index": replica_index,
                                       "state": state.value})

    def close_container(self, container_id):
        self._call("CloseContainer", {"container_id": container_id})

    def delete_container(self, container_id, force=False):
        self._call("DeleteContainer", {"container_id": container_id,
                                       "force": force})

    def write_chunk(self, block_id, info, data, sync=False, writer=None):
        m = {"block_id": block_id.to_json(), "chunk": info.to_json(),
             "sync": sync}
        if writer is not None:
            m["writer"] = writer
        self._call("WriteChunk", m, hostmem.as_array(data))

    def read_chunk(self, block_id, info, verify=False):
        _, payload = self._call("ReadChunk", {
            "block_id": block_id.to_json(), "chunk": info.to_json(),
            "verify": verify})
        # a view over the response buffer, no copy
        return wire.payload_array(payload)

    def read_chunks(self, block_id, infos, verify=False):
        """Batch read: one server-streamed call returns every chunk of
        `infos`, in order."""
        frames = self._ch.call_server_stream(
            SERVICE, "ReadChunks",
            wire.pack({"block_id": block_id.to_json(),
                       "chunks": [i.to_json() for i in infos],
                       "verify": verify}),
            timeout=resilience.op_timeout(self._BULK_STREAM_TIMEOUT_S,
                                          "ReadChunks"))
        out = [wire.payload_array(wire.unpack(f)[1]) for f in frames]
        if len(out) != len(infos):
            raise StorageError(
                "IO_EXCEPTION",
                f"ReadChunks returned {len(out)}/{len(infos)} frames")
        return out

    def put_block(self, block, sync=False, writer=None):
        m = {"block": block.to_json(), "sync": sync}
        if writer is not None:
            m["writer"] = writer
        self._call("PutBlock", m)

    def get_block(self, block_id):
        m, _ = self._call("GetBlock", {"block_id": block_id.to_json()})
        return BlockData.from_json(m["block"])

    def list_blocks(self, container_id):
        m, _ = self._call("ListBlock", {"container_id": container_id})
        return [BlockData.from_json(b) for b in m["blocks"]]

    def get_committed_block_length(self, block_id):
        m, _ = self._call("GetCommittedBlockLength",
                          {"block_id": block_id.to_json()})
        return m["length"]

    def delete_block(self, block_id):
        self._call("DeleteBlock", {"block_id": block_id.to_json()})

    def export_container(self, container_id: int,
                         compress: bool = True) -> bytes:
        """Download the packed container, streamed in frames."""
        from ozone_tpu_torch.storage.container_packer import available_codecs

        frames = iter(self._ch.call_server_stream(
            SERVICE, "ExportContainer",
            wire.pack({"container_id": container_id, "compress": compress,
                       "accept": (list(available_codecs()) if compress
                                  else ["none"])}),
            timeout=resilience.op_timeout(self._BULK_STREAM_TIMEOUT_S,
                                          "ExportContainer")))
        wire.unpack(next(frames))  # header: {container_id, size, compression}
        return b"".join(frames)  # one assembly copy

    def import_container(self, data: bytes, replica_index=None,
                         container_id=None) -> int:
        """Upload and unpack a container tarball, streamed in frames;
        `container_id` makes the server check the tarball is that
        container."""
        meta = {"replica_index": replica_index}
        if container_id is not None:
            meta["container_id"] = int(container_id)
        view = memoryview(data)

        def frames():
            yield wire.pack(meta)
            for off in range(0, len(view), _EXPORT_FRAME):
                yield view[off:off + _EXPORT_FRAME]

        out = self._ch.call_streaming(
            SERVICE, "ImportContainer", frames(),
            timeout=resilience.op_timeout(self._BULK_STREAM_TIMEOUT_S,
                                          "ImportContainer"))
        return int(wire.unpack(out)[0]["container_id"])

    def stream_write_block(self, block_id, data_frames,
                           chunk_size=4 * 1024 * 1024, sync=False,
                           checksum_type="CRC32C",
                           bytes_per_checksum=16 * 1024):
        """Streaming write of a whole block: `data_frames` yields slabs of
        any size; returns the committed BlockData (one ack for the
        block)."""

        def frames():
            yield wire.pack({"block_id": block_id.to_json(),
                             "chunk_size": chunk_size, "sync": sync,
                             "checksum_type": checksum_type,
                             "bytes_per_checksum": bytes_per_checksum})
            # slabs go out as views: the socket sends them as they are
            yield from data_frames

        resp = self._ch.call_streaming(
            SERVICE, "StreamWriteBlock", frames(),
            timeout=resilience.op_timeout(self._STREAM_TIMEOUT_S,
                                          "StreamWriteBlock"))
        return BlockData.from_json(wire.unpack(resp)[0]["block"])

    def write_chunks_commit(self, block_id, chunks, commit=None,
                            sync=False, writer=None):
        """Write `chunks` ([(ChunkInfo, payload)]) and optionally commit
        `commit` (a BlockData) in one round trip."""
        meta = {"block_id": block_id.to_json(), "sync": sync}
        if writer is not None:
            meta["writer"] = writer
        if commit is not None:
            meta["commit"] = commit.to_json()

        def frames():
            yield wire.pack(meta)
            for info, data in chunks:
                yield wire.pack_parts({"chunk": info.to_json()},
                                      hostmem.as_array(data))

        self._ch.call_streaming(
            SERVICE, "WriteChunksCommit", frames(),
            timeout=resilience.op_timeout(self._STREAM_TIMEOUT_S,
                                          "WriteChunksCommit"))

    def echo(self, data: bytes = b"ping") -> bytes:
        return bytes(self._ch.call(SERVICE, "Echo", data))

    def close(self):
        self._ch.close()
