"""Core storage identifiers and metadata records.

Mirrors the reference's id model: containers hold blocks, blocks hold
chunks (README.md "Ozone consists of volumes, buckets, and keys" +
container/block/chunk hierarchy in hadoop-hdds). BlockID = (container_id,
local_id) as in hdds ContainerBlockID; EC adds a per-container replica
index (hdds.proto ECReplicationConfig/replicaIndex usage).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from ozone_tpu_torch.utils.checksum import ChecksumData, ChecksumType


@dataclass(frozen=True, order=True)
class BlockID:
    container_id: int
    local_id: int

    def __str__(self) -> str:
        return f"blk_{self.container_id}_{self.local_id}"

    def to_json(self) -> dict:
        return {"container_id": self.container_id, "local_id": self.local_id}

    @classmethod
    def from_json(cls, d: dict) -> "BlockID":
        return cls(int(d["container_id"]), int(d["local_id"]))


class ContainerState(Enum):
    """Container lifecycle (DatanodeClientProtocol.proto:256-264 State enum;
    SCM-side lifecycle OPEN->CLOSING->QUASI_CLOSED/CLOSED->DELETED in
    server-scm ContainerStateManagerImpl)."""

    OPEN = "OPEN"
    CLOSING = "CLOSING"
    QUASI_CLOSED = "QUASI_CLOSED"
    CLOSED = "CLOSED"
    UNHEALTHY = "UNHEALTHY"
    INVALID = "INVALID"
    DELETED = "DELETED"
    RECOVERING = "RECOVERING"


@dataclass(frozen=True)
class ChunkInfo:
    """One chunk of a block: name, offset within the block, length, checksum
    (reference ContainerProtos ChunkInfo message)."""

    name: str
    offset: int
    length: int
    checksum: ChecksumData = field(
        default_factory=lambda: ChecksumData(ChecksumType.NONE, 0)
    )

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "offset": self.offset,
            "length": self.length,
            "checksum": self.checksum.to_lists(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "ChunkInfo":
        return cls(
            d["name"],
            int(d["offset"]),
            int(d["length"]),
            ChecksumData.from_lists(d["checksum"]),
        )


@dataclass
class BlockData:
    """Block metadata stored in the container DB: chunk list + total length
    (reference container keyvalue BlockData / BlockManagerImpl.java:54)."""

    block_id: BlockID
    chunks: list[ChunkInfo] = field(default_factory=list)
    # length of the logical block group this block belongs to (EC putBlock
    # carries blockGroupLength, ECBlockOutputStream.java:103-195)
    block_group_length: Optional[int] = None
    committed: bool = False

    @property
    def length(self) -> int:
        return sum(c.length for c in self.chunks)

    def to_json(self) -> dict:
        return {
            "block_id": self.block_id.to_json(),
            "chunks": [c.to_json() for c in self.chunks],
            "block_group_length": self.block_group_length,
            "committed": self.committed,
        }

    @classmethod
    def from_json(cls, d: dict) -> "BlockData":
        return cls(
            BlockID.from_json(d["block_id"]),
            [ChunkInfo.from_json(c) for c in d["chunks"]],
            d.get("block_group_length"),
            bool(d.get("committed", False)),
        )


class StorageError(Exception):
    """Dispatcher-level error with a result code mirroring
    DatanodeClientProtocol.proto Result enum."""

    def __init__(self, code: str, msg: str = ""):
        super().__init__(f"{code}: {msg}" if msg else code)
        self.code = code
        self.msg = msg  # bare message for re-wrapping without code stacking


# Result codes (subset of DatanodeClientProtocol.proto Result)
CONTAINER_NOT_FOUND = "CONTAINER_NOT_FOUND"
CONTAINER_EXISTS = "CONTAINER_EXISTS"
NO_SUCH_BLOCK = "NO_SUCH_BLOCK"
CHECKSUM_MISMATCH = "CHECKSUM_MISMATCH"
CLOSED_CONTAINER_IO = "CLOSED_CONTAINER_IO"
INVALID_CONTAINER_STATE = "INVALID_CONTAINER_STATE"
IO_EXCEPTION = "IO_EXCEPTION"
INVALID_WRITE_SIZE = "INVALID_WRITE_SIZE"
# a second writer tried to stream into a block file another writer owns
# (ChunkUtils.validateChunkForOverwrite analog, ChunkUtils.java:285-312):
# defense in depth under the commit-first SCM allocator — a duplicate
# (container, local_id) can no longer be issued, and even if one were,
# the datanode refuses to interleave two writers' bytes
BLOCK_WRITE_CONFLICT = "BLOCK_WRITE_CONFLICT"
# a refused block or container capability token (BlockTokenVerifier.java);
# every datanode lane answers it: the RPC verbs, the native sidecar and
# the raft pipelines' Submit
BLOCK_TOKEN_VERIFICATION_FAILED = "BLOCK_TOKEN_VERIFICATION_FAILED"
