"""Shard map: the root ring's partition table for the sharded OM plane.

Port of `ozone_tpu/om/sharding/shardmap.py`. The namespace is
hash-partitioned across N independent meta rings by (volume, bucket):
`crc32(volume/bucket) % SLOT_COUNT` picks one of a fixed number of
slots, and the epoch-numbered shard map assigns every slot to exactly
one shard. The map lives in the root ring; clients cache it and refresh
on a `SHARD_MOVED` rejection.

Ownership is enforced server-side: every shard replica carries its own
replicated `system/shard_config` row (installed through its ring, so
followers converge with the log) and rejects any bucket-addressed
request whose slot it does not own. A stale client map therefore cannot
read or write through a moved slot: the rejection is the cache
invalidation signal. `ImportRow` writes its row through the store's
update journal as any put does, as in the reference: a geo shipper
tailing the receiving shard sees a migrated key as a new commit.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Optional

from ozone_tpu_torch.om.requests import INVALID_REQUEST, OMError, OMRequest

#: fixed slot count: small enough that the map is a trivial row, large
#: enough to rebalance in slot-granular moves (64 slots over <= 16
#: shards keeps every shard within 1 slot of the mean)
SLOT_COUNT = 64

#: rejection code for a request that landed on a shard that does not
#: own the (volume, bucket) slot; the message carries the rejecting
#: replica's config epoch so clients can tell stale-map from split-brain
SHARD_MOVED = "SHARD_MOVED"


def slot_for(volume: str, bucket: str, slot_count: int = SLOT_COUNT) -> int:
    """Stable slot for a (volume, bucket) pair. crc32, not hash(), so
    every process, replica and client agrees across restarts."""
    return zlib.crc32(f"{volume}/{bucket}".encode()) % slot_count


@dataclass
class ShardMap:
    """Epoch-numbered slot -> shard assignment (the root ring row)."""

    epoch: int
    shards: list[str]  # shard ids, index = slot value domain
    slots: list[int] = field(default_factory=list)  # slot -> shards idx
    #: shard id -> comma-joined "host:port,host:port" replica list
    #: (empty for in-process planes that route by object, not address)
    addresses: dict[str, str] = field(default_factory=dict)

    @classmethod
    def uniform(cls, shards: list[str], epoch: int = 1,
                addresses: Optional[dict[str, str]] = None,
                slot_count: int = SLOT_COUNT) -> "ShardMap":
        """Round-robin every slot over the shard list."""
        return cls(epoch=epoch, shards=list(shards),
                   slots=[i % len(shards) for i in range(slot_count)],
                   addresses=dict(addresses or {}))

    @property
    def slot_count(self) -> int:
        return len(self.slots)

    def shard_for(self, volume: str, bucket: str) -> str:
        return self.shards[self.slots[slot_for(volume, bucket,
                                               len(self.slots))]]

    def owned_slots(self, shard_id: str) -> list[int]:
        idx = self.shards.index(shard_id)
        return [s for s, owner in enumerate(self.slots) if owner == idx]

    def move_slot(self, slot: int, shard_id: str) -> "ShardMap":
        """A rebalance step: reassign one slot, bump the epoch."""
        slots = list(self.slots)
        slots[slot] = self.shards.index(shard_id)
        return ShardMap(epoch=self.epoch + 1, shards=list(self.shards),
                        slots=slots, addresses=dict(self.addresses))

    def to_json(self) -> dict:
        return {"epoch": self.epoch, "shards": list(self.shards),
                "slots": list(self.slots),
                "addresses": dict(self.addresses)}

    @classmethod
    def from_json(cls, d: dict) -> "ShardMap":
        return cls(epoch=d["epoch"], shards=list(d["shards"]),
                   slots=list(d["slots"]),
                   addresses=dict(d.get("addresses") or {}))


@dataclass
class InstallShardMap(OMRequest):
    """Root-ring request: publish a new shard map (replicated, so every
    root replica serves the same map at the same epoch)."""

    map_json: dict

    def apply(self, store):
        cur = store.get("system", "shard_map")
        if cur is not None and self.map_json["epoch"] <= cur["epoch"]:
            if self.map_json == cur:
                return cur  # idempotent re-install (log replay)
            raise OMError(
                INVALID_REQUEST,
                f"shard map epoch {self.map_json['epoch']} <= "
                f"current {cur['epoch']}")
        store.put("system", "shard_map", dict(self.map_json))
        return dict(self.map_json)


@dataclass
class InstallShardConfig(OMRequest):
    """Per-shard-ring request: record which slots this ring owns.

    Replicated through the shard's own ring so followers enforce the
    same ownership set as the leader; the epoch guard makes a delayed
    re-install of an older assignment an error rather than a
    regression."""

    epoch: int
    shard_id: str
    slot_count: int
    owned: list[int]  # slots this shard serves

    def apply(self, store):
        cur = store.get("system", "shard_config")
        if cur is not None and self.epoch < cur["epoch"]:
            raise OMError(
                INVALID_REQUEST,
                f"shard config epoch {self.epoch} < current "
                f"{cur['epoch']}")
        row = {"epoch": self.epoch, "shard_id": self.shard_id,
               "slot_count": self.slot_count,
               "owned": sorted(self.owned)}
        store.put("system", "shard_config", row)
        return row


@dataclass
class ImportRow(OMRequest):
    """Slot migration: a replicated raw-row import on the receiving ring.

    Used only by the rebalance runbook (`plane.migrate_slot`,
    `MiniShardedCluster.move_slot`) while the slot is fenced on the
    source, so a verbatim put is safe: the source already rejects the
    slot and the rows being copied are quiescent."""

    table: str
    key: str
    row: dict

    def apply(self, store):
        store.put(self.table, self.key, dict(self.row))


def check_shard(store, volume: str, bucket: str) -> None:
    """Server-side ownership gate: raise SHARD_MOVED when this replica's
    installed shard config does not own the (volume, bucket) slot.

    Unsharded deployments (no config row) pass through untouched, so the
    single-ring path pays one cached `system` get and nothing else."""
    cfg = store.get("system", "shard_config")
    if cfg is None:
        return
    slot = slot_for(volume, bucket, cfg["slot_count"])
    if slot not in cfg["owned"]:
        raise OMError(
            SHARD_MOVED,
            f"slot {slot} of {volume}/{bucket} not owned by "
            f"{cfg['shard_id']} at epoch {cfg['epoch']}")
