"""Client-side shard routing: cached map, per-shard pools, floors.

Port of `ozone_tpu/om/sharding/router.py`. `RemoteOmClient` discovers
the shard map once (GetShardMap, served ungated by any replica), builds
one FailoverChannels pool per shard from the map's address book, with
the client's own TLS identity, and routes every bucket-addressed verb to
the owning shard. The map is a cache: a `SHARD_MOVED` rejection from a
shard that no longer owns the slot invalidates it, and the client
refetches the map and retries once through the new owner.

The router also tracks a per-shard applied-index floor (the highest
`_applied` seen in any answer) so lease-based follower reads can carry
`_min_applied`: a follower whose state machine lags the caller's own
writes refuses, and the read falls back to the leader.
"""

from __future__ import annotations

import threading
from typing import Optional

from ozone_tpu_torch.net.rpc import FailoverChannels
from ozone_tpu_torch.om.sharding.leases import (
    FOLLOWER_READ_VERBS,
    follower_reads_enabled,
)
from ozone_tpu_torch.om.sharding.shardmap import ShardMap
from ozone_tpu_torch.utils.metrics import registry

METRICS = registry("om.shard")

#: verbs never routed by (volume, bucket) even when both are present:
#: KMS state lives in the home OM's store, not the bucket's shard
ROUTE_EXEMPT = frozenset({"GetShardMap", "KmsDecrypt", "KmsCreateKey",
                          "KmsKeyInfo", "KmsListKeys"})


class ShardRouter:
    """The client half of the shard map: routing + invalidation."""

    def __init__(self, map_json: dict, tls=None):
        self._tls = tls
        self._lock = threading.Lock()
        self.map = ShardMap.from_json(map_json)
        self.pools: dict[str, FailoverChannels] = {}
        self._floors: dict[str, int] = {}
        self._read_rr: dict[str, int] = {}
        self._build_pools()

    def _build_pools(self) -> None:
        for sid, addrs in self.map.addresses.items():
            if addrs and sid not in self.pools:
                self.pools[sid] = FailoverChannels(addrs, tls=self._tls)

    @property
    def routable(self) -> bool:
        return bool(self.pools)

    def route(self, method: str, meta: dict):
        """(shard_id, pool) for a routable call, else (None, None)."""
        volume, bucket = meta.get("volume"), meta.get("bucket")
        if not volume or not bucket or method in ROUTE_EXEMPT:
            return None, None
        sid = self.map.shard_for(volume, bucket)
        pool = self.pools.get(sid)
        if pool is None:
            return None, None
        METRICS.counter("routes").inc()
        if follower_reads_enabled() and method in FOLLOWER_READ_VERBS:
            meta["_min_applied"] = self.floor(sid)
        return sid, pool

    def read_address(self, sid: str) -> Optional[str]:
        """Round-robin follower preference for lease-served reads (the
        leader answers too if the cursor lands on it — it is simply a
        leader read then)."""
        pool = self.pools.get(sid)
        if pool is None or len(pool.addresses) < 2:
            return None
        with self._lock:
            i = self._read_rr.get(sid, 0)
            self._read_rr[sid] = i + 1
        return pool.addresses[i % len(pool.addresses)]

    def observe(self, sid: Optional[str], resp: dict) -> None:
        """Advance the shard's applied floor from a response."""
        idx = resp.get("_applied")
        if sid is None or not isinstance(idx, int):
            return
        with self._lock:
            if idx > self._floors.get(sid, 0):
                self._floors[sid] = idx

    def floor(self, sid: str) -> int:
        with self._lock:
            return self._floors.get(sid, 0)

    def update_map(self, map_json: dict) -> None:
        """Adopt a refreshed map (SHARD_MOVED invalidation). Pools for
        shards whose address list is unchanged are REUSED — their
        channels may carry in-flight calls on other threads."""
        new = ShardMap.from_json(map_json)
        with self._lock:
            for sid, addrs in new.addresses.items():
                old = self.map.addresses.get(sid)
                if sid in self.pools and old != addrs:
                    self.pools.pop(sid)
            self.map = new
        self._build_pools()

    def close(self) -> None:
        for pool in self.pools.values():
            pool.close()
