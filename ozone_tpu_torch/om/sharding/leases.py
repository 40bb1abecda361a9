"""Lease-based follower reads for the metadata plane.

Port of `ozone_tpu/om/sharding/leases.py`, the gate only. A follower
that heard from its leader within the read-lease window may serve
read-only verbs locally. Staleness is bounded by the lease: the window
is shorter than the minimum election timeout, so while a follower's
lease is live no other node can have won an election and committed
writes it never heard of. Read-your-writes is bounded by `min_applied`:
a follower whose state machine lags the index the client has already
seen refuses, and the client falls back to the leader. The metadata
ring builds a gate on every replica; no verb of the port's daemon is
served through it until the sharded plane's router, which sends the
client's applied floor, is ported.
"""

from __future__ import annotations

from ozone_tpu_torch.utils.metrics import registry

METRICS = registry("om.shard")

#: read-only OM verbs a lease-holding follower may answer. Everything
#: else (writes, anything that allocates) must reach the leader.
FOLLOWER_READ_VERBS = frozenset({
    "LookupKey", "ListKeys", "ListKeysPaged", "BucketInfo",
    "ListBuckets", "VolumeInfo", "ListVolumes", "GetFileStatus",
    "ListStatus", "KeyBlockGroups", "GetShardMap",
})


#: follower read-lease window, in seconds. It stays under the 0.15 s
#: minimum election timeout: a longer lease than that re-introduces the
#: stale-read race the lease exists to close.
READ_LEASE_S = 0.12


class FollowerReadGate:
    """Per-replica admission check for follower reads.

    `try_serve` answers: may THIS replica answer `verb` right now,
    given the client has already observed `min_applied`?"""

    def __init__(self, node, lease_s: float, metrics=METRICS):
        self.node = node  # consensus.raft.RaftNode
        self.lease_s = lease_s
        self.metrics = metrics

    def try_serve(self, verb: str, min_applied: int = 0) -> bool:
        if verb not in FOLLOWER_READ_VERBS:
            return False
        if not self.node.follower_lease_valid(self.lease_s):
            self.metrics.counter("follower_read_misses").inc()
            return False
        if self.node.last_applied < int(min_applied or 0):
            # lease is live but the state machine lags what the client
            # has already seen: refuse rather than time-travel
            self.metrics.counter("follower_read_misses").inc()
            return False
        self.metrics.counter("follower_read_hits").inc()
        return True
