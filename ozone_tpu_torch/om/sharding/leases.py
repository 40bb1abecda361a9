"""Lease-based follower reads for the metadata plane.

Port of `ozone_tpu/om/sharding/leases.py`. A follower that heard from
its leader within the read-lease window may serve read-only verbs
locally. Staleness is bounded by the lease: the window is shorter than
the minimum election timeout, so while a follower's lease is live no
other node can have won an election and committed writes it never heard
of. Read-your-writes is bounded by `min_applied`: a follower whose state
machine lags the index the client has already seen refuses, and the
client falls back to the leader. The metadata ring builds a gate on
every replica; the daemon's leader gate (`net/daemons.py`) and the
in-process plane (`plane.py`) answer `FOLLOWER_READ_VERBS` through it
when `follower_reads_enabled()`, and the shard router sends the client's
applied floor with them.
"""

from __future__ import annotations

import os

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


def follower_reads_enabled() -> bool:
    """OZONE_TPU_OM_FOLLOWER_READS=1: clients prefer follower replicas
    for the read verbs above. Off by default: an unsharded deployment
    keeps strict leader reads unless the operator opts in."""
    return os.environ.get("OZONE_TPU_OM_FOLLOWER_READS", "0") == "1"


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
