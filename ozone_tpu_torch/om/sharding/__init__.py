"""Sharded metadata plane: hash-partitioned OM rings under a root map.

Port of `ozone_tpu/om/sharding/`, module for module:

- `shardmap.py`: slot hashing, the epoch-numbered root shard map, the
  per-shard replicated ownership config and the SHARD_MOVED gate.
- `txn.py`: two-phase cross-shard rename and bucket link, with a
  root-ring coordinator journal and presumed-abort crash recovery.
- `leases.py`: lease-based follower reads (the gate, the switch and
  the verbs a follower may answer).
- `plane.py`: the in-process sharded plane and its `ShardedOm` facade.
- `router.py`: the client-side shard-map cache and routing.

Importing this package registers the sharding request classes, so any
process that may apply replicated sharding entries (daemons, followers)
imports it before its first log replay; `net/daemons.py` does so at
module import.
"""

from ozone_tpu_torch.utils.metrics import registry

#: the om.shard.* observability family
METRICS = registry("om.shard")

# request registration side effects (OMRequest.__init_subclass__)
from ozone_tpu_torch.om.sharding import leases, shardmap, txn  # noqa: E402,F401
from ozone_tpu_torch.om.sharding.shardmap import (  # noqa: E402
    SHARD_MOVED,
    SLOT_COUNT,
    ShardMap,
    slot_for,
)

__all__ = ["METRICS", "SHARD_MOVED", "SLOT_COUNT", "ShardMap",
           "slot_for", "leases", "shardmap", "txn"]
