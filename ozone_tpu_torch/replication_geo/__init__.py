"""Geo replication: asynchronous cross-cluster bucket replication.

Port of `ozone_tpu/replication_geo/`. Per-bucket rules (`rules.py`:
destination cluster endpoint, optional prefix filter, optional
destination scheme) ride the bucket row; a leader-singleton, term-fenced
`ReplicationShipper` (`shipper.py`) tails the OM store's update journal
and replays key commits and deletes to the remote cluster through the
client datapath, re-encoding on the destination client's device.

Consistency: strong inside a cluster, asynchronous and ordered across
clusters, last-writer-wins under the rewrite fence, so a destination-side
overwrite beats a stale replay. Apache Ozone 1.5 has no bucket-level
cross-cluster replication; the reference adds it as an extension.
"""

from ozone_tpu_torch.replication_geo.rules import (  # noqa: F401
    GeoReplicationError,
    ReplicationRule,
    rules_from_s3_xml,
    rules_to_s3_xml,
    validate_rules,
)
from ozone_tpu_torch.replication_geo.shipper import (  # noqa: F401
    ReplicationShipper,
    register_inprocess,
    unregister_inprocess,
)
