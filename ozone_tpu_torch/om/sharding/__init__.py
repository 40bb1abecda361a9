"""The sharded metadata plane's pieces the metadata ring needs.

Port of part of `ozone_tpu/om/sharding/`: the follower read-lease gate
(`leases.py`), which the metadata ring builds on every replica. The
shard map, the sharded plane and the shard daemon wait for their slice.
"""
