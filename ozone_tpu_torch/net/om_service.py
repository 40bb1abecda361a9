"""OM RPC service and the remote OM client.

Port of `ozone_tpu/net/om_service.py` (the reference's OmClientProtocol
served by OzoneManagerProtocolServerSideTranslatorPB, at the verb
level), for the verbs the port's `om/om.py` has: volume and bucket
create, info, list and delete; open_key, allocate_block and commit_key;
lookup_key (with the address book of the key's datanodes), list_keys and
delete_key. `RemoteOmClient` (the reference's GrpcOmClient) has the
attribute surface `OzoneClient` needs from `OzoneManager`, so the client
API works unchanged against a remote OM, and fails over across a
comma-separated address list. Left out: sharding, delegation tokens and
the caller identity, ACLs, snapshots, multipart, quotas, small objects,
lifecycle and geo replication.
"""

from __future__ import annotations

import contextlib
from typing import TYPE_CHECKING, Optional

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import FailoverChannels, RpcServer
from ozone_tpu_torch.om.requests import OMError
from ozone_tpu_torch.scm.pipeline import ReplicationConfig
from ozone_tpu_torch.storage.ids import StorageError

if TYPE_CHECKING:
    from ozone_tpu_torch.om.om import OzoneManager

SERVICE = "ozone.tpu.OmService"


def _block_group():
    # function-local: the writer's module imports torch, which the
    # namespace verbs of the CLI never need
    from ozone_tpu_torch.client.ec_writer import BlockGroup

    return BlockGroup


class OmRpcService:
    def __init__(self, om: "OzoneManager", server: RpcServer,
                 addresses_provider=None, locations_provider=None,
                 scm_lock=None):
        self.om = om
        #: the co-located SCM service's lock, held across an allocation
        self.scm_lock = scm_lock or contextlib.nullcontext()
        #: callable -> the dn_id -> address book (the co-located SCM
        #: service's)
        self.addresses_provider = addresses_provider or (lambda: {})
        #: callable -> dn_id -> topology location, shipped with allocations
        self.locations_provider = locations_provider or (lambda: {})
        w = self._wrap
        server.add_service(SERVICE, {
            "CreateVolume": w(lambda m: om.create_volume(m["volume"])),
            "DeleteVolume": w(lambda m: om.delete_volume(m["volume"])),
            "VolumeInfo": w(lambda m: om.volume_info(m["volume"])),
            "ListVolumes": w(lambda m: om.list_volumes()),
            "CreateBucket": w(lambda m: om.create_bucket(
                m["volume"], m["bucket"],
                m.get("replication", "rs-6-3-1024k"),
                m.get("layout", "OBJECT_STORE"))),
            "DeleteBucket": w(lambda m: om.delete_bucket(m["volume"],
                                                         m["bucket"])),
            "BucketInfo": w(lambda m: om.bucket_info(m["volume"],
                                                     m["bucket"])),
            "ListBuckets": w(lambda m: om.list_buckets(m["volume"])),
            "OpenKey": self._open_key,
            "AllocateBlock": self._allocate_block,
            "CommitKey": self._commit_key,
            "LookupKey": w(lambda m: om.lookup_key(
                m["volume"], m["bucket"], m["key"]), with_addresses=True),
            "ListKeys": w(lambda m: om.list_keys(
                m["volume"], m["bucket"], m.get("prefix", ""),
                m.get("start_after", ""), m.get("limit"))),
            "DeleteKey": w(lambda m: om.delete_key(m["volume"], m["bucket"],
                                                   m["key"])),
        })

    def _wrap(self, fn, with_addresses: bool = False):
        def method(req) -> bytes:
            m, _ = wire.unpack(req)
            try:
                out = fn(m)
            except OMError as e:
                raise StorageError(e.code, e.msg)
            resp = {"result": out}
            if with_addresses:
                # located reads: the address book of the key's own
                # datanodes, so a client that never wrote can read
                nodes = {n for g in (out or {}).get("block_groups", [])
                         for n in g.get("nodes", [])}
                if nodes:
                    book = self.addresses_provider()
                    locs = self.locations_provider()
                    resp["addresses"] = {n: book[n] for n in nodes
                                         if n in book}
                    resp["locations"] = {n: locs[n] for n in nodes
                                         if n in locs}
            return wire.pack(resp)

        return method

    def _open_key(self, req) -> bytes:
        m, _ = wire.unpack(req)
        try:
            s = self.om.open_key(m["volume"], m["bucket"], m["key"],
                                 m.get("replication"))
        except OMError as e:
            raise StorageError(e.code, e.msg)
        return wire.pack({
            "client_id": s.client_id,
            "replication": str(s.replication),
            "checksum_type": s.checksum_type,
            "bytes_per_checksum": s.bytes_per_checksum,
            "block_size": self.om.block_size,
            "volume": s.volume,
            "bucket": s.bucket,
            "key": s.key,
        })

    def _allocate_block(self, req) -> bytes:
        m, _ = wire.unpack(req)
        with self.scm_lock:
            g = self.om.scm.allocate_block(
                ReplicationConfig.parse(m["replication"]), self.om.block_size,
                m.get("excluded"), m.get("excluded_containers"))
        return wire.pack({"group": g.to_json(),
                          "addresses": self.addresses_provider(),
                          "locations": self.locations_provider()})

    def _commit_key(self, req) -> bytes:
        m, _ = wire.unpack(req)

        class _S:  # the session fields a commit reads
            volume = m["volume"]
            bucket = m["bucket"]
            key = m["key"]
            client_id = m["client_id"]
            replication = ReplicationConfig.parse(m["replication"])
            expect_object_id = m.get("expect_object_id", "")
            expect_generation = m.get("expect_generation", -1)

        try:
            self.om.commit_key(_S(), [_block_group().from_json(g)
                                      for g in m["groups"]], m["size"])
        except OMError as e:
            raise StorageError(e.code, e.msg)
        return wire.pack({})


class RemoteOpenKeySession:
    def __init__(self, volume, bucket, key, meta):
        self.volume = meta.get("volume", volume)
        self.bucket = meta.get("bucket", bucket)
        # the server normalizes legacy-bucket paths
        self.key = meta.get("key", key)
        self.client_id = meta["client_id"]
        self.replication = ReplicationConfig.parse(meta["replication"])
        self.checksum_type = meta["checksum_type"]
        self.bytes_per_checksum = meta["bytes_per_checksum"]
        self.expect_object_id = ""
        self.expect_generation = -1


class RemoteOmClient:
    """Remote OzoneManager with the attribute surface OzoneClient expects.

    `address` may be a comma-separated replica list (the
    OMFailoverProxyProvider analog): calls stick to the known leader,
    follow OM_NOT_LEADER hints, rotate on an unreachable replica and back
    off on SERVER_BUSY. `clients` (a DatanodeClientFactory) learns the
    datanode addresses that allocations and lookups carry."""

    def __init__(self, address: str, clients=None):
        self._pool = FailoverChannels(address)
        self.addresses = self._pool.addresses
        self.address = self.addresses[0]
        self.block_size = 16 * 1024 * 1024
        self.clients = clients

    def _call(self, method: str, **meta) -> dict:
        payload = wire.pack(meta)
        last: Optional[Exception] = None
        attempts = max(4, 3 * len(self.addresses))
        policy = resilience.failover_retry_policy(attempts)
        for attempt in range(attempts):
            floor_s = None
            addr, ch = self._pool.channel()
            try:
                m, _ = wire.unpack(ch.call(
                    SERVICE, method, payload,
                    timeout=resilience.op_timeout(30.0, method)))
                self.address = addr
                return m
            except StorageError as e:
                last = e
                if e.code == "OM_NOT_LEADER":
                    self._pool.follow_hint(e.msg)
                elif e.code == "UNAVAILABLE":
                    # unreachable replica: drop its channel and rotate;
                    # server-raised errors surface (a blind retry would
                    # re-run a non-idempotent write)
                    self._pool.invalidate(addr)
                    if len(self.addresses) == 1:
                        raise
                    self._pool.rotate()
                elif e.code == resilience.SERVER_BUSY:
                    # pushback from a healthy peer: back off, same replica
                    floor_s = resilience.server_pushback_floor(e, "om")
                else:
                    raise
            if not policy.sleep(attempt, floor_s=floor_s):
                resilience.check_deadline("om_failover")
                break
        if isinstance(last, StorageError) \
                and last.code == resilience.SERVER_BUSY:
            raise last
        raise StorageError("IO_EXCEPTION", f"no OM leader reachable: {last}")

    def _learn_from(self, m: dict):
        """Adopt the address book riding a located answer; returns the
        answer's result."""
        if self.clients is not None:
            for dn_id, addr in m.get("addresses", {}).items():
                self.clients.update_remote(dn_id, addr)
            self.clients.learn_locations(m.get("locations", {}))
        return m.get("result")

    # namespace
    def create_volume(self, volume):
        self._call("CreateVolume", volume=volume)

    def delete_volume(self, volume):
        self._call("DeleteVolume", volume=volume)

    def volume_info(self, volume):
        return self._call("VolumeInfo", volume=volume)["result"]

    def list_volumes(self):
        return self._call("ListVolumes")["result"]

    def create_bucket(self, volume, bucket, replication="rs-6-3-1024k",
                      layout="OBJECT_STORE"):
        self._call("CreateBucket", volume=volume, bucket=bucket,
                   replication=replication, layout=layout)

    def delete_bucket(self, volume, bucket):
        self._call("DeleteBucket", volume=volume, bucket=bucket)

    def bucket_info(self, volume, bucket):
        return self._call("BucketInfo", volume=volume, bucket=bucket)["result"]

    def list_buckets(self, volume):
        return self._call("ListBuckets", volume=volume)["result"]

    # keys
    def open_key(self, volume, bucket, key, replication=None):
        meta = self._call("OpenKey", volume=volume, bucket=bucket, key=key,
                          replication=replication)
        self.block_size = meta.get("block_size", self.block_size)
        return RemoteOpenKeySession(volume, bucket, key, meta)

    def allocate_block(self, session, excluded: Optional[list[str]] = None,
                       excluded_containers=None):
        m = self._call("AllocateBlock", replication=str(session.replication),
                       excluded=excluded or [],
                       excluded_containers=list(excluded_containers or ()))
        self._learn_from(m)
        return _block_group().from_json(m["group"])

    def commit_key(self, session, groups, size):
        self._call("CommitKey", volume=session.volume, bucket=session.bucket,
                   key=session.key, client_id=session.client_id,
                   replication=str(session.replication),
                   groups=[g.to_json() for g in groups], size=size,
                   expect_object_id=session.expect_object_id,
                   expect_generation=session.expect_generation)

    def lookup_key(self, volume, bucket, key):
        return self._learn_from(self._call("LookupKey", volume=volume,
                                           bucket=bucket, key=key))

    def key_block_groups(self, info):
        return [_block_group().from_json(g) for g in info["block_groups"]]

    def list_keys(self, volume, bucket, prefix="", start_after="",
                  limit=None):
        return self._call("ListKeys", volume=volume, bucket=bucket,
                          prefix=prefix, start_after=start_after,
                          limit=limit)["result"]

    def delete_key(self, volume, bucket, key):
        self._call("DeleteKey", volume=volume, bucket=bucket, key=key)

    def close(self) -> None:
        self._pool.close()
