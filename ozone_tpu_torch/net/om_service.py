"""OM RPC service and the remote OM client.

Port of `ozone_tpu/net/om_service.py` (the reference's OmClientProtocol
served by OzoneManagerProtocolServerSideTranslatorPB, at the verb
level), for the verbs the port's `om/om.py` has: volume and bucket
create, info, list and delete; open_key (with user metadata),
allocate_block and commit_key; lookup_key (with the address book of the
key's datanodes), list_keys and delete_key; key attributes, S3 secrets
and the upgrade status; the multipart verbs, whose part commit carries
block groups as commit_key does; the small-object verbs (the bucket
opt-in, inline PUTs with the value in base64, the batched needle commit,
slab allocation, info and listing, compaction) and the lifecycle verbs
(rules set, get and clear, the sweeper's status, and a sweep run now,
which runs in the metadata daemon's process); the filesystem verbs
(link buckets, bucket attributes, key rename, the hsync flag on a
commit, lease recovery, the open-files listing, and the FSO directory
verbs; an FSO open carries its tree position, parent id and file name,
to the commit). `RemoteOmClient` (the
reference's GrpcOmClient) has the attribute surface `OzoneClient`, the
slab packer and the S3 gateway need from `OzoneManager`, so all work
unchanged against a remote OM, and fails over across a comma-separated
address list. Under HA the daemon sets `gate` (every verb on a replica
that is not the ready leader answers OM_NOT_LEADER with the leader's
address),
`scm_barrier` (an allocation is answered only once its SCM decision
records are quorum-committed) and `applied_index_fn` (the replica's
applied index, stamped on answers as `_applied`).

Security: every verb binds the caller's identity for the OM's ACL
checks (`_identity`): a presented delegation token (`_dtoken`)
authenticates its owner, and a bare `_user` / `_groups` is the trusted
transport's assertion, ignored when a token is present. The client
sends them from `user_context` and its `token`. The verbs: native ACLs
(ModifyAcl, GetAcls, CheckAccess), S3 bucket grants (SetBucketAcl,
GetBucketAcl), tenants and access ids, and the delegation tokens' get,
renew and cancel; allocations carry their block and container tokens.
Encryption: the KMS verbs (KmsCreateKey, KmsKeyInfo, KmsListKeys,
KmsDecrypt, the reference's), a bucket's `encryption_key` and `gdpr` on
CreateBucket, the envelope bundle on the open session's answer (a key's,
and a multipart upload's from its row), and each part's IV on
CommitMultipartPart. `RemoteOmClient(tls=...)` dials the mutual-TLS plane
with its role's certificate. Snapshots: create, list, info, delete,
rename, diff (synchronous, and the paged jobs' submit and page), a
snapshot's key listing, and its key lookup with the address book as
LookupKey has it. The quota, volume-owner and bucket-replication verbs,
and the upgrade quiesce (Prepare, CancelPrepare, PrepareStatus). Geo
replication: a bucket's rules set, get and clear, the shipper's status
and a cycle run now (in the metadata daemon's process). Sharding
(`om/sharding/`): GetShardMap answers the root shard map row from any
replica, ungated by the HA leader gate, since it is how a client finds
the shard rings; the gate is told the verb and the request, so a
follower holding a read lease answers the follower-read verbs. A
`RemoteOmClient` discovers the map on its first call (`shard_aware`
None; False never routes, True requires a routable map), routes every
bucket-addressed verb to the owning shard's pool (`ShardRouter`), retries
once through a refetched map on SHARD_MOVED, fans volume creates,
deletes and bucket listings out to every shard, and with
OZONE_TPU_OM_FOLLOWER_READS=1 sends a read verb first to a replica of
the shard's round robin with its applied floor.
"""

from __future__ import annotations

import base64
import contextlib
import threading
from typing import TYPE_CHECKING, Optional

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import FailoverChannels, RpcServer
from ozone_tpu_torch.om.requests import OMError
from ozone_tpu_torch.om.sharding.router import METRICS as SHARD_METRICS
from ozone_tpu_torch.om.sharding.router import ShardRouter
from ozone_tpu_torch.om.sharding.shardmap import SHARD_MOVED
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
        #: HA hooks, set by the daemon (see the module docstring)
        self.gate = None
        self.scm_barrier = None
        self.applied_index_fn = None
        w = self._wrap
        methods = {
            "CreateVolume": w(lambda m: om.create_volume(m["volume"])),
            "DeleteVolume": w(lambda m: om.delete_volume(m["volume"])),
            "VolumeInfo": w(lambda m: om.volume_info(m["volume"])),
            "ListVolumes": w(lambda m: om.list_volumes()),
            "CreateBucket": w(lambda m: om.create_bucket(
                m["volume"], m["bucket"],
                m.get("replication", "rs-6-3-1024k"),
                m.get("layout", "OBJECT_STORE"),
                encryption_key=m.get("encryption_key", ""),
                gdpr=m.get("gdpr", False))),
            # the KMS (OzoneKMSUtil + KMSClientProvider surface)
            "KmsCreateKey": w(lambda m: om.kms_create_key(
                m["name"], rotate=m.get("rotate", False))),
            "KmsKeyInfo": w(lambda m: om.kms_key_info(m["name"])),
            "KmsListKeys": w(lambda m: om.kms_list_keys()),
            "KmsDecrypt": w(lambda m: om.kms_decrypt(
                m["volume"], m["bucket"], m["bundle"])),
            "CreateBucketLink": w(lambda m: om.create_bucket_link(
                m["src_volume"], m["src_bucket"], m["volume"], m["bucket"])),
            "DeleteBucket": w(lambda m: om.delete_bucket(m["volume"],
                                                         m["bucket"])),
            "BucketInfo": w(lambda m: om.bucket_info(m["volume"],
                                                     m["bucket"])),
            "ListBuckets": w(lambda m: om.list_buckets(m["volume"])),
            "OpenKey": self._open_key,
            "AllocateBlock": self._allocate_block,
            "CommitKey": self._commit_key,
            "RecoverLease": w(lambda m: om.recover_lease(
                m["volume"], m["bucket"], m["key"])),
            "LookupKey": w(lambda m: om.lookup_key(
                m["volume"], m["bucket"], m["key"]), with_addresses=True),
            "ListKeys": w(lambda m: om.list_keys(
                m["volume"], m["bucket"], m.get("prefix", ""),
                m.get("start_after", ""), m.get("limit"))),
            "DeleteKey": w(lambda m: om.delete_key(
                m["volume"], m["bucket"], m["key"],
                expect_object_id=m.get("expect_object_id", ""))),
            "RenameKey": w(lambda m: om.rename_key(
                m["volume"], m["bucket"], m["key"], m["new_key"])),
            "SetKeyAttrs": w(lambda m: om.set_key_attrs(
                m["volume"], m["bucket"], m["key"], m["attrs"],
                m.get("preconds"))),
            "SetBucketAttrs": w(lambda m: om.set_bucket_attrs(
                m["volume"], m["bucket"], m["attrs"])),
            # the FSO verbs (the reference's CreateDirectory, GetFileStatus,
            # ListStatus, and DeleteKey with its recursive flag)
            "CreateDirectory": w(lambda m: om.create_directory(
                m["volume"], m["bucket"], m["path"])),
            "DeleteDirectory": w(lambda m: om.delete_directory(
                m["volume"], m["bucket"], m["path"],
                m.get("recursive", False))),
            "GetFileStatus": w(lambda m: om.get_file_status(
                m["volume"], m["bucket"], m["path"])),
            "ListStatus": w(lambda m: om.list_status(
                m["volume"], m["bucket"], m["path"])),
            "ListOpenFiles": w(lambda m: om.list_open_files(
                m.get("volume", ""), m.get("bucket", ""),
                m.get("prefix", ""), m.get("start_after", ""),
                m.get("limit", 100))),
            "GetS3Secret": w(lambda m: om.get_s3_secret(
                m["access_id"], m.get("create", True))),
            "RevokeS3Secret": w(lambda m: om.revoke_s3_secret(
                m["access_id"])),
            "UpgradeStatus": w(lambda m: om.upgrade_status()),
            "InitiateMultipartUpload": w(lambda m: om.initiate_multipart_upload(
                m["volume"], m["bucket"], m["key"], m.get("replication"),
                m.get("metadata"))),
            "MultipartInfo": w(lambda m: om.multipart_info(
                m["volume"], m["bucket"], m["key"], m["upload_id"])),
            "CommitMultipartPart": self._commit_multipart_part,
            "CompleteMultipartUpload": w(lambda m: om.complete_multipart_upload(
                m["volume"], m["bucket"], m["key"], m["upload_id"],
                m["parts"])),
            "AbortMultipartUpload": w(lambda m: om.abort_multipart_upload(
                m["volume"], m["bucket"], m["key"], m["upload_id"])),
            "ListParts": w(lambda m: om.list_parts(
                m["volume"], m["bucket"], m["key"], m["upload_id"])),
            "ListMultipartUploads": w(lambda m: om.list_multipart_uploads(
                m["volume"], m["bucket"], m.get("prefix", ""))),
            # the small-object path (inline values and needle slabs)
            "SetBucketSmallObj": w(lambda m: om.set_bucket_smallobj(
                m["volume"], m["bucket"],
                enabled=bool(m.get("enabled", True)),
                inline_max=m.get("inline_max", 0),
                needle_max=m.get("needle_max", 0))),
            "PutInlineKey": w(lambda m: om.put_inline_key(
                m["volume"], m["bucket"], m["key"],
                base64.b64decode(m["data"]), metadata=m.get("metadata"))),
            "CommitKeys": w(lambda m: om.commit_keys(
                m["volume"], m["bucket"], m["slab"], m["entries"])),
            "SlabInfo": w(lambda m: om.slab_info(
                m["volume"], m["bucket"], m["slab_id"])),
            "ListSlabs": w(lambda m: om.list_slabs(m["volume"],
                                                   m["bucket"])),
            "AllocateSlabGroup": self._allocate_slab_group,
            # bucket lifecycle (the reference's tiering extension)
            "SetBucketLifecycle": w(lambda m: om.set_bucket_lifecycle(
                m["volume"], m["bucket"], m["rules"])),
            "GetBucketLifecycle": w(lambda m: om.get_bucket_lifecycle(
                m["volume"], m["bucket"])),
            "DeleteBucketLifecycle": w(lambda m: om.delete_bucket_lifecycle(
                m["volume"], m["bucket"])),
            "LifecycleStatus": w(lambda m: om.lifecycle_status()),
            "LifecycleRunNow": w(lambda m: om.run_lifecycle_once(
                m.get("max_keys"))),
            "SlabCompactionRunNow": w(lambda m: om.run_slab_compaction_once(
                m.get("max_slabs"))),
            # cross-cluster bucket replication (the reference's extension)
            "SetBucketGeoReplication": w(
                lambda m: om.set_bucket_geo_replication(
                    m["volume"], m["bucket"], m["rules"])),
            "GetBucketGeoReplication": w(
                lambda m: om.get_bucket_geo_replication(
                    m["volume"], m["bucket"])),
            "DeleteBucketGeoReplication": w(
                lambda m: om.delete_bucket_geo_replication(
                    m["volume"], m["bucket"])),
            "GeoStatus": w(lambda m: om.geo_status()),
            "GeoRunNow": w(lambda m: om.run_geo_once(m.get("max_entries"))),
            # S3 bucket grants, native ACLs and tenants (the reference's
            # AddAcl/RemoveAcl/SetAcl/GetAcl and tenant admin verbs)
            "SetBucketAcl": w(lambda m: om.set_bucket_acl(
                m["volume"], m["bucket"], m["acl"])),
            "GetBucketAcl": w(lambda m: om.get_bucket_acl(m["volume"],
                                                          m["bucket"])),
            "ModifyAcl": w(lambda m: om.modify_acl(
                m["obj_type"], m["volume"], m.get("bucket", ""),
                m.get("path", ""), m.get("op", "add"), m.get("acls", []))),
            "CheckAccess": w(lambda m: om.check_access(
                m["volume"], m.get("bucket"), m.get("key"), m["right"],
                user=m.get("user"), groups=m.get("groups", ()))),
            "GetAcls": w(lambda m: om.get_acls(
                m["obj_type"], m["volume"], m.get("bucket", ""),
                m.get("path", ""))),
            "CreateTenant": w(lambda m: om.create_tenant(
                m["tenant"], m.get("volume", ""), m.get("owner", "root"))),
            "DeleteTenant": w(lambda m: om.delete_tenant(m["tenant"])),
            "ListTenants": w(lambda m: om.list_tenants()),
            "TenantAssignUser": w(lambda m: om.tenant_assign_user(
                m["tenant"], m["user"], m.get("access_id", ""))),
            "TenantRevokeAccess": w(lambda m: om.tenant_revoke_access(
                m["access_id"])),
            "ListTenantUsers": w(lambda m: om.list_tenant_users(m["tenant"])),
            "TenantForAccessId": w(lambda m: om.tenant_for_access_id(
                m["access_id"])),
            # delegation tokens
            "GetDelegationToken": w(lambda m: om.get_delegation_token(
                m["renewer"])),
            "RenewDelegationToken": w(lambda m: om.renew_delegation_token(
                m["token"])),
            "CancelDelegationToken": w(lambda m: om.cancel_delegation_token(
                m["token"])),
            # quotas, ownership and replication
            "SetVolumeOwner": w(lambda m: om.set_volume_owner(
                m["volume"], m["owner"])),
            "SetQuota": w(lambda m: om.set_quota(
                m["volume"], m.get("bucket", ""), m.get("quota_bytes"),
                m.get("quota_namespace"))),
            "RepairQuota": w(lambda m: om.repair_quota(m["volume"])),
            "SetBucketReplication": w(lambda m: om.set_bucket_replication(
                m["volume"], m["bucket"], m["replication"])),
            # the upgrade quiesce (`admin om prepare`)
            "Prepare": w(lambda m: {"txid": om.prepare()}),
            "CancelPrepare": w(lambda m: om.cancel_prepare()),
            "PrepareStatus": w(lambda m: {"prepared": om.prepared}),
            # snapshots
            "CreateSnapshot": w(lambda m: om.create_snapshot(
                m["volume"], m["bucket"], m["name"])),
            "ListSnapshots": w(lambda m: om.list_snapshots(
                m["volume"], m["bucket"])),
            "SnapshotInfo": w(lambda m: om.snapshot_info(
                m["volume"], m["bucket"], m["name"])),
            "DeleteSnapshot": w(lambda m: om.delete_snapshot(
                m["volume"], m["bucket"], m["name"])),
            "RenameSnapshot": w(lambda m: om.rename_snapshot(
                m["volume"], m["bucket"], m["name"], m["new_name"])),
            "SnapshotDiff": w(lambda m: om.snapshot_diff(
                m["volume"], m["bucket"], m["from_snapshot"],
                m.get("to_snapshot"))),
            "SnapshotDiffSubmit": w(lambda m: om.snapshot_diff_submit(
                m["volume"], m["bucket"], m["from_snapshot"],
                m.get("to_snapshot"))),
            "SnapshotDiffPage": w(lambda m: om.snapshot_diff_page(
                m["job_id"], m.get("token", ""), m.get("page_size", 1000))),
            "SnapshotKeys": w(lambda m: om.snapshot_keys(
                m["volume"], m["bucket"], m["name"])),
            "SnapshotLookupKey": w(lambda m: om.snapshot_lookup_key(
                m["volume"], m["bucket"], m["name"], m["key"]),
                with_addresses=True),
            # the sharded metadata plane: the root map, answered by any
            # replica (it is how a fresh client finds the shard rings,
            # so it cannot be leader-gated)
            "GetShardMap": w(lambda m: om.store.get("system", "shard_map")),
        }
        server.add_service(SERVICE, {n: self._gated(n, fn)
                                     for n, fn in methods.items()})

    #: verbs exempt from the HA leader gate (see GetShardMap above)
    UNGATED = frozenset({"GetShardMap"})

    def _gated(self, name: str, fn):
        def method(req) -> bytes:
            if self.gate is not None and name not in self.UNGATED:
                # verb-aware: the HA gate admits read verbs on followers
                # holding a live lease (om/sharding/leases.py) and
                # bounces everything else to the leader
                self.gate(name, req)
            return fn(req)

        return method

    def _identity(self, m: dict) -> tuple:
        """The caller of this request. A presented delegation token
        authenticates it (signature and live row); the bare `_user` and
        `_groups` fields are the trusted transport's assertion, ignored
        when a token is present so a field cannot outrank a token. The
        third element marks a token-authenticated caller, who may not
        mint further tokens."""
        tok = m.pop("_dtoken", None)
        user = m.pop("_user", None)
        groups = m.pop("_groups", ())
        if tok is not None:
            row = self.om.verify_delegation_token(tok)  # raises OMError
            return row["owner"], (), True
        return user, groups, False

    def _bound(self, m: dict):
        """The OM's user context for this request's caller."""
        user, groups, via_token = self._identity(m)
        return self.om.user_context(user, groups, via_token=via_token)

    def _wrap(self, fn, with_addresses: bool = False):
        def method(req) -> bytes:
            m, _ = wire.unpack(req)
            try:
                with self._bound(m):
                    out = fn(m)
            except OMError as e:
                raise StorageError(e.code, e.msg)
            resp = {"result": out}
            if self.applied_index_fn is not None:
                resp["_applied"] = self.applied_index_fn()
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
            with self._bound(m):
                s = self.om.open_key(m["volume"], m["bucket"], m["key"],
                                     m.get("replication"),
                                     metadata=m.get("metadata"),
                                     acls=m.get("acls"))
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
            # an FSO session carries its tree position across the wire
            "parent_id": s.parent_id,
            "file_name": s.file_name,
            "encryption": s.encryption,
        })

    def _allocate_block(self, req) -> bytes:
        m, _ = wire.unpack(req)
        with self.scm_lock:
            g = self.om.scm.allocate_block(
                ReplicationConfig.parse(m["replication"]), self.om.block_size,
                m.get("excluded"), m.get("excluded_containers"))
        g = self.om.grant_write_tokens(g)
        if self.scm_barrier is not None:
            # HA: the allocation must survive a leader failover before
            # the client writes data against it
            self.scm_barrier()
        return wire.pack({"group": g.to_json(with_tokens=True),
                          "addresses": self.addresses_provider(),
                          "locations": self.locations_provider()})

    def _allocate_slab_group(self, req) -> bytes:
        m, _ = wire.unpack(req)
        with self.scm_lock:
            g = self.om.allocate_slab_group(
                m["replication"], m.get("excluded"),
                m.get("excluded_containers"))
        if self.scm_barrier is not None:
            self.scm_barrier()
        return wire.pack({"group": g.to_json(with_tokens=True),
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
            parent_id = m.get("parent_id")
            file_name = m.get("file_name")

        try:
            self.om.commit_key(_S(), [_block_group().from_json(g)
                                      for g in m["groups"]], m["size"],
                               hsync=bool(m.get("hsync")))
        except OMError as e:
            raise StorageError(e.code, e.msg)
        resp = {}
        if self.applied_index_fn is not None:
            resp["_applied"] = self.applied_index_fn()
        return wire.pack(resp)


    def _commit_multipart_part(self, req) -> bytes:
        m, _ = wire.unpack(req)

        class _S:  # the session fields a part commit reads
            volume = m["volume"]
            bucket = m["bucket"]
            key = m["key"]
            client_id = m["upload_id"]

        try:
            etag = self.om.commit_multipart_part(
                _S(), m["part_number"],
                [_block_group().from_json(g) for g in m["groups"]],
                m["size"], m["etag"], iv=m.get("iv", ""))
        except OMError as e:
            raise StorageError(e.code, e.msg)
        return wire.pack({"result": etag})


#: verbs whose answer waits for a whole background sweep in the daemon
_SWEEP_VERBS = ("LifecycleRunNow", "SlabCompactionRunNow", "GeoRunNow")
_SWEEP_VERB_TIMEOUT_S = 600.0


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
        self.parent_id = meta.get("parent_id")
        self.file_name = meta.get("file_name")
        self.encryption = meta.get("encryption") or {}


class RemoteOmClient:
    """Remote OzoneManager with the attribute surface OzoneClient expects.

    `address` may be a comma-separated replica list (the
    OMFailoverProxyProvider analog): calls stick to the known leader,
    follow OM_NOT_LEADER hints, rotate on an unreachable replica and back
    off on SERVER_BUSY. `clients` (a DatanodeClientFactory) learns the
    datanode addresses that allocations and lookups carry. Each call
    carries the caller identity bound by `user_context` (`_user`,
    `_groups`) and the delegation token the client was built with
    (`_dtoken`, the authenticated path). `tls` (a TlsMaterial or
    RotatingTls) is the role's identity on a mutual-TLS cluster, and the
    shard router's pools dial with it too. `shard_aware`: None discovers
    the shard map on the first call, False never routes, True requires
    a routable map."""

    def __init__(self, address: str, clients=None, token=None, tls=None,
                 shard_aware: Optional[bool] = None):
        self._pool = FailoverChannels(address, tls=tls)
        self.tls = tls
        self.addresses = self._pool.addresses
        self.address = self.addresses[0]
        self.block_size = 16 * 1024 * 1024
        self.clients = clients
        self._caller = threading.local()
        self._token = token
        #: client-side shard routing (om/sharding/router.py): None =
        #: discover through GetShardMap on first use (a deployment with
        #: no shard map costs one extra call, once), False = never
        #: route, True = require a routable map
        self._shard_aware = shard_aware
        self._router = None
        self._router_checked = shard_aware is False
        self._router_lock = threading.Lock()

    def user_context(self, user, groups=()):
        """Bind a caller identity to every call this thread makes."""

        @contextlib.contextmanager
        def _ctx():
            prev = getattr(self._caller, "identity", None)
            self._caller.identity = (user, tuple(groups))
            try:
                yield
            finally:
                self._caller.identity = prev

        return _ctx()

    def _ensure_router(self) -> None:
        """One-shot shard-map discovery (see __init__)."""
        with self._router_lock:
            if self._router_checked:
                return
            self._router_checked = True
            try:
                mj = self._call("GetShardMap", _pool=self._pool)["result"]
            except StorageError:
                mj = None  # a server without the verb, or transient
            if mj and any(mj.get("addresses", {}).values()):
                self._router = ShardRouter(mj, tls=self.tls)
            elif self._shard_aware is True:
                raise StorageError(
                    "INVALID", "shard_aware=True but the server has no "
                    "routable shard map")

    def _refresh_shard_map(self) -> None:
        """SHARD_MOVED invalidation: refetch the map and adopt it."""
        SHARD_METRICS.counter("moved_rejections").inc()
        mj = self._call("GetShardMap", _pool=self._pool)["result"]
        if mj and self._router is not None:
            self._router.update_map(mj)

    def _call(self, method: str, _pool=None, **meta) -> dict:
        ident = getattr(self._caller, "identity", None)
        if ident is not None and ident[0] is not None:
            meta.setdefault("_user", ident[0])
            meta.setdefault("_groups", list(ident[1]))
        if self._token is not None:
            meta.setdefault("_dtoken", self._token)
        if _pool is None and not self._router_checked:
            self._ensure_router()
        # shard routing: bucket-addressed verbs go to the owning ring
        sid = None
        pool = _pool
        if pool is None and self._router is not None:
            sid, pool = self._router.route(method, meta)
        if pool is None:
            pool = self._pool
        # lease-based follower reads: spread read verbs over the shard's
        # replicas; a follower without a live lease (or behind the
        # caller's floor) answers OM_NOT_LEADER and the retry below
        # falls back to the leader
        read_addr = None
        if sid is not None and "_min_applied" in meta:
            read_addr = self._router.read_address(sid)
        payload = wire.pack(meta)
        # a sweep run now works in the daemon for as long as its budget
        hop_s = _SWEEP_VERB_TIMEOUT_S if method in _SWEEP_VERBS else 30.0
        last: Optional[Exception] = None
        attempts = max(4, 3 * len(self.addresses))
        policy = resilience.failover_retry_policy(attempts)
        moved_retried = False
        for attempt in range(attempts):
            floor_s = None
            if read_addr is not None and attempt == 0:
                addr, ch = pool.channel(read_addr)
            else:
                addr, ch = pool.channel()
            try:
                m, _ = wire.unpack(ch.call(
                    SERVICE, method, payload,
                    timeout=resilience.op_timeout(hop_s, method)))
                if sid is None:
                    self.address = addr
                elif self._router is not None:
                    self._router.observe(sid, m)
                return m
            except StorageError as e:
                last = e
                if e.code == "OM_NOT_LEADER":
                    pool.follow_hint(e.msg)
                elif e.code == SHARD_MOVED and sid is not None \
                        and not moved_retried:
                    # a stale shard map: the rejection is the cache
                    # invalidation; refetch, re-route, retry once
                    moved_retried = True
                    self._refresh_shard_map()
                    new_sid, new_pool = self._router.route(method, meta)
                    if new_pool is not None:
                        sid, pool = new_sid, new_pool
                        payload = wire.pack(meta)  # _min_applied moved
                elif e.code == "UNAVAILABLE":
                    # unreachable replica: drop its channel and rotate;
                    # server-raised errors surface (a blind retry would
                    # re-run a non-idempotent write)
                    pool.invalidate(addr)
                    if len(pool.addresses) == 1:
                        raise
                    pool.rotate()
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

    def _shard_pools(self) -> Optional[list]:
        """Every shard's pool on a routed client, else None."""
        if not self._router_checked:
            self._ensure_router()
        if self._router is None:
            return None
        return list(self._router.pools.values())

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
        pools = self._shard_pools()
        if pools is not None:
            # volumes exist on every shard (any shard may own buckets of
            # any volume): fan the create out
            for pool in pools:
                self._call("CreateVolume", _pool=pool, volume=volume)
            return
        self._call("CreateVolume", volume=volume)

    def delete_volume(self, volume):
        pools = self._shard_pools()
        if pools is not None:
            # check all, then delete all: each shard's DeleteVolume sees
            # only its own buckets, so a one-pass delete could remove
            # the volume from empty shards and then fail
            for pool in pools:
                if self._call("ListBuckets", _pool=pool,
                              volume=volume)["result"]:
                    raise StorageError("VOLUME_NOT_EMPTY", volume)
            for pool in pools:
                self._call("DeleteVolume", _pool=pool, volume=volume)
            return
        self._call("DeleteVolume", volume=volume)

    def volume_info(self, volume):
        return self._call("VolumeInfo", volume=volume)["result"]

    def list_volumes(self):
        return self._call("ListVolumes")["result"]

    def create_bucket(self, volume, bucket, replication="rs-6-3-1024k",
                      layout="OBJECT_STORE", encryption_key="", gdpr=False):
        self._call("CreateBucket", volume=volume, bucket=bucket,
                   replication=replication, layout=layout,
                   encryption_key=encryption_key, gdpr=gdpr)

    # the KMS
    def kms_create_key(self, name, rotate=False):
        return self._call("KmsCreateKey", name=name, rotate=rotate)["result"]

    def kms_key_info(self, name):
        return self._call("KmsKeyInfo", name=name)["result"]

    def kms_list_keys(self):
        return self._call("KmsListKeys")["result"]

    def kms_decrypt(self, volume, bucket, bundle):
        return self._call("KmsDecrypt", volume=volume, bucket=bucket,
                          bundle=bundle)["result"]

    def create_bucket_link(self, src_volume, src_bucket, volume, bucket):
        self._call("CreateBucketLink", src_volume=src_volume,
                   src_bucket=src_bucket, volume=volume, bucket=bucket)

    def delete_bucket(self, volume, bucket):
        self._call("DeleteBucket", volume=volume, bucket=bucket)

    def set_bucket_attrs(self, volume, bucket, attrs):
        return self._call("SetBucketAttrs", volume=volume, bucket=bucket,
                          attrs=attrs)["result"]

    def bucket_info(self, volume, bucket):
        return self._call("BucketInfo", volume=volume, bucket=bucket)["result"]

    def list_buckets(self, volume):
        pools = self._shard_pools()
        if pools is not None:
            out = []
            for pool in pools:
                out.extend(self._call("ListBuckets", _pool=pool,
                                      volume=volume)["result"])
            return sorted(out, key=lambda b: b["name"])
        return self._call("ListBuckets", volume=volume)["result"]

    def get_shard_map(self):
        """The root shard map row, or None on unsharded deployments."""
        return self._call("GetShardMap")["result"]

    def upgrade_status(self):
        return self._call("UpgradeStatus")["result"]

    # keys
    def open_key(self, volume, bucket, key, replication=None, metadata=None,
                 acls=None):
        meta = self._call("OpenKey", volume=volume, bucket=bucket, key=key,
                          replication=replication, metadata=metadata,
                          acls=acls)
        self.block_size = meta.get("block_size", self.block_size)
        return RemoteOpenKeySession(volume, bucket, key, meta)

    def allocate_block(self, session, excluded: Optional[list[str]] = None,
                       excluded_containers=None):
        m = self._call("AllocateBlock", replication=str(session.replication),
                       excluded=excluded or [],
                       excluded_containers=list(excluded_containers or ()))
        self._learn_from(m)
        return _block_group().from_json(m["group"])

    def commit_key(self, session, groups, size, hsync=False):
        self._call("CommitKey", volume=session.volume, bucket=session.bucket,
                   key=session.key, client_id=session.client_id,
                   replication=str(session.replication),
                   groups=[g.to_json() for g in groups], size=size,
                   expect_object_id=session.expect_object_id,
                   expect_generation=session.expect_generation,
                   parent_id=getattr(session, "parent_id", None),
                   file_name=getattr(session, "file_name", None),
                   hsync=hsync)

    def hsync_key(self, session, groups, size):
        self.commit_key(session, groups, size, hsync=True)

    def recover_lease(self, volume, bucket, key):
        return self._call("RecoverLease", volume=volume, bucket=bucket,
                          key=key)["result"]

    def list_open_files(self, volume="", bucket="", prefix="",
                        start_after="", limit=100):
        return self._call("ListOpenFiles", volume=volume, bucket=bucket,
                          prefix=prefix, start_after=start_after,
                          limit=limit)["result"]

    def lookup_key(self, volume, bucket, key):
        return self._learn_from(self._call("LookupKey", volume=volume,
                                           bucket=bucket, key=key))

    # quotas, ownership, replication and the upgrade quiesce
    def set_volume_owner(self, volume, owner):
        return self._call("SetVolumeOwner", volume=volume,
                          owner=owner)["result"]

    def set_quota(self, volume, bucket="", quota_bytes=None,
                  quota_namespace=None):
        return self._call("SetQuota", volume=volume, bucket=bucket,
                          quota_bytes=quota_bytes,
                          quota_namespace=quota_namespace)["result"]

    def repair_quota(self, volume):
        return self._call("RepairQuota", volume=volume)["result"]

    def set_bucket_replication(self, volume, bucket, replication):
        return self._call("SetBucketReplication", volume=volume,
                          bucket=bucket, replication=replication)["result"]

    def prepare(self):
        return self._call("Prepare")["result"]

    def cancel_prepare(self):
        self._call("CancelPrepare")

    def prepare_status(self):
        return self._call("PrepareStatus")["result"]

    # snapshots
    def create_snapshot(self, volume, bucket, name):
        return self._call("CreateSnapshot", volume=volume, bucket=bucket,
                          name=name)["result"]

    def list_snapshots(self, volume, bucket):
        return self._call("ListSnapshots", volume=volume,
                          bucket=bucket)["result"]

    def snapshot_info(self, volume, bucket, name):
        return self._call("SnapshotInfo", volume=volume, bucket=bucket,
                          name=name)["result"]

    def delete_snapshot(self, volume, bucket, name):
        self._call("DeleteSnapshot", volume=volume, bucket=bucket,
                   name=name)

    def rename_snapshot(self, volume, bucket, name, new_name):
        return self._call("RenameSnapshot", volume=volume, bucket=bucket,
                          name=name, new_name=new_name)["result"]

    def snapshot_diff(self, volume, bucket, from_snapshot,
                      to_snapshot=None):
        return self._call("SnapshotDiff", volume=volume, bucket=bucket,
                          from_snapshot=from_snapshot,
                          to_snapshot=to_snapshot)["result"]

    def snapshot_diff_submit(self, volume, bucket, from_snapshot,
                             to_snapshot=None):
        return self._call("SnapshotDiffSubmit", volume=volume,
                          bucket=bucket, from_snapshot=from_snapshot,
                          to_snapshot=to_snapshot)["result"]

    def snapshot_diff_page(self, job_id, token="", page_size=1000):
        return self._call("SnapshotDiffPage", job_id=job_id, token=token,
                          page_size=page_size)["result"]

    def snapshot_keys(self, volume, bucket, name):
        return self._call("SnapshotKeys", volume=volume, bucket=bucket,
                          name=name)["result"]

    def snapshot_lookup_key(self, volume, bucket, name, key):
        return self._learn_from(self._call(
            "SnapshotLookupKey", volume=volume, bucket=bucket, name=name,
            key=key))

    def key_block_groups(self, info):
        return [_block_group().from_json(g) for g in info["block_groups"]]

    def list_keys(self, volume, bucket, prefix="", start_after="",
                  limit=None):
        return self._call("ListKeys", volume=volume, bucket=bucket,
                          prefix=prefix, start_after=start_after,
                          limit=limit)["result"]

    def delete_key(self, volume, bucket, key, expect_object_id=""):
        self._call("DeleteKey", volume=volume, bucket=bucket, key=key,
                   expect_object_id=expect_object_id)

    def rename_key(self, volume, bucket, key, new_key):
        self._call("RenameKey", volume=volume, bucket=bucket, key=key,
                   new_key=new_key)

    def set_key_attrs(self, volume, bucket, key, attrs, preconds=None):
        return self._call("SetKeyAttrs", volume=volume, bucket=bucket,
                          key=key, attrs=attrs, preconds=preconds)["result"]

    # FSO file system
    def create_directory(self, volume, bucket, path):
        self._call("CreateDirectory", volume=volume, bucket=bucket, path=path)

    def delete_directory(self, volume, bucket, path, recursive=False):
        self._call("DeleteDirectory", volume=volume, bucket=bucket,
                   path=path, recursive=recursive)

    def get_file_status(self, volume, bucket, path):
        return self._call("GetFileStatus", volume=volume, bucket=bucket,
                          path=path)["result"]

    def list_status(self, volume, bucket, path):
        return self._call("ListStatus", volume=volume, bucket=bucket,
                          path=path)["result"]

    # s3 secrets
    def get_s3_secret(self, access_id, create=True):
        return self._call("GetS3Secret", access_id=access_id,
                          create=create)["result"]

    def revoke_s3_secret(self, access_id):
        self._call("RevokeS3Secret", access_id=access_id)

    # delegation tokens
    def get_delegation_token(self, renewer):
        return self._call("GetDelegationToken", renewer=renewer)["result"]

    def renew_delegation_token(self, token):
        return self._call("RenewDelegationToken", token=token)["result"]

    def cancel_delegation_token(self, token):
        self._call("CancelDelegationToken", token=token)

    # S3 bucket grants, native ACLs, tenants
    def set_bucket_acl(self, volume, bucket, acl):
        self._call("SetBucketAcl", volume=volume, bucket=bucket, acl=acl)

    def get_bucket_acl(self, volume, bucket):
        return self._call("GetBucketAcl", volume=volume,
                          bucket=bucket)["result"]

    def modify_acl(self, obj_type, volume, bucket="", path="", op="add",
                   acls=None):
        from ozone_tpu_torch.om.acl import normalize_acls

        return self._call("ModifyAcl", obj_type=obj_type, volume=volume,
                          bucket=bucket, path=path, op=op,
                          acls=normalize_acls(acls))["result"]

    def check_access(self, volume, bucket, key, right, user=None,
                     groups=()):
        self._call("CheckAccess", volume=volume, bucket=bucket, key=key,
                   right=right if isinstance(right, str) else right.name,
                   user=user, groups=list(groups))

    def get_acls(self, obj_type, volume, bucket="", path=""):
        return self._call("GetAcls", obj_type=obj_type, volume=volume,
                          bucket=bucket, path=path)["result"]

    def create_tenant(self, tenant, volume="", owner="root"):
        self._call("CreateTenant", tenant=tenant, volume=volume, owner=owner)

    def delete_tenant(self, tenant):
        self._call("DeleteTenant", tenant=tenant)

    def list_tenants(self):
        return self._call("ListTenants")["result"]

    def tenant_assign_user(self, tenant, user, access_id=""):
        return self._call("TenantAssignUser", tenant=tenant, user=user,
                          access_id=access_id)["result"]

    def tenant_revoke_access(self, access_id):
        self._call("TenantRevokeAccess", access_id=access_id)

    def list_tenant_users(self, tenant):
        return self._call("ListTenantUsers", tenant=tenant)["result"]

    def tenant_for_access_id(self, access_id):
        return self._call("TenantForAccessId",
                          access_id=access_id)["result"]

    # multipart upload
    def initiate_multipart_upload(self, volume, bucket, key,
                                  replication=None, metadata=None):
        return self._call("InitiateMultipartUpload", volume=volume,
                          bucket=bucket, key=key, replication=replication,
                          metadata=metadata)["result"]

    def multipart_info(self, volume, bucket, key, upload_id):
        return self._call("MultipartInfo", volume=volume, bucket=bucket,
                          key=key, upload_id=upload_id)["result"]

    def open_multipart_part(self, volume, bucket, key, upload_id):
        info = self.multipart_info(volume, bucket, key, upload_id)
        return RemoteOpenKeySession(volume, bucket, key, {
            "client_id": upload_id,
            "replication": info["replication"],
            "checksum_type": info["checksum_type"],
            "bytes_per_checksum": info["bytes_per_checksum"],
            "volume": info["volume"],
            "bucket": info["bucket"],
            "encryption": info.get("encryption", {}),
        })

    def commit_multipart_part(self, session, part_number, groups, size,
                              etag, iv=""):
        return self._call("CommitMultipartPart", volume=session.volume,
                          bucket=session.bucket, key=session.key,
                          upload_id=session.client_id,
                          part_number=part_number,
                          groups=[g.to_json() for g in groups], size=size,
                          etag=etag, iv=iv)["result"]

    def complete_multipart_upload(self, volume, bucket, key, upload_id,
                                  parts):
        return self._call("CompleteMultipartUpload", volume=volume,
                          bucket=bucket, key=key, upload_id=upload_id,
                          parts=parts)["result"]

    def abort_multipart_upload(self, volume, bucket, key, upload_id):
        self._call("AbortMultipartUpload", volume=volume, bucket=bucket,
                   key=key, upload_id=upload_id)

    def list_parts(self, volume, bucket, key, upload_id):
        return self._call("ListParts", volume=volume, bucket=bucket,
                          key=key, upload_id=upload_id)["result"]

    def list_multipart_uploads(self, volume, bucket, prefix=""):
        return self._call("ListMultipartUploads", volume=volume,
                          bucket=bucket, prefix=prefix)["result"]

    # small objects: inline values ride the wire in base64 (the wire
    # format is JSON-shaped; they are at most inline_max bytes)
    def set_bucket_smallobj(self, volume, bucket, enabled=True,
                            inline_max=0, needle_max=0):
        return self._call("SetBucketSmallObj", volume=volume,
                          bucket=bucket, enabled=enabled,
                          inline_max=inline_max,
                          needle_max=needle_max)["result"]

    def put_inline_key(self, volume, bucket, key, data, metadata=None):
        return self._call(
            "PutInlineKey", volume=volume, bucket=bucket, key=key,
            data=base64.b64encode(bytes(data)).decode("ascii"),
            metadata=metadata)["result"]

    def commit_keys(self, volume, bucket, slab, entries):
        return self._call("CommitKeys", volume=volume, bucket=bucket,
                          slab=slab, entries=list(entries))["result"]

    def slab_info(self, volume, bucket, slab_id):
        return self._call("SlabInfo", volume=volume, bucket=bucket,
                          slab_id=slab_id)["result"]

    def list_slabs(self, volume, bucket):
        return self._call("ListSlabs", volume=volume,
                          bucket=bucket)["result"]

    def allocate_slab_group(self, replication, excluded=None,
                            excluded_containers=None):
        m = self._call(
            "AllocateSlabGroup", replication=str(replication),
            excluded=excluded or [],
            excluded_containers=list(excluded_containers or ()))
        self._learn_from(m)
        return _block_group().from_json(m["group"])

    def run_slab_compaction_once(self, max_slabs=None):
        return self._call("SlabCompactionRunNow",
                          max_slabs=max_slabs)["result"]

    # bucket lifecycle
    def set_bucket_lifecycle(self, volume, bucket, rules):
        return self._call("SetBucketLifecycle", volume=volume,
                          bucket=bucket, rules=rules)["result"]

    def get_bucket_lifecycle(self, volume, bucket):
        return self._call("GetBucketLifecycle", volume=volume,
                          bucket=bucket)["result"]

    def delete_bucket_lifecycle(self, volume, bucket):
        self._call("DeleteBucketLifecycle", volume=volume, bucket=bucket)

    def lifecycle_status(self):
        return self._call("LifecycleStatus")["result"]

    def run_lifecycle_once(self, max_keys=None):
        return self._call("LifecycleRunNow", max_keys=max_keys)["result"]

    # cross-cluster bucket replication
    def set_bucket_geo_replication(self, volume, bucket, rules):
        return self._call("SetBucketGeoReplication", volume=volume,
                          bucket=bucket, rules=rules)["result"]

    def get_bucket_geo_replication(self, volume, bucket):
        return self._call("GetBucketGeoReplication", volume=volume,
                          bucket=bucket)["result"]

    def delete_bucket_geo_replication(self, volume, bucket):
        self._call("DeleteBucketGeoReplication", volume=volume,
                   bucket=bucket)

    def geo_status(self):
        return self._call("GeoStatus")["result"]

    def run_geo_once(self, max_entries=None):
        return self._call("GeoRunNow", max_entries=max_entries)["result"]

    def close(self) -> None:
        if self._router is not None:
            self._router.close()
        self._pool.close()
