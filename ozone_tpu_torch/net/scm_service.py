"""SCM RPC service and its remote client: registration, heartbeats,
allocation and the admin verbs.

Port of `ozone_tpu/net/scm_service.py` (the reference's
ScmServerDatanodeHeartbeatProtocol and ScmServerProtocol surface):
datanodes register and heartbeat, and take back their queued commands,
serialized with a type tag and the node address book so a remote
datanode can rebuild against peers it has never met; the OM and tools
allocate blocks, list containers and read the cluster status.
`ScmRpcService` is `ScmGrpcService` and `RemoteScmClient` is
`GrpcScmClient`. A registering datanode echoes the op state it
persisted (`op_state`) and sends its full container report with the
registration (upstream's register request carries it; the reference
waits for the next heartbeat), and every heartbeat carries its
healthy-volume count. The admin verbs: the mutating ones (`decommission`,
`recommission`, `maintenance`, `close-container`, `close-pipeline`,
`balancer-start` with config overrides, `balancer-stop`,
`safemode-enter`, `safemode-exit`) go to `apply_admin_op`, through the
ring under HA; the read-only ones (container info, `pipelines`,
`balancer-status`, `replication-status`, safemode status, the tokens)
are answered by the replica asked; and the metadata ring's verbs
(`ring-status` from any replica; `ring-add`, `ring-remove`,
`ring-transfer` on the leader). `finalize-upgrade` is a mutating verb
(the SCM finalizes, and every datanode is commanded to), and
`upgrade-status` answers the finalizer's view; every heartbeat carries
the node's `layout_version`. `replication-status` and `container-report`
read Recon's container-health census (`recon/recon.ReconScmView`). Under
HA the
daemon sets the hooks: `gate` refuses an allocation or a mutating verb
on a follower with SCM_NOT_LEADER and the leader's address, `barrier`
holds the answer until the decision records of an allocation are
quorum-committed, `admin_submitter` sends the mutating verbs through
the ring, and `ring_provider` ships the ring's
addresses on every register and heartbeat answer, which the remote
client adopts. On a token-enforcing SCM every register and heartbeat
answer says so (`block_tokens`), and carries the live secret keys when
`distribute_secrets` is on (the reference's SecretKeyProtocol): it is
on exactly when the server runs TLS (only an enrolled caller gets
through the handshake), or under the daemon's tests-only
`insecure_secrets`; the remote client merges them into `security` for
the datanode daemon. The operator's `block-token` and `container-token`
verbs mint tokens for dn-direct tools (`AdminTokenFetcher` is a
TokenStore issuer over them); `cert-list` and `cert-revoke` answer on
the replica that hosts the cluster CA (the daemon sets `cert_ops`).
`RemoteScmClient(tls=...)` dials the mutual-TLS plane.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import asdict
from typing import TYPE_CHECKING, Optional

from ozone_tpu_torch import admission
from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import FailoverChannels, RpcServer
from ozone_tpu_torch.scm.block_deletion import DeleteBlocksCommand
from ozone_tpu_torch.scm.pipeline import ReplicationConfig
from ozone_tpu_torch.storage.ids import BlockID, StorageError

if TYPE_CHECKING:
    from ozone_tpu_torch.scm.scm import StorageContainerManager

SERVICE = "ozone.tpu.ScmService"


def _command_types():
    # function-local: these modules import torch, which the admin and
    # namespace clients (the CLI's light verbs) never need
    from ozone_tpu_torch.scm.replication_manager import (
        DeleteReplicaCommand,
        ReplicateCommand,
    )
    from ozone_tpu_torch.storage.reconstruction import ReconstructionCommand

    return ReconstructionCommand, DeleteReplicaCommand, ReplicateCommand


def serialize_command(cmd, addresses: dict[str, str]) -> dict:
    ReconstructionCommand, DeleteReplicaCommand, ReplicateCommand = \
        _command_types()
    if isinstance(cmd, ReconstructionCommand):
        return {
            "type": "reconstruct",
            "container_id": cmd.container_id,
            "replication": str(cmd.replication),
            "sources": {str(k): v for k, v in cmd.sources.items()},
            "targets": {str(k): v for k, v in cmd.targets.items()},
            "addresses": addresses,
        }
    if isinstance(cmd, DeleteBlocksCommand):
        return {"type": "delete_blocks", "tx_ids": cmd.tx_ids,
                "blocks": [b.to_json() for b in cmd.blocks]}
    if isinstance(cmd, DeleteReplicaCommand):
        return {"type": "delete_replica", **asdict(cmd)}
    if isinstance(cmd, ReplicateCommand):
        return {"type": "replicate", **asdict(cmd), "addresses": addresses}
    if isinstance(cmd, dict):
        return cmd
    return {"type": "unknown", "repr": repr(cmd)}


def deserialize_command(d: dict):
    ReconstructionCommand, DeleteReplicaCommand, ReplicateCommand = \
        _command_types()
    t = d.get("type")
    if t == "reconstruct":
        return ReconstructionCommand(
            container_id=d["container_id"],
            replication=CoderOptions.parse(d["replication"]),
            sources={int(k): v for k, v in d["sources"].items()},
            targets={int(k): v for k, v in d["targets"].items()},
        )
    if t == "delete_blocks":
        return DeleteBlocksCommand(list(d["tx_ids"]),
                                   [BlockID.from_json(b) for b in d["blocks"]])
    if t == "delete_replica":
        return DeleteReplicaCommand(d["container_id"], d.get("replica_index", 0))
    if t == "replicate":
        return ReplicateCommand(d["container_id"], d["source"], d["target"],
                                d.get("replica_index", 0))
    return d


class ScmRpcService:
    def __init__(self, scm: "StorageContainerManager", server: RpcServer):
        self.scm = scm
        #: secret keys leave the SCM only over mutual TLS, where every
        #: caller holds a CA-issued certificate; without it any caller of
        #: Register or Heartbeat could read them and mint its own tokens
        #: (the daemon's tests-only insecure_secrets turns it on anyway)
        self.distribute_secrets = server.tls_enabled
        #: (op, target) -> answer of the CA's lifecycle verbs, set by a
        #: daemon that hosts the cluster CA
        self.cert_ops = None
        #: dn_id -> RPC address, learned at registration
        self.addresses: dict[str, str] = {}
        #: serializes the SCM's state between the RPC workers, the OM's
        #: allocations and the daemon's background loops
        self.lock = threading.RLock()
        #: hook fired when a node (re)registers with a new address (the
        #: daemon re-announces the node's pipelines through it)
        self.on_register = None
        #: HA hooks, set by the daemon (see the module docstring);
        #: registration and heartbeats stay open on every replica
        self.gate = None
        self.barrier = None
        self.admin_submitter = None
        #: callable(op, target) for ring-add/ring-remove/ring-transfer
        self.ring_ops = None
        #: callable -> this replica's ring view; any replica answers
        self.ring_status = None
        #: callable -> the ring's replica addresses
        self.ring_provider = None
        locked = {name: self._locked(fn) for name, fn in {
            "Register": self._register,
            "Heartbeat": self._heartbeat,
            "NodeAddresses": self._node_addresses,
            "Status": self._status,
            "ListContainers": self._list_containers,
        }.items()}
        # these take the lock themselves: a ring operation or a quorum
        # barrier must not hold heartbeats back while it waits
        # client-facing verbs are refused past the in-flight bound; node
        # liveness traffic is exempt (a shed heartbeat turns overload into
        # a dead-node storm)
        server.add_service(SERVICE, {**locked,
                                     "AllocateBlock": self._allocate_block,
                                     "AdminOp": self._admin_op},
                           admission=admission.controller(
                               "scm", exempt=frozenset({
                                   "Register", "Heartbeat",
                                   "NodeAddresses", "Status"})))

    def _locked(self, fn):
        @functools.wraps(fn)
        def method(req):
            with self.lock:
                return fn(req)

        return method

    def _register(self, req) -> bytes:
        m, _ = wire.unpack(req)
        changed = self.addresses.get(m["dn_id"]) != m["address"]
        self.addresses[m["dn_id"]] = m["address"]
        self.scm.register_datanode(m["dn_id"], m.get("rack", "/default-rack"),
                                   m.get("capacity_bytes", 0),
                                   op_state=m.get("op_state"),
                                   container_report=m.get("container_report"))
        if changed and self.on_register is not None:
            # a restarted node binds a new port: its pipelines' peers
            # learn the new address
            self.on_register(m["dn_id"])
        return wire.pack(self._security_fields())

    def _security_fields(self) -> dict:
        """What every register and heartbeat answer carries: the ring's
        addresses (datanodes follow a grown ring), whether tokens are
        enforced, and the secret keys where they may be distributed."""
        out = {}
        if self.ring_provider is not None:
            out["ring"] = list(self.ring_provider())
        if not self.scm.block_tokens:
            return out
        out["block_tokens"] = True
        if self.distribute_secrets:
            out["secret_keys"] = self.scm.secret_keys.export_keys()
        return out

    def _heartbeat(self, req) -> bytes:
        m, _ = wire.unpack(req)
        cmds = self.scm.heartbeat(
            m["dn_id"], container_report=m.get("container_report"),
            used_bytes=m.get("used_bytes", 0),
            deleted_block_acks=m.get("deleted_block_acks"),
            healthy_volumes=m.get("healthy_volumes"),
            layout_version=m.get("layout_version"))
        book = dict(self.addresses)
        return wire.pack({"commands": [serialize_command(c, book)
                                       for c in cmds],
                          **self._security_fields()})

    def _allocate_block(self, req) -> bytes:
        if self.gate is not None:
            self.gate()  # a follower-local allocation would never replicate
        m, _ = wire.unpack(req)
        with self.lock:
            g = self.scm.allocate_block(
                ReplicationConfig.parse(m["replication"]), m["block_size"],
                m.get("excluded"), m.get("excluded_containers"))
        if self.barrier is not None:
            self.barrier()  # the allocation must survive a leader failover
        return wire.pack({"group": g.to_json(),
                          "addresses": dict(self.addresses)})

    def node_locations(self) -> dict[str, str]:
        """dn_id -> topology location ("/rack")."""
        return {n.dn_id: n.rack for n in self.scm.nodes.nodes()}

    def _node_addresses(self, req) -> bytes:
        return wire.pack({"addresses": dict(self.addresses),
                          "locations": self.node_locations()})

    #: admin verbs that change cluster state: leader-only under HA, and
    #: replicated through the ring
    MUTATING_ADMIN = frozenset({
        "decommission", "recommission", "maintenance",
        "balancer-start", "balancer-stop", "safemode-enter", "safemode-exit",
        "close-container", "close-pipeline", "finalize-upgrade",
    })

    def _admin_op(self, req) -> bytes:
        """Operator verbs (the `ozone admin` analog)."""
        m, _ = wire.unpack(req)
        op, target = m["op"], m.get("target")
        if op == "ring-status":
            # any replica answers (followers report the leader hint)
            if self.ring_status is None:
                raise StorageError("UNSUPPORTED_REQUEST",
                                   "not an HA deployment")
            return wire.pack(self.ring_status())
        if op in ("ring-add", "ring-remove", "ring-transfer"):
            # a membership change is its own replication (the config
            # entry rides the raft log); a transfer acts on the leader
            if self.ring_ops is None:
                raise StorageError("UNSUPPORTED_REQUEST",
                                   "not an HA deployment")
            if self.gate is not None:
                self.gate()
            out = self.ring_ops(op, target)
            return wire.pack(out if op == "ring-transfer"
                             else {"members": out})
        if op in ("cert-list", "cert-revoke"):
            # answered by the replica that hosts the root CA
            if self.cert_ops is None:
                raise StorageError(
                    "UNSUPPORTED_REQUEST",
                    "this replica does not host the cluster CA")
            return wire.pack({"result": self.cert_ops(op, target)})
        if op in self.MUTATING_ADMIN:
            if self.gate is not None:
                self.gate()
            if self.admin_submitter is not None:
                return wire.pack(self.admin_submitter(op, target))
            with self.lock:
                return wire.pack(self.scm.apply_admin_op(op, target))
        with self.lock:
            return self._local_admin_op(op, target)

    def _local_admin_op(self, op: str, target) -> bytes:
        """The read-only admin verbs, answered from this replica."""
        scm = self.scm
        if op == "safemode-status":
            out = {"safemode": scm.safemode.in_safemode(),
                   **scm.safemode.status()}
        elif op == "balancer-status":
            out = scm.balancer_status()
        elif op == "replication-status":
            out = scm.replication_status()
        elif op == "container-report":
            # container-state census and replication-health census in
            # one view (`admin container report`)
            from collections import Counter

            states = Counter(
                c.state.value for c in scm.containers.containers())
            out = {"containers_total": sum(states.values()),
                   "states": dict(states),
                   "health": scm.replication_status()}
        elif op == "upgrade-status":
            # finalization progress (`admin upgrade`): the layout-feature
            # catalog as this replica's finalizer sees it
            if scm.finalizer is not None:
                out = scm.finalizer.status()
            else:
                from ozone_tpu_torch.utils.upgrade import (
                    FEATURES,
                    LATEST_VERSION,
                )

                out = {"metadata_version": LATEST_VERSION,
                       "software_version": LATEST_VERSION,
                       "needs_finalization": False,
                       "features": [{"name": f.name, "version": f.version,
                                     "allowed": True} for f in FEATURES]}
        elif op == "pipelines":
            out = {"pipelines": [
                {"id": p.id, "nodes": p.nodes,
                 "replication": str(p.replication), "state": p.state.value}
                for p in scm.containers.pipelines()]}
        elif op in ("container-token", "block-token"):
            # operator tokens for dn-direct debug and repair tools
            # (SCMSecurityProtocol.getContainerToken); None on an
            # insecure cluster, so the tools need no mode switch
            if not scm.block_tokens:
                out = {"token": None}
            else:
                from ozone_tpu_torch.utils.security import (
                    AccessMode,
                    BlockTokenIssuer,
                )

                issuer = BlockTokenIssuer(scm.secret_keys)
                if op == "container-token":
                    tok = issuer.issue_container(int(target), owner="admin")
                else:
                    tok = issuer.issue(
                        BlockID.from_json(target),
                        [AccessMode.READ, AccessMode.WRITE], owner="admin")
                out = {"token": tok}
        elif op == "container-info":
            try:
                cid = int(str(target), 0)
            except (TypeError, ValueError):
                raise StorageError("INVALID", f"bad container id {target!r}")
            c = scm.containers.get_or_none(cid)
            if c is None:
                raise StorageError("CONTAINER_NOT_FOUND",
                                   f"no container {target}")
            out = {
                    "id": c.id, "state": c.state.value,
                    "replication": str(c.replication),
                    "pipeline": c.pipeline.id if c.pipeline else None,
                    "nodes": c.pipeline.nodes if c.pipeline else [],
                    "used_bytes": c.used_bytes,
                    "replicas": [
                        {"dn_id": r.dn_id, "state": r.state,
                         "replica_index": r.replica_index,
                         "block_count": r.block_count,
                         "used_bytes": r.used_bytes}
                        for r in list(c.replicas.values())],
                }
        else:
            raise StorageError("UNSUPPORTED_REQUEST", f"admin op {op!r}")
        return wire.pack(out)

    def _list_containers(self, req) -> bytes:
        return wire.pack({"containers": [
            {
                "id": c.id, "state": c.state.value,
                "replication": str(c.replication),
                "nodes": c.pipeline.nodes if c.pipeline else [],
                "used_bytes": c.used_bytes,
                # a snapshot: heartbeat threads change replicas live
                "replicas": [{"dn_id": r.dn_id, "state": r.state,
                              "replica_index": r.replica_index}
                             for r in list(c.replicas.values())],
            }
            for c in self.scm.containers.containers()
        ]})

    def _status(self, req) -> bytes:
        return wire.pack(self.scm.status())


class RemoteScmClient:
    """Remote SCM client. `address` may be a comma-separated list: calls
    stick to one replica and rotate when it is unreachable, with the
    failover loop's backoff."""

    def __init__(self, address: str, tls=None):
        self._pool = FailoverChannels(address, tls=tls)
        self.addresses = self._pool.addresses
        #: the security fields of the latest register and heartbeat
        #: answers ({"block_tokens": bool, "secret_keys": [...]}); the
        #: datanode daemon drains it into its verifier after each one
        self.security: dict = {}

    def _call(self, method: str, meta: dict,
              timeout: Optional[float] = 30.0) -> dict:
        payload = wire.pack(meta)
        last: Optional[Exception] = None
        attempts = max(4, 3 * len(self.addresses))
        policy = resilience.failover_retry_policy(attempts)
        for attempt in range(attempts):
            floor_s = None
            addr, ch = self._pool.channel()
            try:
                return wire.unpack(ch.call(SERVICE, method, payload,
                                           timeout=timeout))[0]
            except StorageError as e:
                last = e
                if e.code == "SCM_NOT_LEADER":
                    self._pool.follow_hint(e.msg)
                elif e.code == "UNAVAILABLE":
                    self._pool.invalidate(addr)
                    if len(self.addresses) == 1:
                        raise
                    self._pool.rotate()
                elif e.code == resilience.SERVER_BUSY:
                    floor_s = resilience.server_pushback_floor(e, "scm")
                else:
                    raise
            if not policy.sleep(attempt, floor_s=floor_s):
                resilience.check_deadline("scm_failover")
                break
        raise last

    def _broadcast(self, method: str, meta: dict,
                   timeout: Optional[float] = 2.0) -> list[dict]:
        """Send to every replica (datanodes heartbeat all of them); return
        the answers, at least one required."""
        payload = wire.pack(meta)
        out, last = [], None
        for addr in list(self.addresses):
            _, ch = self._pool.channel(addr)
            try:
                out.append(wire.unpack(ch.call(SERVICE, method, payload,
                                               timeout=timeout))[0])
            except StorageError as e:
                if e.code == "UNAVAILABLE":
                    self._pool.invalidate(addr)
                last = e
        if not out:
            raise last
        return out

    def _follow_ring(self, responses: list[dict]) -> None:
        """Adopt the ring's addresses shipped on the answers, so a
        datanode follows a metadata ring that grew or shrank online, and
        merge their security fields (expired keys dropped)."""
        for m in responses:
            if m.get("ring"):
                self._pool.reconcile(m["ring"])
            if m.get("block_tokens"):
                self.security["block_tokens"] = True
                keys = {k["key_id"]: k
                        for k in self.security.get("secret_keys", [])}
                for k in m.get("secret_keys", []):
                    keys[k["key_id"]] = k
                now = time.time()
                self.security["secret_keys"] = [
                    k for k in keys.values() if k.get("expires", 0) >= now]

    def register(self, dn_id: str, address: str, rack: str = "/default-rack",
                 capacity_bytes: int = 0, op_state: Optional[str] = None,
                 container_report: Optional[list[dict]] = None) -> None:
        meta = {"dn_id": dn_id, "address": address, "rack": rack,
                "capacity_bytes": capacity_bytes, "op_state": op_state}
        if container_report is not None:
            meta["container_report"] = container_report
        self._follow_ring(self._broadcast("Register", meta))

    def heartbeat(self, dn_id: str, container_report=None, used_bytes: int = 0,
                  deleted_block_acks: Optional[list[int]] = None,
                  healthy_volumes: Optional[int] = None,
                  layout_version: Optional[int] = None) -> list:
        responses = self._broadcast("Heartbeat", {
            "dn_id": dn_id, "container_report": container_report,
            "used_bytes": used_bytes,
            "deleted_block_acks": deleted_block_acks or [],
            "healthy_volumes": healthy_volumes,
            "layout_version": layout_version,
        })
        self._follow_ring(responses)
        return [deserialize_command(c) for m in responses
                for c in m["commands"]]

    def allocate_block(self, replication: str, block_size: int,
                       excluded: Optional[list[str]] = None):
        m = self._call("AllocateBlock", {"replication": replication,
                                         "block_size": block_size,
                                         "excluded": excluded or []})
        return m["group"], m["addresses"]

    def list_containers(self) -> list[dict]:
        return self._call("ListContainers", {})["containers"]

    def node_addresses(self) -> dict[str, str]:
        return self._call("NodeAddresses", {})["addresses"]

    def node_topology(self) -> tuple[dict[str, str], dict[str, str]]:
        """(addresses, locations) from one NodeAddresses round trip."""
        m = self._call("NodeAddresses", {})
        return m["addresses"], m.get("locations", {})

    def admin(self, op: str, target=None) -> dict:
        return self._call("AdminOp", {"op": op, "target": target})

    def status(self) -> dict:
        return self._call("Status", {})

    def close(self) -> None:
        self._pool.close()


class AdminTokenFetcher:
    """A TokenStore issuer that fetches operator tokens from the SCM
    (SCMSecurityProtocol.getContainerToken): dn-direct tools run against
    a token-enforcing cluster without holding the keys. An insecure SCM
    answers None and the requests go out with no token."""

    def __init__(self, scm_client: RemoteScmClient):
        self.scm = scm_client

    def issue(self, block_id, modes=None, owner="admin"):
        try:
            return self.scm.admin("block-token",
                                  block_id.to_json()).get("token")
        except StorageError:
            return None

    def issue_container(self, container_id, modes=None, owner="admin"):
        try:
            return self.scm.admin("container-token",
                                  int(container_id)).get("token")
        except StorageError:
            return None
