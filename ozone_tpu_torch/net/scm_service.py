"""SCM RPC service and its remote client: registration, heartbeats,
allocation and the admin verbs.

Port of `ozone_tpu/net/scm_service.py` (the reference's
ScmServerDatanodeHeartbeatProtocol and ScmServerProtocol surface):
datanodes register and heartbeat, and take back their queued commands,
serialized with a type tag and the node address book so a remote
datanode can rebuild against peers it has never met; the OM and tools
allocate blocks, list containers and read the cluster status.
`ScmRpcService` is `ScmGrpcService` and `RemoteScmClient` is
`GrpcScmClient`. Of the admin verbs, container info, container close and
safemode status are ported. Left out: HA gates and barriers, secret-key
distribution, ring and certificate verbs, decommission, the balancer and
pipeline verbs.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import asdict
from typing import TYPE_CHECKING, Optional

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
        #: dn_id -> RPC address, learned at registration
        self.addresses: dict[str, str] = {}
        #: serializes the SCM's state between the RPC workers, the OM's
        #: allocations and the daemon's background loops
        self.lock = threading.RLock()
        server.add_service(SERVICE, {
            name: self._locked(fn) for name, fn in {
                "Register": self._register,
                "Heartbeat": self._heartbeat,
                "AllocateBlock": self._allocate_block,
                "NodeAddresses": self._node_addresses,
                "Status": self._status,
                "ListContainers": self._list_containers,
                "AdminOp": self._admin_op,
            }.items()})

    def _locked(self, fn):
        @functools.wraps(fn)
        def method(req):
            with self.lock:
                return fn(req)

        return method

    def _register(self, req) -> bytes:
        m, _ = wire.unpack(req)
        self.addresses[m["dn_id"]] = m["address"]
        self.scm.register_datanode(m["dn_id"], m.get("rack", "/default-rack"),
                                   m.get("capacity_bytes", 0))
        return wire.pack({})

    def _heartbeat(self, req) -> bytes:
        m, _ = wire.unpack(req)
        cmds = self.scm.heartbeat(
            m["dn_id"], container_report=m.get("container_report"),
            used_bytes=m.get("used_bytes", 0),
            deleted_block_acks=m.get("deleted_block_acks"))
        book = dict(self.addresses)
        return wire.pack({"commands": [serialize_command(c, book)
                                       for c in cmds]})

    def _allocate_block(self, req) -> bytes:
        m, _ = wire.unpack(req)
        g = self.scm.allocate_block(ReplicationConfig.parse(m["replication"]),
                                    m["block_size"], m.get("excluded"),
                                    m.get("excluded_containers"))
        return wire.pack({"group": g.to_json(),
                          "addresses": dict(self.addresses)})

    def node_locations(self) -> dict[str, str]:
        """dn_id -> topology location ("/rack")."""
        return {n.dn_id: n.rack for n in self.scm.nodes.nodes()}

    def _node_addresses(self, req) -> bytes:
        return wire.pack({"addresses": dict(self.addresses),
                          "locations": self.node_locations()})

    def _admin_op(self, req) -> bytes:
        """Operator verbs (the `ozone admin` analog)."""
        m, _ = wire.unpack(req)
        op, target = m["op"], m.get("target")
        scm = self.scm
        if op == "safemode-status":
            out = {"safemode": scm.safemode.in_safemode(),
                   **scm.safemode.status()}
        elif op in ("container-info", "close-container"):
            try:
                cid = int(str(target), 0)
            except (TypeError, ValueError):
                raise StorageError("INVALID", f"bad container id {target!r}")
            c = scm.containers.get_or_none(cid)
            if c is None:
                raise StorageError("CONTAINER_NOT_FOUND",
                                   f"no container {target}")
            if op == "close-container":
                # the normal close flow: CLOSING, and close commands to
                # the replicas; their reports mark it CLOSED
                scm.containers.finalize_container(c.id)
                out = {"container": c.id, "state": c.state.value}
            else:
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

    def __init__(self, address: str):
        self._pool = FailoverChannels(address)
        self.addresses = self._pool.addresses

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

    def register(self, dn_id: str, address: str, rack: str = "/default-rack",
                 capacity_bytes: int = 0) -> None:
        self._broadcast("Register", {"dn_id": dn_id, "address": address,
                                     "rack": rack,
                                     "capacity_bytes": capacity_bytes})

    def heartbeat(self, dn_id: str, container_report=None, used_bytes: int = 0,
                  deleted_block_acks: Optional[list[int]] = None) -> list:
        responses = self._broadcast("Heartbeat", {
            "dn_id": dn_id, "container_report": container_report,
            "used_bytes": used_bytes,
            "deleted_block_acks": deleted_block_acks or [],
        })
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

    def admin(self, op: str, target: Optional[str] = None) -> dict:
        return self._call("AdminOp", {"op": op, "target": target})

    def status(self) -> dict:
        return self._call("Status", {})

    def close(self) -> None:
        self._pool.close()
