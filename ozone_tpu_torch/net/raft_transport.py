"""Raft messaging over the port's RPC: many groups, one server.

Port of `ozone_tpu/net/raft_transport.py` (the reference's Ratis
transport between OMs, SCMs and datanode pipeline peers). One
`RaftRpcService` on a process's `RpcServer` serves every raft group that
process takes part in; requests carry a group id and are routed to the
registered `RaftNode`. `RpcRaftTransport` is the reference's
`GrpcRaftTransport` (named after the port's `Rpc*` classes, as
`RpcServer` is): the `consensus/raft.Transport` that carries the same
request and response dicts `InProcessTransport` passes directly, so the
raft core is the same in tests and daemons. With `tls` the transport
dials its peers over mutual TLS with `server_name=<peer id>` (a ring
member's certificate carries its id among its names), and a renewed
identity (a new `version`) retires the channels made under the old one.
`owner` tags every outbound channel of the transport with the local node
id, so an owner-scoped partition (`net/partition.block(dst, owner=id)`)
isolates one replica of a ring whose members share a process.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ozone_tpu_torch.consensus.raft import RaftNode, Transport
from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import RpcChannel, RpcServer
from ozone_tpu_torch.storage.ids import StorageError

log = logging.getLogger(__name__)

SERVICE = "raft"
_METHODS = ("request_vote", "append_entries", "install_snapshot",
            "fetch_state", "timeout_now")


class RaftRpcService:
    """Server side: routes raft RPCs to the group's local RaftNode."""

    def __init__(self, server: RpcServer):
        self._groups: dict[str, RaftNode] = {}
        self._lock = threading.Lock()
        server.add_service(SERVICE, {m: self._handler(m) for m in _METHODS})

    def register(self, group_id: str, node: RaftNode) -> None:
        with self._lock:
            self._groups[group_id] = node

    def unregister(self, group_id: str) -> None:
        with self._lock:
            self._groups.pop(group_id, None)

    def _handler(self, method: str):
        def handle(request) -> bytes:
            meta, _ = wire.unpack(request)
            gid = meta["group"]
            with self._lock:
                node = self._groups.get(gid)
            if node is None:
                raise StorageError("NO_SUCH_RAFT_GROUP",
                                   f"group {gid} not served here")
            resp = getattr(node, f"handle_{method}")(meta["req"])
            return wire.pack({"resp": resp})

        return handle


class RpcRaftTransport(Transport):
    """Client side: one transport per (group, local node).

    `peers` maps peer node id -> "host:port" of the peer's RpcServer.
    Addresses may be learned late (a pipeline member may register before
    its peers are known) through `set_peer`.
    """

    def __init__(self, group_id: str, peers: dict[str, str], tls=None,
                 timeout_s: float = 5.0, vote_timeout_s: float = 1.0,
                 owner: Optional[str] = None):
        self.group_id = group_id
        self._peers = dict(peers)
        self._tls = tls
        #: the partition scope tag of this node's outbound channels
        self._owner = owner
        #: the identity version the cached channels were made under; the
        #: retired ones are closed with the transport (a raft call may
        #: still be on one)
        self._tls_ver = getattr(tls, "version", None)
        self._retired: list[RpcChannel] = []
        self._timeout = timeout_s
        #: votes get a short deadline: a hung call to a dead peer inside
        #: an election round delays the candidate's next campaign
        self._vote_timeout = vote_timeout_s
        self._channels: dict[str, RpcChannel] = {}
        self._lock = threading.Lock()

    def register(self, node: RaftNode) -> None:  # transport API, no-op
        pass

    def set_peer(self, peer_id: str, address: str) -> None:
        with self._lock:
            if self._peers.get(peer_id) != address:
                self._peers[peer_id] = address
                ch = self._channels.pop(peer_id, None)
                if ch is not None:
                    ch.close()

    def _channel(self, peer_id: str) -> RpcChannel:
        with self._lock:
            ver = getattr(self._tls, "version", None)
            if ver != self._tls_ver:
                self._retired.extend(self._channels.values())
                self._channels.clear()
                self._tls_ver = ver
            ch = self._channels.get(peer_id)
            if ch is None:
                addr = self._peers.get(peer_id)
                if not addr:
                    raise ConnectionError(
                        f"no address for raft peer {peer_id}")
                ch = self._channels[peer_id] = RpcChannel(
                    addr, tls=self._tls,
                    server_name=peer_id if self._tls is not None else None,
                    owner=self._owner)
            return ch

    def send(self, peer_id: str, method: str, req: dict) -> dict:
        ch = self._channel(peer_id)
        timeout = (self._vote_timeout if method == "request_vote"
                   else self._timeout)
        try:
            raw = ch.call(SERVICE, method,
                          wire.pack({"group": self.group_id, "req": req}),
                          timeout=timeout)
        except StorageError as e:
            # the raft core treats any raised error as "peer unreachable"
            # and retries on the next heartbeat
            raise ConnectionError(str(e)) from e
        meta, _ = wire.unpack(raw)
        return meta["resp"]

    def close(self) -> None:
        with self._lock:
            chans = list(self._channels.values()) + self._retired
            self._channels.clear()
            self._retired = []
        for ch in chans:
            ch.close()
