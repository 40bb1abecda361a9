"""Client-facing RPC surface of the datanode Raft pipeline server.

Port of `ozone_tpu/net/ratis_service.py` (the reference exposes Ratis
writes through the Xceiver protocol: XceiverClientRatis.sendRequestAsync
routes container commands into the pipeline's Raft ring, watchForCommit
waits for all-replica apply). Three verbs on the datanode's RpcServer:
Submit (an ordered write through the local leader), Watch (a commit
watermark wait) and Info (the leadership and groups probe a client uses
to find the leader). `RatisRpcService` is the reference's
`RatisGrpcService` and `RemoteRatisClient` its `GrpcRatisClient`, named
after the port's `Rpc*` and `Remote*` classes. With a verifier on, a
proposal is token-checked at the leader before it enters the ring
(followers apply the committed log without checking again, as the
reference's ContainerStateMachine does): a container create or close
needs a container token, a chunk commit or block commit a WRITE block
token. `RemoteRatisClient(tls=...)` dials a mutual-TLS ring, as the
daemons' rings run on a secure cluster.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Protocol

from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import RpcChannel, RpcServer
from ozone_tpu_torch.storage.ids import BlockID
from ozone_tpu_torch.storage.ratis import RatisXceiverServer
from ozone_tpu_torch.utils import security

log = logging.getLogger(__name__)

SERVICE = "xceiver-ratis"


class RatisRpcService:
    def __init__(self, xceiver: RatisXceiverServer, server: RpcServer,
                 verifier=None):
        self.xceiver = xceiver
        #: the datanode's BlockTokenVerifier, shared with its other lanes
        self.verifier = verifier
        server.add_service(SERVICE, {
            "Submit": self._submit,
            "Watch": self._watch,
            "Info": self._info,
        })

    def _authorize(self, req: dict) -> None:
        """Token-check a proposal at the leader."""
        verb = req.get("verb")
        if verb in ("create_container", "close_container"):
            security.gate(self.verifier, "ratis", req.get("container_token"),
                          container_id=int(req["container_id"]))
        elif verb == "write_chunk_commit":
            security.gate(self.verifier, "ratis", req.get("token"),
                          block_id=BlockID.from_json(req["block_id"]))
        elif verb == "put_block":
            security.gate(self.verifier, "ratis", req.get("token"),
                          block_id=BlockID.from_json(
                              req["block"]["block_id"]))

    def _submit(self, request) -> bytes:
        meta, _ = wire.unpack(request)
        self._authorize(meta.get("request") or {})
        out = self.xceiver.submit(int(meta["pipeline_id"]), meta["request"],
                                  timeout=float(meta.get("timeout", 30.0)))
        return wire.pack(out)

    def _watch(self, request) -> bytes:
        meta, _ = wire.unpack(request)
        out = self.xceiver.watch(
            int(meta["pipeline_id"]), int(meta["index"]),
            policy=meta.get("policy", "ALL"),
            timeout=float(meta.get("timeout", 30.0)),
        )
        return wire.pack(out)

    def _info(self, request) -> bytes:
        meta, _ = wire.unpack(request)
        pid = meta.get("pipeline_id")
        return wire.pack({
            "pipelines": self.xceiver.pipelines(),
            "leader": (self.xceiver.leader_of(int(pid))
                       if pid is not None else None),
        })


class RatisClient(Protocol):
    dn_id: str

    def submit(self, pipeline_id: int, request: dict,
               timeout: float = 30.0) -> dict: ...
    def watch(self, pipeline_id: int, index: int, policy: str = "ALL",
              timeout: float = 30.0) -> dict: ...
    def info(self, pipeline_id: Optional[int] = None) -> dict: ...


class LocalRatisClient:
    """In-process client over a RatisXceiverServer (tests/minicluster)."""

    def __init__(self, xceiver: RatisXceiverServer, dn_id: str):
        self.xceiver = xceiver
        self.dn_id = dn_id

    def submit(self, pipeline_id, request, timeout=30.0):
        return self.xceiver.submit(pipeline_id, request, timeout=timeout)

    def watch(self, pipeline_id, index, policy="ALL", timeout=30.0):
        return self.xceiver.watch(pipeline_id, index, policy=policy,
                                  timeout=timeout)

    def info(self, pipeline_id=None):
        return {
            "pipelines": self.xceiver.pipelines(),
            "leader": (self.xceiver.leader_of(pipeline_id)
                       if pipeline_id is not None else None),
        }


class RemoteRatisClient:
    def __init__(self, dn_id: str, address: str, tls=None):
        self.dn_id = dn_id
        self._ch = RpcChannel(address, tls=tls)

    def submit(self, pipeline_id, request, timeout=30.0):
        raw = self._ch.call(SERVICE, "Submit", wire.pack({
            "pipeline_id": pipeline_id, "request": request,
            "timeout": timeout,
        }), timeout=timeout + 5)
        return wire.unpack(raw)[0]

    def watch(self, pipeline_id, index, policy="ALL", timeout=30.0):
        raw = self._ch.call(SERVICE, "Watch", wire.pack({
            "pipeline_id": pipeline_id, "index": index, "policy": policy,
            "timeout": timeout,
        }), timeout=timeout + 5)
        return wire.unpack(raw)[0]

    def info(self, pipeline_id=None):
        raw = self._ch.call(SERVICE, "Info",
                            wire.pack({"pipeline_id": pipeline_id}))
        return wire.unpack(raw)[0]

    def close(self) -> None:
        self._ch.close()


class RatisClientFactory:
    """dn_id -> RatisClient resolver, local first, like
    `client/dn_client.DatanodeClientFactory`."""

    def __init__(self, address_source=None, tls=None):
        #: the identity remote clients present on a mutual-TLS cluster;
        #: a renewal (a new `version`) rebuilds them
        self.tls = tls
        self._tls_ver = getattr(tls, "version", None)
        self._local: dict[str, LocalRatisClient] = {}
        self._remote_addr: dict[str, str] = {}
        self._remote: dict[str, RemoteRatisClient] = {}
        self._lock = threading.Lock()
        #: optional dn_id -> address resolver (typically the datapath
        #: DatanodeClientFactory.remote_address: both services ride the
        #: same RpcServer, so one address book serves both)
        self._address_source = address_source

    def register_local(self, xceiver: RatisXceiverServer,
                       dn_id: str) -> LocalRatisClient:
        c = LocalRatisClient(xceiver, dn_id)
        self._local[dn_id] = c
        return c

    def register_remote(self, dn_id: str, address: str) -> None:
        with self._lock:
            old = None
            if self._remote_addr.get(dn_id) != address:
                self._remote_addr[dn_id] = address
                old = self._remote.pop(dn_id, None)
        if old is not None:
            old.close()

    def maybe_get(self, dn_id: str) -> Optional[RatisClient]:
        c = self._local.get(dn_id)
        if c is not None:
            return c
        if self._address_source is not None:
            # re-resolve every time: a restarted datanode binds a new
            # port and the shared address book follows it
            fresh = self._address_source(dn_id)
            if fresh:
                self.register_remote(dn_id, fresh)
        with self._lock:
            ver = getattr(self.tls, "version", None)
            if ver != self._tls_ver:
                self._tls_ver = ver
                self._remote.clear()  # in-flight calls finish on theirs
            c = self._remote.get(dn_id)
            if c is None:
                addr = self._remote_addr.get(dn_id)
                if addr is None:
                    return None
                c = self._remote[dn_id] = RemoteRatisClient(dn_id, addr,
                                                            tls=self.tls)
            return c

    def close(self) -> None:
        with self._lock:
            clients = list(self._remote.values())
            self._remote.clear()
        for c in clients:
            c.close()

    def get(self, dn_id: str) -> RatisClient:
        c = self.maybe_get(dn_id)
        if c is None:
            raise KeyError(f"no ratis client for {dn_id}")
        return c
