"""CSI driver: Identity / Controller / Node services.

Port of `ozone_tpu/gateway/csi.py` (the reference's CSI gateway, CsiServer:
the Container Storage Interface through which Kubernetes provisions
Ozone-backed volumes — ControllerService creates a bucket per volume,
NodeService publishes it as a mount via the goofys s3 FUSE daemon pointed
at the s3 gateway).

Shape here: the three CSI services with their standard verbs served over
the port's standard-library RPC (net/rpc.py services with the net/wire.py
envelope rather than gRPC and the CSI protobufs; same verb surface). It
runs no codec, so it imports no torch. Volume provisioning creates a bucket in the s3 volume,
exactly like the reference; NodePublishVolume materializes the target
path and drops a mount descriptor pointing at the s3 gateway endpoint
(the FUSE data plane the reference shells out to goofys for is external
to the driver in both designs).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.rpc import RpcServer
from ozone_tpu_torch.om.requests import OMError
from ozone_tpu_torch.storage.ids import StorageError

log = logging.getLogger(__name__)

#: the S3 gateway's volume (gateway/s3.py S3_VOLUME), where CSI volumes
#: live as buckets
S3_VOLUME = "s3v"

_OM_ERRORS = (OMError, StorageError)

IDENTITY = "csi.v1.Identity"
CONTROLLER = "csi.v1.Controller"
NODE = "csi.v1.Node"


class CsiServer:
    """The three CSI services on one RPC server (CsiServer.java wires
    IdentityService + ControllerService + NodeService the same way)."""

    def __init__(self, client, s3_endpoint: str = "",
                 host: str = "127.0.0.1", port: int = 0,
                 replication: Optional[str] = None,
                 default_volume_size: int = 1024 * 1024 * 1024):
        self.client = client
        self.s3_endpoint = s3_endpoint
        self.replication = replication
        self.default_volume_size = default_volume_size
        try:
            client.om.create_volume(S3_VOLUME)
        except _OM_ERRORS:
            pass
        self.server = RpcServer(host, port)
        self.server.add_service(IDENTITY, {
            "GetPluginInfo": self._get_plugin_info,
            "GetPluginCapabilities": self._get_plugin_capabilities,
            "Probe": self._probe,
        })
        self.server.add_service(CONTROLLER, {
            "CreateVolume": self._create_volume,
            "DeleteVolume": self._delete_volume,
            "ValidateVolumeCapabilities": self._validate_capabilities,
            "ControllerGetCapabilities": self._controller_capabilities,
            "ListVolumes": self._list_volumes,
        })
        self.server.add_service(NODE, {
            "NodePublishVolume": self._node_publish,
            "NodeUnpublishVolume": self._node_unpublish,
            "NodeGetInfo": self._node_get_info,
            "NodeGetCapabilities": self._node_capabilities,
        })

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self) -> str:
        return self.server.address

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    # ------------------------------------------------------------ identity
    def _get_plugin_info(self, req: bytes) -> bytes:
        return wire.pack({
            "name": "org.apache.hadoop.ozone.tpu",
            "vendor_version": "1.0",
        })

    def _get_plugin_capabilities(self, req: bytes) -> bytes:
        return wire.pack({
            "capabilities": ["CONTROLLER_SERVICE"],
        })

    def _probe(self, req: bytes) -> bytes:
        # liveness: prove the OM answers
        try:
            self.client.om.list_buckets(S3_VOLUME)
            ready = True
        except Exception:  # noqa: BLE001
            ready = False
        return wire.pack({"ready": ready})

    # ------------------------------------------------------------ controller
    def _create_volume(self, req: bytes) -> bytes:
        m, _ = wire.unpack(req)
        name = m["name"]
        size = int(m.get("capacity_bytes") or self.default_volume_size)
        try:
            if self.replication:
                self.client.om.create_bucket(S3_VOLUME, name,
                                             self.replication)
            else:
                self.client.om.create_bucket(S3_VOLUME, name)
        except _OM_ERRORS as e:
            # CSI CreateVolume is idempotent
            if getattr(e, "code", "") != "BUCKET_ALREADY_EXISTS":
                raise StorageError("IO_EXCEPTION", str(e))
        return wire.pack({
            "volume": {"volume_id": name, "capacity_bytes": size},
        })

    def _delete_volume(self, req: bytes) -> bytes:
        m, _ = wire.unpack(req)
        try:
            self.client.om.delete_bucket(S3_VOLUME, m["volume_id"])
        except _OM_ERRORS as e:
            if getattr(e, "code", "") != "BUCKET_NOT_FOUND":
                raise StorageError("IO_EXCEPTION", str(e))
        return wire.pack({})

    def _validate_capabilities(self, req: bytes) -> bytes:
        m, _ = wire.unpack(req)
        self.client.om.bucket_info(S3_VOLUME, m["volume_id"])
        return wire.pack({"confirmed": True})

    def _controller_capabilities(self, req: bytes) -> bytes:
        return wire.pack({
            "capabilities": ["CREATE_DELETE_VOLUME"],
        })

    def _list_volumes(self, req: bytes) -> bytes:
        buckets = self.client.om.list_buckets(S3_VOLUME)
        return wire.pack({
            "entries": [
                {"volume_id": b["name"]} for b in buckets
            ],
        })

    # ------------------------------------------------------------ node
    def _node_publish(self, req: bytes) -> bytes:
        """Record the mount: materialize target_path and write the
        descriptor the data-plane mounter (goofys-equivalent, pointed at
        our s3 gateway) consumes. Reference NodeService.nodePublishVolume
        execs `goofys --endpoint <s3g> <bucket> <target>`."""
        m, _ = wire.unpack(req)
        target = Path(m["target_path"])
        target.mkdir(parents=True, exist_ok=True)
        desc = {
            "volume_id": m["volume_id"],
            "bucket": m["volume_id"],
            "s3_endpoint": self.s3_endpoint,
            "readonly": bool(m.get("readonly", False)),
        }
        (target / ".ozone-csi.json").write_text(json.dumps(desc))
        return wire.pack({})

    def _node_unpublish(self, req: bytes) -> bytes:
        m, _ = wire.unpack(req)
        target = Path(m["target_path"])
        desc = target / ".ozone-csi.json"
        if desc.exists():
            desc.unlink()
        if target.is_dir() and not any(target.iterdir()):
            target.rmdir()
        return wire.pack({})

    def _node_get_info(self, req: bytes) -> bytes:
        import socket

        return wire.pack({"node_id": socket.gethostname()})

    def _node_capabilities(self, req: bytes) -> bytes:
        return wire.pack({"capabilities": []})


class CsiClient:
    """Client half, for tests and the CLI (what the kubelet/external-
    provisioner side would invoke)."""

    def __init__(self, address: str):
        from ozone_tpu_torch.net.rpc import RpcChannel

        self._ch = RpcChannel(address)

    def _call(self, service: str, method: str, **m) -> dict:
        out, _ = wire.unpack(self._ch.call(service, method, wire.pack(m)))
        return out

    # identity
    def plugin_info(self) -> dict:
        return self._call(IDENTITY, "GetPluginInfo")

    def probe(self) -> dict:
        return self._call(IDENTITY, "Probe")

    # controller
    def create_volume(self, name: str, capacity_bytes: int = 0) -> dict:
        return self._call(CONTROLLER, "CreateVolume", name=name,
                          capacity_bytes=capacity_bytes)

    def delete_volume(self, volume_id: str) -> dict:
        return self._call(CONTROLLER, "DeleteVolume", volume_id=volume_id)

    def list_volumes(self) -> list[dict]:
        return self._call(CONTROLLER, "ListVolumes")["entries"]

    def validate(self, volume_id: str) -> dict:
        return self._call(CONTROLLER, "ValidateVolumeCapabilities",
                          volume_id=volume_id)

    # node
    def publish(self, volume_id: str, target_path: str,
                readonly: bool = False) -> dict:
        return self._call(NODE, "NodePublishVolume", volume_id=volume_id,
                          target_path=target_path, readonly=readonly)

    def unpublish(self, volume_id: str, target_path: str) -> dict:
        return self._call(NODE, "NodeUnpublishVolume",
                          volume_id=volume_id, target_path=target_path)

    def node_info(self) -> dict:
        return self._call(NODE, "NodeGetInfo")

    def close(self) -> None:
        self._ch.close()
