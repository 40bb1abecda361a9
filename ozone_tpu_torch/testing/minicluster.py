"""MiniOzoneCluster: a whole cluster in one process.

Port of `MiniOzoneCluster` from `ozone_tpu/testing/minicluster.py` (the
reference's MiniOzoneClusterImpl): a StorageContainerManager, an
OzoneManager and N Datanodes wired through the in-process client
factory, with a manual or background heartbeat pump and a command loop
that runs the SCM's commands on the datanodes the way
DatanodeStateMachine's handlers do: reconstruction on the port's
`ECReconstructionCoordinator` (the mesh executor when two or more CUDA
devices are attached, else the default mesh policy, which is no mesh on
one device), block deletion,
replica deletion and container copies; `run_deletion_services` reaps what
deletes leave (FSO subtrees, then blocks) as a daemon's background pass
does. The codec runs on `device`
("cuda" launches the fused kernel and raises when CUDA is absent; "cpu"
runs its plain version).

`MiniOzoneHACluster` (the reference's MiniOzoneHAClusterImpl) boots N
`ScmOmDaemon` replicas on one metadata ring over the port's RPC and M
`DatanodeDaemon`s heartbeating every replica, hands out failover-aware
clients, and stops and revives replicas by id. With `secure=True` every
channel runs mutual TLS: the first replica hosts the cluster CA and its
enrollment endpoint (`enroll_address`), the other replicas and the
datanodes enroll there with `enrollment_secret`, and `client()` presents
a client certificate enrolled the same way. The OM's KMS (TDE and GDPR
buckets) needs nothing more: `om.kms_create_key`, then
`om.create_bucket(..., encryption_key=...)` or `gdpr=True`, on either
cluster. `make_meta_daemon` and
`await_meta_leader` are the helpers the HA tests share.

`MiniShardedCluster` (the reference's) is the sharded metadata plane
over the port's RPC: one single-replica ScmOmDaemon per shard, each
booted with its replicated ownership row and a copy of the root shard
map, and shard-aware `RemoteOmClient`s (`om_client`) that route by the
fetched map; `move_slot` is the operator's rebalance under live clients.
It is metadata-only, as in the reference: each daemon embeds its own
SCM, so their container ids would collide; data-path drills run on the
in-process `ShardedMetaPlane` (`om/sharding/plane.py`), whose shards
share one SCM.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from pathlib import Path
from typing import Optional

from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ozone_client import OzoneClient
from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.om.om import OzoneManager
from ozone_tpu_torch.parallel import mesh_executor
from ozone_tpu_torch.parallel.sharded import default_codec_mesh
from ozone_tpu_torch.scm.block_deletion import DeleteBlocksCommand
from ozone_tpu_torch.scm.replication_manager import (
    DeleteReplicaCommand,
    ReplicateCommand,
)
from ozone_tpu_torch.scm.scm import StorageContainerManager
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import BlockData, StorageError
from ozone_tpu_torch.storage.reconstruction import (
    ECReconstructionCoordinator,
    ReconstructionCommand,
)

log = logging.getLogger(__name__)


class MiniOzoneCluster:
    def __init__(
        self,
        root: Path,
        num_datanodes: int = 5,
        racks: int = 1,
        block_size: int = 16 * 1024 * 1024,
        container_size: int = 256 * 1024 * 1024,
        stale_after_s: float = 9.0,
        dead_after_s: float = 30.0,
        placement_seed: Optional[int] = 42,
        device="cuda",
    ):
        self.root = Path(root)
        self.device = resolve_device(device)
        self.scm = StorageContainerManager(
            min_datanodes=min(num_datanodes, 1),
            container_size=container_size,
            placement_seed=placement_seed,
            stale_after_s=stale_after_s,
            dead_after_s=dead_after_s,
        )
        self.clients = DatanodeClientFactory()
        self.datanodes: list[Datanode] = []
        for i in range(num_datanodes):
            dn = Datanode(self.root / f"dn{i}", dn_id=f"dn{i}")
            self.datanodes.append(dn)
            self.clients.register_local(dn)
            rack = f"/rack{i % racks}" if racks > 1 else "/default-rack"
            self.scm.register_datanode(dn.id, rack=rack,
                                       capacity_bytes=10 * container_size)
        self.om = OzoneManager(self.root / "om" / "om.db", self.scm,
                               block_size=block_size, clients=self.clients,
                               device=self.device)
        # repair decodes: the persistent mesh executor when it can exist
        # (it coalesces batches across containers), else the DP mesh of
        # every local GPU, else one device
        ex = mesh_executor.maybe_executor() if self.device.type == "cuda" else None
        self.reconstruction = ECReconstructionCoordinator(
            self.clients, device=self.device,
            mesh=None if ex is not None or self.device.type != "cuda"
            else default_codec_mesh(),
            executor=ex)
        self._stopped_dns: set[str] = set()
        self._hb_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ----------------------------------------------------------------- client
    def client(self) -> OzoneClient:
        return OzoneClient(self.om, self.clients, device=self.device)

    def datanode(self, dn_id: str) -> Datanode:
        return next(d for d in self.datanodes if d.id == dn_id)

    # -------------------------------------------------------------- liveness
    def stop_datanode(self, dn_id: str) -> None:
        """Simulate a crash: stop heartbeating and unregister the client so
        IO to this node fails."""
        self._stopped_dns.add(dn_id)
        self.clients._local.pop(dn_id, None)

    def restart_datanode(self, dn_id: str) -> None:
        self._stopped_dns.discard(dn_id)
        self.clients.register_local(self.datanode(dn_id))

    # -------------------------------------------------------------- heartbeat
    def heartbeat_all(self, with_reports: bool = True) -> None:
        """One heartbeat round: every live datanode reports and runs the
        commands it gets back."""
        for dn in self.datanodes:
            if dn.id in self._stopped_dns:
                continue
            report = dn.container_report() if with_reports else None
            commands = self.scm.heartbeat(dn.id, container_report=report)
            for cmd in commands:
                self._execute_command(dn, cmd)

    def _execute_command(self, dn: Datanode, cmd) -> None:
        try:
            if isinstance(cmd, DeleteBlocksCommand):
                for bid in cmd.blocks:
                    try:
                        dn.delete_block(bid)
                    except StorageError:
                        pass
                self.scm.deleted_blocks.ack(dn.id, cmd.tx_ids)
            elif isinstance(cmd, ReconstructionCommand):
                self.reconstruction.reconstruct_container_group(cmd)
                for idx in cmd.targets:
                    self.scm.replication.op_completed(cmd.container_id, idx)
            elif isinstance(cmd, DeleteReplicaCommand):
                dn.delete_container(cmd.container_id, force=True)
            elif isinstance(cmd, ReplicateCommand):
                self._replicate_container(cmd)
                self.scm.replication.op_completed(cmd.container_id)
            else:
                log.debug("ignoring command %r", cmd)
        except Exception:
            log.exception("command %r failed on %s", cmd, dn.id)
            if isinstance(cmd, ReconstructionCommand):
                for idx in cmd.targets:
                    self.scm.replication.op_completed(cmd.container_id, idx)
            elif isinstance(cmd, ReplicateCommand):
                self.scm.replication.op_completed(cmd.container_id)

    def _replicate_container(self, cmd: ReplicateCommand) -> None:
        """In-process container copy (DownloadAndImportReplicator)."""
        src = self.clients.get(cmd.source)
        dst = self.clients.get(cmd.target)
        blocks = src.list_blocks(cmd.container_id)
        try:
            dst.create_container(cmd.container_id, cmd.replica_index)
        except StorageError as e:
            if e.code != "CONTAINER_EXISTS":
                raise
        for bd in blocks:
            for info in bd.chunks:
                data = src.read_chunk(bd.block_id, info)
                dst.write_chunk(bd.block_id, info, data)
            dst.put_block(
                BlockData(bd.block_id, bd.chunks, bd.block_group_length)
            )
        dst.close_container(cmd.container_id)

    def tick(self, rounds: int = 1) -> None:
        """Heartbeats and the SCM's control loops, n times."""
        for _ in range(rounds):
            self.heartbeat_all()
            self.scm.run_background_once()
            self.heartbeat_all()  # deliver the commands the scan emitted

    def run_deletion_services(self) -> int:
        """Reap what deletes left behind, as the daemon's background pass
        does: detached FSO subtrees into the deleted-key chain, its
        blocks into the SCM's deletion log, and the deletes out to the
        datanodes over heartbeats. Returns the keys purged."""
        from ozone_tpu_torch.om.fso import DirectoryDeletingService

        DirectoryDeletingService(self.om).run_to_completion()
        purged = 0
        while True:
            n = self.om.run_key_deleting_service_once()
            if n == 0:
                break
            purged += n
        self.tick()
        return purged

    def start_heartbeats(self, interval_s: float = 0.5) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    log.exception("heartbeat tick failed")

        self._hb_thread = threading.Thread(
            target=loop, name="mini-heartbeats", daemon=True
        )
        self._hb_thread.start()

    # ----------------------------------------------------------------- admin
    def close(self) -> None:
        self._stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=5)
        self.scm.stop()
        self.om.close()
        for dn in self.datanodes:
            dn.close()


def free_ports(n: int) -> list[int]:
    """n distinct free loopback ports (bound together, then released)."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class MiniOzoneHACluster:
    """A metadata ring of `num_meta` ScmOmDaemons and `num_datanodes`
    DatanodeDaemons (on `racks` racks, round robin) in one process, all
    over the port's RPC (mutual TLS with `secure`). Extra keywords go to
    every ScmOmDaemon."""

    def __init__(self, root: Path, num_meta: int = 3,
                 num_datanodes: int = 5,
                 block_size: int = 256 * 1024,
                 heartbeat_interval_s: float = 0.15,
                 device="cuda", racks: int = 1, secure: bool = False,
                 enrollment_secret: str = "mini-cluster-secret", **meta_kw):
        from ozone_tpu_torch.net.daemons import DatanodeDaemon

        self.root = Path(root)
        self.block_size = block_size
        self.device = device
        self._meta_kw = meta_kw
        ports = free_ports(num_meta + 1)
        self.peers = {f"m{i}": f"127.0.0.1:{p}"
                      for i, p in enumerate(ports[:num_meta])}
        #: the primordial replica's enrollment endpoint (secure clusters)
        self.secure = secure
        self.enrollment_secret = enrollment_secret
        self.enroll_address = f"127.0.0.1:{ports[-1]}" if secure else None
        self._client_tls = None
        self.metas: dict = {}
        self.datanodes: list = []
        try:
            for mid in self.peers:
                d = self._make_meta(mid)
                d.start()
                self.metas[mid] = d
            self.await_leader()
            scm_addrs = ",".join(self.peers.values())
            for i in range(num_datanodes):
                d = DatanodeDaemon(self.root / f"dn{i}", f"dn{i}", scm_addrs,
                                   rack=f"/rack{i % racks}",
                                   heartbeat_interval_s=heartbeat_interval_s,
                                   device=device,
                                   ca_address=self.enroll_address,
                                   enrollment_secret=(enrollment_secret
                                                      if secure else None))
                d.start()
                self.datanodes.append(d)
        except BaseException:
            self.shutdown()
            raise

    def _make_meta(self, mid: str):
        kw = dict(block_size=self.block_size, device=self.device)
        if self.secure:
            kw.update(secure=True, enrollment_secret=self.enrollment_secret)
            if mid == "m0":  # the primordial replica hosts the CA
                kw["enroll_port"] = int(self.enroll_address.rsplit(":", 1)[1])
            else:
                kw["ca_address"] = self.enroll_address
        kw.update(self._meta_kw)
        return make_meta_daemon(self.root, int(mid[1:]), self.peers, **kw)

    def client_tls(self):
        """The clients' certificate (secure clusters; None otherwise),
        enrolled once under <root>/client-certs."""
        if self.secure and self._client_tls is None:
            from ozone_tpu_torch.utils.ca import CertificateClient

            cc = CertificateClient(self.root / "client-certs", "client-cli")
            if not cc.enrolled:
                cc.enroll_remote(self.enroll_address,
                                 secret=self.enrollment_secret)
            self._client_tls = cc.tls()
        return self._client_tls

    # ------------------------------------------------------------ control
    def await_leader(self, timeout: float = 15.0) -> str:
        return await_meta_leader(self.metas, timeout=timeout)

    def stop_meta(self, mid: str) -> None:
        self.metas.pop(mid).stop()

    def revive_meta(self, mid: str) -> None:
        d = self._make_meta(mid)
        d.start()
        self.metas[mid] = d

    # ------------------------------------------------------------ clients
    def client(self) -> OzoneClient:
        """An OzoneClient over a failover RemoteOmClient, with raft
        pipeline clients for RATIS/THREE keys."""
        from ozone_tpu_torch.net.om_service import RemoteOmClient
        from ozone_tpu_torch.net.ratis_service import RatisClientFactory
        from ozone_tpu_torch.net.scm_service import RemoteScmClient

        addrs = ",".join(self.peers.values())
        tls = self.client_tls()
        clients = DatanodeClientFactory()
        clients.tls = tls
        om = RemoteOmClient(addrs, clients=clients, tls=tls)
        # datanode addresses up front, so a client that reads before it
        # writes resolves the replicas
        scm = RemoteScmClient(addrs, tls=tls)
        try:
            for dn_id, addr in scm.node_addresses().items():
                clients.register_remote(dn_id, addr)
        except StorageError:
            pass  # learned from the allocations instead
        finally:
            scm.close()
        ratis = RatisClientFactory(address_source=clients.remote_address,
                                   tls=tls)
        return OzoneClient(om, clients, device=self.device,
                           ratis_clients=ratis)

    def shutdown(self) -> None:
        for d in self.datanodes:
            d.stop()
        for d in list(self.metas.values()):
            d.stop()
        self.metas.clear()
        self.datanodes = []


class MiniShardedCluster:
    """The sharded metadata plane over the RPC: per-shard daemons with
    replicated shard configs, a root map served ungated through
    GetShardMap, and shard-aware remote clients that retry through
    SHARD_MOVED. Every daemon's OM takes `device`, resolved here, so
    "cuda" raises without CUDA."""

    def __init__(self, root: Path, n_shards: int = 2,
                 slot_count: int = 64, block_size: int = 256 * 1024,
                 device="cuda"):
        from ozone_tpu_torch.net.daemons import ScmOmDaemon
        from ozone_tpu_torch.om.sharding.shardmap import ShardMap

        self.root = Path(root)
        self.device = resolve_device(device)
        self.shard_ids = [f"s{i}" for i in range(n_shards)]
        addresses = {sid: f"127.0.0.1:{p}"
                     for sid, p in zip(self.shard_ids, free_ports(n_shards))}
        self.map = ShardMap.uniform(self.shard_ids, epoch=1,
                                    addresses=addresses,
                                    slot_count=slot_count)
        self.daemons: dict[str, ScmOmDaemon] = {}
        try:
            for sid in self.shard_ids:
                d = ScmOmDaemon(
                    self.root / sid / "om.db",
                    port=int(addresses[sid].rsplit(":", 1)[1]),
                    block_size=block_size, stale_after_s=1000.0,
                    dead_after_s=2000.0, background_interval_s=0.2,
                    device=self.device,
                    shard_config={"epoch": 1, "shard_id": sid,
                                  "slot_count": slot_count,
                                  "owned": self.map.owned_slots(sid)},
                    shard_map=self.map.to_json())
                d.start()
                self.daemons[sid] = d
        except BaseException:
            self.shutdown()
            raise

    def om_client(self):
        """A shard-aware remote OM client (it discovers the map itself)."""
        from ozone_tpu_torch.net.om_service import RemoteOmClient

        return RemoteOmClient(",".join(self.map.addresses.values()),
                              shard_aware=True)

    def move_slot(self, slot: int, to_sid: str):
        """The operator's rebalance: fence the source, copy the slot's
        rows, grant the target, publish the bumped map on every daemon.
        Clients holding the old map get SHARD_MOVED and refetch."""
        from ozone_tpu_torch.om.sharding.shardmap import (
            ImportRow,
            InstallShardConfig,
            InstallShardMap,
            slot_for,
        )

        new_map = self.map.move_slot(slot, to_sid)
        from_sid = self.map.shards[self.map.slots[slot]]
        src, dst = self.daemons[from_sid].om, self.daemons[to_sid].om
        src.submit(InstallShardConfig(
            epoch=new_map.epoch, shard_id=from_sid,
            slot_count=new_map.slot_count,
            owned=new_map.owned_slots(from_sid)))
        for vk, _ in list(src.store.iterate("volumes")):
            for bk, brow in list(src.store.iterate("buckets", vk + "/")):
                if slot_for(brow["volume"], brow["name"],
                            new_map.slot_count) != slot:
                    continue
                dst.submit(ImportRow("buckets", bk, brow))
                for table in ("keys", "open_keys", "deleted_keys",
                              "multipart", "dirs", "files",
                              "deleted_dirs"):
                    for k, row in list(src.store.iterate(table, bk + "/")):
                        dst.submit(ImportRow(table, k, row))
        dst.submit(InstallShardConfig(
            epoch=new_map.epoch, shard_id=to_sid,
            slot_count=new_map.slot_count,
            owned=new_map.owned_slots(to_sid)))
        for d in self.daemons.values():
            d.om.submit(InstallShardMap(new_map.to_json()))
        self.map = new_map
        return new_map

    def shutdown(self) -> None:
        for d in self.daemons.values():
            d.stop()
        self.daemons.clear()


def make_meta_daemon(root, i: int, peers: dict, **overrides):
    """One metadata-ring replica with test-friendly defaults; `peers`
    maps 'm<i>' -> host:port. Shared by the HA suites."""
    from ozone_tpu_torch.net.daemons import ScmOmDaemon

    kw = dict(stale_after_s=1000.0, dead_after_s=2000.0,
              background_interval_s=0.2, ha_id=f"m{i}", ha_peers=peers)
    kw.update(overrides)
    return ScmOmDaemon(Path(root) / f"meta{i}" / "om.db",
                       port=int(peers[f"m{i}"].rsplit(":", 1)[1]), **kw)


def await_meta_leader(metas: dict, timeout: float = 10.0, among=None) -> str:
    """Wait until exactly one replica (optionally among `among`) leads;
    returns its id."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [mid for mid, d in metas.items()
                   if (among is None or mid in among)
                   and d.ha is not None and d.ha.is_leader]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.05)
    raise AssertionError(f"no single leader among {among or list(metas)}")
