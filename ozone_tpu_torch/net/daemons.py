"""Service daemons: the datanode and the SCM+OM metadata server.

Port of `ozone_tpu/net/daemons.py` (the reference's HddsDatanodeService
with the DatanodeStateMachine register -> heartbeat loop and command
handlers; StorageContainerManagerStarter and OzoneManagerStarter, here
co-located behind one server).

`DatanodeDaemon` serves the datanode verbs (`net/dn_service.py`), starts
the native chunk datapath sidecar (`storage/fast_datapath.py`) that the
bulk verbs ride and advertises it through `GetDatapathInfo` (on unless
OZONE_TPU_NATIVE_DATAPATH=0; a sidecar that cannot be built or bound
raises, the daemon never serves the RPC alone in its place), registers with the SCM with its filesystem capacity, heartbeats with a
full container report whenever one changed (or every 10 s), and runs the
commands that come back: close, EC reconstruction on the port's
`ECReconstructionCoordinator`, replication (a container export pulled
from the source and imported here), replica deletion and block
deletion. A background loop scrubs one closed container per tick on the
port's `DeviceScrubber`. The codec runs on `device` ("cuda" by default,
raising when CUDA is absent; "cpu" runs the plain versions). A command
that fails is logged and its error raised from the heartbeat that ran
it; nothing is re-run on the CPU.

`ScmOmDaemon` runs the SCM and the OM behind one RPC server, with the
SCM's control loops and the OM's key-deleting service on a background
thread, and turns a container going CLOSING into close commands to its
replicas. The same thread runs the lifecycle sweep and the slab
compaction every OZONE_TPU_LIFECYCLE_PERIOD_S (60 s) on the OM's
`LifecycleService`, whose datanode clients follow the heartbeat-learned
address book; a `lifecycle run-now` runs the same service. Its codec (the
tiering encode, the compaction's slab flush) runs on `device`, resolved
at the first sweep that has work for it.

Left out: HA (so the sweeper's fencing term is 0), secure mode and
certificate enrolment, block tokens, raft pipelines, operational state,
Recon, the HTTP server, geo replication and its cadence, and sharding.
"""

from __future__ import annotations

import logging
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

from ozone_tpu_torch.client import native_dn
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.net.dn_service import DatanodeRpcService
from ozone_tpu_torch.net.om_service import OmRpcService
from ozone_tpu_torch.net.rpc import RpcServer
from ozone_tpu_torch.net.scm_service import RemoteScmClient, ScmRpcService
from ozone_tpu_torch.om.om import OzoneManager
from ozone_tpu_torch.scm.block_deletion import DeleteBlocksCommand
from ozone_tpu_torch.scm.replication_manager import (
    DeleteReplicaCommand,
    ReplicateCommand,
)
from ozone_tpu_torch.scm.scm import StorageContainerManager
from ozone_tpu_torch.storage.container_packer import import_container
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.fast_datapath import DatapathSidecar
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.storage.reconstruction import (
    ECReconstructionCoordinator,
    ReconstructionCommand,
)
from ozone_tpu_torch.storage.scrubber import SCANNABLE_STATES, DeviceScrubber

log = logging.getLogger(__name__)


class DatanodeDaemon:
    """Datanode process: the RPC service and the SCM heartbeat/command loop."""

    #: a full container report goes out at least this often
    FULL_REPORT_EVERY_S = 10.0

    def __init__(
        self,
        root: Path,
        dn_id: str,
        scm_address: str,
        host: str = "127.0.0.1",
        port: int = 0,
        rack: str = "/default-rack",
        heartbeat_interval_s: float = 1.0,
        scan_interval_s: float = 300.0,
        device="cuda",
    ):
        # first: a datanode that cannot reach its device refuses to start
        self.device = resolve_device(device)
        self.dn = Datanode(Path(root), dn_id=dn_id)
        #: the native datapath sidecar, or None when it is turned off
        self.datapath: Optional[DatapathSidecar] = None
        try:
            if native_dn.enabled():
                self.datapath = DatapathSidecar(self.dn, host=host)
                self.datapath.start()  # raises when it cannot build or bind
            self.server = RpcServer(host, port)
        except BaseException:
            self.stop_datapath()
            self.dn.close()
            raise
        self.service = DatanodeRpcService(self.dn, self.server,
                                          datapath_port=self.advertise)
        self.scm = RemoteScmClient(scm_address)
        self.rack = rack
        self.heartbeat_interval = heartbeat_interval_s
        # peer clients for reconstruction and replication
        self.clients = DatanodeClientFactory()
        self.clients.register_local(self.dn)
        self.reconstruction = ECReconstructionCoordinator(
            self.clients, device=self.device)
        self.scan_interval = scan_interval_s
        self._scrubber = DeviceScrubber(device=self.device)
        self._scan_cursor = 0
        self._pending_acks: list[int] = []
        self._last_report_fp = None
        self._last_report_t = 0.0
        self._last_used = 0
        self._stop = threading.Event()
        self._hb: Optional[threading.Thread] = None
        self._scanner: Optional[threading.Thread] = None
        #: commands that raised, by type name
        self.failed_commands: dict[str, int] = {}

    @property
    def address(self) -> str:
        return self.server.address

    def advertise(self) -> Optional[dict]:
        """GetDatapathInfo's answer: the sidecar's port and unix socket."""
        return self.datapath.advertise() if self.datapath else None

    def lane_counts(self) -> dict:
        """Chunk traffic served by each lane since start: the native
        datapath's write and read streams, and the RPC's chunk verbs."""
        return {k: self.dn.metrics.counter(k).value
                for k in ("native_write_streams", "native_read_streams",
                          "rpc_chunk_calls")}

    def stop_datapath(self) -> None:
        if self.datapath is not None:
            self.datapath.stop()

    def _capacity_bytes(self) -> int:
        """Capacity of the filesystem under the datanode's volume."""
        return shutil.disk_usage(self.dn.root).total

    def _register(self) -> None:
        self.scm.register(self.dn.id, self.address, rack=self.rack,
                          capacity_bytes=self._capacity_bytes())

    def start(self) -> None:
        self.server.start()
        try:
            self._register()
        except StorageError as e:
            if e.code != "UNAVAILABLE":
                raise
            # the SCM is not up yet: heartbeats retry, and the SCM answers
            # an unknown node's heartbeat with a register command
            log.warning("%s: SCM unreachable at start (%s); registering on "
                        "a later heartbeat", self.dn.id, e.msg)
        self._hb = threading.Thread(target=self._heartbeat_loop,
                                    name=f"hb-{self.dn.id}", daemon=True)
        self._hb.start()
        if self.scan_interval and self.scan_interval > 0:
            self._scanner = threading.Thread(target=self._scan_loop,
                                             name=f"scan-{self.dn.id}",
                                             daemon=True)
            self._scanner.start()

    # -------------------------------------------------------------- scrub
    def scan_once(self) -> Optional[list[str]]:
        """Scrub the next closed container in round-robin order on the
        device (the background scanner's unit of work); its errors, or
        None when there is nothing to scan. A scrubbed-bad replica goes
        UNHEALTHY and the next container report carries it to the SCM."""
        containers = [c for c in self.dn.list_containers()
                      if c.state in SCANNABLE_STATES]
        if not containers:
            return None
        c = containers[self._scan_cursor % len(containers)]
        self._scan_cursor += 1
        errs = self._scrubber.scrub_container(self.dn, c.id)
        if errs:
            log.warning("%s: container %d failed scrub: %s",
                        self.dn.id, c.id, errs[:4])
        return errs

    def _scan_loop(self) -> None:
        while not self._stop.wait(self.scan_interval):
            try:
                self.scan_once()
            except Exception:
                log.exception("%s background scan failed", self.dn.id)

    # ---------------------------------------------------------- heartbeat
    def heartbeat_once(self) -> None:
        """One heartbeat: a full container report when one changed (or
        every FULL_REPORT_EVERY_S), then every command that came back. A
        command that raises is logged; the first such error is raised
        once all commands ran."""
        fp = (self.dn.mutation_count,
              tuple(sorted((c.id, c.state.value) for c in self.dn.containers)))
        now = time.monotonic()
        report = None
        if fp != self._last_report_fp \
                or now - self._last_report_t >= self.FULL_REPORT_EVERY_S:
            report = self.dn.container_report()
            self._last_used = sum(r["used_bytes"] for r in report)
        acks, self._pending_acks = self._pending_acks, []
        try:
            commands = self.scm.heartbeat(self.dn.id, container_report=report,
                                          used_bytes=self._last_used,
                                          deleted_block_acks=acks)
        except BaseException:
            self._pending_acks = acks + self._pending_acks
            raise
        if report is not None:  # only a delivered report counts
            self._last_report_fp = fp
            self._last_report_t = now
        first: Optional[BaseException] = None
        for cmd in commands:
            try:
                self.execute(cmd)
            except Exception as e:
                name = type(cmd).__name__ if not isinstance(cmd, dict) \
                    else cmd.get("type", "dict")
                self.failed_commands[name] = \
                    self.failed_commands.get(name, 0) + 1
                log.exception("%s command %r failed", self.dn.id, cmd)
                first = first or e
        if first is not None:
            raise first

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self.heartbeat_once()
            except Exception:
                log.exception("%s heartbeat failed", self.dn.id)

    def _learn_topology(self) -> None:
        """One NodeAddresses round trip feeds the address book."""
        try:
            addresses, locations = self.scm.node_topology()
        except (StorageError, OSError):
            return  # the command's own peers may still be known
        for dn_id, addr in addresses.items():
            if dn_id != self.dn.id:
                self.clients.update_remote(dn_id, addr)
        self.clients.learn_locations(locations)

    def execute(self, cmd) -> None:
        """Run one SCM command; raises when it fails."""
        if isinstance(cmd, DeleteBlocksCommand):
            for bid in cmd.blocks:
                try:
                    self.dn.delete_block(bid)
                except StorageError as e:  # idempotent: still acked
                    log.warning("%s: delete of block %s failed: %s",
                                self.dn.id, bid, e)
            self._pending_acks.extend(cmd.tx_ids)
        elif isinstance(cmd, ReconstructionCommand):
            self._learn_topology()
            self.reconstruction.reconstruct_container_group(cmd)
        elif isinstance(cmd, DeleteReplicaCommand):
            self.dn.delete_container(cmd.container_id, force=True)
        elif isinstance(cmd, ReplicateCommand):
            self._learn_topology()
            self._replicate(cmd)
        elif isinstance(cmd, dict) and cmd.get("type") == "register":
            self._register()
        elif isinstance(cmd, dict) and cmd.get("type") == "close-container":
            try:
                self.dn.close_container(int(cmd["container_id"]))
            except StorageError:  # already closed, or not here yet
                pass
        else:
            log.debug("%s ignoring command %r", self.dn.id, cmd)

    def _replicate(self, cmd: ReplicateCommand) -> None:
        """Pull the source's packed replica and import it here
        (DownloadAndImportReplicator)."""
        data = self.clients.get(cmd.source).export_container(
            cmd.container_id)
        import_container(self.dn, data, replica_index=cmd.replica_index,
                         expect_id=cmd.container_id)

    def stop(self) -> None:
        self._stop.set()
        for t in (self._hb, self._scanner):
            if t is not None:
                t.join(timeout=5)
        self.server.stop()
        self.stop_datapath()
        self.scm.close()
        self.clients.close()
        self.dn.close()


class ScmOmDaemon:
    """Metadata server process: SCM + OM behind one RPC endpoint."""

    def __init__(
        self,
        om_db: Path,
        host: str = "127.0.0.1",
        port: int = 0,
        min_datanodes: int = 1,
        block_size: int = 16 * 1024 * 1024,
        container_size: int = 256 * 1024 * 1024,
        stale_after_s: float = 9.0,
        dead_after_s: float = 30.0,
        background_interval_s: float = 1.0,
        placement_seed: Optional[int] = None,
        device="cuda",
    ):
        self.scm = StorageContainerManager(
            min_datanodes=min_datanodes, container_size=container_size,
            placement_seed=placement_seed, stale_after_s=stale_after_s,
            dead_after_s=dead_after_s)
        self.server = RpcServer(host, port)
        self.scm_service = ScmRpcService(self.scm, self.server)
        self.scm.containers.on_container_closing = self._announce_close
        self.om = OzoneManager(Path(om_db), self.scm, block_size=block_size)
        self.om_service = OmRpcService(
            self.om, self.server,
            addresses_provider=lambda: dict(self.scm_service.addresses),
            locations_provider=self.scm_service.node_locations,
            scm_lock=self.scm_service.lock)
        self._bg_interval = background_interval_s
        self._bg_stop = threading.Event()
        self._bg: Optional[threading.Thread] = None
        # the lifecycle sweeper: leader-singleton and term-fenced in the
        # reference; here the only OM, at term 0. Its datanode clients
        # resolve lazily from heartbeat-learned addresses, and
        # OZONE_TPU_LIFECYCLE_MBPS paces its source reads
        from ozone_tpu_torch.lifecycle.service import LifecycleService
        from ozone_tpu_torch.utils.config import env_float

        self._lifecycle_clients: Optional[DatanodeClientFactory] = None
        mbps = env_float("OZONE_TPU_LIFECYCLE_MBPS", 0.0)
        throttle = None
        if mbps > 0:
            from ozone_tpu_torch.utils.throttle import Throttle

            throttle = Throttle(mbps * 1024 * 1024, metrics=self.om.metrics)
        self.lifecycle = LifecycleService(
            self.om, clients_fn=self._lifecycle_client_factory,
            throttle=throttle,
            # tighter than the standalone 300 s: the sweep shares the
            # background thread with the SCM loops and key deletion
            sweep_deadline_s=env_float("OZONE_TPU_LIFECYCLE_DEADLINE_S",
                                       30.0),
            device=device)
        self.om.lifecycle = self.lifecycle
        self.om.scm_lock = self.scm_service.lock
        #: seconds between lifecycle sweeps (and slab compactions)
        self._lc_period = env_float("OZONE_TPU_LIFECYCLE_PERIOD_S", 60.0)
        self._lc_last = time.monotonic()

    @property
    def address(self) -> str:
        return self.server.address

    def _announce_close(self, c) -> None:
        """A container went CLOSING: every replica gets a close command on
        its next heartbeat; their CLOSED reports mark it CLOSED."""
        for dn in (c.pipeline.nodes if c.pipeline else []):
            self.scm.nodes.queue_command(
                dn, {"type": "close-container", "container_id": c.id})

    def _lifecycle_client_factory(self) -> DatanodeClientFactory:
        """Datanode clients for the lifecycle executor, refreshed from the
        heartbeat-learned address book before each sweep."""
        if self._lifecycle_clients is None:
            self._lifecycle_clients = DatanodeClientFactory()
        for dn_id, addr in dict(self.scm_service.addresses).items():
            # update, not register: an unchanged address keeps its
            # pooled connection
            self._lifecycle_clients.update_remote(dn_id, addr)
        self._lifecycle_clients.learn_locations(
            self.scm_service.node_locations())
        return self._lifecycle_clients

    def run_background_once(self) -> None:
        """One pass of the SCM's control loops and the OM's key-deleting
        service; every OZONE_TPU_LIFECYCLE_PERIOD_S, a lifecycle sweep
        and a slab compaction after it (outside the SCM lock: they
        allocate blocks and write to datanodes through the RPC)."""
        with self.scm_service.lock:
            self.scm.run_background_once()
            self.om.run_key_deleting_service_once()
        now = time.monotonic()
        if now - self._lc_last >= self._lc_period:
            self._lc_last = now
            self.lifecycle.run_once()
            self.lifecycle.compact_slabs_once()

    def start(self) -> None:
        self.server.start()

        def loop():
            while not self._bg_stop.wait(self._bg_interval):
                try:
                    self.run_background_once()
                except Exception:
                    log.exception("metadata background pass failed")

        self._bg = threading.Thread(target=loop, name="scm-om-background",
                                    daemon=True)
        self._bg.start()

    def stop(self) -> None:
        self._bg_stop.set()
        if self._bg is not None:
            self._bg.join(timeout=30)
        self.server.stop()
        if self._lifecycle_clients is not None:
            self._lifecycle_clients.close()
        self.om.close()
