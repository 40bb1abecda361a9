"""Service daemons: the datanode and the SCM+OM metadata server.

Port of `ozone_tpu/net/daemons.py` (the reference's HddsDatanodeService
with the DatanodeStateMachine register -> heartbeat loop and command
handlers; StorageContainerManagerStarter and OzoneManagerStarter, here
co-located behind one server).

`DatanodeDaemon` serves the datanode verbs (`net/dn_service.py`), starts
the native chunk datapath sidecar (`storage/fast_datapath.py`) that the
bulk verbs ride and advertises it through `GetDatapathInfo` (on unless
OZONE_TPU_NATIVE_DATAPATH=0 or the daemon runs TLS; a sidecar that
cannot be built or bound raises, the daemon never serves the RPC alone
in its place), registers with the SCM with its filesystem capacity and
its full container report, heartbeats with a full container report
whenever one changed (or every 10 s), and runs the commands that come
back: close, EC reconstruction on the port's
`ECReconstructionCoordinator`, replication (a container export pulled
from the source and imported here), replica deletion and block
deletion. `replication_bandwidth_mbps` caps its replication traffic
(the reference's ReplicationSupervisor limit): one `Throttle` paces the
export frames it serves and is paid for each export it pulls before the
import. A background loop checks its volumes (a failed one's replicas
leave the next report) and scrubs one closed container per tick on the
port's `DeviceScrubber`; containers queued for an on-demand scan (a
write-fence violation) are scrubbed after each heartbeat once they are
writer-free. The SCM's `set-op-state` command (decommission,
maintenance) is persisted under the root (`op_state.json`) and echoed
at every registration, so a restarted SCM relearns a drain in flight.
Its peer clients read nearest-first from its own rack. The codec runs
on `device` ("cuda" by default, raising when CUDA is absent; "cpu" runs
the plain versions). A command that fails is logged, counted by type
(`failed_commands`, with the command and its error in
`command_errors`) and its error raised from the heartbeat that ran it;
nothing is re-run on the CPU.

Every datanode also hosts the raft groups of its RATIS pipelines
(`storage/ratis.RatisXceiverServer`, XceiverServerRatis): the SCM's
`join-pipeline` command opens a group (recorded in `ratis/groups.json`
and re-opened after a restart), `leave-pipeline` retires it, and a
RATIS container's close is ordered through its group (the leader
submits it; the others apply it from the log). The raft RPCs and the
client's Submit/Watch ride the same RpcServer.

`ScmOmDaemon` runs the SCM and the OM behind one RPC server, with the
SCM's control loops and the OM's key-deleting service on a background
thread, and turns a container going CLOSING into close commands to its
replicas and a RATIS pipeline's creation and retirement into join and
leave commands to its members. The same thread runs the lifecycle
sweep and the slab compaction every OZONE_TPU_LIFECYCLE_PERIOD_S (60 s)
on the OM's `LifecycleService`, whose datanode clients follow the
heartbeat-learned address book; a `lifecycle run-now` runs the same
service. Its codec (the tiering encode, the compaction's slab flush)
runs on `device`, resolved at the first sweep that has work for it. The
geo replication shipper (`replication_geo/shipper.py`) runs a cycle
every OZONE_TPU_GEO_PERIOD_S (30 s) on the same thread, over the same
datanode clients, within OZONE_TPU_GEO_DEADLINE_S (30 s), its source
reads paced by OZONE_TPU_GEO_MBPS, its destinations dialed with the
daemon's `tls`, its codec on `device`; a `replication run-now` runs it
too. A rule-less cluster ships, fences and checkpoints nothing.

With `ha_id` and `ha_peers` the daemon is one replica of the metadata
ring (`consensus/meta_ring.MetaHARing`, the reference's OM HA and SCM
HA on one ring): every OM write goes through the ring; the OM and SCM
services refuse clients on a replica that is not the ready leader
(OM_NOT_LEADER / SCM_NOT_LEADER with the leader's address), an
allocation is answered after its SCM decision records commit, the
container close and the ring's operator verbs go through the ring, and
the address book follows the ring's membership. Only the leader runs
the background loops; every replica compacts its own raft log. The
lifecycle sweeper and the geo shipper are fenced with the ring's term
and run on the ready leader only.

Block tokens (`ScmOmDaemon(block_tokens=True, secure=True)`, the
reference's hdds.block.token.enabled): the SCM mints and rotates the
secret keys (through the ring under HA), the OM signs a token onto every
allocation and lookup, and each datanode verifies them on its three
lanes (the RPC verbs, the native sidecar, the raft pipelines' Submit)
with one verifier. A datanode turns the verifier on at the first SCM
answer that says tokens are on, before it holds any key, so it fails
closed until the keys arrive; it then signs its own reconstruction and
replication traffic with an issuer over the keys it imported. The keys
ride Register and Heartbeat, so tokens need mutual TLS (`secure=True`,
below), or `insecure_secrets=True`, which sends them in the clear, for
tests. `acl_enabled`
turns the OM's native authorizer on (the superuser root passes every
check).

Mutual TLS (`ScmOmDaemon(secure=True)`, the reference's
hdds.grpc.tls.enabled posture with the root CA in the SCM): the
primordial metadata server hosts the cluster CA (`utils/ca.py`, under
`<db dir>/ca`), enrolls its own certificate (`<db dir>/certs`), serves
its main RPC over mutual TLS with the CRL checked on every call, and
signs CSRs on a separate plaintext enrollment server (`enroll_port`,
gated by `enrollment_secret`); the CA's `cert-list` and `cert-revoke`
answer there. Another HA replica (`ca_address`) enrolls at the
primordial one. A secure token-enforcing cluster needs an enrollment
secret (open CSR signing would let any caller into the trust domain);
the secret keys then ride only the mutual-TLS Register and Heartbeat.
`DatanodeDaemon(ca_address=..., enrollment_secret=...)` enrolls at the
enrollment endpoint (`<root>/certs`, its id among the certificate's
names), then runs everything over mutual TLS: its server, its SCM
client, its peers' datapath and raft channels. It starts no native
sidecar (the reference keeps mTLS clusters on the authenticated
channel). Its certificate renews in the background, served on the next
handshake with no restart; the trust bundle and CRL are refreshed with
it only when a secret authenticates the answers. A failed handshake is
never retried in plaintext.

Sharding (`om/sharding/`): `ScmOmDaemon(shard_config=..., shard_map=...)`
is one shard of the sharded metadata plane. It installs its replicated
ownership row (`InstallShardConfig`, enforced by the OM's `check_shard`)
and a copy of the root map (`InstallShardMap`, served by GetShardMap)
at construction, or, under HA, from the background loop once this
replica is the ready leader. Under HA with OZONE_TPU_OM_FOLLOWER_READS=1
a follower holding a live read lease answers the follower-read verbs at
the leader gate when it has applied the caller's `_min_applied`, and the
leader pushes its commit index after each write. `tools/shardd.py` runs
one such daemon as a process.

Upgrade (`utils/upgrade.py`): each datanode keeps its layout version in
`<root>/layout_version.json`, gates the streaming-write verbs on its RPC
and its native sidecar with it, reports it on every heartbeat, and
finalizes on the SCM's `finalize` command (the metadata daemon's
`admin finalizeupgrade`); the metadata services keep theirs beside the
SCM store. A store written by older software runs clamped before
finalization.

Observability: every daemon serves insight's verbs (`utils/insight.py`)
on its RPC server and ships its spans every 2 s to the metadata daemon's
`TraceCollector` (`utils/tracing.py`), whose own spans go straight in.
`ScmOmDaemon(http_port=...)` serves `/prom`, `/prof`, `/stacks`,
`/status` and `/reconfig` (`utils/http_server.py`) with three keys
reconfigurable live: `ozone.scm.stale.node.interval`,
`ozone.scm.dead.node.interval` and `ozone.om.block.size`.
`recon_port` serves Recon (`recon/recon.py`, its warehouse in
`<db dir>/recon.db`), whose tasks run on the background thread every
`recon_interval_s` (30 s), never per tick.
"""

from __future__ import annotations

import json
import logging
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

from ozone_tpu_torch.client import native_dn
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.net import wire
from ozone_tpu_torch.net.dn_service import DatanodeRpcService
from ozone_tpu_torch.net.om_service import OmRpcService
from ozone_tpu_torch.net.raft_transport import RaftRpcService
from ozone_tpu_torch.net.ratis_service import RatisRpcService
from ozone_tpu_torch.net.rpc import RpcServer
from ozone_tpu_torch.net.scm_service import RemoteScmClient, ScmRpcService
from ozone_tpu_torch.om.om import OzoneManager
# importing the sharding package registers its request classes before
# any log replay: a shard ring follower applies them
from ozone_tpu_torch.om.sharding.leases import follower_reads_enabled
from ozone_tpu_torch.om.sharding.shardmap import (
    InstallShardConfig,
    InstallShardMap,
)
from ozone_tpu_torch.scm.block_deletion import DeleteBlocksCommand
from ozone_tpu_torch.scm.pipeline import ReplicationType
from ozone_tpu_torch.scm.replication_manager import (
    DeleteReplicaCommand,
    ReplicateCommand,
)
from ozone_tpu_torch.scm.scm import StorageContainerManager
from ozone_tpu_torch.storage.container_packer import import_container
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.fast_datapath import DatapathSidecar
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.storage.ratis import RatisXceiverServer
from ozone_tpu_torch.storage.reconstruction import (
    ECReconstructionCoordinator,
    ReconstructionCommand,
)
from ozone_tpu_torch.storage.scrubber import SCANNABLE_STATES, DeviceScrubber
from ozone_tpu_torch.utils.ca import CertRenewalService
from ozone_tpu_torch.utils.insight import InsightService
from ozone_tpu_torch.utils.security import (
    BlockTokenIssuer,
    BlockTokenVerifier,
    SecretKeyManager,
)
from ozone_tpu_torch.utils.tracing import SpanExporter, TraceCollector, Tracer

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
        ca_address: Optional[str] = None,
        enrollment_secret: Optional[str] = None,
        num_volumes: int = 1,
        volume_policy: str = "round-robin",
        replication_bandwidth_mbps: Optional[float] = None,
    ):
        # first: a datanode that cannot reach its device refuses to start
        self.device = resolve_device(device)
        self.dn = Datanode(Path(root), dn_id=dn_id, num_volumes=num_volumes,
                           volume_policy=volume_policy)
        # the layout version (VersionedDatanodeFeatures and the
        # finalizeNewLayoutVersion command): it gates the streaming
        # writes on the RPC and the sidecar
        from ozone_tpu_torch.utils.upgrade import (
            LayoutVersionManager,
            UpgradeFinalizer,
        )

        self.layout = LayoutVersionManager(Path(root) / "layout_version.json")
        self.finalizer = UpgradeFinalizer(self.layout)
        #: the live TLS identity (secure clusters) and its renewal loop
        self.tls = None
        self.cert_client = None
        self.cert_renewal: Optional[CertRenewalService] = None
        # token verification on every lane: off until the SCM's first
        # answer says tokens are on, then on before any key arrives
        self.secrets = SecretKeyManager(generate=False)
        self.verifier = BlockTokenVerifier(self.secrets, enabled=False)
        #: the native datapath sidecar, or None when it is turned off
        self.datapath: Optional[DatapathSidecar] = None
        try:
            if ca_address is not None:
                self._enroll(Path(root), dn_id, ca_address, enrollment_secret)
            if native_dn.enabled() and self.tls is None:
                self.datapath = DatapathSidecar(self.dn, host=host,
                                                verifier=self.verifier,
                                                layout=self.layout)
                self.datapath.start()  # raises when it cannot build or bind
            self.server = RpcServer(host, port, tls=self.tls)
        except BaseException:
            self.stop_datapath()
            self.dn.close()
            raise
        if self.tls is not None:
            # refuse peers whose serial the CRL lists (learned with the
            # MAC'd trust refresh)
            self.server.crl_provider = self.tls.crl
        self.service = DatanodeRpcService(self.dn, self.server,
                                          datapath_port=self.advertise,
                                          verifier=self.verifier,
                                          layout=self.layout)
        #: the replication bandwidth cap (None = unlimited): it paces the
        #: exports this node serves and the ones it pulls
        self.replication_throttle = None
        if replication_bandwidth_mbps:
            from ozone_tpu_torch.utils.throttle import Throttle

            self.replication_throttle = Throttle(
                replication_bandwidth_mbps * 1024 * 1024,
                metrics=self.dn.metrics)
            self.service.throttle = self.replication_throttle
        # raft pipelines (XceiverServerRatis): the raft RPCs and the
        # client's Submit/Watch ride the same RpcServer
        self.raft_rpc = RaftRpcService(self.server)
        self.xceiver_ratis = RatisXceiverServer(
            self.dn, Path(root), self.server.address,
            rpc_service=self.raft_rpc, tls=self.tls)
        self.ratis_service = RatisRpcService(self.xceiver_ratis, self.server,
                                             verifier=self.verifier)
        self._groups_file = Path(root) / "ratis" / "groups.json"
        self.insight = InsightService(self.server, f"datanode:{dn_id}")
        # span export to the metadata daemon's collector
        self.trace_exporter = SpanExporter(
            Tracer.instance(), f"datanode-{dn_id}",
            scm_address.split(",")[0].strip(), tls=self.tls)
        self.scm = RemoteScmClient(scm_address, tls=self.tls)
        self.rack = rack
        self.heartbeat_interval = heartbeat_interval_s
        # peer clients for reconstruction and replication
        self.clients = DatanodeClientFactory()
        self.clients.tls = self.tls
        self.clients.location = rack
        self.clients.node_id = dn_id
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
        #: commands that raised, by type name, and the first 1000 of them
        #: with their errors
        self.failed_commands: dict[str, int] = {}
        self.command_errors: list[tuple] = []
        # the persisted op state (persistedOpState): set by the SCM's
        # command, echoed at registration
        self._op_state_file = Path(root) / "op_state.json"
        self._op_state: Optional[str] = None
        if self._op_state_file.exists():
            try:
                loaded = json.loads(self._op_state_file.read_text())
                if isinstance(loaded, dict):
                    self._op_state = loaded.get("op_state")
            except ValueError:  # corrupt: start IN_SERVICE, the SCM re-drives
                log.warning("%s: unreadable %s", dn_id, self._op_state_file)

    @property
    def address(self) -> str:
        return self.server.address

    def _enroll(self, root: Path, dn_id: str, ca_address: str,
                secret: Optional[str]) -> None:
        """Enroll at the CA's plaintext endpoint (once: the certificate
        persists under <root>/certs), then hold the live identity and its
        renewal loop. The recurring trust refresh runs only when the
        secret authenticates its answers: an unauthenticated one would be
        a standing channel for a rogue CA bundle."""
        from ozone_tpu_torch.utils.ca import CertificateClient

        cc = self.cert_client = CertificateClient(
            root / "certs", f"datanode-{dn_id}",
            hostnames=["localhost", "127.0.0.1", dn_id])
        if not cc.enrolled:
            cc.enroll_remote(ca_address, secret=secret)
        self.tls = cc.rotating_tls()
        trust = ((lambda: cc.refresh_trust_remote(ca_address, secret=secret))
                 if secret is not None else None)
        self.cert_renewal = CertRenewalService(
            self.tls, lambda: cc.renew_remote(ca_address, secret=secret),
            trust_fn=trust)

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
        """Filesystem capacity across the healthy volumes (the reference's
        StorageLocationReport), each filesystem counted once."""
        total, seen = 0, set()
        for v in self.dn.volumes:
            if v.failed:
                continue
            try:
                dev = v.root.stat().st_dev
                if dev not in seen:
                    seen.add(dev)
                    total += shutil.disk_usage(v.root).total
            except OSError:  # ozlint: allow[error-swallowing] -- a vanished volume drops out of the report
                continue
        return total

    def _register(self) -> None:
        """Register with the op state and the full container report."""
        fp = self._report_fingerprint()
        report = self.dn.container_report()
        self.scm.register(self.dn.id, self.address, rack=self.rack,
                          capacity_bytes=self._capacity_bytes(),
                          op_state=self._op_state, container_report=report)
        self._last_report_fp = fp
        self._last_report_t = time.monotonic()
        self._last_used = sum(r["used_bytes"] for r in report)
        self._sync_security()

    def _set_op_state(self, state: Optional[str]) -> None:
        self._op_state = state if state != "IN_SERVICE" else None
        if self._op_state is None:
            self._op_state_file.unlink(missing_ok=True)
        else:
            tmp = self._op_state_file.with_suffix(".tmp")
            tmp.write_text(json.dumps({"op_state": self._op_state}))
            tmp.replace(self._op_state_file)

    def _sync_security(self) -> None:
        """Take the token posture and keys from the SCM's answers: turn
        the verifier on at the first answer that says tokens are on (with
        no key yet every check fails: a request is refused, never served
        unchecked), import the keys, and sign this node's own repair
        traffic with them (TokenHelper)."""
        sec = self.scm.security
        if not sec.get("block_tokens"):
            return
        if not self.verifier.enabled:
            self.verifier.enabled = True
            log.info("%s: block-token enforcement on", self.dn.id)
        if sec.get("secret_keys"):
            self.secrets.import_keys(sec["secret_keys"])
            if self.clients.tokens.issuer is None:
                self.clients.tokens.issuer = BlockTokenIssuer(self.secrets)

    def start(self) -> None:
        self.server.start()
        if self.cert_renewal is not None:
            self.cert_renewal.start()
        self.trace_exporter.start()
        self._rejoin_pipelines()
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
                # disk health first (StorageVolumeChecker): a failed
                # volume's replicas leave the next report and the SCM
                # rebuilds them elsewhere
                self.dn.check_volumes()
                self.scan_once()
            except Exception:
                log.exception("%s background scan failed", self.dn.id)

    # ---------------------------------------------------------- heartbeat
    def heartbeat_once(self) -> None:
        """One heartbeat: a full container report when one changed (or
        every FULL_REPORT_EVERY_S), then every command that came back. A
        command that raises is logged; the first such error is raised
        once all commands ran."""
        fp = self._report_fingerprint()
        now = time.monotonic()
        report = None
        if fp != self._last_report_fp \
                or now - self._last_report_t >= self.FULL_REPORT_EVERY_S:
            report = self.dn.container_report()
            self._last_used = sum(r["used_bytes"] for r in report)
        acks, self._pending_acks = self._pending_acks, []
        try:
            commands = self.scm.heartbeat(
                self.dn.id, container_report=report,
                used_bytes=self._last_used, deleted_block_acks=acks,
                healthy_volumes=self.dn.healthy_volume_count,
                layout_version=self.layout.metadata_version)
        except BaseException:
            self._pending_acks = acks + self._pending_acks
            raise
        if report is not None:  # only a delivered report counts
            self._last_report_fp = fp
            self._last_report_t = now
        self._sync_security()
        first: Optional[BaseException] = None
        for cmd in commands:
            try:
                self.execute(cmd)
            except Exception as e:
                name = type(cmd).__name__ if not isinstance(cmd, dict) \
                    else cmd.get("type", "dict")
                self.failed_commands[name] = \
                    self.failed_commands.get(name, 0) + 1
                if len(self.command_errors) < 1000:
                    self.command_errors.append((cmd, e))
                log.exception("%s command %r failed", self.dn.id, cmd)
                first = first or e
        if first is not None:
            raise first

    def _report_fingerprint(self) -> tuple:
        return (self.dn.mutation_count,
                tuple(sorted((c.id, c.state.value)
                             for c in self.dn.containers)))

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self.heartbeat_once()
                self._drain_scan_requests()
            except Exception:
                log.exception("%s heartbeat failed", self.dn.id)

    def _drain_scan_requests(self) -> None:
        """Scrub the containers queued for an on-demand scan
        (OnDemandContainerDataScanner) once writer-free; an OPEN replica's
        chunks in flight would read torn, so it stays queued."""
        for cid in self.dn.pop_scan_requests():
            try:
                c = self.dn.get_container(cid)
            except StorageError:  # ozlint: allow[error-swallowing] -- deleted since the request
                continue
            if c.state not in SCANNABLE_STATES:
                self.dn.request_scan(cid)
                continue
            errs = self._scrubber.scrub_container(self.dn, cid)
            if errs:
                log.warning("%s: on-demand scan of container %d found: %s",
                            self.dn.id, cid, errs[:4])

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
        elif isinstance(cmd, dict) and cmd.get("type") == "set-op-state":
            self._set_op_state(cmd.get("op_state"))
        elif isinstance(cmd, dict) and cmd.get("type") == "join-pipeline":
            self._join_pipeline(cmd)
        elif isinstance(cmd, dict) and cmd.get("type") == "leave-pipeline":
            self._leave_pipeline(int(cmd["pipeline_id"]))
            # the group stopped: a replica that missed the raft close
            # converges by a direct close
            if cmd.get("container_id") is not None:
                try:
                    self.dn.close_container(int(cmd["container_id"]))
                except StorageError:  # ozlint: allow[error-swallowing] -- already closed, or absent
                    pass
        elif isinstance(cmd, dict) and cmd.get("type") == "close-container":
            self._close_container(cmd)
        elif isinstance(cmd, dict) and cmd.get("type") == "finalize":
            out = self.finalizer.finalize()
            log.info("%s layout finalize: %s -> v%d", self.dn.id, out.value,
                     self.layout.metadata_version)
        else:
            log.debug("%s ignoring command %r", self.dn.id, cmd)

    # ------------------------------------------------------ raft pipelines
    def _read_groups(self) -> dict:
        if not self._groups_file.exists():
            return {}
        try:
            return json.loads(self._groups_file.read_text())
        except ValueError:
            log.exception("%s: corrupt %s", self.dn.id, self._groups_file)
            return {}

    def _write_groups(self, groups: dict) -> None:
        self._groups_file.parent.mkdir(parents=True, exist_ok=True)
        tmp = self._groups_file.with_suffix(".tmp")
        tmp.write_text(json.dumps(groups))
        tmp.replace(self._groups_file)

    def _rejoin_pipelines(self) -> None:
        """Re-open the raft groups this node served before a restart (the
        reference reloads its RaftGroups from the ratis storage)."""
        for g in self._read_groups().values():
            try:
                self.xceiver_ratis.join(int(g["pipeline_id"]), g["peers"])
            except Exception:
                log.exception("%s: rejoin of pipeline %s failed",
                              self.dn.id, g.get("pipeline_id"))

    def _join_pipeline(self, cmd: dict) -> None:
        pid = int(cmd["pipeline_id"])
        peers = dict(cmd["peers"])
        self.xceiver_ratis.join(pid, peers)
        groups = self._read_groups()
        groups[str(pid)] = {"pipeline_id": pid, "peers": peers}
        self._write_groups(groups)

    def _leave_pipeline(self, pid: int) -> None:
        """Retire a closed pipeline's raft group: stop the node, drop it
        from the rejoin record, delete its log (the data stays)."""
        self.xceiver_ratis.leave(pid)
        groups = self._read_groups()
        if groups.pop(str(pid), None) is not None:
            self._write_groups(groups)
        shutil.rmtree(self._groups_file.parent
                      / self.xceiver_ratis.group_id(pid), ignore_errors=True)

    def _close_container(self, cmd: dict) -> None:
        cid = int(cmd["container_id"])
        pid = cmd.get("pipeline_id")
        if pid is not None and self.xceiver_ratis.get(int(pid)) is not None:
            # RATIS: ordered through the ring after the writes in flight;
            # only the leader submits, the others apply it from the log
            from ozone_tpu_torch.client import resilience

            try:
                self.xceiver_ratis.submit(int(pid), {
                    "verb": "close_container", "container_id": cid,
                }, timeout=resilience.op_timeout(10.0, "close_container"))
            except StorageError as e:
                if e.code != "NOT_LEADER":
                    log.warning("%s: raft close of container %d failed: %s",
                                self.dn.id, cid, e)
            return
        try:
            self.dn.close_container(cid)
        except StorageError:  # ozlint: allow[error-swallowing] -- already closed, or not here yet
            pass

    def _replicate(self, cmd: ReplicateCommand) -> None:
        """Pull the source's packed replica and import it here
        (DownloadAndImportReplicator)."""
        data = self.clients.get(cmd.source).export_container(
            cmd.container_id)
        if self.replication_throttle is not None:
            # paid before the import: a run of copies paces itself
            # instead of bursting, then stalling foreground IO
            self.replication_throttle.take(len(data))
        import_container(self.dn, data, replica_index=cmd.replica_index,
                         expect_id=cmd.container_id)

    def stop(self) -> None:
        self._stop.set()
        if self.cert_renewal is not None:
            self.cert_renewal.stop()
        self.trace_exporter.stop()
        for t in (self._hb, self._scanner):
            if t is not None:
                t.join(timeout=5)  # ozlint: allow[deadline-propagation] -- shutdown join of the daemon's own loop threads, not a request path
        self.xceiver_ratis.stop()
        self.server.stop()
        self.stop_datapath()
        self.scm.close()
        self.clients.close()
        self.dn.close()


class ScmOmDaemon:
    """Metadata server process: SCM + OM behind one RPC endpoint; with
    `ha_id` and `ha_peers` ({id: "host:port"}, this replica included)
    one replica of the metadata ring."""

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
        ha_id: Optional[str] = None,
        ha_peers: Optional[dict[str, str]] = None,
        block_tokens: bool = False,
        insecure_secrets: bool = False,
        secure: bool = False,
        acl_enabled: bool = False,
        enroll_port: int = 0,
        enrollment_secret: Optional[str] = None,
        ca_address: Optional[str] = None,
        shard_config: Optional[dict] = None,
        shard_map: Optional[dict] = None,
        http_port: Optional[int] = None,
        recon_port: Optional[int] = None,
        recon_interval_s: float = 30.0,
    ):
        if block_tokens and not secure and not insecure_secrets:
            raise ValueError(
                "block_tokens without secure=True would hand the signing "
                "keys to any caller of Register/Heartbeat; pass "
                "secure=True (mTLS) or insecure_secrets=True (tests only)")
        if block_tokens and secure and ca_address is None \
                and enrollment_secret is None:
            # open CSR signing would admit any caller into the mutual-TLS
            # trust domain, where the admin token verbs live: the
            # bootstrap secret is the cluster's admission credential
            raise ValueError(
                "secure block-token clusters require an "
                "enrollment_secret: open CSR signing would let any "
                "caller enroll and mint admin tokens")
        self.scm = StorageContainerManager(
            min_datanodes=min_datanodes, container_size=container_size,
            placement_seed=placement_seed, stale_after_s=stale_after_s,
            dead_after_s=dead_after_s, db_path=Path(om_db).parent / "scm.db",
            block_tokens=block_tokens)
        #: secure mode: the live identity, the CA (primordial replica), its
        #: plaintext enrollment server and the renewal loop
        self.tls = None
        self.ca = None
        self.cert_client = None
        self.enroll_server: Optional[RpcServer] = None
        self.cert_renewal: Optional[CertRenewalService] = None
        self._enrollment_secret = enrollment_secret
        if secure:
            self._init_secure(Path(om_db).parent, host, enroll_port,
                              enrollment_secret, ca_address, ha_id)
        self.server = RpcServer(host, port, tls=self.tls)
        if self.tls is not None:
            self.server.crl_provider = self.tls.crl
        self.scm_service = ScmRpcService(self.scm, self.server)
        if insecure_secrets:
            self.scm_service.distribute_secrets = True
        if self.ca is not None:
            self.scm_service.cert_ops = self._cert_ops
        self._wire_pipeline_hooks()
        self.om = OzoneManager(Path(om_db), self.scm, block_size=block_size,
                               device=device)
        if acl_enabled:
            self.om.enable_acls()
        if block_tokens:
            # the first signing key before serving (single node: here;
            # under HA the leader's replicated key replaces it)
            if ha_id is None:
                self.scm.ensure_secret_key()
            self.om.enable_block_tokens(BlockTokenIssuer(self.scm.secret_keys))
        self.om_service = OmRpcService(
            self.om, self.server,
            addresses_provider=lambda: dict(self.scm_service.addresses),
            locations_provider=self.scm_service.node_locations,
            scm_lock=self.scm_service.lock)
        self._bg_interval = background_interval_s
        self._bg_stop = threading.Event()
        self._bg: Optional[threading.Thread] = None
        # the lifecycle sweeper: leader-singleton on the metadata ring and
        # fenced with its raft term (term 0 without a ring). Its datanode
        # clients resolve lazily from heartbeat-learned addresses, and
        # OZONE_TPU_LIFECYCLE_MBPS paces its source reads
        from ozone_tpu_torch.lifecycle.service import LifecycleService
        from ozone_tpu_torch.utils.config import env_float

        self._lifecycle_clients: Optional[DatanodeClientFactory] = None
        mbps = env_float("OZONE_TPU_LIFECYCLE_MBPS", 0.0)
        throttle = None
        if mbps > 0:
            from ozone_tpu_torch.utils.throttle import Throttle

            throttle = Throttle(mbps * 1024 * 1024, metrics=self.om.metrics)
        self.ha = None
        self._ha_peers = dict(ha_peers or {})
        self.lifecycle = LifecycleService(
            self.om, clients_fn=self._lifecycle_client_factory,
            term_fn=lambda: (self.ha.node.storage.term
                             if self.ha is not None else 0),
            leader_fn=lambda: (self.ha.is_ready
                               if self.ha is not None else True),
            throttle=throttle,
            # tighter than the standalone 300 s: the sweep shares the
            # background thread with the SCM loops and key deletion
            sweep_deadline_s=env_float("OZONE_TPU_LIFECYCLE_DEADLINE_S",
                                       30.0),
            device=device,
            alloc_barrier=lambda: (self.ha._await_records()
                                   if self.ha is not None else None))
        self.om.lifecycle = self.lifecycle
        #: where the lifecycle sweep and the geo shipper run the codec
        self.device = device
        # the geo replication shipper: leader-singleton and term-fenced
        # like the sweeper, on the same datanode clients;
        # OZONE_TPU_GEO_MBPS paces its source reads
        from ozone_tpu_torch.replication_geo.shipper import (
            ReplicationShipper,
        )

        geo_throttle = None
        geo_mbps = env_float("OZONE_TPU_GEO_MBPS", 0.0)
        if geo_mbps > 0:
            from ozone_tpu_torch.utils.throttle import Throttle

            geo_throttle = Throttle(geo_mbps * 1024 * 1024,
                                    metrics=self.om.metrics)
        self.geo = ReplicationShipper(
            self.om, clients_fn=self._lifecycle_client_factory,
            term_fn=lambda: (self.ha.node.storage.term
                             if self.ha is not None else 0),
            leader_fn=lambda: (self.ha.is_ready
                               if self.ha is not None else True),
            throttle=geo_throttle,
            ship_deadline_s=env_float("OZONE_TPU_GEO_DEADLINE_S", 30.0),
            tls=self.tls, device=self.device)
        self.om.geo = self.geo
        self.om.scm_lock = self.scm_service.lock
        #: seconds between lifecycle sweeps (and slab compactions)
        self._lc_period = env_float("OZONE_TPU_LIFECYCLE_PERIOD_S", 60.0)
        self._lc_last = time.monotonic()
        #: seconds between geo ship cycles
        self._geo_period = env_float("OZONE_TPU_GEO_PERIOD_S", 30.0)
        self._geo_last = time.monotonic()
        self._bg_ticks = 0
        if ha_id is not None:
            self._init_ha(ha_id, Path(om_db).parent / "meta-raft")
        # the sharded metadata plane: shard_config is this daemon's
        # InstallShardConfig payload (epoch, shard_id, slot_count, owned),
        # the replicated ownership row its OM enforces through
        # check_shard; shard_map is the root map this daemon serves from
        # GetShardMap, so clients discover the shard rings through any
        # replica
        self._shard_config = shard_config
        self._shard_map = shard_map
        self._shard_installed = shard_config is None and shard_map is None
        if not self._shard_installed:
            if self.ha is None:
                self._install_sharding()
            elif follower_reads_enabled():
                # HA: the install waits for a ready leader (the
                # background loop); a fresh commit index per write lets
                # follower leases serve read-your-writes at once
                self.ha.push_commit_on_write = True
        self.insight = InsightService(self.server, "scm-om")
        # the cluster trace collector, with this process's own spans fed
        # straight in (no wire round trip)
        self.trace_collector = TraceCollector(self.server)
        self.trace_exporter = SpanExporter(
            Tracer.instance(), "scm-om", collector=self.trace_collector)
        self.http = None
        if http_port is not None:
            self.http = self._make_http(host, http_port, stale_after_s,
                                        dead_after_s, block_size)
        # Recon rides the metadata process and tails the same store
        self.recon = None
        if recon_port is not None:
            from ozone_tpu_torch.recon.recon import ReconServer

            self.recon = ReconServer(
                self.om, self.scm, host=host, port=recon_port,
                db_path=Path(om_db).parent / "recon.db")
            # the slow-trace view serves the cluster collector's ring too
            self.recon.trace_collector = self.trace_collector
        # Recon's tasks scan the whole namespace: they run on their own
        # cadence, never per background tick
        self._recon_interval = recon_interval_s
        self._recon_last = 0.0

    def _make_http(self, host: str, port: int, stale_after_s: float,
                   dead_after_s: float, block_size: int):
        """/prom, /prof, /stacks, /status and live reconfiguration of the
        liveness intervals and the OM's block size (the reference's
        ReconfigureProtocol, feature/Reconfigurability.md)."""
        from ozone_tpu_torch.utils.config import (
            OzoneConfiguration,
            ReconfigurationHandler,
        )
        from ozone_tpu_torch.utils.http_server import ServiceHttpServer

        conf = OzoneConfiguration()
        reconfig = ReconfigurationHandler(conf)

        def set_float(attr):
            def apply(v):
                setattr(self.scm.nodes, attr, float(v))

            return apply

        def set_block_size(v):
            self.om.block_size = int(v)

        # seeded with the effective values, so /reconfig/properties
        # reports what runs
        for key, value, apply, validator, description in (
                ("ozone.scm.stale.node.interval", stale_after_s,
                 set_float("stale_after"), float,
                 "seconds of heartbeat silence before STALE"),
                ("ozone.scm.dead.node.interval", dead_after_s,
                 set_float("dead_after"), float,
                 "seconds of heartbeat silence before DEAD"),
                ("ozone.om.block.size", block_size, set_block_size, int,
                 "allocation unit for new keys (bytes)")):
            conf.set(key, value)
            reconfig.register(key, apply, validator=validator,
                              description=description)
        return ServiceHttpServer(
            "scm-om", host, port,
            status_provider=lambda: {
                "address": self.address,
                "safemode": self.scm.safemode.in_safemode(),
            },
            reconfig=reconfig)

    @property
    def address(self) -> str:
        return self.server.address

    @property
    def enroll_address(self) -> Optional[str]:
        """The plaintext certificate-enrollment endpoint (secure mode, on
        the replica that hosts the CA)."""
        return (self.enroll_server.address
                if self.enroll_server is not None else None)

    # ----------------------------------------------------------- security
    def _init_secure(self, meta_dir: Path, host: str, enroll_port: int,
                     secret: Optional[str], ca_address: Optional[str],
                     ha_id: Optional[str]) -> None:
        from ozone_tpu_torch.utils.ca import (
            CertificateAuthority,
            CertificateClient,
            EnrollmentService,
        )

        # the ring dials its peers with server_name=<ha id>: the
        # certificate carries it among its names
        names = ["localhost", "127.0.0.1"] + ([ha_id] if ha_id else [])
        cc = self.cert_client = CertificateClient(meta_dir / "certs",
                                                  "scm-om", hostnames=names)
        if ca_address is not None:
            # another HA replica: the CA lives on the primordial one
            if not cc.enrolled:
                cc.enroll_remote(ca_address, secret=secret)
            renew = lambda: cc.renew_remote(ca_address,  # noqa: E731
                                            secret=secret)
            # no secret, no recurring plaintext trust refresh
            trust = ((lambda: cc.refresh_trust_remote(ca_address,
                                                      secret=secret))
                     if secret is not None else None)
        else:
            self.ca = CertificateAuthority(meta_dir / "ca")
            if not cc.enrolled:
                cc.enroll(self.ca)
            self.enroll_server = RpcServer(host, enroll_port)
            EnrollmentService(self.ca, self.enroll_server, secret=secret)
            renew = lambda: cc.renew(self.ca)  # noqa: E731
            trust = lambda: cc.refresh_trust(self.ca)  # noqa: E731
        self.tls = cc.rotating_tls()
        self.cert_renewal = CertRenewalService(self.tls, renew,
                                               trust_fn=trust)

    def _cert_ops(self, op: str, target):
        """The CA's lifecycle verbs: list the issued certificates, revoke
        one by serial. This server enforces a new CRL at once; peers learn
        it on their next trust refresh."""
        if op == "cert-list":
            return self.ca.issued()
        try:
            serial = int(str(target), 0)
        except (TypeError, ValueError):
            raise StorageError("INVALID", f"bad serial {target!r}")
        try:
            self.ca.revoke(serial)
        except ValueError as e:
            raise StorageError("INVALID", str(e))
        if self.cert_renewal is not None:
            self.cert_renewal.check_once()
        out = {"revoked": serial, "crl": sorted(self.ca.crl())}
        if self._enrollment_secret is None:
            # without the secret peers run no trust refresh: the CRL
            # reaches them at their next renewal only
            out["warning"] = (
                "no enrollment secret: datanodes cannot fetch "
                "CRL updates; revocation takes effect on their "
                "next renewal, not immediately")
        return out

    # ------------------------------------------------------- SCM hooks
    def _wire_pipeline_hooks(self) -> None:
        """RATIS pipelines become raft groups on their members
        (RatisPipelineProvider): join on creation, leave on retirement,
        and a RATIS container closes through its group."""
        from ozone_tpu_torch.scm.pipeline import PipelineState

        def raft_pipeline(p) -> bool:
            return (p is not None
                    and p.replication.type is ReplicationType.RATIS
                    and p.replication.factor > 1)

        def announce_pipeline(p) -> None:
            if not raft_pipeline(p):
                return
            peers = {dn: self.scm_service.addresses.get(dn, "")
                     for dn in p.nodes}
            for dn in p.nodes:
                self.scm.nodes.queue_command(dn, {
                    "type": "join-pipeline", "pipeline_id": p.id,
                    "peers": peers})

        def announce_close(c) -> None:
            # a RATIS close is ordered after every replicated write in
            # flight; EC replicas close directly
            via_raft = raft_pipeline(c.pipeline)
            for dn in (c.pipeline.nodes if c.pipeline else []):
                self.scm.nodes.queue_command(dn, {
                    "type": "close-container", "container_id": c.id,
                    "pipeline_id": c.pipeline.id if via_raft else None})

        def retire_pipeline(p) -> None:
            if not raft_pipeline(p):
                return
            # the (1:1) container rides along, so a member that missed
            # the raft close still converges once the group stops
            cid = next((c.id for c in self.scm.containers.containers()
                        if c.pipeline is not None and c.pipeline.id == p.id),
                       None)
            for dn in p.nodes:
                self.scm.nodes.queue_command(dn, {
                    "type": "leave-pipeline", "pipeline_id": p.id,
                    "container_id": cid})

        def reannounce_pipelines_of(dn_id: str) -> None:
            for p in self.scm.containers.pipelines():
                # a retired pipeline is never revived by a re-registration
                if dn_id in p.nodes and p.state is PipelineState.OPEN:
                    announce_pipeline(p)

        self.scm.containers.on_pipeline_created = announce_pipeline
        self.scm.containers.on_container_closing = announce_close
        self.scm.containers.on_pipeline_closed = retire_pipeline
        self.scm_service.on_register = reannounce_pipelines_of

    # --------------------------------------------------------------- HA
    def _leader_address(self, hint: Optional[str]) -> str:
        return self._ha_peers.get(hint or "", "")

    def _ha_call(self, fn, not_leader_code: str):
        """Run a ring operation, turning NotRaftLeaderError into the wire
        error (with the leader's address) clients fail over on, and an
        operator's input error into INVALID."""
        from ozone_tpu_torch.consensus.raft import NotRaftLeaderError

        try:
            return fn()
        except NotRaftLeaderError as e:
            raise StorageError(not_leader_code,
                               self._leader_address(e.leader_hint))
        except (ValueError, RuntimeError) as e:
            raise StorageError("INVALID", str(e))

    def _init_ha(self, ha_id: str, raft_dir: Path) -> None:
        from ozone_tpu_torch.consensus.meta_ring import MetaHARing
        from ozone_tpu_torch.net.raft_transport import RpcRaftTransport
        from ozone_tpu_torch.om import requests as rq

        raft_rpc = RaftRpcService(self.server)
        self._ha_transport = RpcRaftTransport("meta-ha", self._ha_peers,
                                              tls=self.tls, owner=ha_id)
        self.ha = MetaHARing(self.om, self.scm, raft_dir, ha_id,
                             list(self._ha_peers),
                             transport=self._ha_transport)
        raft_rpc.register("meta-ha", self.ha.node)
        om = self.om

        def ha_submit(request):
            with om.metrics.histogram(type(request).__name__).time():
                result = self._ha_call(lambda: self.ha.submit_om(request),
                                       "OM_NOT_LEADER")
            om.metrics.counter("write_ops").inc()
            return result

        # every OM write goes through the ring (the OM's methods all
        # funnel into submit); reads are leader-gated at the service edge
        om.submit = ha_submit
        om.prepare = lambda: self._ha_call(self.ha.prepare_om,
                                           "OM_NOT_LEADER")
        om.cancel_prepare = lambda: self._ha_call(self.ha.cancel_prepare_om,
                                                  "OM_NOT_LEADER")
        self.om_service.gate = self._leader_gate
        self.om_service.scm_barrier = lambda: self._ha_call(
            self.ha._await_records, "OM_NOT_LEADER")
        self.om_service.applied_index_fn = lambda: self.ha.node.last_applied

        def scm_gate():
            if not self.ha.is_ready:
                raise StorageError("SCM_NOT_LEADER",
                                   self._leader_address(self.ha.leader_hint))

        self.scm_service.gate = scm_gate
        self.scm_service.barrier = lambda: self._ha_call(
            self.ha._await_records, "SCM_NOT_LEADER")
        self.scm_service.admin_submitter = lambda op, target: self._ha_call(
            lambda: self.ha.submit_admin(op, target), "SCM_NOT_LEADER")
        # a token-key rotation is a replicated decision: every replica's
        # OM signs with the keys the datanodes verify against
        self.scm.on_secret_rotate = lambda key: self.ha.submit_admin(
            "import-secret-key", key.to_json())

        def ring_ops(op, target):
            if op == "ring-add":
                node_id, _, address = str(target).partition("=")
                if not address:
                    raise StorageError("INVALID",
                                       "ring-add needs id=host:port")
                return self.ha.ring_add(node_id, address)
            if op == "ring-transfer":
                return self.ha.ring_transfer(str(target))
            return self.ha.ring_remove(str(target))

        self.scm_service.ring_ops = lambda op, target: self._ha_call(
            lambda: ring_ops(op, target), "SCM_NOT_LEADER")
        self.scm_service.ring_status = self.ha.ring_status

        def on_ring_config(members: dict) -> None:
            # config entries carry the peers' addresses: the leader-hint
            # address book follows the ring
            self._ha_peers = {k: (v or self._ha_peers.get(k, ""))
                              for k, v in members.items()}

        self.ha.node.on_config = on_ring_config
        self.scm_service.ring_provider = \
            lambda: [a for a in self._ha_peers.values() if a]

    def _install_sharding(self) -> None:
        """Install this daemon's shard ownership and its copy of the root
        map: at construction without HA; under HA from the background
        loop once this replica is the ready leader (the install
        replicates to the followers like any other OM request)."""
        if self._shard_config is not None:
            self.om.submit(InstallShardConfig(**self._shard_config))
        if self._shard_map is not None:
            self.om.submit(InstallShardMap(dict(self._shard_map)))
        self._shard_installed = True

    def _leader_gate(self, verb: Optional[str] = None,
                     req: Optional[bytes] = None) -> None:
        # the ready leader, not just the leader: a fresh leader applies
        # the earlier terms' committed entries (its no-op) before it
        # serves, or a failover client could read stale state
        if self.ha is None or self.ha.is_ready:
            return
        # lease-based follower reads (om/sharding/leases.py): a replica
        # holding a live read lease answers read verbs locally once its
        # applied state reaches the caller's floor; the leader-read
        # fallback is the client's, on the OM_NOT_LEADER below
        if verb is not None and req is not None and follower_reads_enabled():
            m, _ = wire.unpack(req)
            if self.ha.read_gate.try_serve(verb,
                                           int(m.get("_min_applied") or 0)):
                return
        raise StorageError("OM_NOT_LEADER",
                           self._leader_address(self.ha.leader_hint))

    # -------------------------------------------------------- lifecycle
    def _lifecycle_client_factory(self) -> DatanodeClientFactory:
        """Datanode clients for the lifecycle executor, refreshed from the
        heartbeat-learned address book before each sweep."""
        if self._lifecycle_clients is None:
            self._lifecycle_clients = DatanodeClientFactory()
            self._lifecycle_clients.tls = self.tls
            self._lifecycle_clients.tokens.issuer = self.om.token_issuer
        for dn_id, addr in dict(self.scm_service.addresses).items():
            # update, not register: an unchanged address keeps its
            # pooled connection
            self._lifecycle_clients.update_remote(dn_id, addr)
        self._lifecycle_clients.learn_locations(
            self.scm_service.node_locations())
        return self._lifecycle_clients

    def run_background_once(self) -> None:
        """One pass of the SCM's control loops and the OM's directory-
        deleting and key-deleting services (detached FSO subtrees move
        into the deleted-key chain, whose blocks go to the SCM's deletion
        log); every OZONE_TPU_LIFECYCLE_PERIOD_S, a lifecycle sweep
        and a slab compaction after it, and every OZONE_TPU_GEO_PERIOD_S
        a geo ship cycle (outside the SCM lock: they allocate blocks and
        write to datanodes through the RPC). Under
        HA every replica first compacts its raft log behind a snapshot
        once 512 entries sit past the last one; the rest runs on the
        leader only."""
        if self.ha is not None:
            node = self.ha.node
            if node.last_applied - node.storage.snapshot_index > 512:
                try:
                    node.take_snapshot()
                except Exception:
                    log.exception("raft log compaction failed")
            if not self.ha.is_leader:
                return
        if not self._shard_installed:
            # the deferred HA shard install: this replica just became
            # the leader
            self._install_sharding()
        self.om.run_dir_deleting_service_once()
        with self.scm_service.lock:
            self.scm.run_background_once()
            self.om.run_key_deleting_service_once()
        # the expired delegation tokens' sweep (ExpiredTokenRemover) on
        # the reference's slow cadence: every 60 passes
        self._bg_ticks += 1
        if self._bg_ticks % 60 == 0:
            self.om.run_dtoken_cleanup_once()
        now = time.monotonic()
        if now - self._lc_last >= self._lc_period:
            self._lc_last = now
            self.lifecycle.run_once()
            self.lifecycle.compact_slabs_once()
        now = time.monotonic()
        if now - self._geo_last >= self._geo_period:
            self._geo_last = now
            self.geo.run_once()
        now = time.monotonic()
        if self.recon is not None \
                and now - self._recon_last >= self._recon_interval:
            self._recon_last = now
            self.recon.run_tasks_once()

    def start(self) -> None:
        if self.enroll_server is not None:
            self.enroll_server.start()
        self.server.start()
        if self.http is not None:
            self.http.start()
        if self.recon is not None:
            self.recon.start()
        if self.cert_renewal is not None:
            self.cert_renewal.start()
        self.trace_exporter.start()
        if self.ha is not None:
            self.ha.start()

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
        if self.cert_renewal is not None:
            self.cert_renewal.stop()
        if self._bg is not None:
            self._bg.join(timeout=30)  # ozlint: allow[deadline-propagation] -- shutdown join of the daemon's own loop threads, not a request path
        if self.http is not None:
            self.http.stop()
        if self.recon is not None:
            self.recon.stop()
        self.trace_exporter.stop()
        # the server first: calls in flight finish (within its grace)
        # against a ring that still commits
        self.server.stop()
        if self.enroll_server is not None:
            self.enroll_server.stop()
        if self.ha is not None:
            self.ha.stop()
            self._ha_transport.close()
        self.geo.close()
        if self._lifecycle_clients is not None:
            self._lifecycle_clients.close()
        self.om.close()
