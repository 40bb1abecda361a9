"""The port's daemon cluster against `ozone_tpu`'s, on the CPU.

In-process daemons on loopback (an ScmOmDaemon and DatanodeDaemons,
device="cpu" on the port's side), mirroring tests/test_distributed.py:
echo, remote chunk I/O, an EC key over the wire with a degraded read, a
fresh client reading through a located lookup, an SCM-driven
reconstruction after a dead node, and container close converging. The
same seeded keys go through `ozone_tpu.net.daemons`, and bytes read, key
sizes, per-group lengths, every chunk's CRC32C words and the error codes
of the same bad requests must be equal. Beyond the reference's tests:
the S3 gateway's OM verbs (multipart, key attributes, secrets, the
upgrade status), the metadata daemon's lifecycle cadence (a sweep on its
own that tiers keys over the wire), the per-stripe write path and the permanent downgrade
when a member refuses WriteChunksCommit, container replication through
export and import (a tarball the reference's datanode packed included),
and the daemon's background scrub.
"""

import time

import numpy as np
import pytest
import torch

from ozone_tpu.client.dn_client import DatanodeClientFactory as JFactory
from ozone_tpu.client.ozone_client import OzoneClient as JOzoneClient
from ozone_tpu.net import daemons as j_daemons
from ozone_tpu.net.dn_service import GrpcDatanodeClient
from ozone_tpu.net.om_service import GrpcOmClient
from ozone_tpu.storage import ids as j_ids
from ozone_tpu.utils import checksum as j_checksum
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ozone_client import OzoneClient
from ozone_tpu_torch.codec import hostmem
from ozone_tpu_torch.net import daemons
from ozone_tpu_torch.net.dn_service import RpcDatanodeClient
from ozone_tpu_torch.net.om_service import RemoteOmClient
from ozone_tpu_torch.scm.replication_manager import ReplicateCommand
from ozone_tpu_torch.storage import ids as port_ids
from ozone_tpu_torch.storage.container_packer import import_container
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import ContainerState, StorageError
from ozone_tpu_torch.utils import checksum

EC = "rs-3-2-4096"
#: every wait in this file is bounded by this many seconds
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def _quiet_codec(monkeypatch):
    """Direct codec route and one torch thread: no process-wide dispatcher
    outlives a test, and the plain versions do not oversubscribe the
    cores the suite's timing-sensitive tests share."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One cluster of daemons, the port's or the reference's, and a client."""

    def __init__(self, port: bool, root, n_dn=6, block_size=4 * 4096,
                 container_size=1024 * 1024, heartbeat_s=0.2):
        mod = daemons if port else j_daemons
        self.port = port
        self.ids = port_ids if port else j_ids
        kw = {"device": "cpu"} if port else {}
        self.meta = mod.ScmOmDaemon(
            root / "om.db", block_size=block_size,
            container_size=container_size, stale_after_s=1000.0,
            dead_after_s=2000.0, background_interval_s=0.2, **kw)
        self.meta.start()
        self.dns = [mod.DatanodeDaemon(root / f"dn{i}", f"dn{i}",
                                       self.meta.address,
                                       heartbeat_interval_s=heartbeat_s, **kw)
                    for i in range(n_dn)]
        for d in self.dns:
            d.start()
        self.oz = self.client()

    def client(self):
        if self.port:
            clients = DatanodeClientFactory()
            return OzoneClient(RemoteOmClient(self.meta.address,
                                              clients=clients),
                               clients, device="cpu")
        clients = JFactory()
        return JOzoneClient(GrpcOmClient(self.meta.address, clients=clients),
                            clients)

    def dn_client(self, d):
        cls = RpcDatanodeClient if self.port else GrpcDatanodeClient
        return cls(d.dn.id, d.address)

    def daemon(self, dn_id):
        return next(d for d in self.dns if d.dn.id == dn_id)

    def chunks(self, info: dict) -> list:
        """[(group, unit, offset, length, CRC words)] of a key, read from
        its datanodes over the wire."""
        out = []
        for gi, g in enumerate(info["block_groups"]):
            bid = self.ids.BlockID(int(g["container_id"]), int(g["local_id"]))
            for u, dn_id in enumerate(g["nodes"]):
                try:
                    block = self.oz.clients.get(dn_id).get_block(bid)
                except (StorageError, j_ids.StorageError):
                    continue  # a unit the group's data never reached
                out += [(gi, u, c.offset, c.length, c.checksum.checksums)
                        for c in block.chunks]
        return out

    def stop(self):
        for d in self.dns:
            d.stop()
        self.meta.stop()


@pytest.fixture
def pair(tmp_path):
    sides = []
    try:
        sides.append(Side(True, tmp_path / "port"))
        sides.append(Side(False, tmp_path / "ref"))
        yield sides
    finally:
        for s in sides:
            s.stop()


def both(pair, fn):
    return [fn(s) for s in pair]


def codes(pair, fn) -> list:
    """The error code each side raises for the same bad request."""
    out = []
    for s in pair:
        try:
            fn(s)
        except (StorageError, j_ids.StorageError) as e:
            out.append(e.code)
        else:
            out.append(None)
    return out


def _data(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _wait(what: str, cond, timeout_s: float = WAIT_S, detail=None) -> None:
    """Poll `cond` until it holds; on timeout the message carries
    `detail()`, what the caller saw last."""
    t_end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > t_end:
            seen = f"; {detail()}" if detail is not None else ""
            raise AssertionError(f"{what} within {timeout_s} s{seen}")
        time.sleep(0.1)


# ---------------------------------------------------------------- the wire
def test_echo_roundtrip(pair):
    out = []
    for s in pair:
        c = s.dn_client(s.dns[0])
        out.append(c.echo(b"hello"))
        c.close()
    assert out == [b"hello", b"hello"]


def test_remote_chunk_io(pair):
    data = _data(0, 10_000)
    got = []
    for s in pair:
        c = s.dn_client(s.dns[0])
        ids = s.ids
        ck = checksum if s.port else j_checksum
        crc = ck.Checksum(ck.ChecksumType.CRC32C, 4096)
        c.create_container(99)
        cs = crc.compute(data)
        bid = ids.BlockID(99, 1)
        infos = [ids.ChunkInfo(f"c{i}", i * 5000, 5000,
                               crc.compute(data[i * 5000:(i + 1) * 5000]))
                 for i in range(2)]
        c.write_chunk(bid, ids.ChunkInfo("c", 0, data.size, cs), data)
        c.put_block(ids.BlockData(bid, [ids.ChunkInfo("c", 0, data.size,
                                                      cs)]))
        one = c.read_chunk(bid, ids.ChunkInfo("c", 0, data.size, cs),
                           verify=True)
        c.write_chunks_commit(ids.BlockID(99, 2),
                              [(i, data[k * 5000:(k + 1) * 5000])
                               for k, i in enumerate(infos)],
                              commit=ids.BlockData(ids.BlockID(99, 2), infos))
        batch = c.read_chunks(ids.BlockID(99, 2), infos, verify=True)
        got.append((bytes(one), [bytes(b) for b in batch],
                    cs.checksums,
                    c.get_committed_block_length(ids.BlockID(99, 2)),
                    [b.block_id.local_id for b in c.list_blocks(99)]))
        c.close()
    assert got[0] == got[1]
    assert got[0][0] == data.tobytes()
    bad = codes(pair, lambda s: s.dn_client(s.dns[0]).create_container(99))
    assert bad == ["CONTAINER_EXISTS"] * 2
    bad = codes(pair, lambda s: s.dn_client(s.dns[0]).list_blocks(12345))
    assert bad == ["CONTAINER_NOT_FOUND"] * 2
    bad = codes(pair, lambda s: s.dn_client(s.dns[0]).get_block(
        s.ids.BlockID(99, 77)))
    assert bad == ["NO_SUCH_BLOCK"] * 2


def test_stream_write_block_matches_reference(pair):
    """Slabs of any size cut into chunks on the datanode: the same chunk
    list, CRCs and bytes in both."""
    data = _data(3, 300_000)
    cuts = [0, 1, 70_000, 70_001, 200_000, 300_000]
    got = []
    for s in pair:
        c = s.dn_client(s.dns[1])
        c.create_container(7)
        bid = s.ids.BlockID(7, 1)
        bd = c.stream_write_block(
            bid, [data[a:b] for a, b in zip(cuts, cuts[1:])],
            chunk_size=64 * 1024, bytes_per_checksum=4096)
        got.append(([(ch.offset, ch.length, ch.checksum.checksums)
                     for ch in bd.chunks],
                    b"".join(bytes(c.read_chunk(bid, ch, verify=True))
                             for ch in bd.chunks)))
        c.close()
    assert got[0] == got[1]
    assert got[0][1] == data.tobytes()


def test_ec_key_over_the_wire_and_degraded_read(pair):
    data = _data(1, 60_000)
    for s in pair:
        s.oz.create_volume("v").create_bucket("b", replication=EC)
        s.oz.get_volume("v").get_bucket("b").write_key("k", data)
    infos = both(pair, lambda s: s.oz.om.lookup_key("v", "b", "k"))
    assert [i["size"] for i in infos] == [data.size] * 2
    assert [[g["length"] for g in i["block_groups"]] for i in infos][0] == \
        [[g["length"] for g in i["block_groups"]] for i in infos][1]
    assert pair[0].chunks(infos[0]) == pair[1].chunks(infos[1])
    reads = both(pair, lambda s: s.oz.get_volume("v").get_bucket("b")
                 .read_key("k"))
    assert all(np.array_equal(r, data) for r in reads)
    # degraded read over the wire: one holder's server stops
    for s, info in zip(pair, infos):
        s.daemon(info["block_groups"][0]["nodes"][0]).server.stop()
    reads = both(pair, lambda s: s.oz.get_volume("v").get_bucket("b")
                 .read_key("k"))
    assert all(np.array_equal(r, data) for r in reads)
    # the same bad requests fail with the same codes
    assert codes(pair, lambda s: s.oz.om.lookup_key("v", "b", "nope")) == \
        ["KEY_NOT_FOUND"] * 2
    assert codes(pair, lambda s: s.oz.create_volume("v")) == \
        ["VOLUME_ALREADY_EXISTS"] * 2
    assert codes(pair, lambda s: s.oz.om.bucket_info("v", "nope")) == \
        ["BUCKET_NOT_FOUND"] * 2


def test_s3_verbs_over_the_wire(pair):
    """The gateway's OM verbs through RemoteOmClient against the
    reference's gRPC client: a multipart upload with a replaced part and
    its listings, the composite ETag and the key bytes; key attributes;
    S3 secrets; the upgrade status; and the error codes."""
    parts = [_data(20, 9_000), _data(21, 4_096), _data(22, 5)]

    def run(s):
        b = s.oz.create_volume("v").create_bucket("b", replication=EC)
        up = b.initiate_multipart_upload("mp", metadata={"m": "1"})
        for n in (2, 1, 3, 2):
            up.write_part(n, parts[n - 1])
        listed = [(p["part_number"], p["size"], p["etag"])
                  for p in up.list_parts()]
        uploads = [u["name"] for u in
                   s.oz.om.list_multipart_uploads("v", "b", "")]
        etag = up.complete()["etag"]
        s.oz.om.set_key_attrs("v", "b", "mp", {"tags": {"t": "1"}})
        info = s.oz.om.lookup_key("v", "b", "mp")
        om = s.oz.om
        om_secret = om.get_s3_secret("wire")
        return (listed, uploads, etag, info["size"], info["attrs"],
                info.get("metadata"), b.read_key("mp").tobytes(),
                om.get_s3_secret("wire") == om_secret,
                om.get_s3_secret("nobody", create=False),
                om.revoke_s3_secret("wire"),
                om.get_s3_secret("wire", create=False),
                om.upgrade_status())

    got, want = both(pair, run)
    assert got == want
    assert got[6] == b"".join(parts)
    assert codes(pair, lambda s: s.oz.om.abort_multipart_upload(
        "v", "b", "mp", "no-such-upload")) == ["NO_SUCH_MULTIPART_UPLOAD"] * 2


def test_fresh_client_reads_via_located_lookup(pair):
    data = _data(5, 40_000)
    for s in pair:
        s.oz.create_volume("lv").create_bucket("lb", replication=EC)
        s.oz.get_volume("lv").get_bucket("lb").write_key("k", data)
    for s in pair:
        reader = s.client()  # an empty address book
        assert reader.clients.known_ids() == []
        rb = reader.get_volume("lv").get_bucket("lb")
        assert np.array_equal(rb.read_key("k"), data)
        got = s.client().get_volume("lv").get_bucket("lb").read_key_range(
            "k", 10_000, 5_000)
        assert np.array_equal(got, data[10_000:15_000])


def _close_groups(s, groups) -> None:
    for g in groups:
        for d in s.dns:
            if d.dn.id in g.pipeline.nodes:
                try:
                    d.dn.close_container(g.container_id)
                except Exception:  # noqa: BLE001 - already closed
                    pass


def _rebuilt_unit(s, g, unit: int, victim: str) -> list:
    """(offset, length, CRC words, bytes) of a group's unit on the replica
    that holds its index now (not the victim)."""
    c = s.meta.scm.containers.get(g.container_id)
    holder = next(dn for dn, r in c.replicas.items()
                  if r.replica_index == unit + 1 and dn != victim)
    dn = s.daemon(holder).dn
    bid = s.ids.BlockID(g.container_id, g.local_id)
    return [(ch.offset, ch.length, ch.checksum.checksums,
             dn.read_chunk(bid, ch, verify=True).tobytes())
            for ch in dn.get_block(bid).chunks]


def test_reconstruction_over_the_wire(tmp_path):
    """One datanode of a closed group dies; the SCM plans the rebuild and
    a daemon's coordinator rebuilds the lost unit over the wire, in each
    cluster. The sides run one after the other (their daemons share this
    process's cores). The groups close only once the SCM holds every
    replica, and the victim dies only once they are CLOSED there: the
    replication manager of both packages plans a replica it has not
    heard of yet as lost, and never plans again an index whose plan
    failed (ROADMAP, Queue 3)."""
    data = _data(2, 40_000)
    lost, rebuilt, coordinated = [], [], []
    for port in (True, False):
        s = Side(port, tmp_path / ("port" if port else "ref"))
        side = "port" if port else "reference"
        try:
            b = s.oz.create_volume("v").create_bucket("b", replication=EC)
            b.write_key("k", data)
            groups = s.oz.om.key_block_groups(
                s.oz.om.lookup_key("v", "b", "k"))
            victim_id = groups[0].pipeline.nodes[1]

            def indexes(skip=None):
                return {g.container_id: sorted(
                    r.replica_index for dn_id, r in
                    s.meta.scm.containers.get(g.container_id)
                    .replicas.items() if dn_id != skip) for g in groups}

            def detail(skip=None):
                failed = {d.dn.id: d.failed_commands for d in s.dns
                          if getattr(d, "failed_commands", None)}
                states = {g.container_id: s.meta.scm.containers.get(
                    g.container_id).state.name for g in groups}
                victim_state = s.meta.scm.nodes.get(victim_id).state.name
                return f"replica indexes seen per group {indexes(skip)}, " \
                    f"container states {states}, victim {victim_id} " \
                    f"{victim_state}, failed commands {failed}"

            def whole(skip=None):
                return all(set(v) == {1, 2, 3, 4, 5}
                           for v in indexes(skip).values())

            _wait(f"{side}: the SCM's replica map of the written groups",
                  whole, detail=detail)
            _close_groups(s, groups)
            _wait(f"{side}: the groups CLOSED on the SCM",
                  lambda: whole() and all(
                      s.meta.scm.containers.get(g.container_id).state.name
                      == "CLOSED" for g in groups),
                  detail=detail)
            victim = s.daemon(victim_id)
            bid = s.ids.BlockID(groups[0].container_id, groups[0].local_id)
            lost.append([(ch.offset, ch.length, ch.checksum.checksums,
                          victim.dn.read_chunk(bid, ch).tobytes())
                         for ch in victim.dn.get_block(bid).chunks])
            victim.stop()
            # age out only the victim: an ancient heartbeat passes dead_after
            s.meta.scm.nodes.get(victim_id).last_heartbeat = -1e9
            s.meta.scm.nodes.check_liveness()
            _wait(f"{side}: reconstruction over the wire",
                  lambda: whole(victim_id),
                  detail=lambda: detail(victim_id))
            rebuilt.append(_rebuilt_unit(s, groups[0], 1, victim_id))
            if port:
                # the port's SCM-driven rebuild ran on a daemon's coordinator
                coordinated = [
                    sum(d.reconstruction.metrics.counter(
                        "groups_reconstructed").value for d in s.dns),
                    [d.failed_commands for d in s.dns]]
        finally:
            s.stop()
    assert lost[0] == lost[1] == rebuilt[0] == rebuilt[1]
    assert coordinated[0] >= 1
    assert all(not f for f in coordinated[1])


def test_container_close_converges(tmp_path):
    """A full container goes CLOSING on the SCM, the close command reaches
    every replica over heartbeats, the replicas close and report, and the
    SCM marks it CLOSED, in both clusters."""
    payload = _data(8, 64 * 1024).tobytes()
    results = []
    for port in (True, False):
        s = Side(port, tmp_path / ("port" if port else "ref"), n_dn=5,
                 block_size=64 * 1024, container_size=128 * 1024,
                 heartbeat_s=0.1)
        try:
            b = s.oz.create_volume("v").create_bucket("b", replication=EC)
            for i in range(4):  # two blocks fill a container
                b.write_key(f"k{i}", payload)
            closed = []

            def any_closed():
                closed[:] = [c for c in s.meta.scm.containers.containers()
                             if c.state.value == "CLOSED"]
                return closed

            _wait("a container closed on the SCM", any_closed)
            cid = closed[0].id
            holders = [d for d in s.dns
                       if d.dn.containers._containers.get(cid) is not None]
            assert holders
            assert all(d.dn.containers.get(cid).state.value
                       in ("CLOSED", "QUASI_CLOSED") for d in holders)
            reads = [b.read_key(f"k{i}").tobytes() for i in range(4)]
            results.append((len(holders), reads))
        finally:
            s.stop()
    assert results[0] == results[1]
    assert results[0][1] == [payload] * 4


# ----------------------------------------------------- beyond the reference
def test_per_stripe_writes_match_the_reference(pair, monkeypatch):
    """OZONE_TPU_BATCH_WRITES=0: each stripe is k+p WriteChunk calls and a
    PutBlock barrier, in both packages; the stored chunks are equal. On the
    native datapath each WriteChunk is a stream of one chunk."""
    monkeypatch.setenv("OZONE_TPU_BATCH_WRITES", "0")
    data = _data(11, 3 * 4096 * 5 + 777)
    for s in pair:
        s.oz.create_volume("v").create_bucket("b", replication=EC)
        s.oz.get_volume("v").get_bucket("b").write_key("k", data)
    infos = both(pair, lambda s: s.oz.om.lookup_key("v", "b", "k"))
    stored = pair[0].chunks(infos[0])
    assert stored == pair[1].chunks(infos[1])
    streams = sum(d.dn.metrics.counter("batched_write_streams").value
                  for d in pair[0].dns)
    chunks = sum(d.dn.metrics.counter("batched_write_chunks").value
                 for d in pair[0].dns)
    assert streams == chunks == len(stored)
    assert np.array_equal(pair[0].oz.get_volume("v").get_bucket("b")
                          .read_key("k"), data)


def test_refused_batch_verb_downgrades_for_good(pair):
    """One datanode refuses WriteChunksCommit: the writer rolls the run back,
    replays per stripe and keeps to it; the key equals the reference's. The
    port's sidecars are stopped, so the bulk verbs fall back to the RPC
    (counted) and meet the refusal there."""
    port = pair[0]
    fallbacks = hostmem.METRICS.counter("native_fallbacks").value
    for d in port.dns:
        d.stop_datapath()
        d.server._methods.pop("/ozone.tpu.DatanodeService/WriteChunksCommit")
    data = _data(12, 3 * 4096 * 9 + 5)
    for s in pair:
        s.oz.create_volume("v").create_bucket("b", replication=EC)
        s.oz.get_volume("v").get_bucket("b").write_key("k", data)
    infos = both(pair, lambda s: s.oz.om.lookup_key("v", "b", "k"))
    assert pair[0].chunks(infos[0]) == pair[1].chunks(infos[1])
    assert np.array_equal(port.oz.get_volume("v").get_bucket("b")
                          .read_key("k"), data)
    assert sum(d.dn.metrics.counter("batched_write_streams").value
               for d in port.dns) == 0
    assert hostmem.METRICS.counter("native_fallbacks").value > fallbacks


def test_replication_moves_the_container(pair, tmp_path):
    """A ReplicateCommand pulls the source's packed replica and imports it:
    the target holds the same blocks and chunks; a tarball the reference's
    datanode packed imports the same way."""
    port, ref = pair
    data = _data(13, 30_000)
    for s in pair:
        s.oz.create_volume("v").create_bucket("b", replication=EC)
        s.oz.get_volume("v").get_bucket("b").write_key("k", data)
    g = port.oz.om.key_block_groups(port.oz.om.lookup_key("v", "b", "k"))[0]
    _close_groups(port, [g])
    src = port.daemon(g.pipeline.nodes[0])
    dst = next(d for d in port.dns if d.dn.id not in g.pipeline.nodes)
    dst.execute(ReplicateCommand(g.container_id, src.dn.id, dst.dn.id, 1))
    bid = port_ids.BlockID(g.container_id, g.local_id)

    def held(dn):
        return [(c.to_json(), dn.read_chunk(bid, c, verify=True).tobytes())
                for c in dn.get_block(bid).chunks]

    assert held(dst.dn) == held(src.dn)
    assert dst.dn.containers.get(g.container_id).state is \
        ContainerState.CLOSED
    # the reference's tarball (uncompressed) onto a fresh port datanode
    rg = ref.oz.om.key_block_groups(ref.oz.om.lookup_key("v", "b", "k"))[0]
    _close_groups(ref, [rg])
    rsrc = ref.daemon(rg.pipeline.nodes[0])
    tar = ref.dn_client(rsrc).export_container(rg.container_id,
                                               compress=False)
    fresh = Datanode(tmp_path / "fresh", dn_id="fresh")
    try:
        with pytest.raises(StorageError) as ei:  # refused before it lands
            import_container(fresh, tar, expect_id=4242)
        assert ei.value.code == "CONTAINER_ID_MISMATCH"
        assert fresh.list_containers() == []
        import_container(fresh, tar, expect_id=rg.container_id)
        rbid = port_ids.BlockID(rg.container_id, rg.local_id)
        jbid = j_ids.BlockID(rg.container_id, rg.local_id)
        assert [(ch.to_json(), fresh.read_chunk(rbid, ch, verify=True)
                 .tobytes()) for ch in fresh.get_block(rbid).chunks] == \
            [(ch.to_json(), rsrc.dn.read_chunk(jbid, ch).tobytes())
             for ch in rsrc.dn.get_block(jbid).chunks]
    finally:
        fresh.close()


def test_background_scrub_matches_the_host_scan(pair):
    """scan_once scrubs closed containers round-robin on the daemon's
    device scrubber; a flipped byte gives the host scan's errors and poisons
    the replica."""
    port = pair[0]
    data = _data(14, 50_000)
    port.oz.create_volume("v").create_bucket("b", replication=EC)
    port.oz.get_volume("v").get_bucket("b").write_key("k", data)
    g = port.oz.om.key_block_groups(port.oz.om.lookup_key("v", "b", "k"))[0]
    _close_groups(port, [g])
    d = port.daemon(g.pipeline.nodes[0])
    assert d.scan_once() == []
    assert d._scrubber.dispatches >= 1
    c = d.dn.containers.get(g.container_id)
    f = next(c.chunks.chunks_dir.glob("*.block"))
    raw = bytearray(f.read_bytes())
    raw[100] ^= 0xFF
    f.write_bytes(bytes(raw))
    errs = d.scan_once()
    assert errs and len(errs) == len(d.dn.scan_container(g.container_id))
    assert c.state is ContainerState.UNHEALTHY


def test_daemon_lifecycle_cadence_tiers_over_the_wire(tmp_path, monkeypatch):
    """With OZONE_TPU_LIFECYCLE_PERIOD_S short, the metadata daemon's own
    background loop sweeps: replicated keys under an age-0 rule become
    EC with no call from the client, and read back byte-exact; the
    stored chunks with their CRC words equal the reference's."""
    monkeypatch.setenv("OZONE_TPU_LIFECYCLE_PERIOD_S", "0.5")
    datas = {f"cold-{i}": _data(30 + i, 20_000 + 4096 * i) for i in range(3)}
    out = []
    for port in (True, False):
        s = Side(port, tmp_path / ("port" if port else "ref"))
        side = "port" if port else "reference"
        try:
            b = s.oz.create_volume("v").create_bucket(
                "b", replication="RATIS/THREE")
            for k, d in datas.items():
                b.write_key(k, d)
            s.oz.om.set_bucket_lifecycle("v", "b", [
                {"id": "warm", "prefix": "cold-", "age_days": 0,
                 "action": "TRANSITION_TO_EC", "target": EC}])

            def reps():
                return [s.oz.om.lookup_key("v", "b", k)["replication"]
                        for k in datas]

            _wait(f"{side}: the daemon's sweep",
                  lambda: reps() == [EC] * len(datas),
                  detail=lambda: f"replications {reps()}, lifecycle "
                  f"{s.oz.om.lifecycle_status()['stats']}")
            for k, d in datas.items():
                assert np.array_equal(b.read_key(k), d), (side, k)
            out.append([[c[1:] for c in s.chunks(
                s.oz.om.lookup_key("v", "b", k))] for k in datas])
        finally:
            s.stop()
    assert out[0] == out[1]
