"""The port's control plane against `ozone_tpu`'s, on the CPU.

The native host CRC32C on both of its routes against
`ozone_tpu.utils.checksum`; then a port `MiniOzoneCluster` and a JAX
`MiniOzoneCluster`, both with placement_seed=42, run the same script
(namespace CRUD, EC and replicated keys written, read and range-read,
deleted and purged through the SCM), and their key rows, placements,
stored chunks and chunk CRCs must be equal. The port's OM opens an om.db
the JAX OM wrote; allocation before enough datanodes register raises
safemode in both; and a dead datanode is rebuilt through the SCM's own
ReconstructionCommand, byte-exact.
"""

import time
import types
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from ozone_tpu.om.requests import OMError as JOMError
from ozone_tpu.scm import scm as j_scm
from ozone_tpu.scm.node_manager import NodeState as JNodeState
from ozone_tpu.scm.pipeline import ReplicationConfig as JReplicationConfig
from ozone_tpu.scm.safemode import SafeModeError as JSafeModeError
from ozone_tpu.storage import ids as j_ids
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu.utils import checksum as j_checksum
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.file_checksum import file_checksum
from ozone_tpu_torch.om.om import OzoneManager
from ozone_tpu_torch.om.requests import OMError
from ozone_tpu_torch.scm import scm
from ozone_tpu_torch.scm.node_manager import NodeState
from ozone_tpu_torch.scm.pipeline import ReplicationConfig
from ozone_tpu_torch.scm.safemode import SafeModeError
from ozone_tpu_torch.storage import ids as port_ids
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
from ozone_tpu_torch.utils import checksum

EC = "rs-3-2-4096"
XOR = "xor-3-1-4096"
RATIS = "RATIS/THREE"
BLOCK = 256 * 1024


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain PyTorch versions run at test sizes on one thread: the
    suite runs in several worker processes on shared cores, and torch's
    default of a thread per core in each of them would oversubscribe
    every core the timing-sensitive tests beside these need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ native CRC32C
def test_native_route_is_loaded_with_sse42():
    """g++ is on this host: the library builds from the port's own source
    and its crc32c_hw runs the SSE4.2 instruction."""
    assert checksum.route() == "native"
    assert checksum.native_probe() >= 1
    with checksum.numpy_route():
        assert checksum.route() == "numpy"
        assert checksum.native_probe() == -1
    assert checksum.route() == "native"


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("bpc", [512, 16 * 1024])
def test_crc32c_and_compute_match_reference(route, bpc):
    rng = np.random.default_rng(bpc)
    lengths = [0, 1, 7, 8, 255, 256, 257, bpc - 1, bpc, bpc + 1,
               *rng.integers(0, 70_000, 8).tolist()]
    ctx = checksum.numpy_route() if route == "numpy" else nullcontext()
    with ctx:
        assert checksum.route() == route
        for n in lengths:
            data = rng.integers(0, 256, int(n), dtype=np.uint8)
            prev = int(rng.integers(0, 2**32))
            assert checksum.crc32c(data) == j_checksum.crc32c(data), n
            assert checksum.crc32c(data, prev) == \
                j_checksum.crc32c(data, prev), n
            got = checksum.Checksum(checksum.ChecksumType.CRC32C,
                                    bpc).compute(data)
            want = j_checksum.Checksum(j_checksum.ChecksumType.CRC32C,
                                       bpc).compute(data)
            assert got.to_lists() == want.to_lists(), n
            assert checksum.crc32c_slices(data, bpc).tolist() == [
                int.from_bytes(c, "big") for c in want.checksums], n


# ----------------------------------------------------------------- clusters
def _clusters(tmp_path, n_dn=8, racks=2):
    port = MiniOzoneCluster(tmp_path / "port", num_datanodes=n_dn,
                            racks=racks, block_size=BLOCK,
                            container_size=4 * 1024 * 1024,
                            stale_after_s=1000.0, dead_after_s=2000.0,
                            placement_seed=42, device="cpu")
    ref = JCluster(tmp_path / "ref", num_datanodes=n_dn, racks=racks,
                   block_size=BLOCK, container_size=4 * 1024 * 1024,
                   stale_after_s=1000.0, dead_after_s=2000.0,
                   placement_seed=42)
    return port, ref


@pytest.fixture
def clusters(tmp_path, monkeypatch):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    port, ref = _clusters(tmp_path)
    yield port, ref
    port.close()
    ref.close()


def key_row(info: dict) -> dict:
    """A key row without what differs between runs by design: the
    object id, timestamps and pipeline ids (process-wide counters)."""
    row = {k: v for k, v in info.items()
           if k not in ("object_id", "created", "modified", "block_groups")}
    row["block_groups"] = [{k: v for k, v in g.items() if k != "pipeline_id"}
                           for g in info["block_groups"]]
    return row


def stored_chunks(cluster, info: dict) -> list:
    """[(group, unit, chunk json, bytes)] of a key as its datanodes hold it."""
    out = []
    for g in info["block_groups"]:
        bid = _block_id(cluster, g)
        for u, dn_id in enumerate(g["nodes"]):
            dn = cluster.datanode(dn_id)
            try:
                block = dn.get_block(bid)
            except (StorageError, JStorageError):
                continue  # a unit the group's data never reached
            for c in block.chunks:
                out.append(((bid.container_id, bid.local_id), u, c.to_json(),
                            dn.read_chunk(bid, c, verify=True).tobytes()))
    return out


def both(port, ref, fn):
    """fn(cluster, client) on each cluster; returns (port's, ref's)."""
    return fn(port, port.client()), fn(ref, ref.client())


def test_namespace_crud_matches_reference(clusters):
    def script(c, oz):
        vol = oz.create_volume("vol1")
        vol.create_bucket("b1", replication=EC)
        vol.create_bucket("b2", replication=RATIS)
        codes = []
        for call in (lambda: oz.om.create_volume("vol1"),
                     lambda: vol.create_bucket("b1", replication=EC),
                     lambda: oz.om.delete_volume("vol1"),
                     lambda: oz.om.delete_bucket("vol1", "nope"),
                     lambda: oz.om.bucket_info("vol1", "nope")):
            with pytest.raises((OMError, JOMError)) as ei:
                call()
            codes.append(ei.value.code)
        names = [b["name"] for b in vol.list_buckets()]
        row = dict(oz.om.bucket_info("vol1", "b2"))
        oz.om.delete_bucket("vol1", "b1")
        oz.om.delete_bucket("vol1", "b2")
        oz.om.delete_volume("vol1")
        row.pop("created")
        return codes, names, row, oz.list_volumes()

    got, want = both(*clusters, script)
    assert got == want
    assert got[0] == ["VOLUME_ALREADY_EXISTS", "BUCKET_ALREADY_EXISTS",
                      "VOLUME_NOT_EMPTY", "BUCKET_NOT_FOUND",
                      "BUCKET_NOT_FOUND"]


@pytest.mark.parametrize("replication,size", [
    (EC, 50_000),  # one short group
    (EC, 3 * BLOCK + 4096 * 5 + 77),  # two groups, partial cells
    (XOR, 3 * BLOCK + 12_345),
    (RATIS, 5 * 1024 * 1024 + 7),  # a full 4 MiB chunk and a short one
])
def test_key_write_read_matches_reference(clusters, replication, size):
    port, ref = clusters
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)

    def script(c, oz):
        b = oz.create_volume("v").create_bucket("b", replication=replication)
        b.write_key("k", data)
        b.write_key("k2", data[: size // 3])
        info = oz.om.lookup_key("v", "b", "k")
        assert np.array_equal(b.read_key("k"), data)
        for off, n in ((0, 1), (4095, 2), (size // 2, size // 3),
                       (size - 100, 100)):
            assert np.array_equal(b.read_key_range("k", off, n),
                                  data[off:off + n])
        return (key_row(info), [key_row(k) for k in b.list_keys()],
                stored_chunks(c, info))

    got, want = both(port, ref, script)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[0]["replication"] == replication
    assert len(got[2]) > 0


def test_delete_and_purge_match_reference(clusters):
    port, ref = clusters
    data = np.random.default_rng(5).integers(0, 256, 40_000, dtype=np.uint8)

    def script(c, oz):
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k", data)
        b.write_key("k", data[::-1].copy())  # the overwrite goes to purge
        r = oz.get_volume("v").create_bucket("r", replication=RATIS)
        r.write_key("k", data)
        infos = [oz.om.lookup_key("v", "b", "k"),
                 oz.om.lookup_key("v", "r", "k")]
        b.delete_key("k")
        r.delete_key("k")
        with pytest.raises((OMError, JOMError)) as ei:
            b.read_key("k")
        purged = c.om.run_key_deleting_service_once()
        pending = c.scm.deleted_blocks.pending_count()
        c.tick(rounds=2)
        gone = []
        for info in infos:
            for g in info["block_groups"]:
                for dn_id in g["nodes"]:
                    with pytest.raises((StorageError, JStorageError)):
                        c.datanode(dn_id).get_block(_block_id(c, g))
                    gone.append(dn_id)
        return (ei.value.code, purged, pending,
                c.scm.deleted_blocks.pending_count(), gone,
                [b["used_bytes"] for b in
                 oz.get_volume("v").list_buckets()])

    got, want = both(port, ref, script)
    assert got == want
    assert got[:4] == ("KEY_NOT_FOUND", 3, got[2], 0)
    assert got[2] > 0


def _block_id(cluster, g):
    """A group row's BlockID, of the cluster's own package."""
    ids = j_ids if isinstance(cluster, JCluster) else port_ids
    return ids.BlockID(int(g["container_id"]), int(g["local_id"]))


def test_safemode_gates_allocation_in_both():
    for mod, err, repl in ((scm, SafeModeError, ReplicationConfig),
                           (j_scm, JSafeModeError, JReplicationConfig)):
        s = mod.StorageContainerManager(min_datanodes=3, placement_seed=42)
        s.register_datanode("dn0")
        s.register_datanode("dn1")
        assert s.safemode.in_safemode()
        with pytest.raises(err):
            s.allocate_block(repl.parse("RATIS/ONE"), BLOCK)
        s.register_datanode("dn2")
        g = s.allocate_block(repl.parse("RATIS/THREE"), BLOCK)
        assert sorted(g.pipeline.nodes) == ["dn0", "dn1", "dn2"]


def test_port_om_reads_reference_om_db(tmp_path, monkeypatch):
    """Carrying state across: the JAX OM writes an om.db; the port's OM
    opens it and its lookups and listings equal the JAX OM's rows. The
    store holds an FSO bucket too: a tree three levels deep, a renamed
    directory, a deleted subtree still in deleted_dirs, and an hsynced
    file still open; the port's file status, listings, lookups, open
    files and file checksums (over port datanodes opened on the
    reference's datanode directories) equal the reference's answers."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    ref = JCluster(tmp_path / "ref", num_datanodes=6, block_size=BLOCK,
                   stale_after_s=1000.0, dead_after_s=2000.0)
    oz = ref.client()
    rng = np.random.default_rng(11)
    vol = oz.create_volume("v")
    for bucket, repl in (("ec", EC), ("rep", RATIS), ("leg", EC)):
        if bucket == "leg":
            ref.om.create_bucket("v", bucket, repl, layout="LEGACY")
            b = vol.get_bucket(bucket)
        else:
            b = vol.create_bucket(bucket, replication=repl)
        for i, n in enumerate((0, 9_999, 3 * BLOCK + 5)):
            b.write_key(f"dir/k{i}", rng.integers(0, 256, n, dtype=np.uint8))
    oz.get_volume("v").get_bucket("ec").delete_key("dir/k1")
    # the FSO bucket
    ref.om.create_bucket("v", "fso", EC, layout="FILE_SYSTEM_OPTIMIZED")
    fb = vol.get_bucket("fso")
    for p, n in (("a/b/c/f1", 9_999), ("a/b/f2", 3 * BLOCK + 5),
                 ("a/f3", 100), ("top", 0), ("gone/sub/f4", 777)):
        fb.write_key(p, rng.integers(0, 256, n, dtype=np.uint8))
    ref.om.rename_key("v", "fso", "a/b", "a/bb")
    ref.om.delete_directory("v", "fso", "gone", recursive=True)
    ref.om.create_bucket("v", "fsr", RATIS, layout="FILE_SYSTEM_OPTIMIZED")
    h = vol.get_bucket("fsr").open_key("logs/h")
    h.write(rng.integers(0, 256, 5000, dtype=np.uint8))
    h.hsync()  # left open: the writer never closes
    fso_paths = ["", "a", "a/bb", "a/bb/c", "a/bb/c/f1", "a/bb/f2", "a/f3",
                 "top"]
    want_fso = {
        "status": {p: ref.om.get_file_status("v", "fso", p)
                   for p in fso_paths},
        "list": {p: ref.om.list_status("v", "fso", p)
                 for p in ("", "a", "a/bb", "a/bb/c")},
        "keys": ref.om.list_keys("v", "fso"),
        "page": ref.om.list_keys("v", "fso", start_after="a/bb/c/f1",
                                 limit=2),
        "lookup": {p: ref.om.lookup_key("v", "fso", p)
                   for p in ("a/bb/c/f1", "a/bb/f2", "a/f3", "top")},
        "hsynced": ref.om.lookup_key("v", "fsr", "logs/h"),
        "open": ref.om.list_open_files("v", "fsr"),
        "deleted_dirs": list(ref.om.store.iterate("deleted_dirs")),
        "checksum": {p: fb.file_checksum(p)
                     for p in ("a/bb/c/f1", "a/bb/f2", "a/f3")},
        "checksum_hsynced": vol.get_bucket("fsr").file_checksum("logs/h"),
        "missing": [_code(lambda p=p: ref.om.get_file_status("v", "fso", p))
                    for p in ("a/b", "gone", "gone/sub/f4")],
    }
    want_lists = {b: ref.om.list_keys("v", b) for b in ("ec", "rep", "leg")}
    want_rows = {(b, k["name"]): ref.om.lookup_key("v", b, k["name"])
                 for b, rows in want_lists.items() for k in rows}
    want_deleted = list(ref.om.store.iterate("deleted_keys"))
    ref.close()

    om = OzoneManager(tmp_path / "ref" / "om" / "om.db",
                      scm.StorageContainerManager(placement_seed=42))
    try:
        assert {b: om.list_keys("v", b) for b in want_lists} == want_lists
        assert {bk: om.lookup_key("v", *bk) for bk in want_rows} == want_rows
        assert list(om.store.iterate("deleted_keys")) == want_deleted
        assert om.list_volumes()[0]["name"] == "v"
        assert om.lookup_key("v", "leg", "/dir//k2")["size"] == 3 * BLOCK + 5
        groups = om.key_block_groups(want_rows[("ec", "dir/k2")])
        assert [g.to_json()["nodes"] for g in groups] == \
            [g["nodes"] for g in want_rows[("ec", "dir/k2")]["block_groups"]]
        # the FSO bucket, carried across
        assert {p: om.get_file_status("v", "fso", p) for p in fso_paths} \
            == want_fso["status"]
        assert {p: om.list_status("v", "fso", p) for p in want_fso["list"]} \
            == want_fso["list"]
        assert om.list_keys("v", "fso") == want_fso["keys"]
        assert om.list_keys("v", "fso", start_after="a/bb/c/f1",
                            limit=2) == want_fso["page"]
        assert {p: om.lookup_key("v", "fso", p) for p in want_fso["lookup"]} \
            == want_fso["lookup"]
        assert om.lookup_key("v", "fsr", "logs/h") == want_fso["hsynced"]
        assert want_fso["hsynced"]["hsync_client_id"]
        assert om.list_open_files("v", "fsr") == want_fso["open"]
        assert list(om.store.iterate("deleted_dirs")) == \
            want_fso["deleted_dirs"] != []
        assert [_code(lambda p=p: om.get_file_status("v", "fso", p))
                for p in ("a/b", "gone", "gone/sub/f4")] == \
            want_fso["missing"] == ["KEY_NOT_FOUND"] * 3
        factory = DatanodeClientFactory()
        for d in sorted((tmp_path / "ref").glob("dn*")):
            factory.register_local(Datanode(d, dn_id=d.name))
        reader = types.SimpleNamespace(om=om, clients=factory)
        assert {p: file_checksum(reader, "v", "fso", p)
                for p in want_fso["checksum"]} == want_fso["checksum"]
        assert file_checksum(reader, "v", "fsr", "logs/h") == \
            want_fso["checksum_hsynced"]
    finally:
        om.close()


def _code(fn):
    """The OMError code (either package's) `fn` raises, or None."""
    try:
        fn()
    except (OMError, JOMError) as e:
        return e.code
    return None


def _kill(cluster, dn_id, dead_state):
    """Stop a datanode and let the SCM's liveness sweep find it dead (its
    last heartbeat moved far into the past; every other node stays
    healthy)."""
    cluster.stop_datanode(dn_id)
    cluster.scm.nodes.get(dn_id).last_heartbeat = -1e9
    cluster.scm.nodes.check_liveness()
    assert cluster.scm.nodes.get(dn_id).state is dead_state


def test_scm_driven_repair_matches_reference(clusters):
    """Close the containers, stop one datanode and let the SCM find it
    dead: the replication manager's ReconstructionCommand rebuilds its
    unit of every group onto a spare; the rebuilt chunks equal the lost
    ones and the key reads back byte-exact (test_minicluster's flow)."""
    port, ref = clusters
    data = np.random.default_rng(2).integers(0, 256, 3 * BLOCK + 40_000,
                                             dtype=np.uint8)

    def script(c, oz):
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k", data)
        c.tick()
        info = oz.om.lookup_key("v", "b", "k")
        victim = info["block_groups"][0]["nodes"][1]
        lost = stored_chunks(c, info)
        for g in info["block_groups"]:
            for dn_id in g["nodes"]:
                c.datanode(dn_id).close_container(int(g["container_id"]))
        c.tick()
        _kill(c, victim, JNodeState.DEAD if c is ref else NodeState.DEAD)
        c.tick(rounds=3)
        report = c.scm.replication.run_once()
        targets = {}
        for g in info["block_groups"]:
            cinfo = c.scm.containers.get(int(g["container_id"]))
            idx = {r.replica_index: dn for dn, r in cinfo.replicas.items()}
            assert sorted(idx) == [1, 2, 3, 4, 5]
            u = g["nodes"].index(victim) if victim in g["nodes"] else None
            if u is None:
                continue
            targets[g["container_id"]] = idx[u + 1]
            g["nodes"][u] = idx[u + 1]
        rebuilt = stored_chunks(c, info)
        # the key read through the rebuilt replicas
        reread = b.read_key_info(info)
        return (victim, targets, report.under_replicated, lost, rebuilt,
                np.array_equal(reread, data))

    got, want = both(port, ref, script)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2] == []
    assert got[5] and want[5]
    # the rebuilt units are the lost ones, chunk for chunk, CRCs included
    assert got[4] == got[3]
    assert got[4] == want[4]
    assert all(t != got[0] for t in got[1].values()) and got[1]


def test_background_heartbeats_drive_the_deletion_chain(clusters):
    """The minicluster's background pump ticks on its own: a purged key's
    blocks leave every datanode with no explicit tick."""
    port, _ref = clusters
    oz = port.client()
    b = oz.create_volume("v").create_bucket("b", replication=EC)
    b.write_key("k", np.arange(30_000, dtype=np.uint8))
    info = oz.om.lookup_key("v", "b", "k")
    b.delete_key("k")
    assert port.om.run_key_deleting_service_once() == 1
    port.start_heartbeats(interval_s=0.02)
    deadline = time.monotonic() + 20
    while port.scm.deleted_blocks.pending_count() and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert port.scm.deleted_blocks.pending_count() == 0
    for g in info["block_groups"]:
        for dn_id in g["nodes"]:
            with pytest.raises(StorageError):
                port.datanode(dn_id).get_block(_block_id(port, g))


def test_replication_plans_complete_by_report_and_expire(tmp_path):
    """Where the port departs from the reference's replication manager on
    purpose (its pending set clears only through `op_completed`, which no
    daemon calls): a plan whose command never ran is planned again once
    `PENDING_TIMEOUT_S` has passed, and a planned index is no longer
    pending once a replica of it is reported, so the same index is
    rebuilt again when its new holder dies."""
    c = MiniOzoneCluster(tmp_path, num_datanodes=7, block_size=BLOCK,
                         container_size=4 * 1024 * 1024, stale_after_s=1000.0,
                         dead_after_s=2000.0, device="cpu")
    try:
        rm = c.scm.replication
        now = [0.0]
        rm.clock = lambda: now[0]
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        data = np.random.default_rng(7).integers(0, 256, 40_000,
                                                 dtype=np.uint8)
        b.write_key("k", data)
        g = oz.om.lookup_key("v", "b", "k")["block_groups"][0]
        cid = int(g["container_id"])
        for dn_id in g["nodes"]:
            c.datanode(dn_id).close_container(cid)
        c.tick()
        _kill(c, g["nodes"][1], NodeState.DEAD)
        rm.run_once()
        assert (cid, 2) in rm._pending
        # the command is lost (as a failed one is, in the daemons)
        c.scm.nodes._commands.clear()
        rm.run_once()
        assert rm.metrics.counter("reconstructions_emitted").value == 1
        now[0] += rm.PENDING_TIMEOUT_S + 1
        rm.run_once()  # expired: planned again
        assert rm.metrics.counter("reconstructions_emitted").value == 2
        assert rm.metrics.counter("pending_expired").value == 1
        c.heartbeat_all()  # the command runs; the rebuilt replica reports
        c.heartbeat_all()
        holder = next(dn for dn, r in c.scm.containers.get(cid)
                      .replicas.items() if r.replica_index == 2
                      and dn != g["nodes"][1])
        rm.run_once()
        assert (cid, 2) not in rm._pending
        # the new holder dies: the same index is planned and rebuilt again
        _kill(c, holder, NodeState.DEAD)
        c.tick(rounds=2)
        idx = {r.replica_index for dn, r in c.scm.containers.get(cid)
               .replicas.items() if dn not in (holder, g["nodes"][1])}
        assert idx == {1, 2, 3, 4, 5}
        assert rm.metrics.counter("reconstructions_emitted").value == 3
        assert np.array_equal(b.read_key("k"), data)
    finally:
        c.close()
