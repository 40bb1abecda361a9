"""The consumers that take a mesh or a mesh executor, on the CPU.

- A degraded RS(10,4) read through the port's `ECBlockGroupReader` with a
  mesh of four CPU slots (DP, and the survivor ring with `use_ring`) and
  through a mesh executor, beside the reference reader with a mesh of
  four virtual devices and with its executor, on the same layout (the
  dual cluster of test_torch_ec_write.py): the same bytes, equal to the
  source; every DP decode batch is four kernel passes.
- The scrubber with `mesh=`: its verdicts equal the reference scrubber's
  with a mesh, and its own without one; each slice batch is one pass per
  slot.
- A reconstruction storm through a mesh executor: byte-exact repairs and
  the report's `mesh_*` counter deltas.
- The SLO shedder's `slo_mesh_depth` verdict over the `mesh` registry's
  `inflight_depth` gauge, beside the reference's, and its knob.
- Recon's `/api/mesh`: the live executor's `stats()`, with every key of
  the reference's.
"""

import numpy as np
import pytest
import torch

from ozone_tpu import admission as j_admission
from ozone_tpu.client import ec_reader as j_ec_reader
from ozone_tpu.client import dn_client as j_dn_client
from ozone_tpu.client import ec_writer as j_ec_writer
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.parallel import mesh_executor as j_mex
from ozone_tpu.parallel import sharded as j_sharded
from ozone_tpu.scm import pipeline as j_pipeline
from ozone_tpu.storage import datanode as j_datanode
from ozone_tpu.storage import ids as j_ids
from ozone_tpu.storage import scrubber as j_scrubber
from ozone_tpu.utils import checksum as j_checksum
from ozone_tpu.utils.metrics import registry as j_registry
from ozone_tpu_torch import admission
from ozone_tpu_torch.client import dn_client, ec_reader, ec_writer
from ozone_tpu_torch.client.reconstruction import ReconstructionStorm
from ozone_tpu_torch.codec import fused_kernel
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.parallel import mesh_executor
from ozone_tpu_torch.parallel.mesh_executor import MeshExecutor
from ozone_tpu_torch.parallel.sharded import make_mesh
from ozone_tpu_torch.recon.recon import ReconServer
from ozone_tpu_torch.scm import pipeline
from ozone_tpu_torch.storage import datanode, ids, scrubber
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils import checksum
from ozone_tpu_torch.utils.checksum import ChecksumType
from ozone_tpu_torch.utils.metrics import registry as p_registry
from tests.test_torch_ec_write import CELL, MiniEC
from tests.test_torch_reconstruction_storm import _port_cluster, _victim, _write_keys
from tests.test_torch_scrubber import flip

K, P = 10, 4
ROW = K * CELL
#: two groups of 4 stripes, then a third of one stripe and 77 bytes (every
#: data unit holds bytes there: the reference counts a unit with no block
#: as unreachable)
SIZE = 2 * 4 * ROW + ROW + 77


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def passes(monkeypatch):
    seen = []
    real = fused_kernel.fused_encode_crc

    def spy(data, *a, **kw):
        seen.append(tuple(data.shape))
        return real(data, *a, **kw)

    monkeypatch.setattr(fused_kernel, "fused_encode_crc", spy)
    return seen


@pytest.fixture
def rs104(tmp_path, monkeypatch):
    """(port, ref, data, port groups, ref groups) on 14 datanodes each,
    decode batches of 4 stripes (one batch per full group)."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    monkeypatch.setenv("OZONE_TPU_DECODE_BATCH", "4")
    port = MiniEC(tmp_path / "port", (datanode, dn_client, pipeline, ec_writer),
                  CoderOptions(K, P, "rs", cell_size=CELL), n_dn=K + P)
    ref = MiniEC(tmp_path / "ref", (j_datanode, j_dn_client, j_pipeline, j_ec_writer),
                 JOptions(K, P, "rs", cell_size=CELL), n_dn=K + P)
    data = np.random.default_rng(21).integers(0, 256, SIZE, dtype=np.uint8)
    groups, jgroups = port.write(data, device="cpu"), ref.write(data)
    for cluster, gs in ((port, groups), (ref, jgroups)):
        for g in gs:
            for u in (0, 1):  # two data units lost in every group
                cluster.dns[int(g.pipeline.nodes[u][2:])].delete_container(
                    g.container_id, force=True)
    yield port, ref, data, groups, jgroups
    port.close()
    ref.close()


def _read_all(port, ref, groups, jgroups, port_kw, ref_kw):
    got, jgot, dispatches = [], [], 0
    for g, jg in zip(groups, jgroups):
        r = ec_reader.ECBlockGroupReader(
            g, port.opts, port.clients, checksum=ChecksumType.CRC32C,
            bytes_per_checksum=1024, device="cpu", **port_kw)
        got.append(r.read_all())
        dispatches += r.dispatches
        jgot.append(j_ec_reader.ECBlockGroupReader(
            jg, ref.opts, ref.clients, checksum=j_ec_reader.ChecksumType.CRC32C,
            bytes_per_checksum=1024, **ref_kw).read_all())
    return np.concatenate(got), np.concatenate(jgot), dispatches


@pytest.mark.parametrize("use_ring", [False, True])
def test_degraded_read_over_a_mesh_matches_reference(rs104, passes, use_ring):
    port, ref, data, groups, jgroups = rs104
    got, jgot, dispatches = _read_all(
        port, ref, groups, jgroups,
        {"mesh": make_mesh(devices=["cpu"] * 4), "use_ring": use_ring},
        {"mesh": j_sharded.make_mesh(4), "use_ring": use_ring})
    assert np.array_equal(got, data) and np.array_equal(got, jgot)
    # stripes 0-3 of each full group and the tail's two decode
    assert dispatches == 3
    if not use_ring:
        assert len(passes) == 4 * dispatches  # DP: one pass per slot
    else:
        # partials, 4 x 3 combines, a CRC pass per slot holding rows
        assert len(passes) == 2 * (4 + 12 + 4) + (4 + 12 + 2)


def test_degraded_read_through_the_executor_matches_reference(rs104):
    port, ref, data, groups, jgroups = rs104
    ex = MeshExecutor(mesh=make_mesh(devices=["cpu"] * 4), depth=2)
    jex = j_mex.MeshExecutor(mesh=j_sharded.make_mesh(4), depth=2)
    snap0 = mesh_executor.METRICS.snapshot()
    try:
        got, jgot, dispatches = _read_all(port, ref, groups, jgroups,
                                          {"executor": ex}, {"executor": jex})
    finally:
        ex.close()
        jex.close()
    assert np.array_equal(got, data) and np.array_equal(got, jgot)
    snap1 = mesh_executor.METRICS.snapshot()
    assert snap1["submissions"] - snap0.get("submissions", 0) == dispatches == 3
    assert snap1["dispatches"] - snap0.get("dispatches", 0) == 3


def _scrub_pair(tmp_path, mesh, jmesh, cap):
    rng = np.random.default_rng(9)
    payloads = [rng.bytes(9 * 1024), rng.bytes(5 * 1024 + 100)]
    out = []
    for dn_mod, ids_mod, sum_mod, scrub_mod, kw in (
            (datanode, ids, checksum, scrubber, {"device": "cpu", "mesh": mesh}),
            (j_datanode, j_ids, j_checksum, j_scrubber, {"mesh": jmesh})):
        d = dn_mod.Datanode(tmp_path / f"{scrub_mod.__name__}-{mesh is None}",
                            dn_id="dn0")
        try:
            d.create_container(1)
            infos = []
            for i, p in enumerate(payloads):
                arr = np.frombuffer(p, np.uint8)
                cd = sum_mod.Checksum(sum_mod.ChecksumType.CRC32C, 1024).compute(arr)
                info = ids_mod.ChunkInfo(f"c{i}", i * 16 * 1024, arr.size, checksum=cd)
                d.write_chunk(ids_mod.BlockID(1, 1), info, arr)
                infos.append(info)
            d.put_block(ids_mod.BlockData(ids_mod.BlockID(1, 1), infos))
            for pos in (3, 7 * 1024 + 5, 16 * 1024 + 5 * 1024 + 50):
                flip(d, 1, ids_mod.BlockID(1, 1), pos)
            s = scrub_mod.DeviceScrubber(max_batch_bytes=cap, **kw)
            out.append((s.scrub_container(d, 1), d.containers.get(1).state.value))
            if scrub_mod is scrubber:
                out.append(s.dispatches)
        finally:
            d.close()
    return out


def test_scrubber_verdicts_with_a_mesh(tmp_path, passes):
    """Slice batches rounded up to a multiple of the mesh (3) and split
    over its slots: the same errors and state as the reference scrubber on
    its mesh, and as the port's without one."""
    port, dispatches, ref = _scrub_pair(tmp_path, make_mesh(devices=["cpu"] * 3),
                                        j_sharded.make_mesh(3), 4 * 1024)
    assert port == ref and len(port[0]) == 3
    # 14 full slices in batches of at most 4 (the tail is checked on the host)
    assert dispatches == 4 and len(passes) == 3 * dispatches
    alone, _, _ = _scrub_pair(tmp_path, None, None, 4 * 1024)
    assert alone == port


def test_storm_through_a_mesh_executor(tmp_path):
    cluster = _port_cluster(tmp_path)
    ex = MeshExecutor(mesh=make_mesh(devices=["cpu"] * 4), depth=2)
    try:
        _write_keys(cluster, 10, seed=5)
        victim, held = _victim(cluster)
        dn = cluster.datanode(victim)
        truth = {(c.id, bd.block_id.local_id): [dn.read_chunk(bd.block_id, i)
                                                for i in bd.chunks]
                 for c in held for bd in dn.list_blocks(c.id)}
        cluster.stop_datanode(victim)
        storm = ReconstructionStorm(cluster.scm, cluster.clients, executor=ex,
                                    device="cpu")
        assert storm.coordinator.executor is ex
        report = storm.repair_datanode(victim)
        assert report.ok and report.containers_repaired == len(held)
        assert report.mesh_dispatches > 0
        assert report.mesh_stripes >= 8 * report.containers_repaired
        assert report.mesh_coalesced_ops >= report.mesh_dispatches
        assert 1 <= report.mesh_max_inflight <= ex.depth + 1
        # every block the victim held is back, chunk for chunk, on a
        # surviving node (its replica's chunks verify against their CRCs)
        for (cid, local_id), chunks in truth.items():
            found = False
            for other in cluster.datanodes:
                if other.id == victim:
                    continue
                try:
                    blk = other.get_block(ids.BlockID(cid, local_id))
                except StorageError:
                    continue
                got = [other.read_chunk(blk.block_id, i, verify=True) for i in blk.chunks]
                if len(got) == len(chunks) and all(
                        np.array_equal(a, b) for a, b in zip(got, chunks)):
                    found = True
                    break
            assert found, f"container {cid} block {local_id} not rebuilt"
    finally:
        ex.close()
        cluster.close()


def _mesh_shed(adm, reg):
    depth = reg("mesh").gauge("inflight_depth")
    out = []
    try:
        s = adm.SloShedder(mesh_depth=2, cache_s=0.0)
        for d in (3, 2, 0):
            depth.set(d)
            out += [s.over_budget(), s.should_shed("bulk"),
                    s.should_shed("interactive")]
        out.append(s.snapshot())
    finally:
        depth.set(0)
    return out


def test_slo_mesh_depth_matches_reference(monkeypatch):
    port = _mesh_shed(admission, p_registry)
    assert port == _mesh_shed(j_admission, j_registry)
    assert port[:3] == ["slo_mesh_depth", "slo_mesh_depth", None]
    assert port[3:6] == [None, None, None]
    monkeypatch.setenv("OZONE_TPU_ADMIT_SLO_MESH_DEPTH_GATEWAY", "5")
    admission.reset_for_tests()
    try:
        assert admission.controller("gateway").shedder.mesh_depth == 5
    finally:
        admission.reset_for_tests()


def test_api_mesh_answers_the_live_executor(monkeypatch):
    monkeypatch.delenv("OZONE_TPU_MESH", raising=False)
    monkeypatch.setattr(mesh_executor, "_executor", None)
    assert ReconServer.mesh_view(None) == {
        "enabled": True, "started": False, "spill_enabled": False,
        "spill_watermark": 64}
    ex = MeshExecutor(mesh=make_mesh(devices=["cpu"] * 2), depth=2)
    jex = j_mex.MeshExecutor(mesh=j_sharded.make_mesh(2), depth=2)
    try:
        monkeypatch.setattr(mesh_executor, "_executor", ex)
        view = ReconServer.mesh_view(None)
        assert set(jex.stats()) <= set(view), set(jex.stats()) - set(view)
        assert view["devices"] == 2 and view["programs_host_twin"] == 0
        monkeypatch.setenv("OZONE_TPU_MESH", "0")
        assert ReconServer.mesh_view(None) == {"enabled": False}
    finally:
        ex.close()
        jex.close()
