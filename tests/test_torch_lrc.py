"""The port's LRC against `ozone_tpu`'s, on the CPU.

Coding matrices and the repair planner of `codec/lrc_math.py` equal the
reference's for lrc-12-2-2 and a second geometry; every single and
double erasure of lrc-12-2-2 decodes through the port's fused decoder
(device="cpu", the kernel's plain version) to the same units and CRC
words as the JAX fused decoder; a local repair reads exactly group_size
datanodes; a degraded read and a rebuild on the port's dual cluster are
byte-exact against the JAX reader and coordinator on the same keys; and
a group shorter than a stripe repairs locally over its known-zero units.
"""

import itertools

import numpy as np
import pytest

from ozone_tpu.client import dn_client as j_dn_client
from ozone_tpu.client import ec_reader as j_ec_reader
from ozone_tpu.client import ec_writer as j_ec_writer
from ozone_tpu.codec import fused as j_fused
from ozone_tpu.codec import lrc_math as j_lrc_math
from ozone_tpu.codec import service as j_cs
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.scm import pipeline as j_pipeline
from ozone_tpu.storage import datanode as j_datanode
from ozone_tpu.storage import reconstruction as j_reconstruction
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch.client import dn_client, ec_reader, ec_writer
from ozone_tpu_torch.codec import lrc_math
from ozone_tpu_torch.codec import service as cs
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import FusedSpec, make_fused_decoder, make_fused_encoder
from ozone_tpu_torch.scm import pipeline
from ozone_tpu_torch.storage import datanode, reconstruction
from ozone_tpu_torch.storage.ids import ContainerState
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType
from tests.test_torch_ec_write import MiniEC

CELL = 4096
SCHEME = f"lrc-12-2-2-{CELL}"
LRC = CoderOptions.parse(SCHEME)
J_LRC = JOptions.parse(SCHEME)
N = LRC.all_units
SPARES = ["dn16", "dn17"]
PATTERNS = [list(p) for r in (1, 2) for p in itertools.combinations(range(N), r)]


# ------------------------------------------------------------- matrices
@pytest.mark.parametrize("scheme", [SCHEME, "lrc-6-3-2-4096"])
def test_matrices_and_planner_match_reference(scheme):
    opts, jopts = CoderOptions.parse(scheme), JOptions.parse(scheme)
    assert lrc_math.geometry(opts) == j_lrc_math.geometry(jopts)
    assert np.array_equal(lrc_math.parity_matrix(opts),
                          j_lrc_math.parity_matrix(jopts))
    assert np.array_equal(lrc_math.encode_matrix(opts),
                          j_lrc_math.encode_matrix(jopts))
    n = opts.all_units
    for u in range(n):
        assert lrc_math.group_of(opts, u) == j_lrc_math.group_of(jopts, u)
    rng = np.random.default_rng(1)
    patterns = [list(p) for r in (1, 2, 3)
                for p in itertools.combinations(range(n), r)]
    for erased in patterns:
        everyone = [u for u in range(n) if u not in erased]
        # all survivors, a shuffled preference, and a random subset
        prefer = list(rng.permutation(everyone))
        subset = sorted(rng.choice(everyone, len(everyone) - 1, replace=False))
        for avail, pref in ((everyone, None), (everyone, prefer),
                            (subset, None)):
            try:
                want = j_lrc_math.plan_valid(jopts, erased, avail, prefer=pref)
            except ValueError:
                with pytest.raises(ValueError):
                    lrc_math.plan_valid(opts, erased, avail, prefer=pref)
                continue
            got = lrc_math.plan_valid(opts, erased, avail, prefer=pref)
            assert got == want, (erased, avail)
            assert np.array_equal(
                lrc_math.recovery_rows(opts, got[0], erased),
                j_lrc_math.recovery_rows(jopts, want[0], erased))
        if len(erased) < 3:
            assert lrc_math.repair_read_units(opts, erased) == \
                j_lrc_math.repair_read_units(jopts, erased)


def test_local_rows_and_read_sets():
    pm = lrc_math.parity_matrix(LRC)
    assert pm.shape == (4, 12)
    assert np.array_equal(pm[0], np.array([1] * 6 + [0] * 6, np.uint8))
    assert np.array_equal(pm[1], np.array([0] * 6 + [1] * 6, np.uint8))
    assert np.all(pm[2:] != 0)
    healthy = [u for u in range(N) if u != 2]
    assert lrc_math.plan_valid(LRC, [2], healthy) == ([0, 1, 3, 4, 5, 12], "local")
    assert len(PATTERNS) == 16 + 120


# --------------------------------------------------------------- decoder
@pytest.fixture(scope="module")
def codewords():
    """(units [B, 16, C], port parity+CRCs, JAX parity+CRCs) of one seeded
    batch: 1 KiB cells, 256-byte CRC32C slices."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OZONE_TPU_FUSED_BACKEND", "jax")
        opts, jopts = (CoderOptions(12, 4, "lrc", 1024, local_groups=2),
                       JOptions(12, 4, "lrc", 1024, local_groups=2))
        spec = FusedSpec(opts, ChecksumType.CRC32C, 256)
        jspec = j_fused.FusedSpec(jopts, JChecksumType.CRC32C, 256)
        data = np.random.default_rng(7).integers(0, 256, (2, 12, 1024),
                                                 dtype=np.uint8)
        parity, crcs = make_fused_encoder(spec, device="cpu")(data)
        jparity, jcrcs = (np.asarray(x)
                          for x in j_fused.make_fused_encoder(jspec)(data))
        yield (spec, jspec, np.concatenate([data, parity.numpy()], 1),
               (parity.numpy(), crcs.numpy().view(np.uint32)),
               (jparity, jcrcs.astype(np.uint32)))


def test_lrc_encode_matches_reference(codewords):
    _spec, _jspec, _units, (parity, crcs), (jparity, jcrcs) = codewords
    assert np.array_equal(parity, jparity)
    assert np.array_equal(crcs, jcrcs)


@pytest.mark.parametrize("erased", PATTERNS, ids=[str(p) for p in PATTERNS])
def test_every_single_and_double_erasure_matches_reference(codewords, erased,
                                                           monkeypatch):
    monkeypatch.setenv("OZONE_TPU_FUSED_BACKEND", "jax")
    spec, jspec, units, _p, _j = codewords
    avail = [u for u in range(N) if u not in erased]
    valid, kind = lrc_math.plan_valid(spec.options, erased, avail)
    assert (valid, kind) == j_lrc_math.plan_valid(jspec.options, erased, avail)
    rec, crcs = make_fused_decoder(spec, valid, erased, device="cpu")(
        units[:, valid])
    jrec, jcrcs = (np.asarray(x) for x in j_fused.make_fused_decoder(
        jspec, valid, erased)(units[:, valid]))
    assert np.array_equal(rec.numpy(), units[:, erased])
    assert np.array_equal(rec.numpy(), jrec)
    assert np.array_equal(crcs.numpy().view(np.uint32),
                          jcrcs.astype(np.uint32))
    if len(erased) == 1 and erased[0] < 14:
        assert kind == "local" and len(valid) == 6


# -------------------------------------------------------------- datapath
def _spy_reads(clients):
    """Count each datanode client's chunk reads."""
    counts: dict[str, int] = {}

    def wrap(dn_id, fn):
        def spy(*a, **kw):
            counts[dn_id] = counts.get(dn_id, 0) + 1
            return fn(*a, **kw)
        return spy

    for dn_id, c in clients._local.items():
        c.read_chunk = wrap(dn_id, c.read_chunk)
        c.read_chunks = wrap(dn_id, c.read_chunks)
    return counts


@pytest.fixture
def lrc_clusters(tmp_path, monkeypatch):
    """Port and JAX clusters of 18 datanodes (16 units, 2 spares), decode
    batches of 3 stripes, the JAX fused decoder on its jax backend."""
    monkeypatch.setenv("OZONE_TPU_DECODE_BATCH", "3")
    monkeypatch.setenv("OZONE_TPU_FUSED_BACKEND", "jax")
    cs.reset_for_tests()
    j_cs.reset_for_tests()
    port = MiniEC(tmp_path / "port", (datanode, dn_client, pipeline, ec_writer),
                  LRC, n_dn=18)
    ref = MiniEC(tmp_path / "ref",
                 (j_datanode, j_dn_client, j_pipeline, j_ec_writer), J_LRC, n_dn=18)
    yield port, ref
    port.close()
    ref.close()
    cs.reset_for_tests()
    j_cs.reset_for_tests()


def _lose(cluster, group, units):
    for u in units:
        cluster.dns[int(group.pipeline.nodes[u][2:])].delete_container(
            group.container_id, force=True)


def _port_reader(port, g):
    return ec_reader.ECBlockGroupReader(g, port.opts, port.clients,
                                        bytes_per_checksum=1024, device="cpu")


#: one full group of 4 stripes, then 1 stripe and a partial one
SIZE = 12 * 4 * CELL + 12 * CELL + 777


@pytest.mark.parametrize("service", ["1", "0"])
@pytest.mark.parametrize("lost", [[4], [4, 9], [0, 1], [13, 15]])
def test_degraded_read_matches_reference(lrc_clusters, monkeypatch, service,
                                         lost):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", service)
    port, ref = lrc_clusters
    data = np.random.default_rng(len(lost)).integers(0, 256, SIZE, dtype=np.uint8)
    groups, jgroups = port.write(data, device="cpu"), ref.write(data)
    assert [g.length for g in groups] == [g.length for g in jgroups]
    assert port.stored(groups) == ref.stored(jgroups)
    s0 = cs.METRICS.counter("submissions").value
    base = 0
    for g, jg in zip(groups, jgroups):
        _lose(port, g, lost)
        _lose(ref, jg, lost)
        r = _port_reader(port, g)
        got = r.read_all()
        jr = j_ec_reader.ECBlockGroupReader(jg, ref.opts, ref.clients,
                                            bytes_per_checksum=1024)
        assert np.array_equal(got, jr.read_all())
        assert np.array_equal(got, data[base:base + g.length])
        rec, crcs = r.recover_cells_with_crcs(lost)
        jrec, jcrcs = jr.recover_cells_with_crcs(lost)
        assert np.array_equal(rec, jrec)
        assert np.array_equal(crcs, np.asarray(jcrcs, dtype=np.uint32))
        base += g.length
    moved = cs.METRICS.counter("submissions").value - s0
    assert (moved > 0) == (service == "1")


def test_local_repair_reads_exactly_group_size_units(lrc_clusters):
    """Repairing one lost data unit touches exactly its group's other five
    data units and its local parity, never the k = 12 an RS repair
    reads, and launches decodes over a 6-unit read set."""
    port, _ref = lrc_clusters
    data = np.random.default_rng(11).integers(0, 256, 12 * 2 * CELL,
                                              dtype=np.uint8)
    (g,) = port.write(data, device="cpu")
    counts = _spy_reads(port.clients)
    rec = _port_reader(port, g).recover_cells([2])
    assert set(counts) == {g.pipeline.nodes[u] for u in (0, 1, 3, 4, 5, 12)}
    assert len(counts) == LRC.group_size
    cells = data.reshape(2, 12, CELL)
    assert np.array_equal(rec[:, 0], cells[:, 2])


def test_rebuild_matches_reference(lrc_clusters):
    """Unit 2's replica is rebuilt onto a spare by each coordinator from
    unit 2's local group; the rebuilt chunks and ChecksumData are equal
    between the two and to the lost ones, and the key reads back."""
    port, ref = lrc_clusters
    data = np.random.default_rng(5).integers(0, 256, 12 * 3 * CELL + 99,
                                             dtype=np.uint8)
    (g,), (jg,) = port.write(data, device="cpu"), ref.write(data)
    src = port.dns[int(g.pipeline.nodes[2][2:])]
    lost_chunks = [(i.to_json(), src.read_chunk(g.block_id, i).tobytes())
                   for i in src.get_block(g.block_id).chunks]
    rebuilt = []
    for c, grp, mod, kw in ((port, g, reconstruction, {"device": "cpu"}),
                            (ref, jg, j_reconstruction, {})):
        _lose(c, grp, [2])
        counts = _spy_reads(c.clients)
        cmd = mod.ReconstructionCommand(
            grp.container_id, c.opts,
            {u + 1: n for u, n in enumerate(grp.pipeline.nodes) if u != 2},
            {3: SPARES[0]})
        mod.ECReconstructionCoordinator(
            c.clients, bytes_per_checksum=1024, **kw).reconstruct_container_group(cmd)
        assert set(counts) == {grp.pipeline.nodes[u] for u in (0, 1, 3, 4, 5, 12)}
        spare = c.dns[int(SPARES[0][2:])]
        cont = spare.containers.get(grp.container_id)
        rebuilt.append((cont.replica_index, cont.state.value,
                        [(i.to_json(), spare.read_chunk(grp.block_id, i,
                                                        verify=True).tobytes())
                         for i in spare.get_block(grp.block_id).chunks]))
    assert rebuilt[0] == rebuilt[1]
    assert rebuilt[0][:2] == (3, ContainerState.CLOSED.value)
    assert rebuilt[0][2] == lost_chunks
    g.pipeline.nodes[2] = SPARES[0]
    assert np.array_equal(_port_reader(port, g).read_all(), data)


@pytest.mark.parametrize("service", ["1", "0"])
def test_short_group_repairs_locally_over_known_zero_units(lrc_clusters,
                                                           monkeypatch,
                                                           service):
    """A group of one cell and 1234 bytes: unit 0 is full, unit 1 holds
    1234 bytes and units 2-11 hold none (the writer makes no block for
    them). With unit 0 down, the reader repairs it locally from unit 1,
    the known-zero units 2-5 (asked of no datanode) and the local parity:
    one decode over a 6-unit read set, reading only the datanodes of units
    1 and 12. The coordinator rebuilds unit 0 the same way. The reference
    reader counts units 2-11 unreachable and cannot read the group."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", service)
    port, ref = lrc_clusters
    data = np.random.default_rng(3).integers(0, 256, CELL + 1234, dtype=np.uint8)
    (g,), (jg,) = port.write(data, device="cpu"), ref.write(data)
    _lose(ref, jg, [0])
    with pytest.raises(j_ec_reader.InsufficientLocationsError):
        j_ec_reader.ECBlockGroupReader(jg, ref.opts, ref.clients,
                                       bytes_per_checksum=1024).read_all()
    src = port.dns[int(g.pipeline.nodes[0][2:])]
    (info,) = src.get_block(g.block_id).chunks
    lost_chunk = src.read_chunk(g.block_id, info)
    _lose(port, g, [0])
    reader = _port_reader(port, g)
    assert lrc_math.plan_valid(LRC, [0], reader.available_units()) == \
        ([1, 2, 3, 4, 5, 12], "local")
    counts = _spy_reads(port.clients)
    assert np.array_equal(reader.read_all(), data)
    assert reader.dispatches == 1
    assert set(counts) == {g.pipeline.nodes[u] for u in (1, 12)}
    cmd = reconstruction.ReconstructionCommand(
        g.container_id, LRC,
        {u + 1: n for u, n in enumerate(g.pipeline.nodes) if u != 0},
        {1: SPARES[0]})
    reconstruction.ECReconstructionCoordinator(
        port.clients, bytes_per_checksum=1024,
        device="cpu").reconstruct_container_group(cmd)
    spare = port.dns[int(SPARES[0][2:])]
    (rinfo,) = spare.get_block(g.block_id).chunks
    got = spare.read_chunk(g.block_id, rinfo, verify=True)
    assert np.array_equal(got, lost_chunk)
    assert rinfo.checksum.checksums == \
        Checksum(ChecksumType.CRC32C, 1024).compute(got).checksums
