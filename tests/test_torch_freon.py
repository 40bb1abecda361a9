"""The port's freon generators against `ozone_tpu`'s, on the CPU.

ockg, ockv, ockr, ockrr and ecrd run on a port and a JAX
`MiniOzoneCluster` (12 datanodes on 3 racks, rs-6-3 with 64 KiB cells,
placement_seed=42, one thread so both allocate in one order): the key
rows (less object ids, times and pipeline ids), the stored chunks and
their CRCs, and every generator's counts must be equal. Then
`FreonReport.summary()` and `Histogram.percentiles()` for the same
observations, and the shape of `rawcoder_bench`'s rows.
"""

import numpy as np
import pytest
import torch

from ozone_tpu.codec import numpy_coder as j_np
from ozone_tpu.codec import registry as j_registry
from ozone_tpu.storage import ids as j_ids
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu.tools import freon as j_freon
from ozone_tpu.utils import metrics as j_metrics
from ozone_tpu_torch.storage import ids as port_ids
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
from ozone_tpu_torch.tools import freon
from ozone_tpu_torch.utils import metrics

CELL = 64 * 1024
EC = "rs-6-3-64k"
BLOCK = 16 * CELL
KEY = 2 * 6 * CELL + 777  # two full stripes and a partial cell
N_KEYS = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain PyTorch versions run at test sizes on one thread: the
    suite runs in several worker processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clusters(tmp_path, monkeypatch):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    kw = dict(num_datanodes=12, racks=3, block_size=BLOCK,
              container_size=16 * BLOCK, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    port = MiniOzoneCluster(tmp_path / "port", device="cpu", **kw)
    ref = JCluster(tmp_path / "ref", **kw)
    yield port, ref
    port.close()
    ref.close()


def key_row(info: dict) -> dict:
    """A key row without what differs between runs by design: the object
    id, timestamps and pipeline ids (process-wide counters)."""
    row = {k: v for k, v in info.items()
           if k not in ("object_id", "created", "modified", "block_groups")}
    row["block_groups"] = [{k: v for k, v in g.items() if k != "pipeline_id"}
                           for g in info["block_groups"]]
    return row


def stored_chunks(cluster, info: dict) -> list:
    """[(block, unit, chunk json, bytes)] of a key as its datanodes hold it."""
    ids = j_ids if isinstance(cluster, JCluster) else port_ids
    out = []
    for g in info["block_groups"]:
        bid = ids.BlockID(int(g["container_id"]), int(g["local_id"]))
        for u, dn_id in enumerate(g["nodes"]):
            dn = cluster.datanode(dn_id)
            try:
                block = dn.get_block(bid)
            except (StorageError, JStorageError):
                continue
            for c in block.chunks:
                out.append(((bid.container_id, bid.local_id), u, c.to_json(),
                            dn.read_chunk(bid, c, verify=True).tobytes()))
    return out


def every_chunk(cluster) -> list:
    """[(datanode, container, state, replica index, block, chunk json,
    bytes)] of every chunk every datanode holds."""
    out = []
    for dn in cluster.datanodes:
        for c in sorted(dn.list_containers(), key=lambda c: c.id):
            for bd in dn.list_blocks(c.id):
                for info in bd.chunks:
                    out.append((dn.id, c.id, c.state.value, c.replica_index,
                                bd.block_id.local_id, info.to_json(),
                                dn.read_chunk(bd.block_id, info,
                                              verify=True).tobytes()))
    return out


def counts(rep) -> tuple:
    s = rep.summary()
    return s["generator"], s["ops"], s["failures"]


def test_key_generators_match_reference(clusters):
    results = []
    for c, mod in zip(clusters, (freon, j_freon)):
        oz = c.client()
        reps = [mod.ockg(oz, n_keys=N_KEYS, size=KEY, threads=1,
                         replication=EC, warmup=1),
                mod.ockv(oz, n_keys=N_KEYS, size=KEY, threads=2),
                mod.ockr(oz, N_KEYS, threads=2),
                mod.ockrr(oz, 12, threads=2, size=CELL + 5, n_keys=N_KEYS)]
        keys = oz.om.list_keys("freon-vol", "freon-bucket", "")
        gen = [counts(r) for r in reps]
        read_bytes = [r.bytes_processed for r in reps]
        # the hist_* extras read process-wide histograms, which other
        # tests in the same worker process may have filled before
        hist_keys = sorted(k for k in reps[0].summary() if not k.startswith("hist_"))
        assert "hist_put_ms" in reps[0].summary()
        results.append((gen, read_bytes, hist_keys, [key_row(k) for k in keys],
                        [stored_chunks(c, k) for k in keys]))
    got, want = results
    assert got[0] == want[0] == [("ockg", N_KEYS, 0), ("ockv", N_KEYS, 0),
                                 ("ockr", N_KEYS, 0), ("ockrr", 12, 0)]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert len(got[3]) == N_KEYS + 1  # the warm-up key too
    assert got[4] == want[4]
    assert all(len(chunks) > 0 for chunks in got[4])


def test_ockv_counts_a_corrupt_key_as_a_failure(clusters):
    port, _ = clusters
    oz = port.client()
    freon.ockg(oz, n_keys=2, size=KEY, threads=1, replication=EC)
    b = oz.get_volume("freon-vol").get_bucket("freon-bucket")
    b.write_key("key-1", np.zeros(KEY, dtype=np.uint8))
    rep = freon.ockv(oz, n_keys=2, size=KEY)
    assert (rep.ops, rep.failures) == (1, 1)


def ref_status(scm) -> dict:
    """The reference SCM service's Status answer for an in-process SCM."""
    from types import SimpleNamespace

    from ozone_tpu.net import wire
    from ozone_tpu.net.scm_service import ScmGrpcService

    return wire.unpack(ScmGrpcService._status(SimpleNamespace(scm=scm), b""))[0]


def test_ecrd_matches_reference(clusters):
    """The reference's ecrd reads status() from an SCM client; its
    in-process SCM gets the Status handler's answer. The port's SCM
    answers status() itself."""
    from types import SimpleNamespace

    results = []
    for c, mod in zip(clusters, (freon, j_freon)):
        oz = c.client()
        scm = c.scm if mod is freon else SimpleNamespace(
            status=lambda c=c: ref_status(c.scm))
        out = mod.ecrd(oz, scm, size=3 * 6 * CELL + 100, rounds=2,
                       replication=EC)
        keys = oz.om.list_keys("freon-vol", "freon-ecrd", "")
        results.append((sorted(out), out["rounds"], out["unit_mib"],
                        len(out["times_s"]), keys, every_chunk(c)))
        assert out["reconstruct_mib_s_per_datanode"] > 0
    got, want = results
    assert got[:5] == want[:5]
    assert got[4] == []  # each drill key is deleted after its round
    # the chunks stay until the key-deleting service runs: the rebuilt
    # replicas on the spares are byte-exact with the reference's
    assert got[5] == want[5]
    assert any(state == "CLOSED" for _, _, state, *_ in got[5])


def test_scm_status_matches_reference(clusters):
    """The port's SCM status() against the body of the reference SCM
    service's Status handler, less the block-token and layout-version
    fields and the pipeline rules of safemode the port does not have."""
    port, ref = clusters
    want = ref_status(ref.scm)
    want.pop("block_tokens")
    for n in want["nodes"]:
        n.pop("layout_version")
    for k in ("pipelines_total", "pipelines_healthy", "pipelines_with_member"):
        want["safemode_status"].pop(k)
    assert port.scm.status() == want
    assert len(want["nodes"]) == 12


# ------------------------------------------------------------------ reports
LATENCIES = [0.0004, 0.0021, 0.0021, 0.013, 0.05, 0.2, 0.00001, 1.7, 0.9, 0.031]


def test_freon_report_summary_matches_reference():
    got = freon.FreonReport("ockg", 9, 1, 2.5, list(LATENCIES), 12345678,
                            {"x": 1}).summary()
    want = j_freon.FreonReport("ockg", 9, 1, 2.5, list(LATENCIES), 12345678,
                               {"x": 1}).summary()
    assert got == want
    assert freon.FreonReport("e", 0, 0, 0.0).summary() == \
        j_freon.FreonReport("e", 0, 0, 0.0).summary()


@pytest.mark.parametrize("n", [0, 1, 10, 1000])
def test_histogram_percentiles_match_reference(n):
    rng = np.random.default_rng(n)
    values = (10 ** rng.uniform(-5, 2.5, n)).tolist()
    h, jh = metrics.Histogram(), j_metrics.Histogram()
    for v in values:
        h.observe(v)
        jh.observe(v)
    assert h.bounds == jh.bounds
    assert h.percentiles() == jh.percentiles()
    for q in (0.0, 0.25, 0.5, 0.999, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert (h.count, h.max) == (jh.count, jh.max)


def test_base_generator_counts_failures_and_bytes():
    got = freon.BaseFreonGenerator("t", 7, threads=3).run(
        lambda i: 1 / (i % 3) and 10)
    want = j_freon.BaseFreonGenerator("t", 7, threads=3).run(
        lambda i: 1 / (i % 3) and 10)
    assert (got.ops, got.failures, got.bytes_processed) == \
        (want.ops, want.failures, want.bytes_processed) == (4, 3, 40)
    assert np.array_equal(freon._det_payload(1000, 3), j_freon._det_payload(1000, 3))


# ------------------------------------------------------------ rawcoder bench
def test_rawcoder_bench_rows_have_the_reference_keys(monkeypatch):
    # the reference's bench on a registry of its numpy coder alone: its
    # default registry would build the reference's native library in place
    reg = j_registry.CodecRegistry()
    reg.register("rs", "numpy", 10, j_np.NumpyRSEncoder, j_np.NumpyRSDecoder)
    monkeypatch.setattr(j_registry.CodecRegistry, "_instance", reg)
    want = j_freon.rawcoder_bench(["numpy", "nope"], "rs-3-2", 4096, 2, 1)
    got = freon.rawcoder_bench(None, "rs-3-2", 4096, 2, 1, device="cpu")
    assert [r["backend"] for r in got] == ["torch", "cpp", "numpy"]
    assert all(sorted(r) == sorted(want[0]) for r in got), got
    assert all(r["encode_gib_s"] > 0 and r["decode_gib_s"] > 0 for r in got)
    bad = freon.rawcoder_bench(["nope"], "rs-3-2", 4096, 2, 1)
    assert sorted(bad[0]) == sorted(want[1]) == ["backend", "error", "schema"]
    assert bad[0]["error"] == want[1]["error"]
    xor = freon.rawcoder_bench(None, "xor-6-1", 4096, 2, 1, device="cpu")
    assert [r["backend"] for r in xor] == ["torch", "numpy"]
    assert all("error" not in r for r in xor)
