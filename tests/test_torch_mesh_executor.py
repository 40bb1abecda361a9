"""The port's persistent mesh executor against `ozone_tpu`'s, on the CPU.

Every test of tests/test_mesh_executor.py but `test_host_twin_on_cpu`
(the port has no host twin yet): `pad_batch` edges, plan caches keyed on
the mesh and the erasure pattern, encode and decode through the
executor, unknown keys, warm programs, cross-operation coalescing,
depth-N in-flight buffering, staging reuse, wide submissions, program
errors, `MeshPipeline`, close, and the codec service's spill of a whole
lane at watermark 4 (off by default). The port runs on a mesh of eight
CPU slots, the reference on its eight virtual CPU devices; the same
submissions go to both, and the port's `dispatches`,
`coalesced_operations`, `multi_op_dispatches` and `max_inflight` must
equal the reference's.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from ozone_tpu.codec import create_encoder as j_create_encoder
from ozone_tpu.codec import service as j_service
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.codec.fused import FusedSpec as JSpec
from ozone_tpu.parallel import mesh_executor as j_mex
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch.codec import service as codec_service
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import FusedSpec
from ozone_tpu_torch.parallel import mesh_executor, sharded
from ozone_tpu_torch.parallel.mesh_executor import MeshExecutor, _MeshProgram
from ozone_tpu_torch.parallel.sharded import (
    _sharded_fused_encoder_cached,
    make_mesh,
    pad_batch,
)
from ozone_tpu_torch.utils.checksum import ChecksumType

OPTS = CoderOptions(6, 3, "rs", cell_size=1024)
SPEC = FusedSpec(OPTS, ChecksumType.CRC32C, bytes_per_checksum=256)
J_OPTS = JOptions(6, 3, "rs", cell_size=1024)
J_SPEC = JSpec(J_OPTS, JChecksumType.CRC32C, bytes_per_checksum=256)
COUNTS = ("dispatches", "coalesced_operations", "multi_op_dispatches")


def cpu_mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def executor():
    ex = MeshExecutor(mesh=cpu_mesh(), depth=2)
    yield ex
    ex.close()


@pytest.fixture
def both():
    """(port executor, reference executor), depth 2 on eight slots each."""
    assert jax.device_count() == 8, "conftest must provide 8 CPU devices"
    ex, jex = MeshExecutor(mesh=cpu_mesh(), depth=2), j_mex.MeshExecutor(depth=2)
    yield ex, jex
    ex.close()
    jex.close()


def _deltas(metrics, before: dict) -> dict:
    snap = metrics.snapshot()
    return {k: snap.get(k, 0) - before.get(k, 0) for k in COUNTS}


def _on_both(both, scenario):
    """Run scenario(executor, program class) on the port, then on the
    reference; returns each one's counter deltas and max in-flight."""
    out = []
    for ex, mod in zip(both, (mesh_executor, j_mex)):
        before = mod.METRICS.snapshot()
        scenario(ex, mod._MeshProgram)
        ex.quiesce()
        out.append((_deltas(mod.METRICS, before), ex._max_inflight))
    return out


def _identity_program(cls, delay_s: float = 0.0):
    """A synthetic lane program returning its batch, optionally slowly:
    deterministic dispatcher back-pressure for the scheduling tests."""
    def fn(batch):
        if delay_s:
            time.sleep(delay_s)
        return (np.array(batch, copy=True),)
    return cls(fn, (), True)


# ------------------------------------------------------- pad_batch edges
def test_pad_batch_zero_rows():
    batch = np.empty((0, 6, 1024), dtype=np.uint8)
    padded, orig = pad_batch(batch, 8)
    assert orig == 0
    assert padded.shape == (0, 6, 1024)


def test_pad_batch_already_aligned():
    batch = np.arange(8 * 6 * 4, dtype=np.uint8).reshape(8, 6, 4)
    padded, orig = pad_batch(batch, 8)
    assert orig == 8
    assert padded is batch  # an aligned input is not copied


def test_pad_batch_pads_with_zeros():
    batch = np.ones((5, 2, 4), dtype=np.uint8)
    padded, orig = pad_batch(batch, 4)
    assert orig == 5 and padded.shape[0] == 8
    assert np.array_equal(padded[:5], batch)
    assert not padded[5:].any()


# ------------------------------------------------- plan cache key edges
def test_sharded_encoder_cache_isolated_across_meshes():
    """The cache key includes the mesh: two meshes of different sizes
    never share an encoder, and the same mesh gets its own back."""
    mesh8, mesh4 = cpu_mesh(8), cpu_mesh(4)
    fn8 = _sharded_fused_encoder_cached(
        OPTS, SPEC.checksum, SPEC.bytes_per_checksum, mesh8, "dn")
    fn4 = _sharded_fused_encoder_cached(
        OPTS, SPEC.checksum, SPEC.bytes_per_checksum, mesh4, "dn")
    assert fn8 is not fn4
    again = _sharded_fused_encoder_cached(
        OPTS, SPEC.checksum, SPEC.bytes_per_checksum, mesh8, "dn")
    assert again is fn8


def test_decode_program_isolated_across_patterns(executor):
    k1 = codec_service.decode_key(SPEC, [0, 1, 2, 3, 4, 5], [6])
    k2 = codec_service.decode_key(SPEC, [1, 2, 3, 4, 5, 6], [0])
    assert executor.accepts(k1) and executor.accepts(k2)
    assert executor._programs[k1] is not executor._programs[k2]
    assert executor.accepts_cached(k1) is True
    assert executor.accepts_cached(("decode", "never-seen")) is None


# --------------------------------------------------------- correctness
def test_executor_encode_matches_reference(both):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (16, 6, 1024), dtype=np.uint8)
    outs = []

    def scenario(ex, _cls):
        spec = SPEC if isinstance(ex, MeshExecutor) else J_SPEC
        key = (codec_service if isinstance(ex, MeshExecutor) else j_service).encode_key(spec)
        outs.append(ex.submit(key, data, width=2).result(timeout=60))

    (port, port_max), (ref, ref_max) = _on_both(both, scenario)
    (parity, crcs), (jparity, jcrcs) = outs
    assert np.array_equal(parity, j_create_encoder(J_OPTS, "numpy").encode(data))
    assert np.array_equal(parity, np.asarray(jparity))
    assert crcs.dtype == np.uint32 and np.array_equal(crcs, np.asarray(jcrcs))
    assert port == ref and port["dispatches"] == 1
    assert port_max == ref_max


def test_executor_decode_matches_reference(both):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (8, 6, 1024), dtype=np.uint8)
    units = np.concatenate([data, j_create_encoder(J_OPTS, "numpy").encode(data)], axis=1)
    erased = [1, 7]
    valid = [i for i in range(9) if i not in erased][:6]
    outs = []

    def scenario(ex, _cls):
        port = isinstance(ex, MeshExecutor)
        key = (codec_service if port else j_service).decode_key(
            SPEC if port else J_SPEC, valid, erased)
        outs.append(ex.submit(key, units[:, valid], width=2).result(timeout=60))

    (port, _), (ref, _) = _on_both(both, scenario)
    (rec, crcs), (jrec, jcrcs) = outs
    assert np.array_equal(rec, units[:, erased])
    assert np.array_equal(rec, np.asarray(jrec)) and np.array_equal(crcs, np.asarray(jcrcs))
    assert port == ref


def test_executor_unknown_key_raises(executor):
    with pytest.raises(KeyError):
        executor.submit(codec_service.reencode_key(SPEC, 2),
                        np.zeros((1, 6, 1024), dtype=np.uint8), width=1)
    with pytest.raises(KeyError):
        executor.pipeline(codec_service.reencode_key(SPEC, 2), width=1)


def test_warm_programs_no_new_compiles(executor):
    """Steady-state rounds after the first dispatch build no new plan
    (the port's census of what a program builds: per-device matrices),
    erasure-pattern churn included: each pattern builds once."""
    rng = np.random.default_rng(2)
    enc_key = codec_service.encode_key(SPEC)
    data = rng.integers(0, 256, (8, 6, 1024), dtype=np.uint8)
    executor.submit(enc_key, data, width=1).result(timeout=120)
    assert not executor._programs[enc_key].host_twin
    dkeys = [codec_service.decode_key(SPEC, [0, 1, 2, 3, 4, 5], [e]) for e in (6, 7)]
    for key in dkeys:
        executor.submit(key, data, width=1).result(timeout=120)
    warm = executor.compile_counts()
    assert warm >= 1
    for _ in range(3):
        executor.submit(enc_key, data, width=1).result(timeout=120)
        for key in dkeys:
            executor.submit(key, data, width=1).result(timeout=120)
    assert executor.compile_counts() == warm, "steady-state dispatches built new plans"


def test_stats_keys_match_reference(both):
    ex, jex = both
    assert ex.accepts(codec_service.encode_key(SPEC))
    assert jex.accepts(j_service.encode_key(J_SPEC))
    stats, jstats = ex.stats(), jex.stats()
    assert set(jstats) <= set(stats), set(jstats) - set(stats)
    assert stats["programs"] == 1 and stats["programs_host_twin"] == 0
    assert stats["devices"] == jstats["devices"] == 8
    for key in ("mesh_depth", "spill_enabled", "spill_watermark", "enabled",
                "queue_depth", "lanes", "inflight"):
        assert stats[key] == jstats[key], key


# ------------------------------------------------ coalescing + depth-N
def test_cross_operation_coalescing_single_dispatch(both):
    """Submissions from concurrent operations sharing one lane coalesce
    into one multi-op dispatch while the dispatcher is busy."""
    got = []

    def scenario(ex, cls):
        key = ("encode", "synthetic-coalesce")
        ex._programs[key] = _identity_program(cls, delay_s=0.1)
        plug = ex.submit(key, np.zeros((8, 4), dtype=np.uint8), width=1)
        time.sleep(0.02)  # let the dispatcher pick it up
        subs = [ex.submit(key, np.full((2, 4), i, dtype=np.uint8), width=1)
                for i in range(4)]
        got.append([f.result(timeout=30)[0] for f in subs])
        plug.result(timeout=30)

    (port, _), (ref, _) = _on_both(both, scenario)
    for outs in got:
        for i, out in enumerate(outs):
            assert np.array_equal(out, np.full((2, 4), i, dtype=np.uint8))
    # 5 operations, 2 dispatches: the plug, then all 4 queued ops in one
    assert port == ref
    assert (port["dispatches"], port["multi_op_dispatches"]) == (2, 1)


def test_inflight_depth_reaches_window(both):
    """With a backlog of full batches the dispatcher keeps depth+1
    dispatches out before harvesting the oldest."""
    def scenario(ex, cls):
        key = ("encode", "synthetic-depth")
        ex._programs[key] = _identity_program(cls, delay_s=0.005)
        futs = [ex.submit(key, np.zeros((8, 4), dtype=np.uint8), width=1)
                for _ in range(8)]
        for f in futs:
            f.result(timeout=30)

    (port, port_max), (ref, ref_max) = _on_both(both, scenario)
    assert port == ref and port["dispatches"] == 8
    assert port_max == ref_max
    assert both[0].depth <= port_max <= both[0].depth + 1


def test_staging_buffers_reused(executor):
    key = ("encode", "synthetic-staging")
    executor._programs[key] = _identity_program(_MeshProgram)
    snap0 = mesh_executor.METRICS.snapshot()
    for i in range(6):
        out = executor.submit(
            key, np.full((3, 4), i, dtype=np.uint8), width=1
        ).result(timeout=30)
        assert np.array_equal(out[0], np.full((3, 4), i, dtype=np.uint8))
    snap1 = mesh_executor.METRICS.snapshot()
    reuses = snap1.get("staging_reuses", 0) - snap0.get("staging_reuses", 0)
    assert reuses >= 4, f"staging pool not recycling: {reuses} reuses"


def test_multi_dispatch_submission_reassembles(executor):
    key = ("encode", "synthetic-wide")
    executor._programs[key] = _identity_program(_MeshProgram)
    big = np.arange(20 * 4, dtype=np.uint8).reshape(20, 4)
    out = executor.submit(key, big, width=1).result(timeout=30)
    assert np.array_equal(out[0], big)


def test_program_error_fails_future(executor):
    key = ("encode", "synthetic-broken")

    def boom(batch):
        raise RuntimeError("kaboom")

    executor._programs[key] = _MeshProgram(boom)
    fut = executor.submit(key, np.zeros((2, 4), dtype=np.uint8), width=1)
    with pytest.raises(RuntimeError, match="kaboom"):
        fut.result(timeout=30)


def test_mesh_pipeline_contract(executor):
    """submit returns the previous submission's (ctx, outs); drain
    flushes the last."""
    pipe = executor.pipeline(codec_service.encode_key(SPEC), width=2)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (4, 6, 1024), dtype=np.uint8)
               for _ in range(3)]
    enc = j_create_encoder(J_OPTS, "numpy")
    got = []
    for i, b in enumerate(batches):
        out = pipe.submit(b, ctx=i)
        if out is not None:
            got.append(out)
    out = pipe.drain()
    if out is not None:
        got.append(out)
    assert [ctx for ctx, _ in got] == [0, 1, 2]
    for ctx, (parity, _crcs) in got:
        assert np.array_equal(parity, enc.encode(batches[ctx]))
    assert pipe.drain() is None


def test_close_fails_pending_and_rejects_submits():
    ex = MeshExecutor(mesh=cpu_mesh(), depth=1)
    key = ("encode", "synthetic-close")
    ex._programs[key] = _identity_program(_MeshProgram)
    ex.close()
    with pytest.raises(RuntimeError):
        ex.submit(key, np.zeros((1, 4), dtype=np.uint8), width=1)


def test_executor_needs_a_mesh_on_this_host():
    """No CUDA here: the default mesh is refused loudly, and the
    singleton policy answers None."""
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshExecutor()
    assert mesh_executor.maybe_executor() is None
    with pytest.raises(ValueError):
        sharded.make_mesh(0, devices=["cpu"])


# ----------------------------------------------------------- spill path
def _spill_run(svc_mod, mex_mod, ex, spec, monkeypatch):
    monkeypatch.setattr(mex_mod, "_executor", ex)
    enc_key = svc_mod.encode_key(spec)
    assert ex.accepts(enc_key)  # warm: the peek answers True
    rng = np.random.default_rng(4)
    datas = [rng.integers(0, 256, (1, 6, 1024), dtype=np.uint8) for _ in range(12)]
    release = threading.Event()

    def slow_fn(batch):
        release.wait(timeout=30)
        return (np.array(batch, copy=True),)

    svc = svc_mod.CodecService()
    snap0, msnap0 = svc_mod.METRICS.snapshot(), mex_mod.METRICS.snapshot()
    try:
        # pin the dispatcher: a full width-1 lane dispatches at once and
        # blocks inside slow_fn until released
        plug = svc.submit(("encode", "slow-plug"), slow_fn,
                          np.zeros((1, 4), dtype=np.uint8), width=1)
        time.sleep(0.05)
        futs = [svc.submit(enc_key, None, d, width=1) for d in datas]
        release.set()
        plug.result(timeout=30)
        results = [f.result(timeout=60) for f in futs]
    finally:
        release.set()
        svc.close()
    enc = j_create_encoder(J_OPTS, "numpy")
    for d, (parity, _crcs) in zip(datas, results):
        assert np.array_equal(np.asarray(parity), enc.encode(d))
    snap1, msnap1 = svc_mod.METRICS.snapshot(), mex_mod.METRICS.snapshot()
    return {k: snap1.get(k, 0) - snap0.get(k, 0)
            for k in ("mesh_spill_lanes", "mesh_spill_stripes")} | {
        k: msnap1.get(k, 0) - msnap0.get(k, 0) for k in ("spilled_lanes", "spilled_stripes")}


def test_service_spill_redirects_whole_lane(both, monkeypatch):
    """Past watermark 4, with the service's dispatcher pinned on a slow
    lane, the untouched encode lane moves wholesale to the executor and
    its futures still resolve bit-exactly, as in the reference."""
    monkeypatch.setenv("OZONE_TPU_MESH_SPILL", "1")
    monkeypatch.setenv("OZONE_TPU_MESH_SPILL_WATERMARK", "4")
    port = _spill_run(codec_service, mesh_executor, both[0], SPEC, monkeypatch)
    ref = _spill_run(j_service, j_mex, both[1], J_SPEC, monkeypatch)
    assert port == ref
    assert port["mesh_spill_lanes"] >= 1 and port["mesh_spill_stripes"] >= 8
    assert port["spilled_lanes"] >= 1


def test_spill_off_by_default(executor, monkeypatch):
    monkeypatch.delenv("OZONE_TPU_MESH_SPILL", raising=False)
    monkeypatch.setattr(mesh_executor, "_executor", executor)
    svc = codec_service.CodecService()
    try:
        with svc._lock:
            assert svc._collect_spill_locked() == []
    finally:
        svc.close()
