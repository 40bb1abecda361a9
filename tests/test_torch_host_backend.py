"""The port's host coding backend against `ozone_tpu`'s, on the CPU.

The link probe and backend policy (`codec/fused.py`: `_measure_link`
through `_prefer_host_coder`) give the reference's verdicts on the
reference's patched samples (tests/test_codec.py
`test_adaptive_backend_probe`), case by case. The host twin
(`_native_fused_encoder`, `_native_fused_decoder`) is bit-exact against
the reference's twin and the port's plain version for RS, XOR and LRC.
``OZONE_TPU_FUSED_BACKEND=native`` with no host library raises. A twin
writer and a plain writer of one spec never share a codec-service lane.
The mesh executor's host twin (tests/test_mesh_executor.py
`test_host_twin_on_cpu`) and `EventQueue(async_dispatch=True)` behave as
the reference's. Both packages read the same environment variables here,
so every test sets the knob it needs.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from ozone_tpu.client import dn_client as j_dn_client
from ozone_tpu.client import ec_writer as j_ec_writer
from ozone_tpu.codec import fused as j_fused
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.parallel import mesh_executor as j_mex
from ozone_tpu.scm import pipeline as j_pipeline
from ozone_tpu.storage import datanode as j_datanode
from ozone_tpu.utils import events as j_events
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch.client import dn_client, ec_writer
from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
from ozone_tpu_torch.codec import cpp_coder, fused, fused_kernel, lrc_math
from ozone_tpu_torch.codec import service as cs
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import (
    FusedSpec,
    make_fused_decoder,
    make_fused_encoder,
)
from ozone_tpu_torch.parallel import mesh_executor
from ozone_tpu_torch.parallel.mesh_executor import MeshExecutor
from ozone_tpu_torch.parallel.sharded import make_mesh
from ozone_tpu_torch.scm import pipeline
from ozone_tpu_torch.storage import datanode
from ozone_tpu_torch.utils import events
from ozone_tpu_torch.utils.checksum import ChecksumType
from tests.test_torch_ec_write import MiniEC

CELL = 4096
BPC = 1024
PROBE_OPTS = CoderOptions(6, 3, "rs", cell_size=4096)
J_PROBE_OPTS = JOptions(6, 3, "rs", cell_size=4096)


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _spec(scheme, checksum="CRC32C"):
    return (FusedSpec(CoderOptions.parse(f"{scheme}-{CELL}"),
                      ChecksumType[checksum], BPC),
            j_fused.FusedSpec(JOptions.parse(f"{scheme}-{CELL}"),
                              JChecksumType[checksum], BPC))


@pytest.fixture
def knob(monkeypatch):
    """Set OZONE_TPU_FUSED_BACKEND (None: unset) for the test."""
    def set_(value):
        if value is None:
            monkeypatch.delenv("OZONE_TPU_FUSED_BACKEND", raising=False)
        else:
            monkeypatch.setenv("OZONE_TPU_FUSED_BACKEND", value)
    return set_


# ------------------------------------------------------------- the policy
def _err():
    raise RuntimeError("no device")


#: (case, {name: patched attribute of both fused modules}, call kwargs,
#: the verdict both must give)
PROBE_CASES = [
    # a tunnel-degraded link: the host twin wins
    ("degraded_link", {"_measure_link": lambda: (12.0, 10.0)}, {}, True),
    # a healthy PCIe-class link: the device path wins
    ("healthy_link", {"_measure_link": lambda: (8000.0, 8000.0)}, {}, False),
    # the decode transfer shape gets its own verdict (e/v, not p/k)
    ("decode_ratio", {"_measure_link": lambda: (8000.0, 8000.0)},
     {"out_ratio": 1 / 6}, False),
    # a probe error keeps the device path
    ("probe_error", {"_measure_link": _err}, {}, False),
    # a non-CRC32C spec has no twin: the device path, no probe
    ("non_crc32c", {"_measure_link": lambda: (1.0, 1.0)},
     {"checksum": "CRC32"}, False),
    # a wedged probe times out into the host twin
    ("wedged", {"_measure_link": lambda: time.sleep(1.0),
                "_PROBE_WALL_S": 0.2}, {}, True),
    # no twin to fall back to: the device path without a probe
    ("no_library", {"_measure_link": lambda: (1.0, 1.0),
                    "_native_lib_available": lambda: False}, {}, False),
]


def _prefer(mod, kwargs):
    kw = dict(kwargs)
    if "checksum" in kw:
        kw["checksum"] = (JChecksumType if mod is j_fused
                          else ChecksumType)[kw["checksum"]]
    return mod._prefer_host_coder(J_PROBE_OPTS if mod is j_fused else PROBE_OPTS,
                                  **kw)


@pytest.fixture
def probe_env(monkeypatch, knob):
    """Both packages with an accelerator present (the reference's default
    backend patched to "tpu", the port asked for "cuda"), the policy on
    (``auto``, which the reference reads as its default), the twin
    available at 1400 MiB/s, and empty verdict caches."""
    knob("auto")
    monkeypatch.setenv("OZONE_TPU_LINK_PROBE", "1")
    monkeypatch.setattr(j_fused.jax, "default_backend", lambda: "tpu")
    for mod in (fused, j_fused):
        monkeypatch.setattr(mod, "_native_lib_available", lambda: True)
        monkeypatch.setattr(mod, "_native_rate_sample", lambda o: 1400.0)
        mod._PROBE_CACHE.clear()
    yield monkeypatch
    for mod in (fused, j_fused):
        mod._PROBE_CACHE.clear()


@pytest.mark.parametrize("case,patches,kwargs,host",
                         PROBE_CASES, ids=[c[0] for c in PROBE_CASES])
def test_probe_verdicts_match_reference(probe_env, case, patches, kwargs, host):
    """Each case of the reference's probe test: the port's verdict equals
    the reference's and the expected one; a verdict for the host is
    counted (and a device one too)."""
    called = []
    for mod in (fused, j_fused):
        for name, value in patches.items():
            if name == "_measure_link":
                def value(inner=value, mod=mod):  # noqa: E306
                    called.append(mod.__name__)
                    return inner()
            probe_env.setattr(mod, name, value)
    counter = "verdicts_host" if host else "verdicts_device"
    c0 = fused.METRICS.counter(counter).value
    got = [_prefer(mod, kwargs) for mod in (fused, j_fused)]
    assert got == [host, host], f"{case}: port {got[0]}, reference {got[1]}"
    if case in ("non_crc32c", "no_library"):
        assert not called, f"{case} probed the link"
    else:
        assert fused.METRICS.counter(counter).value == c0 + 1
        assert sorted(called) == ["ozone_tpu.codec.fused",
                                  "ozone_tpu_torch.codec.fused"]


def test_cached_verdict_is_lock_free(probe_env):
    """Once a verdict is cached neither the library check nor the probe
    runs again, in either package."""
    for mod in (fused, j_fused):
        probe_env.setattr(mod, "_measure_link", lambda: (8000.0, 8000.0))
    assert [_prefer(mod, {}) for mod in (fused, j_fused)] == [False, False]
    called = []
    for mod in (fused, j_fused):
        probe_env.setattr(mod, "_native_lib_available",
                          lambda: called.append("lib") or True)
        probe_env.setattr(mod, "_measure_link",
                          lambda: called.append("probe") or (1.0, 1.0))
    assert [_prefer(mod, {}) for mod in (fused, j_fused)] == [False, False]
    assert not called


def test_host_verdict_is_logged_with_its_numbers(probe_env, caplog):
    probe_env.setattr(fused, "_measure_link", lambda: (12.0, 10.0))
    with caplog.at_level("WARNING", logger="ozone_tpu_torch.codec.fused"):
        assert _prefer(fused, {}) is True
        assert _prefer(fused, {}) is True  # cached: logged once
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1
    assert "h2d 12.0 MiB/s" in lines[0] and "host twin 1400.0 MiB/s" in lines[0]


@pytest.mark.parametrize("value,host", [("native", True), ("jax", False),
                                        ("cuda", False), (None, False)])
def test_knob_forces_the_backend(probe_env, knob, value, host):
    """``native`` and ``jax`` force both packages alike; ``cuda`` and an
    unset knob are the port's default, the kernel, with no probe."""
    called = []
    for mod in (fused, j_fused):
        probe_env.setattr(mod, "_measure_link",
                          lambda: called.append("probe") or (12.0, 10.0))
    knob(value)
    assert _prefer(fused, {}) is host
    if value in ("native", "jax"):
        assert _prefer(j_fused, {}) is host
    assert not called


def test_unknown_knob_value_raises(knob):
    knob("tpu")
    with pytest.raises(ValueError):
        fused.fused_backend()


def test_auto_takes_the_twin_on_cpu_and_link_probe_off_keeps_the_kernel(
        knob, monkeypatch):
    spec, _ = _spec("rs-6-3")
    knob("auto")
    assert isinstance(make_fused_encoder(spec, device="cpu"), fused._HostTwin)
    monkeypatch.setenv("OZONE_TPU_LINK_PROBE", "0")
    assert fused._prefer_host_coder(spec.options, device="cuda") is False


# -------------------------------------------------------------- the twin
ENCODE_SCHEMES = ["rs-6-3", "rs-10-4", "lrc-12-2-2", "xor-6-1"]


@pytest.mark.parametrize("scheme", ENCODE_SCHEMES)
def test_twin_encoder_bit_exact(knob, scheme):
    """The port's twin equals the reference's twin and the port's plain
    version, word for word, and returns the device path's tensors."""
    spec, jspec = _spec(scheme)
    k = spec.options.data_units
    data = _rand((3, k, CELL), hash(scheme) % 1000)
    knob(None)
    plain = make_fused_encoder(spec, device="cpu")(data)
    knob("native")
    twin = make_fused_encoder(spec, device="cpu")
    assert isinstance(twin, fused._HostTwin)
    n0 = fused.host_twin_calls.count
    strided = torch.from_numpy(np.concatenate([data, data], axis=1))[:, ::2]
    strided.copy_(torch.from_numpy(data))  # a non-contiguous view of data
    outs = [twin(data), twin(torch.from_numpy(data)), twin(strided)]
    assert fused.host_twin_calls.count == n0 + 3
    ref = j_fused._native_fused_encoder(jspec.options, jspec.checksum, BPC)(data)
    for parity, crcs in outs:
        assert parity.dtype == torch.uint8 and crcs.dtype == torch.int32
        assert parity.device.type == crcs.device.type == "cpu"
        assert torch.equal(parity, plain[0]) and torch.equal(crcs, plain[1])
        assert np.array_equal(parity.numpy(), ref[0])
        assert np.array_equal(crcs.numpy().view(np.uint32), ref[1])
        assert crcs.shape == (3, k + spec.options.parity_units, CELL // BPC)


def _lrc_valid(erased):
    opts = CoderOptions.parse("lrc-12-2-2")
    return lrc_math.plan_valid(opts, erased,
                               [u for u in range(16) if u not in erased])[0]


DECODE_CASES = [
    ("rs-6-3", [0, 1, 3, 4, 5, 6], [2, 7]),
    ("rs-10-4", list(range(2, 12)), [0, 1]),
    ("lrc-12-2-2", _lrc_valid([2]), [2]),  # local: the group only
    ("lrc-12-2-2", _lrc_valid([0, 1, 12]), [0, 1, 12]),  # global
    ("xor-6-1", [0, 1, 2, 4, 5, 6], [3]),
]


@pytest.mark.parametrize("scheme,valid,erased", DECODE_CASES,
                         ids=[f"{c[0]}-{'-'.join(map(str, c[2]))}"
                              for c in DECODE_CASES])
def test_twin_decoder_bit_exact(knob, scheme, valid, erased):
    spec, jspec = _spec(scheme)
    opts = spec.options
    data = _rand((2, opts.data_units, CELL), 7 + len(valid))
    knob(None)
    parity, _ = make_fused_encoder(spec, device="cpu")(data)
    units = np.concatenate([data, parity.numpy()], axis=1)
    inputs = np.ascontiguousarray(units[:, valid])
    plain = make_fused_decoder(spec, valid, erased, device="cpu")(inputs)
    knob("native")
    twin = make_fused_decoder(spec, valid, erased, device="cpu")
    assert isinstance(twin, fused._HostTwin)
    rec, crcs = twin(inputs)
    jrec, jcrcs = j_fused._native_fused_decoder(
        jspec.options, jspec.checksum, BPC, tuple(valid), tuple(erased))(inputs)
    assert np.array_equal(rec.numpy(), units[:, erased])
    assert torch.equal(rec, plain[0]) and torch.equal(crcs, plain[1])
    assert np.array_equal(rec.numpy(), jrec)
    assert np.array_equal(crcs.numpy().view(np.uint32), jcrcs)


def test_non_crc32c_stays_on_the_device_path(knob):
    """No twin serves CRC32 or no checksum, as in the reference: under
    ``native`` those specs keep the plain version here."""
    knob("native")
    for checksum in ("CRC32", "NONE"):
        spec, jspec = _spec("rs-6-3", checksum)
        assert fused._native_fused_encoder(spec.options, spec.checksum, BPC) is None
        assert j_fused._native_fused_encoder(jspec.options, jspec.checksum,
                                             BPC) is None
        assert not isinstance(make_fused_encoder(spec, device="cpu"),
                              fused._HostTwin)
        assert not isinstance(make_fused_decoder(spec, [0, 1, 2, 3, 4, 5], [6],
                                                 device="cpu"), fused._HostTwin)


@pytest.fixture
def no_gf_library(monkeypatch):
    """The host GF coder cannot be built (no compiler)."""
    def fail():
        raise RuntimeError("g++ not found: a C++ compiler is required")

    fused._native_fused_encoder.cache_clear()
    fused._native_fused_decoder.cache_clear()
    monkeypatch.setattr(cpp_coder, "load", fail)
    fused._PROBE_CACHE.clear()
    yield
    fused._native_fused_encoder.cache_clear()
    fused._native_fused_decoder.cache_clear()
    fused._PROBE_CACHE.clear()


def test_native_without_the_library_raises(knob, no_gf_library):
    """A departure from the reference, which quietly takes the device
    path: ``native`` raises, on the CPU and on CUDA alike."""
    spec, _ = _spec("rs-6-3")
    knob("native")
    for device in ("cpu", "cuda"):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            make_fused_encoder(spec, device=device)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            make_fused_decoder(spec, [0, 1, 2, 3, 4, 5], [6], device=device)


def test_auto_without_the_library_keeps_the_plain_version(knob, no_gf_library):
    spec, _ = _spec("rs-6-3")
    knob("auto")
    fn = make_fused_encoder(spec, device="cpu")
    assert not isinstance(fn, fused._HostTwin)
    data = _rand((1, 6, CELL), 3)
    assert fn(data)[0].shape == (1, 3, CELL)


# --------------------------------------------------- the service's lanes
def test_twin_and_plain_writers_never_share_a_lane(knob, monkeypatch):
    """A plain writer's and a twin writer's stripes of one spec,
    interleaved into one service with a long linger: two lanes, one
    dispatch each, every stripe on its own backend's function (counted
    by the twin's counter and a spy on the plain one), outputs exact."""
    spec, _ = _spec("rs-6-3")
    knob(None)
    plain = make_fused_encoder(spec, device="cpu")
    plain_rows = []

    def plain_spy(batch):
        plain_rows.append(np.array(batch, copy=True))
        return plain(batch)

    knob("native")
    twin = make_fused_encoder(spec, device="cpu")
    monkeypatch.setenv("OZONE_TPU_CODEC_LINGER_MS", "300")
    cs.reset_for_tests()
    try:
        svc = cs.get_service()
        key = cs.encode_key(spec)
        subs = [(_rand((1, 6, CELL), 40 + i), twin if i % 2 else plain_spy)
                for i in range(6)]
        d0 = cs.METRICS.counter("dispatches").value
        n0 = fused.host_twin_calls.count
        futs = [svc.submit(key, fn, data, width=8) for data, fn in subs]
        outs = [cs.wait_result(f) for f in futs]
        dispatches = cs.METRICS.counter("dispatches").value - d0
        twin_calls = fused.host_twin_calls.count - n0
    finally:
        cs.reset_for_tests()
    assert (dispatches, twin_calls, len(plain_rows)) == (2, 1, 1)
    seen = plain_rows[0]
    for (data, fn), (parity, crcs) in zip(subs, outs):
        on_plain = any(np.array_equal(row, data[0]) for row in seen)
        assert on_plain == (fn is plain_spy)
        want = plain(data)
        assert np.array_equal(parity, want[0].numpy())
        assert np.array_equal(crcs, want[1].numpy().view(np.uint32))
    assert cs.backend_key(key, twin) == key + (fused.HOST_TWIN,)
    assert cs.backend_key(key, plain) == key


def test_native_write_and_degraded_read_match_reference(tmp_path, knob,
                                                        monkeypatch):
    """The slice end to end under ``native``: port writers on the service
    store the chunks the reference's writers store (the reference takes
    its twin on the CPU too), a degraded read decodes on the twin, and
    every dispatch is one twin call with no kernel launch."""
    knob("native")
    monkeypatch.setenv("OZONE_TPU_CODEC_LINGER_MS", "2")
    cs.reset_for_tests()
    opts, jopts = CoderOptions(3, 2, "rs", cell_size=CELL), \
        JOptions(3, 2, "rs", cell_size=CELL)
    data = _rand(7 * 3 * CELL + 123, 77)
    port = MiniEC(tmp_path / "port", (datanode, dn_client, pipeline, ec_writer), opts)
    ref = MiniEC(tmp_path / "ref", (j_datanode, j_dn_client, j_pipeline,
                                    j_ec_writer), jopts)
    try:
        d0 = cs.METRICS.counter("dispatches").value
        dd0 = cs.METRICS.counter("dispatches_decode").value
        n0, l0 = fused.host_twin_calls.count, fused_kernel.launches.total
        groups = port.write(data, device="cpu")
        stored = port.stored(groups)
        assert stored == ref.stored(ref.write(data))
        for g in groups:
            port.dns[int(g.pipeline.nodes[0][2:])].delete_container(
                g.container_id, force=True)
        got = np.concatenate([ECBlockGroupReader(
            g, opts, port.clients, bytes_per_checksum=BPC,
            device="cpu").read_all() for g in groups])
        assert np.array_equal(got, data)
        dispatches = cs.METRICS.counter("dispatches").value - d0
        assert cs.METRICS.counter("dispatches_decode").value > dd0
        assert dispatches > len(groups)
        assert fused.host_twin_calls.count - n0 == dispatches
        assert fused_kernel.launches.total == l0
    finally:
        port.close()
        ref.close()
        cs.reset_for_tests()


# ------------------------------------------------ the mesh executor's twin
MESH_SPEC = FusedSpec(CoderOptions(6, 3, "rs", cell_size=1024),
                      ChecksumType.CRC32C, bytes_per_checksum=256)
J_MESH_SPEC = j_fused.FusedSpec(JOptions(6, 3, "rs", cell_size=1024),
                                JChecksumType.CRC32C, bytes_per_checksum=256)


@pytest.fixture
def mesh_pair():
    """(port executor on 8 CPU slots, reference executor), depth 2."""
    assert jax.device_count() == 8, "conftest must provide 8 CPU devices"
    ex = MeshExecutor(mesh=make_mesh(devices=["cpu"] * 8), depth=2)
    jex = j_mex.MeshExecutor(depth=2)
    yield ex, jex
    ex.close()
    jex.close()


def test_mesh_host_twin_on_cpu(knob, mesh_pair):
    """On CPU slots under ``auto`` an encode and a decode lane resolve to
    the host twin, as on the reference's CPU devices: no plan built,
    `programs_host_twin` counts both, and the outputs equal the
    reference executor's and the single twin's."""
    knob("auto")
    ex, jex = mesh_pair
    enc, jenc = cs.encode_key(MESH_SPEC), ("encode", J_MESH_SPEC)
    valid, erased = (0, 1, 2, 3, 4, 5), (6, 7)
    dec, jdec = (cs.decode_key(MESH_SPEC, valid, erased),
                 ("decode", J_MESH_SPEC, valid, erased))
    data = _rand((11, 6, 1024), 5)
    n0 = fused.host_twin_calls.count
    m0 = mesh_executor.METRICS.counter("dispatches").value
    for k, jk in ((enc, jenc), (dec, jdec)):
        assert ex.accepts(k) and jex.accepts(jk)
        prog, jprog = ex._programs[k], jex._programs[jk]
        assert prog.host_twin and jprog.host_twin and prog.compile_count() == 0
        outs = ex.submit(k, data, width=1).result(timeout=60)
        jouts = jex.submit(jk, data, width=1).result(timeout=60)
        assert len(outs) == len(jouts) == 2
        for o, jo in zip(outs, jouts):
            assert np.array_equal(o, np.asarray(jo))
    single = fused._native_fused_encoder(MESH_SPEC.options, ChecksumType.CRC32C, 256)
    parity, _ = single.run(data)
    assert np.array_equal(ex.submit(enc, data, width=1).result(timeout=60)[0],
                          parity.numpy())
    # a dispatch is 8 rows (11 rows: 8, then 3 and zero padding), one
    # twin call per slot
    dispatches = mesh_executor.METRICS.counter("dispatches").value - m0
    assert dispatches == 6
    assert fused.host_twin_calls.count - n0 == 8 * dispatches
    stats, jstats = ex.stats(), jex.stats()
    assert stats["programs_host_twin"] == jstats["programs_host_twin"] == 2
    assert stats["programs"] == 2


def test_mesh_default_is_the_device_program_but_twin_lanes_stay_twins(knob):
    """With the knob unset every program is the sharded device program; a
    key the service tagged as a twin lane's (a spilled twin lane) still
    gets the twin, so its stripes never run on the device program."""
    knob(None)
    ex = MeshExecutor(mesh=make_mesh(devices=["cpu"] * 4), depth=2)
    try:
        key = cs.encode_key(MESH_SPEC)
        tagged = key + (fused.HOST_TWIN,)
        assert ex.accepts(key) and ex.accepts(tagged)
        assert not ex._programs[key].host_twin and ex._programs[tagged].host_twin
        data = _rand((4, 6, 1024), 6)
        a = ex.submit(key, data, width=1).result(timeout=60)
        b = ex.submit(tagged, data, width=1).result(timeout=60)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert ex.stats()["programs_host_twin"] == 1
    finally:
        ex.close()


# ---------------------------------------------------- the event queue
def _event_run(mod):
    """Publish 0..5 on an async queue with a failing middle handler; the
    publisher sees no error, flush() returns once all ran, in order."""
    q = mod.EventQueue(async_dispatch=True)
    seen, threads = [], set()
    gate = threading.Event()

    def first(x):
        gate.wait(5)
        threads.add(threading.current_thread().name)
        seen.append(("first", x))

    def failing(x):
        if x % 2:
            raise ValueError(f"handler failed on {x}")
        seen.append(("failing", x))

    q.subscribe("t", first)
    q.subscribe("t", failing)
    q.subscribe("t", lambda x: seen.append(("last", x)))
    for i in range(6):
        q.publish("t", i)
    before = list(seen)  # the worker is held at the gate: nothing ran yet
    gate.set()
    q.flush()
    q.publish("other", 9)  # no handler
    q.flush()
    return before, seen, sorted(threads)


def test_event_queue_async_dispatch_matches_reference(caplog):
    with caplog.at_level("ERROR"):
        port, ref = _event_run(events), _event_run(j_events)
    assert port == ref
    before, seen, threads = port
    assert before == [] and threads == ["event-queue"]
    assert [x for name, x in seen if name == "last"] == list(range(6))
    assert [x for name, x in seen if name == "failing"] == [0, 2, 4]
    failures = [r for r in caplog.records
                if r.name == "ozone_tpu_torch.utils.events"]
    assert len(failures) == 3 and all(r.exc_info for r in failures)


def test_event_queue_sync_default_and_flush():
    q = events.EventQueue()
    seen = []
    q.subscribe("t", seen.append)
    q.publish("t", 1)
    assert seen == [1]  # synchronous: ran before publish returned
    q.flush()  # a no-op
    assert q._worker is None


@pytest.mark.parametrize("scheme", ["rs-6-3", "rs-10-4", "lrc-12-2-2"])
def test_rate_sample_serves_every_codec(scheme):
    """The policy's twin sample runs at 256 KiB cells for every codec the
    verdicts are asked of (an LRC keeps its local groups), uncounted."""
    n0 = fused.host_twin_calls.count
    assert fused._native_rate_sample(CoderOptions.parse(f"{scheme}-{1 << 20}")) > 0
    assert fused.host_twin_calls.count == n0
    jopts = JOptions.parse(f"{scheme}-{1 << 20}")
    if scheme.startswith("lrc"):
        # the reference drops the local groups (ROADMAP Queue 3 item 14)
        with pytest.raises(ValueError, match="local_groups"):
            j_fused._native_rate_sample(jopts)
    else:
        assert j_fused._native_rate_sample(jopts) > 0
