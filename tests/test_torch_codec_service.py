"""The port's shared codec service against `ozone_tpu`'s, on the CPU.

Each test of tests/test_codec_service.py, on the port's service with the
fused functions on device="cpu" (the kernel's plain version): stripes of
different operations share one dispatch, a lone stripe is bounded by the
linger, a near-expiry deadline forces a partial batch, weighted fair QoS
keeps a bulk sweep from starving interactive work, and the writer, the
reader and the coordinator take the service by default and their
per-operation route with OZONE_TPU_CODEC_SERVICE=0, byte-exact either way.
Then the port's service is held against the JAX service on the same
submissions (outputs per submitter, dispatches, multi-operation
dispatches), and concurrent port writers on the service against
concurrent JAX writers on theirs (every stored chunk equal).
"""

import itertools
import threading
import time

import numpy as np
import pytest

from ozone_tpu.client import dn_client as j_dn_client
from ozone_tpu.client import ec_writer as j_ec_writer
from ozone_tpu.codec import fused as j_fused
from ozone_tpu.codec import service as j_cs
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.scm import pipeline as j_pipeline
from ozone_tpu.storage import datanode as j_datanode
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch.client import dn_client, ec_writer, resilience
from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
from ozone_tpu_torch.client.ec_writer import ECKeyWriter
from ozone_tpu_torch.codec import service as cs
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import FusedSpec, make_fused_encoder
from ozone_tpu_torch.scm import pipeline
from ozone_tpu_torch.storage import datanode, reconstruction
from ozone_tpu_torch.utils.checksum import ChecksumType
from tests.test_torch_ec_write import MiniEC as DualMiniEC

CELL = 4096
OPTS = CoderOptions(3, 2, "rs", cell_size=CELL)
SPEC = FusedSpec(OPTS, ChecksumType.CRC32C, 1024)


@pytest.fixture
def svc():
    cs.reset_for_tests()
    yield cs.get_service()
    cs.reset_for_tests()


@pytest.fixture
def fresh_service_env(monkeypatch):
    """Re-create the singleton after knob monkeypatches apply."""
    def make(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        cs.reset_for_tests()
        return cs.get_service()

    yield make
    cs.reset_for_tests()


class MiniEC(DualMiniEC):
    """The port's side of the dual cluster of test_torch_ec_write.py, with
    the writer and reader of tests/test_codec_service.py's harness."""

    def __init__(self, tmp_path, n_dn=7):
        super().__init__(tmp_path, (datanode, dn_client, pipeline, ec_writer),
                         OPTS, n_dn=n_dn)

    def writer(self, **kw):
        return ECKeyWriter(self.opts, self.allocate, self.clients,
                           block_size=8 * CELL, bytes_per_checksum=1024,
                           stripe_batch=4, device="cpu", **kw)

    def reader(self, g):
        return ECBlockGroupReader(g, self.opts, self.clients,
                                  bytes_per_checksum=1024, device="cpu")


@pytest.fixture
def cluster(tmp_path):
    c = MiniEC(tmp_path)
    yield c
    c.close()


def _rand(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)


def _encoder():
    return make_fused_encoder(SPEC, device="cpu")


def _host(outs):
    return tuple(o.numpy().view(np.uint32) if o.dtype.is_signed else o.numpy()
                 for o in outs)


# ------------------------------------------------------------ coalescing
def test_cross_request_stripes_share_one_dispatch(svc):
    """Two distinct operations' stripes land in one fused dispatch, and
    each gets exactly its own slice of the batched outputs."""
    fn = _encoder()
    a, b = _rand((2, 3, CELL), 1), _rand((2, 3, CELL), 2)
    d0 = cs.METRICS.counter("dispatches").value
    x0 = cs.METRICS.counter("multi_op_dispatches").value
    f1 = svc.submit(cs.encode_key(SPEC), fn, a, width=4)
    f2 = svc.submit(cs.encode_key(SPEC), fn, b, width=4)
    p1, c1 = cs.wait_result(f1)
    p2, c2 = cs.wait_result(f2)
    ref_p, ref_c = _host(fn(np.concatenate([a, b])))
    assert c1.dtype == np.uint32
    assert np.array_equal(np.concatenate([p1, p2]), ref_p)
    assert np.array_equal(np.concatenate([c1, c2]), ref_c)
    assert cs.METRICS.counter("dispatches").value - d0 == 1
    assert cs.METRICS.counter("multi_op_dispatches").value - x0 == 1


def test_large_submission_splits_across_constant_shape_batches(svc):
    """A submission wider than the lane splits into width-sized
    dispatches and reassembles in order, byte-exact against one call."""
    fn = _encoder()
    data = _rand((11, 3, CELL), 3)
    d0 = cs.METRICS.counter("dispatches").value
    out_p, out_c = cs.wait_result(
        svc.submit(cs.encode_key(SPEC), fn, data, width=4))
    ref_p, ref_c = _host(fn(data))
    assert np.array_equal(out_p, ref_p)
    assert np.array_equal(out_c, ref_c)
    assert cs.METRICS.counter("dispatches").value - d0 == 3  # 4+4+3pad


def test_mismatched_widths_never_pad_against_each_other(svc):
    """Lanes are keyed by (key, width): an 8-wide submitter and a 2-wide
    submitter batch separately."""
    fn = _encoder()
    a = _rand((2, 3, CELL), 4)
    f1 = svc.submit(cs.encode_key(SPEC), fn, a, width=8)
    f2 = svc.submit(cs.encode_key(SPEC), fn, a, width=2)
    p1, _ = cs.wait_result(f1)
    p2, _ = cs.wait_result(f2)
    assert np.array_equal(p1, p2)


# ----------------------------------------------------- linger + deadline
def test_lone_stripe_completes_within_linger_plus_dispatch(
        fresh_service_env):
    """A lone 1-stripe submission into a wide lane completes within the
    linger plus one dispatch, through the forced (linger) flush."""
    svc = fresh_service_env(OZONE_TPU_CODEC_LINGER_MS="40")
    fn = _encoder()
    fn(_rand((1, 3, CELL)))  # first-touch cost outside the timing
    ff0 = cs.METRICS.counter("forced_flushes").value
    t0 = time.monotonic()
    p, _ = cs.wait_result(
        svc.submit(cs.encode_key(SPEC), fn, _rand((1, 3, CELL), 5),
                   width=8, tail=True))
    dt = time.monotonic() - t0
    assert p.shape == (1, 2, CELL)
    assert dt < 0.04 + 1.0, f"lone stripe took {dt:.3f}s"
    assert dt >= 0.8 * 0.04, "linger path was skipped entirely"
    assert cs.METRICS.counter("forced_flushes").value == ff0 + 1
    assert cs.METRICS.gauge("batch_fill_pct").value < 100.0


def test_near_expiry_deadline_forces_partial_flush(fresh_service_env):
    """A submitter whose deadline is about to expire gets a partial-batch
    dispatch instead of DEADLINE_EXCEEDED, though the linger says wait."""
    svc = fresh_service_env(OZONE_TPU_CODEC_LINGER_MS="5000")
    fn = _encoder()
    fn(_rand((1, 3, CELL)))
    df0 = cs.METRICS.counter("deadline_flushes").value
    with resilience.start("near_expiry_put", seconds=0.25):
        t0 = time.monotonic()
        p, _ = cs.wait_result(
            svc.submit(cs.encode_key(SPEC), fn,
                       _rand((2, 3, CELL), 6), width=8))
        dt = time.monotonic() - t0
    assert p.shape == (2, 2, CELL)
    assert dt < 2.0, f"deadline flush never fired ({dt:.3f}s)"
    assert cs.METRICS.counter("deadline_flushes").value >= df0 + 1


# ---------------------------------------------------------------- QoS
def _busy(seconds):
    def fn(batch):
        t_end = time.monotonic() + seconds
        while time.monotonic() < t_end:
            pass
        return (batch.copy(),)
    return fn


def test_bulk_sweep_cannot_starve_interactive(fresh_service_env):
    """A saturating bulk sweep and an interactive submitter run at once:
    both progress and the interactive P95 wait stays bounded."""
    svc = fresh_service_env(OZONE_TPU_CODEC_LINGER_MS="1",
                            OZONE_TPU_CODEC_QOS="interactive=4,bulk=1")
    slow_fn = _busy(0.003)

    def fast_fn(batch):
        return (batch.copy(),)

    stop = threading.Event()
    bulk_done = [0]

    def bulk():
        data = _rand((8, 3, CELL), 7)
        while not stop.is_set():
            cs.wait_result(svc.submit(("bulk-lane",), slow_fn, data,
                                      width=8, qos="bulk"))
            bulk_done[0] += 1

    threads = [threading.Thread(target=bulk) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.05)  # let the sweep saturate the dispatcher
        waits = []
        one = _rand((1, 3, CELL), 8)
        for _ in range(25):
            t0 = time.monotonic()
            (out,) = cs.wait_result(svc.submit(
                ("interactive-lane",), fast_fn, one, width=1,
                qos="interactive"))
            waits.append(time.monotonic() - t0)
            assert np.array_equal(out, one)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert bulk_done[0] >= 3, "the bulk sweep made no progress"
    waits.sort()
    p95 = waits[int(0.95 * (len(waits) - 1))]
    assert p95 < 0.25, f"interactive P95 wait {p95:.3f}s: starved"


def test_starvation_guard_preempts_pathological_weights(
        fresh_service_env):
    """With weights pathologically inverted, the starvation guard serves
    an over-aged queue head (and counts the trip)."""
    svc = fresh_service_env(
        OZONE_TPU_CODEC_LINGER_MS="1",
        OZONE_TPU_CODEC_STARVE_MS="20",
        OZONE_TPU_CODEC_QOS="interactive=0.000001,bulk=1000")
    slow_fn = _busy(0.002)
    one = _rand((1, 3, CELL), 10)
    # the first interactive dispatch is free (vtime 0) and inflates the
    # class's virtual time past the whole bulk backlog's
    cs.wait_result(svc.submit(("interactive-lane",), slow_fn, one,
                              width=1, qos="interactive"))
    g0 = cs.METRICS.counter("starvation_guard_trips").value
    data = _rand((4, 3, CELL), 9)
    bulk_futs = [svc.submit(("bulk-lane",), slow_fn, data, width=4,
                            qos="bulk") for _ in range(80)]
    t0 = time.monotonic()
    (out,) = cs.wait_result(svc.submit(
        ("interactive-lane",), slow_fn, one, width=1, qos="interactive"))
    dt = time.monotonic() - t0
    assert np.array_equal(out, one)
    assert cs.METRICS.counter("starvation_guard_trips").value > g0
    assert dt < 0.12, f"guard served the interactive head at {dt:.3f}s"
    for f in bulk_futs:
        cs.wait_result(f)  # the sweep itself still completes


def test_idle_class_activation_floors_virtual_time(fresh_service_env):
    """A class idle through a long burst of the other class joins at the
    system virtual clock: its stale low virtual time buys no monopoly.

    Counted, not timed: between the interactive submit and its dispatch,
    the bulk class may run only the dispatches the weighted-fair order
    allows it from where it joined (the clock) up to the interactive
    class's virtual time, one dispatch costing 4 stripes / weight 1. The
    burst (800 interactive stripes at weight 4) sets that time 50 bulk
    dispatches above zero, so a bulk class joining at zero instead of at
    the clock would run its whole backlog first."""
    svc = fresh_service_env(OZONE_TPU_CODEC_LINGER_MS="1",
                            OZONE_TPU_CODEC_STARVE_MS="5000",
                            OZONE_TPU_CODEC_QOS="interactive=4,bulk=1")
    slow_fn = _busy(0.002)
    order: list[str] = []

    def tagged(name):
        def fn(batch):
            order.append(name)
            return slow_fn(batch)
        return fn

    bulk_fn, inter_fn = tagged("bulk"), tagged("interactive")
    burst = _rand((80, 3, CELL), 11)
    one = burst[:1]
    for _ in range(10):
        cs.wait_result(svc.submit(("interactive-lane",), inter_fn, burst,
                                  width=80, qos="interactive"))
    with svc._lock:  # idle: the clock and the interactive time stand
        vclock, v_inter = svc._vclock, svc._vtime["interactive"]
    allowed = int((v_inter - vclock) // 4) + 1  # 4 stripes / weight 1
    data = _rand((4, 3, CELL), 12)
    bulk_futs = [svc.submit(("bulk-lane",), bulk_fn, data, width=4,
                            qos="bulk") for _ in range(50)]
    mark = len(order)
    cs.wait_result(svc.submit(("interactive-lane",), inter_fn, one,
                              width=1, qos="interactive"))
    ahead = order[mark:order.index("interactive", mark)].count("bulk")
    assert ahead <= allowed, (
        f"{ahead} bulk dispatches ran ahead of the interactive submission "
        f"(the weighted-fair order allows {allowed}): the activation floor "
        f"is broken")
    assert svc._vtime["bulk"] > 0.0  # joined at the clock, not at zero
    for f in bulk_futs:
        cs.wait_result(f)


# ------------------------------------------------------- datapath wiring
def test_concurrent_writers_coalesce_and_stay_byte_exact(
        cluster, fresh_service_env):
    """Concurrent one-stripe PUTs share fused dispatches across
    operations, and every key reads back byte-exact."""
    fresh_service_env(OZONE_TPU_CODEC_LINGER_MS="250")
    n_ops = 4
    datas = [_rand(3 * CELL, 20 + i) for i in range(n_ops)]
    groups: list = [None] * n_ops
    x0 = cs.METRICS.counter("multi_op_dispatches").value
    t0 = cs.METRICS.counter("tail_flushes").value
    barrier = threading.Barrier(n_ops)

    def put(i):
        barrier.wait()
        w = cluster.writer()
        w.write(datas[i])
        groups[i] = w.close()

    threads = [threading.Thread(target=put, args=(i,))
               for i in range(n_ops)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert all(g is not None for g in groups)
    assert cs.METRICS.counter("multi_op_dispatches").value > x0
    assert cs.METRICS.counter("tail_flushes").value >= t0 + n_ops
    for i in range(n_ops):
        got = np.concatenate([cluster.reader(g).read_all()
                              for g in groups[i]])
        assert np.array_equal(got, datas[i])


def test_degraded_read_routes_through_service(cluster, svc):
    """A degraded read decodes through the shared service (its dispatch
    counters move) and stays byte-exact."""
    data = _rand(6 * CELL, 30)
    w = cluster.writer()
    w.write(data)
    groups = w.close()
    d0 = cs.METRICS.counter("dispatches").value
    for g in groups:
        cluster.dns[[d.id for d in cluster.dns].index(
            g.pipeline.nodes[0])].delete_container(
                g.container_id, force=True)
    got = np.concatenate([cluster.reader(g).read_all() for g in groups])
    assert np.array_equal(got, data)
    assert cs.METRICS.counter("dispatches").value > d0


@pytest.mark.parametrize("service", ["1", "0"])
def test_coordinator_rebuilds_on_both_routes(cluster, monkeypatch, service):
    """Offline reconstruction submits its decode batches to the service
    (in the bulk class) by default and decodes on its own with the
    service off; the rebuilt chunks are the lost ones either way."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", service)
    cs.reset_for_tests()
    try:
        data = _rand(9 * CELL + 5, 40)
        w = cluster.writer()
        w.write(data)
        (g,) = w.close()
        lost = g.pipeline.nodes[1]
        src = cluster.dns[int(lost[2:])]
        want = [src.read_chunk(g.block_id, i)
                for i in src.get_block(g.block_id).chunks]
        src.delete_container(g.container_id, force=True)
        s0 = cs.METRICS.counter("submissions").value
        b0 = cs.METRICS.counter("stripes_dispatched").value
        cmd = reconstruction.ReconstructionCommand(
            g.container_id, OPTS,
            {u + 1: n for u, n in enumerate(g.pipeline.nodes) if n != lost},
            {2: "dn5"})
        reconstruction.ECReconstructionCoordinator(
            cluster.clients, bytes_per_checksum=1024,
            device="cpu").reconstruct_container_group(cmd)
        spare = cluster.dns[5]
        got = [spare.read_chunk(g.block_id, i, verify=True)
               for i in spare.get_block(g.block_id).chunks]
        assert [x.tobytes() for x in got] == [x.tobytes() for x in want]
        moved = cs.METRICS.counter("submissions").value - s0
        assert (moved > 0) == (service == "1")
        if service == "1":
            assert cs.METRICS.counter("stripes_dispatched").value - b0 == 4
    finally:
        cs.reset_for_tests()


def test_disabled_service_falls_back_byte_exact(cluster, monkeypatch):
    """OZONE_TPU_CODEC_SERVICE=0: writers and readers keep their
    per-operation routes; bytes identical, service untouched."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    assert cs.maybe_service() is None
    s0 = cs.METRICS.counter("submissions").value
    data = _rand(7 * CELL + 11, 31)
    w = cluster.writer()
    w.write(data)
    groups = w.close()
    for g in groups:
        cluster.dns[[d.id for d in cluster.dns].index(
            g.pipeline.nodes[1])].delete_container(
                g.container_id, force=True)
    got = np.concatenate([cluster.reader(g).read_all() for g in groups])
    assert np.array_equal(got, data)
    assert cs.METRICS.counter("submissions").value == s0


def test_service_error_propagates_to_submitter(svc):
    """A fused function failing mid-dispatch surfaces on the submitter's
    future, not as a dead dispatcher."""
    def broken(batch):
        raise RuntimeError("device fault")

    with pytest.raises(RuntimeError, match="device fault"):
        cs.wait_result(svc.submit(("broken-lane",), broken,
                                  _rand((1, 3, CELL), 32), width=1))
    fn = _encoder()
    p, _ = cs.wait_result(
        svc.submit(cs.encode_key(SPEC), fn, _rand((1, 3, CELL), 33),
                   width=1))
    assert p.shape == (1, 2, CELL)


def test_stats_snapshot_shape(svc):
    """The operator snapshot: fill ratio, operations per dispatch, queue
    depth and the knobs are always present."""
    fn = _encoder()
    cs.wait_result(svc.submit(cs.encode_key(SPEC), fn,
                              _rand((2, 3, CELL), 34), width=2))
    out = svc.stats()
    for want in ("fill_ratio", "ops_per_dispatch", "queue_depth",
                 "lanes", "inflight", "linger_ms", "weights", "enabled"):
        assert want in out, want
    assert 0.0 < out["fill_ratio"] <= 1.0
    assert out["enabled"] is True


def test_tensor_submissions_stage_into_a_host_buffer(svc):
    """Tensor submitters (the writer's and reader's staged batches) are
    packed into a fresh zero-padded host tensor; a lone submission that
    fills the lane goes in as its own tensor."""
    import torch

    seen = []

    def spy(batch):
        seen.append(batch)
        return (batch.clone(),)

    a = torch.from_numpy(_rand((1, 3, CELL), 35))
    b = torch.from_numpy(_rand((2, 3, CELL), 36))
    (out,) = cs.wait_result(svc.submit(("spy",), spy, a, width=1))
    assert seen[-1].data_ptr() == a.data_ptr()
    assert np.array_equal(out, a.numpy())
    f1 = svc.submit(("spy",), spy, b, width=4, tail=True)
    (out,) = cs.wait_result(f1)
    assert isinstance(seen[-1], torch.Tensor) and seen[-1].shape[0] == 4
    assert not seen[-1][2:].any()  # zero padding
    assert np.array_equal(out, b.numpy())


# ------------------------------------ dispatcher steps and the device edge
STEPS = ("codec:idle_wait", "codec:pack", "codec:stage", "codec:launch",
         "codec:pull_start", "codec:pull_wait", "codec:resolve")
HOST_STEPS = ("codec:pack", "codec:stage", "codec:launch",
              "codec:pull_start", "codec:resolve")
#: slack of a boundary between two steps: one rounding of wall time
TICK = 1e-6


def _counts(*names):
    return {n: cs.METRICS.counter(n).value for n in names}


def _since(t0, names):
    from ozone_tpu_torch.utils.tracing import Tracer

    return [s for s in Tracer.instance().traces()
            if s.name in names and s.start >= t0]


def test_dispatcher_steps_tile_nest_and_sum(fresh_service_env):
    """The dispatcher's steps cover its thread end to end, one after
    another; each dispatch's steps are children of its
    `codec:device_dispatch`, which starts with `codec:stage` (before the
    launch) and ends with `codec:resolve`; the two time counters are the
    sums of their steps."""
    from ozone_tpu_torch.utils.tracing import Tracer

    cs.reset_for_tests()
    c0 = _counts("dispatch_host_seconds_total", "pull_wait_seconds_total",
                 "dispatches")
    t0 = Tracer.now()
    svc = fresh_service_env(OZONE_TPU_CODEC_LINGER_MS="1")
    fn = _encoder()

    def submitter(i):
        for j in range(4):
            cs.wait_result(svc.submit(cs.encode_key(SPEC), fn,
                                      _rand((1 + (i + j) % 3, 3, CELL), i),
                                      width=4, tail=True))

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    time.sleep(0.05)  # the dispatcher goes idle
    cs.reset_for_tests()  # ends the loop: every step is recorded
    c1 = _counts("dispatch_host_seconds_total", "pull_wait_seconds_total",
                 "dispatches")
    steps = sorted(_since(t0, STEPS), key=lambda s: s.start)
    assert {s.name for s in steps} == set(STEPS)
    for a, b in zip(steps, steps[1:]):
        assert b.start == pytest.approx(a.start + a.duration, abs=TICK), \
            (a.name, b.name)
    covered = sum(s.duration for s in steps)
    assert covered == pytest.approx(
        steps[-1].start + steps[-1].duration - steps[0].start, abs=TICK)

    dispatches = _since(t0, ("codec:device_dispatch",))
    assert len(dispatches) == c1["dispatches"] - c0["dispatches"] > 1
    for d in dispatches:
        kids = {s.name: s for s in steps
                if s.trace_id == d.trace_id and s.parent_id == d.span_id}
        assert sorted(kids) == sorted(set(STEPS) - {"codec:idle_wait"})
        end = d.start + d.duration
        assert kids["codec:pack"].start + kids["codec:pack"].duration == \
            pytest.approx(d.start, abs=TICK)
        assert kids["codec:stage"].start == pytest.approx(d.start, abs=TICK)
        assert d.start < kids["codec:launch"].start
        for name in STEPS[2:]:
            k = kids[name]
            assert d.start - TICK <= k.start
            assert k.start + k.duration <= end + TICK
        r = kids["codec:resolve"]
        assert r.start + r.duration == pytest.approx(end, abs=TICK)

    host = sum(s.duration for s in steps if s.name in HOST_STEPS)
    wait = sum(s.duration for s in steps if s.name == "codec:pull_wait")
    assert c1["dispatch_host_seconds_total"] - \
        c0["dispatch_host_seconds_total"] == pytest.approx(host, abs=TICK)
    assert c1["pull_wait_seconds_total"] - \
        c0["pull_wait_seconds_total"] == pytest.approx(wait, abs=TICK)


def _rs_spec(k, p):
    return FusedSpec(CoderOptions(k, p, "rs", cell_size=CELL),
                     ChecksumType.CRC32C, 1024)


WORDS = CELL // 1024 * 4  # CRC32C bytes per cell


@pytest.mark.parametrize("lane,width,n,in_bytes,out_bytes", [
    # RS(6,3) encode: 6 cells in; 3 parity cells and 9 cells' CRCs out
    ("rs63-encode", 2, 2, 6 * CELL, 3 * CELL + 9 * WORDS),
    # RS(10,4) decode of units 0 and 1 from units 2-11: 10 cells in; 2
    # rebuilt cells and their CRCs out
    ("rs104-decode", 2, 2, 10 * CELL, 2 * CELL + 2 * WORDS),
    # one stripe in a lane of 4: the padding crosses the edge too
    ("rs63-encode", 4, 1, 6 * CELL, 3 * CELL + 9 * WORDS),
])
def test_edge_bytes_per_stripe_are_exact(svc, lane, width, n, in_bytes,
                                         out_bytes):
    from ozone_tpu_torch.codec.fused import make_fused_decoder
    from ozone_tpu_torch.utils.tracing import Tracer

    if lane == "rs63-encode":
        spec = _rs_spec(6, 3)
        fn, key, k = make_fused_encoder(spec, "cpu"), cs.encode_key(spec), 6
    else:
        spec = _rs_spec(10, 4)
        valid, erased = list(range(2, 12)), [0, 1]
        fn = make_fused_decoder(spec, valid, erased, "cpu")
        key, k = cs.decode_key(spec, valid, erased), 10
    c0 = _counts("h2d_bytes", "d2h_bytes", "stripes_dispatched")
    t0 = Tracer.now()
    cs.wait_result(svc.submit(key, fn, _rand((n, k, CELL), 7), width=width,
                              tail=n < width))
    cs.reset_for_tests()
    c1 = _counts("h2d_bytes", "d2h_bytes", "stripes_dispatched")
    assert c1["stripes_dispatched"] - c0["stripes_dispatched"] == n
    assert c1["h2d_bytes"] - c0["h2d_bytes"] == width * in_bytes
    assert c1["d2h_bytes"] - c0["d2h_bytes"] == width * out_bytes
    edge = (c1["h2d_bytes"] - c0["h2d_bytes"]
            + c1["d2h_bytes"] - c0["d2h_bytes"]) / n
    assert edge == width // n * (in_bytes + out_bytes)
    (launch,) = _since(t0, ("codec:launch",))
    (pull,) = _since(t0, ("codec:pull_start",))
    assert launch.tags["h2d_bytes"] == width * in_bytes
    assert pull.tags["d2h_bytes"] == width * out_bytes


def test_mesh_forms_count_their_edge_bytes():
    """The mesh forms' host rows and the mesh executor's pull count at the
    same edge."""
    from ozone_tpu_torch.parallel import mesh_executor, sharded

    spec = _rs_spec(6, 3)
    mesh = sharded.make_mesh(devices=["cpu"] * 2)
    fn = sharded.make_sharded_fused_encoder(spec, mesh)
    c0 = _counts("h2d_bytes", "d2h_bytes")
    outs = fn(_rand((4, 6, CELL), 8))
    mesh_executor._finish_pull(mesh_executor._start_pull(outs))
    c1 = _counts("h2d_bytes", "d2h_bytes")
    assert c1["h2d_bytes"] - c0["h2d_bytes"] == 4 * 6 * CELL
    assert c1["d2h_bytes"] - c0["d2h_bytes"] == 4 * (3 * CELL + 9 * WORDS)


# ------------------------------------------------- against the reference
J_SPEC = j_fused.FusedSpec(JOptions(3, 2, "rs", cell_size=CELL),
                           JChecksumType.CRC32C, 1024)


@pytest.fixture
def both_services(monkeypatch):
    """The port's and the JAX service with a long linger, so a lane
    dispatches only when it is full and the packing is deterministic."""
    monkeypatch.setenv("OZONE_TPU_CODEC_LINGER_MS", "5000")
    monkeypatch.setenv("OZONE_TPU_FUSED_BACKEND", "jax")
    cs.reset_for_tests()
    j_cs.reset_for_tests()
    yield cs.get_service(), j_cs.get_service()
    cs.reset_for_tests()
    j_cs.reset_for_tests()


@pytest.mark.parametrize("width,sizes,dispatches,multi", [
    (4, [12], 3, 0),  # one submission split into three full batches
    (4, [2, 2], 1, 1),  # two operations share one batch
    (4, [3, 2, 3], 2, 2),  # FIFO packing across submission boundaries
    (8, [1] * 8, 1, 1),  # eight one-stripe tails in one batch
])
def test_service_matches_reference(both_services, width, sizes,
                                   dispatches, multi):
    port_svc, ref_svc = both_services
    fn = _encoder()
    jfn = j_fused.make_fused_encoder(J_SPEC)
    subs = [_rand((n, 3, CELL), 50 + i) for i, n in enumerate(sizes)]
    results = []
    for mod, svc, f, key in ((cs, port_svc, fn, cs.encode_key(SPEC)),
                             (j_cs, ref_svc, jfn, j_cs.encode_key(J_SPEC))):
        d0 = mod.METRICS.counter("dispatches").value
        m0 = mod.METRICS.counter("multi_op_dispatches").value
        futs = [svc.submit(key, f, s, width=width) for s in subs]
        outs = [tuple(np.asarray(a) for a in mod.wait_result(x))
                for x in futs]
        results.append((outs,
                        mod.METRICS.counter("dispatches").value - d0,
                        mod.METRICS.counter("multi_op_dispatches").value - m0))
    (outs, d, m), (j_outs, jd, jm) = results
    assert (d, m) == (jd, jm) == (dispatches, multi)
    for (p, c), (jp, jc), s in zip(outs, j_outs, subs):
        assert p.shape == (s.shape[0], 2, CELL)
        assert np.array_equal(p, jp)
        assert np.array_equal(c, np.asarray(jc, dtype=np.uint32))


def test_concurrent_writers_match_reference(tmp_path, monkeypatch):
    """Concurrent port writers on the port's service and JAX writers on
    the JAX service, on the same data: every stored chunk and its
    ChecksumData are equal, and both services coalesced the tails."""
    monkeypatch.setenv("OZONE_TPU_CODEC_LINGER_MS", "250")
    monkeypatch.setenv("OZONE_TPU_FUSED_BACKEND", "jax")
    cs.reset_for_tests()
    j_cs.reset_for_tests()
    n_ops = 4
    datas = [_rand(5 * 3 * CELL + 1000 * i + 7, 60 + i) for i in range(n_ops)]
    port = DualMiniEC(tmp_path / "port",
                      (datanode, dn_client, pipeline, ec_writer), OPTS)
    ref = DualMiniEC(tmp_path / "ref",
                     (j_datanode, j_dn_client, j_pipeline, j_ec_writer),
                     JOptions(3, 2, "rs", cell_size=CELL))
    try:
        stored = []
        for c, mod, kw in ((port, cs, {"device": "cpu"}), (ref, j_cs, {})):
            m0 = mod.METRICS.counter("multi_op_dispatches").value
            groups: list = [None] * n_ops
            barrier = threading.Barrier(n_ops)

            def put(i, c=c, kw=kw, groups=groups, barrier=barrier):
                ids = itertools.count(100 * (i + 1))

                def allocate(excluded):
                    n = next(ids)
                    return c.writer_mod.BlockGroup(
                        container_id=n, local_id=n,
                        pipeline=c.pipe_mod.Pipeline(
                            c.pipe_mod.ReplicationConfig.from_ec(c.opts),
                            [d.id for d in c.dns][:c.opts.all_units]))

                w = c.writer_mod.ECKeyWriter(
                    c.opts, allocate, c.clients, block_size=4 * CELL,
                    bytes_per_checksum=1024, stripe_batch=4, **kw)
                barrier.wait()
                w.write(datas[i])
                groups[i] = w.close()

            threads = [threading.Thread(target=put, args=(i,))
                       for i in range(n_ops)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert mod.METRICS.counter("multi_op_dispatches").value > m0
            stored.append([c.stored(g) for g in groups])
        assert stored[0] == stored[1]
        for data, key in zip(datas, stored[0]):
            got = b"".join(chunk for _ident, units in key
                           for u, _, chunk in units if u < 3)
            assert len(got) == data.size
    finally:
        cs.reset_for_tests()
        j_cs.reset_for_tests()
        port.close()
        ref.close()
