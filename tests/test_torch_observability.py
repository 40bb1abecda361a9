"""The port's observability layer against `ozone_tpu` on the CPU.

Mirrors of the reference's tests of `/prom`, spans and the trace
collector (tests/test_observability.py), the profiler, thread dump,
live reconfiguration and the Recon page (tests/test_observability_extras.py),
insight (tests/test_insight_repair.py) and the audit parser
(tests/test_audit_parser.py), with device="cpu" on the port's side.
Beyond them: the `/prom` text of equal registries is the reference's byte
for byte (exemplar timestamps aside), and the same seeded requests
through both packages' OM write the same audit records.
"""

import json
import logging
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ozone_tpu.testing.minicluster import MiniOzoneCluster as RefCluster
from ozone_tpu.utils import metrics as ref_metrics
from ozone_tpu_torch.net.rpc import RpcServer
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
from ozone_tpu_torch.tools.audit_parser import (
    aggregate,
    failures,
    filter_records,
    parse_file,
    parse_line,
)
from ozone_tpu_torch.utils import metrics as m
from ozone_tpu_torch.utils.audit import AuditLogger
from ozone_tpu_torch.utils.http_server import sample_stacks, thread_dump
from ozone_tpu_torch.utils.insight import (
    INSIGHT_POINTS,
    InsightClient,
    InsightService,
    RingLogHandler,
)
from ozone_tpu_torch.utils.tracing import (
    SpanExporter,
    TraceCollector,
    Tracer,
    critical_path,
)

EC = "rs-3-2-4096"


@pytest.fixture(autouse=True)
def _quiet_codec(monkeypatch):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(addr, path):
    return urllib.request.urlopen(f"http://{addr}{path}", timeout=10)


# ------------------------------------------------------------------ /prom
def test_prometheus_text_golden_every_registry_renders():
    """Every registry renders each metric with a # HELP + # TYPE pair and
    a stable sanitized name, the documented families of the port
    included; histograms render cumulative buckets, _sum, _count and the
    OpenMetrics trace exemplar; rendering is deterministic."""
    import ozone_tpu_torch.client.native_dn  # noqa: F401 - its counters
    import ozone_tpu_torch.lifecycle.service as lc_service
    from ozone_tpu_torch.admission import METRICS as ADMIT
    from ozone_tpu_torch.client.ozone_client import METRICS as OPS
    from ozone_tpu_torch.client.resilience import METRICS as RES
    from ozone_tpu_torch.client.slab import METRICS as SMALLOBJ
    from ozone_tpu_torch.codec.service import METRICS as CODEC
    from ozone_tpu_torch.om.sharding.plane import METRICS as SHARD
    from ozone_tpu_torch.replication_geo.shipper import METRICS as GEO

    for name in ("keys_scanned", "transitions", "bytes_tiered",
                 "expirations", "leader_fences"):
        lc_service.METRICS.counter(name).inc(0)
    lc_service.METRICS.timer("sweep_seconds").update(0.0)
    RES.counter("deadline_exceeded").inc(0)
    RES.counter("hedges_fired").inc(0)
    RES.counter("server_busy").inc(0)
    for name in ("submissions", "dispatches", "stripes_dispatched",
                 "slots_dispatched", "coalesced_operations",
                 "multi_op_dispatches", "forced_flushes",
                 "deadline_flushes", "tail_flushes",
                 "starvation_guard_trips"):
        CODEC.counter(name).inc(0)
    CODEC.gauge("queue_depth").set(0)
    CODEC.gauge("batch_fill_pct").set(0.0)
    CODEC.histogram("queue_wait_seconds").observe(0.0)
    CODEC.histogram("dispatch_seconds").observe(
        0.25, trace_id="deadbeefcafef00d")
    OPS.histogram("put_seconds").observe(0.001)
    OPS.histogram("get_seconds").observe(0.001)
    for name in ("keys_shipped", "bytes_shipped", "deletes_shipped",
                 "conflicts", "ship_failures", "pages_shipped",
                 "leader_fences", "bootstraps", "journal_gaps", "cycles"):
        GEO.counter(name).inc(0)
    GEO.gauge("lag_entries").set(0)
    GEO.gauge("lag_seconds").set(0.0)
    GEO.timer("ship_seconds").update(0.0)
    for name in ("routes", "moved_rejections", "cross_shard_prepares",
                 "cross_shard_commits", "cross_shard_aborts",
                 "follower_read_hits", "follower_read_misses",
                 "lease_renewals", "slots_migrated"):
        SHARD.counter(name).inc(0)
    for name in ("inline_puts", "inline_gets", "needles_packed",
                 "slabs_flushed"):
        SMALLOBJ.counter(name).inc(0)
    SMALLOBJ.gauge("queue_depth").set(0)
    SMALLOBJ.histogram("flush_seconds").observe(0.0)
    for name in ("gateway_admitted", "gateway_rejected_total",
                 "gateway_rejected_queue", "om_admitted"):
        ADMIT.counter(name).inc(0)
    ADMIT.gauge("gateway_inflight").set(0)

    text = m.prometheus_text()
    lines = text.splitlines()
    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    seen = set()
    for i, line in enumerate(lines):
        if not line.startswith("# TYPE "):
            continue
        _, _, metric, mtype = line.split(" ")
        assert mtype in ("counter", "gauge", "summary", "histogram"), line
        assert name_re.match(metric), f"unstable metric name {metric!r}"
        assert lines[i - 1].startswith(f"# HELP {metric} ")
        assert lines[i + 1].startswith(metric)
        seen.add(metric)
    with m._all_lock:
        regs = dict(m._all_registries)
    for reg_name, reg in regs.items():
        base = reg_name.replace(".", "_").replace("-", "_")
        for k in list(reg._counters):
            want = f"{base}_{k.replace('.', '_').replace('-', '_')}"
            assert want in seen, f"{reg_name}: missing {want}"
    for want in ("lifecycle_keys_scanned", "lifecycle_sweep_seconds",
                 "client_resilience_deadline_exceeded",
                 "client_resilience_server_busy",
                 "codec_service_dispatches", "codec_service_queue_depth",
                 "codec_service_dispatch_seconds",
                 "replication_keys_shipped", "replication_lag_seconds",
                 "replication_ship_seconds", "om_shard_routes",
                 "admission_gateway_rejected_total",
                 "admission_gateway_inflight", "smallobj_inline_puts",
                 "smallobj_flush_seconds", "datapath_native_fallbacks",
                 "datapath_layout_downgrades"):
        stem = want.removesuffix("_seconds")
        assert any(s.startswith(stem) for s in seen), want
    for fam in ("codec_service_queue_wait_seconds",
                "codec_service_dispatch_seconds",
                "client_ops_put_seconds", "client_ops_get_seconds"):
        assert f"# TYPE {fam} histogram" in text, fam
        assert any(s.startswith(f'{fam}_bucket{{le="+Inf"}}')
                   for s in lines), fam
        assert any(s.startswith(f"{fam}_sum ") for s in lines), fam
        assert any(s.startswith(f"{fam}_count ") for s in lines), fam
    assert re.search(
        r'codec_service_dispatch_seconds_bucket\{le="[^"]+"\} \d+ '
        r'# \{trace_id="deadbeefcafef00d"\} 0\.25 \d+(\.\d+)?', text)
    assert m.prometheus_text() == text


def _fill(mod, reg_name, rng_seed):
    """The same seeded observations into one registry of `mod`."""
    rng = np.random.default_rng(rng_seed)
    reg = mod.MetricsRegistry(reg_name)
    for k in ("a.b", "c-d", "ops"):
        reg.counter(k).inc(int(rng.integers(0, 100)))
    reg.gauge("depth").set(float(rng.integers(0, 50)))
    reg.gauge("fill.pct").set(float(rng.random()))
    t = reg.timer("sweep")
    for v in rng.random(5):
        t.update(float(v))
    h = reg.histogram("lat_seconds")
    for i, v in enumerate(10 ** rng.uniform(-5, 2.5, 40)):
        h.observe(float(v), trace_id=f"{i:016x}" if i % 3 == 0 else "")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prom_text_equals_reference(seed):
    """Equal registries render the reference's exposition text, apart
    from their names and the exemplars' unix timestamps."""
    got = m.prometheus_text(_fill(m, f"port.diff{seed}", seed))
    want = ref_metrics.prometheus_text(
        _fill(ref_metrics, f"port.diff{seed}", seed))
    ts = re.compile(r"(# \{trace_id=\"[0-9a-f]+\"\} \S+) \d+(\.\d+)?$")
    norm = [ts.sub(r"\1 T", ln) for ln in got.splitlines()]
    assert norm == [ts.sub(r"\1 T", ln) for ln in want.splitlines()]
    assert "trace_id=" in got
    assert m.escape_label('a"b\\c\nd') == \
        ref_metrics.escape_label('a"b\\c\nd')


# ---------------------------------------------------------------- tracing
def test_tracing_spans_nest_and_propagate():
    t = Tracer.instance()
    with t.span("outer") as outer:
        with t.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            ctx = t.inject()
            assert ctx == f"{inner.trace_id}:{inner.span_id}"
    with t.span("remote", child_of=ctx) as remote:
        assert remote.trace_id == outer.trace_id
        assert remote.parent_id == inner.span_id
    assert len(t.traces(trace_id=outer.trace_id)) == 3


def test_spans_read_one_clock():
    """`span` and `record_span` callers read `Tracer.now()`, host wall
    time: the clock a device trace is aligned to."""
    t = Tracer.instance()
    assert Tracer.now is time.time or Tracer.now() == pytest.approx(
        time.time(), abs=1e-3)
    before = time.time()
    with t.span("clocked") as s:
        time.sleep(0.01)
    after = time.time()
    assert before <= s.start and s.start + s.duration <= after + 1e-6
    assert s.duration >= 0.009


def test_span_ids_ignore_a_seeded_random():
    """Code that seeds `random` (tests of the consensus ring do) must not
    make trace ids repeat: two traces after the same seed differ."""
    import random

    t = Tracer.instance()
    random.seed(0)
    with t.span("first") as a:
        pass
    random.seed(0)
    with t.span("second") as b:
        pass
    assert a.trace_id != b.trace_id and a.span_id != b.span_id
    assert len(t.traces(trace_id=b.trace_id)) == 1


def test_full_buffer_counts_every_span_it_drops():
    """A span that falls off the full buffer unread counts in
    `spans_dropped` of the `tracing` registry, exactly, and `/prom`
    renders it; spans a reader took first are not counted."""
    from ozone_tpu_torch.utils import tracing

    dropped = m.registry("tracing").counter("spans_dropped")
    t = Tracer(max_spans=5)
    d0 = dropped.value
    for i in range(12):
        t.record_span("s", child_of="t:p", start=float(i), duration=0.0)
    assert dropped.value - d0 == 7
    assert [s.start for s in t.spans] == [7.0, 8.0, 9.0, 10.0, 11.0]
    # a batch longer than the buffer: the five buffered and its own
    # three oldest fall off
    t.record_spans([("t:p", "b", float(i), float(i), {}) for i in range(8)])
    assert dropped.value - d0 == 15
    assert [s.start for s in t.spans] == [3.0, 4.0, 5.0, 6.0, 7.0]
    t.spans.popleft()
    t.spans.popleft()  # a reader (a benchmark's drain) takes two
    t.record_spans([("t:p", "c", 0.0, 0.0, {})] * 2)
    assert dropped.value - d0 == 15 and len(t.spans) == 5
    t.record_span("root", start=0.0, duration=0.0)
    assert dropped.value - d0 == 16
    assert f"tracing_spans_dropped {dropped.value}" in \
        m.prometheus_text().splitlines()
    assert tracing.SPANS_DROPPED is dropped


def test_swapped_in_buffer_sets_the_bound():
    """A caller that swaps in a larger buffer (`chip_smoke.py` does, to
    keep a whole phase's spans) keeps every span up to its `maxlen`; an
    unbounded one drops none."""
    from collections import deque

    dropped = m.registry("tracing").counter("spans_dropped")
    t = Tracer(max_spans=5)
    t.spans = deque(t.spans, maxlen=50)
    d0 = dropped.value
    for i in range(40):
        t.record_span("s", child_of="t:p", start=float(i), duration=0.0)
    t.record_spans([("t:p", "b", 40.0 + i, 40.0 + i, {}) for i in range(10)])
    assert dropped.value == d0 and len(t.spans) == 50
    t.record_span("s", child_of="t:p", start=50.0, duration=0.0)
    assert dropped.value - d0 == 1 and t.spans[0].start == 1.0
    t.spans = deque()
    for i in range(20):
        t.record_span("s", child_of="t:p", start=float(i), duration=0.0)
    assert dropped.value - d0 == 1 and len(t.spans) == 20


def test_slo_keys_computed_once_env_read_live(monkeypatch):
    """Each root name's SLO key is worked out once; its value is read
    from the environment on every call, so a per-case override holds."""
    from ozone_tpu_torch.utils import tracing

    rec = tracing.FlightRecorder
    monkeypatch.delenv("OZONE_TPU_TRACE_SLO_MS", raising=False)
    monkeypatch.delenv("OZONE_TPU_TRACE_SLO_CLIENT_PUT_MS", raising=False)
    assert rec.slo_s("client:put") == 1.0
    assert tracing._SLO_KEYS["client:put"] == \
        "OZONE_TPU_TRACE_SLO_CLIENT_PUT_MS"
    monkeypatch.setenv("OZONE_TPU_TRACE_SLO_MS", "250")
    assert rec.slo_s("client:put") == 0.25
    monkeypatch.setenv("OZONE_TPU_TRACE_SLO_CLIENT_PUT_MS", "0")
    assert rec.slo_s("client:put") == 0.0
    assert rec.slo_s("--weird  name--") == 0.25
    assert tracing._SLO_KEYS["--weird  name--"] == \
        "OZONE_TPU_TRACE_SLO_WEIRD_NAME_MS"


def test_rpc_carries_trace_context(tmp_path):
    from ozone_tpu_torch.net.dn_service import (
        DatanodeRpcService,
        RpcDatanodeClient,
    )
    from ozone_tpu_torch.storage.datanode import Datanode

    dn = Datanode(tmp_path / "dn0", dn_id="dn0")
    srv = RpcServer()
    DatanodeRpcService(dn, srv)
    srv.start()
    try:
        c = RpcDatanodeClient("dn0", srv.address)
        t = Tracer.instance()
        with t.span("test-root") as root:
            c.echo(b"x")
        names = {s.name for s in t.traces(trace_id=root.trace_id)}
        assert any(n.startswith("client:") for n in names)
        assert any(n.startswith("server:") for n in names)
        c.close()
    finally:
        srv.stop()
        dn.close()


def test_trace_collector_assembles_across_services():
    srv = RpcServer()
    collector = TraceCollector(srv)
    srv.start()
    try:
        t = Tracer.instance()
        exp = SpanExporter(t, "svc-a", srv.address, interval_s=60.0)
        with t.span("a-root") as root:
            with t.span("a-child"):
                ctx = t.inject()
        exp.flush()
        with t.span("b-remote", child_of=ctx):
            pass
        exp.service = "svc-b"
        exp.flush()
        assert exp.exported == 3
        spans = collector.trace(root.trace_id)
        assert {s["name"] for s in spans} == {"a-root", "a-child",
                                              "b-remote"}
        row = next(r for r in collector.recent()
                   if r["traceId"] == root.trace_id)
        assert set(row["services"]) == {"svc-a", "svc-b"}
        assert row["root"] == "a-root"
        exp.stop()
    finally:
        t._export_q = None
        srv.stop()


def test_critical_path_equals_reference():
    """The same span sets reduce to the reference's stage attribution,
    whose micros sum to the root's duration."""
    from ozone_tpu.utils.tracing import critical_path as ref_cp

    rng = np.random.default_rng(5)
    for _ in range(20):
        spans = [{"spanId": "r", "parentId": "", "name": "root",
                  "start": 0.0, "durationMs": 100.0}]
        for i in range(int(rng.integers(1, 8))):
            parent = spans[int(rng.integers(0, len(spans)))]
            p0 = parent["start"]
            p1 = p0 + parent["durationMs"] / 1e3
            s0 = float(rng.uniform(p0, p1))
            spans.append({"spanId": f"s{i}", "parentId": parent["spanId"],
                          "name": f"stage{int(rng.integers(0, 4))}",
                          "start": s0,
                          "durationMs": float(rng.uniform(0, (p1 - s0) * 1e3))})
        got = critical_path(spans)
        assert got == ref_cp(spans)
        assert abs(sum(st["micros"] for st in got) - 100_000) <= len(got)


def test_daemon_spans_ship_to_metadata_collector(tmp_path):
    """Live daemons: a key write's datanode and OM spans ship to the
    scm-om collector under the trace id the client propagated."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient

    meta = ScmOmDaemon(tmp_path / "om.db", block_size=4 * 4096,
                       container_size=1024 * 1024, stale_after_s=1000.0,
                       dead_after_s=2000.0, device="cpu")
    meta.start()
    dns = [DatanodeDaemon(tmp_path / f"dn{i}", f"dn{i}", meta.address,
                          heartbeat_interval_s=0.2, device="cpu")
           for i in range(5)]
    for d in dns:
        d.start()
    clients = DatanodeClientFactory()
    oz = OzoneClient(RemoteOmClient(meta.address, clients=clients),
                     clients, device="cpu")
    try:
        b = oz.create_volume("tv").create_bucket("tb", replication=EC)
        t = Tracer.instance()
        with t.span("client-write") as root:
            b.write_key("k", np.zeros(20_000, np.uint8))
        deadline = time.monotonic() + 10
        spans = []
        while time.monotonic() < deadline:
            for d in dns:
                d.trace_exporter.flush()
            meta.trace_exporter.flush()
            spans = meta.trace_collector.trace(root.trace_id)
            names = {s["name"] for s in spans}
            if "client-write" in names and any(
                    "OmService" in n for n in names) and any(
                    "Datanode" in n for n in names):
                break
            time.sleep(0.2)
        names = {s["name"] for s in spans}
        assert "client-write" in names, names
        assert any("OmService" in n for n in names), names
        assert any("Datanode" in n for n in names), names
        assert all(s.get("service") for s in spans)
    finally:
        oz.clients.close()
        oz.om.close()
        for d in dns:
            d.stop()
        meta.stop()
        Tracer.instance()._export_q = None


# ----------------------------------------------------------- http extras
def test_sample_stacks_sees_worker_thread():
    stop = threading.Event()

    def spin_about():
        while not stop.is_set():
            time.sleep(0.001)

    t = threading.Thread(target=spin_about, name="prof-victim")
    t.start()
    try:
        out = sample_stacks(duration_s=0.3, interval_s=0.01)
    finally:
        stop.set()
        t.join()
    assert "spin_about" in out
    line = next(ln for ln in out.splitlines() if "spin_about" in ln)
    assert line.rsplit(" ", 1)[1].isdigit()
    assert ";" in line


def test_thread_dump_lists_threads():
    out = thread_dump()
    assert "Thread " in out
    assert "MainThread" in out


@pytest.fixture
def daemon(tmp_path):
    from ozone_tpu_torch.net.daemons import ScmOmDaemon

    d = ScmOmDaemon(tmp_path / "om.db", stale_after_s=1000.0,
                    dead_after_s=2000.0, http_port=0, device="cpu")
    d.start()
    yield d
    d.stop()
    Tracer.instance()._export_q = None


def test_live_reconfiguration_over_http(daemon):
    addr = daemon.http.address
    keys = {p["key"] for p in json.load(_get(addr, "/reconfig/properties"))}
    assert keys == {"ozone.scm.stale.node.interval",
                    "ozone.scm.dead.node.interval", "ozone.om.block.size"}
    r = json.load(_get(
        addr, "/reconfig?key=ozone.scm.stale.node.interval&value=123.5"))
    assert r["new"] == 123.5
    assert daemon.scm.nodes.stale_after == 123.5
    json.load(_get(addr, "/reconfig?key=ozone.scm.dead.node.interval"
                         "&value=456"))
    assert daemon.scm.nodes.dead_after == 456.0
    json.load(_get(addr, "/reconfig?key=ozone.om.block.size&value=65536"))
    assert daemon.om.block_size == 65536
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(addr, "/reconfig?key=not.a.key&value=1")
    assert ei.value.code == 400


def test_prof_and_stacks_endpoints(daemon):
    addr = daemon.http.address
    out = _get(addr, "/prof?duration=0.2&interval=0.02").read().decode()
    assert out == "" or all(
        ln.rsplit(" ", 1)[1].isdigit() for ln in out.splitlines())
    dump = _get(addr, "/stacks").read().decode()
    assert "Thread " in dump
    status = json.load(_get(addr, "/status"))
    assert status["address"] == daemon.address
    daemon.om.create_volume("promvol")
    prom = _get(addr, "/prom").read().decode()
    assert "# TYPE om_write_ops counter" in prom
    assert "# TYPE om_CreateVolume histogram" in prom


def test_recon_ui_served(tmp_path):
    from ozone_tpu_torch.om.om import OzoneManager
    from ozone_tpu_torch.recon.recon import ReconServer
    from ozone_tpu_torch.scm.scm import StorageContainerManager

    scm = StorageContainerManager(stale_after_s=1e6, dead_after_s=2e6)
    for i in range(3):
        scm.register_datanode(f"dn{i}")
        scm.heartbeat(f"dn{i}", container_report=[])
    om = OzoneManager(tmp_path / "om.db", scm, device="cpu")
    srv = ReconServer(om, scm)
    srv.start()
    try:
        html = _get(srv.address, "/").read().decode()
        assert "Recon" in html and "viz-root" in html and "badge" in html
        s = json.load(_get(srv.address, "/api/summary"))
        assert len(s["nodes"]) == 3
        json.load(_get(srv.address, "/api/filesizes"))
        assert json.load(_get(srv.address, "/api/pipelines")) == []
    finally:
        srv.stop()
        om.close()


# ---------------------------------------------------------------- insight
@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = MiniOzoneCluster(tmp_path_factory.mktemp("insight"), num_datanodes=5,
                         block_size=8 * 4096, container_size=4 * 1024 * 1024,
                         stale_after_s=1000.0, dead_after_s=2000.0,
                         device="cpu")
    yield c
    c.close()


@pytest.fixture(scope="module")
def insight(cluster):
    server = RpcServer()
    InsightService(server, "test-daemon")
    server.start()
    cli = InsightClient(server.address)
    yield cli
    cli.close()
    server.stop()


def test_insight_points_catalog(insight):
    from ozone_tpu.utils.insight import INSIGHT_POINTS as REF_POINTS

    got = insight.list_points()
    assert got["component"] == "test-daemon"
    points = got["points"]
    assert "scm.replication-manager" in points
    assert "om.key-manager" in points
    for p in points.values():
        assert p["loggers"] and p["metrics"]
        assert all(lg.startswith("ozone_tpu_torch.") for lg in p["loggers"])
    assert set(points) == set(INSIGHT_POINTS) == set(REF_POINTS)
    # the same catalog over the port's loggers
    for name, p in points.items():
        assert [lg.replace("ozone_tpu_torch.", "ozone_tpu.")
                for lg in p["loggers"]] == REF_POINTS[name]["loggers"]


def test_insight_metrics(cluster, insight):
    cluster.client().create_volume("insvol")
    regs = insight.metrics()["registries"]
    assert "om" in regs and "scm" in regs
    assert regs["om"].get("write_ops", 0) >= 1
    assert regs["scm"].get("heartbeats", 0) >= 0


def test_insight_logs_and_level(insight):
    log = logging.getLogger("ozone_tpu_torch.scm.replication_manager")
    insight.set_log_level("ozone_tpu_torch.scm.replication_manager", "DEBUG")
    log.debug("insight-test-debug-message %d", 42)
    records = insight.logs(n=50, logger="ozone_tpu_torch.scm")
    assert any("insight-test-debug-message 42" in r["message"]
               for r in records)
    records = insight.logs(n=50, logger="ozone_tpu_torch.scm",
                           level="ERROR")
    assert not any("insight-test-debug-message" in r["message"]
                   for r in records)
    log.setLevel(logging.NOTSET)


def test_ring_handler_bounded():
    h = RingLogHandler(capacity=10)
    for i in range(100):
        h.emit(logging.LogRecord("x", logging.INFO, "", 0, f"m{i}", (),
                                 None))
    assert len(h.records) == 10
    assert h.tail(5)[-1]["message"] == "m99"


def test_admin_reconfig_cli(tmp_path, capsys):
    from ozone_tpu_torch.net.daemons import ScmOmDaemon
    from ozone_tpu_torch.tools.cli import main as cli_main

    meta = ScmOmDaemon(tmp_path / "om.db", stale_after_s=1e6,
                       dead_after_s=2e6, http_port=0, device="cpu")
    meta.start()
    try:
        http = meta.http.address
        assert cli_main(["admin", "reconfig", "properties",
                         "--http", http]) == 0
        props = json.loads(capsys.readouterr().out)
        assert isinstance(props, list) and props
        name = props[0]["key"]
        assert cli_main(["admin", "reconfig", "set", name,
                         "--http", http, "--value", "123"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["key"] == name and float(out["new"]) == 123
        assert cli_main(["admin", "reconfig", "properties"]) == 2
    finally:
        meta.stop()
        Tracer.instance()._export_q = None


# ------------------------------------------------------------------ audit
def test_parse_line_tolerates_logging_prefix():
    rec = parse_line(
        'INFO 2026-07-30 audit.om: {"ts": 1.0, "user": "alice", '
        '"action": "CreateVolume", "params": {}, "result": "SUCCESS"}')
    assert rec["action"] == "CreateVolume" and rec["user"] == "alice"
    assert parse_line("not json at all") is None
    assert parse_line('{"no_action": true}') is None


def test_roundtrip_through_real_audit_logger(tmp_path):
    logfile = tmp_path / "audit.log"
    handler = logging.FileHandler(logfile)
    logger = logging.getLogger("audit.test-component")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        al = AuditLogger("test-component")
        al.log("CreateVolume", {"volume": "v"}, user="alice")
        al.log("CreateBucket", {"bucket": "b"}, user="alice")
        al.log("DeleteKey", {"key": "k"}, ok=False, error="nope",
               user="bob")
        handler.flush()
    finally:
        logger.removeHandler(handler)
        handler.close()
    recs = list(parse_file(logfile))
    assert [r["action"] for r in recs] == [
        "CreateVolume", "CreateBucket", "DeleteKey"]
    assert aggregate(recs, by="user")[0] == {"user": "alice", "count": 2}
    fails = failures(recs)
    assert len(fails) == 1 and fails[0]["error"] == "nope"
    only_bob = list(filter_records(recs, user="bob"))
    assert len(only_bob) == 1 and only_bob[0]["action"] == "DeleteKey"


def test_cli_top_and_failures(tmp_path, capsys):
    from ozone_tpu_torch.tools.cli import main

    logfile = tmp_path / "a.log"
    lines = [json.dumps({"ts": float(i), "user": "u", "action": "Put",
                         "params": {}, "result": "SUCCESS"})
             for i in range(5)]
    lines.append(json.dumps({"ts": 9.0, "user": "u", "action": "Get",
                             "params": {}, "result": "FAILURE",
                             "error": "boom"}))
    logfile.write_text("\n".join(lines) + "\n")
    assert main(["audit", "top", str(logfile)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out[0] == {"action": "Put", "count": 5}
    assert main(["audit", "failures", str(logfile)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out) == 1 and out[0]["error"] == "boom"
    assert main(["audit", "parse", str(tmp_path / "missing.log")]) == 1


def _audited(make_cluster, root, seed):
    """Audit records of a seeded request sequence on one package's
    minicluster (the timestamps dropped)."""
    records: list[dict] = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(json.loads(record.getMessage()))

    logger = logging.getLogger("audit.om")
    h = Grab(level=logging.INFO)
    old = logger.level
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    c = make_cluster(root)
    try:
        rng = np.random.default_rng(seed)
        oz = c.client()
        v = oz.create_volume("v")
        b = v.create_bucket("b", replication=EC)
        names = [f"k{int(x)}" for x in rng.integers(0, 50, 5)]
        for name in names:
            b.write_key(name, rng.integers(0, 256, int(rng.integers(
                1, 20_000)), dtype=np.uint8))
        for name in names[:2]:
            try:
                oz.om.delete_key("v", "b", name)
            except Exception:  # noqa: BLE001 - a repeated name's second delete
                pass
        for bad in (lambda: oz.om.create_volume("v"),
                    lambda: oz.om.delete_key("v", "b", "missing"),
                    lambda: oz.om.create_bucket("v", "b", EC)):
            try:
                bad()
            except Exception:  # noqa: BLE001 - the refusals are audited
                pass
    finally:
        logger.removeHandler(h)
        logger.setLevel(old)
        c.close()
    for r in records:
        r.pop("ts")
        for k in ("client_id", "key_id", "object_id", "created",
                  "modified", "ts", "mtime", "ctime", "update_id"):
            r["params"].pop(k, None)
    return records


@pytest.mark.parametrize("seed", [0, 1])
def test_audit_records_equal_reference(tmp_path, seed):
    """The same seeded requests through both packages' OM: the same
    audit records, action, result, error code and the scalar params
    that do not depend on time or process-wide ids."""
    def port(root):
        return MiniOzoneCluster(root, num_datanodes=5, block_size=8 * 4096,
                                container_size=4 * 1024 * 1024,
                                stale_after_s=1000.0, dead_after_s=2000.0,
                                device="cpu")

    def ref(root):
        return RefCluster(root, num_datanodes=5, block_size=8 * 4096,
                          container_size=4 * 1024 * 1024,
                          stale_after_s=1000.0, dead_after_s=2000.0)

    got = _audited(port, tmp_path / "port", seed)
    want = _audited(ref, tmp_path / "ref", seed)
    assert [(r["action"], r["result"], r.get("error")) for r in got] == \
        [(r["action"], r["result"], r.get("error")) for r in want]
    assert got == want
    assert {r["result"] for r in got} == {"SUCCESS", "FAILURE"}


def test_http_server_stops_unstarted():
    """A departure: a service HTTP server stopped before it started
    returns at once (the reference's `shutdown()` waits for a
    `serve_forever` that never ran)."""
    from ozone_tpu_torch.utils.http_server import ServiceHttpServer

    srv = ServiceHttpServer("idle")
    t = threading.Thread(target=srv.stop, daemon=True)
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()
    started = ServiceHttpServer("live")
    started.start()
    assert json.load(_get(started.address, "/status")) == {}
    started.stop()
