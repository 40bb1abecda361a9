"""The port's admission control against `ozone_tpu`'s, without a cluster.

Each scenario runs the same calls on both packages' `admission` and
returns what it saw: tenant buckets (ops and bytes, two tenants), the
bounded in-flight gate, the SLO shedder over the codec backlog and the
client P99 by priority, the tenant QoS class map and the ambient tenant
context, the per-hop knobs as `controller(hop)` reads them, and the
refusal messages with their hints. The observations must be equal
(exact; a bucket's wait, which follows the clock, is kept as its sign).
The gateway maps every access id to one tenant, so the tenant
dimension is held here, at the controller.
"""

import pytest

from ozone_tpu import admission as j_admission
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.utils.metrics import registry as j_registry
from ozone_tpu_torch import admission
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.metrics import registry as p_registry

SIDES = ((admission, p_registry, StorageError),
         (j_admission, j_registry, JStorageError))

#: every knob the port reads, each set to a value of its own
KNOBS = {"OPS": "3", "BYTES_GATEWAY": "5000", "BURST_S": "2",
         "QUEUE_OM": "7", "SLO_P99_MS_GATEWAY": "40",
         "SLO_CODEC_DEPTH": "9", "RETRY_AFTER_S_GATEWAY": "1.5",
         "CLASS": "batchco=bulk, liveco = interactive,bad=fast"}


def _admit(result):
    """A bucket's answer with the wait kept as its sign."""
    reason, wait = result
    return reason, wait > 0.0


def tenant_buckets(adm, reg, err):
    ops = adm.TenantBuckets(ops_per_s=2.0, burst_s=1.0)
    out = [_admit(ops.try_admit("noisy")) for _ in range(3)]
    out.append(_admit(ops.try_admit("quiet")))
    byt = adm.TenantBuckets(bytes_per_s=1000.0, burst_s=1.0)
    # one request past the burst is admitted once, then the tenant waits
    out += [_admit(byt.try_admit("t", nbytes=50_000)),
            _admit(byt.try_admit("t", nbytes=100)),
            _admit(byt.try_admit("u", nbytes=100)),
            _admit(byt.try_admit("t")), adm.TenantBuckets().enabled]
    return out


def inflight_gate(adm, reg, err):
    g = adm.InflightGate(2)
    out = [g.try_enter(), g.try_enter(), g.try_enter(), g.inflight]
    g.exit()
    out += [g.try_enter(), g.inflight]
    off = adm.InflightGate(0)
    return out + [all(off.try_enter() for _ in range(10)), off.inflight]


def controller_charge(adm, reg, err):
    """Per-tenant refusals through a controller, with the counters."""
    ctl = adm.AdmissionController("tenanthop", ops_per_s=1.0, burst_s=1.0)
    out = []
    for tenant in ("a", "a", "b", "b", "a"):
        try:
            ctl.charge(tenant)
            out.append(tenant)
        except err as e:
            out.append((e.code, str(e).split(";")[0],
                        adm.retry_after_hint(str(e)) > 0.0))
    m = adm.METRICS
    return out + [m.counter("tenanthop_tenant_rejections").value,
                  m.counter("tenanthop_rejected_ops").value]


def queue_gate(adm, reg, err):
    ctl = adm.AdmissionController("queuehop", queue_limit=1,
                                  retry_after_s=0.75)
    out = []
    with ctl.admit():
        try:
            with ctl.admit():
                out.append("admitted")
        except err as e:
            out.append((e.code, str(e)))
    with ctl.admit():
        out.append(ctl.gate.inflight)
    m = adm.METRICS
    return out + [ctl.gate.inflight,
                  m.counter("queuehop_rejected_queue").value,
                  m.counter("queuehop_rejected_total").value,
                  m.counter("queuehop_admitted").value]


def slo_shed(adm, reg, err):
    """The shedder by signal and priority, alone and in a controller."""
    depth = reg("codec.service").gauge("queue_depth")
    out = []
    try:
        s = adm.SloShedder(codec_depth=4, cache_s=0.0)
        for d in (10, 4, 0):
            depth.set(d)
            out += [s.over_budget(), s.should_shed("bulk"),
                    s.should_shed("interactive")]
        # the histograms are the process's: a 1 us budget is crossed and
        # a 1e9 ms one is not, whatever else the process recorded
        reg("client.ops").histogram("get_seconds").observe(0.01)
        p99 = adm.SloShedder(p99_ms=0.001, cache_s=0.0)
        out += [p99.should_shed("bulk"), p99.should_shed("interactive"),
                adm.SloShedder(p99_ms=1e9, cache_s=0.0).should_shed("bulk"),
                adm.SloShedder().enabled, s.enabled]
        ctl = adm.AdmissionController("shedhop", shedder=p99,
                                      retry_after_s=0.5)
        ctl.charge("t", priority="interactive")
        try:
            ctl.charge("t", priority="bulk")
        except err as e:
            out.append((e.code, str(e)))
        out.append(adm.METRICS.counter("shedhop_rejected_slo_p99").value)
    finally:
        depth.set(0)
    return out


def class_map(adm, reg, err):
    """The tenant QoS class map and the ambient context, nested."""
    out = [adm.qos_class_for(t) for t in ("batchco", "liveco", "bad", "x")]
    out.append(adm.ambient_qos("bulk"))
    with adm.tenant_context("batchco"):
        out.append(adm.ambient_qos())
        with adm.tenant_context("liveco"):
            out.append(adm.ambient_qos("bulk"))
        with adm.tenant_context("x", qos="bulk"):
            out.append(adm.ambient_qos())
        out.append(adm.ambient_qos())
    return out + [adm.ambient_qos()]


def hop_knobs(adm, reg, err):
    """Each hop's controller as the OZONE_TPU_ADMIT_* knobs make it."""
    out = []
    for hop in ("gateway", "om"):
        c = adm.controller(hop)
        out.append((c.hop, c.buckets.ops_per_s, c.buckets.bytes_per_s,
                    c.buckets.burst_s, c.gate.limit, c.shedder.p99_ms,
                    c.shedder.codec_depth, c.retry_after_s))
    return out + [adm.controller("gateway") is adm.controller("gateway")]


def hints(adm, reg, err):
    e = adm.busy_error("om", "ops", 0.5)
    return [e.code, str(e), adm.SERVER_BUSY, adm.retry_after_hint(str(e)),
            adm.retry_after_hint("retry_after_s=999"),
            adm.retry_after_hint("no hint here"),
            adm.retry_after_hint("<Message>gateway overloaded (queue); "
                                 "retry_after_s=0.250</Message>")]


def exempt_verbs(adm, reg, err):
    """`controller(hop, exempt=...)` and `admit(verb)`: an exempt verb
    passes a full gate uncounted; the exemption is fixed at creation."""
    m = reg("admission")
    base = [m.counter(n).value for n in ("dn_admitted", "dn_rejected_queue")]
    c = adm.controller("dn", exempt=frozenset({"Echo"}))
    out = [sorted(c.exempt), adm.controller("dn", exempt={"Other"}) is c]
    with c.admit("WriteChunk"):
        try:
            with c.admit("ReadChunk"):
                out.append("second admitted")
        except err as e:
            out.append(e.code)
        with c.admit("Echo"):
            out.append(c.gate.inflight)
    return out + [c.gate.inflight] + [
        m.counter(n).value - b
        for n, b in zip(("dn_admitted", "dn_rejected_queue"), base)]


@pytest.mark.parametrize("scenario", [
    tenant_buckets, inflight_gate, controller_charge, queue_gate, slo_shed,
    class_map, hop_knobs, hints, exempt_verbs], ids=lambda f: f.__name__)
def test_admission_matches_reference(monkeypatch, scenario):
    for name, value in KNOBS.items():
        monkeypatch.setenv(f"OZONE_TPU_ADMIT_{name}", value)
    got = []
    try:
        for adm, reg, err in SIDES:
            adm.reset_for_tests()
            got.append(scenario(adm, reg, err))
    finally:
        for adm, _, _ in SIDES:
            adm.reset_for_tests()
    assert got[0] == got[1]


# ------------------------------------------------- RPC-hop admission
def test_rpc_server_admits_before_the_handler(monkeypatch):
    """A service added with a controller answers SERVER_BUSY past its
    in-flight bound, before its handler runs; an exempt verb still
    passes; the calls of a service without one are never refused."""
    import threading

    from ozone_tpu_torch.net.rpc import RpcChannel, RpcServer

    monkeypatch.setenv("OZONE_TPU_ADMIT_QUEUE_T", "1")
    admission.reset_for_tests()
    ctl = admission.controller("t", exempt={"Ping"})
    entered, release, ran = threading.Event(), threading.Event(), []

    def slow(req):
        entered.set()
        release.wait(10)
        return req

    def fast(req):
        ran.append(bytes(req))
        return req

    server = RpcServer()
    server.add_service("svc", {"Slow": slow, "Fast": fast, "Ping": fast},
                       admission=ctl)
    server.add_service("free", {"Fast": fast})
    server.start()
    ch = RpcChannel(server.address)
    try:
        t = threading.Thread(target=lambda: ch.call("svc", "Slow", b"s"))
        t.start()
        assert entered.wait(10)
        with pytest.raises(StorageError) as ei:
            ch.call("svc", "Fast", b"refused")
        assert ei.value.code == admission.SERVER_BUSY
        assert "retry_after_s=" in ei.value.msg and ran == []
        assert bytes(ch.call("svc", "Ping", b"p")) == b"p"
        assert bytes(ch.call("free", "Fast", b"f")) == b"f"
        release.set()
        t.join(10)
        assert bytes(ch.call("svc", "Fast", b"ok")) == b"ok"
        m = p_registry("admission")
        assert m.counter("t_rejected_queue").value >= 1
    finally:
        release.set()
        ch.close()
        server.stop()
        admission.reset_for_tests()


def test_services_admit_with_the_reference_exemptions(tmp_path):
    """The datanode, SCM and OM services put every verb behind their hop's
    controller, with the reference's exempt verbs."""
    from ozone_tpu_torch.net.daemons import ScmOmDaemon
    from ozone_tpu_torch.net.dn_service import DatanodeRpcService
    from ozone_tpu_torch.net.rpc import RpcServer
    from ozone_tpu_torch.storage.datanode import Datanode

    admission.reset_for_tests()
    meta = ScmOmDaemon(tmp_path / "om.db")
    server = RpcServer()
    dn = Datanode(tmp_path / "dn0", "dn0")
    DatanodeRpcService(dn, server)
    try:
        hops = {}
        for srv in (meta.server, server):
            for key, ctl in srv._admission.items():
                hops.setdefault(ctl.hop, (ctl, set()))[1].add(key.rsplit("/", 1)[1])
        assert sorted(hops) == ["dn", "om", "scm"]
        assert hops["dn"][0].exempt == {"Echo", "GetDatapathInfo"}
        assert hops["scm"][0].exempt == {"Register", "Heartbeat",
                                         "NodeAddresses", "Status"}
        assert hops["om"][0].exempt == {"GetShardMap"}
        assert {"WriteChunk", "ReadChunks", "WriteChunksCommit"} <= hops["dn"][1]
        assert {"AllocateBlock", "Heartbeat"} <= hops["scm"][1]
        assert {"CreateVolume", "GetShardMap"} <= hops["om"][1]
    finally:
        server.stop()
        dn.close()
        meta.server.stop()
        admission.reset_for_tests()


def test_om_pushback_is_backoff_not_failure(tmp_path):
    """A SERVER_BUSY refusal from the OM's tenant bucket is absorbed by the
    client's retry loop: a backoff to the hinted floor on the same replica,
    so a paced-down caller still succeeds on every op."""
    from ozone_tpu_torch.client import resilience
    from ozone_tpu_torch.testing.minicluster import MiniOzoneHACluster

    c = MiniOzoneHACluster(tmp_path, num_meta=1, num_datanodes=1,
                           device="cpu")
    try:
        oz = c.client()
        m = p_registry("admission")
        rej = m.counter("om_rejected_ops").value
        busy = resilience.METRICS.counter("server_busy").value
        import os

        old = {k: os.environ.get(k) for k in ("OZONE_TPU_ADMIT_OPS_OM",
                                              "OZONE_TPU_ADMIT_BURST_S")}
        os.environ.update(OZONE_TPU_ADMIT_OPS_OM="4",
                          OZONE_TPU_ADMIT_BURST_S="0.5")
        admission.reset_for_tests()
        try:
            for _ in range(8):
                oz.om.list_volumes()
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            admission.reset_for_tests()
        assert m.counter("om_rejected_ops").value > rej
        assert resilience.METRICS.counter("server_busy").value > busy
        oz.om.close()
    finally:
        c.shutdown()
