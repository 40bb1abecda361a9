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


@pytest.mark.parametrize("scenario", [
    tenant_buckets, inflight_gate, controller_charge, queue_gate, slo_shed,
    class_map, hop_knobs, hints], ids=lambda f: f.__name__)
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
