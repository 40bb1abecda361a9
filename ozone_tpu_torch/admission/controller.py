"""Per-hop admission controllers: a bounded in-flight gate, tenant
buckets and SLO shedding.

Port of `ozone_tpu/admission/controller.py`. One `AdmissionController`
per service hop (`gateway`, `om`, `scm`, `dn`), got or made through
`controller(hop)` so every entry point of a process shares its
accounting. Three gates, each with its own per-hop, per-reason refusal
counter in the `admission` registry:

- `InflightGate`: past `queue_limit` requests admitted at once, a new
  one is answered SERVER_BUSY at once instead of queuing without bound;
- per-tenant token buckets (`admission/bucket.py`);
- the SLO shedder (`admission/shed.py`): bulk work is refused while live
  signals are over budget.

The S3 gateway (hop `gateway`) admits and charges each request; the
RPC servers of the OM (`om`), SCM (`scm`) and datanode (`dn`) admit
every call through `net/rpc.RpcServer.add_service(..., admission=)`,
with their liveness verbs exempt, and the OM charges each caller's
tenant bucket. A refusal raises `StorageError(SERVER_BUSY, ...)` with a
`retry_after_s=<float>` hint. The code is not a transport fault: clients
back off and retry the same peer, and no breaker trips.

Knobs (all `OZONE_TPU_ADMIT_*`, the reference's; the defaults turn the
buckets and the shedder off and bound the gate generously):

=============================== ======= ===================================
knob                            default meaning
=============================== ======= ===================================
OZONE_TPU_ADMIT_OPS             0       per-tenant ops/s (0 = unlimited)
OZONE_TPU_ADMIT_BYTES           0       per-tenant bytes/s (0 = unlimited)
OZONE_TPU_ADMIT_BURST_S         1.0     bucket burst window, seconds
OZONE_TPU_ADMIT_QUEUE           256     per-hop in-flight bound (0 = off)
OZONE_TPU_ADMIT_SLO_P99_MS      0       shed bulk past this client P99
OZONE_TPU_ADMIT_SLO_CODEC_DEPTH 0       shed bulk past this codec backlog
OZONE_TPU_ADMIT_RETRY_AFTER_S   0.25    hint for queue and SLO refusals
OZONE_TPU_ADMIT_CLASS           ""      tenant QoS map, "t1=bulk,t2=..."
=============================== ======= ===================================

A per-hop override appends the upper-cased hop name:
`OZONE_TPU_ADMIT_QUEUE_GATEWAY`, `OZONE_TPU_ADMIT_OPS_OM`, ...
The reference's `OZONE_TPU_ADMIT_SLO_MESH_DEPTH` comes with the port's
mesh.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import threading
from typing import Iterable, Optional

from ozone_tpu_torch.admission.bucket import TenantBuckets
from ozone_tpu_torch.admission.shed import SloShedder
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.config import env_float, env_int
from ozone_tpu_torch.utils.metrics import MetricsRegistry, registry

#: the StorageError code of every admission refusal
SERVER_BUSY = "SERVER_BUSY"

#: every admission signal, in one registry
METRICS: MetricsRegistry = registry("admission")

_RETRY_AFTER_RE = re.compile(r"retry_after_s=([0-9][0-9.]*)")


def retry_after_hint(msg: object) -> Optional[float]:
    """The `retry_after_s=<float>` hint of a SERVER_BUSY message (or an S3
    SlowDown body), capped at 30 s; None when absent or garbled."""
    m = _RETRY_AFTER_RE.search(str(msg))
    if not m:
        return None
    try:
        return min(30.0, float(m.group(1)))
    except ValueError:
        return None


def busy_error(hop: str, reason: str, retry_after_s: float) -> StorageError:
    return StorageError(
        SERVER_BUSY,
        f"{hop} overloaded ({reason}); retry_after_s={retry_after_s:.3f}")


class InflightGate:
    """An explicit bounded request queue: admits up to `limit` requests at
    once and refuses the rest at once. limit <= 0 turns it off."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._n = 0
        self._lock = threading.Lock()

    def try_enter(self) -> bool:
        if self.limit <= 0:
            return True
        with self._lock:
            if self._n >= self.limit:
                return False
            self._n += 1
            return True

    def exit(self) -> None:
        if self.limit <= 0:
            return
        with self._lock:
            self._n -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._n


class AdmissionController:
    """One hop's front door: `admit()` is the bounded gate (wrap the
    whole request in it); `charge(tenant, ...)` the identity-aware gate
    (buckets, then the shedder) for hops that know who is asking."""

    def __init__(self, hop: str, *, ops_per_s: float = 0.0,
                 bytes_per_s: float = 0.0, burst_s: float = 1.0,
                 queue_limit: int = 0,
                 shedder: Optional[SloShedder] = None,
                 retry_after_s: float = 0.25,
                 exempt: Iterable[str] = ()):
        self.hop = hop
        #: verbs never refused (control-plane traffic: heartbeats and
        #: registrations; refusing those turns overload into a dead-node
        #: storm)
        self.exempt = frozenset(exempt)
        self.buckets = TenantBuckets(ops_per_s, bytes_per_s, burst_s)
        self.gate = InflightGate(queue_limit)
        self.shedder = shedder or SloShedder()
        self.retry_after_s = retry_after_s

    @property
    def enabled(self) -> bool:
        return (self.gate.limit > 0 or self.buckets.enabled
                or self.shedder.enabled)

    def snapshot(self) -> dict:
        """The hop's knobs, live in-flight depth, tenants seen and shed
        state (Recon's /api/admission)."""
        return {
            "hop": self.hop,
            "enabled": self.enabled,
            "queue_limit": self.gate.limit,
            "inflight": self.gate.inflight,
            "ops_per_s": self.buckets.ops_per_s,
            "bytes_per_s": self.buckets.bytes_per_s,
            "burst_s": self.buckets.burst_s,
            "tenants": self.buckets.tenants(),
            "shed": self.shedder.snapshot(),
        }

    def _reject(self, reason: str, retry_after_s: float) -> StorageError:
        METRICS.counter(f"{self.hop}_rejected_total").inc()
        METRICS.counter(f"{self.hop}_rejected_{reason}").inc()
        return busy_error(self.hop, reason, retry_after_s)

    @contextlib.contextmanager
    def admit(self, verb: str = ""):
        """Bounded admission of one request: raises SERVER_BUSY when the
        hop's in-flight bound is reached, else tracks the request until
        it completes. An exempt verb always passes, uncounted."""
        if verb in self.exempt:
            yield
            return
        if not self.gate.try_enter():
            raise self._reject("queue", self.retry_after_s)
        METRICS.counter(f"{self.hop}_admitted").inc()
        METRICS.gauge(f"{self.hop}_inflight").set(self.gate.inflight)
        try:
            yield
        finally:
            self.gate.exit()
            METRICS.gauge(f"{self.hop}_inflight").set(self.gate.inflight)

    def charge(self, tenant: str, nbytes: int = 0,
               priority: str = "interactive") -> None:
        """Tenant buckets, then the SLO shedder; raises SERVER_BUSY with a
        Retry-After hint on refusal."""
        reason, wait = self.buckets.try_admit(tenant, nbytes)
        if reason is not None:
            METRICS.counter(f"{self.hop}_tenant_rejections").inc()
            raise self._reject(reason, max(wait, 0.001))
        shed = self.shedder.should_shed(priority)
        if shed is not None:
            raise self._reject(shed, self.retry_after_s)


# ------------------------------------------------------ hop controllers
_controllers: dict[str, AdmissionController] = {}
_controllers_lock = threading.Lock()


def _hop_knob_f(hop: str, suffix: str, default: float) -> float:
    base = env_float(f"OZONE_TPU_ADMIT_{suffix}", default)
    return env_float(f"OZONE_TPU_ADMIT_{suffix}_{hop.upper()}", base)


def _hop_knob_i(hop: str, suffix: str, default: int) -> int:
    base = env_int(f"OZONE_TPU_ADMIT_{suffix}", default)
    return env_int(f"OZONE_TPU_ADMIT_{suffix}_{hop.upper()}", base)


def controller(hop: str,
               exempt: Iterable[str] = ()) -> AdmissionController:
    """Get or make the hop's controller, its knobs read from the
    environment when it is made (`reset_for_tests` drops the cache).
    `exempt` applies only when the controller is made."""
    with _controllers_lock:
        ctl = _controllers.get(hop)
        if ctl is None:
            ctl = _controllers[hop] = AdmissionController(
                hop,
                ops_per_s=_hop_knob_f(hop, "OPS", 0.0),
                bytes_per_s=_hop_knob_f(hop, "BYTES", 0.0),
                burst_s=_hop_knob_f(hop, "BURST_S", 1.0),
                queue_limit=_hop_knob_i(hop, "QUEUE", 256),
                shedder=SloShedder(
                    p99_ms=_hop_knob_f(hop, "SLO_P99_MS", 0.0),
                    codec_depth=_hop_knob_i(hop, "SLO_CODEC_DEPTH", 0),
                ),
                retry_after_s=_hop_knob_f(hop, "RETRY_AFTER_S", 0.25),
                exempt=exempt,
            )
        return ctl


def controllers() -> dict[str, AdmissionController]:
    """The installed controllers (Recon's /api/admission)."""
    with _controllers_lock:
        return dict(_controllers)


def reset_for_tests() -> None:
    """Drop every controller and the tenant-class cache, so the next
    lookup reads the OZONE_TPU_ADMIT_* environment again."""
    global _class_map
    with _controllers_lock:
        _controllers.clear()
        _class_map = None


# ------------------------------------------- tenant identity, QoS class
#: (tenant, qos) of the request served on this thread, set by the gateway
#: after auth so the client, the EC writer and reader and the codec
#: service below inherit the tenant's QoS class
_tenant_ctx: contextvars.ContextVar[Optional[tuple]] = \
    contextvars.ContextVar("ozone_tpu_torch_admit_tenant", default=None)

_class_map: Optional[dict[str, str]] = None


def qos_class_for(tenant: str) -> str:
    """The tenant's QoS class from OZONE_TPU_ADMIT_CLASS
    ("tenantA=bulk,tenantB=interactive"); interactive by default."""
    global _class_map
    m = _class_map
    if m is None:
        m = {}
        for part in os.environ.get("OZONE_TPU_ADMIT_CLASS", "").split(","):
            name, _, cls = part.partition("=")
            if name.strip() and cls.strip() in ("interactive", "bulk"):
                m[name.strip()] = cls.strip()
        _class_map = m
    return m.get(tenant, "interactive")


@contextlib.contextmanager
def tenant_context(tenant: str, qos: Optional[str] = None):
    """Bind a request's tenant (and its QoS class) to this thread for one
    operation."""
    tok = _tenant_ctx.set((tenant, qos or qos_class_for(tenant)))
    try:
        yield
    finally:
        _tenant_ctx.reset(tok)


def current_tenant() -> Optional[str]:
    """The ambient tenant (the gateway's request identity), or None."""
    ctx = _tenant_ctx.get()
    return ctx[0] if ctx is not None else None


def ambient_qos(default: str = "interactive") -> str:
    """The ambient tenant's QoS class, or `default` outside any tenant
    context: how OzoneClient carries the gateway's identity into the
    codec service's weighted-fair lanes."""
    ctx = _tenant_ctx.get()
    return ctx[1] if ctx is not None else default
