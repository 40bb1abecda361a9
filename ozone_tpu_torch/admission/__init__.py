"""Overload protection for the object store's request path.

Port of `ozone_tpu/admission/`: admission control answers, per hop,
whether a request may start work now.

- `bucket`: per-tenant ops/s and bytes/s token buckets;
- `shed`: SLO-driven shedding of bulk work off live latency and backlog
  signals;
- `controller`: the per-hop front door combining both with an explicit
  bounded in-flight gate, and the tenant context that carries the
  gateway's identity into the codec service's QoS lanes.

Every refusal is a `StorageError(SERVER_BUSY)` with a
`retry_after_s=...` hint, counted per hop and per reason in the
`admission` registry; the S3 gateway maps it to 503 `SlowDown` with
`Retry-After`. The OM, SCM and datanode RPC servers admit every call
through their hop's controller (`net/rpc.py`), with the liveness verbs
exempt. The knobs are the reference's `OZONE_TPU_ADMIT_*`.
"""

from ozone_tpu_torch.admission.bucket import TenantBuckets
from ozone_tpu_torch.admission.controller import (
    METRICS,
    SERVER_BUSY,
    AdmissionController,
    InflightGate,
    ambient_qos,
    busy_error,
    controller,
    controllers,
    current_tenant,
    qos_class_for,
    reset_for_tests,
    retry_after_hint,
    tenant_context,
)
from ozone_tpu_torch.admission.shed import SloShedder

__all__ = [
    "METRICS",
    "SERVER_BUSY",
    "AdmissionController",
    "InflightGate",
    "SloShedder",
    "TenantBuckets",
    "ambient_qos",
    "busy_error",
    "controller",
    "controllers",
    "current_tenant",
    "qos_class_for",
    "reset_for_tests",
    "retry_after_hint",
    "tenant_context",
]
