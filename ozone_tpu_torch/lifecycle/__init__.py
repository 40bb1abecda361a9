"""Lifecycle subsystem: policy-driven hot->warm tiering and TTL expiry.

Port of `ozone_tpu/lifecycle/`: the control loop that turns per-bucket
age rules into batched re-encode work on the device (replicated -> EC)
plus TTL expirations.

- policy.py: the rule model and the S3 LifecycleConfiguration XML codec;
  rules ride the OM bucket row.
- service.py: the sweeper, term-fenced with a resumable cursor committed
  through the OM, and the needle compaction of the small-object path.
- executor.py: the datapath: many keys per device submission through
  the fused encode+CRC kernel, the commit fenced against concurrent
  overwrites, the old blocks retired through the SCM's deletion log.
"""

from ozone_tpu_torch.lifecycle.executor import TieringExecutor
from ozone_tpu_torch.lifecycle.policy import (
    ACTION_EXPIRE,
    ACTION_TRANSITION,
    LifecycleRule,
    rules_from_s3_xml,
    rules_to_s3_xml,
)
from ozone_tpu_torch.lifecycle.service import LifecycleService

__all__ = [
    "ACTION_EXPIRE",
    "ACTION_TRANSITION",
    "LifecycleRule",
    "LifecycleService",
    "TieringExecutor",
    "rules_from_s3_xml",
    "rules_to_s3_xml",
]
