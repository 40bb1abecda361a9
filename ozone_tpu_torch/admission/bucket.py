"""Per-tenant token buckets: the rate dimension of admission control.

Port of `ozone_tpu/admission/bucket.py`. Two buckets per tenant, ops/s
and bytes/s, consulted without blocking: a refusal comes back at once
with the seconds until the demand would fit (a Retry-After hint), and
books nothing, so a refused tenant leaves its bucket to better-behaved
traffic.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class _Bucket:
    """A virtual-scheduling token bucket (the reference's
    `utils/throttle.Throttle`, its `try_take` only): `rate` units per
    second, at most `rate * burst_s` banked."""

    def __init__(self, rate: float, burst_s: float):
        self.rate = float(rate)
        self.burst = self.rate * burst_s
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, n: float) -> float:
        """Take `n` units if they are there now and return 0.0; else
        return the seconds until they will be, booking nothing."""
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate


class TenantBuckets:
    """tenant -> (ops bucket, bytes bucket), made on first use. A rate of
    0 turns that dimension off; `burst_s` sizes the buckets."""

    def __init__(self, ops_per_s: float = 0.0, bytes_per_s: float = 0.0,
                 burst_s: float = 1.0):
        self.ops_per_s = max(0.0, float(ops_per_s))
        self.bytes_per_s = max(0.0, float(bytes_per_s))
        self.burst_s = max(0.05, float(burst_s))
        self._lock = threading.Lock()
        self._buckets: dict[str, tuple[Optional[_Bucket],
                                       Optional[_Bucket]]] = {}

    @property
    def enabled(self) -> bool:
        return self.ops_per_s > 0 or self.bytes_per_s > 0

    def _get(self, tenant: str) -> tuple[Optional[_Bucket],
                                         Optional[_Bucket]]:
        with self._lock:
            pair = self._buckets.get(tenant)
            if pair is None:
                ops = (_Bucket(self.ops_per_s, self.burst_s)
                       if self.ops_per_s > 0 else None)
                byt = (_Bucket(self.bytes_per_s, self.burst_s)
                       if self.bytes_per_s > 0 else None)
                pair = self._buckets[tenant] = (ops, byt)
            return pair

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._buckets)

    def try_admit(self, tenant: str,
                  nbytes: int = 0) -> tuple[Optional[str], float]:
        """(None, 0.0) when admitted (both dimensions booked), else
        (reason, retry_after_s) with reason "ops" or "bytes"."""
        if not self.enabled:
            return None, 0.0
        ops, byt = self._get(tenant)
        if ops is not None:
            wait = ops.try_take(1.0)
            if wait > 0.0:
                return "ops", wait
        if byt is not None and nbytes > 0:
            # at most one burst window: a single huge request can neither
            # be refused for good nor book a deficit that starves the
            # tenant for minutes
            wait = byt.try_take(min(float(nbytes),
                                    self.bytes_per_s * self.burst_s))
            if wait > 0.0:
                return "bytes", wait
        return None, 0.0
