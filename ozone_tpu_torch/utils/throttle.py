"""Token-bucket bandwidth throttle for background transfers.

A copy of `Throttle.take` from `ozone_tpu/utils/throttle.py` (the role
of the reference's replication bandwidth limits): background work must
not starve foreground client IO on shared disks and links. The lifecycle
sweeper paces its source reads through one instance; `take(n)` blocks
until `n` bytes of budget accumulate. (The admission buckets keep their
own copy of the non-blocking `try_take`.)
"""

from __future__ import annotations

import threading
import time


class Throttle:
    def __init__(self, bytes_per_s: float, burst_s: float = 0.25,
                 metrics=None):
        if bytes_per_s <= 0:
            raise ValueError("bytes_per_s must be positive")
        self.rate = float(bytes_per_s)
        self.burst = self.rate * burst_s
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()
        #: MetricsRegistry that records the throttled sleep milliseconds
        #: and the paced bytes
        self.metrics = metrics

    def take(self, n: int) -> float:
        """Consume `n` bytes of budget, sleeping as needed; returns the
        seconds slept. A request larger than the burst is paid across
        several refills, never refused."""
        slept = 0.0
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate)
            self._t = now
            self._tokens -= n
            if self._tokens < 0:
                slept = -self._tokens / self.rate
        if slept > 0:
            # sleep outside the lock: the deficit stays booked, so a
            # second taker arriving mid-sleep queues behind this one
            time.sleep(slept)
        if self.metrics is not None and slept > 0:
            self.metrics.counter("replication_throttle_ms").inc(
                int(slept * 1000))
        if self.metrics is not None:
            self.metrics.counter("replication_throttled_bytes").inc(n)
        return slept
