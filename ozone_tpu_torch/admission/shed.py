"""SLO-driven shedding: refuse bulk work while live signals say the
latency budget is crossed.

Port of `ozone_tpu/admission/shed.py`. The signals are ones the process
already exports: the client PUT and GET P99 (`client.ops` histograms),
the codec service's queue depth (`codec.service`) and the mesh
executor's in-flight depth (the `mesh` registry's `inflight_depth`). The
verdict is cached for a short window; only `bulk` work is shed,
interactive traffic passes.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ozone_tpu_torch.utils.metrics import registry


class SloShedder:
    """Thresholds over live metrics; a threshold of 0 turns its signal
    off."""

    def __init__(self, p99_ms: float = 0.0, codec_depth: int = 0,
                 mesh_depth: int = 0, cache_s: float = 0.1):
        self.p99_ms = max(0.0, float(p99_ms))
        self.codec_depth = max(0, int(codec_depth))
        self.mesh_depth = max(0, int(mesh_depth))
        self.cache_s = cache_s
        self._lock = threading.Lock()
        self._cached: Optional[str] = None
        self._cached_at = 0.0

    @property
    def enabled(self) -> bool:
        return bool(self.p99_ms or self.codec_depth or self.mesh_depth)

    def _evaluate(self) -> Optional[str]:
        if self.p99_ms:
            hist = registry("client.ops")
            for verb in ("put", "get"):
                p99_s = hist.histogram(f"{verb}_seconds").quantile(0.99)
                if p99_s * 1000.0 > self.p99_ms:
                    return "slo_p99"
        if self.codec_depth:
            depth = registry("codec.service").gauge("queue_depth").value
            if depth > self.codec_depth:
                return "slo_codec_depth"
        if self.mesh_depth:
            depth = registry("mesh").gauge("inflight_depth").value
            if depth > self.mesh_depth:
                return "slo_mesh_depth"
        return None

    def over_budget(self) -> Optional[str]:
        """The first crossed signal (a refusal-reason suffix), or None;
        cached for `cache_s`."""
        if not self.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            if now - self._cached_at < self.cache_s:
                return self._cached
            self._cached = self._evaluate()
            self._cached_at = now
            return self._cached

    def snapshot(self) -> dict:
        """Recon's view of the shedder."""
        return {"p99_ms": self.p99_ms, "codec_depth": self.codec_depth,
                "mesh_depth": self.mesh_depth,
                "over_budget": self.over_budget()}

    def should_shed(self, priority: str) -> Optional[str]:
        """Bulk work is refused while over budget; interactive work
        always passes."""
        if priority == "interactive":
            return None
        return self.over_budget()
