"""95th percentile (nearest rank) of the latency of every GET issued in the
window; a failed GET counts as missing every limit (infinitely late)."""

from portbench.harness.data import percentile


def read(w):
    gets = w.ops("get", ok=None)
    if not gets:
        return None
    lat = [o.latency_s if o.ok else float("inf") for o in gets]
    return 1e3 * percentile(lat, 0.95)
