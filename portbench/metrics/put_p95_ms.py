"""95th percentile (nearest rank) of every PUT's latency from its due time;
a failed PUT counts as infinitely late. The host paces this tail, so it
stands beside `put_mean_ms` without a bound."""

from portbench.harness.data import percentile


def read(w):
    puts = w.ops("put", ok=None)
    if not puts:
        return None
    return 1e3 * percentile(
        [o.latency_s if o.ok else float("inf") for o in puts], 0.95)
