"""95th percentile of how late the open-loop generator sent each PUT after
its due time: above a few ms, the generator, not the system, set the
pace."""

from portbench.harness.data import percentile


def read(w):
    puts = w.ops("put", ok=None)
    if not puts or w.cell.traffic["loop"] != "open":
        return None
    return 1e3 * percentile([max(0.0, o.late_s) for o in puts], 0.95)
