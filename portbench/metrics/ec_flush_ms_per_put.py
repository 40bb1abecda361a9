"""Time in the EC writer's stripe writes to the datanodes (span `ec:flush`,
the write of one encoded batch) per PUT of the window."""


def read(w):
    puts = w.ops("put")
    total = w.span_total_s("ec:flush")
    if not puts or not total:
        return None
    return 1e3 * total / len(puts)
