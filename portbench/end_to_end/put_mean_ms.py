"""Mean over every acknowledged PUT of the window, each timed from the
moment it was due (its scheduled send time) to the acknowledged commit."""


def read(w):
    puts = w.ops("put")
    if not puts:
        return None
    return 1e3 * sum(o.latency_s for o in puts) / len(puts)
