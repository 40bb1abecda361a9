"""Stripes the codec service packed into each device dispatch over the
window (counters `stripes_dispatched` / `dispatches`)."""


def read(w):
    n = w.counters.get("dispatches", 0)
    if not n:
        return None
    return w.counters["stripes_dispatched"] / n
