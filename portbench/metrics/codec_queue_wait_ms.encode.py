"""Mean wait of a submission in the codec service's queue before its
dispatch (histogram `queue_wait_seconds` of the `codec.service` registry,
over the window)."""


def read(w):
    n = w.counters.get("queue_wait_seconds.count", 0)
    if not n:
        return None
    return 1e3 * w.counters["queue_wait_seconds.total"] / n
