"""Host time of the codec service's dispatcher per dispatch over the
window: its steps but the waits on the copy back and the idle waits
(`codec:pack`, `codec:stage`, `codec:launch`, `codec:pull_start`,
`codec:resolve`; counter `dispatch_host_seconds_total` of the
`codec.service` registry) over the dispatches (`dispatches`). A program
without the counter reports nothing."""


def read(w):
    n = w.counters.get("dispatches", 0)
    t = w.counters.get("dispatch_host_seconds_total")
    if not n or t is None:
        return None
    return 1e3 * t / n
