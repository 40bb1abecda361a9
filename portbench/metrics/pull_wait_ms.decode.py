"""Time the codec service's dispatcher spent blocked on the copy back of
a dispatch's outputs, per dispatch over the window (`codec:pull_wait`,
`finish_pull`; counter `pull_wait_seconds_total` of the `codec.service`
registry, over `dispatches`). A program without the counter reports
nothing."""


def read(w):
    n = w.counters.get("dispatches", 0)
    t = w.counters.get("pull_wait_seconds_total")
    if not n or t is None:
        return None
    return 1e3 * t / n
