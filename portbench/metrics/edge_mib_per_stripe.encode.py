"""MiB across the host-device edge per stripe dispatched over the window:
host rows handed to the device path plus outputs pulled back (counters
`h2d_bytes` and `d2h_bytes` of the `codec.service` registry, counted at
`_to_device` and `start_pull`) over `stripes_dispatched`. Padding and
second copies show as more than the shape's own bytes. A program without
the counters reports nothing."""


def read(w):
    n = w.counters.get("stripes_dispatched", 0)
    h2d, d2h = w.counters.get("h2d_bytes"), w.counters.get("d2h_bytes")
    if not n or h2d is None or d2h is None:
        return None
    return (h2d + d2h) / 2**20 / n
