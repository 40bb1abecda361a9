"""Share of the traced window in which the device ran nothing: one minus
the union of every kernel, copy and set interval in the profiler's trace,
over the window."""


def read(w):
    if w.device is None or w.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.device.busy_s() / w.device.window_s)
