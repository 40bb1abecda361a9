"""Host-to-device copy rate at the device edge: bytes of the profiler's
HtoD memcpy events over their summed device time."""


def read(w):
    if w.device is None:
        return None
    copies = [e for e in w.device.events
              if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    t = sum(e["end"] - e["start"] for e in copies)
    b = sum(e["bytes"] for e in copies)
    if not copies or t <= 0 or b <= 0:
        return None
    return b / t / 2**30
