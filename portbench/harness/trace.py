"""What a `--trace 1` run reads besides the clock: the program's spans
(`utils/tracing.py`), its `codec.service` registry (`utils/metrics.py`)
and `torch.profiler` over the window.

The tracer keeps 10 000 spans and drops the oldest, so a traced run
drains it every 50 ms into a list of its own. The profiler records device
activity only (kernels, copies, sets); its trace is written under TMPDIR,
read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field

REGISTRY = "codec.service"
HISTOGRAMS = ("queue_wait_seconds", "dispatch_seconds")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class SpanDrain:
    """Moves the tracer's spans into `spans` (dicts with name, start, end
    in host wall time, tags) every `period_s`."""

    def __init__(self, period_s: float = 0.05):
        from ozone_tpu_torch.utils.tracing import Tracer

        self._buf = Tracer.instance().spans
        self.spans: list[dict] = []
        self._stop = threading.Event()
        self._period = period_s
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="bench-span-drain")

    def _take(self) -> list:
        out = []
        while True:
            try:
                out.append(self._buf.popleft())
            except IndexError:
                return out

    def start(self) -> None:
        self._take()
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            self._keep(self._take())

    def _keep(self, taken: list) -> None:
        for s in taken:
            self.spans.append({"name": s.name, "start": s.start,
                               "end": s.start + s.duration,
                               "trace": s.trace_id, "tags": dict(s.tags)})

    def stop(self) -> list[dict]:
        self._stop.set()
        self._thread.join(timeout=5)
        self._keep(self._take())
        return self.spans


def counters() -> dict:
    """The codec service's counters, and count and total of its
    histograms, now."""
    from ozone_tpu_torch.utils.metrics import registry

    reg = registry(REGISTRY)
    snap = {k: v for k, v in reg.snapshot().items()
            if isinstance(v, (int, float))}
    for h in HISTOGRAMS:
        hist = reg.histogram(h)
        snap[f"{h}.count"] = hist.count
        snap[f"{h}.total"] = hist.total
    return snap


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


@dataclass
class DeviceTrace:
    """Device activity of the traced window: events with name, cat, start
    and end in seconds of host wall time (aligned by a marker launched at a
    known host time), and bytes for copies."""

    events: list[dict] = field(default_factory=list)
    t0: float = 0.0      # host wall time the window opened
    t1: float = 0.0      # and closed

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of every device event's interval, clipped to the
        window, as sorted disjoint intervals."""
        spans = sorted((max(e["start"], self.t0), min(e["end"], self.t1))
                       for e in self.events)
        out: list[list[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals of the window."""
        out, cur = [], self.t0
        for a, b in self.busy_intervals():
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            out.append((cur, self.t1))
        return out


class Profiler:
    """torch.profiler over the window, CUDA activity only."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._marker_host = 0.0
        self.trace = DeviceTrace()

    def start(self) -> None:
        torch = self._torch
        torch.cuda.synchronize()
        self._prof.__enter__()
        # the first device event is this marker: its start aligns the
        # device clock with the host's
        self._marker_host = time.time()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.trace.t0 = time.time()

    def stop(self) -> DeviceTrace:
        torch = self._torch
        torch.cuda.synchronize()
        self.trace.t1 = time.time()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        events = [e for e in raw.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        if not events:
            return self.trace
        events.sort(key=lambda e: float(e["ts"]))
        offset = self._marker_host - float(events[0]["ts"]) * 1e-6
        for e in events[1:]:
            start = float(e["ts"]) * 1e-6 + offset
            args = e.get("args", {})
            self.trace.events.append({
                "name": e.get("name", ""), "cat": e["cat"],
                "start": start, "end": start + float(e.get("dur", 0)) * 1e-6,
                "bytes": int(args.get("bytes", 0) or 0)})
        return self.trace


def breakdown(trace: DeviceTrace, spans: list[dict], top: int = 10) -> dict:
    """The device operations that took most time (by name), and the idle
    time of the window by what the host was doing: each gap is labelled by
    the innermost program span open at its middle ("no span" if none), and
    the gaps' seconds are summed per label."""
    import numpy as np

    by_op: dict[str, float] = {}
    for e in trace.events:
        name = e["name"][:96]
        by_op[name] = by_op.get(name, 0.0) + (e["end"] - e["start"])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:500]
    idle: dict[str, float] = {}
    if spans:
        st = np.array([s["start"] for s in spans])
        en = np.array([s["end"] for s in spans])
        dur = en - st
    for a, b in gaps:
        label = "no span"
        if spans:
            mid = (a + b) / 2
            hit = np.flatnonzero((st <= mid) & (en >= mid))
            if hit.size:
                label = spans[int(hit[np.argmin(dur[hit])])]["name"]
        idle[label] = idle.get(label, 0.0) + (b - a)
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gap_list]}
