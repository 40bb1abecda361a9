"""The codec service dispatcher's readings from a traced run of a codec
cell, on the card at the cell's own size; not run by the benchmark's own
runs.

    python3 portbench/tools/dispatcher.py --workload rs63-encode \
        --seed 11 --seconds 30 [--out readings.json]

It runs the cell traced, as `run.py --trace 1` does, keeps the spans and
the device trace, and prints one JSON line:
- `idle_by_step`: every idle gap of the window (the result line's
  breakdown labels only the 500 longest) summed under the innermost span
  open at its middle ("no span" if none);
- `addup`: `dispatch_host_seconds_total` plus `pull_wait_seconds_total`
  plus the `codec:idle_wait` time inside the counters' interval, over
  that interval (the dispatcher's steps tile its thread: 1 when whole);
- `steps_ms_per_dispatch`, `spans_dropped` over the window, and `edge`:
  bytes per stripe from the `h2d_bytes`/`d2h_bytes` counters and from the
  `codec:launch`/`codec:pull_start` tags over the `codec:pack` rows;
- `clock`: each fused kernel paired, in launch order, with the
  `codec:launch` span whose `launch` tag counts it; a kernel's lead is its
  start on the aligned device clock less its span's start, and none may
  be negative;
- `alignment_ms`: five markers launched on the idle card right after the
  harness's own, each at a known host time; the largest host time less
  its aligned start is how late the harness's alignment puts the device
  clock, and `clock_moved`, `idle_by_step_moved` repeat the two readings
  with the device events moved by it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from contextlib import contextmanager
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import cell as cell_mod  # noqa: E402
from portbench.harness import spec, trace  # noqa: E402

STEPS = ("codec:idle_wait", "codec:pack", "codec:stage", "codec:launch",
         "codec:pull_start", "codec:pull_wait", "codec:resolve")
KERNEL = "fused_encode_crc_kernel"
MARKERS = 5


@contextmanager
def _capture():
    """Wraps the harness for one run: keeps its window view, stamps the
    host clock at each counter reading, and launches the markers after the
    profiler's own."""
    got = {"stamps": [], "marks": []}
    view_cls, counters, start = (cell_mod.WindowView, trace.counters,
                                 trace.Profiler.start)

    class View(view_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            got["view"] = self

    def stamped():
        got["stamps"].append(time.time())
        return counters()

    def marked(prof):
        start(prof)
        torch = prof._torch
        for _ in range(MARKERS):
            torch.cuda.synchronize()
            got["marks"].append(time.time())
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    cell_mod.WindowView, trace.counters, trace.Profiler.start = \
        View, stamped, marked
    try:
        yield got
    finally:
        cell_mod.WindowView, trace.counters, trace.Profiler.start = \
            view_cls, counters, start


def _idle_by_step(gaps, spans, shift: float = 0.0) -> dict:
    import numpy as np

    out: dict[str, float] = {}
    st = np.array([s["start"] for s in spans])
    en = np.array([s["end"] for s in spans])
    for a, b in gaps:
        mid = (a + b) / 2 + shift
        hit = np.flatnonzero((st <= mid) & (en >= mid))
        name = spans[int(hit[np.argmin(en[hit] - st[hit])])]["name"] \
            if hit.size else "no span"
        out[name] = out.get(name, 0.0) + (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _clock(kernels, launches: dict, t0: float, t1: float,
           shift: float = 0.0) -> dict:
    inside = sorted(n for n, s in launches.items() if t0 <= s["start"] <= t1)
    if not kernels or not inside:
        return {}
    leads = [e["start"] + shift - launches[inside[0] + i]["start"]
             for i, e in enumerate(kernels) if inside[0] + i in launches]
    return {"kernels": len(kernels), "paired": len(leads),
            "min_lead_ms": 1e3 * min(leads),
            "median_lead_ms": 1e3 * statistics.median(leads),
            "early": sum(1 for x in leads if x < 0)}


def analyse(view, stamps: list[float], marks: list[float],
            dropped: int) -> dict:
    """The readings of one traced window (module docstring)."""
    spans, cnt = view.spans, view.counters
    t_a, t_b = stamps[0], stamps[1]

    def inside(s):
        return max(0.0, min(s["end"], t_b) - max(s["start"], t_a))

    steps = {n: sum(inside(s) for s in spans if s["name"] == n)
             for n in STEPS}
    n = cnt.get("dispatches", 0)
    host = cnt.get("dispatch_host_seconds_total", 0.0)
    wait = cnt.get("pull_wait_seconds_total", 0.0)
    launches = [s for s in spans if s["name"] == "codec:launch"]
    pulls = [s for s in spans if s["name"] == "codec:pull_start"]
    rows = sum(s["tags"].get("rows", 0) for s in spans
               if s["name"] == "codec:pack")
    stripes = cnt.get("stripes_dispatched", 0)
    out = {
        "dispatches": n, "interval_s": t_b - t_a,
        "addup": (host + wait + steps["codec:idle_wait"]) / (t_b - t_a),
        "steps_ms_per_dispatch": {k: 1e3 * v / n for k, v in steps.items()}
        if n else {},
        "spans_dropped": dropped,
        "edge": {
            "counters_mib_per_stripe": (cnt.get("h2d_bytes", 0)
                                        + cnt.get("d2h_bytes", 0))
            / 2**20 / stripes if stripes else None,
            "tags_mib_per_stripe": (
                sum(s["tags"].get("h2d_bytes", 0) for s in launches)
                + sum(s["tags"].get("d2h_bytes", 0) for s in pulls))
            / 2**20 / rows if rows else None},
    }
    dev = view.device
    if dev is None:
        return out
    gaps = dev.gaps()
    kernels = sorted((e for e in dev.events if e["cat"] == "kernel"
                      and KERNEL in e["name"]), key=lambda e: e["start"])
    by_launch = {s["tags"]["launch"]: s for s in launches
                 if "launch" in s["tags"]}
    out["idle_s"] = sum(b - a for a, b in gaps)
    out["idle_by_step"] = _idle_by_step(gaps, spans)
    out["clock"] = _clock(kernels, by_launch, dev.t0, dev.t1)
    sleeps = sorted((e for e in dev.events if e["cat"] == "kernel"
                     and ("sleep" in e["name"].lower()
                          or "spin" in e["name"].lower())),
                    key=lambda e: e["start"])[:len(marks)]
    if marks and len(sleeps) == len(marks):
        late = [h - e["start"] for h, e in zip(marks, sleeps)]
        shift = max(late)
        out["alignment_ms"] = [1e3 * x for x in late]
        out["clock_moved"] = _clock(kernels, by_launch, dev.t0, dev.t1,
                                    shift)
        out["idle_by_step_moved"] = _idle_by_step(gaps, spans, shift)
    return out


def run(cell: spec.Cell, seed: int, seconds: float,
        device: str = "cuda") -> dict:
    """One traced run of `cell` with the readings beside its result."""
    from ozone_tpu_torch.utils.metrics import registry

    dropped = registry("tracing").counter("spans_dropped")
    d0 = dropped.value
    with _capture() as got:
        res = cell_mod.run_cell(cell, seed, seconds, True, device=device)
    readings = analyse(got["view"], got["stamps"], got["marks"],
                       dropped.value - d0)
    return {"workload": cell.name, "seed": seed, "correct": res["correct"],
            "metrics": {k: m["value"] for k, m in res["metrics"].items()},
            "breakdown": res.get("breakdown"), **readings}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    out = run(spec.load_cell(args.workload), args.seed, args.seconds)
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
