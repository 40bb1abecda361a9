"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
and its metrics are found by name through `BENCHMARK.json`. The program
under test is `ozone_tpu_torch` on one CUDA device; without one the run
exits with code 2 and prints no result. The last line of standard output
is the result (JSON); the compared numbers and their limits are also the
last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that must never be loaded into a run
FORBIDDEN = ("jax", "jaxlib", "flax", "ozone_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(res: dict, device_kind: str, traced: bool) -> dict:
    """The result line of one run: `correct`, `attempted`, `failed`,
    `metrics`, `device` (with `busy_s` and `window_s` when traced), the
    traced run's `breakdown`, and last `checks`, each compared number with
    its limit."""
    device = {"platform": "gpu", "kind": device_kind, "count": 1,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if traced:
        device["busy_s"] = res.get("busy_s", 0.0)
        device["window_s"] = res.get("window_s", 0.0)
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> None:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    try:
        import torch

        import ozone_tpu_torch  # noqa: F401
        from portbench.harness import cell as cell_mod
        from portbench.harness import spec
    except ImportError as e:
        fail(f"the program, PyTorch or the harness is not importable: {e}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        fail("no CUDA device: the benchmark measures ozone_tpu_torch on one "
             "NVIDIA GPU and prints no result without one")
    try:
        c = spec.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        fail(str(e))
    need = max(1, int(next(w for w in c.bench["workloads"]
                           if w["name"] == c.name)["chips"]))
    if torch.cuda.device_count() < need:
        fail(f"{c.name} needs {need} CUDA devices, "
             f"{torch.cuda.device_count()} present")
    res = cell_mod.run_cell(c, args.seed, args.seconds, bool(args.trace),
                            device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        fail(f"modules that must not load were loaded: {bad}", 3)
    line = result_line(res, torch.cuda.get_device_name(0), bool(args.trace))
    for name, v in res["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
