"""Sweep a PUT cell's load on the card, to find the highest rate the
system sustains (the knee) once; not run by the benchmark's own runs.

    python3 portbench/tools/knee.py --workload rs63-put --seed 7 \
        --seconds 6 --clients 1,2,4,8,16 --rates 8,10,12

Each step is a fresh run of the cell: first closed loops of N PUT clients
(their completed PUTs per second approach the knee), then the cell's own
open loop at each rate (whether its mean and tail stay flat).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import cell as cell_mod  # noqa: E402
from portbench.harness import spec  # noqa: E402


def step(base: spec.Cell, traffic: dict, seed: int, seconds: float) -> dict:
    c = copy.deepcopy(base)
    c.traffic = traffic
    c.end_to_end = [m for m in c.bench["end_to_end"]
                    if m["name"] in ("put_mean_ms", "setup_s")]
    c.per_layer = []
    res = cell_mod.run_cell(c, seed, seconds, False, device="cuda")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="rs63-put")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--clients", default="1,2,4,8,16")
    ap.add_argument("--rates", default="")
    args = ap.parse_args()
    base = spec.load_cell(args.workload)
    for n in [int(x) for x in args.clients.split(",") if x]:
        tr = {**base.traffic, "loop": "closed", "clients": n,
              "put_pool_objects": 32, "warmup_puts": 1}
        res = step(base, tr, args.seed + n, args.seconds)
        print(json.dumps({"closed_clients": n, "puts_per_s":
                          (res["attempted"] - res["failed"]) / args.seconds,
                          "metrics": res["metrics"],
                          "correct": res["correct"]}), flush=True)
    for r in [float(x) for x in args.rates.split(",") if x]:
        tr = {**base.traffic, "rate_per_s": r}
        res = step(base, tr, args.seed + int(r * 10), args.seconds)
        print(json.dumps({"open_rate": r, "metrics": res["metrics"],
                          "failed": res["failed"],
                          "correct": res["correct"]}), flush=True)


if __name__ == "__main__":
    main()
