"""The controls and the program's own readings of the compared numbers, on
the card at a cell's own size; not run by the benchmark's own runs.

    python3 portbench/tools/control.py --workload rs63-encode \
        --seeds 11,12,13 --seconds 30 [--control crc32]

Without `--control` it runs the cell as committed on each seed (the lower
readings: what sound runs give). `--control crc32` runs the program with
its own CRC32 path switched on in place of the configuration's CRC32C
(`FusedSpec.checksum`), which breaks the stated guarantee "one CRC32C word
per 16 KiB slice": the comparison must come out not correct. All seeds run
in one process, so the import and the kernel load are paid once; each
seed's set-up is its own.
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

CONTROLS = {
    # the program's own other checksum path in place of the configured one
    "crc32": {"config": {"checksum": "CRC32"}},
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    args = ap.parse_args()
    base = spec.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        c = copy.deepcopy(base)
        c.per_layer = []
        if args.control:
            c.config.update(CONTROLS[args.control]["config"])
        res = cell_mod.run_cell(c, seed, args.seconds, False, device="cuda")
        print(json.dumps({
            "workload": c.name, "control": args.control, "seed": seed,
            "correct": res["correct"], "attempted": res["attempted"],
            "checks": {k: v["value"] for k, v in res["checks"].items()}}),
            flush=True)


if __name__ == "__main__":
    main()
