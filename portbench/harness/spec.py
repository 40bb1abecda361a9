"""A cell as `BENCHMARK.json` names it: its configuration file, its traffic
file, its end-to-end metrics and its per-layer metric readers, each found
by name under this folder."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent                             # the checkout


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench: dict = field(repr=False, default_factory=dict)


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell named `workload`; raises KeyError for an unknown name."""
    bench = bench if bench is not None else load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {', '.join(sorted(cells))}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = load_traffic(w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _reports(m, workload)]
    return Cell(workload, config, traffic, e2e, per_layer, bench)


def load_traffic(name: str) -> dict:
    traffic = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    traffic["name"] = name
    return traffic


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"portbench_reader_{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str) -> ModuleType:
    """The reader module of a metric: `end_to_end/<name>.py` or
    `metrics/<name>.py`, with a function `read(window) -> float | None`."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path.relative_to(ROOT)} for "
                                f"metric {name!r}")
    return _module(path)
