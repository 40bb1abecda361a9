"""BENCHMARK.json against the rules its keys follow, and loading by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench.harness import spec
from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name_and_reports(w):
    cell = spec.load_cell(w)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end:
        if m["name"] != "setup_s":
            assert callable(spec.reader("end_to_end", m["name"]).read)
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader("metrics", m["name"]).read)
    entry = next(x for x in BENCH["workloads"] if x["name"] == w)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_source_and_guarantees(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert c["file"].startswith("portbench/")
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert cfg["guarantees"] and cfg["flush_policy"]
    for key in ("data_units", "parity_units", "cell_bytes",
                "bytes_per_checksum", "checksum", "scheme"):
        assert key in cfg


def test_every_layer_name_is_one_line():
    for m in BENCH["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


@pytest.mark.parametrize("t", sorted(p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json")))
def test_every_traffic_file_loads(t):
    tr = spec.load_traffic(t)
    assert tr["loop"] in ("open", "closed") and tr["ops"]
