"""The command without a card, without the program, and its result line."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.harness import cell as cell_mod
from portbench.tests.conftest import ROOT, small_cell

ARGS = ["--workload", "rs63-encode", "--seed", "3000000019", "--seconds",
        "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = _run(ROOT, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {**os.environ, "PYTHONPATH": ""}
    proc = _run(tmp_path, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(traced, cpu_threads):
    cell = small_cell("rs-6-3-1024k", "encode_closed", "rs63-encode")
    res = cell_mod.run_cell(cell, 3000000019, 1.0, traced, device="cpu")
    line = json.loads(json.dumps(run.result_line(res, "cpu (test)", traced)))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert ("busy_s" in dev) == traced
    if not traced:
        assert set(line["metrics"]) == {"setup_s"}
    for v in line["metrics"].values():
        assert isinstance(v["value"], float) and v["unit"]
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
