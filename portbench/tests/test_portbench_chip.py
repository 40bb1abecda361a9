"""On the card: each cell of BENCHMARK.json runs whole for a short window
with the kernel, correct; its control is not. Skips without a CUDA
device (the `cuda` fixture decides, at run time)."""

from __future__ import annotations

import copy

import pytest

from portbench.harness import cell as cell_mod
from portbench.harness import spec
from portbench.tests.test_portbench_spec import BENCH

CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, cuda):
    cell = spec.load_cell(workload)
    res = cell_mod.run_cell(cell, 3_141_592_653, 3.0, True, device=cuda)
    assert res["correct"], res["checks"]
    assert res["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload, cuda):
    cell = copy.deepcopy(spec.load_cell(workload))
    cell.config["checksum"] = "CRC32"
    res = cell_mod.run_cell(cell, 1_618_033_988, 3.0, False, device=cuda)
    assert not res["correct"]
    assert res["checks"]["crc_words_wrong"]["value"] > 0
