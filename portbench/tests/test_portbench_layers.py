"""The readers of the dispatcher's and the device edge's counters: a
traced run of each codec cell on the CPU at a small size reports every
per-layer metric that reads a program counter, and the edge's bytes per
stripe are the shape's own."""

from __future__ import annotations

import pytest

from portbench.harness import cell as cell_mod
from portbench.harness import spec
from portbench.tests.conftest import SMALL_CELL, small_cell

SEED = 3_037_000_493
CELLS = [("rs63-encode", "rs-6-3-1024k", "encode_closed"),
         ("rs104-decode", "rs-10-4-1024k", "decode_closed2")]


def _edge_bytes(cfg: dict, erased: list) -> int:
    """Bytes one stripe moves across the edge: its input cells in, its
    output cells and their CRC32C words out."""
    k, p = cfg["data_units"], cfg["parity_units"]
    words = SMALL_CELL // cfg["bytes_per_checksum"] * 4
    if erased:
        return k * SMALL_CELL + len(erased) * (SMALL_CELL + words)
    return k * SMALL_CELL + p * SMALL_CELL + (k + p) * words


@pytest.mark.parametrize("workload,config,traffic", CELLS)
def test_traced_run_reports_the_counter_metrics(workload, config, traffic,
                                                cpu_threads):
    cell = small_cell(config, traffic, workload)
    cell.per_layer = [m for m in spec.load_cell(workload).per_layer
                      if m["source"] == "program_counter"]
    res = cell_mod.run_cell(cell, SEED, 1.0, True, device="cpu")
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) == {m["name"] for m in cell.per_layer}
    kind = workload.split("-")[1]
    for name in ("dispatch_host_ms", "pull_wait_ms"):
        assert got[f"{name}.{kind}"]["value"] > 0
    edge = got[f"edge_mib_per_stripe.{kind}"]["value"]
    want = _edge_bytes(cell.config, cell.traffic.get("erased_units", []))
    assert edge == pytest.approx(want / 2**20, rel=1e-12)


@pytest.mark.parametrize("workload,config,traffic", CELLS)
def test_dispatcher_tool_reads_a_traced_run(workload, config, traffic,
                                            cpu_threads):
    """`tools/dispatcher.py` on the CPU: the dispatcher's steps add up to
    the counters' interval, nothing is dropped, and the edge's bytes per
    stripe read the same from the span tags as from the counters."""
    from portbench.tools import dispatcher

    cell = small_cell(config, traffic, workload)
    out = dispatcher.run(cell, SEED, 1.0, device="cpu")
    assert out["correct"]
    assert out["dispatches"] > 0 and out["spans_dropped"] == 0
    assert out["addup"] == pytest.approx(1.0, abs=0.05)
    assert set(out["steps_ms_per_dispatch"]) == set(dispatcher.STEPS)
    want = _edge_bytes(cell.config, cell.traffic.get("erased_units", []))
    edge = out["edge"]
    assert edge["counters_mib_per_stripe"] == pytest.approx(want / 2**20,
                                                            rel=1e-12)
    assert edge["tags_mib_per_stripe"] == pytest.approx(want / 2**20,
                                                        rel=1e-12)
    assert "clock" not in out  # no device trace on the CPU
