"""Shared helpers of the benchmark's own tests: a cell cut to a size the
CPU runs in seconds (the kernels' plain versions stand in for the card),
and the `chip` marker for tests that need a CUDA device."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import spec  # noqa: E402

#: a cell cut to 64 KiB cells for the CPU; the shapes stay those of the
#: configuration (k, p, CRC32C per 16 KiB)
SMALL_CELL = 64 * 1024


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA device (decided here, at run
    time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")
    return "cuda"


def small_cell(config: str, traffic: str, name: str = "t") -> spec.Cell:
    """A cell of `config` under `traffic`, cut to run on the CPU: 64 KiB
    cells, objects of 10 cells, batches of 2 stripes, few clients."""
    bench = spec.load_bench()
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == config) \
        if any(c["name"] == config for c in bench["configs"]) \
        else f"portbench/configs/{config}.json"
    cfg = json.loads((ROOT / cfg_file).read_text())
    cfg["cell_bytes"] = SMALL_CELL
    cfg["scheme"] = cfg["scheme"].replace("1024k", "64k")
    cfg["block_bytes"] = 16 * SMALL_CELL
    cfg["container_bytes"] = 64 << 20
    tr = copy.deepcopy(spec.load_traffic(traffic))
    for key, value in (("object_bytes", 10 * SMALL_CELL), ("clients", 2),
                       ("senders", 4), ("put_pool_objects", 4),
                       ("batch_stripes", 2), ("sample_per_client", 2)):
        if key in tr:
            tr[key] = value
    if tr.get("preload_objects"):
        tr["preload_objects"] = 6
    if "rate_per_s" in tr:
        tr["rate_per_s"] = 4
    e2e = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    return spec.Cell(name, cfg, tr, e2e, [], bench)


@pytest.fixture
def cpu_threads():
    """One torch thread: the plain kernels oversubscribe a shared host."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
