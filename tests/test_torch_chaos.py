"""The port's chaos harness: committed keys survive random datanode kills
(`tests/test_chaos.py`, the mini-chaos-tests strategy), on the port's
MiniOzoneCluster with the plain PyTorch coder."""

import pytest
import torch

from ozone_tpu_torch.testing.chaos import FailureManager, run_chaos
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cluster(tmp_path, device="cpu"):
    return MiniOzoneCluster(tmp_path, num_datanodes=7, block_size=8 * 4096,
                            container_size=4 * 1024 * 1024,
                            stale_after_s=1000.0, dead_after_s=2000.0,
                            device=device)


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_writes_survive_node_kills(tmp_path, seed):
    cluster = _cluster(tmp_path)
    try:
        result = run_chaos(cluster, duration_s=4.0, max_down=1, seed=seed,
                           replication="rs-3-2-4096")
        assert result.kills >= 1, "chaos must actually kill nodes"
        assert len(result.keys_written) >= 3
        assert result.read_mismatches == []
        assert result.read_errors == []
    finally:
        cluster.close()


def test_chaos_codes_on_the_device_asked_for(tmp_path):
    """`device` is the client's coding device, passed past the cluster's
    own: every key committed through that client reads back."""
    cluster = _cluster(tmp_path)
    try:
        result = run_chaos(cluster, duration_s=1.0, max_down=2, seed=3,
                           replication="rs-3-2-4096", device="cpu")
        assert len(result.keys_written) >= 1
        assert result.read_mismatches == [] and result.read_errors == []
    finally:
        cluster.close()


def test_failure_manager_bounds_the_nodes_down(tmp_path):
    """At most max_down datanodes are down at once, and stop() brings
    every one back."""
    cluster = _cluster(tmp_path)
    try:
        fm = FailureManager(cluster, max_down=2, seed=5)
        peak = 0
        for _ in range(40):
            fm._tick()
            peak = max(peak, len(fm.down))
            assert len(fm.down) <= 2
        assert peak == 2 and fm.kills >= 2 and fm.restarts >= 1
        fm.stop()
        assert fm.down == [] and not cluster._stopped_dns
    finally:
        cluster.close()


def test_chaos_path_runs_on_the_cpu(monkeypatch):
    """chip_smoke's `chaos_path` end to end at a small size on the plain
    PyTorch path: (a) chaos, (c) leader isolation, (b) partitions, delays,
    verb rules and admission, (f) freon and om_scale, (d) the injected
    datanode process, (e) fsck, repair and debug; every check inside it
    must hold."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    out = chip_smoke.chaos_path(torch.device("cpu"), 64 * 1024, 16 * 1024, 0,
                                n_keys=2, key_cells=4, chaos_s=2.0, n_freon=4,
                                om_scale_keys=2000, dnsim_nodes=4)
    assert out["a"]["kills"] >= 1 and out["c"]["retried"] == 0
    assert set(out["launches"]) >= {"chaos_run", "chaos_put", "chaos_repair",
                                    "chaos_corrupt_rebuild"}
