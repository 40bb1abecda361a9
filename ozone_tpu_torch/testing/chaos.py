"""Chaos harness: random failure injection under load.

Port of `ozone_tpu/testing/chaos.py`, the reference's mini-chaos-tests
(fault-injection-test: MiniOzoneChaosCluster and its FailureManager
randomly restart and kill datanodes while load generators check
invariants). `FailureManager` stops and restarts the port's
`MiniOzoneCluster` datanodes on a schedule while `run_chaos` writes keys;
the invariant is that every key whose commit succeeded reads back
byte-exact afterwards (EC tolerates p datanodes down at once). The keys
are coded on `device` (the cluster's own unless given): on the card the
writes and the degraded reads run the fused kernel.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ozone_tpu_torch.client.ozone_client import OzoneClient
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

log = logging.getLogger(__name__)


@dataclass
class ChaosResult:
    keys_written: list[str] = field(default_factory=list)
    write_failures: int = 0
    kills: int = 0
    restarts: int = 0
    read_mismatches: list[str] = field(default_factory=list)
    read_errors: list[str] = field(default_factory=list)


class FailureManager:
    """Randomly stops and restarts datanodes, keeping at most `max_down`
    down (p for an EC cluster)."""

    def __init__(self, cluster: MiniOzoneCluster, max_down: int = 1,
                 seed: int = 0, interval_s: float = 0.3):
        self.cluster = cluster
        self.max_down = max_down
        self.rng = random.Random(seed)
        self.interval = interval_s
        self.down: list[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills = 0
        self.restarts = 0

    def _tick(self) -> None:
        if self.down and (len(self.down) >= self.max_down
                          or self.rng.random() < 0.5):
            dn = self.down.pop(self.rng.randrange(len(self.down)))
            self.cluster.restart_datanode(dn)
            self.restarts += 1
        else:
            alive = [d.id for d in self.cluster.datanodes
                     if d.id not in self.down]
            if len(alive) > 1:
                dn = self.rng.choice(alive)
                self.cluster.stop_datanode(dn)
                self.down.append(dn)
                self.kills += 1

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self._tick()
                except Exception:
                    log.exception("failure manager tick failed")

        self._thread = threading.Thread(target=loop, name="failure-manager",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        for dn in list(self.down):
            self.cluster.restart_datanode(dn)
        self.down.clear()


def _payload(rng: np.random.Generator, i: int, key_size: int) -> np.ndarray:
    """Key i's bytes: the seeded stream, with i in the first 8 bytes."""
    data = rng.integers(0, 256, key_size, dtype=np.uint8)
    data[:8] = np.frombuffer(i.to_bytes(8, "big"), dtype=np.uint8)
    return data


def run_chaos(
    cluster: MiniOzoneCluster,
    duration_s: float = 5.0,
    replication: str = "rs-3-2-4096",
    key_size: int = 20_000,
    max_down: int = 1,
    seed: int = 0,
    interval_s: float = 0.3,
    device=None,
) -> ChaosResult:
    """Write keys under random failures, then verify every committed key.
    `device` is where the client codes (default: the cluster's)."""
    result = ChaosResult()
    oz = (cluster.client() if device is None
          else OzoneClient(cluster.om, cluster.clients, device=device))
    vol = oz.create_volume(f"chaos{seed}")
    bucket = vol.create_bucket("b", replication=replication)
    rng = np.random.default_rng(seed)
    fm = FailureManager(cluster, max_down=max_down, seed=seed,
                        interval_s=interval_s)
    fm.start()

    deadline = time.time() + duration_s
    i = 0
    try:
        while time.time() < deadline:
            name = f"key-{i}"
            data = _payload(rng, i, key_size)
            try:
                bucket.write_key(name, data)
                result.keys_written.append(name)
            except Exception as e:  # noqa: BLE001 - counted: chaos may fail a write
                log.info("write %s failed under chaos: %s", name, e)
                result.write_failures += 1
            i += 1
    finally:
        fm.stop()
        result.kills = fm.kills
        result.restarts = fm.restarts

    # the cluster is whole again: every committed key reads back
    written = set(result.keys_written)
    rng_v = np.random.default_rng(seed)
    for j in range(i):
        expect = _payload(rng_v, j, key_size)
        name = f"key-{j}"
        if name not in written:
            continue
        try:
            got = bucket.read_key(name)
            if not np.array_equal(np.asarray(got), expect):
                result.read_mismatches.append(name)
        except Exception as e:  # noqa: BLE001 - recorded: the invariant's check
            result.read_errors.append(f"{name}: {e}")
    return result
