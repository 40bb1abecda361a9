"""Freon: load generators and benchmarks.

Port of the EC part of `ozone_tpu/tools/freon.py` (the reference's freon
suite, hadoop-ozone/tools freon/Freon.java): the BaseFreonGenerator
harness (thread-pool task loop, latency report) and

- ockg: OzoneClientKeyGenerator, n keys of one size written through the
  full client stack;
- ockr / ockv: read, and read-and-validate, ockg's keys;
- ockrr: random ranged reads over ockg's keys;
- rawcoder_bench: RawErasureCoderBenchmark, encode and decode GiB/s per
  coder backend (torch, cpp, numpy);
- ecrd: the EC reconstruction drill, end-to-end repair MiB/s per
  datanode.

The generators take a port `OzoneClient`, whose `device` the EC coding
runs on: one over an in-process cluster, or one the CLI builds from
`--om` over the RPC (`tools/cli.py`, as the reference's `cmd_freon`
does); `ecrd` also takes an SCM, in process or `RemoteScmClient`. The
other generators of the reference wait for the port's gateways, raft and
lifecycle.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class FreonReport:
    name: str
    ops: int
    failures: int
    elapsed_s: float
    latencies_s: list[float] = field(default_factory=list)
    bytes_processed: int = 0
    #: generator-specific extra fields merged into summary()
    extras: dict = field(default_factory=dict)

    def summary(self) -> dict:
        lat = sorted(self.latencies_s)

        def pct(q: float) -> float:
            return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0

        return {
            **self.extras,
            "generator": self.name,
            "ops": self.ops,
            "failures": self.failures,
            "elapsed_s": round(self.elapsed_s, 3),
            "ops_per_s": round(self.ops / self.elapsed_s, 2)
            if self.elapsed_s
            else 0,
            "throughput_mib_s": round(
                self.bytes_processed / 2**20 / self.elapsed_s, 2
            )
            if self.elapsed_s
            else 0,
            "mean_ms": round(1e3 * sum(lat) / len(lat), 3) if lat else 0,
            "p50_ms": round(1e3 * pct(0.5), 3),
            "p75_ms": round(1e3 * pct(0.75), 3),
            "p90_ms": round(1e3 * pct(0.9), 3),
            "p95_ms": round(1e3 * pct(0.95), 3),
            "p99_ms": round(1e3 * pct(0.99), 3),
            "p999_ms": round(1e3 * pct(0.999), 3),
            "max_ms": round(1e3 * (lat[-1] if lat else 0), 3),
            "histogram": self.histogram(),
        }

    def histogram(self) -> list[dict]:
        """Power-of-two latency buckets, per bucket (not cumulative): each
        entry counts the ops whose latency falls in (previous le_ms,
        le_ms]."""
        if not self.latencies_s:
            return []
        counts: dict[float, int] = {}
        for dt in self.latencies_s:
            ms = dt * 1e3
            le = 2 ** max(0, math.ceil(math.log2(max(ms, 1e-3))))
            counts[le] = counts.get(le, 0) + 1
        return [{"le_ms": k, "count": counts[k]} for k in sorted(counts)]


class BaseFreonGenerator:
    """Thread-pooled op loop with latency capture."""

    def __init__(self, name: str, n_ops: int, threads: int = 4):
        self.name = name
        self.n_ops = n_ops
        self.threads = threads
        self._lat: list[float] = []
        self._failures = 0
        self._bytes = 0
        self._lock = threading.Lock()

    def run(self, op: Callable[[int], int]) -> FreonReport:
        """op(i) -> bytes processed; runs n_ops times across the pool. An
        op that raises counts as a failure."""
        t0 = time.time()

        def task(i: int) -> None:
            s = time.perf_counter()
            try:
                nbytes = op(i) or 0
                dt = time.perf_counter() - s
                with self._lock:
                    self._lat.append(dt)
                    self._bytes += nbytes
            except Exception:  # noqa: BLE001 - counted, as freon counts failures
                with self._lock:
                    self._failures += 1

        with ThreadPoolExecutor(max_workers=self.threads) as pool:
            list(pool.map(task, range(self.n_ops)))
        return FreonReport(
            self.name,
            ops=self.n_ops - self._failures,
            failures=self._failures,
            elapsed_s=time.time() - t0,
            latencies_s=self._lat,
            bytes_processed=self._bytes,
        )


def _client_hist_extras() -> dict:
    """Tail latency as a scraper would see it: p50/p95/p99 (ms) estimated
    from the client-ops histograms over every op since process start,
    warm-ups included, beside the raw-list percentiles."""
    from ozone_tpu_torch.client.ozone_client import METRICS as client_ops

    out: dict = {}
    for verb in ("put", "get"):
        h = client_ops.histogram(f"{verb}_seconds")
        if h.count:
            out[f"hist_{verb}_ms"] = {
                p: round(1e3 * v, 3) for p, v in h.percentiles().items()}
    return out


def _det_payload(size: int, seed: int = 0) -> np.ndarray:
    """The deterministic ockg payload; ockv re-derives it to validate, so
    both use this one helper."""
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8)


def _ensure_bucket(client, volume: str, bucket: str, replication: str) -> None:
    """Create the volume and bucket unless they exist."""
    try:
        client.om.create_volume(volume)
    except Exception:  # noqa: BLE001 - it exists
        pass
    try:
        client.om.create_bucket(volume, bucket, replication)
    except Exception:  # noqa: BLE001 - it exists
        pass


def ockg(
    client,
    n_keys: int = 100,
    size: int = 10 * 1024,
    threads: int = 4,
    volume: str = "freon-vol",
    bucket: str = "freon-bucket",
    replication: Optional[str] = None,
    prefix: str = "key",
    validate: bool = False,
    warmup: int = 0,
) -> FreonReport:
    """Ozone Client Key Generator (freon ockg). `warmup` keys are written
    before the clock starts (the first launch builds the kernel)."""
    _ensure_bucket(client, volume, bucket, replication or "rs-6-3-1024k")
    b = client.get_volume(volume).get_bucket(bucket)
    payload = _det_payload(size)

    def op(i: int) -> int:
        b.write_key(f"{prefix}-{i}", payload, replication)
        if validate:
            got = b.read_key(f"{prefix}-{i}")
            assert np.array_equal(got, payload)
        return size

    for w in range(warmup):
        b.write_key(f"{prefix}-warmup-{w}", payload, replication)
    rep = BaseFreonGenerator("ockg", n_keys, threads).run(op)
    rep.extras.update(_client_hist_extras())
    return rep


def ockr(client, n_keys: int, threads: int = 4, volume: str = "freon-vol",
         bucket: str = "freon-bucket", prefix: str = "key") -> FreonReport:
    """Key read generator (a read pass over ockg's keys)."""
    b = client.get_volume(volume).get_bucket(bucket)

    def op(i: int) -> int:
        data = b.read_key(f"{prefix}-{i}")
        return int(data.size)

    rep = BaseFreonGenerator("ockr", n_keys, threads).run(op)
    rep.extras.update(_client_hist_extras())
    return rep


def ockrr(client, n_reads: int, threads: int = 4, size: int = 65536,
          volume: str = "freon-vol", bucket: str = "freon-bucket",
          prefix: str = "key", n_keys: int = 0) -> FreonReport:
    """Random ranged-read generator over ockg's keys: each op reads `size`
    bytes at a random offset of a random key through the positioned path
    (only the covering cells move). The key pool is keys
    0..max(1, n_keys)-1, all of key 0's size."""
    b = client.get_volume(volume).get_bucket(bucket)
    rng = np.random.default_rng(4)
    pool = max(1, n_keys)
    key_size = int(b.lookup_key_info(f"{prefix}-0")["size"])
    span = max(1, key_size - size + 1)
    # a schedule drawn up front: worker threads must not share a Generator
    keys = rng.integers(0, pool, size=n_reads)
    offs = rng.integers(0, span, size=n_reads)

    def op(i: int) -> int:
        off = int(offs[i])
        ln = min(size, key_size - off)
        data = b.read_key_range(f"{prefix}-{int(keys[i])}", off, ln)
        return int(data.size)

    return BaseFreonGenerator("ockrr", n_reads, threads).run(op)


def ockv(client, n_keys: int = 100, size: int = 10 * 1024,
         threads: int = 4, volume: str = "freon-vol",
         bucket: str = "freon-bucket",
         prefix: str = "key") -> FreonReport:
    """Key validator (freon ockv): read back ockg's keys and check each
    against the deterministic payload, so corruption anywhere in the path
    fails the op."""
    b = client.get_volume(volume).get_bucket(bucket)
    expect = _det_payload(size)

    def op(i: int) -> int:
        got = b.read_key(f"{prefix}-{i}")
        assert np.array_equal(got, expect), f"corrupt key {prefix}-{i}"
        return int(got.size)

    return BaseFreonGenerator("ockv", n_keys, threads).run(op)


def rawcoder_bench(
    backends: Optional[list[str]] = None,
    schema: str = "rs-6-3",
    cell: int = 1024 * 1024,
    batch: int = 8,
    iters: int = 5,
    device=None,
) -> list[dict]:
    """Raw coder throughput matrix (RawErasureCoderBenchmark analog): for
    each backend, encode and decode GiB/s of data units over `iters`
    calls after one warm-up; the decode rebuilds the first min(2, p)
    units. `device` reaches the torch coder only. A backend that fails
    gives a row with "error"."""
    from ozone_tpu_torch.codec import CoderOptions, create_decoder, create_encoder
    from ozone_tpu_torch.codec.registry import CodecRegistry

    parts = schema.split("-")
    opts = CoderOptions(int(parts[1]), int(parts[2]), parts[0], cell)
    backends = backends or CodecRegistry.instance().backends(opts.codec)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (batch, opts.data_units, cell), dtype=np.uint8)
    out = []
    for be in backends:
        try:
            enc = create_encoder(opts, be, device)
            enc.encode(data)  # warm
            t0 = time.time()
            for _ in range(iters):
                parity = enc.encode(data)
            enc_dt = (time.time() - t0) / iters

            dec = create_decoder(opts, be, device)
            units = np.concatenate([data, parity], axis=1)
            erased = list(range(min(2, opts.parity_units)))
            inputs = [
                None if i in erased else units[:, i]
                for i in range(opts.all_units)
            ]
            dec.decode(inputs, erased)  # warm
            t0 = time.time()
            for _ in range(iters):
                dec.decode(inputs, erased)
            dec_dt = (time.time() - t0) / iters
            gib = data.nbytes / 2**30
            out.append(
                {
                    "backend": be,
                    "schema": schema,
                    # unrounded: a small shape's rate is below 0.001
                    "encode_gib_s": gib / enc_dt,
                    "decode_gib_s": gib / dec_dt,
                }
            )
        except Exception as e:  # noqa: BLE001 - reported in the row
            out.append({"backend": be, "schema": schema, "error": str(e)})
    return out


def ecrd(
    client,
    scm,
    size: int = 64 * 1024 * 1024,
    rounds: int = 3,
    replication: str = "rs-6-3-1048576",
    volume: str = "freon-vol",
    bucket: str = "freon-ecrd",
) -> dict:
    """EC reconstruction drill: the end-to-end repair path in MiB/s per
    datanode. Writes an EC key, closes its containers, wipes one unit's
    replica, and times ECReconstructionCoordinator repairing it onto a
    spare datanode: survivor reads, device decode, target writes
    (ECReconstructionCoordinator.java:146 reconstructECContainerGroup)."""
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.storage.reconstruction import (
        ECReconstructionCoordinator,
        ReconstructionCommand,
    )

    opts = CoderOptions.parse(replication)
    _ensure_bucket(client, volume, bucket, replication)
    b = client.get_volume(volume).get_bucket(bucket)
    payload = _det_payload(size, seed=9)
    all_nodes = [n["dn_id"] for n in scm.status()["nodes"]]
    results = []
    for r in range(rounds):
        key = f"drill-{r}"
        b.write_key(key, payload, replication)
        groups = client.om.key_block_groups(
            client.om.lookup_key(volume, bucket, key))
        g = groups[0]
        # close replicas directly on the datanodes (synchronously): close
        # commands through the SCM arrive over later heartbeats and would
        # race the drill's RECOVERING container
        for dn_id in set(g.pipeline.nodes):
            try:
                client.clients.get(dn_id).close_container(g.container_id)
            except Exception:  # noqa: BLE001 - already closed
                pass
        lost = 1  # a data unit
        client.clients.get(g.pipeline.nodes[lost]).delete_container(
            g.container_id, force=True)
        # a node holding no replica of this group; when the pipeline
        # spans every node, the wiped node itself (it holds none now)
        spare = next((d for d in all_nodes if d not in g.pipeline.nodes),
                     g.pipeline.nodes[lost])
        cmd = ReconstructionCommand(
            g.container_id, opts,
            sources={u + 1: g.pipeline.nodes[u]
                     for u in range(opts.all_units) if u != lost},
            targets={lost + 1: spare},
        )
        coord = ECReconstructionCoordinator(client.clients, device=client.device)
        t0 = time.perf_counter()
        coord.reconstruct_container_group(cmd)
        dt = time.perf_counter() - t0
        unit_bytes = -(-g.length // opts.data_units)
        results.append((unit_bytes, dt))
        b.delete_key(key)
    per_dn = sorted(ub / 2**20 / dt for ub, dt in results)
    return {
        "name": "ecrd",
        "rounds": rounds,
        "unit_mib": round(results[0][0] / 2**20, 2),
        "reconstruct_mib_s_per_datanode": round(per_dn[len(per_dn) // 2], 2),
        "best_mib_s_per_datanode": round(per_dn[-1], 2),
        "times_s": [round(dt, 3) for _, dt in results],
    }
