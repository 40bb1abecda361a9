"""Freon: load generators and benchmarks.

Port of the EC part of `ozone_tpu/tools/freon.py` (the reference's freon
suite, hadoop-ozone/tools freon/Freon.java): the BaseFreonGenerator
harness (thread-pool task loop, latency report) and

- ockg: OzoneClientKeyGenerator, n keys of one size written through the
  full client stack;
- ockr / ockv: read, and read-and-validate, ockg's keys;
- ockrr: random ranged reads over ockg's keys;
- mpug: multipart uploads (initiate, N parts, complete) through the
  client;
- s3kg: PUTs (optionally GET-validated) through the S3 gateway's HTTP
  endpoint, unsigned as in the reference or SigV4-signed with an access
  id's secret;
- rawcoder_bench: RawErasureCoderBenchmark, encode and decode GiB/s per
  coder backend (torch, cpp, numpy);
- ecrd: the EC reconstruction drill, end-to-end repair MiB/s per
  datanode;
- lcg: lifecycle churn: replicated keys under an age-0 TRANSITION_TO_EC
  rule, one sweep, then every key read back and checked EC-coded;
- tinyg: tiny keys into a small-object bucket (inline values and slab
  needles), or with `packer=False` the same keys down the per-key stripe
  path, the before/after pair; `mix` draws sizes from TINY_SIZES;
- fskg: nested files `depth` directories down in an FSO bucket (the
  directory-tree resolve and create path);
- fsg: create and read back through the ofs adapter
  (`gateway/fs.RootedOzoneFileSystem`);
- swarm: the closed-loop multi-tenant overload workload over the S3
  gateway (Zipfian keys, mixed sizes, PUT/GET mix; a 503 SlowDown counts
  as shed, not failed);
- geo: geo replication churn: keys under a rule to another cluster, a
  ship cycle, overwrites and deletes, a second cycle, then every key
  checked through the destination (byte-exact, or gone) and the lag;
- omkg: OmKeyGenerator, open and commit of empty keys (no datanode IO,
  the namespace's throughput), over `buckets` buckets so a sharded
  plane spreads them over its shards;
- ommg: OmMetadataGenerator, a mix of create, read (lookup), update
  (rename there and back), delete and list per the `mix` string.

The generators take a port `OzoneClient`, whose `device` the EC coding
runs on: one over an in-process cluster, or one the CLI builds from
`--om` over the RPC (`tools/cli.py`, as the reference's `cmd_freon`
does); `ecrd` also takes an SCM, in process or `RemoteScmClient`; `s3kg`
and `swarm` take a gateway's host:port; `geo` the destination cluster's
OM endpoint. The reference's other generators are not ported yet.
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


def mpug(client, n_uploads: int = 20, parts: int = 3,
         part_size: int = 16 * 1024, threads: int = 4,
         volume: str = "freon-vol", bucket: str = "freon-mpu",
         replication: Optional[str] = None) -> FreonReport:
    """Multipart upload generator: each op runs initiate, `parts` part
    writes and complete, and counts the whole upload."""
    _ensure_bucket(client, volume, bucket, replication or "rs-6-3-1024k")
    b = client.get_volume(volume).get_bucket(bucket)
    payload = np.random.default_rng(2).integers(0, 256, part_size,
                                                dtype=np.uint8)

    def op(i: int) -> int:
        up = b.initiate_multipart_upload(f"mpu-{i}", replication)
        for p in range(1, parts + 1):
            up.write_part(p, payload)
        up.complete()
        return part_size * parts

    return BaseFreonGenerator("mpug", n_uploads, threads).run(op)


def s3kg(endpoint: str, n_keys: int = 100, size: int = 10 * 1024,
         threads: int = 4, bucket: str = "freon-s3",
         validate: bool = False, access_id: Optional[str] = None,
         secret: Optional[str] = None) -> FreonReport:
    """S3 gateway key generator: PUTs (and, with `validate`, GETs compared
    with what was put) over HTTP, the XML, HTTP and auth surface rather
    than the client's RPC. With `access_id` and `secret` every request is
    SigV4-signed, payload hash included; without them it is anonymous."""
    import urllib.request

    from ozone_tpu_torch.gateway.s3_auth import request_headers

    def request(method: str, path: str, data: bytes = b"",
                check: bool = True) -> bytes:
        headers, _ = request_headers(endpoint, method, path, data,
                                     access_id=access_id or None,
                                     secret=secret)
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://{endpoint}{path}", data=data or None,
                    method=method, headers=headers)) as r:
                return r.read()
        except Exception:  # noqa: BLE001 - the bucket may exist
            if check:
                raise
            return b""

    request("PUT", f"/{bucket}", check=False)
    payload = bytes(np.random.default_rng(3).integers(0, 256, size,
                                                      dtype=np.uint8))

    def op(i: int) -> int:
        request("PUT", f"/{bucket}/k{i}", payload)
        if validate:
            got = request("GET", f"/{bucket}/k{i}")
            assert got == payload, f"corrupt s3 key k{i}"
        return size * (2 if validate else 1)

    return BaseFreonGenerator("s3kg", n_keys, threads).run(op)


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


def lcg(client, n_keys: int = 20, size: int = 10 * 1024,
        threads: int = 4, volume: str = "freon-vol",
        bucket: str = "freon-tier", replication: str = "RATIS/THREE",
        target: str = "rs-3-2-4096", prefix: str = "tier",
        age_days: float = 0.0) -> FreonReport:
    """Lifecycle churn (write, sweep, verify): `n_keys` replicated keys
    under an age-based TRANSITION_TO_EC rule, one sweep (`lifecycle
    run-now`), then every key read back byte-exact and checked EC-coded.
    The timer covers the writes; the sweep's outcome rides the extras
    (`transitioned`, `ec_keys`, `verify_failures`, `sweep_bytes`,
    `sweep_dispatches`)."""
    _ensure_bucket(client, volume, bucket, replication)
    client.om.set_bucket_lifecycle(volume, bucket, [{
        "id": "freon-tier", "prefix": prefix, "age_days": age_days,
        "action": "TRANSITION_TO_EC", "target": target,
    }])
    b = client.get_volume(volume).get_bucket(bucket)

    def op(i: int) -> int:
        b.write_key(f"{prefix}-{i}", _det_payload(size, seed=i),
                    replication)
        return size

    rep = BaseFreonGenerator("lcg", n_keys, threads).run(op)
    sweep = client.om.run_lifecycle_once()
    verify_failures = 0
    ec_count = 0
    for i in range(n_keys):
        try:
            info = client.om.lookup_key(volume, bucket, f"{prefix}-{i}")
            got = b.read_key_info(info)
            if not np.array_equal(got, _det_payload(size, seed=i)):
                verify_failures += 1
                continue
            if str(info.get("replication", "")).startswith("rs-"):
                ec_count += 1
        except Exception:  # noqa: BLE001 - counted, the run goes on
            verify_failures += 1
    rep.extras.update({
        "transitioned": sweep.get("transitioned", 0),
        "ec_keys": ec_count,
        "verify_failures": verify_failures,
        "sweep_bytes": sweep.get("bytes", 0),
        "sweep_dispatches": sweep.get("dispatches", 0),
    })
    return rep


def geo(client, dest_endpoint: str, n_keys: int = 20,
        size: int = 10 * 1024, threads: int = 4,
        volume: str = "freon-vol", bucket: str = "freon-geo",
        replication: str = "RATIS/THREE", scheme: str = "",
        prefix: str = "geo", dest_client=None) -> FreonReport:
    """Geo replication churn (write, ship, overwrite, delete, ship,
    verify): `n_keys` keys under a rule to `dest_endpoint`, a ship cycle
    (`replication run-now`), every third key overwritten and every fifth
    of the rest deleted, a second cycle, then every surviving key read
    back byte-exact through the destination (`dest_client`, or one
    dialed on this client's device) and every deleted key checked gone
    there. The timer covers the writes; the extras carry `shipped`,
    `deletes_shipped`, `conflicts`, `ship_bytes`, `verify_failures` and
    `lag_entries`."""
    _ensure_bucket(client, volume, bucket, replication)
    client.om.set_bucket_geo_replication(volume, bucket, [{
        "id": "freon-geo", "endpoint": dest_endpoint, "prefix": prefix,
        "scheme": scheme,
    }])
    b = client.get_volume(volume).get_bucket(bucket)

    def op(i: int) -> int:
        b.write_key(f"{prefix}-{i}", _det_payload(size, seed=i),
                    replication)
        return size

    rep = BaseFreonGenerator("geo", n_keys, threads).run(op)
    ship1 = client.om.run_geo_once()
    # the churn after the first cycle: overwrites supersede shipped
    # replicas and deletes retire them
    expect: dict[str, Optional[int]] = {
        f"{prefix}-{i}": i for i in range(n_keys)}
    for i in range(0, n_keys, 3):
        b.write_key(f"{prefix}-{i}", _det_payload(size, seed=i + 1000),
                    replication)
        expect[f"{prefix}-{i}"] = i + 1000
    for i in range(1, n_keys, 5):
        b.delete_key(f"{prefix}-{i}")
        expect[f"{prefix}-{i}"] = None
    ship2 = client.om.run_geo_once()
    ship = {k: int(ship1.get(k, 0)) + int(ship2.get(k, 0))
            for k in ("keys_shipped", "deletes_shipped", "conflicts",
                      "bytes")}
    remote = None
    if dest_client is None:
        from ozone_tpu_torch.replication_geo.shipper import resolve_cluster

        remote = resolve_cluster(dest_endpoint, device=client.device)
        dest_client = remote.oz
    try:
        db = dest_client.get_volume(volume).get_bucket(bucket)
        verify_failures = 0
        for name, seed in expect.items():
            try:
                info = dest_client.om.lookup_key(volume, bucket, name)
            except Exception:  # noqa: BLE001 - absent at the destination
                if seed is not None:
                    verify_failures += 1
                continue
            if seed is None:  # deleted at the source, still there
                verify_failures += 1
                continue
            if not np.array_equal(db.read_key_info(info),
                                  _det_payload(size, seed=seed)):
                verify_failures += 1
    finally:
        if remote is not None:
            remote.close()
    status = client.om.geo_status()
    rep.extras.update({
        "shipped": ship["keys_shipped"],
        "deletes_shipped": ship["deletes_shipped"],
        "conflicts": ship["conflicts"],
        "ship_bytes": ship["bytes"],
        "verify_failures": verify_failures,
        "lag_entries": (status.get("lag") or {}).get("entries", 0),
    })
    return rep


#: the tiny-key size mix, 80/15/5: inline, needle, large needle
TINY_SIZES = (512, 4 * 1024, 48 * 1024)


def _tiny_size(i: int, size: int, mix: bool) -> int:
    if not mix:
        return size
    r = i % 20
    if r < 16:
        return TINY_SIZES[0]
    if r < 19:
        return TINY_SIZES[1]
    return TINY_SIZES[2]


def tinyg(client, n_keys: int = 200, size: int = 4 * 1024,
          threads: int = 8, volume: str = "freon-vol",
          bucket: str = "freon-tiny",
          replication: str = "rs-3-2-4096", prefix: str = "tiny",
          packer: bool = True, mix: bool = False,
          validate: bool = True) -> FreonReport:
    """Tiny keys into a small-object EC bucket: inline values land in the
    OM key row, needles coalesce through the client's SlabPacker into
    shared EC stripes committed by CommitKeys. `packer=False` writes the
    same keys with an explicit per-key replication, so every key takes
    the open/allocate/commit stripe path (the before/after pair).
    `mix=True` draws sizes from TINY_SIZES instead of `size`. The extras
    say how the keys landed (inline, needle and regular counts, distinct
    slabs) and count byte-exact `verify_failures`."""
    _ensure_bucket(client, volume, bucket, replication)
    if packer:
        client.om.set_bucket_smallobj(volume, bucket)
    b = client.get_volume(volume).get_bucket(bucket)
    # an explicit replication pins the per-key stripe path: write_key
    # routes tiny keys only when the caller leaves it unset
    per_key_repl = None if packer else replication

    def op(i: int) -> int:
        sz = _tiny_size(i, size, mix)
        b.write_key(f"{prefix}-{i}", _det_payload(sz, seed=i), per_key_repl)
        return sz

    rep = BaseFreonGenerator("tinyg", n_keys, threads).run(op)
    if packer:
        client.packer.flush()
    inline = needle = regular = verify_failures = 0
    slabs: set = set()
    for i in range(n_keys):
        try:
            info = client.om.lookup_key(volume, bucket, f"{prefix}-{i}")
            if info.get("inline") is not None:
                inline += 1
            elif info.get("needle"):
                needle += 1
                slabs.add(info["needle"]["slab"])
            else:
                regular += 1
            if validate:
                got = b.read_key_info(info)
                want = _det_payload(_tiny_size(i, size, mix), seed=i)
                if not np.array_equal(got, want):
                    verify_failures += 1
        except Exception:  # noqa: BLE001 - counted, the run goes on
            verify_failures += 1
    rep.extras.update({
        "packer": packer,
        "inline_keys": inline,
        "needle_keys": needle,
        "regular_keys": regular,
        "slabs": len(slabs),
        "verify_failures": verify_failures,
    })
    rep.extras.update(_client_hist_extras())
    return rep


def fskg(client, n_files: int = 100, size: int = 10 * 1024,
         depth: int = 3, threads: int = 4, volume: str = "freon-vol",
         bucket: str = "freon-fso",
         replication: Optional[str] = None) -> FreonReport:
    """Nested-file generator over an FSO bucket (HadoopNestedDirGenerator
    and the file-create family): each op creates a file `depth`
    directories down, the directory-tree resolve and create path rather
    than the flat key table."""
    try:
        client.om.create_volume(volume)
    except Exception:
        pass
    try:
        client.om.create_bucket(volume, bucket,
                                replication or "rs-6-3-1024k",
                                layout="FILE_SYSTEM_OPTIMIZED")
    except Exception:
        pass
    b = client.get_volume(volume).get_bucket(bucket)
    payload = np.random.default_rng(1).integers(0, 256, size,
                                                dtype=np.uint8)

    def op(i: int) -> int:
        parts = [f"d{(i >> (4 * d)) & 0xF}" for d in range(depth)]
        b.write_key("/".join(parts) + f"/f{i}", payload, replication)
        return size

    return BaseFreonGenerator("fskg", n_files, threads).run(op)


def fsg(client, n_files: int = 50, size: int = 10 * 1024,
        threads: int = 4, volume: str = "freon-vol",
        bucket: str = "freon-ofs",
        replication: Optional[str] = None) -> FreonReport:
    """ofs filesystem generator (HadoopFsGenerator): each op is a create
    and a read-back through the RootedOzoneFileSystem adapter, the path
    HttpFS and Hadoop-compatible workloads take."""
    from ozone_tpu_torch.gateway.fs import RootedOzoneFileSystem

    fs = RootedOzoneFileSystem(client,
                               replication=replication or "rs-6-3-1024k")
    fs.mkdirs(f"/{volume}/{bucket}")
    payload = bytes(np.random.default_rng(4).integers(
        0, 256, size, dtype=np.uint8))

    def op(i: int) -> int:
        p = f"/{volume}/{bucket}/d{i % 8}/f{i}"
        fs.create(p, payload)
        with fs.open(p) as f:
            got = f.read()
        assert len(got) == size
        return size * 2

    return BaseFreonGenerator("fsg", n_files, threads).run(op)


def _freon_buckets(client, volume: str, bucket: str,
                   buckets: int) -> list[str]:
    """Create the generator's bucket set. buckets > 1 spreads ops over
    `bucket-<j>` names: on a sharded metadata plane the (volume, bucket)
    hash then fans the load over the shard rings instead of serializing
    it on one ring's slot."""
    try:
        client.om.create_volume(volume)
    except Exception:
        pass
    names = ([bucket] if buckets <= 1
             else [f"{bucket}-{j}" for j in range(buckets)])
    for name in names:
        try:
            client.om.create_bucket(volume, name)
        except Exception:
            pass
    return names


def omkg(client, n_keys: int = 1000, threads: int = 8,
         volume: str = "freon-vol", bucket: str = "freon-meta",
         buckets: int = 1) -> FreonReport:
    """Pure OM metadata op generator: open and commit empty keys without
    any datanode IO (OmKeyGenerator: the namespace's throughput)."""
    names = _freon_buckets(client, volume, bucket, buckets)

    def op(i: int) -> int:
        b = names[i % len(names)]
        s = client.om.open_key(volume, b, f"meta-{i}")
        client.om.commit_key(s, [], 0)
        return 0

    return BaseFreonGenerator("omkg", n_keys, threads).run(op)


def ommg(client, n_ops: int = 1000, threads: int = 8,
         volume: str = "freon-vol", bucket: str = "freon-meta",
         mix: str = "crudl", buckets: int = 1) -> FreonReport:
    """Mixed OM metadata ops (OmMetadataGenerator): cycles create,
    read (lookup), update (rename), delete and list per the mix."""
    bad = set(mix) - set("crudl")
    if not mix or bad:
        raise ValueError(f"mix must be chars from 'crudl', got {mix!r}")
    names = _freon_buckets(client, volume, bucket, buckets)
    # seed keys the read and delete ops can hit (every bucket gets the
    # whole seed set: op i addresses bucket i % len(names))
    for name in names:
        for i in range(min(64, n_ops)):
            s = client.om.open_key(volume, name, f"mix-{i}")
            client.om.commit_key(s, [], 0)

    def op(i: int) -> int:
        kind = mix[i % len(mix)]
        b = names[i % len(names)]
        name = f"mix-{i % 64}"
        if kind == "c":
            s = client.om.open_key(volume, b, f"mix-new-{i}")
            client.om.commit_key(s, [], 0)
        elif kind == "r":
            client.om.lookup_key(volume, b, name)
        elif kind == "u":
            client.om.rename_key(volume, b, name, name + ".r")
            client.om.rename_key(volume, b, name + ".r", name)
        elif kind == "d":
            s = client.om.open_key(volume, b, f"mix-del-{i}")
            client.om.commit_key(s, [], 0)
            client.om.delete_key(volume, b, f"mix-del-{i}")
        elif kind == "l":
            client.om.list_keys(volume, b, "mix-")
        return 0

    return BaseFreonGenerator("ommg", n_ops, threads).run(op)


def swarm(endpoint: str, tenants: list, duration_s: float = 4.0,
          threads_per_tenant: int = 2, n_keys: int = 64,
          sizes: tuple = (4 * 1024, 64 * 1024), zipf_a: float = 1.2,
          seed: int = 1234, bucket: str = "swarm",
          tiny: bool = False) -> FreonReport:
    """freon swarm: the standing multi-tenant overload workload, over the
    S3 gateway and its admission control.

    N simulated tenants drive the S3 gateway closed-loop through
    SigV4-signed HTTP — Zipfian key popularity over a bounded working
    set, mixed op sizes (mostly small, some bulk), mixed PUT/GET. Each
    tenant dict carries {"name", "access_id", "secret", "rate"}: rate
    is its offered ops/s (0 = unpaced, as fast as the loop turns), so
    the caller ramps offered load — 1x capacity, then 2x with an
    aggressor unpaced — without changing the workload shape.

    503 SlowDown responses are counted as SHED, not failures: a shed op
    is the admission system doing its job, and the report separates the
    three outcomes (ok / shed / errors) per tenant so shed-not-collapse
    is checkable — goodput and accepted-op latency per tenant, shed
    fraction overall.
    """
    import bisect
    import datetime
    import random as _random
    import urllib.error
    import urllib.request

    from ozone_tpu_torch.gateway.s3_auth import sign_request

    if tiny:
        # tiny-key churn mode: the tinyg size mix drives the swarm, so
        # the overload drills exercise the inline/needle path too (the
        # gateway-side bucket must be smallobj-enabled by the caller)
        sizes = TINY_SIZES
    base = f"http://{endpoint}"

    def _amz_now() -> str:
        return datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")

    def _request(t: dict, method: str, path: str,
                 body: bytes = b"") -> None:
        url = f"{base}{path}"
        headers = {"host": endpoint, "x-amz-date": _amz_now()}
        if t.get("access_id"):
            headers = sign_request(t["access_id"], t["secret"], method,
                                   url, headers, body)
        req = urllib.request.Request(
            url, data=body if method in ("PUT", "POST") else None,
            method=method, headers=headers)
        with urllib.request.urlopen(req) as r:
            r.read()

    # Zipfian popularity: cumulative weights over key ranks, sampled by
    # bisect — rank 0 is the hot key, the tail cools as 1/rank^a
    cum: list[float] = []
    acc = 0.0
    for r in range(max(1, n_keys)):
        acc += 1.0 / (r + 1) ** zipf_a
        cum.append(acc)
    payloads = {sz: bytes(np.random.default_rng(11).integers(
        0, 256, sz, dtype=np.uint8)) for sz in sizes}

    for t in tenants:
        try:
            _request(t, "PUT", f"/{bucket}")
        except Exception:
            pass  # BucketAlreadyExists across phases

    lock = threading.Lock()
    stats = {t["name"]: {"offered": 0, "ok": 0, "shed": 0, "errors": 0,
                         "bytes": 0, "lat": []} for t in tenants}
    written: dict[str, set] = {t["name"]: set() for t in tenants}
    start = time.monotonic()
    end = start + duration_s

    def worker(t: dict, wid: int) -> None:
        st = stats[t["name"]]
        seen = written[t["name"]]
        rng = _random.Random(f"{seed}:{t['name']}:{wid}")
        rate = float(t.get("rate") or 0.0)
        interval = threads_per_tenant / rate if rate > 0 else 0.0
        next_t = time.monotonic() + rng.uniform(0, interval or 0.001)
        while True:
            now = time.monotonic()
            if now >= end:
                return
            if interval:
                # paced offered load: ops fire on a schedule, late ops
                # do NOT bunch up (the schedule advances regardless)
                if next_t >= end:
                    return
                if next_t > now:
                    time.sleep(next_t - now)
                next_t += interval
            rank = bisect.bisect_left(cum, rng.uniform(0.0, cum[-1]))
            key = f"{t['name']}-k{rank}"
            size = sizes[0] if rng.random() < 0.8 else sizes[-1]
            do_put = rank not in seen or rng.random() < 0.5
            s0 = time.perf_counter()
            try:
                if do_put:
                    _request(t, "PUT", f"/{bucket}/{key}",
                             payloads[size])
                else:
                    _request(t, "GET", f"/{bucket}/{key}")
                dt = time.perf_counter() - s0
                with lock:
                    st["offered"] += 1
                    st["ok"] += 1
                    st["bytes"] += size
                    st["lat"].append(dt)
                if do_put:
                    seen.add(rank)
            except urllib.error.HTTPError as e:
                e.close()
                with lock:
                    st["offered"] += 1
                    if e.code == 503:
                        st["shed"] += 1
                    else:
                        st["errors"] += 1
            except Exception:
                with lock:
                    st["offered"] += 1
                    st["errors"] += 1

    threads = [threading.Thread(target=worker, args=(t, w), daemon=True)
               for t in tenants for w in range(threads_per_tenant)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    elapsed = time.monotonic() - start

    def _p99(lat: list) -> float:
        if not lat:
            return 0.0
        ls = sorted(lat)
        return ls[min(len(ls) - 1, int(0.99 * len(ls)))]

    all_lat: list[float] = []
    per_tenant = {}
    offered = ok = shed = errors = nbytes = 0
    for name, st in stats.items():
        all_lat.extend(st["lat"])
        offered += st["offered"]
        ok += st["ok"]
        shed += st["shed"]
        errors += st["errors"]
        nbytes += st["bytes"]
        per_tenant[name] = {
            "offered": st["offered"],
            "ok": st["ok"],
            "shed": st["shed"],
            "errors": st["errors"],
            "goodput_ops_s": round(st["ok"] / elapsed, 2)
            if elapsed else 0.0,
            "p99_ms": round(1e3 * _p99(st["lat"]), 3),
        }
    return FreonReport(
        "swarm", ops=ok, failures=errors, elapsed_s=elapsed,
        latencies_s=all_lat, bytes_processed=nbytes,
        extras={
            "per_tenant": per_tenant,
            "offered": offered,
            "shed": shed,
            "shed_fraction": round(shed / offered, 4) if offered else 0.0,
            "goodput_ops_s": round(ok / elapsed, 2) if elapsed else 0.0,
        })
