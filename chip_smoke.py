#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernel-only]

Builds the port's CUDA kernels from `ozone_tpu_torch/csrc` (nvcc, sm_90a),
holds every kernel against its plain PyTorch version on the card, in its
encode and its decode form, then drives the port's main paths:

- four concurrent RS(6,3) key PUTs through `ECKeyWriter` into nine
  in-process datanodes, read back and checked against the source bytes
  and the plain version's parity and CRCs;
- RS(10,4) read and repair: two keys PUT into 16 datanodes, read whole
  through `ECBlockGroupReader` healthy, then with two data units down
  (whole and ranged), their replicas rebuilt onto two spares by
  `ECReconstructionCoordinator`, and read again through the rebuilt
  replicas with two other units down.

Every failure raises. The last line is one JSON object with "ok" and the
device; the line before it is nvidia-smi's name and power limit, and the
one before that the kernels' JSON line. --kernel-only stops after the
build, the kernel cases and the timings (no main paths; the kernels' JSON
then has "launches": null) and prints the same last lines.

It exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

MIB = 1 << 20
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, int8 ops/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls: int = 1, rounds: int = 20) -> float:
    """Device time per call: CUDA events around `calls` back-to-back calls
    of fn(), divided by `calls`; the median of `rounds` such runs, after
    one warm-up. With one call a round, host time inside the call that
    leaves the card idle counts; in a run of calls the host enqueues
    ahead, so its time hides unless a call launches slower than it runs."""
    fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def fused_bound(b: int, k: int, p: int, cell: int, bpc: int,
                rows: int | None = None) -> tuple[float, str]:
    """(least ms, what bounds it) for one fused pass over [b, k, cell] that
    writes p output rows and CRCs `rows` rows (k + p for encode, the p
    recovered rows for decode): each input byte read once, outputs and CRC
    words written once; the operations are p GF multiply-adds per input
    byte plus one CRC step per byte of each CRC'd row, counted against the
    int8 peak."""
    rows = k + p if rows is None else rows
    moved = b * k * cell + b * p * cell + b * rows * (cell // bpc) * 4
    ops = b * cell * (2 * k * p + rows)
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, ops / INT8_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel phase
def check_kernel_cases(device, cases, seed: int) -> float:
    """Kernel against plain on each (k, p, cell, bpc, B, checksum[, crc_in])
    case, exact on every byte and word; sampled slices against the host
    CRC. p = 0 is a plain slice CRC of the k inputs. Returns the largest
    difference seen (0 when every case agrees)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _POLY, _parity_matrix
    from ozone_tpu_torch.utils.checksum import ChecksumType, crc32c

    rng = np.random.default_rng(seed)
    worst = 0
    for k, p, cell, bpc, b, checksum, *rest in cases:
        crc_in = rest[0] if rest else True
        data = torch.from_numpy(rng.integers(0, 256, (b, k, cell), dtype=np.uint8)).to(device)
        matrix = (_parity_matrix(CoderOptions(k, p, cell_size=cell)) if p
                  else np.zeros((0, k), dtype=np.uint8))
        matrix = torch.from_numpy(matrix).to(device)
        poly = _POLY.get(ChecksumType[checksum])
        out, crcs = fused_kernel.fused_encode_crc(data, matrix, poly, bpc, crc_in)
        pout, pcrcs = fused_kernel.fused_encode_crc_plain(data, matrix, poly, bpc, crc_in)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = max((out.int() - pout.int()).abs().max().item() if out.numel() else 0,
                   (crcs.long() - pcrcs.long()).abs().max().item() if crcs.numel() else 0)
        worst = max(worst, diff)
        rows = (k if crc_in else 0) + p if poly else 0
        shape_ok = out.shape == (b, p, cell) and crcs.shape == (b, rows, cell // bpc)
        print(f"kernel vs plain rs-{k}-{p} cell={cell} bpc={bpc} B={b} {checksum} "
              f"crc_in={crc_in}: max_abs_err={diff} crcs={tuple(crcs.shape)}")
        if diff or not shape_ok:
            raise AssertionError(f"kernel disagrees with plain on rs-{k}-{p} cell={cell} "
                                 f"bpc={bpc} B={b} {checksum} crc_in={crc_in}")
        if poly is None:
            continue
        units = torch.cat([data, out] if crc_in else [out], 1).cpu().numpy()
        words = crcs.cpu().numpy().view(np.uint32)
        host = crc32c if checksum == "CRC32C" else (lambda a: zlib.crc32(a.tobytes()))
        for _ in range(64 if bpc < cell else 8):
            bi, u, s = (int(rng.integers(n)) for n in (b, rows, cell // bpc))
            want = host(units[bi, u, s * bpc:(s + 1) * bpc])
            if int(words[bi, u, s]) != want:
                raise AssertionError(f"CRC of slice {(bi, u, s)} != host {checksum}")
    return worst


def check_decode_cases(device, cases, seed: int) -> float:
    """The kernel in decode form (an [e, v] recovery matrix, crc_in=False)
    against plain on each (k, p, valid, erased, cell, bpc, B, checksum)
    case: a seeded codeword is encoded by the plain version, the `valid`
    units go in, and the recovered rows must equal the plain version's and
    the erased units, exact; sampled slices against the host CRC. Returns
    the largest difference seen."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _POLY, _decode_matrix, _parity_matrix
    from ozone_tpu_torch.utils.checksum import ChecksumType, crc32c

    rng = np.random.default_rng(seed)
    worst = 0
    for k, p, valid, erased, cell, bpc, b, checksum in cases:
        opts = CoderOptions(k, p, cell_size=cell)
        data = torch.from_numpy(rng.integers(0, 256, (b, k, cell), dtype=np.uint8)).to(device)
        parity, _ = fused_kernel.fused_encode_crc_plain(
            data, torch.from_numpy(_parity_matrix(opts)).to(device), None, bpc)
        units = torch.cat([data, parity], 1)
        inputs = units[:, valid].contiguous()
        matrix = torch.from_numpy(_decode_matrix(opts, valid, erased)).to(device)
        poly = _POLY.get(ChecksumType[checksum])
        rec, crcs = fused_kernel.fused_encode_crc(inputs, matrix, poly, bpc, crc_in=False)
        prec, pcrcs = fused_kernel.fused_encode_crc_plain(inputs, matrix, poly, bpc,
                                                          crc_in=False)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = max((rec.int() - prec.int()).abs().max().item(),
                   (crcs.long() - pcrcs.long()).abs().max().item() if crcs.numel() else 0)
        worst = max(worst, diff)
        rows = len(erased) if poly else 0
        name = f"rs-{k}-{p} valid={valid} erased={erased} bpc={bpc} B={b} {checksum}"
        print(f"decode kernel vs plain {name}: max_abs_err={diff} crcs={tuple(crcs.shape)}")
        if diff or crcs.shape != (b, rows, cell // bpc):
            raise AssertionError(f"decode kernel disagrees with plain on {name}")
        if not torch.equal(rec, units[:, erased]):
            raise AssertionError(f"decode of {name} does not give the erased units")
        if poly is None:
            continue
        rec_np, words = rec.cpu().numpy(), crcs.cpu().numpy().view(np.uint32)
        host = crc32c if checksum == "CRC32C" else (lambda a: zlib.crc32(a.tobytes()))
        for _ in range(32):
            bi, u, sl = (int(rng.integers(n)) for n in (b, rows, cell // bpc))
            if int(words[bi, u, sl]) != host(rec_np[bi, u, sl * bpc:(sl + 1) * bpc]):
                raise AssertionError(f"CRC of slice {(bi, u, sl)} of {name} != host")
    return worst


def time_decode(device, cell: int, bpc: int, b: int, seed: int) -> dict:
    """The kernel in decode form at the degraded read's shape: RS(10,4),
    units 0 and 1 rebuilt from units 2..11, CRC32C over the two rows."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _decode_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    valid, erased = list(range(2, 12)), [0, 1]
    rng = np.random.default_rng(seed)
    units = torch.from_numpy(rng.integers(0, 256, (b, len(valid), cell), dtype=np.uint8)).to(device)
    matrix = torch.from_numpy(_decode_matrix(CoderOptions(10, 4, cell_size=cell),
                                             valid, erased)).to(device)

    def run():
        return fused_kernel.fused_encode_crc(units, matrix, CRC32C_POLY, bpc, crc_in=False)

    ms = cuda_ms(run)
    in_run_ms = cuda_ms(run, calls=20, rounds=5)
    plain_ms = cuda_ms(lambda: fused_kernel.fused_encode_crc_plain(
        units, matrix, CRC32C_POLY, bpc, crc_in=False), rounds=5)
    bound_ms, bound_by = fused_bound(b, len(valid), len(erased), cell, bpc, rows=len(erased))
    print(f"fused_encode_crc decode rs-10-4 e=2 v=10 cell={cell} bpc={bpc} B={b}: "
          f"{ms:.4f} ms a single call ({in_run_ms:.4f} ms a call in a run of 20), "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{b * len(valid) * cell / MIB / ms * 1e3 / 1024:.2f} GiB/s in, plain {plain_ms:.4f} ms")
    return {"ms": ms, "ms_in_run": in_run_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def time_kernel(device, k: int, p: int, cell: int, bpc: int, b: int,
                seed: int, plain: bool) -> dict:
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _parity_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, (b, k, cell), dtype=np.uint8)).to(device)
    matrix = torch.from_numpy(_parity_matrix(CoderOptions(k, p, cell_size=cell))).to(device)

    def run():
        return fused_kernel.fused_encode_crc(data, matrix, CRC32C_POLY, bpc)

    before = fused_kernel.launches.count
    ms = cuda_ms(run)
    in_run_ms = cuda_ms(run, calls=20, rounds=5)
    launched = fused_kernel.launches.count - before
    plain_ms = (cuda_ms(lambda: fused_kernel.fused_encode_crc_plain(
        data, matrix, CRC32C_POLY, bpc), rounds=5) if plain else None)
    bound_ms, bound_by = fused_bound(b, k, p, cell, bpc)
    print(f"fused_encode_crc rs-{k}-{p} cell={cell} bpc={bpc} B={b}: "
          f"{ms:.4f} ms a single call ({in_run_ms:.4f} ms a call in a run of 20), "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{b * k * cell / MIB / ms * 1e3 / 1024:.2f} GiB/s in, launches {launched}"
          + (f", plain {plain_ms:.4f} ms" if plain else ""))
    return {"ms": ms, "ms_in_run": in_run_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_parts(device, k: int, p: int, cell: int, bpc: int, b: int, seed: int) -> None:
    """The kernel's two halves apart, at one shape: the GF apply with no
    CRC, and the CRC alone over as many rows (p = 0, k + p input rows)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _parity_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, (b, k + p, cell), dtype=np.uint8)).to(device)
    matrix = torch.from_numpy(_parity_matrix(CoderOptions(k, p, cell_size=cell))).to(device)
    inputs = data[:, :k].contiguous()
    no_rows = torch.zeros((0, k + p), dtype=torch.uint8, device=device)
    gf_ms = cuda_ms(lambda: fused_kernel.fused_encode_crc(inputs, matrix, None, bpc),
                    calls=20, rounds=5)
    crc_ms = cuda_ms(lambda: fused_kernel.fused_encode_crc(data, no_rows, CRC32C_POLY, bpc),
                     calls=20, rounds=5)
    print(f"fused_encode_crc rs-{k}-{p} B={b} apart: GF apply alone {gf_ms:.4f} ms, "
          f"CRC alone over {k + p} rows {crc_ms:.4f} ms")


# --------------------------------------------------------------- main path
class Cluster:
    """In-process port datanodes and a naive group allocator that takes the
    first k+p of them. The client factory raises for a node in `dead`, as
    for a node that is down."""

    def __init__(self, root: Path, opts, n_dn: int):
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        from ozone_tpu_torch.storage.datanode import Datanode

        class Factory(DatanodeClientFactory):
            def get(self, dn_id):
                if dn_id in cluster.dead:
                    raise KeyError(f"datanode {dn_id} is down")
                return super().get(dn_id)

        cluster = self
        self.opts = opts
        self.dead: set[str] = set()
        self.dns = {f"dn{i}": Datanode(root / f"dn{i}", dn_id=f"dn{i}")
                    for i in range(n_dn)}
        self.clients = Factory()
        for dn in self.dns.values():
            self.clients.register_local(dn)
        self._lock = threading.Lock()
        self._next = 0

    def allocate(self, excluded):
        from ozone_tpu_torch.client.ec_writer import BlockGroup
        from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig

        nodes = [d for d in self.dns if d not in excluded][:self.opts.all_units]
        if len(nodes) < self.opts.all_units:
            raise RuntimeError("not enough datanodes")
        with self._lock:
            self._next += 1
            n = self._next
        return BlockGroup(container_id=n, local_id=n, pipeline=Pipeline(
            ReplicationConfig.from_ec(self.opts), nodes))

    def close(self):
        for dn in self.dns.values():
            dn.close()


def put_keys(cluster: Cluster, keys: list[np.ndarray], device, bpc: int):
    """PUT every key on its own thread; returns (groups per key, writers)."""
    from ozone_tpu_torch.client.ec_writer import ECKeyWriter

    results: list = [None] * len(keys)
    errors: list = []

    def put(i):
        try:
            w = ECKeyWriter(cluster.opts, cluster.allocate, cluster.clients,
                            bytes_per_checksum=bpc, device=device)
            data = keys[i]
            for pos in range(0, data.size, 4 * MIB):  # a client's write calls
                w.write(data[pos:pos + 4 * MIB])
            results[i] = (w.close(), w)
        except BaseException as e:  # reported and re-raised by the caller
            errors.append(e)

    threads = [threading.Thread(target=put, args=(i,)) for i in range(len(keys))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            raise TimeoutError("a PUT did not finish")
    if errors:
        raise errors[0]
    return [r[0] for r in results], [r[1] for r in results]


def verify_keys(cluster: Cluster, keys, groups_per_key, device, bpc: int,
                seed: int, samples: int) -> dict:
    """Read every chunk back: data chunks equal the source bytes, parity
    chunks and full-cell CRCs equal the plain version's on `device`, and a
    sample of chunks (the partial ones included) pass read_chunk(verify)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.fused import _POLY, _parity_matrix
    from ozone_tpu_torch.storage.ids import StorageError
    from ozone_tpu_torch.utils.checksum import ChecksumType

    opts = cluster.opts
    k, p, cell = opts.data_units, opts.parity_units, opts.cell_size
    matrix = torch.from_numpy(_parity_matrix(opts)).to(device)
    poly = _POLY[ChecksumType.CRC32C]
    rng = np.random.default_rng(seed)
    chunks = verified = partial = 0
    refs = []
    for data, groups in zip(keys, groups_per_key):
        if sum(g.length for g in groups) != data.size:
            raise AssertionError("committed lengths do not add up to the key")
        base = 0
        for g in groups:
            n_stripes = -(-g.length // (k * cell))
            stripes = np.zeros((n_stripes, k, cell), dtype=np.uint8)
            stripes.reshape(-1)[:g.length] = data[base:base + g.length]
            base += g.length
            for s0 in range(0, n_stripes, 8):
                batch = torch.from_numpy(stripes[s0:s0 + 8]).to(device)
                par, crcs = fused_kernel.fused_encode_crc_plain(batch, matrix, poly, bpc)
                par, crcs = par.cpu().numpy(), crcs.cpu().numpy().view(np.uint32)
                for u, dn_id in enumerate(g.pipeline.nodes):
                    dn = cluster.dns[dn_id]
                    try:
                        block = dn.get_block(g.block_id)
                    except StorageError:  # a unit the key's data never reached
                        block = None
                    infos = {c.offset // cell: c for c in (block.chunks if block else [])}
                    for j in range(par.shape[0]):
                        s = s0 + j
                        info = infos.get(s)
                        want = stripes[s, u] if u < k else par[j, u - k]
                        if info is None:
                            if u < k and s * k * cell + u * cell < g.length:
                                raise AssertionError(f"missing chunk {g.block_id} {u}/{s}")
                            continue
                        refs.append((dn, g.block_id, info))
                        got = dn.read_chunk(g.block_id, info)
                        chunks += 1
                        if not np.array_equal(got, want[:info.length]):
                            raise AssertionError(f"chunk {info.name} unit {u} differs")
                        if info.length == cell:
                            stored = [int.from_bytes(c, "big") for c in info.checksum.checksums]
                            if stored != crcs[j, u].tolist():
                                raise AssertionError(f"stored CRCs of {info.name} unit {u} "
                                                     "differ from the plain version")
                        else:
                            partial += 1
                            dn.read_chunk(g.block_id, info, verify=True)
                            verified += 1
    for i in rng.choice(len(refs), min(samples, len(refs)), replace=False):
        dn, bid, info = refs[int(i)]
        dn.read_chunk(bid, info, verify=True)
        verified += 1
    return {"chunks": chunks, "verified": verified, "partial": partial}


def main_path(device, key_sizes, cell: int, bpc: int, seed: int) -> dict:
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions

    opts = CoderOptions(6, 3, "rs", cell_size=cell)
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in key_sizes]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        cluster = Cluster(Path(tmp), opts, opts.all_units)
        try:
            fused_kernel.launches.reset()
            t0 = time.perf_counter()
            groups, writers = put_keys(cluster, keys, device, bpc)
            wall = time.perf_counter() - t0
            launches = fused_kernel.launches.count
            dispatches = sum(w.dispatches for w in writers)
            disk = sum(f.stat().st_size for f in Path(tmp).rglob("*.block"))
            checked = verify_keys(cluster, keys, groups, device, bpc, seed, 64)
        finally:
            cluster.close()
    total = sum(key_sizes)
    print(f"main path: {len(keys)} concurrent rs-6-3 PUTs, {total} B of user data "
          f"in {wall:.3f} s = {total / wall / 2**30:.3f} GiB/s (wall); "
          f"kernel launches {launches}, writer dispatches {dispatches}; "
          f"{disk} B of chunk files on disk; {checked['chunks']} chunks read back, "
          f"{checked['verified']} verified ({checked['partial']} partial)")
    if device.type == "cuda" and (launches <= 0 or launches != dispatches):
        raise AssertionError(f"{launches} kernel launches for {dispatches} dispatches")
    if checked["verified"] < 64 or not checked["partial"]:
        raise AssertionError("too few chunks verified")
    return {"launches": launches, "dispatches": dispatches, "wall_s": wall}


def read_groups(cluster: Cluster, keys, groups_per_key, device, bpc: int,
                verify: bool = True) -> dict:
    """read_all every block group of every key through a fresh reader (the
    datanodes check each chunk's stored CRCs unless `verify` is off); each
    must equal its source bytes. Returns user bytes, wall seconds of the
    reads, and decode dispatches."""
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader

    total = dispatches = 0
    wall = 0.0
    for data, groups in zip(keys, groups_per_key):
        base = 0
        for g in groups:
            reader = ECBlockGroupReader(g, cluster.opts, cluster.clients, verify=verify,
                                        bytes_per_checksum=bpc, device=device)
            t0 = time.perf_counter()
            got = reader.read_all()
            wall += time.perf_counter() - t0
            if not np.array_equal(got, data[base:base + g.length]):
                raise AssertionError(f"read of group {g.block_id} differs from the source")
            base += g.length
            total += g.length
            dispatches += reader.dispatches
    return {"bytes": total, "wall_s": wall, "dispatches": dispatches}


def ranged_reads(cluster: Cluster, keys, groups_per_key, device, bpc: int) -> dict:
    """Ranged reads across cell and stripe boundaries of every group, the
    partial tail included; each must equal its source bytes."""
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader

    cell, row = cluster.opts.cell_size, cluster.opts.data_units * cluster.opts.cell_size
    n = dispatches = 0
    for data, groups in zip(keys, groups_per_key):
        base = 0
        for g in groups:
            reader = ECBlockGroupReader(g, cluster.opts, cluster.clients,
                                        bytes_per_checksum=bpc, device=device)
            for off, length in ((cell - 100, 200), (row - 50, 100),
                                (row + cell // 2, 3 * cell),
                                (g.length - cell - 77, cell + 77)):
                if off < 0 or off + length > g.length:
                    continue
                got = reader.read(off, length)
                if not np.array_equal(got, data[base + off:base + off + length]):
                    raise AssertionError(f"ranged read {off}+{length} of {g.block_id} differs")
                n += 1
            base += g.length
            dispatches += reader.dispatches
    return {"ranges": n, "dispatches": dispatches}


def span_totals(since: float) -> str:
    """The port tracer's spans that started at or after `since` (time.time()),
    by name: count and seconds summed over all threads."""
    from ozone_tpu_torch.utils.tracing import Tracer

    totals: dict[str, list] = {}
    for s in Tracer.instance().traces():
        if s.start >= since:
            t = totals.setdefault(s.name, [0, 0.0])
            t[0] += 1
            t[1] += s.duration
    return ", ".join(f"{name} {n} x {secs:.3f} s" for name, (n, secs) in sorted(totals.items()))


def check_launches(what: str, device, launches: int, dispatches: int) -> None:
    """On the card, every decode dispatch is one kernel launch, and the
    path launched at least once."""
    print(f"{what}: decode launches {launches}, decode dispatches {dispatches}")
    if device.type == "cuda" and (launches <= 0 or launches != dispatches):
        raise AssertionError(f"{what}: {launches} kernel launches for {dispatches} dispatches")


def check_rebuilt(cluster: Cluster, groups, lost, spares, bpc: int) -> dict:
    """Every rebuilt replica is CLOSED with the lost replica index, and each
    of its chunks equals the lost unit's stored chunk, with stored CRCs
    equal to the host CRC32C of its bytes."""
    from concurrent.futures import ThreadPoolExecutor

    from ozone_tpu_torch.storage.ids import ContainerState
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    host = Checksum(ChecksumType.CRC32C, bpc)
    pairs = []
    per_target = dict.fromkeys(spares, 0)
    for g in groups:
        for u, spare in zip(lost, spares):
            src, dst = cluster.dns[g.pipeline.nodes[u]], cluster.dns[spare]
            c = dst.containers.get(g.container_id)
            if c.state is not ContainerState.CLOSED or c.replica_index != u + 1:
                raise AssertionError(f"rebuilt container {g.container_id} on {spare} is "
                                     f"{c.state.value}, replica index {c.replica_index}")
            sblk, dblk = src.get_block(g.block_id), dst.get_block(g.block_id)
            if [(i.offset, i.length) for i in sblk.chunks] != \
                    [(i.offset, i.length) for i in dblk.chunks]:
                raise AssertionError(f"rebuilt chunk list of {g.block_id} unit {u} differs")
            per_target[spare] += dblk.length
            pairs += [(src, dst, g.block_id, si, di)
                      for si, di in zip(sblk.chunks, dblk.chunks)]

    def check(pair):
        src, dst, bid, si, di = pair
        got = dst.read_chunk(bid, di)
        if not np.array_equal(got, src.read_chunk(bid, si)):
            raise AssertionError(f"rebuilt chunk {di.name} differs from the lost one")
        if host.compute(got).checksums != di.checksum.checksums:
            raise AssertionError(f"stored CRCs of rebuilt chunk {di.name} != host CRC32C")
        return di.length < cluster.opts.cell_size

    with ThreadPoolExecutor(8) as pool:
        partial = sum(pool.map(check, pairs))
    return {"chunks": len(pairs), "partial": partial, "per_target": per_target}


def read_repair_path(device, key_sizes, cell: int, bpc: int, seed: int) -> dict:
    """RS(10,4) read and repair: PUT the keys into 16 datanodes (groups on
    the first 14), read every group healthy, then with the datanodes of
    units 0 and 1 down (whole and ranged), rebuild replica indexes 1 and 2
    of every container onto the two spares, and read again through the
    rebuilt replicas with units 2 and 3 down. Kernel launches are counted
    from 0 for each run."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.storage.reconstruction import (
        ECReconstructionCoordinator,
        ReconstructionCommand,
    )

    opts = CoderOptions(10, 4, "rs", cell_size=cell)
    rng = np.random.default_rng(seed + 1)
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in key_sizes]
    lost, spares = [0, 1], ["dn14", "dn15"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-rr-") as tmp:
        cluster = Cluster(Path(tmp), opts, 16)
        try:
            fused_kernel.launches.reset()
            groups_per_key, writers = put_keys(cluster, keys, device, bpc)
            out["put_launches"] = fused_kernel.launches.count
            groups = [g for gs in groups_per_key for g in gs]
            total = sum(key_sizes)
            print(f"read/repair: rs-10-4 PUT of {len(keys)} keys, {total} B, "
                  f"{len(groups)} block groups on 14 of 16 datanodes; encode launches "
                  f"{out['put_launches']} for {sum(w.dispatches for w in writers)} dispatches")

            fused_kernel.launches.reset()
            since = time.time()
            healthy = read_groups(cluster, keys, groups_per_key, device, bpc)
            launches = fused_kernel.launches.count
            print(f"healthy GET spans: {span_totals(since)}")
            print(f"healthy GET: {healthy['bytes'] / healthy['wall_s'] / 2**30:.3f} GiB/s "
                  f"(wall), {healthy['bytes']} B byte-exact in {healthy['wall_s']:.3f} s; "
                  f"decode launches {launches}, dispatches {healthy['dispatches']}")
            if launches or healthy["dispatches"]:
                raise AssertionError("a healthy read decoded")
            unverified = read_groups(cluster, keys, groups_per_key, device, bpc, verify=False)
            print(f"healthy GET without the datanodes' CRC check: "
                  f"{unverified['bytes'] / unverified['wall_s'] / 2**30:.3f} GiB/s (wall)")

            cluster.dead = {groups[0].pipeline.nodes[u] for u in lost}
            fused_kernel.launches.reset()
            since = time.time()
            degraded = read_groups(cluster, keys, groups_per_key, device, bpc)
            out["degraded_launches"] = fused_kernel.launches.count
            print(f"degraded GET spans: {span_totals(since)}")
            print(f"degraded GET (units {lost} down): "
                  f"{degraded['bytes'] / degraded['wall_s'] / 2**30:.3f} GiB/s (wall), "
                  f"{degraded['bytes']} B byte-exact in {degraded['wall_s']:.3f} s")
            check_launches("degraded GET", device, out["degraded_launches"],
                           degraded["dispatches"])

            fused_kernel.launches.reset()
            ranged = ranged_reads(cluster, keys, groups_per_key, device, bpc)
            out["ranged_launches"] = fused_kernel.launches.count
            print(f"ranged degraded reads: {ranged['ranges']} ranges byte-exact")
            check_launches("ranged degraded reads", device, out["ranged_launches"],
                           ranged["dispatches"])

            coord = ECReconstructionCoordinator(cluster.clients, bytes_per_checksum=bpc,
                                                device=device)
            cmds = [ReconstructionCommand(
                g.container_id, opts,
                {u + 1: n for u, n in enumerate(g.pipeline.nodes) if u not in lost},
                {u + 1: spare for u, spare in zip(lost, spares)}) for g in groups]
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            for cmd in cmds:
                coord.reconstruct_container_group(cmd)
            repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            print(f"repair spans: {span_totals(since)}")
            rebuilt = check_rebuilt(cluster, groups, lost, spares, bpc)
            per_target = statistics.mean(rebuilt["per_target"].values())
            print(f"repair: {len(cmds)} containers, replica indexes "
                  f"{[u + 1 for u in lost]} onto {spares} in {repair_s:.3f} s: "
                  f"{per_target / repair_s / MIB:.1f} MiB/s per target datanode (wall), "
                  f"{per_target:.0f} B per target; {rebuilt['chunks']} rebuilt chunks "
                  f"({rebuilt['partial']} partial) equal the lost ones, CRCs equal host CRC32C")
            check_launches("repair", device, out["repair_launches"],
                           coord.metrics.counter("decode_dispatches").value)

            for g in groups:
                for u, spare in zip(lost, spares):
                    g.pipeline.nodes[u] = spare
            cluster.dead = {groups[0].pipeline.nodes[u] for u in (2, 3)}
            fused_kernel.launches.reset()
            reread = read_groups(cluster, keys, groups_per_key, device, bpc)
            out["reread_launches"] = fused_kernel.launches.count
            print(f"re-read through the rebuilt replicas (units [2, 3] down): "
                  f"{reread['bytes'] / reread['wall_s'] / 2**30:.3f} GiB/s (wall), "
                  f"byte-exact")
            check_launches("re-read", device, out["reread_launches"], reread["dispatches"])
        finally:
            cluster.close()
    out["decode_launches"] = sum(out[k] for k in ("degraded_launches", "ranged_launches",
                                                  "repair_launches", "reread_launches"))
    out.update(healthy_gib_s=healthy["bytes"] / healthy["wall_s"] / 2**30,
               degraded_gib_s=degraded["bytes"] / degraded["wall_s"] / 2**30,
               repair_mib_s_per_target=per_target / repair_s / MIB)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-only", action="store_true",
                    help="build, kernel cases and timings only; no main paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ozone_tpu_torch import cuda_build  # fails outside a checkout

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for lib, (secs, log) in sorted(logs.items()):
        print(f"nvcc {lib} ({secs:.2f} s):\n{log.strip()}")

    from ozone_tpu_torch.codec import fused_kernel

    for k, p in ((6, 3), (10, 4), (20, 4)):
        smem, per_sm = fused_kernel.kernel_occupancy(k, p, 16 * 1024, k + p)
        print(f"fused_encode_crc rs-{k}-{p} bpc=16384: {smem} B shared memory per "
              f"block, {per_sm} blocks per SM")
    cases = [
        (6, 3, MIB, 16 * 1024, 8, "CRC32C"),
        (6, 3, MIB, 16 * 1024, 8, "CRC32"),
        (10, 4, MIB, 16 * 1024, 4, "CRC32C"),
        (3, 2, MIB, MIB, 4, "CRC32C"),  # one slice per cell, many tiles
        (6, 3, MIB, 16 * 1024, 1, "NONE"),
        (20, 4, MIB, 16 * 1024, 2, "CRC32C"),
        (6, 3, 4800, 480, 3, "CRC32C"),  # 512-byte tile, padded front
        (6, 3, 4800, 100, 3, "CRC32"),  # slice not a multiple of 16: byte path
        (6, 3, MIB, 16 * 1024, 4, "CRC32C", False),  # decode form: outputs only
        (6, 0, MIB, 16 * 1024, 4, "CRC32C"),  # p = 0: plain slice CRC
    ]
    err = check_kernel_cases(device, cases, args.seed)
    decode_cases = [  # (k, p, valid, erased, cell, bpc, B, checksum)
        (10, 4, list(range(2, 12)), [0, 1], MIB, 16 * 1024, 8, "CRC32C"),
        (6, 3, [0, 1, 3, 4, 5, 6], [2, 7], MIB, 16 * 1024, 8, "CRC32C"),
        (10, 4, [0, 1, 2, 4, 5, 6, 7, 8, 9, 13], [3], MIB, 16 * 1024, 1, "CRC32C"),
        (10, 4, list(range(4, 14)), [0, 1, 2, 3], MIB, 16 * 1024, 2, "NONE"),
    ]
    err = max(err, check_decode_cases(device, decode_cases, args.seed))
    timed = time_kernel(device, 6, 3, MIB, 16 * 1024, 8, args.seed, plain=True)
    time_kernel(device, 6, 3, MIB, 16 * 1024, 128, args.seed, plain=False)
    time_parts(device, 6, 3, MIB, 16 * 1024, 128, args.seed)
    decode = time_decode(device, MIB, 16 * 1024, 8, args.seed)
    print("library_ms: none; no single PyTorch call computes a GF(2^8) "
          "matrix apply with slice CRCs")

    launches = None
    if not args.kernel_only:
        put = main_path(device, [192 * MIB, 192 * MIB, 96 * MIB + 12345, MIB + 7],
                        MIB, 16 * 1024, args.seed)
        rr = read_repair_path(device, [320 * MIB, 161 * MIB + 12345], MIB, 16 * 1024,
                              args.seed)
        launches = put["launches"] + rr["put_launches"] + rr["decode_launches"]
        print(f"kernel launches on the main paths: {launches} (rs-6-3 PUT "
              f"{put['launches']}, rs-10-4 PUT {rr['put_launches']}, decode "
              f"{rr['decode_launches']})")
    print(json.dumps({"kernels": [{
        "name": "fused_encode_crc", "route": "cuda",
        "source": "ozone_tpu_torch/csrc/fused_encode_crc.cu",
        "replaces": "ozone_tpu/codec/pallas_kernel.py:56",
        "launches": launches, "max_abs_err": err,
        "ms": timed["ms"], "ms_in_run": timed["ms_in_run"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
        "library_ms": None,
        "decode_ms": decode["ms"], "decode_ms_in_run": decode["ms_in_run"],
        "decode_plain_ms": decode["plain_ms"], "decode_bound_ms": decode["bound_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
