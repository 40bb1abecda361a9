#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernel-only]

Builds the port's CUDA kernels from `ozone_tpu_torch/csrc` (nvcc, sm_90a),
holds every kernel against its plain PyTorch version on the card, then
drives the port's main path: four concurrent RS(6,3) key PUTs through
`ECKeyWriter` into nine in-process datanodes, read back and checked
against the source bytes and the plain version's parity and CRCs. Every
failure raises. The last line is one JSON object with "ok" and the
device; the line before it is nvidia-smi's name and power limit, and the
one before that the kernels' JSON line. --kernel-only stops after the
build, the kernel cases and the timings (no PUTs; the kernels' JSON then
has "launches": null) and prints the same last lines.

It exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import argparse
import json
import os
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


def fused_bound(b: int, k: int, p: int, cell: int, bpc: int) -> tuple[float, str]:
    """(least ms, what bounds it) for one fused encode+CRC of [b, k, cell]:
    each input byte read once, parity and CRC words written once; the
    operations are p GF multiply-adds per input byte plus one CRC step per
    byte of all k+p rows, counted against the int8 peak."""
    moved = b * k * cell + b * p * cell + b * (k + p) * (cell // bpc) * 4
    ops = b * cell * (2 * k * p + (k + p))
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
    """Nine in-process port datanodes and a naive group allocator."""

    def __init__(self, root: Path, opts, n_dn: int):
        from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
        from ozone_tpu_torch.storage.datanode import Datanode

        self.opts = opts
        self.dns = {f"dn{i}": Datanode(root / f"dn{i}", dn_id=f"dn{i}")
                    for i in range(n_dn)}
        self.clients = DatanodeClientFactory()
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-only", action="store_true",
                    help="build, kernel cases and timings only; no PUTs")
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
    timed = time_kernel(device, 6, 3, MIB, 16 * 1024, 8, args.seed, plain=True)
    time_kernel(device, 6, 3, MIB, 16 * 1024, 128, args.seed, plain=False)
    time_parts(device, 6, 3, MIB, 16 * 1024, 128, args.seed)
    print("library_ms: none; no single PyTorch call computes a GF(2^8) "
          "matrix apply with slice CRCs")

    launches = None
    if not args.kernel_only:
        run = main_path(device, [192 * MIB, 192 * MIB, 96 * MIB + 12345, MIB + 7],
                        MIB, 16 * 1024, args.seed)
        launches = run["launches"]
    print(json.dumps({"kernels": [{
        "name": "fused_encode_crc", "route": "cuda",
        "source": "ozone_tpu_torch/csrc/fused_encode_crc.cu",
        "replaces": "ozone_tpu/codec/pallas_kernel.py:56",
        "launches": launches, "max_abs_err": err,
        "ms": timed["ms"], "ms_in_run": timed["ms_in_run"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
