#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernel-only]

Builds the port's CUDA kernels (nvcc, sm_90a) and its host libraries
(the CRC32C with g++ -msse4.2, the GF coder and the chunk datapath
sidecar with -march=native) from
`ozone_tpu_torch/csrc`, fails unless the host CRC library reports the
SSE4.2 CRC and the GF coder the AVX2 build, holds every kernel against
its plain PyTorch version on the card, in its RS, XOR and LRC encode
forms, its XOR(1)->RS re-encode form, its decode forms (RS, LRC local,
across groups and global), its scrub form (slice CRCs, no coding rows)
and the coder SPI's forms (no CRC rows, below), then drives the
port's main paths, on the shared codec service (the default route) unless
a phase says otherwise:

- four concurrent RS(6,3) key PUTs through `ECKeyWriter` into nine
  in-process datanodes, read back and checked against the source bytes
  and the plain version's parity and CRCs, once on the service and once
  with OZONE_TPU_CODEC_SERVICE=0 (the direct route);
- 32 concurrent small RS(6,3) PUTs (one stripe and a 4 KiB tail each)
  whose tails coalesce in the service;
- RS(10,4) read and repair: two keys PUT into 16 datanodes, read whole
  through `ECBlockGroupReader` healthy (alternately with the datanodes'
  CRC check on the native and on the numpy route), then with two data
  units down
  (whole and ranged), their replicas rebuilt onto two spares by
  `ECReconstructionCoordinator`, and read again through the rebuilt
  replicas with two other units down;
- LRC(12,2,2): two keys PUT into 18 datanodes, read healthy, with one
  unit down (local repair, reading only the lost unit's group), with
  unit 0 down (a short group's local repair over known-zero units), with
  two units of one group down (global decode), and unit 2 rebuilt onto a
  spare from its group;
- the device scrubber over every closed container of those datanodes,
  then over a container with one flipped byte, against the host scan;
- the control plane: a `MiniOzoneCluster` (SCM, OM, 12 datanodes on 3
  racks) takes an XOR(6,1) key, a RATIS/THREE key and a second XOR key
  through `OzoneClient`; the replicated key is re-encoded to RS(6,3), the
  first XOR key with unit 2's datanode down (the fused re-encode), the
  second with its parity's datanode down (a plain encode); every key is
  re-read byte-exact; then one RS datanode dies and the SCM's own
  reconstruction commands rebuild its replicas onto spares;
- freon (`freon_path`): the raw coder SPI's rawcoder_bench (rs-6-3 and
  rs-10-4 on the torch, cpp and numpy coders, xor-6-1 on torch and numpy,
  B=8, 1 MiB cells; torch's outputs equal numpy's); then on a
  `MiniOzoneCluster` of 12 datanodes on 3 racks (rs-6-3-1024k, 16 MiB
  blocks): ockg (48 keys of 16 MiB), ockv, ockrr (64 ranged reads of
  1 MiB), ecrd (64 MiB, 3 rounds), and the reconstruction storm: the
  datanode holding the most closed EC containers (at least 8) dies and
  `ReconstructionStorm.repair_datanode` rebuilds every one, byte-exact;
- the daemon cluster (`daemon_path`): an ScmOmDaemon and 12
  DatanodeDaemons on loopback on 3 racks, each with its native chunk
  datapath sidecar (`csrc/datapath.cpp`), driven through a remote
  OzoneClient: the PUT phase's four keys concurrently over the native
  lane, then again over the RPC lane (GiB/s of each beside the in-process
  rate of the same keys), a GET over each lane and through in-process
  clients, a degraded GET with two holders' servers and sidecars stopped,
  an admin close of the containers, a datanode's death and the SCM's
  ReconstructionCommands over heartbeats (the rebuilt chunks equal the
  lost ones), and `scan_once` on every live daemon. The native PUT, GET,
  degraded GET and repair must move every chunk over the native lane (no
  RPC chunk call, no server-side chunk span; on the PUT and GET no
  fallback and every payload byte counted as moved), and each prints its
  host copies per chunk. Then `python -m ozone_tpu_torch.tools cluster
  --datanodes 10 --device cuda` as processes, driven through the CLI (`sh
  volume/bucket create`, `sh key put/get` of 64 MiB + 12 345 B with a byte
  compare, `freon ockg -n 16 -s 16777216`, `admin status`: 10 HEALTHY),
  torn down by pid; every datanode log names its native port, and their
  lane counts show the chunks rode the native lane only.

The kernel cases also hold the coder SPI's two forms of the kernel (no
CRC rows) against their plain versions: the matrix apply
(`torch_coder.gf_apply`: RS(6,3) at cells of 1, 100, 4097 B and 1 MiB,
an RS(10,4) [4, 10] decode) and the XOR reduce (k = 3, 6, 10); the
kernels' JSON has one entry for each form beside the kernel's own.

Every failure raises. A line "phase seconds" gives each phase's command
time. The last line is one JSON object with "ok" and the device; the line
before it is nvidia-smi's name and power limit, and the one before that
the kernels' JSON line. --kernel-only stops after the
build, the kernel cases and the timings (no main paths; the kernels' JSON
then has "launches": null) and prints the same last lines.

It exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import argparse
import contextlib
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
    """Kernel against plain on each (k, p, cell, bpc, B, checksum[, crc_in[,
    scheme]]) case, exact on every byte and word; sampled slices against
    the host CRC. The matrix is the RS generator, or that of `scheme`
    (e.g. "lrc-12-2-2"); p = 0 is a plain slice CRC of the k inputs, the
    scrubber's form. Returns the largest difference seen (0 when every
    case agrees)."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _POLY, _parity_matrix
    from ozone_tpu_torch.utils.checksum import ChecksumType, crc32c

    rng = np.random.default_rng(seed)
    worst = 0
    for k, p, cell, bpc, b, checksum, *rest in cases:
        crc_in = rest[0] if rest else True
        scheme = rest[1] if len(rest) > 1 else f"rs-{k}-{p}"
        data = torch.from_numpy(rng.integers(0, 256, (b, k, cell), dtype=np.uint8)).to(device)
        matrix = (_parity_matrix(CoderOptions.parse(f"{scheme}-{cell}")) if p
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
        print(f"kernel vs plain {scheme} cell={cell} bpc={bpc} B={b} {checksum} "
              f"crc_in={crc_in}: max_abs_err={diff} crcs={tuple(crcs.shape)}")
        if diff or not shape_ok:
            raise AssertionError(f"kernel disagrees with plain on {scheme} cell={cell} "
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
    against plain on each (scheme, valid, erased, cell, bpc, B, checksum)
    case: a seeded codeword is encoded by the plain version, the `valid`
    units go in, and the recovered rows must equal the plain version's and
    the erased units, exact; sampled slices against the host CRC. For LRC
    the read set may be narrower than k (a local repair reads group_size
    units). Returns the largest difference seen."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _POLY, _decode_matrix, _parity_matrix
    from ozone_tpu_torch.utils.checksum import ChecksumType, crc32c

    rng = np.random.default_rng(seed)
    worst = 0
    for scheme, valid, erased, cell, bpc, b, checksum in cases:
        opts = CoderOptions.parse(f"{scheme}-{cell}")
        k = opts.data_units
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
        name = (f"{scheme} valid={valid} erased={erased} matrix={tuple(matrix.shape)} "
                f"bpc={bpc} B={b} {checksum}")
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


def reencode_inputs(device, k: int, lost: int, cell: int, b: int, seed: int):
    """(units, data, matrix): a seeded XOR(1) group `data` [B, k, cell] on
    `device`, `units` the same with the XOR parity in slot `lost`, and the
    re-encode's [1+p, k] matrix for RS(k, 3)."""
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _reencode_matrix

    rng = np.random.default_rng(seed + lost)
    data = rng.integers(0, 256, (b, k, cell), dtype=np.uint8)
    units = data.copy()
    units[:, lost] = np.bitwise_xor.reduce(data, axis=1)
    matrix = _reencode_matrix(CoderOptions(k, 3, "rs", cell_size=cell), lost)
    return (torch.from_numpy(units).to(device), torch.from_numpy(data).to(device),
            torch.from_numpy(matrix).to(device))


def check_reencode_cases(device, lost_units, cell: int, bpc: int, b: int,
                         seed: int) -> float:
    """The kernel in re-encode form (RS(6,3): the [4, 6] matrix [D[lost];
    P D], CRCs of the 6 inputs and the 4 outputs) against plain for each
    lost unit, exact; the recovered row must equal the lost data unit,
    the rest the RS parity of the group, and sampled slices the host CRC.
    Returns the largest difference seen."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.fused import _parity_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY, crc32c

    k = 6
    rng = np.random.default_rng(seed)
    rs = torch.from_numpy(_parity_matrix(CoderOptions(k, 3, "rs", cell_size=cell))).to(device)
    worst = 0
    for lost in lost_units:
        units, data, matrix = reencode_inputs(device, k, lost, cell, b, seed)
        out, crcs = fused_kernel.fused_encode_crc(units, matrix, CRC32C_POLY, bpc)
        pout, pcrcs = fused_kernel.fused_encode_crc_plain(units, matrix, CRC32C_POLY, bpc)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = max((out.int() - pout.int()).abs().max().item(),
                   (crcs.long() - pcrcs.long()).abs().max().item())
        worst = max(worst, diff)
        name = f"re-encode rs-6-3 lost={lost} matrix={tuple(matrix.shape)} B={b}"
        print(f"re-encode kernel vs plain {name}: max_abs_err={diff} "
              f"crcs={tuple(crcs.shape)}")
        parity, _ = fused_kernel.fused_encode_crc_plain(data, rs, None, bpc)
        if diff or crcs.shape != (b, k + 4, cell // bpc):
            raise AssertionError(f"re-encode kernel disagrees with plain on {name}")
        if not (torch.equal(out[:, 0], data[:, lost]) and torch.equal(out[:, 1:], parity)):
            raise AssertionError(f"{name} does not give the lost unit and the RS parity")
        rows = torch.cat([units, out], 1).cpu().numpy()
        words = crcs.cpu().numpy().view(np.uint32)
        for _ in range(32):
            bi, u, sl = (int(rng.integers(n)) for n in (b, k + 4, cell // bpc))
            if int(words[bi, u, sl]) != crc32c(rows[bi, u, sl * bpc:(sl + 1) * bpc]):
                raise AssertionError(f"CRC of slice {(bi, u, sl)} of {name} != host")
    return worst


def time_reencode(device, cell: int, bpc: int, b: int, seed: int) -> dict:
    """The re-encode form at the XOR->RS path's shape: RS(6,3), B=8, unit 2
    lost, CRC32C over the 6 inputs and 4 outputs."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    units, _, matrix = reencode_inputs(device, 6, 2, cell, b, seed)
    return time_form(
        f"re-encode rs-6-3 [4, 6] lost=2 B={b}",
        lambda: fused_kernel.fused_encode_crc(units, matrix, CRC32C_POLY, bpc),
        lambda: fused_kernel.fused_encode_crc_plain(units, matrix, CRC32C_POLY, bpc),
        fused_bound(b, 6, 4, cell, bpc, rows=10), b * 6 * cell)


def time_form(name: str, run, plain, bound: tuple[float, str], in_bytes: int) -> dict:
    """A kernel form's time on fixed inputs, a single call and a call in a
    run of 20, beside its plain version's time and its bound."""
    ms = cuda_ms(run)
    in_run_ms = cuda_ms(run, calls=20, rounds=5)
    plain_ms = cuda_ms(plain, rounds=5)
    bound_ms, bound_by = bound
    print(f"fused_encode_crc {name}: {ms:.4f} ms a single call ({in_run_ms:.4f} ms a call "
          f"in a run of 20), bound {bound_ms:.4f} ms ({bound_by}), "
          f"{in_bytes / ms * 1e3 / 2**30:.2f} GiB/s in, plain {plain_ms:.4f} ms")
    return {"ms": ms, "ms_in_run": in_run_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


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
    return time_form(
        f"decode rs-10-4 e=2 v=10 cell={cell} bpc={bpc} B={b}",
        lambda: fused_kernel.fused_encode_crc(units, matrix, CRC32C_POLY, bpc, crc_in=False),
        lambda: fused_kernel.fused_encode_crc_plain(units, matrix, CRC32C_POLY, bpc,
                                                    crc_in=False),
        fused_bound(b, len(valid), len(erased), cell, bpc, rows=len(erased)),
        b * len(valid) * cell)


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


def time_lrc_and_scrub(device, cell: int, bpc: int, seed: int) -> dict:
    """The LRC(12,2,2) encode (B=8, [4, 12] generator, CRC32C over all 16
    rows), its local decode (unit 2 from its group, B=8, [1, 6] matrix,
    CRC32C over the recovered row) and the scrubber's batch (4096 slices
    of bpc bytes through `make_crc_fn`, no coding rows)."""
    from ozone_tpu_torch.codec import fused_kernel, lrc_math
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.crc_device import make_crc_fn
    from ozone_tpu_torch.codec.fused import _decode_matrix, _parity_matrix
    from ozone_tpu_torch.utils.checksum import CRC32C_POLY

    rng = np.random.default_rng(seed)
    lrc = CoderOptions.parse(f"lrc-12-2-2-{cell}")
    b = 8
    data = torch.from_numpy(rng.integers(0, 256, (b, 12, cell), dtype=np.uint8)).to(device)
    gen = torch.from_numpy(_parity_matrix(lrc)).to(device)
    out = {"lrc_encode": time_form(
        f"lrc-12-2-2 encode [4, 12] B={b}",
        lambda: fused_kernel.fused_encode_crc(data, gen, CRC32C_POLY, bpc),
        lambda: fused_kernel.fused_encode_crc_plain(data, gen, CRC32C_POLY, bpc),
        fused_bound(b, 12, 4, cell, bpc), b * 12 * cell)}
    valid, _ = lrc_math.plan_valid(lrc, [2], [u for u in range(16) if u != 2])
    units = data[:, :len(valid)].contiguous()
    rows = torch.from_numpy(_decode_matrix(lrc, valid, [2])).to(device)
    out["lrc_decode"] = time_form(
        f"lrc-12-2-2 local decode [1, {len(valid)}] B={b}",
        lambda: fused_kernel.fused_encode_crc(units, rows, CRC32C_POLY, bpc, crc_in=False),
        lambda: fused_kernel.fused_encode_crc_plain(units, rows, CRC32C_POLY, bpc,
                                                    crc_in=False),
        fused_bound(b, len(valid), 1, cell, bpc, rows=1), b * len(valid) * cell)
    n = 4096
    slices = torch.from_numpy(rng.integers(0, 256, (n, 1, bpc), dtype=np.uint8)).to(device)
    no_rows = torch.zeros((0, 1), dtype=torch.uint8, device=device)
    crc_fn = make_crc_fn(bpc)
    out["scrub"] = time_form(
        f"scrub batch [{n}, 1, {bpc}] (no coding rows)",
        lambda: crc_fn(slices),
        lambda: fused_kernel.fused_encode_crc_plain(slices, no_rows, CRC32C_POLY, bpc),
        fused_bound(n, 1, 0, bpc, bpc, rows=1), n * bpc)
    return out


# --------------------------------------------------------------- main path
def service_counts() -> dict:
    """The shared codec service's dispatch counters, and the observation
    counts and sums of its queue-wait and dispatch histograms
    (process-wide)."""
    from ozone_tpu_torch.codec import service as codec_service

    out = {name: codec_service.METRICS.counter(name).value
           for name in ("submissions", "dispatches", "multi_op_dispatches",
                        "stripes_dispatched", "slots_dispatched")}
    for name in ("queue_wait_seconds", "dispatch_seconds"):
        h = codec_service.METRICS.histogram(name)
        out[name], out[f"{name}_n"] = h.total, h.count
    return out


def service_delta(before: dict) -> dict:
    """The service's counters since `before`, with the fill ratio of the
    dispatches in between (stripes over batch slots) and the mean queue
    wait and dispatch time (launch to results on the host) in ms."""
    now = service_counts()
    out = {k: now[k] - before[k] for k in now}
    out["fill_ratio"] = (out["stripes_dispatched"] / out["slots_dispatched"]
                         if out["slots_dispatched"] else 0.0)
    for name, key in (("queue_wait_seconds", "queue_wait_ms"),
                      ("dispatch_seconds", "dispatch_ms")):
        n = out[f"{name}_n"]
        out[key] = 1e3 * out[name] / n if n else 0.0
    return out


@contextlib.contextmanager
def codec_route(service: bool):
    """The enclosed phase takes the shared codec service (the default) or,
    with OZONE_TPU_CODEC_SERVICE=0, the direct route."""
    old = os.environ.get("OZONE_TPU_CODEC_SERVICE")
    os.environ["OZONE_TPU_CODEC_SERVICE"] = "1" if service else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("OZONE_TPU_CODEC_SERVICE")
        else:
            os.environ["OZONE_TPU_CODEC_SERVICE"] = old


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


def put_keys(cluster: Cluster, keys: list[np.ndarray], device, bpc: int,
             barrier: threading.Barrier | None = None):
    """PUT every key on its own thread; returns (groups per key, writers).
    With a barrier, every writer's close() starts together."""
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
            if barrier is not None:
                barrier.wait(timeout=300)
            results[i] = (w.close(), w)
        except BaseException as e:  # reported and re-raised by the caller
            errors.append(e)
            if barrier is not None:
                barrier.abort()

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


def put_run(device, opts, keys, bpc: int, seed: int, route: str, what: str,
            barrier: bool = False) -> dict:
    """PUT `keys` concurrently into a fresh cluster of k+p datanodes on
    `route` ("service" or "direct") and check every chunk against the
    source and the plain version. On the service, launches equal the
    service's dispatches; on the direct route, the writers' submissions."""
    from ozone_tpu_torch.codec import fused_kernel

    total = sum(int(k.size) for k in keys)
    with codec_route(route == "service"), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        cluster = Cluster(Path(tmp), opts, opts.all_units)
        try:
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            groups, writers = put_keys(
                cluster, keys, device, bpc,
                barrier=threading.Barrier(len(keys)) if barrier else None)
            wall = time.perf_counter() - t0
            launches = fused_kernel.launches.count
            svc = service_delta(before)
            spans = span_totals(since)
            submissions = sum(w.dispatches for w in writers)
            checked = verify_keys(cluster, keys, groups, device, bpc, seed, 64)
        finally:
            cluster.close()
    print(f"{what} ({route}): {len(keys)} concurrent {opts} PUTs, {total} B in "
          f"{wall:.3f} s = {total / wall / 2**30:.3f} GiB/s, {len(keys) / wall:.1f} PUTs/s "
          f"(wall); kernel launches {launches}, writer submissions {submissions}; service "
          f"dispatches {svc['dispatches']}, multi_op_dispatches "
          f"{svc['multi_op_dispatches']}, fill_ratio {svc['fill_ratio']:.3f}, queue wait "
          f"{svc['queue_wait_ms']:.3f} ms, dispatch {svc['dispatch_ms']:.3f} ms (means); "
          f"{checked['chunks']} chunks byte-exact")
    print(f"{what} ({route}) spans: {spans}")
    dispatches = svc["dispatches"] if route == "service" else submissions
    if svc["submissions"] != (submissions if route == "service" else 0):
        raise AssertionError(f"{what} ({route}): {svc['submissions']} service submissions "
                             f"for {submissions} writer submissions")
    if device.type == "cuda" and (launches <= 0 or launches != dispatches):
        raise AssertionError(f"{what} ({route}): {launches} kernel launches for "
                             f"{dispatches} dispatches")
    if checked["verified"] < 64:
        raise AssertionError("too few chunks verified")
    return {"launches": launches, "dispatches": dispatches, "submissions": submissions,
            "multi_op": svc["multi_op_dispatches"], "fill_ratio": svc["fill_ratio"],
            "gib_s": total / wall / 2**30, "puts_s": len(keys) / wall,
            "partial": checked["partial"]}


#: route order of a paired comparison in one call, after one unmeasured
#: run on each route (the first runs pay for new pinned and device
#: memory): one run on the direct route, one on the service (two of each
#: until the daemon phase needed the run time)
WARMUP, ROUTES = ("service", "direct"), ("direct", "service")
#: host CRC32C routes of the healthy RS(10,4) GET, one run each
CRC_ROUTES = ("native", "numpy")


def compare_routes(device, opts, keys, bpc: int, seed: int, what: str,
                   barrier: bool = False) -> dict:
    """The warm-up runs, then the paired runs; {route: [run, ...]} of the
    paired runs, and "warmup": [run, ...]."""
    warm = [put_run(device, opts, keys, bpc, seed, route, f"{what} warm-up", barrier)
            for route in WARMUP]
    runs = [put_run(device, opts, keys, bpc, seed, route, what, barrier)
            for route in ROUTES]
    out = {route: [r for r, name in zip(runs, ROUTES) if name == route]
           for route in ("service", "direct")}
    out["warmup"] = warm
    return out


def main_path(device, key_sizes, cell: int, bpc: int, seed: int) -> dict:
    """Concurrent RS(6,3) PUTs of the same keys into a fresh cluster, on the
    direct route and on the shared codec service, alternated."""
    from ozone_tpu_torch.codec.api import CoderOptions

    opts = CoderOptions(6, 3, "rs", cell_size=cell)
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in key_sizes]
    out = compare_routes(device, opts, keys, bpc, seed, "main path")
    if not all(r["partial"] for runs in out.values() for r in runs):
        raise AssertionError("no partial chunk was verified")
    return out


def small_puts(device, n_keys: int, key_size: int, cell: int, bpc: int,
               seed: int) -> dict:
    """Many small concurrent RS(6,3) PUTs: each key is one full stripe and a
    short tail, both flushed at close() as one partial batch, and every
    close() starts behind one barrier, so on the service the tails reach
    it within its linger and share launches. The direct route, alternated
    with it, launches once per PUT."""
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.pipeline import host_buffer

    opts = CoderOptions(6, 3, "rs", cell_size=cell)
    rng = np.random.default_rng(seed + 2)
    keys = [rng.integers(0, 256, key_size, dtype=np.uint8) for _ in range(n_keys)]
    # the pinned pool of a long-running client already holds blocks of the
    # staging size; without them the first allocations spread the closes
    warm = [host_buffer((2, opts.data_units, cell), device) for _ in range(n_keys)]
    del warm
    out = compare_routes(device, opts, keys, bpc, seed, "small PUTs", barrier=True)
    for r in out["service"]:
        if r["multi_op"] <= 0 or not r["dispatches"] < r["submissions"]:
            raise AssertionError(f"small PUTs: {r['dispatches']} service dispatches for "
                                 f"{r['submissions']} submissions, {r['multi_op']} "
                                 "carrying more than one PUT")
    return out


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


def check_launches(what: str, device, launches: int, svc: dict, submissions: int) -> None:
    """The service saw every decode submission of the path and dispatched
    them in at most as many launches; on the card every service dispatch
    is one kernel launch, and the path launched at least once."""
    print(f"{what}: decode launches {launches}, decode submissions {submissions}, "
          f"service dispatches {svc['dispatches']} (multi_op_dispatches "
          f"{svc['multi_op_dispatches']})")
    if svc["submissions"] != submissions or svc["dispatches"] > submissions:
        raise AssertionError(f"{what}: {svc['submissions']} service submissions, "
                             f"{svc['dispatches']} dispatches for {submissions} submissions")
    if device.type == "cuda" and (launches <= 0 or launches != svc["dispatches"]):
        raise AssertionError(f"{what}: {launches} kernel launches for "
                             f"{svc['dispatches']} service dispatches")


def check_rebuilt(cluster: Cluster, groups, lost, spares, bpc: int) -> dict:
    """Every rebuilt replica is CLOSED with the lost replica index, and each
    of its chunks equals the lost unit's stored chunk, with stored CRCs
    equal to the host CRC32C of its bytes."""
    from concurrent.futures import ThreadPoolExecutor

    from ozone_tpu_torch.storage.ids import ContainerState, StorageError
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
            try:
                schunks = src.get_block(g.block_id).chunks
            except StorageError:  # a unit holding no bytes of a short group
                schunks = []
            dblk = dst.get_block(g.block_id)
            if [(i.offset, i.length) for i in schunks] != \
                    [(i.offset, i.length) for i in dblk.chunks]:
                raise AssertionError(f"rebuilt chunk list of {g.block_id} unit {u} differs")
            per_target[spare] += dblk.length
            pairs += [(src, dst, g.block_id, si, di)
                      for si, di in zip(schunks, dblk.chunks)]

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
    rebuilt replicas with units 2 and 3 down, all on the shared codec
    service. Kernel launches are counted from 0 for each run and must equal
    the service's dispatches in it."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.storage.reconstruction import (
        ECReconstructionCoordinator,
        ReconstructionCommand,
    )
    from ozone_tpu_torch.utils import checksum

    opts = CoderOptions(10, 4, "rs", cell_size=cell)
    rng = np.random.default_rng(seed + 1)
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in key_sizes]
    lost, spares = [0, 1], ["dn14", "dn15"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-rr-") as tmp:
        cluster = Cluster(Path(tmp), opts, 16)
        try:
            before = service_counts()
            fused_kernel.launches.reset()
            groups_per_key, writers = put_keys(cluster, keys, device, bpc)
            out["put_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            groups = [g for gs in groups_per_key for g in gs]
            total = sum(key_sizes)
            print(f"read/repair: rs-10-4 PUT of {len(keys)} keys, {total} B, "
                  f"{len(groups)} block groups on 14 of 16 datanodes; encode launches "
                  f"{out['put_launches']} for {svc['dispatches']} service dispatches of "
                  f"{sum(w.dispatches for w in writers)} writer submissions")
            if device.type == "cuda" and out["put_launches"] != svc["dispatches"]:
                raise AssertionError("rs-10-4 PUT: launches differ from service dispatches")

            # the healthy GET with the datanodes' CRC check on each host
            # CRC32C route: native, then numpy
            crc_rates: dict[str, list[float]] = {"native": [], "numpy": []}
            for route in CRC_ROUTES:
                fused_kernel.launches.reset()
                since = time.time()
                with (checksum.numpy_route() if route == "numpy"
                      else contextlib.nullcontext()):
                    if checksum.route() != route:
                        raise AssertionError(f"host CRC32C runs on {checksum.route()}, "
                                             f"not {route}")
                    healthy = read_groups(cluster, keys, groups_per_key, device, bpc)
                launches = fused_kernel.launches.count
                rate = healthy["bytes"] / healthy["wall_s"] / 2**30
                crc_rates[route].append(rate)
                print(f"healthy GET spans ({route} CRC32C): {span_totals(since)}")
                print(f"healthy GET ({route} host CRC32C): {rate:.3f} GiB/s (wall), "
                      f"{healthy['bytes']} B byte-exact in {healthy['wall_s']:.3f} s; "
                      f"decode launches {launches}, dispatches {healthy['dispatches']}")
                if launches or healthy["dispatches"]:
                    raise AssertionError("a healthy read decoded")
            print("healthy GET by host CRC32C route: " + ", ".join(
                f"{route} {' '.join(f'{r:.3f}' for r in rates)} GiB/s"
                for route, rates in crc_rates.items()))
            unverified = read_groups(cluster, keys, groups_per_key, device, bpc, verify=False)
            print(f"healthy GET without the datanodes' CRC check: "
                  f"{unverified['bytes'] / unverified['wall_s'] / 2**30:.3f} GiB/s (wall)")

            cluster.dead = {groups[0].pipeline.nodes[u] for u in lost}
            before = service_counts()
            fused_kernel.launches.reset()
            since = time.time()
            degraded = read_groups(cluster, keys, groups_per_key, device, bpc)
            out["degraded_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"degraded GET spans: {span_totals(since)}")
            print(f"degraded GET (units {lost} down): "
                  f"{degraded['bytes'] / degraded['wall_s'] / 2**30:.3f} GiB/s (wall), "
                  f"{degraded['bytes']} B byte-exact in {degraded['wall_s']:.3f} s")
            check_launches("degraded GET", device, out["degraded_launches"], svc,
                           degraded["dispatches"])

            before = service_counts()
            fused_kernel.launches.reset()
            ranged = ranged_reads(cluster, keys, groups_per_key, device, bpc)
            out["ranged_launches"] = fused_kernel.launches.count
            print(f"ranged degraded reads: {ranged['ranges']} ranges byte-exact")
            check_launches("ranged degraded reads", device, out["ranged_launches"],
                           service_delta(before), ranged["dispatches"])

            coord = ECReconstructionCoordinator(cluster.clients, bytes_per_checksum=bpc,
                                                device=device)
            cmds = [ReconstructionCommand(
                g.container_id, opts,
                {u + 1: n for u, n in enumerate(g.pipeline.nodes) if u not in lost},
                {u + 1: spare for u, spare in zip(lost, spares)}) for g in groups]
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            for cmd in cmds:
                coord.reconstruct_container_group(cmd)
            repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"repair spans: {span_totals(since)}")
            rebuilt = check_rebuilt(cluster, groups, lost, spares, bpc)
            per_target = statistics.mean(rebuilt["per_target"].values())
            print(f"repair: {len(cmds)} containers, replica indexes "
                  f"{[u + 1 for u in lost]} onto {spares} in {repair_s:.3f} s: "
                  f"{per_target / repair_s / MIB:.1f} MiB/s per target datanode (wall), "
                  f"{per_target:.0f} B per target; {rebuilt['chunks']} rebuilt chunks "
                  f"({rebuilt['partial']} partial) equal the lost ones, CRCs equal host CRC32C")
            check_launches("repair", device, out["repair_launches"], svc,
                           coord.metrics.counter("decode_dispatches").value)

            for g in groups:
                for u, spare in zip(lost, spares):
                    g.pipeline.nodes[u] = spare
            cluster.dead = {groups[0].pipeline.nodes[u] for u in (2, 3)}
            before = service_counts()
            fused_kernel.launches.reset()
            reread = read_groups(cluster, keys, groups_per_key, device, bpc)
            out["reread_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"re-read through the rebuilt replicas (units [2, 3] down): "
                  f"{reread['bytes'] / reread['wall_s'] / 2**30:.3f} GiB/s (wall), "
                  f"byte-exact")
            check_launches("re-read", device, out["reread_launches"], svc,
                           reread["dispatches"])
        finally:
            cluster.close()
    out["decode_launches"] = sum(out[k] for k in ("degraded_launches", "ranged_launches",
                                                  "repair_launches", "reread_launches"))
    out.update(healthy_gib_s=crc_rates,
               degraded_gib_s=degraded["bytes"] / degraded["wall_s"] / 2**30,
               repair_mib_s_per_target=per_target / repair_s / MIB)
    return out


@contextlib.contextmanager
def spy_reads(cluster: Cluster):
    """Count the bytes each datanode serves through its client while the
    block runs (`read_chunks` goes through the spied `read_chunk`)."""
    served: dict[str, int] = {}
    lock = threading.Lock()
    clients = list(cluster.clients._local.items())

    def spied(dn_id, fn):
        def read_chunk(*a, **kw):
            data = fn(*a, **kw)
            with lock:
                served[dn_id] = served.get(dn_id, 0) + int(data.size)
            return data
        return read_chunk

    for dn_id, c in clients:
        c.read_chunk = spied(dn_id, c.read_chunk)
    try:
        yield served
    finally:
        for _, c in clients:
            del c.read_chunk


def degraded_lrc_get(cluster: Cluster, keys, groups_per_key, device, bpc: int,
                     down: list[int], what: str) -> dict:
    """read_all of every group with the datanodes of units `down` out, on
    the service; byte-exact, and launches equal the service's dispatches."""
    from ozone_tpu_torch.codec import fused_kernel

    cluster.dead = {groups_per_key[0][0].pipeline.nodes[u] for u in down}
    before = service_counts()
    fused_kernel.launches.reset()
    got = read_groups(cluster, keys, groups_per_key, device, bpc)
    launches = fused_kernel.launches.count
    print(f"lrc {what} GET (units {down} down): "
          f"{got['bytes'] / got['wall_s'] / 2**30:.3f} GiB/s (wall), {got['bytes']} B "
          f"byte-exact in {got['wall_s']:.3f} s")
    check_launches(f"lrc {what} GET", device, launches, service_delta(before),
                   got["dispatches"])
    cluster.dead = set()
    return {"launches": launches, "gib_s": got["bytes"] / got["wall_s"] / 2**30}


def lrc_path(device, key_sizes, cell: int, bpc: int, seed: int) -> dict:
    """LRC(12,2,2) on 18 datanodes (16 units, 2 spares), all on the shared
    codec service: concurrent PUTs, a healthy GET (no decode), degraded
    GETs with unit 2 down (local repair: each decode reads only unit 2's
    group), unit 0 down (in a short group, a local repair over known-zero
    units) and units 0 and 1 down (global decode), a rebuild of replica
    index 3 (unit 2) of every container onto a spare, then the device
    scrubber over the datanodes."""
    from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
    from ozone_tpu_torch.codec import fused_kernel, lrc_math
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.storage.reconstruction import (
        ECReconstructionCoordinator,
        ReconstructionCommand,
    )

    opts = CoderOptions.parse(f"lrc-12-2-2-{cell}")
    rng = np.random.default_rng(seed + 3)
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in key_sizes]
    out = {}
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-lrc-") as tmp:
        cluster = Cluster(Path(tmp), opts, 18)
        try:
            before = service_counts()
            fused_kernel.launches.reset()
            t0 = time.perf_counter()
            groups_per_key, writers = put_keys(cluster, keys, device, bpc)
            put_s = time.perf_counter() - t0
            out["put_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            groups = [g for gs in groups_per_key for g in gs]
            checked = verify_keys(cluster, keys, groups_per_key, device, bpc, seed, 64)
            print(f"lrc: lrc-12-2-2 PUT of {len(keys)} keys, {sum(key_sizes)} B in "
                  f"{put_s:.3f} s = {sum(key_sizes) / put_s / 2**30:.3f} GiB/s (wall), "
                  f"{len(groups)} block groups on 16 of 18 datanodes; encode launches "
                  f"{out['put_launches']} for {svc['dispatches']} service dispatches of "
                  f"{sum(w.dispatches for w in writers)} writer submissions; "
                  f"{checked['chunks']} chunks equal the source and the plain version")
            if device.type == "cuda" and (out["put_launches"] <= 0
                                          or out["put_launches"] != svc["dispatches"]):
                raise AssertionError("lrc PUT: launches differ from service dispatches")

            fused_kernel.launches.reset()
            healthy = read_groups(cluster, keys, groups_per_key, device, bpc)
            print(f"lrc healthy GET: {healthy['bytes'] / healthy['wall_s'] / 2**30:.3f} "
                  f"GiB/s (wall), decode launches {fused_kernel.launches.count}")
            if fused_kernel.launches.count or healthy["dispatches"]:
                raise AssertionError("a healthy lrc read decoded")

            nodes = groups[0].pipeline.nodes
            scope = {nodes[u] for u in lrc_math.group_scope(opts, 0)} - {nodes[2]}
            out["local"] = degraded_lrc_get(cluster, keys, groups_per_key, device, bpc,
                                            [2], "local")
            cluster.dead = {nodes[2]}
            for g in groups:
                reader = ECBlockGroupReader(g, opts, cluster.clients,
                                            bytes_per_checksum=bpc, device=device)
                with spy_reads(cluster) as served:
                    reader.recover_cells([2])
                if not set(served) <= scope or (g.length >= 12 * cell
                                                and len(served) != 6):
                    raise AssertionError(f"local repair of unit 2 in {g.block_id} read "
                                         f"{sorted(served)}, not its group {sorted(scope)}")
            cluster.dead = set()
            print(f"lrc local repair: every decode of unit 2 read only the datanodes of "
                  f"its group ({len(scope)})")
            out["short"] = degraded_lrc_get(cluster, keys, groups_per_key, device, bpc,
                                            [0], "local (unit 0, short group over "
                                            "known-zero units)")
            out["global"] = degraded_lrc_get(cluster, keys, groups_per_key, device, bpc,
                                             [0, 1], "global")

            cluster.dead = {nodes[2]}
            coord = ECReconstructionCoordinator(cluster.clients, bytes_per_checksum=bpc,
                                                device=device)
            cmds = [ReconstructionCommand(
                g.container_id, opts,
                {u + 1: n for u, n in enumerate(g.pipeline.nodes) if u != 2},
                {3: "dn16"}) for g in groups]
            before = service_counts()
            fused_kernel.launches.reset()
            with spy_reads(cluster) as served:
                t0 = time.perf_counter()
                for cmd in cmds:
                    coord.reconstruct_container_group(cmd)
                repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            rebuilt = check_rebuilt(cluster, groups, [2], ["dn16"], bpc)
            target = rebuilt["per_target"]["dn16"]
            read_bytes = sum(served.values())
            print(f"lrc repair: {len(cmds)} containers, replica index 3 onto dn16 in "
                  f"{repair_s:.3f} s: {target / repair_s / MIB:.1f} MiB/s per target "
                  f"datanode (wall), {target} B rebuilt; {read_bytes} B read from "
                  f"{len(served)} datanodes = {read_bytes / target:.3f} B read per rebuilt "
                  f"B; {rebuilt['chunks']} rebuilt chunks ({rebuilt['partial']} partial) "
                  f"equal the lost ones, CRCs equal host CRC32C")
            if not set(served) <= scope:
                raise AssertionError(f"the repair read {sorted(served)}, outside unit 2's "
                                     "group")
            check_launches("lrc repair", device, out["repair_launches"], svc,
                           coord.metrics.counter("decode_dispatches").value)
            cluster.dead = set()
            out.update(repair_mib_s_per_target=target / repair_s / MIB,
                       read_per_rebuilt=read_bytes / target)
            out["scrub"] = scrub_path(cluster, device, groups)
        finally:
            cluster.close()
    out["decode_launches"] = sum(out[k]["launches"] for k in ("local", "short", "global")) \
        + out["repair_launches"]
    return out


def scrub_path(cluster: Cluster, device, groups) -> dict:
    """Close every container, scrub every datanode on the device (no
    errors), then flip one byte of one chunk file: the scrubber reports
    exactly that slice, the replica goes UNHEALTHY, and the host scan names
    the same chunk."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.storage.ids import ContainerState
    from ozone_tpu_torch.storage.scrubber import SCANNABLE_STATES, DeviceScrubber

    scrubbed = 0
    for dn in cluster.dns.values():
        for c in dn.list_containers():
            if c.state is ContainerState.OPEN:
                dn.close_container(c.id)
            if c.state in SCANNABLE_STATES:
                scrubbed += sum(i.length for b in c.list_blocks() for i in b.chunks)
    scrubber = DeviceScrubber(device=device)
    fused_kernel.launches.reset()
    t0 = time.perf_counter()
    found = {dn_id: scrubber.scrub_all(dn) for dn_id, dn in cluster.dns.items()}
    wall = time.perf_counter() - t0
    launches = fused_kernel.launches.count
    print(f"scrub: {len(cluster.dns)} datanodes, {scrubbed} B of chunks in {wall:.3f} s = "
          f"{scrubbed / wall / 2**30:.3f} GiB/s (wall); kernel launches {launches}, "
          f"scrub dispatches {scrubber.dispatches}")
    if any(found.values()):
        raise AssertionError(f"the scrubber found errors in healthy containers: {found}")
    if device.type == "cuda" and (launches <= 0 or launches != scrubber.dispatches):
        raise AssertionError(f"scrub: {launches} kernel launches for "
                             f"{scrubber.dispatches} dispatches")

    g = max(groups, key=lambda grp: grp.length)
    dn = cluster.dns[g.pipeline.nodes[5]]
    info = dn.get_block(g.block_id).chunks[3]
    bpc = info.checksum.bytes_per_checksum
    sl = min(7, info.length // bpc - 1)
    path = dn.containers.get(g.container_id).chunks.block_path(g.block_id)
    with open(path, "r+b") as f:
        f.seek(info.offset + sl * bpc + 100)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x5A]))
    errors = scrubber.scrub_container(dn, g.container_id)
    want = f"{g.block_id}/{info.name}: crc mismatch at slice {sl}"
    state = dn.containers.get(g.container_id).state
    host = dn.scan_container(g.container_id)
    print(f"scrub of one flipped byte: {errors}; container {state.value}; host scan: {host}")
    if errors != [want] or state is not ContainerState.UNHEALTHY:
        raise AssertionError(f"scrub reported {errors} ({state.value}), want [{want!r}]")
    if [e.split(":")[0] for e in host] != [want.split(":")[0]]:
        raise AssertionError(f"the host scan reported {host}")
    return {"launches": launches, "gib_s": scrubbed / wall / 2**30,
            "dispatches": scrubber.dispatches}


def kill_datanode(cluster, dn_id: str) -> None:
    """Stop a datanode (its client raises, it heartbeats no more) and let
    the SCM's liveness sweep find it dead."""
    from ozone_tpu_torch.scm.node_manager import NodeState

    cluster.stop_datanode(dn_id)
    cluster.scm.nodes.get(dn_id).last_heartbeat = -1e9
    cluster.scm.nodes.check_liveness()
    if cluster.scm.nodes.get(dn_id).state is not NodeState.DEAD:
        raise AssertionError(f"the SCM does not see {dn_id} dead")


def ec_missing(cluster) -> dict:
    """{container id: missing replica indexes} of every closed EC container,
    as the SCM's replica reports show them (read only: no commands)."""
    from ozone_tpu_torch.scm.pipeline import ReplicationType
    from ozone_tpu_torch.scm.replication_manager import ECReplicaCount
    from ozone_tpu_torch.storage.ids import ContainerState

    out = {}
    for c in cluster.scm.containers.containers():
        if c.replication.type is ReplicationType.EC and c.state in (
                ContainerState.CLOSED, ContainerState.QUASI_CLOSED):
            missing = ECReplicaCount(c, cluster.scm.nodes).missing_indexes
            if missing:
                out[c.id] = missing
    return out


def revive_datanode(cluster, dn_id: str) -> None:
    cluster.restart_datanode(dn_id)
    cluster.tick()


def reencode(cluster, device, what: str, volume: str, bucket: str, key: str,
             ec: str, size: int) -> dict:
    """One re-encode through `client/re_encode.py` on the codec service:
    MiB/s of user data (wall), and kernel launches against the service's
    dispatches in the run."""
    from ozone_tpu_torch.client.re_encode import re_encode_key_to_ec
    from ozone_tpu_torch.codec import fused_kernel

    before = service_counts()
    fused_kernel.launches.reset()
    since, t0 = time.time(), time.perf_counter()
    info = re_encode_key_to_ec(cluster.om, cluster.clients, volume, bucket, key,
                               ec=ec, device=device)
    wall = time.perf_counter() - t0
    launches = fused_kernel.launches.count
    svc = service_delta(before)
    print(f"{what} spans: {span_totals(since)}")
    print(f"{what}: {size} B to {info['replication']} in {wall:.3f} s = "
          f"{size / wall / MIB:.1f} MiB/s of user data (wall), "
          f"{len(info['block_groups'])} groups; kernel launches {launches}, service "
          f"dispatches {svc['dispatches']} of {svc['submissions']} submissions")
    if info["size"] != size or info["replication"] != ec:
        raise AssertionError(f"{what}: key info {info['size']} B {info['replication']}")
    if device.type == "cuda" and (launches <= 0 or launches != svc["dispatches"]):
        raise AssertionError(f"{what}: {launches} kernel launches for "
                             f"{svc['dispatches']} service dispatches")
    return {"launches": launches, "dispatches": svc["dispatches"],
            "mib_s": size / wall / MIB}


def control_plane_path(device, cell: int, bpc: int, seed: int) -> dict:
    """The control plane on the codec service: a MiniOzoneCluster of 12
    datanodes on 3 racks (SCM with rack-scatter placement, OM on sqlite),
    blocks of 16 cells. Through OzoneClient: an xor-6-1 key of three full
    groups and a short one, a RATIS/THREE key of one group and 7 B, and a
    second xor-6-1 key of one group and 12 345 B. Then the replicated key
    is re-encoded to rs-6-3, the first XOR key with unit 2's datanode down
    (the fused re-encode), the second with its parity's datanode down (a
    plain encode); every key is re-read byte-exact through OzoneClient.
    Last, every container is closed, one datanode of the RS groups dies,
    and ticks run until the SCM's reconstruction commands have rebuilt
    its replicas onto spares; the rebuilt chunks must equal the lost ones
    and the keys must read back byte-exact."""
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.storage.ids import BlockID, ContainerState, StorageError
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    block = 16 * cell
    rs, xor = f"rs-6-3-{cell // 1024}k", f"xor-6-1-{cell // 1024}k"
    rng = np.random.default_rng(seed + 4)
    sizes = {"x1": 3 * 6 * block + 12345, "rep": 6 * block + 7,
             "x2": 6 * block + 12345}
    data = {k: rng.integers(0, 256, n, dtype=np.uint8) for k, n in sizes.items()}
    out: dict = {}
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-cp-") as tmp:
        cluster = MiniOzoneCluster(Path(tmp), num_datanodes=12, racks=3, block_size=block,
                                   container_size=16 * block, stale_after_s=1e6,
                                   dead_after_s=2e6, placement_seed=seed, device=device)
        try:
            oz = cluster.client()
            vol = oz.create_volume("v")
            buckets = {"x1": vol.create_bucket("xor", replication=xor),
                       "rep": vol.create_bucket("rep", replication="RATIS/THREE"),
                       "x2": vol.create_bucket("xor2", replication=xor)}
            before = service_counts()
            fused_kernel.launches.reset()
            t0 = time.perf_counter()
            for name, b in buckets.items():
                b.write_key("k", data[name])
            put_s = time.perf_counter() - t0
            out["put_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"control plane: 12 datanodes on 3 racks; PUT of {sum(sizes.values())} B "
                  f"({xor} {sizes['x1']} B, RATIS/THREE {sizes['rep']} B, {xor} "
                  f"{sizes['x2']} B) through OzoneClient in {put_s:.3f} s; XOR encode "
                  f"launches {out['put_launches']} for {svc['dispatches']} service "
                  f"dispatches")
            if device.type == "cuda" and out["put_launches"] != svc["dispatches"]:
                raise AssertionError("XOR PUT: launches differ from service dispatches")

            out["reencode_replicated"] = reencode(
                cluster, device, "re-encode RATIS/THREE -> rs-6-3", "v", "rep", "k", rs,
                sizes["rep"])
            x1 = oz.om.lookup_key("v", "xor", "k")
            victim = {g["nodes"][2] for g in x1["block_groups"]}
            for dn_id in victim:
                kill_datanode(cluster, dn_id)
            out["reencode_xor"] = reencode(
                cluster, device, f"re-encode {xor} -> rs-6-3, unit 2 down {sorted(victim)}",
                "v", "xor", "k", rs, sizes["x1"])
            for dn_id in victim:
                revive_datanode(cluster, dn_id)
            x2 = oz.om.lookup_key("v", "xor2", "k")
            victim = {g["nodes"][6] for g in x2["block_groups"]}
            for dn_id in victim:
                kill_datanode(cluster, dn_id)
            out["reencode_xor_parity_lost"] = reencode(
                cluster, device, f"re-encode {xor} -> rs-6-3, XOR parity down "
                f"{sorted(victim)}", "v", "xor2", "k", rs, sizes["x2"])
            for dn_id in victim:
                revive_datanode(cluster, dn_id)
            for name, b in buckets.items():
                if not np.array_equal(b.read_key("k"), data[name]):
                    raise AssertionError(f"re-read of {name} differs from the source")
                off, n = sizes[name] // 3, sizes[name] // 2
                if not np.array_equal(b.read_key_range("k", off, n),
                                      data[name][off:off + n]):
                    raise AssertionError(f"ranged re-read of {name} differs")
            print("control plane: every re-encoded key re-read byte-exact through "
                  "OzoneClient (whole and ranged)")
            # the old versions retire through the SCM's deletion chain
            purged = cluster.om.run_key_deleting_service_once()
            cluster.tick(rounds=2)
            if purged != 3 or cluster.scm.deleted_blocks.pending_count():
                raise AssertionError(f"purge: {purged} keys, "
                                     f"{cluster.scm.deleted_blocks.pending_count()} pending")

            # SCM-driven repair: close everything, one RS datanode dies
            for dn in cluster.datanodes:
                for c in dn.list_containers():
                    if c.state is ContainerState.OPEN:
                        dn.close_container(c.id)
            cluster.tick()
            infos = {name: oz.om.lookup_key("v", b.name, "k") for name, b in buckets.items()}
            groups = [g for info in infos.values() for g in info["block_groups"]]
            victim = groups[0]["nodes"][0]
            lost = {}  # BlockID -> (unit, [(ChunkInfo, bytes)])
            vdn = cluster.datanode(victim)
            for g in groups:
                if victim in g["nodes"]:
                    bid = BlockID(int(g["container_id"]), int(g["local_id"]))
                    try:
                        chunks = vdn.get_block(bid).chunks
                    except StorageError:  # a unit holding no bytes of a short group
                        chunks = []
                    lost[bid] = (g["nodes"].index(victim),
                                 [(c, vdn.read_chunk(bid, c)) for c in chunks])
            kill_datanode(cluster, victim)
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            ticks = 0
            while True:
                cluster.tick()
                cluster.heartbeat_all()  # the rebuilt replicas report
                ticks += 1
                missing = ec_missing(cluster)
                if not missing or ticks >= 5:
                    break
            repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"SCM repair spans: {span_totals(since)}")
            if missing:
                raise AssertionError(f"after {ticks} ticks, replicas still missing: {missing}")
            host = Checksum(ChecksumType.CRC32C, bpc)
            per_target: dict[str, int] = {}
            n_chunks = 0
            for bid, (u, chunks) in lost.items():
                cinfo = cluster.scm.containers.get(bid.container_id)
                holders = [dn for dn, r in cinfo.replicas.items() if r.replica_index == u + 1]
                if len(holders) != 1 or holders[0] == victim:
                    raise AssertionError(f"{bid} replica index {u + 1}: {holders}")
                dst = cluster.datanode(holders[0])
                c = dst.containers.get(bid.container_id)
                if c.state is not ContainerState.CLOSED:
                    raise AssertionError(f"rebuilt container {bid.container_id} is "
                                         f"{c.state.value}")
                rebuilt = dst.get_block(bid).chunks if chunks else []
                if [(i.offset, i.length) for i, _ in chunks] != \
                        [(i.offset, i.length) for i in rebuilt]:
                    raise AssertionError(f"rebuilt chunk list of {bid} differs")
                for (_, want), info in zip(chunks, rebuilt):
                    got = dst.read_chunk(bid, info)
                    if not np.array_equal(got, want):
                        raise AssertionError(f"rebuilt chunk {info.name} differs")
                    if host.compute(got).checksums != info.checksum.checksums:
                        raise AssertionError(f"stored CRCs of rebuilt {info.name} != host")
                    per_target[holders[0]] = per_target.get(holders[0], 0) + info.length
                    n_chunks += 1
            rebuilt_mib_s = {t: n / repair_s / MIB for t, n in per_target.items()}
            print(f"SCM repair: {victim} dead; {len(lost)} blocks of its replicas rebuilt onto "
                  f"{sorted(per_target)} by the replication manager's commands in {ticks} "
                  f"ticks, {repair_s:.3f} s: " + ", ".join(
                      f"{t} {per_target[t]} B = {r:.1f} MiB/s" for t, r in
                      sorted(rebuilt_mib_s.items())) + " per target (wall); "
                  f"{n_chunks} rebuilt chunks equal the lost ones, CRCs equal host CRC32C; "
                  f"decode launches {out['repair_launches']}, service dispatches "
                  f"{svc['dispatches']}")
            if device.type == "cuda" and (out["repair_launches"] <= 0
                                          or out["repair_launches"] != svc["dispatches"]):
                raise AssertionError(f"SCM repair: {out['repair_launches']} kernel launches "
                                     f"for {svc['dispatches']} service dispatches")
            if not per_target:
                raise AssertionError("the SCM repair rebuilt no bytes")
            before = service_counts()
            fused_kernel.launches.reset()
            for name, b in buckets.items():
                if not np.array_equal(b.read_key("k"), data[name]):
                    raise AssertionError(f"re-read of {name} after the repair differs")
            out["degraded_launches"] = fused_kernel.launches.count
            check_launches_equal("re-read with the victim down", device,
                                 out["degraded_launches"], service_delta(before))
            print("control plane: every key re-read byte-exact with the dead datanode "
                  "still down")
            out["repair_mib_s_per_target"] = rebuilt_mib_s
        finally:
            cluster.close()
    return out


# ------------------------------------------------------- raw coder SPI
def check_coder_forms(device, cell: int, seed: int) -> dict:
    """The raw coder SPI's two forms of the kernel (no CRC rows) against
    their plain versions, exact: the matrix apply (`torch_coder.gf_apply`)
    with the RS(6,3) generator at cells of 1, 100 and 4097 B and `cell`,
    and an RS(10,4) [4, 10] decode (units 0-3 from units 4-13), which must
    also give the erased units; the XOR reduce (`torch_coder.xor_reduce`)
    over k = 3, 6 and 10 units. Returns the largest difference per form."""
    from ozone_tpu_torch.codec import rs_math, torch_coder
    from ozone_tpu_torch.codec.fused_kernel import gf_apply_plain

    rng = np.random.default_rng(seed + 7)
    worst = {"gf_apply": 0, "xor_reduce": 0}

    def data(b, k, c):
        return torch.from_numpy(rng.integers(0, 256, (b, k, c), dtype=np.uint8)).to(device)

    def compare(form, name, got, want):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = (got.int() - want.int()).abs().max().item()
        print(f"{form} kernel vs plain {name}: max_abs_err={diff} out={tuple(got.shape)}")
        if diff or got.shape != want.shape:
            raise AssertionError(f"{form} kernel disagrees with plain on {name}")
        worst[form] = max(worst[form], diff)

    pm = torch.from_numpy(rs_math.parity_matrix(6, 3)).to(device)
    for c, b in ((1, 8), (100, 8), (4097, 4), (cell, 8)):
        x = data(b, 6, c)
        compare("gf_apply", f"rs-6-3 [3, 6] cell={c} B={b} slice="
                f"{torch_coder.apply_slice(c)}", torch_coder.gf_apply(x, pm),
                gf_apply_plain(x, pm))
    x = data(8, 10, cell)
    units = torch.cat([x, gf_apply_plain(x, torch.from_numpy(
        rs_math.parity_matrix(10, 4)).to(device))], 1)
    valid, erased = list(range(4, 14)), [0, 1, 2, 3]
    dm = torch.from_numpy(rs_math.decode_matrix(10, 4, erased, valid)).to(device)
    inputs = units[:, valid].contiguous()
    rec = torch_coder.gf_apply(inputs, dm)
    compare("gf_apply", f"rs-10-4 decode [4, 10] erased={erased} cell={cell} B=8",
            rec, gf_apply_plain(inputs, dm))
    if not torch.equal(rec, units[:, erased]):
        raise AssertionError("the RS(10,4) decode does not give the erased units")
    for k in (3, 6, 10):
        x = data(8, k, cell)
        compare("xor_reduce", f"[1, {k}] cell={cell} B=8", torch_coder.xor_reduce(x),
                torch_coder.xor_reduce_plain(x))
    return worst


def time_coder_forms(device, cell: int, seed: int) -> dict:
    """The two SPI forms at the rawcoder bench's RS(6,3) shape, B=8: the
    matrix apply [3, 6] (bound: 48 + 24 MiB moved at 1 MiB cells) and the
    XOR reduce [1, 6] (48 + 8 MiB)."""
    from ozone_tpu_torch.codec import rs_math, torch_coder
    from ozone_tpu_torch.codec.fused_kernel import gf_apply_plain

    rng = np.random.default_rng(seed + 8)
    b = 8
    x = torch.from_numpy(rng.integers(0, 256, (b, 6, cell), dtype=np.uint8)).to(device)
    pm = torch.from_numpy(rs_math.parity_matrix(6, 3)).to(device)
    out = {}
    for form, p, run, plain in (
            ("gf_apply", 3, lambda: torch_coder.gf_apply(x, pm),
             lambda: gf_apply_plain(x, pm)),
            ("xor_reduce", 1, lambda: torch_coder.xor_reduce(x),
             lambda: torch_coder.xor_reduce_plain(x))):
        bound = fused_bound(b, 6, p, cell, cell, rows=0)
        out[form] = {**time_form(f"{form} [{p}, 6] (no CRC rows) cell={cell} B={b}",
                                 run, plain, bound, b * 6 * cell),
                     "bound_by": bound[1]}
    print("library_ms: none for gf_apply and xor_reduce; no single PyTorch call "
          "computes a GF(2^8) matrix product, and torch has no bitwise-XOR reduction")
    return out


def rawcoder_phase(device, cell: int) -> dict:
    """freon's rawcoder_bench at B=8: rs-6-3 and rs-10-4 for the torch,
    cpp and numpy coders, xor-6-1 for torch and numpy (numpy one timed
    call, the others three). Fails on an "error" row; the registry must
    answer torch, cpp, numpy for rs, the cpp coder must be the AVX2 build,
    kernel launches must equal the torch coder's calls, and the torch
    coder's parity and decoded units must equal numpy's."""
    from ozone_tpu_torch.codec import (
        CoderOptions,
        cpp_coder,
        create_decoder,
        create_encoder,
        fused_kernel,
        torch_coder,
    )
    from ozone_tpu_torch.codec.registry import CodecRegistry
    from ozone_tpu_torch.tools import freon

    reg = CodecRegistry.instance()
    probe = cpp_coder.probe()
    print(f"coder registry: rs {reg.backends('rs')}, xor {reg.backends('xor')}, "
          f"lrc {reg.backends('lrc')}, dummy {reg.backends('dummy')}; "
          f"cpp coder probe {probe} (2 = AVX2 nibble shuffle, 0 = scalar loop)")
    if reg.backends("rs") != ["torch", "cpp", "numpy"]:
        raise AssertionError(f"registry order for rs: {reg.backends('rs')}")
    if probe < 2:
        raise AssertionError("the cpp coder is not the AVX2 build")
    enc = create_encoder(CoderOptions(6, 3, "rs", cell), device=device)
    before = fused_kernel.launches.count
    enc.encode(np.zeros((1, 6, cell), dtype=np.uint8))
    if not isinstance(enc, torch_coder.TorchRSEncoder) or (
            device.type == "cuda" and fused_kernel.launches.count - before != 1):
        raise AssertionError(f"the registry's default rs encoder ({type(enc).__name__}) "
                             "did not launch the kernel")

    runs = (("rs-6-3", ["torch", "cpp"], 3), ("rs-6-3", ["numpy"], 1),
            ("rs-10-4", ["torch", "cpp"], 3), ("rs-10-4", ["numpy"], 1),
            ("xor-6-1", ["torch"], 3), ("xor-6-1", ["numpy"], 1))
    calls = {"gf_apply": 0, "xor_reduce": 0}
    fused_kernel.launches.reset()
    torch_coder.apply_launches.reset()
    torch_coder.xor_launches.reset()
    rows = []
    for schema, backends, iters in runs:
        rows += freon.rawcoder_bench(backends, schema, cell, 8, iters, device=device)
        if "torch" in backends:  # a warm-up and `iters` calls, each way
            calls["xor_reduce" if schema.startswith("xor") else "gf_apply"] += 2 * (iters + 1)
    out = {"rows": rows, "launches": fused_kernel.launches.count,
           "gf_apply_launches": torch_coder.apply_launches.count,
           "xor_reduce_launches": torch_coder.xor_launches.count}
    for r in rows:
        print(f"rawcoder_bench cell={cell} B=8: {json.dumps(r)}")
    if any("error" in r for r in rows):
        raise AssertionError("a rawcoder_bench row failed")
    print(f"rawcoder_bench: kernel launches {out['launches']} (gf_apply "
          f"{out['gf_apply_launches']}, xor_reduce {out['xor_reduce_launches']}) for "
          f"torch coder calls {calls}")
    if device.type == "cuda" and (
            out["gf_apply_launches"] != calls["gf_apply"]
            or out["xor_reduce_launches"] != calls["xor_reduce"]
            or out["launches"] != sum(calls.values())):
        raise AssertionError("rawcoder_bench: kernel launches differ from the torch "
                             "coder's calls")
    for schema in ("rs-6-3", "rs-10-4", "xor-6-1"):
        codec, k, p = schema.split("-")
        opts = CoderOptions(int(k), int(p), codec, cell)
        data = np.random.default_rng(2).integers(0, 256, (8, opts.data_units, cell),
                                                 dtype=np.uint8)
        parity = create_encoder(opts, "numpy").encode(data)
        if not np.array_equal(create_encoder(opts, "torch", device).encode(data), parity):
            raise AssertionError(f"{schema}: torch parity differs from numpy's")
        units = np.concatenate([data, parity], axis=1)
        erased = list(range(min(2, opts.parity_units)))
        inputs = [None if i in erased else units[:, i] for i in range(opts.all_units)]
        got = create_decoder(opts, "torch", device).decode(inputs, erased)
        if not (np.array_equal(got, create_decoder(opts, "numpy").decode(inputs, erased))
                and np.array_equal(got, units[:, erased])):
            raise AssertionError(f"{schema}: torch decode differs from numpy's")
    print("rawcoder_bench: torch parity and decoded units equal numpy's (rs-6-3, "
          "rs-10-4, xor-6-1)")
    return out


def freon_path(device, cell: int, bpc: int, seed: int) -> dict:
    """Freon's EC generators and the reconstruction storm, on the codec
    service, after the rawcoder bench: a MiniOzoneCluster of 12 datanodes
    on 3 racks, rs-6-3 at `cell`, CRC32C over bpc, blocks of 16 cells and
    containers of three blocks.
    - ockg: 48 keys of one block (8 threads, one warm-up key), then ockv
      over all 48 and ockrr with 64 ranged reads of one cell; no failures,
      launches = service dispatches;
    - ecrd: a key of 64 cells, 3 rounds (freon's defaults at 1 MiB);
    - the storm: every container closed, the datanode with the most
      closed EC containers (at least 8) dies (the SCM's liveness sweep
      declares it DEAD), and `ReconstructionStorm.repair_datanode` rebuilds
      all of them; every rebuilt chunk must equal the lost one, with
      stored CRCs equal to the host CRC32C, and launches = dispatches."""
    from ozone_tpu_torch.client.reconstruction import ReconstructionStorm
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.scm.pipeline import ReplicationType
    from ozone_tpu_torch.storage.ids import ContainerState
    from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
    from ozone_tpu_torch.tools import freon
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    out = {"rawcoder": rawcoder_phase(device, cell)}
    block = 16 * cell
    ec = f"rs-6-3-{cell // 1024}k"
    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-freon-") as tmp:
        cluster = MiniOzoneCluster(Path(tmp), num_datanodes=12, racks=3, block_size=block,
                                   container_size=3 * block, stale_after_s=1e6,
                                   dead_after_s=2e6, placement_seed=seed, device=device)
        try:
            oz = cluster.client()

            def generator(what, run):
                before = service_counts()
                fused_kernel.launches.reset()
                rep = run()
                launches = fused_kernel.launches.count
                check_launches_equal(what, device, launches, service_delta(before))
                if isinstance(rep, dict):
                    print(f"{what}: {json.dumps(rep)}")
                    return rep, launches
                summary = {k: v for k, v in rep.summary().items() if k != "histogram"}
                print(f"{what}: {json.dumps(summary)}")
                if rep.failures or not rep.ops:
                    raise AssertionError(f"{what}: {rep.failures} failures of {rep.ops}")
                return summary, launches

            out["ockg"], out["ockg_launches"] = generator(
                f"ockg 48 keys of {block} B {ec}, 8 threads", lambda: freon.ockg(
                    oz, n_keys=48, size=block, threads=8, replication=ec, warmup=1))
            out["ockv"], out["ockv_launches"] = generator(
                "ockv 48 keys", lambda: freon.ockv(oz, n_keys=48, size=block, threads=8))
            out["ockrr"], out["ockrr_launches"] = generator(
                f"ockrr 64 reads of {cell} B", lambda: freon.ockrr(
                    oz, 64, threads=8, size=cell, n_keys=48))
            out["ecrd"], out["ecrd_launches"] = generator(
                f"ecrd {64 * cell} B, 3 rounds", lambda: freon.ecrd(
                    oz, cluster.scm, size=64 * cell, rounds=3, replication=ec))
            print(f"ecrd: reconstruct_mib_s_per_datanode "
                  f"{out['ecrd']['reconstruct_mib_s_per_datanode']}")

            # the storm: close every container, let the SCM see the reports
            for dn in cluster.datanodes:
                for c in dn.list_containers():
                    if c.state is ContainerState.OPEN:
                        dn.close_container(c.id)
            cluster.tick()
            cluster.heartbeat_all()
            held: dict[str, list] = {}
            for c in cluster.scm.containers.containers():
                if c.replication.type is ReplicationType.EC \
                        and c.state is ContainerState.CLOSED:
                    for dn_id in c.replicas:
                        held.setdefault(dn_id, []).append(c)
            victim = max(sorted(held), key=lambda d: len(held[d]))
            if len(held[victim]) < 8:
                raise AssertionError(f"{victim} holds {len(held[victim])} closed EC "
                                     "containers; the storm needs 8")
            vdn = cluster.datanode(victim)
            lost = {}  # container id -> (replica index, [(BlockID, [(ChunkInfo, bytes)])])
            for c in held[victim]:
                lost[c.id] = (c.replicas[victim].replica_index, [
                    (bd.block_id, [(i, vdn.read_chunk(bd.block_id, i)) for i in bd.chunks])
                    for bd in vdn.list_blocks(c.id)])
            kill_datanode(cluster, victim)
            storm = ReconstructionStorm(cluster.scm, cluster.clients, device=device)
            plans: list = []
            plan = storm.plan
            storm.plan = lambda dn_id: plans.append(plan(dn_id)) or plans[-1]
            before = service_counts()
            fused_kernel.launches.reset()
            since = time.time()
            report = storm.repair_datanode(victim)
            out["storm_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            print(f"storm spans: {span_totals(since)}")
            planned = {cmd.container_id: cmd for cmd in plans[0]}
            print(f"storm plan: {len(planned)} containers, {len(lost)} closed ones held "
                  f"by {victim}: " + ", ".join(
                      f"{cid} {sorted(cmd.targets.items())}" for cid, cmd in
                      sorted(planned.items())))
            if not report.ok or report.containers_repaired != report.containers_planned \
                    or set(lost) != set(planned):
                raise AssertionError(f"storm: {report}")
            host = Checksum(ChecksumType.CRC32C, bpc)
            per_target: dict[str, int] = {}
            n_chunks = 0
            for cmd in plans[0]:
                idx, blocks = lost[cmd.container_id]
                target = cmd.targets[idx]
                dst = cluster.datanode(target)
                c = dst.containers.get(cmd.container_id)
                if c.state is not ContainerState.CLOSED or c.replica_index != idx:
                    raise AssertionError(f"rebuilt container {cmd.container_id} on {target}"
                                         f" is {c.state.value}, index {c.replica_index}")
                for bid, chunks in blocks:
                    rebuilt = dst.get_block(bid).chunks
                    if [(i.offset, i.length) for i, _ in chunks] != \
                            [(i.offset, i.length) for i in rebuilt]:
                        raise AssertionError(f"rebuilt chunk list of {bid} differs")
                    for (_, want), info in zip(chunks, rebuilt):
                        got = dst.read_chunk(bid, info)
                        if not np.array_equal(got, want):
                            raise AssertionError(f"rebuilt chunk {info.name} differs")
                        if host.compute(got).checksums != info.checksum.checksums:
                            raise AssertionError(f"stored CRCs of rebuilt {info.name} "
                                                 "!= host CRC32C")
                        per_target[target] = per_target.get(target, 0) + info.length
                        n_chunks += 1
            mib_s = {t: n / report.elapsed_s / MIB for t, n in sorted(per_target.items())}
            print(f"storm: {victim} dead; {report.containers_repaired} of "
                  f"{report.containers_planned} planned containers repaired in "
                  f"{report.elapsed_s:.3f} s, {n_chunks} rebuilt chunks equal the lost "
                  f"ones, CRCs equal host CRC32C; " + ", ".join(
                      f"{t} {per_target[t]} B = {r:.1f} MiB/s" for t, r in mib_s.items())
                  + f" per target, {sum(per_target.values()) / report.elapsed_s / MIB:.1f} "
                  f"MiB/s in all; decode launches {out['storm_launches']}, service "
                  f"dispatches {svc['dispatches']} of {svc['submissions']} submissions, "
                  f"multi_op_dispatches {svc['multi_op_dispatches']}")
            if device.type == "cuda" and (out["storm_launches"] <= 0
                                          or out["storm_launches"] != svc["dispatches"]):
                raise AssertionError(f"storm: {out['storm_launches']} kernel launches for "
                                     f"{svc['dispatches']} service dispatches")
            out["storm"] = {"containers": report.containers_repaired,
                            "elapsed_s": report.elapsed_s, "mib_s_per_target": mib_s,
                            "multi_op_dispatches": svc["multi_op_dispatches"],
                            "dispatches": svc["dispatches"]}
        finally:
            cluster.close()
    return out


def check_launches_equal(what: str, device, launches: int, svc: dict) -> None:
    print(f"{what}: kernel launches {launches}, service dispatches {svc['dispatches']}")
    if device.type == "cuda" and launches != svc["dispatches"]:
        raise AssertionError(f"{what}: {launches} kernel launches for "
                             f"{svc['dispatches']} service dispatches")


# ------------------------------------------------------------- daemon path
def stop_server(d) -> None:
    """Stop a daemon's datanode RPC server and its native datapath sidecar."""
    d.server.stop()
    d.stop_datapath()


def restart_server(d) -> None:
    """Serve a daemon's datanode verbs again on its old port, with a new
    native sidecar, after stop_server (the registered address stays valid;
    clients discover the sidecar's new port)."""
    from ozone_tpu_torch.net.dn_service import DatanodeRpcService
    from ozone_tpu_torch.net.rpc import RpcServer
    from ozone_tpu_torch.storage.fast_datapath import DatapathSidecar

    d.datapath = DatapathSidecar(d.dn)
    d.datapath.start()
    d.server = RpcServer(port=d.server.port)
    d.service = DatanodeRpcService(d.dn, d.server, datapath_port=d.advertise)
    d.server.start()


LANE_COUNTERS = ("copies", "bytes_copied", "bytes_moved", "native_fallbacks")


class LaneMeter:
    """Deltas across a with-block of the client's `datapath` registry (host
    copies, bytes moved without a copy, native-lane fallbacks) and of the
    daemons' lane counters (native streams, RPC chunk calls, chunks and
    bytes written)."""

    DN_COUNTERS = ("native_write_streams", "native_read_streams",
                   "rpc_chunk_calls", "batched_write_chunks", "batched_read_chunks",
                   "bytes_written")

    def __init__(self, daemons):
        from ozone_tpu_torch.codec import hostmem

        self._reg = hostmem.METRICS
        self._dns = list(daemons)

    def _read(self) -> dict:
        out = {n: self._reg.counter(n).value for n in LANE_COUNTERS}
        for n in self.DN_COUNTERS:
            out[n] = sum(d.dn.metrics.counter(n).value for d in self._dns)
        return out

    def __enter__(self):
        self._v0 = self._read()
        return self

    def __exit__(self, *exc):
        self.d = {k: v - self._v0[k] for k, v in self._read().items()}

    def line(self, chunks_key: str) -> str:
        d = self.d
        chunks = d[chunks_key]
        per = d["copies"] / chunks if chunks else float("nan")
        return (f"native streams w{d['native_write_streams']}/r{d['native_read_streams']}, "
                f"RPC chunk calls {d['rpc_chunk_calls']}, {chunks} chunks, bytes moved "
                f"natively {d['bytes_moved']}, host copies {d['copies']} "
                f"({d['bytes_copied']} B) = {per:.3f} per chunk, native fallbacks "
                f"{d['native_fallbacks']}")


def span_stat(since: float, name: str) -> tuple[int, float]:
    """Count and summed seconds of the tracer's spans `name` since `since`."""
    from ozone_tpu_torch.utils.tracing import Tracer

    spans = [sp for sp in Tracer.instance().traces() if sp.start >= since and sp.name == name]
    return len(spans), sum(sp.duration for sp in spans)


def wait_for(what: str, cond, timeout_s: float, poll_s: float = 0.1) -> float:
    """Poll cond() until true; seconds waited. Raises after timeout_s."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(poll_s)
    return time.perf_counter() - t0


def concurrent(fn, items) -> list:
    """fn(item) for every item, each on its own thread, in item order."""
    out: list = [None] * len(items)
    errors: list = []

    def run(i):
        try:
            out[i] = fn(items[i])
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise TimeoutError("a concurrent operation did not finish")
    if errors:
        raise errors[0]
    return out


def daemon_cluster_in_process(device, cell: int, bpc: int, seed: int,
                              in_process_put_gib_s: float) -> dict:
    """One ScmOmDaemon and 12 DatanodeDaemons on loopback on 3 racks, the
    codec on `device`, driven through a remote OzoneClient: the PUT phase's
    four keys concurrently over the native datapath, then again over the
    RPC lane; a GET over each lane and in process; a degraded GET with two
    holders' servers and sidecars stopped; an admin close of the
    containers, a datanode's death and the SCM's reconstruction over
    heartbeats; and a scrub of every live daemon's closed containers. The
    native runs must move every chunk over the native lane: no fallback,
    no RPC chunk call, no server-side chunk span."""
    from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
    from ozone_tpu_torch.client.ozone_client import OzoneClient
    from ozone_tpu_torch.codec import fused_kernel
    from ozone_tpu_torch.net.daemons import DatanodeDaemon, ScmOmDaemon
    from ozone_tpu_torch.net.om_service import RemoteOmClient
    from ozone_tpu_torch.net.scm_service import RemoteScmClient
    from ozone_tpu_torch.scm.node_manager import NodeState
    from ozone_tpu_torch.storage.ids import BlockID, ContainerState, StorageError
    from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

    rs = f"rs-6-3-{cell // 1024}k"
    rng = np.random.default_rng(seed)
    sizes = [192 * cell, 192 * cell, 96 * cell + 12345, cell + 7]
    keys = [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
    total = sum(sizes)
    out: dict = {}

    def no_rpc_chunks(what: str, meter: LaneMeter, since: float, verbs) -> None:
        spans = {v: span_stat(since, f"server:{v}")[0] for v in verbs}
        if meter.d["rpc_chunk_calls"] or any(spans.values()) \
                or meter.d["bytes_moved"] <= 0:
            raise AssertionError(f"{what}: chunk bytes left the native lane: "
                                 f"{meter.d}, server spans {spans}")

    with codec_route(True), tempfile.TemporaryDirectory(prefix="chip-smoke-dm-") as tmp:
        root = Path(tmp)
        meta = ScmOmDaemon(root / "om.db", block_size=16 * cell,
                           container_size=256 * cell, stale_after_s=3.0,
                           dead_after_s=6.0, background_interval_s=0.5,
                           placement_seed=seed)
        meta.start()
        dns = []
        clients = DatanodeClientFactory()
        om = RemoteOmClient(meta.address, clients=clients)
        rpc_clients = DatanodeClientFactory(native_datapath=False)
        om_rpc = RemoteOmClient(meta.address, clients=rpc_clients)
        scm = RemoteScmClient(meta.address)
        try:
            for i in range(12):
                d = DatanodeDaemon(root / f"dn{i}", f"dn{i}", meta.address,
                                   rack=f"/rack{i % 3}", heartbeat_interval_s=0.5,
                                   device=device)
                d.start()
                dns.append(d)
            by_id = {d.dn.id: d for d in dns}
            wait_for("12 datanodes registered",
                     lambda: len(scm.status()["nodes"]) == 12, 30)
            oz = OzoneClient(om, clients, device=device)
            bucket = oz.create_volume("v").create_bucket("b", replication=rs)
            rpc_bucket = OzoneClient(om_rpc, rpc_clients, device=device).get_volume(
                "v").create_bucket("r", replication=rs)
            names = [f"k{i}" for i in range(len(keys))]
            lanes = [d.advertise() for d in dns]
            if any(not lane or not lane["port"] for lane in lanes):
                raise AssertionError(f"a daemon advertises no native datapath: {lanes}")
            print(f"daemon native datapath: 12 sidecars, ports "
                  f"{[lane['port'] for lane in lanes]}, unix sockets "
                  f"{sum(bool(lane['uds']) for lane in lanes)}")

            # PUT over the native lane, then the same keys over the RPC lane:
            # the client's launches are the service's
            def put_phase(lane: str, bkt) -> float:
                before = service_counts()
                fused_kernel.launches.reset()
                since, t0 = time.time(), time.perf_counter()
                with LaneMeter(dns) as m:
                    concurrent(lambda i: bkt.write_key(names[i], keys[i]), range(len(keys)))
                put_s = time.perf_counter() - t0
                launches = fused_kernel.launches.count
                svc = service_delta(before)
                print(f"daemon PUT ({lane} lane) spans: {span_totals(since)}")
                print(f"daemon PUT over the {lane} lane: 4 concurrent {rs} PUTs through a "
                      f"remote OzoneClient into 12 DatanodeDaemons, {total} B in "
                      f"{put_s:.3f} s = {total / put_s / 2**30:.3f} GiB/s (wall), next to "
                      f"{in_process_put_gib_s:.3f} GiB/s for the same keys in process (main "
                      f"path, service route, earlier in this run); kernel launches "
                      f"{launches}, service dispatches {svc['dispatches']}, queue wait "
                      f"{svc['queue_wait_ms']:.3f} ms, dispatch {svc['dispatch_ms']:.3f} ms "
                      f"(means); {m.line('batched_write_chunks')}")
                if device.type == "cuda" and (launches <= 0 or launches != svc["dispatches"]):
                    raise AssertionError(f"daemon PUT ({lane}): {launches} launches for "
                                         f"{svc['dispatches']} service dispatches")
                if lane == "native":
                    no_rpc_chunks("daemon PUT (native)", m, since,
                                  ("WriteChunksCommit", "WriteChunk", "StreamWriteBlock"))
                    if m.d["native_fallbacks"] or m.d["bytes_moved"] != m.d["bytes_written"] \
                            or m.d["bytes_moved"] < total:
                        raise AssertionError(f"daemon PUT (native): {m.d}")
                    out["put_launches"] = launches
                    out["put_copies_per_chunk"] = m.d["copies"] / m.d["batched_write_chunks"]
                elif m.d["native_write_streams"] or not m.d["rpc_chunk_calls"]:
                    raise AssertionError(f"daemon PUT (rpc): {m.d}")
                else:
                    out["put_rpc_launches"] = launches
                return total / put_s / 2**30

            out["put_gib_s"] = put_phase("native", bucket)
            out["put_rpc_gib_s"] = put_phase("RPC", rpc_bucket)
            infos = [om.lookup_key("v", "b", n) for n in names]
            rpc_infos = [om.lookup_key("v", "r", n) for n in names]
            if [i["size"] for i in infos] != sizes or [i["size"] for i in rpc_infos] != sizes:
                raise AssertionError(f"daemon PUT: key sizes {[i['size'] for i in infos]}, "
                                     f"{[i['size'] for i in rpc_infos]}")

            # GET over each lane, then the same chunks through in-process clients
            local = DatanodeClientFactory()
            for d in dns:
                local.register_local(d.dn)
            for what, factory in (("over the native lane", clients),
                                  ("over the RPC lane", rpc_clients), ("in process", local)):
                reader = OzoneClient(om, factory, device=device).get_volume(
                    "v").get_bucket("b")
                since, t0 = time.time(), time.perf_counter()
                with LaneMeter(dns) as m:
                    got = concurrent(reader.read_key_info, infos)
                get_s = time.perf_counter() - t0
                if not all(np.array_equal(g, k) for g, k in zip(got, keys)):
                    raise AssertionError(f"daemon GET {what}: bytes differ")
                del got
                key = {clients: "native", rpc_clients: "rpc", local: "local"}[factory]
                out[f"get_gib_s_{key}"] = total / get_s / 2**30
                print(f"daemon GET {what}: {total} B byte-exact in {get_s:.3f} s = "
                      f"{total / get_s / 2**30:.3f} GiB/s (wall); "
                      f"{m.line('batched_read_chunks')}")
                if key == "native":
                    no_rpc_chunks("daemon GET (native)", m, since, ("ReadChunks", "ReadChunk"))
                    if m.d["native_fallbacks"] or m.d["bytes_moved"] < total:
                        raise AssertionError(f"daemon GET (native): {m.d}")
                    out["get_copies_per_chunk"] = m.d["copies"] / max(
                        1, m.d["batched_read_chunks"])

            # degraded GET: two holders' servers and sidecars stop
            g0 = infos[0]["block_groups"][0]
            down = g0["nodes"][:2]
            for dn_id in down:
                stop_server(by_id[dn_id])
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            with LaneMeter([d for d in dns if d.dn.id not in down]) as m:
                got = concurrent(bucket.read_key_info, infos)
            deg_s = time.perf_counter() - t0
            out["degraded_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            if not all(np.array_equal(g, k) for g, k in zip(got, keys)):
                raise AssertionError("daemon degraded GET: bytes differ")
            del got
            print(f"daemon degraded GET ({down} servers and sidecars stopped): {total} B "
                  f"byte-exact in {deg_s:.3f} s = {total / deg_s / 2**30:.3f} GiB/s (wall); "
                  f"decode launches {out['degraded_launches']}, service dispatches "
                  f"{svc['dispatches']}; {m.line('batched_read_chunks')}")
            no_rpc_chunks("daemon degraded GET", m, since, ("ReadChunks", "ReadChunk"))
            if device.type == "cuda" and (out["degraded_launches"] <= 0 or
                                          out["degraded_launches"] != svc["dispatches"]):
                raise AssertionError("daemon degraded GET: launches differ from dispatches")
            for dn_id in down:
                restart_server(by_id[dn_id])

            # admin close of every container; the replicas report CLOSED
            cids = [c["id"] for c in scm.list_containers()]
            for cid in cids:
                scm.admin("close-container", str(cid))
            waited = wait_for("containers closed", lambda: all(
                c["state"] == "CLOSED" and all(r["state"] == "CLOSED"
                                               for r in c["replicas"])
                for c in scm.list_containers()), 30)
            print(f"daemon admin close: containers {cids} CLOSED on the SCM and on "
                  f"every replica in {waited:.2f} s")

            # one datanode dies; the SCM's commands rebuild its replicas
            victim = g0["nodes"][2]
            vdn = by_id[victim].dn
            lost = {}  # BlockID -> (unit, [(ChunkInfo, bytes)])
            for info in infos + rpc_infos:
                for g in info["block_groups"]:
                    if victim in g["nodes"]:
                        bid = BlockID(int(g["container_id"]), int(g["local_id"]))
                        try:
                            chunks = vdn.get_block(bid).chunks
                        except StorageError:  # no bytes of a short group
                            chunks = []
                        lost[bid] = (g["nodes"].index(victim),
                                     [(c, vdn.read_chunk(bid, c).copy()) for c in chunks])
            by_id[victim].stop()
            dead_s = wait_for(f"{victim} declared dead", lambda: meta.scm.nodes.get(
                victim).state is NodeState.DEAD, 30)
            before = service_counts()
            fused_kernel.launches.reset()
            since, t0 = time.time(), time.perf_counter()
            meter = LaneMeter([d for d in dns if d.dn.id != victim])
            meter.__enter__()

            def rebuilt():
                with meta.scm_service.lock:
                    for bid, (u, _) in lost.items():
                        c = meta.scm.containers.get(bid.container_id)
                        held = [dn for dn, r in c.replicas.items()
                                if r.replica_index == u + 1 and dn != victim
                                and r.state == "CLOSED"]
                        if len(held) != 1:
                            return False
                return True

            wait_for("reconstruction over heartbeats", rebuilt, 60, poll_s=0.05)
            repair_s = time.perf_counter() - t0
            out["repair_launches"] = fused_kernel.launches.count
            svc = service_delta(before)
            meter.__exit__()
            print(f"daemon repair spans: {span_totals(since)}")
            print(f"daemon repair reads: {meter.line('batched_read_chunks')}")
            no_rpc_chunks("daemon repair", meter, since, ("ReadChunks", "ReadChunk"))
            if meter.d["native_fallbacks"]:
                raise AssertionError(f"daemon repair: native fallbacks {meter.d}")
            host = Checksum(ChecksumType.CRC32C, bpc)
            per_target: dict[str, int] = {}
            n_chunks = 0
            for bid, (u, chunks) in lost.items():
                c = meta.scm.containers.get(bid.container_id)
                holder = next(dn for dn, r in c.replicas.items()
                              if r.replica_index == u + 1 and dn != victim)
                dst = by_id[holder].dn
                if dst.containers.get(bid.container_id).state is not ContainerState.CLOSED:
                    raise AssertionError(f"rebuilt container {bid.container_id} not CLOSED")
                rebuilt_chunks = dst.get_block(bid).chunks if chunks else []
                if [(i.offset, i.length) for i, _ in chunks] != \
                        [(i.offset, i.length) for i in rebuilt_chunks]:
                    raise AssertionError(f"rebuilt chunk list of {bid} differs")
                for (_, want), info in zip(chunks, rebuilt_chunks):
                    got = dst.read_chunk(bid, info)
                    if not np.array_equal(got, want):
                        raise AssertionError(f"rebuilt chunk {info.name} differs")
                    if host.compute(got).checksums != info.checksum.checksums:
                        raise AssertionError(f"stored CRCs of rebuilt {info.name} != host")
                    per_target[holder] = per_target.get(holder, 0) + info.length
                    n_chunks += 1
            out["repair_mib_s_per_target"] = {t: n / repair_s / MIB
                                              for t, n in per_target.items()}
            print(f"daemon repair: {victim} stopped, DEAD on the SCM after {dead_s:.2f} s; "
                  f"{len(lost)} blocks rebuilt by ReconstructionCommands over heartbeats "
                  f"in {repair_s:.3f} s: " + ", ".join(
                      f"{t} {per_target[t]} B = {r:.1f} MiB/s" for t, r in
                      sorted(out["repair_mib_s_per_target"].items())) +
                  f" per target (wall, from the death); {n_chunks} rebuilt chunks equal "
                  f"the lost ones, CRCs equal host CRC32C; decode launches "
                  f"{out['repair_launches']}, service dispatches {svc['dispatches']}")
            if not per_target:
                raise AssertionError("the daemon repair rebuilt no bytes")
            if any(d.failed_commands for d in dns if d.dn.id != victim):
                raise AssertionError(f"commands failed: "
                                     f"{[d.failed_commands for d in dns]}")
            if device.type == "cuda" and (out["repair_launches"] <= 0 or
                                          out["repair_launches"] != svc["dispatches"]):
                raise AssertionError("daemon repair: launches differ from dispatches")

            # the daemons' scrub of their closed containers
            live = [d for d in dns if d.dn.id != victim]
            scanned = sum(i.length for d in live for c in d.dn.list_containers()
                          for b in c.list_blocks() for i in b.chunks)
            disp0 = sum(d._scrubber.dispatches for d in live)
            fused_kernel.launches.reset()
            t0 = time.perf_counter()
            found = {}
            for d in live:
                for _ in d.dn.list_containers():
                    errs = d.scan_once()
                    if errs:
                        found[d.dn.id] = errs
            scrub_s = time.perf_counter() - t0
            out["scrub_launches"] = fused_kernel.launches.count
            dispatches = sum(d._scrubber.dispatches for d in live) - disp0
            out["scrub_gib_s"] = scanned / scrub_s / 2**30
            print(f"daemon scrub: scan_once over the closed containers of {len(live)} "
                  f"daemons, {scanned} B in {scrub_s:.3f} s = {out['scrub_gib_s']:.3f} "
                  f"GiB/s (wall); kernel launches {out['scrub_launches']}, scrub "
                  f"dispatches {dispatches}")
            if found:
                raise AssertionError(f"the daemons' scrub found errors: {found}")
            if device.type == "cuda" and (out["scrub_launches"] <= 0
                                          or out["scrub_launches"] != dispatches):
                raise AssertionError("daemon scrub: launches differ from dispatches")
            out["degraded_gib_s"] = total / deg_s / 2**30
        finally:
            om.close()
            om_rpc.close()
            scm.close()
            clients.close()
            rpc_clients.close()
            for d in dns:
                d.stop()
            meta.stop()
    return out


def daemon_cluster_processes(device, cell: int, seed: int) -> dict:
    """`python -m ozone_tpu_torch.tools cluster --datanodes 10` (the supervisor,
    an scm-om and ten datanode processes) driven through the CLI: a volume,
    an rs-6-3 bucket, a key put and get with a byte compare, freon ockg and
    admin status; then every process is torn down by pid."""
    import signal
    import socket

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    dev = "cpu" if device.type == "cpu" else "cuda"
    rs = f"rs-6-3-{cell // 1024}k"
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    om = f"127.0.0.1:{port}"

    def cli(*argv, timeout=180):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ozone_tpu_torch.tools", *argv],
                              capture_output=True, text=True, timeout=timeout,
                              cwd=str(repo), env=env)
        if proc.returncode != 0:
            raise AssertionError(f"cli {argv[:3]} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        return proc.stdout, time.perf_counter() - t0

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        with open(root / "supervisor.log", "w") as log:
            sup = subprocess.Popen(
                [sys.executable, "-m", "ozone_tpu_torch.tools", "cluster",
                 "--datanodes", "10", "--port", str(port), "--root", str(root / "c"),
                 "--device", dev],
                stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                cwd=str(repo), env=env)
        pids: list[int] = []
        try:
            def up():
                text = (root / "supervisor.log").read_text()
                if sup.poll() is not None:
                    raise AssertionError(f"the cluster supervisor exited: {text[-2000:]}")
                for line in text.splitlines():
                    if line.startswith("cluster up:"):
                        pids[:] = json.loads(line.split("pids=")[1])
                        return True
                return False

            up_s = wait_for("the CLI cluster up", up, 180, poll_s=0.25)
            print(f"cli cluster: supervisor {sup.pid}, children {pids}, up in {up_s:.2f} s")
            rng = np.random.default_rng(seed + 8)
            payload = rng.integers(0, 256, 64 * cell + 12345, dtype=np.uint8)
            src, dst = root / "in.bin", root / "out.bin"
            src.write_bytes(payload.tobytes())
            times: dict[str, float] = {}

            def key_chain():
                """sh volume and bucket create, key put, key get."""
                for name, argv in (
                        ("volume create", ("sh", "volume", "create", "/cv", "--om", om)),
                        ("bucket create", ("sh", "bucket", "create", "/cv/b", "--om", om,
                                           "--replication", rs)),
                        ("key put", ("sh", "key", "put", "/cv/b/key", str(src), "--om", om,
                                     "--device", dev)),
                        ("key get", ("sh", "key", "get", "/cv/b/key", str(dst), "--om", om,
                                     "--device", dev))):
                    times[name] = cli(*argv)[1]
                return dst.read_bytes() == payload.tobytes()

            def ockg():
                text, times["freon ockg"] = cli(
                    "freon", "ockg", "-n", "16", "-s", str(16 * cell), "--om", om,
                    "--device", dev, "--replication", rs)
                return json.loads(text)

            def status():
                text, times["admin status"] = cli("admin", "status", "--om", om)
                return json.loads(text)

            t1 = time.perf_counter()
            same, rep, st = concurrent(lambda f: f(), [key_chain, ockg, status])
            print(f"cli commands, the key chain beside freon and admin status: "
                  f"{time.perf_counter() - t1:.2f} s; per process (interpreter start, "
                  f"torch, CUDA and all): " + ", ".join(f"{k} {v:.2f} s"
                                                        for k, v in times.items()))
            if not same:
                raise AssertionError("cli key get differs from the file put")
            print(f"cli sh key put / get of {payload.size} B: byte-exact")
            print(f"cli freon ockg -n 16 -s {16 * cell} (beside the key chain): ops "
                  f"{rep['ops']}, failures {rep['failures']}, {rep['throughput_mib_s']} "
                  f"MiB/s, p50 {rep['p50_ms']} ms in the freon process")
            if rep["ops"] != 16 or rep["failures"] != 0:
                raise AssertionError(f"cli freon ockg: {rep}")
            states = [n["state"] for n in st["nodes"]]
            print(f"cli admin status: {len(states)} datanodes {sorted(set(states))}, "
                  f"safemode {st['safemode']}, {st['containers']} containers")
            if states != ["HEALTHY"] * 10:
                raise AssertionError(f"cli admin status: {states}")
            devices, native = [], []
            for i in range(10):
                line = next(l for l in (root / "c" / f"dn{i}.log").read_text().splitlines()
                            if l.startswith(f"datanode dn{i} serving"))
                devices.append(line.rsplit("device=", 1)[1])
                native.append(line.split("native datapath=", 1)[1].split(",", 1)[0])
            print(f"cli datanode logs: devices {devices}; native datapath {native}")
            if devices != [str(torch.device(dev))] * 10:
                raise AssertionError(f"datanode devices {devices}")
            if not all(n.split(" ")[0].isdigit() for n in native):
                raise AssertionError(f"a datanode advertises no native datapath: {native}")
            out.update(ockg_mib_s=rep["throughput_mib_s"], **times)
        finally:
            if sup.poll() is None:
                sup.send_signal(signal.SIGTERM)
            try:
                sup.wait(timeout=30)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait()
            alive = []
            for pid in pids:
                try:
                    os.kill(pid, 0)
                    alive.append(pid)
                except ProcessLookupError:
                    pass
            for pid in alive:
                os.kill(pid, signal.SIGKILL)
            print(f"cli cluster torn down in {time.perf_counter() - t0:.2f} s of phase "
                  f"time; children still alive after the supervisor's teardown: {alive}")
            if alive:
                raise AssertionError(f"processes left behind: {alive}")
        # every chunk of the key chain and of freon rode the native lane
        lanes: dict[str, int] = {}
        for i in range(10):
            line = next(l for l in (root / "c" / f"dn{i}.log").read_text().splitlines()
                        if l.startswith(f"datanode dn{i} stopped"))
            for k, v in json.loads(line.split("by lane: ", 1)[1]).items():
                lanes[k] = lanes.get(k, 0) + v
        print(f"cli datanodes' chunk traffic by lane, summed: {lanes}")
        if lanes["native_write_streams"] <= 0 or lanes["native_read_streams"] <= 0 \
                or lanes["rpc_chunk_calls"]:
            raise AssertionError(f"cli cluster: chunks left the native lane: {lanes}")
        out["lanes"] = lanes
    return out


def daemon_path(device, cell: int, bpc: int, seed: int,
                in_process_put_gib_s: float = float("nan")) -> dict:
    """The port as a cluster of daemons: in process on loopback, then as
    processes through the CLI. Every library is built before anything is
    spawned, so the datanode processes load them instead of compiling."""
    from ozone_tpu_torch import cuda_build

    if device.type == "cuda":
        cuda_build.build_all()
    out = daemon_cluster_in_process(device, cell, bpc, seed, in_process_put_gib_s)
    out["cli"] = daemon_cluster_processes(device, cell, seed)
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

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for lib, (secs, log) in sorted(logs.items()):
        print(f"compile {lib} ({secs:.2f} s):\n{log.strip()}")
    from ozone_tpu_torch.utils import checksum

    probe = checksum.native_probe()
    print(f"host CRC32C: route {checksum.route()}, native_probe() = {probe} "
          "(1 = SSE4.2 crc32, 2 = AVX2 build, 0 = bitwise loop, -1 = numpy)")
    if checksum.route() != "native" or probe < 1:
        raise AssertionError("the host CRC32C library is not on the SSE4.2 route")
    from ozone_tpu_torch.codec import cpp_coder

    print(f"host GF coder: probe() = {cpp_coder.probe()} (2 = AVX2, 0 = scalar loop)")
    if cpp_coder.probe() < 2:
        raise AssertionError("the host GF coder is not the AVX2 build")

    from ozone_tpu_torch.codec import fused_kernel

    for k, p in ((6, 3), (10, 4), (20, 4)):
        smem, per_sm = fused_kernel.kernel_occupancy(k, p, 16 * 1024, k + p)
        print(f"fused_encode_crc rs-{k}-{p} bpc=16384: {smem} B shared memory per "
              f"block, {per_sm} blocks per SM")
    bpc = 16 * 1024
    cases = [
        (6, 3, MIB, bpc, 8, "CRC32C"),
        (6, 3, MIB, bpc, 8, "CRC32"),
        (10, 4, MIB, bpc, 4, "CRC32C"),
        (3, 2, MIB, MIB, 4, "CRC32C"),  # one slice per cell, many tiles
        (6, 3, MIB, bpc, 1, "NONE"),
        (20, 4, MIB, bpc, 2, "CRC32C"),
        (6, 3, 4800, 480, 3, "CRC32C"),  # 512-byte tile, padded front
        (6, 3, 4800, 100, 3, "CRC32"),  # slice not a multiple of 16: byte path
        (6, 3, MIB, bpc, 4, "CRC32C", False),  # decode form: outputs only
        (6, 0, MIB, bpc, 4, "CRC32C"),  # p = 0: plain slice CRC
        (12, 4, MIB, bpc, 8, "CRC32C", True, "lrc-12-2-2"),  # LRC encode, [4, 12]
        (1, 0, bpc, bpc, 4096, "CRC32C"),  # the scrubber's batch at its 64 MiB cap
        (1, 0, bpc, bpc, 1024, "CRC32C"),  # the scrub of one 16 MiB container
        (6, 1, MIB, bpc, 8, "CRC32C", True, "xor-6-1"),  # XOR encode, [1, 6]
    ]
    err = check_kernel_cases(device, cases, args.seed)
    from ozone_tpu_torch.codec import lrc_math
    from ozone_tpu_torch.codec.api import CoderOptions

    def lrc_read_set(erased):
        return lrc_math.plan_valid(CoderOptions.parse("lrc-12-2-2"), erased,
                                   [u for u in range(16) if u not in erased])[0]

    decode_cases = [  # (scheme, valid, erased, cell, bpc, B, checksum)
        ("rs-10-4", list(range(2, 12)), [0, 1], MIB, bpc, 8, "CRC32C"),
        ("rs-6-3", [0, 1, 3, 4, 5, 6], [2, 7], MIB, bpc, 8, "CRC32C"),
        ("rs-10-4", [0, 1, 2, 4, 5, 6, 7, 8, 9, 13], [3], MIB, bpc, 1, "CRC32C"),
        ("rs-10-4", list(range(4, 14)), [0, 1, 2, 3], MIB, bpc, 2, "NONE"),
        # LRC local repair: [1, 6], the register-held k = 6 instance
        ("lrc-12-2-2", lrc_read_set([2]), [2], MIB, bpc, 8, "CRC32C"),
        # one loss in each group: [2, 12]
        ("lrc-12-2-2", lrc_read_set([2, 8]), [2, 8], MIB, bpc, 8, "CRC32C"),
        # global: two data units and their group's local parity, pruned columns
        ("lrc-12-2-2", lrc_read_set([0, 1, 12]), [0, 1, 12], MIB, bpc, 8, "CRC32C"),
    ]
    err = max(err, check_decode_cases(device, decode_cases, args.seed))
    # the XOR(1)->RS re-encode form: [4, 6], crc_in and crc_out
    err = max(err, check_reencode_cases(device, (0, 2, 5), MIB, bpc, 8, args.seed))
    timed = time_kernel(device, 6, 3, MIB, bpc, 8, args.seed, plain=True)
    time_kernel(device, 6, 3, MIB, bpc, 128, args.seed, plain=False)
    time_parts(device, 6, 3, MIB, bpc, 128, args.seed)
    decode = time_decode(device, MIB, bpc, 8, args.seed)
    forms = time_lrc_and_scrub(device, MIB, bpc, args.seed)
    forms["reencode"] = time_reencode(device, MIB, bpc, 8, args.seed)
    print("library_ms: none; no single PyTorch call computes a GF(2^8) "
          "matrix apply with slice CRCs")
    # the raw coder SPI's forms: no CRC rows
    coder_err = check_coder_forms(device, MIB, args.seed)
    coder_timed = time_coder_forms(device, MIB, args.seed)

    launches = paths = None
    phase_s = {"build_and_kernel_cases": time.perf_counter() - t_start}

    def phase(name, fn, *a):
        t = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[name] = time.perf_counter() - t

    if not args.kernel_only:
        put = phase("main_path", main_path, device,
                    [192 * MIB, 192 * MIB, 96 * MIB + 12345, MIB + 7], MIB, bpc, args.seed)
        small = phase("small_puts", small_puts, device, 32, 6 * MIB + 4096, MIB, bpc,
                      args.seed)
        rr = phase("read_repair_path", read_repair_path, device,
                   [320 * MIB, 161 * MIB + 12345], MIB, bpc, args.seed)
        lrc = phase("lrc_path", lrc_path, device, [384 * MIB, MIB + 12345], MIB, bpc,
                    args.seed)
        cp = phase("control_plane_path", control_plane_path, device, MIB, bpc, args.seed)
        fr = phase("freon_path", freon_path, device, MIB, bpc, args.seed)
        dm = phase("daemon_path", daemon_path, device, MIB, bpc, args.seed,
                   statistics.mean(r["gib_s"] for r in put["service"]))
        print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
              + f"; total {time.perf_counter() - t_start:.1f}")
        paths = {
            f"rs63_{name}_{route}": sum(r["launches"] for r in runs[route])
            for name, runs in (("put", put), ("small_puts", small))
            for route in ("service", "direct", "warmup")}
        paths.update({
            "rs104_put": rr["put_launches"], "rs104_decode": rr["decode_launches"],
            "lrc_put": lrc["put_launches"], "lrc_decode": lrc["decode_launches"],
            "scrub": lrc["scrub"]["launches"],
            "control_plane_xor_put": cp["put_launches"],
            "reencode_replicated": cp["reencode_replicated"]["launches"],
            "reencode_xor": cp["reencode_xor"]["launches"],
            "reencode_xor_parity_lost": cp["reencode_xor_parity_lost"]["launches"],
            "scm_repair": cp["repair_launches"],
            "control_plane_degraded_get": cp["degraded_launches"],
            "rawcoder_bench": fr["rawcoder"]["launches"],
            "freon_ockg": fr["ockg_launches"], "freon_ockv": fr["ockv_launches"],
            "freon_ockrr": fr["ockrr_launches"], "freon_ecrd": fr["ecrd_launches"],
            "storm": fr["storm_launches"],
            "daemon_put": dm["put_launches"],
            "daemon_put_rpc_lane": dm["put_rpc_launches"],
            "daemon_degraded_get": dm["degraded_launches"],
            "daemon_repair": dm["repair_launches"],
            "daemon_scrub": dm["scrub_launches"],
        })
        launches = sum(paths.values())
        form_launches = {form: fr["rawcoder"][f"{form}_launches"]
                         for form in ("gf_apply", "xor_reduce")}
        print(f"kernel launches on the main paths: {launches} {paths}; of them "
              f"through the coder SPI's forms {form_launches}")
    else:
        form_launches = {"gf_apply": None, "xor_reduce": None}
    from ozone_tpu_torch.codec import service as codec_service

    codec_service.reset_for_tests()  # stops the service's dispatcher thread
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
        **{f"{form}_{key}": value for form, timing in forms.items()
           for key, value in timing.items()},
        "launches_by_path": paths,
    }] + [{
        "name": f"fused_encode_crc as {form} (no CRC rows)", "route": "cuda",
        "source": "ozone_tpu_torch/csrc/fused_encode_crc.cu",
        "replaces": replaces, "launches": form_launches[form],
        "max_abs_err": coder_err[form], "ms": coder_timed[form]["ms"],
        "ms_in_run": coder_timed[form]["ms_in_run"],
        "plain_ms": coder_timed[form]["plain_ms"],
        "bound_ms": coder_timed[form]["bound_ms"],
        "bound_by": coder_timed[form]["bound_by"], "library_ms": None,
    } for form, replaces in (("gf_apply", "ozone_tpu/codec/jax_coder.py:108"),
                             ("xor_reduce", "ozone_tpu/codec/jax_coder.py:177"))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
