"""Fused EC encode + CRC, decode + CRC and XOR(1)->RS re-encode + CRC: one
device pass per stripe batch.

Port of `ozone_tpu/codec/fused.py`. The encoder takes a stripe batch
[B, k, C] and returns the parity [B, p, C] and the CRC of every
bytes_per_checksum slice of all k+p units [B, k+p, C / bpc]. The decoder
takes the v valid units of a batch [B, v, C] and returns the e erased
units [B, e, C] and their slice CRCs [B, e, C / bpc]. The re-encoder
takes an XOR(1) group [B, k, C] with the XOR parity in the lost data
unit's slot and returns the recovered unit with the RS parity
[B, 1+p, C], the CRCs of its k inputs [B, k, S] and of its 1+p outputs
[B, 1+p, S]. Each is one launch of the fused kernel
(codec/fused_kernel.py) with the coding matrix as its runtime argument:
the parity generator for encode, a per-pattern [e, v] recovery matrix for
decode, the composed [1+p, k] matrix for re-encode, so a new pattern
builds a small matrix, never a kernel.

The host backend (the reference's twin and its policy): with
``OZONE_TPU_FUSED_BACKEND=native`` the encoder and decoder of a CRC32C
spec run the host twin instead, the port's g++ GF coder
(`csrc/gf_coder.cpp`, AVX2 nibble tables) and host CRC32C
(`csrc/host_crc32c.cpp`) on the same matrices, returning the same CPU
tensors the device path pulls back; with ``auto`` the reference's policy
picks: the twin on ``device="cpu"``, and on CUDA a one-time link probe
(``OZONE_TPU_LINK_PROBE=0`` skips it) that takes the twin only where
the link's ceiling, ``1 / (1/h2d + out_ratio/d2h)``, is below the twin's
own rate. Unset, ``cuda`` or ``jax`` keep the kernel on CUDA and its
plain version on the CPU. Two departures, both on purpose: the default
is the kernel, not the policy, and ``native`` raises where the host
libraries cannot be built instead of quietly taking the device path.
The re-encoder has no twin, as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ozone_tpu_torch.codec import cpp_coder, lrc_math, rs_math
from ozone_tpu_torch.codec.gf256 import gf_matmul
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused_kernel import LaunchCounter, fused_encode_crc
from ozone_tpu_torch.codec.pipeline import H2D_BYTES
from ozone_tpu_torch.utils import checksum as hostsum
from ozone_tpu_torch.utils.checksum import ChecksumType
from ozone_tpu_torch.utils.metrics import MetricsRegistry, registry

log = logging.getLogger(__name__)

#: the backend policy's verdicts (`verdicts_host`, `verdicts_device`)
METRICS: MetricsRegistry = registry("codec.fused")

#: calls of the host twin in this process, beside the kernel's launches
#: (`fused_kernel.launches`)
host_twin_calls = LaunchCounter()
#: the `backend` of a host-twin function, which the codec service appends
#: to its lanes' keys (`service.backend_key`)
HOST_TWIN = "native"

_POLY = {
    ChecksumType.CRC32: hostsum.CRC32_POLY,
    ChecksumType.CRC32C: hostsum.CRC32C_POLY,
}


def effective_bpc(cell_size: int, bytes_per_checksum: int) -> int:
    """Clamp bytes-per-checksum so cells divide into whole slices: a bpc
    larger than the cell (or not dividing it) degrades to one checksum
    per cell."""
    if bytes_per_checksum <= 0:
        return cell_size
    if bytes_per_checksum <= cell_size and cell_size % bytes_per_checksum == 0:
        return bytes_per_checksum
    return cell_size


@dataclass(frozen=True)
class FusedSpec:
    options: CoderOptions
    checksum: ChecksumType = ChecksumType.CRC32C
    bytes_per_checksum: int = 16 * 1024

    def __post_init__(self):
        object.__setattr__(
            self,
            "bytes_per_checksum",
            effective_bpc(self.options.cell_size, self.bytes_per_checksum),
        )


def _parity_matrix(options: CoderOptions) -> np.ndarray:
    """p x k GF(2^8) parity generator: Cauchy for RS, the all-ones row for
    XOR single parity; LRC stacks its l local XOR rows on its r global
    Cauchy rows (lrc_math.parity_matrix), so all its parities are one
    launch."""
    if options.codec == "xor":
        if options.parity_units != 1:
            raise ValueError("xor codec has exactly one parity unit")
        return np.ones((1, options.data_units), dtype=np.uint8)
    if options.codec == "lrc":
        return lrc_math.parity_matrix(options)
    return rs_math.parity_matrix(options.data_units, options.parity_units)


def _decode_matrix(options: CoderOptions, valid: list[int],
                   erased: list[int]) -> np.ndarray:
    """e x len(valid) GF(2^8) recovery matrix. RS inverts the surviving
    k x k submatrix; XOR recovers its one erasable unit as the XOR of the
    k others. LRC solves over any spanning read set (len(valid) may be
    the local group's size instead of k, lrc_math.recovery_rows); the
    kernel takes the narrower matrix as it is."""
    if options.codec == "lrc":
        return lrc_math.recovery_rows(options, list(valid), list(erased))
    if options.codec == "xor":
        if len(erased) != 1:
            raise ValueError("xor codec recovers at most one erasure")
        if len(valid) != options.data_units:
            raise ValueError("xor decode needs all other units")
        if erased[0] == options.data_units:
            # the parity itself: re-encode from the k data units
            return np.ones((1, options.data_units), dtype=np.uint8)
        return np.ones((1, len(valid)), dtype=np.uint8)
    return rs_math.decode_matrix(
        options.data_units, options.parity_units, list(erased), list(valid))


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; CUDA must be present
    unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path")
    return dev


def _to_device(units, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor of units as a uint8 tensor on `dev`, copied
    without blocking (asynchronously when the host memory is pinned).
    Host units count in `h2d_bytes` (`codec/pipeline.py`), whatever `dev`."""
    if not isinstance(units, torch.Tensor):
        units = torch.from_numpy(np.ascontiguousarray(units, dtype=np.uint8))
    if units.device.type == "cpu":
        H2D_BYTES.inc(units.nbytes)
    return units.to(dev, non_blocking=True)


# ------------------------------------------------------------ host twin
def fused_backend() -> str:
    """The OZONE_TPU_FUSED_BACKEND knob: "device" (unset, ``cuda`` or
    ``jax``: the kernel, or its plain version on the CPU), "native" (the
    host twin for CRC32C specs) or "auto" (the reference's policy)."""
    value = os.environ.get("OZONE_TPU_FUSED_BACKEND", "").strip().lower()
    if value in ("", "cuda", "jax"):
        return "device"
    if value in ("native", "auto"):
        return value
    raise ValueError(f"OZONE_TPU_FUSED_BACKEND={value!r}: expected cuda, jax, "
                     "native or auto")


def _measure_link(size: int = 4 * 2**20,
                  pinned: bool = False) -> tuple[float, float]:
    """One-shot (h2d, d2h) bandwidth sample in MiB/s for the current CUDA
    device. Pageable host memory unless `pinned`,
    as the reference's `device_put` of a numpy array; a small buffer and
    one warm-up keep the probe well under a second. The d2h leg reads a
    computed tensor (`x + 1`), not the copied one, so it times the link
    and not a cached host copy."""
    dev = torch.device("cuda")
    host = torch.zeros(size, dtype=torch.uint8, pin_memory=pinned)
    warm = torch.zeros(1 << 16, dtype=torch.uint8, pin_memory=pinned).to(dev)
    (warm + 1).cpu()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    on_dev = host.to(dev, non_blocking=pinned)
    torch.cuda.synchronize(dev)
    h2d = size / 2**20 / max(time.perf_counter() - t0, 1e-9)
    on_dev = on_dev + 1
    out = torch.empty(size, dtype=torch.uint8, pin_memory=True) if pinned else None
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if pinned:
        out.copy_(on_dev, non_blocking=True)  # ozlint: allow[span-on-dispatch] -- the one-time link probe of the backend policy, not a request-path dispatch
    else:
        on_dev.cpu()
    torch.cuda.synchronize(dev)
    d2h = size / 2**20 / max(time.perf_counter() - t0, 1e-9)
    return h2d, d2h


def _native_rate_sample(options: CoderOptions) -> float:
    """MiB/s of the host twin's encode on a small batch (0 when the host
    libraries are unavailable); it stands for the decoder too (the same
    GF multiply per output byte, the same CRC slicer). Its calls are not
    counted in `host_twin_calls`."""
    if not _native_lib_available():
        return 0.0
    k, cell = options.data_units, min(options.cell_size, 256 * 1024)
    small = dataclasses.replace(options, cell_size=cell)  # LRC keeps its groups
    fn = _native_fused_encoder(small, ChecksumType.CRC32C,
                               effective_bpc(cell, 16 * 1024))
    data = np.zeros((4, k, cell), dtype=np.uint8)
    fn.run(data)  # warm the tables
    t0 = time.perf_counter()
    fn.run(data)
    return data.nbytes / 2**20 / max(time.perf_counter() - t0, 1e-9)


def _native_lib_available() -> bool:
    """Whether both host libraries of the twin load (or build now): the
    GF coder and the host CRC32C."""
    try:
        cpp_coder.load()
    except (OSError, RuntimeError) as e:
        log.info("host GF coder unavailable: %s", e)
        return False
    return hostsum._native_lib() is not None


_PROBE_LOCK = threading.Lock()
_PROBE_CACHE: dict = {}
_PROBE_WALL_S = 10.0


def _native_avail_cached() -> bool:
    """`_native_lib_available`, cached: the loaders take a mutex even when
    loaded."""
    avail = _PROBE_CACHE.get("native_avail")
    if avail is None:
        avail = _PROBE_CACHE["native_avail"] = _native_lib_available()
    return avail


def _probe_link_guarded():
    """`_measure_link` under a watchdog thread: a transfer that wedges
    strands one daemon thread, not every coder thread queued behind
    `_PROBE_LOCK`. Returns (h2d, d2h); None on a probe error (the device
    path); "wedged" on timeout (the device path would hang too, so the
    host twin)."""
    box: list = []

    def run():
        try:
            box.append(_measure_link())
        except Exception:  # noqa: BLE001 - read as "no verdict for the host"
            log.exception("link probe failed; the device path stays")
            box.append(None)

    t = threading.Thread(target=run, daemon=True, name="link-probe")
    t.start()
    t.join(_PROBE_WALL_S)
    return box[0] if box else "wedged"


def _verdict(key: tuple, device_wins: bool, link=None,
             rate: Optional[float] = None) -> bool:
    """Store a verdict of `_link_beats_native` (under `_PROBE_LOCK`, or
    for the lock-free "no library" case) and count it; a verdict for the
    host is logged with what it was read from."""
    _PROBE_CACHE[key] = device_wins
    METRICS.counter("verdicts_device" if device_wins else "verdicts_host").inc()
    if not device_wins:
        options, out_ratio = key
        if link == "wedged":
            log.warning("fused backend: the host twin for %s (out_ratio %s): "
                        "the link probe wedged past %.1f s", options, out_ratio,
                        _PROBE_WALL_S)
        else:
            log.warning("fused backend: the host twin for %s (out_ratio %s): "
                        "h2d %.1f MiB/s, d2h %.1f MiB/s, host twin %.1f MiB/s",
                        options, out_ratio, link[0], link[1], rate)
    return device_wins


def _link_beats_native(options: CoderOptions,
                       out_ratio: Optional[float] = None) -> bool:
    """The measured backend choice: a device behind a link too slow to
    feed it loses end to end to the host twin. The device path's ceiling
    is transfer-bound, inputs going h2d once and `out_ratio` of that
    volume coming back d2h (encode p/k, decode e/v), so it wins when
    ``1 / (1/h2d + out_ratio/d2h)`` beats the twin's rate. One probe per
    process, single-flight under `_PROBE_LOCK`; a verdict per (options,
    out_ratio), read lock-free once cached."""
    if out_ratio is None:
        out_ratio = options.parity_units / max(options.data_units, 1)
    key = (options, round(out_ratio, 4))
    hit = _PROBE_CACHE.get(key)  # lock-free hit: reconstruction threads
    if hit is not None:          # must not serialize on a mutex for a
        return hit               # cached bool
    if not _native_avail_cached():
        return _verdict(key, True)  # nothing to fall back to: no probe
    with _PROBE_LOCK:
        if "link" not in _PROBE_CACHE:
            _PROBE_CACHE["link"] = _probe_link_guarded()
        link = _PROBE_CACHE["link"]
        if key in _PROBE_CACHE:
            return _PROBE_CACHE[key]
        if link == "wedged":
            return _verdict(key, False, link)  # a dead link: the host twin
        if link is None:
            return _verdict(key, True)  # a probe error: the device path
        rate_key = ("native_rate", options)
        if rate_key not in _PROBE_CACHE:  # on options only, not on the
            _PROBE_CACHE[rate_key] = _native_rate_sample(options)  # shape
        h2d, d2h = link
        ceiling = 1.0 / (1.0 / max(h2d, 1e-9) + out_ratio / max(d2h, 1e-9))
        rate = _PROBE_CACHE[rate_key]
        return _verdict(key, ceiling > rate, link, rate)


def _prefer_host_coder(options: Optional[CoderOptions] = None,
                       out_ratio: Optional[float] = None,
                       checksum: Optional[ChecksumType] = None,
                       device="cuda") -> bool:
    """True when the fused pass should run on the host: always under
    ``native``; under ``auto`` on a CPU device, or on CUDA where the link
    probe says the device path cannot be fed faster than the twin codes
    (a non-CRC32C spec skips the probe: the twin serves only CRC32C);
    never on the default device backend. ``OZONE_TPU_LINK_PROBE=0``
    keeps ``auto`` on the device without probing."""
    backend = fused_backend()
    if backend == "device":
        return False
    if backend == "native":
        return True
    if torch.device(device).type == "cpu":
        return True
    if options is None or \
            (checksum is not None and checksum is not ChecksumType.CRC32C) \
            or os.environ.get("OZONE_TPU_LINK_PROBE", "1") == "0":
        return False
    return not _link_beats_native(options, out_ratio)


def _host_twin_wanted(spec: FusedSpec, device,
                      out_ratio: Optional[float] = None) -> bool:
    """Whether an encoder or decoder of `spec` on `device` is the host
    twin: a CRC32C spec the policy sends to the host, under ``native``
    whatever the libraries (the twin then raises if they cannot be
    built), under ``auto`` only where they load."""
    if spec.checksum is not ChecksumType.CRC32C or not _prefer_host_coder(
            spec.options, out_ratio, spec.checksum, device):
        return False
    return fused_backend() == "native" or _native_avail_cached()


def _host_units(units) -> np.ndarray:
    """A numpy array, a CPU tensor (pinned or not) or a CUDA tensor (copied
    to the host first) as a contiguous uint8 array."""
    if isinstance(units, torch.Tensor):
        units = units.detach()
        if units.device.type != "cpu":
            units = units.cpu()
        units = units.numpy()
    return np.ascontiguousarray(units, dtype=np.uint8)


def _crc_lib():
    lib = hostsum._native_lib()
    if lib is None:
        raise RuntimeError("host CRC32C library unavailable: the host twin "
                           "cannot run")
    return lib


def _native_crc_slices(units: np.ndarray, bpc: int) -> np.ndarray:
    """[B, U, C] uint8 -> [B, U, C // bpc] uint32 through the host CRC32C
    library's slicer; C divides by bpc (the FusedSpec contract), so one
    flat pass never crosses a unit boundary."""
    lib = _crc_lib()
    b, u, c = units.shape
    flat = np.ascontiguousarray(units).reshape(-1)
    out = np.empty(flat.size // bpc, dtype=np.uint32)
    if flat.size:
        lib.crc32c_slices(flat.ctypes.data, flat.size, bpc, out.ctypes.data)
    return out.reshape(b, u, c // bpc)


class _HostTwin:
    """One host-twin function: `fn(units)` takes a numpy array, a CPU or a
    CUDA tensor and returns CPU tensors (uint8 outputs, int32 CRC words),
    counting the call in `host_twin_calls`; `run(units)` is the same
    without the count. `backend` keeps its codec-service lanes apart from
    the device path's."""

    backend = HOST_TWIN

    def __init__(self, apply):
        self._apply = apply

    def run(self, units):
        outs = self._apply(_host_units(units))
        return tuple(torch.from_numpy(o.view(np.int32) if o.dtype == np.uint32 else o)
                     for o in outs)

    def __call__(self, units):
        outs = self.run(units)
        host_twin_calls.add()
        return outs


@lru_cache(maxsize=16)
def _native_fused_encoder(options: CoderOptions, checksum: ChecksumType,
                          bpc: int) -> Optional[_HostTwin]:
    """The host twin of the fused encoder: `fn(data [B, k, C])` ->
    (parity uint8 [B, p, C], crcs int32 [B, k+p, C // bpc]), CPU tensors.
    None for a checksum other than CRC32C; raises when the host libraries
    cannot be built."""
    if checksum is not ChecksumType.CRC32C:
        return None
    lib = cpp_coder.load()
    _crc_lib()
    tables = cpp_coder._nibble_tables(_parity_matrix(options))
    p, k = options.parity_units, options.data_units

    def apply(data: np.ndarray):
        parity = cpp_coder._apply(lib, tables, p, k, data)
        crcs = np.concatenate([_native_crc_slices(data, bpc),
                               _native_crc_slices(parity, bpc)], axis=1)
        return parity, crcs

    return _HostTwin(apply)


@lru_cache(maxsize=512)
def _native_fused_decoder(options: CoderOptions, checksum: ChecksumType,
                          bpc: int, valid: tuple,
                          erased: tuple) -> Optional[_HostTwin]:
    """The host twin of the fused decoder: `fn(valid_units [B, v, C])` ->
    (rec uint8 [B, e, C], crcs int32 [B, e, C // bpc]), CPU tensors. None
    for a checksum other than CRC32C; raises when the host libraries
    cannot be built."""
    if checksum is not ChecksumType.CRC32C:
        return None
    lib = cpp_coder.load()
    _crc_lib()
    tables = cpp_coder._nibble_tables(
        _decode_matrix(options, list(valid), list(erased)))
    e, v = len(erased), len(valid)

    def apply(valid_units: np.ndarray):
        rec = cpp_coder._apply(lib, tables, e, v, valid_units)
        return rec, _native_crc_slices(rec, bpc)

    return _HostTwin(apply)


def make_fused_encoder(spec: FusedSpec, device="cuda"):
    """fn(data uint8 [B, k, C]) -> (parity uint8 [B, p, C],
    crcs int32 [B, k+p, C // bpc]), both torch tensors on `device`; CRC
    words are uint32 bit patterns (`.numpy().view(np.uint32)`), and the
    CRC tensor is [B, k+p, 0] when the checksum is not CRC32/CRC32C.
    `data` may be a numpy array or a tensor; host data goes to the device
    with a non-blocking copy (asynchronous when it is pinned).

    Where the backend policy takes the host twin (`_host_twin_wanted`),
    it returns `_native_fused_encoder`'s function instead: the same
    outputs as CPU tensors."""
    if _host_twin_wanted(spec, device):
        return _native_fused_encoder(spec.options, spec.checksum,
                                     spec.bytes_per_checksum)
    dev = resolve_device(device)
    matrix = torch.from_numpy(_parity_matrix(spec.options)).to(dev)
    poly = _POLY.get(spec.checksum)
    bpc = spec.bytes_per_checksum

    def fn(data):
        data = _to_device(data, dev)
        parity, crcs = fused_encode_crc(data, matrix, poly, bpc)
        if poly is None:
            b, k = data.shape[:2]
            crcs = torch.zeros((b, k + parity.shape[1], 0), dtype=torch.int32,
                               device=dev)
        return parity, crcs

    return fn


@lru_cache(maxsize=512)
def _decode_plan_cached(options: CoderOptions, valid: tuple, erased: tuple,
                        device: torch.device) -> torch.Tensor:
    """The [e, v] uint8 recovery matrix of one erasure pattern, on
    `device`. Cheap to build (a k x k GF inversion and one small copy);
    every pattern shares the one kernel library."""
    dm = _decode_matrix(options, list(valid), list(erased))
    return torch.from_numpy(dm).to(device)


def decode_plan_cache_size() -> int:
    """Decode plans (erasure patterns x devices) currently cached."""
    return _decode_plan_cached.cache_info().currsize


def make_fused_decoder(spec: FusedSpec, valid: list[int], erased: list[int],
                       device="cuda"):
    """fn(valid_units uint8 [B, v, C]) -> (rec uint8 [B, e, C],
    crcs int32 [B, e, C // bpc]), both torch tensors on `device`. `valid`
    lists the unit indexes of the v rows supplied, `erased` the units to
    rebuild, in output order. CRC words are uint32 bit patterns, and the
    CRC tensor is [B, e, 0] when the checksum is not CRC32/CRC32C. Host
    input goes to the device with a non-blocking copy (asynchronous when
    it is pinned).

    Where the backend policy takes the host twin for the decode's
    transfer shape (e units back for v in), it returns
    `_native_fused_decoder`'s function: the same outputs as CPU tensors."""
    if _host_twin_wanted(spec, device, len(erased) / max(len(valid), 1)):
        return _native_fused_decoder(spec.options, spec.checksum,
                                     spec.bytes_per_checksum, tuple(valid),
                                     tuple(erased))
    dev = resolve_device(device)
    matrix = _decode_plan_cached(spec.options, tuple(valid), tuple(erased), dev)
    poly = _POLY.get(spec.checksum)
    bpc = spec.bytes_per_checksum

    def fn(valid_units):
        valid_units = _to_device(valid_units, dev)
        rec, crcs = fused_encode_crc(valid_units, matrix, poly, bpc,
                                     crc_in=False)
        if poly is None:
            crcs = torch.zeros(rec.shape[:2] + (0,), dtype=torch.int32,
                               device=dev)
        return rec, crcs

    return fn


def _reencode_matrix(options: CoderOptions, lost: int) -> np.ndarray:
    """[1+p, k] GF(2^8) matrix of XOR(1)-decode composed with RS-encode:
    M = [D[lost]; P D], where D is the k x k XOR-decode matrix (identity
    rows for the survivors, the all-ones row for slot `lost`, which holds
    the XOR parity: over GF(2) the lost unit is the XOR of all k slots)
    and P the Cauchy parity matrix."""
    k, p = options.data_units, options.parity_units
    if not 0 <= lost < k:
        raise ValueError(f"lost unit {lost} is not a data unit of {k}")
    d = np.eye(k, dtype=np.uint8)
    d[lost, :] = 1
    pm = rs_math.parity_matrix(k, p)
    return np.vstack([d[lost:lost + 1], gf_matmul(pm, d)])


@lru_cache(maxsize=64)
def _reencode_plan_cached(options: CoderOptions, lost: int,
                          device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_reencode_matrix(options, lost)).to(device)


def make_fused_reencoder(spec: FusedSpec, lost: int = 0, device="cuda"):
    """fn(units uint8 [B, k, C]) -> (out uint8 [B, 1+p, C],
    units_crcs int32 [B, k, S], out_crcs int32 [B, 1+p, S]), torch tensors
    on `device`, S = C // bpc (0 when the checksum is not CRC32/CRC32C).

    `units` carries the XOR(1) group with data unit `lost` replaced by the
    XOR parity in its slot. One launch (crc_in and crc_out) recovers the
    lost unit (out[:, 0]), computes the RS parity of the full group
    (out[:, 1:]) and checksums every input and output; its [B, k+1+p, S]
    CRC rows, inputs first, are split into the two CRC tensors.
    `reencode_layout_crcs` assembles the k+p EC-layout order on the host;
    units_crcs[:, lost] checksums the XOR parity slot and goes unused."""
    dev = resolve_device(device)
    matrix = _reencode_plan_cached(spec.options, int(lost), dev)
    poly = _POLY.get(spec.checksum)
    bpc = spec.bytes_per_checksum
    k = spec.options.data_units

    def fn(units):
        units = _to_device(units, dev)
        out, crcs = fused_encode_crc(units, matrix, poly, bpc)
        if poly is None:
            empty = torch.zeros((units.shape[0], 0, 0), dtype=torch.int32,
                                device=dev)
            return out, empty, empty
        return out, crcs[:, :k], crcs[:, k:]

    return fn


def reencode_layout_crcs(units_crcs: np.ndarray, out_crcs: np.ndarray,
                         lost: int) -> np.ndarray:
    """Assemble re-encode CRCs into EC layout order [B, k+p, S]: data
    units 0..k-1 (the recovered unit in slot `lost`), then parity."""
    return np.concatenate(
        [units_crcs[:, :lost], out_crcs[:, :1],
         units_crcs[:, lost + 1:], out_crcs[:, 1:]],
        axis=1,
    )
