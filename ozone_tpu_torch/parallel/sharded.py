"""Multi-device sharded EC codec: the mesh and its DP, TP and ring forms,
every device pass one launch of the fused kernel.

Port of `ozone_tpu/parallel/sharded.py`, whose four jitted `shard_map`
programs become loops over the mesh's slots, each slot launching
`codec/fused_kernel.fused_encode_crc` on its own device:

- **Stripe parallelism (DP)**: the stripe batch is split over the slots;
  each slot encodes (or decodes) and checksums its contiguous rows with
  one launch. No slot talks to another. The outputs are reassembled in
  row order on the first slot's device. n launches a call.
- **Unit parallelism (TP)**: the k data units are split over the slots.
  Slot i applies its k/n columns of the parity matrix to its units (one
  launch, no CRC), giving a packed partial parity [B, p, C]. The
  partials meet on the first slot's device (a device copy within a
  process, `all_gather_into_tensor` across processes), are laid side by
  side as [B, n p, C] in slot order, and one more launch with the block
  identity [I_p ... I_p] XOR-combines them. GF(2^8) addition is XOR, so
  this equals the reference's int32 psum of bit-planes followed by &1,
  bit for bit, and moves packed bytes, not 32-bit bit-planes (NCCL has
  no XOR reduction, so an all_reduce would have to move the planes).
  n + 1 launches a call.
- **Ring reconstruction (SP)**: the survivors are split over the slots,
  zero-padded to a multiple of n outside the program (zero matrix
  columns for the padded slots, so they add zero partials). Slot i makes
  its packed partial [B, e, C] (one launch, no CRC); then n - 1 hops
  pass each slot's accumulator to the next slot (a device copy within a
  process, `batch_isend_irecv` across processes), and each receiver
  XOR-combines what it got with its own partial in one launch of
  [I_e I_e] over the pair. After the hops every slot holds the result.
  Its CRCs are sharded over the batch: one launch with no coding rows
  per slot's rows. n + n (n - 1) launches, and n more with a CRC (as
  many as there are rows when the batch is smaller than n).

Every combine runs in the kernel, not in `torch.bitwise_xor`, so the
kernel's launch counter counts every device pass; `launches[form]`
counts the kernel launches of each form apart (a CPU slot counts none).
Forms with no CRC slice their cells as the coder SPI does
(`torch_coder.apply_slice`).

A `Mesh` is a tuple of slots, each a torch device and the process rank
that owns it. A mesh may repeat a device (`make_mesh(devices=["cpu"] *
8)`, or four slots on `cuda:0`): such logical slots play the part of
the reference's virtual devices, and run one after another on their
device's stream. Slots on distinct CUDA devices launch on each device's
own current stream, so they overlap. On a mesh that spans processes
(`parallel/multihost.py`) each process runs its own slots: the DP forms
take and return the rows of this process's slots, the TP and ring forms
take the whole stripe batch and return the whole (replicated) result.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ozone_tpu_torch.codec import fused_kernel
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import (
    _POLY,
    FusedSpec,
    _decode_matrix,
    _decode_plan_cached,
    _parity_matrix,
    _to_device,
    resolve_device,
)
from ozone_tpu_torch.codec.fused_kernel import LaunchCounter
from ozone_tpu_torch.codec.torch_coder import apply_slice
from ozone_tpu_torch.utils.checksum import ChecksumType

#: kernel launches of each form in this process
launches = {form: LaunchCounter()
            for form in ("dp_encode", "dp_decode", "tp_encode", "ring_decode")}


class Slot:
    """One place of the mesh: the torch device its launches run on and
    the rank of the process that owns it."""

    __slots__ = ("index", "device", "rank")

    def __init__(self, index: int, device: torch.device, rank: int):
        self.index = index
        self.device = device
        self.rank = rank

    def __repr__(self) -> str:
        return f"Slot({self.index}, {self.device}, rank={self.rank})"


class Mesh:
    """Slots with named axes. `devices` is the slots as a numpy object
    array of the mesh's shape (`devices.size` is the slot count, as the
    consumers read it); `axis_names` names its axes. Hashes by identity,
    so every plan cache keyed on a mesh is the mesh's own."""

    def __init__(self, slots: Sequence[Slot], axis_names: tuple,
                 shape: Optional[tuple] = None):
        self.slots = tuple(slots)
        if not self.slots:
            raise ValueError("a mesh needs at least one slot")
        self.axis_names = tuple(axis_names)
        grid = np.empty(len(self.slots), dtype=object)
        grid[:] = self.slots
        self.devices = grid.reshape(shape or (len(self.slots),))
        self.rank = process_rank()
        self.local_slots = tuple(s for s in self.slots if s.rank == self.rank)
        if not self.local_slots:
            raise ValueError(f"no slot of this mesh belongs to rank {self.rank}")
        ranks = [s.rank for s in self.slots]
        if ranks != sorted(ranks):
            raise ValueError("a mesh's slots must be in process-major order")
        self.spans_processes = any(r != self.rank for r in ranks)

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def first_device(self) -> torch.device:
        """Where this process reassembles and combines: its first slot's
        device."""
        return self.local_slots[0].device

    def __repr__(self) -> str:
        return f"Mesh({list(self.devices.shape)}, {self.axis_names}, {self.slots})"


def process_rank() -> int:
    """This process's rank in torch.distributed's group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_mesh(n_devices: Optional[int] = None, axis: str = "dn",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first n of `devices` (default: every CUDA device;
    raises without CUDA). A device may repeat: each entry is one slot."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] * n "
                               "for a mesh of CPU slots on the plain PyTorch path")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f"asked for {n_devices} slots of {len(devs)} devices")
        devs = devs[:n_devices]
    rank = process_rank()
    return Mesh([Slot(i, d, rank) for i, d in enumerate(devs)], (axis,))


def default_codec_mesh(axis: str = "dn") -> Optional[Mesh]:
    """Production mesh policy: every local CUDA device when more than one
    is attached, None (the single-device fused path) otherwise. Datanode
    daemons and the minicluster hand this to the reconstruction
    coordinator and the scrubber, so multi-GPU hosts repair and scrub
    across every card without configuration."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    return make_mesh(axis=axis)


def pad_batch(batch, n: int):
    """Pad the leading axis to a multiple of n with zero rows; returns
    (padded, original rows). An aligned batch comes back as it is."""
    b = batch.shape[0]
    rem = (-b) % n
    if not rem:
        return batch, b
    if isinstance(batch, torch.Tensor):
        pad = torch.zeros((rem,) + tuple(batch.shape[1:]), dtype=batch.dtype,
                          device=batch.device)
        return torch.cat([batch, pad]), b
    pad = np.zeros((rem,) + batch.shape[1:], dtype=batch.dtype)
    return np.concatenate([batch, pad], axis=0), b


# ---------------------------------------------------------------- helpers
def _as_tensor(units) -> torch.Tensor:
    if isinstance(units, torch.Tensor):
        return units
    return torch.from_numpy(np.ascontiguousarray(units, dtype=np.uint8))


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` on `dev`, contiguous (a non-blocking copy when it moves)."""
    if t.device != dev:
        t = t.to(dev, non_blocking=True)
    return t.contiguous()


def _slot_rows(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A slot's part of the batch on `dev`, contiguous: host rows cross
    the device edge through `fused._to_device`, which counts them."""
    return _to_device(t, dev).contiguous()


def _launch(form: str, dev: torch.device, data: torch.Tensor,
            matrix: torch.Tensor, poly: Optional[int], slice_bytes: int,
            crc_in: bool = True, crc_out: bool = True):
    """One pass of the fused kernel on `dev`'s current stream, counted in
    `launches[form]` when it launched (a CUDA tensor with rows)."""
    if dev.type != "cuda":
        return fused_kernel.fused_encode_crc(data, matrix, poly, slice_bytes,
                                             crc_in, crc_out)
    with torch.cuda.device(dev):
        out = fused_kernel.fused_encode_crc(data, matrix, poly, slice_bytes,
                                            crc_in, crc_out)
    if data.shape[0]:
        launches[form].add()
    return out


def dp_apply(mesh: Mesh, batch, per_slot) -> tuple:
    """Split the rows of `batch` over this process's slots, run
    per_slot(slot, rows on its device) -> tuple of tensors, and reassemble
    each output in row order on the first slot's device."""
    t = _as_tensor(batch)
    local = mesh.local_slots
    if t.shape[0] % len(local):
        raise ValueError(f"batch of {t.shape[0]} rows does not split over "
                         f"{len(local)} slots; pad it (pad_batch)")
    per = t.shape[0] // len(local)
    outs = [per_slot(s, _slot_rows(t[i * per:(i + 1) * per], s.device))
            for i, s in enumerate(local)]
    if len(outs) == 1:
        return outs[0]
    dev0 = mesh.first_device
    return tuple(torch.cat([_to(o[j], dev0) for o in outs])
                 for j in range(len(outs[0])))


def _gather_slots(mesh: Mesh, parts: list, dev: torch.device) -> list:
    """Every slot's part, in slot order, on `dev`: this process's `parts`
    (one per local slot, same shape everywhere) moved there, the other
    processes' gathered with all_gather_into_tensor."""
    parts = [_to(p, dev) for p in parts]
    if not mesh.spans_processes:
        return parts
    stacked = torch.stack(parts)
    out = torch.empty((mesh.size,) + tuple(stacked.shape[1:]),
                      dtype=stacked.dtype, device=dev)
    dist.all_gather_into_tensor(out, stacked)
    return list(out.unbind(0))


@lru_cache(maxsize=64)
def _on_device(options: CoderOptions, device: torch.device) -> torch.Tensor:
    """The parity generator [p, k] on `device`."""
    return torch.from_numpy(_parity_matrix(options)).to(device)


@lru_cache(maxsize=64)
def _combine_matrix(rows: int, n: int, device: torch.device) -> torch.Tensor:
    """[I_rows ... I_rows] ([rows, n rows]) on `device`: the XOR of n
    packed partials laid side by side, in one launch."""
    return torch.from_numpy(np.tile(np.eye(rows, dtype=np.uint8), (1, n))).to(device)


# --------------------------------------------------------------------- DP
@lru_cache(maxsize=16)
def _sharded_fused_encoder_cached(options: CoderOptions, checksum: ChecksumType,
                                  bpc: int, mesh: Mesh, axis: str):
    poly = _POLY.get(checksum)
    k = options.data_units

    def per_slot(slot: Slot, rows: torch.Tensor):
        parity, crcs = _launch("dp_encode", slot.device, rows,
                               _on_device(options, slot.device), poly, bpc)
        if poly is None:
            crcs = torch.zeros((rows.shape[0], k + parity.shape[1], 0),
                               dtype=torch.int32, device=slot.device)
        return parity, crcs

    return lambda data: dp_apply(mesh, data, per_slot)


def make_sharded_fused_encoder(spec: FusedSpec, mesh: Mesh, axis: str = "dn"):
    """Stripe-parallel fused encode+CRC: fn(data [B, k, C]) -> (parity
    [B, p, C], crcs int32 [B, k+p, C / bpc]), B split over the slots; B
    must divide by the slot count (see pad_batch)."""
    return _sharded_fused_encoder_cached(
        spec.options, spec.checksum, spec.bytes_per_checksum, mesh, axis)


def make_sharded_decoder(spec: FusedSpec, valid: list[int], erased: list[int],
                         mesh: Mesh, axis: str = "dn"):
    """Stripe-parallel fused decode+CRC: fn(valid_units [B, v, C]) ->
    (rec [B, e, C], crcs int32 [B, e, C / bpc]). The recovery matrix is a
    per-pattern, per-device plan (codec/fused._decode_plan_cached), so
    erasure-pattern churn builds a small matrix, never a program."""
    options, valid, erased = spec.options, tuple(valid), tuple(erased)
    poly = _POLY.get(spec.checksum)
    bpc = spec.bytes_per_checksum

    def per_slot(slot: Slot, rows: torch.Tensor):
        matrix = _decode_plan_cached(options, valid, erased, slot.device)
        rec, crcs = _launch("dp_decode", slot.device, rows, matrix, poly, bpc,
                            crc_in=False)
        if poly is None:
            crcs = torch.zeros(rec.shape[:2] + (0,), dtype=torch.int32,
                               device=slot.device)
        return rec, crcs

    return lambda valid_units: dp_apply(mesh, valid_units, per_slot)


# --------------------------------------------------------------------- TP
@lru_cache(maxsize=64)
def _tp_plan(options: CoderOptions, n: int, device: torch.device) -> torch.Tensor:
    """[n, p, k/n]: slot i's columns of the parity matrix, on `device`."""
    pm = _parity_matrix(options)
    p, k = pm.shape
    return torch.from_numpy(
        pm.reshape(p, n, k // n).transpose(1, 0, 2).copy()).to(device)


@lru_cache(maxsize=16)
def _tp_encoder_cached(options: CoderOptions, mesh: Mesh, axis: str):
    k, p = options.data_units, options.parity_units
    n = mesh.size
    if k % n:
        raise ValueError(f"TP encode requires k % mesh == 0, got {k} % {n}")
    w = k // n

    def fn(data):
        data = _as_tensor(data)
        cell = data.shape[-1]
        sb = apply_slice(cell)
        partials = []
        for s in mesh.local_slots:
            units = _slot_rows(data[:, s.index * w:(s.index + 1) * w],
                               s.device)
            part, _ = _launch("tp_encode", s.device, units,
                              _tp_plan(options, n, s.device)[s.index], None, sb)
            partials.append(part)
        dev0 = mesh.first_device
        side = torch.cat(_gather_slots(mesh, partials, dev0), 1)  # [B, n p, C]
        parity, _ = _launch("tp_encode", dev0, side, _combine_matrix(p, n, dev0),
                            None, sb)
        return parity

    return fn


def make_tp_encoder(options: CoderOptions, mesh: Mesh, axis: str = "dn"):
    """Unit-parallel encode: data units split over the slots, the packed
    partial parities XOR-combined in one more launch. fn(data [B, k, C])
    -> parity [B, p, C], on the first slot's device."""
    return _tp_encoder_cached(options, mesh, axis)


# ------------------------------------------------------------------- ring
@lru_cache(maxsize=512)
def _ring_decode_plan_cached(options: CoderOptions, valid: tuple, erased: tuple,
                             n: int):
    """Per-pattern ring plan: ([n, e, upc] GF matrix, upc), slot i's
    columns of the recovery matrix zero-padded to n upc survivor slots (a
    zero unit against zero columns adds a zero partial)."""
    upc = -(-len(valid) // n)  # units per slot
    dm = _decode_matrix(options, list(valid), list(erased))  # [e, v]
    e = dm.shape[0]
    padded = np.zeros((e, upc * n), dtype=np.uint8)
    padded[:, :dm.shape[1]] = dm
    return padded.reshape(e, n, upc).transpose(1, 0, 2).copy(), upc


@lru_cache(maxsize=512)
def _ring_plan_on(options: CoderOptions, valid: tuple, erased: tuple, n: int,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ring_decode_plan_cached(options, valid, erased, n)[0]).to(device)


def _ring_shift(mesh: Mesh, acc: dict) -> dict:
    """One hop: slot i receives slot i-1's accumulator, on its own device
    (a device copy within the process, isend/irecv across processes)."""
    n, ops, recv = mesh.size, [], {}
    for s in mesh.local_slots:
        src = mesh.slots[(s.index - 1) % n]
        if src.rank == mesh.rank:
            recv[s.index] = _to(acc[src.index], s.device)
        else:
            recv[s.index] = torch.empty_like(acc[s.index])
            ops.append(dist.P2POp(dist.irecv, recv[s.index], src.rank))
        dst = mesh.slots[(s.index + 1) % n]
        if dst.rank != mesh.rank:
            ops.append(dist.P2POp(dist.isend, acc[s.index], dst.rank))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def _ring_crcs(mesh: Mesh, acc: dict, poly: int, bpc: int) -> torch.Tensor:
    """The CRCs of the replicated ring output, sharded over the batch:
    slot i checksums rows [i B / n, (i + 1) B / n) with one no-coding-row
    launch; the rows are gathered in order on the first slot's device."""
    n = mesh.size
    rec0 = acc[mesh.local_slots[0].index]
    b, e, c = rec0.shape
    bounds = [i * b // n for i in range(n + 1)]
    width = -(-b // n)
    parts = []
    for s in mesh.local_slots:
        rows = acc[s.index][bounds[s.index]:bounds[s.index + 1]]
        if rows.shape[0]:
            empty = torch.zeros((0, e), dtype=torch.uint8, device=s.device)
            _, crcs = _launch("ring_decode", s.device, rows, empty, poly, bpc,
                              crc_out=False)
        else:  # a batch smaller than the mesh leaves this slot no rows
            crcs = torch.zeros((0, e, c // bpc), dtype=torch.int32, device=s.device)
        if mesh.spans_processes:  # equal shapes for the gather
            crcs = torch.cat([crcs, crcs.new_zeros((width - crcs.shape[0],)
                                                   + tuple(crcs.shape[1:]))])
        parts.append(crcs)
    dev0 = mesh.first_device
    if not mesh.spans_processes:
        return torch.cat([_to(p, dev0) for p in parts])
    every = _gather_slots(mesh, parts, dev0)
    return torch.cat([every[i][:bounds[i + 1] - bounds[i]] for i in range(n)])


def make_ring_decoder(spec: FusedSpec, valid: list[int], erased: list[int],
                      mesh: Mesh, axis: str = "dn"):
    """Survivor-sharded ring reconstruction: fn(valid_units [B, v, C]) ->
    (recovered [B, e, C], crcs int32 [B, e, C / bpc]) on the first slot's
    device. The v survivors are split over the slots (zero-padded to a
    multiple of the slot count); packed partials XOR-combine around the
    ring. The multi-datanode layout of the reference's BASELINE config #5:
    each slot takes one group of survivors, none holds the whole stripe.
    A new erasure pattern builds a small per-slot matrix, no program."""
    options, valid, erased = spec.options, tuple(valid), tuple(erased)
    n = mesh.size
    _, upc = _ring_decode_plan_cached(options, valid, erased, n)
    e = len(erased)
    poly = _POLY.get(spec.checksum)
    bpc = spec.bytes_per_checksum

    def fn(valid_units):
        units = _as_tensor(valid_units)
        b, v, c = units.shape
        if v != upc * n:
            # pad outside the per-slot launches: each slot then slices
            # whole units, and the padded ones meet zero matrix columns
            units = torch.cat([units, units.new_zeros((b, upc * n - v, c))], 1)
        sb = apply_slice(c)
        local = {}
        for s in mesh.local_slots:
            mine = _slot_rows(units[:, s.index * upc:(s.index + 1) * upc],
                              s.device)
            plan = _ring_plan_on(options, valid, erased, n, s.device)[s.index]
            local[s.index], _ = _launch("ring_decode", s.device, mine, plan, None, sb)
        acc = dict(local)
        for _ in range(n - 1):
            recv = _ring_shift(mesh, acc)
            acc = {i: _launch("ring_decode", mesh.slots[i].device,
                              torch.cat([recv[i], local[i]], 1),
                              _combine_matrix(e, 2, mesh.slots[i].device), None, sb)[0]
                   for i in local}
        rec = acc[mesh.local_slots[0].index]
        if poly is None:
            return rec, torch.zeros((b, e, 0), dtype=torch.int32, device=rec.device)
        return rec, _ring_crcs(mesh, acc, poly, bpc)

    return fn
