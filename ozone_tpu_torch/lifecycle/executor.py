"""Tiering executor: batched replicated->EC transitions on the device.

Port of `ozone_tpu/lifecycle/executor.py`. Where `client/re_encode.py`
converts one key per call, this executor packs stripe windows of many
keys into each device submission, so a sweep over thousands of small
cold keys still drives the fused encode+CRC kernel
(`csrc/fused_encode_crc.cu`) at full batch width. Every dispatch has
the same [window, k, cell] shape (window = OZONE_TPU_TIER_BATCH, the
tail zero-padded).

Per key: read the replicated source a window at a time (throttled), the
fused encode+CRC on `device` (batched across keys), write the EC units,
put the blocks, then CommitKey with the rewrite fence (expect_object_id
and expect_generation): a concurrent user overwrite aborts the
transition instead of being clobbered, and the fresh EC blocks ride the
deletion chain. The old replicated blocks are released only after the
EC commit: the superseded version goes to the deleted table and the
key-deleting service hands its blocks to the SCM's deletion log.

The submissions take the mesh executor's lane when one can exist (two or
more CUDA devices, `mesh_executor.maybe_executor()`, on a CUDA device),
else the shared codec service at the bulk class when it is on, else a
depth-1 `DeviceBatchPipeline`. XOR(1) sources go
through `re_encode_xor_key_to_rs`, one key per call. The codec runs on
`device` ("cuda" launches the kernel and raises without CUDA; "cpu" runs
its plain version); nothing falls back from one to the other.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.om import requests as rq
from ozone_tpu_torch.scm.pipeline import ReplicationConfig, ReplicationType
from ozone_tpu_torch.storage.ids import BlockData, StorageError
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType
from ozone_tpu_torch.utils.metrics import registry

log = logging.getLogger(__name__)

#: shared with service.py: every lifecycle signal in ONE registry
METRICS = registry("lifecycle")


def tier_batch_size() -> int:
    """Stripes per tiering device dispatch (OZONE_TPU_TIER_BATCH);
    falls back to the decode pipeline's batch knob so both background
    device consumers share one tuning surface by default."""
    from ozone_tpu_torch.codec.pipeline import decode_batch_size
    from ozone_tpu_torch.utils.config import env_int

    n = env_int("OZONE_TPU_TIER_BATCH", 0)
    return max(1, n) if n > 0 else decode_batch_size()


class _DeadlineWithStats(StorageError):
    """DEADLINE_EXCEEDED carrying the partial stats of the drained
    work, so the sweeper can book what DID land before it stops
    (without advancing its cursor past the unprocessed remainder)."""

    def __init__(self, stats: dict):
        super().__init__(
            "DEADLINE_EXCEEDED",
            "lifecycle sweep budget spent mid-batch")
        self.stats = stats


@dataclass
class _GroupState:
    """One target EC group mid-write."""

    ng: object  # BlockGroup
    length: int
    lengths: list[int]  # per-unit user-data lengths
    stripes_total: int
    stripes_emitted: int = 0
    unit_infos: list[list] = field(default_factory=list)


@dataclass
class _KeyState:
    volume: str
    bucket: str
    key: str
    info: dict
    session: object
    groups: list[_GroupState] = field(default_factory=list)
    groups_done: int = 0
    total: int = 0
    failed: bool = False
    #: the sweep's stats dict this key reports into
    stats: dict = field(default_factory=dict)


class TieringExecutor:
    """Feeds eligible replicated keys through the batched fused encode.

    `transition_keys([(volume, bucket, key, target_scheme), ...])`
    converts each replicated key to its rule's EC scheme; keys sharing
    a (scheme, checksum) spec share device dispatches. Returns stats:
    transitioned / conflicts / failed / skipped / bytes / dispatches.
    """

    def __init__(self, om, clients, throttle=None, device="cuda"):
        from ozone_tpu_torch.codec.fused import resolve_device

        self.om = om
        self.clients = clients
        #: where the fused encode (and the XOR re-encode) runs
        self.device = resolve_device(device)
        #: utils.throttle.Throttle pacing source reads so tiering never
        #: starves foreground traffic; None = unthrottled
        self.throttle = throttle
        #: test hook: called as fn(key_state) right before each key's
        #: EC commit (the fence regression tests race an overwrite here)
        self.pre_commit_hook: Optional[Callable] = None
        #: HA quorum barrier after each block allocation: the SCM
        #: decision records must commit before data lands on the group
        #: (a remote client gets this from the OM service)
        self.alloc_barrier: Optional[Callable] = None
        #: device dispatches issued by the last transition_keys call
        self.last_dispatches = 0

    # ------------------------------------------------------------- entry
    def transition_keys(self, work: list[tuple]) -> dict:
        """Transition `work`; raises DEADLINE_EXCEEDED (after draining
        the in-flight device batches) when the sweep budget expires
        with items unprocessed — the caller must NOT advance its cursor
        past them (they were neither transitioned nor failed)."""
        from ozone_tpu_torch.client.re_encode import re_encode_xor_key_to_rs

        stats = {"transitioned": 0, "conflicts": 0, "failed": 0,
                 "skipped": 0, "bytes": 0, "dispatches": 0}
        expired = False
        # one packer per fused spec: keys sharing scheme+checksum share
        # device batches (the common case: one rule, one spec)
        packers: dict[tuple, _SpecPacker] = {}
        for volume, bucket, key, target in work:
            try:
                resilience.check_deadline("lifecycle_transition")
            except StorageError:
                # budget spent between keys: stop packing but still
                # DRAIN below — keys already in flight on the device
                # must finalize and commit, not be abandoned
                expired = True
                break
            try:
                info = self.om.lookup_key(volume, bucket, key)
            except rq.OMError:
                stats["skipped"] += 1  # deleted since the scan
                continue
            try:
                repl = ReplicationConfig.parse(info["replication"])
            except ValueError:
                stats["skipped"] += 1
                continue
            if repl.type is ReplicationType.EC:
                if repl.ec.codec == "xor":
                    # XOR(1) sources take the fused decode->re-encode
                    # path per key (its batch geometry is its own)
                    try:
                        re_encode_xor_key_to_rs(
                            self.om, self.clients, volume, bucket, key,
                            ec=target, device=self.device)
                        stats["transitioned"] += 1
                        stats["bytes"] += int(info.get("size", 0))
                        METRICS.counter("transitions").inc()
                        METRICS.counter("bytes_tiered").inc(
                            int(info.get("size", 0)))
                    except (rq.OMError, StorageError) as e:
                        if getattr(e, "code", "") == rq.KEY_MODIFIED:
                            # the re-encode's rewrite fence lost to a
                            # concurrent user overwrite: expected race,
                            # same accounting as the packer path
                            METRICS.counter("transition_conflicts").inc()
                            stats["conflicts"] += 1
                            continue
                        log.warning("lifecycle: xor re-encode of "
                                    "%s/%s/%s failed: %s",
                                    volume, bucket, key, e)
                        stats["failed"] += 1
                        METRICS.counter("transition_failures").inc()
                else:
                    stats["skipped"] += 1  # already RS-coded
                continue
            if not info.get("block_groups"):
                stats["skipped"] += 1  # empty key / directory marker
                continue
            packer = self._packer_for(packers, info, target, stats)
            try:
                self._pack_key(packer, volume, bucket, key, info, target)
            except (rq.OMError, StorageError, OSError, KeyError) as e:
                if isinstance(e, StorageError) \
                        and e.code == resilience.DEADLINE_EXCEEDED:
                    # a spent budget is NOT a failure: the key was
                    # neither transitioned nor broken, and counting it
                    # would make transition_failures climb on every
                    # budget-bounded sweep of a large namespace
                    expired = True
                    break  # drain what's in flight below
                log.warning("lifecycle: transition of %s/%s/%s failed: "
                            "%s", volume, bucket, key, e)
                stats["failed"] += 1
                METRICS.counter("transition_failures").inc()
        for packer in packers.values():
            packer.flush()
            stats["dispatches"] += packer.dispatches
        self.last_dispatches = stats["dispatches"]
        if expired:
            # AFTER the drain: packed keys committed, but unprocessed
            # work items must bounce the caller's cursor advance
            raise _DeadlineWithStats(stats)
        return stats

    # ------------------------------------------------------------ packing
    def _packer_for(self, packers: dict, info: dict, target: str,
                    stats: dict) -> "_SpecPacker":
        from ozone_tpu_torch.codec.fused import (
            FusedSpec,
            effective_bpc,
            make_fused_encoder,
        )

        conf = ReplicationConfig.parse(target)
        ctype = ChecksumType(info.get("checksum_type", "CRC32C"))
        cell = conf.ec.cell_size
        bpc = effective_bpc(cell, info.get("bytes_per_checksum",
                                           16 * 1024))
        key = (target, ctype.value, bpc)
        packer = packers.get(key)
        if packer is None:
            spec = FusedSpec(conf.ec, ctype, bpc)
            packer = packers[key] = _SpecPacker(
                self, make_fused_encoder(spec, device=self.device), conf.ec,
                ctype, bpc,
                stats, spec=spec)
        return packer

    def _pack_key(self, packer: "_SpecPacker", volume: str, bucket: str,
                  key: str, info: dict, target: str) -> None:
        session = self.om.open_key(volume, bucket, key,
                                   replication=target)
        # rewrite fence: commit only if the live row is still this
        # version (object id AND generation, see check_rewrite_fence)
        session.expect_object_id = info.get("object_id", "")
        session.expect_generation = int(info.get("generation", -1))
        ks = _KeyState(volume, bucket, key, info, session)
        ks.stats = packer.stats
        try:
            self._pack_key_groups(packer, ks, info)
        except BaseException:
            # mid-key failure: windows already packed for this key must
            # not finalize/commit a partial version (their allocated
            # blocks are reclaimed by scrubbing, like any dead write)
            ks.failed = True
            raise

    def _pack_key_groups(self, packer: "_SpecPacker", ks: _KeyState,
                         info: dict) -> None:
        from ozone_tpu_torch.client.ec_writer import (
            block_lengths,
            create_group_containers,
        )
        from ozone_tpu_torch.client.replicated import ReplicatedKeyReader

        k, p, cell = (packer.opts.data_units, packer.opts.parity_units,
                      packer.opts.cell_size)
        session = ks.session
        old_groups = self.om.key_block_groups(info)
        window = packer.window
        for g in old_groups:
            stripes = max(1, -(-g.length // (k * cell)))
            ng = self.om.allocate_block(session)
            if self.alloc_barrier is not None:
                self.alloc_barrier()
            create_group_containers(self.clients, ng,
                                    replica_indexed=True)
            gs = _GroupState(
                ng=ng, length=g.length,
                lengths=block_lengths(g.length, k, cell)
                + [stripes * cell] * p,
                stripes_total=stripes,
                unit_infos=[[] for _ in range(k + p)],
            )
            ks.groups.append(gs)
            reader = ReplicatedKeyReader(g, self.clients)
            for s0 in range(0, stripes, window):
                resilience.check_deadline("lifecycle_window")
                n = min(window, stripes - s0)
                lo = s0 * k * cell
                want = min(n * k * cell, g.length - lo)
                if self.throttle is not None and want > 0:
                    self.throttle.take(want)
                data = np.zeros(n * k * cell, np.uint8)
                if want > 0:
                    data[:want] = reader.read(lo, want)
                packer.add(ks, gs, s0, data.reshape(n, k, cell))
            ks.total += g.length

    # ----------------------------------------------------------- finalize
    def _finalize_group(self, ks: _KeyState, gs: _GroupState) -> None:
        for u, dn_id in enumerate(gs.ng.pipeline.nodes):
            self.clients.get(dn_id).put_block(
                BlockData(gs.ng.block_id, gs.unit_infos[u],
                          block_group_length=gs.length))
        gs.ng.length = gs.length
        ks.groups_done += 1
        if ks.groups_done == len(ks.groups):
            self._commit_key(ks)

    def _commit_key(self, ks: _KeyState) -> None:
        if self.pre_commit_hook is not None:
            self.pre_commit_hook(ks)
        try:
            self.om.commit_key(ks.session, [gs.ng for gs in ks.groups],
                               ks.total)
        except rq.OMError as e:
            if e.code == rq.KEY_MODIFIED:
                # concurrent overwrite won: the fence discarded our EC
                # version into the deletion chain; the user's data is
                # authoritative
                METRICS.counter("transition_conflicts").inc()
                ks.failed = True
                ks.stats["conflicts"] += 1
                return
            raise
        METRICS.counter("transitions").inc()
        METRICS.counter("bytes_tiered").inc(ks.total)
        ks.stats["transitioned"] += 1
        ks.stats["bytes"] += ks.total
        log.info("lifecycle: tiered %s/%s/%s (%d bytes, %d groups) -> "
                 "EC", ks.volume, ks.bucket, ks.key, ks.total,
                 len(ks.groups))


class _SpecPacker:
    """Accumulates stripe windows across keys into constant-shape
    device batches over one depth-1 DeviceBatchPipeline."""

    def __init__(self, executor: TieringExecutor, fn, opts, ctype, bpc,
                 stats: dict, spec=None):
        from ozone_tpu_torch.codec import service as codec_service
        from ozone_tpu_torch.codec.pipeline import DeviceBatchPipeline
        from ozone_tpu_torch.parallel import mesh_executor

        self.executor = executor
        self.opts = opts
        self.ctype = ctype
        self.bpc = bpc
        self.stats = stats
        self.window = tier_batch_size()
        # the mesh lane first: on a multi-GPU host a bulk tiering sweep is
        # the traffic the persistent mesh executor exists for, full-width
        # windows coalescing with other sweeps into mesh-wide dispatches.
        # Then the shared codec service at the bulk class: sweep windows
        # coalesce with other operations' stripes and the weighted fair
        # scheduler keeps the sweep from starving interactive traffic; a
        # per-sweep DeviceBatchPipeline when the service is off
        self.pipe = None
        if spec is not None and executor.device.type == "cuda":
            mex = mesh_executor.maybe_executor()
            if mex is not None:
                try:
                    self.pipe = mex.pipeline(codec_service.encode_key(spec),
                                             width=self.window, qos="bulk")
                except KeyError:
                    log.info("no mesh program for %s; the sweep takes one device",
                             spec)
        if self.pipe is None:
            svc = codec_service.maybe_service() if spec is not None else None
            if svc is not None:
                self.pipe = codec_service.ServicePipeline(
                    svc, codec_service.encode_key(spec), fn,
                    width=self.window, qos="bulk")
            else:
                self.pipe = DeviceBatchPipeline(fn)
        self.host_checksum = Checksum(ctype, bpc)
        self.dispatches = 0
        self._reset_buffer()

    def _reset_buffer(self) -> None:
        k, cell = self.opts.data_units, self.opts.cell_size
        # a FRESH buffer per submission: the pipeline keeps one batch in
        # flight while the next fills, and emit still reads the data
        # columns of the in-flight one (the buffer rides the ctx)
        self._buf = np.zeros((self.window, k, cell), np.uint8)
        self._fill = 0
        self._segments: list[tuple] = []  # (ks, gs, s0, n, row0)

    def add(self, ks: _KeyState, gs: _GroupState, s0: int,
            data: np.ndarray) -> None:
        """Append one window of one group ([n, k, cell]); splits across
        device batches as needed so every dispatch is full-width."""
        pos = 0
        while pos < data.shape[0]:
            take = min(self.window - self._fill, data.shape[0] - pos)
            self._buf[self._fill:self._fill + take] = data[pos:pos + take]
            self._segments.append((ks, gs, s0 + pos, take, self._fill))
            self._fill += take
            pos += take
            if self._fill == self.window:
                self._submit()

    def _submit(self) -> None:
        done = self.pipe.submit(self._buf, (self._segments, self._buf))
        self.dispatches += 1
        self._reset_buffer()
        if done is not None:
            self._emit(*done)

    def flush(self) -> None:
        if self._fill:
            # zero-pad the tail to the constant dispatch shape: one
            # launch shape for the whole sweep (padded rows belong to no
            # segment and are simply not written out)
            self._submit()
        done = self.pipe.drain()
        if done is not None:
            self._emit(*done)

    def _emit(self, ctx: tuple, results: tuple) -> None:
        from ozone_tpu_torch.client.dn_client import (
            build_chunk_pairs,
            write_unit_stream,
        )

        segments, buf = ctx
        parity, crcs = results
        k = self.opts.data_units
        p = self.opts.parity_units
        cell = self.opts.cell_size
        for ks, gs, s0, n, row0 in segments:
            gs.stripes_emitted += n
            if ks.failed:
                continue
            try:
                for u in range(k + p):
                    # data columns come back out of the submitted batch
                    # itself (results carry only parity + CRCs)
                    cells = (buf[row0:row0 + n, u] if u < k
                             else parity[row0:row0 + n, u - k])
                    pairs = build_chunk_pairs(
                        gs.ng.block_id, range(s0, s0 + n), cells,
                        crcs[row0:row0 + n, u], gs.lengths[u], cell,
                        self.bpc, self.ctype, self.host_checksum)
                    if pairs:
                        write_unit_stream(
                            self.executor.clients.get(
                                gs.ng.pipeline.nodes[u]),
                            gs.ng.block_id, pairs)
                        gs.unit_infos[u].extend(i for i, _ in pairs)
                if gs.stripes_emitted == gs.stripes_total:
                    self.executor._finalize_group(ks, gs)
            except (rq.OMError, StorageError, OSError, KeyError) as e:
                # KeyError: a datanode with no client (dead/unlearned
                # address) — per-key failure, never a sweep abort
                ks.failed = True
                if isinstance(e, StorageError) and \
                        e.code == "DEADLINE_EXCEEDED":
                    # spent budget, not a broken key: it re-tiers next
                    # sweep and must not inflate transition_failures
                    continue
                log.warning("lifecycle: EC write for %s/%s/%s failed: "
                            "%s", ks.volume, ks.bucket, ks.key, e)
                self.stats["failed"] += 1
                METRICS.counter("transition_failures").inc()
