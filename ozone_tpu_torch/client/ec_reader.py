"""EC block-group read paths: normal, degraded, and targeted recovery.

Port of `ozone_tpu/client/ec_reader.py`. It mirrors the reference's read
stack: round-robin cell reads from the k data
blocks, falling back to reading a decodable set of the other units and
decoding the missing cells, and the targeted recovery that offline
reconstruction drives (`recover_cells_iter`). For RS the read set is k
units; for LRC the repair planner (`codec/lrc_math.plan_valid`) picks it,
the lost unit's local group (group_size units) when one loss per group
allows it.

Degraded reads decode every needed stripe of the group in batches of
`decode_batch_size()` stripes through a depth-1 pipeline: survivor reads
of batch N+1 run while batch N decodes and its results come back to the
host. By default the batches go to the shared codec service
(`ServicePipeline`), where batches of concurrent reads with the same
erasure pattern share launches; with OZONE_TPU_CODEC_SERVICE=0 each is
one launch of its own (`DeviceBatchPipeline`). A reader given a mesh
executor (`parallel/mesh_executor.py`) submits its batches to the
executor's lane for the pattern instead, where they coalesce into
full-width mesh dispatches; a reader given a `mesh` decodes each batch
over it, stripe-parallel (DP) or survivor-sharded around the ring with
`use_ring=True` (`parallel/sharded.py`), and bypasses the codec service.

Straggler tolerance (client/resilience.py): survivor choice skips
breaker-open peers and, with more survivors than it needs, takes the
topology-nearest (`DatanodeClientFactory.nearest_first`), every read feeds the per-peer latency EWMA, and a
cell read that runs past the peer's hedge delay is hedged. The normal
path races the read against a decode of the same cell from parity; the
recovery path drops the straggling survivor and replans the batched
decode around a spare. First result wins; the loser's bytes are dropped.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as fwait
from typing import Optional, Sequence

import numpy as np

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.dn_client import (
    DatanodeClientFactory,
    register_tokens,
)
from ozone_tpu_torch.client.ec_writer import BlockGroup, block_lengths
from ozone_tpu_torch.codec import hostmem, lrc_math
from ozone_tpu_torch.codec import service as codec_service
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import FusedSpec, make_fused_decoder, resolve_device
from ozone_tpu_torch.codec.pipeline import (
    DeviceBatchPipeline,
    batched,
    decode_batch_size,
    host_buffer,
)
from ozone_tpu_torch.storage.ids import BlockData, StorageError
from ozone_tpu_torch.utils.checksum import ChecksumType
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)


class InsufficientLocationsError(Exception):
    """Fewer than k units reachable (reference InsufficientLocationsException)."""


class _UnitReadError(Exception):
    """Internal: a specific unit failed during a multi-unit read."""

    def __init__(self, unit: int, cause: Exception):
        super().__init__(f"unit {unit}: {cause}")
        self.unit = unit
        self.cause = cause


class _StragglerHedge(Exception):
    """Internal: survivor units ran past their hedge delay while spares
    could take their place; the retry loop excludes them and replans the
    batched decode. Their reads are abandoned and their results dropped."""

    def __init__(self, units: list[int]):
        super().__init__(f"straggling units {units}: hedging to spares")
        self.units = units


class ECBlockGroupReader:
    """Reads one block group. The decode runs on `device`: "cuda" launches
    the fused kernel (and raises when CUDA is absent), "cpu" runs its
    plain version. `qos_class` is the codec service's scheduling class of
    this reader's decode batches."""

    def __init__(
        self,
        group: BlockGroup,
        options: CoderOptions,
        clients: DatanodeClientFactory,
        verify: bool = True,
        checksum: ChecksumType = ChecksumType.CRC32C,
        bytes_per_checksum: int = 16 * 1024,
        device="cuda",
        qos_class: str = "interactive",
        mesh=None,
        use_ring: bool = False,
        executor=None,
    ):
        #: optional sharded.Mesh: recovery decodes run stripe-parallel
        #: (DP) over it, or survivor-sharded around the ring with use_ring
        self.mesh = mesh
        self.use_ring = use_ring
        #: optional mesh_executor.MeshExecutor: decode batches join its
        #: submission queue, where concurrent readers (a reconstruction
        #: storm) coalesce into full-width mesh dispatches
        self._executor = executor
        self.group = group
        self.opts = options
        self.k, self.p, self.cell = (
            options.data_units,
            options.parity_units,
            options.cell_size,
        )
        self.clients = clients
        register_tokens(clients, [group])  # READ tokens from the lookup
        self.verify = verify
        self.spec = FusedSpec(options, checksum, bytes_per_checksum)
        self.device = resolve_device(device)
        self._qos = qos_class
        self._block_meta: dict[int, Optional[BlockData]] = {}
        self._read_pool: Optional[ThreadPoolExecutor] = None
        #: (unit, stripe) -> full-cell array, filled by _prefetch_unit's
        #: batched ReadChunks and consumed (popped) by _read_cell
        self._cell_cache: dict[tuple[int, int], np.ndarray] = {}
        #: stripes per decode dispatch
        self._decode_batch = decode_batch_size()
        #: units that failed a read or verify; excluded like missing ones
        self._failed: set[int] = set()
        #: shared per-peer health (EWMA latency, circuit breaker)
        self._health = getattr(clients, "health", None) \
            or resilience.default_registry()
        #: operation deadline captured at the public entry points and
        #: re-activated on reader-pool worker threads
        self._deadline: Optional[resilience.Deadline] = None
        #: decode batches submitted, the hedge's single-cell decodes
        #: included: one fused launch each on the direct route (a mesh's
        #: per-form count over it); on the service and executor routes
        #: they coalesce, so launches follow those dispatches
        self.dispatches = 0
        self._dispatch_lock = threading.Lock()  # hedges count from pool threads

    # ---------------------------------------------------------------- helpers
    @property
    def num_stripes(self) -> int:
        return -(-self.group.length // (self.k * self.cell))

    def _unit_block(self, u: int) -> Optional[BlockData]:
        """BlockData of unit u (0-based) or None if unreachable/missing. A
        data unit that holds no bytes of the group (a short group's units
        past its length) is known zero padding: an empty block, asked of
        no datanode, since the writer never creates that block."""
        if u not in self._block_meta and u < self.k and \
                block_lengths(self.group.length, self.k, self.cell)[u] == 0:
            self._block_meta[u] = BlockData(self.group.block_id, [])
        if u not in self._block_meta:
            dn_id = self.group.pipeline.nodes[u]
            try:
                with Tracer.instance().span("net:get_block", dn=dn_id, unit=u):
                    self._block_meta[u] = self._health.observe(
                        dn_id, self.clients.get(dn_id).get_block,
                        self.group.block_id)
            except (StorageError, KeyError, OSError) as e:
                if isinstance(e, StorageError) \
                        and e.code == resilience.DEADLINE_EXCEEDED:
                    # the operation's budget is spent, not the unit lost:
                    # fail fast instead of a false InsufficientLocations
                    raise
                log.debug("unit %d unavailable: %s", u, e)
                self._block_meta[u] = None
        return self._block_meta[u]

    def available_units(self) -> list[int]:
        return [
            u
            for u in range(self.k + self.p)
            if u not in self._failed and self._unit_block(u) is not None
        ]

    def _read_cell(self, u: int, stripe: int) -> np.ndarray:
        """Read unit u's cell of `stripe`, zero-padded to full cell size."""
        cached = self._cell_cache.pop((u, stripe), None)
        if cached is not None:
            return cached
        return self._fetch_cell(u, stripe)

    def _peek_cell(self, u: int, stripe: int) -> np.ndarray:
        """_read_cell that peeks the prefetch cache instead of popping: the
        decode-from-parity hedge must not consume entries the main loop
        still owns. A fresh fetch is added to the cache (cells are
        immutable), so hedged cells of one window share survivor reads."""
        cached = self._cell_cache.get((u, stripe))
        if cached is not None:
            return cached
        out = self._fetch_cell(u, stripe)
        self._cell_cache.setdefault((u, stripe), out)
        return out

    def _fetch_cell(self, u: int, stripe: int) -> np.ndarray:
        bd = self._unit_block(u)
        if bd is None:
            return np.zeros(self.cell, dtype=np.uint8)
        offset = stripe * self.cell
        info = next((c for c in bd.chunks if c.offset == offset), None)
        if info is None:
            # cell has no data (short final stripe)
            return np.zeros(self.cell, dtype=np.uint8)
        dn_id = self.group.pipeline.nodes[u]
        with Tracer.instance().span("net:read_chunk", dn=dn_id, unit=u,
                                    stripe=stripe):
            data = self._health.observe(
                dn_id, self.clients.get(dn_id).read_chunk,
                self.group.block_id, info, verify=self.verify)
        return self._cell_array(data)

    def _cell_array(self, data: np.ndarray) -> np.ndarray:
        """Full cells pass through as views; a short cell pads into a
        fresh array, one counted copy, inherent to zero-fill."""
        if data.size == self.cell:
            return hostmem.as_array(data)
        out = np.zeros(self.cell, dtype=np.uint8)
        out[: data.size] = data
        hostmem.count_copy(int(data.size), site="ec_reader._cell_array",
                           warn=False)
        return out

    def _prefetch_unit(self, u: int, stripes: Sequence[int]) -> None:
        """Read unit u's cells of `stripes` in one ReadChunks call into the
        cell cache. Best effort: any error leaves the cells to the
        per-chunk path, which reports precise per-cell failures."""
        bd = self._unit_block(u)
        if bd is None:
            return
        by_offset = {c.offset: c for c in bd.chunks}
        wanted = [
            (s, by_offset[s * self.cell])
            for s in stripes
            if (u, s) not in self._cell_cache
            and s * self.cell in by_offset
        ]
        if len(wanted) < 2:
            return  # nothing saved over the per-chunk path
        dn_id = self.group.pipeline.nodes[u]
        try:
            with Tracer.instance().span("net:read_chunks", dn=dn_id, unit=u,
                                        cells=len(wanted)):
                datas = self._health.observe(
                    dn_id, self.clients.get(dn_id).read_chunks,
                    self.group.block_id, [i for _, i in wanted],
                    verify=self.verify)
        except (StorageError, KeyError, OSError) as e:
            if isinstance(e, StorageError) \
                    and e.code == resilience.DEADLINE_EXCEEDED:
                raise
            log.debug("batched read of unit %d failed (%s); per-chunk "
                      "path will retry", u, e)
            return
        for (s, _info), data in zip(wanted, datas):
            self._cell_cache[(u, s)] = self._cell_array(data)

    # ---------------------------------------------------------------- normal
    def read_all(self) -> np.ndarray:
        """Whole-group read, preferring plain data-block reads and falling
        back to reconstruction for missing or failing units."""
        return self.read(0, self.group.length)

    def _close_pool(self) -> None:
        """Reap the reader threads; each public entry point reaps its own
        pool (readers have no close())."""
        pool, self._read_pool = self._read_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def _read_range_into(self, out: np.ndarray, offset: int, length: int,
                         missing_data: list[int]) -> None:
        """Fill `out` with user bytes [offset, offset+length): only the
        cells intersecting the range are read, and on degraded groups only
        the stripes where a missing unit's cell meets the range are
        reconstructed."""
        row = self.k * self.cell
        s0 = offset // row
        s1 = (offset + length - 1) // row
        need_rec = [
            s for s in range(s0, s1 + 1)
            if any(max(offset, s * row + u * self.cell)
                   < min(offset + length, s * row + (u + 1) * self.cell)
                   for u in missing_data)
        ]
        # exclude_stragglers=False: a straggling survivor goes to read()'s
        # retry loop, which folds it into missing_data so the next attempt
        # reconstructs every missing unit in one batched decode
        rec = (self.recover_cells(missing_data, need_rec,
                                  exclude_stragglers=False)
               if need_rec else None)
        rec_pos = {s: i for i, s in enumerate(need_rec)}
        window = 8  # stripes prefetched per unit per call (bounds memory)
        for w0 in range(s0, s1 + 1, window):
            stripes = range(w0, min(w0 + window, s1 + 1))
            # one batched read per needed unit, concurrently; a unit is
            # needed only where the range touches its cells
            needed: dict[int, list[int]] = {}
            for s in stripes:
                for i in range(self.k):
                    if i in missing_data or i in self._failed:
                        continue
                    cell_start = s * row + i * self.cell
                    if (max(offset, cell_start)
                            < min(offset + length, cell_start + self.cell)):
                        needed.setdefault(i, []).append(s)
            if needed:
                self._prefetch_bounded(needed)
            for s in stripes:
                for i in range(self.k):
                    cell_start = s * row + i * self.cell
                    a = max(offset, cell_start)
                    b = min(offset + length, cell_start + self.cell)
                    if a >= b:
                        continue
                    if i in missing_data:
                        cell = rec[rec_pos[s], missing_data.index(i)]
                    else:
                        cell = self._read_cell_hedged(i, s)
                    out[a - offset : b - offset] = \
                        cell[a - cell_start : b - cell_start]

    def _read_cell_checked(self, u: int, stripe: int) -> np.ndarray:
        try:
            return self._read_cell(u, stripe)
        except (StorageError, KeyError, OSError) as e:
            if isinstance(e, StorageError) \
                    and e.code == resilience.DEADLINE_EXCEEDED:
                raise  # a spent budget is the operation's, not the unit's
            raise _UnitReadError(u, e)

    def _prefetch_bounded(self, needed: dict[int, list[int]]) -> None:
        """Concurrent per-unit batched prefetch, bounded by the hedge
        delay: a straggling peer's prefetch is abandoned (whatever it
        delivers still lands in the cache) and the cells it did not
        deliver take the hedged per-cell path."""
        pool = self._ensure_pool()
        futs = [self._submit_act(pool, self._prefetch_unit, u, ss)
                for u, ss in needed.items()]
        nodes = self.group.pipeline.nodes
        # a batched call moves up to `window` cells: scale the one-call
        # hedge delay by the deepest request
        depth = max(len(ss) for ss in needed.values())
        delay = max(1, depth) * max(
            self._health.hedge_delay_s(nodes[u]) for u in needed)
        _done, pending = fwait(set(futs), timeout=resilience.op_timeout(
            delay, "prefetch"))
        if pending:
            # walk away from the stragglers: the next reads get fresh
            # workers instead of queueing behind them
            self._close_pool()

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._read_pool is None:
            self._read_pool = ThreadPoolExecutor(
                max_workers=self.k, thread_name_prefix="ec-read")
        return self._read_pool

    def _submit_act(self, pool, fn, *args):
        """Submit with the operation deadline and the trace context
        re-activated on the worker."""
        d = self._deadline
        ctx = Tracer.instance().inject()

        def run():
            with resilience.activate(d), Tracer.instance().activate(ctx):
                return fn(*args)

        return pool.submit(run)

    # ---------------------------------------------------------------- hedging
    def _read_cell_hedged(self, u: int, stripe: int) -> np.ndarray:
        """Data-cell read racing the owning peer against decode-from-
        parity: once the read runs past the peer's hedge delay and enough
        other units are alive to decode without it, a single-stripe
        decode of the same cell fires; first result wins."""
        if u in self._failed:
            # excluded earlier in this read: fail fast so the outer retry
            # reconstructs it instead of paying the straggler per cell
            raise _UnitReadError(u, StorageError(
                "UNAVAILABLE", f"unit {u} excluded earlier in this read"))
        if (u, stripe) in self._cell_cache:
            return self._read_cell(u, stripe)
        if len(self.available_units()) <= self.k:
            # no spare capacity to decode around u: wait the peer out
            return self._read_cell_checked(u, stripe)
        node = self.group.pipeline.nodes[u]
        try:
            win = resilience.HedgeGroup().run(
                lambda: self._read_cell_checked(u, stripe),
                [lambda: self._decode_cell_from_parity(u, stripe)],
                delay_s=self._health.hedge_delay_s(node),
                deadline=self._deadline)
        except _UnitReadError:
            raise
        except (StorageError, KeyError, OSError,
                InsufficientLocationsError) as e:
            if isinstance(e, StorageError) \
                    and e.code == resilience.DEADLINE_EXCEEDED:
                raise
            # both branches failed: the unit's failure, for the retry loop
            raise _UnitReadError(u, e)
        if win.index > 0:
            # the decode beat the peer: exclude the unit so the next cell
            # replans the read into one batched reconstruction instead of
            # paying a hedge window per remaining cell
            self._failed.add(u)
        return win.value

    def _decode_cell_from_parity(self, u: int, stripe: int) -> np.ndarray:
        """The hedge branch: reconstruct unit u's cell of `stripe` from k
        healthy other units with a width-1 decode. Peeks the prefetch
        cache and changes no reader state but the dispatch count, so a
        losing decode leaves no trace."""
        with Tracer.instance().span("ec:decode_from_parity", unit=u,
                                    stripe=stripe):
            return self._decode_cell_traced(u, stripe)

    def _decode_cell_traced(self, u: int, stripe: int) -> np.ndarray:
        if self.spec.options.codec == "lrc":
            # the repair planner picks the read set (the local group's
            # survivors when u is the only loss of its group)
            valid = self._choose_valid([u])
        else:
            others = [x for x in self.available_units() if x != u]
            nodes = self.group.pipeline.nodes
            order = {dn: i for i, dn in enumerate(
                self._health.preferred([nodes[x] for x in others]))}
            valid = sorted(sorted(
                others,
                key=lambda x: order.get(nodes[x], len(order)))[: self.k])
            if len(valid) < self.k:
                raise InsufficientLocationsError(
                    f"hedge decode needs {self.k} units, reachable: {valid}")
        fn = make_fused_decoder(self.spec, valid, [u], device=self.device)
        batch = host_buffer((1, len(valid), self.cell), self.device)
        for vi, x in enumerate(valid):
            batch.numpy()[0, vi] = self._peek_cell(x, stripe)
        svc = codec_service.maybe_service()
        self._count_dispatch()
        if svc is not None:
            # a lone stripe at width 1: no linger on the latency-critical
            # hedge, but concurrent hedges still share one dispatcher
            rec, _crcs = codec_service.wait_result(svc.submit(
                codec_service.decode_key(self.spec, valid, (u,)), fn,
                batch, width=1, qos=self._qos, deadline=self._deadline))
            return rec[0, 0]
        rec, _crcs = fn(batch)
        return rec[0, 0].cpu().numpy()

    def _count_dispatch(self) -> None:
        with self._dispatch_lock:
            self.dispatches += 1

    def _fanout_survivors(self, pool, fill_unit, valid: list[int],
                          depth: int) -> None:
        """Run the per-survivor batch reads concurrently, watching for
        stragglers: a unit still pending past its hedge delay while a spare
        survivor is alive is dropped (_StragglerHedge) and the batched
        decode replans around it. Without a spare the read waits."""
        nodes = self.group.pipeline.nodes
        futs = {self._submit_act(pool, fill_unit, (vi, u)): u
                for vi, u in enumerate(valid)}
        # each stream moves up to `depth` cells: scale the one-call hedge
        # delay by the batch depth, as _prefetch_bounded does
        delay = (1 + depth) * max(self._health.hedge_delay_s(nodes[u])
                                  for u in valid)
        delay = resilience.op_timeout(delay, "recover_cells")
        done, pending = fwait(set(futs), timeout=delay)
        if pending:
            spares = [x for x in self.available_units()
                      if x not in valid and self._health.usable(nodes[x])]
            # only as many slow survivors as there are spares can be
            # replanned around; the rest must be waited out
            stragglers = sorted(futs[f] for f in pending)[: len(spares)]
            if stragglers:
                resilience.METRICS.counter("hedges_fired").inc()
                Tracer.instance().event("hedge_fired", stragglers=stragglers,
                                        spares=spares)
                log.warning(
                    "survivor unit(s) %s straggling past %.3fs; hedging "
                    "into decode via spare unit(s) %s",
                    stragglers, delay, spares)
                self._close_pool()  # abandon the stragglers' reads
                for f in done:
                    f.result()  # a real error beats a straggler signal
                raise _StragglerHedge(stragglers)
            done2, _ = fwait(set(pending))
            done = set(done) | done2
        for f in done:
            f.result()  # propagate _UnitReadError from the workers

    # ------------------------------------------------------------- degraded
    def _choose_valid(self, erased: Sequence[int]) -> list[int]:
        avail = [u for u in self.available_units() if u not in erased]
        if self.spec.options.codec == "lrc":
            # LRC: the repair planner classifies the pattern. One loss per
            # group reads that group's survivors (group_size units, not
            # k); anything else grows a minimal global read set. Health
            # shapes only the preference order of the global path: usable
            # peers first. A data unit holding no bytes of the group is
            # available (known zeros), so a short group repairs locally.
            nodes = self.group.pipeline.nodes
            pref = sorted(avail)
            if getattr(self.clients, "nearest_first", None) is not None:
                order = {dn: i for i, dn in
                         enumerate(self.clients.nearest_first(
                             [nodes[u] for u in pref]))}
                pref.sort(key=lambda u: order.get(nodes[u], len(order)))
            usable = {u for u in pref if self._health.usable(nodes[u])}
            if usable:
                pref.sort(key=lambda u: u not in usable)  # stable
            try:
                valid, _kind = lrc_math.plan_valid(
                    self.spec.options, list(erased), avail, prefer=pref)
            except ValueError as e:
                raise InsufficientLocationsError(str(e)) from None
            return valid
        if len(avail) < self.k:
            raise InsufficientLocationsError(
                f"need {self.k} units, reachable: {avail}, erased: {list(erased)}"
            )
        if len(avail) > self.k:
            # breaker consult (non-claiming): a peer mid-outage is routed
            # around while spares exist, never excluded when it is the
            # k-th survivor
            nodes = self.group.pipeline.nodes
            usable = [u for u in avail if self._health.usable(nodes[u])]
            if len(usable) >= self.k:
                avail = usable
        if len(avail) > self.k and \
                getattr(self.clients, "nearest_first", None) is not None:
            # more survivors than needed: read the k topology-nearest (the
            # survivor choice is the replica choice; it sets the decode's
            # recovery matrix)
            nodes = self.group.pipeline.nodes
            order = {dn: i for i, dn in
                     enumerate(self.clients.nearest_first(
                         [nodes[u] for u in avail]))}
            avail.sort(key=lambda u: order.get(nodes[u], len(order)))
            avail = sorted(avail[: self.k])
        return avail[: self.k]

    def recover_cells(
        self, targets: Sequence[int], stripes: Optional[Sequence[int]] = None,
        exclude_stragglers: bool = True,
    ) -> np.ndarray:
        """Reconstruct full cells of `targets` units for the given stripes
        (default: all). Returns uint8 [num_stripes, len(targets), cell]."""
        return self.recover_cells_with_crcs(
            targets, stripes, exclude_stragglers=exclude_stragglers)[0]

    def recover_cells_with_crcs(
        self, targets: Sequence[int], stripes: Optional[Sequence[int]] = None,
        exclude_stragglers: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """recover_cells plus the per-slice device CRCs of the recovered
        cells, uint32 [num_stripes, len(targets), cell // bpc]."""
        stripes = list(
            stripes if stripes is not None else range(self.num_stripes))
        pos = {s: i for i, s in enumerate(stripes)}
        rec = np.zeros((len(stripes), len(targets), self.cell),
                       dtype=np.uint8)
        crcs: Optional[np.ndarray] = None
        for sb, (r, c) in self.recover_cells_iter(
                targets, stripes, exclude_stragglers=exclude_stragglers):
            if crcs is None:
                crcs = np.zeros(
                    (len(stripes), len(targets)) + c.shape[2:], c.dtype)
            for bi, s in enumerate(sb):
                rec[pos[s]] = r[bi]
                crcs[pos[s]] = c[bi]
        if crcs is None:  # zero stripes requested
            crcs = np.zeros((0, len(targets), 0), np.uint32)
        return rec, crcs

    def recover_cells_iter(
        self, targets: Sequence[int], stripes: Optional[Sequence[int]] = None,
        exclude_stragglers: bool = True,
    ):
        """Streaming recovery: yields (stripe_batch, (rec, crcs)) per
        decode batch, rec uint8 [b, len(targets), cell] and crcs uint32
        [b, len(targets), cell // bpc], so a consumer writes one batch
        while the device decodes the next. On a unit failure mid-stream
        the recovery restarts with the unit excluded and every batch is
        yielded again: consumers treat stripe indexes as overwrite keys."""
        # refresh per call: a reused reader must not re-activate a
        # previous operation's (possibly expired) budget
        self._deadline = resilience.current()
        try:
            # p hard failures plus straggler hedges both take attempts
            for _ in range(2 * self.p + 1):
                try:
                    yield from self._recover_batches_once(targets, stripes)
                    return
                except _UnitReadError as e:
                    log.warning("unit %d failed during recovery (%s); "
                                "excluding", e.unit, e.cause)
                    self._failed.add(e.unit)
                except _StragglerHedge as e:
                    # a replan, not a failure: the slow survivors are
                    # dropped and the decode replans around spares
                    resilience.METRICS.counter("straggler_replans").inc()
                    Tracer.instance().event("straggler_replan", units=e.units)
                    self._failed.update(e.units)
                    if not exclude_stragglers:
                        # the caller replans (read() reconstructs the
                        # straggler with everything else in one pass)
                        raise
            raise InsufficientLocationsError(
                f"recovery failed; failed units {sorted(self._failed)}"
            )
        finally:
            self._close_pool()

    def _recover_batches_once(
        self, targets: Sequence[int], stripes: Optional[Sequence[int]] = None
    ):
        """One recovery attempt as a depth-1 device pipeline: survivor
        reads of batch N+1 run while batch N decodes and its results come
        back. One dispatch per stripe batch, not per stripe."""
        stripes = list(
            stripes if stripes is not None else range(self.num_stripes))
        valid = self._choose_valid(list(targets))
        pipe = self._decode_pipe(valid, list(targets))
        direct = isinstance(pipe, DeviceBatchPipeline)
        pool = self._ensure_pool()
        for sb in batched(stripes, self._decode_batch):
            # a fresh (pinned, on CUDA) buffer per batch: the previous one
            # may still be in its copy to the device. Its width is the
            # read set's, not k: an LRC local repair reads group_size units
            staged = host_buffer((len(sb), len(valid), self.cell), self.device)
            batch = staged.numpy()

            def fill_unit(vi_u, batch=batch, sb=sb):
                vi, u = vi_u
                # one batched ReadChunks for the unit's cells of this batch
                # first; cells it could not serve fall back to per-chunk
                self._prefetch_unit(u, sb)
                for bi, s in enumerate(sb):
                    batch[bi, vi] = self._read_cell_checked(u, s)

            # one reader thread per survivor unit: the k unit streams come
            # off k datanodes, so the fan-in costs the slowest, not the sum
            self._fanout_survivors(pool, fill_unit, valid, len(sb))
            # the launch (the service records its own dispatch spans),
            # and the wait for the previous batch's results
            with self._dispatch_span(direct, len(sb)):
                out = pipe.submit(staged, sb)
            self._count_dispatch()
            if out is not None:
                yield out
        with self._dispatch_span(direct, 0):
            out = pipe.drain()
        if out is not None:
            yield out

    @staticmethod
    def _dispatch_span(direct: bool, rows: int):
        if not direct:
            return contextlib.nullcontext()
        return Tracer.instance().span("codec:device_dispatch", rows=rows)

    def _decode_pipe(self, valid: list[int], targets: list[int]):
        """The recovery dispatch pipeline, best route first: the mesh
        executor's lane for this pattern (when no mesh was given), then
        the caller's mesh, then the shared codec service, where this
        read's batches share launches with every other operation on the
        same erasure pattern, then a per-operation pipeline."""
        if self._executor is not None and self.mesh is None:
            try:
                return self._executor.pipeline(
                    codec_service.decode_key(self.spec, valid, targets),
                    width=self._decode_batch, qos=self._qos)
            except KeyError:  # ozlint: allow[error-swallowing] -- no mesh program for this spec: the single-device routes below take it
                pass
        if self.mesh is not None:
            return DeviceBatchPipeline(self._mesh_decode_fn(valid, targets))
        fn = make_fused_decoder(self.spec, valid, targets, device=self.device)
        svc = codec_service.maybe_service()
        if svc is not None:
            return codec_service.ServicePipeline(
                svc, codec_service.decode_key(self.spec, valid, targets),
                fn, width=self._decode_batch, qos=self._qos)
        return DeviceBatchPipeline(fn)

    def _mesh_decode_fn(self, valid: list[int], targets: list[int]):
        """The decode over the reader's mesh: DP splits the stripe batch
        over the slots, the ring splits the survivors (each slot fronting
        one group of source datanodes)."""
        from ozone_tpu_torch.parallel import sharded

        if self.use_ring:
            return sharded.make_ring_decoder(self.spec, valid, targets, self.mesh)
        inner = sharded.make_sharded_decoder(self.spec, valid, targets, self.mesh)
        n = self.mesh.devices.size

        def fn(batch):
            padded, orig = sharded.pad_batch(batch, n)
            rec, crcs = inner(padded)
            return rec[:orig], crcs[:orig]

        return fn

    # ---------------------------------------------------------------- ranged
    def read(self, offset: int, length: int) -> np.ndarray:
        """Cell-granular range read in user-byte space: only the stripes
        covering [offset, offset+length) are fetched, and on degraded
        groups only those are reconstructed. Units that fail mid-read are
        excluded and the read retried."""
        if offset < 0 or length < 0 or \
                offset + length > self.group.length:
            raise ValueError("range out of bounds")
        out = np.empty(length, dtype=np.uint8)
        if length == 0:
            return out
        # refresh per call (see recover_cells_iter)
        self._deadline = resilience.current()
        with Tracer.instance().span("ec:read", offset=offset, bytes=length):
            return self._read_traced(out, offset, length)

    def _read_traced(self, out: np.ndarray, offset: int,
                     length: int) -> np.ndarray:
        try:
            # p hard failures plus straggler hedges both take attempts
            for _ in range(2 * self.p + 1):
                avail = set(self.available_units())
                missing_data = [u for u in range(self.k) if u not in avail]
                try:
                    self._read_range_into(out, offset, length, missing_data)
                    return out
                except _UnitReadError as e:
                    log.warning("unit %d failed (%s); excluding and "
                                "retrying", e.unit, e.cause)
                    self._failed.add(e.unit)
                except _StragglerHedge:  # ozlint: allow[error-swallowing] -- a hedged straggler was excluded and counted by the recovery layer; the retry reconstructs it
                    # already excluded and counted by the recovery layer:
                    # the retry reconstructs them with the rest in one pass
                    pass
            raise InsufficientLocationsError(
                f"read failed; failed units {sorted(self._failed)}"
            )
        finally:
            self._close_pool()


def unit_true_lengths(group: BlockGroup, options: CoderOptions) -> list[int]:
    """True byte length of every unit's block: data blocks their striped
    lengths, parity blocks full cells per stripe."""
    k, p, cell = options.data_units, options.parity_units, options.cell_size
    num_stripes = -(-group.length // (k * cell))
    data = block_lengths(group.length, k, cell)
    return data + [num_stripes * cell] * p
