"""Shared codec service: cross-request continuous batching for the card.

Port of `ozone_tpu/codec/service.py`, the route the writer, the reader
and offline reconstruction take by default. Many small concurrent PUTs
and GETs each fill far less than a stripe batch; a per-process,
thread-safe `CodecService` owns the device and runs a dispatcher thread
that drains a submission queue of stripe work (encode, decode, re-encode)
from any concurrent operation, packs same-shape stripes into
constant-width batches (zero-padded tail), keeps one batch in flight
while the next is packed and launched, and completes per-submitter
futures as results land.

Policy:

- **Deadline-aware flush**: a submitter's ambient `resilience.Deadline`
  nearing expiry forces a partial batch instead of waiting for fill.
- **Max linger** (``OZONE_TPU_CODEC_LINGER_MS``): a submission that
  cannot fill its lane's width dispatches, zero-padded, after at most
  the linger.
- **Weighted fair scheduling** (``OZONE_TPU_CODEC_QOS``): per-class
  weights over a virtual clock, with an activation floor for a class
  returning from idle, so a bulk sweep cannot starve interactive work;
  a queue head older than ``OZONE_TPU_CODEC_STARVE_MS`` preempts
  fairness outright.

Lanes: submissions coalesce per (semantic key, batch width, QoS class).
The key carries the fused spec and, for decode, the erasure pattern
(different recovery matrices cannot share one launch). A lane exists
only while it has queued stripes and binds the fused callable of its
first submitter. A callable that is not the device path's (the host twin
of `codec/fused.py`, whose `backend` is `fused.HOST_TWIN`) puts it at the
end of the key (`backend_key`), so a twin writer and a device writer of
one spec never share a lane; the device path's keys are the reference's.

The device edge is `codec/pipeline.py`'s: a packed batch is staged in a
fresh `host_buffer` (pinned when the submitters' stripes are), a lone
submission that fills the whole width goes in as the submitter's own
tensor, and each dispatch's outputs come back through `start_pull` /
`finish_pull`. Futures resolve to tuples of numpy arrays, CRC words as
uint32. A lane function that raises fails its submitters' futures;
nothing retries elsewhere, and a dispatcher that dies fails all pending
work.

Tracing: the dispatcher thread's steps are spans that tile it, each
starting where the one before it ended: `codec:pack` (spill collection,
lane pick, packing, fairness accounting), `codec:stage`, `codec:launch`
(the copy in and the kernel launch), `codec:pull_start`,
`codec:pull_wait` (`finish_pull`), `codec:resolve` (slicing, the
submitters' spans, their futures) and `codec:idle_wait` (nothing ready
and nothing in flight). A dispatch's steps are children of its
`codec:device_dispatch`, which runs from its `codec:stage` to the end of
its `codec:resolve`. `dispatch_host_seconds_total` sums the host steps
(pack, stage, launch, pull_start, resolve) and `pull_wait_seconds_total`
the waits on the copy back.

Spill (``OZONE_TPU_MESH_SPILL=1``, off by default): once the queue depth
crosses ``OZONE_TPU_MESH_SPILL_WATERMARK`` stripes, whole lanes none of
whose stripes has been dispatched move to the multi-device mesh executor
(`parallel/mesh_executor.py`), deepest first, until the depth is back
at the watermark; their futures resolve there (`mesh_spill_lanes`,
`mesh_spill_stripes`).

``OZONE_TPU_CODEC_SERVICE=0`` turns the service off; every caller then
keeps its per-operation route (`DeviceBatchPipeline` or a direct launch).
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any, Callable, Optional

import numpy as np
import torch

from ozone_tpu_torch.codec import fused_kernel
from ozone_tpu_torch.codec.pipeline import finish_pull, host_buffer, start_pull
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.config import env_float
from ozone_tpu_torch.utils.metrics import MetricsRegistry, registry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)

#: every service signal in one registry
METRICS: MetricsRegistry = registry("codec.service")
#: the dispatcher's host time (its steps but the pull waits and the idle
#: waits) and its time blocked on the copy back, in float seconds
_HOST_S = METRICS.counter("dispatch_host_seconds_total")
_PULL_WAIT_S = METRICS.counter("pull_wait_seconds_total")

#: default added-latency bound for a lone stripe waiting for co-batching
DEFAULT_LINGER_MS = 2.0
#: default starvation bound: a queue head older than this preempts the
#: weighted fair pick outright (and counts starvation_guard_trips)
DEFAULT_STARVE_MS = 250.0
#: default per-class QoS weights (OZONE_TPU_CODEC_QOS overrides, e.g.
#: "interactive=4,bulk=1"): interactive reads outweigh background sweeps
DEFAULT_QOS = {"interactive": 4.0, "bulk": 1.0}
#: seed for the dispatch-time EWMA before the first dispatch lands
_DISPATCH_EWMA_SEED_S = 0.005

_PINNED, _HOST = torch.device("cuda"), torch.device("cpu")


def enabled() -> bool:
    """The service switch (OZONE_TPU_CODEC_SERVICE=0 turns it off)."""
    return os.environ.get("OZONE_TPU_CODEC_SERVICE", "1") != "0"


def qos_weights() -> dict[str, float]:
    """Parse OZONE_TPU_CODEC_QOS ("cls=weight,cls=weight"); unknown
    classes default to weight 1, malformed entries are skipped."""
    out = dict(DEFAULT_QOS)
    raw = os.environ.get("OZONE_TPU_CODEC_QOS", "")
    for part in raw.split(","):
        if "=" not in part:
            continue
        cls, _, w = part.partition("=")
        try:
            out[cls.strip()] = max(1e-6, float(w))
        except ValueError:  # ozlint: allow[error-swallowing] -- malformed OZONE_TPU_CODEC_QOS entry: skipped, the defaults cover the class
            continue
    return out


def _ambient_deadline():
    """The submitter's operation deadline, if any (imported late: the
    codec layer stays importable without the client layer)."""
    from ozone_tpu_torch.client import resilience

    return resilience.current()


def _rows(stripes, off: int, take: int):
    """Rows [off, off + take) of a submission, contiguous, in its own
    type (a pinned tensor stays the same pinned memory)."""
    part = stripes[off:off + take]
    if isinstance(part, torch.Tensor):
        return part.contiguous()
    return np.ascontiguousarray(part)


class _Sub:
    """One submission: `n` same-shape stripes from one operation."""

    __slots__ = ("stripes", "n", "future", "cls", "deadline", "t_enq",
                 "t_enq_wall", "trace_ctx", "tail", "taken",
                 "pending_parts", "parts")

    def __init__(self, stripes, future: Future, cls: str, deadline,
                 tail: bool):
        self.stripes = stripes
        self.n = int(stripes.shape[0])
        self.future = future
        self.cls = cls
        self.deadline = deadline
        tracer = Tracer.instance()
        self.t_enq = time.monotonic()
        self.t_enq_wall = tracer.now()
        #: the submitter's trace context: the dispatcher runs on its own
        #: thread, so per-submission spans join the operation's trace
        #: explicitly
        self.trace_ctx = tracer.inject()
        self.tail = tail
        self.taken = 0          # stripes already packed into dispatches
        self.pending_parts = 0  # dispatched parts not yet completed
        self.parts: list[tuple] = []  # (offset, take, host outs tuple)

    def deadline_t(self) -> float:
        return self.deadline.t_end if self.deadline is not None else math.inf


class _Lane:
    """One coalescing lane: same semantic key, same stripe shape, same
    batch width, same QoS class (classes get separate lanes so a bulk
    submission queued ahead of an interactive one can never drag it down
    to bulk weight). FIFO of submissions with undispatched stripes."""

    __slots__ = ("lane_key", "fn", "width", "cls", "subs", "queued",
                 "min_deadline_t", "last_served")

    def __init__(self, lane_key: tuple, fn: Callable, width: int,
                 cls: str):
        self.lane_key = lane_key
        self.fn = fn
        self.width = max(1, int(width))
        self.cls = cls
        self.subs: deque[_Sub] = deque()  # ozlint: allow[bounded-queue] -- lane depth is governed by the weighted-fair scheduler's queue_depth gauge, which the admission SLO shedder watches; bounding here would drop accepted work
        self.queued = 0  # undispatched stripes across subs
        self.min_deadline_t = math.inf
        self.last_served = 0.0  # 0 = never dispatched from


class CodecService:
    """The per-process dispatcher owning fused device dispatches.

    `submit(key, fn, stripes, ...)` enqueues `[n, ...]` stripe work and
    returns a Future resolving to the tuple of numpy arrays `fn` produces
    for exactly those `n` stripes (sliced out of the batch along axis 0).
    Submissions sharing (key, width, qos) coalesce into one dispatch, and
    every batch is zero-padded to the lane width.
    """

    def __init__(self):
        self.linger_s = env_float("OZONE_TPU_CODEC_LINGER_MS",
                                  DEFAULT_LINGER_MS) / 1000.0
        self.starve_s = env_float("OZONE_TPU_CODEC_STARVE_MS",
                                  DEFAULT_STARVE_MS) / 1000.0
        self.weights = qos_weights()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._lanes: dict[tuple, _Lane] = {}
        self._vtime: dict[str, float] = {}
        #: system virtual clock: advances with the least virtual time
        #: among backlogged classes; a class returning from idle is
        #: floored to it on activation, so neither a stale low vtime nor
        #: a stale high one survives an idle period
        self._vclock = 0.0
        self._queued_cls: dict[str, int] = {}  # class -> queued subs
        #: dispatched batches not yet completed: at most two (depth-1
        #: double buffer)
        self._inflight: deque[tuple] = deque()  # ozlint: allow[bounded-queue] -- holds only batches already launched on the device: at most two (the double-buffered dispatch loop)
        self._dispatch_ewma_s = _DISPATCH_EWMA_SEED_S
        tracer = Tracer.instance()
        #: the dispatcher's own trace: its steps that belong to no
        #: dispatch (`codec:idle_wait`, a `codec:pack` that packed
        #: nothing) join it
        self._ctx = f"{tracer._new_id()}:{tracer._new_id()}"
        #: where the dispatcher's current step began (`Tracer.now()`), and
        #: the steps marked since the last hand-over to the tracer
        self._t = tracer.now()
        self._steps: list[tuple] = []
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="codec-service")
        self._thread.start()

    # ----------------------------------------------------------- submit
    def submit(self, key: tuple, fn: Callable, stripes, *, width: int,
               qos: str = "interactive", tail: bool = False,
               deadline=None) -> Future:
        """Enqueue `stripes` ([n, ...] with n >= 1, a numpy array or a
        host tensor) for the fused `fn`.

        `key` is the hashable coalescing identity (kind + spec +
        pattern); `width` the constant dispatch batch size of this
        submitter's shape family. `fn` is bound to the lane by its first
        submitter and dropped when the lane drains. `tail=True` marks a
        partial final flush: it rides the linger (waiting up to it to
        co-batch with other operations) and counts in tail_flushes. The
        ambient resilience deadline is captured when none is given.
        """
        if stripes.shape[0] < 1:
            raise ValueError("empty codec submission")
        if deadline is None:
            deadline = _ambient_deadline()
        fut: Future = Future()
        sub = _Sub(stripes, fut, qos, deadline, tail)
        lane_key = (backend_key(key, fn), width, qos)
        with self._cond:
            if not self._running:
                raise RuntimeError("codec service is shut down")
            lane = self._lanes.get(lane_key)
            if lane is None:
                lane = self._lanes[lane_key] = _Lane(lane_key, fn,
                                                     width, qos)
            if not self._queued_cls.get(qos):
                # activation floor: a class becoming backlogged joins at
                # the system virtual clock
                self._vtime[qos] = max(self._vtime.get(qos, 0.0),
                                       self._vclock)
            self._queued_cls[qos] = self._queued_cls.get(qos, 0) + 1
            lane.subs.append(sub)
            lane.queued += sub.n
            lane.min_deadline_t = min(lane.min_deadline_t,
                                      sub.deadline_t())
            METRICS.counter("submissions").inc()
            METRICS.gauge("queue_depth").set(self._queue_depth_locked())
            self._cond.notify()
        return fut

    # ------------------------------------------------------- scheduling
    def _queue_depth_locked(self) -> int:
        return sum(lane.queued for lane in self._lanes.values())

    def _flush_margin_s(self) -> float:
        """How far before a deadline a partial batch must flush: the
        linger plus headroom for the in-flight depth's dispatch time."""
        return self.linger_s + 4.0 * self._dispatch_ewma_s

    def _ready_reason(self, lane: _Lane, now: float) -> Optional[str]:
        if not lane.subs:
            return None
        if lane.queued >= lane.width:
            return "full"
        if lane.min_deadline_t - now <= self._flush_margin_s():
            return "deadline"
        if now - lane.subs[0].t_enq >= self.linger_s:
            return "linger"
        return None

    def _pick_lane_locked(self, now: float):
        """The next lane to dispatch: the ready lane whose head class has
        the least weighted service (weighted-fair virtual time), unless a
        starved lane preempts it. Among starved lanes the least recently
        served wins, so a deep backlog whose own head is always over-aged
        cannot take the guard back at once."""
        ready: list[tuple[_Lane, str]] = []
        for lane in self._lanes.values():
            reason = self._ready_reason(lane, now)
            if reason is not None:
                ready.append((lane, reason))
        if not ready:
            return None
        # advance the system virtual clock to the least backlogged
        # class's virtual time (it never goes backwards)
        self._vclock = max(self._vclock, min(
            self._vtime.get(lane.subs[0].cls, 0.0) for lane, _ in ready))

        def vkey(lr):
            lane, _ = lr
            cls = lane.subs[0].cls
            return (self._vtime.get(cls, 0.0), lane.subs[0].t_enq)

        fair = min(ready, key=vkey)
        starved = [(lane, r) for lane, r in ready
                   if now - lane.subs[0].t_enq >= self.starve_s]
        if starved:
            lane, reason = min(
                starved,
                key=lambda lr: (lr[0].last_served, lr[0].subs[0].t_enq))
            if lane is not fair[0]:
                # the guard overrode the weighted-fair choice
                METRICS.counter("starvation_guard_trips").inc()
            return lane, reason
        return fair

    def _next_wakeup_locked(self, now: float) -> Optional[float]:
        """Seconds until the earliest linger or deadline trigger."""
        t = math.inf
        margin = self._flush_margin_s()
        for lane in self._lanes.values():
            if not lane.subs:
                continue
            t = min(t, lane.subs[0].t_enq + self.linger_s,
                    lane.min_deadline_t - margin)
        return None if math.isinf(t) else max(0.0, t - now)

    def _pack_locked(self, lane: _Lane):
        """Take up to `width` stripes from the lane head, FIFO across
        submissions (the cross-request coalescing step)."""
        entries: list[tuple[_Sub, int, int, int]] = []
        lane.last_served = time.monotonic()
        row = 0
        while lane.subs and row < lane.width:
            sub = lane.subs[0]
            take = min(sub.n - sub.taken, lane.width - row)
            entries.append((sub, sub.taken, take, row))
            sub.taken += take
            sub.pending_parts += 1
            if sub.taken == sub.n:
                lane.subs.popleft()
                left = self._queued_cls.get(sub.cls, 1) - 1
                if left > 0:
                    self._queued_cls[sub.cls] = left
                else:
                    self._queued_cls.pop(sub.cls, None)
            row += take
            lane.queued -= take
        if not lane.subs:
            # ephemeral lanes: drop the fn binding once drained
            self._lanes.pop(lane.lane_key, None)
            lane.min_deadline_t = math.inf
        else:
            lane.min_deadline_t = min(s.deadline_t() for s in lane.subs)
        return entries, row

    # ------------------------------------------------------------ spill
    def _collect_spill_locked(self) -> list[tuple]:
        """Whole-lane overflow to the mesh executor: past the spill
        watermark, pop entire lanes whose submissions are all untouched (a
        spilled future must be served wholly by one executor), deepest
        first, keeping the watermark's worth of work here so this device
        stays fed while the overflow drains on the others."""
        from ozone_tpu_torch.parallel import mesh_executor

        if not mesh_executor.spill_enabled():
            return []
        depth = self._queue_depth_locked()
        watermark = mesh_executor.spill_watermark()
        if depth <= watermark:
            return []
        mex = mesh_executor.maybe_executor()
        if mex is None:
            return []
        spilled: list[tuple] = []
        for lane in sorted(self._lanes.values(), key=lambda ln: -ln.queued):
            if depth <= watermark:
                break
            if not lane.subs or any(s.taken for s in lane.subs):
                continue
            key = lane.lane_key[0]
            ok = mex.accepts_cached(key)
            if ok is not True:
                if ok is None:
                    # unknown key: resolve it outside the lock, and spill
                    # on a later pass
                    spilled.append((mex, key, None))
                continue
            self._lanes.pop(lane.lane_key, None)
            for sub in lane.subs:
                left = self._queued_cls.get(sub.cls, 1) - 1
                if left > 0:
                    self._queued_cls[sub.cls] = left
                else:
                    self._queued_cls.pop(sub.cls, None)
            depth -= lane.queued
            spilled.append((mex, key, lane))
        real = [s for s in spilled if s[2] is not None]
        if real:
            METRICS.counter("mesh_spill_lanes").inc(len(real))
            METRICS.counter("mesh_spill_stripes").inc(
                sum(lane.queued for _, _, lane in real))
            METRICS.gauge("queue_depth").set(depth)
        return spilled

    @staticmethod
    def _spill(spilled: list[tuple]) -> None:
        """Hand popped lanes to the mesh executor, outside the service
        lock. Entries with no lane resolve keys the peek did not know."""
        for mex, key, lane in spilled:
            if lane is None:
                try:
                    mex.accepts(key)
                except Exception:  # the lane stays queued here
                    log.exception("mesh program for %r could not be built", key)
                continue
            _, width, qos = lane.lane_key
            try:
                mex.absorb(key, width, qos, list(lane.subs))
            except BaseException as e:  # spill must never strand futures
                log.exception("mesh spill failed for %r", key)
                for sub in lane.subs:
                    if not sub.future.done():
                        sub.future.set_exception(e)

    # ------------------------------------------------------- dispatcher
    def _mark(self, name: str, ctx: str, **tags) -> float:
        """Close the dispatcher's current step as a span `name` under
        `ctx`, from the end of the step before it to now: the steps tile
        the dispatcher thread. Returns the step's seconds."""
        t0, self._t = self._t, Tracer.now()
        self._steps.append((ctx, name, t0, self._t, tags))
        return self._t - t0

    def _flush_steps(self) -> None:
        """Hand the marked steps to the tracer, in one pass."""
        if self._steps:
            steps, self._steps = self._steps, []
            Tracer.instance().record_spans(steps)

    def _poll(self) -> None:
        """A pass of the loop that packed nothing: its host time is a
        `codec:pack` of the dispatcher's own trace."""
        _HOST_S.inc(self._mark("codec:pack", self._ctx, rows=0))

    def _loop(self) -> None:
        try:
            while True:
                entries = None
                with self._cond:
                    now = time.monotonic()
                    spilled = self._collect_spill_locked()
                    picked = self._pick_lane_locked(now)
                    if picked is not None:
                        lane, reason = picked
                        entries, rows = self._pack_locked(lane)
                    elif not self._inflight and not spilled:
                        if not self._running:
                            if not self._lanes:
                                break
                            # closing with queued but untriggered work:
                            # flush it rather than strand the futures
                            lane = next(iter(self._lanes.values()))
                            reason = "linger"
                            entries, rows = self._pack_locked(lane)
                        else:
                            self._poll()
                            self._flush_steps()
                            self._cond.wait(self._next_wakeup_locked(now))
                            self._mark("codec:idle_wait", self._ctx)
                            continue
                if spilled:
                    # outside the lock: submitters keep flowing
                    self._spill(spilled)
                if entries is not None:
                    self._dispatch(lane, entries, rows, reason)
                    # depth-1 double buffer: keep one older batch in
                    # flight; complete it only once the next dispatch is
                    # on the device
                    if len(self._inflight) > 1:
                        self._complete(self._inflight.popleft())
                else:
                    self._poll()
                    if self._inflight:
                        # nothing packable right now: never hold results
                        # hostage waiting for more work
                        self._complete(self._inflight.popleft())
        except BaseException:
            log.exception("codec service dispatcher crashed")
            raise
        finally:
            # a dead dispatcher reads as not running: submit() rejects
            # instead of queueing into a drain nobody runs, and
            # get_service() hands out a fresh service
            with self._lock:
                self._running = False
            self._flush_steps()
            self._fail_pending(RuntimeError("codec service stopped"))

    def _stage(self, lane: _Lane, entries, rows: int):
        """The batch `lane.fn` gets: a lone submission covering the whole
        width goes in as its own rows (no staging copy, the pinned tensor
        of a writer or reader stays pinned); otherwise the parts are
        packed into a fresh zero-padded buffer, a `host_buffer` (pinned
        when the head's stripes are) for tensor submitters and a numpy
        array for numpy ones."""
        head = entries[0]
        if len(entries) == 1 and head[2] == rows == lane.width:
            sub, off, take, _ = head
            return _rows(sub.stripes, off, take)
        src = head[0].stripes
        shape = (lane.width,) + tuple(src.shape[1:])
        if isinstance(src, torch.Tensor):
            batch = host_buffer(shape, _PINNED if src.is_pinned() else _HOST)
            dst = batch.numpy()
        else:
            batch = dst = np.empty(shape, dtype=src.dtype)
        for sub, off, take, row in entries:
            dst[row:row + take] = np.asarray(sub.stripes[off:off + take])
        dst[rows:] = 0
        return batch

    def _dispatch(self, lane: _Lane, entries, rows: int,
                  reason: str) -> None:
        """Stage, launch and start the copy back of one packed batch. Its
        steps (`codec:pack` since the loop's last step, `codec:stage`,
        `codec:launch`, `codec:pull_start`) are children of the dispatch's
        own `codec:device_dispatch`, which `_complete` records from the
        start of `codec:stage` to the end of `codec:resolve`."""
        now = time.monotonic()
        ops = len(entries)
        tracer = Tracer.instance()
        t_now = tracer.now()
        # one shared dispatch span id per device dispatch: every
        # coalesced submission's span tags it
        d_tid, d_sid = tracer._new_id(), tracer._new_id()
        ctx = f"{d_tid}:{d_sid}"
        fill_pct = round(100.0 * rows / lane.width, 1)
        lane_desc = str(lane.lane_key)[:120]
        with self._lock:
            # fairness accounting under the lock: submit()'s activation
            # floor does a read-modify-write of the same entries
            for sub, off, take, _row in entries:
                w = self.weights.get(sub.cls, 1.0)
                self._vtime[sub.cls] = \
                    self._vtime.get(sub.cls, 0.0) + take / w
        for sub, off, take, _row in entries:
            if off == 0:
                wait = now - sub.t_enq
                tid = sub.trace_ctx.split(":", 1)[0]
                METRICS.histogram("queue_wait_seconds").observe(wait, tid)
                METRICS.histogram(
                    f"queue_wait_{sub.cls}_seconds").observe(wait, tid)
                if sub.trace_ctx:
                    tracer.record_span(
                        "codec:queue_wait", child_of=sub.trace_ctx,
                        start=sub.t_enq_wall,
                        duration=t_now - sub.t_enq_wall,
                        lane=lane_desc, qos=sub.cls, fill_pct=fill_pct,
                        dispatch_span=d_sid)
                if sub.tail:
                    METRICS.counter("tail_flushes").inc()
        # the dispatch is counted with its launch, in the launch counter's
        # critical section: a reader of both never sees one without the
        # other; `dispatches_<kind>` splits it by form (encode, decode,
        # reencode) for a process that runs several
        key = lane.lane_key[0]
        kind = key[0] if isinstance(key, tuple) and key else "other"

        def tally():
            METRICS.counter("dispatches").inc()
            METRICS.counter(f"dispatches_{kind}").inc()

        host_s = self._mark("codec:pack", ctx, rows=rows)
        # the stage's start on the tracer's clock, for the spans, and on
        # the monotonic one, for the scheduling EWMA and the histogram
        t_stage, m_stage = self._t, time.monotonic()
        step = "codec:stage"
        try:
            with fused_kernel.launches.tallied(tally):
                batch = self._stage(lane, entries, rows)
                host_s += self._mark(step, ctx)
                step = "codec:launch"
                outs = lane.fn(batch)
                if not isinstance(outs, tuple):
                    outs = (outs,)
                host_s += self._mark(step, ctx,
                                     launch=fused_kernel.launches.total,
                                     h2d_bytes=batch.nbytes)
                # the copy back starts now, under the next batch's packing
                step = "codec:pull_start"
                pulled = start_pull(outs)
                host_s += self._mark(step, ctx, d2h_bytes=sum(
                    h.nbytes for h in pulled[0]))
        except Exception as e:  # a fault of this dispatch: its submitters'
            host_s += self._mark(step, ctx, error=type(e).__name__)
            self._resolve_error(entries, e)
            self._close_dispatch(ctx, t_stage, host_s,
                                 error=type(e).__name__)
            return
        METRICS.counter("stripes_dispatched").inc(rows)
        METRICS.counter("slots_dispatched").inc(lane.width)
        METRICS.counter("coalesced_operations").inc(ops)
        if ops > 1:
            METRICS.counter("multi_op_dispatches").inc()
        if reason == "linger":
            METRICS.counter("forced_flushes").inc()
        elif reason == "deadline":
            METRICS.counter("deadline_flushes").inc()
        METRICS.gauge("batch_fill_pct").set(100.0 * rows / lane.width)
        with self._lock:
            METRICS.gauge("queue_depth").set(self._queue_depth_locked())
        self._inflight.append((entries, pulled, t_stage, m_stage, host_s,
                               (ctx, fill_pct, reason, lane_desc, ops,
                                rows, lane.width)))

    def _close_dispatch(self, ctx: str, t_stage: float, host_s: float,
                        **tags) -> None:
        """End a dispatch's `codec:resolve`, count its host seconds and
        record its `codec:device_dispatch`, from the start of
        `codec:stage`."""
        _HOST_S.inc(host_s + self._mark("codec:resolve", ctx))
        self._flush_steps()
        d_tid, d_sid = ctx.split(":")
        Tracer.instance().record_span(
            "codec:device_dispatch", child_of=f"{d_tid}:", span_id=d_sid,
            start=t_stage, duration=self._t - t_stage, **tags)

    def _complete(self, rec: tuple) -> None:
        entries, pulled, t_stage, m_stage, host_s, dctx = rec
        ctx, fill_pct, reason, lane_desc, ops, rows, width = dctx
        try:
            host = finish_pull(pulled)
        except Exception as e:  # a fault of the copy back: its submitters'
            _PULL_WAIT_S.inc(self._mark("codec:pull_wait", ctx,
                                        error=type(e).__name__))
            self._resolve_error(entries, e)
            self._close_dispatch(ctx, t_stage, host_s,
                                 error=type(e).__name__)
            return
        _PULL_WAIT_S.inc(self._mark("codec:pull_wait", ctx))
        t_pulled, dt = self._t, time.monotonic() - m_stage
        self._dispatch_ewma_s += 0.2 * (dt - self._dispatch_ewma_s)
        METRICS.histogram("dispatch_seconds").observe(
            dt, entries[0][0].trace_ctx.split(":", 1)[0])
        tracer = Tracer.instance()
        d_tid, d_sid = ctx.split(":")
        for sub, off, take, _row in entries:
            # per-submission dispatch span in the submitter's trace,
            # carrying the shared span id
            if sub.trace_ctx:
                tracer.record_span(
                    "codec:dispatch", child_of=sub.trace_ctx,
                    start=t_stage, duration=t_pulled - t_stage,
                    lane=lane_desc, qos=sub.cls, stripes=take,
                    fill_pct=fill_pct,
                    dispatch_span=d_sid, dispatch_trace=d_tid)
        for sub, off, take, row in entries:
            sub.parts.append(
                (off, take, tuple(a[row:row + take] for a in host)))
            sub.pending_parts -= 1
            if sub.taken == sub.n and sub.pending_parts == 0:
                self._resolve(sub)
        self._close_dispatch(ctx, t_stage, host_s, lane=lane_desc, ops=ops,
                             rows=rows, width=width, fill_pct=fill_pct,
                             reason=reason)

    @staticmethod
    def _resolve(sub: _Sub) -> None:
        if sub.future.done():
            # an earlier part of this split submission already failed
            # the future; later parts complete harmlessly
            return
        if len(sub.parts) == 1:
            sub.future.set_result(sub.parts[0][2])
            return
        sub.parts.sort(key=lambda p: p[0])
        outs = tuple(
            np.concatenate([p[2][i] for p in sub.parts], axis=0)
            for i in range(len(sub.parts[0][2])))
        sub.future.set_result(outs)

    @staticmethod
    def _resolve_error(entries, e: BaseException) -> None:
        done = set()
        for sub, _off, _take, _row in entries:
            if id(sub) not in done:
                done.add(id(sub))
                if not sub.future.done():
                    sub.future.set_exception(e)

    def _fail_pending(self, e: BaseException) -> None:
        with self._lock:
            subs = [s for lane in self._lanes.values() for s in lane.subs]
            self._lanes.clear()
            self._queued_cls.clear()
            inflight, self._inflight = list(self._inflight), deque()  # ozlint: allow[bounded-queue] -- drain and reset of the bounded in-flight deque above, not a new queue
        for rec in inflight:
            for sub, _o, _t, _r in rec[0]:
                subs.append(sub)
        for s in subs:
            if not s.future.done():
                s.future.set_exception(e)

    # ---------------------------------------------------------- control
    def stats(self) -> dict:
        """Operator snapshot: the service's metrics plus fill ratio,
        operations per dispatch, queue depth and the knobs."""
        snap = METRICS.snapshot()
        slots = snap.get("slots_dispatched", 0)
        disp = snap.get("dispatches", 0)
        snap["fill_ratio"] = (snap.get("stripes_dispatched", 0) / slots
                              if slots else 0.0)
        snap["ops_per_dispatch"] = (
            snap.get("coalesced_operations", 0) / disp if disp else 0.0)
        with self._lock:
            snap["queue_depth"] = self._queue_depth_locked()
            snap["lanes"] = len(self._lanes)
            snap["inflight"] = len(self._inflight)
        snap["linger_ms"] = self.linger_s * 1000.0
        snap["weights"] = dict(self.weights)
        snap["enabled"] = enabled()
        return snap

    def close(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout=self._flush_margin_s() * 64)
        self._fail_pending(RuntimeError("codec service shut down"))


_service: Optional[CodecService] = None
_service_lock = threading.Lock()


def get_service() -> CodecService:
    """The process-wide service (created on first use)."""
    global _service
    with _service_lock:
        if _service is None or not _service._running:
            _service = CodecService()
        return _service


def maybe_service() -> Optional[CodecService]:
    """The service, or None when it is off: the one check every caller
    makes before choosing its per-operation route."""
    return get_service() if enabled() else None


def reset_for_tests() -> None:
    """Shut down and drop the singleton (fresh knobs per test)."""
    global _service
    with _service_lock:
        svc, _service = _service, None
    if svc is not None:
        svc.close()


# ------------------------------------------------------------- plan keys
def encode_key(spec) -> tuple:
    return ("encode", spec)


def decode_key(spec, valid, erased) -> tuple:
    return ("decode", spec, tuple(valid), tuple(erased))


def reencode_key(spec, lost: int) -> tuple:
    return ("reencode", spec, int(lost))


def backend_key(key: tuple, fn: Callable) -> tuple:
    """`key` as the lane of `fn`: unchanged for the device path, with the
    function's `backend` appended otherwise (`fused.HOST_TWIN` for the
    host twin)."""
    backend = getattr(fn, "backend", None)
    return key if backend is None else key + (backend,)


def wait_result(fut: Future, grace_s: Optional[float] = None):
    """Block on a codec future with deadline-aware patience: the wait
    allows the remaining operation budget plus the service's flush
    margin, since a near-expiry submission is being force-flushed and
    its result is on the way."""
    from ozone_tpu_torch.client import resilience

    d = resilience.current()
    if d is None:
        return fut.result()
    if grace_s is None:
        svc = _service
        grace_s = (svc._flush_margin_s() if svc is not None else 0.0) \
            + 16.0 * _DISPATCH_EWMA_SEED_S
    left = d.remaining()
    try:
        return fut.result(timeout=max(0.0, left) + grace_s)
    except _FutTimeout:
        METRICS.counter("wait_deadline_exceeded").inc()
        raise StorageError(
            "DEADLINE_EXCEEDED",
            f"operation {d.op} deadline exceeded waiting for the codec "
            f"service") from None


class ServicePipeline:
    """Twin of `codec.pipeline.DeviceBatchPipeline` backed by the shared
    service: submit(batch, ctx) routes the batch through the coalescing
    dispatcher and returns the previous submission's (ctx, host outs),
    so every depth-1 pipeline consumer keeps its overlap and gains
    cross-request batching."""

    def __init__(self, svc: CodecService, key: tuple, fn: Callable,
                 width: int, qos: str = "interactive"):
        self._svc = svc
        self._key = key
        self._fn = fn
        self._width = max(1, int(width))
        self._qos = qos
        self._pending: Optional[tuple] = None

    def submit(self, batch, ctx: Any = None,
               tail: bool = False) -> Optional[tuple]:
        fut = self._svc.submit(self._key, self._fn, batch,
                               width=self._width, qos=self._qos,
                               tail=tail)
        prev, self._pending = self._pending, (ctx, fut)
        return self._to_host(prev)

    def drain(self) -> Optional[tuple]:
        prev, self._pending = self._pending, None
        return self._to_host(prev)

    @staticmethod
    def _to_host(entry: Optional[tuple]) -> Optional[tuple]:
        if entry is None:
            return None
        ctx, fut = entry
        return ctx, wait_result(fut)
