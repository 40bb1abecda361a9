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
first submitter.

The device edge is `codec/pipeline.py`'s: a packed batch is staged in a
fresh `host_buffer` (pinned when the submitters' stripes are), a lone
submission that fills the whole width goes in as the submitter's own
tensor, and each dispatch's outputs come back through `start_pull` /
`finish_pull`. Futures resolve to tuples of numpy arrays, CRC words as
uint32. A lane function that raises fails its submitters' futures;
nothing retries elsewhere, and a dispatcher that dies fails all pending
work. The reference's spill of whole lanes to a multi-device mesh
executor is not ported: it waits for the port's multi-device slice.

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

from ozone_tpu_torch.codec.pipeline import finish_pull, host_buffer, start_pull
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.config import env_float
from ozone_tpu_torch.utils.metrics import MetricsRegistry, registry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)

#: every service signal in one registry
METRICS: MetricsRegistry = registry("codec.service")

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
        except ValueError:
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
        self.t_enq = time.monotonic()
        self.t_enq_wall = time.time()
        #: the submitter's trace context: the dispatcher runs on its own
        #: thread, so per-submission spans join the operation's trace
        #: explicitly
        self.trace_ctx = Tracer.instance().inject()
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
        self.subs: deque[_Sub] = deque()
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
        self._inflight: deque[tuple] = deque()
        self._dispatch_ewma_s = _DISPATCH_EWMA_SEED_S
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
        lane_key = (key, width, qos)
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

    # ------------------------------------------------------- dispatcher
    def _loop(self) -> None:
        try:
            while True:
                entries = None
                with self._cond:
                    now = time.monotonic()
                    picked = self._pick_lane_locked(now)
                    if picked is not None:
                        lane, reason = picked
                        entries, rows = self._pack_locked(lane)
                    elif not self._inflight:
                        if not self._running:
                            if not self._lanes:
                                break
                            # closing with queued but untriggered work:
                            # flush it rather than strand the futures
                            lane = next(iter(self._lanes.values()))
                            reason = "linger"
                            entries, rows = self._pack_locked(lane)
                        else:
                            self._cond.wait(self._next_wakeup_locked(now))
                            continue
                if entries is not None:
                    self._dispatch(lane, entries, rows, reason)
                    # depth-1 double buffer: keep one older batch in
                    # flight; complete it only once the next dispatch is
                    # on the device
                    if len(self._inflight) > 1:
                        self._complete(self._inflight.popleft())
                elif self._inflight:
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
        now = time.monotonic()
        ops = len(entries)
        tracer = Tracer.instance()
        # one shared dispatch span id per device dispatch: every
        # coalesced submission's span tags it
        d_tid, d_sid = tracer._new_id(), tracer._new_id()
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
                        start=sub.t_enq_wall, duration=wait,
                        lane=lane_desc, qos=sub.cls, fill_pct=fill_pct,
                        dispatch_span=d_sid)
                if sub.tail:
                    METRICS.counter("tail_flushes").inc()
        t0 = time.monotonic()
        try:
            outs = lane.fn(self._stage(lane, entries, rows))
            if not isinstance(outs, tuple):
                outs = (outs,)
            # the copy back starts now, under the next batch's packing
            pulled = start_pull(outs)
        except Exception as e:  # a fault of this dispatch: its submitters'
            self._resolve_error(entries, e)
            return
        METRICS.counter("dispatches").inc()
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
        METRICS.gauge("last_coalesced_operations").set(ops)
        with self._lock:
            METRICS.gauge("queue_depth").set(self._queue_depth_locked())
        self._inflight.append((entries, pulled, t0, time.time(),
                               (d_tid, d_sid, fill_pct, reason,
                                lane_desc, ops, rows, lane.width)))

    def _complete(self, rec: tuple) -> None:
        entries, pulled, t0, t0_wall, dctx = rec
        d_tid, d_sid, fill_pct, reason, lane_desc, ops, rows, width = dctx
        try:
            host = finish_pull(pulled)
        except Exception as e:  # a fault of the copy back: its submitters'
            self._resolve_error(entries, e)
            return
        dt = time.monotonic() - t0
        self._dispatch_ewma_s += 0.2 * (dt - self._dispatch_ewma_s)
        METRICS.histogram("dispatch_seconds").observe(
            dt, entries[0][0].trace_ctx.split(":", 1)[0])
        tracer = Tracer.instance()
        # the shared dispatch span (own trace, id known to every rider)
        tracer.record_span(
            "codec:device_dispatch", child_of=f"{d_tid}:",
            span_id=d_sid, start=t0_wall, duration=dt,
            lane=lane_desc, ops=ops, rows=rows, width=width,
            fill_pct=fill_pct, reason=reason)
        for sub, off, take, _row in entries:
            # per-submission dispatch span in the submitter's trace,
            # carrying the shared span id
            if sub.trace_ctx:
                tracer.record_span(
                    "codec:dispatch", child_of=sub.trace_ctx,
                    start=t0_wall, duration=dt, lane=lane_desc,
                    qos=sub.cls, stripes=take, fill_pct=fill_pct,
                    dispatch_span=d_sid, dispatch_trace=d_tid)
        for sub, off, take, row in entries:
            sub.parts.append(
                (off, take, tuple(a[row:row + take] for a in host)))
            sub.pending_parts -= 1
            if sub.taken == sub.n and sub.pending_parts == 0:
                self._resolve(sub)

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
            inflight, self._inflight = list(self._inflight), deque()
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
