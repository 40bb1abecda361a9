"""Persistent mesh executor: the multi-device datapath, kept fed.

Port of `ozone_tpu/parallel/mesh_executor.py`. It gives the mesh the
treatment `DeviceBatchPipeline` and `CodecService` give one device:

- **Long-lived programs**, one per codec-service semantic key (fused
  spec, erasure pattern), resolved once per key through
  `parallel/sharded.py`'s plan caches: a new erasure pattern builds a
  small per-device matrix, never a kernel.
- **Reused host staging buffers**: every dispatch that packs several
  submissions packs into a pooled buffer of the lane's constant shape
  (pinned on a CUDA mesh, so the copies to the slots run
  asynchronously); the pool keeps depth+1 buffers per shape, the working
  set of the in-flight window.
- **Depth-N in-flight batches** (``OZONE_TPU_MESH_DEPTH``, default 2):
  the dispatcher launches batch N+1 while batches N..N-depth+1 are still
  on the devices. Each dispatch's outputs start their copy back to
  pinned host memory at once, with a CUDA event recorded on the stream
  of the device that holds them, and are harvested once that event has
  fired; the submitter is never blocked by a harvest.
- **A submission queue mirroring `codec/service.py`'s lanes**:
  concurrent operations submit stripes under the same keys (`encode_key`,
  `decode_key`), and the dispatcher coalesces them into full-width mesh
  dispatches (per-slot batch x mesh size), so a reconstruction storm
  over many containers becomes a few wide dispatches.

Spill: with ``OZONE_TPU_MESH_SPILL=1`` (off by default) the shared codec
service hands whole untouched lanes here once its queue depth crosses
``OZONE_TPU_MESH_SPILL_WATERMARK`` (`codec/service.py`,
`_collect_spill_locked`).

Backend policy mirrors `codec/fused.py`: where it takes the host twin
for a key's spec and transfer shape (``OZONE_TPU_FUSED_BACKEND=native``,
or ``auto`` on CPU slots or behind a slow link), the key's program is the
twin sharded over one worker thread per slot, each coding its contiguous
rows of the batch; so is a key the codec service tagged as the twin's
(ending in `fused.HOST_TWIN`: a spilled twin lane). Otherwise, and always
with the knob unset, it is the sharded device program.
`stats()["programs_host_twin"]` counts the twin programs.

Two departures from the reference, each on purpose:

- `maybe_executor()` answers None only when the executor is off, or
  when none is installed and fewer than two CUDA devices are attached.
  A failure to build the mesh raises, as does a failure to build a
  program for a key that has one: neither is swallowed into the
  single-device path.
- A program's failure fails the futures of its dispatch, as in the
  reference.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np
import torch

from ozone_tpu_torch.codec import fused
from ozone_tpu_torch.codec.fused import FusedSpec
from ozone_tpu_torch.codec.pipeline import D2H_BYTES
from ozone_tpu_torch.parallel import sharded
from ozone_tpu_torch.utils.config import env_float, env_int
from ozone_tpu_torch.utils.metrics import MetricsRegistry, registry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)

#: every mesh-executor signal in one registry (prometheus: mesh_*)
METRICS: MetricsRegistry = registry("mesh")
#: the registry's signals, each named by `stats()` (Recon's /api/mesh) at
#: 0 until it moves, whatever this process ran before: counters and
#: gauges, and the histograms' mean and percentiles
_SIGNALS = ("submissions", "dispatches", "stripes_dispatched",
            "slots_dispatched", "coalesced_operations", "multi_op_dispatches",
            "staging_reuses", "spilled_lanes", "spilled_stripes", "devices",
            "depth", "queue_depth", "batch_fill_pct", "inflight_depth",
            "inflight_per_device", "max_inflight_depth") + tuple(
    f"{h}_{q}_s" for h in ("queue_wait_seconds", "dispatch_seconds")
    for q in ("mean", "p50", "p95", "p99"))

#: in-flight mesh batches (double buffering = 2)
DEFAULT_DEPTH = 2
#: a single mesh dispatch never packs more stripe slots than this, whatever
#: the mesh size: bounds the staged memory ([256, k, cell])
MAX_DISPATCH_WIDTH = 256
#: added-latency bound for a partial mesh batch waiting for co-batching
DEFAULT_LINGER_MS = 2.0


def mesh_depth() -> int:
    """The in-flight depth knob (OZONE_TPU_MESH_DEPTH, min 1)."""
    return max(1, env_int("OZONE_TPU_MESH_DEPTH", DEFAULT_DEPTH))


def enabled() -> bool:
    """The executor switch (OZONE_TPU_MESH=0 turns it off)."""
    return os.environ.get("OZONE_TPU_MESH", "1") != "0"


def spill_enabled() -> bool:
    """Codec-service overflow spill onto the mesh (OZONE_TPU_MESH_SPILL=1;
    off by default: spilling helps only when the other devices are
    otherwise idle, and moves interactive work onto a path tuned for
    throughput)."""
    return os.environ.get("OZONE_TPU_MESH_SPILL", "0") in (
        "1", "true", "yes", "on")


def spill_watermark() -> int:
    """Queue depth (stripes) past which the codec service starts handing
    whole lanes to the mesh (OZONE_TPU_MESH_SPILL_WATERMARK)."""
    return max(1, env_int("OZONE_TPU_MESH_SPILL_WATERMARK", 64))


def _ambient_deadline():
    from ozone_tpu_torch.client import resilience

    return resilience.current()


def _rows(x) -> np.ndarray:
    """A submission's stripes as a numpy view (host tensors share memory)."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _contiguous(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_contiguous()
    return x.flags.c_contiguous


def _start_pull(outs: tuple) -> tuple:
    """Start each output's copy to pinned host memory on the current
    stream of the device that holds it, and record an event there. The
    tensors count in the edge's `d2h_bytes` (`codec/pipeline.py`)."""
    D2H_BYTES.inc(sum(t.nbytes for t in outs if isinstance(t, torch.Tensor)))
    pulls = []
    for t in outs:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            pulls.append((t, None))
            continue
        with torch.cuda.device(t.device):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        pulls.append((host, done))
    return tuple(pulls)


def _finish_pull(pulls: tuple) -> tuple:
    """The outputs as numpy arrays once each one's event has fired; int32
    outputs are CRC words and come back as uint32 bit patterns."""
    out = []
    for h, done in pulls:
        if done is not None:
            done.synchronize()
        if isinstance(h, torch.Tensor):
            h = h.numpy().view(np.uint32) if h.dtype == torch.int32 else h.numpy()
        out.append(np.asarray(h))
    return tuple(out)


class _MeshProgram:
    """One resolved, long-lived mesh program for a semantic key.

    `fn(batch [W, ...]) -> tuple of outputs`, W any multiple of the mesh
    size up to the dispatch width. `caches` lists the plan caches the
    program builds its per-device matrices in; their size is the census
    the warm-program probe reads (`compile_count`); a host-twin program
    (`host_twin`) builds none."""

    __slots__ = ("fn", "caches", "host_twin")

    def __init__(self, fn: Callable, caches: tuple = (), host_twin: bool = False):
        self.fn = fn
        self.caches = caches
        self.host_twin = host_twin

    def compile_count(self) -> int:
        """Per-device plans built across this program's caches; steady-
        state dispatches must not move it."""
        return sum(c.cache_info().currsize for c in self.caches)


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
        self.t_enq_wall = Tracer.now()
        self.trace_ctx = Tracer.instance().inject()
        self.tail = tail
        self.taken = 0
        self.pending_parts = 0
        self.parts: list[tuple] = []

    def deadline_t(self) -> float:
        return self.deadline.t_end if self.deadline is not None else math.inf


class _Lane:
    """One coalescing lane: same semantic key, same per-slot batch width,
    same QoS class. The bound program lives as long as the executor."""

    __slots__ = ("lane_key", "program", "width", "cls", "subs", "queued",
                 "min_deadline_t")

    def __init__(self, lane_key: tuple, program: _MeshProgram,
                 width: int, cls: str):
        self.lane_key = lane_key
        self.program = program
        self.width = max(1, int(width))
        self.cls = cls
        self.subs: deque[_Sub] = deque()
        self.queued = 0
        self.min_deadline_t = math.inf


class MeshExecutor:
    """Per-process owner of the multi-device datapath.

    `submit(key, stripes, width=...)` enqueues stripe work under a
    codec-service semantic key and returns a Future of the host output
    tuple for exactly those stripes. Submissions sharing (key, width,
    qos) coalesce into full-width mesh dispatches; up to `depth`
    dispatches stay in flight. With no `mesh` it takes every CUDA device
    (`sharded.default_codec_mesh`): it raises without CUDA, and with
    fewer than two devices.
    """

    def __init__(self, mesh: Optional[sharded.Mesh] = None,
                 depth: Optional[int] = None, axis: str = "dn"):
        if mesh is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available; pass a mesh of CPU slots "
                    "(sharded.make_mesh(devices=['cpu'] * n)) for the plain "
                    "PyTorch path")
            mesh = sharded.default_codec_mesh(axis=axis)
        if mesh is None:
            raise ValueError("mesh executor needs a multi-device mesh "
                             "(torch.cuda.device_count() > 1)")
        self.mesh = mesh
        self.axis = axis
        self.n_devices = int(mesh.devices.size)
        self.depth = depth if depth is not None else mesh_depth()
        self.linger_s = env_float("OZONE_TPU_MESH_LINGER_MS",
                                  DEFAULT_LINGER_MS) / 1000.0
        #: staging buffers are pinned when the slots are on the card
        self._pinned = any(s.device.type == "cuda" for s in mesh.local_slots)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._lanes: dict[tuple, _Lane] = {}
        self._programs: dict[tuple, Optional[_MeshProgram]] = {}
        #: launched batches awaiting harvest: at most depth + 1
        self._inflight: deque[tuple] = deque()
        #: host staging buffers: (shape, dtype str) -> free list; the
        #: in-flight window recycles depth+1 buffers per lane shape
        self._staging: dict[tuple, list] = {}
        self._max_inflight = 0
        #: one worker per slot for the host-twin programs
        self._workers = ThreadPoolExecutor(
            max_workers=self.n_devices, thread_name_prefix="mesh-dev")
        self._dispatch_ewma_s = 0.005
        self._running = True
        METRICS.gauge("devices").set(self.n_devices)
        METRICS.gauge("depth").set(self.depth)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mesh-executor")
        self._thread.start()

    # ------------------------------------------------------ program cache
    def dispatch_width(self, width: int) -> int:
        """A lane's mesh dispatch width: the per-slot batch times the mesh
        size, bounded, and always a multiple of the mesh size."""
        w = max(1, int(width)) * self.n_devices
        w = min(w, MAX_DISPATCH_WIDTH)
        return max(self.n_devices, -(-w // self.n_devices) * self.n_devices)

    def accepts(self, key: tuple) -> bool:
        """Whether `key` resolves to a mesh program (spill eligibility);
        may build the program's plans."""
        return self._resolve(key) is not None

    def accepts_cached(self, key: tuple) -> Optional[bool]:
        """Non-blocking spill-eligibility peek: True/False once `key` was
        resolved, None while unknown (callers holding their own locks
        warm unknown keys through `accepts()` outside them)."""
        with self._lock:
            if key not in self._programs:
                return None
            return self._programs[key] is not None

    def _resolve(self, key: tuple) -> Optional[_MeshProgram]:
        with self._lock:
            if key in self._programs:
                return self._programs[key]
        prog = self._build_program(key)
        with self._lock:
            self._programs.setdefault(key, prog)
            return self._programs[key]

    def _build_program(self, key: tuple) -> Optional[_MeshProgram]:
        """The program of an encode or decode key: the host twin on every
        slot where the backend policy takes it (or the key is a twin
        lane's), else the sharded device program; None for keys with no
        mesh form (re-encode, and any key that carries no fused spec)."""
        kind = key[0]
        spec = key[1] if len(key) > 1 else None
        if not isinstance(spec, FusedSpec):
            return None
        n = self.n_devices
        tagged = key[-1] == fused.HOST_TWIN
        dev = self.mesh.first_device
        if kind == "encode":
            if tagged or fused._host_twin_wanted(spec, dev):
                single = fused._native_fused_encoder(
                    spec.options, spec.checksum, spec.bytes_per_checksum)
                return _MeshProgram(self._host_shard(single), (), True)
            inner = sharded.make_sharded_fused_encoder(spec, self.mesh, self.axis)
            caches = (sharded._on_device,)
        elif kind == "decode":
            valid, erased = list(key[2]), list(key[3])
            if tagged or fused._host_twin_wanted(
                    spec, dev, len(erased) / max(len(valid), 1)):
                single = fused._native_fused_decoder(
                    spec.options, spec.checksum, spec.bytes_per_checksum,
                    tuple(valid), tuple(erased))
                return _MeshProgram(self._host_shard(single), (), True)
            inner = sharded.make_sharded_decoder(
                spec, valid, erased, self.mesh, self.axis)
            caches = (sharded._decode_plan_cached,)
        else:
            # the re-encode's one fused launch has no sharded form here,
            # as in the reference: its lanes never spill
            return None

        def fn(batch):
            padded, orig = sharded.pad_batch(batch, n)
            outs = inner(padded)
            return tuple(o[:orig] for o in outs)

        return _MeshProgram(fn, caches)

    def _host_shard(self, single: Callable) -> Callable:
        """The host mirror of the DP sharding: a batch's rows split into
        one contiguous part per slot, each coded by the single-device twin
        on its own worker thread, the outputs concatenated in row order."""
        n = self.n_devices

        def fn(batch):
            rows = int(batch.shape[0])
            bounds = [i * rows // n for i in range(n + 1)]
            futs = [self._workers.submit(single, batch[a:b])
                    for a, b in zip(bounds, bounds[1:]) if b > a]
            outs = [f.result() for f in futs]
            return tuple(torch.cat([o[i] for o in outs])
                         for i in range(len(outs[0])))

        return fn

    # ---------------------------------------------------------- staging
    def _take_staging(self, shape: tuple, dtype):
        skey = (shape, np.dtype(dtype).str)
        with self._lock:
            free = self._staging.get(skey)
            if free:
                METRICS.counter("staging_reuses").inc()
                return free.pop()
        if self._pinned and np.dtype(dtype) == np.uint8:
            return torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        return np.empty(shape, dtype=dtype)

    def _give_staging(self, buf) -> None:
        skey = (tuple(buf.shape), _rows(buf).dtype.str)
        with self._lock:
            free = self._staging.setdefault(skey, [])
            if len(free) <= self.depth:
                free.append(buf)

    # ----------------------------------------------------------- submit
    def submit(self, key: tuple, stripes, *, width: int,
               qos: str = "bulk", tail: bool = False,
               deadline=None) -> Future:
        """Enqueue `stripes` ([n, ...], n >= 1, a numpy array or a host
        tensor) under semantic `key`. `width` is the submitter's per-slot
        batch width (the lane dispatches at `dispatch_width(width)`).
        Raises KeyError when the key has no mesh program."""
        if stripes.shape[0] < 1:
            raise ValueError("empty mesh submission")
        prog = self._resolve(key)
        if prog is None:
            raise KeyError(f"no mesh program for {key!r}")
        if deadline is None:
            deadline = _ambient_deadline()
        fut: Future = Future()
        sub = _Sub(stripes, fut, qos, deadline, tail)
        self._enqueue(key, prog, width, qos, [sub])
        return fut

    def _enqueue(self, key: tuple, prog: _MeshProgram, width: int,
                 qos: str, subs: list) -> None:
        lane_key = (key, int(width), qos)
        lane_width = self.dispatch_width(width)
        with self._cond:
            if not self._running:
                raise RuntimeError("mesh executor is shut down")
            lane = self._lanes.get(lane_key)
            if lane is None:
                lane = self._lanes[lane_key] = _Lane(
                    lane_key, prog, lane_width, qos)
            for sub in subs:
                lane.subs.append(sub)
                lane.queued += sub.n
                lane.min_deadline_t = min(lane.min_deadline_t,
                                          sub.deadline_t())
                METRICS.counter("submissions").inc()
            METRICS.gauge("queue_depth").set(self._queue_depth_locked())
            self._cond.notify()

    def absorb(self, key: tuple, width: int, qos: str,
               subs: list) -> None:
        """Take over queued submissions spilled from the codec service:
        same future, same stripes, same deadline; only the dispatch path
        changes. The service spills only lanes none of whose stripes has
        been dispatched."""
        prog = self._resolve(key)
        if prog is None:
            raise KeyError(f"no mesh program for {key!r}")
        METRICS.counter("spilled_lanes").inc()
        METRICS.counter("spilled_stripes").inc(sum(s.n for s in subs))
        self._enqueue(key, prog, width, qos, subs)

    def pipeline(self, key: tuple, *, width: int,
                 qos: str = "bulk") -> "MeshPipeline":
        """A `ServicePipeline`-shaped front end over one mesh lane. Raises
        KeyError when the key has no mesh program."""
        if self._resolve(key) is None:
            raise KeyError(f"no mesh program for {key!r}")
        return MeshPipeline(self, key, width=width, qos=qos)

    # ------------------------------------------------------- scheduling
    def _queue_depth_locked(self) -> int:
        return sum(lane.queued for lane in self._lanes.values())

    def _flush_margin_s(self) -> float:
        return self.linger_s + 4.0 * self._dispatch_ewma_s

    def _ready_lane_locked(self, now: float) -> Optional[_Lane]:
        """Full lanes first, then deadline-pressed, then lingered-out;
        the fairness machinery lives in the codec service front end."""
        best: Optional[_Lane] = None
        best_rank: tuple = ()
        margin = self._flush_margin_s()
        for lane in self._lanes.values():
            if not lane.subs:
                continue
            head_age = now - lane.subs[0].t_enq
            if lane.queued >= lane.width:
                rank = (0, -lane.queued, lane.subs[0].t_enq)
            elif lane.min_deadline_t - now <= margin:
                rank = (1, lane.min_deadline_t, lane.subs[0].t_enq)
            elif head_age >= self.linger_s:
                rank = (2, lane.subs[0].t_enq, 0.0)
            else:
                continue
            if best is None or rank < best_rank:
                best, best_rank = lane, rank
        return best

    def _next_wakeup_locked(self, now: float) -> Optional[float]:
        t = math.inf
        margin = self._flush_margin_s()
        for lane in self._lanes.values():
            if not lane.subs:
                continue
            t = min(t, lane.subs[0].t_enq + self.linger_s,
                    lane.min_deadline_t - margin)
        return None if math.isinf(t) else max(0.0, t - now)

    def _pack_locked(self, lane: _Lane):
        entries: list[tuple[_Sub, int, int, int]] = []
        row = 0
        while lane.subs and row < lane.width:
            sub = lane.subs[0]
            take = min(sub.n - sub.taken, lane.width - row)
            entries.append((sub, sub.taken, take, row))
            sub.taken += take
            sub.pending_parts += 1
            if sub.taken == sub.n:
                lane.subs.popleft()
            row += take
            lane.queued -= take
        if not lane.subs:
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
                    lane = self._ready_lane_locked(now)
                    if lane is not None:
                        entries, rows = self._pack_locked(lane)
                    elif not self._inflight:
                        if not self._running:
                            if not any(ln.subs for ln in self._lanes.values()):
                                break
                            lane = next(ln for ln in self._lanes.values()
                                        if ln.subs)
                            entries, rows = self._pack_locked(lane)
                        else:
                            self._cond.wait(self._next_wakeup_locked(now))
                            continue
                if entries is not None:
                    self._dispatch(lane, entries, rows)
                    # depth-N: keep up to `depth` batches in flight and
                    # harvest the oldest only once the window is over-full
                    while len(self._inflight) > self.depth:
                        self._complete(self._inflight.popleft())
                elif self._inflight:
                    # nothing packable: never hold results hostage
                    self._complete(self._inflight.popleft())
        except BaseException:
            log.exception("mesh executor dispatcher crashed")
            raise
        finally:
            with self._lock:
                self._running = False
            self._fail_pending(RuntimeError("mesh executor stopped"))

    def _dispatch(self, lane: _Lane, entries, rows: int) -> None:
        now = time.monotonic()
        ops = len(entries)
        tracer = Tracer.instance()
        t_now = tracer.now()
        lane_desc = str(lane.lane_key)[:120]
        for sub, off, take, _row in entries:
            if off == 0:
                wait = now - sub.t_enq
                tid = sub.trace_ctx.split(":", 1)[0]
                METRICS.histogram("queue_wait_seconds").observe(wait, tid)
                if sub.trace_ctx:
                    tracer.record_span(
                        "mesh:queue_wait", child_of=sub.trace_ctx,
                        start=sub.t_enq_wall,
                        duration=t_now - sub.t_enq_wall,
                        lane=lane_desc, qos=sub.cls)
        head = entries[0]
        staged = None
        if ops == 1 and head[2] == rows == lane.width and head[1] == 0 \
                and head[0].n == lane.width and _contiguous(head[0].stripes):
            # one submission covering the whole batch: its own rows go in
            # without a staging copy
            batch = head[0].stripes
        else:
            shape = (lane.width,) + tuple(head[0].stripes.shape[1:])
            staged = batch = self._take_staging(shape, _rows(head[0].stripes).dtype)
            dst = _rows(staged)
            for sub, off, take, row in entries:
                dst[row:row + take] = _rows(sub.stripes[off:off + take])
            if rows < lane.width:
                dst[rows:] = 0  # constant-shape zero-padded tail
        # the span's start on the tracer's clock; its duration for the
        # scheduling EWMA and the histogram on the monotonic one
        t0, m0 = tracer.now(), time.monotonic()
        with tracer.span("mesh:dispatch", lane=lane_desc, ops=ops,
                         rows=rows, width=lane.width,
                         devices=self.n_devices):
            try:
                outs = lane.program.fn(batch)
                if not isinstance(outs, tuple):
                    outs = (outs,)
                # the copies back start now, under the next batch's packing
                pulls = _start_pull(outs)
            except Exception as e:  # a fault of this dispatch: its submitters'
                if staged is not None:
                    self._give_staging(staged)
                self._resolve_error(entries, e)
                return
        METRICS.counter("dispatches").inc()
        METRICS.counter("stripes_dispatched").inc(rows)
        METRICS.counter("slots_dispatched").inc(lane.width)
        METRICS.counter("coalesced_operations").inc(ops)
        if ops > 1:
            METRICS.counter("multi_op_dispatches").inc()
        METRICS.gauge("batch_fill_pct").set(100.0 * rows / lane.width)
        with self._lock:
            METRICS.gauge("queue_depth").set(self._queue_depth_locked())
            self._inflight.append(
                (entries, pulls, staged, t0, m0,
                 (lane_desc, ops, rows, lane.width)))
            depth_now = len(self._inflight)
        self._max_inflight = max(self._max_inflight, depth_now)
        METRICS.gauge("inflight_depth").set(depth_now)
        METRICS.gauge("inflight_per_device").set(depth_now)
        METRICS.gauge("max_inflight_depth").set(self._max_inflight)

    def _complete(self, rec: tuple) -> None:
        entries, pulls, staged, t0, m0, dctx = rec
        lane_desc, ops, rows, width = dctx
        try:
            with Tracer.instance().span("mesh:harvest", lane=lane_desc, rows=rows):
                host = _finish_pull(pulls)
        except Exception as e:  # a fault of the copy back: its submitters'
            if staged is not None:
                self._give_staging(staged)
            self._resolve_error(entries, e)
            return
        if staged is not None:
            # every copy that read the buffer finished before the outputs
            # that depend on it came back
            self._give_staging(staged)
        t1, dt = Tracer.now(), time.monotonic() - m0
        self._dispatch_ewma_s += 0.2 * (dt - self._dispatch_ewma_s)
        METRICS.histogram("dispatch_seconds").observe(
            dt, entries[0][0].trace_ctx.split(":", 1)[0])
        with self._lock:
            METRICS.gauge("inflight_depth").set(len(self._inflight))
        tracer = Tracer.instance()
        for sub, off, take, _row in entries:
            if sub.trace_ctx:
                tracer.record_span(
                    "mesh:device_dispatch", child_of=sub.trace_ctx,
                    start=t0, duration=t1 - t0, lane=lane_desc,
                    qos=sub.cls, stripes=take, ops=ops, rows=rows,
                    width=width)
        for sub, off, take, row in entries:
            sub.parts.append(
                (off, take, tuple(a[row:row + take] for a in host)))
            sub.pending_parts -= 1
            if sub.taken == sub.n and sub.pending_parts == 0:
                _resolve_sub(sub)

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
            inflight, self._inflight = list(self._inflight), deque()
        for rec in inflight:
            for sub, _o, _t, _r in rec[0]:
                subs.append(sub)
        for s in subs:
            if not s.future.done():
                s.future.set_exception(e)

    # ---------------------------------------------------------- control
    def compile_counts(self) -> int:
        """Per-device plans across every resolved program; the
        warm-program probe reads its delta over steady-state rounds
        (must be zero)."""
        with self._lock:
            progs = [p for p in self._programs.values() if p is not None]
        return sum(p.compile_count() for p in progs)

    def stats(self) -> dict:
        """Operator snapshot (the Recon /api/mesh payload), with every key
        of the reference's."""
        snap = {**dict.fromkeys(_SIGNALS, 0), **METRICS.snapshot()}
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
            progs = [p for p in self._programs.values() if p is not None]
            snap["programs"] = len(progs)
            snap["programs_host_twin"] = sum(
                1 for p in progs if p.host_twin)
        snap["max_inflight"] = self._max_inflight
        snap["devices"] = self.n_devices
        snap["mesh_depth"] = self.depth
        snap["compile_counts"] = sum(p.compile_count() for p in progs)
        snap["spill_enabled"] = spill_enabled()
        snap["spill_watermark"] = spill_watermark()
        snap["enabled"] = enabled()
        return snap

    def quiesce(self, timeout_s: float = 30.0) -> None:
        """Wait until every queued submission has dispatched and been
        harvested (tests and drills)."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            with self._lock:
                if not self._inflight and \
                        self._queue_depth_locked() == 0:
                    return
            time.sleep(0.002)

    def close(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout=60.0)
        self._workers.shutdown(wait=True)
        self._fail_pending(RuntimeError("mesh executor shut down"))


def _resolve_sub(sub: _Sub) -> None:
    if sub.future.done():
        return
    if len(sub.parts) == 1:
        sub.future.set_result(sub.parts[0][2])
        return
    sub.parts.sort(key=lambda p: p[0])
    outs = tuple(
        np.concatenate([p[2][i] for p in sub.parts], axis=0)
        for i in range(len(sub.parts[0][2])))
    sub.future.set_result(outs)


class MeshPipeline:
    """Twin of `DeviceBatchPipeline`/`ServicePipeline` on one mesh lane:
    submit(batch, ctx) coalesces into full-width mesh dispatches and
    returns the previous submission's (ctx, host outputs)."""

    def __init__(self, executor: MeshExecutor, key: tuple, *,
                 width: int, qos: str = "bulk"):
        self._ex = executor
        self._key = key
        self._width = max(1, int(width))
        self._qos = qos
        self._pending: Optional[tuple] = None

    def submit(self, batch, ctx: Any = None,
               tail: bool = False) -> Optional[tuple]:
        fut = self._ex.submit(self._key, batch, width=self._width,
                              qos=self._qos, tail=tail)
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
        from ozone_tpu_torch.codec import service as codec_service

        return ctx, codec_service.wait_result(fut)


_executor: Optional[MeshExecutor] = None
_executor_lock = threading.Lock()


def get_executor() -> MeshExecutor:
    """The process-wide executor (created on first use)."""
    global _executor
    with _executor_lock:
        if _executor is None or not _executor._running:
            _executor = MeshExecutor()
        return _executor


def maybe_executor() -> Optional[MeshExecutor]:
    """The executor when it can exist here: enabled, and either installed
    as the singleton already (over a mesh of the caller's choosing) or
    built over two or more CUDA devices. The one check the routed
    datapaths (the lifecycle mesh lane, reconstruction storms, the
    codec-service spill) make before keeping their single-device
    pipelines. A failure to build the mesh raises."""
    if not enabled():
        return None
    installed = _executor
    if installed is not None and installed._running:
        return installed
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    return get_executor()


def reset_for_tests() -> None:
    """Shut down and drop the singleton (fresh knobs per test)."""
    global _executor
    with _executor_lock:
        ex, _executor = _executor, None
    if ex is not None:
        ex.close()
