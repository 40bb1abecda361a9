"""Needle-in-slab packer: the tiny-object write path.

Port of `ozone_tpu/client/slab.py`, whole. Haystack (OSDI '10) put many
photos behind one file handle; f4 (OSDI '14) packed warm blobs into
shared EC volumes. A per-process `SlabPacker` coalesces many concurrent
small PUTs into shared EC stripes (one slab block per container group,
written through `ECKeyWriter`, so the fused encode+CRC kernel runs once
per slab stripe batch on `device`) and commits all of a flush's keys to
the OM as one batched `CommitKeys`. Each key costs a needle record
(slab_id, offset, length, crc) instead of a stripe, a block and an OM
request of its own.

Durability: `put()` returns only after the batch's `CommitKeys` applied
and was group-flushed by the OM. An unacknowledged key is simply absent
(its bytes may be on the datanodes, but no needle points at them, and
the per-needle CRC gate refuses a torn read).

Overload: the pending set is bounded. At the bound `put()` refuses with
the admission layer's typed `SERVER_BUSY` and a retry-after hint, so a
mass-ingest tenant sheds at the gateway instead of queuing invisibly.
Flushes ride the codec service's bulk class and charge the owning
tenant's byte bucket.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Optional

import numpy as np

from ozone_tpu_torch import admission
from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.ec_writer import ECKeyWriter
from ozone_tpu_torch.om.requests import OMError, SMALLOBJ_NOT_SUPPORTED
from ozone_tpu_torch.scm.pipeline import ReplicationConfig, ReplicationType
from ozone_tpu_torch.utils.checksum import crc32c
from ozone_tpu_torch.utils.config import env_float, env_int
from ozone_tpu_torch.utils.metrics import registry
from ozone_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)

#: the smallobj.* metrics family (pinned in the observability golden):
#: inline hits, needles packed, slabs flushed, fill pct, compaction
METRICS = registry("smallobj")

NEEDLE_CRC_MISMATCH = "NEEDLE_CRC_MISMATCH"


def smallobj_conf(binfo: dict) -> Optional[dict]:
    """Effective inline/needle thresholds from a bucket row (None =
    bucket never opted in). Stored zeros defer to the env knobs so a
    fleet retune needs no bucket-row rewrites. Shared by the OM surface
    and the client router so the two can never disagree."""
    so = binfo.get("smallobj")
    if not so:
        return None
    inline_max = int(so.get("inline_max", 0)) or env_int(
        "OZONE_TPU_INLINE_MAX", 4096)
    needle_max = int(so.get("needle_max", 0)) or env_int(
        "OZONE_TPU_NEEDLE_MAX", 256 * 1024)
    return {"inline_max": inline_max,
            "needle_max": max(needle_max, inline_max)}


class _Pending:
    """One enqueued needle: bytes + the waiter's completion latch."""

    __slots__ = ("key", "data", "metadata", "event", "error", "enq_t")

    def __init__(self, key: str, data: bytes, metadata: Optional[dict]):
        self.key = key
        self.data = data
        self.metadata = metadata
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.enq_t = time.monotonic()


class _BucketQueue:
    """Pending needles of one (volume, bucket): flushed as whole slabs."""

    __slots__ = ("volume", "bucket", "replication", "items", "nbytes")

    def __init__(self, volume: str, bucket: str, replication: str):
        self.volume = volume
        self.bucket = bucket
        self.replication = replication
        self.items: list[_Pending] = []
        self.nbytes = 0


class SlabPacker:
    """Per-process write-side coalescer. Thread-safe; writers block in
    ``put()`` until their needle's batch commit acks."""

    def __init__(self, om, clients, qos_class: str = "bulk",
                 device="cuda"):
        from ozone_tpu_torch.codec.fused import resolve_device

        self.om = om
        self.clients = clients
        self.qos_class = qos_class
        #: where a slab's stripes are encoded
        self.device = resolve_device(device)
        #: flush when a bucket's pending bytes reach this
        self.target_bytes = int(env_float(
            "OZONE_TPU_SLAB_TARGET_MIB", 4.0) * 1024 * 1024)
        #: ... or when its oldest needle has waited this long
        self.linger_s = env_float("OZONE_TPU_SLAB_LINGER_MS", 8.0) / 1e3
        #: bounded pending set (needle count + bytes): beyond either,
        #: put() refuses with SERVER_BUSY instead of queuing
        self.max_pending = env_int("OZONE_TPU_SLAB_QUEUE", 8192)
        self.max_pending_bytes = int(env_float(
            "OZONE_TPU_SLAB_QUEUE_MIB", 64.0) * 1024 * 1024)
        self._cond = threading.Condition()
        self._queues: dict[tuple, _BucketQueue] = {}
        self._pending = 0
        self._pending_bytes = 0
        self._eligible: dict[tuple, tuple] = {}  # (v,b) -> (conf, repl)
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- eligibility
    def _check_eligible(self, volume: str, bucket: str) -> tuple:
        """PUT-time eligibility, cached per bucket: the packer needs a
        small-object-enabled flat bucket with an EC scheme. Anything
        else is refused HERE with a typed error — deterministically at
        PUT time, never from inside a background flush."""
        ck = (volume, bucket)
        hit = self._eligible.get(ck)
        if hit is not None:
            return hit
        binfo = self.om.bucket_info(volume, bucket)
        conf = smallobj_conf(binfo)
        if conf is None:
            raise OMError(SMALLOBJ_NOT_SUPPORTED,
                          f"{volume}/{bucket} has no small-object "
                          "config (set_bucket_smallobj)")
        if binfo.get("layout") == "FILE_SYSTEM_OPTIMIZED":
            raise OMError(SMALLOBJ_NOT_SUPPORTED,
                          f"{volume}/{bucket} is FSO — slab packing "
                          "needs a flat key table")
        repl = binfo["replication"]
        if ReplicationConfig.parse(repl).type is not ReplicationType.EC:
            raise OMError(SMALLOBJ_NOT_SUPPORTED,
                          f"{volume}/{bucket} replication {repl!r} is "
                          "not erasure-coded — slabs are EC stripes")
        self._eligible[ck] = (conf, repl)
        return conf, repl

    # -------------------------------------------------------------- put
    def put(self, volume: str, bucket: str, key: str, data,
            metadata: Optional[dict] = None) -> None:
        """Enqueue one needle and block until its batch commit acks.
        Raises SERVER_BUSY (typed, with a retry-after hint) when the
        bounded pending set is full, and SMALLOBJ_NOT_SUPPORTED when
        the bucket is ineligible."""
        conf, repl = self._check_eligible(volume, bucket)
        raw = (data.tobytes() if isinstance(data, np.ndarray)
               else bytes(data))
        if len(raw) > conf["needle_max"]:
            raise OMError(
                "INVALID_REQUEST",
                f"{len(raw)} bytes exceeds needle_max "
                f"{conf['needle_max']}")
        # the owning tenant's byte bucket (ambient gateway identity,
        # else the volume): mass ingestion is charged at bulk priority
        # so the SLO shedder drops it first under pressure
        tenant = admission.current_tenant() or volume
        admission.controller("gateway").charge(
            tenant, len(raw), priority=self.qos_class)
        p = _Pending(key, raw, metadata)
        with self._cond:
            if self._closed:
                raise OMError("INVALID_REQUEST", "packer is closed")
            if (self._pending >= self.max_pending
                    or self._pending_bytes + len(raw)
                    > self.max_pending_bytes):
                METRICS.counter("put_rejected_queue").inc()
                raise admission.busy_error(
                    "packer", "queue", self.linger_s)
            q = self._queues.get((volume, bucket))
            if q is None:
                q = self._queues[(volume, bucket)] = _BucketQueue(
                    volume, bucket, repl)
            q.items.append(p)
            q.nbytes += len(raw)
            self._pending += 1
            self._pending_bytes += len(raw)
            METRICS.gauge("queue_depth").set(self._pending)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="slab-packer", daemon=True)
                self._thread.start()
            self._cond.notify_all()
        # wait for the flush ack within whatever operation deadline is
        # ambient (resilience.start at the write_key boundary)
        while not p.event.wait(
                timeout=resilience.op_timeout(self.linger_s * 4,
                                              "slab_flush")):
            resilience.check_deadline("slab_flush")
        if p.error is not None:
            raise p.error

    # ------------------------------------------------------------ flush
    def flush(self) -> None:
        """Force every pending needle out now (bench/test hook; close()
        calls it). Runs the flush on the CALLING thread."""
        while True:
            batch = None
            with self._cond:
                batch = self._take_ready(force=True)
            if batch is None:
                return
            self._flush_batch(batch)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self.flush()

    # -------------------------------------------------------- internals
    def _take_ready(self, force: bool = False) -> Optional[_BucketQueue]:
        """Pop ONE bucket queue that is due (size or linger), oldest
        first. Caller holds the lock."""
        now = time.monotonic()
        best, best_age = None, -1.0
        for q in self._queues.values():
            if not q.items:
                continue
            age = now - q.items[0].enq_t
            due = (force or q.nbytes >= self.target_bytes
                   or age >= self.linger_s)
            if due and age > best_age:
                best, best_age = q, age
        if best is None:
            return None
        taken = _BucketQueue(best.volume, best.bucket, best.replication)
        # cap one slab at target_bytes: a burst bigger than the target
        # becomes several well-filled slabs instead of one giant one
        while best.items and (not taken.items
                              or taken.nbytes < self.target_bytes):
            p = best.items.pop(0)
            taken.items.append(p)
            taken.nbytes += len(p.data)
            best.nbytes -= len(p.data)
        self._pending -= len(taken.items)
        self._pending_bytes -= taken.nbytes
        METRICS.gauge("queue_depth").set(self._pending)
        return taken

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._closed and self._pending == 0:
                    return
                batch = self._take_ready()
                if batch is None:
                    # linger-paced wakeup; knob-derived, not a literal
                    self._cond.wait(timeout=self.linger_s)
                    continue
            try:
                self._flush_batch(batch)
            except BaseException:  # noqa: BLE001
                # every waiter already received this error through its
                # completion latch (_flush_batch set p.error before
                # re-raising); the daemon survives for later batches
                log.debug("slab flush failed", exc_info=True)

    def _flush_batch(self, q: _BucketQueue) -> None:
        """Write one slab (single EC block per container group, bulk
        QoS through the shared codec service), then commit every needle
        in ONE batched CommitKeys ring entry. Ack or fail ALL waiters."""
        t0 = time.perf_counter()
        try:
            with Tracer.instance().span("slab:flush", volume=q.volume,
                                        bucket=q.bucket,
                                        needles=len(q.items)):
                out = self._write_and_commit(q)
        except BaseException as e:
            METRICS.counter("flush_failures").inc()
            for p in q.items:
                p.error = e
                p.event.set()
            raise
        skipped = set(out.get("skipped", ()))
        for p in q.items:
            if p.key in skipped:
                p.error = OMError("KEY_MODIFIED",
                                  f"{p.key} fenced out of batch")
            p.event.set()
        METRICS.counter("slabs_flushed").inc()
        METRICS.counter("needles_packed").inc(len(q.items))
        METRICS.counter("slab_bytes").inc(q.nbytes)
        METRICS.gauge("slab_fill_pct").set(
            round(100.0 * q.nbytes / max(1, self.target_bytes), 1))
        METRICS.histogram("flush_seconds").observe(
            time.perf_counter() - t0)

    def _write_and_commit(self, q: _BucketQueue) -> dict:
        return self._write_and_commit_fenced(q, None)

    def _write_and_commit_fenced(self, q: _BucketQueue,
                                 fences: Optional[list]) -> dict:
        """Write the slab, then batch-commit its needles. `fences` (one
        (expect_object_id, expect_generation) per item, compaction's
        survivor rewrite) makes each entry lose deterministically to a
        concurrent user overwrite instead of clobbering it."""
        slab_id = uuid.uuid4().hex[:16]
        offsets, buf, off = [], [], 0
        for p in q.items:
            offsets.append(off)
            buf.append(p.data)
            off += len(p.data)
        payload = np.frombuffer(b"".join(buf), np.uint8)
        groups: list = []

        def allocate(excluded, excluded_containers=()):
            g = self.om.allocate_slab_group(q.replication, excluded,
                                            excluded_containers)
            groups.append(g)
            return g

        opts = ReplicationConfig.parse(q.replication).ec
        w = ECKeyWriter(opts, allocate, self.clients,
                        block_size=self.om.block_size,
                        device=self.device,
                        qos_class=self.qos_class)
        w.write(payload)
        wgroups = w.close()
        slab = {
            "slab_id": slab_id,
            "replication": q.replication,
            "length": off,
            "block_groups": [g.to_json() for g in (wgroups or groups)],
        }
        entries = []
        for i, p in enumerate(q.items):
            e = {
                "key": p.key,
                "offset": offsets[i],
                "length": len(p.data),
                "crc": int(crc32c(np.frombuffer(p.data, np.uint8))),
                "metadata": p.metadata or {},
            }
            if fences is not None:
                e["expect_object_id"] = fences[i][0]
                e["expect_generation"] = fences[i][1]
            entries.append(e)
        return self.om.commit_keys(q.volume, q.bucket, slab, entries)
