"""One run of one cell: set-up, warm-up, the measured window, the readers,
and the comparison that decides `correct`.

`run_cell` takes the device as an argument so that the tests can drive a
whole run on the CPU at a small size (the kernels' plain versions then
run); `run.py` refuses to start without a CUDA device.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from portbench.harness import check, data, spec, trace, traffic
from portbench.harness.system import CodecSidecar, ObjectStore, survivors

#: operations served by the codec service directly
CODEC_OPS = {"encode", "decode"}
#: share of codec answers drawn for the comparison (besides each
#: submitter's first), up to the traffic's `sample_per_client`
CODEC_SAMPLE_SHARE = 0.01
#: share of GETs whose returned bytes are kept and compared, and the most
#: kept (each is one whole object in host memory)
GET_SAMPLE_SHARE = 0.08
GET_SAMPLE_MAX = 128


@dataclass
class WindowView:
    """What a metric reader reads: the window's operations, the program's
    spans and counter deltas, and (traced runs) the device's activity."""

    cell: spec.Cell
    window: traffic.Window
    counters: dict
    spans: list[dict] = field(default_factory=list)
    device: trace.DeviceTrace | None = None

    @property
    def seconds(self) -> float:
        return self.window.seconds

    def ops(self, kind: str, ok: bool | None = True) -> list[traffic.Op]:
        return [o for o in self.window.ops if o.kind == kind
                and (ok is None or o.ok == ok)]

    def done_in_window(self, kind: str) -> list[traffic.Op]:
        return [o for o in self.ops(kind) if o.t_end <= self.window.t1]

    def span_total_s(self, *names: str, where=None) -> float:
        return sum(s["end"] - s["start"] for s in self.spans
                   if s["name"] in names and (where is None or where(s)))

    def kernels(self, fragment: str) -> list[dict]:
        if self.device is None:
            return []
        return [e for e in self.device.events
                if e["cat"] == "kernel" and fragment in e["name"]]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class _Run:
    def __init__(self, cell: spec.Cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.tr = cell.config, cell.traffic
        self.ops = set(self.tr["ops"])
        self.root = tempfile.mkdtemp(prefix="portbench-")
        self.store: ObjectStore | None = None
        self.sidecar: CodecSidecar | None = None
        self.sources: dict[str, np.ndarray] = {}   # acknowledged key -> bytes
        self.pre: list[np.ndarray] = []
        self.pool: list[np.ndarray] = []
        self.get_samples: list[tuple[int, np.ndarray]] = []
        self.codec_data: list[np.ndarray] = []   # per submitter [B, k, C]
        self.codec_staged: list = []
        self.codec_samples: list[list[tuple]] = []
        self.sample_bufs: list[list[tuple]] = []
        self.lost: list[tuple] = []
        self.orders: list[np.ndarray] = []
        self._lock = threading.Lock()
        self._put_next = 0

    # ---------------------------------------------------------- set-up
    def setup(self, seconds: float) -> None:
        size = int(self.tr.get("object_bytes", 0))
        if self.ops & {"put", "get"}:
            self.store = ObjectStore(self.cfg, self.root, self.device)
        n_pre = int(self.tr.get("preload_objects", 0))
        if n_pre:
            self.pre = [data.object_bytes(self.seed, data.PRELOAD, i, size)
                        for i in range(n_pre)]
            with ThreadPoolExecutor(int(self.tr.get("preload_threads", 8))) as ex:
                list(ex.map(lambda i: self._put_acked(f"pre{i}", self.pre[i]),
                            range(n_pre)))
        if self.tr.get("down_units"):
            down = self.store.stop_units("pre0", list(self.tr["down_units"]))
            _log(f"datanodes down: {down}")
        if n_pre:
            t = time.perf_counter()
            _flush_files(self.root)
            _log(f"preloaded {n_pre} objects; their files flushed in "
                 f"{time.perf_counter() - t:.3f} s")
            self.lost = [self._pattern(f"pre{i}") for i in range(n_pre)]
            clients = int(self.tr.get("clients", 1))
            self.orders = [data.object_order(self.seed, c, clients, n_pre)
                           for c in range(clients)]
        if "put" in self.ops:
            if self.tr["loop"] == "open":
                n_pool = len(data.poisson_arrivals(
                    self.seed, float(self.tr["rate_per_s"]), seconds))
            else:
                n_pool = int(self.tr["put_pool_objects"])
            self.pool = [data.object_bytes(self.seed, data.PUT_POOL, j, size)
                         for j in range(n_pool)]
        if self.ops & CODEC_OPS:
            self._codec_inputs()

    def _codec_inputs(self) -> None:
        """Each submitter's stripes from the seed; a decode submits the
        survivors of those stripes, their parity worked out by the
        reference on the card. The device's peak is reset after that, so
        that `memory_peak_bytes` is the program's."""
        b = int(self.tr["batch_stripes"])
        erased = list(self.tr.get("erased_units", []))
        k, p = self.cfg["data_units"], self.cfg["parity_units"]
        valid = survivors(k, p, erased)
        shape = (b, k, self.cfg["cell_bytes"])
        dev = _ref_device(self.device)
        units = []
        for c in range(int(self.tr["clients"])):
            batch = data.object_bytes(self.seed, data.ENCODE, c,
                                      int(np.prod(shape))).reshape(shape)
            self.codec_data.append(batch)
            units.append(check.stripes(batch, self.cfg, dev)[:, valid]
                         .cpu().numpy() if erased else batch)
        if dev == "cuda":
            import torch

            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.sidecar = CodecSidecar(self.cfg, self.device, b, erased)
        self.codec_staged = [self.sidecar.staged(u) for u in units]
        self.codec_samples = [[] for _ in units]

    def _pattern(self, name: str) -> tuple:
        """The units of the key's groups whose datanodes are down."""
        info = self.store.key_info(name)
        down = set(self.store.down)
        return tuple(tuple(u for u, n in enumerate(g["nodes"]) if n in down)
                     for g in info["block_groups"])

    def _put_acked(self, name: str, src: np.ndarray) -> None:
        self.store.put(name, src)
        with self._lock:
            self.sources[name] = src

    def warmup(self) -> None:
        """Every shape the window will use, once: a PUT per `warmup_puts`,
        a GET of each erasure pattern the preloaded keys meet, and
        `warmup_rounds` of every encode submitter."""
        for i in range(int(self.tr.get("warmup_puts", 0))):
            self._put_acked(f"warm{i}", self.pool[i % len(self.pool)])
        if "get" in self.ops:
            seen: dict[tuple, int] = {}
            for i, pat in enumerate(self.lost):
                seen.setdefault(pat, i)
            for i in seen.values():
                self.store.get(f"pre{i}")
            _log(f"erasure patterns of the preloaded keys: "
                 f"{dict(Counter(self.lost))}")
        if self.ops & CODEC_OPS:
            with ThreadPoolExecutor(len(self.codec_staged)) as ex:
                for _ in range(int(self.tr.get("warmup_rounds", 1))):
                    answers = list(ex.map(self.sidecar.code, self.codec_staged))
            # the kept answers are copied into buffers touched now, so that
            # keeping one costs a copy in the window and no page faults
            n = int(self.tr["sample_per_client"])
            self.sample_bufs = [
                [tuple(_touched(a) for a in answers[0]) for _ in range(n)]
                for _ in self.codec_staged]

    # -------------------------------------------------------- executors
    def executors(self) -> dict:
        out = {}
        if "put" in self.ops:
            out["put"] = self._put
        if "get" in self.ops:
            out["get"] = self._get
        for op in self.ops & CODEC_OPS:
            out[op] = self._code
        return out

    def _put(self, op: traffic.Op) -> int:
        if self.tr["loop"] == "open":
            j = op.index
        else:
            with self._lock:
                j, self._put_next = self._put_next, self._put_next + 1
        src = self.pool[j % len(self.pool)]
        self._put_acked(f"w{j:06d}", src)
        return src.size

    def _get(self, op: traffic.Op) -> int:
        order = self.orders[op.client]
        i = int(order[op.index % len(order)])
        got = self.store.get(f"pre{i}")
        op.extra["erased"] = self.lost[i]
        # each client's first answer, then a draw from the seed
        if op.index == 0 or data.sampled(self.seed, 1 + op.client, op.index,
                                         GET_SAMPLE_SHARE):
            with self._lock:
                if len(self.get_samples) < GET_SAMPLE_MAX:
                    self.get_samples.append((i, got))
        return int(got.size)

    def _code(self, op: traffic.Op) -> int:
        """One submission; its size is the data bytes of its stripes."""
        c = op.client
        answer = self.sidecar.code(self.codec_staged[c])
        # each submitter's first answer, then draws from the seed
        if self.sample_bufs[c] and (op.index == 0 or data.sampled(
                self.seed, 1 + c, op.index, CODEC_SAMPLE_SHARE)):
            bufs = self.sample_bufs[c].pop()
            kept = []
            for a, buf in zip(answer, bufs):
                a = np.asarray(a)
                if a.shape == buf.shape and a.dtype == buf.dtype:
                    np.copyto(buf, a)
                    kept.append(buf)
                else:  # judged as it came
                    kept.append(np.array(a))
            self.codec_samples[c].append(tuple(kept))
        return int(self.codec_data[c].nbytes)

    # ------------------------------------------------------- comparison
    def compare(self, window: traffic.Window) -> dict[str, int]:
        counts: Counter = Counter()
        compared = 0
        dev = _ref_device(self.device)
        if self.store is not None:
            for name, src in sorted(self.sources.items()):
                try:
                    info = self.store.key_info(name)
                    stored = self.store.units(info)
                except Exception as e:  # noqa: BLE001 - judged as missing
                    _log(f"key {name}: {type(e).__name__}: {e}")
                    info, stored = None, None
                counts.update(check.compare_key(info, stored, src, self.cfg, dev))
                compared += 1
        for i, got in self.get_samples:
            counts.update(check.compare_get(got, self.pre[i]))
            compared += 1
        erased = list(self.tr.get("erased_units", []))
        for c, samples in enumerate(self.codec_samples):
            ref = None
            for units, crcs in samples:
                got, ref = check.compare_codec(units, crcs, self.codec_data[c],
                                               self.cfg, dev, erased, ref)
                counts.update(got)
                compared += 1
        names = ["never_answered"]
        if self.store is not None:
            names += ["keys_missing", "size_wrong", "cells_wrong",
                      "crc_words_wrong"]
        if "get" in self.ops:
            names += ["get_bytes_wrong"]
        if self.ops & CODEC_OPS:
            names += ["unit_stripes_wrong", "crc_words_wrong"]
        counts["never_answered"] = sum(1 for o in window.ops if o.t_end == 0.0)
        out = {n: int(counts[n]) for n in dict.fromkeys(names)}
        out["answers_compared"] = compared
        return out

    def close(self) -> None:
        try:
            if self.store is not None:
                self.store.close()
        finally:
            from ozone_tpu_torch.codec import service

            service.reset_for_tests()
            shutil.rmtree(self.root, ignore_errors=True)


def _flush_files(root: str) -> None:
    """fsync every file under the cluster's root: the preload's chunks
    reach the disk in set-up, not as writeback under the window."""
    import os

    for d, _, files in os.walk(root):
        for f in files:
            try:
                fd = os.open(os.path.join(d, f), os.O_RDONLY)
            except OSError:
                continue
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def _touched(a) -> np.ndarray:
    """An array shaped like `a`, its pages written once."""
    out = np.empty(np.shape(a), dtype=np.asarray(a).dtype)
    out.fill(0)
    return out


def _ref_device(device: str) -> str:
    return "cuda" if str(device).startswith("cuda") else "cpu"


def _sync(device: str) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run; returns the result line's fields (without `device`'s
    name, which `run.py` adds) and `checks`: each compared number with its
    limit."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = _Run(cell, seed, device)
    try:
        run.setup(seconds)
        run.warmup()
        _sync(device)
        setup_s = time.perf_counter() - t_start
        drain = prof = None
        if traced:
            drain = trace.SpanDrain()
            drain.start()
        before = trace.counters()
        if traced and str(device).startswith("cuda"):
            prof = trace.Profiler()
            prof.start()
        window = traffic.run(cell.traffic, seed, seconds, run.executors())
        after = trace.counters()
        dtrace = prof.stop() if prof is not None else None
        spans = drain.stop() if drain is not None else []
        memory_peak = 0
        if str(device).startswith("cuda"):
            import torch

            memory_peak = int(torch.cuda.max_memory_allocated())
        view = WindowView(cell, window, trace.delta(before, after), spans,
                          dtrace)
        metrics = {}
        wanted = cell.per_layer if traced else cell.end_to_end
        kind = "metrics" if traced else "end_to_end"
        for m in wanted:
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = spec.reader(kind, m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result = {
            "attempted": len(window.ops),
            "failed": sum(1 for o in window.ops if not o.ok),
            "metrics": metrics,
            "memory_peak_bytes": memory_peak,
        }
        errors = Counter(o.error.split(":")[0] for o in window.ops if o.error)
        if errors:
            _log(f"failed operations by error: {dict(errors)}; first: "
                 f"{next(o.error for o in window.ops if o.error)}")
        if dtrace is not None:
            result["busy_s"] = dtrace.busy_s()
            result["window_s"] = dtrace.window_s
            result["breakdown"] = trace.breakdown(dtrace, spans)
        checks = run.compare(window)
        limits = {n: {"value": v, "limit": check.LIMIT}
                  for n, v in checks.items() if n != "answers_compared"}
        limits["answers_compared"] = {"value": checks["answers_compared"],
                                      "limit": ">=1"}
        result["correct"] = (all(v["value"] <= check.LIMIT for n, v in
                                 limits.items() if n != "answers_compared")
                             and checks["answers_compared"] >= 1)
        result["checks"] = limits
        return result
    finally:
        run.close()
