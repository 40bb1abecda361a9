"""The one general generator: an open or a closed loop of operations, as a
traffic file describes it.

- `"loop": "open"`: round(rate_per_s * seconds) arrivals with Poisson gaps
  (`data.poisson_arrivals`); a pool of `senders` threads takes each arrival
  at its due time. An operation is timed from its due time, so a stall
  shows in every operation that waits behind it; how late the sender
  started is kept beside it.
- `"loop": "closed"`: `clients` threads, each issuing its next operation
  when the last returns, until the window closes. An operation is timed
  from its start.

`ops` gives integer weights; every seed issues the same mix in another
order (`data.op_sequence`). What an operation does is the executor's: a
callable per op name, `fn(client, index) -> nbytes`.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from portbench.harness import data

#: how long past the close the generator waits for operations in flight
GRACE_S = 60.0


@dataclass
class Op:
    kind: str
    client: int
    index: int
    t_due: float
    t_start: float = 0.0
    t_end: float = 0.0
    ok: bool = False
    nbytes: int = 0
    error: str = ""
    extra: dict = field(default_factory=dict)

    @property
    def latency_s(self) -> float:
        return self.t_end - self.t_due

    @property
    def late_s(self) -> float:
        return self.t_start - self.t_due


@dataclass
class Window:
    t0: float
    seconds: float
    ops: list[Op]

    @property
    def t1(self) -> float:
        return self.t0 + self.seconds


def _run(op: Op, fn: Callable) -> None:
    op.t_start = time.perf_counter()
    try:
        op.nbytes = fn(op)
        op.ok = True
    except Exception as e:  # noqa: BLE001 - a failed operation is counted
        op.error = f"{type(e).__name__}: {e}"[:300]
    op.t_end = time.perf_counter()


def run(traffic: dict, seed: int, seconds: float,
        executors: dict[str, Callable[[Op], int]]) -> Window:
    """Drive one measured window; returns every operation issued in it,
    each finished or failed (or, past the grace, neither)."""
    if traffic["loop"] == "open":
        return _open_loop(traffic, seed, seconds, executors)
    if traffic["loop"] == "closed":
        return _closed_loop(traffic, seed, seconds, executors)
    raise ValueError(f"unknown loop {traffic['loop']!r}")


def _open_loop(traffic, seed, seconds, executors) -> Window:
    due = data.poisson_arrivals(seed, float(traffic["rate_per_s"]), seconds)
    kinds = data.op_sequence(seed, 0, traffic["ops"], len(due))
    t0 = time.perf_counter() + 0.05
    ops = [Op(kind, -1, i, t0 + float(d)) for i, (kind, d) in
           enumerate(zip(kinds, due))]
    nxt = iter(range(len(ops)))
    lock = threading.Lock()

    def sender(sid: int) -> None:
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            op = ops[i]
            op.client = sid
            wait = op.t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            _run(op, executors[op.kind])

    threads = [threading.Thread(target=sender, args=(s,), daemon=True,
                                name=f"bench-sender-{s}")
               for s in range(int(traffic["senders"]))]
    for t in threads:
        t.start()
    _join(threads, t0 + seconds + GRACE_S)
    return Window(t0, seconds, ops)


def _closed_loop(traffic, seed, seconds, executors) -> Window:
    clients = int(traffic["clients"])
    t0 = time.perf_counter() + 0.05
    t1 = t0 + seconds
    per_client: list[list[Op]] = [[] for _ in range(clients)]
    # enough of each client's sequence for any plausible window
    plan = [data.op_sequence(seed, 1 + c, traffic["ops"], 4096)
            for c in range(clients)]

    def client(c: int) -> None:
        wait = t0 - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        i = 0
        while True:
            now = time.perf_counter()
            if now >= t1:
                return
            kind = plan[c][i % len(plan[c])]
            op = Op(kind, c, i, now)
            per_client[c].append(op)
            _run(op, executors[kind])
            i += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"bench-client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    _join(threads, t1 + GRACE_S)
    ops = [op for lst in per_client for op in lst]
    return Window(t0, seconds, ops)


def _join(threads: list[threading.Thread], deadline: float) -> None:
    """Wait for the threads until `deadline`; an operation still running
    then never answered, and the comparison counts it (`never_answered`)."""
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        print(f"operations still running {GRACE_S} s past the window's "
              f"close: {stuck[:5]}", file=sys.stderr, flush=True)
