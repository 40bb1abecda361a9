"""Operation deadlines, per-peer health and hedged calls.

Trimmed port of `ozone_tpu/client/resilience.py`, as far as the EC
writer, reader and reconstruction coordinator use it:

- `Deadline`: one wall-clock budget minted at the operation boundary
  (`start`) and made ambient; every hop below derives its timeout from
  what is left (`op_timeout`) and fails fast with DEADLINE_EXCEEDED once
  it is spent.
- `PeerHealth` / `HealthRegistry`: per-peer EWMA latency with a cheap
  P95 proxy (mean + 4 mean-absolute-deviations), EWMA error rate, and a
  circuit breaker (CLOSED -> OPEN after N consecutive transport faults ->
  HALF_OPEN single probe after a cooldown -> CLOSED on success). Survivor
  choice, reallocation and source order consult it.
- `HedgeGroup`: first-result-wins racing of a primary call against
  hedges fired after the peer's hedge delay (its P95, floored by
  OZONE_TPU_HEDGE_MS).
- `RetryPolicy` / `failover_retry_policy`: capped exponential backoff
  with jitter for the remote OM and SCM clients' failover loops, and
  `server_pushback_floor`, the Retry-After floor of a SERVER_BUSY
  answer.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
import random
import re
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import wait as _fwait
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Iterable, Optional, Sequence

from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.utils.metrics import MetricsRegistry
from ozone_tpu_torch.utils.tracing import Tracer

#: StorageError code for a spent operation budget
DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"

#: StorageError code of server pushback: a deliberate answer from a
#: healthy peer, retried after the server's hint, never a transport fault
SERVER_BUSY = "SERVER_BUSY"

#: every resilience signal (hedges, breakers, deadlines) in one registry
METRICS = MetricsRegistry("client.resilience")

_RETRY_AFTER_RE = re.compile(r"retry_after_s=([0-9][0-9.]*)")


def retry_after_hint(msg: object) -> Optional[float]:
    """The ``retry_after_s=<float>`` hint of a SERVER_BUSY message, capped
    at 30 s; None when absent or garbled."""
    m = _RETRY_AFTER_RE.search(str(msg))
    if not m:
        return None
    try:
        return min(30.0, float(m.group(1)))
    except ValueError:
        return None


def server_pushback_floor(e: BaseException,
                          verb: str = "") -> Optional[float]:
    """For a SERVER_BUSY StorageError: count it and return the server's
    Retry-After hint in seconds (0.0 without one) as the backoff floor.
    None for anything that is not server pushback."""
    if not (isinstance(e, StorageError) and e.code == SERVER_BUSY):
        return None
    METRICS.counter("server_busy").inc()
    if verb:
        METRICS.counter(f"server_busy_{verb}").inc()
    return retry_after_hint(getattr(e, "msg", str(e))) or 0.0


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# --------------------------------------------------------------- deadline
class Deadline:
    """Absolute wall-clock budget for one logical operation."""

    __slots__ = ("t_end", "op")

    def __init__(self, seconds: Optional[float], op: str = "op"):
        self.t_end = (math.inf if seconds is None or seconds <= 0
                      else time.monotonic() + seconds)
        self.op = op

    def remaining(self) -> float:
        return self.t_end - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, verb: str = "") -> None:
        """Fail fast when the budget is spent (counted per verb)."""
        if self.expired():
            METRICS.counter("deadline_exceeded").inc()
            if verb:
                METRICS.counter(f"deadline_exceeded_{verb}").inc()
            Tracer.instance().event("deadline_exceeded", op=self.op,
                                    verb=verb)
            raise StorageError(
                DEADLINE_EXCEEDED,
                f"operation {self.op} deadline exceeded"
                + (f" before {verb}" if verb else ""))

    def timeout(self, default: Optional[float],
                verb: str = "") -> Optional[float]:
        """Timeout for the next hop: the smaller of the hop's default and
        the remaining budget; raises when the budget is already spent."""
        self.check(verb)
        left = self.remaining()
        if default is None:
            return None if math.isinf(left) else left
        return min(default, left)


_current: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("ozone_tpu_torch_deadline", default=None)


def current() -> Optional[Deadline]:
    """The ambient deadline of this thread's operation, if any."""
    return _current.get()


@contextlib.contextmanager
def start(op: str, seconds: Optional[float] = None):
    """Operation-boundary scope: mint a Deadline and make it ambient. A
    nested boundary inherits the outer deadline. seconds=None reads
    OZONE_TPU_OP_DEADLINE_S (unset or 0: unbounded, no deadline)."""
    outer = _current.get()
    if outer is not None:
        yield outer
        return
    if seconds is None:
        seconds = _env_f("OZONE_TPU_OP_DEADLINE_S", 0.0)
    if seconds <= 0:
        yield None
        return
    d = Deadline(seconds, op)
    tok = _current.set(d)
    try:
        yield d
    finally:
        _current.reset(tok)


@contextlib.contextmanager
def activate(deadline: Optional[Deadline]):
    """Re-establish a captured deadline on a worker thread (contextvars do
    not cross ThreadPoolExecutor boundaries)."""
    if deadline is None:
        yield None
        return
    tok = _current.set(deadline)
    try:
        yield deadline
    finally:
        _current.reset(tok)


def op_timeout(default: Optional[float],
               verb: str = "") -> Optional[float]:
    """Deadline-derived timeout for one hop: `default` when no operation
    deadline is ambient, min(default, remaining) otherwise."""
    d = _current.get()
    if d is None:
        return default
    return d.timeout(default, verb)


def check_deadline(verb: str = "") -> None:
    """Fail fast with DEADLINE_EXCEEDED when the ambient budget is spent."""
    d = _current.get()
    if d is not None:
        d.check(verb)


# ----------------------------------------------------------------- retry
@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with jitter: ``backoff_s(attempt)`` draws
    uniform(lo, hi) with hi = min(cap, base * 2**attempt) and lo = hi *
    floor_fraction (0.0 is full jitter, 0.5 equal jitter)."""

    base_s: float = 0.25
    cap_s: float = 5.0
    max_attempts: int = 8
    floor_fraction: float = 0.0

    def backoff_s(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        hi = min(self.cap_s, self.base_s * (2.0 ** max(0, attempt)))
        lo = hi * min(1.0, max(0.0, self.floor_fraction))
        return rng.uniform(lo, hi) if rng is not None \
            else random.uniform(lo, hi)

    def sleep(self, attempt: int,
              deadline: Optional[Deadline] = None,
              rng: Optional[random.Random] = None,
              floor_s: Optional[float] = None) -> bool:
        """Sleep the jittered backoff (at least `floor_s`, the server's
        hint), clipped to the deadline. False, without sleeping the full
        interval, when the attempt cap is reached or the budget cannot
        cover another attempt: the caller stops retrying."""
        if attempt >= self.max_attempts - 1:
            return False
        d = self.backoff_s(attempt, rng)
        if floor_s is not None and floor_s > 0:
            d = max(d, floor_s)
        if deadline is None:
            deadline = _current.get()
        if deadline is not None:
            left = deadline.remaining()
            if left <= 0:
                return False
            d = min(d, left)
        METRICS.counter("retries_slept").inc()
        Tracer.instance().event("retry", attempt=attempt + 1,
                                backoff_ms=round(d * 1e3, 1))
        time.sleep(d)
        return not (deadline is not None and deadline.expired())


def failover_retry_policy(attempts: int) -> RetryPolicy:
    """The one tuning of leader-failover loops (OM and SCM clients): equal
    jitter, so the summed window outlives an election while retries of
    clients that failed together still decorrelate."""
    return RetryPolicy(base_s=0.2, cap_s=0.6, max_attempts=attempts,
                       floor_fraction=0.5)


# ---------------------------------------------------------------- health
#: StorageError codes that mean the peer (or the path to it) is unwell;
#: application answers from a healthy peer never trip its breaker
TRANSPORT_FAULT_CODES = frozenset({"UNAVAILABLE", "TIMEOUT", "IO_EXCEPTION"})


def is_transport_fault(e: BaseException) -> bool:
    """Whether an exception counts against a peer's breaker. A refused verb
    travels as an IO_EXCEPTION-coded UNIMPLEMENTED but is a healthy peer's
    answer."""
    if isinstance(e, StorageError):
        if e.code == "IO_EXCEPTION" and "UNIMPLEMENTED" in e.msg:
            return False
        return e.code in TRANSPORT_FAULT_CODES
    return isinstance(e, (OSError, ConnectionError, KeyError))


class BreakerState(Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


#: EWMA smoothing for latency and error signals: ~the last 10 samples
_ALPHA = 0.2


class PeerHealth:
    """One peer's rolling health: EWMA latency and deviation, EWMA error
    rate, and the circuit breaker. Thread-safe."""

    def __init__(self, peer: str, open_after: int, reset_s: float):
        self.peer = peer
        self._open_after = max(1, int(open_after))
        self._reset_s = reset_s
        self._lock = threading.Lock()
        self.ewma_s: Optional[float] = None
        self.ewma_dev_s = 0.0
        self.error_rate = 0.0
        self.consecutive_failures = 0
        self.samples = 0
        self._state = BreakerState.CLOSED
        self._opened_at = 0.0
        self._probe_claimed = False
        self._probe_at = 0.0

    def record_success(self, latency_s: float) -> None:
        with self._lock:
            if self.ewma_s is None:
                self.ewma_s = latency_s
            else:
                dev = abs(latency_s - self.ewma_s)
                self.ewma_dev_s += _ALPHA * (dev - self.ewma_dev_s)
                self.ewma_s += _ALPHA * (latency_s - self.ewma_s)
            self.error_rate += _ALPHA * (0.0 - self.error_rate)
            self.samples += 1
            self.consecutive_failures = 0
            if self._state is not BreakerState.CLOSED:
                # the half-open probe (or a call from before the trip)
                # succeeded: the peer is back
                self._state = BreakerState.CLOSED
                self._probe_claimed = False
                METRICS.counter("breaker_closed").inc()
                Tracer.instance().event("breaker_closed", peer=self.peer)

    def record_failure(self) -> None:
        with self._lock:
            self.error_rate += _ALPHA * (1.0 - self.error_rate)
            self.samples += 1
            self.consecutive_failures += 1
            if self._state is BreakerState.HALF_OPEN:
                # the single probe failed: OPEN again, fresh cooldown
                self._state = BreakerState.OPEN
                self._opened_at = time.monotonic()
                self._probe_claimed = False
                METRICS.counter("breaker_reopened").inc()
                Tracer.instance().event("breaker_reopened", peer=self.peer)
            elif (self._state is BreakerState.CLOSED
                  and self.consecutive_failures >= self._open_after):
                self._state = BreakerState.OPEN
                self._opened_at = time.monotonic()
                METRICS.counter("breaker_opened").inc()
                Tracer.instance().event("breaker_opened", peer=self.peer)

    @property
    def state(self) -> BreakerState:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (self._state is BreakerState.OPEN
                and time.monotonic() - self._opened_at >= self._reset_s):
            self._state = BreakerState.HALF_OPEN
            self._probe_claimed = False
            METRICS.counter("breaker_half_open").inc()

    def allow(self) -> bool:
        """May this peer be selected for traffic now? CLOSED: yes. OPEN:
        not until the cooldown ends. HALF_OPEN: one caller per reset
        window gets the probe."""
        with self._lock:
            self._maybe_half_open()
            if self._state is BreakerState.CLOSED:
                return True
            if self._state is BreakerState.HALF_OPEN:
                now = time.monotonic()
                # a claimed probe whose outcome never landed expires, so
                # the peer is never wedged half-open
                if not self._probe_claimed \
                        or now - self._probe_at >= self._reset_s:
                    self._probe_claimed = True
                    self._probe_at = now
                    return True
            return False

    def p95_s(self) -> Optional[float]:
        """EWMA-derived tail estimate; None until a sample lands."""
        with self._lock:
            if self.ewma_s is None:
                return None
            return self.ewma_s + 4.0 * self.ewma_dev_s


class HealthRegistry:
    """peer id -> PeerHealth, shared by the clients of one factory."""

    def __init__(self, open_after: int = 5, reset_s: float = 10.0,
                 hedge_floor_s: Optional[float] = None):
        self.open_after = open_after
        self.reset_s = reset_s
        #: hedge-delay floor; OZONE_TPU_HEDGE_MS overrides (milliseconds)
        self.hedge_floor_s = (
            hedge_floor_s if hedge_floor_s is not None
            else _env_f("OZONE_TPU_HEDGE_MS", 50.0) / 1000.0)
        self._peers: dict[str, PeerHealth] = {}
        self._lock = threading.Lock()

    def get(self, peer: str) -> PeerHealth:
        with self._lock:
            h = self._peers.get(peer)
            if h is None:
                h = self._peers[peer] = PeerHealth(
                    peer, self.open_after, self.reset_s)
            return h

    def success(self, peer: str, latency_s: float) -> None:
        self.get(peer).record_success(latency_s)

    def failure(self, peer: str) -> None:
        self.get(peer).record_failure()

    def observe(self, peer: str, fn: Callable, *a, **kw):
        """Run fn(*a, **kw) and fold its outcome into the peer's health.
        Only transport faults count against the breaker; an application
        error still records a success sample (the peer answered); a call
        cut short by a spent operation deadline records nothing."""
        t0 = time.monotonic()
        try:
            out = fn(*a, **kw)
        except BaseException as e:  # classify, then re-raise
            d = _current.get()
            if d is not None and d.expired():
                pass
            elif is_transport_fault(e):
                self.failure(peer)
            else:
                self.success(peer, time.monotonic() - t0)
            raise
        self.success(peer, time.monotonic() - t0)
        return out

    def allow(self, peer: str) -> bool:
        return self.get(peer).allow()

    def usable(self, peer: str) -> bool:
        """Non-claiming breaker check for selection (ordering, spare
        counting): anything not OPEN is usable. Unlike allow() it never
        consumes the half-open probe."""
        ok = self.get(peer).state is not BreakerState.OPEN
        if not ok:
            METRICS.counter("breaker_skips").inc()
            Tracer.instance().event("breaker_skip", peer=peer)
        return ok

    def open_peers(self) -> list[str]:
        """Peers whose breaker refuses traffic right now."""
        with self._lock:
            peers = list(self._peers.values())
        return [h.peer for h in peers if h.state is BreakerState.OPEN]

    def preferred(self, peers: Sequence[str]) -> list[str]:
        """Selection order: usable peers first, fastest EWMA first (peers
        with no sample keep their position), OPEN peers last."""
        def key(i_p):
            i, p = i_p
            h = self.get(p)
            lat = h.ewma_s if h.ewma_s is not None else 0.0
            return (h.state is BreakerState.OPEN, lat, i)

        return [p for _, p in sorted(enumerate(peers), key=key)]

    def hedge_delay_s(self, peer: str) -> float:
        """How long a call to `peer` may run before a hedge fires: its P95
        EWMA, floored by hedge_floor_s (a cold peer gets the floor)."""
        p95 = self.get(peer).p95_s()
        return max(self.hedge_floor_s, p95 or 0.0)


_default_registry: Optional[HealthRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> HealthRegistry:
    """Process-wide registry for components built without a factory."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = HealthRegistry()
        return _default_registry


# --------------------------------------------------------------- hedging
#: shared hedge executor. It carries primaries too (a racer needs its
#: primary abandonable, which blocking IO is not), so it is sized for the
#: process's read concurrency
_HEDGE_THREADS = 32
_hedge_pool: Optional[ThreadPoolExecutor] = None
_hedge_pool_lock = threading.Lock()


def _hedge_executor() -> ThreadPoolExecutor:
    global _hedge_pool
    with _hedge_pool_lock:
        if _hedge_pool is None:
            _hedge_pool = ThreadPoolExecutor(
                max_workers=_HEDGE_THREADS, thread_name_prefix="hedge")
        return _hedge_pool


class HedgeWinner:
    """Outcome of a hedged race: the single consumed result."""

    __slots__ = ("value", "index")

    def __init__(self, value, index: int):
        self.value = value
        self.index = index  # 0 = primary, 1.. = hedge rank


class HedgeGroup:
    """Race a primary callable against hedges, first success wins.

    The primary runs at once; each hedge fires after `delay_s` without a
    result, or at once when a branch fails outright. Exactly one result
    is consumed; losers still pending finish on the hedge pool and their
    results are dropped."""

    def run(self, primary: Callable[[], object],
            hedges: Iterable[Callable[[], object]] = (),
            delay_s: float = 0.05,
            deadline: Optional[Deadline] = None) -> HedgeWinner:
        if deadline is None:
            deadline = _current.get()
        ex = _hedge_executor()
        todo = list(hedges)
        futs: dict[Future, int] = {}
        fired = 0
        errors: list[BaseException] = []
        ctx = Tracer.instance().inject()

        def fire(fn: Callable[[], object], idx: int) -> None:
            if idx > 0:
                METRICS.counter("hedges_fired").inc()
                Tracer.instance().event("hedge_fired", idx=idx)
            futs[ex.submit(self._wrap(fn, deadline, ctx))] = idx

        fire(primary, 0)
        while True:
            if not futs:
                if not todo:
                    raise errors[-1]  # every branch failed: surface the last
                fired += 1
                fire(todo.pop(0), fired)
                continue
            budget = delay_s if todo else None
            if deadline is not None:
                deadline.check("hedge")
                left = deadline.remaining()
                if not math.isinf(left):
                    budget = left if budget is None else min(budget, left)
            done, _pending = _fwait(list(futs), timeout=budget,
                                    return_when=FIRST_COMPLETED)
            failed_this_round = False
            for f in done:
                idx = futs.pop(f)
                err = f.exception()
                if err is None:
                    if idx > 0:
                        METRICS.counter("hedges_won").inc()
                        Tracer.instance().event("hedge_won", idx=idx)
                    return HedgeWinner(f.result(), idx)
                errors.append(err)
                failed_this_round = True
            if todo and (failed_this_round or not done):
                # primary past its grace window, or a branch failed
                # outright: bring the next hedge into the race
                fired += 1
                fire(todo.pop(0), fired)

    @staticmethod
    def _wrap(fn: Callable[[], object], deadline: Optional[Deadline],
              trace_ctx: str = ""):
        def run():
            # branches run on the shared pool: the deadline and the trace
            # context travel explicitly
            with activate(deadline), Tracer.instance().activate(trace_ctx):
                return fn()

        return run
