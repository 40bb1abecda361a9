"""Operation deadlines and per-peer health, as far as the EC writer uses them.

Trimmed port of `ozone_tpu/client/resilience.py`: the ambient operation
`Deadline`, the transport-fault classifier, and a `HealthRegistry` whose
`observe` folds each RPC's outcome into a per-peer circuit breaker that
the writer consults (`open_peers`) when it allocates a block group.
Retry policies, hedging and latency EWMAs are not ported yet.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import threading
import time
from typing import Callable, Optional

from ozone_tpu_torch.storage.ids import StorageError

#: StorageError code for a spent operation budget
DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"

#: StorageError codes that mean the peer (or the path to it) is unwell;
#: application answers from a healthy peer never trip its breaker
TRANSPORT_FAULT_CODES = frozenset({"UNAVAILABLE", "TIMEOUT", "IO_EXCEPTION"})


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
        if self.expired():
            raise StorageError(
                DEADLINE_EXCEEDED,
                f"operation {self.op} deadline exceeded"
                + (f" before {verb}" if verb else ""))


_current: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("ozone_tpu_torch_deadline", default=None)


def current() -> Optional[Deadline]:
    """The ambient deadline of this thread's operation, if any."""
    return _current.get()


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


def is_transport_fault(e: BaseException) -> bool:
    """Whether an exception counts against a peer's breaker. A refused verb
    travels as an IO_EXCEPTION-coded UNIMPLEMENTED but is a healthy peer's
    answer."""
    if isinstance(e, StorageError):
        if e.code == "IO_EXCEPTION" and "UNIMPLEMENTED" in e.msg:
            return False
        return e.code in TRANSPORT_FAULT_CODES
    return isinstance(e, (OSError, ConnectionError, KeyError))


class PeerHealth:
    """One peer's circuit breaker: open after `open_after` consecutive
    transport faults, until `reset_s` has passed or a call succeeds."""

    def __init__(self, peer: str, open_after: int, reset_s: float):
        self.peer = peer
        self._open_after = max(1, int(open_after))
        self._reset_s = reset_s
        self._lock = threading.Lock()
        self.consecutive_failures = 0
        self._opened_at: Optional[float] = None

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self.consecutive_failures >= self._open_after:
                self._opened_at = time.monotonic()

    def is_open(self) -> bool:
        with self._lock:
            return (self._opened_at is not None
                    and time.monotonic() - self._opened_at < self._reset_s)


class HealthRegistry:
    """peer id -> PeerHealth, shared by the clients of one factory."""

    def __init__(self, open_after: int = 5, reset_s: float = 10.0):
        self.open_after = open_after
        self.reset_s = reset_s
        self._peers: dict[str, PeerHealth] = {}
        self._lock = threading.Lock()

    def get(self, peer: str) -> PeerHealth:
        with self._lock:
            h = self._peers.get(peer)
            if h is None:
                h = self._peers[peer] = PeerHealth(
                    peer, self.open_after, self.reset_s)
            return h

    def success(self, peer: str) -> None:
        self.get(peer).record_success()

    def failure(self, peer: str) -> None:
        self.get(peer).record_failure()

    def observe(self, peer: str, fn: Callable, *a, **kw):
        """Run fn(*a, **kw) and fold its outcome into the peer's health;
        a call cut short by a spent operation deadline records nothing."""
        try:
            out = fn(*a, **kw)
        except BaseException as e:  # classify, then re-raise
            d = _current.get()
            if d is not None and d.expired():
                pass
            elif is_transport_fault(e):
                self.failure(peer)
            else:
                self.success(peer)
            raise
        self.success(peer)
        return out

    def open_peers(self) -> list[str]:
        """Peers whose breaker refuses traffic right now."""
        with self._lock:
            peers = list(self._peers.values())
        return [h.peer for h in peers if h.is_open()]


_default_registry: Optional[HealthRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> HealthRegistry:
    """Process-wide registry for components built without a factory."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = HealthRegistry()
        return _default_registry
