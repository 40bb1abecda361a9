"""Typed pub/sub event queue.

Port of `EventQueue` from `ozone_tpu/utils/events.py` (the reference's
EventQueue, hdds/server/events/EventQueue.java): handlers subscribe to
topics and publish dispatches synchronously, in subscription order (the
deterministic mode the reference's tests and minicluster use). The
reference's worker-thread dispatch is not ported: no ported control loop
uses it. `EventWatcher` (EventWatcher.java with its LeaseManager) tracks a
started event by id until its completion event arrives; a lease that
runs out re-publishes the payload (up to `max_retries`), then drops it
and calls `on_timeout`.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)

Handler = Callable[[Any], None]


class EventQueue:
    def __init__(self):
        self._handlers: dict[str, list[Handler]] = defaultdict(list)
        self._lock = threading.Lock()

    def subscribe(self, topic: str, handler: Handler) -> None:
        with self._lock:
            self._handlers[topic].append(handler)

    def publish(self, topic: str, payload: Any = None) -> None:
        for h in list(self._handlers.get(topic, ())):
            try:
                h(payload)
            except Exception:  # handler errors must not break the publisher
                log.exception("event handler for %s failed", topic)


class EventWatcher:
    """Command-ack tracking with a lease timeout. `check_leases()` is one
    sweep (deterministic for tests, which may replace `_time`);
    `start_timer()` runs it on a background thread."""

    def __init__(
        self,
        queue: EventQueue,
        start_topic: str,
        completion_topic: str,
        lease_timeout_s: float = 10.0,
        on_timeout: Optional[Handler] = None,
        max_retries: int = 3,
    ):
        self._time = time.monotonic
        self.queue = queue
        self.start_topic = start_topic
        self.completion_topic = completion_topic
        self.lease_timeout_s = lease_timeout_s
        self.on_timeout = on_timeout
        self.max_retries = max_retries
        #: id -> (payload, deadline, retries)
        self._pending: dict[Any, tuple[Any, float, int]] = {}
        self._lock = threading.Lock()
        self._timer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        queue.subscribe(completion_topic, self._on_completion)

    def watch(self, event_id: Any, payload: Any) -> None:
        """Publish on the start topic and track until its completion."""
        with self._lock:
            self._pending[event_id] = (
                payload, self._time() + self.lease_timeout_s, 0)
        self.queue.publish(self.start_topic, payload)

    def _on_completion(self, event_id: Any) -> None:
        with self._lock:
            self._pending.pop(event_id, None)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def check_leases(self) -> list[Any]:
        """Expire the overdue leases: re-publish (up to max_retries), then
        drop and call on_timeout. Returns the ids that timed out."""
        now = self._time()
        with self._lock:
            expired = [(eid, entry) for eid, entry in self._pending.items()
                       if entry[1] <= now]
        timed_out = []
        for eid, entry in expired:
            payload, _deadline, retries = entry
            with self._lock:
                # the completion may have landed since, and the id been
                # watched again: act only on the exact expired lease
                if self._pending.get(eid) is not entry:
                    continue
                retry = retries < self.max_retries
                if retry:
                    self._pending[eid] = (
                        payload, self._time() + self.lease_timeout_s,
                        retries + 1)
                else:
                    self._pending.pop(eid, None)
            if retry:
                self.queue.publish(self.start_topic, payload)
            else:
                timed_out.append(eid)
                if self.on_timeout is not None:
                    try:
                        self.on_timeout(payload)
                    except Exception:
                        log.exception("event watcher timeout hook failed")
        return timed_out

    def start_timer(self, interval_s: float = 1.0) -> None:
        if self._timer is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                self.check_leases()

        self._timer = threading.Thread(target=loop, daemon=True,
                                       name="event-watcher")
        self._timer.start()

    def stop(self) -> None:
        self._stop.set()
        if self._timer is not None:
            self._timer.join(timeout=1.0)
            self._timer = None
