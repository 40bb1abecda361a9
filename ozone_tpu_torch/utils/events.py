"""Typed pub/sub event queue.

Port of `EventQueue` from `ozone_tpu/utils/events.py` (the reference's
EventQueue, hdds/server/events/EventQueue.java): handlers subscribe to
topics, and publish dispatches to them in subscription order:
synchronously by default (the deterministic mode the reference's tests
and minicluster use), or, with `async_dispatch=True`, on one
`event-queue` worker thread in publish order, `flush()` waiting until the
queue has drained (the reference's FixedThreadPoolWithAffinityExecutor
with one thread). A handler's error is logged and reaches neither the
publisher nor the next handler. `EventWatcher` (EventWatcher.java with
its LeaseManager) tracks a started event by id until its completion
event arrives; a lease that runs out re-publishes the payload (up to
`max_retries`), then drops it and calls `on_timeout`.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)

Handler = Callable[[Any], None]


class EventQueue:
    def __init__(self, async_dispatch: bool = False):
        self._handlers: dict[str, list[Handler]] = defaultdict(list)
        self._lock = threading.Lock()
        self._async = async_dispatch
        self._q: "queue.Queue[tuple[str, Any]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        if async_dispatch:
            self._worker = threading.Thread(
                target=self._drain, name="event-queue", daemon=True)
            self._worker.start()

    def subscribe(self, topic: str, handler: Handler) -> None:
        with self._lock:
            self._handlers[topic].append(handler)

    def publish(self, topic: str, payload: Any = None) -> None:
        if self._async:
            self._q.put((topic, payload))
        else:
            self._dispatch(topic, payload)

    def _dispatch(self, topic: str, payload: Any) -> None:
        with self._lock:
            handlers = list(self._handlers.get(topic, ()))
        for h in handlers:
            try:
                h(payload)
            except Exception:  # handler errors must not break the publisher
                log.exception("event handler for %s failed", topic)

    def _drain(self) -> None:
        while True:
            topic, payload = self._q.get()
            try:
                self._dispatch(topic, payload)
            finally:
                self._q.task_done()

    def flush(self) -> None:
        """Wait until every event published so far has been dispatched (a
        no-op for the synchronous queue)."""
        if self._async:
            self._q.join()


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
