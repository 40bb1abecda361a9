"""Typed pub/sub event queue.

Port of `EventQueue` from `ozone_tpu/utils/events.py` (the reference's
EventQueue, hdds/server/events/EventQueue.java): handlers subscribe to
topics and publish dispatches synchronously, in subscription order (the
deterministic mode the reference's tests and minicluster use). The
reference's worker-thread dispatch and its EventWatcher (command leases)
are not ported: no ported control loop uses them.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Any, Callable

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
