# ozlint: path ozone_tpu_torch/storage/_fixture.py
"""Known-bad corpus for `blocking-under-lock`: blocking calls lexically
inside a held lock — the dispatcher/double-buffer race-detector shape."""
import time


class Worker:
    def tick(self):
        with self._lock:
            time.sleep(0.5)  # convoy: every other thread queues here

    def collect(self, fut):
        with self._state_lock:
            return fut.result()  # future join under the lock

    def pump(self):
        self._mutex.acquire()
        item = self._queue.get()  # queue wait between acquire/release
        self._mutex.release()
        return item

    def flush(self, batch):
        with self._cond:
            self._dispatch(batch)  # device dispatch while holding it
