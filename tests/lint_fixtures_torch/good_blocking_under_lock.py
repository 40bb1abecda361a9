# ozlint: path ozone_tpu_torch/storage/_fixture.py
"""Known-good corpus for `blocking-under-lock`: state mutation under the
lock, blocking work outside it; Condition.wait is exempt (it releases)."""
import time


class Worker:
    def tick(self):
        with self._lock:
            wait = self._deficit / self._rate
        time.sleep(wait)  # paced OUTSIDE the lock

    def collect(self, fut):
        out = fut.result()  # join first...
        with self._state_lock:
            self._results.append(out)  # ...book under the lock
        return out

    def pump(self):
        with self._cond:
            while not self._ready:
                self._cond.wait(self._next_wakeup())  # releases the lock
            batch = self._take_locked()
        self._dispatch(batch)  # chip dispatch with no lock held
        return batch
