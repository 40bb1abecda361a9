# ozlint: path ozone_tpu_torch/net/_fixture.py
"""Known-good corpus for `error-swallowing`: handled, logged, or
suppressed with a written reason."""
import logging

log = logging.getLogger(__name__)


def apply_entry(store, entry):
    try:
        store.apply(entry)
    except Exception as e:
        log.warning("apply of %s failed: %s", entry, e)
        raise


def close_quietly(sock):
    try:
        sock.close()
    except OSError:  # ozlint: allow[error-swallowing] -- best-effort teardown, nothing to recover
        pass
