# ozlint: path ozone_tpu_torch/client/_fixture.py
"""Known-good corpus for `deadline-propagation`: every timeout derives
from the ambient Deadline, an env knob, or a dynamic expression."""
import socket

from ozone_tpu_torch.client import resilience


def connect(host, port, default_s):
    sock = socket.create_connection(
        (host, port),
        timeout=resilience.op_timeout(default_s, "connect"))
    sock.settimeout(resilience.op_timeout(default_s, "io"))
    return sock


def wait_for(fut, deadline):
    return fut.result(timeout=deadline.remaining())


def retry_loop(op, policy):
    for attempt in range(8):
        try:
            return op()
        except OSError:
            if not policy.sleep(attempt):  # jittered + deadline-clipped
                raise
