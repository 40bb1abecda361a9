# ozlint: path ozone_tpu_torch/client/_fixture.py
"""Known-bad corpus for `deadline-propagation`: every timeout shape the
old regex lint missed — keyword args, computed literals, and constants
resolved through module-level names."""
import socket
import time

CONNECT_TIMEOUT = 60.0 * 2  # computed literal behind a name


def connect(host, port):
    # literal via module constant AND a keyword arg (regex-invisible)
    sock = socket.create_connection((host, port),
                                    timeout=CONNECT_TIMEOUT)
    sock.settimeout(30)  # direct literal socket arm
    return sock


def wait_for(fut, t):
    return fut.result(timeout=5.0)  # literal timeout kwarg


def retry_loop(op):
    for _ in range(3):
        try:
            return op()
        except OSError:
            time.sleep(0.25)  # bare retry sleep, no jitter, no deadline
