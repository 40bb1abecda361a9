# ozlint: path ozone_tpu_torch/codec/_fixture.py
"""Known-bad corpus for `span-on-dispatch`: the port's device edges (the
kernel launch through the ctypes library, the pinned copy back, the CUDA
event record and synchronize, the pull helpers) with no active span,
and a handler put into a server's method table past add_service."""
import torch


def launch_untraced(lib, data, out):
    return lib.fused_encode_crc(data.data_ptr(), out.data_ptr())


def pull_untraced(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host


def drain_untraced(pulled):
    return finish_pull(pulled)


def register_handler(server, fn):
    # bypasses RpcServer.add_service: no server span, no trace context
    server._methods["/svc/Verb"] = ("unary", fn)


def finish_pull(pulled):
    return pulled
