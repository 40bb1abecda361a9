# ozlint: path ozone_tpu_torch/codec/_fixture.py
"""Known-good corpus for `span-on-dispatch`: every device edge runs
under an open span, a fabricated record_span, or a carried context, and
handlers register through RpcServer.add_service."""
import torch

from ozone_tpu_torch.utils.tracing import Tracer


def launch_traced(lib, data, out):
    with Tracer.instance().span("codec:dispatch"):
        return lib.fused_encode_crc(data.data_ptr(), out.data_ptr())


def pull_fabricated(t, t0, t1):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    Tracer.instance().record_span("codec:device_dispatch", t0, t1)
    return host


def sync_carried(done, ctx):
    with Tracer.instance().activate(ctx):
        done.synchronize()


def plain_copy(dst, src):
    # a blocking copy is no dispatch edge
    dst.copy_(src)


def register_handler(server, fn):
    server.add_service("svc", {"Verb": fn})
