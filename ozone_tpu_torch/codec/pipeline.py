"""Depth-1 device batch pipeline and the host<->device edge it shares
with the writer.

Port of `ozone_tpu/codec/pipeline.py` onto CUDA. `DeviceBatchPipeline`
keeps one batch in flight: `submit` launches the fused function on a
batch, starts the copy of its outputs into fresh pinned host tensors
(`non_blocking`, on the stream that ran the kernel) and records a CUDA
event, then returns the previous batch's outputs once its event has
fired. The degraded reader and offline reconstruction drive it, so
survivor reads and target writes of one batch run under the decode and
the device->host copy of the next, as the writer's in-flight encode
batch does.

`host_buffer`, `start_pull` and `finish_pull` are that edge, used by the
pipeline, by `client/ec_writer.py` and by the shared codec service
(`codec/service.py`) alike. On the CPU they do no copies and record no
event, and outputs that are already numpy arrays pass through.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import numpy as np
import torch

#: stripes per decode dispatch, and so the pipeline's granularity; 8
#: matches the writer's stripe_batch, and a 16-stripe group repairs as two
#: overlapped batches
DEFAULT_DECODE_BATCH = 8


def decode_batch_size(default: int = DEFAULT_DECODE_BATCH) -> int:
    """The decode batch-depth knob (OZONE_TPU_DECODE_BATCH)."""
    try:
        n = int(os.environ.get("OZONE_TPU_DECODE_BATCH", default))
    except ValueError:
        return default
    return max(1, n)


def host_buffer(shape, device: torch.device) -> torch.Tensor:
    """A fresh uint8 host tensor to stage a batch for `device`: pinned when
    the device is CUDA, so its copy there runs asynchronously. Fill it
    through `.numpy()`. Each batch takes a fresh one: PyTorch's pinned
    allocator does not hand the memory out again until the copy reading
    it has finished."""
    return torch.empty(tuple(shape), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def start_pull(outs: tuple) -> tuple:
    """Start the device->host copy of a batch's output tensors on the
    current stream (the one that ran the kernel); returns (host tensors,
    event), the event None for CPU tensors and numpy arrays."""
    if not isinstance(outs[0], torch.Tensor) or outs[0].device.type != "cuda":
        return tuple(outs), None
    hosts = []
    for t in outs:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    done = torch.cuda.Event()
    done.record()
    return tuple(hosts), done


def finish_pull(pulled: tuple) -> tuple:
    """The outputs of a `start_pull` as numpy arrays, once the copy is
    done. int32 outputs are CRC words and come back as their uint32 bit
    patterns."""
    hosts, done = pulled
    if done is not None:
        done.synchronize()
    return tuple(_host_array(h) for h in hosts)


def _host_array(h) -> np.ndarray:
    if not isinstance(h, torch.Tensor):
        return np.asarray(h)
    return h.numpy().view(np.uint32) if h.dtype == torch.int32 else h.numpy()


class DeviceBatchPipeline:
    """One device batch in flight. submit(batch) launches fn(batch), which
    returns a tuple of tensors, and returns the previous batch's (ctx, host
    outputs), or None on the first call; drain() returns the last
    in-flight batch. `ctx` rides along untouched so callers can tag
    batches (stripe indexes)."""

    def __init__(self, fn: Callable[[Any], Any]):
        self._fn = fn
        self._pending: Optional[tuple] = None

    def submit(self, batch, ctx: Any = None) -> Optional[tuple]:
        prev, self._pending = self._pending, (ctx, start_pull(self._fn(batch)))
        return self._to_host(prev)

    def drain(self) -> Optional[tuple]:
        prev, self._pending = self._pending, None
        return self._to_host(prev)

    @staticmethod
    def _to_host(entry: Optional[tuple]) -> Optional[tuple]:
        if entry is None:
            return None
        ctx, pulled = entry
        return ctx, finish_pull(pulled)


def batched(seq, n: int):
    """Yield contiguous slices of `seq` of at most n items."""
    for i in range(0, len(seq), n):
        yield seq[i:i + n]
