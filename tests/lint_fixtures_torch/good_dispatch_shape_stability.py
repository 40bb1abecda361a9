# ozlint: path ozone_tpu_torch/codec/_fixture.py
"""Known-good corpus for `dispatch-shape-stability`: launch plans cached
on config-stable values; a pattern-keyed plan behind a finite bound; the
width passed at launch."""
from functools import lru_cache

import torch


@lru_cache(maxsize=512)
def decode_plan(options, valid, erased, device):
    # the recovery matrix is a kernel argument: one compiled kernel for
    # every pattern, and the pattern cache is bounded
    return torch.eye(len(erased), device=device)


@lru_cache(maxsize=64)
def encode_constants(poly, slice_bytes, device):
    return torch.zeros(slice_bytes, device=device) + poly


def launch(options, data):
    # the batch width is the tensor's, read at launch
    return data.reshape(data.shape[0], options.data_units, -1)
