# ozlint: path ozone_tpu_torch/codec/_fixture.py
"""Known-bad corpus for `dispatch-shape-stability`: launch plans cached
on a per-call width (every new request shape misses and rebuilds the
plan) or keyed on an erasure pattern with no cache bound."""
from functools import cache, lru_cache

import torch


@lru_cache(maxsize=64)
def staging_plan(options, batch, device):
    # keyed on the request's batch width: one plan per width
    return torch.zeros((batch, options.data_units), device=device)


@lru_cache(maxsize=None)
def decode_plan(options, valid, erased, device):
    # keyed on the erasure pattern with no bound: grows with every
    # pattern a failing cluster shows it
    return torch.eye(len(erased), device=device)


@cache
def lost_plan(options, lost):
    return options, lost
