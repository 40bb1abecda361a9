"""Everything a run makes from `--seed`: object bytes, the order of
operations, arrival gaps. The same seed gives the same inputs; every seed
gives the same multiset of sizes, operations and gaps, in another order,
so that seeds change what is read and written but not how much."""

from __future__ import annotations

import math

import numpy as np

MASK64 = (1 << 64) - 1


def _seq(seed: int, *tags: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed & MASK64, *tags])


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(_seq(seed, *tags)))


#: tags that keep the streams of one seed apart
PRELOAD, PUT_POOL, ORDER, GAPS, CLIENT, ENCODE, SAMPLE = range(1, 8)


def object_bytes(seed: int, tag: int, index: int, nbytes: int) -> np.ndarray:
    """The bytes of object `index` of stream `tag` (read-only uint8)."""
    return np.frombuffer(rng(seed, tag, index).bytes(nbytes), dtype=np.uint8)


def poisson_arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of round(rate * seconds)
    arrivals: the exponential distribution's quantiles at (i + 0.5) / n as
    gaps, shuffled by the seed, scaled so that the n gaps span the window,
    the first arrival at 0."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[rng(seed, GAPS).permutation(n)]
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def op_sequence(seed: int, stream: int, weights: dict, n: int) -> list[str]:
    """n operation names in blocks of sum(weights) (integer weights), each
    block holding every op its weight's number of times, shuffled by the
    seed."""
    names = sorted(weights)
    block = [name for name in names for _ in range(int(weights[name]))]
    if not block:
        raise ValueError(f"no operations in {weights}")
    g = rng(seed, ORDER, stream)
    out: list[str] = []
    while len(out) < n:
        out.extend(block[i] for i in g.permutation(len(block)))
    return out[:n]


def object_order(seed: int, client: int, clients: int, objects: int) -> np.ndarray:
    """The order in which a closed-loop client visits `objects` preloaded
    objects: one seed-shuffled permutation, each client starting at its own
    offset, so that all clients together read every object about equally
    often."""
    perm = rng(seed, ORDER).permutation(objects)
    start = (client * objects) // max(1, clients)
    return np.roll(perm, -start)


def sampled(seed: int, stream: int, index: int, share: float) -> bool:
    """Whether answer `index` of `stream` is among those compared: a draw
    from the seed, so that the sample does not depend on timing."""
    return rng(seed, SAMPLE, stream, index).random() < share


def percentile(values, q: float) -> float:
    """The nearest-rank q-quantile (0 < q <= 1) of `values`."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(0, math.ceil(q * len(vals)) - 1)]
