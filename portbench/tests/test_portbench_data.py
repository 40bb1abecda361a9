"""What the benchmark makes from `--seed`: the same seed, the same inputs;
every seed the same amount of work."""

from __future__ import annotations

import numpy as np

from portbench.harness import data

BIG = 3_000_000_019  # more than 32 signed bits hold


def test_object_bytes_follow_the_seed():
    a = data.object_bytes(BIG, data.PRELOAD, 3, 4096)
    assert np.array_equal(a, data.object_bytes(BIG, data.PRELOAD, 3, 4096))
    assert not np.array_equal(a, data.object_bytes(BIG + 1, data.PRELOAD, 3, 4096))
    assert not np.array_equal(a, data.object_bytes(BIG, data.PUT_POOL, 3, 4096))


def test_arrivals_same_gaps_other_order():
    a = data.poisson_arrivals(BIG, 5.0, 30.0)
    b = data.poisson_arrivals(BIG + 7, 5.0, 30.0)
    assert len(a) == len(b) == 150 and a[0] == 0.0
    assert np.allclose(np.sort(np.diff(np.append(a, 30.0))),
                       np.sort(np.diff(np.append(b, 30.0))))
    assert not np.allclose(a, b)
    assert np.array_equal(a, data.poisson_arrivals(BIG, 5.0, 30.0))


def test_op_sequence_keeps_the_mix():
    seq = data.op_sequence(BIG, 1, {"get": 19, "put": 1}, 400)
    assert seq.count("put") == 20 and seq.count("get") == 380
    assert seq == data.op_sequence(BIG, 1, {"get": 19, "put": 1}, 400)
    assert seq != data.op_sequence(BIG + 1, 1, {"get": 19, "put": 1}, 400)


def test_object_order_covers_every_object():
    orders = [data.object_order(BIG, c, 4, 128) for c in range(4)]
    for o in orders:
        assert sorted(o.tolist()) == list(range(128))
    assert len({int(o[0]) for o in orders}) == 4


def test_sampling_is_a_draw_from_the_seed():
    picks = [data.sampled(BIG, 2, i, 0.25) for i in range(400)]
    assert picks == [data.sampled(BIG, 2, i, 0.25) for i in range(400)]
    assert 50 < sum(picks) < 150


def test_percentile_nearest_rank():
    assert data.percentile([5, 1, 3, 2, 4], 0.5) == 3
    assert data.percentile(list(range(1, 101)), 0.95) == 95
