"""Commit-first, term-fenced sequence-id issuance for SCM HA.

Port of `ozone_tpu/scm/sequence_id.py` (the reference's
SequenceIdGenerator, server-scm ha/SequenceIdGenerator.java:52-84): ids
are handed out ONLY from ranges already committed through the consensus
ring. The leader reserves a batch through a replicated record, waits for
the quorum commit, then issues from the batch locally; a leadership
change invalidates the local batch. Every replica's committed floor is
raised past a reserved range before any id in it is exposed, so two
leaders (or two terms of one leader) never issue the same id. An
invalidated batch's unissued tail is burned, as the reference's
invalidateBatch does on a leader change.
"""

from __future__ import annotations

import threading
from typing import Callable

#: ids reserved per ring round-trip; block ids dominate allocation
#: traffic so they get the big batch (reference default batch 1000)
DEFAULT_BATCH_SIZES = {"block": 1000, "container": 16, "pipeline": 16}


class SequenceIdGenerator:
    """Issue ids from quorum-committed ranges only.

    ``reserve_fn(kind, count) -> (lo, hi)`` must return a half-open
    range that IS ALREADY COMMITTED through the ring when it returns
    (propose + await apply); it raises when this node is not the leader.
    ``invalidate()`` must be called on any leadership change.
    """

    def __init__(
        self,
        reserve_fn: Callable[[str, int], tuple[int, int]],
        batch_sizes: dict[str, int] | None = None,
    ):
        self._reserve_fn = reserve_fn
        self._batch_sizes = dict(batch_sizes or DEFAULT_BATCH_SIZES)
        self._lock = threading.Lock()  # guards batches/free/epoch
        self._batches: dict[str, list[int]] = {}  # kind -> [cursor, hi)
        self._free: dict[str, list[int]] = {}  # released, never-exposed ids
        self._epoch = 0
        # one reservation in flight per kind; other callers of the same
        # kind wait on it instead of burning parallel ranges
        self._reserve_locks: dict[str, threading.Lock] = {}

    def next(self, kind: str) -> int:
        """One globally-unique id. May block on a ring round-trip when
        the local batch is exhausted; raises the reserve_fn's error
        (NotRaftLeaderError) when this node cannot reserve."""
        while True:
            with self._lock:
                epoch = self._epoch
                free = self._free.get(kind)
                if free:
                    return free.pop()
                b = self._batches.get(kind)
                if b is not None and b[0] < b[1]:
                    b[0] += 1
                    return b[0] - 1
                rlock = self._reserve_locks.setdefault(
                    kind, threading.Lock())
            with rlock:
                with self._lock:
                    b = self._batches.get(kind)
                    if (b is not None and b[0] < b[1]) \
                            or self._free.get(kind):
                        continue  # another thread refilled while we waited
                count = self._batch_sizes.get(kind, 64)
                # ring round-trip OUTSIDE every other lock: the apply
                # path (raft-node lock -> container lock) must stay free
                lo, hi = self._reserve_fn(kind, count)
                with self._lock:
                    if self._epoch == epoch:
                        self._batches[kind] = [lo, hi]
                    # epoch moved mid-reservation (step-down raced the
                    # commit): burn the committed range — issuing from it
                    # here would be safe for uniqueness (no other node
                    # can ever reserve below the raised floor) but this
                    # node may no longer be entitled to serve

    @property
    def epoch(self) -> int:
        """Invalidation epoch; capture BEFORE next() to hand release()
        a token proving the id predates no step-down."""
        with self._lock:
            return self._epoch

    def release(self, kind: str, id_: int, epoch: int | None = None) -> None:
        """Return a never-exposed id for reuse. Only ids obtained from
        next() may be released, and at most once — they re-enter the
        local free list, which is still unique-by-construction because
        no other node can ever reserve below this range's committed
        ceiling. `epoch` (captured via .epoch before the matching
        next()) keeps the documented burn contract exact: if the
        generator was invalidated since, the id belongs to a burned
        batch and is dropped instead of re-entering the fresh free
        list (a deposed-then-re-elected leader must not issue from a
        batch its step-down burned)."""
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return
            self._free.setdefault(kind, []).append(id_)

    def invalidate(self) -> None:
        """Leadership changed: burn local batches and free lists (the
        reference's invalidateBatch on notifyLeaderChanged). Safe to
        call from raft callbacks — only takes the generator's own
        lock."""
        with self._lock:
            self._epoch += 1
            self._batches.clear()
            self._free.clear()
