# ozlint: path ozone_tpu_torch/net/_fixture.py
"""Known-bad corpus for `bounded-queue`: unbounded queue construction
on server-side modules — each shape accumulates work without limit, the
collapse mode admission control exists to prevent."""

import collections
import queue


class Dispatcher:
    def __init__(self):
        # no maxsize: accepts work faster than it drains
        self.requests = queue.Queue()
        # deque without maxlen is just as unbounded
        self.backlog = collections.deque()

    def make_priority(self):
        # maxsize=0 means UNLIMITED, not zero
        return queue.PriorityQueue(0)

    def make_simple(self):
        # SimpleQueue has no bound at all
        return queue.SimpleQueue()
