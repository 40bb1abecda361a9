# ozlint: path ozone_tpu_torch/net/_fixture.py
"""Known-good corpus for `bounded-queue`: every server-side queue
carries an explicit bound (or a reasoned suppression naming the
machinery that bounds its depth)."""

import collections
import queue

DEPTH = 256


class Dispatcher:
    def __init__(self, depth):
        self.requests = queue.Queue(maxsize=DEPTH)
        self.backlog = collections.deque(maxlen=depth)
        # bound as the second positional arg is a bound too
        self.recent = collections.deque([], 64)

    def make_priority(self, depth):
        # a non-constant bound is assumed deliberate
        return queue.PriorityQueue(depth)

    def make_acked(self):
        # depth provably bounded elsewhere: callers block on the ack
        return queue.Queue()  # ozlint: allow[bounded-queue] -- fixture: callers block on an ack condition, depth capped by the ack window
