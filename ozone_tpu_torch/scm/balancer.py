"""Container balancer: move replicas from over- to under-utilized nodes.

Port of `ozone_tpu/scm/balancer.py` (the reference's ContainerBalancer
with ContainerBalancerTask's FindSourceStrategy and FindTargetStrategy):
the HEALTHY, IN_SERVICE nodes above the band of `threshold` around the
cluster's mean utilization are sources, those below it targets; an
iteration moves at most `max_moves_per_iteration` containers and
`max_size_per_iteration` bytes, one per source. The SCM persists the
config and the progress counters as the balancer's service-state row
(`scm/scm.py`).

Where the port departs from the reference on purpose, each as upstream
does it:
- A move queues the ReplicateCommand to the target only, and the
  DeleteReplicaCommand to the source once the target reports the copy
  (`settle`, MoveManager's order). The reference queues both at once;
  the two nodes heartbeat independently, so the source may delete its
  replica before the target has pulled it.
- A container is moved once at a time, and the replication manager
  leaves its excess replica to the move (`moving`), which would
  otherwise delete the new copy. A second move of it planned before the
  first copy is reported could pick the same target, which refuses it.
- An iteration waits for the previous one's moves to complete, and a
  move is planned only where neither end leaves the band once the
  replica's reported bytes have moved (canSizeEnterTarget and
  canSizeLeaveSource). The reference sends every source's largest
  container to the coldest node, which overshoots and moves containers
  back and forth once a replica is larger than the band.
With one hot and one cold node the moves are the reference's.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional

from ozone_tpu_torch.scm.container_manager import ContainerManager
from ozone_tpu_torch.scm.node_manager import NodeManager
from ozone_tpu_torch.scm.replication_manager import (
    DeleteReplicaCommand,
    ReplicateCommand,
)
from ozone_tpu_torch.storage.ids import ContainerState

log = logging.getLogger(__name__)


@dataclass
class BalancerConfig:
    threshold: float = 0.10  # the +-10% band around mean utilization
    max_moves_per_iteration: int = 5
    max_size_per_iteration: int = 10 * 1024**3


@dataclass
class Move:
    container_id: int
    replica_index: int
    source: str
    target: str
    size: int


@dataclass
class BalancerStatus:
    running: bool = False
    iterations: int = 0
    moves_scheduled: int = 0
    bytes_scheduled: int = 0
    last_iteration_moves: list[Move] = field(default_factory=list)


class ContainerBalancer:
    def __init__(
        self,
        containers: ContainerManager,
        nodes: NodeManager,
        config: Optional[BalancerConfig] = None,
    ):
        self.containers = containers
        self.nodes = nodes
        # a fresh default per balancer: restores and operator overrides
        # mutate it
        self.config = config if config is not None else BalancerConfig()
        self.status = BalancerStatus()
        #: (container, replica index) -> [the move in flight, whether its
        #: source delete went out, when it was planned]
        self.inflight: dict[tuple[int, int], list] = {}
        self.clock = time.monotonic

    def _utilization(self) -> dict[str, float]:
        return {n.dn_id: (n.used_bytes / n.capacity_bytes
                          if n.capacity_bytes else 0.0)
                for n in self.nodes.healthy_in_service()}

    def run_iteration(self) -> list[Move]:
        """One balancing iteration: schedule up to max_moves moves. While
        the previous iteration's moves are in flight it plans nothing and
        does not count."""
        if self.inflight:
            self.status.last_iteration_moves = []
            return []
        util = self._utilization()
        if not util:
            return []
        avg = sum(util.values()) / len(util)
        cap = {n.dn_id: n.capacity_bytes
               for n in self.nodes.healthy_in_service()}
        #: utilization each node gains (or loses) by this iteration's moves
        planned = dict.fromkeys(util, 0.0)

        def fits(src: str, t: str, size: int) -> bool:
            # neither end may leave the band; sizes are the replica's
            # reported bytes
            if not size:
                return True
            return (util[t] + planned[t] + size / max(cap[t], 1)
                    <= avg + self.config.threshold
                    and util[src] + planned[src] - size / max(cap[src], 1)
                    >= avg - self.config.threshold)
        over = sorted(
            (d for d, u in util.items() if u > avg + self.config.threshold),
            key=lambda d: -util[d])
        under = sorted(
            (d for d, u in util.items() if u < avg - self.config.threshold),
            key=lambda d: util[d])
        moves: list[Move] = []
        budget = self.config.max_size_per_iteration
        # one move per container at a time: the SCM learns of a copy only
        # from the target's report, so a second move planned before it
        # lands may pick the same target
        busy = {cid for cid, _ in self.inflight}
        for src in over:
            if len(moves) >= self.config.max_moves_per_iteration or not under:
                break
            # the source's closed replicas, largest container first
            cands = [
                (c, c.replicas[src])
                for c in self.containers.containers()
                if src in c.replicas
                and c.state in (ContainerState.CLOSED,
                                ContainerState.QUASI_CLOSED)
                and c.id not in busy
            ]
            cands.sort(key=lambda t: -t[0].used_bytes)
            for c, replica in cands:
                if len(moves) >= self.config.max_moves_per_iteration:
                    break
                if c.used_bytes > budget:
                    continue
                target = next((t for t in under if t not in c.replicas
                               and fits(src, t, replica.used_bytes)), None)
                if target is None:
                    continue
                moves.append(Move(c.id, replica.replica_index, src, target,
                                  c.used_bytes))
                busy.add(c.id)
                planned[target] += replica.used_bytes / max(cap[target], 1)
                planned[src] -= replica.used_bytes / max(cap[src], 1)
                budget -= c.used_bytes
                break  # one move per source per iteration
        for m in moves:
            self.nodes.queue_command(
                m.target,
                ReplicateCommand(m.container_id, source=m.source,
                                 target=m.target,
                                 replica_index=m.replica_index))
            self.inflight[(m.container_id, m.replica_index)] = [
                m, False, self.clock()]
        self.status.iterations += 1
        self.status.moves_scheduled += len(moves)
        self.status.bytes_scheduled += sum(m.size for m in moves)
        self.status.last_iteration_moves = moves
        return moves

    def moving(self, container_id: int, replica_index: int) -> bool:
        return (container_id, replica_index) in self.inflight

    #: seconds after which a move that never completed is forgotten
    MOVE_TIMEOUT_S = 600.0

    def settle(self) -> list[Move]:
        """Advance the moves in flight: queue the source's delete once the
        target reports the copy CLOSED; forget a move once the source no
        longer reports its replica, or once its target is gone or it ran
        past MOVE_TIMEOUT_S. Returns the moves completed."""
        from ozone_tpu_torch.scm.node_manager import NodeState

        done = []
        for key, entry in list(self.inflight.items()):
            m, delete_sent, t0 = entry
            c = self.containers.get_or_none(m.container_id)
            if c is None or self.clock() - t0 > self.MOVE_TIMEOUT_S:
                del self.inflight[key]
                continue
            tgt = c.replicas.get(m.target)
            copied = (tgt is not None and tgt.replica_index == m.replica_index
                      and tgt.state == "CLOSED")
            if delete_sent:
                if m.source not in c.replicas:
                    del self.inflight[key]
                    done.append(m)
                continue
            node = self.nodes.get(m.target)
            if node is None or node.state is NodeState.DEAD:
                del self.inflight[key]  # the copy cannot land
                continue
            if copied:
                self.nodes.queue_command(
                    m.source, DeleteReplicaCommand(m.container_id,
                                                   m.replica_index))
                entry[1] = True
        return done
