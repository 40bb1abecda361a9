"""Placement policies: rack-scatter (the SCM's policy for every
pipeline), capacity and random.

Port of `ozone_tpu/scm/placement.py` (the reference's
SCMContainerPlacementRackScatter: EC spreads d+p over as many racks as
possible; SCMContainerPlacementCapacity: the less-used half of the
candidates; SCMContainerPlacementRandom; and the rack-spread validation
of SCMCommonPlacementPolicy). Candidates are the HEALTHY, IN_SERVICE
nodes with a usable volume, so a draining, in-maintenance or
storage-dead node gets no new replica. Every policy's draws on
`random.Random(seed)` are the reference's, call for call, so a seeded
port SCM picks the same nodes as a seeded `ozone_tpu` SCM.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Optional, Sequence

from ozone_tpu_torch.scm.node_manager import NodeInfo, NodeManager


class PlacementError(Exception):
    pass


class PlacementPolicy:
    def __init__(self, nodes: NodeManager, seed: Optional[int] = None):
        self.nodes = nodes
        self.rng = random.Random(seed)

    def choose(
        self, count: int, excluded: Sequence[str] = ()
    ) -> list[NodeInfo]:
        raise NotImplementedError

    def _candidates(self, excluded: Sequence[str]) -> list[NodeInfo]:
        ex = set(excluded)
        return [n for n in self.nodes.healthy_in_service()
                if n.dn_id not in ex and n.healthy_volumes != 0]


class RandomPlacement(PlacementPolicy):
    def choose(self, count, excluded=()):
        cands = self._candidates(excluded)
        if len(cands) < count:
            raise PlacementError(
                f"need {count} nodes, only {len(cands)} available"
            )
        return self.rng.sample(cands, count)


class CapacityPlacement(PlacementPolicy):
    """Prefer the less-utilized nodes: a random draw from the least-used
    half (at least `count`), so a new node is not flooded at once."""

    def choose(self, count, excluded=()):
        cands = self._candidates(excluded)
        if len(cands) < count:
            raise PlacementError(
                f"need {count} nodes, only {len(cands)} available"
            )

        def util(n: NodeInfo) -> float:
            return n.used_bytes / n.capacity_bytes if n.capacity_bytes else 0.0

        cands.sort(key=util)
        pool = cands[: max(count, len(cands) // 2 + 1)]
        return self.rng.sample(pool, count)


class RackScatterPlacement(PlacementPolicy):
    """Scatter across racks, round-robin by rack."""

    def choose(self, count, excluded=()):
        cands = self._candidates(excluded)
        if len(cands) < count:
            raise PlacementError(
                f"need {count} nodes, only {len(cands)} available"
            )
        by_rack: dict[str, list[NodeInfo]] = defaultdict(list)
        for n in cands:
            by_rack[n.rack].append(n)
        for nodes in by_rack.values():
            self.rng.shuffle(nodes)
        racks = sorted(by_rack, key=lambda r: -len(by_rack[r]))
        self.rng.shuffle(racks)
        chosen: list[NodeInfo] = []
        while len(chosen) < count:
            progressed = False
            for r in racks:
                if by_rack[r] and len(chosen) < count:
                    chosen.append(by_rack[r].pop())
                    progressed = True
            if not progressed:
                break
        if len(chosen) < count:
            raise PlacementError("insufficient nodes across racks")
        return chosen

    @staticmethod
    def validate(racks_used: int, total_racks: int, count: int) -> bool:
        """Mis-replication check: a placement is valid when it spans
        min(count, total_racks) distinct racks."""
        return racks_used >= min(count, max(total_racks, 1))
