"""Pipeline and replication-config model.

Port of `ozone_tpu/scm/pipeline.py` (the reference's ReplicationConfig
hierarchy and SCM Pipeline: a set of datanodes carrying one replication
scheme; for EC, node i holds replica index i+1).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from ozone_tpu_torch.codec.api import CoderOptions


class ReplicationType(Enum):
    STANDALONE = "STANDALONE"
    RATIS = "RATIS"
    EC = "EC"


@dataclass(frozen=True)
class ReplicationConfig:
    """Replication scheme of a bucket/key/container."""

    type: ReplicationType
    factor: int = 1  # RATIS/STANDALONE replica count
    ec: Optional[CoderOptions] = None

    @classmethod
    def from_ec(cls, ec: CoderOptions) -> "ReplicationConfig":
        return cls(ReplicationType.EC, factor=ec.all_units, ec=ec)

    @classmethod
    def parse(cls, s: str) -> "ReplicationConfig":
        """Parse "RATIS/THREE", "RATIS/1", "rs-6-3-1024k" style strings."""
        s = s.strip()
        up = s.upper()
        if up.startswith("RATIS") or up.startswith("STANDALONE"):
            t = ReplicationType.RATIS if up.startswith("RATIS") else \
                ReplicationType.STANDALONE
            factor = 3
            if "/" in s:
                f = s.split("/")[1].upper()
                factor = {"ONE": 1, "THREE": 3}.get(f) or int(f)
            return cls(t, factor=factor)
        return cls.from_ec(CoderOptions.parse(s))

    @property
    def required_nodes(self) -> int:
        return self.ec.all_units if self.ec else self.factor

    def __str__(self) -> str:
        if self.type is ReplicationType.EC:
            return str(self.ec)
        return f"{self.type.value}/{self.factor}"


class PipelineState(Enum):
    ALLOCATED = "ALLOCATED"
    OPEN = "OPEN"
    DORMANT = "DORMANT"
    CLOSED = "CLOSED"


class _PipelineIdAllocator:
    """Monotonic pipeline-id source that can be advanced past persisted
    or ring-issued ids: a regenerated id colliding with one a datanode
    still serves a raft group under would mis-address writes."""

    def __init__(self):
        self._last = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._last += 1
            return self._last

    def advance_past(self, pipeline_id: int) -> None:
        with self._lock:
            self._last = max(self._last, int(pipeline_id))


_pipeline_ids = _PipelineIdAllocator()


@dataclass
class Pipeline:
    """An ordered set of datanodes carrying one replication scheme; for EC,
    node i (0-based) holds replica index i+1, data units first."""

    replication: ReplicationConfig
    nodes: list[str]  # datanode ids, ordered
    id: int = field(default_factory=_pipeline_ids.next)
    state: PipelineState = PipelineState.OPEN

    def __post_init__(self):
        if len(self.nodes) != self.replication.required_nodes:
            raise ValueError(
                f"pipeline needs {self.replication.required_nodes} nodes, "
                f"got {len(self.nodes)}"
            )
