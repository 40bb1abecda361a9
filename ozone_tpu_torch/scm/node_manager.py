"""SCM node management: registration, heartbeats, liveness state machine,
per-node command queues.

Port of `ozone_tpu/scm/node_manager.py` (the reference's SCMNodeManager
register + processHeartbeat with piggybacked command delivery, and
NodeStateManager's HEALTHY -> STALE -> DEAD transitions driven by
heartbeat age, with events on each transition), and the operational
states of decommission and maintenance: `set_op_state` records one,
persists it through `on_op_state_change` (the SCM store) and queues a
`set-op-state` command so the node persists it too; `seed_op_states`
installs the store's records at startup, and a (re)registering node
takes the SCM's record, else the state it echoes (the reference's
persistedOpState round trip).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Optional

from ozone_tpu_torch.utils.events import EventQueue

log = logging.getLogger(__name__)


class NodeState(Enum):
    HEALTHY = "HEALTHY"
    STALE = "STALE"
    DEAD = "DEAD"


class NodeOperationalState(Enum):
    IN_SERVICE = "IN_SERVICE"
    DECOMMISSIONING = "DECOMMISSIONING"
    DECOMMISSIONED = "DECOMMISSIONED"
    IN_MAINTENANCE = "IN_MAINTENANCE"


# event topics
STALE_NODE = "scm.stale_node"
DEAD_NODE = "scm.dead_node"
NEW_NODE = "scm.new_node"
HEALTHY_READBACK = "scm.node_healthy_again"


@dataclass
class NodeInfo:
    dn_id: str
    rack: str = "/default-rack"
    capacity_bytes: int = 0
    used_bytes: int = 0
    last_heartbeat: float = field(default_factory=time.monotonic)
    state: NodeState = NodeState.HEALTHY
    op_state: NodeOperationalState = NodeOperationalState.IN_SERVICE
    #: healthy-disk count from heartbeats (-1: not reported); 0 means the
    #: node is alive but has no usable storage, never a placement target
    healthy_volumes: int = -1
    #: when its last full container report arrived (the node manager's clock)
    last_report: float = float("-inf")


class NodeManager:
    def __init__(
        self,
        events: Optional[EventQueue] = None,
        stale_after_s: float = 9.0,
        dead_after_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.events = events or EventQueue()
        self.stale_after = stale_after_s
        self.dead_after = dead_after_s
        self.clock = clock
        self._nodes: dict[str, NodeInfo] = {}
        self._commands: dict[str, list[Any]] = {}
        self._lock = threading.Lock()
        #: the SCM store's durable op states (seeded at startup; they win
        #: over a node's own echo) and the hook that persists a change
        self._seeded_op: dict[str, str] = {}
        self.on_op_state_change = None

    # ---------------------------------------------------------------- members
    def register(self, dn_id: str, rack: str = "/default-rack",
                 capacity_bytes: int = 0,
                 op_state: Optional[str] = None) -> None:
        # events publish outside the lock: handlers take other managers'
        # locks, and those managers call back into queue_command
        is_new = False
        with self._lock:
            n = self._nodes.get(dn_id)
            if n is None:
                n = NodeInfo(dn_id, rack, capacity_bytes,
                             last_heartbeat=self.clock())
                # the SCM's durable record wins; the node's persisted echo
                # covers an SCM that lost its store
                adopted = self._seeded_op.get(dn_id) or op_state
                if adopted:
                    try:
                        n.op_state = NodeOperationalState(adopted)
                    except ValueError:
                        log.warning("%s reported unknown op state %r; "
                                    "treating as IN_SERVICE", dn_id, adopted)
                self._nodes[dn_id] = n
                self._commands.setdefault(dn_id, [])
                is_new = True
            else:
                # re-registration refreshes what the node reports
                n.last_heartbeat = self.clock()
                n.capacity_bytes = capacity_bytes
                n.rack = rack
        if is_new:
            self.events.publish(NEW_NODE, dn_id)

    def process_heartbeat(self, dn_id: str, used_bytes: int = 0) -> list[Any]:
        """Record a heartbeat; return the node's queued commands (SCM
        commands ride heartbeat responses)."""
        recovered = False
        with self._lock:
            n = self._nodes.get(dn_id)
            if n is None:
                # unknown node: ask it to re-register
                return [{"type": "register"}]
            n.last_heartbeat = self.clock()
            n.used_bytes = used_bytes
            if n.state is not NodeState.HEALTHY:
                n.state = NodeState.HEALTHY
                recovered = True
            cmds, self._commands[dn_id] = self._commands.get(dn_id, []), []
        if recovered:
            self.events.publish(HEALTHY_READBACK, dn_id)
        return cmds

    def check_liveness(self) -> None:
        """Periodic sweep advancing HEALTHY->STALE->DEAD by heartbeat age."""
        now = self.clock()
        transitions: list[tuple[str, str]] = []
        with self._lock:
            for n in self._nodes.values():
                age = now - n.last_heartbeat
                if age > self.dead_after and n.state is not NodeState.DEAD:
                    n.state = NodeState.DEAD
                    transitions.append((DEAD_NODE, n.dn_id))
                elif (
                    self.stale_after < age <= self.dead_after
                    and n.state is NodeState.HEALTHY
                ):
                    n.state = NodeState.STALE
                    transitions.append((STALE_NODE, n.dn_id))
        for topic, dn_id in transitions:
            self.events.publish(topic, dn_id)

    # ---------------------------------------------------------------- queries
    def get(self, dn_id: str) -> Optional[NodeInfo]:
        return self._nodes.get(dn_id)

    def nodes(self, state: Optional[NodeState] = None) -> list[NodeInfo]:
        return [n for n in list(self._nodes.values())
                if state is None or n.state is state]

    def healthy_in_service(self) -> list[NodeInfo]:
        return [
            n
            for n in self._nodes.values()
            if n.state is NodeState.HEALTHY
            and n.op_state is NodeOperationalState.IN_SERVICE
        ]

    def node_count(self) -> int:
        return len(self._nodes)

    # ---------------------------------------------------------------- cmds
    def queue_command(self, dn_id: str, command: Any) -> None:
        with self._lock:
            self._commands.setdefault(dn_id, []).append(command)

    def pending_commands(self, dn_id: str) -> int:
        return len(self._commands.get(dn_id, []))

    # ---------------------------------------------------------------- admin
    def seed_op_states(self, states: dict[str, str]) -> None:
        """Install the SCM store's durable op-state records (applied to
        nodes as they register)."""
        with self._lock:
            self._seeded_op.update(states)

    def set_op_state(self, dn_id: str, state: NodeOperationalState) -> None:
        n = self._nodes[dn_id]
        n.op_state = state
        with self._lock:
            if state is NodeOperationalState.IN_SERVICE:
                self._seeded_op.pop(dn_id, None)
            else:
                self._seeded_op[dn_id] = state.value
        if self.on_op_state_change is not None:
            try:
                self.on_op_state_change(dn_id, state.value)
            except Exception:  # persistence must not fail the operation
                log.exception("op-state persistence failed for %s", dn_id)
        # the node persists it and echoes it at its next registration
        # (SetNodeOperationalStateCommand)
        self.queue_command(dn_id, {
            "type": "set-op-state", "op_state": state.value,
        })
