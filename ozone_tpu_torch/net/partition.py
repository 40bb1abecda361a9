"""Client-side network-partition injection: the blockade analog.

Port of `ozone_tpu/net/partition.py`. The reference tests network
partitions with blockade/iptables around docker containers
(fault-injection-test/network-tests/src/test/blockade/test_blockade_*.py:
datanode isolation, SCM isolation, a flaky network). Every daemon of the
port speaks its RPC through `net/rpc.RpcChannel`, and the bulk chunk
verbs through `client/native_dn.NativeDatanodeClient`, so a partition is
injected one layer up: every outbound call consults a process-global deny
table and fails with the same UNAVAILABLE StorageError a dead TCP peer
would give. Failover clients rotate, raft peers mark the target
unreachable and retry on the next heartbeat, as if the wire were cut.

Entries are scoped: ("*", dst) drops every call this process makes to
dst; (owner, dst) drops only calls made through channels tagged with that
owner. That is how an in-process HA cluster isolates ONE replica of a
ring whose members share the process (each replica's raft transport tags
its channels with its node id).

Daemon processes serve Partition, Delay, Heal and PartitionList on their
insight RPC service (`utils/insight.py`), so a test or an operator drill
can cut links between live daemons: cutting both directions of a link is
one Partition call to each endpoint's process, as blockade programs
netfilter in each container.

Verb rules (the byteman analog: the reference injects latency and
failures at method boundaries with dev-support/byteman/*.btm scripts such
as ratis-no-flush.btm): a rule names (dst, verb, owner, delay_s,
drop_pct, count) and fires only on matching RPC methods. A rule with
drop_pct=100 and a `count` fails exactly the first `count` matching
calls, then expires.

Every RPC consults this module, so `consult` answers from the empty
tables without taking the lock when no partition, delay or rule is set.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Optional

_lock = threading.Lock()
_blocked: set[tuple[str, str]] = set()
_delayed: dict[tuple[str, str], float] = {}

#: wildcard owner: matches calls from every channel in the process
ANY = "*"


@dataclass
class Rule:
    """One verb-scoped injection rule (a byteman .btm analog)."""

    id: int
    dst: str = ANY  # peer address, or ANY
    verb: str = ANY  # RPC method name ("AppendEntries"), or ANY
    owner: str = ANY  # channel owner tag, or ANY
    delay_s: float = 0.0
    drop_pct: float = 0.0  # 0..100
    #: fire at most this many times, then expire (None = forever); with
    #: drop_pct=100 this is the deterministic fail-first-N shape
    count: Optional[int] = None
    _rng: random.Random = field(default_factory=lambda: random.Random(7))

    def matches(self, dst: str, verb: Optional[str],
                owner: Optional[str]) -> bool:
        if self.dst != ANY and self.dst != dst:
            return False
        if self.verb != ANY:
            if verb is None:
                return False
            if verb.rsplit("/", 1)[-1] != self.verb:
                return False
        return self.owner == ANY or self.owner == owner


_rules: dict[int, Rule] = {}
_next_rule_id = [1]


def add_rule(dst: str = ANY, verb: str = ANY, owner: str = ANY,
             delay_s: float = 0.0, drop_pct: float = 0.0,
             count: Optional[int] = None, seed: int = 7) -> int:
    """Install a verb-scoped rule; returns its id for `remove_rule`."""
    with _lock:
        rid = _next_rule_id[0]
        _next_rule_id[0] += 1
        _rules[rid] = Rule(rid, dst, verb, owner, float(delay_s),
                           float(drop_pct), count, random.Random(seed))
        return rid


def remove_rule(rule_id: int) -> None:
    with _lock:
        _rules.pop(rule_id, None)


def rules() -> list[dict]:
    with _lock:
        return [
            {"id": r.id, "dst": r.dst, "verb": r.verb, "owner": r.owner,
             "delay_s": r.delay_s, "drop_pct": r.drop_pct,
             "count": r.count}
            for r in _rules.values()
        ]


def consult(dst: str, verb: Optional[str] = None,
            owner: Optional[str] = None) -> tuple[bool, float]:
    """The decision for one outbound call: (drop?, delay seconds). Folds
    the address tables with the verb rules, and counts down the
    count-limited rules as they fire."""
    if not _blocked and not _delayed and not _rules:
        return False, 0.0  # nothing injected: no lock on the hot path
    with _lock:
        if (ANY, dst) in _blocked or (
                owner is not None and (owner, dst) in _blocked):
            return True, 0.0
        d = _delayed.get((ANY, dst), 0.0)
        if owner is not None:
            d = max(d, _delayed.get((owner, dst), 0.0))
        drop = False
        expired = []
        for r in _rules.values():
            if not r.matches(dst, verb, owner):
                continue
            fired = False
            if r.drop_pct > 0 and (
                    r.drop_pct >= 100
                    or r._rng.uniform(0, 100) < r.drop_pct):
                drop = True
                fired = True
            if r.delay_s > 0:
                d = max(d, r.delay_s)
                fired = True
            if fired and r.count is not None:
                r.count -= 1
                if r.count <= 0:
                    expired.append(r.id)
        for rid in expired:
            _rules.pop(rid, None)
        return drop, d


def block(dst: str, owner: str = ANY) -> None:
    """Drop future calls to dst (from `owner`-tagged channels only, or
    from the whole process with the default wildcard)."""
    with _lock:
        _blocked.add((owner, dst))


def delay(dst: str, seconds: float, owner: str = ANY) -> None:
    """Add fixed latency to future calls to dst (the blockade slow or
    flaky network: the link works, slowly)."""
    with _lock:
        _delayed[(owner, dst)] = float(seconds)


def heal(dst: str, owner: str = ANY) -> None:
    with _lock:
        _blocked.discard((owner, dst))
        _delayed.pop((owner, dst), None)


def clear() -> None:
    """Drop every partition, delay and verb rule. (The reference's clear
    leaves the verb rules installed, so a rule a failed drill left behind
    fires in whatever runs next in the process; the port drops them.)"""
    with _lock:
        _blocked.clear()
        _delayed.clear()
        _rules.clear()


def blocked() -> list[tuple[str, str]]:
    with _lock:
        return sorted(_blocked)


def delayed() -> list[tuple[str, str, float]]:
    with _lock:
        return sorted((o, d, sec) for (o, d), sec in _delayed.items())


def delay_for(dst: str, owner: Optional[str] = None) -> float:
    with _lock:
        if not _delayed:
            return 0.0
        d = _delayed.get((ANY, dst), 0.0)
        if owner is not None:
            d = max(d, _delayed.get((owner, dst), 0.0))
        return d


def is_blocked(dst: str, owner: Optional[str] = None) -> bool:
    with _lock:
        if not _blocked:
            return False
        if (ANY, dst) in _blocked:
            return True
        return owner is not None and (owner, dst) in _blocked
