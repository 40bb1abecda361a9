"""Client write path through the datanode Raft pipeline.

Port of `ozone_tpu/client/ratis_client.py` (the reference's
XceiverClientRatis: sendRequestAsync routes container commands through
the pipeline's Raft leader, watchForCommit blocks until every replica
applied the write, degrading from ALL to MAJORITY when a follower lags).
`RatisKeyWriter` composes it with the replicated writer: chunk BYTES
still fan out over the datapath to every member, while the create and
commit verbs are proposed to the leader, so every replica applies the
same ordered history; it commits once a majority took a chunk's bytes,
and its `hsync` and `close` wait for the commit watermark on all members.
Left out: block and container tokens on the proposals.
"""

from __future__ import annotations

import logging
from typing import Optional

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.dn_client import (
    DatanodeClientFactory,
    register_tokens,
)
from ozone_tpu_torch.client.ec_writer import BlockGroup, StripeWriteError
from ozone_tpu_torch.client.replicated import ReplicatedKeyWriter
from ozone_tpu_torch.net.ratis_service import RatisClientFactory
from ozone_tpu_torch.scm.pipeline import Pipeline
from ozone_tpu_torch.storage.ids import BlockData, ChunkInfo, StorageError

log = logging.getLogger(__name__)


class XceiverClientRatis:
    """Leader-tracking submit/watch client for one pipeline."""

    def __init__(self, pipeline: Pipeline, ratis_clients: RatisClientFactory,
                 max_attempts: int = 8, retry_interval_s: float = 0.25):
        self.pipeline = pipeline
        self.clients = ratis_clients
        self.max_attempts = max_attempts
        self.retry_interval_s = retry_interval_s
        # capped exponential + FULL jitter between failover sweeps: the
        # old fixed `interval * min(attempt+1, 4)` ladder synchronized
        # every client that failed together onto the same retry ticks,
        # thundering-herding each fresh leader after an election
        self.retry_policy = resilience.RetryPolicy(
            base_s=retry_interval_s,
            cap_s=max(retry_interval_s, min(5.0, retry_interval_s * 16)),
            max_attempts=max_attempts)
        self._leader: Optional[str] = None
        #: sticky watch degrade: once a follower proves dead, later
        #: watches skip straight to MAJORITY instead of re-paying the
        #: ALL timeout per block (the reference caches the weaker
        #: policy on the stream the same way)
        self._degraded = False

    def _candidates(self) -> list[str]:
        nodes = list(self.pipeline.nodes)
        if self._leader in nodes:
            nodes.remove(self._leader)
            nodes.insert(0, self._leader)
        return nodes

    def _with_leader(self, fn, non_retriable: tuple = ()):
        """Run fn(client) against the leader, following NOT_LEADER hints
        and retrying through elections (the OM-failover-proxy shape).
        Codes in `non_retriable` propagate immediately (a watch timeout
        is the leader's answer, not a routing failure)."""
        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            for dn_id in self._candidates():
                client = self.clients.maybe_get(dn_id)
                if client is None:
                    continue
                try:
                    out = fn(client)
                    self._leader = dn_id
                    return out
                except StorageError as e:
                    last = e
                    if e.code == "NOT_LEADER":
                        # e.msg carries the leader hint when known
                        self._leader = e.msg or None
                        if self._leader:
                            break  # retry straight at the hinted leader
                    elif e.code in non_retriable:
                        raise
                    elif e.code not in ("TIMEOUT", "IO_EXCEPTION",
                                        "UNAVAILABLE",
                                        "NO_SUCH_RAFT_GROUP"):
                        raise  # deterministic application error
                except (KeyError, OSError, ConnectionError) as e:
                    last = e
            if attempt < self.max_attempts - 1 and \
                    not self.retry_policy.sleep(attempt):
                # the operation deadline cannot cover another sweep:
                # surface the fail-fast DEADLINE_EXCEEDED (never the
                # transport-shaped IO_EXCEPTION below, which breakers
                # and callers would read as a peer fault)
                resilience.check_deadline("ratis_retry")
                break
        raise StorageError(
            "IO_EXCEPTION",
            f"no reachable leader for pipeline {self.pipeline.id}: {last}")

    def submit(self, request: dict, timeout: float = 30.0) -> dict:
        return self._with_leader(
            lambda c: c.submit(self.pipeline.id, request, timeout=timeout))

    def watch_for_commit(self, index: int, timeout: float = 10.0) -> dict:
        """ALL_COMMITTED watch, degrading to MAJORITY when a follower
        lags (XceiverClientRatis watch-degrade semantics)."""
        if not self._degraded:
            try:
                return self._with_leader(
                    lambda c: c.watch(self.pipeline.id, index,
                                      policy="ALL", timeout=timeout),
                    non_retriable=("TIMEOUT",))
            except StorageError as e:
                if e.code not in ("TIMEOUT", "IO_EXCEPTION", "UNAVAILABLE"):
                    raise
                log.warning(
                    "watch(ALL) for index %d on pipeline %d degraded to "
                    "MAJORITY: %s", index, self.pipeline.id, e)
                self._degraded = True
        return self._with_leader(
            lambda c: c.watch(self.pipeline.id, index,
                              policy="MAJORITY", timeout=timeout))


class RatisKeyWriter(ReplicatedKeyWriter):
    """Replicated key writer whose commit path is the pipeline Raft ring.

    Data phase unchanged from the parent (chunk fan-out to all members);
    `create_container` / per-chunk commit+putBlock are ordered through
    the leader, and block finalization waits for the commit watermark.
    """

    #: commits MUST ride the Raft ring, not a per-member piggyback —
    #: the ring orders them and the watch watermark tracks them
    _combined_commit = False

    def __init__(self, allocate_group, clients: DatanodeClientFactory,
                 ratis_clients: RatisClientFactory,
                 watch_timeout_s: float = 10.0, **kw):
        super().__init__(allocate_group, clients, **kw)
        self.ratis_clients = ratis_clients
        #: per-policy wait before an ALL watch degrades to MAJORITY
        self.watch_timeout_s = watch_timeout_s
        self._xceivers: dict[int, XceiverClientRatis] = {}
        self._watch_targets: list[tuple[XceiverClientRatis, int]] = []
        self._last_index = 0

    def _xceiver(self, group: BlockGroup) -> XceiverClientRatis:
        x = self._xceivers.get(group.pipeline.id)
        if x is None:
            x = XceiverClientRatis(group.pipeline, self.ratis_clients)
            self._xceivers[group.pipeline.id] = x
        return x

    def _data_phase_ok(self, group: BlockGroup, failed: list[str]) -> bool:
        """Raft availability: commit as long as a majority took the bytes
        (the reference's Ratis pipeline keeps accepting writes with one
        of three members down; the lagging replica is repaired offline)."""
        n = len(group.pipeline.nodes)
        ok = len(failed) <= (n - 1) // 2
        if ok and failed:
            log.warning(
                "pipeline %d: committing with %d/%d members missing the "
                "data phase (%s); their replicas will be repaired",
                group.pipeline.id, len(failed), n, failed)
        return ok

    def _create_containers(self, group: BlockGroup) -> None:
        # the data phase's fan-out to every member needs the tokens too
        register_tokens(self.clients, [group])
        try:
            x = self._xceiver(group)
            req = {"verb": "create_container",
                   "container_id": group.container_id}
            if group.container_token is not None:
                req["container_token"] = group.container_token
            out = x.submit(req)
            # the data phase writes chunks straight to every member: the
            # container must exist everywhere before bytes arrive, so wait
            # for the create to apply on all replicas (short timeout — a
            # dead member degrades this to majority and simply fails its
            # data fan-out later, which the quorum data policy absorbs)
            x.watch_for_commit(int(out.get("index", 0)),
                               timeout=min(2.0, self.watch_timeout_s))
        except (StorageError, ConnectionError, KeyError, OSError) as e:
            # the whole pipeline is unreachable through its ring (e.g. a
            # client-side partition): surface the base-class contract so
            # the retry path excludes these members and reallocates
            self._group = None
            raise StripeWriteError(list(group.pipeline.nodes), e)

    def _commit_chunk(self, group: BlockGroup, info: ChunkInfo) -> None:
        x = self._xceiver(group)
        tok = {"token": group.token} if group.token is not None else {}
        x.submit({
            "verb": "write_chunk_commit",
            "block_id": group.block_id.to_json(),
            "offset": info.offset,
            "length": info.length,
            **tok,
        })
        bd = BlockData(group.block_id, [*self._chunks, info])
        out = x.submit({"verb": "put_block", "block": bd.to_json(),
                        "writer": self._writer_id, **tok})
        self._last_index = int(out.get("index", 0))

    def _finalize_group(self) -> None:
        if self._group is not None and self._group.length > 0 and \
                self._last_index:
            self._watch_targets.append(
                (self._xceiver(self._group), self._last_index))
            self._last_index = 0
        super()._finalize_group()

    def hsync(self) -> list[BlockGroup]:
        """The parent's hsync, then the hflush barrier over every block
        it covers: the finalized blocks' and the open block's last commit
        indexes applied on all replicas, so a reader of the synced length
        finds it on any member."""
        groups = super().hsync()
        targets, self._watch_targets = self._watch_targets, []
        if self._group is not None and self._last_index:
            targets.append((self._xceiver(self._group), self._last_index))
        for xceiver, index in targets:
            xceiver.watch_for_commit(index, timeout=self.watch_timeout_s)
        return groups

    def close(self) -> list[BlockGroup]:
        groups = super().close()
        # hflush barrier: every finalized block's commit index applied on
        # all replicas (BlockOutputStream watchForCommit watermark)
        targets, self._watch_targets = self._watch_targets, []
        for xceiver, index in targets:
            xceiver.watch_for_commit(index, timeout=self.watch_timeout_s)
        return groups
