"""Datanode clients: the in-process client and the dn_id -> client factory.

Port of `ozone_tpu/client/dn_client.py` (the reference's XceiverClient
family): the in-process client, and a factory that resolves in-process
datanodes first, then remote addresses registered with `register_remote`,
whose `NativeDatanodeClient` (`client/native_dn.py`: the bulk verbs over
the datanode's native datapath, the rest over the RPC) it builds lazily
on first use. The factory's `TokenStore` holds the block and container
tokens that rode each allocation and lookup, and every remote client
attaches them to its verbs; a datanode installs an issuer over its
imported keys to sign its own repair traffic. On a mutual-TLS cluster
the factory's `tls` (a TlsMaterial or RotatingTls) is the identity every
remote client presents (and the native lane is off); a renewal bumps the
material's `version`, and the remote clients made under the old one are
retired (closed with the factory: a repair may still be on one) so the
next call presents the new certificate. Left out: nearest-first ordering
(`learn_locations` keeps the topology the SCM ships).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from ozone_tpu_torch.client.resilience import HealthRegistry
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import (
    BlockData,
    BlockID,
    ChunkInfo,
    ContainerState,
    StorageError,
)
from ozone_tpu_torch.utils.checksum import ChecksumData

#: the code a datanode answers before the batched verbs are finalized
PRE_FINALIZE_ERROR = "NOT_SUPPORTED_OPERATION_PRIOR_FINALIZATION"


def batch_unsupported(e: Exception) -> bool:
    """True when `e` means the peer cannot serve the batched
    WriteChunksCommit verb; callers downgrade to per-chunk verbs."""
    return isinstance(e, StorageError) and (
        e.code == PRE_FINALIZE_ERROR
        or (e.code == "IO_EXCEPTION" and "UNIMPLEMENTED" in e.msg))


def write_unit_batched(client, block_id: BlockID, pairs, commit: BlockData,
                       writer: Optional[str] = None) -> None:
    """Land one unit's chunks + block commit: one WriteChunksCommit when
    the peer serves it, per-chunk verbs otherwise."""
    fn = getattr(client, "write_chunks_commit", None)
    if fn is not None:
        try:
            fn(block_id, pairs, commit=commit, writer=writer)
            return
        except StorageError as e:
            if not batch_unsupported(e):
                raise
    for info, data in pairs:
        client.write_chunk(block_id, info, data, writer=writer)
    client.put_block(commit, writer=writer)


def write_unit_stream(client, block_id: BlockID, pairs,
                      writer: Optional[str] = None) -> None:
    """Land one batch of a unit's chunks with no commit (the streaming half
    of write_unit_batched); a refused verb is remembered on the client."""
    fn = getattr(client, "write_chunks_commit", None)
    if fn is not None and not getattr(client, "_stream_downgraded", False):
        try:
            fn(block_id, pairs, commit=None, writer=writer)
            return
        except StorageError as e:
            if not batch_unsupported(e):
                raise
            client._stream_downgraded = True
    for info, data in pairs:
        client.write_chunk(block_id, info, data, writer=writer)


def build_chunk_pairs(block_id: BlockID, stripes, cells, crcs,
                      unit_len: int, cell: int, bpc: int, checksum,
                      host_checksum) -> list[tuple[ChunkInfo, object]]:
    """(ChunkInfo, data) pairs for one unit's cells of the given stripe
    indexes: cells [len(stripes), cell], crcs [len(stripes), S] device CRCs
    as uint32 (size 0 forces host checksums). Full cells reuse the device
    CRCs; the tail chunk falls back to the host checksummer."""
    pairs: list[tuple[ChunkInfo, object]] = []
    for bi, s in enumerate(stripes):
        chunk_len = max(0, min(cell, unit_len - s * cell))
        if chunk_len == 0:
            continue
        data = cells[bi, :chunk_len]
        if chunk_len == cell and cell % bpc == 0 and crcs.size:
            cs = ChecksumData(checksum, bpc, tuple(
                int(v).to_bytes(4, "big") for v in crcs[bi].tolist()))
        else:
            cs = host_checksum.compute(data)
        pairs.append((ChunkInfo(
            name=f"{block_id}_chunk_{s}",
            offset=s * cell,
            length=chunk_len,
            checksum=cs,
        ), data))
    return pairs


class LocalDatanodeClient:
    """In-process client wrapping a Datanode instance directly."""

    def __init__(self, dn: Datanode):
        self.dn = dn
        self.dn_id = dn.id

    def create_container(self, container_id, replica_index=0,
                         state=ContainerState.OPEN):
        self.dn.create_container(container_id, replica_index, state)

    def close_container(self, container_id):
        self.dn.close_container(container_id)

    def delete_container(self, container_id, force=False):
        self.dn.delete_container(container_id, force)

    def write_chunk(self, block_id, info, data, sync=False, writer=None):
        self.dn.write_chunk(block_id, info, data, sync, writer=writer)

    def read_chunk(self, block_id, info, verify=False):
        return self.dn.read_chunk(block_id, info, verify)

    def read_chunks(self, block_id, infos, verify=False):
        # the instance verb per chunk, so subclasses that inject read
        # faults cover the batched path too
        return [self.read_chunk(block_id, i, verify) for i in infos]

    def put_block(self, block, sync=False, writer=None):
        self.dn.put_block(block, sync, writer=writer)

    def write_chunks_commit(self, block_id, chunks, commit=None,
                            sync=False, writer=None):
        """In-process twin of the batched stream verb: every chunk, then the
        commit. Routes through the instance verbs so subclasses that inject
        faults cover this path too."""
        for info, data in chunks:
            self.write_chunk(block_id, info, data, sync, writer=writer)
        if commit is not None:
            self.put_block(commit, sync, writer=writer)

    def get_block(self, block_id):
        return self.dn.get_block(block_id)

    def list_blocks(self, container_id):
        return self.dn.list_blocks(container_id)

    def get_committed_block_length(self, block_id):
        return self.dn.get_committed_block_length(block_id)

    def delete_block(self, block_id):
        self.dn.delete_block(block_id)


class TokenStore:
    """The client's cache of block and container tokens the OM or SCM
    granted (the reference threads an encodedToken through every Xceiver
    request). Writers and readers register the tokens riding each
    BlockGroup (`put_group`), and every remote client the factory hands
    out reads them per call. `issuer` is the fallback of a datanode that
    holds the cluster keys: it signs its own reconstruction and
    replication traffic (ec/reconstruction/TokenHelper.java)."""

    _CAP = 8192  # bounded: tokens expire in minutes anyway
    #: seconds of validity below which a cached token counts as missing
    #: (re-issued where an issuer exists): none may expire mid-flight
    _EXPIRY_MARGIN = 15.0

    def __init__(self, issuer=None):
        self.issuer = issuer
        self._blocks: OrderedDict[BlockID, dict] = OrderedDict()
        self._containers: OrderedDict[int, dict] = OrderedDict()
        self._lock = threading.Lock()

    def put_block_token(self, block_id: BlockID, token: dict) -> None:
        with self._lock:
            self._blocks[block_id] = token
            self._blocks.move_to_end(block_id)
            while len(self._blocks) > self._CAP:
                self._blocks.popitem(last=False)

    def put_container_token(self, container_id: int, token: dict) -> None:
        with self._lock:
            self._containers[int(container_id)] = token
            self._containers.move_to_end(int(container_id))
            while len(self._containers) > self._CAP:
                self._containers.popitem(last=False)

    def put_group(self, group) -> None:
        """Register the tokens riding a BlockGroup, if any."""
        tok = getattr(group, "token", None)
        if tok is not None:
            self.put_block_token(group.block_id, tok)
        ctok = getattr(group, "container_token", None)
        if ctok is not None:
            self.put_container_token(group.container_id, ctok)

    def _fresh(self, tok: Optional[dict]) -> Optional[dict]:
        if tok is not None and \
                tok.get("expiry", 0) < time.time() + self._EXPIRY_MARGIN:
            return None
        return tok

    def block_token(self, block_id: BlockID) -> Optional[dict]:
        with self._lock:
            tok = self._fresh(self._blocks.get(block_id))
        if tok is None and self.issuer is not None:
            from ozone_tpu_torch.utils.security import AccessMode

            tok = self.issuer.issue(
                block_id, [AccessMode.READ, AccessMode.WRITE], owner="dn")
            if tok is not None:
                self.put_block_token(block_id, tok)
        return tok

    def container_token(self, container_id: int) -> Optional[dict]:
        with self._lock:
            tok = self._fresh(self._containers.get(int(container_id)))
        if tok is None and self.issuer is not None:
            tok = self.issuer.issue_container(container_id, owner="dn")
            if tok is not None:
                self.put_container_token(container_id, tok)
        return tok


def register_tokens(clients, groups) -> None:
    """Register the tokens riding `groups` (BlockGroups, or the JSON
    groups of a lookup) in the factory's store, when it has one."""
    tokens = getattr(clients, "tokens", None)
    if tokens is None:
        return
    for g in groups:
        if isinstance(g, dict):
            if g.get("token") is not None:
                tokens.put_block_token(
                    BlockID(int(g["container_id"]), int(g["local_id"])),
                    g["token"])
        else:
            tokens.put_group(g)


class DatanodeClientFactory:
    """dn_id -> client resolver (the XceiverClientManager pool analog), with
    the per-peer health registry every writer built over it shares."""

    def __init__(self, native_datapath: Optional[bool] = None):
        #: whether remote clients take the native datapath for the bulk
        #: verbs; None reads OZONE_TPU_NATIVE_DATAPATH (on by default)
        self.native_datapath = native_datapath
        self._local: dict[str, LocalDatanodeClient] = {}
        self._addresses: dict[str, str] = {}
        self._remote: dict = {}
        # maybe_get runs on writer and reader worker threads at once
        self._remote_lock = threading.Lock()
        self.health = HealthRegistry()
        #: tokens shared by every remote client of this factory
        self.tokens = TokenStore()
        #: dn_id -> topology location ("/rack"), learned from the SCM
        self.locations: dict[str, str] = {}
        #: the identity remote clients present on a mutual-TLS cluster
        self.tls = None
        self._tls_ver = None
        self._retired: list = []

    def learn_locations(self, locations: dict[str, str]) -> None:
        if locations:
            self.locations.update(locations)

    def register_local(self, dn: Datanode) -> LocalDatanodeClient:
        c = LocalDatanodeClient(dn)
        self._local[dn.id] = c
        return c

    def register_remote(self, dn_id: str, address: str) -> None:
        with self._remote_lock:
            self._addresses[dn_id] = address
            old = self._remote.pop(dn_id, None)  # reconnect on next use
        if old is not None:
            old.close()

    def update_remote(self, dn_id: str, address: str) -> None:
        """Refresh a remote address if it changed (a restarted daemon binds
        a new port); in-process datanodes are left alone."""
        if dn_id in self._local:
            return
        if self._addresses.get(dn_id) != address:
            self.register_remote(dn_id, address)

    def known_ids(self) -> list[str]:
        return sorted(set(self._local) | set(self._addresses))

    def remote_address(self, dn_id: str) -> Optional[str]:
        """The RPC address a remote datanode was registered with (the raft
        pipeline clients share this address book)."""
        return self._addresses.get(dn_id)

    def maybe_get(self, dn_id: str):
        c = self._local.get(dn_id)
        if c is not None:
            return c
        with self._remote_lock:
            ver = getattr(self.tls, "version", None)
            if ver != self._tls_ver:
                # a renewed identity: clients made under the old one retire
                self._tls_ver = ver
                self._retired.extend(self._remote.values())
                self._remote.clear()
            c = self._remote.get(dn_id)
            if c is None and dn_id in self._addresses:
                from ozone_tpu_torch.client.native_dn import (
                    NativeDatanodeClient,
                )

                c = self._remote[dn_id] = NativeDatanodeClient(
                    dn_id, self._addresses[dn_id],
                    native=self.native_datapath, tokens=self.tokens,
                    tls=self.tls)
            return c

    def get(self, dn_id: str):
        c = self.maybe_get(dn_id)
        if c is None:
            raise KeyError(f"no client for datanode {dn_id}")
        return c

    def close(self) -> None:
        with self._remote_lock:
            clients = list(self._remote.values()) + self._retired
            self._remote.clear()
            self._retired = []
        for c in clients:
            c.close()
