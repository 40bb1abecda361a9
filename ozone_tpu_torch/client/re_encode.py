"""Replication-to-EC and XOR(1)->RS re-encode of keys.

Port of `ozone_tpu/client/re_encode.py` (BASELINE config #4, the
reference's container-service conversion): data written with replication
or XOR(1) for fast ingest is re-encoded to RS in the background. A
replicated source streams from any live replica through the standard EC
writer. An XOR(1) source with one data unit lost takes the fused
re-encode: one kernel launch per stripe window recovers the unit, makes
the RS parity and checksums every unit (`codec/fused.make_fused_reencoder`);
with the XOR parity lost instead, the window is a plain fused encode of
the k surviving data units. Both run on the shared codec service's bulk
lane by default, and on a `DeviceBatchPipeline` with
OZONE_TPU_CODEC_SERVICE=0. The key's block list is swapped at a commit
fenced on the scanned version (a user overwrite racing the conversion
wins with KEY_MODIFIED), and the old blocks go through the SCM deletion
chain. The codec runs on `device` ("cuda" launches the kernel and raises
when CUDA is absent; "cpu" runs its plain version).
"""

from __future__ import annotations

import functools
import logging

import numpy as np

from ozone_tpu_torch.client import resilience
from ozone_tpu_torch.client.dn_client import (
    DatanodeClientFactory,
    build_chunk_pairs,
    register_tokens,
    write_unit_stream,
)
from ozone_tpu_torch.client.ec_writer import (
    BlockGroup,
    ECKeyWriter,
    StripeWriteError,
    block_lengths,
    create_group_containers,
)
from ozone_tpu_torch.client.replicated import ReplicatedKeyReader
from ozone_tpu_torch.codec import service as codec_service
from ozone_tpu_torch.codec.fused import (
    FusedSpec,
    effective_bpc,
    make_fused_encoder,
    make_fused_reencoder,
    reencode_layout_crcs,
    resolve_device,
)
from ozone_tpu_torch.codec.pipeline import (
    DeviceBatchPipeline,
    decode_batch_size,
    host_buffer,
)
from ozone_tpu_torch.om.om import OzoneManager
from ozone_tpu_torch.scm.pipeline import ReplicationConfig, ReplicationType
from ozone_tpu_torch.storage.ids import BlockData, ChunkInfo, StorageError
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

log = logging.getLogger(__name__)


def _op_boundary(op: str):
    """One operation deadline covers the whole conversion (source reads,
    device passes, target writes, commit)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with resilience.start(op):
                return fn(*a, **kw)
        return wrapped
    return deco


@_op_boundary("re_encode")
def re_encode_key_to_ec(
    om: OzoneManager,
    clients: DatanodeClientFactory,
    volume: str,
    bucket: str,
    key: str,
    ec: str = "rs-6-3-1024k",
    device="cuda",
) -> dict:
    """Convert one replicated or XOR(1)-coded key to RS EC; returns the
    new key info. A replicated source streams through the EC writer on
    the codec service's bulk lane; an XOR source goes to
    `re_encode_xor_key_to_rs`."""
    device = resolve_device(device)
    info = om.lookup_key(volume, bucket, key)
    old_groups = om.key_block_groups(info)
    register_tokens(clients, old_groups)  # READ tokens from the lookup
    repl = ReplicationConfig.parse(info["replication"])
    if repl.type is ReplicationType.EC:
        if repl.ec.codec == "xor":
            return re_encode_xor_key_to_rs(om, clients, volume, bucket,
                                           key, ec, device=device)
        raise ValueError(f"{key} is already erasure coded ({repl})")

    ec_conf = ReplicationConfig.parse(ec)
    session = om.open_key(volume, bucket, key, replication=ec)
    # rewrite fence on the scanned version: a user overwrite racing the
    # conversion must win; the fenced commit refuses with KEY_MODIFIED
    # and routes the conversion's blocks to the purge chain
    session.expect_object_id = info.get("object_id", "")
    session.expect_generation = int(info.get("generation", -1))
    writer = ECKeyWriter(
        ec_conf.ec,
        lambda excluded, excluded_containers=():
            om.allocate_block(session, excluded, excluded_containers),
        clients,
        block_size=om.block_size,
        checksum=ChecksumType(info.get("checksum_type", "CRC32C")),
        bytes_per_checksum=info.get("bytes_per_checksum", 16 * 1024),
        device=device,
        qos_class="bulk",  # a background conversion must not starve reads
    )
    for g in old_groups:
        writer.write(ReplicatedKeyReader(g, clients).read_all())
    groups = writer.close()
    # the fenced commit swaps the block list; the superseded replicated
    # version goes to the purge chain (finalize_commit)
    om.commit_key(session, groups, writer.bytes_written)
    log.info(
        "re-encoded %s/%s/%s: %d bytes, %d replicated groups -> %d EC groups",
        volume, bucket, key, writer.bytes_written, len(old_groups),
        len(groups),
    )
    return om.lookup_key(volume, bucket, key)


def _allocate_group(om: OzoneManager, session, clients, excluded: list[str],
                    retries: int = 3) -> BlockGroup:
    """A new RS group with its containers created on every member. A
    member that cannot take its container joins `excluded` (kept for the
    rest of the conversion) and the group is allocated again: the SCM goes
    on handing out an open container whose pipeline holds a node that
    died after the container was made."""
    for attempt in range(retries + 1):
        ng = om.allocate_block(session, excluded)
        try:
            create_group_containers(clients, ng, replica_indexed=True)
            return ng
        except StripeWriteError as e:
            if attempt == retries:
                raise StorageError("IO_EXCEPTION",
                                   f"re-encode target allocation: {e}")
            log.warning("re-encode target %s: %s; reallocating",
                        ng.block_id, e)
            excluded.extend(e.failed_nodes)
    raise AssertionError("unreachable")


def _unit_source(clients, group, unit, cell, unit_len):
    """(client, {stripe: ChunkInfo}) of one unit's replica, or None if the
    replica is unreachable or missing. A unit that holds no bytes of the
    group (`unit_len` 0: a short group's data units past its length, for
    which the writer made no block) is known zeros, (None, {}), wherever
    its node is. Outcomes feed the shared peer health registry."""
    if unit_len == 0:
        return None, {}
    dn_id = group.pipeline.nodes[unit]
    health = getattr(clients, "health", None)
    try:
        client = clients.get(dn_id)
        bd = client.get_block(group.block_id)
    except Exception:  # noqa: BLE001 - any failure = unit unavailable
        if health is not None:
            health.failure(dn_id)
        return None
    return client, {info.offset // cell: info for info in bd.chunks}


def _read_unit_window(group, source, s0: int, n: int, out: np.ndarray,
                      health=None) -> None:
    """One unit's cells for stripes [s0, s0+n) into `out` [n, cell],
    zero-padded."""
    client, by_stripe = source
    out[:] = 0
    for s in range(s0, s0 + n):
        info = by_stripe.get(s)
        if info is not None:
            if health is not None:
                data = health.observe(client.dn_id, client.read_chunk,
                                      group.block_id, info)
            else:
                data = client.read_chunk(group.block_id, info)
            out[s - s0, :info.length] = data[:info.length]


@_op_boundary("re_encode")
def re_encode_xor_key_to_rs(
    om: OzoneManager,
    clients: DatanodeClientFactory,
    volume: str,
    bucket: str,
    key: str,
    ec: str = "rs-6-3-1024k",
    device="cuda",
) -> dict:
    """Convert an XOR(1)-coded key to RS(k, p), surviving one lost data
    unit per group. The XOR decode and the RS parity are one launch per
    window of stripes, and the RS layout is written straight to a freshly
    allocated group with the CRCs the device computed."""
    device = resolve_device(device)
    info = om.lookup_key(volume, bucket, key)
    old_groups = om.key_block_groups(info)
    register_tokens(clients, old_groups)  # READ tokens from the lookup
    src = ReplicationConfig.parse(info["replication"])
    dst = ReplicationConfig.parse(ec)
    if src.type is not ReplicationType.EC or src.ec.codec != "xor":
        raise ValueError(f"{key} is not XOR-coded ({src})")
    if dst.type is not ReplicationType.EC or dst.ec.codec != "rs":
        raise ValueError(f"target must be RS EC, got {dst}")
    k, cell = src.ec.data_units, src.ec.cell_size
    if (dst.ec.data_units, dst.ec.cell_size) != (k, cell):
        raise ValueError(
            f"XOR->RS re-encode needs matching data units and cell size "
            f"({src} -> {dst})")
    ctype = ChecksumType(info.get("checksum_type", "CRC32C"))
    bpc = effective_bpc(cell, info.get("bytes_per_checksum", 16 * 1024))
    spec = FusedSpec(dst.ec, ctype, bpc)
    host_checksum = Checksum(ctype, bpc)
    p = dst.ec.parity_units

    session = om.open_key(volume, bucket, key, replication=ec)
    # the same rewrite fence as the replicated path
    session.expect_object_id = info.get("object_id", "")
    session.expect_generation = int(info.get("generation", -1))
    new_groups = []
    total = 0
    window = decode_batch_size()
    excluded: list[str] = []  # target nodes that failed this conversion
    health = getattr(clients, "health", None)
    for g in old_groups:
        stripes = -(-g.length // (k * cell))
        # the k input slots: data units where alive, the XOR parity in the
        # lost unit's slot (in slot 0 when nothing is lost: the same IO
        # and one uniform program; the recovered column then equals unit
        # 0, so writing it doubles as a parity consistency check)
        lengths = block_lengths(g.length, k, cell) + [stripes * cell] * p
        sources = [_unit_source(clients, g, u, cell, lengths[u])
                   for u in range(k)]
        missing = [u for u, x in enumerate(sources) if x is None]
        if len(missing) > 1:
            raise StorageError(
                "INSUFFICIENT_LOCATIONS",
                f"group {g.block_id}: {len(missing)} data units lost, "
                f"XOR(1) tolerates one")
        lost = missing[0] if missing else 0
        parity_src = _unit_source(clients, g, k, cell, stripes * cell)
        parity_ok = parity_src is not None
        if parity_ok:
            sources[lost] = parity_src
        elif missing:
            raise StorageError(
                "INSUFFICIENT_LOCATIONS",
                f"group {g.block_id}: data unit {lost} AND the XOR "
                f"parity are gone")
        # with the parity itself gone every slot holds original data, and
        # the re-encoder's matrix would fold slot `lost` into the XOR of
        # all data (the parity): that case is a plain fused encode
        fn = (make_fused_reencoder(spec, lost=lost, device=device)
              if parity_ok else make_fused_encoder(spec, device=device))
        ng = _allocate_group(om, session, clients, excluded)
        unit_infos: list[list[ChunkInfo]] = [[] for _ in range(k + p)]

        def emit(ctx, results):
            """Write one window's RS layout to the new group, while the
            next window reads and re-encodes on the device."""
            s0, n, batch = ctx
            if parity_ok:
                out, ucrcs, ocrcs = results
                crcs = reencode_layout_crcs(ucrcs, ocrcs, lost)

                def unit_cells(u):
                    if u < k:
                        return out[:, 0] if u == lost else batch[:, u]
                    return out[:, 1 + (u - k)]
            else:
                # plain encode: data passes through; the device made the
                # parity and the CRCs of all k+p units
                parity_cells, crcs = results

                def unit_cells(u):
                    return batch[:, u] if u < k else parity_cells[:, u - k]
            for u in range(k + p):
                pairs = build_chunk_pairs(
                    ng.block_id, range(s0, s0 + n), unit_cells(u),
                    crcs[:, u], lengths[u], cell, bpc, ctype,
                    host_checksum)
                if pairs:
                    write_unit_stream(clients.get(ng.pipeline.nodes[u]),
                                      ng.block_id, pairs)
                    unit_infos[u].extend(i for i, _ in pairs)

        # depth-1 pipeline over stripe windows: window N's target writes
        # overlap window N+1's reads and device pass
        svc = codec_service.maybe_service()
        if svc is not None:
            lane_key = (codec_service.reencode_key(spec, lost) if parity_ok
                        else codec_service.encode_key(spec))
            pipe = codec_service.ServicePipeline(
                svc, lane_key, fn, width=window, qos="bulk")
        else:
            pipe = DeviceBatchPipeline(fn)
        for s0 in range(0, stripes, window):
            deadline = resilience.current()
            if deadline is not None:
                deadline.check("re_encode_window")
            n = min(window, stripes - s0)
            # staged in pinned memory when the codec runs on the card
            staged = host_buffer((n, k, cell), device)
            batch = staged.numpy()
            for u, unit_src in enumerate(sources):
                _read_unit_window(g, unit_src, s0, n, batch[:, u],
                                  health=health)
            done = pipe.submit(staged, (s0, n, batch))
            if done is not None:
                emit(*done)
        done = pipe.drain()
        if done is not None:
            emit(*done)

        for u in range(k + p):
            clients.get(ng.pipeline.nodes[u]).put_block(BlockData(
                ng.block_id, unit_infos[u], block_group_length=g.length))
        ng.length = g.length
        new_groups.append(ng)
        total += g.length

    om.commit_key(session, new_groups, total)
    log.info(
        "fused XOR->RS re-encode %s/%s/%s: %d bytes, %d groups",
        volume, bucket, key, total, len(new_groups),
    )
    return om.lookup_key(volume, bucket, key)
