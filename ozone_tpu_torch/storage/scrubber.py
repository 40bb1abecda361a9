"""Device-batched container scrubbing: checksum verification as batched
CRC launches instead of a per-slice host loop.

Port of `ozone_tpu/storage/scrubber.py` (role analog of the reference's
BackgroundContainerDataScanner: a full-chunk checksum verify that marks
containers UNHEALTHY so the replication manager repairs them; it scans
only closed containers, never ones with live writers). Full
bytes-per-checksum slices are stacked into uint8 batches and verified by
the fused kernel with no coding rows (`codec/crc_device.make_crc_fn`),
so a container becomes a few launches. Tails (short final slices) and
non-CRC32C checksums are checked on the host.

Only checksum mismatches (and metadata inconsistencies) poison a
replica. A chunk that cannot be read is checked against the block
metadata first: if the block is gone, a concurrent deletion won the race
and the chunk is skipped.

The reference's option of sharding the slice batch over a device mesh
waits for the port's multi-device slice.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ozone_tpu_torch.codec.crc_device import make_crc_fn
from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.codec.pipeline import finish_pull, host_buffer, start_pull
from ozone_tpu_torch.storage.ids import ContainerState, StorageError
from ozone_tpu_torch.utils.checksum import (
    Checksum,
    ChecksumError,
    ChecksumType,
    crc32c,
)

if TYPE_CHECKING:  # pragma: no cover
    from ozone_tpu_torch.storage.datanode import Datanode

#: container states whose data is stable enough to scrub (the reference
#: scanner's shouldScanData contract: no live writers)
SCANNABLE_STATES = (ContainerState.CLOSED, ContainerState.QUASI_CLOSED)


def _next_pow2(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


class DeviceScrubber:
    """Batched CRC32C verification over container contents, on `device`:
    "cuda" launches the kernel (and raises when CUDA is absent), "cpu"
    runs its plain version."""

    def __init__(self, max_batch_bytes: int = 64 * 1024 * 1024,
                 device="cuda"):
        self.max_batch_bytes = max_batch_bytes
        self.device = resolve_device(device)
        self._fns: dict[int, object] = {}
        #: slice batches verified (one kernel launch each on CUDA)
        self.dispatches = 0

    def _crc_fn(self, bpc: int):
        fn = self._fns.get(bpc)
        if fn is None:
            fn = self._fns[bpc] = make_crc_fn(bpc)
        return fn

    def _dispatch(self, bpc: int, bufs: list, exps: list, labels: list,
                  errors: list[str]) -> None:
        """Verify one slice batch on the device and drain the buffers.

        Batches are padded with zero slices to the next power of two
        (their CRCs are ignored), so each bpc sees a handful of shapes."""
        if not bufs:
            return
        n = len(bufs)
        padded = _next_pow2(n)
        # a fresh (pinned, on CUDA) buffer: the copy to the card runs
        # asynchronously and the allocator keeps it until that is done
        staged = host_buffer((padded, 1, bpc), self.device)
        batch = staged.numpy()
        np.stack(bufs, out=batch[:n, 0])
        batch[n:] = 0
        words = self._crc_fn(bpc)(staged.to(self.device, non_blocking=True))
        self.dispatches += 1
        (crcs,) = finish_pull(start_pull((words,)))
        crcs = crcs.reshape(-1)[:n]
        exp = np.asarray(exps, dtype=np.uint32)
        for i in np.nonzero(crcs != exp)[0][:64]:
            lbl, sl = labels[int(i)]
            errors.append(f"{lbl}: crc mismatch at slice {sl}")
        bufs.clear()
        exps.clear()
        labels.clear()

    def scrub_container(self, dn: "Datanode", container_id: int,
                        mark_unhealthy: bool = True) -> list[str]:
        """Verify every chunk checksum in a container; returns error
        strings and (by default) poisons the replica on any."""
        c = dn.containers.get(container_id)
        errors: list[str] = []
        # bpc -> (slice buffers, expected crcs, (label, slice idx)); drained
        # to the device whenever a group reaches the batch cap, so peak
        # host memory is bounded by max_batch_bytes per group, not by the
        # container size
        groups: dict[int, tuple[list, list, list]] = {}
        for block in c.list_blocks():
            for info in block.chunks:
                cd = info.checksum
                if not cd.checksums:
                    continue
                label = f"{block.block_id}/{info.name}"
                try:
                    data = np.asarray(
                        c.chunks.read_chunk(block.block_id, info),
                        dtype=np.uint8,
                    ).reshape(-1)
                except StorageError as e:
                    # corruption evidence only if the block metadata is
                    # still live; a concurrently deleted block is a race,
                    # not damage
                    if c.db.get_block(block.block_id) is not None:
                        errors.append(f"{label}: {e}")
                    continue
                if cd.type is not ChecksumType.CRC32C:
                    try:
                        Checksum().verify(data, cd, label)
                    except ChecksumError as e:
                        errors.append(f"{label}: {e}")
                    continue
                bpc = cd.bytes_per_checksum
                n_full = data.size // bpc
                expected_entries = n_full + (1 if data.size % bpc else 0)
                if len(cd.checksums) != expected_entries:
                    errors.append(
                        f"{label}: {len(cd.checksums)} checksum entries "
                        f"for {data.size} bytes (expected "
                        f"{expected_entries})")
                    continue
                bufs, exps, labels = groups.setdefault(bpc, ([], [], []))
                cap = max(1, self.max_batch_bytes // bpc)
                for i in range(n_full):
                    bufs.append(data[i * bpc:(i + 1) * bpc])
                    exps.append(int.from_bytes(cd.checksums[i], "big"))
                    labels.append((label, i))
                    if len(bufs) >= cap:
                        self._dispatch(bpc, bufs, exps, labels, errors)
                tail = data[n_full * bpc:]
                if tail.size:
                    if crc32c(tail).to_bytes(4, "big") \
                            != cd.checksums[n_full]:
                        errors.append(
                            f"{label}: crc mismatch at tail slice "
                            f"{n_full}")
        for bpc, (bufs, exps, labels) in groups.items():
            self._dispatch(bpc, bufs, exps, labels, errors)
        if errors and mark_unhealthy:
            c.mark_unhealthy()
        dn.metrics.counter("containers_scrubbed").inc()
        return errors

    def scrub_all(self, dn: "Datanode") -> dict[int, list[str]]:
        """One pass over every scannable (writer-free) container."""
        out: dict[int, list[str]] = {}
        for c in dn.list_containers():
            if c.state not in SCANNABLE_STATES:
                continue
            try:
                errs = self.scrub_container(dn, c.id)
            except StorageError as e:
                errs = [str(e)]
            if errs:
                out[c.id] = errs
        return out
