"""Multi-host meshes: the codec's communication backend across processes.

Port of `ozone_tpu/parallel/multihost.py`. Where the reference joins its
processes into one `jax.distributed` runtime and lets XLA place the
collectives, the port joins them into one `torch.distributed` process
group and `parallel/sharded.py` calls the collectives itself: the TP
partials meet through `all_gather_into_tensor`, the ring's hops cross a
process boundary through `batch_isend_irecv`, and the DP forms need none.

    from ozone_tpu_torch.parallel import multihost
    multihost.initialize("10.0.0.1:8476", num_processes=4, process_id=i)
    mesh = multihost.global_codec_mesh()          # 1-D, every rank's slots
    hybrid = multihost.hybrid_codec_mesh()        # ("dcn", "dn"), 2-D

On CUDA (the default) the group runs NCCL with one GPU per rank (NCCL
refuses two ranks on one card): rank r takes local GPU r mod the local
count. With device="cpu" it runs gloo, and a rank may hold several
logical CPU slots (`local_device_count`), as the reference's CPU test
rig carves a process into virtual devices. Nothing on the host tells a
process of the cluster: the caller gives the coordinator's address, the
process count and this process's rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ozone_tpu_torch.codec.fused import resolve_device
from ozone_tpu_torch.parallel.sharded import Mesh, Slot, process_rank

#: this process's slot devices, set by initialize()
_local_devices: list[torch.device] = []


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_count: Optional[int] = None,
               device="cuda") -> None:
    """Join this process to the cluster-wide process group (rank 0 hosts
    the TCP store at `coordinator_address`, "host:port"); every process
    calls it before building a mesh. Idempotent per process."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        if local_device_count not in (None, 1):
            raise ValueError("NCCL takes one GPU per rank; local_device_count "
                             "must be 1 on CUDA")
        gpu = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(gpu)
        slots, backend = [gpu], "nccl"
    else:
        slots, backend = [dev] * (local_device_count or 1), "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _local_devices[:] = slots


def _slot_grid() -> list[list[Slot]]:
    """Every rank's slots, rank-major: each rank's slot count and device
    type come from an all_gather, the indexes run over the whole grid."""
    if not dist.is_initialized():
        raise RuntimeError("multihost.initialize has not run in this process")
    mine = [(d.type, d.index) for d in _local_devices]
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    counts = [len(x) for x in every]
    if len(set(counts)) != 1:
        raise ValueError(f"uneven devices per process: {counts}")
    grid, i = [], 0
    for rank, devs in enumerate(every):
        row = []
        for typ, index in devs:
            row.append(Slot(i, torch.device(typ, index) if index is not None
                            else torch.device(typ), rank))
            i += 1
        grid.append(row)
    return grid


def global_codec_mesh(axis: str = "dn") -> Mesh:
    """1-D mesh over every slot of every process, in rank order: the
    shape the DP encoder and the survivor ring shard over, with ring
    neighbours on one host wherever they can be (a hop crosses processes
    only at a rank boundary)."""
    return Mesh([s for row in _slot_grid() for s in row], (axis,))


def hybrid_codec_mesh(ici_axis: str = "dn", dcn_axis: str = "dcn") -> Mesh:
    """2-D (dcn, dn) mesh: processes on the outer axis, each process's
    slots contiguous on the inner one."""
    grid = _slot_grid()
    return Mesh([s for row in grid for s in row], (dcn_axis, ici_axis),
                shape=(len(grid), len(grid[0])))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_rank() == 0
