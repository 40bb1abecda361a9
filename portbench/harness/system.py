"""The system under test: `ozone_tpu_torch` as a user meets it.

`ObjectStore` is an in-process `MiniOzoneCluster` (SCM, OM, datanodes)
with one bucket of the configuration's scheme, driven through
`OzoneBucket.write_key` and `read_key`. `CodecSidecar` is the shared codec
service, driven as the EC writer drives it (`client/ec_writer.py`
`_flush_queue`). Both read the program's state back for the comparison
(`units`), and nothing else of the program is used here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

VOLUME, BUCKET = "bench", "b"


class ObjectStore:
    def __init__(self, config: dict, root: Path, device):
        from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

        self.config = config
        self.cluster = MiniOzoneCluster(
            Path(root), num_datanodes=config["datanodes"],
            block_size=config["block_bytes"],
            container_size=config["container_bytes"],
            placement_seed=config["placement_seed"], device=device)
        client = self.cluster.client()
        self.bucket = client.create_volume(VOLUME).create_bucket(
            BUCKET, replication=config["scheme"])
        self.down: list[str] = []

    def put(self, name: str, data: np.ndarray) -> None:
        self.bucket.write_key(name, data)

    def get(self, name: str) -> np.ndarray:
        return self.bucket.read_key(name)

    def key_info(self, name: str) -> dict:
        return self.cluster.om.lookup_key(VOLUME, BUCKET, name)

    def stop_units(self, name: str, units: list[int]) -> list[str]:
        """Stop the datanodes that hold `units` of the first group of key
        `name` (no heartbeat runs, so nothing repairs them)."""
        nodes = self.key_info(name)["block_groups"][0]["nodes"]
        for u in units:
            self.cluster.stop_datanode(nodes[u])
            self.down.append(nodes[u])
        return [nodes[u] for u in units]

    def units(self, info: dict) -> list[list[list[dict]]]:
        """What the datanodes hold of a key, read back from their stores
        (stopped datanodes included): per group, per unit, its chunks in
        offset order, each {"bytes", "type", "bpc", "words"}."""
        from ozone_tpu_torch.storage.ids import BlockID

        out = []
        for g in info["block_groups"]:
            bid = BlockID(int(g["container_id"]), int(g["local_id"]))
            per_unit = []
            for dn_id in g["nodes"]:
                dn = self.cluster.datanode(dn_id)
                try:
                    block = dn.get_block(bid)
                except Exception:  # noqa: BLE001 - no block: no chunks
                    per_unit.append([])
                    continue
                chunks = []
                for c in sorted(block.chunks, key=lambda c: c.offset):
                    chunks.append({
                        "bytes": dn.read_chunk(bid, c),
                        "type": c.checksum.type.value,
                        "bpc": c.checksum.bytes_per_checksum,
                        "words": [int.from_bytes(w, "big")
                                  for w in c.checksum.checksums],
                    })
                per_unit.append(chunks)
            out.append(per_unit)
        return out

    def close(self) -> None:
        self.cluster.close()


def survivors(k: int, p: int, erased: list[int]) -> list[int]:
    """The units a decode of `erased` reads: the first k of the others, as
    Ozone's RS decoder takes its valid inputs."""
    return [u for u in range(k + p) if u not in erased][:k]


class CodecSidecar:
    """The codec service with one lane of the EC client's: the writer's
    encode (`client/ec_writer.py` `_flush_queue`), or, given `erased`, the
    degraded reader's decode of those units from the first k others
    (`client/ec_reader.py` `_decode_pipe`). `code(batch)` submits one
    [B, k, C] batch at the lane's width and waits for (parity or
    recovered units, CRC words)."""

    def __init__(self, config: dict, device, width: int,
                 erased: list[int] | None = None):
        from ozone_tpu_torch.codec import service
        from ozone_tpu_torch.codec.api import CoderOptions
        from ozone_tpu_torch.codec.fused import (
            FusedSpec,
            make_fused_decoder,
            make_fused_encoder,
        )
        from ozone_tpu_torch.codec.pipeline import host_buffer
        from ozone_tpu_torch.utils.checksum import ChecksumType

        self.spec = FusedSpec(CoderOptions.parse(config["scheme"]),
                              ChecksumType[config["checksum"]],
                              config["bytes_per_checksum"])
        if erased:
            self.valid = survivors(config["data_units"],
                                   config["parity_units"], erased)
            self.erased = list(erased)
            self.fn = make_fused_decoder(self.spec, self.valid, self.erased,
                                         device=device)
            self.key = service.decode_key(self.spec, self.valid, self.erased)
        else:
            self.valid, self.erased = [], []
            self.fn = make_fused_encoder(self.spec, device=device)
            self.key = service.encode_key(self.spec)
        self.svc = service.get_service()
        self.width = width
        self._host_buffer = host_buffer
        self.device = device

    def staged(self, data: np.ndarray):
        """A batch staged as the writer stages one (`host_buffer`: pinned
        for CUDA)."""
        import torch

        buf = self._host_buffer(data.shape, torch.device(self.device))
        buf.numpy()[...] = data
        return buf

    def code(self, staged) -> tuple[np.ndarray, np.ndarray]:
        return self.svc.submit(self.key, self.fn, staged,
                               width=self.width).result(timeout=120)
