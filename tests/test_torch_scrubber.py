"""The port's device scrubber against `ozone_tpu`'s, on the CPU.

Each `DeviceScrubber` test of tests/test_scrubber.py (the daemon's
background loop is not ported) on the port's datanode, with the scrub on
device="cpu" (the kernel's plain version): a clean container, corruption
in a full slice and in a tail, a checksum-count mismatch, agreement with
the host scan, the deleted-block race and `scrub_all` skipping open
containers. Then containers holding the same chunks with the same
corruption in a port and a JAX datanode: the port's error list equals the
JAX scrubber's.
"""

import unittest.mock as mock

import numpy as np
import pytest

from ozone_tpu.storage import datanode as j_datanode
from ozone_tpu.storage import ids as j_ids
from ozone_tpu.storage import scrubber as j_scrubber
from ozone_tpu.utils import checksum as j_checksum
from ozone_tpu_torch.storage import datanode, ids, scrubber
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import BlockData, BlockID, ChunkInfo, ContainerState
from ozone_tpu_torch.storage.scrubber import DeviceScrubber
from ozone_tpu_torch.utils import checksum
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumData, ChecksumType


@pytest.fixture
def dn(tmp_path):
    d = Datanode(tmp_path, dn_id="dn0")
    yield d
    d.close()


def scrub(**kw):
    return DeviceScrubber(device="cpu", **kw)


def put_chunk(dn, bid, name, offset, payload, bpc=4096):
    arr = np.frombuffer(payload, np.uint8)
    info = ChunkInfo(
        name, offset, len(payload),
        checksum=Checksum(ChecksumType.CRC32C, bpc).compute(arr),
    )
    dn.write_chunk(bid, info, arr)
    return info


def flip(dn, cid, bid, pos, mask=0xFF):
    path = dn.containers.get(cid).chunks.block_path(bid)
    raw = bytearray(path.read_bytes())
    raw[pos] ^= mask
    path.write_bytes(bytes(raw))


def test_scrub_clean_container(dn):
    dn.create_container(1)
    bid = BlockID(1, 1)
    rng = np.random.default_rng(0)
    # mixed sizes: multiple full slices plus a tail slice
    c0 = put_chunk(dn, bid, "c0", 0, rng.bytes(3 * 4096))
    c1 = put_chunk(dn, bid, "c1", 3 * 4096, rng.bytes(4096 + 1000))
    dn.put_block(BlockData(bid, [c0, c1]))
    s = scrub()
    assert s.scrub_container(dn, 1) == []
    assert s.dispatches == 1  # four full slices, padded to four
    assert dn.containers.get(1).state is ContainerState.OPEN
    assert dn.metrics.counter("containers_scrubbed").value == 1


def test_scrub_detects_corruption_and_poisons_replica(dn):
    dn.create_container(1)
    bid = BlockID(1, 1)
    rng = np.random.default_rng(1)
    c0 = put_chunk(dn, bid, "c0", 0, rng.bytes(2 * 4096))
    dn.put_block(BlockData(bid, [c0]))
    flip(dn, 1, bid, 4096 + 7)  # one byte of the second slice
    errs = scrub().scrub_container(dn, 1)
    assert len(errs) == 1 and "slice 1" in errs[0]
    assert dn.containers.get(1).state is ContainerState.UNHEALTHY


def test_scrub_detects_tail_corruption(dn):
    dn.create_container(1)
    bid = BlockID(1, 1)
    payload = np.random.default_rng(2).bytes(4096 + 500)
    c0 = put_chunk(dn, bid, "c0", 0, payload)
    dn.put_block(BlockData(bid, [c0]))
    flip(dn, 1, bid, -1, 0x01)
    errs = scrub().scrub_container(dn, 1)
    assert len(errs) == 1 and "tail" in errs[0]


def test_scrub_flags_checksum_count_mismatch(dn):
    dn.create_container(1)
    bid = BlockID(1, 1)
    payload = np.frombuffer(
        np.random.default_rng(3).bytes(2 * 4096), np.uint8)
    good = Checksum(ChecksumType.CRC32C, 4096).compute(payload)
    short = ChecksumData(good.type, good.bytes_per_checksum,
                         good.checksums[:1])
    info = ChunkInfo("c0", 0, len(payload), checksum=short)
    dn.write_chunk(bid, info, payload)
    dn.put_block(BlockData(bid, [info]))
    errs = scrub().scrub_container(dn, 1)
    assert len(errs) == 1 and "checksum entries" in errs[0]


def test_scrub_agrees_with_host_scan(dn):
    """The device scrub and the host scan agree on a corrupted container
    (same detection contract, different engine) and name the same chunk."""
    dn.create_container(1)
    bid = BlockID(1, 1)
    c0 = put_chunk(dn, bid, "c0", 0,
                   np.random.default_rng(4).bytes(4 * 4096))
    dn.put_block(BlockData(bid, [c0]))
    flip(dn, 1, bid, 2 * 4096, 0x10)
    dev = scrub().scrub_container(dn, 1, mark_unhealthy=False)
    assert dn.containers.get(1).state is ContainerState.OPEN
    host = dn.scan_container(1)
    assert len(dev) == len(host) == 1
    assert dev[0].split(":")[0] == host[0].split(":")[0] == "blk_1_1/c0"
    assert dn.containers.get(1).state is ContainerState.UNHEALTHY


def test_scrub_skips_concurrently_deleted_block(dn):
    """A block deleted between listing and reading is a race, not
    corruption: the replica is not poisoned."""
    dn.create_container(1)
    bid = BlockID(1, 1)
    c0 = put_chunk(dn, bid, "c0", 0,
                   np.random.default_rng(6).bytes(4096))
    dn.put_block(BlockData(bid, [c0]))
    c = dn.containers.get(1)
    blocks = c.list_blocks()
    # the deletion lands mid-scrub: data and metadata gone
    c.chunks.delete_block(bid)
    c.db.delete_block(bid)
    with mock.patch.object(c, "list_blocks", return_value=blocks):
        errs = scrub().scrub_container(dn, 1)
    assert errs == []
    assert c.state is ContainerState.OPEN


def test_scrub_all_skips_open_containers(dn):
    dn.create_container(1)
    dn.create_container(2)
    for cid in (1, 2):
        bid = BlockID(cid, 1)
        ch = put_chunk(dn, bid, "c0", 0,
                       np.random.default_rng(cid).bytes(4096))
        dn.put_block(BlockData(bid, [ch]))
        flip(dn, cid, bid, 0)
    dn.close_container(2)  # only container 2 is scannable
    assert [c.id for c in dn.list_containers()] == [1, 2]
    out = scrub().scrub_all(dn)
    assert list(out) == [2]
    assert dn.containers.get(1).state is ContainerState.OPEN
    assert dn.containers.get(2).state is ContainerState.UNHEALTHY


def test_batch_cap_splits_into_power_of_two_launches(dn):
    """A container larger than the batch cap goes in several batches, each
    padded to a power of two, and still finds the one bad slice."""
    dn.create_container(1)
    bid = BlockID(1, 1)
    c0 = put_chunk(dn, bid, "c0", 0,
                   np.random.default_rng(8).bytes(11 * 1024), bpc=1024)
    dn.put_block(BlockData(bid, [c0]))
    flip(dn, 1, bid, 9 * 1024 + 3)
    s = scrub(max_batch_bytes=4 * 1024)
    errs = s.scrub_container(dn, 1)
    assert errs == ["blk_1_1/c0: crc mismatch at slice 9"]
    assert s.dispatches == 3  # 4 + 4 + 3 slices, the last padded to 4
    assert scrubber._next_pow2(3) == 4 and scrubber._next_pow2(1) == 1


# ------------------------------------------------- against the reference
#: chunk -> (block, offset, checksum type)
CHUNKS = {"c0": (1, 0, "CRC32C"), "c1": (1, 3 * 4096, "CRC32C"),
          "c2": (2, 0, "CRC32C"), "c3": (2, 2 * 4096, "CRC32")}
CASES = {
    "clean": [],
    "full slices": [("c0", 5), ("c0", 2 * 4096 + 1), ("c2", 4096)],
    "tail": [("c1", 4096 + 999)],
    "every kind": [("c0", 0), ("c1", 4096 + 10), ("c3", 17)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_scrub_matches_reference(tmp_path, case):
    """Two blocks holding CRC32C chunks (full slices and a tail) and a
    CRC32 chunk, in a port and a JAX datanode, with the same bytes flipped
    in both: the error lists and the container states are equal, and so
    are the chunks the host scans name."""
    rng = np.random.default_rng(9)
    payloads = {"c0": rng.bytes(3 * 4096), "c1": rng.bytes(4096 + 1000),
                "c2": rng.bytes(2 * 4096), "c3": rng.bytes(500)}
    results = []
    for dn_mod, ids_mod, sum_mod, scrub_mod, kw in (
            (datanode, ids, checksum, scrubber, {"device": "cpu"}),
            (j_datanode, j_ids, j_checksum, j_scrubber, {})):
        d = dn_mod.Datanode(tmp_path / scrub_mod.__name__, dn_id="dn0")
        try:
            d.create_container(1)
            infos = {}
            for name, (block, offset, typ) in CHUNKS.items():
                arr = np.frombuffer(payloads[name], np.uint8)
                cd = sum_mod.Checksum(sum_mod.ChecksumType[typ], 4096).compute(arr)
                info = ids_mod.ChunkInfo(name, offset, arr.size, checksum=cd)
                d.write_chunk(ids_mod.BlockID(1, block), info, arr)
                infos[name] = info
            d.put_block(ids_mod.BlockData(ids_mod.BlockID(1, 1),
                                          [infos["c0"], infos["c1"]]))
            d.put_block(ids_mod.BlockData(ids_mod.BlockID(1, 2),
                                          [infos["c2"], infos["c3"]]))
            for name, pos in CASES[case]:
                block, offset, _typ = CHUNKS[name]
                flip(d, 1, ids_mod.BlockID(1, block), offset + pos)
            errs = scrub_mod.DeviceScrubber(**kw).scrub_container(d, 1)
            state = d.containers.get(1).state.value
            host = sorted(e.split(":")[0] for e in d.scan_container(1))
            results.append((errs, state, host))
        finally:
            d.close()
    assert results[0] == results[1]
    assert bool(results[0][0]) == bool(CASES[case])
