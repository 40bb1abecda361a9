"""The port's composite file checksums against `ozone_tpu`'s, on the CPU.

Each test of `tests/test_file_checksum.py` runs as one script on a port
`MiniOzoneCluster` (device="cpu") and on a JAX one with the same seeded
bytes: the COMPOSITE-CRC32C answers (algorithm, hex value, length),
composed from the chunk CRCs the datanodes store, must be equal, and
equal to the host CRC32C of the bytes. For EC keys those stored CRCs are
the words the fused kernel's plain version wrote. A short group's
unwritten data unit answers NO_SUCH_BLOCK on the port's datanodes too,
so both compositions skip it alike.
"""

import types

import numpy as np
import pytest
import torch

from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu.utils.checksum import crc32c as j_crc32c
from ozone_tpu_torch.storage.ids import BlockID, StorageError
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
from ozone_tpu_torch.utils.checksum import crc32c

EC = "rs-3-2-4096"
RATIS = "RATIS/THREE"
REF = types.SimpleNamespace(name="ref")
PORT = types.SimpleNamespace(name="port")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(tmp_path, monkeypatch, script):
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    kw = dict(num_datanodes=5, block_size=4 * 4096,
              container_size=1024 * 1024, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    out = {}
    for P in (REF, PORT):
        root = tmp_path / P.name
        c = (MiniOzoneCluster(root, device="cpu", **kw) if P is PORT
             else JCluster(root, **kw))
        try:
            out[P.name] = script(c, c.client(), P)
        finally:
            c.close()
    assert out["port"] == out["ref"]
    return out["port"]


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("layout", ["OBJECT_STORE", "FILE_SYSTEM_OPTIMIZED"])
def test_replicated_composite_matches_whole_stream(tmp_path, monkeypatch,
                                                   layout):
    data = _payload(50_000, 0)  # spans several blocks

    def script(c, oz, P):
        oz.create_volume("v")
        c.om.create_bucket("v", "b", RATIS, layout)
        b = oz.get_volume("v").get_bucket("b")
        b.write_key("d/k", data)
        return b.file_checksum("d/k")

    out = both(tmp_path, monkeypatch, script)
    assert out["algorithm"] == "COMPOSITE-CRC32C"
    assert out["length"] == data.size
    assert int(out["checksum"], 16) == int(crc32c(data)) == j_crc32c(data)


@pytest.mark.parametrize("layout", ["OBJECT_STORE", "FILE_SYSTEM_OPTIMIZED"])
@pytest.mark.parametrize("n", [3 * 4096 * 2 + 4096 + 123, 100, 5000])
def test_ec_composite_matches_whole_stream(tmp_path, monkeypatch, layout, n):
    """Several stripes with a partial last cell and stripe; and groups
    too short to reach every data unit (100 B, 5000 B)."""
    data = _payload(n, 1)

    def script(c, oz, P):
        oz.create_volume("v")
        c.om.create_bucket("v", "b", EC, layout)
        b = oz.get_volume("v").get_bucket("b")
        b.write_key("d/k", data)
        return b.file_checksum("d/k")

    out = both(tmp_path, monkeypatch, script)
    assert out["length"] == data.size
    assert int(out["checksum"], 16) == int(crc32c(data))


def test_unwritten_unit_answers_no_such_block(tmp_path, monkeypatch):
    """A 100-byte rs-3-2 group writes data unit 0 and the parity only:
    units 1 and 2 hold no block, and their datanodes answer
    NO_SUCH_BLOCK, the code the checksum composition skips."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    c = MiniOzoneCluster(tmp_path, num_datanodes=5, block_size=4 * 4096,
                         container_size=1024 * 1024, stale_after_s=1000.0,
                         dead_after_s=2000.0, device="cpu")
    try:
        oz = c.client()
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k", _payload(100, 2))
        g = oz.om.lookup_key("v", "b", "k")["block_groups"][0]
        bid = BlockID(g["container_id"], g["local_id"])
        codes = []
        for dn_id in g["nodes"]:
            try:
                c.clients.get(dn_id).get_block(bid)
                codes.append(None)
            except StorageError as e:
                codes.append(e.code)
        assert codes == [None, "NO_SUCH_BLOCK", "NO_SUCH_BLOCK", None, None]
    finally:
        c.close()


def test_composite_equal_across_layouts(tmp_path, monkeypatch):
    """The distcp property: identical bytes under EC and replication give
    the same composite checksum."""
    data = _payload(27_001, 2)

    def script(c, oz, P):
        vol = oz.create_volume("v")
        ec_b = vol.create_bucket("ecb", replication=EC)
        rep_b = vol.create_bucket("repb", replication=RATIS)
        ec_b.write_key("k", data)
        rep_b.write_key("k", data)
        return ec_b.file_checksum("k"), rep_b.file_checksum("k")

    ec, rep = both(tmp_path, monkeypatch, script)
    assert ec == rep


def test_composite_differs_on_different_data(tmp_path, monkeypatch):
    def script(c, oz, P):
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        b.write_key("a", _payload(10_000, 3))
        b.write_key("b", _payload(10_000, 4))
        return b.file_checksum("a"), b.file_checksum("b")

    a, b = both(tmp_path, monkeypatch, script)
    assert a != b


def test_replicated_composite_survives_replica_loss(tmp_path, monkeypatch):
    data = _payload(20_000, 5)

    def script(c, oz, P):
        b = oz.create_volume("v").create_bucket("b", replication=RATIS)
        b.write_key("k", data)
        info = oz.om.lookup_key("v", "b", "k")
        c.stop_datanode(info["block_groups"][0]["nodes"][0])
        return b.file_checksum("k")

    out = both(tmp_path, monkeypatch, script)
    assert int(out["checksum"], 16) == int(crc32c(data))


def test_ec_composite_fails_loudly_when_a_unit_is_unreachable(tmp_path,
                                                              monkeypatch):
    """An unreachable data unit raises, never a plausible short
    composition."""
    def script(c, oz, P):
        b = oz.create_volume("v").create_bucket("b", replication=EC)
        b.write_key("k", _payload(3 * 4096 * 2, 6))
        info = oz.om.lookup_key("v", "b", "k")
        c.stop_datanode(info["block_groups"][0]["nodes"][0])
        try:
            b.file_checksum("k")
        except Exception as e:  # noqa: BLE001 - either package's error
            return type(e).__name__
        return None

    assert both(tmp_path, monkeypatch, script) is not None
