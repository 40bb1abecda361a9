"""The port's re-encode against `ozone_tpu`'s, on the CPU.

`make_fused_reencoder` and `reencode_layout_crcs` equal the JAX
package's for every lost unit of RS(3,2) and RS(6,3) under CRC32C, CRC32
and no checksum. Then a port and a JAX `MiniOzoneCluster` (both seeded)
run the same conversions: a replicated key to rs-3-2, an XOR(3,1) key
with data unit 0, 1 or 2 down (the fused re-encode) and one with its XOR
parity down (the plain encode), on the codec service and on the direct
route. The re-read bytes, the new key rows and every new chunk with its
stored CRCs must be equal, and the service dispatches equal on both
sides. The rewrite fence holds (KEY_MODIFIED). Where the reference
fails, the port re-encodes past an open target container with a dead
member and reads a short group's empty data units as zeros.
"""

import numpy as np
import pytest
import torch

from ozone_tpu.client import re_encode as j_re_encode
from ozone_tpu.client.ec_writer import StripeWriteError as JStripeWriteError
from ozone_tpu.codec import fused as j_fused
from ozone_tpu.codec import service as j_service
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.scm.node_manager import NodeState as JNodeState
from ozone_tpu.storage.ids import StorageError as JStorageError
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch.client import re_encode
from ozone_tpu_torch.codec import fused
from ozone_tpu_torch.codec import service
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.om.requests import KEY_MODIFIED, OMError
from ozone_tpu_torch.scm.node_manager import NodeState
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster
from ozone_tpu_torch.utils.checksum import ChecksumType
from test_torch_control_plane import key_row, stored_chunks

RS = "rs-3-2-4096"
XOR = "xor-3-1-4096"
BLOCK = 256 * 1024
#: stripes per re-encode window (OZONE_TPU_DECODE_BATCH); every XOR key
#: below has a multiple of it in each group, so each side compiles one
#: window shape
WINDOW = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain PyTorch versions run at test sizes on one thread: the
    suite runs in several worker processes on shared cores, and torch's
    default of a thread per core in each of them would oversubscribe
    every core the timing-sensitive tests beside these need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- re-encoder
@pytest.mark.parametrize("checksum", ["CRC32C", "CRC32", "NONE"])
@pytest.mark.parametrize("k,p,lost", [(3, 2, u) for u in range(3)]
                         + [(6, 3, u) for u in range(6)])
def test_reencoder_matches_reference(k, p, lost, checksum):
    cell, bpc, b = 2048, 512, 2
    rng = np.random.default_rng(100 * k + lost)
    data = rng.integers(0, 256, (b, k, cell), dtype=np.uint8)
    units = data.copy()
    units[:, lost] = np.bitwise_xor.reduce(data, axis=1)  # the XOR parity
    spec = fused.FusedSpec(CoderOptions(k, p, "rs", cell_size=cell),
                           ChecksumType[checksum], bpc)
    jspec = j_fused.FusedSpec(JOptions(k, p, "rs", cell_size=cell),
                              JChecksumType[checksum], bpc)
    out, ucrcs, ocrcs = fused.make_fused_reencoder(spec, lost, "cpu")(
        torch.from_numpy(units))
    jout, jucrcs, jocrcs = (np.asarray(x) for x in
                            j_fused.make_fused_reencoder(jspec, lost)(units))
    out = out.numpy()
    ucrcs, ocrcs = (c.numpy().view(np.uint32) for c in (ucrcs, ocrcs))
    assert np.array_equal(out, jout)
    assert np.array_equal(ucrcs, jucrcs) and ucrcs.shape == jucrcs.shape
    assert np.array_equal(ocrcs, jocrcs) and ocrcs.shape == jocrcs.shape
    assert np.array_equal(out[:, 0], data[:, lost])
    if checksum != "NONE":
        layout = fused.reencode_layout_crcs(ucrcs, ocrcs, lost)
        assert np.array_equal(
            layout, j_fused.reencode_layout_crcs(jucrcs, jocrcs, lost))
        assert layout.shape == (b, k + p, cell // bpc)


# ---------------------------------------------------------------- clusters
@pytest.fixture
def clusters(tmp_path, monkeypatch, request):
    route = getattr(request, "param", "direct")
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE",
                       "1" if route == "service" else "0")
    monkeypatch.setenv("OZONE_TPU_DECODE_BATCH", str(WINDOW))
    service.reset_for_tests()
    j_service.reset_for_tests()
    kw = dict(num_datanodes=8, racks=2, block_size=BLOCK,
              container_size=4 * 1024 * 1024, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    port = MiniOzoneCluster(tmp_path / "port", device="cpu", **kw)
    ref = JCluster(tmp_path / "ref", **kw)
    yield port, ref, route
    port.close()
    ref.close()
    service.reset_for_tests()
    j_service.reset_for_tests()


def _dispatches(mod) -> int:
    return mod.METRICS.counter("dispatches").value


def _kill(cluster, dn_id):
    """Stop a datanode and let the SCM's liveness sweep find it dead."""
    cluster.stop_datanode(dn_id)
    cluster.scm.nodes.get(dn_id).last_heartbeat = -1e9
    cluster.scm.nodes.check_liveness()
    assert cluster.scm.nodes.get(dn_id).state in (NodeState.DEAD,
                                                  JNodeState.DEAD)


def _convert(c, oz, src_repl, size, down, seed):
    """Write a key of `src_repl`, take the datanode of unit `down` of
    every group down (None: none), re-encode to RS and re-read. Returns
    what must equal across the packages, and the service dispatches the
    conversion made."""
    data = np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8)
    b = oz.create_volume("v").create_bucket("b", replication=src_repl)
    b.write_key("k", data)
    before = oz.om.lookup_key("v", "b", "k")
    if down is not None:
        for node in {g["nodes"][down] for g in before["block_groups"]}:
            _kill(c, node)
    svc = service if isinstance(c, MiniOzoneCluster) else j_service
    d0 = _dispatches(svc)
    if isinstance(c, MiniOzoneCluster):
        info = re_encode.re_encode_key_to_ec(c.om, c.clients, "v", "b", "k",
                                             ec=RS, device="cpu")
    else:
        info = j_re_encode.re_encode_key_to_ec(c.om, c.clients, "v", "b",
                                               "k", ec=RS)
    dispatches = _dispatches(svc) - d0
    reread = b.read_key("k")
    ranged = b.read_key_range("k", 5000, size // 2)
    assert np.array_equal(reread, data)
    assert np.array_equal(ranged, data[5000:5000 + size // 2])
    purged = c.om.run_key_deleting_service_once()
    return (key_row(info), stored_chunks(c, info), purged), dispatches


def _stripes(size: int, k: int = 3, cell: int = 4096) -> list[int]:
    """Stripes per group of a key of `size` bytes in RS/XOR(3) groups."""
    per_group = 3 * BLOCK
    sizes = [min(per_group, size - o) for o in range(0, size, per_group)]
    return [-(-n // (k * cell)) for n in sizes]


FLOWS = [
    # (source, key size, unit down): XOR keys of a full group (64 stripes)
    # and a short one of 4 stripes, or one short group of 8 stripes
    ("RATIS/THREE", 3 * BLOCK + 70_000, None),
    (XOR, 3 * BLOCK + 36_964, 0),
    (XOR, 3 * BLOCK + 36_964, 1),
    (XOR, 90_000, 2),
    (XOR, 3 * BLOCK + 36_964, 3),  # the XOR parity itself
]


@pytest.mark.parametrize("clusters", ["service", "direct"], indirect=True)
@pytest.mark.parametrize("src,size,down", FLOWS)
def test_re_encode_matches_reference(clusters, src, size, down):
    port, ref, route = clusters
    got, port_disp = _convert(port, port.client(), src, size, down, size)
    want, ref_disp = _convert(ref, ref.client(), src, size, down, size)
    assert got[0] == want[0]
    assert got[0]["replication"] == RS and got[0]["size"] == size
    assert got[1] == want[1]  # every new chunk, its bytes and its CRCs
    assert got[2] == want[2] == 1  # the old version went to the purge
    assert port_disp == ref_disp
    if route == "direct":
        assert port_disp == 0
    elif src == XOR:
        # one dispatch per window of every group: nothing else submits
        assert port_disp == sum(-(-s // WINDOW) for s in _stripes(size))
    else:
        assert port_disp >= 1


def test_re_encode_loses_to_concurrent_overwrite(clusters, monkeypatch):
    """A user overwrite that lands while the conversion reads wins: the
    fenced commit refuses with KEY_MODIFIED, the overwrite stays on its
    own scheme, and the conversion's blocks go to the purge chain."""
    port, _ref, _route = clusters
    oz = port.client()
    b = oz.create_volume("v").create_bucket("b", replication="RATIS/THREE")
    rng = np.random.default_rng(3)
    b.write_key("k", rng.integers(0, 256, 60_000, dtype=np.uint8))
    fresh = rng.integers(0, 256, 50_000, dtype=np.uint8)
    orig = re_encode.ReplicatedKeyReader.read_all
    fired = []

    def hooked(self):
        out = orig(self)
        if not fired:
            fired.append(1)
            b.write_key("k", fresh)
        return out

    monkeypatch.setattr(re_encode.ReplicatedKeyReader, "read_all", hooked)
    with pytest.raises(OMError) as ei:
        re_encode.re_encode_key_to_ec(port.om, port.clients, "v", "b", "k",
                                      ec=RS, device="cpu")
    assert ei.value.code == KEY_MODIFIED and fired
    info = oz.om.lookup_key("v", "b", "k")
    assert info["replication"] == "RATIS/THREE"
    assert np.array_equal(b.read_key("k"), fresh)
    assert port.om.run_key_deleting_service_once() >= 1
    with pytest.raises(ValueError):  # an RS key is not converted again
        b2 = oz.get_volume("v").create_bucket("rs", replication=RS)
        b2.write_key("k", fresh)
        re_encode.re_encode_key_to_ec(port.om, port.clients, "v", "rs", "k",
                                      device="cpu")


def test_re_encode_reallocates_past_a_dead_target_member(clusters):
    """After a replicated->RS conversion leaves an open RS container, one
    of its members dies and an XOR key is converted: the SCM hands out
    that container again. The port excludes the dead member and
    reallocates; the reference fails the conversion."""
    port, ref, _route = clusters
    rng = np.random.default_rng(4)
    rep = rng.integers(0, 256, 40_000, dtype=np.uint8)
    xor = rng.integers(0, 256, 40_000, dtype=np.uint8)
    for c in (port, ref):
        oz = c.client()
        vol = oz.create_volume("v")
        vol.create_bucket("r", replication="RATIS/THREE").write_key("k", rep)
        vol.create_bucket("x", replication=XOR).write_key("k", xor)
        kw = {"device": "cpu"} if c is port else {}
        mod = re_encode if c is port else j_re_encode
        first = mod.re_encode_key_to_ec(c.om, c.clients, "v", "r", "k",
                                        ec=RS, **kw)
        xnodes = oz.om.lookup_key("v", "x", "k")["block_groups"][0]["nodes"]
        victim = next(n for n in first["block_groups"][0]["nodes"]
                      if n not in xnodes)
        _kill(c, victim)
        if c is ref:
            with pytest.raises(JStripeWriteError):
                mod.re_encode_key_to_ec(c.om, c.clients, "v", "x", "k",
                                        ec=RS)
            continue
        info = mod.re_encode_key_to_ec(c.om, c.clients, "v", "x", "k",
                                       ec=RS, **kw)
        assert victim not in info["block_groups"][0]["nodes"]
        assert np.array_equal(vol.get_bucket("x").read_key("k"), xor)


def test_re_encode_reads_a_short_groups_empty_units_as_zeros(clusters):
    """An XOR key whose last group is 100 B holds no bytes on data units 1
    and 2 of that group (the writer makes no block there). The port reads
    them as known zeros and converts the key; the reference counts them as
    lost and refuses."""
    port, ref, _route = clusters
    data = np.random.default_rng(6).integers(0, 256, 3 * BLOCK + 100,
                                             dtype=np.uint8)
    for c in (port, ref):
        b = c.client().create_volume("v").create_bucket("x",
                                                        replication=XOR)
        b.write_key("k", data)
        if c is ref:
            with pytest.raises(JStorageError) as ei:
                j_re_encode.re_encode_key_to_ec(c.om, c.clients, "v", "x",
                                                "k", ec=RS)
            assert ei.value.code == "INSUFFICIENT_LOCATIONS"
            continue
        info = re_encode.re_encode_key_to_ec(c.om, c.clients, "v", "x", "k",
                                             ec=RS, device="cpu")
        assert info["replication"] == RS and len(info["block_groups"]) == 2
        assert np.array_equal(b.read_key("k"), data)
