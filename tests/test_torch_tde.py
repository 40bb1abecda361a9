"""Encryption at rest on the port: TDE and GDPR buckets, against `ozone_tpu`.

The reference's `tests/test_tde.py` on a port `MiniOzoneCluster` (the
CPU's plain kernel versions): master keys in the OM's store, a fresh
EDEK per key at open, client-side AES-CTR (datanodes hold ciphertext),
rotation, multipart keys with per-part IVs, ranged reads and hsync'd
prefixes, GDPR crypto-erasure in the delete's apply (OBS, FSO, an
overwrite, a recursive delete), the KMS decrypt bound to the bucket, and
`.snapshot/` reads of an encrypted key after its overwrite. Across
the packages: `ctr_crypt` equals the reference's byte for byte at any
offset and length (a counter that wraps 2^128 included), an EDEK wrapped
by one package's `KeyProvider` unwraps in the other's over the same
store rows, and an om.db the reference wrote with a TDE key, a GDPR key
and an encrypted multipart key reads byte-exact through the port's OM
and client over port datanodes opened on the reference's directories.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("cryptography")

from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster  # noqa: E402
from ozone_tpu.utils import kms as j_kms  # noqa: E402
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory  # noqa: E402
from ozone_tpu_torch.client.ozone_client import OzoneClient  # noqa: E402
from ozone_tpu_torch.om.metadata import OMMetadataStore  # noqa: E402
from ozone_tpu_torch.om.om import OzoneManager  # noqa: E402
from ozone_tpu_torch.om.requests import OMError  # noqa: E402
from ozone_tpu_torch.scm import scm  # noqa: E402
from ozone_tpu_torch.storage.datanode import Datanode  # noqa: E402
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster  # noqa: E402
from ozone_tpu_torch.utils import kms  # noqa: E402
from ozone_tpu_torch.utils.kms import ctr_crypt  # noqa: E402

EC = "rs-3-2-4096"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions on one thread: the suite's worker processes
    share the cores with timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = MiniOzoneCluster(
        tmp_path_factory.mktemp("tde"),
        num_datanodes=5,
        block_size=8 * 4096,
        container_size=4 * 1024 * 1024,
        stale_after_s=1000.0,
        dead_after_s=2000.0,
        device="cpu",
    )
    c.client().create_volume("ev")
    c.om.kms_create_key("mk1")
    c.om.create_bucket("ev", "enc", EC, encryption_key="mk1")
    c.om.create_bucket("ev", "gdpr", EC, gdpr=True)
    yield c
    c.close()


def _payload(seed, n=60_000):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_ctr_crypt_offsets():
    key, iv = b"k" * 32, b"\x00" * 15 + b"\x05"
    data = np.frombuffer(bytes(range(256)) * 10, np.uint8)
    whole = ctr_crypt(data, key, iv)
    assert np.array_equal(whole, j_kms.ctr_crypt(data, key, iv))
    # any split point (aligned or not) produces the same stream
    for cut in (16, 33, 100, 255):
        a = ctr_crypt(data[:cut], key, iv, 0)
        b = ctr_crypt(data[cut:], key, iv, cut)
        assert np.array_equal(np.concatenate([a, b]), whole)
    assert np.array_equal(ctr_crypt(whole, key, iv), data)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), offset=st.integers(0, 5000),
       length=st.integers(0, 3000),
       iv_top=st.sampled_from([0, 2**128 - 1, 2**128 - 3, 2**64 - 1,
                               2**127]))
def test_ctr_crypt_equals_reference(seed, offset, length, iv_top):
    """Byte for byte the reference's at any offset and length; the IVs
    near 2^128 - 1 wrap the counter within the stream (the base taken mod
    2^128)."""
    rng = np.random.default_rng(seed)
    key = rng.bytes(32)
    iv = ((iv_top - int(rng.integers(0, 4))) % (1 << 128)).to_bytes(16, "big")
    data = rng.integers(0, 256, length, dtype=np.uint8)
    got = ctr_crypt(data, key, iv, offset)
    assert got.dtype == np.uint8 and got.size == length
    assert got.tobytes() == j_kms.ctr_crypt(data, key, iv, offset).tobytes()
    # bytes in, the same stream out
    assert ctr_crypt(data.tobytes(), key, iv, offset).tobytes() == \
        got.tobytes()


def test_edek_unwraps_across_packages(tmp_path):
    """One store's master-key rows: an EDEK the port wraps unwraps in the
    reference's KeyProvider, and the other way round, across a
    rotation."""
    from ozone_tpu.om.metadata import OMMetadataStore as JStore
    from ozone_tpu.om.requests import CreateMasterKey as JCreate

    from ozone_tpu_torch.om.requests import CreateMasterKey

    port_store = OMMetadataStore(tmp_path / "om.db")
    req = CreateMasterKey("mk")
    req.pre_execute(None)
    req.apply(port_store)
    port_store.close()
    ref_store = JStore(tmp_path / "om.db")
    rot = JCreate("mk", rotate=True)
    rot.pre_execute(None)
    rot.apply(ref_store)
    ref = j_kms.KeyProvider(ref_store)
    port = kms.KeyProvider(ref_store)  # the rows, read through either
    assert port.master_info("mk") == ref.master_info("mk") == \
        {"name": "mk", "versions": 2}
    assert port.master_key_names() == ref.master_key_names() == ["mk"]
    for a, b in ((port, ref), (ref, port)):
        bundle = a.generate_edek("mk")
        assert bundle["version"] == 1 and bundle["master"] == "mk"
        assert b.unwrap_edek(bundle) == a.unwrap_edek(bundle)
        assert len(b.unwrap_edek(bundle)) == 32
        # a tampered EDEK or another master is refused in both
        bad = dict(bundle, edek=("00" + bundle["edek"][2:]))
        for p in (a, b):
            with pytest.raises(Exception):
                p.unwrap_edek(bad)
    with pytest.raises(OMError) as e:
        port.generate_edek("ghost")
    assert e.value.code == "INVALID_REQUEST"
    ref_store.close()


def test_kms_master_key_lifecycle(cluster):
    om = cluster.om
    assert "mk1" in om.kms_list_keys()
    assert om.kms_key_info("mk1")["versions"] >= 1
    with pytest.raises(OMError):
        om.kms_create_key("mk1")  # duplicate refused
    with pytest.raises(OMError):
        om.kms_create_key("ghost", rotate=True)  # nothing to rotate
    with pytest.raises(OMError):
        om.create_bucket("ev", "b2", EC, encryption_key="no-such-key")


def test_encrypted_roundtrip_and_ciphertext_on_datanodes(cluster):
    b = cluster.client().get_volume("ev").get_bucket("enc")
    data = _payload(1)
    b.write_key("k1", data)
    assert np.array_equal(b.read_key("k1"), data)
    info = cluster.om.lookup_key("ev", "enc", "k1")
    enc = info["encryption"]
    assert enc["master"] == "mk1" and "edek" in enc
    assert "gdpr_secret" not in enc
    # the stored units are ctr_crypt of the source under the unwrapped DEK
    dek = bytes.fromhex(cluster.om.kms_decrypt("ev", "enc", enc))
    cipher = ctr_crypt(data, dek, bytes.fromhex(enc["iv"]))
    assert np.array_equal(j_kms.ctr_crypt(data, dek, bytes.fromhex(enc["iv"])),
                          cipher)
    probe = data[1000:1032].tobytes()
    cprobe = cipher[1000:1032].tobytes()
    seen = False
    for dn in cluster.datanodes:
        for f in dn.root.rglob("*"):
            if f.is_file() and f.stat().st_size >= len(probe):
                raw = f.read_bytes()
                assert probe not in raw, f
                seen = seen or cprobe in raw
    assert seen, "no chunk file holds the ciphertext"
    b.write_key("k2", data)
    e2 = cluster.om.lookup_key("ev", "enc", "k2")["encryption"]
    assert e2["edek"] != enc["edek"] and e2["iv"] != enc["iv"]


def test_master_key_rotation_keeps_old_keys_readable(cluster):
    om = cluster.om
    b = cluster.client().get_volume("ev").get_bucket("enc")
    data = _payload(2)
    b.write_key("pre-rotate", data)
    v0 = om.lookup_key("ev", "enc", "pre-rotate")["encryption"]["version"]
    n = om.kms_key_info("mk1")["versions"]
    om.kms_create_key("mk1", rotate=True)
    assert om.kms_key_info("mk1")["versions"] == n + 1
    b.write_key("post-rotate", _payload(3))
    v1 = om.lookup_key("ev", "enc", "post-rotate")["encryption"]["version"]
    assert v1 == v0 + 1
    assert np.array_equal(b.read_key("pre-rotate"), data)
    assert np.array_equal(b.read_key("post-rotate"), _payload(3))


def test_encrypted_multipart_upload(cluster):
    b = cluster.client().get_volume("ev").get_bucket("enc")
    p1, p2 = _payload(4, 40_000), _payload(5, 25_000)
    up = b.initiate_multipart_upload("mpk")
    up.write_part(1, p1)
    up.write_part(2, p2)
    up.complete()
    got = b.read_key("mpk")
    assert np.array_equal(got, np.concatenate([p1, p2]))
    info = cluster.om.lookup_key("ev", "enc", "mpk")
    assert len(info["enc_parts"]) == 2
    assert info["enc_parts"][0]["iv"] != info["enc_parts"][1]["iv"]
    assert [p["size"] for p in info["enc_parts"]] == [40_000, 25_000]


def test_encrypted_ranged_reads(cluster):
    b = cluster.client().get_volume("ev").get_bucket("enc")
    data = _payload(6, 50_000)
    b.write_key("rk", data)
    for off, ln in [(0, 1), (15, 33), (4096 - 1, 2), (0, 50_000),
                    (49_999, 1), (12_345, 20_000)]:
        got = b.read_key_range("rk", off, ln)
        assert np.array_equal(got, data[off:off + ln]), (off, ln)
    p1, p2 = _payload(7, 40_000), _payload(8, 25_000)
    up = b.initiate_multipart_upload("rmp")
    up.write_part(1, p1)
    up.write_part(2, p2)
    up.complete()
    full = np.concatenate([p1, p2])
    for off, ln in [(0, 5), (39_990, 20), (40_000, 100),
                    (39_999, 1), (64_999, 1), (0, 65_000)]:
        got = b.read_key_range("rmp", off, ln)
        assert np.array_equal(got, full[off:off + ln]), (off, ln)


def test_encrypted_hsync_prefix_readable(cluster):
    cluster.om.create_bucket("ev", "encr3", "RATIS/THREE",
                             encryption_key="mk1")
    br = cluster.client().get_volume("ev").get_bucket("encr3")
    data = _payload(6, 30_000)
    with br.open_key("hs") as h:
        h.write(data[:17_000])  # unaligned on purpose
        h.hsync()
        assert np.array_equal(br.read_key("hs"), data[:17_000])
        h.write(data[17_000:])
    assert np.array_equal(br.read_key("hs"), data)


def test_encrypted_key_readable_through_snapshot(cluster):
    """The snapshot keeps the key row with its encryption bundle, so a
    .snapshot read decrypts like a live one after the live key is
    overwritten."""
    b = cluster.client().get_volume("ev").get_bucket("enc")
    v1 = _payload(20, 12_000)
    b.write_key("snapk", v1)
    cluster.om.create_snapshot("ev", "enc", "s1")
    b.write_key("snapk", _payload(21, 12_000))  # overwrite live
    got = b.read_key(".snapshot/s1/snapk")
    assert np.array_equal(got, v1)


def test_gdpr_crypto_erasure(cluster):
    b = cluster.client().get_volume("ev").get_bucket("gdpr")
    data = _payload(7)
    b.write_key("subject-data", data)
    assert np.array_equal(b.read_key("subject-data"), data)
    enc = cluster.om.lookup_key("ev", "gdpr", "subject-data")["encryption"]
    assert "gdpr_secret" in enc and "edek" not in enc
    b.delete_key("subject-data")
    rows = [v for k, v in cluster.om.store.iterate("deleted_keys")
            if "subject-data" in k]
    assert rows and all(r["encryption"] == {"erased": True} for r in rows)


def test_gdpr_fso_erasure(cluster):
    cluster.om.create_bucket("ev", "gfso", EC,
                             layout="FILE_SYSTEM_OPTIMIZED", gdpr=True)
    b = cluster.client().get_volume("ev").get_bucket("gfso")
    data = _payload(8, 20_000)
    b.write_key("d/f", data)
    assert np.array_equal(b.read_key("d/f"), data)
    assert "gdpr_secret" in cluster.om.lookup_key("ev", "gfso",
                                                  "d/f")["encryption"]
    b.delete_key("d/f")
    erased = [v for _, v in cluster.om.store.iterate("deleted_keys")
              if v.get("file_name") == "f" and "encryption" in v]
    assert erased and all(r["encryption"] == {"erased": True}
                          for r in erased)


def test_gdpr_overwrite_erases_old_version(cluster):
    b = cluster.client().get_volume("ev").get_bucket("gdpr")
    b.write_key("ow", _payload(10, 8_000))
    b.write_key("ow", _payload(11, 8_000))  # overwrite
    rows = [v for k, v in cluster.om.store.iterate("deleted_keys")
            if "/ow:" in k]
    assert rows and all(r["encryption"] == {"erased": True} for r in rows)
    assert np.array_equal(b.read_key("ow"), _payload(11, 8_000))


def test_gdpr_fso_recursive_delete_erases(cluster):
    b = cluster.client().get_volume("ev").get_bucket("gfso")
    b.write_key("tree/a/f1", _payload(12, 5_000))
    b.write_key("tree/a/f2", _payload(13, 5_000))
    cluster.om.delete_directory("ev", "gfso", "tree", recursive=True)
    for _ in range(20):
        if not cluster.om.run_dir_deleting_service_once():
            break
    rows = [v for _, v in cluster.om.store.iterate("deleted_keys")
            if v.get("file_name") in ("f1", "f2")]
    assert len(rows) == 2, "files never reached the purge chain"
    assert all(r.get("encryption") == {"erased": True} for r in rows)


def test_kms_decrypt_bound_to_bucket(cluster):
    om = cluster.om
    b = cluster.client().get_volume("ev").get_bucket("enc")
    b.write_key("cd", _payload(14, 4_000))
    bundle = om.lookup_key("ev", "enc", "cd")["encryption"]
    om.create_bucket("ev", "plain", EC)
    with pytest.raises(OMError) as e:
        om.kms_decrypt("ev", "plain", bundle)
    assert e.value.code == "PERMISSION_DENIED"
    assert om.kms_decrypt("ev", "enc", bundle)


def test_port_reads_reference_encrypted_keys(tmp_path, monkeypatch):
    """State carried across: the reference writes a TDE key, a GDPR key
    and an encrypted multipart key; the port's OM opens its om.db, and
    the port's client reads each byte-exact (whole and ranged, across the
    part boundary) over port datanodes opened on the reference's
    directories. The key rows are the reference's."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    ref = JCluster(tmp_path / "ref", num_datanodes=5, block_size=8 * 4096,
                   container_size=4 * 1024 * 1024, stale_after_s=1000.0,
                   dead_after_s=2000.0)
    oz = ref.client()
    oz.create_volume("ev")
    ref.om.kms_create_key("mk1")
    ref.om.create_bucket("ev", "enc", EC, encryption_key="mk1")
    ref.om.create_bucket("ev", "gdpr", EC, gdpr=True)
    tde, gdpr = _payload(21, 70_000), _payload(22, 9_999)
    p1, p2 = _payload(23, 40_000), _payload(24, 25_000)
    oz.get_volume("ev").get_bucket("enc").write_key("t", tde)
    oz.get_volume("ev").get_bucket("gdpr").write_key("g", gdpr)
    up = oz.get_volume("ev").get_bucket("enc").initiate_multipart_upload("m")
    up.write_part(1, p1)
    up.write_part(2, p2)
    up.complete()
    want = {(b, k): ref.om.lookup_key("ev", b, k)
            for b, k in (("enc", "t"), ("gdpr", "g"), ("enc", "m"))}
    ref.close()

    om = OzoneManager(tmp_path / "ref" / "om" / "om.db",
                      scm.StorageContainerManager(placement_seed=42))
    factory = DatanodeClientFactory()
    try:
        assert {bk: om.lookup_key("ev", *bk) for bk in want} == want
        assert om.kms_list_keys() == ["mk1"]
        for d in sorted((tmp_path / "ref").glob("dn*")):
            factory.register_local(Datanode(d, dn_id=d.name))
        client = OzoneClient(om, factory, device="cpu")
        enc_b = client.get_volume("ev").get_bucket("enc")
        assert np.array_equal(enc_b.read_key("t"), tde)
        assert np.array_equal(enc_b.read_key_range("t", 12_345, 33_333),
                              tde[12_345:45_678])
        assert np.array_equal(
            client.get_volume("ev").get_bucket("gdpr").read_key("g"), gdpr)
        full = np.concatenate([p1, p2])
        assert np.array_equal(enc_b.read_key("m"), full)
        assert np.array_equal(enc_b.read_key_range("m", 39_990, 100),
                              full[39_990:40_090])
        # the DEK the port unwraps is the reference's (same EDEK row)
        dek = bytes.fromhex(om.kms_decrypt("ev", "enc",
                                           want[("enc", "t")]["encryption"]))
        assert len(dek) == 32
    finally:
        factory.close()
        om.close()


def test_encryption_bundle_rides_the_replicated_open(cluster):
    """The open's request carries the bundle (as the reference's), so a
    follower applying it stores the same row; the JSON form round-trips."""
    from ozone_tpu_torch.om.requests import OMRequest, OpenKey

    enc = cluster.om.kms.generate_edek("mk1")
    req = OpenKey("ev", "enc", "x", "cid", EC, encryption=enc)
    back = OMRequest.from_json(req.to_json())
    assert back.encryption == enc and back == req
    # each open mints its own DEK and IV
    again = cluster.om.kms.generate_edek("mk1")
    assert again["iv"] != enc["iv"] and again["edek"] != enc["edek"]
