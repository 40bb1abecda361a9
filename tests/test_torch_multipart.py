"""The port's multipart upload, key attributes and S3 secrets against
`ozone_tpu`'s, on the CPU.

A port `MiniOzoneCluster` (device="cpu") and a JAX `MiniOzoneCluster`,
both with 5 datanodes and placement_seed=42 (as tests/test_multipart.py
sizes them), run the same script on seeded parts under rs-3-2-4096:
uploads with parts out of order, replaced parts and an overwritten key;
completes that list a subset, parts out of order, a bad ETag, a missing
part; aborts; both expiry services; and the error codes of each. The
composite ETags, key rows, key bytes, part listings and purge-chain
entries must be equal (exact), up to the ids and times that are random
by design.
"""

import hashlib

import numpy as np
import pytest
import torch

from ozone_tpu.om.requests import OMError as JOMError
from ozone_tpu.om.requests import SetS3Secret as JSetS3Secret
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.om.multipart import _final_etag
from ozone_tpu_torch.om.requests import OMError, SetS3Secret
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

EC = "rs-3-2-4096"
VOL = "mpuvol"


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """The plain versions run on one thread (the suite's workers share
    the cores) and on the direct route."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    kw = dict(num_datanodes=5, block_size=8 * 4096,
              container_size=4 * 1024 * 1024, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    root = tmp_path_factory.mktemp("torch-mpu")
    port = MiniOzoneCluster(root / "port", device="cpu", **kw)
    ref = JCluster(root / "ref", **kw)
    for c in (port, ref):
        c.client().create_volume(VOL).create_bucket("b", replication=EC)
    yield port, ref
    port.close()
    ref.close()


def both(clusters, fn):
    """fn(om, bucket handle) on each cluster: (port's, reference's)."""
    port, ref = clusters
    return tuple(fn(c.om, c.client().get_volume(VOL).get_bucket("b"))
                 for c in (port, ref))


def _data(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _code(fn):
    try:
        fn()
    except (OMError, JOMError) as e:
        return e.code
    return None


def key_row(info: dict) -> dict:
    """A key row without what is random by design: the object id, the
    times and the pipeline ids (process-wide counters)."""
    row = {k: v for k, v in info.items()
           if k not in ("object_id", "created", "modified", "block_groups",
                        "generation")}
    row["block_groups"] = [{k: v for k, v in g.items() if k != "pipeline_id"}
                           for g in info.get("block_groups", [])]
    return row


def part_rows(parts: list[dict]) -> list[dict]:
    return [key_row(p) for p in parts]


def n_deleted(om) -> int:
    return len(list(om.store.iterate("deleted_keys")))


def test_final_etag_is_the_references():
    from ozone_tpu.om.multipart import _final_etag as j_final_etag

    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 10):
        listed = [{"etag": rng.bytes(16).hex()} for _ in range(n)]
        assert _final_etag(listed) == j_final_etag(listed)
        joined = "".join(p["etag"] for p in listed)
        assert _final_etag(listed) == \
            hashlib.md5(joined.encode()).hexdigest() + f"-{n}"


@pytest.mark.parametrize("sizes", [[9000, 9100, 9200], [4096 * 3 * 4, 1],
                                   [5, 70_000]])
def test_upload_out_of_order_parts_matches(clusters, sizes):
    """Parts written in reverse order, listed, then completed: the part
    rows, the key row (with its composite ETag and metadata) and the key
    bytes equal the reference's."""
    parts = [_data(100 + i, n) for i, n in enumerate(sizes)]
    name = f"ooo-{len(sizes)}-{sizes[0]}"

    def script(om, b):
        mpu = b.initiate_multipart_upload(name, metadata={"color": "red"})
        etags = {i: mpu.write_part(i, parts[i - 1])
                 for i in reversed(range(1, len(parts) + 1))}
        listed = part_rows(mpu.list_parts())
        uploads = [(m["name"], sorted(m["parts"]))
                   for m in om.list_multipart_uploads(VOL, "b", name)]
        info = mpu.complete()
        return (etags, listed, uploads, key_row(info),
                key_row(om.lookup_key(VOL, "b", name)),
                b.read_key(name).tobytes())

    got, want = both(clusters, script)
    assert got == want
    etags, _, _, row, _, data = got
    assert data == np.concatenate(parts).tobytes()
    assert etags == {i + 1: hashlib.md5(p.tobytes()).hexdigest()
                     for i, p in enumerate(parts)}
    assert row["etag"] == _final_etag([{"etag": etags[i]}
                                       for i in sorted(etags)])
    assert row["metadata"] == {"color": "red"} and row["size"] == sum(sizes)


def test_part_replace_subset_and_overwrite_purge_equal(clusters):
    """A replaced part, a part left out of the complete and the key's
    previous version each reach the purge chain, in both packages."""
    def script(om, b):
        deltas = []
        b.write_key("over", _data(1, 5000))
        mpu = b.initiate_multipart_upload("over")
        d0 = n_deleted(om)
        mpu.write_part(1, _data(2, 8000))
        mpu.write_part(1, _data(3, 8000))      # replaces part 1
        deltas.append(n_deleted(om) - d0)
        mpu.write_part(2, _data(4, 3000))
        mpu.write_part(3, _data(5, 3000))
        d0 = n_deleted(om)
        info = mpu.complete([{"part_number": 1, "etag": mpu._etags[1]},
                             {"part_number": 3, "etag": mpu._etags[3]}])
        deltas.append(n_deleted(om) - d0)      # orphan part 2 + old key
        return deltas, key_row(info), b.read_key("over").tobytes()

    got, want = both(clusters, script)
    assert got == want
    assert got[0] == [1, 2]
    assert got[2] == (_data(3, 8000).tobytes() + _data(5, 3000).tobytes())


def test_bad_completes_and_error_codes_equal(clusters):
    """Parts out of order, a wrong ETag, a missing part, an empty list,
    an unknown upload, a missing bucket, a bad replication: the same
    codes, and the upload stays intact for a good complete after."""
    def script(om, b):
        mpu = b.initiate_multipart_upload("bad")
        e1 = mpu.write_part(1, _data(10, 3000))
        e2 = mpu.write_part(2, _data(11, 3000))
        codes = [_code(lambda parts=parts: mpu.complete(parts)) for parts in (
            [{"part_number": 2, "etag": e2}, {"part_number": 1, "etag": e1}],
            [{"part_number": 1, "etag": "0" * 32}],
            [{"part_number": 1, "etag": e1}, {"part_number": 5, "etag": e1}],
            [],
        )]
        codes += [
            _code(lambda: om.complete_multipart_upload(
                VOL, "b", "bad", "nope", [{"part_number": 1}])),
            _code(lambda: om.abort_multipart_upload(VOL, "b", "bad", "nope")),
            _code(lambda: om.list_parts(VOL, "b", "bad", "nope")),
            _code(lambda: om.initiate_multipart_upload(VOL, "nob", "k")),
            _code(lambda: om.initiate_multipart_upload(VOL, "b", "k",
                                                       "rs-9-9-x")),
            _code(lambda: om.commit_multipart_part(_Gone(mpu), 1, [], 0,
                                                   "x")),
        ]
        info = mpu.complete()
        return codes, key_row(info), b.read_key("bad").tobytes()

    got, want = both(clusters, script)
    assert got == want
    assert got[0] == ["INVALID_PART"] * 4 + [
        "NO_SUCH_MULTIPART_UPLOAD"] * 3 + [
        "BUCKET_NOT_FOUND", "INVALID_REQUEST", "NO_SUCH_MULTIPART_UPLOAD"]


class _Gone:
    """The session fields of a part commit, for an upload id that does
    not exist."""

    def __init__(self, mpu):
        self.volume, self.bucket = VOL, "b"
        self.key, self.client_id = mpu.key, "gone"


def test_abort_and_both_cleanup_services_equal(clusters):
    """Abort sends every part's blocks to the purge chain and forgets the
    upload; the multipart cleanup aborts old uploads; the open-key
    cleanup drops stale sessions: equal counts and codes."""
    def script(om, b):
        mpu = b.initiate_multipart_upload("ab")
        mpu.write_part(1, _data(20, 4000))
        mpu.write_part(2, _data(21, 4000))
        d0 = n_deleted(om)
        mpu.abort()
        out = [n_deleted(om) - d0,
               _code(lambda: om.multipart_info(VOL, "b", "ab",
                                               mpu.upload_id)),
               _code(mpu.abort)]
        old = b.initiate_multipart_upload("stale")
        old.write_part(1, _data(22, 2000))
        d0 = n_deleted(om)
        out += [om.run_mpu_cleanup_once(max_age_s=3600.0),
                om.run_mpu_cleanup_once(max_age_s=0.0),
                n_deleted(om) - d0,
                om.list_multipart_uploads(VOL, "b")]
        om.open_key(VOL, "b", "never-committed")
        out += [om.run_open_key_cleanup_once(max_age_s=3600.0),
                om.run_open_key_cleanup_once(max_age_s=0.0),
                list(om.store.iterate("open_keys"))]
        return out

    got, want = both(clusters, script)
    assert got == want
    assert got[:3] == [2, "NO_SUCH_MULTIPART_UPLOAD",
                       "NO_SUCH_MULTIPART_UPLOAD"]
    assert got[3:7] == [0, 1, 1, []] and got[7:] == [0, 1, []]


def test_key_attrs_and_s3_secrets_equal(clusters):
    """set_key_attrs merges and deletes, checks its preconditions and
    refuses a missing key with the reference's codes; S3 secrets set
    through SetS3Secret read back, if_absent keeps the first, revoke
    forgets it."""
    def script(om, b):
        b.write_key("attrs", _data(30, 100))
        rows = [om.set_key_attrs(VOL, "b", "attrs", {"tags": {"a": "1"}})]
        rows.append(om.set_key_attrs(VOL, "b", "attrs",
                                     {"owner": "u", "tags": None}))
        codes = [
            _code(lambda: om.set_key_attrs(VOL, "b", "attrs", {"x": 1},
                                           {"owner": False})),
            _code(lambda: om.set_key_attrs(VOL, "b", "attrs", {"x": 1},
                                           {"y": True})),
            _code(lambda: om.set_key_attrs(VOL, "b", "nope", {"x": 1})),
            _code(lambda: om.set_key_attrs(VOL, "nob", "attrs", {"x": 1})),
        ]
        req = (SetS3Secret if type(om).__module__.startswith("ozone_tpu_torch")
               else JSetS3Secret)
        secrets = [om.submit(req("alice", "s" * 64)),
                   om.submit(req("alice", "t" * 64, if_absent=True)),
                   om.get_s3_secret("alice", create=False)]
        om.revoke_s3_secret("alice")
        secrets.append(om.get_s3_secret("alice", create=False))
        fresh = om.get_s3_secret("bob")
        secrets += [len(fresh), om.get_s3_secret("bob") == fresh]
        return [key_row(r)["attrs"] for r in rows], codes, secrets

    got, want = both(clusters, script)
    assert got == want
    assert got[0] == [{"tags": {"a": "1"}}, {"owner": "u"}]
    assert got[1] == ["XATTR_EXISTS", "XATTR_NOT_FOUND", "KEY_NOT_FOUND",
                      "BUCKET_NOT_FOUND"]
    assert got[2] == ["s" * 64, "s" * 64, "s" * 64, None, 64, True]


def test_upgrade_status_is_the_references(clusters):
    port, ref = clusters
    assert port.om.upgrade_status() == ref.om.upgrade_status()
