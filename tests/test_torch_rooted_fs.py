"""The port's ofs adapter, HttpFS gateway, CSI driver and libo3fs against
`ozone_tpu`'s, on the CPU.

A port `MiniOzoneCluster` (device="cpu") and a JAX one, both seeded, each
with a `RootedOzoneFileSystem`, an `HttpFSGateway` and a `CsiServer`. The
tests of `tests/test_rooted_fs.py`, the CSI tests of
`tests/test_csi_recon.py` and those of `tests/test_libo3fs.py` run one
script against each package: file statuses (without write times),
listings, bytes, WebHDFS JSON answers and status codes, trash paths, CSI
answers and the C client's results must be equal. Where the port departs
on purpose the test pins it: the WebHDFS verbs that need snapshots
answer 501 UnsupportedOperationException (not ported; the ACL verbs,
served since the security slice, answer as the reference's), and the
ofs adapter speaks the FSO directory verbs on an FSO bucket,
where the reference's writes directory markers as files and refuses a
nested create with NOT_A_DIRECTORY. The C client is built from the
port's copy of o3fs.c with gcc into the port's build directory.
"""

import ctypes
import json
import shutil
import subprocess
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import ozone_tpu.om.requests as j_rq
import ozone_tpu_torch.om.requests as t_rq
from ozone_tpu.gateway.csi import CsiClient as JCsiClient
from ozone_tpu.gateway.csi import CsiServer as JCsiServer
from ozone_tpu.gateway.fs import RootedOzoneFileSystem as JOfs
from ozone_tpu.gateway.httpfs import HttpFSGateway as JHttpFS
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.client import libo3fs
from ozone_tpu_torch.client.libo3fs import O3FS_RDONLY, O3FS_WRONLY
from ozone_tpu_torch.gateway.csi import CsiClient, CsiServer
from ozone_tpu_torch.gateway.fs import RootedOzoneFileSystem
from ozone_tpu_torch.gateway.httpfs import HttpFSGateway
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

EC = "rs-3-2-4096"
FSO = "FILE_SYSTEM_OPTIMIZED"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    """{"ref": ns, "port": ns}: cluster, ofs and HttpFS gateway each."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    root = tmp_path_factory.mktemp("ofs")
    kw = dict(num_datanodes=5, block_size=8 * 4096,
              container_size=4 * 1024 * 1024, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    out = {}
    for name, Cl, Ofs, Gw in (("ref", JCluster, JOfs, JHttpFS),
                              ("port", MiniOzoneCluster,
                               RootedOzoneFileSystem, HttpFSGateway)):
        ckw = dict(kw, device="cpu") if name == "port" else kw
        c = Cl(root / name, **ckw)
        gw = Gw(c.client(), replication=EC)
        gw.start()
        out[name] = types.SimpleNamespace(
            name=name, cluster=c, ofs=Ofs(c.client(), replication=EC), gw=gw)
    yield out
    for s in out.values():
        s.gw.stop()
        s.cluster.close()
    mp.undo()


def st(s):
    """A FileStatus without its write time (it differs run to run)."""
    return (s.path, s.is_dir, s.length, dict(s.attrs or {}))


def code(fn):
    try:
        fn()
    except (j_rq.OMError, t_rq.OMError) as e:
        return e.code
    except (FileNotFoundError, IsADirectoryError, FileExistsError,
            OSError) as e:
        return type(e).__name__
    return None


def ofs_both(side, script):
    out = {n: script(s.ofs, s) for n, s in side.items()}
    assert out["port"] == out["ref"]
    return out["port"]


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **kw):
        return None


_OPENER = urllib.request.build_opener(_NoRedirect)
#: fields of a WebHDFS answer that carry write times
_TIMES = ("modificationTime", "accessTime")


def _norm(obj):
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_norm(v) for v in obj)
    return obj


class Http:
    """One gateway's WebHDFS client: `req` answers (status, body), the
    body parsed when it is JSON; a 307's Location is kept apart."""

    def __init__(self, gw):
        self.gw = gw

    def url(self, path, **params):
        qs = "&".join(f"{k}={v}" for k, v in params.items())
        return f"http://{self.gw.address}/webhdfs/v1{path}?{qs}"

    def req(self, method, path, body=None, **params):
        return self.raw(method, self.url(path, **params), body)

    def raw(self, method, url, data=None):
        try:
            r = _OPENER.open(urllib.request.Request(url, data=data,
                                                    method=method))
        except urllib.error.HTTPError as e:
            self.location = e.headers.get("Location")
            body = e.read()
            e.close()
            return e.code, json.loads(body) if body else None
        body = r.read()
        if r.headers.get("Content-Type") == "application/json" and body:
            return r.status, json.loads(body)
        return r.status, body

    def put(self, path, data):
        return self.req("PUT", path, data, op="CREATE", data="true")


def http_both(side, script):
    out = {n: _norm(script(Http(s.gw), s)) for n, s in side.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


# ------------------------------------------------------------------- ofs
def test_mkdirs_creates_volume_and_bucket(side):
    def script(ofs, s):
        ofs.mkdirs("/vol1/bkt1/a/b")
        return [st(ofs.get_file_status(p))[1]
                for p in ("/vol1", "/vol1/bkt1", "/vol1/bkt1/a/b")]

    assert ofs_both(side, script) == [True, True, True]


def test_root_and_volume_listing(side):
    def script(ofs, s):
        ofs.mkdirs("/vol1/bkt2")
        return ({x.path for x in ofs.list_status("/")},
                {x.path for x in ofs.list_status("/vol1")})

    names, buckets = ofs_both(side, script)
    assert "vol1" in names and {"vol1/bkt1", "vol1/bkt2"} <= buckets


def test_file_roundtrip_deep_path(side):
    data = _payload(20000, 0)

    def script(ofs, s):
        ofs.create("/vol1/bkt1/d/e/file.bin", data)
        with ofs.open("/vol1/bkt1/d/e/file.bin") as f:
            got = f.read()
        return st(ofs.get_file_status("/vol1/bkt1/d/e/file.bin")), got

    status, got = ofs_both(side, script)
    assert not status[1] and status[2] == len(data) and got == data


def test_rename_within_bucket_and_cross_bucket_rejected(side):
    def script(ofs, s):
        ofs.create("/vol1/bkt1/r/src.txt", b"move me")
        ofs.rename("/vol1/bkt1/r/src.txt", "/vol1/bkt1/r/dst.txt")
        return (ofs.exists("/vol1/bkt1/r/dst.txt"),
                ofs.exists("/vol1/bkt1/r/src.txt"),
                code(lambda: ofs.rename("/vol1/bkt1/r/dst.txt",
                                        "/vol1/bkt2/r/dst.txt")))

    assert ofs_both(side, script) == (True, False, "OSError")


def test_delete_recursive_and_bucket(side):
    def script(ofs, s):
        ofs.create("/vol1/bkt2/t/one", b"1")
        ofs.create("/vol1/bkt2/t/two", b"2")
        ofs.delete("/vol1/bkt2/t", recursive=True)
        gone = not ofs.exists("/vol1/bkt2/t/one")
        ofs.delete("/vol1/bkt2", recursive=True)
        return gone, ofs.exists("/vol1/bkt2")

    assert ofs_both(side, script) == (True, False)


def test_trash_delete_checkpoint_expunge(side):
    def script(ofs, s):
        ofs.create("/vol1/bkt1/t/doomed.txt", b"keep me a while")
        tp = ofs.trash_delete("/vol1/bkt1/t/doomed.txt", user="alice")
        with ofs.open(tp) as f:
            kept = f.read()
        gone = not ofs.exists("/vol1/bkt1/t/doomed.txt")
        cps = ofs.trash_checkpoint(user="alice")
        young = ofs.trash_expunge(older_than_s=3600)
        purged = ofs.trash_expunge(older_than_s=3600,
                                   now=time.time() + 7200)
        ofs.create("/vol1/bkt1/t2/x", b"x")
        tp2 = ofs.trash_delete("/vol1/bkt1/t2/x")
        again = ofs.trash_delete(tp2)
        return (tp, kept, gone, len(cps), "/Current" in cps[0], young,
                purged == cps, ofs.exists(cps[0]), again, ofs.exists(tp2))

    assert ofs_both(side, script) == (
        "/vol1/bkt1/.Trash/alice/Current/t/doomed.txt", b"keep me a while",
        True, 1, False, [], True, False, "", False)


def test_trash_guards_and_emptier(side):
    def script(ofs, s):
        ofs.create("/vol1/bkt1/g/one", b"1")
        guard = code(lambda: ofs.trash_delete("/vol1/bkt1/g",
                                              recursive=False))
        ofs.create("/vol1/bkt1/.Trash-backup/x", b"x")
        tp = ofs.trash_delete("/vol1/bkt1/.Trash-backup/x", user="u1")
        kept = ofs.exists(tp)
        ofs.trash_delete("/vol1/bkt1/g", user="u2", recursive=True)
        gw = type(s.gw)(s.cluster.client(), replication=EC,
                        trash_interval_s=0.0)
        gw._httpd.server_close()  # only its emptier is driven
        cps = gw.fs.trash_checkpoint()
        purged = gw.fs.trash_expunge(3600, now=time.time() + 7200)
        return (guard, kept, any("/u1/" in c for c in cps),
                any("/u2/" in c for c in cps), set(purged) >= set(cps))

    assert ofs_both(side, script) == ("OSError", True, True, True, True)


def test_list_status_page_skips_subtrees(side):
    def script(ofs, s):
        for f in ("a-file", "z-file"):
            ofs.create(f"/vol1/bkt1/pg/{f}", b"x")
        for i in range(20):
            ofs.create(f"/vol1/bkt1/pg/mid-dir/k{i:02d}", b"y")
        page, more = ofs.list_status_page("/vol1/bkt1/pg", limit=2)
        page2, more2 = ofs.list_status_page("/vol1/bkt1/pg",
                                            start_after="mid-dir", limit=5)
        return ([x.path.rpartition("/")[2] for x in page], more,
                [x.path.rpartition("/")[2] for x in page2], more2)

    assert ofs_both(side, script) == (["a-file", "mid-dir"], True,
                                      ["z-file"], False)


# -------------------------------------------------------- ofs on FSO
def _fso_tree(ofs, base):
    """Every entry under `base`, depth first, as (path, is_dir, length)."""
    out = []
    for x in ofs.list_status(base):
        out.append(st(x)[:3])
        if x.is_dir:
            out.extend(_fso_tree(ofs, "/" + x.path))
    return out


def test_ofs_on_fso_bucket_departs_from_reference(side):
    """On an FSO bucket the reference's adapter writes the parents'
    markers as zero-byte files and refuses the nested create; the port's
    speaks the directory verbs, and its tree equals the one the
    reference's OM builds from its own FSO verbs."""
    ref, port = side["ref"], side["port"]
    for s in (ref, port):
        s.cluster.om.create_volume("fv")
        s.cluster.om.create_bucket("fv", "fb", EC, FSO)
    assert code(lambda: ref.ofs.create("/fv/fb/bench/io/f0", b"x")) == \
        "NOT_A_DIRECTORY"
    data = _payload(9000, 3)
    port.ofs.create("/fv/fb/bench/io/f1", data)
    port.ofs.mkdirs("/fv/fb/bench/empty")
    # the reference tree, made by its OM's FSO verbs directly
    ref.cluster.om.delete_key("fv", "fb", "bench")  # its stray marker file
    ref.cluster.om.create_directory("fv", "fb", "bench/io")
    ref.cluster.om.create_directory("fv", "fb", "bench/empty")
    ref.cluster.client().get_volume("fv").get_bucket("fb").write_key(
        "bench/io/f1", np.frombuffer(data, np.uint8))
    want = [(e["type"], e["path"]) for e in
            ref.cluster.om.list_status("fv", "fb", "bench")]
    got = [(e["type"], e["path"]) for e in
           port.cluster.om.list_status("fv", "fb", "bench")]
    assert got == want == [("DIRECTORY", "bench/empty"),
                           ("DIRECTORY", "bench/io")]
    assert _fso_tree(port.ofs, "/fv/fb") == [
        ("fv/fb/bench", True, 0), ("fv/fb/bench/empty", True, 0),
        ("fv/fb/bench/io", True, 0), ("fv/fb/bench/io/f1", False, 9000)]
    with port.ofs.open("/fv/fb/bench/io/f1") as f:
        assert f.read() == data
    assert port.ofs.checksum("/fv/fb/bench/io/f1") == \
        ref.cluster.client().get_volume("fv").get_bucket(
            "fb").file_checksum("bench/io/f1")


def test_ofs_fso_rename_moves_one_row_and_delete_detaches(side):
    port = side["port"]
    ofs, om = port.ofs, port.cluster.om
    for i in range(6):
        ofs.create(f"/fv/fb/tree/d{i % 2}/f{i}", b"z" * i)
    rows = len(list(om.store.iterate("dirs")))
    ofs.rename("/fv/fb/tree", "/fv/fb/moved")
    assert len(list(om.store.iterate("dirs"))) == rows
    assert not ofs.exists("/fv/fb/tree/d0/f0")
    assert st(ofs.get_file_status("/fv/fb/moved/d1/f5"))[2] == 5
    page, more = ofs.list_status_page("/fv/fb/moved/d0", limit=2)
    page2, _ = ofs.list_status_page("/fv/fb/moved/d0",
                                    start_after=page[-1].path.rpartition(
                                        "/")[2], limit=2)
    assert [x.path for x in page + page2] == [
        "fv/fb/moved/d0/f0", "fv/fb/moved/d0/f2", "fv/fb/moved/d0/f4"]
    assert more
    assert code(lambda: ofs.delete("/fv/fb/moved")) == "OSError"
    ofs.delete("/fv/fb/moved", recursive=True)
    assert not ofs.exists("/fv/fb/moved")
    assert len(list(om.store.iterate("deleted_dirs"))) == 1
    purged = port.cluster.run_deletion_services()
    assert list(om.store.iterate("deleted_dirs")) == []
    # the six files, and what earlier tests deleted in this cluster
    assert purged >= 6 and list(om.store.iterate("deleted_keys")) == []
    tp = ofs.trash_delete("/fv/fb/bench/io/f1", user="carol")
    assert tp == "/fv/fb/.Trash/carol/Current/bench/io/f1"
    assert st(ofs.get_file_status(tp))[2] == 9000


# ----------------------------------------------------------------- httpfs
def test_webhdfs_mkdirs_and_status(side):
    def script(h, s):
        return (h.req("PUT", "/wv/wb/dir", op="MKDIRS"),
                h.req("GET", "/wv/wb/dir", op="GETFILESTATUS"))

    mk, status = http_both(side, script)
    assert mk == (200, {"boolean": True})
    assert status[1]["FileStatus"]["type"] == "DIRECTORY"


def test_webhdfs_create_two_step_and_open(side):
    payload = _payload(15000, 1)

    def script(h, s):
        first = h.req("PUT", "/wv/wb/f.bin", op="CREATE")
        loc = h.location
        second = h.raw("PUT", loc, payload)
        return (first[0], loc.split("/webhdfs/v1", 1)[1], second[0],
                h.req("GET", "/wv/wb/f.bin", op="OPEN"),
                h.req("GET", "/wv/wb/f.bin", op="OPEN", offset=100,
                      length=50))

    s1, loc, s2, whole, part = http_both(side, script)
    assert (s1, s2) == (307, 201)
    assert loc == "/wv/wb/f.bin?op=CREATE&data=true&overwrite=true"
    assert whole == (200, payload) and part == (200, payload[100:150])


def test_webhdfs_liststatus(side):
    def script(h, s):
        return (h.put("/wv/wb/ls/x.txt", b"hello")[0],
                h.req("GET", "/wv/wb/ls", op="LISTSTATUS"))

    created, (code_, body) = http_both(side, script)
    sts = body["FileStatuses"]["FileStatus"]
    assert created == 201 and [x["pathSuffix"] for x in sts] == ["x.txt"]
    assert sts[0]["type"] == "FILE" and sts[0]["length"] == 5


def test_webhdfs_rename_delete(side):
    def script(h, s):
        h.put("/wv/wb/mv/a.txt", b"abc")
        return (h.req("PUT", "/wv/wb/mv/a.txt", op="RENAME",
                      destination="/wv/wb/mv/b.txt"),
                h.req("DELETE", "/wv/wb/mv", op="DELETE", recursive="true"),
                h.req("GET", "/wv/wb/mv/b.txt", op="GETFILESTATUS")[0])

    ren, dele, missing = http_both(side, script)
    assert ren == dele == (200, {"boolean": True}) and missing == 404


def test_webhdfs_content_summary(side):
    def script(h, s):
        for i in range(3):
            h.put(f"/wv/wb/cs/f{i}", b"z" * 100)
        return h.req("GET", "/wv/wb/cs", op="GETCONTENTSUMMARY")

    _, body = http_both(side, script)
    assert body["ContentSummary"]["fileCount"] == 3
    assert body["ContentSummary"]["length"] == 300


def test_webhdfs_unknown_op_400(side):
    def script(h, s):
        return h.req("GET", "/wv/wb", op="BOGUS")

    status, body = http_both(side, script)
    assert status == 400 and "RemoteException" in body


def test_webhdfs_setowner_setpermission_settimes(side):
    def script(h, s):
        h.put("/wv/wb/attrs/f", b"attr-data")
        got = [h.req("PUT", "/wv/wb/attrs/f", op="SETOWNER", owner="alice",
                     group="eng")[0],
               h.req("PUT", "/wv/wb/attrs/f", op="SETPERMISSION",
                     permission="640")[0],
               h.req("PUT", "/wv/wb/attrs/f", op="SETTIMES",
                     modificationtime=1700000000000,
                     accesstime=1700000001000)[0]]
        f = h.req("GET", "/wv/wb/attrs/f", op="GETFILESTATUS")[1]
        got.append(h.req("PUT", "/wv/wb/attrs", op="SETPERMISSION",
                         permission="700")[0])
        d = h.req("GET", "/wv/wb/attrs", op="GETFILESTATUS")[1]
        ls = h.req("GET", "/wv/wb", op="LISTSTATUS")[1]
        row = next(x for x in ls["FileStatuses"]["FileStatus"]
                   if x["pathSuffix"] == "attrs")
        got.append(h.req("PUT", "/wv/wb", op="SETPERMISSION",
                         permission="750")[0])
        b = h.req("GET", "/wv/wb", op="GETFILESTATUS")[1]
        bad = h.req("PUT", "/wv/wb/attrs/f", op="SETPERMISSION",
                    permission="999")[0]
        fs_ = f["FileStatus"]
        return (got, fs_, [fs_["modificationTime"], fs_["accessTime"]],
                d["FileStatus"]["permission"], row["permission"],
                b["FileStatus"]["permission"], bad)

    got, f, times, dperm, rowperm, bperm, bad = http_both(side, script)
    assert got == [200] * 5 and times == [1700000000000, 1700000001000]
    assert (f["owner"], f["group"], f["permission"]) == ("alice", "eng",
                                                         "640")
    assert (dperm, rowperm, bperm, bad) == ("700", "700", "750", 403)


def test_webhdfs_append_two_step(side):
    def script(h, s):
        h.put("/wv/wb/app/f", b"hello ")
        first = h.req("POST", "/wv/wb/app/f", op="APPEND")[0]
        second = h.raw("POST", h.location, b"world")[0]
        return first, second, h.req("GET", "/wv/wb/app/f", op="OPEN")

    assert http_both(side, script) == (307, 200, (200, b"hello world"))


def test_webhdfs_truncate(side):
    def script(h, s):
        h.put("/wv/wb/tr/f", b"0123456789")
        return (h.req("POST", "/wv/wb/tr/f", op="TRUNCATE", newlength=4),
                h.req("GET", "/wv/wb/tr/f", op="OPEN"),
                h.req("POST", "/wv/wb/tr/f", op="TRUNCATE",
                      newlength=99)[0])

    assert http_both(side, script) == ((200, {"boolean": True}),
                                       (200, b"0123"), 403)


def test_webhdfs_getfilechecksum(side):
    payload = _payload(50_000, 7)

    def script(h, s):
        h.put("/wv/wb/ck/f", payload)
        h.put("/wv/wb/ck/g", payload)
        return (h.req("GET", "/wv/wb/ck/f", op="GETFILECHECKSUM")[1],
                h.req("GET", "/wv/wb/ck/g", op="GETFILECHECKSUM")[1])

    f, g = http_both(side, script)
    from ozone_tpu_torch.utils.checksum import crc32c

    ck = f["FileChecksum"]
    assert ck["algorithm"] == "COMPOSITE-CRC32C" and ck["length"] == 4
    assert int(ck["bytes"], 16) == int(crc32c(np.frombuffer(payload,
                                                            np.uint8)))
    assert g == f


def test_webhdfs_malformed_numeric_params_400(side):
    def script(h, s):
        h.put("/wv/wb/num/f", b"12345")
        a = h.req("POST", "/wv/wb/num/f", op="TRUNCATE", newlength="abc")
        b = h.req("PUT", "/wv/wb/num/f", op="SETTIMES",
                  modificationtime="xyz")
        return a[0], a[1]["RemoteException"]["exception"], b[0]

    assert http_both(side, script) == (400, "IllegalArgumentException", 400)


def test_webhdfs_delete_to_trash(side):
    def script(h, s):
        h.put("/wv/wb/tr2/f", b"trash-bytes")
        out = h.req("DELETE", "/wv/wb/tr2/f", op="DELETE",
                    skiptrash="false", **{"user.name": "bob"})[1]
        return out, h.req("GET", out["trashPath"], op="OPEN")

    out, got = http_both(side, script)
    assert out == {"boolean": True,
                   "trashPath": "/wv/wb/.Trash/bob/Current/tr2/f"}
    assert got == (200, b"trash-bytes")


def test_webhdfs_liststatus_batch(side):
    def script(h, s):
        h.req("PUT", "/wv/wb/batch", op="MKDIRS")
        for i in range(7):
            h.put(f"/wv/wb/batch/f{i:02d}", b"x")
        seen, start, sizes = [], "", []
        while True:
            params = {"op": "LISTSTATUS_BATCH", "batchsize": 3}
            if start:
                params["startAfter"] = start
            listing = h.req("GET", "/wv/wb/batch", **params)[1][
                "DirectoryListing"]
            page = listing["partialListing"]["FileStatuses"]["FileStatus"]
            sizes.append(len(page))
            seen += [x["pathSuffix"] for x in page]
            if listing["remainingEntries"] == 0:
                break
            start = page[-1]["pathSuffix"]
        return seen, sizes, h.req("GET", "/wv/wb/batch",
                                  op="LISTSTATUS_BATCH", batchsize=0)[0]

    seen, sizes, bad = http_both(side, script)
    assert seen == [f"f{i:02d}" for i in range(7)]
    assert max(sizes) <= 3 and bad == 400


def test_webhdfs_xattrs(side):
    def script(h, s):
        h.req("PUT", "/xv/xb", op="MKDIRS")
        h.put("/xv/xb/f", b"x")
        out = [h.req("PUT", "/xv/xb/f", op="SETXATTR",
                     **{"xattr.name": "user.color", "xattr.value": "teal",
                        "flag": "CREATE"})[0],
               h.req("PUT", "/xv/xb/f", op="SETXATTR",
                     **{"xattr.name": "user.color", "xattr.value": "x",
                        "flag": "CREATE"})[0],
               h.req("PUT", "/xv/xb/f", op="SETXATTR",
                     **{"xattr.name": "user.color", "xattr.value": "plum",
                        "flag": "REPLACE"})[0],
               h.req("PUT", "/xv/xb/f", op="SETXATTR",
                     **{"xattr.name": "user.nope", "xattr.value": "x",
                        "flag": "REPLACE"})[0],
               h.req("PUT", "/xv/xb/f", op="SETXATTR",
                     **{"xattr.name": "user.size", "xattr.value": "11"})[0]]
        names = h.req("GET", "/xv/xb/f", op="LISTXATTRS")[1]
        got = h.req("GET", "/xv/xb/f", op="GETXATTRS")[1]
        hexed = h.req("GET", "/xv/xb/f", op="GETXATTRS", encoding="hex",
                      **{"xattr.name": "user.size"})[1]
        out.append(h.req("PUT", "/xv/xb/f", op="REMOVEXATTR",
                         **{"xattr.name": "user.size"})[0])
        after = h.req("GET", "/xv/xb/f", op="LISTXATTRS")[1]
        return out, names, got, hexed, after

    out, names, got, hexed, after = http_both(side, script)
    assert out == [200, 403, 200, 403, 200, 200]
    assert json.loads(names["XAttrNames"]) == ["user.color", "user.size"]
    assert {"name": "user.color", "value": '"plum"'} in got["XAttrs"]
    assert hexed["XAttrs"] == [{"name": "user.size",
                                "value": "0x" + b"11".hex()}]
    assert json.loads(after["XAttrNames"]) == ["user.color"]


def test_webhdfs_quota_trashroot_home(side):
    def script(h, s):
        h.req("PUT", "/sv/sb", op="MKDIRS")
        h.put("/sv/sb/a", b"one")
        h.put("/sv/sb/b", b"two")
        return (h.req("GET", "/sv/sb", op="GETQUOTAUSAGE")[1],
                h.req("GET", "/sv/sb/a", op="GETTRASHROOT",
                      **{"user.name": "alice"})[1],
                h.req("GET", "/", op="GETHOMEDIRECTORY",
                      **{"user.name": "bob"})[1])

    q, t, hm = http_both(side, script)
    assert q["QuotaUsage"]["spaceConsumed"] == 6
    assert q["QuotaUsage"]["fileAndDirectoryCount"] == 2
    assert t["Path"] == "/sv/sb/.Trash/alice" and hm["Path"] == "/user/bob"


def test_webhdfs_blocklocations(side):
    def script(h, s):
        h.req("PUT", "/bv/bb", op="MKDIRS")
        h.put("/bv/bb/f", b"z" * 20_000)
        return (h.req("GET", "/bv/bb/f", op="GETFILEBLOCKLOCATIONS")[1],
                h.req("GET", "/bv/bb/f", op="GETFILEBLOCKLOCATIONS",
                      offset=1, length=2)[1],
                h.req("GET", "/bv/bb/f", op="GETFILEBLOCKLOCATIONS",
                      offset=20_000, length=5)[1],
                h.req("GET", "/bv/bb/nope", op="GETFILEBLOCKLOCATIONS")[0])

    full, window, past, missing = http_both(side, script)
    locs = full["BlockLocations"]["BlockLocation"]
    assert locs[0]["offset"] == 0 and len(locs[0]["hosts"]) == 5
    assert sum(x["length"] for x in locs) == 20_000
    assert len(window["BlockLocations"]["BlockLocation"]) == 1
    assert past["BlockLocations"]["BlockLocation"] == [] and missing == 404


@pytest.mark.parametrize("method,op,params", [
    ("GET", "GETACLSTATUS", {}),
    ("GET", "CHECKACCESS", {"fsaction": "rw-"}),
    ("PUT", "CREATESNAPSHOT", {"snapshotname": "base"}),
    ("PUT", "RENAMESNAPSHOT", {"oldsnapshotname": "a", "snapshotname": "b"}),
    ("DELETE", "DELETESNAPSHOT", {"snapshotname": "base"}),
    ("GET", "GETSNAPSHOTDIFF", {"oldsnapshotname": "a",
                                "snapshotname": ""}),
])
def test_webhdfs_acl_and_snapshot_verbs_answer_501(side, method, op, params):
    """The ACL and snapshot verbs answer as the reference's gateway does,
    status and body: GETACLSTATUS and CHECKACCESS since the security
    slice, and the snapshot verbs (501 before snapshots were ported) since
    the snapshot slice: CREATESNAPSHOT answers 200 with the snapshot's
    path, and a verb naming a snapshot that does not exist is refused
    (the gateways are shared by the module, so "base" may exist by then).
    None changes the live listing."""
    h = Http(side["port"].gw)
    h.req("PUT", "/av/ab", op="MKDIRS")
    h.put("/av/ab/f", b"x")
    before = h.req("GET", "/av/ab", op="LISTSTATUS")
    status, body = h.req(method, "/av/ab/f", op=op, **params)
    ref = Http(side["ref"].gw)
    ref.req("PUT", "/av/ab", op="MKDIRS")
    ref.put("/av/ab/f", b"x")
    assert (status, body) == ref.req(method, "/av/ab/f", op=op, **params)
    if op in ("GETACLSTATUS", "CHECKACCESS", "CREATESNAPSHOT"):
        assert status == 200
    elif status != 200:
        assert status == 403
        assert "SNAPSHOT_NOT_FOUND" in body["RemoteException"]["message"]
    if op == "CREATESNAPSHOT":
        assert body == {"Path": "/av/ab/.snapshot/base"}
    assert _norm(h.req("GET", "/av/ab", op="LISTSTATUS")) == _norm(before)


def test_webhdfs_on_fso_bucket(side):
    """The gateway over an FSO bucket: two-step CREATE into new
    directories, ranged OPEN, LISTSTATUS, RENAME of a directory (one
    row), checksum and DELETE, through the port's FSO-aware adapter."""
    port = side["port"]
    port.cluster.om.create_volume("hv")
    port.cluster.om.create_bucket("hv", "hb", EC, FSO)
    h = Http(port.gw)
    data = _payload(30_000, 9)
    assert h.req("PUT", "/hv/hb/io/d/f", op="CREATE")[0] == 307
    assert h.raw("PUT", h.location, data)[0] == 201
    assert h.req("GET", "/hv/hb/io/d/f", op="OPEN", offset=7,
                 length=9000) == (200, data[7:9007])
    ls = h.req("GET", "/hv/hb/io", op="LISTSTATUS")[1]
    assert [(x["pathSuffix"], x["type"]) for x in
            ls["FileStatuses"]["FileStatus"]] == [("d", "DIRECTORY")]
    assert h.req("PUT", "/hv/hb/io", op="RENAME",
                 destination="/hv/hb/io2")[1] == {"boolean": True}
    ck = h.req("GET", "/hv/hb/io2/d/f", op="GETFILECHECKSUM")[1]
    from ozone_tpu_torch.utils.checksum import crc32c

    assert int(ck["FileChecksum"]["bytes"], 16) == int(
        crc32c(np.frombuffer(data, np.uint8)))
    assert h.req("DELETE", "/hv/hb/io2", op="DELETE")[0] == 403
    assert h.req("DELETE", "/hv/hb/io2", op="DELETE",
                 recursive="true")[1] == {"boolean": True}
    assert h.req("GET", "/hv/hb/io2/d/f", op="GETFILESTATUS")[0] == 404


# -------------------------------------------------------------------- CSI
@pytest.fixture(scope="module")
def csi(side):
    out = {}
    for name, Srv, Cli in (("ref", JCsiServer, JCsiClient),
                           ("port", CsiServer, CsiClient)):
        srv = Srv(side[name].cluster.client(), s3_endpoint="127.0.0.1:9878",
                  replication=EC)
        srv.start()
        out[name] = (srv, Cli(srv.address))
    yield {n: c for n, (_, c) in out.items()}
    for srv, cli in out.values():
        cli.close()
        srv.stop()


def csi_both(csi, script):
    out = {n: script(c) for n, c in csi.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_csi_identity(csi):
    info, probe = csi_both(csi, lambda c: (c.plugin_info(), c.probe()))
    assert info["name"].startswith("org.apache.hadoop.ozone")
    assert probe["ready"] is True


def test_csi_create_list_delete_volume(csi):
    def script(c):
        v = c.create_volume("pvc-1234", capacity_bytes=1 << 30)
        c.create_volume("pvc-1234")  # idempotent
        listed = "pvc-1234" in [e["volume_id"] for e in c.list_volumes()]
        valid = c.validate("pvc-1234")
        c.delete_volume("pvc-1234")
        after = "pvc-1234" in [e["volume_id"] for e in c.list_volumes()]
        c.delete_volume("pvc-1234")  # idempotent
        return v, listed, valid, after

    v, listed, valid, after = csi_both(csi, script)
    assert v["volume"]["volume_id"] == "pvc-1234" and listed
    assert valid["confirmed"] is True and not after


def test_csi_publish_unpublish(csi, tmp_path):
    def script(c):
        c.create_volume("pvc-mount")
        target = tmp_path / c.__class__.__module__ / "mnt" / "vol"
        c.publish("pvc-mount", str(target))
        desc = json.loads((target / ".ozone-csi.json").read_text())
        c.unpublish("pvc-mount", str(target))
        return desc, target.exists(), bool(c.node_info()["node_id"])

    desc, exists, node = csi_both(csi, script)
    assert desc["bucket"] == "pvc-mount"
    assert desc["s3_endpoint"] == "127.0.0.1:9878"
    assert not exists and node


# ---------------------------------------------------------------- libo3fs
@pytest.fixture(scope="module")
def lib():
    if shutil.which("gcc") is None:
        pytest.skip("no gcc: libo3fs is a C library")
    from ozone_tpu_torch import cuda_build

    src, so = cuda_build._target("o3fs")
    assert src.relative_to(cuda_build.PKG).as_posix() == \
        "csrc/libo3fs/o3fs.c" and so.parent == cuda_build.BUILD
    return libo3fs.library()


def _c_roundtrip(lib, port):
    """The C client's script; every call's result, in order."""
    out = []
    fs = lib.o3fsConnect(b"127.0.0.1", port)
    out.append(bool(fs))
    out.append(lib.o3fsCreateDirectory(fs, b"/cv/cb/dir"))
    isdir = ctypes.c_int(0)
    out.append((lib.o3fsGetPathInfo(fs, b"/cv/cb/dir", ctypes.byref(isdir)),
                isdir.value))
    payload = _payload(200_000, 7)
    f = lib.o3fsOpenFile(fs, b"/cv/cb/dir/blob.bin", O3FS_WRONLY, 0, 0, 0)
    out.append(lib.o3fsWrite(fs, f, payload[:70_000], 70_000))
    out.append(lib.o3fsWrite(fs, f, payload[70_000:], len(payload) - 70_000))
    out.append(lib.o3fsCloseFile(fs, f))
    out.append(lib.o3fsGetPathInfo(fs, b"/cv/cb/dir/blob.bin", None))
    f = lib.o3fsOpenFile(fs, b"/cv/cb/dir/blob.bin", O3FS_RDONLY, 0, 0, 0)
    buf = ctypes.create_string_buffer(len(payload) + 10)
    got = b""
    while True:
        n = lib.o3fsRead(fs, f, buf, 65536)
        if n <= 0:
            break
        got += buf.raw[:n]
    out.append(got == payload)
    out.append(lib.o3fsSeek(fs, f, 100))
    n = lib.o3fsRead(fs, f, buf, 16)
    out.append(buf.raw[:n] == payload[100:116])
    out.append(lib.o3fsCloseFile(fs, f))
    out.append(lib.o3fsRename(fs, b"/cv/cb/dir/blob.bin",
                              b"/cv/cb/dir/blob2.bin"))
    out.append([lib.o3fsExists(fs, p) for p in (b"/cv/cb/dir/blob2.bin",
                                                b"/cv/cb/dir/blob.bin")])
    out.append(lib.o3fsDelete(fs, b"/cv/cb/dir/blob2.bin", 0))
    out.append(lib.o3fsExists(fs, b"/cv/cb/dir/blob2.bin"))
    out.append(bool(lib.o3fsOpenFile(fs, b"/cv/cb/nope.bin", O3FS_RDONLY,
                                     0, 0, 0)))
    lib.o3fsDisconnect(fs)
    return out


def test_c_client_roundtrip(side, lib):
    got = {n: _c_roundtrip(lib, s.gw.port) for n, s in side.items()}
    assert got["port"] == got["ref"]
    assert got["port"] == [True, 0, (0, 1), 70_000, 130_000, 0, 200_000,
                           True, 0, True, 0, 0, [0, -1], 0, -1, False]


def test_c_client_on_fso_bucket(side, lib):
    """libo3fs over the port's gateway into an FSO bucket: a directory,
    a whole-file write and read, a rename and a delete."""
    port = side["port"]
    port.cluster.om.create_volume("cf")
    port.cluster.om.create_bucket("cf", "fb", EC, FSO)
    fs = lib.o3fsConnect(b"127.0.0.1", port.gw.port)
    assert lib.o3fsCreateDirectory(fs, b"/cf/fb/a/b") == 0
    payload = _payload(50_000, 11)
    f = lib.o3fsOpenFile(fs, b"/cf/fb/a/b/x", O3FS_WRONLY, 0, 0, 0)
    assert lib.o3fsWrite(fs, f, payload, len(payload)) == len(payload)
    assert lib.o3fsCloseFile(fs, f) == 0
    assert port.cluster.om.get_file_status("cf", "fb", "a/b/x")["size"] == \
        len(payload)
    f = lib.o3fsOpenFile(fs, b"/cf/fb/a/b/x", O3FS_RDONLY, 0, 0, 0)
    buf = ctypes.create_string_buffer(len(payload))
    assert lib.o3fsRead(fs, f, buf, len(payload)) == len(payload)
    assert buf.raw == payload
    assert lib.o3fsCloseFile(fs, f) == 0
    assert lib.o3fsRename(fs, b"/cf/fb/a", b"/cf/fb/z") == 0
    assert lib.o3fsExists(fs, b"/cf/fb/z/b/x") == 0
    assert lib.o3fsDelete(fs, b"/cf/fb/z", 1) == 0
    assert lib.o3fsExists(fs, b"/cf/fb/z") == -1
    lib.o3fsDisconnect(fs)


def test_example_binaries(side, lib, tmp_path):
    """The reference's two example programs, built against the port's
    o3fs.c, write and read a file through each gateway alike."""
    exdir = REPO / "ozone_tpu" / "native" / "libo3fs" / "examples"
    src = REPO / "ozone_tpu_torch" / "csrc" / "libo3fs"
    wbin, rbin = tmp_path / "o3fs_write", tmp_path / "o3fs_read"
    for ex, out in (("libo3fs_write.c", wbin), ("libo3fs_read.c", rbin)):
        subprocess.run(["gcc", "-O2", "-I", str(src), "-o", str(out),
                        str(exdir / ex), str(src / "o3fs.c")],
                       check=True, capture_output=True, timeout=120)
    local = tmp_path / "in.bin"
    data = _payload(123_457, 8)
    local.write_bytes(data)
    for s in side.values():
        r = subprocess.run([str(wbin), "127.0.0.1", str(s.gw.port),
                            "/cv/cb/fromc.bin", str(local)],
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        assert "wrote 123457 bytes" in r.stdout
        r = subprocess.run([str(rbin), "127.0.0.1", str(s.gw.port),
                            "/cv/cb/fromc.bin"], capture_output=True,
                           timeout=60)
        assert r.returncode == 0 and r.stdout == data
