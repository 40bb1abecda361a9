"""The port's FSO bucket layout against `ozone_tpu`'s, on the CPU.

Each test of `tests/test_fso.py` runs as one script on a port
`MiniOzoneCluster` (device="cpu") and on a JAX `MiniOzoneCluster`, both
with placement_seed=42 and the same seeded bytes; the listings, status
rows, error codes, deleted-key queues and file bytes must be equal, and
the reference test's own expectations must hold on the port's answers.
Rows are compared without what differs run to run by design: object and
parent ids (random per run), timestamps and pipeline ids.
"""

import types

import numpy as np
import pytest
import torch

import ozone_tpu.om.fso as j_fso
import ozone_tpu.om.requests as j_rq
import ozone_tpu_torch.om.fso as t_fso
import ozone_tpu_torch.om.requests as t_rq
from ozone_tpu.testing.minicluster import MiniOzoneCluster as JCluster
from ozone_tpu_torch.testing.minicluster import MiniOzoneCluster

EC = "rs-3-2-4096"
REF = types.SimpleNamespace(fso=j_fso, rq=j_rq, name="ref")
PORT = types.SimpleNamespace(fso=t_fso, rq=t_rq, name="port")
#: fields that differ between two runs of one script by design
VOLATILE = ("object_id", "parent_id", "created", "modified", "ts",
            "pipeline_id")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cluster(P, root):
    kw = dict(num_datanodes=5, block_size=8 * 4096,
              container_size=4 * 1024 * 1024, stale_after_s=1000.0,
              dead_after_s=2000.0, placement_seed=42)
    if P is PORT:
        return MiniOzoneCluster(root, device="cpu", **kw)
    return JCluster(root, **kw)


def both(tmp_path, monkeypatch, script):
    """Run `script(cluster, P)` on each package; equal answers, returned."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    out = {}
    for P in (REF, PORT):
        c = _cluster(P, tmp_path / P.name)
        try:
            c.client().create_volume("vol")
            c.om.create_bucket("vol", "fsb", replication=EC,
                               layout="FILE_SYSTEM_OPTIMIZED")
            out[P.name] = script(c, P)
        finally:
            c.close()
    assert out["port"] == out["ref"]
    return out["port"]


def strip(row):
    """A row (or list of rows) without the volatile fields."""
    if isinstance(row, list):
        return [strip(r) for r in row]
    if not isinstance(row, dict):
        return row
    return {k: strip(v) for k, v in row.items() if k not in VOLATILE}


def code(fn):
    """The OMError code `fn` raises, or None."""
    try:
        fn()
    except (j_rq.OMError, t_rq.OMError) as e:
        return e.code
    return None


def _bucket(c):
    return c.client().get_volume("vol").get_bucket("fsb")


def _bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_nested_write_read(tmp_path, monkeypatch):
    data = _bytes(300_000)

    def script(c, P):
        b = _bucket(c)
        b.write_key("a/b/c/file.bin", data)
        return {"bytes": b.read_key("a/b/c/file.bin").tobytes(),
                "dir": strip(c.om.get_file_status("vol", "fsb", "a/b")),
                "file": strip(c.om.get_file_status("vol", "fsb",
                                                   "a/b/c/file.bin"))}

    out = both(tmp_path, monkeypatch, script)
    assert out["bytes"] == data.tobytes()
    assert out["dir"]["type"] == "DIRECTORY"
    assert out["file"]["type"] == "FILE" and out["file"]["size"] == data.size


def test_mkdir_and_list_status(tmp_path, monkeypatch):
    def script(c, P):
        om = c.om
        om.create_directory("vol", "fsb", "x/y/z")
        _bucket(c).write_key("x/y/f1", b"11111")
        _bucket(c).write_key("x/f2", b"22222")
        return {p: [(e["type"], e["path"])
                    for e in om.list_status("vol", "fsb", p)]
                for p in ("x", "x/y", "")}

    out = both(tmp_path, monkeypatch, script)
    assert ("DIRECTORY", "x/y") in out["x"] and ("FILE", "x/f2") in out["x"]
    assert ("DIRECTORY", "x/y/z") in out["x/y"]
    assert [p for _, p in out[""]] == ["x"]


def test_list_keys_recursive(tmp_path, monkeypatch):
    def script(c, P):
        b = _bucket(c)
        for p in ("d1/k1", "d1/d2/k2", "k0"):
            b.write_key(p, b"data")
        return ([k["name"] for k in b.list_keys()],
                [k["name"] for k in b.list_keys(prefix="d1/")],
                strip(b.list_keys()))

    names, under, _ = both(tmp_path, monkeypatch, script)
    assert names == ["d1/d2/k2", "d1/k1", "k0"]
    assert under == ["d1/d2/k2", "d1/k1"]


def test_dir_rename_moves_subtree(tmp_path, monkeypatch):
    def script(c, P):
        b = _bucket(c)
        b.write_key("src/deep/file", b"payload")
        dirs_before = len(list(c.om.store.iterate("dirs")))
        c.om.rename_key("vol", "fsb", "src", "dst")
        return {"bytes": b.read_key("dst/deep/file").tobytes(),
                "old": code(lambda: c.om.get_file_status(
                    "vol", "fsb", "src/deep/file")),
                "dirs": (dirs_before, len(list(c.om.store.iterate("dirs"))))}

    out = both(tmp_path, monkeypatch, script)
    assert out["bytes"] == b"payload" and out["old"] == "KEY_NOT_FOUND"
    assert out["dirs"] == (2, 2)  # one row moved, none copied


def test_file_rename(tmp_path, monkeypatch):
    def script(c, P):
        b = _bucket(c)
        b.write_key("a/old", b"v")
        b.rename_key("a/old", "a/new")
        return (b.read_key("a/new").tobytes(),
                code(lambda: b.read_key("a/old")))

    assert both(tmp_path, monkeypatch, script) == (b"v", "KEY_NOT_FOUND")


def test_rename_into_own_subtree_rejected(tmp_path, monkeypatch):
    def script(c, P):
        c.om.create_directory("vol", "fsb", "p/q")
        return code(lambda: c.om.rename_key("vol", "fsb", "p", "p/q/p2"))

    assert both(tmp_path, monkeypatch, script) == "NOT_A_DIRECTORY"


def test_delete_nonrecursive_requires_empty(tmp_path, monkeypatch):
    def script(c, P):
        b = _bucket(c)
        b.write_key("d/f", b"x")
        first = code(lambda: c.om.delete_directory("vol", "fsb", "d"))
        b.delete_key("d/f")
        c.om.delete_directory("vol", "fsb", "d")
        return first, code(lambda: c.om.get_file_status("vol", "fsb", "d"))

    first, after = both(tmp_path, monkeypatch, script)
    assert first == t_fso.DIRECTORY_NOT_EMPTY and after == "KEY_NOT_FOUND"


def test_recursive_delete_purges_subtree(tmp_path, monkeypatch):
    def script(c, P):
        b = _bucket(c)
        for p in ("big/a/f1", "big/a/f2", "big/b/c/f3", "big/f4"):
            b.write_key(p, b"some bytes here")
        c.om.delete_directory("vol", "fsb", "big", recursive=True)
        hidden = code(lambda: c.om.get_file_status("vol", "fsb", "big/a/f1"))
        queued = len(list(c.om.store.iterate("deleted_dirs")))
        P.fso.DirectoryDeletingService(c.om).run_to_completion()
        deleted = sorted(k.rsplit(":", 1)[0].rsplit("/", 1)[1]
                         for k, _ in c.om.store.iterate("deleted_keys"))
        return {"hidden": hidden, "queued": queued,
                "left": (list(c.om.store.iterate("deleted_dirs")),
                         list(c.om.store.iterate("files", "/vol/fsb/"))),
                "deleted": deleted,
                "purged": c.om.run_key_deleting_service_once()}

    out = both(tmp_path, monkeypatch, script)
    assert out["hidden"] == "KEY_NOT_FOUND" and out["queued"] == 1
    assert out["left"] == ([], []) and out["purged"] == 4
    assert out["deleted"] == ["f1", "f2", "f3", "f4"]


def test_overwrite_and_type_conflicts(tmp_path, monkeypatch):
    def script(c, P):
        b = _bucket(c)
        b.write_key("c/f", b"one")
        b.write_key("c/f", b"two")
        return (b.read_key("c/f").tobytes(),
                code(lambda: b.write_key("c", b"clobber")),
                code(lambda: b.write_key("c/f/under", b"x")))

    got = both(tmp_path, monkeypatch, script)
    assert got == (b"two", t_fso.NOT_A_FILE, t_fso.NOT_A_DIRECTORY)


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_fso_requests_roundtrip_wire_form(P):
    """The FSO requests replicate through the ring's log like any other;
    each package reads back its own wire form, and the two forms are
    equal field for field."""
    def reqs(fso):
        return [
            fso.CreateDirectory("v", "b", "a/b", new_ids=["1", "2"],
                                created=1.0),
            fso.OpenFile("v", "b", "a/f", "cid", EC, new_dir_ids=["3"],
                         created=2.0),
            fso.CommitFile("v", "b", "3", "f", "cid", 10, [], modified=3.0),
            fso.DeleteFile("v", "b", "a/f", ts=4.0),
            fso.DeleteDirectory("v", "b", "a", recursive=True, ts=5.0),
            fso.RenameEntry("v", "b", "a", "z", ts=6.0),
            fso.PurgeDirectories(drops=["k"], file_moves=[], dir_moves=[]),
            fso.SetEntryAttrs("v", "b", "a", {"owner": "u"}),
        ]

    for r in reqs(P.fso):
        assert P.rq.OMRequest.from_json(r.to_json()) == r
    ref_wire = [r.to_json() for r in reqs(j_fso)]
    port_wire = [r.to_json() for r in reqs(t_fso)]
    # the open's encryption bundle (empty here) and explicit ACLs included
    assert port_wire == ref_wire


def test_list_names_follow_ancestor_rename(tmp_path, monkeypatch):
    def script(c, P):
        b = _bucket(c)
        b.write_key("top/mid/leaf", b"v")
        c.om.rename_key("vol", "fsb", "top", "newtop")
        return ([k["name"] for k in b.list_keys()],
                bool(b.list_keys(prefix="newtop/")),
                b.list_keys(prefix="top/"),
                c.om.get_file_status("vol", "fsb", "newtop/mid/leaf")["name"])

    assert both(tmp_path, monkeypatch, script) == (
        ["newtop/mid/leaf"], True, [], "newtop/mid/leaf")


def test_commit_into_deleted_dir_rejected(tmp_path, monkeypatch):
    """A commit racing a recursive delete fails with DIRECTORY_NOT_FOUND
    and its blocks go to the purge chain (the session's resolved tree
    position is what the commit checks)."""
    def script(c, P):
        om = c.om
        h = _bucket(c).open_key("gone/part")
        h.write(b"block data written before the delete")
        om.create_directory("vol", "fsb", "gone/sub")
        om.delete_directory("vol", "fsb", "gone", recursive=True)
        P.fso.DirectoryDeletingService(om).run_to_completion()
        return (code(h.close), list(om.store.iterate("files", "/vol/fsb/")),
                len(list(om.store.iterate("deleted_keys"))))

    got = both(tmp_path, monkeypatch, script)
    assert got == (t_fso.DIRECTORY_NOT_FOUND, [], 1)


def test_fs_ops_validate_bucket(tmp_path, monkeypatch):
    def script(c, P):
        om = c.om
        got = [code(lambda: om.list_status("vol", "nope", "")),
               code(lambda: om.get_file_status("vol", "nope", ""))]
        om.create_bucket("vol", "flat", replication=EC)
        got.append(code(lambda: om.list_status("vol", "flat", "")))
        return got

    assert both(tmp_path, monkeypatch, script) == [
        "BUCKET_NOT_FOUND", "BUCKET_NOT_FOUND", t_fso.NOT_A_DIRECTORY]


def test_overwrite_queues_old_blocks(tmp_path, monkeypatch):
    def script(c, P):
        b = _bucket(c)
        b.write_key("ow/f", b"version one")
        b.write_key("ow/f", b"version two")
        dels = [strip(v) for _, v in c.om.store.iterate("deleted_keys")]
        c.om.create_bucket("vol", "obs2", replication=EC)
        ob = c.client().get_volume("vol").get_bucket("obs2")
        ob.write_key("k", b"one")
        ob.write_key("k", b"two")
        return dels, len(list(c.om.store.iterate("deleted_keys")))

    dels, n = both(tmp_path, monkeypatch, script)
    assert len(dels) == 1 and dels[0]["block_groups"] and n == 2


def test_delete_bucket_requires_fso_empty(tmp_path, monkeypatch):
    def script(c, P):
        _bucket(c).write_key("d/f", b"x")
        got = [code(lambda: c.om.delete_bucket("vol", "fsb"))]
        c.om.delete_directory("vol", "fsb", "d", recursive=True)
        got.append(code(lambda: c.om.delete_bucket("vol", "fsb")))
        P.fso.DirectoryDeletingService(c.om).run_to_completion()
        got.append(code(lambda: c.om.delete_bucket("vol", "fsb")))
        return got

    assert both(tmp_path, monkeypatch, script) == [
        "BUCKET_NOT_EMPTY", "BUCKET_NOT_EMPTY", None]


def test_obs_bucket_unaffected(tmp_path, monkeypatch):
    def script(c, P):
        c.om.create_bucket("vol", "obs", replication=EC)
        ob = c.client().get_volume("vol").get_bucket("obs")
        ob.write_key("a/b/c", b"flat")
        return (ob.read_key("a/b/c").tobytes(),
                code(lambda: c.om.create_directory("vol", "obs", "a")))

    assert both(tmp_path, monkeypatch, script) == (b"flat",
                                                   t_fso.NOT_A_DIRECTORY)


def test_walk_files_paged_order_pruning_and_limits(tmp_path, monkeypatch):
    full_want = ["a", "d/x", "d/y/deep", "d0", "m/1", "m/2", "z"]

    def script(c, P):
        om = c.om
        b = _bucket(c)
        for p in full_want:
            b.write_key(p, np.zeros(10, np.uint8))
        full = [k["name"] for k in om.list_keys("vol", "fsb")]
        got, cursor = [], ""
        while True:
            page = om.list_keys("vol", "fsb", start_after=cursor, limit=3)
            if not page:
                break
            got += [k["name"] for k in page]
            cursor = page[-1]["name"]
        return {"full": full, "paged": got,
                "prefix": [k["name"] for k in om.list_keys(
                    "vol", "fsb", prefix="m/")],
                "mid": [k["name"] for k in om.list_keys(
                    "vol", "fsb", start_after="d/x", limit=2)]}

    out = both(tmp_path, monkeypatch, script)
    assert out["full"] == out["paged"] == full_want
    assert out["prefix"] == ["m/1", "m/2"]
    assert out["mid"] == ["d/y/deep", "d0"]


def test_list_keys_limit_zero_is_empty_on_both_layouts(tmp_path, monkeypatch):
    def script(c, P):
        c.om.create_bucket("vol", "obs", EC)
        for bk in ("obs", "fsb"):
            c.client().get_volume("vol").get_bucket(bk).write_key(
                "k", np.zeros(10, np.uint8))
        return [c.om.list_keys("vol", bk, limit=0) for bk in ("obs", "fsb")]

    assert both(tmp_path, monkeypatch, script) == [[], []]


def test_fso_set_key_attrs(tmp_path, monkeypatch):
    def script(c, P):
        om = c.om
        _bucket(c).write_key("p/q/f.txt", np.frombuffer(b"data", np.uint8))
        om.set_key_attrs("vol", "fsb", "p/q/f.txt",
                         {"owner": "alice", "permission": "640"})
        om.set_key_attrs("vol", "fsb", "p/q/f.txt", {"mtime": 1700.0})
        first = om.get_file_status("vol", "fsb", "p/q/f.txt")["attrs"]
        om.set_key_attrs("vol", "fsb", "p/q", {"permission": "700"})
        om.set_key_attrs("vol", "fsb", "p/q/f.txt", {"owner": None})
        return (first, om.get_file_status("vol", "fsb", "p/q")["attrs"],
                om.get_file_status("vol", "fsb", "p/q/f.txt")["attrs"],
                code(lambda: om.set_key_attrs("vol", "fsb", "p/nope",
                                              {"owner": "x"})))

    first, d, f, missing = both(tmp_path, monkeypatch, script)
    assert first == {"owner": "alice", "permission": "640", "mtime": 1700.0}
    assert d == {"permission": "700"} and "owner" not in f
    assert missing == "KEY_NOT_FOUND"


def test_fso_attr_preconds_atomic(tmp_path, monkeypatch):
    def script(c, P):
        om = c.om
        _bucket(c).write_key("d/f", b"x")
        return [code(lambda: om.set_key_attrs(
                    "vol", "fsb", "d/f", {"xattr:user.a": "1"},
                    preconds={"xattr:user.a": False})),
                code(lambda: om.set_key_attrs(
                    "vol", "fsb", "d/f", {"xattr:user.a": "2"},
                    preconds={"xattr:user.a": False})),
                code(lambda: om.set_key_attrs(
                    "vol", "fsb", "d/f", {"xattr:user.b": "2"},
                    preconds={"xattr:user.b": True})),
                code(lambda: om.set_key_attrs(
                    "vol", "fsb", "d/f", {"xattr:user.a": None},
                    preconds={"xattr:user.a": True}))]

    assert both(tmp_path, monkeypatch, script) == [
        None, "XATTR_EXISTS", "XATTR_NOT_FOUND", None]


def test_link_bucket_resolves_to_fso_source(tmp_path, monkeypatch):
    """A link bucket's key and directory verbs act on its source tree, and
    a link whose source is gone answers DANGLING_LINK."""
    def script(c, P):
        om = c.om
        om.create_bucket_link("vol", "fsb", "vol", "lnk")
        om.create_bucket_link("vol", "gone", "vol", "dangling")
        c.client().get_volume("vol").get_bucket("lnk").write_key(
            "d/f", b"via link")
        om.create_directory("vol", "lnk", "d/e")
        info = om.bucket_info("vol", "lnk")
        return {"src": [(e["type"], e["path"])
                        for e in om.list_status("vol", "fsb", "d")],
                "layout": info["layout"], "source": info["source"],
                "bytes": _bucket(c).read_key("d/f").tobytes(),
                "dangling": code(lambda: om.lookup_key("vol", "dangling",
                                                       "k")),
                "resolved": om.resolve_bucket("vol", "lnk")}

    out = both(tmp_path, monkeypatch, script)
    assert out["src"] == [("DIRECTORY", "d/e"), ("FILE", "d/f")]
    assert out["layout"] == "FILE_SYSTEM_OPTIMIZED"
    assert out["bytes"] == b"via link" and out["dangling"] == "DANGLING_LINK"
    assert out["resolved"] == ("vol", "fsb")
