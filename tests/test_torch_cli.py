"""The port's CLI driving a cluster of daemon processes, on the CPU.

One module-scoped cluster of subprocesses (`python -m
ozone_tpu_torch.tools scm-om` and five `datanode --device cpu`), driven
through the CLI's entry point, mirroring tests/test_acceptance.py: the
namespace verbs, `sh key put/get` in processes of their own with a byte
compare, `freon ockg`, `admin status`, and a `datanode` started without
`--device cpu` on a rig without CUDA, which exits non-zero naming CUDA.
The scm-om runs with `--device cpu` too: its lifecycle sweep encodes.
Then the lifecycle verbs (`set`, `get`, `clear`, `run-now`, `status`,
`compact-slabs`) with `freon lcg`, and `sh bucket set-smallobj` with
inline and needle keys through `sh key put/get` and `freon tinyg` with
and without the packer. Apart from that cluster, three `scm-om --ha-id
--peer` processes form a metadata ring: `admin ring-status` from every
replica and `admin ring-transfer` to a follower.
"""

import json
import re
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ozone_tpu_torch.net.scm_service import RemoteScmClient
from ozone_tpu_torch.storage.ids import StorageError
from ozone_tpu_torch.tools import cli

REPO = Path(__file__).resolve().parent.parent
#: every wait in this file is bounded by this many seconds
WAIT_S = 60.0
ENV = dict(os.environ, PYTHONPATH=str(REPO), OZONE_TPU_CODEC_SERVICE="0")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(*argv, check=True) -> subprocess.CompletedProcess:
    """The CLI in a process of its own."""
    return subprocess.run(
        [sys.executable, "-m", "ozone_tpu_torch.tools", *argv],
        capture_output=True, text=True, timeout=WAIT_S, check=check,
        cwd=str(REPO), env=ENV)


@pytest.fixture(scope="module")
def live_cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-cli")
    om = f"127.0.0.1:{_free_port()}"
    procs = []

    def spawn(name, *argv):
        with open(tmp / f"{name}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ozone_tpu_torch.tools", *argv],
                stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                cwd=str(REPO), env=ENV))

    scm = RemoteScmClient(om)
    try:
        spawn("scm-om", "scm-om", "--db", str(tmp / "om.db"),
              "--port", om.rpartition(":")[2], "--device", "cpu")
        for i in range(5):
            spawn(f"dn{i}", "datanode", "--root", str(tmp / f"dn{i}"),
                  "--scm", om, "--id", f"dn{i}", "--heartbeat-interval",
                  "0.5", "--device", "cpu")
        t_end = time.monotonic() + WAIT_S
        while True:
            try:
                if len(scm.status()["nodes"]) == 5:
                    break
            except StorageError:
                pass  # not up yet
            if time.monotonic() > t_end:
                logs = {p.name: p.read_text()[-2000:]
                        for p in tmp.glob("*.log")}
                pytest.fail(f"the cluster did not come up: {logs}")
            time.sleep(0.25)
        yield om, tmp
    finally:
        scm.close()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


@pytest.fixture
def sh(capsys, monkeypatch):
    """The CLI's entry point in this process: (exit code, stdout, stderr)."""
    monkeypatch.setenv("OZONE_TPU_CODEC_SERVICE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(*argv):
        rc = cli.main(list(argv))
        out = capsys.readouterr()
        return rc, out.out, out.err

    yield run
    torch.set_num_threads(n)


def test_namespace_verbs(live_cluster, sh):
    om, _ = live_cluster
    assert sh("sh", "volume", "create", "/vol1", "--om", om)[0] == 0
    assert sh("sh", "bucket", "create", "/vol1/b1", "--om", om,
              "--replication", "rs-3-2-4096")[0] == 0
    rc, out, _ = sh("sh", "bucket", "list", "/vol1", "--om", om)
    assert rc == 0 and [b["name"] for b in json.loads(out)] == ["b1"]
    rc, out, _ = sh("sh", "bucket", "info", "/vol1/b1", "--om", om)
    assert json.loads(out)["replication"] == "rs-3-2-4096"
    rc, out, _ = sh("sh", "volume", "list", "/", "--om", om)
    assert "vol1" in [v["name"] for v in json.loads(out)]
    rc, _, err = sh("sh", "volume", "create", "/vol1", "--om", om)
    assert rc == 1 and err.startswith("error VOLUME_ALREADY_EXISTS:")
    rc, _, err = sh("sh", "bucket", "info", "/vol1/nope", "--om", om)
    assert rc == 1 and err.startswith("error BUCKET_NOT_FOUND:")
    assert sh("sh", "bucket", "delete", "/vol1/b1", "--om", om)[0] == 0
    assert sh("sh", "volume", "delete", "/vol1", "--om", om)[0] == 0


def test_key_put_get_roundtrip(live_cluster, sh):
    om, tmp = live_cluster
    sh("sh", "volume", "create", "/vol2", "--om", om)
    sh("sh", "bucket", "create", "/vol2/ec", "--om", om, "--replication",
       "rs-3-2-4096")
    payload = np.random.default_rng(0).integers(0, 256, 100_000,
                                                dtype=np.uint8).tobytes()
    src, dst = tmp / "in.bin", tmp / "out.bin"
    src.write_bytes(payload)
    _run("sh", "key", "put", "/vol2/ec/dir/key1", str(src), "--om", om,
         "--device", "cpu")
    _run("sh", "key", "get", "/vol2/ec/dir/key1", str(dst), "--om", om,
         "--device", "cpu")
    assert dst.read_bytes() == payload
    rc, out, _ = sh("sh", "key", "info", "/vol2/ec/dir/key1", "--om", om)
    assert rc == 0 and json.loads(out)["size"] == 100_000
    rc, out, _ = sh("sh", "key", "list", "/vol2/ec", "--om", om)
    assert [k["name"] for k in json.loads(out)] == ["dir/key1"]
    rc, _, err = sh("sh", "key", "get", "/vol2/ec/nope", str(dst), "--om",
                    om, "--device", "cpu")
    assert rc == 1 and err.startswith("error KEY_NOT_FOUND:")


def test_freon_ockg_and_admin(live_cluster, sh):
    om, _ = live_cluster
    rc, out, _ = sh("freon", "ockg", "-n", "10", "-s", "4096", "-t", "2",
                    "--om", om, "--replication", "rs-3-2-4096",
                    "--device", "cpu")
    rep = json.loads(out)
    assert rc == 0 and rep["ops"] == 10 and rep["failures"] == 0
    rc, out, _ = sh("admin", "status", "--om", om)
    st = json.loads(out)
    assert [n["state"] for n in st["nodes"]] == ["HEALTHY"] * 5
    assert st["safemode"] is False
    rc, out, _ = sh("admin", "container", "list", "--om", om)
    cid = json.loads(out)[0]["id"]
    rc, out, _ = sh("admin", "container", "info", str(cid), "--om", om)
    assert rc == 0 and json.loads(out)["id"] == cid
    rc, _, err = sh("admin", "container", "info", "999999", "--om", om)
    assert rc == 1 and err.startswith("error CONTAINER_NOT_FOUND:")


def test_datanode_without_cpu_flag_names_cuda(live_cluster, tmp_path):
    """On a rig without CUDA the default device is an error, before the
    datanode binds or registers."""
    om, _ = live_cluster
    assert not torch.cuda.is_available()
    proc = _run("datanode", "--root", str(tmp_path / "dnx"), "--scm", om,
                check=False)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    scm = RemoteScmClient(om)
    try:
        assert "dnx" not in [n["dn_id"] for n in scm.status()["nodes"]]
    finally:
        scm.close()


# ---------------------------------------------------------------------- s3
def test_s3_getsecret_and_revokesecret(live_cluster, sh):
    """`s3 getsecret` creates an access id's secret once and returns the
    same one after; `revokesecret` forgets it, and the next getsecret
    makes a new one."""
    om, _ = live_cluster
    rc, out, _ = sh("s3", "getsecret", "alice", "--om", om)
    first = json.loads(out)
    assert rc == 0 and first["access_id"] == "alice"
    assert len(first["secret"]) == 64
    assert json.loads(sh("s3", "getsecret", "alice", "--om", om)[1]) == first
    rc, out, _ = sh("s3", "revokesecret", "alice", "--om", om)
    assert rc == 0 and json.loads(out) == {"access_id": "alice",
                                           "revoked": True}
    again = json.loads(sh("s3", "getsecret", "alice", "--om", om)[1])
    assert again["secret"] != first["secret"]


def test_s3g_without_cpu_flag_names_cuda(live_cluster):
    om, _ = live_cluster
    proc = _run("s3g", "--om", om, "--port", str(_free_port()), check=False)
    assert proc.returncode != 0 and "CUDA" in proc.stderr


def test_s3g_process_signed_put_get_multipart_and_freon(live_cluster, sh,
                                                        tmp_path):
    """`s3g --require-auth --device cpu` against the cluster: a signed PUT
    and GET byte-exact (its ETag the body's MD5), an unsigned PUT
    refused, a 3-part multipart upload with the composite ETag, `freon
    s3kg` signed with a secret from `s3 getsecret`, `freon mpug`; on
    SIGTERM the gateway prints its launch and dispatch counts."""
    import hashlib
    import urllib.error
    import urllib.request

    from ozone_tpu_torch.gateway.s3_auth import sign_request

    om, _ = live_cluster
    port = _free_port()
    log = tmp_path / "s3g.log"
    with open(log, "w") as f:
        gw = subprocess.Popen(
            [sys.executable, "-m", "ozone_tpu_torch.tools", "s3g", "--om",
             om, "--port", str(port), "--replication", "rs-3-2-4096",
             "--require-auth", "--device", "cpu"],
            stdout=f, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            cwd=str(REPO), env=ENV)
    try:
        t_end = time.monotonic() + WAIT_S
        while "s3 gateway serving" not in log.read_text():
            assert gw.poll() is None and time.monotonic() < t_end, \
                log.read_text()
            time.sleep(0.2)
        secret = json.loads(sh("s3", "getsecret", "s3user", "--om",
                               om)[1])["secret"]
        endpoint = f"127.0.0.1:{port}"

        def req(method, path, data=b"", sign=True):
            url = f"http://{endpoint}{path}"
            headers = {"host": endpoint, "x-amz-date": time.strftime(
                "%Y%m%dT%H%M%SZ", time.gmtime())}
            if sign:
                headers = sign_request("s3user", secret, method, url,
                                       headers, data)
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        url, data=data or None, method=method,
                        headers=headers), timeout=WAIT_S) as r:
                    return r.status, r.headers, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.headers, e.read()

        body = np.random.default_rng(5).integers(
            0, 256, 3 * 4096 * 5 + 12345, dtype=np.uint8).tobytes()
        assert req("PUT", "/s3b")[0] == 200
        st, headers, _ = req("PUT", "/s3b/obj", body)
        assert st == 200 and headers["ETag"] == \
            f'"{hashlib.md5(body).hexdigest()}"'
        assert req("GET", "/s3b/obj")[2] == body
        st, _, err = req("PUT", "/s3b/anon", b"x", sign=False)
        assert st == 403 and b"AccessDenied" in err
        uid = re.search(rb"<UploadId>([^<]+)<",
                        req("POST", "/s3b/mp?uploads")[2]).group(1).decode()
        parts = [body[:20000], body[20000:40000], body[40000:]]
        md5s = []
        for n, p in enumerate(parts, 1):
            st, headers, _ = req("PUT", f"/s3b/mp?partNumber={n}"
                                        f"&uploadId={uid}", p)
            md5s.append(headers["ETag"].strip('"'))
        st, _, done = req("POST", f"/s3b/mp?uploadId={uid}")
        composite = hashlib.md5("".join(md5s).encode()).hexdigest() + "-3"
        assert st == 200 and composite.encode() in done
        assert req("GET", "/s3b/mp")[2] == body
        rc, out, _ = sh("freon", "s3kg", "-n", "4", "-s", "5000", "-t", "2",
                        "--endpoint", endpoint, "--access-id", "s3user",
                        "--validate", "--om", om)
        rep = json.loads(out)
        assert rc == 0 and rep["ops"] == 4 and rep["failures"] == 0
        rc, out, _ = sh("freon", "mpug", "-n", "2", "-s", "5000", "-t", "2",
                        "--om", om, "--replication", "rs-3-2-4096",
                        "--device", "cpu")
        rep = json.loads(out)
        assert rc == 0 and rep["ops"] == 2 and rep["failures"] == 0
    finally:
        gw.send_signal(signal.SIGTERM)
        gw.wait(timeout=WAIT_S)
    last = log.read_text().strip().splitlines()[-1]
    assert re.match(r"s3 gateway stopped; kernel launches \d+, service "
                    r"dispatches \d+$", last), last


# ------------------------------------------------- lifecycle and tiny keys
def test_lifecycle_verbs_and_freon_lcg(live_cluster, sh, tmp_path):
    om, _ = live_cluster
    sh("sh", "volume", "create", "/lcv", "--om", om)
    sh("sh", "bucket", "create", "/lcv/b", "--om", om, "--replication",
       "RATIS/THREE")
    rc, out, _ = sh("lifecycle", "set", "/lcv/b", "--prefix", "cold-",
                    "--target", "rs-3-2-4096", "--om", om)
    assert rc == 0 and json.loads(out)[0]["action"] == "TRANSITION_TO_EC"
    rc, out, _ = sh("lifecycle", "set", "/lcv/b", "--action", "expire",
                    "--prefix", "ttl-", "--append", "--om", om)
    assert [r["id"] for r in json.loads(out)] == ["rule-0", "rule-1"]
    rc, out, _ = sh("lifecycle", "get", "/lcv/b", "--om", om)
    assert [r["action"] for r in json.loads(out)] == [
        "TRANSITION_TO_EC", "EXPIRE"]
    assert sh("lifecycle", "set", "/lcv/b", "--action", "shred",
              "--om", om)[0] == 2
    assert sh("lifecycle", "get", "--om", om)[0] == 2
    rc, _, err = sh("lifecycle", "set", "/lcv/b", "--target", "RATIS/ONE",
                    "--om", om)
    assert rc == 1 and err.startswith("error INVALID_REQUEST:")
    payload = np.random.default_rng(1).integers(0, 256, 40_000,
                                                dtype=np.uint8)
    src, dst = tmp_path / "cold.bin", tmp_path / "back.bin"
    src.write_bytes(payload.tobytes())
    for key in ("cold-1", "ttl-1", "hot-1"):
        assert sh("sh", "key", "put", f"/lcv/b/{key}", str(src), "--om", om,
                  "--device", "cpu")[0] == 0
    rc, out, _ = sh("lifecycle", "run-now", "--om", om)
    stats = json.loads(out)
    assert rc == 0 and stats["expired"] == 1 and stats["complete"]
    assert stats["transitioned"] + stats["failed"] == 1
    if stats["failed"]:
        # its group's container closed under the write (the rs-3-2 pool
        # this module's tests share fills up): the key stays replicated
        # and the next sweep tiers it
        assert json.loads(sh("lifecycle", "run-now", "--om", om)[1])[
            "transitioned"] == 1
    assert sh("sh", "key", "get", "/lcv/b/cold-1", str(dst), "--om", om,
              "--device", "cpu")[0] == 0
    assert dst.read_bytes() == payload.tobytes()
    rc, out, _ = sh("sh", "key", "info", "/lcv/b/cold-1", "--om", om)
    assert json.loads(out)["replication"] == "rs-3-2-4096"
    rc, out, _ = sh("sh", "key", "info", "/lcv/b/hot-1", "--om", om)
    assert json.loads(out)["replication"] == "RATIS/THREE"
    rc, _, err = sh("sh", "key", "info", "/lcv/b/ttl-1", "--om", om)
    assert rc == 1 and err.startswith("error KEY_NOT_FOUND:")
    rc, out, _ = sh("lifecycle", "status", "--om", om)
    st = json.loads(out)
    assert st["term"] == 0 and st["in_progress"] is False
    assert st["stats"]["transitioned"] >= 1
    rc, out, _ = sh("lifecycle", "clear", "/lcv/b", "--om", om)
    assert rc == 0 and json.loads(sh("lifecycle", "get", "/lcv/b", "--om",
                                     om)[1]) == []
    rc, out, _ = sh("freon", "lcg", "-n", "4", "-s", "20000", "-t", "2",
                    "--target", "rs-3-2-4096", "--om", om, "--device", "cpu")
    rep = json.loads(out)
    assert rc == 0 and rep["ops"] == 4 and rep["failures"] == 0
    assert rep["verify_failures"] == 0 and rep["sweep_dispatches"] >= 1
    assert rep["transitioned"] == rep["ec_keys"] >= 1
    if rep["ec_keys"] < 4:  # as above: a closed container, the next sweep
        assert json.loads(sh("lifecycle", "run-now", "--om", om)[1])[
            "transitioned"] == 4 - rep["ec_keys"]
    for i in range(4):
        rc, out, _ = sh("sh", "key", "info", f"/freon-vol/freon-tier/tier-{i}",
                        "--om", om)
        assert json.loads(out)["replication"] == "rs-3-2-4096"


def test_set_smallobj_and_freon_tinyg(live_cluster, sh, tmp_path):
    om, _ = live_cluster
    sh("sh", "volume", "create", "/tv", "--om", om)
    sh("sh", "bucket", "create", "/tv/b", "--om", om, "--replication",
       "rs-3-2-4096")
    rc, out, _ = sh("sh", "bucket", "set-smallobj", "/tv/b", "--om", om)
    assert rc == 0 and json.loads(out)["smallobj"] == {"inline_max": 0,
                                                       "needle_max": 0}
    rng = np.random.default_rng(2)
    for key, size, kind in (("tiny", 2_000, "inline"),
                            ("small", 20_000, "needle")):
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        src, dst = tmp_path / f"{key}.in", tmp_path / f"{key}.out"
        src.write_bytes(payload)
        assert sh("sh", "key", "put", f"/tv/b/{key}", str(src), "--om", om,
                  "--device", "cpu")[0] == 0
        assert sh("sh", "key", "get", f"/tv/b/{key}", str(dst), "--om", om,
                  "--device", "cpu")[0] == 0
        assert dst.read_bytes() == payload
        info = json.loads(sh("sh", "key", "info", f"/tv/b/{key}", "--om",
                             om)[1])
        assert (info.get("inline") is not None) == (kind == "inline")
        assert bool(info.get("needle")) == (kind == "needle")
    rc, _, err = sh("sh", "bucket", "set-smallobj", "/tv/nob", "--om", om)
    assert rc == 1 and err.startswith("error BUCKET_NOT_FOUND:")
    rc, out, _ = sh("freon", "tinyg", "-n", "40", "-t", "4", "--tiny",
                    "--validate", "--om", om, "--device", "cpu")
    rep = json.loads(out)
    assert rc == 0 and rep["failures"] == 0 and rep["verify_failures"] == 0
    assert (rep["inline_keys"], rep["needle_keys"]) == (38, 2)
    rc, out, _ = sh("freon", "tinyg", "-n", "10", "-t", "2", "--no-packer",
                    "--validate", "--om", om, "--device", "cpu")
    rep = json.loads(out)
    assert rep["regular_keys"] == 10 and rep["verify_failures"] == 0
    rc, out, _ = sh("lifecycle", "compact-slabs", "--om", om)
    assert rc == 0 and json.loads(out)["slabs_scanned"] >= 1


def test_scm_om_ring_status_and_transfer(tmp_path, sh):
    """Three scm-om processes on one metadata ring: every replica answers
    ring-status with one leader, ring-transfer hands leadership to a
    follower, and a write through the address list lands on it."""
    peers = {f"m{i}": f"127.0.0.1:{_free_port()}" for i in range(3)}
    flags = [a for m, addr in peers.items() for a in ("--peer", f"{m}={addr}")]
    everyone = ",".join(peers.values())
    procs = []
    try:
        for m, addr in peers.items():
            with open(tmp_path / f"{m}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ozone_tpu_torch.tools", "scm-om",
                     "--db", str(tmp_path / m / "om.db"),
                     "--port", addr.rpartition(":")[2], "--ha-id", m,
                     *flags], stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL, cwd=str(REPO), env=ENV))

        def status(addr):
            rc, out, _ = sh("admin", "ring-status", "--om", addr)
            return json.loads(out) if rc == 0 else None

        t_end = time.monotonic() + WAIT_S
        views = {}
        while time.monotonic() < t_end:
            views = {m: status(a) for m, a in peers.items()}
            if all(v and v["leader"] for v in views.values()) and \
                    len({v["leader"] for v in views.values()}) == 1:
                break
            time.sleep(0.25)
        leaders = {v["leader"] for v in views.values() if v}
        assert len(leaders) == 1 and None not in leaders, views
        leader = leaders.pop()
        for m, v in views.items():
            assert v["replica_id"] == m
            assert v["members"] == sorted(peers)
            assert v["role"] == ("LEADER" if m == leader else "FOLLOWER")
        target = next(m for m in peers if m != leader)
        rc, out, err = sh("admin", "ring-transfer", target, "--om", everyone)
        assert rc == 0, err
        assert json.loads(out)["transferred"] is True
        t_end = time.monotonic() + WAIT_S
        while time.monotonic() < t_end:
            if (status(peers[target]) or {}).get("role") == "LEADER":
                break
            time.sleep(0.2)
        assert status(peers[target])["role"] == "LEADER"
        assert sh("sh", "volume", "create", "/vring", "--om", everyone)[0] == 0
        rc, out, _ = sh("sh", "volume", "info", "/vring", "--om", everyone)
        assert rc == 0 and "vring" in out
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
