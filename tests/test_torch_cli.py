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
replica and `admin ring-transfer` to a follower. The filesystem verbs:
`sh bucket create --layout FILE_SYSTEM_OPTIMIZED`, `sh bucket link`,
`fs mkdir|ls|stat|rm|recover-lease`, `sh key rename|checksum|cat|cp|
rewrite`, `admin om list-open-files`, `freon fskg|fsg`, and an `httpfs`
and a `csi` process; `sh key checksum` and the `fs` verbs import no
torch. Encryption: `admin kms create-key|rotate-key|list|info`, `sh
bucket create --encryption-key|--gdpr` and a byte-exact `sh key put/get`
of a TDE key on the plaintext cluster; then `cluster --secure` as a
process (mutual TLS with block tokens, a client certificate enrolled for
the user), driven with OZONE_TPU_CERT_DIR: the same TDE round trip,
`admin cert list|revoke`, and a command without the certificate refused.
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


# ------------------------------------------------------------ filesystem
def test_fs_and_sh_filesystem_verbs(live_cluster, sh, tmp_path):
    om, _ = live_cluster
    assert sh("sh", "volume", "create", "/fsv", "--om", om)[0] == 0
    assert sh("sh", "bucket", "create", "/fsv/fb", "--om", om,
              "--replication", "rs-3-2-4096", "--layout",
              "FILE_SYSTEM_OPTIMIZED")[0] == 0
    rc, out, _ = sh("sh", "bucket", "info", "/fsv/fb", "--om", om)
    assert json.loads(out)["layout"] == "FILE_SYSTEM_OPTIMIZED"
    assert sh("fs", "mkdir", "/fsv/fb/a/b", "--om", om)[0] == 0
    payload = np.random.default_rng(3).integers(0, 256, 30_000,
                                                dtype=np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(payload)
    _run("sh", "key", "put", "/fsv/fb/a/b/f", str(src), "--om", om,
         "--device", "cpu")
    rc, out, _ = sh("fs", "ls", "/fsv/fb/a", "--om", om)
    assert [(e["type"], e["path"]) for e in json.loads(out)] == [
        ("DIRECTORY", "a/b")]
    rc, out, _ = sh("fs", "stat", "/fsv/fb/a/b/f", "--om", om)
    assert json.loads(out)["type"] == "FILE" and \
        json.loads(out)["size"] == 30_000
    rc, out, _ = sh("sh", "key", "checksum", "/fsv/fb/a/b/f", "--om", om)
    from ozone_tpu_torch.utils.checksum import crc32c

    ck = json.loads(out)
    assert ck["algorithm"] == "COMPOSITE-CRC32C" and ck["length"] == 30_000
    assert int(ck["checksum"], 16) == int(crc32c(np.frombuffer(payload,
                                                               np.uint8)))
    # a 100-byte file reaches data unit 0 only: units 1 and 2 answer
    # NO_SUCH_BLOCK over the RPC, and the composition skips them
    tiny = tmp_path / "tiny.bin"
    tiny.write_bytes(payload[:100])
    assert sh("sh", "key", "put", "/fsv/fb/a/tiny", str(tiny), "--om", om,
              "--device", "cpu")[0] == 0
    rc, out, _ = sh("sh", "key", "checksum", "/fsv/fb/a/tiny", "--om", om)
    assert int(json.loads(out)["checksum"], 16) == int(
        crc32c(np.frombuffer(payload[:100], np.uint8)))
    assert sh("sh", "key", "rename", "/fsv/fb/a", "--to", "z", "--om",
              om)[0] == 0
    got = subprocess.run(
        [sys.executable, "-m", "ozone_tpu_torch.tools", "sh", "key", "cat",
         "/fsv/fb/z/b/f", "--om", om, "--device", "cpu"],
        capture_output=True, timeout=WAIT_S, check=True, cwd=str(REPO),
        env=ENV).stdout
    assert got == payload
    sh("sh", "bucket", "create", "/fsv/obs", "--om", om, "--replication",
       "rs-3-2-4096")
    rc, _, err = sh("sh", "key", "cp", "/fsv/fb/z/b/f", "--om", om,
                    "--device", "cpu")
    assert rc == 2 and "cp needs --to" in err
    rc, _, _ = sh("sh", "key", "cp", "/fsv/fb/z/b/f", "--to",
                  "/fsv/obs/copy", "--om", om, "--device", "cpu")
    assert rc == 0
    rc, _, _ = sh("sh", "key", "rewrite", "/fsv/obs/copy", "--replication",
                  "RATIS/THREE", "--om", om, "--device", "cpu")
    assert rc == 0
    rc, out, _ = sh("sh", "key", "info", "/fsv/obs/copy", "--om", om)
    assert json.loads(out)["replication"] == "RATIS/THREE"
    rc, out, _ = sh("sh", "key", "checksum", "/fsv/obs/copy", "--om", om)
    assert json.loads(out) == ck  # the distcp property, across layouts
    assert sh("sh", "bucket", "link", "/fsv/fb", "--to", "/fsv/lnk", "--om",
              om)[0] == 0
    rc, out, _ = sh("fs", "ls", "/fsv/lnk/z/b", "--om", om)
    assert [e["path"] for e in json.loads(out)] == ["z/b/f"]
    rc, out, _ = sh("admin", "om", "list-open-files", "/fsv/fb", "--om", om)
    assert rc == 0 and json.loads(out) == {
        "open_files": [], "truncated": False, "continuation": ""}
    rc, _, err = sh("fs", "recover-lease", "/fsv/fb/z/nope", "--om", om)
    assert rc == 1 and err.startswith("error KEY_NOT_FOUND:")
    rc, _, err = sh("fs", "rm", "/fsv/fb/z", "--om", om)
    assert rc == 1 and err.startswith("error DIRECTORY_NOT_EMPTY:")
    assert sh("fs", "rm", "/fsv/fb/z", "-r", "--om", om)[0] == 0
    rc, _, err = sh("fs", "stat", "/fsv/fb/z/b/f", "--om", om)
    assert rc == 1 and err.startswith("error KEY_NOT_FOUND:")
    rc, out, _ = sh("freon", "fskg", "-n", "6", "-s", "3901", "-t", "2",
                    "--depth", "3", "--om", om, "--replication",
                    "rs-3-2-4096", "--device", "cpu")
    assert rc == 0 and json.loads(out)["ops"] == 6
    rc, out, _ = sh("freon", "fsg", "-n", "4", "-s", "3901", "-t", "2",
                    "--om", om, "--replication", "rs-3-2-4096", "--device",
                    "cpu")
    rep = json.loads(out)
    assert rc == 0 and rep["ops"] == 4 and rep["failures"] == 0


def test_fs_and_checksum_verbs_import_no_torch(live_cluster):
    """`fs ls` and `sh key checksum` run through the CLI's entry point in
    a fresh process without importing torch."""
    om, _ = live_cluster
    code = f"""
import sys
from ozone_tpu_torch.tools import cli
cli.main(["sh", "volume", "create", "/lightv", "--om", "{om}"])
cli.main(["sh", "bucket", "create", "/lightv/b", "--om", "{om}",
          "--replication", "RATIS/THREE", "--layout",
          "FILE_SYSTEM_OPTIMIZED"])
cli.main(["fs", "mkdir", "/lightv/b/d", "--om", "{om}"])
cli.main(["fs", "ls", "/lightv/b", "--om", "{om}"])
print("torch" in sys.modules, file=sys.stderr)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=WAIT_S, cwd=str(REPO), env=ENV)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip().splitlines()[-1] == "False"
    assert json.loads(proc.stdout[proc.stdout.index("["):])[0]["path"] == "d"



def test_admin_scm_verbs_as_processes(live_cluster):
    """The SCM's read-only admin verbs, each a process of its own: five
    IN_SERVICE nodes, the balancer idle, the replication census, the
    pipelines; a balancer flag without `start` is a usage error."""
    om, _ = live_cluster
    nodes = json.loads(_run("admin", "datanode", "list", "--om", om).stdout)
    assert sorted((n["dn_id"], n["op_state"]) for n in nodes) == \
        [(f"dn{i}", "IN_SERVICE") for i in range(5)]
    st = json.loads(_run("admin", "balancer", "status", "--om", om).stdout)
    assert st["running"] is False and st["threshold"] == 0.1
    census = json.loads(_run("admin", "replicationmanager", "--om",
                             om).stdout)
    assert set(census) == {"healthy", "under_replicated", "over_replicated",
                           "missing"} and census["missing"] == 0
    pipes = json.loads(_run("admin", "pipeline", "list", "--om", om).stdout)
    assert all(set(p["nodes"]) <= {f"dn{i}" for i in range(5)}
               for p in pipes["pipelines"])
    bad = _run("admin", "balancer", "stop", "--threshold", "0.2", "--om", om,
               check=False)
    assert bad.returncode == 2 and "require the 'start' verb" in bad.stderr

def _serve_until(argv, log, marker):
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ozone_tpu_torch.tools", *argv],
            stdout=f, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            cwd=str(REPO), env=ENV)
    t_end = time.monotonic() + WAIT_S
    while marker not in log.read_text():
        assert proc.poll() is None and time.monotonic() < t_end, \
            log.read_text()
        time.sleep(0.2)
    return proc


def test_httpfs_and_csi_processes(live_cluster, tmp_path):
    """`httpfs --device cpu` serves a two-step CREATE and an OPEN and
    prints its kernel launches on SIGTERM; `csi` provisions a volume as
    a bucket of s3v; `httpfs` without --device cpu names CUDA."""
    import urllib.request

    from ozone_tpu_torch.gateway.csi import CsiClient

    om, _ = live_cluster
    proc = _run("httpfs", "--om", om, "--port", str(_free_port()),
                check=False)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    hport, cport = _free_port(), _free_port()
    hf = _serve_until(["httpfs", "--om", om, "--port", str(hport),
                       "--replication", "rs-3-2-4096", "--device", "cpu"],
                      tmp_path / "httpfs.log", "httpfs gateway serving")
    csi = _serve_until(["csi", "--om", om, "--port", str(cport),
                        "--replication", "rs-3-2-4096"],
                       tmp_path / "csi.log", "csi driver serving")
    try:
        base = f"http://127.0.0.1:{hport}/webhdfs/v1/hv/hb/dir/f"
        body = b"webhdfs over the daemon cluster" * 100
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{hport}/webhdfs/v1/hv/hb?op=MKDIRS",
            method="PUT"), timeout=WAIT_S).read()
        with urllib.request.urlopen(urllib.request.Request(
                base + "?op=CREATE&data=true", data=body, method="PUT"),
                timeout=WAIT_S) as r:
            assert r.status == 201
        with urllib.request.urlopen(base + "?op=OPEN&offset=3&length=40",
                                    timeout=WAIT_S) as r:
            assert r.read() == body[3:43]
        cli_ = CsiClient(f"127.0.0.1:{cport}")
        try:
            assert cli_.probe()["ready"] is True
            cli_.create_volume("pvc-cli")
            assert "pvc-cli" in [e["volume_id"] for e in cli_.list_volumes()]
            cli_.delete_volume("pvc-cli")
        finally:
            cli_.close()
    finally:
        for p in (hf, csi):
            p.send_signal(signal.SIGTERM)
            p.wait(timeout=WAIT_S)
    last = (tmp_path / "httpfs.log").read_text().strip().splitlines()[-1]
    assert re.match(r"httpfs gateway stopped; kernel launches \d+$", last), \
        last


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


def test_kms_verbs_and_encrypted_buckets(live_cluster, sh, tmp_path):
    """The KMS verbs, TDE and GDPR buckets from the shell, and a TDE and
    a GDPR key put and got byte-exact; the stored row holds a wrapped
    key, never the DEK."""
    om, _ = live_cluster
    rc, out, err = sh("admin", "kms", "create-key", "clikey", "--om", om)
    assert rc == 0 and json.loads(out) == {"name": "clikey", "versions": 1}, err
    rc, out, _ = sh("admin", "kms", "rotate-key", "clikey", "--om", om)
    assert rc == 0 and json.loads(out)["versions"] == 2
    rc, out, _ = sh("admin", "kms", "list", "--om", om)
    assert "clikey" in json.loads(out)
    rc, out, _ = sh("admin", "kms", "info", "clikey", "--om", om)
    assert json.loads(out)["versions"] == 2
    rc, _, err = sh("admin", "kms", "create-key", "clikey", "--om", om)
    assert rc == 1 and err.startswith("error INVALID_REQUEST:")
    rc, _, err = sh("admin", "kms", "info", "--om", om)
    assert rc == 2
    sh("sh", "volume", "create", "/venc", "--om", om)
    assert sh("sh", "bucket", "create", "/venc/tde", "--om", om,
              "--replication", "rs-3-2-4096", "--encryption-key",
              "clikey")[0] == 0
    assert sh("sh", "bucket", "create", "/venc/g", "--om", om,
              "--replication", "rs-3-2-4096", "--gdpr")[0] == 0
    rc, _, err = sh("sh", "bucket", "create", "/venc/bad", "--om", om,
                    "--encryption-key", "no-such-key")
    assert rc == 1 and err.startswith("error INVALID_REQUEST:")
    rc, out, _ = sh("sh", "bucket", "info", "/venc/tde", "--om", om)
    assert json.loads(out)["encryption_key"] == "clikey"
    rc, out, _ = sh("sh", "bucket", "info", "/venc/g", "--om", om)
    assert json.loads(out)["gdpr"] is True
    payload = np.random.default_rng(5).integers(0, 256, 70_001,
                                                dtype=np.uint8).tobytes()
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(payload)
    for bucket in ("tde", "g"):
        assert sh("sh", "key", "put", f"/venc/{bucket}/k", str(src), "--om",
                  om, "--device", "cpu")[0] == 0
        assert sh("sh", "key", "get", f"/venc/{bucket}/k", str(dst), "--om",
                  om, "--device", "cpu")[0] == 0
        assert dst.read_bytes() == payload
    rc, out, _ = sh("sh", "key", "info", "/venc/tde/k", "--om", om)
    enc = json.loads(out)["encryption"]
    assert enc["master"] == "clikey" and enc["version"] == 1
    assert "edek" in enc and "gdpr_secret" not in enc
    # the CA's verbs answer only where a CA lives
    rc, _, err = sh("admin", "cert", "list", "--om", om)
    assert rc == 1 and err.startswith("error UNSUPPORTED_REQUEST:")


def test_cluster_secure(tmp_path, sh, monkeypatch):
    """`cluster --secure` as a process: the scm-om hosts the CA, every
    datanode enrolls and serves mutual TLS with no native sidecar, and a
    client certificate waits under <root>/client-certs. With
    OZONE_TPU_CERT_DIR the shell's verbs run over mutual TLS (a TDE key
    byte-exact), `admin cert list|revoke` act on the CA, and a command
    without the certificate is refused at the handshake."""
    port = _free_port()
    while True:  # the enrollment endpoint takes the next port
        probe = socket.socket()
        try:
            probe.bind(("127.0.0.1", port + 1))
            break
        except OSError:
            port = _free_port()
        finally:
            probe.close()
    om = f"127.0.0.1:{port}"
    log = tmp_path / "cluster.log"
    proc = _serve_until(["cluster", "--secure", "--datanodes", "5",
                         "--port", str(port), "--root", str(tmp_path / "c"),
                         "--enrollment-secret", "cli-secret",
                         "--device", "cpu"], log, "cluster up")
    try:
        line = log.read_text()
        cert_dir = re.search(r"cert_dir=(\S+)", line).group(1)
        assert "enroll=127.0.0.1:%d" % (port + 1) in line
        rc, _, err = sh("admin", "status", "--om", om)
        assert rc == 1 and err.startswith("error UNAVAILABLE:")
        monkeypatch.setenv("OZONE_TPU_CERT_DIR", cert_dir)
        monkeypatch.setattr(cli, "_TLS", [])
        rc, out, _ = sh("admin", "status", "--om", om)
        assert rc == 0 and len(json.loads(out)["nodes"]) == 5
        assert sh("admin", "kms", "create-key", "mk", "--om", om)[0] == 0
        sh("sh", "volume", "create", "/sv", "--om", om)
        assert sh("sh", "bucket", "create", "/sv/tde", "--om", om,
                  "--replication", "rs-3-2-4096", "--encryption-key",
                  "mk")[0] == 0
        payload = np.random.default_rng(6).integers(
            0, 256, 50_000, dtype=np.uint8).tobytes()
        src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
        src.write_bytes(payload)
        assert sh("sh", "key", "put", "/sv/tde/k", str(src), "--om", om,
                  "--device", "cpu")[0] == 0
        assert sh("sh", "key", "get", "/sv/tde/k", str(dst), "--om", om,
                  "--device", "cpu")[0] == 0
        assert dst.read_bytes() == payload
        rc, out, _ = sh("admin", "cert", "list", "--om", om)
        issued = json.loads(out)["result"]
        assert rc == 0 and len(issued) == 7  # scm-om, 5 datanodes, client
        assert {r["subject"].split("CN=")[1].split(",")[0] for r in issued} \
            >= {"scm-om", "datanode-dn0", "client-cli"}
        # a second enrolled certificate, revoked: its next call refused
        from ozone_tpu_torch.utils.ca import CertificateClient

        other = CertificateClient(tmp_path / "other", "client-cli")
        other.enroll_remote("127.0.0.1:%d" % (port + 1), secret="cli-secret")
        serial = str(other.cert.serial_number)
        rc, out, _ = sh("admin", "cert", "revoke", serial, "--om", om)
        assert rc == 0 and int(serial) in json.loads(out)["result"]["crl"]
        monkeypatch.setenv("OZONE_TPU_CERT_DIR", str(tmp_path / "other"))
        monkeypatch.setattr(cli, "_TLS", [])
        rc, _, err = sh("admin", "status", "--om", om)
        assert rc == 1 and err.startswith("error CERTIFICATE_REVOKED:")
        logs = "".join((tmp_path / "c" / f"dn{i}.log").read_text()
                       for i in range(5))
        assert logs.count("native datapath=off") == 5
        assert logs.count("mutual TLS") == 5
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
