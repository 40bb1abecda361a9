"""The port's CLI driving a cluster of daemon processes, on the CPU.

One module-scoped cluster of subprocesses (`python -m
ozone_tpu_torch.tools scm-om` and five `datanode --device cpu`), driven
through the CLI's entry point, mirroring tests/test_acceptance.py: the
namespace verbs, `sh key put/get` in processes of their own with a byte
compare, `freon ockg`, `admin status`, and a `datanode` started without
`--device cpu` on a rig without CUDA, which exits non-zero naming CUDA.
"""

import json
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
              "--port", om.rpartition(":")[2])
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
