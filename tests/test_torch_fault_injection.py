"""The port's LD_PRELOAD filesystem failure injector.

`tests/test_fault_injection.py`'s seven tests on the port's interposer
(`csrc/failure_injector.cpp`, built by `cuda_build` into `_build/`) and
controller (`testing/fault_injection.py`): operations under a target
path fail with a chosen errno, are delayed or corrupted, other paths are
untouched, a corrupted chunk write is caught by the checksum on read, the
batched EC write excludes a datanode whose pwrites fail, a recycled fd
inherits no rule, and rules change under a live process. Then the rules
file each package writes drives the other's shim (the reference's built
from its source into the test's directory, never into
`ozone_tpu/native/`). The subprocesses are light (`python -c`); only the
EC write's imports torch.
"""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ozone_tpu_torch.testing.fault_injection import FaultInjector, build_injector

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(build_injector() is None,
                                reason="no native toolchain")


def _run_py(code: str, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, **env, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=120)


def test_write_fail_with_errno(tmp_path):
    fi = FaultInjector(tmp_path)
    target = tmp_path / "data"
    target.mkdir()
    fi.fail("write", target, "ENOSPC")
    r = _run_py(
        f"f = open({str(target / 'x')!r}, 'wb')\n"
        "try:\n"
        "    f.write(b'hello'); f.flush(); print('WROTE')\n"
        "except OSError as e:\n"
        "    print('ERR', e.errno)\n",
        fi.env())
    assert "ERR 28" in r.stdout, r.stdout + r.stderr  # ENOSPC


def test_open_fail_and_untargeted_path_unaffected(tmp_path):
    fi = FaultInjector(tmp_path)
    target, other = tmp_path / "blocked", tmp_path / "free"
    target.mkdir()
    other.mkdir()
    fi.fail("open", target, "EACCES")
    r = _run_py(
        "try:\n"
        f"    open({str(target / 'x')!r}, 'wb'); print('OPENED')\n"
        "except OSError as e:\n"
        "    print('ERR', e.errno)\n"
        f"open({str(other / 'y')!r}, 'wb').write(b'ok')\n"
        "print('OTHER_OK')\n",
        fi.env())
    assert "ERR 13" in r.stdout  # EACCES
    assert "OTHER_OK" in r.stdout


def test_write_corruption_detected_by_checksum(tmp_path):
    """A corrupted chunk write is caught by the read-side checksum (the
    scanner's trigger), in the port's datanode."""
    fi = FaultInjector(tmp_path)
    dn_root = tmp_path / "dn"
    fi.corrupt_writes(dn_root)
    code = f"""
import numpy as np
from pathlib import Path
from ozone_tpu_torch.storage.datanode import Datanode
from ozone_tpu_torch.storage.ids import BlockID, ChunkInfo, StorageError
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumError, ChecksumType

dn = Datanode(Path({str(dn_root)!r}), "dn0")
dn.create_container(1, replica_index=1)
data = np.arange(4096, dtype=np.uint8) % 251
cs = Checksum(ChecksumType.CRC32C, 1024).compute(data)
info = ChunkInfo("c0", 0, data.size, cs)
dn.write_chunk(BlockID(1, 1), info, data)
try:
    dn.read_chunk(BlockID(1, 1), info, verify=True)
    print("UNDETECTED")
except ChecksumError:
    print("CORRUPTION_DETECTED")
except StorageError as e:
    print("CORRUPTION_DETECTED" if e.code == "CHECKSUM_MISMATCH"
          else f"OTHER {{e.code}}")
import sys
print("TORCH", "torch" in sys.modules)
"""
    r = _run_py(code, fi.env())
    assert "CORRUPTION_DETECTED" in r.stdout, r.stdout + r.stderr
    assert "TORCH False" in r.stdout


def test_batched_ec_write_survives_pwrite_faults(tmp_path):
    """The batched EC write under real syscall faults: a datanode whose
    chunk pwrites fail with EIO is excluded mid-write (the run rolled back,
    a fresh group) and the key lands byte-exact on the healthy members."""
    fi = FaultInjector(tmp_path)  # empty: the datanodes boot healthy
    code = f"""
import itertools
import os
import time
import numpy as np
from pathlib import Path
from ozone_tpu_torch.client.dn_client import DatanodeClientFactory
from ozone_tpu_torch.client.ec_reader import ECBlockGroupReader
from ozone_tpu_torch.client.ec_writer import BlockGroup, ECKeyWriter
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.scm.pipeline import Pipeline, ReplicationConfig
from ozone_tpu_torch.storage.datanode import Datanode

root = Path({str(tmp_path)!r})
opts = CoderOptions(3, 2, "rs", cell_size=4096)
dns = [Datanode(root / f"dn{{i}}", dn_id=f"dn{{i}}") for i in range(6)]
clients = DatanodeClientFactory()
for d in dns:
    clients.register_local(d)
cid, lid = itertools.count(1), itertools.count(1)
rules = Path({str(fi.rules_path)!r})
rules.write_text(f"write {{root / 'dn0'}} fail EIO\\n")
st = rules.stat()
os.utime(rules, (st.st_atime, int(st.st_mtime) + 2))
time.sleep(1.3)  # the shim reads its rules at most once a second

def allocate(excluded, ec=()):
    nodes = [d.id for d in dns if d.id not in excluded][:5]
    assert len(nodes) == 5, nodes
    return BlockGroup(container_id=next(cid), local_id=next(lid),
                      pipeline=Pipeline(ReplicationConfig.from_ec(opts), nodes))

w = ECKeyWriter(opts, allocate, clients, block_size=4 * 4096,
                bytes_per_checksum=1024, stripe_batch=3, device="cpu")
data = np.random.default_rng(0).integers(0, 256, 5 * 4096, dtype=np.uint8)
w.write(data)
groups = w.close()
assert "dn0" in w._excluded, w._excluded
assert all("dn0" not in g.pipeline.nodes for g in groups)
got = np.concatenate([ECBlockGroupReader(g, opts, clients, bytes_per_checksum=1024,
                                         device="cpu").read_all()
                      for g in groups])
assert np.array_equal(got, data), "data mismatch"
print("FAULT_EXCLUDED_OK")
"""
    r = _run_py(code, {**fi.env(), "OZONE_TPU_CODEC_SERVICE": "0"})
    assert "FAULT_EXCLUDED_OK" in r.stdout, r.stdout + r.stderr


def test_delay(tmp_path):
    fi = FaultInjector(tmp_path)
    target = tmp_path / "slow"
    target.mkdir()
    fi.delay("write", target, 300)
    r = _run_py(
        "import time\n"
        f"f = open({str(target / 'x')!r}, 'wb')\n"
        "t0 = time.time(); f.write(b'z'); f.flush()\n"
        "print('ELAPSED', time.time() - t0)\n",
        fi.env())
    assert float(r.stdout.split("ELAPSED")[1]) >= 0.3, r.stdout


def test_fd_reuse_does_not_leak_rules(tmp_path):
    """A recycled fd pointing at an untargeted file inherits no rule."""
    fi = FaultInjector(tmp_path)
    target, other = tmp_path / "t", tmp_path / "o"
    target.mkdir()
    other.mkdir()
    fi.fail("write", target, "EIO")
    r = _run_py(
        "import os\n"
        f"fd1 = os.open({str(target / 'x')!r}, os.O_WRONLY | os.O_CREAT)\n"
        "try:\n"
        "    os.write(fd1, b'x'); print('T_WROTE')\n"
        "except OSError as e:\n"
        "    print('T_ERR', e.errno)\n"
        "os.close(fd1)\n"
        f"fd2 = os.open({str(other / 'y')!r}, os.O_WRONLY | os.O_CREAT)\n"
        "print('SAME_FD', fd1 == fd2)\n"
        "os.write(fd2, b'y'); print('O_WROTE')\n"
        "os.close(fd2)\n",
        fi.env())
    assert "T_ERR 5" in r.stdout
    assert "SAME_FD True" in r.stdout, r.stdout
    assert "O_WROTE" in r.stdout, r.stdout


def test_live_retarget(tmp_path):
    """Rules change while the victim process runs."""
    fi = FaultInjector(tmp_path)
    target = tmp_path / "d"
    target.mkdir()
    code = f"""
import sys
p = {str(target / 'x')!r}
open(p, 'wb').write(b'first')
print('PHASE1_OK', flush=True)
sys.stdin.readline()
try:
    f = open(p, 'wb'); f.write(b'second'); print('PHASE2_WROTE')
except OSError as e:
    print('PHASE2_ERR', e.errno)
"""
    proc = subprocess.Popen([sys.executable, "-c", code],
                            env={**os.environ, **fi.env()},
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    assert "PHASE1_OK" in proc.stdout.readline()
    fi.fail("open", target, "EIO")
    time.sleep(1.2)  # the shim reads its rules at most once a second
    out, _ = proc.communicate(input="go\n", timeout=30)
    assert "PHASE2_ERR 5" in out


# --------------------------------------------------- state carried across
def _reference_shim(tmp_path) -> Path:
    """The reference's interposer built from its source into tmp_path."""
    so = tmp_path / "libref_failure_injector.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(REPO / "ozone_tpu" / "native" / "failure_injector.cpp"),
                    "-ldl"], check=True, capture_output=True, timeout=120)
    return so


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_rules_file_drives_the_other_packages_shim(tmp_path, writer):
    """Each package's controller writes the rules file the other package's
    shim obeys: the same grammar and the same whole-second mtime bump."""
    from ozone_tpu.testing.fault_injection import FaultInjector as JFaultInjector

    target = tmp_path / "t"
    target.mkdir()
    if writer == "port":
        fi, shim = FaultInjector(tmp_path), _reference_shim(tmp_path)
    else:
        fi, shim = JFaultInjector(tmp_path), build_injector()
    fi.fail("write", target, "EIO")
    fi.delay("open", tmp_path / "slow", 200)
    assert fi.rules_path.read_text() == (f"write {target} fail EIO\n"
                                         f"open {tmp_path / 'slow'} delay 200\n")
    env = {"LD_PRELOAD": str(shim), "OZONE_FI_CONFIG": str(fi.rules_path)}
    r = _run_py(
        f"f = open({str(target / 'x')!r}, 'wb')\n"
        "try:\n"
        "    f.write(b'x'); f.flush(); print('WROTE')\n"
        "except OSError as e:\n"
        "    print('ERR', e.errno)\n", env)
    assert "ERR 5" in r.stdout, r.stdout + r.stderr
    fi.clear()
    assert fi.rules_path.read_text() == ""
    time.sleep(1.2)
    r = _run_py(f"open({str(target / 'y')!r}, 'wb').write(b'y'); print('OK')", env)
    assert "OK" in r.stdout
