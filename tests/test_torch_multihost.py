"""The port's multi-process mesh on the CPU: two OS processes under gloo.

Mirror of tests/test_multihost.py. Each process joins one
`torch.distributed` group through `multihost.initialize(...,
local_device_count=4, device="cpu")`, and the two form one global mesh
of eight CPU slots. There:

- the DP encoder runs with no collective, each process on the rows of
  its own four slots, checked against the numpy coder;
- the TP encoder gathers the eight packed partials across the process
  boundary (`all_gather_into_tensor`), and the ring decoder passes its
  accumulators across it (`batch_isend_irecv`) and gathers the CRC rows;
  both processes' outputs must equal the reference's on its
  single-process mesh of eight virtual devices, bit for bit;
- the hybrid (dcn, dn) mesh is 2 x 4, and a sum over both its axes
  (each process's four slots, then an all_reduce) is 12.

The reference's test may skip where its jaxlib cannot run multi-process
CPU computations; gloo runs them here, so this one never skips.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from ozone_tpu.codec import create_encoder
from ozone_tpu.codec.api import CoderOptions
from ozone_tpu.codec.fused import FusedSpec
from ozone_tpu.parallel import sharded as j_sharded
from ozone_tpu.utils.checksum import ChecksumType

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 120

_WORKER = r"""
import sys
port, pid, repo, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from ozone_tpu_torch.codec import fused_kernel
from ozone_tpu_torch.codec import create_encoder
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import FusedSpec
from ozone_tpu_torch.parallel import multihost, sharded
from ozone_tpu_torch.utils.checksum import ChecksumType

multihost.initialize(f"127.0.0.1:{port}", 2, pid, local_device_count=4,
                     device="cpu")
assert multihost.process_count() == 2
assert multihost.is_coordinator() == (pid == 0)
mesh = multihost.global_codec_mesh()
assert mesh.devices.size == 8 and mesh.spans_processes
assert [s.index for s in mesh.local_slots] == list(range(4 * pid, 4 * pid + 4))

passes = [0]
real = fused_kernel.fused_encode_crc
def spy(*a, **kw):
    passes[0] += 1
    return real(*a, **kw)
fused_kernel.fused_encode_crc = spy

# DP: no collective; this process encodes the rows of its own slots
opts = CoderOptions(3, 2, "rs", cell_size=1024)
spec = FusedSpec(opts, ChecksumType.CRC32C, 1024)
rng = np.random.default_rng(0)  # same seed in both processes: one view
batch = rng.integers(0, 256, (8, 3, 1024), dtype=np.uint8)
local = batch[pid * 4:(pid + 1) * 4]
parity, crcs = sharded.make_sharded_fused_encoder(spec, mesh)(local)
ref = create_encoder(opts, "numpy").encode(batch)
assert np.array_equal(parity.numpy(), ref[pid * 4:(pid + 1) * 4]), pid
assert tuple(crcs.shape) == (4, 5, 1) and passes[0] == 4

# TP across the process boundary: RS(8,3), one data unit per slot
passes[0] = 0
tp_opts = CoderOptions(8, 3, "rs", cell_size=512)
tp_data = np.random.default_rng(2).integers(0, 256, (4, 8, 512), dtype=np.uint8)
tp = sharded.make_tp_encoder(tp_opts, mesh)(tp_data).numpy()
tp_passes = passes[0]

# the ring across it: RS(6,3) and RS(10,4) (survivors padded 10 -> 16)
ring = {}
for name, (k, p, erased, valid) in {
        "rs63": (6, 3, [1, 4], [0, 2, 3, 5, 6, 7]),
        "rs104": (10, 4, [0, 12], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10])}.items():
    ro = CoderOptions(k, p, "rs", cell_size=1024)
    data = np.random.default_rng(7).integers(0, 256, (8, k, 1024), dtype=np.uint8)
    allu = np.concatenate([data, create_encoder(ro, "numpy").encode(data)], 1)
    passes[0] = 0
    rec, rcrcs = sharded.make_ring_decoder(
        FusedSpec(ro, ChecksumType.CRC32C, 256), valid, erased, mesh)(allu[:, valid])
    ring[name] = (rec.numpy(), rcrcs.numpy().view(np.uint32), passes[0])
    assert np.array_equal(ring[name][0], allu[:, erased]), name

# the hybrid mesh: processes outer, slots inner; a sum over both axes
h = multihost.hybrid_codec_mesh()
assert h.devices.shape == (2, 4) and h.axis_names == ("dcn", "dn")
mine = torch.tensor([float(pid + 1) * len(h.local_slots)])
dist.all_reduce(mine)
np.savez(out, tp=tp, tp_passes=tp_passes, summed=mine.numpy(),
         **{f"{n}_{i}": v for n, r in ring.items() for i, v in enumerate(r)})
dist.barrier()
dist.destroy_process_group()
print(f"WORKER_OK {pid}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _reference_ring(k, p, erased, valid):
    opts = CoderOptions(k, p, "rs", cell_size=1024)
    data = np.random.default_rng(7).integers(0, 256, (8, k, 1024), dtype=np.uint8)
    allu = np.concatenate([data, create_encoder(opts, "numpy").encode(data)], 1)
    fn = j_sharded.make_ring_decoder(FusedSpec(opts, ChecksumType.CRC32C, 256),
                                     valid, erased, j_sharded.make_mesh(8))
    return jax.device_get(fn(allu[:, valid]))


def test_two_process_global_mesh(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(port), str(i), str(REPO),
             str(tmp_path / f"out{i}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO))
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, out

    tp_opts = CoderOptions(8, 3, "rs", cell_size=512)
    tp_data = np.random.default_rng(2).integers(0, 256, (4, 8, 512), dtype=np.uint8)
    tp_ref = np.asarray(j_sharded.make_tp_encoder(tp_opts, j_sharded.make_mesh(8))(tp_data))
    rings = {"rs63": _reference_ring(6, 3, [1, 4], [0, 2, 3, 5, 6, 7]),
             "rs104": _reference_ring(10, 4, [0, 12], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10])}
    for i in range(2):
        got = np.load(tmp_path / f"out{i}.npz")
        assert np.array_equal(got["tp"], tp_ref), f"process {i}: TP parity"
        # four local partials and the combine, in each process
        assert int(got["tp_passes"]) == 4 + 1
        for name, (jrec, jcrcs) in rings.items():
            assert np.array_equal(got[f"{name}_0"], jrec), f"process {i}: {name}"
            assert np.array_equal(got[f"{name}_1"], jcrcs), f"process {i}: {name} CRCs"
            # four partials, 4 x 7 combines, four CRC launches per process
            assert int(got[f"{name}_2"]) == 4 + 4 * 7 + 4
        # proc 0 gives four slots x 1, proc 1 four x 2
        assert float(got["summed"][0]) == 12.0
