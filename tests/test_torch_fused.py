"""The port's fused encode+CRC against `ozone_tpu`'s, word- and byte-exact.

The same seeded inputs go through the port's encoder (its plain PyTorch
version, on the CPU), `ozone_tpu`'s XLA program and `ozone_tpu`'s Pallas
kernel in interpret mode. The CUDA kernel itself runs only on the card,
where chip_smoke.py holds it against the same plain version.
"""

import numpy as np
import pytest
import torch

from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.codec.fused import FusedSpec as JSpec
from ozone_tpu.codec.fused import _fused_encode_cached
from ozone_tpu.codec.pallas_kernel import make_pallas_fused_encoder
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch.codec import crc_device, fused_kernel
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import FusedSpec, _parity_matrix, make_fused_encoder
from ozone_tpu_torch.utils.checksum import ChecksumType, crc32, crc32c

CELL = 2048
B = 4


def _inputs(k, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, k, CELL), dtype=np.uint8)


def _port(k, p, checksum, bpc, data):
    spec = FusedSpec(CoderOptions(k, p, "rs", cell_size=CELL),
                     ChecksumType[checksum], bpc)
    parity, crcs = make_fused_encoder(spec, device="cpu")(data)
    assert parity.device.type == "cpu" and crcs.dtype == torch.int32
    return parity.numpy(), crcs.numpy().view(np.uint32)


@pytest.mark.parametrize("k,p", [(3, 2), (6, 3)])
@pytest.mark.parametrize("checksum", ["CRC32", "CRC32C", "NONE"])
@pytest.mark.parametrize("bpc", [512, CELL])
def test_encoder_matches_xla(k, p, checksum, bpc):
    data = _inputs(k)
    parity, crcs = _port(k, p, checksum, bpc, data)
    fn = _fused_encode_cached(JOptions(k, p, "rs", cell_size=CELL),
                              JChecksumType[checksum], bpc)
    jparity, jcrcs = (np.asarray(x) for x in fn(data))
    assert np.array_equal(parity, jparity)
    assert crcs.shape == jcrcs.shape
    assert crcs.shape == ((B, k + p, CELL // bpc) if checksum != "NONE"
                          else (B, k + p, 0))
    assert np.array_equal(crcs, jcrcs)


@pytest.mark.parametrize("k,p", [(3, 2), (6, 3)])
@pytest.mark.parametrize("checksum", ["CRC32", "CRC32C"])
@pytest.mark.parametrize("bpc", [512, CELL])
def test_encoder_matches_pallas_interpret(k, p, checksum, bpc):
    data = _inputs(k, seed=1)
    parity, crcs = _port(k, p, checksum, bpc, data)
    spec = JSpec(JOptions(k, p, "rs", cell_size=CELL), JChecksumType[checksum], bpc)
    fn = make_pallas_fused_encoder(spec, stripes_per_block=2, interpret=True)
    jparity, jcrcs = (np.asarray(x) for x in fn(data))
    assert np.array_equal(parity, jparity)
    assert np.array_equal(crcs, jcrcs)


@pytest.mark.parametrize("checksum,host", [("CRC32", crc32), ("CRC32C", crc32c)])
def test_plain_matches_host_crc(checksum, host):
    """fused_encode_crc_plain on its own: CRCs of every slice of the inputs
    and outputs equal the host CRC; crc_in/crc_out select the rows."""
    k, p, bpc = 3, 2, 512
    data = torch.from_numpy(_inputs(k, seed=2))
    matrix = torch.from_numpy(_parity_matrix(CoderOptions(k, p, cell_size=CELL)))
    poly = {"CRC32": 0xEDB88320, "CRC32C": 0x82F63B78}[checksum]
    out, crcs = fused_kernel.fused_encode_crc_plain(data, matrix, poly, bpc)
    units = torch.cat([data, out], 1).numpy()
    words = crcs.numpy().view(np.uint32)
    for b in range(B):
        for u in range(k + p):
            for s in range(CELL // bpc):
                assert words[b, u, s] == host(units[b, u, s * bpc:(s + 1) * bpc])
    _, out_only = fused_kernel.fused_encode_crc_plain(data, matrix, poly, bpc,
                                                      crc_in=False)
    assert torch.equal(out_only, crcs[:, k:])
    fn = crc_device.make_crc_fn(bpc, poly)
    assert torch.equal(fn(data), crcs[:, :k])


def test_wrapper_counts_no_launch_on_cpu():
    fused_kernel.launches.reset()
    data = torch.from_numpy(_inputs(3))
    matrix = torch.from_numpy(_parity_matrix(CoderOptions(3, 2, cell_size=CELL)))
    fused_kernel.fused_encode_crc(data, matrix, 0x82F63B78, 512)
    assert fused_kernel.launches.count == 0


@pytest.mark.parametrize("case", ["dtype", "matrix_dtype", "rank", "width",
                                  "slice", "rows", "contiguous", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    data = torch.zeros((2, 3, 1024), dtype=torch.uint8)
    matrix = torch.ones((2, 3), dtype=torch.uint8)
    bpc = 512
    if case == "dtype":
        data = data.to(torch.int32)
    elif case == "matrix_dtype":
        matrix = matrix.to(torch.int64)
    elif case == "rank":
        data = data.reshape(6, 1024)
    elif case == "width":
        matrix = torch.ones((2, 4), dtype=torch.uint8)
    elif case == "slice":
        bpc = 300
    elif case == "rows":
        matrix = torch.ones((fused_kernel.MAX_P + 1, 3), dtype=torch.uint8)
    elif case == "contiguous":
        data = torch.zeros((2, 1024, 3), dtype=torch.uint8).transpose(1, 2)
    elif case == "device":
        data, matrix = data.to("meta"), matrix.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fused_kernel.fused_encode_crc(data, matrix, 0x82F63B78, bpc)


def _emulate_kernel_crc(piece: np.ndarray, poly: int) -> int:
    """The CRC schedule of csrc/fused_encode_crc.cu, in Python: 4 KiB tiles
    zero-padded at the front, 16-byte lane segments, five shuffle folds
    with adv_16..adv_256, a per-row carry with adv_512, then zeros_crc."""
    from ozone_tpu_torch.utils.checksum import _linear_parts

    consts = fused_kernel.kernel_constants(poly)
    tab = [int(v) for v in consts[:256]]
    ops = [consts[256 + 32 * i:256 + 32 * (i + 1)] for i in range(6)]

    def adv(op, x):
        y = 0
        for i in range(32):
            if (x >> i) & 1:
                y ^= int(op[i])
        return y

    n = piece.size
    tile = min(-(-n // 512) * 512, 4096)
    ntiles = -(-n // tile)
    buf = np.concatenate([np.zeros(ntiles * tile - n, np.uint8), piece])
    state = 0
    for c in range(0, buf.size, 512):
        segs = []
        for lane in range(32):
            crc = 0
            for byte in buf[c + 16 * lane:c + 16 * lane + 16].tolist():
                crc = (crc >> 8) ^ tab[(crc ^ byte) & 0xFF]
            segs.append(crc)
        for level in range(5):
            step = 1 << level
            segs = [adv(ops[level], segs[i]) ^ segs[i + step]
                    if i % (2 * step) == 0 else segs[i] for i in range(32)]
        state = adv(ops[5], state) ^ segs[0]
    return state ^ _linear_parts(n, poly)[1]


@pytest.mark.parametrize("n", [16, 100, 512, 4096 + 48])
@pytest.mark.parametrize("checksum,host", [("CRC32", crc32), ("CRC32C", crc32c)])
def test_kernel_crc_schedule_matches_host(n, checksum, host):
    """The kernel's host-built table and zero-advance operators, combined
    the way the kernel combines them, give the host CRC."""
    poly = {"CRC32": 0xEDB88320, "CRC32C": 0x82F63B78}[checksum]
    piece = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert _emulate_kernel_crc(piece, poly) == host(piece)
