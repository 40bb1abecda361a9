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


def _adv(op, x: int) -> int:
    y = 0
    for i in range(32):
        if (x >> i) & 1:
            y ^= int(op[i])
    return y


def _emulate_kernel_crc(piece: np.ndarray, poly: int) -> int:
    """The CRC schedule of csrc/fused_encode_crc.cu, in Python: tiles of
    kernel_tile(n) bytes zero-padded at the front, 32 lane pieces of
    tile/32 bytes, each lane running slicing-by-4 through its piece of
    every tile from its own state after one gap advance (operator 0, by
    four byte tables), one five-level fold (operators 1..5), then
    zeros_crc."""
    from ozone_tpu_torch.utils.checksum import _linear_parts

    n = piece.size
    consts = fused_kernel.kernel_constants(poly, n)
    ops = [consts[256 + 32 * i:256 + 32 * (i + 1)] for i in range(6)]
    tabs = [[int(v) for v in consts[:256]]]
    for _ in range(3):  # T1..T3 from T0, as each block derives them
        tabs.append([(v >> 8) ^ tabs[0][v & 0xFF] for v in tabs[-1]])
    t0, t1, t2, t3 = tabs

    tile = fused_kernel.kernel_tile(n)
    ntiles = -(-n // tile)
    lp = tile // fused_kernel.LANES
    buf = np.concatenate([np.zeros(ntiles * tile - n, np.uint8), piece])
    words = buf.view("<u4").tolist()
    states = [0] * fused_kernel.LANES
    # the gap operator as four byte tables, as each block builds it
    gap = [[_adv(ops[0], v << (8 * nb)) for v in range(256)] for nb in range(4)]
    for t in range(ntiles):
        for lane in range(fused_kernel.LANES):
            st = states[lane]
            st = (gap[0][st & 0xFF] ^ gap[1][(st >> 8) & 0xFF]
                  ^ gap[2][(st >> 16) & 0xFF] ^ gap[3][st >> 24]) if t else 0
            w0 = (t * tile + lane * lp) // 4
            for w in words[w0:w0 + lp // 4]:
                c = st ^ w
                st = t3[c & 0xFF] ^ t2[(c >> 8) & 0xFF] ^ t1[(c >> 16) & 0xFF] ^ t0[c >> 24]
            states[lane] = st
    for level in range(5):
        step = 1 << level
        states = [_adv(ops[1 + level], states[i]) ^ states[i + step]
                  if i % (2 * step) == 0 else states[i] for i in range(32)]
    return states[0] ^ _linear_parts(n, poly)[1]


@pytest.mark.parametrize("n", [16, 100, 512, 4096 + 48, 16384 + 48, 65536])
@pytest.mark.parametrize("checksum,host", [("CRC32", crc32), ("CRC32C", crc32c)])
def test_kernel_crc_schedule_matches_host(n, checksum, host):
    """The kernel's host-built table and zero-advance operators, combined
    the way the kernel combines them, give the host CRC."""
    poly = {"CRC32": 0xEDB88320, "CRC32C": 0x82F63B78}[checksum]
    piece = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert _emulate_kernel_crc(piece, poly) == host(piece)


@pytest.mark.parametrize("n,lengths", [
    (16, (496, 16, 32, 64, 128, 256)),
    (100, (496, 16, 32, 64, 128, 256)),
    (1536, (1488, 48, 96, 192, 384, 768)),
    (16384, (3968, 128, 256, 512, 1024, 2048)),
    (1 << 20, (3968, 128, 256, 512, 1024, 2048)),
])
def test_kernel_advance_lengths(n, lengths):
    """Six operators for every slice length; the gap plus one piece is a
    tile, and the last fold level spans half of it."""
    assert fused_kernel.advance_lengths(n) == lengths
    assert fused_kernel.kernel_constants(0x82F63B78, n).shape == (256 + 6 * 32,)


def _xtime(x: np.ndarray) -> np.ndarray:
    """The kernel's packed doubling of four GF(2^8) bytes in a uint32:
    ((x << 1) & 0xfefefefe) ^ umulhi(x & 0x80808080, 0x1d << 25)."""
    hi = (x & np.uint32(0x80808080)).astype(np.uint64)
    red = ((hi * np.uint64(0x1D << 25)) >> np.uint64(32)).astype(np.uint32)
    return ((x << np.uint32(1)) & np.uint32(0xFEFEFEFE)) ^ red


def _emulate_kernel_gf(data: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """The kernel's GF(2^8) apply on 32-bit words: uint8 [k, C] and
    [p, k] -> uint8 [p, C] by Horner's rule over the coefficient bits,
    acc = xtime(acc) ^ XOR_j (x_j & mask[j][b][i]) for b = 7 .. 0."""
    p, k = matrix.shape
    words = np.ascontiguousarray(data).view("<u4")  # [k, C/4]
    bits = (matrix.T[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    masks = np.where(bits == 1, np.uint32(0xFFFFFFFF), np.uint32(0))  # [k, 8, p]
    acc = np.zeros((p, words.shape[1]), dtype=np.uint32)
    for b in range(7, -1, -1):
        if b < 7:
            acc = _xtime(acc)
        for j in range(k):
            acc ^= words[j][None, :] & masks[j, b][:, None]
    return acc.view(np.uint8)


def test_kernel_gf_product_all_pairs():
    """Packed xtime and bit masks give gf_mul for all 256 x 256 pairs."""
    from ozone_tpu_torch.codec.gf256 import gf_mul

    a = np.arange(256, dtype=np.uint8)
    coeffs = np.arange(256, dtype=np.uint8)[:, None]  # 256 rows, k = 1
    got = _emulate_kernel_gf(a[None, :], coeffs)
    assert np.array_equal(got, gf_mul(coeffs, a[None, :]))


@pytest.mark.parametrize("k,p", [(6, 3), (10, 4)])
@pytest.mark.parametrize("which", ["parity", "random"])
def test_kernel_gf_matrix_apply(k, p, which):
    """The kernel's GF apply equals gf_matmul and the plain version on an
    RS parity matrix and on a random coefficient matrix."""
    from ozone_tpu_torch.codec.gf256 import gf_matmul

    rng = np.random.default_rng(k * 10 + p)
    if which == "parity":
        matrix = _parity_matrix(CoderOptions(k, p, cell_size=CELL))
    else:
        matrix = rng.integers(0, 256, (p, k), dtype=np.uint8)
    data = rng.integers(0, 256, (k, CELL), dtype=np.uint8)
    got = _emulate_kernel_gf(data, matrix)
    assert np.array_equal(got, gf_matmul(matrix, data))
    plain = fused_kernel.gf_apply_plain(torch.from_numpy(data[None]),
                                        torch.from_numpy(matrix))
    assert np.array_equal(got, plain[0].numpy())
