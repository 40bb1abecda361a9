"""The port's host-side codec math against `ozone_tpu`'s, array-equal.

Covers GF(2^8) tables and matrix ops, the Cauchy parity and recovery
matrices, the bit-expanded coding matrix, the CRC constants and the host
CRCs, for each scheme the port's encoder takes.
"""

import zlib

import numpy as np
import pytest

from ozone_tpu.codec import bitlin as j_bitlin
from ozone_tpu.codec import crc_device as j_crc_device
from ozone_tpu.codec import fused as j_fused
from ozone_tpu.codec import gf256 as j_gf256
from ozone_tpu.codec import rs_math as j_rs_math
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.scm import pipeline as j_pipeline
from ozone_tpu.utils import checksum as j_checksum
from ozone_tpu_torch.codec import bitlin, crc_device, fused, gf256, rs_math
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.scm import pipeline
from ozone_tpu_torch.utils import checksum

SCHEMES = ["rs-3-2", "rs-6-3", "rs-10-4", "rs-20-4", "xor-2-1"]
POLYS = [checksum.CRC32_POLY, checksum.CRC32C_POLY]


def _options(scheme):
    return CoderOptions.parse(scheme), JOptions.parse(scheme)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_options_parse(scheme):
    opts, jopts = _options(scheme)
    assert (opts.data_units, opts.parity_units, opts.codec, opts.cell_size) == (
        jopts.data_units, jopts.parity_units, jopts.codec, jopts.cell_size)
    assert str(opts) == str(jopts)
    rc, jrc = pipeline.ReplicationConfig.parse(scheme), \
        j_pipeline.ReplicationConfig.parse(scheme)
    assert (rc.type.value, rc.factor, rc.required_nodes, str(rc)) == \
        (jrc.type.value, jrc.factor, jrc.required_nodes, str(jrc))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gf256_matmul_and_inverse(scheme):
    opts, _ = _options(scheme)
    k = opts.data_units
    assert np.array_equal(gf256.EXP, j_gf256.EXP)
    assert np.array_equal(gf256.LOG, j_gf256.LOG)
    assert np.array_equal(gf256.MUL_TABLE, j_gf256.MUL_TABLE)
    rng = np.random.default_rng(k)
    a = rng.integers(0, 256, (k, k), dtype=np.uint8)
    b = rng.integers(0, 256, (k, 3), dtype=np.uint8)
    assert np.array_equal(gf256.gf_matmul(a, b), j_gf256.gf_matmul(a, b))
    # a Cauchy-extended generator's top k rows are the identity; its
    # parity rows stacked over identity rows are invertible
    m = rs_math.encode_matrix(k, 1)[1:k + 1]
    assert np.array_equal(gf256.gf_invert_matrix(m), j_gf256.gf_invert_matrix(m))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_parity_matrix(scheme):
    opts, jopts = _options(scheme)
    assert np.array_equal(fused._parity_matrix(opts), j_fused._parity_matrix(jopts))
    if opts.codec == "rs":
        k, p = opts.data_units, opts.parity_units
        assert np.array_equal(rs_math.parity_matrix(k, p),
                              j_rs_math.parity_matrix(k, p))


@pytest.mark.parametrize("scheme", [s for s in SCHEMES if s.startswith("rs")])
def test_decode_matrix(scheme):
    opts, _ = _options(scheme)
    k, p = opts.data_units, opts.parity_units
    rng = np.random.default_rng(k * 31 + p)
    for _ in range(4):
        e = int(rng.integers(1, p + 1))
        erased = sorted(rng.choice(k + p, e, replace=False).tolist())
        valid = [u for u in range(k + p) if u not in erased][:k]
        assert np.array_equal(rs_math.decode_matrix(k, p, erased, valid),
                              j_rs_math.decode_matrix(k, p, erased, valid))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_expand_coding_matrix(scheme):
    opts, jopts = _options(scheme)
    assert np.array_equal(
        bitlin.expand_coding_matrix(fused._parity_matrix(opts)),
        j_bitlin.expand_coding_matrix(j_fused._parity_matrix(jopts)))


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("n", [1, 16, 512, 2048])
def test_crc_constants(poly, n):
    k, z = crc_device.crc_constants_planemajor(n, poly)
    jk, jz = j_crc_device.crc_constants_planemajor(n, poly)
    assert np.array_equal(k, jk) and z == jz
    k32, z32 = checksum._linear_parts(n, poly)
    jk32, jz32 = j_checksum._linear_parts(n, poly)
    assert np.array_equal(k32, jk32) and z32 == jz32


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4096, 16 * 1024])
def test_host_crcs(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert checksum.crc32c(data) == j_checksum.crc32c(data)
    assert checksum.crc32(data) == j_checksum.crc32(data) == zlib.crc32(data.tobytes())
    assert checksum.crc_table_driven(data, checksum.CRC32C_POLY) == checksum.crc32c(data)
    # incremental contract: continue a running CRC
    assert checksum.crc32c(data[n // 2:], checksum.crc32c(data[:n // 2])) == \
        checksum.crc32c(data)


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("n,slices", [(1, 5), (100, 3), (1024, 4), (16 * 1024, 2)])
def test_position_table_slice_crcs(poly, n, slices):
    """The byte-position-table CRC of whole slices equals the table loop,
    and Checksum.compute (which takes it for CRC32C) equals the
    reference's, the short tail included."""
    data = np.random.default_rng(n).integers(0, 256, n * slices, dtype=np.uint8)
    want = [checksum.crc_table_driven(data[i * n:(i + 1) * n], poly)
            for i in range(slices)] if n < 16 * 1024 else \
        [checksum.crc_linear(data[i * n:(i + 1) * n], poly) for i in range(slices)]
    assert checksum.crc_slices(data, n, poly).tolist() == want
    tail = np.concatenate([data, data[:n // 2 + 1]])
    assert checksum.Checksum(checksum.ChecksumType.CRC32C, n).compute(tail) == \
        checksum.ChecksumData.from_lists(j_checksum.Checksum(
            j_checksum.ChecksumType.CRC32C, n).compute(tail).to_lists())
