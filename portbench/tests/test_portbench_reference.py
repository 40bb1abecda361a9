"""The plain reference against known vectors and against the program's
own plain coder, and the roofline count."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import roofline
from portbench.reference import crc32c, gf256, rs


def test_crc32c_known_vector():
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    assert crc32c.crc32c(b"") == 0


def test_slice_crcs_match_the_definition():
    rng = np.random.default_rng(5)
    for length in (1, 7, 512, 1000):
        rows = rng.integers(0, 256, (6, length), dtype=np.uint8)
        got = crc32c.slice_crcs(torch.from_numpy(rows), block=4).tolist()
        assert got == [crc32c.crc32c(r.tobytes()) for r in rows]


def test_cell_crcs_per_slice():
    rng = np.random.default_rng(6)
    cells = rng.integers(0, 256, (2, 3, 4096), dtype=np.uint8)
    got = crc32c.cell_crcs(torch.from_numpy(cells), 1024).numpy()
    assert got.shape == (2, 3, 4)
    assert got[1, 2, 3] == crc32c.crc32c(cells[1, 2, 3072:].tobytes())


def test_field_arithmetic():
    t = gf256.mul_table()
    assert (t[1] == np.arange(256)).all() and (t[0] == 0).all()
    assert (t == t.T).all()
    for a in (1, 2, 3, 0x53, 0xCA, 255):
        assert t[a, gf256.inverse(a)] == 1
        assert t[a, 7] == gf256.mul_slow(a, 7)
    with pytest.raises(ZeroDivisionError):
        gf256.inverse(0)


@pytest.mark.parametrize("k,p", [(6, 3), (10, 4), (3, 2)])
def test_generator_and_parity_against_the_program(k, p):
    from ozone_tpu_torch.codec import rs_math
    from ozone_tpu_torch.codec.api import CoderOptions
    from ozone_tpu_torch.codec.numpy_coder import NumpyRSEncoder

    assert (gf256.parity_matrix(k, p) == rs_math.parity_matrix(k, p)).all()
    rng = np.random.default_rng(k * p)
    data = rng.integers(0, 256, (3, k, 256), dtype=np.uint8)
    ours = rs.encode(torch.from_numpy(data), k, p).numpy()
    enc = NumpyRSEncoder(CoderOptions.parse(f"rs-{k}-{p}-256"))
    assert (ours == enc.do_encode(data)).all()


def test_roofline_of_the_kernel_table():
    enc, what = roofline.fused_bound(8, 6, 3, 1 << 20, 16384)
    assert what == "bytes" and round(enc * 1e3, 4) == 0.0225
    dec, _ = roofline.fused_bound(8, 10, 2, 1 << 20, 16384, rows=2)
    assert round(dec * 1e3, 4) == 0.0300
    # a GF(2^8) code of fewer than 256 units moves too many bytes per
    # operation to be bounded by the int8 peak
    _, what = roofline.fused_bound(1, 128, 127, 1 << 20, 16384)
    assert what == "bytes"
