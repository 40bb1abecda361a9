"""The port's sharded codec against `ozone_tpu.parallel.sharded`, on the CPU.

Every test of tests/test_sharded.py, on a port mesh of CPU slots beside
the reference's mesh of as many virtual CPU devices (tests/conftest.py
provides eight), at mesh sizes 1, 2, 3 and 8: DP encode (with and
without padding), TP encode and its `k % n` refusal, sharded
reconstruction, the DP batch split, and the ring decoder (a data+parity
erasure, a parity-only erasure, survivors padded by more than one unit).
The same numpy-seeded stripes go through both; parity, recovered units
and CRC words must be equal bit for bit, and equal to the numpy coder's.
Every form's device passes are counted (the CPU runs the kernel's plain
version, so the count is of `fused_encode_crc` calls): DP n, TP n + 1,
ring n + n (n - 1) + n.
"""

import jax
import numpy as np
import pytest
import torch

from ozone_tpu.codec import create_encoder as j_create_encoder
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.codec.fused import FusedSpec as JSpec
from ozone_tpu.parallel import sharded as j_sharded
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch.codec import fused_kernel
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import FusedSpec
from ozone_tpu_torch.parallel import sharded
from ozone_tpu_torch.utils.checksum import ChecksumType, crc32c

SIZES = [1, 2, 3, 8]
CELL, BPC = 1024, 256


def _opts(k, p, cell=CELL):
    return CoderOptions(k, p, "rs", cell_size=cell), JOptions(k, p, "rs", cell_size=cell)


def _specs(k=6, p=3, cell=CELL, checksum="CRC32C"):
    opts, jopts = _opts(k, p, cell)
    return (FusedSpec(opts, ChecksumType[checksum], BPC),
            JSpec(jopts, JChecksumType[checksum], BPC))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def passes(monkeypatch):
    """Records (device, input shape) of every fused kernel pass the forms
    make."""
    seen = []
    real = fused_kernel.fused_encode_crc

    def spy(data, *a, **kw):
        seen.append((data.device, tuple(data.shape)))
        return real(data, *a, **kw)

    monkeypatch.setattr(fused_kernel, "fused_encode_crc", spy)
    return seen


def meshes(n):
    assert jax.device_count() == 8, "conftest must provide 8 CPU devices"
    return sharded.make_mesh(devices=["cpu"] * n), j_sharded.make_mesh(n)


def _u32(t):
    return t.numpy().view(np.uint32)


def _stripes(seed, b, k, cell=CELL):
    return np.random.default_rng(seed).integers(0, 256, (b, k, cell), dtype=np.uint8)


@pytest.mark.parametrize("n", SIZES)
def test_dp_encode_matches_reference(n, passes):
    spec, jspec = _specs()
    data = _stripes(0, 2 * n, 6)
    parity, crcs = sharded.make_sharded_fused_encoder(spec, meshes(n)[0])(data)
    jparity, jcrcs = (np.asarray(x) for x in
                      j_sharded.make_sharded_fused_encoder(jspec, meshes(n)[1])(data))
    assert np.array_equal(parity.numpy(), jparity)
    assert np.array_equal(_u32(crcs), jcrcs)
    assert np.array_equal(parity.numpy(), j_create_encoder(JOptions(6, 3, "rs", cell_size=CELL),
                                                           "numpy").encode(data))
    assert int(_u32(crcs)[1, 0, 0]) == crc32c(data[1, 0, :BPC])
    assert int(_u32(crcs)[1, 6, 2]) == crc32c(parity.numpy()[1, 0, 512:768])
    assert len(passes) == n


@pytest.mark.parametrize("n", SIZES)
def test_dp_encode_with_padding(n, passes):
    spec, jspec = _specs()
    data = _stripes(1, 5, 6)  # 5 rows: padded unless n is 1
    padded, orig = sharded.pad_batch(data, n)
    assert padded.shape[0] % n == 0 and orig == 5
    parity = sharded.make_sharded_fused_encoder(spec, meshes(n)[0])(padded)[0].numpy()[:orig]
    jparity = np.asarray(j_sharded.make_sharded_fused_encoder(jspec, meshes(n)[1])(
        j_sharded.pad_batch(data, n)[0])[0])[:orig]
    assert np.array_equal(parity, jparity)
    assert len(passes) == n
    # padded torch batches pad the same way
    tpad, torig = sharded.pad_batch(torch.from_numpy(data), n)
    assert torig == 5 and np.array_equal(tpad.numpy(), padded)


def test_dp_encode_zero_rows_keeps_shapes(passes):
    spec, _ = _specs()
    parity, crcs = sharded.make_sharded_fused_encoder(spec, meshes(3)[0])(
        np.zeros((0, 6, CELL), np.uint8))
    assert tuple(parity.shape) == (0, 3, CELL)
    assert tuple(crcs.shape) == (0, 9, CELL // BPC)


@pytest.mark.parametrize("n", SIZES)
def test_tp_encode_psum_matches_reference(n, passes):
    k = 8 if 8 % n == 0 else 6  # k must divide over the mesh
    opts, jopts = _opts(k, 3, 512)
    data = _stripes(2, 4, k, 512)
    parity = sharded.make_tp_encoder(opts, meshes(n)[0])(data).numpy()
    jparity = np.asarray(j_sharded.make_tp_encoder(jopts, meshes(n)[1])(data))
    assert np.array_equal(parity, jparity)
    assert np.array_equal(parity, j_create_encoder(jopts, "numpy").encode(data))
    assert len(passes) == n + 1
    # the combine lays the n partials side by side: [B, n p, C] in, p out
    assert passes[-1] == (torch.device("cpu"), (4, n * 3, 512))


def test_tp_encode_refuses_uneven_units():
    opts, jopts = _opts(6, 3)
    with pytest.raises(ValueError) as jerr:
        j_sharded.make_tp_encoder(jopts, meshes(8)[1])
    with pytest.raises(ValueError) as err:
        sharded.make_tp_encoder(opts, meshes(8)[0])
    assert str(err.value) == str(jerr.value) == "TP encode requires k % mesh == 0, got 6 % 8"


@pytest.mark.parametrize("n", SIZES)
def test_sharded_reconstruction_matches(n, passes):
    spec, jspec = _specs()
    data = _stripes(3, 2 * n, 6)
    units = np.concatenate([data, j_create_encoder(JOptions(6, 3, "rs", cell_size=CELL),
                                                   "numpy").encode(data)], axis=1)
    erased = [1, 7]
    valid = [i for i in range(9) if i not in erased][:6]
    rec, crcs = sharded.make_sharded_decoder(spec, valid, erased, meshes(n)[0])(units[:, valid])
    jrec, jcrcs = (np.asarray(x) for x in j_sharded.make_sharded_decoder(
        jspec, valid, erased, meshes(n)[1])(units[:, valid]))
    assert np.array_equal(rec.numpy(), units[:, erased])
    assert np.array_equal(rec.numpy(), jrec) and np.array_equal(_u32(crcs), jcrcs)
    assert int(_u32(crcs)[1, 1, 3]) == crc32c(units[1, erased[1], 768:])
    assert len(passes) == n


@pytest.mark.parametrize("n", SIZES)
def test_dp_scales_batch_across_devices(n, passes):
    """The batch is split over every slot: n passes of B / n rows, one on
    each slot's device, reassembled in row order."""
    spec, _ = _specs()
    mesh = meshes(n)[0]
    data = _stripes(4, 2 * n, 6)
    parity, _ = sharded.make_sharded_fused_encoder(spec, mesh)(data)
    assert passes == [(s.device, (2, 6, CELL)) for s in mesh.local_slots]
    assert mesh.devices.size == n and mesh.axis_names == ("dn",)
    for i in range(n):
        one, _ = sharded.make_sharded_fused_encoder(spec, meshes(1)[0])(data[2 * i:2 * i + 2])
        assert np.array_equal(parity.numpy()[2 * i:2 * i + 2], one.numpy())


def _ring_case(n, passes, seed, b, k, p, erased, valid):
    spec, jspec = _specs(k, p)
    data = _stripes(seed, b, k)
    jopts = JOptions(k, p, "rs", cell_size=CELL)
    allu = np.concatenate([data, j_create_encoder(jopts, "numpy").encode(data)], axis=1)
    rec, crcs = sharded.make_ring_decoder(spec, valid, erased, meshes(n)[0])(allu[:, valid])
    jrec, jcrcs = jax.device_get(j_sharded.make_ring_decoder(
        jspec, valid, erased, meshes(n)[1])(allu[:, valid]))
    np.testing.assert_array_equal(rec.numpy(), allu[:, erased])
    np.testing.assert_array_equal(rec.numpy(), jrec)
    np.testing.assert_array_equal(_u32(crcs), jcrcs)
    for bi in range(b):
        for ei, u in enumerate(erased):
            for s in range(CELL // BPC):
                assert int(_u32(crcs)[bi, ei, s]) == crc32c(allu[bi, u, s * BPC:(s + 1) * BPC])
    # n partials, n (n - 1) combines, then the CRC over each slot's rows
    assert len(passes) == n + n * (n - 1) + min(n, b)


@pytest.mark.parametrize("n", SIZES)
def test_ring_decoder_matches_reference(n, passes):
    """k = 6 survivors zero-padded over the mesh (two padded units at 8)."""
    _ring_case(n, passes, 7, 8, 6, 3, [1, 4], [0, 2, 3, 5, 6, 7])


@pytest.mark.parametrize("n", SIZES)
def test_ring_decoder_parity_only_erasure(n, passes):
    """An erased parity unit is re-encoded through the ring."""
    _ring_case(n, passes, 8, 2, 6, 3, [7], [0, 1, 2, 3, 4, 5])


@pytest.mark.parametrize("n", SIZES)
def test_ring_decoder_pads_survivors(n, passes):
    """RS(10,4) with two losses: 10 survivors, padded to 12 at n = 3 and
    to 16 at n = 8 (six padded units, three slots of nothing but
    padding, each adding a zero partial)."""
    _ring_case(n, passes, 9, 8, 10, 4, [0, 12], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10])


def test_ring_decoder_without_crc(passes):
    spec, jspec = _specs(checksum="NONE")
    data = _stripes(10, 3, 6)
    allu = np.concatenate([data, j_create_encoder(JOptions(6, 3, "rs", cell_size=CELL),
                                                  "numpy").encode(data)], axis=1)
    valid, erased = [0, 2, 3, 5, 6, 7], [1, 4]
    rec, crcs = sharded.make_ring_decoder(spec, valid, erased, meshes(3)[0])(allu[:, valid])
    jrec, jcrcs = jax.device_get(j_sharded.make_ring_decoder(
        jspec, valid, erased, meshes(3)[1])(allu[:, valid]))
    assert np.array_equal(rec.numpy(), jrec)
    assert tuple(crcs.shape) == jcrcs.shape == (3, 2, 0)
    assert len(passes) == 3 + 3 * 2


def test_plan_caches_isolated_across_meshes():
    """Programs are keyed on the mesh: two meshes never share one, the
    same mesh always gets its own back."""
    opts, _ = _opts(8, 3)
    m8, m4 = meshes(8)[0], meshes(4)[0]
    tp8, tp4 = sharded.make_tp_encoder(opts, m8), sharded.make_tp_encoder(opts, m4)
    assert tp8 is not tp4 and sharded.make_tp_encoder(opts, m8) is tp8
    spec, _ = _specs()
    assert sharded.make_sharded_fused_encoder(spec, m8) is not \
        sharded.make_sharded_fused_encoder(spec, m4)
    # the ring's per-pattern plan is per slot count: padded to 8 vs 4 slots
    p8, upc8 = sharded._ring_decode_plan_cached(opts, tuple(range(8)), (8,), 8)
    p4, upc4 = sharded._ring_decode_plan_cached(opts, tuple(range(8)), (8,), 4)
    assert (p8.shape, upc8, p4.shape, upc4) == ((8, 1, 1), 1, (4, 1, 2), 2)


def test_make_mesh_contract():
    mesh = sharded.make_mesh(3, devices=["cpu"] * 8)
    assert mesh.devices.size == 3 and not mesh.spans_processes
    assert [s.index for s in mesh.slots] == [0, 1, 2]
    with pytest.raises(ValueError):
        sharded.make_mesh(9, devices=["cpu"] * 8)
    # one CUDA-less host: the production policy is the single-device path
    assert sharded.default_codec_mesh() is None
