"""The port's fused decoder against `ozone_tpu`'s XLA decode, word-exact.

The same seeded codewords go through the port's make_fused_decoder (its
plain PyTorch version, on the CPU) and `ozone_tpu`'s make_fused_decoder
with OZONE_TPU_FUSED_BACKEND=jax, so the XLA program `_decode_apply_jit`
(`_decode_apply_nocrc_jit` with no checksum) is the oracle. Recovered
bytes and CRC words (as uint32) must be equal, and equal to the erased
units of the codeword. The CUDA kernel itself runs only on the card,
where chip_smoke.py holds its decode form against the same plain version.
"""

import itertools

import numpy as np
import pytest
import torch

from ozone_tpu.codec import fused as j_fused
from ozone_tpu.codec.api import CoderOptions as JOptions
from ozone_tpu.utils.checksum import ChecksumType as JChecksumType
from ozone_tpu_torch import cuda_build
from ozone_tpu_torch.codec import fused_kernel
from ozone_tpu_torch.codec.api import CoderOptions
from ozone_tpu_torch.codec.fused import (
    FusedSpec,
    _parity_matrix,
    decode_plan_cache_size,
    make_fused_decoder,
)
from ozone_tpu_torch.codec.fused_kernel import gf_apply_plain
from ozone_tpu_torch.utils.checksum import Checksum, ChecksumType

CELL = 4096
B = 2


def _codeword(k, p, codec="rs", seed=0):
    """uint8 [B, k+p, CELL]: seeded data and its parity."""
    data = np.random.default_rng(seed).integers(0, 256, (B, k, CELL),
                                                dtype=np.uint8)
    matrix = torch.from_numpy(_parity_matrix(CoderOptions(k, p, codec,
                                                          cell_size=CELL)))
    parity = gf_apply_plain(torch.from_numpy(data), matrix).numpy()
    return np.concatenate([data, parity], axis=1)


def _check(monkeypatch, k, p, erased, codec="rs", checksum="CRC32C",
           bpc=1024, valid=None):
    monkeypatch.setenv("OZONE_TPU_FUSED_BACKEND", "jax")
    units = _codeword(k, p, codec, seed=len(erased) * 100 + sum(erased))
    if valid is None:
        valid = [u for u in range(k + p) if u not in erased][:k]
    spec = FusedSpec(CoderOptions(k, p, codec, cell_size=CELL),
                     ChecksumType[checksum], bpc)
    rec, crcs = make_fused_decoder(spec, valid, erased, device="cpu")(
        units[:, valid])
    assert rec.dtype == torch.uint8 and crcs.dtype == torch.int32
    rec, crcs = rec.numpy(), crcs.numpy().view(np.uint32)
    jspec = j_fused.FusedSpec(JOptions(k, p, codec, cell_size=CELL),
                              JChecksumType[checksum], bpc)
    jrec, jcrcs = (np.asarray(x) for x in j_fused.make_fused_decoder(
        jspec, valid, erased)(units[:, valid]))
    assert np.array_equal(rec, jrec)
    assert np.array_equal(rec, units[:, erased])
    assert crcs.shape == jcrcs.shape
    assert np.array_equal(crcs, jcrcs.astype(np.uint32))
    slices = spec.bytes_per_checksum
    assert crcs.shape == (B, len(erased),
                          CELL // slices if checksum != "NONE" else 0)
    if checksum != "NONE":
        host = Checksum(ChecksumType[checksum], slices)
        assert [int.from_bytes(c, "big")
                for c in host.compute(rec[1, -1]).checksums] == crcs[1, -1].tolist()


RS63_PATTERNS = [list(c) for e in (1, 2) for c in itertools.combinations(range(9), e)]


@pytest.mark.parametrize("erased", RS63_PATTERNS,
                         ids=["-".join(map(str, e)) for e in RS63_PATTERNS])
def test_rs63_every_single_and_double_erasure(monkeypatch, erased):
    assert len(RS63_PATTERNS) == 45
    _check(monkeypatch, 6, 3, erased)


_rng = np.random.default_rng(104)
RS104_PATTERNS = [sorted(_rng.choice(14, e, replace=False).tolist())
                  for e in (1, 2, 2, 3, 3, 4, 4, 4)] + [[0, 1], [10, 11, 12, 13]]


@pytest.mark.parametrize("erased", RS104_PATTERNS,
                         ids=["-".join(map(str, e)) for e in RS104_PATTERNS])
def test_rs104_erasures(monkeypatch, erased):
    _check(monkeypatch, 10, 4, erased)


def test_rs104_out_of_order_survivors(monkeypatch):
    """Survivors need not be the first k; the outputs follow `erased`."""
    _check(monkeypatch, 10, 4, [13, 0], valid=[1, 3, 4, 5, 6, 7, 8, 9, 10, 12])


@pytest.mark.parametrize("erased", [[0], [2], [3]], ids=["data0", "data2", "parity"])
def test_xor_data_and_parity_unit(monkeypatch, erased):
    _check(monkeypatch, 3, 1, erased, codec="xor")


@pytest.mark.parametrize("checksum", ["CRC32", "CRC32C", "NONE"])
@pytest.mark.parametrize("erased", [[1], [0, 7]])
def test_checksum_types(monkeypatch, checksum, erased):
    _check(monkeypatch, 6, 3, erased, checksum=checksum)


@pytest.mark.parametrize("bpc", [1024, CELL, 16 * 1024, 3000],
                         ids=["1024", "cell", "clamped-larger", "clamped-odd"])
def test_bytes_per_checksum_and_clamp(monkeypatch, bpc):
    _check(monkeypatch, 6, 3, [2, 6], bpc=bpc)


def test_host_and_tensor_input_agree():
    spec = FusedSpec(CoderOptions(6, 3, cell_size=CELL))
    units = _codeword(6, 3)[:, 1:7]
    fn = make_fused_decoder(spec, list(range(1, 7)), [0], device="cpu")
    rec_np, crcs_np = fn(units)
    rec_t, crcs_t = fn(torch.from_numpy(units.copy()))
    assert torch.equal(rec_np, rec_t) and torch.equal(crcs_np, crcs_t)


def test_new_patterns_add_plans_not_libraries():
    """Each new erasure pattern adds one cached plan (its recovery matrix)
    and builds nothing; a pattern seen before adds nothing."""
    spec = FusedSpec(CoderOptions(4, 2, cell_size=1024), bytes_per_checksum=512)
    libs, builds = dict(cuda_build._libs), dict(cuda_build.build_log)
    launched = fused_kernel.launches.count
    units = np.zeros((1, 4, 1024), dtype=np.uint8)
    before = decode_plan_cache_size()
    patterns = [[0], [1], [0, 5], [4, 2]]
    for i, erased in enumerate(patterns):
        valid = [u for u in range(6) if u not in erased][:4]
        make_fused_decoder(spec, valid, erased, device="cpu")(units)
        assert decode_plan_cache_size() == before + i + 1
    for erased in patterns:
        valid = [u for u in range(6) if u not in erased][:4]
        make_fused_decoder(spec, valid, erased, device="cpu")(units)
    assert decode_plan_cache_size() == before + len(patterns)
    assert cuda_build._libs == libs and cuda_build.build_log == builds
    assert fused_kernel.launches.count == launched


def test_decoder_rejects_what_it_cannot_decode():
    with pytest.raises(ValueError):  # lrc: the read set must span unit 0
        make_fused_decoder(FusedSpec(CoderOptions(4, 4, "lrc", cell_size=CELL,
                                                  local_groups=2)),
                           [2, 3, 5], [0], device="cpu")
    with pytest.raises(ValueError):  # xor recovers one unit only
        make_fused_decoder(FusedSpec(CoderOptions(3, 1, "xor", cell_size=CELL)),
                           [0, 1], [2, 3], device="cpu")
    with pytest.raises(ValueError):  # rs needs exactly k survivors
        make_fused_decoder(FusedSpec(CoderOptions(6, 3, cell_size=CELL)),
                           [0, 1, 2], [3], device="cpu")
