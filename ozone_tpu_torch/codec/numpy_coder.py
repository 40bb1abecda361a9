"""Pure-numpy RS / LRC / XOR / Dummy coders: the CPU reference backend.

Port of `ozone_tpu/codec/numpy_coder.py` (the role of the reference's
pure-Java coders RSRawEncoder/Decoder, XORRawEncoder/Decoder and
DummyRawEncoder/Decoder): always available, bit-identical to ISA-L
output, the ground truth the other backends are held against and the
last fallback of the registry.
"""

from __future__ import annotations

import numpy as np

from ozone_tpu_torch.codec import gf256, lrc_math, rs_math
from ozone_tpu_torch.codec.api import (
    CoderOptions,
    RawErasureDecoder,
    RawErasureEncoder,
    check_decode_inputs,
    dense_valid,
)


def _gf_apply(matrix: np.ndarray, units: np.ndarray) -> np.ndarray:
    """Apply GF(2^8) coding matrix [r, k] to units [B, k, C] -> [B, r, C]:
    out[b, r, c] = XOR_j mul(matrix[r, j], units[b, j, c]), the reference's
    table-lookup-XOR loop (RSUtil.encodeData) vectorized over B and C."""
    out = np.zeros((units.shape[0], matrix.shape[0], units.shape[2]), dtype=np.uint8)
    for r in range(matrix.shape[0]):
        acc = out[:, r, :]
        for j in range(matrix.shape[1]):
            c = int(matrix[r, j])
            if c == 0:
                continue
            if c == 1:
                acc ^= units[:, j, :]
            else:
                acc ^= gf256.MUL_TABLE[c][units[:, j, :]]
    return out


class NumpyRSEncoder(RawErasureEncoder):
    def __init__(self, options: CoderOptions):
        super().__init__(options)
        self._pm = rs_math.parity_matrix(self.k, self.p)

    def do_encode(self, data: np.ndarray) -> np.ndarray:
        return _gf_apply(self._pm, data)


class NumpyRSDecoder(RawErasureDecoder):
    def __init__(self, options: CoderOptions):
        super().__init__(options)
        self._cache: dict[tuple, np.ndarray] = {}

    def do_decode(self, valid_data, valid, erased):
        key = (tuple(valid), tuple(erased))
        dm = self._cache.get(key)
        if dm is None:
            dm = rs_math.decode_matrix(self.k, self.p, erased, valid)
            self._cache[key] = dm
        return _gf_apply(dm, valid_data)


class NumpyLRCEncoder(RawErasureEncoder):
    """Locally repairable code encoder: one stacked (l+r) x k generator
    (local XOR rows over global Cauchy rows, codec/lrc_math.py) in one
    pass."""

    def __init__(self, options: CoderOptions):
        super().__init__(options)
        self._pm = lrc_math.parity_matrix(options)

    def do_encode(self, data: np.ndarray) -> np.ndarray:
        return _gf_apply(self._pm, data)


class NumpyLRCDecoder(RawErasureDecoder):
    """LRC decoder with the local-repair planner in front: a single loss
    in a group reads that group's survivors (group_size units, not k);
    more losses in a group, or a lost global, solve over a grown and
    pruned read set. Overrides decode() because the base contract's
    first-k read set is an RS notion: an LRC read set may be smaller than
    k, and the first k may even be singular."""

    def decode(self, inputs, erased_indexes):
        erased, avail = check_decode_inputs(self.options, inputs,
                                            erased_indexes)
        valid, _kind = lrc_math.plan_valid(self.options, erased, avail)
        dense, squeeze = dense_valid(inputs, valid)
        out = self.do_decode(dense, valid, erased)
        return out[0] if squeeze else out

    def do_decode(self, valid_data, valid, erased):
        dm = lrc_math.recovery_rows(self.options, valid, erased)
        return _gf_apply(dm, valid_data)


class NumpyXOREncoder(RawErasureEncoder):
    """Single-parity XOR (reference XORRawEncoder.java)."""

    def __init__(self, options: CoderOptions):
        if options.parity_units != 1:
            raise ValueError("XOR codec supports exactly one parity unit")
        super().__init__(options)

    def do_encode(self, data: np.ndarray) -> np.ndarray:
        return np.bitwise_xor.reduce(data, axis=1, keepdims=True)


class NumpyXORDecoder(RawErasureDecoder):
    def __init__(self, options: CoderOptions):
        if options.parity_units != 1:
            raise ValueError("XOR codec supports exactly one parity unit")
        super().__init__(options)

    def do_decode(self, valid_data, valid, erased):
        if len(erased) != 1:
            raise ValueError("XOR can reconstruct exactly one erased unit")
        return np.bitwise_xor.reduce(valid_data, axis=1, keepdims=True)


class DummyEncoder(RawErasureEncoder):
    """No-op coder emitting zero parity, for tests and benchmark floors
    (reference DummyRawEncoder.java)."""

    def do_encode(self, data: np.ndarray) -> np.ndarray:
        return np.zeros((data.shape[0], self.p, data.shape[2]), dtype=np.uint8)


class DummyDecoder(RawErasureDecoder):
    def do_decode(self, valid_data, valid, erased):
        return np.zeros(
            (valid_data.shape[0], len(erased), valid_data.shape[2]), dtype=np.uint8
        )
