"""The least time one H100 could take for the fused encode and decode, and
the peaks it is counted against.

A frozen copy of `chip_smoke.py`'s `fused_bound`: each input byte read
once, each output byte and CRC word written once, against the HBM's
bandwidth; p GF multiply-adds per input byte plus one CRC step per byte of
each CRC'd row, against the int8 peak. The larger of the two times bounds
the call. It counts the work the shapes need (the stripes a submitter
asked for, not the rows a lane pads them to), whatever implements it.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12


def fused_bound(b: int, k: int, p: int, cell: int, bpc: int,
                rows: int | None = None) -> tuple[float, str]:
    """(least seconds, what bounds it) for one fused pass over [b, k, cell]
    that writes p output rows and CRCs `rows` rows (k + p for encode, the
    p recovered rows for decode)."""
    rows = k + p if rows is None else rows
    moved = b * k * cell + b * p * cell + b * rows * (cell // bpc) * 4
    ops = b * cell * (2 * k * p + rows)
    t_bytes, t_ops = moved / HBM_BYTES_S, ops / INT8_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
