"""RS(k, p) parity of whole stripes, plain PyTorch: every product a table
lookup, every sum an XOR."""

from __future__ import annotations

import torch

from portbench.reference import gf256


def encode(data: torch.Tensor, k: int, p: int) -> torch.Tensor:
    """parity uint8 [S, p, C] of data uint8 [S, k, C] (on any device)."""
    if data.dtype != torch.uint8 or data.dim() != 3 or data.shape[1] != k:
        raise ValueError(f"data must be uint8 [S, {k}, C], got "
                         f"{tuple(data.shape)} {data.dtype}")
    table = torch.from_numpy(gf256.mul_table()).to(data.device)
    matrix = gf256.parity_matrix(k, p)
    s, _, c = data.shape
    out = torch.zeros((s, p, c), dtype=torch.uint8, device=data.device)
    for j in range(k):
        idx = data[:, j].to(torch.int64)
        for i in range(p):
            out[:, i] ^= table[int(matrix[i, j])][idx]
    return out
