"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (`portbench/reference/`).

The program's outputs are read back and handed to the reference only to
be judged: the datanodes' stored cells and CRC words of every
acknowledged key, the OM's committed size, the bytes a sample of GETs
returned, the parity and CRC words a sample of codec submissions got. The
reference works out what each should be from the seed's source bytes
alone. Every count below is an exact comparison, so its limit is 0.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from portbench.reference import crc32c, rs

#: every compared count's limit: an exact comparison
LIMIT = 0


def _expected_cells(seg: np.ndarray, k: int, p: int, cell: int, device):
    """(per unit: list of expected cell bytes in stripe order, the stripe
    data [S, k, C] and parity [S, p, C] on `device`) of one block group
    holding `seg`."""
    row = k * cell
    stripes = max(1, math.ceil(seg.size / row))
    padded = np.zeros(stripes * row, dtype=np.uint8)
    padded[:seg.size] = seg
    data = torch.from_numpy(padded.reshape(stripes, k, cell)).to(device)
    parity = rs.encode(data, k, p)
    lengths = np.clip(seg.size - (np.arange(stripes)[:, None] * k
                                  + np.arange(k)[None, :]) * cell, 0, cell)
    per_unit: list[list[tuple[int, int]]] = [[] for _ in range(k + p)]
    for s in range(stripes):
        for u in range(k):
            if lengths[s, u] > 0:
                per_unit[u].append((s, int(lengths[s, u])))
        for u in range(k, k + p):
            # a parity cell is as long as the stripe's first data cell
            per_unit[u].append((s, int(lengths[s, 0])))
    return per_unit, data, parity


def _crc_words(ref: torch.Tensor, full: np.ndarray, length: int,
               bpc: int) -> list[int]:
    """CRC32C words of the first `length` bytes of one cell, per slice:
    `full` holds the whole cell's words, which serve where the cell is
    whole; a shorter cell's are worked out byte by byte."""
    if length == ref.shape[-1]:
        return full.tolist()
    raw = ref[:length].cpu().numpy().tobytes()
    return [crc32c.crc32c(raw[i:i + bpc]) for i in range(0, length, bpc)]


def compare_key(info: dict | None, stored, source: np.ndarray, config: dict,
                device) -> Counter:
    """Counts of what differs between one key as the program stored it and
    the reference: `keys_missing`, `size_wrong`, `cells_wrong` (a cell
    missing, extra, or with other bytes), `crc_words_wrong` (a word
    missing, extra or other, or a chunk whose checksum is not the
    configuration's type and slice)."""
    out: Counter = Counter()
    if info is None:
        out["keys_missing"] += 1
        return out
    k, p = config["data_units"], config["parity_units"]
    cell, bpc = config["cell_bytes"], config["bytes_per_checksum"]
    if int(info["size"]) != source.size:
        out["size_wrong"] += 1
    off = 0
    for g, units in zip(info["block_groups"], stored):
        glen = int(g["length"])
        seg = source[off:off + glen]
        off += glen
        per_unit, data, parity = _expected_cells(seg, k, p, cell, device)
        full = crc32c.cell_crcs(torch.cat([data, parity], dim=1),
                                bpc).cpu().numpy()
        host = torch.cat([data, parity], dim=1).cpu().numpy()
        for u, expected in enumerate(per_unit):
            chunks = units[u] if u < len(units) else []
            out["cells_wrong"] += abs(len(chunks) - len(expected))
            for (s, length), chunk in zip(expected, chunks):
                ref = data[s, u] if u < k else parity[s, u - k]
                got = chunk["bytes"]
                if got.size != length or not np.array_equal(
                        got, host[s, u, :length]):
                    out["cells_wrong"] += 1
                words = _crc_words(ref, full[s, u], length, bpc)
                if chunk["type"] != config["checksum"] or chunk["bpc"] != bpc:
                    out["crc_words_wrong"] += len(words)
                    continue
                have = chunk["words"]
                out["crc_words_wrong"] += abs(len(have) - len(words)) + sum(
                    a != b for a, b in zip(have, words))
            for s, length in expected[len(chunks):]:
                out["crc_words_wrong"] += math.ceil(length / bpc)
    if len(stored) != len(info["block_groups"]):
        out["cells_wrong"] += abs(len(stored) - len(info["block_groups"]))
    return out


def stripes(data: np.ndarray, config: dict, device) -> torch.Tensor:
    """The whole stripes [S, k + p, C] of data [S, k, C], on `device`:
    the data units and the reference's parity."""
    d = torch.from_numpy(np.array(data)).to(device)
    return torch.cat([d, rs.encode(d, config["data_units"],
                                   config["parity_units"])], dim=1)


def reference_answer(data: np.ndarray, config: dict, device,
                     erased: list[int] | None = None) -> tuple:
    """What one codec submission over the stripes of `data` [S, k, C]
    must return: the parity (or, given `erased`, those units as they were
    before they were lost) and the CRC32C words of every unit the call
    covers (all k + p for an encode, the erased ones for a decode)."""
    k, bpc = config["data_units"], config["bytes_per_checksum"]
    whole = stripes(data, config, device)
    if erased:
        out = whole[:, list(erased)]
        words = crc32c.cell_crcs(out, bpc)
    else:
        out = whole[:, k:]
        words = crc32c.cell_crcs(whole, bpc)
    return out.cpu().numpy(), words.cpu().numpy().astype(np.uint32)


def compare_codec(units: np.ndarray, crcs: np.ndarray, data: np.ndarray,
                  config: dict, device, erased: list[int] | None = None,
                  ref: tuple | None = None) -> tuple[Counter, tuple]:
    """Counts of what differs between one codec submission's answer and the
    reference's (`reference_answer`): `unit_stripes_wrong` (stripes whose
    parity or recovered units have other bytes, or another shape) and
    `crc_words_wrong`. Returns (counts, the reference, for reuse on the
    same batch)."""
    if ref is None:
        ref = reference_answer(data, config, device, erased)
    ref_par, ref_words = ref
    out: Counter = Counter()
    parity = np.asarray(units)
    crcs = np.asarray(crcs)
    if parity.shape != ref_par.shape:
        out["unit_stripes_wrong"] += ref_par.shape[0]
    else:
        out["unit_stripes_wrong"] += int(
            (parity != ref_par).reshape(parity.shape[0], -1).any(axis=1).sum())
    if crcs.shape != ref_words.shape:
        out["crc_words_wrong"] += ref_words.size
    else:
        out["crc_words_wrong"] += int(
            (crcs.astype(np.uint32) != ref_words).sum())
    return out, ref


def compare_get(got: np.ndarray, source: np.ndarray) -> Counter:
    """`get_bytes_wrong`: 1 when a GET returned other bytes than the key
    holds (or another length)."""
    got = np.asarray(got)
    ok = got.size == source.size and np.array_equal(got.reshape(-1), source)
    return Counter({"get_bytes_wrong": 0 if ok else 1})
