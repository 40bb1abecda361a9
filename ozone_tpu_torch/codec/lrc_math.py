"""Locally-repairable code (LRC) coding matrices and repair planning.

Port of `ozone_tpu/codec/lrc_math.py`. Scheme family after Azure
Storage's LRC (Huang et al., USENIX ATC '12): the k data units are split
into l equal local groups; each group gets one XOR local parity, and r
global Cauchy parities cover all k data units. The string form is
"lrc-k-l-r[-cell]", e.g. lrc-12-2-2 = 12 data units in 2 groups of 6,
2 local parities, 2 global parities (n = 16, overhead 1.33x against
RS(6,3)'s 1.5x).

Unit layout (index order on the wire and in block groups):

    [0, k)          data units
    [k, k+l)        local parities (one per group, XOR of its group)
    [k+l, k+l+r)    global parities (Cauchy rows over all data units)

All l+r parity rows stack into one (l+r) x k generator, so the fused
encode+CRC kernel (codec/fused.py) emits every parity in a single launch.

The repair win: a single lost unit inside a group is the XOR of its
group's survivors, so repair reads group_size units instead of k. The
planner classifies an erasure pattern and returns the minimal read set;
the general recovery solver produces an exact GF(2^8) recovery matrix
over any spanning read set (len(valid) need not equal k, unlike plain
RS), which the fused decode applies as its runtime matrix.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

from ozone_tpu_torch.codec import gf256
from ozone_tpu_torch.codec.api import CoderOptions


def geometry(options: CoderOptions) -> tuple[int, int, int, int]:
    """Validated (k, l, r, group_size) for an lrc CoderOptions."""
    if options.codec != "lrc":
        raise ValueError(f"not an lrc config: {options}")
    k, l = options.data_units, options.local_groups
    r = options.parity_units - l
    if l < 1 or r < 1 or k % l != 0:
        raise ValueError(f"bad LRC geometry {options}")
    return k, l, r, k // l


def group_of(options: CoderOptions, unit: int) -> Optional[int]:
    """Group index of a data or local-parity unit; None for globals."""
    k, l, _r, gs = geometry(options)
    if unit < k:
        return unit // gs
    if unit < k + l:
        return unit - k
    return None


def group_scope(options: CoderOptions, group: int) -> list[int]:
    """All unit indexes participating in one local group: its
    group_size data units plus its local parity."""
    k, l, _r, gs = geometry(options)
    if not 0 <= group < l:
        raise ValueError(f"group {group} out of range for {options}")
    return list(range(group * gs, (group + 1) * gs)) + [k + group]


def parity_matrix(options: CoderOptions) -> np.ndarray:
    """(l+r) x k stacked generator: l XOR indicator rows (one per local
    group) on top of r global Cauchy rows gf_inv((k+l+i) ^ j). One
    matrix, one fused launch for all parities."""
    k, l, r, gs = geometry(options)
    m = np.zeros((l + r, k), dtype=np.uint8)
    for g in range(l):
        m[g, g * gs:(g + 1) * gs] = 1
    rows = np.arange(k + l, k + l + r, dtype=np.int64)[:, None]
    cols = np.arange(k, dtype=np.int64)[None, :]
    m[l:] = gf256.gf_inv((rows ^ cols).astype(np.uint8))
    return m


def encode_matrix(options: CoderOptions) -> np.ndarray:
    """Full n x k generator (identity on top of parity_matrix): row u is
    unit u as a GF(2^8)-linear function of the k data units."""
    k = options.data_units
    return np.vstack([np.eye(k, dtype=np.uint8), parity_matrix(options)])


def _gf_solve(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """Solve a @ x = b over GF(2^8) by Gauss-Jordan; a is [m, nvars]
    (nvars need NOT equal m).  Free variables are set to 0 so redundant
    read-set columns fall out with zero coefficients.  Returns None when
    the system is inconsistent (read set does not span the target)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    m, nvars = a.shape
    aug = np.concatenate([a, b[:, None]], axis=1).astype(np.uint8)
    pivots: list[int] = []
    row = 0
    for col in range(nvars):
        if row == m:
            break
        nz = np.nonzero(aug[row:, col])[0]
        if nz.size == 0:
            continue
        j = row + int(nz[0])
        if j != row:
            aug[[row, j]] = aug[[j, row]]
        aug[row] = gf256.gf_mul(aug[row], gf256.gf_inv(aug[row, col]))
        for rr in range(m):
            if rr != row and aug[rr, col]:
                aug[rr] ^= gf256.gf_mul(aug[rr, col], aug[row])
        pivots.append(col)
        row += 1
    if np.any(aug[row:, -1]):
        return None
    x = np.zeros(nvars, dtype=np.uint8)
    for i, col in enumerate(pivots):
        x[col] = aug[i, -1]
    return x


@lru_cache(maxsize=1024)
def _recovery_rows_cached(options: CoderOptions, valid: tuple,
                          erased: tuple) -> np.ndarray:
    enc = encode_matrix(options)
    a = enc[np.asarray(valid, dtype=np.int64)].T  # [k, len(valid)]
    rows = np.zeros((len(erased), len(valid)), dtype=np.uint8)
    for i, e in enumerate(erased):
        x = _gf_solve(a, enc[e])
        if x is None:
            raise ValueError(
                f"units {list(valid)} cannot reconstruct unit {e} "
                f"for {options}")
        rows[i] = x
    return rows


def recovery_rows(options: CoderOptions, valid: Sequence[int],
                  erased: Sequence[int]) -> np.ndarray:
    """len(erased) x len(valid) recovery matrix over an ARBITRARY read
    set: output[i] = XOR_j gf_mul(rows[i, j], unit[valid[j]]) rebuilds
    unit erased[i].  Unlike rs_math.decode_matrix, len(valid) may be
    smaller than k (a local-group read) or larger (an over-complete set
    whose redundant columns solve to 0)."""
    rows = _recovery_rows_cached(
        options, tuple(int(v) for v in valid), tuple(int(e) for e in erased))
    return rows.copy()


def plan_valid(
    options: CoderOptions,
    erased: Sequence[int],
    available: Sequence[int],
    prefer: Optional[Sequence[int]] = None,
) -> tuple[list[int], str]:
    """Classify an erasure pattern and return (read_set, kind).

    kind == "local": every erasure sits in a distinct local group (no
    global parity lost) and each affected group's other members all
    survive — the read set is the union of affected-group survivors,
    group_size units per lost unit instead of k.

    kind == "global": anything else decodable — the read set starts
    from the first k preferred survivors, grows until the recovery
    system is solvable, then drops columns every recovery row ignores.

    `prefer` orders the candidate survivors for the global path (e.g.
    topology-nearest first); the local read set is forced by geometry.
    Raises ValueError when the pattern is not recoverable from
    `available`.
    """
    k, l, _r, _gs = geometry(options)
    n = options.all_units
    erased_set = {int(e) for e in erased}
    avail = [int(u) for u in (prefer if prefer is not None
                              else sorted(available))]
    avail = [u for u in avail if u in set(int(a) for a in available)
             and u not in erased_set]
    # -- local path: one erasure per group, no global parity lost
    if all(e < k + l for e in erased_set):
        by_group: dict[int, list[int]] = {}
        for e in erased_set:
            g = group_of(options, e)
            by_group.setdefault(g, []).append(e)
        if all(len(v) == 1 for v in by_group.values()):
            reads: set[int] = set()
            avail_set = set(avail)
            for g, lost in by_group.items():
                need = [u for u in group_scope(options, g)
                        if u not in erased_set]
                if not all(u in avail_set for u in need):
                    break
                reads.update(need)
            else:
                return sorted(reads), "local"
    # -- global fallback: grow a spanning set, then prune dead columns
    if len(avail) < min(k, n - len(erased_set)):
        raise ValueError(
            f"cannot recover {sorted(erased_set)}: only {len(avail)} "
            f"surviving units for {options}")
    sel = avail[:k]
    rest = avail[k:]
    target = sorted(erased_set)
    while True:
        try:
            rows = recovery_rows(options, sel, target)
            break
        except ValueError:
            if not rest:
                raise ValueError(
                    f"cannot recover {target} from units {avail} "
                    f"for {options}") from None
            sel.append(rest.pop(0))
    used = np.any(rows != 0, axis=0)
    valid = [u for u, keep in zip(sel, used) if keep]
    if not valid:  # degenerate (never for real generators) — keep one
        valid = sel[:1]
    return valid, "global"


def repair_read_units(options: CoderOptions, erased: Sequence[int]) -> int:
    """Units read to repair `erased` with all other units healthy: the
    repair-economics number of a scheme."""
    valid, _kind = plan_valid(
        options, erased,
        [u for u in range(options.all_units) if u not in set(erased)])
    return len(valid)
