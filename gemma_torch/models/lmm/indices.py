"""Static index structure for the LMM Pab recurrences.

GEMMA stores all pairwise quantities a' P_p b in a flat vector indexed
by `GetabIndex(a, b, n_cvt)` (param.cpp:1400-1410), where columns
1..n_cvt are covariates, n_cvt+1 is the SNP genotype x, and n_cvt+2 is
the phenotype y.  The recurrence that eliminates covariate p reads, for
every pair (a,b), the row-(p-1) entries at (a,b), (a,p), (b,p), (p,p)
(lmm.cpp CalcPab:283-357).

All of this indexing is static given n_cvt, so we precompute numpy
gather tables once per covariate count; the device code then runs the
recurrence as pure gather/elementwise ops vectorised over the SNP batch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def ab_index(a: int, b: int, n_cvt: int) -> int:
    """GEMMA's GetabIndex: flat position of pair (a, b), 1-based labels."""
    cols = n_cvt + 2
    if b < a:
        a, b = b, a
    return (2 * cols - a + 2) * (a - 1) // 2 + (b - a)


def _ab_index_many(a: np.ndarray, p: int, cols: int) -> np.ndarray:
    """ab_index(a, p) for an array of labels a."""
    lo, hi = np.minimum(a, p), np.maximum(a, p)
    return (2 * cols - lo + 2) * (lo - 1) // 2 + (hi - lo)


def n_index(n_cvt: int) -> int:
    return (n_cvt + 3) * (n_cvt + 2) // 2


@dataclasses.dataclass(frozen=True)
class PabIndices:
    """Precomputed gather tables for a given n_cvt.

    Labels: 1..n_cvt = covariate columns, n_cvt+1 = x, n_cvt+2 = y.
    """

    n_cvt: int
    n_index: int
    pairs: tuple  # pair (a, b) for each flat index, in index order
    # per elimination step p (1..n_cvt+1): gather tables of len n_index
    aw: np.ndarray  # (n_cvt+1, n_index) index of (a, p)
    bw: np.ndarray  # (n_cvt+1, n_index) index of (b, p)
    ww: np.ndarray  # (n_cvt+1,) index of (p, p)
    # special positions
    yy: int
    xx: int
    xy: int
    diag: np.ndarray  # (n_cvt+1,) index of (i+1, i+1) for i = 0..n_cvt
    # base-row construction: which flat positions hold W/y-only pairs vs
    # x-involving pairs
    wy_positions: np.ndarray    # flat positions of pairs not involving x
    wy_pairs: tuple             # the (a, b) pairs at those positions
    xw_positions: np.ndarray    # flat positions of (x, j) for j=1..n_cvt and (x, y)
    xw_partners: np.ndarray     # partner label j (0-based col into [W|y])


@functools.lru_cache(maxsize=32)
def pab_indices(n_cvt: int) -> PabIndices:
    cols = n_cvt + 2
    x_lab = n_cvt + 1
    y_lab = n_cvt + 2
    nidx = n_index(n_cvt)

    pairs = [None] * nidx
    for a in range(1, cols + 1):
        for b in range(a, cols + 1):
            pairs[ab_index(a, b, n_cvt)] = (a, b)
    pairs = tuple(pairs)

    n_steps = n_cvt + 1
    aw = np.zeros((n_steps, nidx), dtype=np.int32)
    bw = np.zeros((n_steps, nidx), dtype=np.int32)
    ww = np.zeros((n_steps,), dtype=np.int32)
    la = np.array([a for a, _ in pairs])
    lb = np.array([b for _, b in pairs])
    for p in range(1, n_steps + 1):
        ww[p - 1] = ab_index(p, p, n_cvt)
        aw[p - 1] = _ab_index_many(la, p, cols)
        bw[p - 1] = _ab_index_many(lb, p, cols)

    wy_positions, wy_pairs = [], []
    xw_positions, xw_partners = [], []
    for k, (a, b) in enumerate(pairs):
        if a == x_lab and b == x_lab:
            continue  # handled separately (xx term)
        if x_lab in (a, b):
            j = b if a == x_lab else a  # the non-x partner label
            xw_positions.append(k)
            # partner column in [W | y]: covariate j-1, or n_cvt for y
            xw_partners.append(n_cvt if j == y_lab else j - 1)
        else:
            wy_positions.append(k)
            wy_pairs.append((a, b))

    diag = np.array([ab_index(i + 1, i + 1, n_cvt) for i in range(n_cvt + 1)],
                    dtype=np.int32)

    return PabIndices(
        n_cvt=n_cvt,
        n_index=nidx,
        pairs=pairs,
        aw=aw,
        bw=bw,
        ww=ww,
        yy=ab_index(y_lab, y_lab, n_cvt),
        xx=ab_index(x_lab, x_lab, n_cvt),
        xy=ab_index(x_lab, y_lab, n_cvt),
        diag=diag,
        wy_positions=np.array(wy_positions, dtype=np.int32),
        wy_pairs=tuple(wy_pairs),
        xw_positions=np.array(xw_positions, dtype=np.int32),
        xw_partners=np.array(xw_partners, dtype=np.int32),
    )
