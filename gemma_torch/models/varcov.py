"""Windowed SNP-SNP correlations (-calccor, -gw), with the band kernel K16.

GEMMA src/varcov.cpp; the reference is gemma_tpu/models/varcov.py.  For
each QC-passing SNP GEMMA computes its genotype variance and its
correlation with every following kept SNP inside a window bounded by base
pairs, centimorgans and/or SNP count (CalcNB, varcov.cpp:168-218;
Calc_Cor:220-241).  Output: one row per SNP with the window size, the
variance and the comma-joined correlation list.

Rows are mean-imputed, centred and unit-normalised on the host in float64
(as the reference), block by block with the reference's `block + bw`
carry, and the band of correlations is K16 on the device:

  K16 banded_cor  out[i, j] = <x_i, x_{i+j+1}>, j < bw, over the
                  normalised rows (csrc/banded_cor.cu): S bw n
                  multiply-adds where the reference forms the whole
                  (S, S + bw) product and keeps bw diagonals.
"""

from __future__ import annotations

import numpy as np
import torch

from gemma_torch import kernels


def calc_neighbours(chr_, pos, cM, window_bp, window_cm, window_ns):
    """Number of following in-window kept SNPs per SNP (CalcNB semantics
    on the kept subset, varcov.cpp:168-218).  Inputs are arrays over the
    kept SNPs in file order."""
    p = len(chr_)
    n_nb = np.zeros(p, dtype=np.int64)
    for t in range(p):
        if chr_[t] == "-9" or (cM[t] == -9 and window_cm != 0) or \
           (pos[t] == -9 and window_bp != 0):
            continue
        if t == p - 1:
            continue
        t2 = t + 1
        nb = 0
        while (t2 < p and chr_[t2] == chr_[t]
               and (window_cm == 0 or cM[t2] - cM[t] < window_cm)
               and (window_bp == 0 or pos[t2] - pos[t] < window_bp)
               and (window_ns == 0 or nb < window_ns)):
            t2 += 1
            nb += 1
        n_nb[t] = nb
    return n_nb


# rows correlated by one K16 launch on the streaming path (the reference's
# block)
BLOCK = 2048

# ---------------------------------------------------------------------------
# K16 banded_cor

def banded_cor_plain(X: torch.Tensor, S: int, bw: int) -> torch.Tensor:
    """PyTorch version of K16: (S, bw) with out[i, j] = <X[i], X[i+j+1]>
    over the rows X (R, n), 0 where i + j + 1 >= R."""
    R = X.shape[0]
    out = X.new_zeros((S, bw))
    for j in range(bw):
        k = min(S, R - j - 1)
        if k > 0:
            out[:k, j] = (X[:k] * X[j + 1:j + 1 + k]).sum(-1)
    return out


def banded_cor_cuda(X: torch.Tensor, S: int, bw: int) -> torch.Tensor:
    """K16 on the card (float32 or float64 rows and sums)."""
    R, n = X.shape
    kernels.check_operand(X, "X", X.dtype, (R, n))
    if not 0 <= S <= R:
        raise ValueError(f"banded_cor: {S} rows of {R}")
    kern = kernels.variant(kernels.BANDED_COR, kernels.BANDED_COR_F64,
                           X.dtype)
    out = torch.empty((S, bw), dtype=X.dtype, device=X.device)
    if S and bw:
        kern.launch(X.device, R, n, S, bw, X.data_ptr(), out.data_ptr())
    return out


def banded_cor(X: torch.Tensor, S: int, bw: int) -> torch.Tensor:
    """Correlations of the first S rows with their next bw rows (K16 on
    the card)."""
    fn = banded_cor_plain if X.device.type == "cpu" else banded_cor_cuda
    return fn(X, S, bw)


def windowed_correlations_fetch(fetch, p: int, n: int, n_nb: np.ndarray,
                                dtype: torch.dtype, device: torch.device,
                                block: int = BLOCK):
    """Streaming windowed correlations: `fetch(lo, hi)` returns raw dosage
    rows (NaN missing), called with monotone lo (one file scan on a
    streaming backend).  Only `block + bw` normalised rows are held at
    once (the reference's varcov.py:63-105).  Returns (var (p,), the list
    of per-SNP correlation arrays)."""
    bw = int(n_nb.max()) if len(n_nb) else 0
    var = np.zeros(p)
    cors = [np.zeros(0)] * p

    def _normalize(raw, lo, hi):
        miss = np.isnan(raw)
        mean = np.nanmean(np.where(miss, np.nan, raw), axis=1)
        Xc = np.where(miss, mean[:, None], raw) - mean[:, None]
        ss = np.einsum("ij,ij->i", Xc, Xc)
        var[lo:hi] = ss / n
        return Xc / np.sqrt(np.where(ss > 0, ss, 1.0))[:, None]

    if bw == 0:
        for s in range(0, p, block):
            e = min(s + block, p)
            _normalize(fetch(s, e), s, e)
        return var, cors

    carry = np.zeros((0, n))
    fetched = 0
    s = 0
    while s < p:
        e = min(s + block, p)
        hi = min(e + bw, p)
        if hi > fetched:
            new = _normalize(fetch(fetched, hi), fetched, hi)
            carry = np.vstack([carry, new]) if carry.size else new
            fetched = hi
        # carry holds the normalised rows [s, fetched)
        rows = torch.as_tensor(carry, dtype=dtype,
                               device=device).contiguous()
        band = banded_cor(rows, e - s, bw).to(torch.float64).cpu().numpy()
        for i in range(s, e):
            cors[i] = band[i - s, :int(n_nb[i])].copy()
        carry = carry[e - s:]
        s = e
    return var, cors


def write_cor(path: str, snp_rows: list, var, cors) -> None:
    """prefix.cor.txt (VARCOV::WriteCov layout, varcov.cpp:74-146)."""
    with open(path, "w") as fh:
        fh.write("chr\trs\tps\tn_mis\tn_obs\tallele1\tallele0\taf\t"
                 "window_size\tvar\tcor\n")
        for i, s in enumerate(snp_rows):
            fh.write(f"{s['chr']}\t{s['rs']}\t{s['ps']}\t{s['n_miss']}\t"
                     f"{s['n_obs']}\t{s['allele1']}\t{s['allele0']}\t"
                     f"{s['af']:.3f}\t{len(cors[i])}\t{var[i]:.6e}\t")
            if len(cors[i]) == 0:
                fh.write("NA")
            else:
                fh.write(",".join(f"{v:.6e}" for v in cors[i]))
            fh.write("\n")
