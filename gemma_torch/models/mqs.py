"""MQS: summary-statistics variance-component estimation (-gs, -gq, -vc
with -beta or -study/-ref).

GEMMA's MQS estimator (Zhou 2016); the reference is
gemma_tpu/models/mqs.py, after vc.cpp (CalcVCss:1309-1501), gemma_io.cpp
(ReadFile_beta:3363-3551, Calcq:3716-3960, BimbamKinUncentered:2753-2945)
and param.cpp (compAKtoS:1325-1378, JackknifeAKtoS:1596-1715,
CalcS:1717-1809).

Summary z-scores give the q vector, with its block-jackknife variance Vq
(host numpy, as in the reference); reference genotypes give the S matrix
tr(Kc_i Kc_j) relating per-category kinships, with its leave-one-
individual-out jackknife variance Svar; then pve solves S pve = q.

On the device:
  * category_kinship_fetch — kernel K1's centre mode on each genotype
    block (ops/pack2.prologue), W projected out (`torch.linalg.solve` and
    a product), the scale sqrt(w/var), one `addmm_` per category into an
    (n_vc, n, n) stack, in the run's precision;
  * ak_to_s — from the finished stacks on, float64 in both precisions:
    centring and scaling, one K15 pass (vc.pair_colsum) for the
    column sums of every pair's Hadamard product A_i∘K_j, batched
    matrix-vector products for K_j rA_i and A_i rK_j, and n-vector algebra
    for the jackknife's d_t.  The reference forms an n×n temporary for
    each pair; here its column sums are

      Σ_l (rA_l − A_lt)(rK_l − K_lt) = rA·rK − (K_jᵀ rA)_t − (A_iᵀ rK)_t
                                       + colsum(A_i∘K_j)_t

    with rA, rK the row sums, and tr_t(A K) = tot − 2 colsum_t + A_tt K_tt
    (the stacks are symmetric, so row and column sums of A_i∘K_j agree).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.stats
import torch

from gemma_torch.io.readers import _open_text
from gemma_torch.models import vc
from gemma_torch.ops.center import center_matrix, scale_matrix
from gemma_torch.ops.pack2 import CENTRE, prologue

_F64 = torch.float64


# ---------------------------------------------------------------------------
# header-driven summary-stat reader

_HDR = {
    "rs": {"rs", "RS", "snp", "SNP", "snps", "SNPS", "snpid", "SNPID",
           "rsid", "RSID", "MarkerName"},
    "chr": {"chr", "CHR"},
    "pos": {"ps", "PS", "pos", "POS", "base_position", "BASE_POSITION",
            "bp", "BP"},
    "cm": {"cm", "CM"},
    "a1": {"a1", "A1", "allele1", "ALLELE1", "Allele1", "INC_ALLELE"},
    "a0": {"a0", "A0", "allele0", "ALLELE0", "Allele0", "a2", "A2",
           "allele2", "ALLELE2", "Allele2", "DEC_ALLELE"},
    "z": {"z", "Z", "z_score", "Z_SCORE", "zscore", "ZSCORE"},
    "beta": {"beta", "BETA", "b", "B"},
    "sebeta": {"se_beta", "SE_BETA", "se", "SE"},
    "chisq": {"chisq", "CHISQ", "chisquare", "CHISQUARE"},
    "p": {"p", "P", "pvalue", "PVALUE", "p-value", "P-VALUE"},
    "n": {"n", "N", "ntotal", "NTOTAL", "n_total", "N_TOTAL"},
    "nmis": {"nmis", "NMIS", "n_mis", "N_MIS", "n_miss", "N_MISS"},
    "nobs": {"nobs", "NOBS", "n_obs", "N_OBS"},
    "ncase": {"ncase", "NCASE", "n_case", "N_CASE"},
    "ncontrol": {"ncontrol", "NCONTROL", "n_control", "N_CONTROL"},
    "af": {"af", "AF", "maf", "MAF", "f", "F", "allele_freq",
           "ALLELE_FREQ", "allele_frequency", "ALLELE_FREQUENCY"},
    "var": {"var", "VAR"},
    "ws": {"window_size", "WINDOW_SIZE", "ws", "WS"},
    "cor": {"cor", "COR", "r", "R"},
}


def parse_header(line: str) -> dict:
    """Column-name → 1-based position map (ReadHeader_io semantics)."""
    cols = line.replace(",", " ").split()
    out = {"coln": len(cols)}
    for i, tok in enumerate(cols):
        for key, names in _HDR.items():
            if tok in names and key not in out:
                out[key] = i + 1
    return out


@dataclasses.dataclass
class BetaSummary:
    cat: np.ndarray      # (m,) category index
    ni: np.ndarray       # (m,) per-SNP sample size
    weight: np.ndarray   # (m,)
    z2: np.ndarray       # (m,)
    rs: list
    ni_total: int        # max sample size
    ns_total: int
    ns_test: int


def read_beta_summary(path: str, rs2cat: dict | None = None,
                      rs2w: dict | None = None) -> BetaSummary:
    """ReadFile_beta (gemma_io.cpp:3363-3551): z^2 from z, beta/se,
    chisq, or p columns; sample size from n or nmis+nobs or
    ncase+ncontrol."""
    cat, ni, weight, z2, rs_list = [], [], [], [], []
    ni_total = ns_total = ns_test = 0
    with _open_text(path) as fh:
        hdr = parse_header(fh.readline())
        for line in fh:
            parts = line.replace(",", " ").split()
            if not parts:
                continue

            def get(key, cast=float, default=0):
                c = hdr.get(key, 0)
                return cast(parts[c - 1]) if c else default

            rs = get("rs", str, "")
            if not rs:
                rs = f"{get('chr', str, '')}:{get('pos', str, '')}"
            n_total = int(get("n", float))
            if hdr.get("n", 0) == 0:
                if hdr.get("nmis", 0) and hdr.get("nobs", 0):
                    n_total = int(get("nmis", float) + get("nobs", float))
                else:
                    n_total = int(get("ncase", float) +
                                  get("ncontrol", float))

            if hdr.get("z", 0):
                zsq = get("z") ** 2
            elif hdr.get("beta", 0) and hdr.get("sebeta", 0):
                zsq = (get("beta") / get("sebeta")) ** 2
            elif hdr.get("chisq", 0):
                zsq = get("chisq")
            elif hdr.get("p", 0):
                zsq = scipy.stats.chi2.isf(get("p"), 1)
            else:
                zsq = 0.0

            ns_total += 1
            if ((rs2w is None or rs in rs2w)
                    and (rs2cat is None or rs in rs2cat) and zsq != 0):
                cat.append(rs2cat[rs] if rs2cat else 0)
                ni.append(n_total)
                weight.append(rs2w[rs] if rs2w else 1.0)
                z2.append(zsq)
                rs_list.append(rs)
                ni_total = max(ni_total, n_total)
                ns_test += 1

    return BetaSummary(
        cat=np.asarray(cat, np.int64), ni=np.asarray(ni, np.int64),
        weight=np.asarray(weight), z2=np.asarray(z2), rs=rs_list,
        ni_total=ni_total, ns_total=ns_total, ns_test=ns_test)


def read_categories(path: str):
    """-cat file: header + per-SNP 0/1 membership columns
    (ReadFile_cat, gemma_io.cpp:2634-2719).  Returns (rs2cat, n_vc)."""
    rs2cat = {}
    with _open_text(path) as fh:
        hdr = parse_header(fh.readline())
        meta_cols = sum(1 for k in ("rs", "chr", "pos", "cm", "a1", "a0")
                        if hdr.get(k, 0))
        n_vc = hdr["coln"] - meta_cols
        meta_pos = {hdr[k] for k in ("rs", "chr", "pos", "cm", "a1", "a0")
                    if hdr.get(k, 0)}
        for line in fh:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            rs = parts[hdr["rs"] - 1] if hdr.get("rs", 0) else \
                f"{parts[hdr['chr'] - 1]}:{parts[hdr['pos'] - 1]}"
            i_cat = 0
            for i, tok in enumerate(parts):
                if (i + 1) in meta_pos:
                    continue
                if tok in ("0", "1"):
                    if tok == "1" and rs not in rs2cat:
                        rs2cat[rs] = i_cat
                    i_cat += 1
    return rs2cat, n_vc


# ---------------------------------------------------------------------------
# q vector with block-jackknife variance (Calcq, gemma_io.cpp:3716-3960)

def calcq(n_block: int, cat, ni, weight, z2, n_vc: int):
    """Returns (Vq, q, s)."""
    cat = np.asarray(cat)
    ni = np.asarray(ni, np.float64)
    weight = np.asarray(weight, np.float64)
    z2 = np.asarray(z2, np.float64)

    vec_q = np.zeros(n_vc)
    vec_s = np.zeros(n_vc)
    n_snps = np.zeros(n_vc)
    np.add.at(vec_q, cat, (z2 - 1.0) * weight / ni)
    np.add.at(vec_s, cat, weight)
    np.add.at(n_snps, cat, 1.0)

    q = np.where(vec_s != 0, vec_q / np.where(vec_s != 0, vec_s, 1), 0.0)
    s = vec_s.copy()

    Vq = np.zeros((n_vc, n_vc))
    for l in range(n_vc):
        n_snp = int(n_snps[l] // n_block)
        if n_snp == 0:
            continue
        # assign block ids: the l'th category's SNPs advance the block
        # counter; other categories accumulate into the current block
        mat_q = np.zeros((n_block, n_vc))
        mat_s = np.zeros((n_block, n_vc))
        b = 0
        t = 0
        for i in range(len(cat)):
            c = cat[i]
            mat_q[b, c] += (z2[i] - 1.0) * weight[i]
            mat_s[b, c] += weight[i]
            if c == l:
                if b < n_block - 1:
                    if t < n_snp - 1:
                        t += 1
                    else:
                        b += 1
                        t = 0
                else:
                    t += 1

        # delete-block estimates, centered; entries failing the
        # validity check keep their raw accumulated value
        # (gemma_io.cpp:3813-3833)
        for i in range(n_vc):
            valid = (mat_s[:, i] != 0) & (vec_s[i] != mat_s[:, i])
            dvals = np.zeros(n_block)
            dvals[valid] = ((vec_q[i] - mat_q[valid, i]) /
                            (vec_s[i] - mat_s[valid, i]))
            mat_q[:, i] = np.where(valid, dvals, mat_q[:, i])
            m = dvals[valid].mean() if valid.any() else 0.0
            nz = mat_q[:, i] != 0
            mat_q[nz, i] -= m

        for i in range(n_vc):
            both = (mat_q[:, l] != 0) & (mat_q[:, i] != 0)
            nn = int(both.sum())
            d = 0.0
            if nn:
                d = (mat_q[both, l] * mat_q[both, i]).sum() / nn * (nn - 1)
            Vq[i, l] += d
            if i != l:
                Vq[l, i] = Vq[i, l]

    # halve off-diagonals (gemma_io.cpp:3943-3953)
    off = ~np.eye(n_vc, dtype=bool)
    Vq[off] /= 2.0
    return Vq, q, s


# ---------------------------------------------------------------------------
# per-category reference kinships (BimbamKinUncentered semantics)

def category_kinship_fetch(fetch, p: int, n: int, W, cats: np.ndarray,
                           n_vc: int, weights: np.ndarray | None = None,
                           block: int = 4096,
                           dtype: torch.dtype = _F64,
                           device: str | torch.device = "cuda"):
    """Weighted, W-projected, variance-standardized (uncentered)
    per-category kinships (gemma_io.cpp:2797-2928), streamed:
    `fetch(lo, hi)` returns the raw genotype rows [lo, hi) of the p-SNP
    set on `device`, in any wire K1 reads ((k, ceil(n/4)) packed uint8,
    int8 with -1 missing, or float with NaN missing).  cats: (p,)
    category per SNP (-1 = excluded).  Peak memory is one block plus
    the (n_vc, n, n) stack, which accumulates in `dtype`.

    Returns (K (n_vc, n, n) float64 on `device`, ns (n_vc,))."""
    dev = torch.device(device)
    Wd = torch.as_tensor(np.asarray(W), dtype=dtype, device=dev)
    WtWi_Wt = torch.linalg.solve(Wd.T @ Wd, Wd.T)          # (c, n)
    w_all = torch.as_tensor(np.ones(p) if weights is None
                            else np.asarray(weights, np.float64),
                            dtype=dtype, device=dev)
    cats_d = torch.as_tensor(np.asarray(cats, np.int64), device=dev)
    K = torch.zeros((n_vc, n, n), dtype=dtype, device=dev)
    ns = np.zeros(n_vc, dtype=np.int64)
    for s in range(0, p, block):
        e = min(s + block, p)
        # missing → 0 after centring: the reference's mean imputation
        x = prologue(fetch(s, e), n, CENTRE, dtype=dtype)
        x = x - (x @ WtWi_Wt.T) @ Wd.T                     # project W out
        var = (x * x).sum(dim=1) / n
        cb = cats_d[s:e]
        ok = (var != 0) & (cb >= 0)
        one = torch.ones_like(var)
        scale = torch.where(ok, torch.sqrt(torch.where(
            ok, w_all[s:e] / torch.where(var != 0, var, one),
            torch.zeros_like(var))), torch.zeros_like(var))
        x = x * scale[:, None]
        for c in range(n_vc):
            sel = torch.nonzero(ok & (cb == c)).squeeze(1)
            k = int(sel.numel())
            if k:
                Xd = x.index_select(0, sel)
                K[c].addmm_(Xd.T, Xd)
                ns[c] += k
    K = K.to(_F64)
    for c in range(n_vc):
        if ns[c]:
            K[c] /= ns[c]
    return K, ns


def _array_fetch(X_raw):
    X = torch.as_tensor(np.asarray(X_raw, np.float64))
    return lambda lo, hi: X[lo:hi]


def category_kinship(X_raw: np.ndarray, W: np.ndarray, cats: np.ndarray,
                     n_vc: int, weights: np.ndarray | None = None,
                     dtype: torch.dtype = _F64,
                     device: str | torch.device = "cuda"):
    """category_kinship_fetch over a (p, n) dosage array (NaN missing),
    held on the host and passed to the device a block at a time."""
    p, n = np.shape(X_raw)
    fetch = _array_fetch(X_raw)
    dev = torch.device(device)
    return category_kinship_fetch(
        lambda lo, hi: fetch(lo, hi).to(dev), p, n, W, cats, n_vc, weights,
        dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# S matrix + jackknife variance, float64 from the finished stacks on

def center_scale(K: torch.Tensor) -> torch.Tensor:
    """scale_matrix(center_matrix(·)) of each matrix of a stack, float64."""
    return torch.stack([scale_matrix(center_matrix(Ki.to(_F64)))
                        for Ki in K])


@dataclasses.dataclass
class _PairSums:
    """What compAKtoS and JackknifeAKtoS read of each pair (i, j)."""
    C: torch.Tensor       # (m, m, n) column sums of A_i∘K_j (K15)
    rA: torch.Tensor      # (m, n) row sums of A_i
    rK: torch.Tensor      # (m, n) row sums of K_j
    dA: torch.Tensor      # (m, n) diagonals
    dK: torch.Tensor


def _pair_sums(A: torch.Tensor, K: torch.Tensor) -> _PairSums:
    A, K = A.to(_F64), K.to(_F64)
    return _PairSums(C=vc.pair_colsum(A, K), rA=A.sum(dim=2), rK=K.sum(dim=2),
                     dA=torch.diagonal(A, dim1=1, dim2=2),
                     dK=torch.diagonal(K, dim1=1, dim2=2))


def comp_ak_to_s(A: torch.Tensor, K: torch.Tensor, n_cvt: int,
                 sums: _PairSums | None = None) -> np.ndarray:
    """S_ij from centered+scaled kinship stacks (compAKtoS,
    param.cpp:1325-1378).  A, K: (n_vc, n, n); `sums` reuses a pass."""
    ps = sums or _pair_sums(A, K)
    n = A.shape[-1]
    tr_AK = ps.C.sum(dim=-1)                              # (m, m)
    sum_A = ps.rA.sum(dim=1) / n
    sum_K = ps.rK.sum(dim=1) / n
    sum_AK = (ps.rA @ ps.rK.T) / n
    tr_A = ps.dA.sum(dim=1) - sum_A
    tr_K = ps.dK.sum(dim=1) - sum_K
    d = tr_AK - 2 * sum_AK + sum_A[:, None] * sum_K[None, :]
    zero = (tr_A == 0)[:, None] | (tr_K == 0)[None, :]
    S = torch.where(zero, torch.zeros_like(d),
                    d / (tr_A[:, None] * tr_K[None, :]) - 1.0 / (n - n_cvt))
    return S.cpu().numpy()


def jackknife_ak_to_s(A: torch.Tensor, K: torch.Tensor, n_cvt: int,
                      S: np.ndarray, sums: _PairSums | None = None):
    """Leave-one-individual-out jackknife of the S statistic
    (JackknifeAKtoS, param.cpp:1596-1715).  Returns (S_corrected, Svar).
    Vectorised over the left-out individual t and the pairs (i, j)."""
    ps = sums or _pair_sums(A, K)
    A, K = A.to(_F64), K.to(_F64)
    n = A.shape[-1]
    rA, rK, dA, dK = ps.rA, ps.rK, ps.dA, ps.dK
    sumA_t = (rA.sum(dim=1, keepdim=True) - 2 * rA + dA) / (n - 1)
    trA_t = dA.sum(dim=1, keepdim=True) - dA
    sumK_t = (rK.sum(dim=1, keepdim=True) - 2 * rK + dK) / (n - 1)
    trK_t = dK.sum(dim=1, keepdim=True) - dK

    # [i, j, t] layout; tr_t(A_i K_j) from the column sums
    trAK_t = (ps.C.sum(dim=-1, keepdim=True) - 2 * ps.C
              + dA[:, None, :] * dK[None, :, :])
    KtrA = torch.matmul(K.transpose(1, 2), rA.T)          # [j, t, i]
    AtrK = torch.matmul(A.transpose(1, 2), rK.T)          # [i, t, j]
    Psum = ((rA @ rK.T)[:, :, None] - KtrA.permute(2, 0, 1)
            - AtrK.permute(0, 2, 1) + ps.C)
    Pdiag = (rA - dA)[:, None, :] * (rK - dK)[None, :, :]
    sumAK_t = (Psum - Pdiag) / (n - 1)

    denA = (trA_t - sumA_t)[:, None, :]
    denK = (trK_t - sumK_t)[None, :, :]
    d_t = trAK_t - 2 * sumAK_t + sumA_t[:, None, :] * sumK_t[None, :, :]
    good = (denA != 0) & (denK != 0)
    d_t = torch.where(good, d_t / torch.where(good, denA * denK,
                                              torch.ones_like(d_t))
                      - 1.0 / (n - n_cvt - 1), torch.zeros_like(d_t))
    # the variance in two passes: the reference's mean(d²) - mean(d)²
    # cancels, and at n = 1,940 a float64 rounding of the stacks moves
    # its Svar by 2e-7 relative, this form's by 1e-13 (ROADMAP §C19)
    m = d_t.mean(dim=-1)
    v = ((d_t - m[..., None]) ** 2).mean(dim=-1)
    Svar = (v * (n - 1)).cpu().numpy()
    S_out = np.array(S, dtype=np.float64, copy=True)
    if n_cvt == 1:
        S_out = n * S_out - (n - 1) * m.cpu().numpy()
    return S_out, Svar


def ak_to_s(A: torch.Tensor, K: torch.Tensor, n_cvt: int):
    """comp_ak_to_s then jackknife_ak_to_s on one pass of K15."""
    sums = _pair_sums(A, K)
    S = comp_ak_to_s(A, K, n_cvt, sums)
    return jackknife_ak_to_s(A, K, n_cvt, S, sums)


def calc_s_fetch(fetch, p: int, W: np.ndarray, cats: np.ndarray,
                 n_vc: int, weights: np.ndarray | None = None,
                 weights_a: np.ndarray | None = None,
                 dtype: torch.dtype = _F64,
                 device: str | torch.device = "cuda", block: int = 4096):
    """CalcS (param.cpp:1717-1809), streamed through `fetch` (see
    category_kinship_fetch): per-category kinships → centre + scale → S
    and jackknife Svar.  Returns (S, Svar, ns).

    `weights` builds the K stack (mapRS2wK); `weights_a`, when given,
    builds a separately-weighted A stack (mapRS2wA, the LDSC second
    pass of -vc 2 with summary stats) — otherwise A = K."""
    n = np.shape(W)[0]
    Kstack, ns = category_kinship_fetch(fetch, p, n, W, cats, n_vc, weights,
                                        block, dtype, device)
    Kc = center_scale(Kstack)
    del Kstack
    if weights_a is None:
        Ac = Kc
    else:
        Astack, _ = category_kinship_fetch(fetch, p, n, W, cats, n_vc,
                                           weights_a, block, dtype, device)
        Ac = center_scale(Astack)
    S, Svar = ak_to_s(Ac, Kc, np.shape(W)[1])
    return S, Svar, ns


def calc_s(X_raw: np.ndarray, W: np.ndarray, cats: np.ndarray, n_vc: int,
           weights: np.ndarray | None = None,
           weights_a: np.ndarray | None = None,
           dtype: torch.dtype = _F64, device: str | torch.device = "cuda"):
    """calc_s_fetch over a (p, n) dosage array (NaN missing)."""
    p = np.shape(X_raw)[0]
    fetch = _array_fetch(X_raw)
    dev = torch.device(device)
    return calc_s_fetch(lambda lo, hi: fetch(lo, hi).to(dev), p, W, cats,
                        n_vc, weights, weights_a, dtype, dev)


# ---------------------------------------------------------------------------
# solve S pve = q (CalcVCss, vc.cpp:1309-1501)

@dataclasses.dataclass
class MqsResult:
    pve: np.ndarray
    se_pve: np.ndarray
    sigma2persnp: np.ndarray
    se_sigma2persnp: np.ndarray
    enrich: np.ndarray
    se_enrich: np.ndarray
    pve_total: float
    se_pve_total: float


def calc_vc_ss(Vq, S, Svar, q, s, df) -> MqsResult:
    n_vc = S.shape[0]
    Si = np.linalg.inv(S)
    pve = Si @ q
    sigma2persnp = pve / s

    qvar = Vq / (df * df)
    Var = Svar * np.outer(pve, pve) + qvar
    Var = Si @ Var @ Si

    se_pve = np.sqrt(np.diag(Var))
    se_sigma2persnp = se_pve / s

    pve_total = float(pve.sum())
    se_pve_total = float(np.sqrt(Var.sum()))

    s_pve = pve.sum()
    s_snp = s.sum()
    enrich = sigma2persnp * (s_snp / s_pve)

    T = np.empty((n_vc, n_vc))
    for i in range(n_vc):
        d = pve[i] / s_pve
        for j in range(n_vc):
            if i == j:
                T[i, j] = (1 - d) / s[i] * s_snp / s_pve
            else:
                T[i, j] = -d / s[i] * s_snp / s_pve
    VarEnrich = T @ Var @ T.T
    se_enrich = np.sqrt(np.diag(VarEnrich))

    return MqsResult(pve=pve, se_pve=se_pve, sigma2persnp=sigma2persnp,
                     se_sigma2persnp=se_sigma2persnp, enrich=enrich,
                     se_enrich=se_enrich, pve_total=pve_total,
                     se_pve_total=se_pve_total)
