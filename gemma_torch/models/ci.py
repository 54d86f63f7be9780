"""Confidence intervals for MQS variance-component estimates (-ci 1/2).

GEMMA's a_mode 66/67 block of GEMMA::BatchRun (gemma.cpp:2400-2560) with
CalcCIss (vc.cpp:2727-2963) and the weight plumbing of PARAM
(ObtainWeight param.cpp:2214, UpdateWeight :2300, UpdateSNPnZ :2353);
the reference is gemma_tpu/models/ci.py.

Given a previous -vc point estimate (-pve), a reference panel S matrix
(-ref/-mref) and the study z-scores (-beta), the sampling variance of
the q vector is rebuilt from the genotype passes

    Xz[:, k]    = sum_{s in cat k} z_s x_s          (BimbamXwz, w = 1)
    XWz[:, k]   = sum_{s in cat k} w_s z_s x_s      (w = LDSC weights,
                                                     mode 67 only)
    XtXWz[s, k] = x_s' XWz[:, k]                    (BimbamXtXwz)

with x_s the mean-imputed, centred, 1/sd-scaled genotype row
(vc.cpp:2259-2297): kernel K1's standardised form (ops/pack2.prologue,
centre mode with scale and n_total = n).  On the device Xz and XWz are
`addmm_` over genotype blocks; XtXWz = Xs @ XWz is a second pass, since
it needs the finished XWz.  Readers, weights and CalcCIss's n_vc × n_vc
algebra run on the host in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gemma_torch.io.readers import _open_text
from gemma_torch.models.mqs import parse_header
from gemma_torch.ops.pack2 import CENTRE, prologue

_F64 = torch.float64


# ---------------------------------------------------------------------------
# file readers

def _rs_of(parts, hdr) -> str:
    return parts[hdr["rs"] - 1] if hdr.get("rs", 0) else \
        f"{parts[hdr['chr'] - 1]}:{parts[hdr['pos'] - 1]}"


def read_wsnp(path: str) -> dict:
    """-wsnp: `rs weight` pairs (ReadFile_wsnp, gemma_io.cpp:3255)."""
    out = {}
    with _open_text(path) as fh:
        for line in fh:
            parts = line.replace(",", " ").split()
            if len(parts) >= 2:
                out[parts[0]] = float(parts[1])
    return out


def read_wcat(path: str, n_vc: int) -> dict:
    """-wcat: header + per-SNP weight vector of length n_vc
    (ReadFile_wsnp overload, gemma_io.cpp:3281-3361)."""
    out = {}
    with _open_text(path) as fh:
        hdr = parse_header(fh.readline())
        meta_pos = {hdr[k] for k in ("rs", "chr", "pos", "cm", "a1", "a0")
                    if hdr.get(k, 0)}
        for line in fh:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            w = [float(tok) for i, tok in enumerate(parts)
                 if (i + 1) not in meta_pos]
            if len(w) != n_vc:
                raise ValueError(
                    "wcat file column count does not match cat file")
            out[_rs_of(parts, hdr)] = np.asarray(w)
    return out


def read_signed_beta(path: str, keep: set | None = None):
    """Second ReadFile_beta overload (gemma_io.cpp:3553-3711): signed
    z-scores (z column, or beta/se) keyed by rs, plus the a1 allele
    used to orient the sign against the genotype file."""
    rs2z, rs2a1 = {}, {}
    with _open_text(path) as fh:
        hdr = parse_header(fh.readline())
        if not hdr.get("z", 0) and not (hdr.get("beta", 0)
                                        and hdr.get("sebeta", 0)):
            raise ValueError("missing z scores in the beta file")
        for line in fh:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            rs = _rs_of(parts, hdr)
            if keep is not None and rs not in keep:
                continue
            if hdr.get("z", 0):
                z = float(parts[hdr["z"] - 1])
            else:
                z = (float(parts[hdr["beta"] - 1])
                     / float(parts[hdr["sebeta"] - 1]))
            rs2z[rs] = z
            rs2a1[rs] = parts[hdr["a1"] - 1] if hdr.get("a1", 0) else ""
    return rs2z, rs2a1


def read_beta_rs_set(path: str) -> set:
    """ReadFile_snps_header (gemma_io.cpp:181): the rs column of a
    header-bearing summary file as a set."""
    out = set()
    with _open_text(path) as fh:
        hdr = parse_header(fh.readline())
        for line in fh:
            parts = line.replace(",", " ").split()
            if parts:
                out.add(_rs_of(parts, hdr))
    return out


def read_ref(prefix: str):
    """-ref: prefix.size.txt + prefix.S.txt → (S, Svar, s_ref, ni_ref)
    (ReadFile_ref, gemma_io.cpp:3988)."""
    s_full = np.atleast_1d(np.loadtxt(prefix + ".size.txt"))
    n_vc = len(s_full) - 1
    Sfull = np.loadtxt(prefix + ".S.txt").reshape(2 * n_vc, n_vc)
    return Sfull[:n_vc], Sfull[n_vc:], s_full[:n_vc], int(s_full[n_vc])


def read_mref(path: str):
    """-mref: list of -ref prefixes, pooled with s_i s_j weighting
    (ReadFile_mref, gemma_io.cpp:4103-4186)."""
    S_sum = Svar_sum = s_vec = None
    ni = 0
    with open(path) as fh:
        prefixes = [ln.strip() for ln in fh if ln.strip()]
    for prefix in prefixes:
        S, Svar, s, ni_sub = read_ref(prefix)
        ni = max(ni, ni_sub)
        ss = np.outer(s, s)
        if S_sum is None:
            S_sum = S * ss
            Svar_sum = Svar * ss * ss
            s_vec = s.copy()
        else:
            S_sum += S * ss
            Svar_sum += Svar * ss * ss
            s_vec += s
    ss = np.outer(s_vec, s_vec)
    nz = ss != 0
    S_out = np.where(nz, S_sum / np.where(nz, ss, 1.0), 0.0)
    Svar_out = np.where(nz, Svar_sum / np.where(nz, ss * ss, 1.0), 0.0)
    return S_out, Svar_out, s_vec, ni


def read_study(prefix: str):
    """-study: prefix.{Vq,q,size}.txt (ReadFile_study)."""
    s_full = np.atleast_1d(np.loadtxt(prefix + ".size.txt"))
    n_vc = len(s_full) - 1
    q = np.atleast_1d(np.loadtxt(prefix + ".q.txt"))[:n_vc]
    Vq = np.loadtxt(prefix + ".Vq.txt").reshape(n_vc, n_vc)
    return Vq, q, s_full[:n_vc], int(s_full[n_vc])


def read_mstudy(path: str):
    """-mstudy: list of -study prefixes pooled with s-weighting
    (ReadFile_mstudy, gemma_io.cpp:4012-4101)."""
    Vq_sum = q_sum = s_vec = None
    ni = 0
    with open(path) as fh:
        prefixes = [ln.strip() for ln in fh if ln.strip()]
    for prefix in prefixes:
        Vq, q, s, ni_sub = read_study(prefix)
        ni = max(ni, ni_sub)
        if Vq_sum is None:
            Vq_sum = Vq * np.outer(s, s)
            q_sum = q * s
            s_vec = s.copy()
        else:
            Vq_sum += Vq * np.outer(s, s)
            q_sum += q * s
            s_vec += s
    nz = s_vec != 0
    q_out = np.where(nz, q_sum / np.where(nz, s_vec, 1.0), 0.0)
    ss = np.outer(s_vec, s_vec)
    nzm = ss != 0
    Vq_out = np.where(nzm, Vq_sum / np.where(nzm, ss, 1.0), 0.0)
    return Vq_out, q_out, s_vec, ni


# ---------------------------------------------------------------------------
# weight plumbing (PARAM::ObtainWeight / UpdateWeight / UpdateSNPnZ)

def obtain_weight(rs_iter, setSnps_beta: set, rs2cat: dict | None,
                  rs2wsnp: dict | None, rs2wcat: dict | None) -> dict:
    """mapRS2wK: QC-passing SNPs restricted to the beta file and every
    weight/category map, carrying the -wsnp weight (normalized to mean
    one) or 1 (ObtainWeight, param.cpp:2214-2297).

    Deviation (the reference's): when -wsnp and -cat are combined GEMMA
    divides each category's weight sum by a counter that is only ever
    incremented at index 0 (param.cpp:2244), zeroing every weight
    outside category 0; here each category is normalized by its own
    mean."""
    wK = {}
    for rs in rs_iter:
        if setSnps_beta and rs not in setSnps_beta:
            continue
        if rs2wsnp is not None and rs not in rs2wsnp:
            continue
        if rs2wcat is not None and rs not in rs2wcat:
            continue
        if rs2cat is not None and rs not in rs2cat:
            continue
        wK[rs] = rs2wsnp[rs] if rs2wsnp is not None else 1.0
    if rs2wsnp is not None and wK:
        wsum, wcount = {}, {}
        for rs, w in wK.items():
            c = rs2cat[rs] if rs2cat is not None else 0
            wsum[c] = wsum.get(c, 0.0) + w
            wcount[c] = wcount.get(c, 0) + 1
        for rs in wK:
            c = rs2cat[rs] if rs2cat is not None else 0
            wK[rs] /= wsum[c] / wcount[c]
    return wK


def update_weight(pve_flag: int, wK: dict, ni_test: int, ns: np.ndarray,
                  v_pve, rs2cat: dict | None,
                  rs2wcat: dict | None) -> dict:
    """mapRS2wA, the LDSC-style per-SNP weights 1/d² with
    d = 1 + sum_i (n/ns_i) wcat_i pve_i, normalized to mean one per
    category (UpdateWeight, param.cpp:2300-2351).

    Deviation (the reference's): without -wcat GEMMA indexes an empty
    map (undefined behaviour, param.cpp:2317); here missing LD scores
    default to 1."""
    wA = {}
    ones = np.ones(len(ns))
    v_pve = np.asarray(v_pve, dtype=float)
    for rs in wK:
        d = 1.0
        wc = rs2wcat[rs] if rs2wcat is not None else ones
        for i in range(len(ns)):
            if pve_flag == 1 and v_pve[i] >= 1:
                d += ni_test / ns[i] * wc[i]
            elif pve_flag == 1 and v_pve[i] <= 0:
                pass
            else:
                d += ni_test / ns[i] * wc[i] * v_pve[i]
        wA[rs] = 1.0 / (d * d)
    wsum, wcount = {}, {}
    for rs, w in wA.items():
        c = rs2cat[rs] if rs2cat is not None else 0
        wsum[c] = wsum.get(c, 0.0) + w
        wcount[c] = wcount.get(c, 0) + 1
    for rs in wA:
        c = rs2cat[rs] if rs2cat is not None else 0
        wA[rs] /= wsum[c] / wcount[c]
    return wA


def update_snp_z(rs_arr, a_minor_arr, qc_mask, wA: dict, rs2a1: dict,
                 rs2z: dict, rs2cat: dict | None):
    """Per-SNP arrays in genotype-file order for the Xwz passes: the
    weight w, the allele-oriented z (flipped when the genotype minor
    allele differs from the beta file's a1), and the category; SNPs
    absent from wA drop out (UpdateSNPnZ, param.cpp:2353-2420)."""
    keep_idx, w, z, cat = [], [], [], []
    for i in np.flatnonzero(qc_mask):
        rs = rs_arr[i]
        if rs not in wA:
            continue
        keep_idx.append(i)
        w.append(wA[rs])
        zv = rs2z[rs]
        z.append(zv if a_minor_arr[i] == rs2a1[rs] else -zv)
        cat.append(rs2cat[rs] if rs2cat is not None else 0)
    return (np.asarray(keep_idx, np.int64), np.asarray(w),
            np.asarray(z), np.asarray(cat, np.int64))


# ---------------------------------------------------------------------------
# genotype passes

def standardized_genotypes(raw: torch.Tensor, n: int | None = None,
                           dtype: torch.dtype = _F64) -> torch.Tensor:
    """Mean-impute, centre and 1/sd-scale each SNP row exactly as the
    Xwz streaming passes do (vc.cpp:2259-2297): GEMMA's population
    variance with missing entries imputed at the mean, no scaling where
    it is not positive — K1's standardised form with n_total = n.  `raw`
    is a (k, ·) block in any wire K1 reads; n defaults to its width."""
    n = raw.shape[1] if n is None else n
    return prologue(raw, n, CENTRE, scale=True, n_total=n, dtype=dtype)


def _zw_columns(w, z, cat, n_vc: int, dtype, device):
    """(p, n_vc) one-hot category columns times z, and times w·z."""
    onehot = torch.eye(n_vc, dtype=dtype, device=device)[
        torch.as_tensor(np.asarray(cat, np.int64), device=device)]
    z = np.asarray(z, np.float64)
    zc = onehot * torch.as_tensor(z, dtype=dtype, device=device)[:, None]
    wzc = onehot * torch.as_tensor(np.asarray(w, np.float64) * z,
                                   dtype=dtype, device=device)[:, None]
    return zc, wzc


def _host(*ts):
    return tuple(t.cpu().numpy().astype(np.float64) for t in ts)


def xwz_passes_fetch(fetch, p: int, n: int, w: np.ndarray, z: np.ndarray,
                     cat: np.ndarray, n_vc: int, block: int = 4096,
                     dtype: torch.dtype = _F64,
                     device: str | torch.device = "cuda"):
    """Streaming xwz passes: `fetch(lo, hi)` returns the raw genotype rows
    [lo, hi) on `device` (see mqs.category_kinship_fetch); they are
    standardised a block at a time.  Two passes over the genotypes —
    Xz/XWz accumulate first, then XtXWz needs the complete XWz (the
    reference's pass structure, vc.cpp:2220-2726).  Returns host float64
    (Xz (n, n_vc), XWz (n, n_vc), XtXWz (p, n_vc))."""
    dev = torch.device(device)
    zc, wzc = _zw_columns(w, z, cat, n_vc, dtype, dev)
    Xz = torch.zeros((n, n_vc), dtype=dtype, device=dev)
    XWz = torch.zeros_like(Xz)
    for s in range(0, p, block):
        e = min(s + block, p)
        Xs = standardized_genotypes(fetch(s, e), n, dtype)
        Xz.addmm_(Xs.T, zc[s:e])
        XWz.addmm_(Xs.T, wzc[s:e])
    XtXWz = torch.empty((p, n_vc), dtype=dtype, device=dev)
    for s in range(0, p, block):
        e = min(s + block, p)
        XtXWz[s:e] = standardized_genotypes(fetch(s, e), n, dtype) @ XWz
    return _host(Xz, XWz, XtXWz)


def xwz_passes(Xs: torch.Tensor, w: np.ndarray, z: np.ndarray,
               cat: np.ndarray, n_vc: int):
    """The genotype passes as products on standardised rows Xs (p, n)
    held whole: Xz (unit weights), XWz (given weights) and XtXWz = Xs XWz
    (gemma.cpp:2478-2540)."""
    zc, wzc = _zw_columns(w, z, cat, n_vc, Xs.dtype, Xs.device)
    XWz = Xs.T @ wzc
    return _host(Xs.T @ zc, XWz, Xs @ XWz)


# ---------------------------------------------------------------------------
# CalcCIss

@dataclasses.dataclass
class CiResult:
    pve: np.ndarray
    se_pve: np.ndarray
    pve_total: float
    se_pve_total: float
    sigma2persnp: np.ndarray
    se_sigma2persnp: np.ndarray
    enrich: np.ndarray
    se_enrich: np.ndarray


def calc_ci_ss(Xz, XWz, XtXWz, S, Svar, w, z, s_vec, cat, v_pve) -> CiResult:
    """Standard errors of the MQS pve estimates given their point
    values (CalcCIss, vc.cpp:2727-2963)."""
    n_vc = XWz.shape[1]
    ni_test = XWz.shape[0]
    v_pve = np.asarray(v_pve, dtype=float)
    s_vec = np.asarray(s_vec, dtype=float)

    wz = w * z
    zwz = np.bincount(cat, weights=wz * z, minlength=n_vc)
    zz = np.bincount(cat, weights=z * z, minlength=n_vc)

    s_pve = float(v_pve.sum())
    s_snp = float(s_vec.sum())
    Xz_pve = Xz @ (v_pve / s_vec)                      # (n,)
    w_pve = v_pve[cat] / s_vec[cat]                    # (p,)

    s0 = 1.0 - s_pve + float(zz @ (v_pve / s_vec))
    qvar = np.zeros((n_vc, n_vc))
    for i in range(n_vc):
        s1 = s0 - zwz[i] * (1 - s_pve) / s_vec[i]
        WXtXWz = XtXWz[:, i] * w_pve
        s1 -= float(Xz_pve @ XWz[:, i]) / s_vec[i]
        for j in range(n_vc):
            s = s1 - zwz[j] * (1 - s_pve) / s_vec[j]
            s += float(WXtXWz @ XtXWz[:, j]) / (s_vec[i] * s_vec[j])
            s += float(XWz[:, i] @ XWz[:, j]) / (s_vec[i] * s_vec[j]) \
                * (1 - s_pve)
            s -= float(Xz_pve @ XWz[:, j]) / s_vec[j]
            qvar[i, j] = s
    d = float(ni_test - 1)
    qvar *= 2.0 / (d * d * d)

    Si = np.linalg.inv(S)
    Var = Svar * np.outer(v_pve, v_pve) + qvar
    Var = np.triu(Var) + np.triu(Var, 1).T            # symmetrize like ref
    Var = Si @ Var @ Si

    sigma2persnp = v_pve / s_vec
    enrich = v_pve / s_vec * s_snp / max(s_pve, np.finfo(float).tiny)
    se_pve = np.sqrt(np.maximum(np.diag(Var), 0.0))
    se_sigma2 = se_pve / s_vec
    pve_total = s_pve
    se_pve_total = float(np.sqrt(max(Var.sum(), 0.0)))

    # enrichment delta-method (vc.cpp:2888-2908)
    T = np.empty((n_vc, n_vc))
    for i in range(n_vc):
        dfrac = v_pve[i] / s_pve
        for j in range(n_vc):
            if i == j:
                T[i, j] = (1 - dfrac) / s_vec[i] * s_snp / s_pve
            else:
                T[i, j] = -dfrac / s_vec[i] * s_snp / s_pve
    VarEnrich = T @ Var @ T.T
    se_enrich = np.sqrt(np.maximum(np.diag(VarEnrich), 0.0))

    return CiResult(pve=v_pve, se_pve=se_pve, pve_total=pve_total,
                    se_pve_total=se_pve_total, sigma2persnp=sigma2persnp,
                    se_sigma2persnp=se_sigma2, enrich=enrich,
                    se_enrich=se_enrich)
