"""BSLMM-DAP: deterministic approximation to BSLMM (-bslmm 4/5).

Reference src/bslmmdap.cpp, through the reference package's
`gemma_tpu/models/bslmmdap.py`.  Mode 14 computes, for every SNP, the
Bayes factor of the single-SNP model against the null on a grid of
(h, rho) hyper-parameters (DAP_CalcBF:573-646).  Mode 15 reads the
BF/hyp files back and runs an EM over the hyper grid and per-SNP prior
inclusion probabilities, optionally regressed on annotations
(DAP_EstimateHyper:682-860).

The single-SNP marginal has a closed form (Omega is 1x1), so the (SNPs ×
grid) table is two products, xHx = (UtX∘UtX) w' and xHy = UtX (w∘Uty)'
(`torch.matmul`), and an elementwise epilogue, kernel K13
(`csrc/dap_bf.cu`) on the card, `bf_epilogue_plain` on the CPU.  The
epilogue runs in float64 for float32 products too: in float32,
exp(logm - logm_null) overflows past a log Bayes factor of 88.7
(scripts/dap_f32_overflow.py).
The EM (mode 15) is host numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gemma_torch import kernels
from gemma_torch.models.logistic import (
    logistic_cat_fit, logistic_cat_pred, logistic_cont_fit,
    logistic_cont_pred, logistic_mixed_fit, logistic_mixed_pred)

F64 = torch.float64

# annotation-header names (ReadHeader_io, the columns
# read_dap_annotations classifies)
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


def hyper_grid(h_min, h_max, h_ngrid, rho_min, rho_max, rho_ngrid,
               trace_G, ns_causal: int = 10):
    """(h, rho, sigma_a2, sigma_b2) rows of the DAP grid
    (bslmmdap.cpp:595-615)."""
    rows = []
    for i in range(h_ngrid):
        h = h_min + (h_max - h_min) * i / (h_ngrid - 1)
        for j in range(rho_ngrid):
            rho = rho_min + (rho_max - rho_min) * j / (rho_ngrid - 1)
            sa2 = h * rho / ((1 - h) * ns_causal)
            sb2 = h * (1 - rho) / (trace_G * (1 - h))
            rows.append((h, rho, sa2, sb2))
    return np.asarray(rows)


def bf_products(UtXT, Uty, eval_, sb2):
    """The grid's products for SNP rows UtXT (S, n): xHx and xHy (S, G) in
    the operands' dtype, with H's weights w = 1/(eval sb2 + 1) (G, n);
    and, in float64, logdet_H and hi_yy = Uty' H^-1 Uty (G,)."""
    dt = UtXT.dtype
    sb2_64 = torch.as_tensor(sb2, dtype=F64, device=UtXT.device)
    w64 = 1.0 / (eval_.to(F64)[None, :] * sb2_64[:, None] + 1.0)
    uty64 = Uty.to(F64)
    logdet_H = -torch.log(w64).sum(dim=1)
    hi_yy = (w64 * (uty64 * uty64)[None, :]).sum(dim=1)
    w = w64.to(dt)
    xHx = (UtXT * UtXT) @ w.T
    xHy = UtXT @ (w * Uty[None, :]).T
    return xHx.contiguous(), xHy.contiguous(), logdet_H, hi_yy


def bf_epilogue_plain(xHx, xHy, logdet_H, hi_yy, sa2, tau: float,
                      n: int) -> torch.Tensor:
    """PyTorch version of K13: BF (S, G) = exp(logm - logm_null), the
    single-SNP marginal (CalcMarginal, bslmmdap.cpp:480-562) against the
    null, in float64."""
    xx, xy = xHx.to(F64), xHy.to(F64)
    sa2 = sa2[None, :]
    half_n_logtau = 0.5 * n * np.log(tau)
    logm_null = -0.5 * logdet_H - 0.5 * tau * hi_yy + half_n_logtau
    logdet_O = torch.log1p(sa2 * xx)
    P_yy = hi_yy[None, :] - sa2 * xy * xy / (1.0 + sa2 * xx)
    logm = (-0.5 * logdet_H[None, :] - 0.5 * logdet_O - 0.5 * tau * P_yy
            + half_n_logtau)
    return torch.exp(logm - logm_null[None, :])


def bf_epilogue_cuda(xHx, xHy, logdet_H, hi_yy, sa2, tau: float,
                     n: int) -> torch.Tensor:
    """K13 on the card (float64 products: its f64 instantiation)."""
    S, G = xHx.shape
    dt = xHx.dtype
    kern = kernels.variant(kernels.DAP_BF, kernels.DAP_BF_F64, dt)
    kernels.check_operand(xHx, "xHx", dt, (S, G))
    kernels.check_operand(xHy, "xHy", dt, (S, G))
    for name, v in (("logdet_H", logdet_H), ("hi_yy", hi_yy), ("sa2", sa2)):
        kernels.check_operand(v, name, F64, (G,))
    BF = torch.empty((S, G), dtype=F64, device=xHx.device)
    kern.launch(xHx.device, xHx.data_ptr(), xHy.data_ptr(),
                logdet_H.data_ptr(), hi_yy.data_ptr(), sa2.data_ptr(),
                float(tau), n, S, G, BF.data_ptr())
    return BF


def bf_epilogue(xHx, xHy, logdet_H, hi_yy, sa2, tau: float,
                n: int) -> torch.Tensor:
    """The Bayes-factor epilogue (K13 on the card)."""
    if xHx.device.type == "cpu":
        return bf_epilogue_plain(xHx, xHy, logdet_H, hi_yy, sa2, tau, n)
    return bf_epilogue_cuda(xHx, xHy, logdet_H, hi_yy, sa2, tau, n)


def dap_calc_bf(UtXT, Uty, eval_, grid: np.ndarray) -> np.ndarray:
    """BF table (ns_test, n_grid) as float64 numpy, for SNP rows UtXT
    (p, n); tau = n / y'y (bslmmdap.cpp:588-590)."""
    n = Uty.shape[0]
    uty64 = Uty.to(F64)
    tau = float(n) / float(uty64 @ uty64)
    xHx, xHy, logdet_H, hi_yy = bf_products(UtXT, Uty, eval_, grid[:, 3])
    sa2 = torch.as_tensor(grid[:, 2], dtype=F64, device=UtXT.device)
    return bf_epilogue(xHx, xHy, logdet_H, hi_yy, sa2, tau,
                       n).cpu().numpy()


def single_ct_regression(Ad0: np.ndarray, pip: np.ndarray, n_levels: int):
    """Closed-form prior update for one categorical annotation
    (bslmmdap.cpp:648-679).  Returns (coef per level, prior per SNP)."""
    coef = np.zeros(n_levels)
    prior = np.zeros(len(pip))
    for lv in range(n_levels):
        sel = Ad0 == lv
        mean_pip = pip[sel].mean() if sel.any() else 0.5
        coef[lv] = np.log(mean_pip / (1 - mean_pip))
        prior[sel] = mean_pip
    return coef, prior


def dap_estimate_hyper(vec_sa2, vec_sb2, wab, BF_blocks, rs_list,
                       Ac=None, Ad=None, n_levels=None,
                       max_iter: int = 100, tol: float = 1e-3):
    """EM over hyper-grid weights and per-SNP priors
    (DAP_EstimateHyper, bslmmdap.cpp:682-860).

    BF_blocks: list of (m_b, n_grid) arrays.  Returns
    (Hyper (n_grid, 5), pip (m,), coef).
    """
    n_grid = len(wab)
    m = sum(b.shape[0] for b in BF_blocks)
    kc = 0 if Ac is None else Ac.shape[1]
    kd = 0 if Ad is None else Ad.shape[1]

    prior = np.full(m, len(BF_blocks) / m)
    wab_cur = np.asarray(wab, dtype=np.float64)
    wab_new = wab_cur.copy()
    pip = np.zeros(m)
    coef = np.zeros(kc + (sum(n_levels) if n_levels else 0) + 1)

    logm_save = np.nan
    BF_flat = np.vstack(BF_blocks)                  # (m, n_grid)
    block_of = np.concatenate([
        np.full(b.shape[0], i) for i, b in enumerate(BF_blocks)])

    it = 0
    dif = 1.0
    while it < max_iter and dif > tol:
        # E step for gamma: pip ∝ prior/(1-prior) * sum_ij w_ij BF
        odds = prior / (1 - prior)
        d_all = (BF_flat @ wab_new) * odds          # (m,)
        for b in range(len(BF_blocks)):
            sel = block_of == b
            s = 1.0 + d_all[sel].sum()
            pip[sel] = d_all[sel] / s

        # E step for wab
        contrib = odds[:, None] * BF_flat * wab_cur[None, :]  # (m, grid)
        logs = np.zeros(n_grid)
        for b in range(len(BF_blocks)):
            sel = block_of == b
            logs += np.log1p(contrib[sel].sum(axis=0))
        logs -= logs.max()
        wab_new = np.exp(logs)
        wab_new /= wab_new.sum()

        # M step for the prior
        if kc == 0 and kd == 0:
            s = pip.mean()
            prior = np.full(m, s)
            coef = np.array([np.log(s / (1 - s))])
        elif kc == 0 and kd == 1:
            coef, prior = single_ct_regression(Ad[:, 0], pip, n_levels[0])
        elif kc == 0:
            coef = logistic_cat_fit(Ad, n_levels, pip)
            prior = logistic_cat_pred(coef, Ad, n_levels)
        elif kd == 0:
            coef = logistic_cont_fit(Ac, pip)
            prior = logistic_cont_pred(coef, Ac)
        else:
            coef = logistic_mixed_fit(Ad, n_levels, Ac, pip)
            prior = logistic_mixed_pred(coef, Ad, n_levels, Ac)
        prior = np.clip(prior, 1e-12, 1 - 1e-12)

        # marginal likelihood (per reference formula, bslmmdap.cpp:804-820)
        odds = prior / (1 - prior)
        d_all = (BF_flat @ wab_cur) * odds
        logm = 0.0
        for b in range(len(BF_blocks)):
            sel = block_of == b
            logm += np.log1p(d_all[sel].sum()) + \
                np.log(1 - prior[sel]).sum()
        if it > 0:
            dif = logm - logm_save
        logm_save = logm
        it += 1

    # map wab back to (h, rho) rows (bslmmdap.cpp:831-848)
    pi_hat = np.exp(coef[-1]) / (1 + np.exp(coef[-1]))
    Hyper = np.zeros((n_grid, 5))
    for ij in range(n_grid):
        sa2, sb2 = vec_sa2[ij], vec_sb2[ij]
        h = (pi_hat * m * sa2 + sb2) / (1 + pi_hat * m * sa2 + sb2)
        rho = pi_hat * m * sa2 / (pi_hat * m * sa2 + sb2)
        Hyper[ij] = (h, rho, sa2, sb2, wab_new[ij])
    return Hyper, pip, coef


# ---------------------------------------------------------------------------
# file IO (formats per BSLMMDAP::WriteResult / ReadFile_hyb / ReadFile_bf)

def write_hyp_bf(prefix: str, grid: np.ndarray, BF: np.ndarray,
                 snp_rows: list, block_size: int = 1000) -> None:
    n_grid = grid.shape[0]
    with open(prefix + ".hyp.txt", "w") as fh:
        fh.write("h\trho\tsa2\tsb2\tweight\n")
        for (h, rho, sa2, sb2) in grid:
            fh.write(f"{h:.6e}\t{rho:.6e}\t{sa2:.6e}\t{sb2:.6e}\t"
                     f"{1.0 / n_grid:.6e}\n")
    with open(prefix + ".bf.txt", "w") as fh:
        fh.write("chr\trs\tps\tn_miss")
        for i in range(n_grid):
            fh.write(f"\tBF{i + 1}")
        fh.write("\n")
        for t, s in enumerate(snp_rows):
            fh.write(f"{s['chr']}\t{s['rs']}\t{s['ps']}\t{s['n_miss']}")
            for v in BF[t]:
                fh.write(f"\t{v:.6e}")
            fh.write("\n")


def read_hyp(path: str):
    sa2, sb2, wab = [], [], []
    with open(path) as fh:
        next(fh)
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            sa2.append(float(parts[2]))
            sb2.append(float(parts[3]))
            wab.append(float(parts[4]))
    return np.asarray(sa2), np.asarray(sb2), np.asarray(wab)


def read_bf(path: str):
    """Blocks are delimited by a change in the second column
    (ReadFile_bf, bslmmdap.cpp:139-204)."""
    rs_list, blocks, cur = [], [], []
    block_id = None
    with open(path) as fh:
        next(fh)
        for line in fh:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            rs_list.append(parts[0])
            bid = parts[1]
            vals = [float(v) for v in parts[2:]]
            if block_id is None:
                block_id = bid
            elif bid != block_id:
                blocks.append(np.asarray(cur))
                cur = []
                block_id = bid
            cur.append(vals)
    if cur:
        blocks.append(np.asarray(cur))
    return rs_list, blocks


def write_dap_result(prefix: str, rs_list, Hyper: np.ndarray,
                     pip: np.ndarray, coef: np.ndarray) -> None:
    with open(prefix + ".hyp.txt", "w") as fh:
        fh.write("h\trho\tsa2\tsb2\tweight\n")
        for row in Hyper:
            fh.write("\t".join(f"{v:.6e}" for v in row) + "\t\n")
    with open(prefix + ".gamma.txt", "w") as fh:
        fh.write("rs\tgamma\n")
        for rs, p in zip(rs_list, pip):
            fh.write(f"{rs}\t{p:.6e}\n")
    with open(prefix + ".coef.txt", "w") as fh:
        fh.write("coef\n")
        for v in coef:
            fh.write(f"{v:.6e}\n")


def read_dap_annotations(path: str, rs_list):
    """Annotation file for -bslmm 5: header columns ending in `_c`/`_C`
    are continuous, other non-meta columns discrete (the BSLMMDAP
    ReadFile_cat overload, bslmmdap.cpp:209-331 + the header
    classification at gemma_io.cpp:2591-2604).

    Returns (Ac (m, kc) or None, Ad (m, kd) dense 0-based codes or
    None, n_levels list).  SNPs absent from the file get zeros."""
    import gzip
    import io as _io

    opener = (lambda p: _io.TextIOWrapper(gzip.open(p, "rb"))) \
        if str(path).endswith(".gz") else open
    with opener(path) as fh:
        header = fh.readline().replace(",", " ").split()
        hdr = parse_header(" ".join(header))
        meta_pos = {hdr[k] for k in ("rs", "chr", "pos", "cm", "a1", "a0")
                    if hdr.get(k, 0)}
        catc_cols = [i for i, tok in enumerate(header)
                     if (i + 1) not in meta_pos and tok[-2:] in ("_c", "_C")]
        catd_cols = [i for i, tok in enumerate(header)
                     if (i + 1) not in meta_pos
                     and tok[-2:] not in ("_c", "_C")]
        rs2c, rs2d = {}, {}
        for line in fh:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            rs = parts[hdr["rs"] - 1] if hdr.get("rs", 0) else \
                f"{parts[hdr['chr'] - 1]}:{parts[hdr['pos'] - 1]}"
            if catc_cols and rs not in rs2c:
                rs2c[rs] = [float(parts[i]) for i in catc_cols]
            if catd_cols and rs not in rs2d:
                rs2d[rs] = [int(float(parts[i])) for i in catd_cols]

    kc, kd = len(catc_cols), len(catd_cols)
    m = len(rs_list)
    Ac = Ad = n_levels = None
    if kc:
        Ac = np.zeros((m, kc))
        for i, rs in enumerate(rs_list):
            if rs in rs2c:
                Ac[i] = rs2c[rs]
    if kd:
        Ad_raw = np.zeros((m, kd), dtype=np.int64)
        for i, rs in enumerate(rs_list):
            if rs in rs2d:
                Ad_raw[i] = rs2d[rs]
        # dense 0-based codes per column; n_levels = distinct count
        Ad = np.empty_like(Ad_raw)
        n_levels = []
        for j in range(kd):
            _, Ad[:, j] = np.unique(Ad_raw[:, j], return_inverse=True)
            n_levels.append(int(Ad[:, j].max()) + 1)
    return Ac, Ad, n_levels
