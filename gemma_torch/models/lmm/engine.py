"""Univariate LMM engine: null-model fit and batched association.

Orchestrates the likelihood (likelihood.py) and the batched λ
optimiser (optimize.py) into the two operations GEMMA's LMM class
performs (lmm.cpp), as the reference package's engine does:

  * fit_null          — REML + ML lambda for the covariate-only model,
                        plus vg/ve/beta/se (CalcLmmVgVeBeta,
                        lmm.cpp:2210) and PVE (CalcPve, lmm.cpp:2183).
  * assoc_block_impl  — per-SNP Wald/LRT/score statistics for a block
                        of rotated genotypes (LMM::Analyze,
                        lmm.cpp:1474-1658).

Modes mirror GEMMA's -lmm numbers: 1=Wald, 2=LRT, 3=score, 4=all,
9=LRT+score (with beta/se from the score fit).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm.indices import pab_indices
from gemma_torch.models.lmm.optimize import calc_lambda


class NullFit(NamedTuple):
    l_mle: torch.Tensor
    logl_mle: torch.Tensor
    l_remle: torch.Tensor
    logl_remle: torch.Tensor
    vg_mle: torch.Tensor
    ve_mle: torch.Tensor
    beta_mle: torch.Tensor
    se_beta_mle: torch.Tensor
    vg_remle: torch.Tensor
    ve_remle: torch.Tensor
    beta_remle: torch.Tensor
    se_beta_remle: torch.Tensor
    pve: torch.Tensor
    pve_se: torch.Tensor


def _vg_ve_beta(eval_, UtW, Uty, lam, n_cvt: int):
    """REML/MLE variance components and GLS covariate effects at lambda
    (CalcLmmVgVeBeta, lmm.cpp:2210-2281)."""
    idx = pab_indices(n_cvt)
    n = eval_.shape[0]
    hi = 1.0 / (lam * eval_ + 1.0)
    HiW = UtW * hi[:, None]
    WHiW = HiW.T @ UtW
    WHiy = HiW.T @ Uty
    beta = torch.linalg.solve(WHiW, WHiy)
    Vbeta = torch.linalg.inv(WHiW)

    data = lk.null_batch_data(eval_, UtW, Uty, n_cvt)
    pab = lk._pab_rows(lk._base_row(hi[None, :], data, n_cvt), n_cvt)
    p_yy = pab[n_cvt][..., idx.yy][0]

    ve = p_yy / (n - n_cvt)
    vg = ve * lam
    se_beta = torch.sqrt(torch.diagonal(Vbeta) * ve)
    return vg, ve, beta, se_beta


def fit_null(eval_, UtW, Uty, trace_G, n_cvt: int,
             l_min: float = 1e-5, l_max: float = 1e5,
             n_region: int = 10) -> NullFit:
    """Fit the covariate-only LMM (gemma.cpp:2704-2753)."""
    data = lk.null_batch_data(eval_, UtW, Uty, n_cvt)
    mle = calc_lambda(data, n_cvt, calc_null=True, reml=False,
                      l_min=l_min, l_max=l_max, n_region=n_region)
    remle = calc_lambda(data, n_cvt, calc_null=True, reml=True,
                        l_min=l_min, l_max=l_max, n_region=n_region)
    l_mle = mle.lam[0]
    l_remle = remle.lam[0]

    vg_m, ve_m, beta_m, se_m = _vg_ve_beta(eval_, UtW, Uty, l_mle, n_cvt)
    vg_r, ve_r, beta_r, se_r = _vg_ve_beta(eval_, UtW, Uty, l_remle, n_cvt)

    # CalcPve: se(lambda) from the REML curvature (lmm.cpp:2183-2205)
    _, d2 = lk.dev12(remle.lam, data, n_cvt, calc_null=True, reml=True)
    se_lam = torch.sqrt(-1.0 / d2[0])
    pve = trace_G * l_remle / (trace_G * l_remle + 1.0)
    pve_se = trace_G / (trace_G * l_remle + 1.0) ** 2 * se_lam

    return NullFit(
        l_mle=l_mle, logl_mle=mle.logf[0],
        l_remle=l_remle, logl_remle=remle.logf[0],
        vg_mle=vg_m, ve_mle=ve_m, beta_mle=beta_m, se_beta_mle=se_m,
        vg_remle=vg_r, ve_remle=ve_r, beta_remle=beta_r, se_beta_remle=se_r,
        pve=pve, pve_se=pve_se,
    )


class AssocStats(NamedTuple):
    """Per-SNP summary statistics (SUMSTAT, lmm.h)."""
    beta: torch.Tensor
    se: torch.Tensor
    lambda_remle: torch.Tensor
    lambda_mle: torch.Tensor
    p_wald: torch.Tensor
    p_lrt: torch.Tensor
    p_score: torch.Tensor
    logl_H1: torch.Tensor


def assoc_block_impl(eval_, UtW, Uty, Utx_block, l_mle_null, logl_mle_H0,
                     n_cvt: int, mode: int,
                     l_min: float = 1e-5, l_max: float = 1e5,
                     n_region: int = 10) -> AssocStats:
    """Association statistics for one rotated SNP block (S, n).

    Utx_block rows are U'x for mean-imputed (uncentered) genotype
    vectors, exactly as LMM::Analyze feeds them (lmm.cpp:1589-1636).
    The tests run in the reference's order, so its overrides hold: the
    score runs at the null's ML λ; in mode 4 beta/se come from the Wald
    fit, in mode 9 from the score fit; logl_H1 is the ML fit's in 2/4/9.
    On the card: K5 the score; K2 + K3 (K7 in float64) each λ search; K4
    the Wald test; K6 the likelihood-ratio test."""
    if mode not in (1, 2, 3, 4, 9):
        raise ValueError(f"assoc_block_impl runs -lmm 1/2/3/4/9, not {mode}")
    data = lk.build_batch_data(eval_, UtW, Uty, Utx_block, n_cvt)
    zeros = torch.zeros_like(Utx_block[:, 0])
    beta = se = lambda_remle = lambda_mle = zeros
    p_wald = p_lrt = p_score = logl_H1 = zeros

    if mode in (3, 4, 9):
        beta, se, p_score = lk.score_pvalues(l_mle_null, data, n_cvt)
    if mode in (1, 4):
        remle = calc_lambda(data, n_cvt, calc_null=False, reml=True,
                            l_min=l_min, l_max=l_max, n_region=n_region)
        lambda_remle, logl_H1 = remle.lam, remle.logf
        beta, se, p_wald = lk.wald_pvalues(remle.lam, data, n_cvt)
    if mode in (2, 4, 9):
        mle = calc_lambda(data, n_cvt, calc_null=False, reml=False,
                          l_min=l_min, l_max=l_max, n_region=n_region)
        lambda_mle = mle.lam
        logl_H1, p_lrt = lk.lrt_pvalues(mle.lam, mle.logf, data, n_cvt,
                                        l_mle_null, logl_mle_H0)
    return AssocStats(beta=beta, se=se, lambda_remle=lambda_remle,
                      lambda_mle=lambda_mle, p_wald=p_wald, p_lrt=p_lrt,
                      p_score=p_score, logl_H1=logl_H1)
