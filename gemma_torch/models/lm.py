"""Plain linear model association (-lm 1..4; GEMMA src/lm.cpp).

Per-SNP OLS with the covariates projected out, as the reference
package's gemma_tpu/models/lm.py.  Everything reduces to three projected
inner products (CalcvPv, lm.cpp:224-264):

  xPwx = x'x - x'W (W'W)^-1 W'x
  xPwy = x'y - x'W (W'W)^-1 W'y
  yPwy = y'y - y'W (W'W)^-1 W'y      (shared across SNPs)

and the statistics (LmCalcP, lm.cpp:266-289): beta = xPwy/xPwx, Wald
F(1, df), score F(1, df), LRT chi-square(1) on n log(yPwy/yPxy), with
df = n - c - 1.  Gene mode (lm.cpp:290-384) swaps the roles: each row is
a response, the phenotype the shared predictor.

The per-row part is kernel K8 (csrc/lm_tail.cu) on the card and
`lm_tail_plain` on the CPU; the shared (W'W)^-1, (W'W)^-1 W'v and v'P_W v
are a few float64 torch operations on (n, c) operands.  Both forms work
in float64 from the operands of either type, and the LRT statistic is
-n log1p(-xPwy²/(xPwx yPwy)): the reference's difference of two logs
cancels in float32 for null SNPs, as the LMM's did (ROADMAP.md §C0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gemma_torch import kernels
from gemma_torch.ops.stats import chisq_sf, f_sf


class LmStats(NamedTuple):
    beta: torch.Tensor
    se: torch.Tensor
    p_wald: torch.Tensor
    p_lrt: torch.Tensor
    p_score: torch.Tensor


class LmConsts(NamedTuple):
    """The pieces every row shares, float64, on the operands' device."""
    WtWi: torch.Tensor      # (c, c) (W'W)^-1
    WtWi_Wtv: torch.Tensor  # (c,)   (W'W)^-1 W'v
    vPwv: torch.Tensor      # (1,)   v'v - v'W (W'W)^-1 W'v


def lm_consts(W: torch.Tensor, v: torch.Tensor) -> LmConsts:
    """(W'W)^-1, (W'W)^-1 W'v and v'P_W v for the shared vector v (the
    phenotype, or in gene mode the predictor)."""
    W64, v64 = W.double(), v.double()
    WtW = W64.T @ W64
    Wtv = W64.T @ v64
    WtWi_Wtv = torch.linalg.solve(WtW, Wtv)
    vPwv = (v64 @ v64 - Wtv @ WtWi_Wtv).reshape(1)
    return LmConsts(torch.linalg.inv(WtW).contiguous(),
                    WtWi_Wtv.contiguous(), vPwv.contiguous())


def _lm_stats(xPwx, xPwy, yPwy, n: int, df: float, se_score: bool):
    """beta, se and the three p-values from the projected products."""
    r2 = xPwy * xPwy / (xPwx * yPwy)
    yPxy = yPwy - xPwy * xPwy / xPwx
    beta = xPwy / xPwx
    se = (torch.sqrt(yPwy / (n * xPwx)) if se_score
          else torch.sqrt(yPxy / (df * xPwx)))
    p_wald = f_sf(xPwy * xPwy * df / (xPwx * yPxy), 1.0, df)
    p_score = f_sf(n * r2, 1.0, df)
    p_lrt = chisq_sf(-n * torch.log1p(-r2), 1.0)
    return beta, se, p_wald, p_lrt, p_score


def lm_tail_plain(rows, v, W, consts: LmConsts, gene: bool,
                  se_score: bool) -> LmStats:
    """PyTorch version of K8: each row's products with itself, v and the
    covariates in float64, its projections and its tests; results in
    the rows' dtype."""
    n, c = W.shape
    R = rows.double()
    rW = R @ W.double()                                    # (S, c)
    rPwr = (R * R).sum(dim=1) - ((rW @ consts.WtWi) * rW).sum(dim=1)
    rPwv = R @ v.double() - rW @ consts.WtWi_Wtv
    vPwv = consts.vPwv[0]
    if gene:
        xPwx, yPwy = vPwv, rPwr
    else:
        xPwx, yPwy = rPwr, vPwv
    out = _lm_stats(xPwx, rPwv, yPwy, n, float(n - c - 1), se_score)
    return LmStats(*(t.to(rows.dtype) for t in out))


def lm_tail_cuda(rows, v, W, consts: LmConsts, gene: bool,
                 se_score: bool) -> LmStats:
    """K8 on the card (float64 operands: its f64 instantiation)."""
    S, n = rows.shape
    c = W.shape[1]
    kernels.check_n_cvt(c)
    dt = rows.dtype
    kern = kernels.variant(kernels.LM_TAIL, kernels.LM_TAIL_F64, dt)
    kernels.check_operand(rows, "rows", dt, (S, n))
    kernels.check_operand(v, "v", dt, (n,))
    kernels.check_operand(W, "W", dt, (n, c))
    f64 = torch.float64
    kernels.check_operand(consts.WtWi, "WtWi", f64, (c, c))
    kernels.check_operand(consts.WtWi_Wtv, "WtWi_Wtv", f64, (c,))
    kernels.check_operand(consts.vPwv, "vPwv", f64, (1,))
    out = torch.empty((5, S), dtype=dt, device=rows.device)
    # above 32 covariates each row keeps its r'W in a scratch (c doubles)
    scratch = torch.empty(S * kernels.LM_TAIL.lane_bytes(c), dtype=torch.uint8,
                          device=rows.device)
    kern.launch(rows.device, rows.data_ptr(), v.data_ptr(), W.data_ptr(),
                consts.WtWi.data_ptr(), consts.WtWi_Wtv.data_ptr(),
                consts.vPwv.data_ptr(), S, n, c, int(gene), int(se_score),
                *(out[i].data_ptr() for i in range(5)), scratch.data_ptr())
    return LmStats(*out)


def lm_tail(rows, v, W, consts: LmConsts, gene: bool,
            se_score: bool) -> LmStats:
    """The per-row OLS tests (K8 on the card)."""
    if rows.device.type == "cpu":
        return lm_tail_plain(rows, v, W, consts, gene, se_score)
    return lm_tail_cuda(rows, v, W, consts, gene, se_score)


def lm_block(W, y, X_block, mode: int = 51) -> LmStats:
    """OLS stats for one (S, n) mean-imputed genotype block; se is the
    score test's in -lm 3 (mode 53), the Wald test's otherwise."""
    return lm_tail(X_block, y, W, lm_consts(W, y), gene=False,
                   se_score=mode == 53)


def lm_gene_block(W, x, Y_block, mode: int = 51) -> LmStats:
    """Gene-expression OLS: the phenotype x is the (shared) predictor
    and each row of Y_block is a response (LM::AnalyzeGene,
    lm.cpp:290-384)."""
    return lm_tail(Y_block, x, W, lm_consts(W, x), gene=True,
                   se_score=mode == 53)
