"""Batched LMM (restricted) likelihood in the eigen-rotated space.

The model: y = W alpha + x beta + u + e, u ~ N(0, lambda tau^-1 K),
e ~ N(0, tau^-1 I).  After rotating by the eigenvectors U of K
(D = eigenvalues), H = lambda D + I is diagonal and every quantity the
(restricted) likelihood needs reduces to weighted inner products of the
rotated vectors {U'w_1..U'w_c, U'x, U'y} with weights H^-1, H^-2, H^-3
(Zhou & Stephens 2012 supplement; reference lmm.cpp:227-1125).

These are the plain PyTorch versions of the reference package's
functions of the same names (gemma_tpu/models/lmm/likelihood.py), on
tensors of any device and dtype.  Four of them have kernels on the card:
the epilogue of `dev1_grid` (K2, csrc/lambda_grid.cu), the Wald tail
`wald_pvalues` (K4, csrc/wald_tail.cu), the score tail `score_pvalues`
(K5, csrc/score_tail.cu) and the likelihood-ratio tail `lrt_pvalues`
(K6, csrc/lrt_tail.cu).  Lanes are one axis (S,).

A block's operands are shared by all lanes (one phenotype, one set of
covariates: -lmm on SNPs) or per lane (GxE: each SNP's covariates are
[W, env, x]; gene mode: each gene is a response): `UtWy` (S, n, c+1)
and `wy_prod` (S, n, m_wy) instead of (n, c+1) and (n, m_wy), and
`Utx` one shared row (1, n) where the lanes share the predictor.  The
kernels take each per-lane operand with a lane stride, 0 where it is
shared.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gemma_torch import kernels
from gemma_torch.models.lmm.indices import pab_indices
from gemma_torch.ops.stats import chisq_sf, f_sf

P_YY_MIN = 1e-8  # round-off clamp, reference lmm.cpp:52
_LOG_2PI = math.log(2.0 * math.pi)


class LmmBatchData(NamedTuple):
    """Device-resident inputs for one SNP block.

    eval:    (n,)   zeroed eigenvalues of the centered kinship matrix
    UtWy:    (n, c+1)  rotated covariates with rotated phenotype as last
             col, or (S, n, c+1) per lane
    wy_prod: (n, m_wy) elementwise products of the {W,y}-pair columns,
             ordered to match PabIndices.wy_positions; (S, n, m_wy) per
             lane
    Utx:     (S, n) rotated genotypes for the block (zeros for null
             fits), or (1, n) one predictor shared by every lane
    iab_logdiag: (S, n_cvt+1) log of the identity-weighted recurrence
             diagonals (the λ-independent piece of the Pab-form REML
             logdet); float64 only, where the strict `logf` reads it
    """

    eval: torch.Tensor
    UtWy: torch.Tensor
    wy_prod: torch.Tensor
    Utx: torch.Tensor
    iab_logdiag: torch.Tensor | None


def _ix(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def per_lane(data: LmmBatchData) -> bool:
    """True when each lane has its own UtWy / wy_prod."""
    return data.UtWy.dim() == 3


def n_lanes(data: LmmBatchData) -> int:
    """Lane count: the per-lane operands' leading axis, else Utx's rows."""
    return data.UtWy.shape[0] if per_lane(data) else data.Utx.shape[0]


def lane_strides(data: LmmBatchData) -> tuple:
    """Elements between two lanes' UtWy, wy_prod and Utx (0 = shared),
    as the kernels take them."""
    n = data.eval.shape[0]
    if not per_lane(data):
        return 0, 0, n
    return (n * data.UtWy.shape[2], n * data.wy_prod.shape[2],
            0 if data.Utx.shape[0] == 1 else n)


def _lane_mm(w, A):
    """Each lane's weights w (..., S, n) times its operand A: (n, m)
    shared by the lanes, or (S, n, m) per lane."""
    if A.dim() == 2:
        return torch.matmul(w, A)
    return torch.matmul(w.unsqueeze(-2), A).squeeze(-2)


def _iab_logdiag(data: LmmBatchData, n_cvt: int) -> torch.Tensor:
    idx = pab_indices(n_cvt)
    ones = torch.ones((n_lanes(data), data.eval.shape[0]),
                      dtype=data.Utx.dtype, device=data.Utx.device)
    iab = _pab_rows(_base_row(ones, data, n_cvt), n_cvt)
    return torch.stack([torch.log(iab[i][..., int(idx.diag[i])])
                        for i in range(n_cvt + 1)], dim=-1)


def build_batch_data(eval_, UtW, Uty, Utx, n_cvt: int) -> LmmBatchData:
    """Assemble the tensors for a SNP block (or a null fit).

    Shared operands are UtW (n, c) and Uty (n,).  A per-lane UtW
    (S, n, c) or Uty (S, n), the other broadcast to the S lanes, gives
    per-lane UtWy and wy_prod; Utx is (S, n) or one shared row (1, n)."""
    idx = pab_indices(n_cvt)
    if UtW.dim() == 3 or Uty.dim() == 2:
        S = UtW.shape[0] if UtW.dim() == 3 else Uty.shape[0]
        n = eval_.shape[0]
        UtWy = torch.cat([UtW.expand(S, n, n_cvt),
                          Uty.expand(S, n)[..., None]], dim=-1).contiguous()
    else:
        UtWy = torch.cat([UtW, Uty[:, None]], dim=1).contiguous()
    cols = []
    for (a, b) in idx.wy_pairs:
        ca = UtWy[..., a - 1] if a <= n_cvt else UtWy[..., n_cvt]
        cb = UtWy[..., b - 1] if b <= n_cvt else UtWy[..., n_cvt]
        cols.append(ca * cb)
    wy_prod = torch.stack(cols, dim=-1).contiguous()
    data = LmmBatchData(eval=eval_, UtWy=UtWy, wy_prod=wy_prod, Utx=Utx,
                        iab_logdiag=None)
    return replace_x(data, Utx, n_cvt)


def replace_x(data: LmmBatchData, Utx, n_cvt: int) -> LmmBatchData:
    """The block with another Utx (and, in float64, its iab_logdiag)."""
    data = data._replace(Utx=Utx, iab_logdiag=None)
    if data.eval.dtype == torch.float64:
        data = data._replace(iab_logdiag=_iab_logdiag(data, n_cvt))
    return data


def null_batch_data(eval_, UtW, Uty, n_cvt: int) -> LmmBatchData:
    """Batch data for the no-SNP (null) model: a single all-zero x lane."""
    Utx = torch.zeros((1, eval_.shape[0]), dtype=eval_.dtype,
                      device=eval_.device)
    return build_batch_data(eval_, UtW, Uty, Utx, n_cvt)


def _assemble(n_cvt: int, shared, xx, xcross):
    """Flat n_index row from its three sources, in GetabIndex order."""
    idx = pab_indices(n_cvt)
    wy_col = {int(p): i for i, p in enumerate(idx.wy_positions)}
    xw_col = {int(p): int(j) for p, j in zip(idx.xw_positions,
                                             idx.xw_partners)}
    parts = []
    for k in range(idx.n_index):
        if k in wy_col:
            parts.append(shared[..., wy_col[k]])
        elif k == idx.xx:
            parts.append(xx)
        else:
            parts.append(xcross[..., xw_col[k]])
    return torch.stack(parts, dim=-1)


def _base_row(w, data: LmmBatchData, n_cvt: int):
    """Row 0 of the Pab recurrence for weight vector(s) w: (..., S, n).

    Returns (..., S, n_index): weighted inner products of every column
    pair, laid out in GEMMA's GetabIndex order.  The terms are w's type
    (w and w·x as given), their products and sums float64, each sum
    rounded once to w's type, as K4 and K5 form them.
    """
    f64 = torch.float64
    wx = w * data.Utx                                  # (..., S, n)
    shared = _lane_mm(w.to(f64), data.wy_prod.to(f64))  # (..., S, m_wy)
    xcross = _lane_mm(wx.to(f64), data.UtWy.to(f64))   # (..., S, c+1)
    xx = torch.sum(wx.to(f64) * data.Utx.to(f64), dim=-1)   # (..., S)
    return _assemble(n_cvt, shared, xx, xcross).to(w.dtype)


def _base_rows_multi(hi, data: LmmBatchData, n_cvt: int, order: int):
    """Base rows for weights hi^1..hi^order in one pass over Utx."""
    v1 = hi * data.Utx
    rows = []
    w = hi
    vx = v1
    for p in range(order):
        shared = _lane_mm(w, data.wy_prod)
        xcross = _lane_mm(vx, data.UtWy)
        if p == 0:
            xx = torch.sum(v1 * data.Utx, dim=-1)
        elif p == 1:
            xx = torch.sum(v1 * v1, dim=-1)
        else:
            xx = torch.sum(v1 * v1 * hi, dim=-1)
        rows.append(_assemble(n_cvt, shared, xx, xcross))
        if p + 1 < order:
            w = w * hi
            vx = vx * hi
    return rows


def _pab_rows(row0, n_cvt: int):
    """CalcPab recurrence: eliminate covariates 1..n_cvt then x.

    Returns list of n_cvt+2 rows, each (..., n_index).
    """
    idx = pab_indices(n_cvt)
    dev = row0.device
    rows = [row0]
    for p in range(1, n_cvt + 2):
        prev = rows[-1]
        aw = prev[..., _ix(idx.aw[p - 1], dev)]
        bwv = prev[..., _ix(idx.bw[p - 1], dev)]
        ww = prev[..., int(idx.ww[p - 1])][..., None]
        safe = torch.where(ww != 0.0, ww, torch.ones_like(ww))
        rows.append(torch.where(ww != 0.0, prev - aw * bwv / safe, prev))
    return rows


def _ppab_rows(row0_pp, pab, n_cvt: int):
    """CalcPPab recurrence (second-order quantities a' P_p^2 b)."""
    idx = pab_indices(n_cvt)
    dev = row0_pp.device
    rows = [row0_pp]
    for p in range(1, n_cvt + 2):
        a_ix, b_ix = _ix(idx.aw[p - 1], dev), _ix(idx.bw[p - 1], dev)
        w = int(idx.ww[p - 1])
        prev2 = rows[-1]
        prev1 = pab[p - 1]
        ps_aw, ps_bw = prev1[..., a_ix], prev1[..., b_ix]
        ps_ww = prev1[..., w][..., None]
        ps2_ab = prev2
        ps2_aw, ps2_bw = prev2[..., a_ix], prev2[..., b_ix]
        ps2_ww = prev2[..., w][..., None]
        safe = torch.where(ps_ww != 0.0, ps_ww, torch.ones_like(ps_ww))
        val = (ps2_ab + ps_aw * ps_bw * ps2_ww / (safe * safe)
               - (ps_aw * ps2_bw + ps_bw * ps2_aw) / safe)
        rows.append(torch.where(ps_ww != 0.0, val, ps2_ab))
    return rows


def _pppab_rows(row0_ppp, pab, ppab, n_cvt: int):
    """CalcPPPab recurrence (third-order quantities a' P_p^3 b)."""
    idx = pab_indices(n_cvt)
    dev = row0_ppp.device
    rows = [row0_ppp]
    for p in range(1, n_cvt + 2):
        a_ix, b_ix = _ix(idx.aw[p - 1], dev), _ix(idx.bw[p - 1], dev)
        w = int(idx.ww[p - 1])
        prev3 = rows[-1]
        prev1 = pab[p - 1]
        prev2 = ppab[p - 1]
        ps_aw, ps_bw = prev1[..., a_ix], prev1[..., b_ix]
        ps_ww = prev1[..., w][..., None]
        ps2_aw, ps2_bw = prev2[..., a_ix], prev2[..., b_ix]
        ps2_ww = prev2[..., w][..., None]
        ps3_ab = prev3
        ps3_aw, ps3_bw = prev3[..., a_ix], prev3[..., b_ix]
        ps3_ww = prev3[..., w][..., None]
        safe = torch.where(ps_ww != 0.0, ps_ww, torch.ones_like(ps_ww))
        val = (ps3_ab
               - ps_aw * ps_bw * ps2_ww * ps2_ww / (safe * safe * safe)
               - (ps_aw * ps3_bw + ps_bw * ps3_aw + ps2_aw * ps2_bw) / safe
               + (ps_aw * ps2_bw * ps2_ww + ps_bw * ps2_aw * ps2_ww
                  + ps_aw * ps_bw * ps3_ww) / (safe * safe))
        rows.append(torch.where(ps_ww != 0.0, val, ps3_ab))
    return rows


def _weights(lam, eval_):
    v = lam[..., None] * eval_ + 1.0
    hi = 1.0 / v
    return v, hi


def _nc_total(n_cvt: int, calc_null: bool) -> int:
    return n_cvt if calc_null else n_cvt + 1


def _df(n: int, n_cvt: int, calc_null: bool) -> float:
    return float(n - n_cvt) if calc_null else float(n - n_cvt - 1)


def logf_const(n: int, n_cvt: int, calc_null: bool, reml: bool) -> float:
    """The λ-independent term of the (RE)ML log-likelihood."""
    if reml:
        df = _df(n, n_cvt, calc_null)
        return 0.5 * df * (math.log(df) - _LOG_2PI - 1.0)
    return 0.5 * n * (math.log(float(n)) - _LOG_2PI - 1.0)


def _clamp_p_yy(p_yy):
    return torch.where((p_yy >= 0.0) & (p_yy < P_YY_MIN),
                       torch.full_like(p_yy, P_YY_MIN), p_yy)


def logf(lam, data: LmmBatchData, n_cvt: int, calc_null: bool, reml: bool):
    """Log (restricted) likelihood at lambda (LogRL_f / LogL_f), Pab form.

    lam: (..., S); returns (..., S).
    """
    idx = pab_indices(n_cvt)
    n = data.eval.shape[0]
    nc_total = _nc_total(n_cvt, calc_null)

    v, hi = _weights(lam, data.eval)
    logdet_h = torch.sum(torch.log(torch.abs(v)), dim=-1)
    pab = _pab_rows(_base_row(hi, data, n_cvt), n_cvt)
    p_yy = _clamp_p_yy(pab[nc_total][..., idx.yy])
    c = logf_const(n, n_cvt, calc_null, reml)
    if reml:
        df = _df(n, n_cvt, calc_null)
        iab = (data.iab_logdiag if data.iab_logdiag is not None
               else _iab_logdiag(data, n_cvt))
        logdet_hiw = torch.zeros_like(p_yy)
        for i in range(nc_total):
            d = int(idx.diag[i])
            logdet_hiw = (logdet_hiw + torch.log(pab[i][..., d])
                          - iab[..., i])
        return c - 0.5 * logdet_h - 0.5 * logdet_hiw - 0.5 * df * torch.log(p_yy)
    return c - 0.5 * logdet_h - 0.5 * n * torch.log(p_yy)


def _cholesky_nan(G):
    """Lower Cholesky factor; NaN where G is not positive definite (as
    the reference's cholesky returns)."""
    L, info = torch.linalg.cholesky_ex(G)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def logf_stable(lam, data: LmmBatchData, n_cvt: int, calc_null: bool,
                reml: bool):
    """logf via an explicit weighted-GLS residual — float32-stable.

    The Pab recurrence computes p_yy = y'P(λ)y by subtracting nested
    projection quadratics that agree to ~7 digits at extreme λ; here the
    minimised quadratic is Σ hᵢ rᵢ² with r the GLS residual: sums of
    non-negative terms, no catastrophic cancellation.
    """
    n = data.eval.shape[0]
    lanes = per_lane(data)
    sw, sj, sy = ("kni", "knj", "kn") if lanes else ("ni", "nj", "n")
    W = data.UtWy[..., :n_cvt]                     # (n, c) or (S, n, c)
    y = data.UtWy[..., n_cvt]                      # (n,) or (S, n)
    v, hi = _weights(lam, data.eval)               # (..., S, n)
    logdet_h = torch.sum(torch.log(torch.abs(v)), dim=-1)

    Gww = torch.einsum(f"...kn,{sw},{sj}->...kij", hi, W, W)
    gwy = torch.einsum(f"...kn,{sw},{sy}->...ki", hi, W, y)
    x = data.Utx.expand(n_lanes(data), n) if lanes else data.Utx
    if calc_null:
        G = Gww
        rhs = gwy
    else:
        Gwx = torch.einsum(f"...kn,{sw},kn->...ki", hi, W, x)
        Gxx = torch.einsum("...kn,kn,kn->...k", hi, x, x)
        gxy = torch.einsum(f"...kn,kn,{sy}->...k", hi, x, y)
        top = torch.cat([Gww, Gwx[..., :, None]], dim=-1)
        bot = torch.cat([Gwx[..., None, :], Gxx[..., None, None]], dim=-1)
        G = torch.cat([top, bot], dim=-2)          # (..., S, c+1, c+1)
        rhs = torch.cat([gwy, gxy[..., None]], dim=-1)

    L = _cholesky_nan(G)
    beta = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    t = y - torch.einsum(f"{sw},...ki->...kn", W, beta[..., :n_cvt])
    if not calc_null:
        t = t - data.Utx * beta[..., n_cvt:n_cvt + 1]
    p_yy = _clamp_p_yy(torch.einsum("...kn,...kn->...k", hi, t * t))

    c = logf_const(n, n_cvt, calc_null, reml)
    if reml:
        df = _df(n, n_cvt, calc_null)
        ld = torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1)))
        logdet_hiw = 2.0 * torch.sum(ld, dim=-1)
        A0ww = (torch.einsum("kni,knj->kij", W, W) if lanes else W.T @ W)
        if calc_null:
            G0 = A0ww.expand(G.shape[:-2] + A0ww.shape[-2:])
        else:
            g0wx = torch.einsum(f"{sw},kn->ki", W, x)
            g0xx = torch.einsum("kn,kn->k", x, x)
            top0 = torch.cat([A0ww.expand(x.shape[:1] + A0ww.shape[-2:]),
                              g0wx[..., :, None]], dim=-1)
            bot0 = torch.cat([g0wx[..., None, :], g0xx[..., None, None]],
                             dim=-1)
            G0 = torch.cat([top0, bot0], dim=-2)
        L0 = _cholesky_nan(G0)
        ld0 = torch.log(torch.abs(torch.diagonal(L0, dim1=-2, dim2=-1)))
        logdet_hiw = logdet_hiw - 2.0 * torch.sum(ld0, dim=-1)
        return (c - 0.5 * logdet_h - 0.5 * logdet_hiw
                - 0.5 * df * torch.log(p_yy))
    return c - 0.5 * logdet_h - 0.5 * n * torch.log(p_yy)


def dev1(lam, data: LmmBatchData, n_cvt: int, calc_null: bool, reml: bool):
    """First derivative of the log (restricted) likelihood w.r.t. lambda."""
    n = data.eval.shape[0]
    _, hi = _weights(lam, data.eval)
    trace_hi = torch.sum(hi, dim=-1)
    row1, row2 = _base_rows_multi(hi, data, n_cvt, 2)
    pab = _pab_rows(row1, n_cvt)
    ppab = _ppab_rows(row2, pab, n_cvt)
    return _dev1_from_rows(lam, trace_hi, pab, ppab, n, n_cvt,
                           calc_null, reml)


def _dev1_from_rows(lam, trace_hi, pab, ppab, n: int, n_cvt: int,
                    calc_null: bool, reml: bool):
    idx = pab_indices(n_cvt)
    nc_total = _nc_total(n_cvt, calc_null)
    p_yy = pab[nc_total][..., idx.yy]
    pp_yy = ppab[nc_total][..., idx.yy]
    ypkpy = (p_yy - pp_yy) / lam
    if reml:
        df = _df(n, n_cvt, calc_null)
        trace_p = trace_hi
        for i in range(nc_total):
            d = int(idx.diag[i])
            trace_p = trace_p - ppab[i][..., d] / pab[i][..., d]
        trace_pk = (df - trace_p) / lam
        return -0.5 * trace_pk + 0.5 * df * ypkpy / p_yy
    trace_hik = (n - trace_hi) / lam
    return -0.5 * trace_hik + 0.5 * n * ypkpy / p_yy


class GridProducts(NamedTuple):
    """The two large products of the shared-λ grid scan, in the layout
    kernel K2 reads (SNP axis last, so its reads are coalesced)."""
    lam: torch.Tensor       # (G,)
    trace_hi: torch.Tensor  # (G,)
    shared: torch.Tensor    # (2, G, m_wy) x-free {W,y} rows; (2, G, m_wy, S)
                            # per lane
    xcross: torch.Tensor    # (2, G, c+1, S)
    xx: torch.Tensor        # (2, G, S)


def grid_products(grid_np, data: LmmBatchData, n_cvt: int) -> GridProducts:
    """Every x-involving base quantity at every grid point and both
    weight powers, from two products that read Utx once:
    xcross = (hi_g^p ⊙ UtWy)ᵀ Utxᵀ and xx = hi_g^p (Utx²)ᵀ.  With
    per-lane operands the x-free rows are per lane too, and both come
    from one (2G, n) @ (n, S·m) product each: shared from wy_prod,
    xcross from UtWy ⊙ Utx.  The grid is float64 numpy cast to the
    working dtype (a float32 grid moves the sign-change brackets)."""
    n = data.eval.shape[0]
    S = n_lanes(data)
    dtype, dev = data.eval.dtype, data.eval.device
    G = len(grid_np)
    lam = torch.as_tensor(np.asarray(grid_np), dtype=dtype, device=dev)
    hi = 1.0 / (lam[:, None] * data.eval + 1.0)             # (G, n)
    HiP = torch.stack([hi, hi * hi]).reshape(2 * G, n)      # (2G, n)
    trace_hi = torch.sum(hi, dim=-1)
    if per_lane(data):
        def lanes_last(A):                       # (S, n, m) → (2, G, m, S)
            m = A.shape[2]
            prod = HiP @ A.transpose(0, 1).reshape(n, S * m)
            return (prod.reshape(2 * G, S, m).permute(0, 2, 1)
                    .reshape(2, G, m, S).contiguous())
        shared = lanes_last(data.wy_prod)
        xcross = lanes_last(data.UtWy * data.Utx[..., None])
        xx = torch.matmul(HiP, (data.Utx * data.Utx).T)
        xx = xx.expand(2 * G, S).reshape(2, G, S).contiguous()
        return GridProducts(lam, trace_hi, shared, xcross, xx)
    shared = torch.matmul(HiP, data.wy_prod).reshape(2, G, -1)
    Wb = (HiP[:, None, :] * data.UtWy.T[None]).reshape(-1, n)  # (2G(c+1), n)
    xcross = torch.matmul(Wb, data.Utx.T).reshape(2, G, n_cvt + 1, S)
    xx = torch.matmul(HiP, (data.Utx * data.Utx).T).reshape(2, G, S)
    return GridProducts(lam, trace_hi, shared.contiguous(), xcross, xx)


def grid_epilogue_plain(gp: GridProducts, n: int, n_cvt: int,
                        calc_null: bool, reml: bool) -> torch.Tensor:
    """PyTorch version of K2: (G, S) dev1 from the grid products."""
    G, S = gp.xx.shape[1], gp.xx.shape[2]
    rows = []
    for p in range(2):
        if gp.shared.dim() == 4:
            shared = gp.shared[p].permute(0, 2, 1)           # (G, S, m)
        else:
            shared = gp.shared[p][:, None, :].expand(G, S, -1)
        xcross = gp.xcross[p].permute(0, 2, 1)               # (G, S, c+1)
        rows.append(_assemble(n_cvt, shared, gp.xx[p], xcross))
    pab = _pab_rows(rows[0], n_cvt)
    ppab = _ppab_rows(rows[1], pab, n_cvt)
    return _dev1_from_rows(gp.lam[:, None], gp.trace_hi[:, None], pab, ppab,
                           n, n_cvt, calc_null, reml)


def grid_epilogue_cuda(gp: GridProducts, n: int, n_cvt: int,
                       calc_null: bool, reml: bool) -> torch.Tensor:
    """K2 on the card: its register form up to 12 covariates, its warp
    form above, which alone reads the Pab index tables."""
    kernels.check_n_cvt(n_cvt)
    G, S = gp.xx.shape[1], gp.xx.shape[2]
    C1 = n_cvt + 1
    M = gp.shared.shape[2]
    wy_lane = gp.shared.dim() == 4
    f32 = torch.float32
    kernels.check_operand(gp.xcross, "xcross", f32, (2, G, C1, S))
    kernels.check_operand(gp.xx, "xx", f32, (2, G, S))
    kernels.check_operand(gp.shared, "shared", f32,
                          (2, G, M, S) if wy_lane else (2, G, M))
    kernels.check_operand(gp.trace_hi, "trace_hi", f32, (G,))
    kernels.check_operand(gp.lam, "lam", f32, (G,))
    dev = gp.xx.device
    kern = kernels.LAMBDA_GRID
    tab = (kernels.pab_tables(n_cvt, str(dev)).data_ptr()
           if kern.query("tables", n_cvt) else None)
    d1f = torch.empty((G, S), dtype=f32, device=dev)
    kern.launch_lanes(dev, S, kern.lane_bytes(n_cvt, G), lambda s0, k, w: (
        gp.xcross.data_ptr(), gp.xx.data_ptr(), gp.shared.data_ptr(),
        gp.trace_hi.data_ptr(), gp.lam.data_ptr(), tab, n_cvt, S, G, M, n,
        int(calc_null), int(reml), int(wy_lane), d1f.data_ptr(), s0, k, w))
    return d1f


def dev1_grid(grid_np, data: LmmBatchData, n_cvt: int, calc_null: bool,
              reml: bool) -> torch.Tensor:
    """dev1 at a FIXED vector of G shared lambda values, for every lane
    at once: returns (G, S).  The reference's interval scan
    (lmm.cpp:1967-1982, one SNP and one lambda at a time) as two
    products and one epilogue (K2 on the card)."""
    gp = grid_products(grid_np, data, n_cvt)
    n = data.eval.shape[0]
    if gp.xx.device.type == "cpu":
        return grid_epilogue_plain(gp, n, n_cvt, calc_null, reml)
    return grid_epilogue_cuda(gp, n, n_cvt, calc_null, reml)


def dev12(lam, data: LmmBatchData, n_cvt: int, calc_null: bool, reml: bool):
    """First and second derivatives (LogRL_dev12 / LogL_dev12)."""
    idx = pab_indices(n_cvt)
    n = data.eval.shape[0]
    nc_total = _nc_total(n_cvt, calc_null)

    _, hi = _weights(lam, data.eval)
    trace_hi = torch.sum(hi, dim=-1)
    trace_hihi = torch.sum(hi * hi, dim=-1)

    row1, row2, row3 = _base_rows_multi(hi, data, n_cvt, 3)
    pab = _pab_rows(row1, n_cvt)
    ppab = _ppab_rows(row2, pab, n_cvt)
    pppab = _pppab_rows(row3, pab, ppab, n_cvt)

    p_yy = pab[nc_total][..., idx.yy]
    pp_yy = ppab[nc_total][..., idx.yy]
    ppp_yy = pppab[nc_total][..., idx.yy]
    ypkpy = (p_yy - pp_yy) / lam
    ypkpkpy = (p_yy + ppp_yy - 2.0 * pp_yy) / (lam * lam)

    if reml:
        df = _df(n, n_cvt, calc_null)
        trace_p = trace_hi
        trace_pp = trace_hihi
        for i in range(nc_total):
            d = int(idx.diag[i])
            ps_ww = pab[i][..., d]
            ps2_ww = ppab[i][..., d]
            ps3_ww = pppab[i][..., d]
            trace_p = trace_p - ps2_ww / ps_ww
            trace_pp = (trace_pp + ps2_ww * ps2_ww / (ps_ww * ps_ww)
                        - 2.0 * ps3_ww / ps_ww)
        trace_pk = (df - trace_p) / lam
        trace_pkpk = (df + trace_pp - 2.0 * trace_p) / (lam * lam)
        d1 = -0.5 * trace_pk + 0.5 * df * ypkpy / p_yy
        d2 = (0.5 * trace_pkpk
              - 0.5 * df * (2.0 * ypkpkpy * p_yy - ypkpy * ypkpy)
              / (p_yy * p_yy))
        return d1, d2
    trace_hik = (n - trace_hi) / lam
    trace_hikhik = (n + trace_hihi - 2.0 * trace_hi) / (lam * lam)
    d1 = -0.5 * trace_hik + 0.5 * n * ypkpy / p_yy
    d2 = (0.5 * trace_hikhik
          - 0.5 * n * (2.0 * ypkpkpy * p_yy - ypkpy * ypkpy) / (p_yy * p_yy))
    return d1, d2


def wald_stats(lam, data: LmmBatchData, n_cvt: int):
    """beta, se, p_wald ingredients at the REML lambda (CalcRLWald).

    Returns (beta, se, f_stat, df): the F statistic feeds the F(1, df)
    survival function.
    """
    idx = pab_indices(n_cvt)
    n = data.eval.shape[0]
    df = float(n - n_cvt - 1)

    _, hi = _weights(lam, data.eval)
    pab = _pab_rows(_base_row(hi, data, n_cvt), n_cvt)

    p_xx = pab[n_cvt][..., idx.xx]
    p_xy = pab[n_cvt][..., idx.xy]
    px_yy = pab[n_cvt + 1][..., idx.yy]

    beta = p_xy / p_xx
    tau = df / px_yy
    se = torch.sqrt(1.0 / (tau * p_xx))
    # identically (p_yy - px_yy) * tau, but free of the cancellation
    # that saturated float32 p_wald at 1 for near-null SNPs
    f_stat = (p_xy * p_xy / p_xx) * tau
    return beta, se, f_stat, df


def score_stats(lam_null, data: LmmBatchData, n_cvt: int):
    """beta, se, score-test F statistic at the null MLE lambda
    (CalcRLScore, lmm.cpp:1163-1198)."""
    idx = pab_indices(n_cvt)
    n = data.eval.shape[0]
    df = float(n - n_cvt - 1)

    _, hi = _weights(lam_null, data.eval)
    pab = _pab_rows(_base_row(hi, data, n_cvt), n_cvt)

    p_yy = pab[n_cvt][..., idx.yy]
    p_xx = pab[n_cvt][..., idx.xx]
    p_xy = pab[n_cvt][..., idx.xy]
    px_yy = pab[n_cvt + 1][..., idx.yy]

    beta = p_xy / p_xx
    tau = df / px_yy
    se = torch.sqrt(1.0 / (tau * p_xx))
    f_stat = n * p_xy * p_xy / (p_yy * p_xx)
    return beta, se, f_stat, df


def wald_pvalues_plain(lam, data: LmmBatchData, n_cvt: int):
    """PyTorch version of K4: (beta, se, p_wald)."""
    beta, se, f_stat, df = wald_stats(lam, data, n_cvt)
    return beta, se, f_sf(f_stat, 1.0, df)


def _one_or_lanes(t: torch.Tensor, name: str, S: int) -> None:
    if t.numel() not in (1, S):
        raise ValueError(f"{name}: expected 1 or {S} values, got "
                         f"{t.numel()}")


def check_lane_operands(data: LmmBatchData, n_cvt: int, dt,
                         wy: bool = True) -> None:
    """Raise unless the block's operands are what the kernels take:
    shared (n, ·) or per lane (S, n, ·), Utx (S, n) or (1, n)."""
    S, n = n_lanes(data), data.eval.shape[0]
    lead = (S, n) if per_lane(data) else (n,)
    kernels.check_operand(data.eval, "eval", dt, (n,))
    kernels.check_operand(data.UtWy, "UtWy", dt, lead + (n_cvt + 1,))
    if wy:
        kernels.check_operand(data.wy_prod, "wy_prod", dt,
                              lead + (data.wy_prod.shape[-1],))
    if data.Utx.shape[0] not in (1, S):
        raise ValueError(f"Utx: expected 1 or {S} rows, got "
                         f"{data.Utx.shape[0]}")
    kernels.check_operand(data.Utx, "Utx", dt, (data.Utx.shape[0], n))


def _test_tail_cuda(k32, k64, lam, data: LmmBatchData, n_cvt: int):
    """K4 or K5 on the card, float32 or float64 (csrc/test_tail.cuh: a
    warp a lane, a tile of 8 lanes on DMMA or a block a lane, by c and
    the lane strides); λ is one per lane (S,) or one shared (1,)."""
    kernels.check_n_cvt(n_cvt)
    idx = pab_indices(n_cvt)
    S, n = n_lanes(data), data.eval.shape[0]
    M = data.wy_prod.shape[-1]
    dt = data.eval.dtype
    kern = kernels.variant(k32, k64, dt)
    kernels.check_operand(lam, "lam", dt)
    _one_or_lanes(lam, "lam", S)
    check_lane_operands(data, n_cvt, dt)
    dev = data.Utx.device
    tab = kernels.pab_tables(n_cvt, str(dev))
    beta = torch.empty(S, dtype=dt, device=dev)
    se = torch.empty_like(beta)
    p = torch.empty_like(beta)
    kern.launch_lanes(dev, S, kern.lane_bytes(n_cvt), lambda s0, k, w: (
        lam.data_ptr(), data.eval.data_ptr(), data.UtWy.data_ptr(),
        data.wy_prod.data_ptr(), data.Utx.data_ptr(), tab.data_ptr(), n_cvt,
        S, n, M, int(idx.xx), int(idx.xy), int(lam.numel() > 1),
        *lane_strides(data), beta.data_ptr(), se.data_ptr(), p.data_ptr(),
        s0, k, w))
    return beta, se, p


def wald_pvalues_cuda(lam, data: LmmBatchData, n_cvt: int):
    """K4 on the card (float64 operands: its f64 instantiation)."""
    kernels.check_operand(lam, "lam", lam.dtype, (n_lanes(data),))
    return _test_tail_cuda(kernels.WALD_TAIL, kernels.WALD_TAIL_F64, lam,
                           data, n_cvt)


def wald_pvalues(lam, data: LmmBatchData, n_cvt: int):
    """beta, se and p_wald = f_sf(f_stat, 1, df) at each lane's λ (K4 on
    the card)."""
    if lam.device.type == "cpu":
        return wald_pvalues_plain(lam, data, n_cvt)
    return wald_pvalues_cuda(lam, data, n_cvt)


def score_pvalues_plain(lam_null, data: LmmBatchData, n_cvt: int):
    """PyTorch version of K5: (beta, se, p_score) at the null λ: one
    shared by the lanes (a 0-d or one-element tensor) or one per lane
    (S,) (gene mode: each gene's own null)."""
    lam = lam_null.reshape(-1).expand(n_lanes(data))
    beta, se, f_stat, df = score_stats(lam, data, n_cvt)
    return beta, se, f_sf(f_stat, 1.0, df)


def score_pvalues_cuda(lam_null, data: LmmBatchData, n_cvt: int):
    """K5 on the card (float64 operands: its f64 instantiation)."""
    lam = lam_null.reshape(-1).contiguous()
    return _test_tail_cuda(kernels.SCORE_TAIL, kernels.SCORE_TAIL_F64, lam,
                           data, n_cvt)


def score_pvalues(lam_null, data: LmmBatchData, n_cvt: int):
    """beta, se and p_score = f_sf(f_stat, 1, df) of every lane at the
    null model's ML λ (K5 on the card)."""
    if data.eval.device.type == "cpu":
        return score_pvalues_plain(lam_null, data, n_cvt)
    return score_pvalues_cuda(lam_null, data, n_cvt)


# K6 modes: re-evaluate the ML logf with float64 sums, or take the tail
# of float64 logf values as given
LRT_RECOMPUTE, LRT_TAIL_ONLY = 1, 0


def lrt_pvalues_plain(lam, logf_H1, data: LmmBatchData, n_cvt: int,
                      l_mle_null, logl_H0):
    """PyTorch version of K6: (logl_H1, p_lrt).

    float64 operands (parity mode): p = chisq_sf(2 (logf_H1 − logl_H0),
    1) of the search's Pab-form values, as the reference computes it.
    float32 operands (speed mode): both ML log-likelihoods are evaluated
    again in the `logf_stable` form in float64 from the float32 operands
    — logf_H1 at each lane's float32 λ_mle, logl_H0 at the null's — since
    their difference is a cancellation of two O(n) float32 sums that the
    χ²(1) tail, infinitely steep at 0, turns into p-value errors of
    1e-2; λ enters only at second order (it is a stationary point).

    The null is the same block's covariate-only model (calc_null) at
    l_mle_null: one λ shared by the lanes, or one per lane (S,) where
    each lane has its own null (GxE, gene mode).  With l_mle_null None
    logl_H0 is taken as given in both modes."""
    dt = data.eval.dtype
    if dt == torch.float64:
        l1, l0 = logf_H1, logl_H0
    else:
        d64 = data._replace(eval=data.eval.double(), UtWy=data.UtWy.double(),
                            Utx=data.Utx.double())
        l1 = logf_stable(lam.double(), d64, n_cvt, False, False)
        l0 = (logl_H0.double() if l_mle_null is None else
              logf_stable(l_mle_null.double().reshape(-1), d64, n_cvt, True,
                          False))
    p = chisq_sf(2.0 * (l1 - l0), 1.0)
    return l1.to(dt), p.to(dt)


def lrt_null_cuda(l_mle_null, data: LmmBatchData, n_cvt: int):
    """K6's null launch on the card (speed mode): the float64 ML
    log-likelihood of the covariate-only model at l_mle_null, one λ
    shared by the lanes or one per lane (S,), in the logf_stable form
    from the float32 operands."""
    kernels.check_n_cvt(n_cvt)
    S, n = n_lanes(data), data.eval.shape[0]
    dev = data.eval.device
    lam0 = l_mle_null.reshape(-1).contiguous()
    kernels.check_operand(lam0, "l_mle_null", torch.float32)
    _one_or_lanes(lam0, "l_mle_null", S)
    check_lane_operands(data, n_cvt, torch.float32, wy=False)
    ustride, _, xstride = lane_strides(data)
    S0 = lam0.numel()
    l0 = torch.empty(S0, dtype=torch.float64, device=dev)
    kern = kernels.LRT_TAIL

    def args(s0, k, w):
        return (LRT_RECOMPUTE, lam0.data_ptr(), data.eval.data_ptr(),
                data.UtWy.data_ptr(), data.Utx.data_ptr(), n_cvt, S0, n, 1,
                ustride, xstride, logf_const(n, n_cvt, False, False), None,
                None, 0, l0.data_ptr(), None, s0, k, w)
    if S0 == 1:
        # one lane: n split over blocks, partial sums in scratch
        scratch = torch.empty(kern.query("null_bytes", n_cvt, n),
                              dtype=torch.uint8, device=dev)
        kern.launch(dev, *args(0, 1, scratch.data_ptr()))
    else:
        kern.launch_lanes(dev, S0, kern.lane_bytes(n_cvt), args)
    return l0


def lrt_pvalues_cuda(lam, logf_H1, data: LmmBatchData, n_cvt: int,
                     l_mle_null, logl_H0):
    """K6 on the card: twice in speed mode (the null lane(s), then the
    SNPs), once in parity mode or where logl_H0 is given."""
    kernels.check_n_cvt(n_cvt)
    S, n = n_lanes(data), data.eval.shape[0]
    dt = data.eval.dtype
    dev = data.eval.device
    f64 = torch.float64
    ustride, _, xstride = lane_strides(data)
    l1 = torch.empty(S, dtype=f64, device=dev)
    p = torch.empty(S, dtype=f64, device=dev)
    if dt == torch.float32:
        kernels.check_operand(lam, "lam", dt, (S,))
        check_lane_operands(data, n_cvt, dt, wy=False)
        c = logf_const(n, n_cvt, False, False)   # ML: no calc_null term
        ptrs = (data.eval.data_ptr(), data.UtWy.data_ptr(),
                data.Utx.data_ptr())
        kern = kernels.LRT_TAIL
        lane_bytes = kern.lane_bytes(n_cvt)
        if l_mle_null is None:
            l0 = logl_H0.to(f64).reshape(-1).contiguous()
        else:
            l0 = lrt_null_cuda(l_mle_null, data, n_cvt)
        kernels.check_operand(l0, "logl_H0", f64)
        _one_or_lanes(l0, "logl_H0", S)
        kern.launch_lanes(dev, S, lane_bytes, lambda s0, k, w: (
            LRT_RECOMPUTE, lam.data_ptr(), *ptrs, n_cvt, S, n, 0, ustride,
            xstride, c, None, l0.data_ptr(), int(l0.numel() > 1),
            l1.data_ptr(), p.data_ptr(), s0, k, w))
    elif dt == f64:
        kernels.check_operand(logf_H1, "logf_H1", dt, (S,))
        l0 = logl_H0.reshape(-1).contiguous()
        kernels.check_operand(l0, "logl_H0", dt)
        _one_or_lanes(l0, "logl_H0", S)
        kernels.LRT_TAIL.launch(
            dev, LRT_TAIL_ONLY, None, None, None, None, n_cvt, S, n, 0, 0, 0,
            0.0, logf_H1.data_ptr(), l0.data_ptr(), int(l0.numel() > 1),
            l1.data_ptr(), p.data_ptr(), 0, S, None)
    else:
        raise TypeError(f"lrt_tail takes float32 or float64, got {dt}")
    return l1.to(dt), p.to(dt)


def lrt_pvalues(lam, logf_H1, data: LmmBatchData, n_cvt: int, l_mle_null,
                logl_H0):
    """logl_H1 and p_lrt of every lane from its ML fit (λ_mle, logf_H1)
    and the null model's (l_mle_null, logl_H0) (K6 on the card)."""
    if data.eval.device.type == "cpu":
        return lrt_pvalues_plain(lam, logf_H1, data, n_cvt, l_mle_null,
                                 logl_H0)
    return lrt_pvalues_cuda(lam, logf_H1, data, n_cvt, l_mle_null, logl_H0)
