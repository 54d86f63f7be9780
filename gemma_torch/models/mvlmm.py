"""Multivariate LMM driver (-lmm with several -n columns).

GEMMA's analysis flow (MVLMM::AnalyzeBimbam/AnalyzePlink,
mvlmm.cpp:2972-3416) over the per-lane kernels of mvlmm_core:

  null model:  MphInitial (univariate REML diagonals, pairwise two-trait
               fits for d > 4) → EM('R') → NR('R') → B, se(B); again with
               'L' for the LRT null, starting from the REML fit.
  per SNP:     (Vg, Ve) reset to the ML null, a short EM (em_iter/10),
               the Wald/LRT/score p-value; SNPs with p < -pnr are fitted
               again (EM, then Newton-Raphson, nr_iter/10) and tested at
               that optimum; with -crt their Wald and LRT p-values take
               the Edgeworth correction there (K14, CalcCRT).

One K9 launch fits a whole block: every lane runs until it converges, so
nothing is compacted or padded.  The float32 speed mode reproduces the
reference's staged driver (mvlmm.py:173-272): its convergence test skips
each burst's first iteration, and lanes still running at the switch point
(224 EM iterations at the default -emi) finish with Newton-Raphson.  The
float64 parity mode keeps the reference's pure EM (staged for REML,
lockstep for ML, as the reference runs them).
"""

from __future__ import annotations

import numpy as np
import torch

from gemma_torch.models import mvlmm_core as core
from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm.engine import _vg_ve_beta
from gemma_torch.models.lmm.optimize import calc_lambda

_F64 = torch.float64


def _no_rows(X0: torch.Tensor) -> torch.Tensor:
    """A (1, 0, n) per-lane block: one lane whose design is X0 alone."""
    return X0.new_zeros((1, 0, X0.shape[1]))


def mph_initial(eval_, X, Y, l_min=1e-5, l_max=1e5, n_region=10,
                em_iter=10000, em_prec=1e-4, nr_iter=100, nr_prec=1e-4):
    """Initial (Vg, Ve, B), float64 (MphInitial, mvlmm.cpp:2763-2948):
    diagonals from a univariate REML fit per trait; for d > 4 the
    off-diagonals from pairwise two-trait EM + NR fits (K9, K11); B by
    GLS at the initial (Vg, Ve)."""
    d, c = Y.shape[0], X.shape[0]
    Xt = X.T.contiguous()
    vg, ve = [], []
    for i in range(d):
        data = lk.null_batch_data(eval_, Xt, Y[i], c)
        res = calc_lambda(data, c, calc_null=True, reml=True, l_min=l_min,
                          l_max=l_max, n_region=n_region)
        g, e, _, _ = _vg_ve_beta(eval_, Xt, Y[i], res.lam[0], c)
        vg.append(g.to(_F64))
        ve.append(e.to(_F64))
    Vg = torch.diag(torch.stack(vg))
    Ve = torch.diag(torch.stack(ve))
    if d > 4:
        # pairwise two-trait refits for the off-diagonals
        # (mvlmm.cpp:2805-2884), from the diagonals
        R0 = _no_rows(X)
        Vg0, Ve0 = Vg.clone(), Ve.clone()
        for i in range(d):
            for j in range(i + 1, d):
                sel = [i, j]
                Ys = Y[sel].contiguous()
                em = core.mph_em(True, em_iter, em_prec, eval_, X, Ys, R0,
                                 Vg0[sel][:, sel][None],
                                 Ve0[sel][:, sel][None],
                                 torch.zeros((1, 2, c), dtype=_F64,
                                             device=X.device))
                Vg_s, Ve_s, _, _ = core.mph_nr(True, nr_iter, nr_prec, eval_,
                                               X, Ys, R0, em.Vg, em.Ve)
                Vg[i, j] = Vg[j, i] = Vg_s[0, 0, 1]
                Ve[i, j] = Ve[j, i] = Ve_s[0, 0, 1]
    B, _ = core.mph_calc_beta(eval_, X, Y, Vg, Ve)
    return Vg, Ve, B


class MvlmmNull:
    """Null-model fits under both criteria (S = 1 launches of K9, K11)."""

    def __init__(self, eval_, X0, Y, cfg):
        d = Y.shape[0]
        R0 = _no_rows(X0)
        Vg, Ve, B = mph_initial(
            eval_, X0, Y, l_min=cfg.l_min, l_max=cfg.l_max,
            n_region=cfg.n_region, em_iter=cfg.em_iter, em_prec=cfg.em_prec,
            nr_iter=cfg.nr_iter, nr_prec=cfg.nr_prec)
        em = core.mph_em(True, cfg.em_iter, cfg.em_prec, eval_, X0, Y, R0,
                         Vg[None], Ve[None], B[None])
        Vg, Ve, logl_r, Hvar = core.mph_nr(True, cfg.nr_iter, cfg.nr_prec,
                                           eval_, X0, Y, R0, em.Vg, em.Ve)
        Vg, Ve = Vg[0], Ve[0]
        B_r, se_B_r = core.mph_calc_beta(eval_, X0, Y, Vg, Ve)
        self.Vg_remle, self.Ve_remle = Vg, Ve
        self.B_remle, self.se_B_remle = B_r, se_B_r
        self.logl_remle_H0 = float(logl_r[0])
        v_size = d * (d + 1) // 2
        hv = torch.diagonal(Hvar[0]).cpu().numpy()
        self.VVg_remle, self.VVe_remle = hv[:v_size], hv[v_size:]

        em = core.mph_em(False, cfg.em_iter, cfg.em_prec, eval_, X0, Y, R0,
                         Vg[None], Ve[None], B_r[None])
        Vg2, Ve2, logl_m, _ = core.mph_nr(False, cfg.nr_iter, cfg.nr_prec,
                                          eval_, X0, Y, R0, em.Vg, em.Ve)
        Vg2, Ve2 = Vg2[0], Ve2[0]
        B_m, se_B_m = core.mph_calc_beta(eval_, X0, Y, Vg2, Ve2)
        self.Vg_mle, self.Ve_mle = Vg2, Ve2
        self.B_mle, self.se_B_mle = B_m, se_B_m
        self.logl_mle_H0 = float(logl_m[0])
        # per-SNP fits start from the MLE null (mvlmm.cpp:3206-3208)
        self.Vg_start, self.Ve_start = Vg2, Ve2
        self.B_start = torch.cat([B_m, B_m.new_zeros((d, 1))], dim=1)


class _Iters:
    """The per-SNP iteration budgets: a tenth of the null's
    (mvlmm.cpp:3197-3200)."""

    def __init__(self, cfg):
        self.em_iter = max(cfg.em_iter // 10, 1)
        self.em_prec = cfg.em_prec * 10
        self.nr_iter = max(cfg.nr_iter // 10, 1)
        self.nr_prec = cfg.nr_prec * 10


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _em_fit(reml: bool, it: _Iters, eval_, X0, Y, R, Vg0, Ve0, B0,
            staged: bool, switch: bool):
    """One K9 launch over the block; with `switch` (float32 speed mode)
    the lanes still running at the reference's switch point go on with
    Newton-Raphson (K11).  Returns (Vg, Ve, logl, K9's iteration counts)."""
    cap = it.em_iter
    at = core.nr_switch_point(it.em_iter) if switch else None
    if at is not None:
        cap = at
    em = core.mph_em(reml, cap, it.em_prec, eval_, X0, Y, R, Vg0, Ve0, B0,
                     staged=staged)
    Vg, Ve, logl = em.Vg, em.Ve, em.logl
    if at is not None:
        idx = torch.nonzero(~em.done).flatten()
        if idx.numel():
            Vg2, Ve2, l2, _ = core.mph_nr(reml, it.nr_iter, it.nr_prec,
                                          eval_, X0, Y, R[idx].contiguous(),
                                          Vg[idx], Ve[idx])
            Vg, Ve, logl = Vg.clone(), Ve.clone(), logl.clone()
            Vg[idx], Ve[idx], logl[idx] = Vg2, Ve2, l2
    return Vg, Ve, logl, em.iters


def _out(S: int, d: int) -> dict:
    """The block's results; em_iters holds each lane's K9 iteration count
    in the ML (column 0) and REML (column 1) fit of its test, -1 where
    the mode runs none, and refined whether the -pnr refit took the lane
    in that fit."""
    return dict(p_wald=np.zeros(S), p_lrt=np.zeros(S), p_score=np.zeros(S),
                beta=np.zeros((S, d)), Vbeta=np.zeros((S, d, d)),
                em_iters=np.full((S, 2), -1, np.int64),
                refined=np.zeros((S, 2), bool))


def _put(out: dict, cp: core.CalcP, idx=None, p_key=None, p=None) -> None:
    """Store beta/Vbeta (and a p column) of a K10 result, at idx."""
    sel = slice(None) if idx is None else idx
    out["beta"][sel] = _np(cp.beta)
    out["Vbeta"][sel] = _np(cp.Vbeta)
    if p_key is not None:
        out[p_key][sel] = _np(p)


def mvlmm_assoc(eval_, X0, Y, Utx, null: MvlmmNull, mode: int, cfg,
                dtype) -> dict:
    """Association statistics of one rotated (S, n) SNP block: the mode
    logic of mvlmm.cpp:3298-3353 with the p < -pnr refinement.  Returns
    host arrays p_wald/p_lrt/p_score (S,), beta (S, d), Vbeta (S, d, d)
    and em_iters and refined (S, 2) (see _out)."""
    d, S = Y.shape[0], Utx.shape[0]
    it = _Iters(cfg)
    speed = dtype == torch.float32
    R = Utx[:, None, :].contiguous()
    Vs, Es, B0 = null.Vg_start[None], null.Ve_start[None], null.B_start[None]
    l0 = torch.tensor([null.logl_mle_H0], dtype=_F64, device=Utx.device)
    crt = getattr(cfg, "crt", 0) == 1
    out = _out(S, d)

    def refine(reml: bool, p: np.ndarray):
        """EM then NR from the null start, and the test at that optimum,
        for the lanes with p < -pnr (mvlmm.cpp:3302-3353); with -crt the
        p-value (Wald for REML, LRT for ML) takes the Edgeworth
        correction at that optimum (K14; the reference's
        mvlmm.py:484-506).  Returns (K10's result, the refined p, idx)."""
        idx = np.flatnonzero(p < cfg.p_nr)
        out["refined"][idx, int(reml)] = True
        if not len(idx):
            return None, None, idx
        Ri = R[torch.as_tensor(idx, device=R.device)].contiguous()
        em = core.mph_em(reml, it.em_iter, it.em_prec, eval_, X0, Y, Ri, Vs,
                         Es, B0)
        Vg2, Ve2, l2, Hvar = core.mph_nr(reml, it.nr_iter, it.nr_prec,
                                         eval_, X0, Y, Ri, em.Vg, em.Ve)
        cp = core.mph_calc_p(eval_, X0, Y, Ri, Vg2, Ve2,
                             *((None, None) if reml else (l2, l0)))
        p2 = _np(cp.p if reml else cp.p_lrt)
        if crt:
            abc = core.calc_crt(eval_, X0, Ri, Vg2, Ve2, Hvar)
            p2 = core.pcrt(1 if reml else 2, d, p2, *(_np(t) for t in abc))
        return cp, p2, idx

    if mode in (3, 4):
        cp = core.mph_calc_p(eval_, X0, Y, R, Vs, Es)
        _put(out, cp, p_key="p_score", p=cp.p)
    if mode in (2, 4):
        # float32: staged, with the Newton finisher; float64: lockstep
        Vg, Ve, logl, iters = _em_fit(False, it, eval_, X0, Y, R, Vs, Es,
                                      B0, staged=speed, switch=speed)
        out["em_iters"][:, 0] = iters.cpu().numpy()
        cp = core.mph_calc_p(eval_, X0, Y, R, Vg, Ve, logl, l0)
        _put(out, cp, p_key="p_lrt", p=cp.p_lrt)
        cp2, p2, idx = refine(False, out["p_lrt"])
        if cp2 is not None:
            _put(out, cp2, idx)
            out["p_lrt"][idx] = p2
    if mode in (1, 4):
        Vg, Ve, _, iters = _em_fit(True, it, eval_, X0, Y, R, Vs, Es, B0,
                                   staged=True, switch=speed)
        out["em_iters"][:, 1] = iters.cpu().numpy()
        cp = core.mph_calc_p(eval_, X0, Y, R, Vg, Ve)
        _put(out, cp, p_key="p_wald", p=cp.p)
        cp2, p2, idx = refine(True, out["p_wald"])
        if cp2 is not None:
            _put(out, cp2, idx)
            out["p_wald"][idx] = p2
    return out


def mvlmm_assoc_gxe(eval_, X0e, Y, Utx, Utxe, null: MvlmmNull, mode: int,
                    cfg, dtype) -> dict:
    """GxE association of one rotated block (MVLMM::AnalyzeBimbamGXE,
    mvlmm.cpp:3970-4416).  X0e holds [UtW; Ut env]; each lane's null adds
    its x ([W, env, x]) and its H1 also x∘env, the tested row.  For mode
    4 the REML refit of the per-SNP null seeds its ML refit, and that
    seeds H1 (mvlmm.cpp:4268-4352); mode 3's score needs no refit.  -crt
    is not read here, as in the reference (ROADMAP §C17)."""
    d, S = Y.shape[0], Utx.shape[0]
    it = _Iters(cfg)
    R1 = Utx[:, None, :].contiguous()
    R2 = torch.stack([Utx, Utxe], dim=1).contiguous()
    Vs, Es = null.Vg_start[None], null.Ve_start[None]
    B_h0 = null.B_start[None]
    B_h1 = torch.cat([null.B_start, null.B_start.new_zeros((d, 1))],
                     dim=1)[None]
    out = _out(S, d)

    Vg1, Ve1, logl_H0 = Vs, Es, None
    if mode in (2, 4):
        V0, E0 = Vs, Es
        if mode == 4:
            em = core.mph_em(True, it.em_iter, it.em_prec, eval_, X0e, Y, R1,
                             Vs, Es, B_h0)
            V0, E0, _, _ = core.mph_nr(True, it.nr_iter, it.nr_prec, eval_,
                                       X0e, Y, R1, em.Vg, em.Ve)
        em = core.mph_em(False, it.em_iter, it.em_prec, eval_, X0e, Y, R1,
                         V0, E0, B_h0)
        Vg1, Ve1, logl_H0, _ = core.mph_nr(False, it.nr_iter, it.nr_prec,
                                           eval_, X0e, Y, R1, em.Vg, em.Ve)

    def refine(reml: bool, p: np.ndarray, em: core.EmResult):
        """NR from the H1 EM's optimum for the lanes with p < -pnr."""
        idx = np.flatnonzero(p < cfg.p_nr)
        out["refined"][idx, int(reml)] = True
        if not len(idx):
            return None, idx
        ti = torch.as_tensor(idx, device=R2.device)
        Ri = R2[ti].contiguous()
        Vg2, Ve2, l2, _ = core.mph_nr(reml, it.nr_iter, it.nr_prec, eval_,
                                      X0e, Y, Ri, em.Vg[ti], em.Ve[ti])
        lrt = (None, None) if reml else (l2, logl_H0[ti])
        return core.mph_calc_p(eval_, X0e, Y, Ri, Vg2, Ve2, *lrt), idx

    if mode in (3, 4):
        cp = core.mph_calc_p(eval_, X0e, Y, R2, Vs, Es)
        _put(out, cp, p_key="p_score", p=cp.p)
    if mode in (2, 4):
        em = core.mph_em(False, it.em_iter, it.em_prec, eval_, X0e, Y, R2,
                         Vg1, Ve1, B_h1)
        out["em_iters"][:, 0] = em.iters.cpu().numpy()
        cp = core.mph_calc_p(eval_, X0e, Y, R2, em.Vg, em.Ve, em.logl,
                             logl_H0)
        _put(out, cp, p_key="p_lrt", p=cp.p_lrt)
        cp2, idx = refine(False, out["p_lrt"], em)
        if cp2 is not None:
            _put(out, cp2, idx, "p_lrt", cp2.p_lrt)
    if mode in (1, 4):
        em = core.mph_em(True, it.em_iter, it.em_prec, eval_, X0e, Y, R2,
                         Vg1, Ve1, B_h1)
        out["em_iters"][:, 1] = em.iters.cpu().numpy()
        cp = core.mph_calc_p(eval_, X0e, Y, R2, em.Vg, em.Ve)
        _put(out, cp, p_key="p_wald", p=cp.p)
        cp2, idx = refine(True, out["p_wald"], em)
        if cp2 is not None:
            _put(out, cp2, idx, "p_wald", cp2.p)
    return out
