"""Batched lambda optimisation: interval scan + Brent/Newton polish.

Replicates the control flow of GEMMA's `CalcLambda` (lmm.cpp:1945-2140)
for a whole SNP block, as the reference package's
gemma_tpu/models/lmm/optimize.py does:

  1. evaluate d logL / d lambda on a log-spaced grid in [l_min, l_max];
     intervals where the sign changes are root brackets,
  2. for each bracket, in interval order, find a root:
     * float64 (parity mode): GSL Brent-Dekker to 1e-1 relative width,
       then Newton to 1e-5 with GEMMA's quirks — the second-to-last
       iterate is kept (lmm.cpp:2096) and a Newton sequence that leaves
       (l_min, l_max) or hits a non-finite value poisons the SNP with
       NaN (lmm.cpp:2078-2094);
     * float32 (speed mode): a 16x finer shared grid (dev1_grid) narrows
       each bracket to a fine sub-interval, Newton starts from its
       geometric midpoint with tolerance 5e-4 and falls back to that
       midpoint when it fails,
  3. keep the root with the best log-likelihood (first accepted
     unconditionally, later ones on strict improvement), then compare
     with the endpoints l_min/l_max on strict improvement.

In float32 on the card the grid epilogue is kernel K2 and everything
after the grid scan — brackets, Newton over dev12, logf_stable at the
candidates and the endpoints — is kernel K3 (csrc/lambda_solve.cu);
`lambda_solve_plain` is its plain version.  Where each lane has its own
operands (GxE, gene mode) K3 runs that search with float64 sums from the
float32 operands and Newton to 1e-5: a gene's or a GxE lane's likelihood
is often flat at small λ, where float32 picks the wrong candidate
(scripts/lane_f32_gap.py).  In float64 on the card the whole search —
the per-point dev1 scan, Brent, Newton, the Pab-form logf — is kernel K7
(csrc/lambda_solve_f64.cu); `lambda_solve_f64_plain` is its plain
version.  Both step several SNP lanes a thread block together through
csrc/lane_search.cuh (`search_geometry` mirrors its layout).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from gemma_torch import kernels
from gemma_torch.models.lmm import likelihood as lk

_BRENT_MAX_ITER = 100
_NEWTON_MAX_ITER = 100
_BRENT_EPSREL = 1e-1
_NEWTON_EPSREL = 1e-5
# float32 speed mode: Newton tolerance above the derivative's noise
# floor, and sub-intervals per coarse grid interval of the fine scan
_F32_NEWTON_EPSREL = 5e-4
_F32_GRID_REFINE = 16


class LambdaResult(NamedTuple):
    lam: torch.Tensor   # (S,)
    logf: torch.Tensor  # (S,)


def _brent_batched(f: Callable, lo, hi, flo, fhi, active, count=None):
    """Vectorised Brent-Dekker root finding on brackets [lo, hi].

    Stops a lane once GSL's interval test (epsabs=0, epsrel=1e-1)
    passes.  Returns (root, converged, cap_hit).  `count` (S,), where
    given, gains one for each evaluation a lane used.
    """
    eps = torch.finfo(lo.dtype).eps
    a, b, c, fa, fb, fc = lo, hi, hi, flo, fhi, fhi
    d = hi - lo
    e = hi - lo
    converged = torch.zeros_like(active)

    def interval_ok(b, c):
        xlo = torch.minimum(b, c)
        xhi = torch.maximum(b, c)
        straddle = ((xlo > 0) & (xhi > 0)) | ((xlo < 0) & (xhi < 0))
        min_abs = torch.where(straddle,
                              torch.minimum(xlo.abs(), xhi.abs()),
                              torch.zeros_like(xlo))
        return (xhi - xlo).abs() < _BRENT_EPSREL * min_abs

    def nz(v):
        return torch.where(v != 0, v, torch.ones_like(v))

    it = 0
    while it < _BRENT_MAX_ITER and bool((active & ~converged).any()):
        live = active & ~converged
        a0, b0, c0, fa0, fb0, fc0, d0, e0 = a, b, c, fa, fb, fc, d, e

        same_side = ((fb < 0) & (fc < 0)) | ((fb > 0) & (fc > 0))
        ac_equal = same_side
        c = torch.where(same_side, a, c)
        fc = torch.where(same_side, fa, fc)
        d = torch.where(same_side, b - a, d)
        e = torch.where(same_side, b - a, e)

        swap = fc.abs() < fb.abs()
        ac_equal = ac_equal | swap
        a2 = torch.where(swap, b, a)
        b2 = torch.where(swap, c, b)
        c2 = torch.where(swap, a2, c)
        fa2 = torch.where(swap, fb, fa)
        fb2 = torch.where(swap, fc, fb)
        fc2 = torch.where(swap, fa2, fc)
        a, b, c, fa, fb, fc = a2, b2, c2, fa2, fb2, fc2

        tol = 0.5 * eps * b.abs()
        m = 0.5 * (c - b)
        early = (fb == 0) | (m.abs() <= tol)

        bisect = (e.abs() < tol) | (fa.abs() <= fb.abs())
        s_r = fb / nz(fa)
        p_2 = 2.0 * m * s_r
        q_2 = 1.0 - s_r
        q_3 = fa / nz(fc)
        r_3 = fb / nz(fc)
        p_3 = s_r * (2.0 * m * q_3 * (q_3 - r_3) - (b - a) * (r_3 - 1.0))
        q3b = (q_3 - 1.0) * (r_3 - 1.0) * (s_r - 1.0)
        p = torch.where(ac_equal, p_2, p_3)
        q = torch.where(ac_equal, q_2, q3b)
        q = torch.where(p > 0, -q, q)
        p = torch.where(p > 0, p, -p)
        interp_ok = 2.0 * p < torch.minimum(3.0 * m * q - (tol * q).abs(),
                                            (e * q).abs())
        d_new = torch.where(interp_ok, p / nz(q), m)
        e_new = torch.where(interp_ok, d, m)
        d_new = torch.where(bisect, m, d_new)
        e_new = torch.where(bisect, m, e_new)

        step = torch.where(d_new.abs() > tol, d_new,
                           torch.where(m > 0, tol, -tol))
        b_n = b + step
        b_eval = torch.where(live & ~early, b_n, torch.ones_like(b_n))
        fb_n = f(b_eval)
        if count is not None:
            count += live & ~early

        do_step = live & ~early
        do_early = live & early

        def commit(step_v, early_v, old_v):
            return torch.where(do_step, step_v,
                               torch.where(do_early, early_v, old_v))

        a_out = commit(b, a, a0)
        b_out = commit(b_n, b, b0)
        c_out = commit(c, c, c0)
        fa_out = commit(fb, fa, fa0)
        fb_out = commit(fb_n, fb, fb0)
        fc_out = commit(fc, fc, fc0)
        d_out = commit(d_new, d, d0)
        e_out = commit(e_new, e, e0)

        conv_now = (do_step & interval_ok(b_out, c_out)) | do_early
        converged = converged | conv_now
        a, b, c, fa, fb, fc, d, e = (a_out, b_out, c_out, fa_out, fb_out,
                                     fc_out, d_out, e_out)
        it += 1

    cap_hit = active & ~converged
    return b, converged, cap_hit


def _newton_batched(fdf: Callable, x0, active, l_min: float, l_max: float,
                    epsrel: float = _NEWTON_EPSREL, count=None, steps=None):
    """Vectorised GSL-Newton polish with GEMMA's exit semantics.

    Returns (root = second-to-last iterate, converged, failed).
    `failed` lanes must be reported as NaN (lmm.cpp:2087-2094).  `count`
    and `steps` (S,), where given, gain one for each evaluation and each
    iteration a lane used.
    """
    f, df = fdf(x0)
    if count is not None:
        count += active
    x_prev, x = x0, x0
    converged = torch.zeros_like(active)
    failed = torch.zeros_like(active)
    it = 0
    while it < _NEWTON_MAX_ITER and bool((active & ~converged
                                          & ~failed).any()):
        live = active & ~converged & ~failed
        if count is not None:
            count += live
            steps += live
        zero_div = df == 0.0
        step_x = x - f / torch.where(zero_div, torch.ones_like(df), df)
        f_new, df_new = fdf(step_x)
        bad = ~torch.isfinite(f_new) | ~torch.isfinite(df_new)
        # GSL test_delta(x1=new, x0=old, epsabs=0, epsrel)
        conv = ((step_x - x).abs() < epsrel * step_x.abs()) | (step_x == x)
        oob = ~((step_x > l_min) & (step_x < l_max))

        fail_now = live & (zero_div | bad | (~conv & oob))
        conv_now = live & ~zero_div & ~bad & conv

        cont = live & ~fail_now & ~conv_now
        moved = live & ~zero_div
        x_prev = torch.where(moved, x, x_prev)
        x = torch.where(moved, step_x, x)
        f = torch.where(cont, f_new, f)
        df = torch.where(cont, df_new, df)
        converged = converged | conv_now
        failed = failed | fail_now
        it += 1
    # lanes still live at the iteration cap exited with GSL_CONTINUE → NaN
    cap_failed = active & ~converged & ~failed
    return x_prev, converged, failed | cap_failed


def fine_grid(l_min: float, l_max: float, n_region: int,
              refine: int) -> np.ndarray:
    """The log-spaced scan grid, in float64 numpy."""
    step = np.log(l_max / l_min) / n_region
    return l_min * np.exp((step / refine) * np.arange(n_region * refine + 1))


def _bracket_search(d1f, fine_np, data: lk.LmmBatchData, n_cvt: int,
                    calc_null: bool, reml: bool, l_min: float, l_max: float,
                    n_region: int, refine: int, strict: bool,
                    epsrel: float | None = None,
                    stats: dict | None = None) -> LambdaResult:
    """Steps 2-3 for every lane from the grid's dev1 values d1f
    (n_region·refine + 1, S).  `stats`, where given, receives per lane
    the evaluations the search used ("evals", added to any it holds),
    its Newton iterations ("newton_steps") and its sign-change intervals
    ("intervals")."""
    dtype, dev = d1f.dtype, d1f.device
    S = d1f.shape[1]
    if epsrel is None:
        epsrel = _NEWTON_EPSREL if strict else _F32_NEWTON_EPSREL

    def f_dev1(lam):
        return lk.dev1(lam, data, n_cvt, calc_null, reml)

    def f_dev12(lam):
        return lk.dev12(lam, data, n_cvt, calc_null, reml)

    f_logf = lk.logf if strict else lk.logf_stable

    def logf_at(lam):
        return f_logf(lam, data, n_cvt, calc_null, reml)

    d1 = d1f[::refine]                              # coarse points
    grid = torch.as_tensor(fine_np[::refine], dtype=dtype, device=dev)
    fine = torch.as_tensor(fine_np, dtype=dtype, device=dev)
    sign_change = d1[:-1] * d1[1:] <= 0.0           # (n_region, S)
    num_changes = sign_change.sum(dim=0)
    sign_change_f = d1f[:-1] * d1f[1:] <= 0.0       # (n_fine, S)
    csum = torch.cumsum(sign_change.int(), dim=0)
    g_iota = torch.arange(n_region, device=dev)[:, None]
    gp_iota = torch.arange(n_region + 1, device=dev)[:, None]
    f_iota = torch.arange(n_region * refine, device=dev)[:, None]

    def bracket_at(j):
        """(lo, hi, flo, fhi) of each lane's j-th sign-change interval;
        lanes with fewer changes get unused dummies."""
        onehot = sign_change & (csum == j + 1)
        iv = (g_iota * onehot).sum(dim=0)
        if strict:
            sel_lo = (gp_iota == iv[None]).to(dtype)
            sel_hi = (gp_iota == iv[None] + 1).to(dtype)
            return ((grid[:, None] * sel_lo).sum(0),
                    (grid[:, None] * sel_hi).sum(0),
                    (d1 * sel_lo).sum(0), (d1 * sel_hi).sum(0))
        # leftmost sign-changing fine sub-interval (argmax = first True)
        window = ((f_iota >= iv[None] * refine)
                  & (f_iota < (iv[None] + 1) * refine) & sign_change_f)
        jf = torch.argmax(window.to(torch.int8), dim=0)
        return (fine[jf], fine[jf + 1], d1f.gather(0, jf[None])[0],
                d1f.gather(0, jf[None] + 1)[0])

    count = steps = None
    if stats is not None:
        count = stats.setdefault("evals", torch.zeros(S, dtype=torch.long,
                                                      device=dev))
        steps = torch.zeros_like(count)
        stats.update(newton_steps=steps, intervals=num_changes)
    best_logf = torch.full((S,), -float("inf"), dtype=dtype, device=dev)
    best_lam = torch.full((S,), float("nan"), dtype=dtype, device=dev)
    has_cand = torch.zeros(S, dtype=torch.bool, device=dev)
    failed = torch.zeros_like(has_cand)
    stopped = torch.zeros_like(has_cand)
    for j in range(n_region):
        active = (j < num_changes) & ~stopped & ~failed
        if not bool(active.any()):
            break
        lo, hi, flo, fhi = bracket_at(j)
        if strict:
            root_b, brent_conv, brent_cap = _brent_batched(
                f_dev1, lo, hi, flo, fhi, active, count)
        else:
            root_b = torch.sqrt(lo * hi)
            brent_conv = torch.ones_like(active)
            brent_cap = torch.zeros_like(active)
        newton_active = active & brent_conv
        root_n, nt_conv, nt_failed = _newton_batched(
            f_dev12, root_b, newton_active, l_min, l_max, epsrel=epsrel,
            count=count, steps=steps)
        if strict:
            cand_ok = newton_active & nt_conv
        else:
            root_n = torch.where(nt_conv, root_n, root_b)
            nt_failed = torch.zeros_like(nt_failed)
            cand_ok = newton_active
        l_cand = torch.clamp(root_n, l_min, l_max)
        logf_cand = logf_at(l_cand)
        if count is not None:
            count += cand_ok
        accept = cand_ok & (~has_cand | (logf_cand > best_logf))
        best_logf = torch.where(accept, logf_cand, best_logf)
        best_lam = torch.where(accept, l_cand, best_lam)
        has_cand = has_cand | cand_ok
        failed = failed | (newton_active & nt_failed)
        stopped = stopped | brent_cap

    # endpoint comparison (lmm.cpp:1985-2000 and 2121-2136)
    logf_lmin = logf_at(torch.full((S,), l_min, dtype=dtype, device=dev))
    logf_lmax = logf_at(torch.full((S,), l_max, dtype=dtype, device=dev))
    if count is not None:
        count += 2 * ~failed
    take_min = logf_lmin > best_logf
    best_logf = torch.where(take_min, logf_lmin, best_logf)
    best_lam = torch.where(take_min, torch.full_like(best_lam, l_min),
                           best_lam)
    take_max = logf_lmax > best_logf
    best_logf = torch.where(take_max, logf_lmax, best_logf)
    best_lam = torch.where(take_max, torch.full_like(best_lam, l_max),
                           best_lam)
    nan = torch.full_like(best_lam, float("nan"))
    return LambdaResult(lam=torch.where(failed, nan, best_lam),
                        logf=torch.where(failed, nan, best_logf))


def _widened(data: lk.LmmBatchData) -> lk.LmmBatchData:
    """The float32 operands as float64, for sums in float64."""
    return data._replace(eval=data.eval.double(), UtWy=data.UtWy.double(),
                         wy_prod=data.wy_prod.double(),
                         Utx=data.Utx.double(), iab_logdiag=None)


def lambda_solve_plain(d1f, fine_np, data: lk.LmmBatchData, n_cvt: int,
                       calc_null: bool, reml: bool, l_min: float,
                       l_max: float, n_region: int, wide: bool = False,
                       stats: dict | None = None) -> LambdaResult:
    """PyTorch version of K3: the float32 bracket/Newton/logf_stable
    search from the fine grid's dev1 values.  `wide`: the same search in
    float64 from the float32 operands, Newton to 1e-5, rounded to
    float32 at the end (K3's per-lane instantiation).  `stats`: as
    _bracket_search."""
    if not wide:
        return _bracket_search(d1f, fine_np, data, n_cvt, calc_null, reml,
                               l_min, l_max, n_region, _F32_GRID_REFINE,
                               strict=False, stats=stats)
    r = _bracket_search(d1f.double(), fine_np, _widened(data), n_cvt,
                        calc_null, reml, l_min, l_max, n_region,
                        _F32_GRID_REFINE, strict=False,
                        epsrel=_NEWTON_EPSREL, stats=stats)
    return LambdaResult(lam=r.lam.float(), logf=r.logf.float())


# csrc/lane_search.cuh: threads a block, lanes a block at most, orders,
# a lane's scalar sums, the first tile's rows, the opt-in shared memory of
# an H100 block and the bytes within which a block keeps UtWy resident;
# the covariate count above which the working sets go to scratch
LS_THREADS, LS_LMAX, LS_PMAX, LS_NSC, LS_TR = 256, 8, 3, 6, 64
LS_SMEM_MAX, LS_RESIDENT_MAX, GT_WIDE_CVT = 232448, 102400, 32
# the row-split sums (c <= 1): flat positions at most, a thread's sums;
# the rows a thread adds before its running sums (row-split, columns)
LS_ROWS_NI = 6
LS_ROWS_NS = LS_PMAX * LS_ROWS_NI + LS_NSC
LS_ROWS_BLOCK, LS_FOLD_ROWS = 16, 64


def _r16(b: int) -> int:
    return (b + 15) // 16 * 16


def search_layout(n_cvt: int, n: int, L: int, TR: int, tin: int, t: int,
                  gram: bool, ws_smem: bool, resident: bool) -> dict:
    """ls_layout of csrc/lane_search.cuh: the byte offsets of a block's
    shared-memory parts, in order, its total ("bytes"), a lane's working
    set ("ws_bytes") and the sums' thread geometry: "rows" (each team's
    threads split its lane's rows, c <= 1), else "items" of two columns,
    "slices" of a tile's rows, "passes" over n."""
    C1 = n_cvt + 1
    ni, M = (n_cvt + 3) * (n_cvt + 2) // 2, C1 * (C1 + 1) // 2
    items = (M + 1) // 2 + (C1 + 1) // 2
    rows = ni <= LS_ROWS_NI
    if items <= LS_THREADS:
        cap = min(LS_THREADS // items, TR // (16 // t))
        slices, passes = 1, 1
        while 2 * slices <= cap:
            slices *= 2
    else:
        slices, passes = 1, -(-items // LS_THREADS)
    ws_bytes = _r16(6 * ni * t) + (_r16(C1 * C1 * t) + 3 * _r16(C1 * t)
                                   if gram else 0)
    parts = (("kind", 4 * LS_LMAX), ("lane", 4 * LS_LMAX),
             ("lam", t * LS_LMAX),
             ("aux", t * LS_LMAX), ("res", 2 * t * LS_LMAX),
             ("lsc", LS_NSC * t * LS_LMAX),
             ("wred", t * LS_LMAX * LS_THREADS // 32),
             ("u", n * C1 * tin if resident else 0 if rows
              else 2 * TR * C1 * tin))
    parts += ((("part", LS_THREADS * LS_ROWS_NS * t),) if rows else
              (("h", L * LS_PMAX * TR * t), ("hx", L * LS_PMAX * TR * t),
               ("sl", slices * ni * L * LS_PMAX * t if slices > 1 else 0)))
    parts += (("ws", L * ws_bytes if ws_smem else 0),)
    out, at = {}, 0
    for name, b in parts:
        out[name] = at
        at += _r16(b)
    out.update(bytes=at, ws_bytes=ws_bytes, items=items, slices=slices,
               passes=passes, L=L, TR=TR, ni=ni, resident=resident,
               rows=rows)
    return out


def search_geometry(n_cvt: int, n: int, f64: bool, wide: bool,
                    per_lane: bool) -> dict:
    """The launch geometry K3 (f64 False; `wide` its float64 sums) or K7
    (f64 True) takes at n_cvt covariates and n individuals: L lanes a
    block (K3 8 where the lanes share float32 operands, K7 4, per-lane
    operands 1); UtWy resident where the block stays within
    LS_RESIDENT_MAX, else the largest tile of LS_TR rows halved to 8 whose
    block fits LS_SMEM_MAX; the working sets in shared memory up to
    GT_WIDE_CVT covariates (ls_fit, k3_layout, k7_layout)."""
    if f64:
        L, tin, t, gram = (1 if per_lane else 4), 8, 8, False
    else:
        L, tin, t, gram = (1 if per_lane or wide else 8), 4, \
            (8 if wide else 4), True
    ws_smem = n_cvt <= GT_WIDE_CVT
    y = search_layout(n_cvt, n, L, LS_TR, tin, t, gram, ws_smem, True)
    if y["bytes"] <= LS_RESIDENT_MAX:
        return y
    TR = LS_TR
    y = search_layout(n_cvt, n, L, TR, tin, t, gram, ws_smem, False)
    while y["bytes"] > LS_SMEM_MAX and TR > 8:
        TR //= 2
        y = search_layout(n_cvt, n, L, TR, tin, t, gram, ws_smem, False)
    return y


def search_blocks(s0: int, count: int, L: int) -> list:
    """The blocks of a K3 or K7 launch over lanes [s0, s0 + count), L
    teams a block: (the first team's lane where L = 1, teams, the first
    team's scratch slot) each, the last block holding the rest.  Each team
    has a working set (its scratch slot above GT_WIDE_CVT covariates);
    with L = 1 its lane is the block's, with L > 1 it takes lanes from
    the launch's counter until there are none."""
    return [(s0 + b, min(L, count - b), b) for b in range(0, count, L)]


def lambda_solve_cuda(d1f, fine_np, data: lk.LmmBatchData, n_cvt: int,
                      calc_null: bool, reml: bool, l_min: float,
                      l_max: float, n_region: int,
                      wide: bool = False) -> LambdaResult:
    """K3 on the card (`wide`: its float64-sum instantiation)."""
    kernels.check_n_cvt(n_cvt)
    S, n = lk.n_lanes(data), data.eval.shape[0]
    Gf = n_region * _F32_GRID_REFINE + 1
    f32 = torch.float32
    kernels.check_operand(d1f, "d1f", f32, (Gf, S))
    lk.check_lane_operands(data, n_cvt, f32)
    dev = d1f.device
    fine = torch.as_tensor(fine_np, dtype=torch.float64 if wide else f32,
                           device=dev)
    tab = kernels.pab_tables(n_cvt, str(dev))
    lam = torch.empty(S, dtype=f32, device=dev)
    logf = torch.empty_like(lam)
    ustride, _, xstride = lk.lane_strides(data)
    # the lane counters, from which a shared-operand launch's teams take
    # their lanes: the launch of lanes [s0, ...) counts at index s0
    ctr = torch.zeros(max(S, 1), dtype=torch.int32, device=dev)
    kern = kernels.LAMBDA_SOLVE
    kern.launch_lanes(dev, S, kern.lane_bytes(n_cvt, int(wide)),
                      lambda s0, k, w: (
        d1f.data_ptr(), fine.data_ptr(), n_region, _F32_GRID_REFINE,
        data.eval.data_ptr(), data.UtWy.data_ptr(), data.Utx.data_ptr(),
        tab.data_ptr(), n_cvt, S, n, int(calc_null), int(reml), ustride,
        xstride, int(wide), float(l_min), float(l_max),
        _NEWTON_EPSREL if wide else _F32_NEWTON_EPSREL, _NEWTON_MAX_ITER,
        lk.logf_const(n, n_cvt, calc_null, reml), lam.data_ptr(),
        logf.data_ptr(), ctr.data_ptr() + 4 * s0, s0, k, w))
    return LambdaResult(lam=lam, logf=logf)


def lambda_solve(d1f, fine_np, data: lk.LmmBatchData, n_cvt: int,
                 calc_null: bool, reml: bool, l_min: float, l_max: float,
                 n_region: int, wide: bool = False) -> LambdaResult:
    """The float32 search after the grid scan (K3 on the card)."""
    if d1f.device.type == "cpu":
        return lambda_solve_plain(d1f, fine_np, data, n_cvt, calc_null,
                                  reml, l_min, l_max, n_region, wide)
    return lambda_solve_cuda(d1f, fine_np, data, n_cvt, calc_null, reml,
                             l_min, l_max, n_region, wide)


def lambda_solve_f64_plain(data: lk.LmmBatchData, n_cvt: int,
                           calc_null: bool, reml: bool, l_min: float,
                           l_max: float, n_region: int,
                           stats: dict | None = None) -> LambdaResult:
    """PyTorch version of K7: the float64 search with GSL semantics.
    `stats`: as _bracket_search, the scan's points among the evals."""
    fine_np = fine_grid(l_min, l_max, n_region, 1)
    S = lk.n_lanes(data)
    dtype, dev = data.eval.dtype, data.eval.device
    d1f = torch.stack([
        lk.dev1(torch.full((S,), float(g), dtype=dtype, device=dev),
                data, n_cvt, calc_null, reml) for g in fine_np])
    if stats is not None:
        stats["evals"] = torch.full((S,), len(fine_np), dtype=torch.long,
                                    device=dev)
    return _bracket_search(d1f, fine_np, data, n_cvt, calc_null, reml,
                           l_min, l_max, n_region, 1, strict=True,
                           stats=stats)


def lambda_solve_f64_cuda(data: lk.LmmBatchData, n_cvt: int,
                          calc_null: bool, reml: bool, l_min: float,
                          l_max: float, n_region: int) -> LambdaResult:
    """K7 on the card."""
    kernels.check_n_cvt(n_cvt)
    S, n = lk.n_lanes(data), data.eval.shape[0]
    f64 = torch.float64
    lk.check_lane_operands(data, n_cvt, f64)
    kernels.check_operand(data.iab_logdiag, "iab_logdiag", f64,
                          (S, n_cvt + 1))
    dev = data.eval.device
    grid = torch.as_tensor(fine_grid(l_min, l_max, n_region, 1), dtype=f64,
                           device=dev)
    tab = kernels.pab_tables(n_cvt, str(dev))
    lam = torch.empty(S, dtype=f64, device=dev)
    logf = torch.empty_like(lam)
    ustride, _, xstride = lk.lane_strides(data)
    ctr = torch.zeros(max(S, 1), dtype=torch.int32, device=dev)
    kern = kernels.LAMBDA_SOLVE_F64
    kern.launch_lanes(dev, S, kern.lane_bytes(n_cvt), lambda s0, k, w: (
        grid.data_ptr(), n_region, data.eval.data_ptr(),
        data.UtWy.data_ptr(), data.Utx.data_ptr(),
        data.iab_logdiag.data_ptr(), tab.data_ptr(), n_cvt, S, n,
        int(calc_null), int(reml), ustride, xstride, float(l_min),
        float(l_max), _BRENT_EPSREL, _NEWTON_EPSREL, _BRENT_MAX_ITER,
        _NEWTON_MAX_ITER, lk.logf_const(n, n_cvt, calc_null, reml),
        lam.data_ptr(), logf.data_ptr(), ctr.data_ptr() + 4 * s0, s0, k,
        w))
    return LambdaResult(lam=lam, logf=logf)


def calc_lambda(data: lk.LmmBatchData, n_cvt: int, calc_null: bool,
                reml: bool, l_min: float, l_max: float,
                n_region: int) -> LambdaResult:
    """Batched equivalent of GEMMA CalcLambda over a SNP block."""
    if data.eval.dtype == torch.float64:
        if data.eval.device.type == "cpu":
            return lambda_solve_f64_plain(data, n_cvt, calc_null, reml,
                                          l_min, l_max, n_region)
        return lambda_solve_f64_cuda(data, n_cvt, calc_null, reml, l_min,
                                     l_max, n_region)
    fine_np = fine_grid(l_min, l_max, n_region, _F32_GRID_REFINE)
    d1f = lk.dev1_grid(fine_np, data, n_cvt, calc_null, reml)
    return lambda_solve(d1f, fine_np, data, n_cvt, calc_null, reml,
                        l_min, l_max, n_region, wide=lk.per_lane(data))
