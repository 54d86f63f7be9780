"""Multivariate LMM core: per-lane EM, Wald/score test and Newton-Raphson
over (Vg, Ve), with their CUDA kernels K9-K11.

Model (GEMMA mvlmm.cpp; Zhou & Stephens 2014): d phenotypes Y (d, n),
covariates X (c, n), kinship eigenvalues δ_k.  In the kinship eigenbasis
each individual is an independent d-variate Gaussian with covariance
H_k = δ_k Vg + Ve.  EigenProc (mvlmm.cpp:213-282) whitens both matrices:
with Ve^-1/2 Vg Ve^-1/2 = Ul D_l Ul', the transform A = UltVehi = Ul'
Ve^-1/2 turns H_k into diag(δ_k D_l + 1), so every quantity is a sum over
n of products of per-individual values: the whitened phenotypes z = A y,
the weights w_kl = 1/(δ_k D_l + 1) and the design rows x_k.

Layout of the lanes (one lane per SNP): the design of lane s is the
shared rows X0 (c0, n) followed by its own rows R[s] (r, n) — [x] for
-lmm, [x] or [x, x∘env] for GxE — so c = c0 + r.  Starting Vg/Ve/B are
one per lane (S, ·) or shared (1, ·).  All arithmetic is float64; the
float32 speed mode differs only in reading float32 operands.

The kernels and their plain versions (the same arithmetic as batched
torch; the wrappers send CPU tensors to the plain version and CUDA tensors
to the kernel):

  K9  mph_em      the reference's EM while-loop (mvlmm_core.py:225), per
                  lane until it converges: eigen_proc, the d c×c blocks of
                  calc_qi, xHiy, logl, the REML/ML M-step with GEMMA's
                  stale UltVehiBX matrix in ML, CalcSigma, UpdateV.
  K10 mph_calc_p  MphCalcP (mvlmm_core.py:712) and the χ²(d) tail, and the
                  LRT tail of a logl difference.
  K11 mph_nr      MphNR (mvlmm_core.py:439): Newton on vech(Vg, Ve) with
                  the closed-form gradient and Hessian (GEMMA's CalcDev)
                  in place of the reference's autodiff, step-halving and
                  GEMMA's acceptance rules; Hvar = -H^-1.
  K14 calc_crt    CalcCRT (mvlmm_core.py:681): the Edgeworth correction
                  factors of a lane at its Newton optimum, from the SNP
                  block of Q^-1 alone (see calc_crt_plain).

Eigenvectors of the d×d problems: the closed form of the reference at
d = 2 (its `_eigh2x2`, including the branch choices); at d >= 3 (cyclic
Jacobi in the kernels) each eigenvector's largest-magnitude component
positive, except in the ML EM, where Ul's columns keep the signs of the
previous iteration's.  That EM carries GEMMA's stale UltVehiBX matrix in
the previous iteration's basis, so its trajectory depends on those signs:
with a fixed convention alone a column's sign can flip between
iterations and the EM wanders (measured at d = 5: logl -1016.8 after
10,000 iterations against the reference's -998.3).  At d >= 3 the ML EM
can differ from the reference's LAPACK-based one (ROADMAP §C).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gemma_torch import kernels
from gemma_torch.ops.stats import chisq_sf

_LOG_2PI = float(np.log(2.0 * np.pi))
_TINY = float(np.finfo(np.float64).tiny)
_F64 = torch.float64
# EM bursts of the reference's staged driver (mvlmm.py:173-272): 32, then
# doubling to 512; its convergence test is skipped at each burst's first
# iteration, and the float32 Newton finisher takes over at the first
# burst start at or past _NR_SWITCH
_BURST0, _BURST_MAX, _NR_SWITCH = 32, 512, 128


# ---------------------------------------------------------------------------
# vech and small symmetric algebra

def vech_index(i: int, j: int, d: int) -> int:
    """GEMMA GetIndex (upper-triangle row-major flattening)."""
    if j < i:
        i, j = j, i
    return (2 * d - i + 1) * i // 2 + (j - i)


def _vech_pairs(d: int) -> list:
    """(i, j), i <= j, in vech order."""
    pairs = [None] * (d * (d + 1) // 2)
    for i in range(d):
        for j in range(i, d):
            pairs[vech_index(i, j, d)] = (i, j)
    return pairs


def vech_to_sym(v: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d(d+1)/2) → (..., d, d) symmetric."""
    out = v.new_zeros(v.shape[:-1] + (d, d))
    for a, (i, j) in enumerate(_vech_pairs(d)):
        out[..., i, j] = v[..., a]
        out[..., j, i] = v[..., a]
    return out


def sym_to_vech(M: torch.Tensor, d: int) -> torch.Tensor:
    return torch.stack([M[..., i, j] for i, j in _vech_pairs(d)], dim=-1)


def vech_basis(d: int, dtype=_F64, device=None) -> torch.Tensor:
    """(v_size, d, d) derivative matrices dH/dv in GEMMA's convention:
    an off-diagonal parameter sets both (i, j) and (j, i)."""
    S = torch.zeros((d * (d + 1) // 2, d, d), dtype=dtype, device=device)
    for a, (i, j) in enumerate(_vech_pairs(d)):
        S[a, i, j] = 1.0
        S[a, j, i] = 1.0
    return S


def eigh2x2(M: torch.Tensor):
    """Closed-form symmetric 2×2 eigendecomposition, batched, exactly the
    reference's `_eigh2x2` (mvlmm_core.py:59-95) in float64.  Returns (w
    ascending, V)."""
    a, b, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
    t = 0.5 * (a + d)
    h2 = (0.5 * (a - d)) ** 2 + b * b
    r = torch.sqrt(torch.clamp(h2, min=_TINY))
    w1, w2 = t - r, t + r
    use1 = (w2 - a).abs() >= (w2 - d).abs()
    vx = torch.where(use1, b, w2 - d)
    vy = torch.where(use1, w2 - a, b)
    diag = b.abs() <= _TINY * 8
    big_is_a = a >= d
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    vx = torch.where(diag, torch.where(big_is_a, one, zero), vx)
    vy = torch.where(diag, torch.where(big_is_a, zero, one), vy)
    nrm = torch.sqrt(vx * vx + vy * vy)
    nrm = torch.where(nrm == 0, one, nrm)
    vx, vy = vx / nrm, vy / nrm
    w = torch.stack([w1, w2], dim=-1)
    V = torch.stack([torch.stack([-vy, vx], dim=-1),
                     torch.stack([vx, vy], dim=-1)], dim=-1)
    return w, V


def sym_eigh(M: torch.Tensor, prev: torch.Tensor | None = None):
    """Batched symmetric eigh, eigenvalues ascending: the closed form at
    d = 2; above, eigenvectors signed to agree with `prev` (the same
    problem's eigenvectors one EM iteration earlier: a non-negative dot
    product) or, without it, with their largest-magnitude component
    positive (the kernels compute the same by cyclic Jacobi).  A
    non-finite matrix gives NaN, not an error."""
    d = M.shape[-1]
    if d == 2:
        return eigh2x2(M)
    ok = torch.isfinite(M).all(-1).all(-1)
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    w, V = torch.linalg.eigh(torch.where(ok[..., None, None], M, eye))
    nan = torch.full_like(w, float("nan"))
    w = torch.where(ok[..., None], w, nan)
    V = torch.where(ok[..., None, None], V, nan[..., None])
    if prev is None:
        big = V.abs().argmax(dim=-2, keepdim=True)
        neg = torch.gather(V, -2, big) < 0
    else:
        neg = (V * prev).sum(-2, keepdim=True) < 0
    return w, torch.where(neg, -V, V)


def eigen_proc(Vg: torch.Tensor, Ve: torch.Tensor, Ul_prev=None,
               with_ul: bool = False):
    """Simultaneous diagonalisation of (Vg, Ve) (EigenProc): returns
    (D_l, UltVeh, UltVehi, logdet_Ve); nonpositive Ve eigenvalues are
    skipped (pseudo-root), negative D_l zeroed.  With_ul also Ul, whose
    signs (d >= 3) follow Ul_prev where given."""
    ev, Uv = sym_eigh(Ve)
    pos = ev > 0
    sq = torch.sqrt(torch.where(pos, ev, torch.ones_like(ev)))
    logdet_Ve = torch.where(pos, torch.log(torch.where(pos, ev, 1.0)),
                            torch.zeros_like(ev)).sum(-1)
    Veh = torch.einsum("...ik,...k,...jk->...ij", Uv,
                       torch.where(pos, sq, torch.zeros_like(sq)), Uv)
    Vehi = torch.einsum("...ik,...k,...jk->...ij", Uv,
                        torch.where(pos, 1.0 / sq, torch.zeros_like(sq)), Uv)
    D_l, Ul = sym_eigh(Vehi @ Vg @ Vehi, Ul_prev)
    D_l = torch.where(D_l < 0, torch.zeros_like(D_l), D_l)
    UlT = Ul.transpose(-1, -2)
    out = (D_l, UlT @ Veh, UlT @ Vehi, logdet_Ve)
    return out + (Ul,) if with_ul else out


def blocks_inv_logdet(blocks: torch.Tensor):
    """Inverse and log|det| of (..., c, c) blocks: the adjugate at c <= 2
    (as the reference), LU above (no error on a singular block)."""
    c = blocks.shape[-1]
    if c == 1:
        det = blocks[..., 0, 0]
        return (1.0 / det)[..., None, None], torch.log(det.abs())
    if c == 2:
        a, b = blocks[..., 0, 0], blocks[..., 0, 1]
        e, f = blocks[..., 1, 0], blocks[..., 1, 1]
        det = a * f - b * e
        inv = torch.stack([torch.stack([f, -b], -1),
                           torch.stack([-e, a], -1)], -2) / det[..., None,
                                                                None]
        return inv, torch.log(det.abs())
    inv, _ = torch.linalg.inv_ex(blocks)
    return inv, torch.linalg.slogdet(blocks)[1]


def calc_qi(eval_, D_l, X, with_blocks: bool = False):
    """Q^-1 (..., dc, dc) and log|Q| (CalcQi, mvlmm.cpp:285-329): Q is a
    permuted block diagonal of d Gram blocks Σ_k w_kl x_k x_k'; with
    with_blocks the (..., d, c, c) inverse blocks too."""
    d, c = D_l.shape[-1], X.shape[-2]
    w = 1.0 / (D_l[..., :, None] * eval_ + 1.0)
    blocks = torch.einsum("...ln,...in,...jn->...lij", w, X, X)
    binv, bld = blocks_inv_logdet(blocks)
    batch = blocks.shape[:-3]
    Q4 = blocks.new_zeros(batch + (c, d, c, d))
    for l in range(d):
        Q4[..., :, l, :, l] = binv[..., l, :, :]
    Qi = Q4.reshape(batch + (c * d, c * d))
    if with_blocks:
        return Qi, bld.sum(-1), binv
    return Qi, bld.sum(-1)


def calc_xhiy(eval_, D_l, X, UltVehiY):
    """xHiy[j*d+i] = Σ_k X_jk UltVehiY_ik / (δ_k D_l[i] + 1)."""
    c = X.shape[-2]
    d = D_l.shape[-1]
    w = 1.0 / (D_l[..., :, None] * eval_ + 1.0)
    out = torch.einsum("...jn,...in->...ji", X, w * UltVehiY)
    return out.reshape(out.shape[:-2] + (c * d,))


def mph_calc_logl(eval_, xHiy, D_l, UltVehiY, Qi):
    """-0.5(Σ_k y'H^-1y + log|H_k|) + 0.5 xHiy' Qi xHiy (MphCalcLogL)."""
    v = D_l[..., :, None] * eval_ + 1.0
    quad = (UltVehiY * UltVehiY / v).sum((-1, -2))
    logd = torch.log(v).sum((-1, -2))
    qQq = torch.einsum("...i,...ij,...j->...", xHiy, Qi, xHiy)
    return -0.5 * (quad + logd - qQq)


def mph_calc_beta(eval_, W, Y, Vg, Ve):
    """Null-model B and se(B), each (d, c) (MphCalcBeta,
    mvlmm.cpp:835-935); S = 1, small torch ops."""
    eval_, W, Y, Vg, Ve = (t.to(_F64) for t in (eval_, W, Y, Vg, Ve))
    d, c = Y.shape[0], W.shape[0]
    D_l, UltVeh, UltVehi, _ = eigen_proc(Vg, Ve)
    Qi, _ = calc_qi(eval_, D_l, W)
    WHiy = calc_xhiy(eval_, D_l, W, UltVehi @ Y)
    B = (((Qi @ WHiy).reshape(c, d)) @ UltVeh).T
    Qi4 = Qi.reshape(c, d, c, d)
    diag_blocks = torch.einsum("ki,ckcl,lj->cij", UltVeh, Qi4, UltVeh)
    se_B = torch.sqrt(torch.einsum("cii->ic", diag_blocks))
    return B, se_B


def pcrt(mode: int, d: int, p_value, crt_a, crt_b, crt_c):
    """Apply the small-sample correction to a p-value (PCRT,
    mvlmm.cpp:2952-2970): 1 Wald, 2 LRT, 3 score (unchanged)."""
    import scipy.stats
    q = float(d)
    chisq = scipy.stats.chi2.isf(p_value, q)
    if mode == 1:
        a = crt_c / (2.0 * q * (q + 2.0))
        b = 1.0 + (crt_a + crt_b) / (2.0 * q)
        chisq_crt = (-b + np.sqrt(np.maximum(b * b + 4.0 * a * chisq, 0.0))
                     ) / (2.0 * a)
    elif mode == 2:
        chisq_crt = chisq / (1.0 + crt_a / (2.0 * q))
    else:
        chisq_crt = chisq
    return scipy.stats.chi2.sf(chisq_crt, q)


# ---------------------------------------------------------------------------
# lane operands

def design(X0: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(S, c0 + r, n) float64 design of every lane: X0's rows, then R's."""
    S = R.shape[0]
    return torch.cat([X0.to(_F64).expand(S, *X0.shape), R.to(_F64)], dim=1)


def _lanes(t: torch.Tensor, S: int) -> torch.Tensor:
    """(1 or S, ...) → (S, ...) float64 copy."""
    return t.to(_F64).expand((S,) + tuple(t.shape[1:])).clone()


def burst_starts(max_iter: int) -> set:
    """Iterations at which the reference's staged EM begins a burst (its
    convergence test is skipped there)."""
    out, b, ln = set(), _BURST0, _BURST0
    while b < max_iter:
        out.add(b)
        ln = min(2 * ln, _BURST_MAX)
        b += ln
    return out


def nr_switch_point(em_iter: int) -> int | None:
    """The iteration at which the reference's float32 staged EM hands its
    stragglers to Newton-Raphson: the first burst start at or past
    _NR_SWITCH below em_iter (224 for the default 1000), or None."""
    starts = [b for b in sorted(burst_starts(em_iter)) if b >= _NR_SWITCH]
    return starts[0] if starts else None


def _logl_const(reml: bool, n: int, d: int, c: int, X: torch.Tensor):
    if reml:
        logdet_XXt = torch.linalg.slogdet(X @ X.transpose(-1, -2))[1]
        return -0.5 * (n - c) * d * _LOG_2PI + 0.5 * d * logdet_XXt
    return torch.full(X.shape[:1], -0.5 * n * d * _LOG_2PI, dtype=_F64,
                      device=X.device)


class _PassA(NamedTuple):
    D: torch.Tensor        # (S, d)
    UltVeh: torch.Tensor   # (S, d, d)
    A: torch.Tensor        # UltVehi (S, d, d)
    w: torch.Tensor        # (S, d, n)
    z: torch.Tensor        # (S, d, n) whitened phenotypes
    Qi: torch.Tensor       # (S, d, c, c)
    beta: torch.Tensor     # (S, d, c) GLS coefficients, whitened basis
    logl: torch.Tensor     # (S,)
    Ul: torch.Tensor       # (S, d, d) eigenvectors of Ve^-1/2 Vg Ve^-1/2


def _pass_a(reml, const, eval_, X, Y, Vg, Ve, Ul_prev=None) -> _PassA:
    """eigen_proc, the Gram blocks, xHiy and the log-likelihood."""
    n, c = eval_.shape[0], X.shape[-2]
    D, UltVeh, A, logdet_Ve, Ul = eigen_proc(Vg, Ve, Ul_prev, with_ul=True)
    v = D[..., None] * eval_ + 1.0
    w = 1.0 / v
    z = A @ Y
    Qi, ldQ = blocks_inv_logdet(torch.einsum("sln,sin,sjn->slij", w, X, X))
    XWz = torch.einsum("sln,sin->sli", w * z, X)
    beta = (Qi @ XWz[..., None])[..., 0]
    quad = (z * z / v).sum((-1, -2))
    logd = torch.log(v).sum((-1, -2))
    qQq = (XWz * beta).sum((-1, -2))
    logl = const - 0.5 * (quad + logd - qQq) - 0.5 * n * logdet_Ve
    if reml:
        logl = logl - 0.5 * (ldQ.sum(-1) - c * logdet_Ve)
    return _PassA(D, UltVeh, A, w, z, Qi, beta, logl, Ul)


def _rot(UltVeh, M):
    """UltVeh' M UltVeh."""
    return UltVeh.transpose(-1, -2) @ M @ UltVeh


# ---------------------------------------------------------------------------
# K9 mph_em

class EmResult(NamedTuple):
    Vg: torch.Tensor       # (S, d, d) float64
    Ve: torch.Tensor
    B: torch.Tensor        # (S, d, c)
    logl: torch.Tensor     # (S,)
    done: torch.Tensor     # (S,) bool: converged or non-finite
    iters: torch.Tensor    # (S,) int32: iteration of the exit test, or cap


def mph_em_plain(reml: bool, max_iter: int, prec: float, eval_, X0, Y, R,
                 Vg0, Ve0, B0, staged: bool = False) -> EmResult:
    """PyTorch version of K9: the reference's PX-EM while-loop body
    (mvlmm_core.py:261-369) on S lanes with per-lane freezing.  `staged`
    skips the convergence test at the reference's burst starts (its
    staged driver, mvlmm.py:173-272)."""
    ev, Yd = eval_.to(_F64), Y.to(_F64)
    X = design(X0, R)
    S, c, n = X.shape
    d = Yd.shape[0]
    Vg, Ve, B = _lanes(Vg0, S), _lanes(Ve0, S), _lanes(B0, S)
    const = _logl_const(reml, n, d, c, X)
    XXti = None if reml else torch.linalg.inv_ex(X @ X.transpose(-1, -2))[0]
    logl = torch.zeros(S, dtype=_F64, device=X.device)
    logl_prev = torch.zeros_like(logl)
    done = torch.zeros(S, dtype=torch.bool, device=X.device)
    iters = torch.full((S,), max_iter, dtype=torch.int32, device=X.device)
    Bc = Ul = None         # ML: the carried UltVehiB (d, c), its basis
    skip = burst_starts(max_iter) if staged else set()
    nan = torch.tensor(float("nan"), dtype=_F64, device=X.device)
    for t in range(max_iter):
        if bool(done.all()):
            break
        pa = _pass_a(reml, const, ev, X, Yd, Vg, Ve, Ul)
        ll = pa.logl
        check = t > 0 and t not in skip
        fin = torch.isfinite(ll)
        nanfrozen = (~done & ~fin) if check else torch.zeros_like(done)
        conv = (((ll - logl_prev).abs() < prec) | ~fin) if check else \
            torch.zeros_like(done)
        iters = torch.where(conv & ~done, torch.full_like(iters, t), iters)
        done_new = done | conv

        D, w, z = pa.D, pa.w, pa.z
        sw = w.sum(-1)
        sdw = (w * ev).sum(-1)
        if reml:
            Bw = pa.beta                                   # (S, d, c)
            py = w * (z - Bw @ X)                          # E, whitened
            G0 = py @ py.transpose(-1, -2)
            G1 = (py * ev) @ py.transpose(-1, -2)
            h = torch.einsum("sin,slij,sjn->sln", X, pa.Qi, X)
            see = D * sdw + (w * w * h).sum(-1)
            suu = D * sw + D * D * (w * w * h * ev).sum(-1)
            UU = D[..., :, None] * G1 * D[..., None, :]
            EE = G0
        else:
            if Bc is None:
                Bc = pa.A @ B
            g = w * (z - Bc @ X)                           # U = δ D g
            e0 = z - ev * D[..., None] * g
            Bw = (e0 @ X.transpose(-1, -2)) @ XXti
            E = e0 - Bw @ X
            UU = D[..., :, None] * ((g * ev) @ g.transpose(-1, -2)) \
                * D[..., None, :]
            EE = E @ E.transpose(-1, -2)
            suu, see = D * sw, D * sdw
        Vg_new = _rot(pa.UltVeh, UU + torch.diag_embed(suu)) / n
        Ve_new = _rot(pa.UltVeh, EE + torch.diag_embed(see)) / n
        B_new = pa.UltVeh.transpose(-1, -2) @ Bw

        km = done_new[:, None, None]
        nm = nanfrozen[:, None, None]
        Vg = torch.where(nm, nan, torch.where(km, Vg, Vg_new))
        Ve = torch.where(nm, nan, torch.where(km, Ve, Ve_new))
        B = torch.where(nm, nan, torch.where(km, B, B_new))
        if not reml:
            Bc = torch.where(km, Bc, Bw)
            Ul = torch.where(km, Ul, pa.Ul) if Ul is not None else pa.Ul
        logl = torch.where(nanfrozen, ll, torch.where(done_new, logl, ll))
        logl_prev = torch.where(done_new, logl_prev, ll)
        done = done_new
    return EmResult(Vg, Ve, B, logl, done, iters)


def _check_lanes(eval_, X0, Y, R, dt):
    """Raise unless the lane operands are what K9-K11 take."""
    n = eval_.shape[0]
    d, c0 = Y.shape[0], X0.shape[0]
    S, r = R.shape[0], R.shape[1]
    kernels.check_mvlmm_shape(d, c0 + r)
    kernels.check_operand(eval_, "eval", dt, (n,))
    kernels.check_operand(X0, "X0", dt, (c0, n))
    kernels.check_operand(Y, "Y", dt, (d, n))
    kernels.check_operand(R, "R", dt, (S, r, n))
    return S, n, d, c0, r


def _lane_param(t: torch.Tensor, name: str, S: int, shape: tuple):
    """A float64 contiguous (1 or S, *shape) tensor and its lane stride."""
    t = t.to(_F64).reshape((-1,) + shape).contiguous()
    if t.shape[0] not in (1, S):
        raise ValueError(f"{name}: expected 1 or {S} lanes, got {t.shape[0]}")
    return t, (0 if t.shape[0] == 1 else int(np.prod(shape)))


def mph_em_cuda(reml: bool, max_iter: int, prec: float, eval_, X0, Y, R,
                Vg0, Ve0, B0, staged: bool = False) -> EmResult:
    """K9 on the card (float64 operands: its f64 instantiation)."""
    dt = eval_.dtype
    S, n, d, c0, r = _check_lanes(eval_, X0, Y, R, dt)
    c = c0 + r
    kern = kernels.variant(kernels.MPH_EM, kernels.MPH_EM_F64, dt)
    Vg0, vs = _lane_param(Vg0, "Vg0", S, (d, d))
    Ve0, vs2 = _lane_param(Ve0, "Ve0", S, (d, d))
    B0, bs = _lane_param(B0, "B0", S, (d, c))
    if vs != vs2:
        raise ValueError("Vg0 and Ve0 must both be shared or both per lane")
    dev = eval_.device
    Vg = torch.empty((S, d, d), dtype=_F64, device=dev)
    Ve = torch.empty_like(Vg)
    B = torch.empty((S, d, c), dtype=_F64, device=dev)
    logl = torch.empty(S, dtype=_F64, device=dev)
    done = torch.empty(S, dtype=torch.int32, device=dev)
    iters = torch.empty(S, dtype=torch.int32, device=dev)
    if S:
        kern.launch_lanes(dev, S, kern.lane_bytes(d, c), lambda s0, k, w: (
            int(reml), int(staged), int(max_iter), float(prec), S, n, d, c0,
            r, eval_.data_ptr(), X0.data_ptr(), Y.data_ptr(), R.data_ptr(),
            Vg0.data_ptr(), Ve0.data_ptr(), vs, B0.data_ptr(), bs,
            Vg.data_ptr(), Ve.data_ptr(), B.data_ptr(), logl.data_ptr(),
            done.data_ptr(), iters.data_ptr(), s0, k, w))
    return EmResult(Vg, Ve, B, logl, done.bool(), iters)


def mph_em(reml: bool, max_iter: int, prec: float, eval_, X0, Y, R, Vg0,
           Ve0, B0, staged: bool = False) -> EmResult:
    """Per-lane PX-EM for (Vg, Ve, B) from the lanes' starts (K9 on the
    card).  Each lane stops when |Δlogl| < prec (tested from t = 1, and
    with `staged` not at the reference's burst starts), goes non-finite
    (NaN-poisoned), or reaches max_iter."""
    fn = mph_em_plain if eval_.device.type == "cpu" else mph_em_cuda
    return fn(reml, max_iter, prec, eval_, X0, Y, R, Vg0, Ve0, B0, staged)


# ---------------------------------------------------------------------------
# K10 mph_calc_p

class CalcP(NamedTuple):
    stat: torch.Tensor     # (S,) float64
    p: torch.Tensor        # (S,) χ²(d) tail of stat
    beta: torch.Tensor     # (S, d)
    Vbeta: torch.Tensor    # (S, d, d)
    p_lrt: torch.Tensor | None  # (S,) χ²(d) tail of 2(logl1 - logl0)


def mph_calc_p_plain(eval_, X0, Y, R, Vg, Ve, logl1=None,
                     logl0=None) -> CalcP:
    """PyTorch version of K10: MphCalcP (mvlmm_core.py:712-752) for the
    tested row R[:, -1] with covariates X0 and R[:, :-1], p = Q_χ²(d)
    (stat); with logl1 (S,) and logl0 (1 or S,) also the LRT tail."""
    ev, Yd = eval_.to(_F64), Y.to(_F64)
    X = design(X0, R)
    S = X.shape[0]
    W, x = X[:, :-1], X[:, -1]
    d = Yd.shape[0]
    D, UltVeh, A, _ = eigen_proc(_lanes(Vg, S), _lanes(Ve, S))
    w = 1.0 / (D[..., None] * ev + 1.0)
    z = A @ Yd
    Qi, _ = blocks_inv_logdet(torch.einsum("sln,sin,sjn->slij", w, W, W))
    WHiy = torch.einsum("sln,sin->sli", w * z, W)          # (S, d, c-1)
    whx = torch.einsum("sln,sin,sn->sli", w, W, x)
    xPy0 = torch.einsum("sln,sn->sl", w * z, x)
    xPx0 = torch.einsum("sln,sn->sl", w, x * x)
    Qwhx = (Qi @ whx[..., None])[..., 0]
    xPx = xPx0 - (whx * Qwhx).sum(-1)                      # (S, d)
    xPy = xPy0 - (Qwhx * WHiy).sum(-1)
    bhat = xPy / xPx
    beta = (UltVeh.transpose(-1, -2) @ bhat[..., None])[..., 0]
    Vbeta = _rot(UltVeh, torch.diag_embed(1.0 / xPx))
    stat = (bhat * xPy).sum(-1)
    p_lrt = None
    if logl1 is not None:
        p_lrt = chisq_sf(2.0 * (logl1.to(_F64)
                                - logl0.to(_F64).reshape(-1)), float(d))
    return CalcP(stat, chisq_sf(stat, float(d)), beta, Vbeta, p_lrt)


def mph_calc_p_cuda(eval_, X0, Y, R, Vg, Ve, logl1=None,
                    logl0=None) -> CalcP:
    """K10 on the card (float64 operands: its f64 instantiation)."""
    dt = eval_.dtype
    S, n, d, c0, r = _check_lanes(eval_, X0, Y, R, dt)
    if r < 1:
        raise ValueError("mph_calc_p: the tested row is the lane's last row")
    kern = kernels.variant(kernels.MPH_CALC_P, kernels.MPH_CALC_P_F64, dt)
    Vg, vs = _lane_param(Vg, "Vg", S, (d, d))
    Ve, vs2 = _lane_param(Ve, "Ve", S, (d, d))
    if vs != vs2:
        raise ValueError("Vg and Ve must both be shared or both per lane")
    dev = eval_.device
    stat = torch.empty(S, dtype=_F64, device=dev)
    p = torch.empty_like(stat)
    beta = torch.empty((S, d), dtype=_F64, device=dev)
    Vbeta = torch.empty((S, d, d), dtype=_F64, device=dev)
    p_lrt, l1, l0, l0s = None, 0, 0, 0
    if logl1 is not None:
        logl1 = logl1.to(_F64).contiguous()
        logl0, l0s = _lane_param(logl0, "logl0", S, ())
        kernels.check_operand(logl1, "logl1", _F64, (S,))
        p_lrt = torch.empty_like(stat)
        l1, l0 = logl1.data_ptr(), logl0.data_ptr()
    if S:
        kern.launch_lanes(dev, S, kern.lane_bytes(d, c0 + r),
                          lambda s0, k, w: (
            S, n, d, c0, r, eval_.data_ptr(), X0.data_ptr(), Y.data_ptr(),
            R.data_ptr(), Vg.data_ptr(), Ve.data_ptr(), vs, l1, l0, l0s,
            stat.data_ptr(), p.data_ptr(), beta.data_ptr(), Vbeta.data_ptr(),
            0 if p_lrt is None else p_lrt.data_ptr(), s0, k, w))
    return CalcP(stat, p, beta, Vbeta, p_lrt)


def mph_calc_p(eval_, X0, Y, R, Vg, Ve, logl1=None, logl0=None) -> CalcP:
    """Wald/score statistic, its χ²(d) p-value, beta and Vbeta of each
    lane's last row at the lane's (Vg, Ve), and optionally the LRT tail
    (K10 on the card)."""
    fn = mph_calc_p_plain if eval_.device.type == "cpu" else mph_calc_p_cuda
    return fn(eval_, X0, Y, R, Vg, Ve, logl1, logl0)


# ---------------------------------------------------------------------------
# K11 mph_nr

def _is_pd(M: torch.Tensor) -> torch.Tensor:
    return (sym_eigh(M)[0] > 0).all(-1)


def nr_logl(reml: bool, eval_, X, Y, Vg, Ve) -> torch.Tensor:
    """The (restricted) log-likelihood at (Vg, Ve), B profiled out; X is
    the (S, c, n) design (the reference's _nr_logl_fn)."""
    n, c, d = eval_.shape[0], X.shape[-2], Y.shape[0]
    const = _logl_const(reml, n, d, c, X)
    return _pass_a(reml, const, eval_.to(_F64), X, Y.to(_F64), Vg, Ve).logl


def nr_derivatives(reml: bool, eval_, X, Y, Vg, Ve):
    """logl, gradient and Hessian in θ = (vech Vg, vech Ve), closed form
    (GEMMA's CalcDev).  With P the projection (REML; H^-1 in the trace
    terms for ML) and D_a = ∂H/∂θ_a = δ^{t_a} S_a:

        g_a  = -½ tr(P D_a) + ½ y'P D_a P y
        H_ab =  ½ tr(P D_a P D_b) - y'P D_a P D_b P y

    all in the whitened basis, where P is block diagonal in the whitened
    phenotype and D_a's blocks are δ^t A S_a A'.  The sums over n are the
    ones K11 accumulates.  Returns (logl (S,), grad (S, p2), hess (S, p2,
    p2))."""
    ev, Yd = eval_.to(_F64), Y.to(_F64)
    S, c, n = X.shape
    d = Yd.shape[0]
    vs = d * (d + 1) // 2
    const = _logl_const(reml, n, d, c, X)
    pa = _pass_a(reml, const, ev, X, Yd, Vg, Ve)
    w, Qi = pa.w, pa.Qi
    py = w * (pa.z - pa.beta @ X)
    e = [torch.ones_like(ev), ev, ev * ev]
    h = torch.einsum("sin,slij,sjn->sln", X, Qi, X)        # x'Qi_l x
    T1 = [torch.einsum("sln,smn,n->slm", w, w, e[t]) for t in range(3)]
    tau = [(w * e[t]).sum(-1) for t in range(2)]
    G = [torch.einsum("sln,smn,n->slm", py, py, e[t]) for t in range(2)]
    K = [torch.einsum("sln,smn,sqn,n->slmq", w, py, py, e[t])
         for t in range(3)]
    F = [torch.einsum("sin,sln,smn,n->slmi", X, w, py, e[t])
         for t in range(2)]
    if reml:
        tau = [tau[t] - (w * w * h * e[t]).sum(-1) for t in range(2)]
        Mtr = [torch.einsum("sln,smn,n->slm", w * w * h, w, e[t])
               for t in range(3)]
        N = [torch.einsum("sln,smn,sin,sjn,n->slmij", w, w, X, X, e[t])
             for t in range(2)]
    # the whitened derivative basis St[a] = A S_a A'
    Sb = vech_basis(d, device=X.device)
    St = torch.einsum("sli,aij,smj->salm", pa.A, Sb, pa.A)  # (S, vs, d, d)
    ta = [1] * vs + [0] * vs
    St2 = torch.cat([St, St], dim=1)                        # (S, p2, d, d)
    grad = torch.stack([
        -0.5 * torch.einsum("sll,sl->s", St2[:, a], tau[ta[a]])
        + 0.5 * (St2[:, a] * G[ta[a]]).sum((-1, -2))
        for a in range(2 * vs)], dim=-1)
    # T^{ab}_{lm} for the type pairs (t_a, t_b)
    T = {}
    for u in range(2):
        for v in range(2):
            Tuv = T1[u + v].clone()
            if reml:
                Tuv = (Tuv - Mtr[u + v] - Mtr[u + v].transpose(-1, -2)
                       + torch.einsum("slij,slmjk,smkq,slmqi->slm", Qi,
                                      N[u], Qi, N[v]))
            T[u, v] = Tuv
    f = [torch.einsum("slm,slmi->sli", St2[:, a], F[ta[a]])
         for a in range(2 * vs)]                            # (S, d, c)
    hess = torch.empty((S, 2 * vs, 2 * vs), dtype=_F64, device=X.device)
    for a in range(2 * vs):
        for b in range(2 * vs):
            tr = 0.5 * torch.einsum("slm,sml,slm->s", St2[:, a], St2[:, b],
                                    T[ta[a], ta[b]])
            qd = (torch.einsum("slm,slq,slmq->s", St2[:, a], St2[:, b],
                               K[ta[a] + ta[b]])
                  - torch.einsum("sli,slij,slj->s", f[a], Qi, f[b]))
            hess[:, a, b] = tr - qd
    return pa.logl, grad, hess


def mph_nr_plain(reml: bool, max_iter: int, prec: float, eval_, X0, Y, R,
                 Vg0, Ve0):
    """PyTorch version of K11: the reference's Newton-Raphson while-loop
    (mvlmm_core.py:475-525) with the closed-form derivatives of
    `nr_derivatives`.  Returns (Vg, Ve, logl, Hvar = -H^-1)."""
    X = design(X0, R)
    S = X.shape[0]
    d = Y.shape[0]
    vs = d * (d + 1) // 2
    p2 = 2 * vs
    dev = X.device
    Vg, Ve = _lanes(Vg0, S), _lanes(Ve0, S)

    def pack(Vg_, Ve_):
        return torch.cat([sym_to_vech(Vg_, d), sym_to_vech(Ve_, d)], -1)

    def unpack(v):
        return vech_to_sym(v[..., :vs], d), vech_to_sym(v[..., vs:], d)

    logl = torch.full((S,), -float("inf"), dtype=_F64, device=dev)
    grad = torch.zeros((S, p2), dtype=_F64, device=dev)
    Hinv = torch.eye(p2, dtype=_F64, device=dev).expand(S, p2, p2).clone()
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    for t in range(max_iter):
        if bool(done.all()):
            break
        v_save = pack(Vg, Ve)
        first = t == 0
        step = (Hinv @ grad[..., None])[..., 0]
        v_new, logl_new = v_save.clone(), torch.full_like(logl, -float("inf"))
        pd_new = torch.zeros_like(done)
        accepted = done.clone()          # frozen lanes try nothing
        for i in range(10):
            if bool(accepted.all()):
                break
            v_try = v_save if first else v_save - (0.5 ** i) * step
            Vg_t, Ve_t = unpack(v_try)
            pd = _is_pd(Vg_t) & _is_pd(Ve_t)
            l_try = nr_logl(reml, eval_, X, Y, Vg_t, Ve_t)
            ok = (pd & (l_try >= logl) & (l_try - logl <= 10.0)) | first
            take = ~accepted
            v_new = torch.where(take[:, None], v_try, v_new)
            logl_new = torch.where(take, l_try, logl_new)
            pd_new = torch.where(take, pd, pd_new)
            accepted = accepted | ok
        if first:
            revert = small = torch.zeros_like(done)
        else:
            revert = (logl_new < logl) | ~pd_new
            small = logl_new - logl < prec
        done_new = done | revert | small | ~torch.isfinite(logl_new)
        live = ~done
        v_next = torch.where(revert[:, None], v_save, v_new)
        v_out = torch.where(live[:, None], v_next, v_save)
        logl = torch.where(live, torch.where(revert, logl, logl_new), logl)
        Vg, Ve = unpack(v_out)
        upd = live & ~done_new
        if bool(upd.any()):
            _, g, H = nr_derivatives(reml, eval_, X[upd], Y, Vg[upd],
                                     Ve[upd])
            grad[upd] = g
            Hinv[upd] = torch.linalg.inv_ex(H)[0]
        done = done_new
    return Vg, Ve, logl, -Hinv


def mph_nr_cuda(reml: bool, max_iter: int, prec: float, eval_, X0, Y, R,
                Vg0, Ve0):
    """K11 on the card (float64 operands: its f64 instantiation).  Its
    per-lane sums and Hessian live in a scratch the wrapper allocates, the
    lanes split into launches whose scratch fits the budget."""
    dt = eval_.dtype
    S, n, d, c0, r = _check_lanes(eval_, X0, Y, R, dt)
    c = c0 + r
    kern = kernels.variant(kernels.MPH_NR, kernels.MPH_NR_F64, dt)
    Vg0, vs = _lane_param(Vg0, "Vg0", S, (d, d))
    Ve0, vs2 = _lane_param(Ve0, "Ve0", S, (d, d))
    if vs != vs2:
        raise ValueError("Vg0 and Ve0 must both be shared or both per lane")
    p2 = d * (d + 1)
    dev = eval_.device
    Vg = torch.empty((S, d, d), dtype=_F64, device=dev)
    Ve = torch.empty_like(Vg)
    logl = torch.empty(S, dtype=_F64, device=dev)
    Hvar = torch.empty((S, p2, p2), dtype=_F64, device=dev)
    if S:
        kern.launch_lanes(dev, S, kern.lane_bytes(d, c), lambda s0, k, w: (
            int(reml), int(max_iter), float(prec), S, n, d, c0, r,
            eval_.data_ptr(), X0.data_ptr(), Y.data_ptr(), R.data_ptr(),
            Vg0.data_ptr(), Ve0.data_ptr(), vs, Vg.data_ptr(), Ve.data_ptr(),
            logl.data_ptr(), Hvar.data_ptr(), s0, k, w))
    return Vg, Ve, logl, Hvar


def mph_nr(reml: bool, max_iter: int, prec: float, eval_, X0, Y, R, Vg0,
           Ve0):
    """Per-lane Newton-Raphson on vech(Vg, Ve) with GEMMA's step-halving
    and acceptance rules (K11 on the card).  Returns (Vg, Ve, logl, Hvar =
    -H^-1), float64."""
    fn = mph_nr_plain if eval_.device.type == "cpu" else mph_nr_cuda
    return fn(reml, max_iter, prec, eval_, X0, Y, R, Vg0, Ve0)


# ---------------------------------------------------------------------------
# K14 calc_crt

_CRT_CHUNK = 256        # lanes per step of the plain version


def _lu_inv(M: torch.Tensor) -> torch.Tensor:
    """Batched inverse by LU with partial pivoting: a singular matrix gives
    inf/NaN, as the reference's jnp.linalg.inv, not an error."""
    LU, piv, _ = torch.linalg.lu_factor_ex(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.lu_solve(LU, piv, eye.expand_as(M))


def _crt_lanes(ev, X, Vg, Ve, Hvar):
    """(crt_a, crt_b, crt_c) of the lanes of X (S, c, n), float64.

    The reference (mvlmm_core.py:561-678) forms the (v, cd, cd) stacks
    M_g, M_e and, per v1, MM_gg, MM_ge, MM_ee, and takes each trace
    against Qi_si = ((Qi)_ss)^-1 from whole (cd, cd) products.  Every
    trace reads only the SNP block's rows s of Qi, so with Qs = Qi[s, :],
    R_k = Qs (x_k kron I_d), P_k = R_k Hi_k, Z = Qi_si and F_k = P_k' Z P_k:

        (Qi M_p[v] Qi)_ss        = Σ_k δ_k^p P_k D_v P_k'         (SS_p[v])
        tr((Qi MM_p Qi)_ss Z)    = Σ_k δ_k^p tr(D_1 Hi_k D_2 F_k)  (from
                                   T_p = Σ_k δ_k^p Hi_k ⊗ F_k)
        (Qi M_1 Qi M_2 Qi)_ss    = L_1 Qi L_2',  L_p[v] = Qs M_p[v]
                                 = Σ_k δ_k^p x_k' ⊗ (P_k D_v Hi_k)

    with D_v the vech basis, M_p's weights δ^p (g: p = 1, e: p = 0) and
    MM's δ^p (gg: 2, ge: 1, ee: 0).  K14 accumulates the same sums."""
    S, c, n = X.shape
    d = Vg.shape[-1]
    vs = d * (d + 1) // 2
    cd = c * d
    dev = X.device
    Sb = vech_basis(d, device=dev)                           # (v, d, d)
    D_l, UltVeh, A, _ = eigen_proc(Vg, Ve)
    w = 1.0 / (D_l[..., None] * ev + 1.0)                    # (S, d, n)
    Hi = torch.einsum("sli,sln,slj->snij", A, w, A)          # (S, n, d, d)
    Qi_w, _ = calc_qi(ev, D_l, X)
    Qi = torch.einsum("ski,sakbl,slj->saibj", UltVeh,
                      Qi_w.reshape(S, c, d, c, d), UltVeh).reshape(S, cd, cd)
    s0 = (c - 1) * d
    Qs = Qi[:, s0:s0 + d, :].reshape(S, d, c, d)
    Z = _lu_inv(Qi[:, s0:s0 + d, s0:s0 + d])
    Rk = torch.einsum("san,siaj->snij", X, Qs)               # (S, n, d, d)
    P = Rk @ Hi
    F = torch.einsum("snai,sab,snbj->snij", P, Z, P)
    e = [torch.ones_like(ev), ev, ev * ev]
    # SS_p[v] (S, v, d, d) and C_p[v] = SS_p[v] Z, p = 0 (e), 1 (g)
    C = [torch.einsum("n,snai,vij,snbj->svab", e[p], P, Sb, P) @ Z[:, None]
         for p in range(2)]
    # tr(D_1 Hi D_2 F) summed with δ^p: T_p[b, c, e, a]
    MMtr = [torch.einsum("vab,wce,sbcea->svw", Sb, Sb,
                         torch.einsum("n,snbc,snea->sbcea", e[p], Hi, F))
            for p in range(3)]
    # L_p[v] (S, v, d, cd) and Y_p[v] = Qi L_p[v]' Z (S, v, cd, d)
    PD = torch.einsum("snai,vij->svnaj", P, Sb)
    PDH = torch.einsum("svnaj,snje->svnae", PD, Hi)
    L = [torch.einsum("n,sbn,svnae->svabe", e[p], X, PDH).reshape(S, vs, d, cd)
         for p in range(2)]
    Y = [Qi[:, None] @ L[p].transpose(-1, -2) @ Z[:, None] for p in range(2)]

    def tt(p1, p2):                                          # tr(L1 Qi L2' Z)
        return torch.einsum("svam,swma->svw", L[p1], Y[p2])

    def cc(x, y):                                            # tr(C1 C2)
        return torch.einsum("svab,swba->svw", x, y)

    trB_gg = -tt(1, 1) + MMtr[2]
    trB_ge = -(tt(1, 0) + tt(0, 1)) + 2.0 * MMtr[1]
    trB_ee = -tt(0, 0) + MMtr[0]
    Cg, Ce = C[1], C[0]
    trCg = -torch.diagonal(Cg, dim1=-2, dim2=-1).sum(-1)     # (S, v)
    trCe = -torch.diagonal(Ce, dim1=-2, dim2=-1).sum(-1)
    trCC_gg, trCC_ee = cc(Cg, Cg), cc(Ce, Ce)
    trCC_ge = cc(Cg, Ce) + cc(Ce, Cg)
    hg, he, hx = Hvar[:, :vs, :vs], Hvar[:, :vs, vs:], Hvar[:, vs:, vs:]
    # v1 <= v2, the v1 != v2 terms doubled with the same h (GEMMA's quirk,
    # mvlmm.cpp:2309-2325)
    mult = torch.triu(torch.full((vs, vs), 2.0, dtype=_F64, device=dev), 1) \
        + torch.eye(vs, dtype=_F64, device=dev)
    o = lambda a, b: a[:, :, None] * b[:, None, :]           # noqa: E731
    B = (mult * (hg * trB_gg + he * trB_ge + hx * trB_ee)).sum((-1, -2))
    Cs = (mult * (hg * (trCC_gg + 0.5 * o(trCg, trCg))
                  + he * (trCC_ge + 0.5 * o(trCg, trCe) + 0.5 * o(trCe, trCg))
                  + hx * (trCC_ee + 0.5 * o(trCe, trCe)))).sum((-1, -2))
    Ds = (mult * (hg * (trCC_gg + trB_gg) + he * (trCC_ge + trB_ge)
                  + hx * (trCC_ee + trB_ee))).sum((-1, -2))
    return 2.0 * Ds - Cs, 2.0 * B, Cs


def calc_crt_plain(eval_, X0, R, Vg, Ve, Hvar):
    """PyTorch version of K14: CalcCRT (mvlmm_core.py:561-678) of each
    lane at its Newton optimum, the tested row R[:, -1] last in the
    design; Vg, Ve (S, d, d) and Hvar (S, 2v, 2v) = -H^-1 from mph_nr.
    Returns (crt_a, crt_b, crt_c), each (S,) float64."""
    ev = eval_.to(_F64)
    S = R.shape[0]
    out = [torch.empty(S, dtype=_F64, device=R.device) for _ in range(3)]
    for a in range(0, S, _CRT_CHUNK):
        b = min(a + _CRT_CHUNK, S)
        res = _crt_lanes(ev, design(X0, R[a:b]), Vg[a:b].to(_F64),
                         Ve[a:b].to(_F64), Hvar[a:b].to(_F64))
        for o, r in zip(out, res):
            o[a:b] = r
    return tuple(out)


def calc_crt_cuda(eval_, X0, R, Vg, Ve, Hvar):
    """K14 on the card, float64 operands (-crt runs in float64); its
    per-lane sums live in a scratch the wrapper allocates, the lanes split
    into launches whose scratch fits the budget."""
    n = eval_.shape[0]
    c0, (S, r) = X0.shape[0], R.shape[:2]
    d = Vg.shape[-1]
    kernels.check_mvlmm_shape(d, c0 + r)
    if r < 1:
        raise ValueError("calc_crt: the tested row is the lane's last row")
    kernels.check_operand(eval_, "eval", _F64, (n,))
    kernels.check_operand(X0, "X0", _F64, (c0, n))
    kernels.check_operand(R, "R", _F64, (S, r, n))
    p2 = d * (d + 1)
    Vg, Ve, Hvar = (t.to(_F64).contiguous() for t in (Vg, Ve, Hvar))
    kernels.check_operand(Vg, "Vg", _F64, (S, d, d))
    kernels.check_operand(Ve, "Ve", _F64, (S, d, d))
    kernels.check_operand(Hvar, "Hvar", _F64, (S, p2, p2))
    dev = eval_.device
    out = torch.empty((3, S), dtype=_F64, device=dev)
    kern = kernels.CALC_CRT
    if S:
        kern.launch_lanes(dev, S, kern.lane_bytes(d, c0 + r),
                          lambda s0, k, w: (
            S, n, d, c0, r, eval_.data_ptr(), X0.data_ptr(), R.data_ptr(),
            Vg.data_ptr(), Ve.data_ptr(), Hvar.data_ptr(), out.data_ptr(),
            s0, k, w))
    return out[0], out[1], out[2]


def calc_crt(eval_, X0, R, Vg, Ve, Hvar):
    """Edgeworth correction factors (crt_a, crt_b, crt_c) of each lane's
    last row at the lane's Newton optimum (K14 on the card)."""
    fn = calc_crt_plain if eval_.device.type == "cpu" else calc_crt_cuda
    return fn(eval_, X0, R, Vg, Ve, Hvar)
