"""Variance components from kinship matrices (-vc 1/2/3), with the pair
column sums K15.

GEMMA src/vc.cpp; the reference is gemma_tpu/models/vc.py.  Over a stack
of m kinship matrices K_i (n×n each) with covariates W and phenotype y:

  * vc_he      (CalcVChe, vc.cpp:1503-1723) — Haseman-Elston: project W
               out of each K and y, solve S pve = q with S_ij = tr(K_i K_j)
               - n r and q_i = y'(K_i - r I) y, and the sampling covariance
               of q from the y'K_r K_l K_r y forms.
  * vc_reml_ai (CalcVCreml, vc.cpp:1726-1930) — REML by damped Newton on
               d logRL / d log σ² with the average-information matrix,
               to an ||dev1||_1 < 1e-3 residual (the reference's stand-in
               for GSL's hybridsj).
  * vc_acl     (CalcVCacl, vc.cpp:1933-2220) — the ACL method of moments
               on correlation-standardised kinships.

The n×n work stays on the device: centring, matrix-vector products, the
REML step's inverse and solves (cuBLAS and cuSOLVER through torch), and
the Hadamard pair reductions, which are K15:

  K15 pair_colsum  out[i, j, t] = Σ_s A_i[s, t] B_j[s, t] over stacks A
                   (ma, n, n) and B (mb, n, n), float64 sums: HE's
                   tr(K_i K_j) and REML's tr(P K_i) (K symmetric) are its
                   sums over t, ACL's n1 is it minus 1.  One pass reads
                   each n×n matrix once for all pairs
                   (csrc/pair_colsum.cu).

The m+1 <= 10 parameter algebra runs on the host in float64, as in the
reference.  `auto` precision is float32 on cuda: the operands and
products are float32, the pair sums float64.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gemma_torch import kernels
from gemma_torch.ops.center import (center_matrix_w, center_vector_w,
                                    scale_matrix)

_F64 = torch.float64
# matrices of one stack per K15 launch (PC_MAX_M in csrc/pair_colsum.cu)
PC_MAX_M = 8
# K15's grid (csrc/pair_colsum.cu): threads a column tile is wide, rows a
# row slice takes at least, blocks wanted on each SM
PC_LANES, PC_ROWS_MIN, PC_BLOCKS_PER_SM = 32, 32, 4


@dataclasses.dataclass
class VcResult:
    sigma2: np.ndarray        # (m+1,) incl. residual
    se_sigma2: np.ndarray
    pve: np.ndarray           # (m,)
    se_pve: np.ndarray
    pve_total: float
    se_pve_total: float


# ---------------------------------------------------------------------------
# K15 pair_colsum

def pair_colsum_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """PyTorch version of K15: out[i, j, t] = Σ_s A[i, s, t] B[j, s, t],
    (ma, mb, n) float64."""
    return torch.einsum("ist,jst->ijt", A.to(_F64), B.to(_F64))


def pc_cols_per_thread(m: int, isz: int, n: int, aligned: bool) -> int:
    """Columns a thread of a K15 launch reads at once, for stacks of up
    to m matrices of isz-byte values: 16 bytes where the products fit the
    registers (m <= 2; float64 also m = 4), 8 for float32 at m = 4, one
    value at m = 8, and one wherever n or an operand's address is not a
    multiple of the vector (pair_colsum_vec in csrc/pair_colsum.cu)."""
    m = 1 << max(0, m - 1).bit_length()       # 1, 2, 4 or 8, as the kernel
    v16 = 16 // isz
    v = v16 if m <= 2 else (2 if m == 4 else 1)
    return v if aligned and n % v == 0 else 1


def pc_slices(n: int, cols: int, sms: int) -> tuple:
    """(rows, ns): K15 splits the n rows into ns slices of `rows` (the
    last may be shorter, none empty) so that its grid, one block per
    tile of PC_LANES * cols columns and slice, puts PC_BLOCKS_PER_SM
    blocks on each of the card's sms SMs, with at least PC_ROWS_MIN rows
    a slice where n has them."""
    tiles = -(-n // (PC_LANES * cols))
    want = -(-PC_BLOCKS_PER_SM * sms // tiles)
    ns = max(1, min(want, n // PC_ROWS_MIN))
    rows = -(-n // ns)
    return rows, -(-n // rows)


@functools.lru_cache(maxsize=256)
def pc_launches(ma: int, mb: int, n: int, isz: int, sms: int,
                aligned: bool) -> tuple:
    """K15's launches for stacks of ma and mb n×n matrices: one per pair
    of chunks of PC_MAX_M, each (i0, j0, ka, kb, cols, rows, ns)."""
    out = []
    for i0 in range(0, ma, PC_MAX_M):
        for j0 in range(0, mb, PC_MAX_M):
            ka, kb = min(PC_MAX_M, ma - i0), min(PC_MAX_M, mb - j0)
            cols = pc_cols_per_thread(max(ka, kb), isz, n, aligned)
            out.append((i0, j0, ka, kb, cols, *pc_slices(n, cols, sms)))
    return tuple(out)


def pc_scratch_words(launches: tuple, n: int) -> int:
    """float64 words of the slices' partial sums that one scratch must
    hold for every launch in turn: ns ka kb n at the largest."""
    return max((ns * ka * kb * n for _, _, ka, kb, _, _, ns in launches),
               default=0)


def pair_colsum_cuda(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """K15 on the card: one launch per pair of chunks of PC_MAX_M
    matrices (one launch for m <= 8), its rows split over the grid and
    the slices' partial sums added in slice order; where B is A each
    matrix is read once for all its pairs."""
    dt = A.dtype
    ma, n = A.shape[0], A.shape[-1]
    mb = B.shape[0]
    kernels.check_operand(A, "A", dt, (ma, n, n))
    kernels.check_operand(B, "B", dt, (mb, n, n))
    kern = kernels.variant(kernels.PAIR_COLSUM, kernels.PAIR_COLSUM_F64, dt)
    same = A.data_ptr() == B.data_ptr() and ma == mb
    out = torch.empty((ma, mb, n), dtype=_F64, device=A.device)
    isz = A.element_size()
    aligned = (A.data_ptr() | B.data_ptr()) % 16 == 0
    plan = pc_launches(ma, mb, n, isz, kernels.sm_count(A.device), aligned)
    part = torch.empty(pc_scratch_words(plan, n), dtype=_F64,
                       device=A.device)
    for i0, j0, ka, kb, cols, rows, ns in plan:
        kern.launch(A.device, ka, kb, n, int(same and i0 == j0), rows, ns,
                    cols, A.data_ptr() + i0 * n * n * isz,
                    B.data_ptr() + j0 * n * n * isz, mb, part.data_ptr(),
                    out.data_ptr() + (i0 * mb + j0) * n * 8)
    return out


def pair_colsum(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Column sums of every pair's Hadamard product, (ma, mb, n) float64
    (K15 on the card)."""
    fn = pair_colsum_plain if A.device.type == "cpu" else pair_colsum_cuda
    return fn(A, B)


# ---------------------------------------------------------------------------
# HE regression

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(_F64).cpu().numpy()


def _he_core(K, W, y):
    """Device core of the HE regression (the reference's _he_core,
    vc.py:50-97) on K (m, n, n); returns host float64 (q, S, ylkj, rr,
    traceG_new, var_y, var_y_new, r)."""
    m, n, _ = K.shape
    c = W.shape[1]
    r = n / (n - c)
    Kc = torch.stack([center_matrix_w(K[i], W) for i in range(m)])
    traceG_new = torch.diagonal(Kc, dim1=-2, dim2=-1).mean(-1)
    K_scale = torch.stack([scale_matrix(Kc[i]) for i in range(m)])
    del Kc
    y_c = center_vector_w(y, W)
    var_y = torch.var(y, correction=0)
    var_y_new = torch.var(y_c, correction=0)
    y_s = (y_c - y_c.mean()) / torch.sqrt(var_y_new)
    Kry = K_scale @ y_s - r * y_s                          # (m, n)
    q = Kry @ y_s
    S = pair_colsum(K_scale, K_scale).sum(-1) - r * n
    KKry = (K_scale @ Kry.T).transpose(1, 2)               # (l, m, n)
    ylkj = torch.einsum("mi,lji->mlj", Kry, KKry)          # [i, l, j]
    rr = Kry @ Kry.T
    return (_np(q), _np(S), _np(ylkj), _np(rr), _np(traceG_new),
            float(var_y), float(var_y_new), r)


def vc_he(K: torch.Tensor, W: torch.Tensor, y: torch.Tensor,
          v_traceG: np.ndarray) -> VcResult:
    """HE regression.  K: (m, n, n) centred kinship matrices on the
    device; v_traceG: their mean diagonals (after plain centring)."""
    q, S, ylkj, rr, traceG_new, var_y, var_y_new, r = _he_core(K, W, y)
    m = K.shape[0]
    Si = np.linalg.inv(S)
    pve_t = Si @ q
    s_rem = 1.0 - np.sum(pve_t)
    qvar = 2.0 * (np.einsum("l,ilj->ij", pve_t, ylkj) + s_rem * rr)
    Var = Si @ qvar @ Si

    sigma2, se_sigma2, pve, se_pve = [], [], [], []
    s = 1.0
    v = 0.0
    pve_total = 0.0
    se_pve_total = 0.0
    for i in range(m):
        d = pve_t[i]
        scale_i = var_y_new / traceG_new[i]
        sigma2.append(d * scale_i)
        pve.append(d * scale_i * (v_traceG[i] / var_y))
        s -= d
        pve_total += d * scale_i * (v_traceG[i] / var_y)
        sd = np.sqrt(Var[i, i])
        se_sigma2.append(sd * scale_i)
        se_pve.append(sd * scale_i * (v_traceG[i] / var_y))
        for j in range(m):
            v += Var[i, j]
            se_pve_total += (Var[i, j]
                             * (var_y_new / traceG_new[i])
                             * (v_traceG[i] / var_y)
                             * (var_y_new / traceG_new[j])
                             * (v_traceG[j] / var_y))
    sigma2.append(s * r * var_y_new)
    se_sigma2.append(np.sqrt(max(v, 0.0)) * r * var_y_new)
    return VcResult(
        sigma2=np.asarray(sigma2), se_sigma2=np.asarray(se_sigma2),
        pve=np.asarray(pve), se_pve=np.asarray(se_pve),
        pve_total=float(pve_total),
        se_pve_total=float(np.sqrt(max(se_pve_total, 0.0))))


# ---------------------------------------------------------------------------
# REML with average information

def _reml_dev12(theta: np.ndarray, K, W, y, noconstrain: bool):
    """dev1 (m+1,) and AI dev2 (m+1, m+1) of logRL in theta (log σ², or σ²
    unconstrained), host float64 (UpdateParam + LogRL_dev12,
    vc.cpp:168-407; the reference's vc.py:135-167)."""
    m, n, _ = K.shape
    s2_np = theta if noconstrain else np.exp(theta)
    s2 = torch.as_tensor(s2_np, dtype=K.dtype, device=K.device)
    H = torch.tensordot(s2[:m], K, dims=1)
    H.diagonal().add_(s2[m])
    Hi = torch.linalg.inv(H)
    HiW = Hi @ W
    P = Hi - HiW @ torch.linalg.solve(W.T @ HiW, HiW.T)
    Py = P @ y
    KPy = torch.cat([K @ Py, Py[None]])                    # (m+1, n)
    PKPy = KPy @ P.T
    tr = torch.cat([pair_colsum(P[None].contiguous(), K)[0].sum(-1),
                    torch.trace(P).to(_F64)[None]])
    yPKPy = KPy @ Py
    dev1 = -0.5 * _np(tr) + 0.5 * _np(yPKPy)
    dev2 = -0.5 * _np(KPy @ PKPy.T)
    if not noconstrain:
        dev1 = dev1 * s2_np
        dev2 = dev2 * s2_np[:, None] * s2_np[None, :]
    return dev1, dev2


def vc_reml_ai(K: torch.Tensor, W: torch.Tensor, y: torch.Tensor,
               v_traceG: np.ndarray, noconstrain: bool = False,
               max_iter: int = 100, tol: float = 1e-3) -> VcResult:
    """REML via Newton on the score equations with the AI matrix, from
    the HE estimates."""
    m = K.shape[0]
    he = vc_he(K, W, y, v_traceG)
    if noconstrain:
        theta = he.sigma2.copy()
    else:
        theta = np.log(np.where(he.sigma2 <= 0, 0.1, he.sigma2))

    dev1, dev2 = _reml_dev12(theta, K, W, y, noconstrain)
    for _ in range(max_iter):
        if np.sum(np.abs(dev1)) < tol:
            break
        try:
            step = np.linalg.solve(dev2, dev1)
        except np.linalg.LinAlgError:
            step = np.linalg.pinv(dev2) @ dev1
        if not np.all(np.isfinite(step)):
            break  # boundary optimum (a component's sigma2 → 0)
        # damped Newton: halve until the residual shrinks
        res0 = np.sum(np.abs(dev1))
        scale = 1.0
        for _ in range(12):
            theta_try = theta - scale * step
            if not noconstrain:
                theta_try = np.clip(theta_try, -30.0, 30.0)
            d1t, d2t = _reml_dev12(theta_try, K, W, y, noconstrain)
            if np.all(np.isfinite(d1t)) and (
                    np.sum(np.abs(d1t)) < res0 or scale < 1e-3):
                break
            scale *= 0.5
        theta = theta_try
        dev1, dev2 = d1t, d2t

    Hess = dev2
    try:
        Hinv = np.linalg.inv(Hess)
    except np.linalg.LinAlgError:
        Hinv = np.linalg.pinv(Hess)

    sigma2 = theta if noconstrain else np.exp(theta)
    if noconstrain:
        se_sigma2 = np.sqrt(np.maximum(-np.diag(Hinv), 0.0))
    else:
        se_sigma2 = np.sqrt(np.maximum(
            -sigma2 * sigma2 * np.diag(Hinv), 0.0))

    s = float(np.sum(v_traceG * sigma2[:m]) + sigma2[m])
    pve = v_traceG * sigma2[:m] / s
    pve_total = float(np.sum(pve))

    # delta-method se(pve) (vc.cpp:1853-1916)
    se_pve = np.zeros(m)
    se_pve_total = 0.0
    grads = np.zeros((m + 1, m + 1))  # grads[k, i] = d pve_k / d theta_i
    for k in range(m + 1):
        for i in range(m + 1):
            d1 = 1.0 if noconstrain else sigma2[i]
            if k < m:
                if i == k:
                    d1 *= v_traceG[k] * (s - sigma2[k] * v_traceG[k]) / (s * s)
                elif i == m:
                    d1 *= -1 * v_traceG[k] * sigma2[k] / (s * s)
                else:
                    d1 *= -1 * v_traceG[i] * v_traceG[k] * sigma2[k] / (s * s)
            else:
                if i == k:
                    d1 *= -1 * (s - sigma2[m]) / (s * s)
                else:
                    d1 *= v_traceG[i] * sigma2[m] / (s * s)
            grads[k, i] = d1
    for k in range(m + 1):
        var_k = -grads[k] @ Hinv @ grads[k]
        if k < m:
            se_pve[k] = np.sqrt(max(var_k, 0.0))
        else:
            se_pve_total = float(np.sqrt(max(var_k, 0.0)))

    return VcResult(sigma2=np.asarray(sigma2), se_sigma2=se_sigma2,
                    pve=pve, se_pve=se_pve, pve_total=pve_total,
                    se_pve_total=se_pve_total)


# ---------------------------------------------------------------------------
# ACL estimator (-vc 3)

def _acl_moments(K, W, y):
    """The moments of the ACL fixed point (CalcVCacl vc.cpp:1933-2052;
    the reference's vc.py:262-289): each kinship W-projected and
    correlation-standardised (diagonal 1), y W-residualised, q, n1[i, j,
    t] = Σ_s (Ks_i ∘ Ks_j)[s, t] - 1 (K15), S1 and S2.  Returns the
    device Ks, y_s, n1 and host float64 y2_sum, q, S1, S2."""
    m, n, _ = K.shape
    Ks = torch.empty_like(K)
    for i in range(m):
        Kc = center_matrix_w(K[i], W)
        dd = torch.diagonal(Kc)
        Ks[i] = Kc / torch.sqrt(torch.outer(dd, dd))
        Ks[i].fill_diagonal_(1.0)
    y_s = center_vector_w(y, W)
    y2 = y_s * y_s
    y2_sum = y2.sum()
    q = (Ks @ y_s) @ y_s - y2_sum
    n1 = pair_colsum(Ks, Ks) - 1.0                          # (m, m, n)
    S1 = 2.0 * n1 @ y2.to(_F64)
    S2 = n1.sum(2)
    return Ks, y_s, n1, float(y2_sum), _np(q), _np(S1), _np(S2)


def _acl_variance(Ks, y_s, n1, pve: np.ndarray, tau_inv: float):
    """J_ij = 2 (A_i y)' V (A_j y) with A_i = Ks_i, its diagonal replaced
    by Σ_j pve_j n1[i, j, :], and V = tau_inv Σ_i pve_i Ks_i
    (vc.cpp:2080-2124).  A_i is never formed: diag(Ks_i) = 1, so A_i y =
    Ks_i y - y + diag_new_i ∘ y."""
    pv = torch.as_tensor(pve, dtype=_F64, device=Ks.device)
    diag_new = torch.einsum("ijt,j->it", n1, pv).to(Ks.dtype)   # (m, n)
    Ay = Ks @ y_s - y_s + diag_new * y_s                         # (m, n)
    M = torch.stack([Ay @ (Ks[l] @ Ay.T) for l in range(Ks.shape[0])])
    return 2.0 * tau_inv * np.einsum("l,lij->ij", pve, _np(M))


def vc_acl(K: torch.Tensor, W: torch.Tensor, y: torch.Tensor,
           v_traceG: np.ndarray, max_iter: int = 100,
           tol: float = 1e-3) -> VcResult:
    """ACL method-of-moments estimator (CalcVCacl, vc.cpp:1933-2220):
    alternate tau_inv = var(y) - q'h/(n(n-1)) and the moment solve h =
    (S1 - tau_inv S2)^-1 q until tau_inv moves by less than 1e-3
    relative."""
    m, n, _ = K.shape
    Ks, y_s, n1, y2s, q, S1, S2 = _acl_moments(K, W, y)
    # the first pass overwrites the pre-loop tau_inv with the pve = 0
    # value y2_sum/n (the reference's pve vector starts zeroed)
    pve = np.zeros(m)
    tau_inv = y2s / n
    s_rel = 1.0
    for it in range(max_iter):
        d = float(q @ pve)
        tau_new = y2s / n - d / (n * (n - 1.0))
        if it > 0:
            s_rel = (tau_new - tau_inv) / tau_new
        tau_inv = tau_new
        pve = np.linalg.solve(S1 - tau_inv * S2, q)
        if it > 0 and abs(s_rel) <= tol:
            break

    J = _acl_variance(Ks, y_s, n1, pve, tau_inv)
    Hi = np.linalg.inv(S2 * tau_inv)
    Var = Hi @ J @ Hi

    pve_total = float(np.sum(pve))
    se_pve = np.sqrt(np.maximum(np.diag(Var), 0.0))
    v_traceG = np.asarray(v_traceG)
    sigma2 = np.concatenate([pve * tau_inv / v_traceG,
                             [(1.0 - pve_total) * tau_inv]])
    var_sum = float(np.sum(Var))
    se_sigma2 = np.concatenate([se_pve * tau_inv / v_traceG,
                                [np.sqrt(max(var_sum, 0.0)) * tau_inv]])
    return VcResult(sigma2=sigma2, se_sigma2=se_sigma2, pve=pve,
                    se_pve=se_pve, pve_total=pve_total,
                    se_pve_total=float(np.sqrt(max(var_sum, 0.0))))
