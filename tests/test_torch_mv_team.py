"""The mvLMM kernels' team design (csrc/mvlmm_lane.cuh) on the CPU:

  * the lane counter's schedule: teams that take lanes from one counter
    in any interleaving fit each lane exactly once;
  * the path's rotation of a SNP block (run._mv_rotate): a SNP's rotated
    row does not depend on its block;
  * a numpy emulation of the kernels' order of summation (individual k to
    partial sum k mod 4, each in increasing k, then the four added as
    ((q0 + q1) + (q2 + q3))), each sum named by its families' rows
    as the kernels' descriptors name them: one EM iteration's Vg, Ve, B
    and logl against mph_em_plain, and the Newton derivatives against
    nr_derivatives, at 1e-12 relative (both sum the same float64 products
    in another order).

No JAX here: the port's fits are held against gemma_tpu in
tests/test_torch_mvlmm.py.
"""

import numpy as np
import pytest
import torch

from gemma_torch.models import mvlmm_core as mvc
from gemma_torch.run import _mv_rotate


# ---------------------------------------------------------------------------
# the lane counter and the rotation (the kernels' own geometry and
# <name>_lane_bytes are held on the card by chip_smoke.py)

@pytest.mark.parametrize("count", (1, 3, 7, 8, 9, 64, 1000))
@pytest.mark.parametrize("L", (1, 2))
def test_lane_counter(count, L):
    """Teams (the launch's blocks times L) take lanes from one counter in
    an arbitrary interleaving: every lane once, every team leaves."""
    teams = -(-count // L) * L
    rng = np.random.default_rng(count)
    ctr, seen, live = 0, [], list(range(teams))
    while live:
        t = live[rng.integers(len(live))]
        lane, ctr = ctr, ctr + 1          # atomicAdd(ctr, 1)
        if lane >= count:
            live.remove(t)
        else:
            seen.append(lane)
    assert sorted(seen) == list(range(count))
    assert ctr == count + teams


@pytest.mark.parametrize("a,k", [(0, 1), (0, 16), (0, 256), (500, 16),
                                 (7, 1), (1030, 700), (0, 2100)])
def test_mv_rotate_does_not_depend_on_block(a, k):
    """The mvLMM's rotation of SNPs a .. a + k alone equals their rows of
    the whole set's, bit for bit (one GEMM shape whatever the block), and
    x U to rounding."""
    rng = np.random.default_rng(k)
    n = 300
    U = torch.linalg.qr(torch.as_tensor(rng.normal(size=(n, n))))[0]
    x = torch.as_tensor(rng.binomial(2, 0.3, size=(2100, n)),
                        dtype=torch.float64)
    sub = _mv_rotate(x[a:a + k], U)
    assert torch.equal(sub, _mv_rotate(x, U)[a:a + k])
    assert torch.allclose(sub, x[a:a + k] @ U, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the kernels' order of summation, emulated

def _fold(p: np.ndarray) -> float:
    """Σ p in the kernels' order: partial sum k mod 4 adds its individuals
    in increasing k, then ((q0 + q1) + (q2 + q3))."""
    q = np.zeros(4)
    for k in range(len(p)):
        q[k % 4] = q[k % 4] + p[k]
    return float((q[0] + q[1]) + (q[2] + q[3]))


def _rows(ev, X, Y, D, A, mode, beta=None, Qi=None):
    """The staged rows of one lane (mv_stage): 1, δ, δ², x, then w, z, log
    v (mode "z") or w, py, h = x'Qi_l x (mode "py")."""
    d, c = A.shape[0], X.shape[0]
    w = 1.0 / (D[:, None] * ev + 1.0)
    z = A @ Y
    rows = [np.ones_like(ev), ev, ev * ev, *X, *w]
    if mode == "z":
        rows += [*z, *np.log(1.0 / w)]
    else:
        rows += [*(w * (z - beta @ X)),
                 *np.einsum("in,lij,jn->ln", X, Qi, X)]
    return np.array(rows), d, c


def _sum(rows, *idx):
    """One sum: its rows' product, left to right, folded in the kernels'
    order."""
    p = rows[idx[0]]
    for i in idx[1:]:
        p = p * rows[i]
    return _fold(p)


def _core(rows, d, c):
    """The core families (F_Q, F_XWZ, F_QUAD, F_R3) as the kernel's sums:
    the Gram blocks Q (d, c, c), XWz (d, c), quad, logd."""
    X, W = 3, 3 + c
    Z, R3 = W + d, W + 2 * d
    Q = np.array([[[_sum(rows, X + i, X + j, W + l) for j in range(c)]
                   for i in range(c)] for l in range(d)])
    xwz = np.array([[_sum(rows, X + i, W + l, Z + l) for i in range(c)]
                    for l in range(d)])
    quad = sum(_sum(rows, Z + l, Z + l, W + l) for l in range(d))
    logd = sum(_sum(rows, R3 + l) for l in range(d))
    return Q, xwz, quad, logd


def _block(d, c, n, seed):
    rng = np.random.default_rng(seed)
    G = rng.binomial(2, 0.3, size=(200, n)).astype(float)
    G -= G.mean(1, keepdims=True)
    ev = np.clip(np.linalg.eigvalsh(G.T @ G / 200), 0.0, None)
    X = np.vstack([np.ones(n), rng.normal(size=(c - 1, n))])
    Y = rng.normal(size=(d, n))
    Vg = np.cov(rng.normal(size=(d, 3 * d))) + 0.3 * np.eye(d)
    Ve = np.cov(rng.normal(size=(d, 3 * d))) + 0.5 * np.eye(d)
    return ev, X, Y, Vg, Ve


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain loops over small tensors, one torch thread (the other
    test workers hold the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d,c,n", [(2, 2, 64), (3, 3, 45), (2, 4, 37)])
def test_em_iteration_in_kernel_order(d, c, n):
    """One REML EM iteration from the kernel's sums (passes X, A, B of
    csrc/mph_em.cu) against mph_em_plain's."""
    ev, X, Y, Vg, Ve = _block(d, c, n, seed=d * 10 + c)
    D, Uh, A, logdet, _ = (x[0].numpy() if x.dim() else float(x[0])
                           for x in mvc.eigen_proc(_t(Vg)[None], _t(Ve)[None],
                                                   with_ul=True))
    rows, d, c = _rows(ev, X, Y, D, A, "z")
    Q, xwz, quad, logd = _core(rows, d, c)
    Qi = np.linalg.inv(Q)
    beta = np.einsum("lij,lj->li", Qi, xwz)
    XX = np.array([[_sum(rows, 3 + i, 3 + j) for j in range(c)]
                   for i in range(c)])
    const = -0.5 * (n - c) * d * np.log(2 * np.pi) \
        + 0.5 * d * np.linalg.slogdet(XX)[1]
    logl = const - 0.5 * (quad + logd - (xwz * beta).sum()) \
        - 0.5 * n * logdet - 0.5 * (np.linalg.slogdet(Q)[1].sum()
                                    - c * logdet)
    W, Z, R3 = 3 + c, 3 + c + d, 3 + c + 2 * d
    sw = np.array([_sum(rows, W + l) for l in range(d)])
    sdw = np.array([_sum(rows, 1, W + l) for l in range(d)])
    rb, _, _ = _rows(ev, X, Y, D, A, "py", beta, Qi)
    G0 = np.array([[_sum(rb, Z + l, Z + m) for m in range(d)]
                   for l in range(d)])
    G1 = np.array([[_sum(rb, 1, Z + l, Z + m) for m in range(d)]
                   for l in range(d)])
    se = np.array([_sum(rb, W + l, W + l, R3 + l) for l in range(d)])
    su = np.array([_sum(rb, 1, W + l, W + l, R3 + l) for l in range(d)])
    U = D[:, None] * G1 * D[None, :] + np.diag(D * sw + D * D * su)
    E = G0 + np.diag(D * sdw + se)
    Vg1, Ve1 = Uh.T @ U @ Uh / n, Uh.T @ E @ Uh / n
    B1 = Uh.T @ beta
    pp = mvc.mph_em_plain(True, 1, 0.0, _t(ev), _t(X), _t(Y),
                          torch.zeros((1, 0, n), dtype=torch.float64),
                          _t(Vg)[None], _t(Ve)[None],
                          torch.zeros((1, d, c), dtype=torch.float64))
    for got, ref in ((Vg1, pp.Vg[0]), (Ve1, pp.Ve[0]), (B1, pp.B[0]),
                     (logl, pp.logl[0])):
        ref = np.asarray(ref)
        assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


@pytest.mark.parametrize("d,c,n", [(2, 2, 64), (3, 2, 50)])
def test_nr_derivatives_in_kernel_order(d, c, n):
    """The REML gradient and Hessian from the kernel's sums (passes A and
    B of csrc/mph_nr.cu, contracted as its trace tables and Hessian loop
    do) against nr_derivatives."""
    ev, X, Y, Vg, Ve = _block(d, c, n, seed=7 + d)
    D, Uh, A, logdet, _ = (x[0].numpy() if x.dim() else float(x[0])
                           for x in mvc.eigen_proc(_t(Vg)[None], _t(Ve)[None],
                                                   with_ul=True))
    rows, d, c = _rows(ev, X, Y, D, A, "z")
    Q, xwz, _, _ = _core(rows, d, c)
    Qi = np.linalg.inv(Q)
    beta = np.einsum("lij,lj->li", Qi, xwz)
    rb, _, _ = _rows(ev, X, Y, D, A, "py", beta, Qi)
    Xr, W, Z, R3 = 3, 3 + c, 3 + c + d, 3 + c + 2 * d
    T1 = [np.array([[_sum(rows, *([t] if t else []), W + l, W + m)
                     for m in range(d)] for l in range(d)]) for t in range(3)]
    tau = [np.array([_sum(rows, *([1] if t else []), W + l)
                     - _sum(rb, *([1] if t else []), W + l, W + l, R3 + l)
                     for l in range(d)]) for t in range(2)]
    N = [np.array([[[[_sum(rows, *([1] if t else []), Xr + i, Xr + j, W + l,
                           W + m) for j in range(c)] for i in range(c)]
                    for m in range(d)] for l in range(d)]) for t in range(2)]
    Gs = [np.array([[_sum(rb, *([1] if t else []), Z + l, Z + m)
                     for m in range(d)] for l in range(d)]) for t in range(2)]
    K = [np.array([[[_sum(rb, *([t] if t else []), W + l, Z + m, Z + q)
                     for q in range(d)] for m in range(d)] for l in range(d)])
         for t in range(3)]
    F = [np.array([[[_sum(rb, *([1] if t else []), Xr + i, W + l, Z + m)
                     for i in range(c)] for m in range(d)] for l in range(d)])
         for t in range(2)]
    Mtr = [np.array([[_sum(rb, *([t] if t else []), W + l, W + l, R3 + l,
                           W + m) for m in range(d)] for l in range(d)])
           for t in range(3)]
    nv = d * (d + 1) // 2
    pairs = [(i, j) for i in range(d) for j in range(i, d)]
    St = []
    for i, j in pairs:
        S = np.outer(A[:, i], A[:, j])
        St.append(S if i == j else S + S.T)
    p2 = 2 * nv
    ta = [1] * nv + [0] * nv
    grad = np.array([-0.5 * np.sum(np.diag(St[a % nv]) * tau[ta[a]])
                     + 0.5 * np.sum(St[a % nv] * Gs[ta[a]])
                     for a in range(p2)])
    Tt = {}
    for u in range(2):
        for v in range(2):
            T = T1[u + v] - Mtr[u + v] - Mtr[u + v].T
            for l in range(d):
                for m in range(d):
                    T[l, m] += np.trace(Qi[l] @ N[u][l, m] @ Qi[m]
                                        @ N[v][l, m])
            Tt[u, v] = T
    fv = [np.einsum("lm,lmi->li", St[a % nv], F[ta[a]]) for a in range(p2)]
    H = np.zeros((p2, p2))
    for a in range(p2):
        for b in range(p2):
            Sa, Sb = St[a % nv], St[b % nv]
            tr = np.sum(Sa * Sb.T * Tt[ta[a], ta[b]])
            qd = np.einsum("lm,lq,lmq->", Sa, Sb, K[ta[a] + ta[b]]) \
                - np.einsum("li,lij,lj->", fv[a], Qi, fv[b])
            H[a, b] = 0.5 * tr - qd
    _, g_ref, h_ref = mvc.nr_derivatives(True, _t(ev), _t(X)[None], _t(Y),
                                         _t(Vg)[None], _t(Ve)[None])
    for got, ref in ((grad, g_ref[0]), (H, h_ref[0])):
        ref = np.asarray(ref)
        assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
