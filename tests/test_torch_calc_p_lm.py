"""K10 (mph_calc_p, csrc/mph_calc_p.cu) and K8 (lm_tail, csrc/lm_tail.cu)
on the CPU:

  * numpy emulations of the kernels' forms, each sum in the kernel's
    order, against the plain versions at 1e-10 relative (both sum the
    same float64 products in another order; the emulation leaves out the
    kernels' fused multiply-adds):
      - K10's warp form: thread t of a lane's warp adds the individuals
        k ≡ t (mod 32) in increasing k, then the butterfly of shuffles;
        the shared-(Vg, Ve) form takes the covariate-only sums from one
        block computation and equals the per-lane form bit for bit;
      - K10's team form: the pass's four partials by k mod 4 added as
        ((q0 + q1) + (q2 + q3)) (csrc/mvlmm_lane.cuh), and the tail;
      - K8's warp form: 16-byte groups (four float32 or two float64
        elements) j ≡ t (mod 32) where the rows are aligned, single
        elements otherwise, then the butterfly;
      - K8's tile form: k-steps of four individuals, a warp's steps
        going to 1, 2 or 4 accumulators in turn by the column tiles'
        count and added in order; Σ r² on 4 threads a row; the
        projections' t_a a lane, q and b by the butterfly;
    and the split equality of each emulated schedule: lanes or rows
    taken in launches of three (or from another tile) give the same
    numbers bit for bit;
  * K8's plain version against gemma_tpu's lm_block and lm_gene_block at
    the forms' edges (c = 1, 3, 4, 16, 17, 24, 32, 33, 40), float64, at
    the tolerances of tests/test_torch_lm.py (p abs 1e-8, beta and se
    rel 1e-9);
  * K10's plain version against gemma_tpu's mph_calc_p at d = 1, 2, 5, 9
    and 12 design rows, per-lane and shared (Vg, Ve), with and without
    the LRT tail, float64: stat, beta, Vbeta and p rel 1e-10 (as
    tests/test_torch_mvlmm.py).

The kernels themselves run on the card only: chip_smoke.py holds every
form against its plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.models import lm as tlm
from gemma_tpu.models import mvlmm as rmv
from gemma_tpu.models import mvlmm_core as ref
from gemma_torch.models import lm
from gemma_torch.models import mvlmm_core as core

N_MV, S_MV = 137, 7
N_LM, S_LM = 150, 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers torch's default
    pool oversubscribes the cores (tests/test_torch_mvlmm.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _butterfly(parts):
    """A warp's xor butterfly (gt_warp_sum) over the last axis of 32
    partials (16: the offsets 8 .. 1 within half a warp): every lane ends
    with the same value, lane 0's returned."""
    v = np.array(parts, np.float64)
    idx = np.arange(v.shape[-1])
    o = v.shape[-1] // 2
    while o:
        v = v + v[..., idx ^ o]
        o //= 2
    return v[..., 0]


def _lanes_fold(p, width):
    """Σ_k p[..., k] with thread t taking k ≡ t (mod width) in increasing
    k: the (..., width) partials."""
    n = p.shape[-1]
    pad = -n % width
    q = np.concatenate([p, np.zeros(p.shape[:-1] + (pad,))], -1)
    q = q.reshape(p.shape[:-1] + (-1, width))
    acc = np.zeros(p.shape[:-1] + (width,))
    for m in range(q.shape[-2]):
        acc = acc + q[..., m, :]
    return acc


def _fold4(p):
    """The team pass's order: four partials by k mod 4, each in increasing
    k, added as ((q0 + q1) + (q2 + q3))."""
    q = _lanes_fold(p, 4)
    return (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])


# ---------------------------------------------------------------------------
# K10

def _mv_problem(d, c0, r, seed):
    rng = np.random.default_rng(seed)
    n = N_MV
    ev = np.where(rng.uniform(size=n) < 0.1, 0.0, rng.uniform(0, 3, n))
    X0 = np.vstack([np.ones(n), rng.normal(size=(c0 - 1, n))])
    Y = rng.normal(size=(d, n))
    R = rng.binomial(2, 0.3, size=(S_MV, r, n)).astype(float)
    A, B = rng.normal(size=(2, d, d))
    Vg = A @ A.T / d + 0.5 * np.eye(d)
    Ve = B @ B.T / d + 0.5 * np.eye(d)
    sc = rng.uniform(0.5, 2.0, size=(S_MV, 1, 1))
    return dict(ev=ev, X0=X0, Y=Y, R=R, Vg=Vg, Ve=Ve, Vgs=Vg[None] * sc,
                Ves=Ve[None] * sc[::-1])


def k10_form(d, c):
    """csrc/mph_calc_p.cu k10w_inst: the warp form's (MD, MC) or None."""
    for md, mc in ((2, 2), (2, 4), (4, 3), (8, 2)):
        if d <= md and c <= mc:
            return md, mc
    return None


def _k10_sums(X, w, z, fold, part=0, c0=0):
    """A lane's sums as the forms take them: per l the Gram's upper
    triangle (i <= j, row-major) and xWz; `part` 1 keeps those touching
    the lane's own rows, 2 the covariate-only ones (the others left out)."""
    c = X.shape[0]
    out = {}
    for l in range(w.shape[0]):
        for i in range(c):
            for j in range(i, c):
                cov = j < c0
                if part == 0 or (part == 1) != cov:
                    out[l, i, j] = fold((X[i] * X[j]) * w[l])
        for i in range(c):
            cov = i < c0
            if part == 0 or (part == 1) != cov:
                out[l, i, "z"] = fold((X[i] * w[l]) * z[l])
    return out


def _k10_tail(sums, d, c, Uh):
    """The tail as the kernels take it: per l the eliminations, then
    beta, Vbeta and the statistic."""
    cw = c - 1
    xPx, xPy = np.zeros(d), np.zeros(d)

    def q(l, i, j):
        return sums[l, min(i, j), max(i, j)]
    for l in range(d):
        Q = np.array([[q(l, i, j) for j in range(cw)] for i in range(cw)])
        whx = np.array([q(l, i, cw) for i in range(cw)])
        Qi = np.linalg.inv(Q) if cw else Q
        px, py = q(l, cw, cw), sums[l, cw, "z"]
        for i in range(cw):
            qw = sum(Qi[i, j] * whx[j] for j in range(cw))
            px -= whx[i] * qw
            py -= qw * sums[l, i, "z"]
        xPx[l], xPy[l] = px, py
    bhat = xPy / xPx
    stat = 0.0
    for l in range(d):
        stat += bhat[l] * xPy[l]
    beta = Uh.T @ bhat
    Vbeta = Uh.T @ np.diag(1.0 / xPx) @ Uh
    return stat, beta, Vbeta


def _k10_emulate(p, lanes, shared, form):
    """K10 on `lanes` in the given form ("warp" or "team"), numpy; shared
    (Vg, Ve) with the covariate-only sums made once (warp form)."""
    d, c0 = p["Y"].shape[0], p["X0"].shape[0]
    fold = ((lambda v: float(_butterfly(_lanes_fold(v, 32))))
            if form == "warp" else (lambda v: float(_fold4(v))))
    out = []
    blk = None
    for s in lanes:
        Vg, Ve = ((p["Vg"], p["Ve"]) if shared
                  else (p["Vgs"][s], p["Ves"][s]))
        D, Uh, A, _ = (t.numpy() for t in core.eigen_proc(_t(Vg)[None],
                                                          _t(Ve)[None]))
        D, Uh, A = D[0], Uh[0], A[0]
        w = 1.0 / (D[:, None] * p["ev"] + 1.0)
        z = A @ p["Y"]
        X = np.vstack([p["X0"], p["R"][s]])
        c = X.shape[0]
        if shared and form == "warp":
            if blk is None:
                blk = _k10_sums(X, w, z, fold, 2, c0)
            sums = {**blk, **_k10_sums(X, w, z, fold, 1, c0)}
        else:
            sums = _k10_sums(X, w, z, fold)
        out.append(_k10_tail(sums, d, c, Uh))
    return out


@pytest.mark.parametrize("d,c0,r", [(2, 1, 1), (2, 2, 2), (4, 2, 1),
                                    (5, 1, 1), (8, 1, 1), (2, 4, 1),
                                    (9, 1, 1), (3, 10, 2)],
                         ids=["protocol", "gxe", "d4c3", "d5", "d8c2",
                              "d2c5", "d9", "d3c12"])
@pytest.mark.parametrize("shared", [False, True], ids=["lanes", "shared"])
def test_k10_form_emulation(d, c0, r, shared):
    """Each form's order of summation and tail against mph_calc_p_plain;
    the shared form's block sums equal the per-lane ones bit for bit;
    lanes in launches of three equal the whole launch bit for bit."""
    p = _mv_problem(d, c0, r, 10 * d + c0)
    form = "warp" if k10_form(d, c0 + r) else "team"
    em = _k10_emulate(p, range(S_MV), shared, form)
    V, E = ((_t(p["Vg"])[None], _t(p["Ve"])[None]) if shared
            else (_t(p["Vgs"]), _t(p["Ves"])))
    cp = core.mph_calc_p_plain(_t(p["ev"]), _t(p["X0"]), _t(p["Y"]),
                               _t(p["R"]), V, E)
    assert _rel([e[0] for e in em], cp.stat) <= 1e-10
    assert _rel(np.stack([e[1] for e in em]), cp.beta) <= 1e-10
    assert _rel(np.stack([e[2] for e in em]), cp.Vbeta) <= 1e-10
    split = [e for a in range(0, S_MV, 3)
             for e in _k10_emulate(p, range(a, min(a + 3, S_MV)), shared,
                                   form)]
    for a, b in zip(split, em):
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) \
            and np.array_equal(a[2], b[2])
    if shared and form == "warp":
        each = _k10_emulate(dict(p, Vgs=np.broadcast_to(p["Vg"], p["Vgs"].shape),
                                 Ves=np.broadcast_to(p["Ve"], p["Ves"].shape)),
                            range(S_MV), False, form)
        for a, b in zip(each, em):
            assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_k10_forms_cover_the_shapes():
    """The warp form takes the protocol, GxE and five-trait shapes; its
    three instantiations nest, and the team form takes everything past
    them (d·c small only)."""
    assert k10_form(2, 2) == (2, 2) and k10_form(2, 4) == (2, 4)
    assert k10_form(5, 2) == (8, 2) and k10_form(4, 3) == (4, 3)
    for d, c in ((2, 5), (3, 4), (5, 3), (9, 2), (10, 13), (2, 14)):
        assert k10_form(d, c) is None
    for d in range(1, 12):
        for c in range(1, 16):
            f = k10_form(d, c)
            assert f is None or (d <= f[0] and c <= f[1]
                                 and d * (c * (c + 1) // 2 + c) <= 40)


def k10_pair(r, i, m):
    """csrc/mph_calc_p.cu k10_pair: pair i of round r (circle method)."""
    def at(k):
        return 0 if k == 0 else (r + k - 1) % (m - 1) + 1
    return tuple(sorted((at(i), at(m - 1 - i))))


def _k10_jacobi(M):
    """k10w_jacobi in numpy: parallel-order sweeps until the off-diagonal
    squares fall to 1e-30 of the diagonal's or, below 1e-20 of it, stop
    halving; eigenvalues ascending, each eigenvector's largest entry
    positive."""
    M = np.array(M, np.float64)
    d = M.shape[0]
    m = d + d % 2
    V = np.eye(d)
    last = np.inf
    for _ in range(50):
        off = np.sum(np.triu(M, 1) ** 2)
        dg = np.sum(np.diag(M) ** 2)
        if not off > 1e-30 * dg or (off <= 1e-20 * dg
                                    and not off < 0.5 * last):
            break
        last = off
        for r in range(m - 1):
            rot = []
            for i in range(m // 2):
                p, q = k10_pair(r, i, m)
                if q < d and M[p, q] != 0.0:
                    th = (M[q, q] - M[p, p]) / (2.0 * M[p, q])
                    t = np.copysign(1.0, th) / (abs(th) + np.sqrt(th * th + 1))
                    c = 1.0 / np.sqrt(t * t + 1.0)
                    rot.append((p, q, c, t * c))
            for p, q, c, s_ in rot:          # columns of M and V
                for A in (M, V):
                    ap, aq = A[:, p].copy(), A[:, q].copy()
                    A[:, p], A[:, q] = c * ap - s_ * aq, s_ * ap + c * aq
            for p, q, c, s_ in rot:          # then rows of M
                ap, aq = M[p].copy(), M[q].copy()
                M[p], M[q] = c * ap - s_ * aq, s_ * ap + c * aq
    o = np.argsort(np.diag(M), kind="stable")
    V = V[:, o]
    big = np.abs(V).argmax(0)
    return np.diag(M)[o], V * np.sign(V[big, np.arange(d)])


@pytest.mark.parametrize("d", [3, 5, 8, 10, 13])
def test_k10_parallel_jacobi(d):
    """The warp eigh's schedule: the m/2 pairs of a round are disjoint and
    every pair meets once in the m - 1 rounds of a sweep; its numpy
    emulation against numpy's eigh, eigenvalues rel 1e-13, eigenvectors
    (signed as the kernel signs them) abs 1e-12."""
    m = d + d % 2
    seen = []
    for r in range(m - 1):
        pairs = [k10_pair(r, i, m) for i in range(m // 2)]
        assert len({x for p in pairs for x in p}) == m
        seen += pairs
    assert sorted(seen) == [(p, q) for p in range(m) for q in range(p + 1, m)]
    A = np.random.default_rng(d).normal(size=(d, d))
    M = A @ A.T + 0.1 * np.eye(d)
    w, V = _k10_jacobi(M)
    wr, Vr = np.linalg.eigh(M)
    Vr = Vr * np.sign(Vr[np.abs(Vr).argmax(0), np.arange(d)])
    assert _rel(w, wr) <= 1e-13
    assert np.max(np.abs(V - Vr)) <= 1e-12


@pytest.mark.parametrize("d,c0,r", [(1, 1, 1), (2, 1, 1), (2, 2, 2),
                                    (5, 1, 1), (9, 1, 1), (2, 11, 1),
                                    (9, 11, 1)],
                         ids=["d1", "d2", "gxe", "d5", "d9", "d2c12",
                              "d9c12"])
def test_k10_plain_matches_reference(d, c0, r):
    """mph_calc_p_plain against the reference's mph_calc_p (the lane's
    rows but the last joined to its covariates), per-lane and shared
    (Vg, Ve), and the LRT tail against the reference's chisq_sf."""
    p = _mv_problem(d, c0, r, 100 + 10 * d + c0)
    W = np.concatenate([np.broadcast_to(p["X0"], (S_MV,) + p["X0"].shape),
                        p["R"][:, :-1]], 1)
    x = p["R"][:, -1]
    rng = np.random.default_rng(d)
    l1 = rng.normal(size=S_MV) - 500.0
    l0 = l1 - rng.exponential(2.0, size=S_MV)
    for shared in (False, True):
        V = np.broadcast_to(p["Vg"], (S_MV, d, d)) if shared else p["Vgs"]
        E = np.broadcast_to(p["Ve"], (S_MV, d, d)) if shared else p["Ves"]
        st, be, Vb = ref.mph_calc_p(jnp.asarray(p["ev"]), jnp.asarray(x),
                                    jnp.asarray(W), jnp.asarray(p["Y"]),
                                    jnp.asarray(V), jnp.asarray(E))
        Vp, Ep = ((_t(p["Vg"])[None], _t(p["Ve"])[None]) if shared
                  else (_t(V), _t(E)))
        for lrt in (None, (_t(l1), _t(l0))):
            cp = core.mph_calc_p_plain(_t(p["ev"]), _t(p["X0"]), _t(p["Y"]),
                                       _t(p["R"]), Vp, Ep,
                                       *(lrt or (None, None)))
            assert _rel(st, cp.stat) <= 1e-10
            assert _rel(be, cp.beta) <= 1e-10
            assert _rel(Vb, cp.Vbeta) <= 1e-10
            np.testing.assert_allclose(
                cp.p.numpy(), np.asarray(rmv.chisq_sf(st, float(d))),
                rtol=1e-10, atol=1e-14)
            if lrt is None:
                assert cp.p_lrt is None
            else:
                np.testing.assert_allclose(
                    cp.p_lrt.numpy(), np.asarray(rmv.chisq_sf(
                        jnp.asarray(2.0 * (l1 - l0)), float(d))),
                    rtol=1e-10, atol=1e-14)


# ---------------------------------------------------------------------------
# K8

LM_NARROW, LM_TR = 3, 32


def lm_nct(c):
    """csrc/lm_tail.cu lm_tile: the 8-wide column tiles of a pass (all
    of [W, v]'s up to 64 columns) and the accumulators a tile (U)."""
    c1p = (c + 1 + 7) // 8 * 8
    nct = 1 if c1p <= 8 else 2 if c1p <= 16 else 4 if c1p <= 32 else 8
    return nct, {1: 4, 2: 2, 4: 2}.get(nct, 1)


def lm_kc(c, isz):
    """csrc/lm_tail.cu lm_tile: a chunk's individuals, the most of 128,
    64, 32, 16 whose three stages fit 56 KB (else 200 KB)."""
    def r16(b):
        return (b + 15) // 16 * 16
    nct, _ = lm_nct(c)
    c1p = (c + 1 + 7) // 8 * 8
    wc = c if c1p <= 8 * nct else 8 * nct
    for budget in (56 << 10, 200 << 10):
        for kc in (128, 64, 32, 16):
            buf = (r16(LM_TR * (kc + 4) * isz) + r16(kc * wc * isz)
                   + r16(kc * isz))
            if 3 * buf <= budget:
                return kc
    return 16


def _lm_problem(c, n=N_LM, seed=0):
    rng = np.random.default_rng(seed + c)
    y = rng.normal(size=n) + 3.0
    X = rng.binomial(2, 0.3, size=(S_LM, n)).astype(np.float64)
    X[:3] += (y > np.median(y)) * 0.5
    W = np.column_stack([np.ones(n), rng.normal(size=(n, c - 1))])
    return W, y, X


def _lm_sums_warp(X, v, W, E):
    """The warp form's sums (r'r, r'v, r'W): thread t the 16-byte groups j
    ≡ t (mod 32), E elements each in order (E = 1: single elements)."""
    S, n = X.shape
    cols = np.concatenate([X[:, None, :] * X[:, None, :],
                           (X * v)[:, None, :],
                           X[:, None, :] * W.T[None]], 1)   # (S, c+2, n)
    g = cols.reshape(S, cols.shape[1], n // E, E)
    acc = np.zeros((S, cols.shape[1], 32))
    for m in range(0, n // E, 32):
        for e in range(E):
            blk = g[:, :, m:m + 32, e]
            acc[:, :, :blk.shape[-1]] = acc[:, :, :blk.shape[-1]] + blk
    return _butterfly(acc)


def _lm_sums_tile(X, v, W):
    """The tile form's r'[W, v] and r'r (float64 operands): chunks of kc
    individuals (lm_kc), k-steps of four (the DMMA's four products added
    in k order), step m into accumulator m mod U (lm_nct; added as
    ((0 + 1) + (2 + 3))); Σ r² on 4 threads a row (thread t the elements
    k ≡ t mod 4), then their butterfly."""
    S, n = X.shape
    c = W.shape[1]
    _, U = lm_nct(c)
    B = np.concatenate([W, v[:, None]], 1)              # (n, c + 1)
    part = np.zeros((U, S, c + 1))
    for m, k in enumerate(range(0, n, 4)):
        step = np.zeros((S, c + 1))
        for kk in range(k, min(k + 4, n)):
            step = step + X[:, kk, None] * B[None, kk]
        part[m % U] = part[m % U] + step
    rw = (part[0] + part[1]) + (part[2] + part[3]) if U == 4 else \
        part[0] + part[1] if U == 2 else part[0]
    return _butterfly(_lanes_fold(X * X, 4)), rw

def _lm_project(rw, rr, rv, consts):
    """t_a = Σ_k WtWi[a, k] rw_k on lane a mod 32; q and b by the
    butterfly."""
    WtWi, Wv = consts.WtWi.numpy(), consts.WtWi_Wtv.numpy()
    S, c = rw.shape
    qa, ba = np.zeros((S, 32)), np.zeros((S, 32))
    for a in range(c):
        t = np.zeros(S)
        for k in range(c):
            t = t + WtWi[a, k] * rw[:, k]
        qa[:, a % 32] = qa[:, a % 32] + rw[:, a] * t
        ba[:, a % 32] = ba[:, a % 32] + rw[:, a] * Wv[a]
    return rr - _butterfly(qa), rv - _butterfly(ba)


def _lm_emulate(X, v, W, gene, vec_e):
    """K8's form for these rows: (rPwr, rPwv) then the tests (the plain
    version's own formulas, lm._lm_stats)."""
    n, c = W.shape
    consts = lm.lm_consts(_t(W), _t(v))
    if c <= LM_NARROW:
        E = vec_e if n % vec_e == 0 else 1
        s = _lm_sums_warp(X, v, W, E)
        WtWi, Wv = consts.WtWi.numpy(), consts.WtWi_Wtv.numpy()
        rw = s[:, 2:]
        q = np.zeros(len(X))
        b = np.zeros(len(X))
        for a in range(c):
            t = np.zeros(len(X))
            for k in range(c):
                t = t + WtWi[a, k] * rw[:, k]
            q = q + rw[:, a] * t
            b = b + rw[:, a] * Wv[a]
        rPwr, rPwv = s[:, 0] - q, s[:, 1] - b
    else:
        rr, rwv = _lm_sums_tile(X, v, W)
        rPwr, rPwv = _lm_project(rwv[:, :c], rr, rwv[:, c], consts)
    vPwv = consts.vPwv[0]
    xPwx, yPwy = (vPwv, _t(rPwr)) if gene else (_t(rPwr), vPwv)
    return lm._lm_stats(xPwx, _t(rPwv), yPwy, n, float(n - c - 1), False)


@pytest.mark.parametrize("c", [1, 3, 4, 9, 17, 40])
@pytest.mark.parametrize("n", [N_LM, N_LM + 1])
@pytest.mark.parametrize("gene", [False, True], ids=["snp", "gene"])
def test_k8_form_emulation(c, n, gene):
    """Each form's order of summation against lm_tail_plain; the rows from
    the fifth on alone (other tiles, other warps) equal the whole call's
    bit for bit."""
    W, y, X = _lm_problem(c, n)
    em = _lm_emulate(X, y, W, gene, 4)
    want = lm.lm_tail_plain(_t(X), _t(y), _t(W), lm.lm_consts(_t(W), _t(y)),
                            gene, False)
    for a, b in zip(em, want):
        ok = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), ok)
        assert _rel(a[ok].numpy(), b[ok].numpy()) <= 1e-10
    part = _lm_emulate(X[5:], y, W, gene, 4)
    for a, b in zip(part, em):
        assert torch.equal(a, b[5:])


def test_k8_tile_layout():
    """The tile form's pass takes every column of [W, v] up to 64 (more
    in passes of 64), a chunk whole k-steps of every accumulator, and a
    row's chunks its four Σ r² threads' elements (both operand types)."""
    for c in range(LM_NARROW + 1, 300):
        nct, U = lm_nct(c)
        c1p = (c + 1 + 7) // 8 * 8
        assert 8 * nct >= min(c1p, 64) and U * nct <= 8
        for isz in (4, 8):
            kc = lm_kc(c, isz)
            assert kc % (4 * U) == 0 and kc % 16 == 0


@pytest.mark.parametrize("c", [1, 3, 4, 16, 17, 24, 32, 33, 40])
def test_k8_plain_matches_reference(c):
    """lm_tail_plain (through lm_block / lm_gene_block) against the
    reference's, float64, at each edge of K8's forms."""
    from test_torch_lm import _compare_f64
    W, y, X = _lm_problem(c)
    for mode in (51, 53):
        _compare_f64(tlm.lm_block(jnp.asarray(W), jnp.asarray(y),
                                  jnp.asarray(X), mode=mode),
                     lm.lm_block(_t(W), _t(y), _t(X), mode=mode))
    if c in (1, 4, 17, 40):
        E = X + np.random.default_rng(c).normal(size=X.shape)
        _compare_f64(tlm.lm_gene_block(jnp.asarray(W), jnp.asarray(y),
                                       jnp.asarray(E), mode=51),
                     lm.lm_gene_block(_t(W), _t(y), _t(E), mode=51))
