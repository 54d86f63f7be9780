"""Shapes past the bounds the port's kernels once had: more than 8 traits
or 10 design rows in the mvLMM (K9-K11, K14), s_max above 1,024 in BSLMM
(K12) and more than 32 covariates in K2-K8.  The kernels now take any
shape the reference takes; here their plain versions, through the port's
CPU path, are held on the same numpy inputs.

Tolerances:
  * mvLMM -lmm 4 at d = 9 (c = 2) and d = 3 (c = 13): the reference's
    per-SNP driver on the port's null (its null fit at d = 9 would cost
    a compile of its own), at the reference's -emp and -nrp.  d = 3:
    p abs 1e-6, beta and Vbeta rel 1e-5, as tests/test_torch_mvlmm.py.
    At d = 9 on 120 individuals both packages' EMs wander from the
    null's start (the log-likelihood falls and rises by thousands; 90
    variance parameters on 120 individuals), each its own way, so d = 9
    runs on 400 individuals with the Newton refinement on every lane
    (-pnr 1), and its p are held as tests/test_torch_mvlmm.py holds the
    ML fit after Newton at d >= 3: abs 1e-3, p_score (the null's alone)
    abs 1e-6.  The two Newton runs stop on a flat likelihood (90
    parameters, -nrp 1e-4 on the log-likelihood): p_wald 5.9e-5, p_lrt
    3.1e-4 and p_score 6.5e-7 apart at most (ROADMAP §C20).  beta and
    Vbeta are held at d = 3 only;
  * calc_crt at c = 13: rel 1e-9, as tests/test_torch_crt.py;
  * BSLMM calc_posterior at n_gamma = 1,100 with the reference's draws:
    rel 1e-10, as tests/test_torch_bslmm.py;
  * -lmm 4 and -lm 4 at 40 covariates: the reference's trace and
    compile at 40 covariates would take minutes, so both are held
    against generalised (and ordinary) least squares written here in
    numpy from the definitions, read back from the .assoc.txt files the
    CLI writes (six or seven digits): beta and p_wald at the port's REML
    λ (-lm 4: every column) rel 1e-5, the printed precision with the
    printed λ's; p_lrt from the ML log-likelihoods at the port's λ and
    at the null's, and p_score at the null's ML λ, abs 1e-6 besides,
    since the null's λ comes from a maximiser of the test's own and the
    χ²(1) tail is steep near 0; each λ against such a maximiser (a
    2,001-point grid over [1e-5, 1e5] and a bounded search): rel 1e-4
    or, on a flat likelihood, the log-likelihood within 1e-9;
  * the lane split: every lane once, in order, and the split results
    equal to one call bit for bit;
  * the speed mode's operands: float32 up to 8 traits, float64 beyond.
"""

import functools
import gzip
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import scipy.stats
import torch

from gemma_torch import kernels
from gemma_torch.cli import parse_args
from gemma_torch.models import bslmm as pb
from gemma_torch.models import mvlmm as pmv
from gemma_torch.models import mvlmm_core as core
from gemma_torch.run import batch_run
from gemma_tpu.models import bslmm as rb
from gemma_tpu.models import mvlmm as rmv
from gemma_tpu.models import mvlmm_core as ref
from gemma_tpu.ops.eigh import eigh_zeroed

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions loop over small tensors (see
    tests/test_torch_mvlmm.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dt=F64):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)), dtype=dt)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# the lane split

@pytest.mark.parametrize("S,lane_bytes,budget", [
    (10, 100, 350), (1, 10 ** 9, 1), (7, 3, 10 ** 6), (0, 5, 5),
    (10775, 2_750_000, 20 * 2 ** 30)])
def test_lane_ranges_cover_each_lane_once(S, lane_bytes, budget):
    ranges = kernels.lane_ranges(S, lane_bytes, budget)
    assert [i for a, b in ranges for i in range(a, b)] == list(range(S))
    per = max(1, budget // lane_bytes)
    assert all(0 < b - a <= per for a, b in ranges)


def test_split_calls_equal_one_call():
    """K10's plain version over a budget of one and a half lanes (a call
    a lane) equals one call over the whole block."""
    ev, X0, Y, R, Vg, Ve = _mv_problem(3, 4)
    args = (_t(ev), _t(X0), _t(Y))
    whole = core.mph_calc_p(*args, _t(R), _t(Vg)[None], _t(Ve)[None])
    S = R.shape[0]
    parts = {f: torch.full_like(getattr(whole, f), float("nan"))
             for f in ("stat", "p", "beta", "Vbeta")}
    seen = []

    def call(a, b):
        seen.extend(range(a, b))
        got = core.mph_calc_p(*args, _t(R[a:b]), _t(Vg)[None], _t(Ve)[None])
        for f in parts:
            parts[f][a:b] = getattr(got, f)

    calls = kernels.run_lanes(S, 1000, 1500, call)
    assert calls == S and seen == list(range(S))
    for f, t in parts.items():
        assert torch.equal(t, getattr(whole, f)), f


# ---------------------------------------------------------------------------
# the mvLMM past 8 traits and 10 design rows

N_MV, S_MV = 120, 48


@functools.lru_cache(maxsize=None)
def _mv_problem(d, c, n=N_MV, s=S_MV, seed=0):
    """Rotated operands of a heritable d-trait set with an intercept and
    c - 2 normal covariates (c design rows with the SNP): eval (n,), X0
    (c - 1, n), Y (d, n), the SNP rows (s, 1, n), and a Vg, Ve."""
    rng = np.random.default_rng(seed + 10 * d + c)
    G = rng.binomial(2, 0.3, size=(300, n)).astype(float)
    G -= G.mean(1, keepdims=True)
    K = G.T @ G / 300
    K = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    ev, U = np.linalg.eigh(K)
    ev = np.where(ev < 1e-10, 0.0, ev)
    L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
    A = rng.normal(size=(d, d))
    Vg = A @ A.T / d + 0.5 * np.eye(d)
    A = rng.normal(size=(d, d))
    Ve = A @ A.T / d + 0.5 * np.eye(d)
    Yr = ((L @ rng.normal(size=(n, d))) @ np.linalg.cholesky(Vg).T
          + rng.normal(size=(n, d)) @ np.linalg.cholesky(Ve).T)
    W = np.column_stack([np.ones(n), rng.normal(size=(n, c - 2))])
    x = rng.binomial(2, 0.3, size=(s, n)).astype(float)
    x[:4] += 0.4 * Yr[:, 0]
    return (ev, (U.T @ W).T, (U.T @ Yr).T, (x @ U)[:, None, :], Vg, Ve)


def _cfg(**kw):
    base = dict(l_min=1e-5, l_max=1e5, n_region=10, em_iter=10000,
                nr_iter=100, em_prec=1e-4, nr_prec=1e-4, p_nr=0.5, crt=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("d,c,n,s", [(9, 2, 400, 8), (3, 13, N_MV, 16)],
                         ids=["d9c2", "d3c13"])
def test_mvlmm_lmm4_past_the_old_bounds(d, c, n, s):
    """-lmm 4 with -pnr 0.5 (d = 3) or 1 (d = 9: Newton refinement on
    every lane) through both packages' per-SNP drivers from the port's
    null, on s SNPs."""
    ev, X0, Y, R, _, _ = _mv_problem(d, c, n=n, s=s)
    cfg = _cfg(p_nr=1.0) if d > 3 else _cfg()
    qn = pmv.MvlmmNull(_t(ev), _t(X0), _t(Y), cfg)
    rn = types.SimpleNamespace(
        **{f: jnp.asarray(getattr(qn, f).numpy()) for f in (
            "Vg_start", "Ve_start", "B_start")},
        logl_mle_H0=float(qn.logl_mle_H0))
    Utx = R[:, 0]
    r = rmv.mvlmm_assoc(jnp.asarray(ev), jnp.asarray(X0), jnp.asarray(Y),
                        jnp.asarray(Utx), rn, 4, cfg, jnp.float64)
    q = pmv.mvlmm_assoc(_t(ev), _t(X0), _t(Y), _t(Utx), qn, 4, cfg, F64)
    for k in ("p_wald", "p_lrt", "p_score"):
        err = np.abs(np.asarray(r[k]) - q[k])
        tol = 1e-3 if d > 3 and k != "p_score" else 1e-6
        assert err.max() <= tol, k
    for k in ("beta", "Vbeta") if d <= 3 else ():
        a = np.asarray(r[k])
        assert np.max(np.abs(a - q[k]) / np.maximum(np.abs(a), 1e-3)) \
            <= 1e-5, k


@pytest.mark.parametrize("d,want", [(8, torch.float32), (9, torch.float64)])
def test_speed_mode_reads_float64_operands_beyond_8_traits(cvt40, d, want,
                                                           monkeypatch):
    """-precision float32 runs the mvLMM from float32 operands up to 8
    traits and from float64 beyond (ROADMAP §C20): the dtype its
    eigendecomposition is asked for."""
    from gemma_torch import run as prun
    td = cvt40[0]
    rng = np.random.default_rng(d)
    np.savetxt(f"{td}/pheno{d}.txt", rng.normal(size=(N_IND, d)),
               fmt="%.6f", delimiter="\t")
    seen = []

    class Stop(Exception):
        pass

    def eigen(cfg, ds, log, dtype, device):
        seen.append(dtype)
        raise Stop

    monkeypatch.setattr(prun, "_load_or_compute_eigen", eigen)
    argv = (f"-g {td}/geno.txt.gz -p {td}/pheno{d}.txt -k {td}/K.txt "
            f"-lmm 4 -precision float32 -outdir {td} -n").split() + [
                str(i) for i in range(1, d + 1)]
    with pytest.raises(Stop):
        prun.run_mvlmm(parse_args(argv), device="cpu")
    assert seen == [want]


def _crt_lanes(d, c, n, seed, S=3):
    """Random lanes as tests/test_torch_crt.py makes them."""
    rng = np.random.default_rng(seed)
    ev = np.abs(rng.gamma(2.0, 1.0, n))
    ev[0] = 0.0
    X0 = np.vstack([np.ones((1, n)), rng.normal(size=(c - 2, n))])
    R = rng.normal(size=(S, 1, n))
    Vg, Ve, H = [], [], []
    for _ in range(S):
        for out in (Vg, Ve):
            A = rng.normal(size=(d, d))
            out.append(A @ A.T / d + 0.3 * np.eye(d))
        Hr = rng.normal(size=(d * (d + 1),) * 2)
        H.append(-(Hr @ Hr.T + 0.5 * np.eye(d * (d + 1))))
    return ev, X0, R, np.array(Vg), np.array(Ve), np.array(H)


def test_calc_crt_at_13_design_rows():
    ev, X0, R, Vg, Ve, H = _crt_lanes(2, 13, 40, 7)
    S, n = R.shape[0], R.shape[2]
    X = np.concatenate([np.broadcast_to(X0, (S,) + X0.shape), R], axis=1)
    want = ref.calc_crt(jnp.asarray(ev), jnp.asarray(X), jnp.zeros((2, n)),
                        jnp.asarray(Vg), jnp.asarray(Ve), jnp.asarray(H))
    got = core.calc_crt(_t(ev), _t(X0), _t(R), _t(Vg), _t(Ve), _t(H))
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) <= 1e-9


# ---------------------------------------------------------------------------
# BSLMM past s_max 1,024

def test_calc_posterior_at_1100_active_snps():
    """calc_posterior with 1,100 active ranks (s_max 1,200), fed the
    reference's own draws (its key split as at gemma_tpu/models/
    bslmm.py:148)."""
    n, p, ng, s_max = 120, 1300, 1100, 1200
    rng = np.random.default_rng(11)
    X = rng.binomial(2, 0.3, size=(p, n)).astype(float)
    X -= X.mean(1, keepdims=True)
    y = X[:5].sum(0) * 0.1 + rng.normal(size=n)
    y -= y.mean()
    ev, U, tr = eigh_zeroed(jnp.asarray(X.T @ X / p))
    ev, U, tr = np.asarray(ev), np.asarray(U), float(tr)
    UtX, Uty = X @ U, U.T @ y            # (p, n), (n,)
    st_r = rb.BslmmSettings(ns_test=p, ni_test=n, s_max=s_max, w_step=1,
                            s_step=1)
    calc_posterior, _ = rb.make_mcmc_step(
        jnp.asarray(UtX.T), jnp.asarray(Uty), jnp.asarray(ev), tr,
        rb.calc_p_gamma(p, st_r.geo_mean), st_r)
    ranks = (np.arange(s_max) * 7) % p
    h, rho, logp = 0.45, 0.3, float(np.log(ng / p))
    key = jax.random.PRNGKey(5)
    want = calc_posterior(
        key, jnp.asarray(Uty),
        jnp.asarray(np.where(np.arange(s_max) < ng, ranks, p), jnp.int32),
        jnp.int32(ng), jnp.float64(h), jnp.float64(rho), jnp.float64(logp))
    k1, k2, k3, _ = jax.random.split(key, 4)
    draws = (_t(jax.random.normal(k1, (n,), jnp.float64)),
             float(jax.random.gamma(k2, n / 2.0, dtype=jnp.float64)),
             _t(jax.random.normal(k3, (s_max,), jnp.float64)))
    st = pb.BslmmSettings(ns_test=p, ni_test=n, s_max=s_max, w_step=1,
                          s_step=1)
    ops = pb.chain_operands(_t(UtX), _t(Uty), _t(ev), tr, st.geo_mean)
    got = pb.calc_posterior(ops, st, _t(Uty), list(ranks[:ng]), ng, h, rho,
                            logp, draws)
    for name, a, b in zip(pb.Posterior._fields, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert _rel(a, b) <= 1e-10, name


# ---------------------------------------------------------------------------
# K2-K8 past 32 covariates

N_CVT, N_IND, N_SNP = 40, 120, 24


@pytest.fixture(scope="module")
def cvt40(tmp_path_factory):
    """A BIMBAM set (3% missing, a heritable phenotype), an intercept and
    39 seeded normal covariates, the port's -gk 1 kinship and its -lmm 4
    and -lm 4 outputs on the CPU."""
    td = str(tmp_path_factory.mktemp("cvt40"))
    rng = np.random.default_rng(40)
    X = rng.binomial(2, rng.uniform(0.05, 0.5, N_SNP)[:, None],
                     size=(N_SNP, N_IND)).astype(float)
    miss = rng.random(X.shape) < 0.03
    with gzip.open(f"{td}/geno.txt.gz", "wt") as fh:
        for j in range(N_SNP):
            v = np.char.mod("%d", X[j].astype(int)).astype(object)
            v[miss[j]] = "NA"
            fh.write(f"rs{j}, A, T, " + ", ".join(v) + "\n")
    G = rng.binomial(2, 0.3, size=(200, N_IND)).astype(float)
    y = 0.15 * (G - G.mean(1, keepdims=True)).sum(0) + rng.normal(
        size=N_IND) + 0.5 * (X[0] - X[0].mean())
    np.savetxt(f"{td}/pheno.txt", y, fmt="%.6f")
    W = np.column_stack([np.ones(N_IND), rng.normal(size=(N_IND,
                                                          N_CVT - 1))])
    np.savetxt(f"{td}/cov.txt", W, fmt="%.6f")
    # the kinship from other markers, as a -k file
    Gc = G - G.mean(1, keepdims=True)
    np.savetxt(f"{td}/K.txt", Gc.T @ Gc / 200, fmt="%.10f", delimiter="\t")
    common = (f"-g {td}/geno.txt.gz -p {td}/pheno.txt -c {td}/cov.txt "
              f"-outdir {td} -device cpu").split()
    for flags in (f"-k {td}/K.txt -lmm 4 -o lmm4", "-lm 4 -o lm4"):
        argv = common + flags.split()
        batch_run(parse_args(argv), argv=["gemma_torch"] + argv,
                  device="cpu")
    Xi = np.where(miss, np.nan, X)
    Xi = np.where(miss, np.nanmean(Xi, 1, keepdims=True), X)
    return td, Xi, W, y, np.loadtxt(f"{td}/K.txt")


def _assoc(path):
    with open(path) as fh:
        head = fh.readline().split()
        rows = [ln.split() for ln in fh]
    stats = ("beta", "se", "logl_H1", "l_remle", "l_mle", "p_wald",
             "p_lrt", "p_score")
    return {h: np.array([r[i] for r in rows], float)
            for i, h in enumerate(head) if h in stats}


def _gls(lam, ev, Z, y):
    """GEMMA's quantities of the rotated design Z (n, k) at λ: P_Z y'y
    terms by dense GLS."""
    h = lam * ev + 1.0
    A = (Z / h[:, None]).T @ Z
    b = Z.T @ (y / h)
    return h, A, b, y @ (y / h) - b @ np.linalg.solve(A, b)


def _logl(lam, ev, Z, y, reml, UtZ0=None):
    """GEMMA's LogL_f / LogRL_f (lmm.cpp) of the model with design Z."""
    n, k = Z.shape
    h, A, _, p_yy = _gls(lam, ev, Z, y)
    logdet_h = np.log(np.abs(h)).sum()
    if not reml:
        return (0.5 * n * (np.log(n) - np.log(2 * np.pi) - 1.0)
                - 0.5 * logdet_h - 0.5 * n * np.log(p_yy))
    df = n - k
    logdet_hiw = np.linalg.slogdet(A)[1] - np.linalg.slogdet(Z.T @ Z)[1]
    return (0.5 * df * (np.log(df) - np.log(2 * np.pi) - 1.0)
            - 0.5 * logdet_h - 0.5 * logdet_hiw - 0.5 * df * np.log(p_yy))


def _argmax(f):
    """The maximiser of f(λ) over [1e-5, 1e5]: a 2,001-point grid in
    log10 λ and a bounded search beside its best point."""
    grid = np.linspace(-5.0, 5.0, 2001)
    vals = np.array([f(10.0 ** t) for t in grid])
    i = int(np.argmax(vals))
    if 0 < i < len(grid) - 1:
        r = scipy.optimize.minimize_scalar(
            lambda t: -f(10.0 ** t), bounds=(grid[i - 1], grid[i + 1]),
            method="bounded", options={"xatol": 1e-12})
        return 10.0 ** r.x, -r.fun
    return 10.0 ** grid[i], vals[i]


def _close(got, want, abs_tol=0.0):
    """got, read from a column printed to six or seven digits, is want
    to that precision."""
    assert abs(got - want) <= abs_tol + 1e-5 * abs(want), (got, want)


def _check_lambda(lam, f):
    """lam maximises f: within 1e-4 of the maximiser, or (a flat
    likelihood) as high to 1e-9."""
    best, top = _argmax(f)
    assert abs(lam - best) <= 1e-4 * best or f(lam) >= top - 1e-9, \
        (lam, best, f(lam), top)


def test_lmm4_at_40_covariates_against_gls(cvt40):
    td, X, W, y, K = cvt40
    got = _assoc(f"{td}/lmm4.assoc.txt")
    n = N_IND
    ev, U = np.linalg.eigh(K - K.mean(0) - K.mean(1)[:, None] + K.mean())
    ev = np.where(ev < 1e-10, 0.0, ev)
    UtW, Uty = U.T @ W, U.T @ y
    # the null: ML λ and logl of the covariates alone
    l0, logl0 = _argmax(lambda lam: _logl(lam, ev, UtW, Uty, False))
    df = n - N_CVT - 1
    for j in range(N_SNP):
        Utx = U.T @ X[j]
        Z = np.column_stack([UtW, Utx])
        lr, lm_ = got["l_remle"][j], got["l_mle"][j]
        _check_lambda(lr, lambda lam: _logl(lam, ev, Z, Uty, True))
        _check_lambda(lm_, lambda lam: _logl(lam, ev, Z, Uty, False))
        # Wald at the port's REML λ: x'P_W x, x'P_W y, y'P_Z y
        h, A, b, _ = _gls(lr, ev, UtW, Uty)
        Ai = np.linalg.inv(A)
        wx = UtW.T @ (Utx / h)
        p_xx = Utx @ (Utx / h) - wx @ Ai @ wx
        p_xy = Utx @ (Uty / h) - wx @ Ai @ b
        px_yy = _gls(lr, ev, Z, Uty)[3]
        tau = df / px_yy
        f_w = p_xy * p_xy / p_xx * tau
        _close(got["beta"][j], p_xy / p_xx)
        _close(got["p_wald"][j], scipy.stats.f.sf(f_w, 1, df))
        # LRT: the ML logls at the port's λ and the null's
        lrt = 2.0 * (_logl(lm_, ev, Z, Uty, False) - logl0)
        _close(got["p_lrt"][j], scipy.stats.chi2.sf(max(lrt, 0.0), 1), 1e-6)
        # score at the null's ML λ
        h, A, b, p_yy = _gls(l0, ev, UtW, Uty)
        Ai = np.linalg.inv(A)
        wx = UtW.T @ (Utx / h)
        p_xx = Utx @ (Utx / h) - wx @ Ai @ wx
        p_xy = Utx @ (Uty / h) - wx @ Ai @ b
        f_s = n * p_xy * p_xy / (p_yy * p_xx)
        _close(got["p_score"][j], scipy.stats.f.sf(f_s, 1, df), 1e-6)


def test_lm4_at_40_covariates_against_ols(cvt40):
    td, X, W, y, _ = cvt40
    got = _assoc(f"{td}/lm4.assoc.txt")
    n = N_IND
    df = n - N_CVT - 1
    Q, _ = np.linalg.qr(W)
    ry = y - Q @ (Q.T @ y)
    yPy = ry @ ry
    for j in range(N_SNP):
        rx = X[j] - Q @ (Q.T @ X[j])
        xPx, xPy = rx @ rx, rx @ ry
        r2 = xPy * xPy / (xPx * yPy)
        yPxy = yPy - xPy * xPy / xPx
        _close(got["beta"][j], xPy / xPx)
        _close(got["se"][j], np.sqrt(yPxy / (df * xPx)))
        _close(got["p_wald"][j],
               scipy.stats.f.sf(xPy * xPy * df / (xPx * yPxy), 1, df))
        _close(got["p_lrt"][j], scipy.stats.chi2.sf(-n * np.log1p(-r2), 1))
        _close(got["p_score"][j], scipy.stats.f.sf(n * r2, 1, df))
