"""The port's multivariate LMM core and driver against gemma_tpu on the
same numpy inputs, float64 on the CPU (the kernel wrappers take their
plain versions).

Tolerances:
  * eigen_proc, calc_qi, mph_calc_logl, mph_calc_p, mph_calc_beta: rel
    1e-10 (the same float64 formulas, summed in another order);
  * mph_em at d = 2, REML and ML, a fixed cap and converged: Vg, Ve and
    logl rel 1e-8, and each lane's exit at the same iteration (the
    reference's done flag flips between iter_cap = t and t + 1 where the
    port's count is t);
  * mph_em REML at d = 3: the same.  ML at d >= 3 is not compared lane by
    lane: GEMMA's ML EM carries its B in the previous iteration's
    eigenbasis, so its trajectory depends on the signs of the 3×3
    eigenvectors, which the reference takes from LAPACK as they come and
    the port keeps consistent between iterations (ROADMAP §C).  After the
    Newton-Raphson both reach the ML optimum: p_lrt abs 1e-3;
  * the closed-form gradient and Hessian against jax.grad/jax.hessian of
    the reference's _nr_logl_fn and against torch.func on the port's own
    likelihood: rel 1e-7; mph_nr: logl rel 1e-9, Vg/Ve/Hvar rel 1e-7;
  * MvlmmNull at d = 2 everything rel 1e-8; at d = 5 (pairwise initial
    values) the REML fit and the ML log-likelihood rel 1e-8 (the ML EMs
    take their eigenvector signs differently, but from the REML fit
    neither flips one on this problem);
  * -lmm 2 at d = 3 with each package fitting its own null: the ML
    log-likelihoods rel 1e-8, p_lrt abs 1e-6;
  * mvlmm_assoc modes 1-4 with refinement forced (-pnr 0.5) and its GxE
    variant: p abs 1e-6, beta and Vbeta rel 1e-5 (to max(|v|, 1e-3));
    the port's float32 speed mode p within 1e-3 of the reference's
    float64.  A mode whose p column is the same computation as in
    -lmm 4 is held against the reference's -lmm 4 run: one compile of
    its programs instead of one per mode.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models import mvlmm as rmv
from gemma_tpu.models import mvlmm_core as ref
from gemma_torch.carry import mvlmm_state_from_numpy
from gemma_torch.models import mvlmm as pmv
from gemma_torch.models import mvlmm_core as core

N, S = 120, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions loop over small tensors; under the suite's
    parallel workers torch's default intra-op pool oversubscribes the
    cores and such loops run some 100x slower (measured: one -lmm 4
    block 507 s against 3.8 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dt=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)), dtype=dt)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


@functools.lru_cache(maxsize=None)
def _problem(d=2, c=1, n=N, s=S, seed=0):
    """Rotated operands of a heritable d-trait set: eval (n,), X0 (c, n),
    Y (d, n), Utx and Utx∘env (s, n), Ut env (n,)."""
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
    W = np.column_stack([np.ones(n), rng.normal(size=(n, c - 1))])
    x = rng.binomial(2, 0.3, size=(s, n)).astype(float)
    x[:4] += 0.4 * Yr[:, 0]
    env = rng.integers(0, 2, n).astype(float)
    return dict(ev=ev, X0=(U.T @ W).T, Y=(U.T @ Yr).T, Utx=x @ U,
                Utxe=(x * env) @ U, Ute=U.T @ env, Vg=Vg, Ve=Ve)


def _x_alt(p):
    return np.concatenate([np.broadcast_to(p["X0"], (S,) + p["X0"].shape),
                           p["Utx"][:, None]], axis=1)


@pytest.mark.parametrize("d", [2, 3])
def test_host_math_matches_reference(d):
    p = _problem(d, c=2)
    Vg, Ve = p["Vg"], p["Ve"]
    r = jax.jit(ref.eigen_proc)(jnp.asarray(Vg), jnp.asarray(Ve))
    q = core.eigen_proc(_t(Vg), _t(Ve))
    assert _rel(r[0], q[0]) <= 1e-10 and abs(float(r[3]) - float(q[3])) < 1e-12
    # UltVeh/UltVehi rows may differ in sign at d >= 3: compare up to it
    sgn = np.sign(np.sum(np.asarray(r[1]) * q[1].numpy(), axis=1))[:, None]
    for a, b in ((r[1], q[1]), (r[2], q[2])):
        assert _rel(a, sgn * b.numpy()) <= 1e-10
    X = p["X0"]
    ev = p["ev"]
    Qr, ldr = jax.jit(ref.calc_qi)(jnp.asarray(ev), r[0], jnp.asarray(X))
    Qp, ldp = core.calc_qi(_t(ev), q[0], _t(X))
    assert _rel(Qr, Qp) <= 1e-10 and abs(float(ldr) - float(ldp)) < 1e-9
    zr = r[2] @ jnp.asarray(p["Y"])
    zp = q[2] @ _t(p["Y"])
    xr = ref._calc_xhiy(jnp.asarray(ev), r[0], jnp.asarray(X), zr)
    xp = core.calc_xhiy(_t(ev), q[0], _t(X), zp)
    lr = ref.mph_calc_logl(jnp.asarray(ev), xr, r[0], zr, Qr)
    lp = core.mph_calc_logl(_t(ev), xp, q[0], zp, Qp)
    assert _rel(lr, lp) <= 1e-10
    Br, ser = ref.mph_calc_beta(jnp.asarray(ev), jnp.asarray(X),
                                jnp.asarray(p["Y"]), jnp.asarray(Vg),
                                jnp.asarray(Ve))
    Bp, sep = core.mph_calc_beta(_t(ev), _t(X), _t(p["Y"]), _t(Vg), _t(Ve))
    assert _rel(Br, Bp) <= 1e-10 and _rel(ser, sep) <= 1e-10
    st, be, Vb = jax.jit(ref.mph_calc_p)(
        jnp.asarray(ev), jnp.asarray(p["Utx"]), jnp.asarray(X),
        jnp.asarray(p["Y"]), jnp.broadcast_to(jnp.asarray(Vg), (S, d, d)),
        jnp.broadcast_to(jnp.asarray(Ve), (S, d, d)))
    cp = core.mph_calc_p(_t(ev), _t(X), _t(p["Y"]), _t(p["Utx"][:, None]),
                         _t(Vg)[None], _t(Ve)[None])
    assert _rel(st, cp.stat) <= 1e-10
    assert _rel(be, cp.beta) <= 1e-10 and _rel(Vb, cp.Vbeta) <= 1e-10
    np.testing.assert_allclose(cp.p.numpy(), np.asarray(
        rmv.chisq_sf(st, float(d))), rtol=1e-10, atol=1e-14)


def _em_pair(d, reml, cap, B0=None):
    p = _problem(d)
    c = p["X0"].shape[0] + 1
    B0 = np.zeros((d, c)) if B0 is None else B0
    args = (jnp.asarray(p["ev"]), jnp.asarray(_x_alt(p)), jnp.asarray(p["Y"]),
            jnp.broadcast_to(jnp.asarray(p["Vg"]), (S, d, d)),
            jnp.broadcast_to(jnp.asarray(p["Ve"]), (S, d, d)),
            jnp.broadcast_to(jnp.asarray(B0), (S, d, c)))

    def run_ref(k):
        return ref.mph_em(reml, 1000, 1e-3, *args, iter_cap=k)

    st = mvlmm_state_from_numpy(p["ev"], p["X0"], p["Y"], Vg=p["Vg"],
                                Ve=p["Ve"], B=B0, R=p["Utx"][:, None])
    got = core.mph_em(reml, cap, 1e-3, st.eval, st.X0, st.Y, st.R, st.Vg,
                      st.Ve, st.B)
    return run_ref, got


@pytest.mark.parametrize("d,reml", [(2, True), (2, False), (3, True)],
                         ids=["d2-reml", "d2-ml", "d3-reml"])
@pytest.mark.parametrize("cap", [25, 1000])
def test_mph_em_matches_reference(d, reml, cap):
    run_ref, got = _em_pair(d, reml, cap, B0=None if reml else
                            np.full((d, 2), 0.1))
    Vg, Ve, B, logl, done = run_ref(cap)
    for a, b in ((Vg, got.Vg), (Ve, got.Ve), (logl, got.logl)):
        assert _rel(a, b) <= 1e-8
    np.testing.assert_array_equal(np.asarray(done), got.done.numpy())
    # the same exit iteration: done by t + 1 iterations, not by t
    iters = got.iters.numpy()
    for t in np.unique(iters[iters < cap]):
        lanes = iters == t
        assert np.asarray(run_ref(int(t) + 1)[4])[lanes].all()
        assert not np.asarray(run_ref(int(t))[4])[lanes].any()


def test_mph_em_staged_skips_the_test_at_burst_starts():
    """The staged form is the reference's burst driver: the same lanes
    leave at the same iterations (its float64 -lmm 1 path)."""
    p = _problem(2)
    R = _t(p["Utx"][:, None])
    args = (_t(p["ev"]), _t(p["X0"]), _t(p["Y"]), R, _t(p["Vg"])[None],
            _t(p["Ve"])[None], torch.zeros((1, 2, 2), dtype=torch.float64))
    plain = core.mph_em(True, 1000, 1e-3, *args)
    staged = core.mph_em(True, 1000, 1e-3, *args, staged=True)
    starts = core.burst_starts(1000)
    assert sorted(starts)[:5] == [32, 96, 224, 480, 992]
    moved = plain.iters != staged.iters
    assert all(int(t) in starts for t in plain.iters[moved])
    assert (staged.iters[moved] == plain.iters[moved] + 1).all()
    assert core.nr_switch_point(1000) == 224
    assert core.nr_switch_point(200) is None
    logl, stat, _, _ = rmv._em_staged_reml(
        jnp.asarray(p["ev"]), jnp.asarray(p["X0"]), jnp.asarray(p["Y"]),
        jnp.asarray(p["Utx"]), jnp.asarray(p["Vg"]), jnp.asarray(p["Ve"]),
        em_iter=1000, em_prec=1e-3)
    cp = core.mph_calc_p(args[0], args[1], args[2], R, staged.Vg, staged.Ve)
    assert _rel(logl, staged.logl) <= 1e-8 and _rel(stat, cp.stat) <= 1e-8


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
def test_closed_form_derivatives(d, reml):
    """nr_derivatives against the reference's autodiff and torch.func."""
    p = _problem(d)
    Xl = _x_alt(p)[0]
    vs = d * (d + 1) // 2
    fn = ref._nr_logl_fn(reml, jnp.asarray(p["ev"]), jnp.asarray(Xl),
                         jnp.asarray(p["Y"]))
    v = jnp.concatenate([ref.sym_to_vech(jnp.asarray(p["Vg"]), d),
                         ref.sym_to_vech(jnp.asarray(p["Ve"]), d)])
    logl, g, H = core.nr_derivatives(reml, _t(p["ev"]), _t(Xl)[None],
                                     _t(p["Y"]), _t(p["Vg"])[None],
                                     _t(p["Ve"])[None])
    assert _rel(jax.jit(fn)(v), logl[0]) <= 1e-12
    assert _rel(jax.jit(jax.grad(fn))(v), g[0]) <= 1e-7
    assert _rel(jax.jit(jax.hessian(fn))(v), H[0]) <= 1e-7

    def f(theta):
        Vg = core.vech_to_sym(theta[:vs], d)[None]
        Ve = core.vech_to_sym(theta[vs:], d)[None]
        return core.nr_logl(reml, _t(p["ev"]), _t(Xl)[None], _t(p["Y"]),
                            Vg, Ve)[0]

    th = _t(np.asarray(v))
    assert _rel(torch.func.grad(f)(th), g[0]) <= 1e-7
    assert _rel(torch.func.hessian(f)(th), H[0]) <= 1e-7


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
def test_mph_nr_matches_reference(d, reml):
    p = _problem(d)
    r = ref.mph_nr(reml, 10, 1e-3, jnp.asarray(p["ev"]),
                   jnp.asarray(_x_alt(p)), jnp.asarray(p["Y"]),
                   jnp.broadcast_to(jnp.asarray(p["Vg"]), (S, d, d)),
                   jnp.broadcast_to(jnp.asarray(p["Ve"]), (S, d, d)))
    q = core.mph_nr(reml, 10, 1e-3, _t(p["ev"]), _t(p["X0"]), _t(p["Y"]),
                    _t(p["Utx"][:, None]), _t(p["Vg"])[None],
                    _t(p["Ve"])[None])
    assert _rel(r[2], q[2]) <= 1e-9
    for a, b in ((r[0], q[0]), (r[1], q[1]), (r[3], q[3])):
        assert _rel(a, b) <= 1e-7


def _cfg(**kw):
    base = dict(l_min=1e-5, l_max=1e5, n_region=10, em_iter=10000,
                nr_iter=100, em_prec=1e-4, nr_prec=1e-4, p_nr=0.5, crt=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


@functools.lru_cache(maxsize=None)
def _nulls(d, gxe=False):
    p = _problem(d)
    X0 = np.vstack([p["X0"], p["Ute"][None]]) if gxe else p["X0"]
    r = rmv.MvlmmNull(jnp.asarray(p["ev"]), jnp.asarray(X0),
                      jnp.asarray(p["Y"]), _cfg())
    q = pmv.MvlmmNull(_t(p["ev"]), _t(X0), _t(p["Y"]), _cfg())
    return X0, r, q


@pytest.mark.parametrize("d", [2, 5])
def test_null_matches_reference(d):
    _, r, q = _nulls(d)
    for f in ("Vg_remle", "Ve_remle", "B_remle", "se_B_remle", "VVg_remle",
              "VVe_remle"):
        assert _rel(getattr(r, f), getattr(q, f)) <= 1e-8, f
    assert abs(r.logl_remle_H0 - q.logl_remle_H0) <= 1e-8 * abs(
        r.logl_remle_H0)
    if d == 2:
        for f in ("Vg_mle", "Ve_mle", "B_mle", "B_start"):
            assert _rel(getattr(r, f), getattr(q, f)) <= 1e-8, f
        assert abs(r.logl_mle_H0 - q.logl_mle_H0) <= 1e-8 * abs(
            r.logl_mle_H0)
    else:
        assert abs(r.logl_mle_H0 - q.logl_mle_H0) <= 1e-8 * abs(
            r.logl_mle_H0)


def _close(r, q, p_tol=1e-6, rel=1e-5, cols=("p_wald", "p_lrt", "p_score")):
    for k in cols:
        assert np.max(np.abs(np.asarray(r[k]) - q[k])) <= p_tol, k
    if rel is not None:
        for k in ("beta", "Vbeta"):
            a = np.asarray(r[k])
            scale = np.maximum(np.abs(a), 1e-3)
            assert np.max(np.abs(a - q[k]) / scale) <= rel, k


@functools.lru_cache(maxsize=None)
def _ref_assoc(mode, gxe):
    p = _problem(2)
    X0, rn, _ = _nulls(2, gxe)
    j = {k: jnp.asarray(p[k]) for k in ("ev", "Y", "Utx", "Utxe")}
    if gxe:
        return rmv.mvlmm_assoc_gxe(j["ev"], jnp.asarray(X0), j["Y"], j["Utx"],
                                   j["Utxe"], rn, mode, _cfg(), jnp.float64)
    return rmv.mvlmm_assoc(j["ev"], jnp.asarray(X0), j["Y"], j["Utx"], rn,
                           mode, _cfg(), jnp.float64)


def _port_assoc(mode, gxe, dt):
    p = _problem(2)
    X0, _, qn = _nulls(2, gxe)
    t = {k: _t(p[k], dt) for k in ("ev", "Y", "Utx", "Utxe")}
    if gxe:
        return pmv.mvlmm_assoc_gxe(t["ev"], _t(X0, dt), t["Y"], t["Utx"],
                                   t["Utxe"], qn, mode, _cfg(), dt)
    return pmv.mvlmm_assoc(t["ev"], _t(X0, dt), t["Y"], t["Utx"], qn, mode,
                           _cfg(), dt)


@pytest.mark.parametrize("gxe", [False, True], ids=["snp", "gxe"])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_assoc_matches_reference(mode, gxe):
    """Each mode's p column against the reference's run of the same mode
    or, where that column is the same computation, its -lmm 4 run (every
    mode but GxE 1 and 2, whose starting values depend on the mode)."""
    own = gxe and mode in (1, 2)
    r = _ref_assoc(mode if own else 4, gxe)
    cols = {1: ("p_wald",), 2: ("p_lrt",), 3: ("p_score",),
            4: ("p_wald", "p_lrt", "p_score")}[mode]
    # beta and Vbeta come from the mode's last fit: REML in modes 1 and 4
    _close(r, _port_assoc(mode, gxe, torch.float64), cols=cols,
           rel=1e-5 if own or mode in (1, 4) else None)
    if mode == 4:
        _close(r, _port_assoc(mode, gxe, torch.float32), p_tol=1e-3,
               rel=None)


def test_d3_ml_after_newton():
    """d = 3, ML: from the ML null, EM then Newton-Raphson, as the -pnr
    refinement runs them, in both packages (the port's null feeds both)
    reach the ML optimum whatever signs the EM took: p_lrt within 1e-3."""
    p = _problem(3)
    k = 8
    qn = pmv.MvlmmNull(_t(p["ev"]), _t(p["X0"]), _t(p["Y"]), _cfg())
    r = rmv._em_then_nr_block(
        jnp.asarray(p["ev"]), jnp.asarray(p["X0"]), jnp.asarray(p["Y"]),
        jnp.asarray(p["Utx"][:k]), jnp.asarray(qn.Vg_start.numpy()),
        jnp.asarray(qn.Ve_start.numpy()), jnp.asarray(qn.B_start.numpy()),
        reml=False, em_iter=1000, em_prec=1e-3, nr_iter=10, nr_prec=1e-3)
    R = _t(p["Utx"][:k, None])
    args = (_t(p["ev"]), _t(p["X0"]), _t(p["Y"]), R)
    em = core.mph_em(False, 1000, 1e-3, *args, qn.Vg_start[None],
                     qn.Ve_start[None], qn.B_start[None])
    _, _, logl, _ = core.mph_nr(False, 10, 1e-3, *args, em.Vg, em.Ve)
    l0 = qn.logl_mle_H0
    p_ref = np.asarray(rmv.chisq_sf(2.0 * (r[0] - l0), 3.0))
    p_got = core.chisq_sf(2.0 * (logl - l0), 3.0).numpy()
    assert np.max(np.abs(p_ref - p_got)) <= 1e-3


def test_d3_lmm2_from_each_packages_null():
    """d = 3, -lmm 2: each package fits its own ML null (EM with its own
    eigenvector signs, then Newton-Raphson) and tests every SNP against
    it, refining p < 0.5.  logl_mle_H0 enters every lane's LRT, so a gap
    between the nulls would move every p_lrt."""
    X0, rn, qn = _nulls(3)
    assert abs(rn.logl_mle_H0 - qn.logl_mle_H0) <= 1e-8 * abs(
        rn.logl_mle_H0)
    p = _problem(3)
    r = rmv.mvlmm_assoc(jnp.asarray(p["ev"]), jnp.asarray(X0),
                        jnp.asarray(p["Y"]), jnp.asarray(p["Utx"]), rn, 2,
                        _cfg(), jnp.float64)
    q = pmv.mvlmm_assoc(_t(p["ev"]), _t(X0), _t(p["Y"]), _t(p["Utx"]), qn,
                        2, _cfg(), torch.float64)
    _close(r, q, cols=("p_lrt",), rel=None)
