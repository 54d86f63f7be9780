"""gemma_torch.models.lmm against gemma_tpu.models.lmm.

Both packages get the same eigenfactors, rotated data and null fits:
the inputs are made with numpy from a seed, the JAX side builds its
LmmBatchData from them and the port's side is carried across by
`gemma_torch.carry.state_from_numpy`.  The port runs on the CPU here,
where the kernel wrappers take their plain versions.

Tolerances:
  * float64: rel 1e-9 on likelihood quantities (logf, λ, logl) — the
    same arithmetic summed in another order; normwise rel 1e-9 on the
    derivatives dev1/dev2, differences of O(n/λ) terms that cross zero
    (an elementwise bound is meaningless there); p_wald abs 1e-8,
    identical NaN positions;
  * float32, port against JAX float32: normwise rel 1e-3 on derivatives
    and logf, whose O(n)-term cancellations amplify float32 rounding of
    sums taken in another order;
  * float32 port against JAX float64: p_wald abs 1e-3 (the speed-mode
    contract), >= 97% finite.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.models.lmm import likelihood as tlk
from gemma_tpu.models.lmm import optimize as topt
from gemma_tpu.models.lmm.engine import assoc_block_impl as tpu_assoc
from gemma_tpu.models.lmm.engine import fit_null as tpu_fit_null
from gemma_torch.carry import state_from_numpy
from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm import optimize as opt
from gemma_torch.models.lmm.engine import assoc_block_impl, fit_null

N, S = 200, 48
DT = {"f64": (np.float64, jnp.float64, torch.float64),
      "f32": (np.float32, jnp.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers torch's default
    pool oversubscribes the cores (tests/test_torch_mvlmm.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n_cvt, seed=5):
    rng = np.random.default_rng(seed)
    Xk = rng.binomial(2, 0.3, size=(500, N)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / 500
    L = np.linalg.cholesky(K + 1e-6 * np.eye(N))
    y = L @ rng.normal(size=N) * 1.2 + rng.normal(size=N)
    X = rng.binomial(2, 0.3, size=(S, N)).astype(np.float64)
    X[:4] += (y > np.median(y)) * 0.6                # a few real signals
    W = np.column_stack([np.ones(N), rng.normal(size=(N, n_cvt - 1))])
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    return dict(eval_=w, U=U, UtW=U.T @ W, Uty=U.T @ y, Utx=X @ U,
                trace_G=w.mean())


@pytest.fixture(scope="module", params=[1, 3], ids=["c1", "c3"])
def prob(request):
    return request.param, _problem(request.param)


def _both(prob, prec):
    """(JAX LmmBatchData, port LmmBatchData) in precision `prec`."""
    n_cvt, p = prob
    npd, jd, td = DT[prec]
    jdata = tlk.build_batch_data(*(jnp.asarray(p[k], jd) for k in
                                   ("eval_", "UtW", "Uty", "Utx")), n_cvt)
    st = state_from_numpy(p["eval_"], p["UtW"], p["Uty"], n_cvt=n_cvt,
                          Utx=p["Utx"], dtype=td)
    return jdata, st.data


def _close(a, b, prec, norm=False):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = np.isfinite(a)
    if prec == "f64" and norm:
        assert np.max(np.abs(b[ok] - a[ok])) <= 1e-9 * np.max(np.abs(a[ok]))
    elif prec == "f64":
        np.testing.assert_allclose(b[ok], a[ok], rtol=1e-9, atol=1e-12)
    else:
        assert np.max(np.abs(b[ok] - a[ok])) <= 1e-3 * np.max(np.abs(a[ok]))


def _lam_lanes(prec):
    rng = np.random.default_rng(1)
    return np.exp(rng.uniform(np.log(1e-4), np.log(1e4), S)).astype(
        DT[prec][0])


def _deriv_close(ref, ours, lam, power, prec):
    """Derivatives: ref is the reference's float64 value.  Each is a
    difference of O(n/λ^power) terms that cancel, so the bound is
    normwise plus the rounding floor n·eps/λ^power of the dtype."""
    ref = np.asarray(ref, np.float64)
    ours = np.asarray(ours, np.float64)
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(ours))
    ok = np.isfinite(ref)
    eps = np.finfo(DT[prec][0]).eps
    rtol = 1e-9 if prec == "f64" else 1e-3
    lam = np.broadcast_to(lam, ref.shape)
    bound = (rtol * np.max(np.abs(ref[ok]))
             + 64 * N * eps / lam[ok] ** power)
    assert np.all(np.abs(ours[ok] - ref[ok]) <= bound)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
def test_dev1_grid_matches_reference(prob, prec, reml):
    jdata, _ = _both(prob, "f64")
    _, data = _both(prob, prec)
    n_cvt = prob[0]
    grid = opt.fine_grid(1e-5, 1e5, 10, 16)
    a = tlk.dev1_grid(grid, jdata, n_cvt, False, reml)
    b = lk.dev1_grid(grid, data, n_cvt, False, reml)
    assert tuple(b.shape) == (len(grid), S)
    _deriv_close(a, b.numpy(), grid[:, None], 1, prec)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("calc_null", [False, True], ids=["alt", "null"])
def test_dev12_and_dev1_match_reference(prob, prec, calc_null):
    jdata, _ = _both(prob, "f64")
    _, data = _both(prob, prec)
    n_cvt = prob[0]
    lam = _lam_lanes(prec)
    a1, a2 = tlk.dev12(jnp.asarray(lam, jnp.float64), jdata, n_cvt,
                       calc_null, True)
    b1, b2 = lk.dev12(torch.from_numpy(lam), data, n_cvt, calc_null, True)
    _deriv_close(a1, b1.numpy(), lam, 1, prec)
    _deriv_close(a2, b2.numpy(), lam, 2, prec)
    c1 = lk.dev1(torch.from_numpy(lam), data, n_cvt, calc_null, False)
    _deriv_close(tlk.dev1(jnp.asarray(lam, jnp.float64), jdata, n_cvt,
                          calc_null, False), c1.numpy(), lam, 1, prec)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("fn", ["logf", "logf_stable"])
@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
def test_logf_matches_reference(prob, prec, fn, reml):
    jdata, data = _both(prob, prec)
    n_cvt = prob[0]
    lam = _lam_lanes(prec)
    for calc_null in (False, True):
        a = getattr(tlk, fn)(jnp.asarray(lam), jdata, n_cvt, calc_null, reml)
        b = getattr(lk, fn)(torch.from_numpy(lam), data, n_cvt, calc_null,
                            reml)
        _close(a, b.numpy(), prec)


def test_logf_stable_agrees_with_pab_logf_in_f64(prob):
    _, data = _both(prob, "f64")
    lam = torch.from_numpy(_lam_lanes("f64"))
    a = lk.logf(lam, data, prob[0], False, True)
    b = lk.logf_stable(lam, data, prob[0], False, True)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-9)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_wald_matches_reference(prob, prec):
    jdata, data = _both(prob, prec)
    n_cvt = prob[0]
    lam = _lam_lanes(prec)
    a = tlk.wald_stats(jnp.asarray(lam), jdata, n_cvt)
    b = lk.wald_stats(torch.from_numpy(lam), data, n_cvt)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        _close(x, y.numpy(), prec)
    from gemma_tpu.ops.stats import f_sf as tpu_f_sf
    j64, _ = _both(prob, "f64")
    f64 = tlk.wald_stats(jnp.asarray(lam, jnp.float64), j64, n_cvt)
    p_ref = np.asarray(tpu_f_sf(f64[2], 1.0, f64[3]))
    p = lk.wald_pvalues(torch.from_numpy(lam), data, n_cvt)[2]
    assert p.dtype == DT[prec][2]
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=0,
                               atol=1e-8 if prec == "f64" else 1e-3)


@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
@pytest.mark.parametrize("calc_null", [False, True], ids=["alt", "null"])
def test_calc_lambda_f64_matches_reference(prob, reml, calc_null):
    """The strict branch: per-point grid, Brent, Newton, NaN poisoning."""
    n_cvt, p = prob
    jdata, data = _both(prob, "f64")
    if calc_null:
        jdata = tlk.null_batch_data(jdata.eval, jdata.UtWy[:, :n_cvt],
                                    jdata.UtWy[:, n_cvt], n_cvt)
        data = lk.null_batch_data(data.eval, data.UtWy[:, :n_cvt],
                                  data.UtWy[:, n_cvt], n_cvt)
    a = topt.calc_lambda(jdata, n_cvt, calc_null, reml, 1e-5, 1e5, 10)
    b = opt.calc_lambda(data, n_cvt, calc_null, reml, 1e-5, 1e5, 10)
    _close(a.lam, b.lam.numpy(), "f64")
    _close(a.logf, b.logf.numpy(), "f64")


@pytest.mark.parametrize("reml", [True, False], ids=["reml", "ml"])
@pytest.mark.parametrize("calc_null", [False, True], ids=["alt", "null"])
def test_calc_lambda_f32_matches_reference(prob, reml, calc_null):
    """The speed-mode branch (fine grid + Newton + logf_stable), port
    float32 against JAX float32: logf within 1e-3 relative, and λ within
    the Newton tolerance's reach (5e-2 relative) away from the interval
    ends, where the likelihood is flat and two float32 evaluations may
    pick different near-tied candidates."""
    n_cvt, p = prob
    jdata, data = _both(prob, "f32")
    if calc_null:
        jdata = tlk.null_batch_data(jdata.eval, jdata.UtWy[:, :n_cvt],
                                    jdata.UtWy[:, n_cvt], n_cvt)
        data = lk.null_batch_data(data.eval, data.UtWy[:, :n_cvt],
                                  data.UtWy[:, n_cvt], n_cvt)
    a = topt.calc_lambda(jdata, n_cvt, calc_null, reml, 1e-5, 1e5, 10)
    b = opt.calc_lambda(data, n_cvt, calc_null, reml, 1e-5, 1e5, 10)
    la, lb = np.asarray(a.lam, float), b.lam.double().numpy()
    fa, fb = np.asarray(a.logf, float), b.logf.double().numpy()
    assert np.isfinite(lb).all()
    np.testing.assert_allclose(fb, fa, rtol=1e-3)
    interior = (la > 2e-5) & (la < 5e4)
    assert interior.mean() > 0.5
    np.testing.assert_allclose(lb[interior], la[interior], rtol=5e-2)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_fit_null_matches_reference(prob, prec):
    n_cvt, p = prob
    npd, jd, td = DT[prec]
    a = tpu_fit_null(*(jnp.asarray(p[k], jd) for k in
                       ("eval_", "UtW", "Uty", "trace_G")), n_cvt)
    st = state_from_numpy(p["eval_"], p["UtW"], p["Uty"], n_cvt=n_cvt,
                          dtype=td)
    b = fit_null(st.eval, st.UtW, st.Uty,
                 torch.tensor(p["trace_G"], dtype=td), n_cvt)
    rtol = 1e-9 if prec == "f64" else 1e-3
    for f in ("logl_mle", "logl_remle", "ve_remle", "beta_remle"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=rtol)
    for f in ("l_mle", "l_remle", "pve"):
        np.testing.assert_allclose(float(getattr(b, f)),
                                   float(getattr(a, f)),
                                   rtol=1e-9 if prec == "f64" else 5e-2)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_assoc_block_mode1_matches_reference(prob, prec):
    """Mode 1 from a carried-across null fit: float64 port against
    float64 JAX to 1e-8; float32 port against float64 JAX to the 1e-3
    contract."""
    n_cvt, p = prob
    ref_null = tpu_fit_null(*(jnp.asarray(p[k]) for k in
                              ("eval_", "UtW", "Uty", "trace_G")), n_cvt)
    a = tpu_assoc(*(jnp.asarray(p[k]) for k in
                    ("eval_", "UtW", "Uty", "Utx")),
                  ref_null.l_mle, ref_null.logl_mle, n_cvt=n_cvt, mode=1)
    st = state_from_numpy(p["eval_"], p["UtW"], p["Uty"], n_cvt=n_cvt,
                          U=p["U"], null=ref_null, Utx=p["Utx"],
                          dtype=DT[prec][2])
    b = assoc_block_impl(st.eval, st.UtW, st.Uty, st.data.Utx, st.null.l_mle,
                         st.null.logl_mle, n_cvt=n_cvt, mode=1)
    pa = np.asarray(a.p_wald, np.float64)
    pb = b.p_wald.double().numpy()
    if prec == "f64":
        np.testing.assert_array_equal(np.isnan(pa), np.isnan(pb))
        ok = np.isfinite(pa)
        np.testing.assert_allclose(pb[ok], pa[ok], rtol=0, atol=1e-8)
        for f in ("beta", "se", "lambda_remle", "logl_H1"):
            _close(getattr(a, f), getattr(b, f).numpy(), "f64")
    else:
        ok = np.isfinite(pa) & np.isfinite(pb)
        assert ok.mean() >= 0.97
        assert np.max(np.abs(pa[ok] - pb[ok])) <= 1e-3


def test_other_modes_raise(prob):
    """assoc_block_impl runs -lmm 1/2/3/4/9; -lmm 5 writes residuals in
    run_lmm and never reaches it."""
    n_cvt, p = prob
    st = state_from_numpy(p["eval_"], p["UtW"], p["Uty"], n_cvt=n_cvt,
                          Utx=p["Utx"])
    with pytest.raises(ValueError, match="-lmm 1/2/3/4/9"):
        assoc_block_impl(st.eval, st.UtW, st.Uty, st.data.Utx,
                         torch.tensor(1.0, dtype=torch.float64),
                         torch.tensor(0.0, dtype=torch.float64),
                         n_cvt=n_cvt, mode=5)
