"""The port's score and likelihood-ratio tests, and -lmm 2/3/4/9, against
gemma_tpu on the same numpy inputs (the port on the CPU, where the
kernel wrappers take their plain versions).

Tolerances:
  * score_stats, float64: rel 1e-9 (the same arithmetic summed in
    another order);
  * assoc_block_impl modes 2/3/4/9, float64: every p-value abs 1e-8,
    every other statistic rel 1e-9, identical NaN lanes;
  * float32 port against the float64 reference at n = 400: p_wald,
    p_lrt and p_score abs <= 1e-3 (the speed-mode contract), >= 97%
    finite.  The reference's own float32 p_lrt misses that contract
    (scripts/lrt_f32_gap.py): it takes the χ²(1) tail, infinitely steep
    at 0, of the difference of two float32 log-likelihoods near -10³.
    The port re-evaluates both in float64 (lrt_pvalues).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.models.lmm import likelihood as tlk
from gemma_tpu.models.lmm.engine import assoc_block_impl as tpu_assoc
from gemma_tpu.models.lmm.engine import fit_null as tpu_fit_null
from gemma_torch.carry import state_from_numpy
from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm.engine import assoc_block_impl, fit_null

N, S = 400, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers torch's default
    pool oversubscribes the cores (tests/test_torch_mvlmm.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n_cvt, n=N, s=S, seed=5):
    rng = np.random.default_rng(seed)
    Xk = rng.binomial(2, 0.3, size=(2 * n + 100, n)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / Xk.shape[0]
    L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
    y = L @ rng.normal(size=n) * 1.2 + rng.normal(size=n)
    X = rng.binomial(2, 0.3, size=(s, n)).astype(np.float64)
    X[:4] += (y > np.median(y)) * 0.6                # a few real signals
    W = np.column_stack([np.ones(n), rng.normal(size=(n, n_cvt - 1))])
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    return dict(eval_=w, U=U, UtW=U.T @ W, Uty=U.T @ y, Utx=X @ U,
                trace_G=w.mean())


@pytest.fixture(scope="module", params=[1, 3], ids=["c1", "c3"])
def prob(request):
    return request.param, _problem(request.param)


def _ref_null(p, n_cvt):
    return tpu_fit_null(*(jnp.asarray(p[k]) for k in
                          ("eval_", "UtW", "Uty", "trace_G")), n_cvt)


def test_score_stats_matches_reference(prob):
    n_cvt, p = prob
    jdata = tlk.build_batch_data(*(jnp.asarray(p[k]) for k in
                                   ("eval_", "UtW", "Uty", "Utx")), n_cvt)
    st = state_from_numpy(p["eval_"], p["UtW"], p["Uty"], n_cvt=n_cvt,
                          Utx=p["Utx"])
    lam = np.full(S, 0.7)
    a = tlk.score_stats(jnp.asarray(lam), jdata, n_cvt)
    b = lk.score_stats(torch.from_numpy(lam), st.data, n_cvt)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-9)


@pytest.mark.parametrize("mode", [2, 3, 4, 9])
def test_assoc_block_modes_match_reference_f64(prob, mode):
    """Float64 port against float64 JAX from one null fit: the
    reference's order and overrides (beta/se from Wald in 4, from the
    score in 9; logl_H1 from the ML fit in 2/4/9)."""
    n_cvt, p = prob
    ref_null = _ref_null(p, n_cvt)
    a = tpu_assoc(*(jnp.asarray(p[k]) for k in
                    ("eval_", "UtW", "Uty", "Utx")),
                  ref_null.l_mle, ref_null.logl_mle, n_cvt=n_cvt, mode=mode)
    st = state_from_numpy(p["eval_"], p["UtW"], p["Uty"], n_cvt=n_cvt,
                          null=ref_null, Utx=p["Utx"])
    b = assoc_block_impl(st.eval, st.UtW, st.Uty, st.data.Utx, st.null.l_mle,
                         st.null.logl_mle, n_cvt=n_cvt, mode=mode)
    for f in a._fields:
        fa = np.asarray(getattr(a, f), np.float64)
        fb = getattr(b, f).numpy()
        np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb), err_msg=f)
        ok = np.isfinite(fa)
        if f.startswith("p_"):
            np.testing.assert_allclose(fb[ok], fa[ok], rtol=0, atol=1e-8,
                                       err_msg=f)
        else:
            np.testing.assert_allclose(fb[ok], fa[ok], rtol=1e-9, atol=1e-12,
                                       err_msg=f)


def test_float32_port_within_contract_all_tests():
    """n = 400: the port's float32 -lmm 4 against the reference's float64,
    every p-value within the 1e-3 contract (the c = 1 inputs of the
    tests above, so the reference's programs are compiled once)."""
    p = _problem(1)
    ref_null = _ref_null(p, 1)
    a = tpu_assoc(*(jnp.asarray(p[k]) for k in
                    ("eval_", "UtW", "Uty", "Utx")),
                  ref_null.l_mle, ref_null.logl_mle, n_cvt=1, mode=4)
    st = state_from_numpy(p["eval_"], p["UtW"], p["Uty"], n_cvt=1,
                          Utx=p["Utx"], dtype=torch.float32)
    nf = fit_null(st.eval, st.UtW, st.Uty,
                  torch.tensor(p["trace_G"], dtype=torch.float32), 1)
    b = assoc_block_impl(st.eval, st.UtW, st.Uty, st.data.Utx, nf.l_mle,
                         nf.logl_mle, n_cvt=1, mode=4)
    for f in ("p_wald", "p_lrt", "p_score"):
        pa = np.asarray(getattr(a, f), np.float64)
        pb = getattr(b, f).double().numpy()
        assert getattr(b, f).dtype == torch.float32
        ok = np.isfinite(pa) & np.isfinite(pb)
        assert ok.mean() >= 0.97, f
        assert np.max(np.abs(pa[ok] - pb[ok])) <= 1e-3, f


def test_lrt_pvalues_float32_is_float64_logf_of_float32_operands(prob):
    """Speed-mode LRT: logl_H1 is logf_stable in float64 of the float32
    operands at the float32 λ, and p the chi-square tail of the float64
    difference (rel 1e-12: the same float64 arithmetic)."""
    n_cvt, p = prob
    st = state_from_numpy(p["eval_"], p["UtW"], p["Uty"], n_cvt=n_cvt,
                          Utx=p["Utx"], dtype=torch.float32)
    lam = torch.full((S,), 0.5, dtype=torch.float32)
    l0 = torch.tensor(0.8, dtype=torch.float32)
    l1, pv = lk.lrt_pvalues(lam, None, st.data, n_cvt, l0, None)
    d64 = st.data._replace(eval=st.data.eval.double(),
                           UtWy=st.data.UtWy.double(),
                           Utx=st.data.Utx.double())
    ref1 = lk.logf_stable(lam.double(), d64, n_cvt, False, False)
    ref0 = lk.logf_stable(l0.double().reshape(1), d64, n_cvt, True, False)
    np.testing.assert_allclose(l1.double().numpy(),
                               ref1.float().double().numpy(), rtol=1e-12)
    from scipy.stats import chi2
    want = chi2.sf(2.0 * (ref1 - ref0).numpy(), 1)
    np.testing.assert_allclose(pv.double().numpy(),
                               want.astype(np.float32), rtol=1e-6)
