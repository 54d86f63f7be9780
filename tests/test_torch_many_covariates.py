"""More than 16 covariates: K2-K8 take any number on the card (their
second instantiation above 16, GT_WIDE_CVT in gemma_torch/csrc/common.cuh,
and a run-time-sized form above 32), as the reference does.  The port's
CPU path (the kernels' plain versions) against the reference, float64,
with an intercept plus 23 seeded normal columns — a human GWAS's sex,
age, batch and principal components: p-values within 1e-8, the other
columns as in test_torch_cli.py.

The reference's -lmm 4 runs its per-SNP block program on the port's
null fit: its own null fit at 24 covariates costs a second compile as
long as the block's (about 90 s on one CPU core).  The null fit is held
instead against GEMMA's REML and ML log-likelihoods written out in numpy
and maximised by a bounded search of their own."""

import numpy as np
import pytest
import scipy.optimize
import torch

import jax.numpy as jnp

from gemma_torch import kernels
from gemma_torch.models.lmm import engine
from gemma_tpu import run as tpu_run
from gemma_tpu.models.lmm.engine import NullFit as RefNullFit
from test_torch_cli import (N, _assert_assoc_close, _read_assoc, _run_both,
                            _write_bimbam)

N_CVT = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain λ search at 24 covariates is many
    small ops, and beside other test workers eight threads made it ten
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("cvt"))
    geno, pheno = _write_bimbam(td, seed=5)
    rng = np.random.default_rng(24)
    cov = np.column_stack([np.ones(N), rng.normal(size=(N, N_CVT - 1))])
    np.savetxt(f"{td}/cov.txt", cov, fmt="%.6f")
    _run_both(td, f"-g {geno} -p {pheno} -gk 1 -o K_{{tag}}")
    return td, f"-g {geno} -p {pheno} -c {td}/cov.txt"


@pytest.fixture(scope="module")
def null(data):
    """-lmm 4 through both packages, the reference's on the port's null
    fit; returns the null's operands and the port's fit of them."""
    td, common = data
    seen = {}

    def port_null(eval_, UtW, Uty, trace_G, n_cvt, **kw):
        ops = [np.array(a, np.float64) for a in (eval_, UtW, Uty)]
        nf = engine.fit_null(*map(torch.as_tensor, ops), float(trace_G),
                             n_cvt, **kw)
        seen.update(ops=ops, nf={k: v.numpy() for k, v in
                                 nf._asdict().items()})
        return RefNullFit(*(jnp.asarray(v.numpy()) for v in nf))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_run, "fit_null", port_null)
        _run_both(td, f"{common} -k {td}/K_tpu.cXX.txt -lmm 4 "
                      "-o lmm4_{tag}")
    return seen


def _assert_p_close(td, a, b, columns):
    ha, ra = _read_assoc(f"{td}/{a}.assoc.txt")
    hb, rb = _read_assoc(f"{td}/{b}.assoc.txt")
    for name in columns:
        col = ha.index(name)
        x = np.array([r[col] for r in ra], float)
        y = np.array([r[hb.index(name)] for r in rb], float)
        assert np.isfinite(x).all()
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("mode,kin", [("-lmm 4", True), ("-lm 4", False)],
                         ids=["lmm4", "lm4"])
def test_24_covariates_match_reference(data, mode, kin, request):
    td, common = data
    tag = mode.replace(" ", "").replace("-", "")
    if kin:
        request.getfixturevalue("null")
    else:
        _run_both(td, f"{common} {mode} -o {tag}_{{tag}}")
    _assert_assoc_close(f"{td}/{tag}_tpu.assoc.txt",
                        f"{td}/{tag}_torch.assoc.txt")
    _assert_p_close(td, f"{tag}_tpu", f"{tag}_torch",
                    ("p_wald", "p_lrt", "p_score"))


def _logl(lam, ev, UtW, Uty, reml):
    """GEMMA's LogL_f / LogRL_f (lmm.cpp) of the covariate-only model at
    lambda, from the rotated operands: dense GLS, no Pab recursion."""
    n, c = UtW.shape
    h = lam * ev + 1.0
    A = (UtW / h[:, None]).T @ UtW
    b = UtW.T @ (Uty / h)
    p_yy = Uty @ (Uty / h) - b @ np.linalg.solve(A, b)
    logdet_h = np.log(np.abs(h)).sum()
    if not reml:
        return (0.5 * n * (np.log(n) - np.log(2 * np.pi) - 1.0)
                - 0.5 * logdet_h - 0.5 * n * np.log(p_yy))
    df = n - c
    logdet_hiw = (np.linalg.slogdet(A)[1]
                  - np.linalg.slogdet(UtW.T @ UtW)[1])
    return (0.5 * df * (np.log(df) - np.log(2 * np.pi) - 1.0)
            - 0.5 * logdet_h - 0.5 * logdet_hiw - 0.5 * df * np.log(p_yy))


@pytest.mark.parametrize("reml", [True, False], ids=["remle", "mle"])
def test_24_covariate_null_fit_maximises_likelihood(null, reml):
    """The port's null λ and log-likelihood against a grid of 4,001
    points over [1e-5, 1e5] and a bounded search around its best point
    (or that bound, where the best point is one: at 24 covariates on 120
    individuals the ML null does): λ within 1e-5 relative, the
    log-likelihood within 1e-10."""
    ev, UtW, Uty = null["ops"]
    tag = "remle" if reml else "mle"
    lam, logl = null["nf"][f"l_{tag}"], null["nf"][f"logl_{tag}"]

    def f(t):
        return -_logl(10.0 ** t, ev, UtW, Uty, reml)

    grid = np.linspace(-5.0, 5.0, 4001)
    i = int(np.argmin([f(t) for t in grid]))
    if 0 < i < len(grid) - 1:
        best = scipy.optimize.minimize_scalar(
            f, bounds=(grid[i - 1], grid[i + 1]), method="bounded",
            options={"xatol": 1e-12})
        t_best, f_best = best.x, best.fun
    else:                       # the supremum lies on a bound: λ is it
        t_best, f_best = grid[i], f(grid[i])
    np.testing.assert_allclose(lam, 10.0 ** t_best, rtol=1e-5)
    np.testing.assert_allclose(logl, -f_best, rtol=0, atol=1e-10)
    np.testing.assert_allclose(logl, _logl(lam, ev, UtW, Uty, reml),
                               rtol=0, atol=1e-10)


def test_check_n_cvt_takes_up_to_32():
    """The covariate bound is gone (the name is the old bound's): K2-K8
    take 33, 40 and 64 covariates, through their run-time-sized form
    above 32 (tests/test_torch_wide_shapes.py holds 40 end to end)."""
    assert not hasattr(kernels, "MAX_CVT")
    for n_cvt in (32, 33, 40, 64):
        kernels.check_n_cvt(n_cvt)
    with pytest.raises(ValueError, match="n_cvt >= 0"):
        kernels.check_n_cvt(-1)


def test_check_mvlmm_and_bslmm_shapes_take_wide_shapes():
    """Nor do the mvLMM and BSLMM kernels bound d, c or s_max: ten traits
    with 13 or 14 design rows (the protocol's covariates with the SNP,
    and with -gxe), and s_max 2,048."""
    for c in (13, 14):
        kernels.check_mvlmm_shape(10, c)
    kernels.check_bslmm_shape(2048)
    for bad in ((1, 2), (2, 0)):
        with pytest.raises(ValueError, match="at least 2 phenotypes"):
            kernels.check_mvlmm_shape(*bad)
    with pytest.raises(ValueError, match="s_max >= 1"):
        kernels.check_bslmm_shape(0)
