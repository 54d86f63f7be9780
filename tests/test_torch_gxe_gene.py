"""The port's GxE and gene-mode association against gemma_tpu on the same
numpy inputs (the port on the CPU, where the kernel wrappers take their
plain versions; both from the same eigenfactors and null fit).

Tolerances:
  * float64, every mode: every p-value abs 1e-8, every other statistic
    rel 1e-9, identical NaN lanes (as tests/test_torch_assoc.py);
  * the port's float32 -lmm 4 against the reference's float64: p_wald,
    p_lrt and p_score abs <= 1e-3 (the speed-mode contract), >= 97%
    finite, and no NaN p_lrt in gene mode.  The reference's own float32
    misses that contract in both (ROADMAP.md §C): its per-gene null is a
    zero-x fit whose float32 likelihood takes a Cholesky factor of a
    Gram with a zero row, NaN, so its p_lrt is NaN for every gene (the
    last test records it); its GxE p_lrt is the difference of two
    float32 log-likelihoods.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.models.lmm.engine import assoc_gene_block as tpu_gene
from gemma_tpu.models.lmm.engine import assoc_gxe_block as tpu_gxe
from gemma_tpu.models.lmm.engine import fit_null as tpu_fit_null
from gemma_torch.models.lmm.engine import (assoc_gene_block_impl,
                                           assoc_gxe_block_impl, fit_null)

N, S = 300, 32
# (n_cvt, mode): every mode once, c = 2 through the LRT (its per-lane
# null); each case compiles the reference's vmapped pipeline once
CASES = [(1, 1), (2, 2), (1, 3), (1, 4), (1, 9)]
IDS = [f"c{c}-lmm{m}" for c, m in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers torch's default
    pool oversubscribes the cores (tests/test_torch_mvlmm.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _problem(n_cvt, n=N, s=S, seed=11):
    rng = np.random.default_rng(seed + n_cvt)
    Xk = rng.binomial(2, 0.3, size=(400, n)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / Xk.shape[0]
    L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
    y = L @ rng.normal(size=n) * 1.2 + rng.normal(size=n)
    env = rng.integers(0, 2, n).astype(np.float64)
    X = rng.binomial(2, 0.3, size=(s, n)).astype(np.float64)
    X[:3] += env * (y > np.median(y)) * 0.8       # a few interactions
    E = rng.normal(size=(s, n))                    # gene expression rows
    E[:3] += 0.6 * y                               # a few real signals
    W = np.column_stack([np.ones(n), rng.normal(size=(n, n_cvt - 1))])
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    return dict(eval_=w, UtW=U.T @ W, Uty=U.T @ y, Ut_env=U.T @ env,
                Utx=X @ U, Utxe=(X * env) @ U, UtE=E @ U, trace_G=w.mean())


@functools.lru_cache(maxsize=None)
def _reference(kind, n_cvt, mode, dtype=np.float64):
    p = _problem(n_cvt)
    j = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    if kind == "gene":
        return tpu_gene(j["eval_"], j["UtW"], j["Uty"], j["UtE"],
                        n_cvt=n_cvt, mode=mode)
    nf = tpu_fit_null(j["eval_"], j["UtW"], j["Uty"], j["trace_G"], n_cvt)
    return tpu_gxe(j["eval_"], j["UtW"], j["Ut_env"], j["Uty"], j["Utx"],
                   j["Utxe"], nf.l_mle, nf.logl_mle, n_cvt=n_cvt, mode=mode)


def _port(kind, n_cvt, mode, dtype):
    p = _problem(n_cvt)
    t = {k: torch.as_tensor(v, dtype=dtype) for k, v in p.items()}
    if kind == "gene":
        return assoc_gene_block_impl(t["eval_"], t["UtW"], t["Uty"],
                                     t["UtE"], n_cvt=n_cvt, mode=mode)
    nf = fit_null(t["eval_"], t["UtW"], t["Uty"], t["trace_G"], n_cvt)
    return assoc_gxe_block_impl(t["eval_"], t["UtW"], t["Ut_env"], t["Uty"],
                                t["Utx"], t["Utxe"], nf.l_mle, nf.logl_mle,
                                n_cvt=n_cvt, mode=mode)


def _assert_f64_close(a, b):
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


@pytest.mark.parametrize("n_cvt,mode", CASES, ids=IDS)
def test_gxe_modes_match_reference_f64(n_cvt, mode):
    """Per-SNP covariates [W, env, x], the interaction as predictor, the
    per-SNP ML null in modes 2/4 (logl_H0 = 0 in mode 9)."""
    _assert_f64_close(_reference("gxe", n_cvt, mode),
                      _port("gxe", n_cvt, mode, torch.float64))


@pytest.mark.parametrize("n_cvt,mode", CASES, ids=IDS)
def test_gene_modes_match_reference_f64(n_cvt, mode):
    """Per-gene responses, the phenotype the shared predictor, the
    reference's zero-x null per gene."""
    _assert_f64_close(_reference("gene", n_cvt, mode),
                      _port("gene", n_cvt, mode, torch.float64))


@pytest.mark.parametrize("kind", ["gxe", "gene"])
def test_float32_port_within_contract(kind):
    """The port's float32 -lmm 4 against the reference's float64."""
    a = _reference(kind, 1, 4)
    b = _port(kind, 1, 4, torch.float32)
    for f in ("p_wald", "p_lrt", "p_score"):
        pa = np.asarray(getattr(a, f), np.float64)
        pb = getattr(b, f).double().numpy()
        assert getattr(b, f).dtype == torch.float32
        ok = np.isfinite(pa) & np.isfinite(pb)
        assert ok.mean() >= 0.97, f
        assert np.max(np.abs(pa[ok] - pb[ok])) <= 1e-3, f
    if kind == "gene":
        assert not np.isnan(b.p_lrt.numpy()).any()


def test_reference_float32_gene_p_lrt_is_nan_and_port_is_not():
    """The documented fault of the reference (ROADMAP.md §C): in float32
    its per-gene zero-x null fit is NaN, and so is every p_lrt; the
    port's float32 null is the true null, and its p_lrt is finite."""
    ref32 = _reference("gene", 1, 4, np.float32)
    assert np.isnan(np.asarray(ref32.p_lrt)).all()
    port32 = _port("gene", 1, 4, torch.float32)
    assert np.isfinite(port32.p_lrt.numpy()).all()


def test_gene_float32_flat_likelihoods_use_float64_sums():
    """256 genes of noise at n = 300 (the inputs of
    scripts/lane_f32_gap.py): their likelihoods are often flat at small
    λ, where a λ search in float32 sums left p_wald 1.09e-3 from float64.
    Per-lane blocks search in float64 sums from the float32 operands;
    the float32 rounding of the operands then leaves p-values within
    2.2e-6 of the float64 path (held here at 1e-4)."""
    n, s = 300, 256
    rng = np.random.default_rng(0)
    Xk = rng.binomial(2, 0.3, size=(400, n)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / Xk.shape[0]
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    y = rng.normal(size=n)
    rng.integers(0, 2, n)                           # the script's env
    rng.binomial(2, rng.uniform(0.05, 0.5, s)[:, None], size=(s, n))
    E = rng.normal(size=(s, n))
    E[:8] += 0.4 * y
    out = {}
    for dt in (torch.float64, torch.float32):
        t = {k: torch.as_tensor(v, dtype=dt) for k, v in
             dict(eval_=w, UtW=U.T @ np.ones((n, 1)), Uty=U.T @ y,
                  UtE=E @ U).items()}
        out[dt] = assoc_gene_block_impl(t["eval_"], t["UtW"], t["Uty"],
                                        t["UtE"], n_cvt=1, mode=4)
    for f in ("p_wald", "p_lrt", "p_score"):
        a = getattr(out[torch.float64], f).numpy()
        b = getattr(out[torch.float32], f).double().numpy()
        assert np.isfinite(b).all(), f
        assert np.max(np.abs(a - b)) <= 1e-4, f
