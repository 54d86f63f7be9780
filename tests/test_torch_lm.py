"""The port's linear model (-lm 1/2/3/4, with and without -gene) against
gemma_tpu on the same numpy inputs, and end to end through both
packages' `batch_run` (the port on the CPU, where K8's wrapper takes its
plain version).

Tolerances:
  * lm_block / lm_gene_block, float64: p-values abs 1e-8, beta and se
    rel 1e-9, identical NaN lanes (as tests/test_torch_assoc.py);
  * the port's float32 against the reference's float64: p-values abs
    <= 1e-3 (the speed-mode contract), >= 97% finite.  The port sums in
    float64 and takes the LRT statistic as -n log1p(-r²); the
    reference's float32 n (log yPwy - log yPxy) cancels for null SNPs;
  * assoc.txt files: as tests/test_torch_cli.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.models import lm as tlm
from gemma_torch.models import lm
from test_torch_cli import _assert_assoc_close, _run_both, _write_bimbam

N, S = 300, 64
MODES = [51, 52, 53, 54]


def _problem(n_cvt, n=N, s=S, seed=3):
    rng = np.random.default_rng(seed + n_cvt)
    y = rng.normal(size=n) + 3.0                 # a phenotype off zero
    X = rng.binomial(2, 0.3, size=(s, n)).astype(np.float64)
    X[:4] += (y > np.median(y)) * 0.5            # a few real signals
    W = np.column_stack([np.ones(n), rng.normal(size=(n, n_cvt - 1))])
    return W, y, X


def _compare_f64(a, b):
    for f in a._fields:
        fa = np.asarray(getattr(a, f), np.float64)
        fb = getattr(b, f).numpy()
        assert getattr(b, f).dtype == torch.float64
        np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb), err_msg=f)
        ok = np.isfinite(fa)
        if f.startswith("p_"):
            np.testing.assert_allclose(fb[ok], fa[ok], rtol=0, atol=1e-8,
                                       err_msg=f)
        else:
            np.testing.assert_allclose(fb[ok], fa[ok], rtol=1e-9,
                                       atol=1e-12, err_msg=f)


@pytest.mark.parametrize("n_cvt", [1, 2], ids=["c1", "c2"])
@pytest.mark.parametrize("mode", MODES)
def test_lm_block_matches_reference_f64(mode, n_cvt):
    W, y, X = _problem(n_cvt)
    a = tlm.lm_block(jnp.asarray(W), jnp.asarray(y), jnp.asarray(X),
                     mode=mode)
    b = lm.lm_block(torch.from_numpy(W), torch.from_numpy(y),
                    torch.from_numpy(X), mode=mode)
    _compare_f64(a, b)


@pytest.mark.parametrize("n_cvt", [1, 2], ids=["c1", "c2"])
@pytest.mark.parametrize("mode", [51, 53])
def test_lm_gene_block_matches_reference_f64(mode, n_cvt):
    """Gene mode: the rows are responses, the phenotype the predictor."""
    W, y, X = _problem(n_cvt)
    E = X + np.random.default_rng(9).normal(size=X.shape)
    a = tlm.lm_gene_block(jnp.asarray(W), jnp.asarray(y), jnp.asarray(E),
                          mode=mode)
    b = lm.lm_gene_block(torch.from_numpy(W), torch.from_numpy(y),
                         torch.from_numpy(E), mode=mode)
    _compare_f64(a, b)


@pytest.mark.parametrize("gene", [False, True], ids=["snp", "gene"])
def test_lm_float32_port_within_contract(gene):
    W, y, X = _problem(2)
    fn_t, fn_p = ((tlm.lm_gene_block, lm.lm_gene_block) if gene
                  else (tlm.lm_block, lm.lm_block))
    a = fn_t(jnp.asarray(W), jnp.asarray(y), jnp.asarray(X), mode=54)
    f32 = torch.float32
    b = fn_p(*(torch.as_tensor(v, dtype=f32) for v in (W, y, X)), mode=54)
    for f in ("p_wald", "p_lrt", "p_score"):
        pa = np.asarray(getattr(a, f), np.float64)
        pb = getattr(b, f).double().numpy()
        assert getattr(b, f).dtype == f32
        ok = np.isfinite(pa) & np.isfinite(pb)
        assert ok.mean() >= 0.97, f
        assert np.max(np.abs(pa[ok] - pb[ok])) <= 1e-3, f


def test_lm_tail_plain_is_the_projection_algebra():
    """K8's plain version against the products written out in float64:
    xPwx = x'(I - W(W'W)^-1 W')x and likewise xPwy, yPwy."""
    W, y, X = _problem(2)
    P = np.eye(N) - W @ np.linalg.solve(W.T @ W, W.T)
    xPwx = np.einsum("sn,nm,sm->s", X, P, X)
    xPwy = X @ P @ y
    yPwy = y @ P @ y
    t = lm.lm_tail_plain(torch.from_numpy(X), torch.from_numpy(y),
                         torch.from_numpy(W),
                         lm.lm_consts(torch.from_numpy(W),
                                      torch.from_numpy(y)),
                         gene=False, se_score=True)
    np.testing.assert_allclose(t.beta.numpy(), xPwy / xPwx, rtol=1e-10)
    np.testing.assert_allclose(t.se.numpy(), np.sqrt(yPwy / (N * xPwx)),
                               rtol=1e-10)


@pytest.fixture(scope="module")
def bimbam_gene(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("lm"))
    geno, pheno = _write_bimbam(td)
    y = np.loadtxt(pheno)
    rng = np.random.default_rng(5)
    with open(f"{td}/expr.txt", "w") as fh:
        fh.write("geneID " + " ".join(f"I{i}" for i in range(len(y))) + "\n")
        for g in range(24):
            e = rng.normal(size=len(y)) + (0.5 * y if g < 3 else 0.0)
            fh.write(f"g{g} " + " ".join(f"{v:.6f}" for v in e) + "\n")
    return td, f"-g {geno} -p {pheno}"


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_lm_cli_matches_reference(bimbam_gene, mode):
    td, data = bimbam_gene
    _run_both(td, f"{data} -lm {mode} -o L{mode}_{{tag}}")
    _assert_assoc_close(f"{td}/L{mode}_tpu.assoc.txt",
                        f"{td}/L{mode}_torch.assoc.txt")


@pytest.mark.parametrize("mode", [1, 4])
def test_lm_gene_cli_matches_reference(bimbam_gene, mode):
    td, data = bimbam_gene
    _run_both(td, f"{data} -lm {mode} -gene {td}/expr.txt -o G{mode}_{{tag}}")
    _assert_assoc_close(f"{td}/G{mode}_tpu.assoc.txt",
                        f"{td}/G{mode}_torch.assoc.txt")
