"""gemma_torch's -lmm 2/3/4/9, -eigen, -u/-d, -lmm 5 and -widv end to end
against gemma_tpu: the same flags on the same BIMBAM input through both
packages' `batch_run`, output files compared by value (the port on the
CPU, float64 in both).

Tolerances, float64: assoc.txt as in test_torch_cli.py (p_wald abs
1e-8, other columns rel 1e-6 of max(|value|, 1e-3), NaN positions
identical); eigenvalues and residuals abs 1e-9 of their largest
magnitude.  Eigenvectors are compared only through the statistics
computed from them: two LAPACK routines differ in sign and inside
degenerate eigenspaces.
"""

import numpy as np
import pytest

from test_torch_cli import _assert_assoc_close, _run_both, _write_bimbam


@pytest.fixture(scope="module")
def bimbam_k(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("modes"))
    geno, pheno = _write_bimbam(td)
    _run_both(td, f"-g {geno} -p {pheno} -gk 1 -o K_{{tag}}")
    return td, f"-g {geno} -p {pheno}", f"{td}/K_tpu.cXX.txt"


@pytest.mark.parametrize("mode", [2, 3, 4, 9])
def test_lmm_modes_bimbam_match_reference(bimbam_k, mode):
    td, data, kin = bimbam_k
    _run_both(td, f"{data} -k {kin} -lmm {mode} -o A{mode}_{{tag}}")
    _assert_assoc_close(f"{td}/A{mode}_tpu.assoc.txt",
                        f"{td}/A{mode}_torch.assoc.txt")


def test_eigen_then_ud_lmm9_match_reference(bimbam_k):
    td, data, kin = bimbam_k
    _run_both(td, f"{data} -k {kin} -eigen -o E_{{tag}}")
    a = np.loadtxt(f"{td}/E_tpu.eigenD.txt")
    b = np.loadtxt(f"{td}/E_torch.eigenD.txt")
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9 * np.abs(a).max())
    U = np.loadtxt(f"{td}/E_torch.eigenU.txt")
    np.testing.assert_allclose(U.T @ U, np.eye(len(b)), atol=1e-8)
    # each package reads its own eigen files
    _run_both(td, f"{data} -u {td}/E_{{tag}}.eigenU.txt "
                  f"-d {td}/E_{{tag}}.eigenD.txt -lmm 9 -o U_{{tag}}")
    _assert_assoc_close(f"{td}/U_tpu.assoc.txt", f"{td}/U_torch.assoc.txt")


def test_lmm5_residuals_match_reference(bimbam_k):
    td, data, kin = bimbam_k
    _run_both(td, f"{data} -k {kin} -lmm 5 -o R_{{tag}}")
    for name in ("residU", "residE"):
        a = np.loadtxt(f"{td}/R_tpu.{name}.txt")
        b = np.loadtxt(f"{td}/R_torch.{name}.txt")
        assert a.shape == (120,)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-9 * np.abs(a).max())


def test_widv_lmm2_matches_reference(bimbam_k):
    """Residual weights, one of them zero (its row and column of K drop
    out, gemma.cpp:2599-2644)."""
    td, data, kin = bimbam_k
    w = np.random.default_rng(3).uniform(0.5, 2.0, 120)
    w[7] = 0.0
    np.savetxt(f"{td}/w.txt", w)
    _run_both(td, f"{data} -k {kin} -widv {td}/w.txt -lmm 2 -o W_{{tag}}")
    _assert_assoc_close(f"{td}/W_tpu.assoc.txt", f"{td}/W_torch.assoc.txt")
