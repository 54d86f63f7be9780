"""gemma_torch's -lmm 2/3/4/9, -eigen, -u/-d, -lmm 5, -widv, LOCO,
-ksnps/-gwasnps, -gxe and -gene end to end against gemma_tpu: the same flags on the same BIMBAM input through both
packages' `batch_run`, output files compared by value (the port on the
CPU, float64 in both).

Tolerances, float64: assoc.txt as in test_torch_cli.py (p_wald abs
1e-8, other columns rel 1e-6 of max(|value|, 1e-3), NaN positions
identical); eigenvalues and residuals abs 1e-9 of their largest
magnitude.  Eigenvectors are compared only through the statistics
computed from them: two LAPACK routines differ in sign and inside
degenerate eigenspaces.
"""

import gzip
import re

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


@pytest.fixture(scope="module")
def extra_files(bimbam_k):
    """Annotation (3 chromosomes), -ksnps / -gwasnps lists, a binary
    environment with one missing value, an expression matrix with a few
    genes tied to the phenotype, and a copy of the genotypes with every
    other SNP recoded 2 - x (mean > 1: GxE's minor-allele flip)."""
    td, data, kin = bimbam_k
    rng = np.random.default_rng(8)
    with open(f"{td}/anno.txt", "w") as fh:
        for j in range(300):
            fh.write(f"rs{j}\t{100 * j}\t{j % 3 + 1}\n")
    with open(f"{td}/ksnps.txt", "w") as fh:
        fh.write("".join(f"rs{j}\n" for j in range(0, 300, 2)))
    with open(f"{td}/gwasnps.txt", "w") as fh:
        fh.write("".join(f"rs{j}\n" for j in range(1, 300, 5)))
    env = rng.integers(0, 2, 120).astype(object)
    env[17] = "NA"
    with open(f"{td}/env.txt", "w") as fh:
        fh.write("".join(f"{v}\n" for v in env))
    y = np.loadtxt(data.split()[3])
    with open(f"{td}/expr.txt", "w") as fh:
        fh.write("geneID " + " ".join(f"I{i}" for i in range(120)) + "\n")
        for g in range(16):
            e = rng.normal(size=120) + (0.5 * y if g < 3 else 0.0)
            fh.write(f"g{g} " + " ".join(f"{v:.6f}" for v in e) + "\n")
    geno = data.split()[1]
    with gzip.open(geno, "rt") as src, \
            gzip.open(f"{td}/flip.txt.gz", "wt") as dst:
        for j, line in enumerate(src):
            parts = [p.strip() for p in line.split(",")]
            if j % 2:
                parts[3:] = [p if p == "NA" else str(2 - int(p))
                             for p in parts[3:]]
            dst.write(", ".join(parts) + "\n")
    return td


def test_loco_gk_and_lmm1_match_reference(bimbam_k, extra_files):
    """-loco 2 -a: K from the other chromosomes' SNPs, the test on
    chromosome 2's SNPs only (param.cpp LOCO_set_Snps)."""
    td, data, _ = bimbam_k
    anno = f"-a {td}/anno.txt -loco 2"
    _run_both(td, f"{data} {anno} -gk 1 -o KL_{{tag}}")
    a = np.loadtxt(f"{td}/KL_tpu.cXX.txt")
    b = np.loadtxt(f"{td}/KL_torch.cXX.txt")
    np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-12)
    assert not np.allclose(a, np.loadtxt(f"{td}/K_tpu.cXX.txt"))
    _run_both(td, f"{data} {anno} -k {td}/KL_tpu.cXX.txt -lmm 1 "
                  "-o AL_{tag}")
    _assert_assoc_close(f"{td}/AL_tpu.assoc.txt", f"{td}/AL_torch.assoc.txt")
    with open(f"{td}/AL_torch.assoc.txt") as fh:
        next(fh)
        chrs = {ln.split()[0] for ln in fh}
    assert chrs == {"2"}


def test_ksnps_gwasnps_match_reference(bimbam_k, extra_files):
    td, data, _ = bimbam_k
    _run_both(td, f"{data} -ksnps {td}/ksnps.txt -gk 1 -o KS_{{tag}}")
    a = np.loadtxt(f"{td}/KS_tpu.cXX.txt")
    b = np.loadtxt(f"{td}/KS_torch.cXX.txt")
    np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-12)
    _run_both(td, f"{data} -gwasnps {td}/gwasnps.txt -k {td}/KS_tpu.cXX.txt "
                  "-lmm 2 -o GW_{tag}")
    _assert_assoc_close(f"{td}/GW_tpu.assoc.txt", f"{td}/GW_torch.assoc.txt")
    with open(f"{td}/GW_torch.assoc.txt") as fh:
        next(fh)
        rs = [ln.split()[1] for ln in fh]
    assert 0 < len(rs) <= 60 and all(int(r[2:]) % 5 == 1 for r in rs)


@pytest.mark.parametrize("flags,match", [
    ("-loco 2 -gk 1", "annotation"),
    ("-loco 2 -a {td}/anno.txt -gxe {td}/env.txt -lmm 1", "GXE"),
    ("-loco 2 -a {td}/anno.txt -ksnps {td}/ksnps.txt -gk 1", "-ksnps"),
])
def test_loco_rules_raise(bimbam_k, extra_files, flags, match):
    """GEMMA's LOCO rules (param.cpp; config.py check_param)."""
    from gemma_torch.cli import parse_args
    from gemma_torch.run import batch_run
    td, data, _ = bimbam_k
    argv = f"{data} {flags.format(td=td)} -outdir {td} -o R".split()
    with pytest.raises(ValueError, match=re.escape(match)):
        batch_run(parse_args(argv), device="cpu")


def test_gxe_lmm4_matches_reference(bimbam_k, extra_files):
    """-gxe: per-SNP covariates [W, env, x], half the SNPs recoded so the
    minor-allele flip and beta's sign restore run, one individual
    dropped for its missing environment value."""
    td, data, kin = bimbam_k
    pheno = data.split()[3]
    _run_both(td, f"-g {td}/flip.txt.gz -p {pheno} -k {kin} -lmm 4 "
                  f"-gxe {td}/env.txt -o X_{{tag}}")
    _assert_assoc_close(f"{td}/X_tpu.assoc.txt", f"{td}/X_torch.assoc.txt")


def test_gene_lmm2_matches_reference(bimbam_k, extra_files):
    td, data, kin = bimbam_k
    _run_both(td, f"{data} -k {kin} -lmm 2 -gene {td}/expr.txt "
                  "-o G_{tag}")
    _assert_assoc_close(f"{td}/G_tpu.assoc.txt", f"{td}/G_torch.assoc.txt")
