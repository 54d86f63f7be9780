"""gemma_torch end to end against gemma_tpu: the same GEMMA flags on the
same BIMBAM and PLINK inputs through both packages' `batch_run`, output
files compared by value.

The port runs on the CPU here (device="cpu"); "auto" precision is then
float64 in both packages (tests/conftest.py turns x64 on for JAX).
Tolerances, float64:
  * kinship files: rel <= 1e-8 (the same sums in another order);
  * assoc.txt: p_wald abs <= 1e-8, the other columns rel <= 1e-6
    relative to max(|value|, 1e-3) — the eigenvectors come from two
    LAPACK drivers and differ in sign and inside degenerate
    eigenspaces, which the statistics are invariant to in exact
    arithmetic; NaN positions identical.
"""

import gzip
import os
import re

import numpy as np
import pytest

from gemma_tpu.cli import parse_args as tpu_parse
from gemma_tpu.run import batch_run as tpu_batch_run
from gemma_torch.cli import parse_args as torch_parse
from gemma_torch.run import batch_run as torch_batch_run
from chip_smoke import _synth_plink

N, P = 120, 300


def _write_bimbam(td, n=N, p=P, seed=0):
    """BIMBAM gz + phenotype as bench.py builds them (3% missing), with
    a heritable phenotype so λ is interior."""
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.05, 0.5, p)
    X = rng.binomial(2, maf[:, None], size=(p, n)).astype(np.int8)
    miss = rng.random((p, n)) < 0.03
    geno = os.path.join(td, "geno.txt.gz")
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for j in range(p):
            vals = np.char.mod("%d", X[j]).astype(object)
            vals[miss[j]] = "NA"
            fh.write(f"rs{j}, A, T, " + ", ".join(vals) + "\n")
    Xc = np.where(miss, np.nan, X.astype(float))
    Xc = np.nan_to_num(Xc - np.nanmean(Xc, axis=1, keepdims=True))
    g = rng.normal(size=p) @ Xc
    y = g / g.std() * 0.7 + rng.normal(size=n) * 0.7
    pheno = os.path.join(td, "pheno.txt")
    with open(pheno, "w") as fh:
        for v in y:
            fh.write(f"{v:.6f}\n")
    return geno, pheno


def _run_both(td, flags):
    for tag, parse, run, extra in (
            ("tpu", tpu_parse, tpu_batch_run, {}),
            ("torch", torch_parse, torch_batch_run, {"device": "cpu"})):
        argv = (flags.format(tag=tag) + f" -outdir {td}").split()
        run(parse(argv), argv=[tag] + argv, **extra)


def _read_assoc(path):
    with open(path) as fh:
        head = fh.readline().split()
        rows = [ln.split() for ln in fh]
    return head, rows


def _assert_assoc_close(a_path, b_path):
    ha, ra = _read_assoc(a_path)
    hb, rb = _read_assoc(b_path)
    assert ha == hb
    assert len(ra) == len(rb) > 0
    for col, name in enumerate(ha):
        va = [r[col] for r in ra]
        vb = [r[col] for r in rb]
        if name in ("chr", "rs", "ps", "n_miss", "allele1", "allele0",
                    "geneID"):
            assert va == vb, name
            continue
        fa = np.array(va, float)
        fb = np.array(vb, float)
        np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb))
        ok = ~np.isnan(fa)
        if name == "p_wald":
            np.testing.assert_allclose(fb[ok], fa[ok], rtol=0, atol=1e-8)
        else:
            scale = np.maximum(np.abs(fa[ok]), 1e-3)
            assert np.max(np.abs(fb[ok] - fa[ok]) / scale) <= 1e-6, name


@pytest.fixture(scope="module")
def bimbam(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("bimbam"))
    return td, _write_bimbam(td)


@pytest.fixture(scope="module")
def plink(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("plink"))
    return td, _synth_plink(td, n=N, p=P)


@pytest.mark.parametrize("gk", [1, 2])
def test_gk_bimbam_matches_reference(bimbam, gk):
    td, (geno, pheno) = bimbam
    _run_both(td, f"-g {geno} -p {pheno} -gk {gk} -o K{gk}_{{tag}}")
    suffix = "cXX" if gk == 1 else "sXX"
    a = np.loadtxt(f"{td}/K{gk}_tpu.{suffix}.txt")
    b = np.loadtxt(f"{td}/K{gk}_torch.{suffix}.txt")
    assert a.shape == (N, N)
    np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("gk", [1, 2])
def test_gk_plink_matches_reference(plink, gk):
    td, (prefix, _) = plink
    _run_both(td, f"-bfile {prefix} -gk {gk} -o P{gk}_{{tag}}")
    suffix = "cXX" if gk == 1 else "sXX"
    a = np.loadtxt(f"{td}/P{gk}_tpu.{suffix}.txt")
    b = np.loadtxt(f"{td}/P{gk}_torch.{suffix}.txt")
    np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-12)


def test_lmm1_bimbam_matches_reference(bimbam):
    td, (geno, pheno) = bimbam
    _run_both(td, f"-g {geno} -p {pheno} -gk 1 -o KL_{{tag}}")
    _run_both(td, f"-g {geno} -p {pheno} -k {td}/KL_tpu.cXX.txt -lmm 1 "
                  "-o A_{tag}")
    _assert_assoc_close(f"{td}/A_tpu.assoc.txt", f"{td}/A_torch.assoc.txt")


def test_lmm1_plink_covariates_matches_reference(plink):
    td, (prefix, cov) = plink
    _run_both(td, f"-bfile {prefix} -gk 2 -o KP_{{tag}}")
    _run_both(td, f"-bfile {prefix} -c {cov} -k {td}/KP_tpu.sXX.txt "
                  "-lmm 1 -o B_{tag}")
    _assert_assoc_close(f"{td}/B_tpu.assoc.txt", f"{td}/B_torch.assoc.txt")


def test_lmm1_float32_port_within_contract(bimbam):
    """The port's float32 speed mode (the card's default) on the CPU,
    against the reference's float64: p_wald abs <= 1e-3 (the speed-mode
    contract), >= 97% finite."""
    td, (geno, pheno) = bimbam
    _run_both(td, f"-g {geno} -p {pheno} -gk 1 -o KF_{{tag}}")
    common = f"-g {geno} -p {pheno} -k {td}/KF_tpu.cXX.txt -lmm 1"
    argv = (common + f" -outdir {td} -o F64").split()
    tpu_batch_run(tpu_parse(argv))
    argv = (common + f" -outdir {td} -o F32 -precision float32").split()
    torch_batch_run(torch_parse(argv), device="cpu")
    h, ra = _read_assoc(f"{td}/F64.assoc.txt")
    _, rb = _read_assoc(f"{td}/F32.assoc.txt")
    col = h.index("p_wald")
    a = np.array([r[col] for r in ra], float)
    b = np.array([r[col] for r in rb], float)
    ok = np.isfinite(a) & np.isfinite(b)
    assert ok.mean() >= 0.97
    assert np.max(np.abs(a[ok] - b[ok])) <= 1e-3


@pytest.mark.parametrize("flags,entry", [
    ("-lmm 1 -debug", 'queue A, "skeleton" (profiling)'),
])
def test_modes_outside_the_slice_raise(bimbam, flags, entry):
    td, (geno, pheno) = bimbam
    flags = flags.format(pheno=pheno)
    argv = (f"-g {geno} -p {pheno} -k {td}/none.txt {flags} -outdir {td}")
    cfg = torch_parse(argv.split())
    cfg.file_kin = ""
    with pytest.raises(NotImplementedError, match=re.escape(entry)):
        torch_batch_run(cfg, device="cpu")


def test_float64_on_cuda_raises_not_implemented():
    """-precision float64 resolves to float64 on cuda too: the parity
    mode runs on the card (K7 and the float64 instantiations)."""
    import torch
    from gemma_torch.precision import resolve_dtype
    assert resolve_dtype("float64", "cuda") == torch.float64
    assert resolve_dtype("auto", "cuda") == torch.float32
    with pytest.raises(ValueError, match="unknown precision"):
        resolve_dtype("float16", "cuda")
