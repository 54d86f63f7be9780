"""Variance components from kinships (-vc 1/2/3, with -k or -mk) in the
port against gemma_tpu's run_vc, and K15's plain version.

The port runs on the CPU (its kernels' plain versions) in float64, from
the same command line parsed by each package.  Tolerances, float64: HE
rel <= 1e-8 (closed form: the same products in another order); REML and
ACL rel <= 1e-6 (their loops stop at a 1e-3 residual, so rounding moves
the last iterate a little).  The port's float32 pve within 1e-3 abs of
its float64 (the speed-mode contract).
"""

import gzip
import os

import numpy as np
import pytest
import torch

from gemma_tpu.cli import parse_args as tpu_parse
from gemma_tpu.run import run_vc as tpu_run_vc
from gemma_torch.cli import parse_args as torch_parse
from gemma_torch.models.vc import pair_colsum
from gemma_torch.run import batch_run as torch_batch_run

N, P = 160, 600
FIELDS = ("pve", "se_pve", "sigma2", "se_sigma2")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A BIMBAM set (3% missing), a covariate, two kinships from the two
    halves of the SNPs (-k is the first, -mk lists both) and a phenotype
    with a polygenic part on each half."""
    td = str(tmp_path_factory.mktemp("vc"))
    rng = np.random.default_rng(21)
    X = rng.binomial(2, rng.uniform(0.05, 0.5, P)[:, None],
                     size=(P, N)).astype(float)
    miss = rng.random((P, N)) < 0.03
    geno = os.path.join(td, "geno.txt.gz")
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for j in range(P):
            vals = np.char.mod("%d", X[j]).astype(object)
            vals[miss[j]] = "NA"
            fh.write(f"rs{j}, A, T, " + ", ".join(vals) + "\n")
    Xc = X - X.mean(1, keepdims=True)
    halves = (Xc[:P // 2], Xc[P // 2:])
    paths = []
    for i, h in enumerate(halves):
        paths.append(os.path.join(td, f"K{i}.cXX.txt"))
        np.savetxt(paths[-1], h.T @ h / h.shape[0], fmt="%.10g",
                   delimiter="\t")
    with open(os.path.join(td, "mk.txt"), "w") as fh:
        fh.write("\n".join(paths) + "\n")
    cov = rng.normal(size=N)
    np.savetxt(os.path.join(td, "cov.txt"),
               np.column_stack([np.ones(N), cov]), fmt="%.6f")
    g = [h.T @ rng.normal(size=h.shape[0]) for h in halves]
    y = (0.6 * g[0] / g[0].std() + 0.4 * g[1] / g[1].std()
         + 0.3 * cov + 0.7 * rng.normal(size=N))
    np.savetxt(os.path.join(td, "pheno.txt"), y, fmt="%.6f")
    return td, (f"-g {geno} -p {td}/pheno.txt -c {td}/cov.txt "
                f"-outdir {td}")


def _kin(td, which):
    return f"-k {td}/K0.cXX.txt" if which == "k" else f"-mk {td}/mk.txt"


def _port(td, common, flags, which, tag, extra=""):
    argv = f"{common} {_kin(td, which)} {flags} -o {tag} {extra}".split()
    return torch_batch_run(torch_parse(argv), device="cpu")


@pytest.mark.parametrize("flags,which,rtol", [
    ("-vc 1", "k", 1e-8), ("-vc 2", "k", 1e-6), ("-vc 3", "k", 1e-6),
    ("-vc 1", "mk", 1e-8), ("-vc 2", "mk", 1e-6), ("-vc 3", "mk", 1e-6),
    ("-vc 2 -noconstrain", "k", 1e-6)])
def test_vc_matches_reference(data, flags, which, rtol):
    td, common = data
    tag = flags.replace(" ", "").replace("-", "") + which
    argv = f"{common} {_kin(td, which)} {flags} -o R{tag}".split()
    want = tpu_run_vc(tpu_parse(argv))
    got = _port(td, common, flags, which, f"T{tag}")
    m = 1 if which == "k" else 2
    assert got.pve.shape == (m,) and got.sigma2.shape == (m + 1,)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol, err_msg=f)
    np.testing.assert_allclose(got.pve_total, want.pve_total, rtol=rtol)
    np.testing.assert_allclose(got.se_pve_total, want.se_pve_total,
                               rtol=rtol)
    with open(f"{td}/T{tag}.log.txt") as fh:
        assert "## pve estimates =" in fh.read()


@pytest.mark.parametrize("flags", ["-vc 1", "-vc 2", "-vc 3"])
def test_vc_float32_within_contract(data, flags):
    """The speed mode's pve (float32 operands and products, float64 pair
    sums) within 1e-3 of the parity mode's, -mk of two kinships."""
    td, common = data
    tag = flags.replace(" ", "").replace("-", "")
    f64 = _port(td, common, flags, "mk", f"D{tag}")
    f32 = _port(td, common, flags, "mk", f"S{tag}", "-precision float32")
    assert np.max(np.abs(f32.pve - f64.pve)) <= 1e-3
    assert abs(f32.pve_total - f64.pve_total) <= 1e-3


@pytest.mark.parametrize("ma,mb,n,dtype", [(2, 3, 17, torch.float64),
                                           (3, 1, 12, torch.float32)])
def test_pair_colsum_plain_matches_numpy(ma, mb, n, dtype):
    rng = np.random.default_rng(ma * 10 + mb)
    A = rng.normal(size=(ma, n, n))
    B = rng.normal(size=(mb, n, n))
    got = pair_colsum(torch.as_tensor(A, dtype=dtype),
                      torch.as_tensor(B, dtype=dtype))
    assert got.dtype == torch.float64 and got.shape == (ma, mb, n)
    want = np.einsum("ist,jst->ijt", A.astype(np.float32).astype(float)
                     if dtype == torch.float32 else A,
                     B.astype(np.float32).astype(float)
                     if dtype == torch.float32 else B)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
