"""Windowed SNP correlations (-calccor, -gw) in the port against
gemma_tpu, and K16's plain version.

The port runs on the CPU (its kernels' plain versions) in float64.  The
neighbour counts are integers and equal; the correlations rel <= 1e-10
(the same dot products in another order); the .cor.txt files, printed to
seven significant digits, byte-equal but for correlations that are exact
zeros, which print as rounding noise below 1e-15 in either order.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from gemma_tpu.cli import parse_args as tpu_parse
from gemma_tpu.models import varcov as ref
from gemma_tpu.run import batch_run as tpu_batch_run
from gemma_torch.cli import parse_args as torch_parse
from gemma_torch.models import varcov
from gemma_torch.run import batch_run as torch_batch_run

N, P = 90, 160


def _snps(rng, p=P):
    """Two chromosomes, positions 3 kb apart with gaps, cM along them,
    one SNP of unknown chromosome."""
    chr_ = np.where(np.arange(p) < p // 2, "1", "2").astype(object)
    chr_[5] = "-9"
    pos = np.cumsum(rng.integers(1, 6, p) * 3000)
    cM = pos / 1e6 + rng.uniform(0, 0.02, p)
    return list(chr_), pos, cM


@pytest.mark.parametrize("window", [(1e4, 0, 0), (0, 0.02, 0), (0, 0, 5),
                                    (3e4, 0, 4), (1, 0, 0)],
                         ids=["bp", "cm", "ns", "bp+ns", "bw0"])
def test_calc_neighbours_matches_reference(window):
    chr_, pos, cM = _snps(np.random.default_rng(1))
    got = varcov.calc_neighbours(chr_, pos, cM, *window)
    want = ref.calc_neighbours(chr_, pos, cM, *window)
    np.testing.assert_array_equal(got, want)
    assert (got.max() == 0) == (window == (1, 0, 0))


@pytest.mark.parametrize("window", [(1e4, 0, 0), (1, 0, 0)],
                         ids=["bp", "bw0"])
def test_windowed_correlations_match_reference(window):
    """The streaming block + bw carry over blocks of 16 rows, with NaN
    genotypes and monomorphic rows (normalised by 1, so their
    correlations are 0)."""
    rng = np.random.default_rng(2)
    chr_, pos, cM = _snps(rng)
    X = rng.binomial(2, 0.3, size=(P, N)).astype(float)
    X[rng.random((P, N)) < 0.05] = np.nan
    X[[3, 40, 41]] = 1.0
    n_nb = ref.calc_neighbours(chr_, pos, cM, *window)

    def fetch(lo, hi):
        return X[lo:hi]

    v0, c0 = ref.windowed_correlations_fetch(fetch, P, N, n_nb, block=16)
    v1, c1 = varcov.windowed_correlations_fetch(
        fetch, P, N, n_nb, torch.float64, torch.device("cpu"), block=16)
    np.testing.assert_allclose(v1, v0, rtol=1e-12)
    assert [len(c) for c in c1] == [len(c) for c in c0] == list(n_nb)
    for a, b in zip(c0, c1):
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-14)
    assert all((c1[i] == 0).all() for i in (3, 40, 41))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """BIMBAM gz (3% missing, one monomorphic SNP) with an annotation
    file: two chromosomes, positions 3 kb apart."""
    td = str(tmp_path_factory.mktemp("varcov"))
    rng = np.random.default_rng(3)
    X = rng.binomial(2, rng.uniform(0.05, 0.5, P)[:, None], size=(P, N))
    X[7] = 1
    miss = rng.random((P, N)) < 0.03
    geno = os.path.join(td, "geno.txt.gz")
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for j in range(P):
            vals = np.char.mod("%d", X[j]).astype(object)
            vals[miss[j]] = "NA"
            fh.write(f"rs{j}, A, T, " + ", ".join(vals) + "\n")
    with open(os.path.join(td, "anno.txt"), "w") as fh:
        for j in range(P):
            fh.write(f"rs{j}\t{3000 * (j % (P // 2)) + 1000}\t"
                     f"{1 + j // (P // 2)}\n")
    np.savetxt(os.path.join(td, "pheno.txt"), rng.normal(size=N),
               fmt="%.6f")
    return td, (f"-g {geno} -p {td}/pheno.txt -a {td}/anno.txt "
                f"-outdir {td}")


@pytest.mark.parametrize("flags", ["-calccor", "-gw", "-calccor -windowns 7",
                                   "-calccor -windowbp 20000"])
def test_calccor_cor_txt_equals_reference(data, flags):
    td, common = data
    tag = flags.replace(" ", "").replace("-", "")
    argv = f"{common} {flags}".split()
    tpu_batch_run(tpu_parse(argv + ["-o", f"R{tag}"]))
    torch_batch_run(torch_parse(argv + ["-o", f"T{tag}"]), device="cpu")
    with open(f"{td}/R{tag}.cor.txt") as a:
        want = a.read().split("\n")
    with open(f"{td}/T{tag}.cor.txt") as b:
        got = b.read().split("\n")
    assert len(got) == len(want) > P // 2
    noise = 0
    for la, lb in zip(want, got):
        if la == lb:
            continue
        # an exact zero correlation (two integer-coded rows orthogonal at
        # n = 90) prints as its rounding noise, which depends on the
        # order of the sums: the one place the bytes may differ
        fa, fb = la.split("\t"), lb.split("\t")
        assert fa[:-1] == fb[:-1]
        for u, v in zip(fa[-1].split(","), fb[-1].split(",")):
            if u != v:
                assert abs(float(u)) < 1e-15 and abs(float(v)) < 1e-15
                noise += 1
    assert noise <= 4


@pytest.mark.parametrize("R,S,bw,dtype", [(40, 30, 12, torch.float64),
                                          (25, 25, 30, torch.float32),
                                          (10, 10, 1, torch.float64)])
def test_banded_cor_plain_matches_numpy(R, S, bw, dtype):
    rng = np.random.default_rng(R)
    X = rng.normal(size=(R, 33))
    got = varcov.banded_cor(torch.as_tensor(X, dtype=dtype), S, bw)
    assert got.shape == (S, bw) and got.dtype == dtype
    Xd = torch.as_tensor(X, dtype=dtype).double().numpy()
    want = np.zeros((S, bw))
    for i in range(S):
        for j in range(bw):
            if i + j + 1 < R:
                want[i, j] = Xd[i] @ Xd[i + j + 1]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.double().numpy(), want, rtol=tol,
                               atol=tol)
