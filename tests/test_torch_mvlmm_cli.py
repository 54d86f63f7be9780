"""The port's multivariate LMM end to end against gemma_tpu: the same
GEMMA flags (`-n 1 2`, with and without `-gxe`) on the same BIMBAM set
through both packages, assoc.txt and the null model's log lines compared
by value.  The port runs on the CPU (its kernels' plain versions); both
read the reference's kinship file.

Tolerances, float64: p-values abs <= 1e-6, beta and Vbeta rel <= 1e-5
relative to max(|value|, 1e-3) (the eigenvectors of the kinship come from
two LAPACK drivers; the statistics are invariant to their signs in exact
arithmetic, and the per-SNP EM stops at |Δlogl| < 1e-3, so a rounding
difference moves a lane's exit by at most one iteration), the log's
numbers rel <= 2e-5 (six significant digits).  The port's float32 speed
mode within 1e-3 of the reference's float64 (the speed-mode contract).
"""

import gzip
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gemma_tpu.cli import parse_args as tpu_parse
from gemma_tpu.run import batch_run as tpu_batch_run
from gemma_torch.cli import parse_args as torch_parse
from gemma_torch.run import batch_run as torch_batch_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, P = 100, 24
P_COLS = ("p_wald", "p_lrt", "p_score")


def _write_set(td, n=N, p=P, seed=5):
    """BIMBAM gz (3% missing), two correlated heritable traits with the
    first SNPs causal for both, and a binary environment."""
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.1, 0.5, p)
    X = rng.binomial(2, maf[:, None], size=(p, n)).astype(np.int8)
    miss = rng.random((p, n)) < 0.03
    geno = os.path.join(td, "geno.txt.gz")
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for j in range(p):
            vals = np.char.mod("%d", X[j]).astype(object)
            vals[miss[j]] = "NA"
            fh.write(f"rs{j}, A, T, " + ", ".join(vals) + "\n")
    Xc = X - X.mean(axis=1, keepdims=True)
    g = rng.normal(size=(2, p)) @ Xc / np.sqrt(p)
    g[1] = 0.5 * g[0] + 0.8 * g[1]
    y = g + rng.normal(size=(2, n)) * 0.8
    y += 0.5 * Xc[:3].sum(0)
    env = rng.integers(0, 2, n)
    y[0] += 0.6 * env * Xc[3]
    pheno = os.path.join(td, "pheno.txt")
    np.savetxt(pheno, y.T, fmt="%.6f")
    np.savetxt(os.path.join(td, "env.txt"), env, fmt="%d")
    return geno, pheno


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's plain versions (see
    tests/test_torch_mvlmm.py); the CLI subprocess gets the same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("mvlmm"))
    geno, pheno = _write_set(td)
    argv = f"-g {geno} -p {pheno} -gk 1 -o K -outdir {td}".split()
    tpu_batch_run(tpu_parse(argv), argv=["tpu"] + argv)
    return td, f"-g {geno} -p {pheno} -k {td}/K.cXX.txt -n 1 2 -outdir {td}"


def _read(path):
    with open(path) as fh:
        head = fh.readline().split()
        rows = [ln.split() for ln in fh]
    return head, rows


def _log_numbers(path):
    """The null model's log lines: name → the numbers on the line."""
    out = {}
    with open(path) as fh:
        for ln in fh:
            m = re.match(r"## (REMLE estimate for V[ge] in the null model|"
                         r"se\(V[ge]\)|REMLE log-likelihood in the null "
                         r"model|MLE log-likelihood in the null model)"
                         r"\s*[:=]\s*(.*)", ln)
            if m:
                out[m.group(1)] = np.array(m.group(2).split(), float)
    return out


def _compare(td, ref, got, p_tol=1e-6, rel=1e-5):
    ha, ra = _read(f"{td}/{ref}.assoc.txt")
    hb, rb = _read(f"{td}/{got}.assoc.txt")
    assert ha == hb
    assert len(ra) == len(rb) > P // 2
    for col, name in enumerate(ha):
        if name in ("chr", "rs", "ps", "n_miss", "allele1", "allele0", "af"):
            assert [r[col] for r in ra] == [r[col] for r in rb], name
            continue
        a = np.array([r[col] for r in ra], float)
        b = np.array([r[col] for r in rb], float)
        assert np.isfinite(a).all() and np.isfinite(b).all(), name
        if name in P_COLS:
            assert np.max(np.abs(a - b)) <= p_tol, name
        elif rel is not None:
            scale = np.maximum(np.abs(a), 1e-3)
            assert np.max(np.abs(a - b) / scale) <= rel, name
    return ha


@pytest.mark.parametrize("flags", ["-lmm 4", "-lmm 4 -gxe {td}/env.txt"],
                         ids=["lmm4", "lmm4-gxe"])
def test_mvlmm_matches_reference(data, flags):
    """`python -m gemma_torch -device cpu ... -n 1 2` against
    gemma_tpu's batch_run: assoc.txt and the null model's log lines."""
    td, common = data
    tag = flags.split()[1] + ("x" if "gxe" in flags else "")
    argv = (common + " " + flags.format(td=td)).split()
    ref = tpu_parse(argv + ["-o", f"R{tag}"])
    tpu_batch_run(ref, argv=["tpu"] + argv)
    r = subprocess.run([sys.executable, "-m", "gemma_torch", "-device", "cpu",
                        *argv, "-o", f"T{tag}"], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    head = _compare(td, f"R{tag}", f"T{tag}")
    assert head[-1] == "p_score"
    la = _log_numbers(f"{td}/R{tag}.log.txt")
    lb = _log_numbers(f"{td}/T{tag}.log.txt")
    assert len(la) == 6 and la.keys() == lb.keys()
    for k in la:
        np.testing.assert_allclose(lb[k], la[k], rtol=2e-5, atol=1e-12,
                                   err_msg=k)


def test_mvlmm_float32_port_within_contract(data):
    """The port's float32 speed mode (its staged EM and Newton finisher)
    against the reference's float64, -lmm 4: every p within 1e-3."""
    td, common = data
    argv = (common + " -lmm 4").split()
    tpu_batch_run(tpu_parse(argv + ["-o", "R32"]), argv=["tpu"] + argv)
    torch_batch_run(torch_parse(argv + ["-o", "T32", "-precision",
                                        "float32"]), device="cpu")
    _compare(td, "R32", "T32", p_tol=1e-3, rel=None)


def test_mvlmm_lmm9_writes_what_the_reference_writes(data):
    """-lmm 9 with several -n runs no test in either package: the same
    columns, zeros."""
    td, common = data
    argv = (common + " -lmm 9").split()
    tpu_batch_run(tpu_parse(argv + ["-o", "R9"]), argv=["tpu"] + argv)
    torch_batch_run(torch_parse(argv + ["-o", "T9"]), device="cpu")
    head = _compare(td, "R9", "T9", p_tol=0.0)
    assert head[-1] == "Vbeta_2_2"


def test_mvlmm_crt_names_its_queue_entry(data):
    """-crt had its queue entry until the port ran it; now -lmm 1 -crt
    writes what the reference writes (tests/test_torch_crt.py holds the
    correction itself)."""
    td, common = data
    argv = (common + " -lmm 1 -crt").split()
    tpu_batch_run(tpu_parse(argv + ["-o", "RC"]), argv=["tpu"] + argv)
    torch_batch_run(torch_parse(argv + ["-o", "C"]), device="cpu")
    _compare(td, "RC", "C")
