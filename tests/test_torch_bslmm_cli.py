"""The port's BSLMM and prediction modes end to end against gemma_tpu: the
same GEMMA flags on the same BIMBAM files through the port on the CPU
and the reference's batch_run, output files compared by value.
`-bslmm 1` and `-bslmm 4` go through `python -m gemma_torch -device cpu`
in a subprocess, the other modes through the port's batch_run in this
process.

Tolerances: -bslmm 2 (.param.txt, .bv.txt), -bslmm 4 (.bf.txt,
.hyp.txt), -bslmm 5 with and without -cat, -predict 1/2 from the same
-epm/-ebv files and -predict 3 (one and two phenotypes): rel 1e-8 (both
compute in float64 and write six or seven significant digits, so the
files are equal but for a last digit rounded the other way).  -bslmm 1's
chain cannot equal the reference's (its random stream is the port's own,
ROADMAP §C6): the log's initial h, rho, pi and |gamma| rel 1e-8, and the
files' shapes equal.  The reference's MCMC runs in a subprocess: its
chain program is the largest XLA:CPU compile in the suite (see
tests/test_predict_varcov.py).
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
N, P = 200, 150


def _write_set(td, n=N, p=P, seed=11):
    """BIMBAM gz (2% missing dosages), two heritable phenotypes (three
    causal SNPs and a polygenic part), 10% of each NA."""
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.1, 0.5, p)
    X = rng.binomial(2, maf[:, None], size=(p, n)).astype(np.int8)
    miss = rng.random((p, n)) < 0.02
    geno = os.path.join(td, "geno.txt.gz")
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for j in range(p):
            vals = np.char.mod("%d", X[j]).astype(object)
            vals[miss[j]] = "NA"
            fh.write(f"rs{j}, A, T, " + ", ".join(vals) + "\n")
    Xc = X - X.mean(axis=1, keepdims=True)
    poly = rng.normal(size=(2, p)) @ Xc / np.sqrt(p)
    y = 0.6 * Xc[[3, 40, 90]].sum(0) + 0.7 * poly + rng.normal(size=(2, n))
    y[1] = 0.5 * y[0] + y[1]
    cols = np.char.mod("%.6f", y.T).astype(object)
    cols[rng.random((n, 2)) < 0.10] = "NA"
    pheno = os.path.join(td, "pheno.txt")
    with open(pheno, "w") as fh:
        fh.write("".join("\t".join(r) + "\n" for r in cols))
    return geno, pheno


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("bslmm"))
    geno, pheno = _write_set(td)
    argv = f"-g {geno} -p {pheno} -gk 1 -o K -outdir {td}".split()
    tpu_batch_run(tpu_parse(argv), argv=["tpu"] + argv)
    return td, f"-g {geno} -p {pheno} -outdir {td}"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's plain versions (see
    tests/test_torch_mvlmm.py); the CLI subprocesses get the same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(argv, cli=False):
    """The port on the CPU: `python -m gemma_torch -device cpu` with
    `cli`, else its batch_run in this process."""
    if not cli:
        torch_batch_run(torch_parse(argv), argv=["torch"] + argv,
                        device="cpu")
        return
    r = subprocess.run([sys.executable, "-m", "gemma_torch", "-device",
                        "cpu", *argv], capture_output=True, text=True,
                       cwd=REPO, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]


def _ref(argv):
    tpu_batch_run(tpu_parse(argv), argv=["tpu"] + argv)


def _table(path, skip_cols=0):
    """(header, text columns, float matrix) of a tab file; NA → NaN."""
    with open(path) as fh:
        rows = [ln.split() for ln in fh]
    head, body = rows[0], rows[1:]
    text = [r[:skip_cols] for r in body]
    vals = np.array([[np.nan if v == "NA" else float(v)
                      for v in r[skip_cols:]] for r in body])
    return head, text, vals


def _same(a_path, b_path, skip_cols=0, header=True, rel=1e-8):
    if header:
        ha, ta, va = _table(a_path, skip_cols)
        hb, tb, vb = _table(b_path, skip_cols)
        assert ha == hb and ta == tb
    else:
        va = np.genfromtxt(a_path, missing_values="NA")
        vb = np.genfromtxt(b_path, missing_values="NA")
    assert va.shape == vb.shape and va.size
    nan = np.isnan(va)
    assert (nan == np.isnan(vb)).all()
    scale = np.maximum(np.abs(va[~nan]), 1e-300)
    assert np.max(np.abs(va[~nan] - vb[~nan]) / scale) <= rel, (a_path,)


def test_bslmm2_gblup_matches_reference(data):
    td, common = data
    argv = (common + f" -k {td}/K.cXX.txt -bslmm 2").split()
    _ref(argv + ["-o", "R2"])
    _port(argv + ["-o", "T2"])
    _same(f"{td}/R2.param.txt", f"{td}/T2.param.txt", skip_cols=4)
    _same(f"{td}/R2.bv.txt", f"{td}/T2.bv.txt", header=False)


@pytest.fixture(scope="module")
def dap(data):
    """-bslmm 4 through both packages, and a -bf file in the reader's
    `rs block BF...` layout from the reference's table (four blocks)."""
    td, common = data
    argv = (common + " -bslmm 4 -hmin 0.1 -hmax 0.9 -rmin 0.1 "
            "-rmax 0.9").split()
    _ref(argv + ["-o", "R4"])
    _port(argv + ["-o", "T4"], cli=True)
    _, text, BF = _table(f"{td}/R4.bf.txt", skip_cols=4)
    with open(f"{td}/bf_in.txt", "w") as fh:
        fh.write("rs\tblock\t" + "\t".join(f"BF{i}" for i in
                                            range(BF.shape[1])) + "\n")
        for i, (row, t) in enumerate(zip(BF, text)):
            fh.write(f"{t[1]}\tb{i // 40}\t"
                     + "\t".join(f"{v:.6e}" for v in row) + "\n")
    rng = np.random.default_rng(3)
    with open(f"{td}/cat.txt", "w") as fh:
        fh.write("rs\tcoding\tscore_c\n")
        for t in text:
            fh.write(f"{t[1]}\t{int(rng.random() < 0.3)}\t"
                     f"{rng.normal():.4f}\n")
    return td


def test_bslmm4_bayes_factors_match_reference(dap):
    td = dap
    _same(f"{td}/R4.bf.txt", f"{td}/T4.bf.txt", skip_cols=4)
    _same(f"{td}/R4.hyp.txt", f"{td}/T4.hyp.txt")


@pytest.mark.parametrize("cat", [False, True], ids=["plain", "cat"])
def test_bslmm5_dap_em_matches_reference(dap, cat):
    td = dap
    argv = (f"-bslmm 5 -hyp {td}/R4.hyp.txt -bf {td}/bf_in.txt "
            f"-outdir {td}").split()
    if cat:
        argv += ["-cat", f"{td}/cat.txt"]
    tag = "c" if cat else ""
    _ref(argv + ["-o", f"R5{tag}"])
    _port(argv + ["-o", f"T5{tag}"])
    _same(f"{td}/R5{tag}.hyp.txt", f"{td}/T5{tag}.hyp.txt")
    _same(f"{td}/R5{tag}.gamma.txt", f"{td}/T5{tag}.gamma.txt",
          skip_cols=1)
    _same(f"{td}/R5{tag}.coef.txt", f"{td}/T5{tag}.coef.txt")


@pytest.mark.parametrize("mode", [1, 2], ids=["predict1", "predict2"])
def test_predict_matches_reference(data, mode):
    """-predict 1 with -epm, -ebv and -k (breeding values propagated by
    the kinship) and -predict 2 (probit) with -epm and -emu, both from the
    reference's -bslmm 2 files."""
    td, common = data
    _ref((common + f" -k {td}/K.cXX.txt -bslmm 2 -o G").split())
    argv = (common + f" -epm {td}/G.param.txt -predict {mode}").split()
    if mode == 1:
        argv += f"-ebv {td}/G.bv.txt -k {td}/K.cXX.txt".split()
    else:
        argv += f"-emu {td}/G.log.txt".split()
    _ref(argv + ["-o", f"RP{mode}"])
    _port(argv + ["-o", f"TP{mode}"])
    _same(f"{td}/RP{mode}.prdt.txt", f"{td}/TP{mode}.prdt.txt",
          header=False)


@pytest.mark.parametrize("n_ph", [1, 2], ids=["d1", "d2"])
def test_predict3_matches_reference(data, n_ph):
    td, common = data
    argv = (common + f" -k {td}/K.cXX.txt -predict 3 -n "
            + " ".join(str(i + 1) for i in range(n_ph))).split()
    _ref(argv + ["-o", f"R3{n_ph}"])
    _port(argv + ["-o", f"T3{n_ph}"])
    _same(f"{td}/R3{n_ph}.prdt.txt", f"{td}/T3{n_ph}.prdt.txt",
          header=False)


def _mcmc_log(path):
    out = {}
    with open(path) as fh:
        for ln in fh:
            m = re.match(r"## initial value of (h|rho|pi|\|gamma\|) = (.*)",
                         ln)
            if m:
                out[m.group(1)] = float(m.group(2))
    return out


def test_bslmm1_initial_values_and_file_shapes(data):
    """-bslmm 1: the same initial state from the same ranking, and files
    of the same shape; the chains themselves differ (ROADMAP §C6)."""
    td, common = data
    argv = (common + " -bslmm 1 -w 20 -s 40 -rpace 2 -smax 30 -seed 4 "
            "-precision float64").split()
    r = subprocess.run([sys.executable, "-m", "gemma_tpu", *argv, "-o",
                        "R1"], capture_output=True, text=True, cwd=REPO,
                       timeout=900, env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-2000:]
    _port(argv + ["-o", "T1"], cli=True)
    la, lb = _mcmc_log(f"{td}/R1.log.txt"), _mcmc_log(f"{td}/T1.log.txt")
    assert len(la) == 4 and la.keys() == lb.keys()
    for k in la:
        np.testing.assert_allclose(lb[k], la[k], rtol=1e-8, err_msg=k)
    for suffix, skip in (("hyp", 0), ("param", 4)):
        ha, ta, va = _table(f"{td}/R1.{suffix}.txt", skip)
        hb, tb, vb = _table(f"{td}/T1.{suffix}.txt", skip)
        assert ha == hb and ta == tb and va.shape == vb.shape
        assert np.isfinite(vb).all()
    assert va.shape[0] > 0.9 * P
    assert _table(f"{td}/T1.hyp.txt")[2].shape == (20, 6)
    ga = np.loadtxt(f"{td}/R1.gamma.txt", skiprows=1, ndmin=2)
    gb = np.loadtxt(f"{td}/T1.gamma.txt", skiprows=1, ndmin=2)
    assert ga.shape == gb.shape == (20, 30)
    assert np.loadtxt(f"{td}/T1.bv.txt", dtype=str).shape == (N,)


@pytest.mark.parametrize("flags, entry", [
    # -crt runs now; -debug, which the port does not trap yet, still raises
    ("-n 1 2 -lmm 1 -crt -debug", 'queue A, "skeleton" (profiling)'),
    # -vc from kinships runs now; from summary statistics it still raises
    ("-vc 1 -beta {td}/K.cXX.txt", 'queue A, "summary statistics"'),
], ids=["crt", "vc"])
def test_modes_still_outside_the_port_name_their_queue(data, flags, entry):
    td, common = data
    flags = flags.format(td=td)
    cfg = torch_parse((common + f" -k {td}/K.cXX.txt {flags} -o X").split())
    with pytest.raises(NotImplementedError, match=re.escape(entry)):
        torch_batch_run(cfg, device="cpu")


def test_bslmm4_default_grid_is_refused(data):
    """-bslmm 4's default h range ends at h = 1, where the grid's sigma_a2
    divides by 1 - h: the reference raises ZeroDivisionError, the port a
    ValueError naming -hmax (ROADMAP §C13)."""
    td, common = data
    argv = (common + " -bslmm 4 -o D").split()
    with pytest.raises(ZeroDivisionError):
        _ref(argv)
    with pytest.raises(ValueError, match="-hmax"):
        torch_batch_run(torch_parse(argv), device="cpu")
