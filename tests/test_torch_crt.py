"""The mvLMM's -crt (Edgeworth small-sample correction) in the port
against gemma_tpu: K14's plain version against the reference's calc_crt,
and `-lmm 1/2/4 -n 1 2 -crt` through both packages' batch_run.

The port runs on the CPU (its kernels' plain versions) in float64.
Tolerances: the crt factors rel <= 1e-9 (the same sums in another order:
the port takes every trace from the SNP rows of Q^-1); p-values abs <=
1e-6 (the per-SNP EM stops at |Δlogl| < 1e-3, so a rounding difference
moves a lane's exit by at most one iteration, as in
tests/test_torch_mvlmm_cli.py).
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.cli import parse_args as tpu_parse
from gemma_tpu.models import mvlmm_core as ref_core
from gemma_tpu.run import batch_run as tpu_batch_run
from gemma_torch.cli import parse_args as torch_parse
from gemma_torch.models import mvlmm_core as core
from gemma_torch.run import batch_run as torch_batch_run

N, P = 100, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain mvLMM loops (tests/
    test_torch_mvlmm.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(d, c, n, seed, S=3):
    """Random lanes as tests/test_crt_dense.py makes them: eigenvalues
    (one zero), an intercept and c - 2 covariates, S SNP rows, positive
    definite Vg, Ve and a symmetric Hvar."""
    rng = np.random.default_rng(seed)
    ev = np.abs(rng.gamma(2.0, 1.0, n))
    ev[0] = 0.0
    X0 = np.vstack([np.ones((1, n)), rng.normal(size=(c - 2, n))])
    R = rng.normal(size=(S, 1, n))
    Vg, Ve, H = [], [], []
    for _ in range(S):
        for out in (Vg, Ve):
            A = rng.normal(size=(d, d))
            out.append(A @ A.T / d + 0.3 * np.eye(d))
        Hr = rng.normal(size=(d * (d + 1),) * 2)
        H.append(-(Hr @ Hr.T + 0.5 * np.eye(d * (d + 1))))
    return ev, X0, R, np.array(Vg), np.array(Ve), np.array(H)


@pytest.mark.parametrize("d,c,n,seed", [(2, 2, 12, 0), (2, 3, 10, 1),
                                        (3, 2, 8, 2), (5, 2, 20, 3)])
def test_calc_crt_matches_reference(d, c, n, seed):
    ev, X0, R, Vg, Ve, H = _lanes(d, c, n, seed)
    S = R.shape[0]
    X = np.concatenate([np.broadcast_to(X0, (S,) + X0.shape), R], axis=1)
    want = ref_core.calc_crt(jnp.asarray(ev), jnp.asarray(X),
                             jnp.zeros((d, n)), jnp.asarray(Vg),
                             jnp.asarray(Ve), jnp.asarray(H))
    t = torch.as_tensor
    got = core.calc_crt(t(ev), t(X0), t(R), t(Vg), t(Ve), t(H))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """BIMBAM gz (3% missing), two correlated heritable traits with the
    first SNPs causal, a binary environment, and the reference's -gk."""
    td = str(tmp_path_factory.mktemp("crt"))
    rng = np.random.default_rng(11)
    maf = rng.uniform(0.1, 0.5, P)
    X = rng.binomial(2, maf[:, None], size=(P, N)).astype(np.int8)
    miss = rng.random((P, N)) < 0.03
    geno = os.path.join(td, "geno.txt.gz")
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for j in range(P):
            vals = np.char.mod("%d", X[j]).astype(object)
            vals[miss[j]] = "NA"
            fh.write(f"rs{j}, A, T, " + ", ".join(vals) + "\n")
    Xc = X - X.mean(axis=1, keepdims=True)
    g = rng.normal(size=(2, P)) @ Xc / np.sqrt(P)
    g[1] = 0.5 * g[0] + 0.8 * g[1]
    y = g + rng.normal(size=(2, N)) * 0.8 + 0.3 * Xc[:4].sum(0)
    pheno = os.path.join(td, "pheno.txt")
    np.savetxt(pheno, y.T, fmt="%.6f")
    np.savetxt(os.path.join(td, "env.txt"), rng.integers(0, 2, N), fmt="%d")
    argv = f"-g {geno} -p {pheno} -gk 1 -o K -outdir {td}".split()
    tpu_batch_run(tpu_parse(argv), argv=["tpu"] + argv)
    common = (f"-g {geno} -p {pheno} -k {td}/K.cXX.txt -n 1 2 -pnr 0.9 "
              f"-outdir {td}")
    return td, common, {}


def _port(data, flags, tag):
    td, common, runs = data
    if tag not in runs:
        argv = (common + " " + flags.format(td=td) + f" -o {tag}").split()
        runs[tag] = torch_batch_run(torch_parse(argv), device="cpu")
    return runs[tag]["stats"]


def _read(path):
    with open(path) as fh:
        head = fh.readline().split()
        rows = np.array([ln.split() for ln in fh])
    return {h: rows[:, i] for i, h in enumerate(head)}


@pytest.mark.parametrize("mode", [1, 2, 4])
def test_crt_matches_reference(data, mode):
    """-lmm 1/2/4 -n 1 2 -crt -pnr 0.9: p_wald and p_lrt of both packages
    within 1e-6, and more than half the lanes corrected."""
    td, common, _ = data
    argv = (common + f" -lmm {mode} -crt -o R{mode}").split()
    tpu_batch_run(tpu_parse(argv), argv=["tpu"] + argv)
    got = _port(data, f"-lmm {mode} -crt", f"T{mode}")
    ref = _read(f"{td}/R{mode}.assoc.txt")
    port = _read(f"{td}/T{mode}.assoc.txt")
    assert (ref["rs"] == port["rs"]).all()
    for col in ("p_wald", "p_lrt"):
        if col not in ref:
            continue
        a, b = ref[col].astype(float), port[col].astype(float)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert np.max(np.abs(a - b)) <= 1e-6, col
        assert (got[col] < 0.9).mean() > 0.5


def test_crt_changes_refined_lanes_only(data):
    """Against the same run without -crt: the lanes -pnr refines (p < 0.9
    before the correction; the results' `refined` column, ML then REML)
    take new p-values, the others keep theirs."""
    plain = _port(data, "-lmm 4", "T4plain")
    crt = _port(data, "-lmm 4 -crt", "T4")
    np.testing.assert_array_equal(crt["refined"], plain["refined"])
    for col, fit in (("p_wald", 1), ("p_lrt", 0)):
        refined = plain["refined"][:, fit]
        np.testing.assert_array_equal(refined, plain[col] < 0.9)
        assert refined.any() and (~refined).any()
        assert (crt[col][refined] != plain[col][refined]).all(), col
        assert (crt[col][~refined] == plain[col][~refined]).all(), col


def test_crt_runs_in_float64(data):
    """-crt with -precision float32 runs the float64 analysis (ROADMAP
    §C18): the refit stops at a 1e-3 logl tolerance and the correction
    amplifies where it stops, so float32 operands would part its p_lrt."""
    f32 = _port(data, "-lmm 4 -crt -precision float32", "T4f32")
    f64 = _port(data, "-lmm 4 -crt", "T4")
    for col in ("p_wald", "p_lrt", "p_score", "beta"):
        np.testing.assert_array_equal(f32[col], f64[col])


def test_crt_is_not_read_under_gxe(data):
    """-gxe ... -crt writes what -gxe writes: of the reference's
    association functions only the non-GxE one reads -crt (ROADMAP
    §C17)."""
    gxe = "-lmm 4 -gxe {td}/env.txt"
    plain = _port(data, gxe, "X4")
    crt = _port(data, gxe + " -crt", "X4crt")
    for col in ("p_wald", "p_lrt", "p_score", "beta"):
        np.testing.assert_array_equal(crt[col], plain[col])
