"""gemma_torch's MQS (summary-statistics variance components: -gq, -gs,
-vc 1/2/3 with -beta or -study/-ref and -mstudy/-mref) against
gemma_tpu on the same inputs, made from a seed with numpy.

The port runs on the CPU here (K1 and K15 through their plain
versions), in float64 unless a test says otherwise.  Tolerances:
  * readers: equal;
  * calcq: rtol 1e-12 (the same host numpy);
  * category kinships: rtol 1e-10 of the largest entry (the same sums in
    another order);
  * S and its jackknife: rtol 1e-9 (n S - (n-1) mean d cancels, so the
    summation order shows at ~1e-11; the reference's Svar = (mean d² -
    (mean d)²)(n-1) cancels too, which the port avoids by taking the
    variance in two passes, ROADMAP §C19 — at these n the two forms
    part by up to 6e-11);
  * calc_vc_ss and the files of the CLI runs: rtol 1e-9 (%.10g text);
  * -precision float32 against float64: pve and se_pve 1e-3 abs, the
    speed-mode contract.
"""

import gzip

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu import run as tpu
from gemma_tpu.cli import parse_args as tpu_parse
from gemma_tpu.config import check_param
from gemma_tpu.models import mqs as rmqs
from gemma_tpu.ops.center import center_matrix as r_center
from gemma_tpu.ops.center import scale_matrix as r_scale
from gemma_torch.cli import parse_args as torch_parse
from gemma_torch.models import mqs
from gemma_torch.run import batch_run as torch_batch_run
from gemma_torch.run import read_categories_multi

N, P = 160, 320
N_VC = 3


def _genotypes(n=N, p=P, seed=0, miss=0.03):
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.05, 0.5, p)
    X = rng.binomial(2, maf[:, None], size=(p, n)).astype(float)
    X[rng.random((p, n)) < miss] = np.nan
    return X


def write_mqs_dataset(td, n=N, p=P, h2=0.5, seed=0):
    """BIMBAM genotypes (3% NA), an h² = h2 phenotype, marginal z-scores
    in a -beta file (a1 a0 z n), a -cat file of N_VC categories (a few
    SNPs in none), -wsnp weights, -wcat LD scores and a covariate file
    (intercept + one column).  Returns the paths by name."""
    rng = np.random.default_rng(seed + 100)
    X = _genotypes(n, p, seed)
    Xf = np.where(np.isnan(X), np.nanmean(X, axis=1, keepdims=True), X)
    Xc = Xf - Xf.mean(axis=1, keepdims=True)
    sd = Xc.std(axis=1)
    g = (Xc / sd[:, None]).T @ rng.normal(size=p)
    g = g / g.std() * np.sqrt(h2)
    y = g + rng.normal(0, np.sqrt(1 - h2), n)
    z = (Xc / sd[:, None]) @ (y - y.mean()) / (y.std() * np.sqrt(n))
    f = {k: f"{td}/{k}.txt" for k in
         ("geno", "pheno", "beta", "cat", "wsnp", "wcat", "cov")}
    with open(f["geno"], "w") as fh:
        for j in range(p):
            vals = ["NA" if np.isnan(v) else f"{v:g}" for v in X[j]]
            fh.write(f"rs{j}, A, T, " + ", ".join(vals) + "\n")
    np.savetxt(f["pheno"], y, fmt="%.6f")
    with open(f["beta"], "w") as fh:
        fh.write("rs\ta1\ta0\tz\tn\n")
        for j in range(p):
            fh.write(f"rs{j}\tA\tT\t{z[j]:.6f}\t{n}\n")
    cat = rng.integers(0, N_VC, p)
    with open(f["cat"], "w") as fh:
        fh.write("SNP\t" + "\t".join(f"c{k}" for k in range(N_VC)) + "\n")
        for j in range(p):
            row = ["0"] * N_VC
            if j % 41 != 7:                        # a few SNPs in none
                row[cat[j]] = "1"
            fh.write(f"rs{j}\t" + "\t".join(row) + "\n")
    with open(f["wsnp"], "w") as fh:
        for j in range(p):
            fh.write(f"rs{j}\t{rng.uniform(0.5, 2.0):.6f}\n")
    with open(f["wcat"], "w") as fh:
        fh.write("SNP\t" + "\t".join(f"c{k}" for k in range(N_VC)) + "\n")
        for j in range(p):
            fh.write(f"rs{j}\t" + "\t".join(
                f"{v:.4f}" for v in rng.uniform(1, 50, N_VC)) + "\n")
    np.savetxt(f["cov"], np.column_stack([np.ones(n), rng.normal(size=n)]),
               fmt="%.6f")
    return f


def tpu_run(cfg):
    """The reference's run of cfg, returning what its run_* returns (its
    batch_run returns nothing)."""
    check_param(cfg)
    if cfg.a_mode in (61, 62, 63):
        if cfg.file_study or cfg.file_mstudy:
            return tpu.run_vc_study_ref(cfg)
        return tpu.run_vc_summary(cfg)
    if cfg.a_mode in (66, 67):
        return tpu.run_ci(cfg)
    return tpu.batch_run(cfg)


def run_both(td, flags):
    """The same flags through both packages; returns (reference, port)."""
    argv = (flags.format(tag="tpu") + f" -outdir {td}").split()
    a = tpu_run(tpu_parse(argv))
    argv = (flags.format(tag="torch") + f" -outdir {td}").split()
    return a, torch_batch_run(torch_parse(argv), device="cpu")


def assert_files_close(td, a, b, suffixes, rtol=1e-9):
    for sfx in suffixes:
        if sfx.endswith(".gz"):
            with gzip.open(f"{td}/{a}.{sfx}", "rt") as fa, \
                    gzip.open(f"{td}/{b}.{sfx}", "rt") as fb:
                assert fa.read() == fb.read(), sfx
            continue
        x = np.loadtxt(f"{td}/{a}.{sfx}")
        y = np.loadtxt(f"{td}/{b}.{sfx}")
        assert x.shape == y.shape, sfx
        np.testing.assert_allclose(y, x, rtol=rtol, atol=1e-300,
                                   err_msg=sfx)


def assert_result_close(a, b, rtol=1e-9):
    for name in ("pve", "se_pve", "sigma2persnp", "se_sigma2persnp",
                 "enrich", "se_enrich"):
        np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                   rtol=rtol, err_msg=name)
    np.testing.assert_allclose(b.pve_total, a.pve_total, rtol=rtol)
    np.testing.assert_allclose(b.se_pve_total, a.se_pve_total, rtol=rtol)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("mqs"))
    return td, write_mqs_dataset(td)


# ---------------------------------------------------------------------------
# readers

@pytest.mark.parametrize("header,row", [
    ("rs\tz\tn", "2.0\t100"),
    ("rs\tbeta\tse\tn", "0.4\t0.2\t50"),
    ("rs\tchisq\tn_mis\tn_obs", "3.5\t4\t96"),
    ("snp\tp\tncase\tncontrol", "0.01\t60\t70"),
    ("chr\tps\tZ\tN", "-1.5\t80"),
], ids=["z_n", "beta_se", "chisq_nmis_nobs", "p_case_control",
        "chr_pos"])
def test_read_beta_summary_matches_reference(tmp_path, header, row):
    f = tmp_path / "beta.txt"
    lead = "1\t100" if header.startswith("chr") else "rsA"
    lead2 = "1\t200" if header.startswith("chr") else "rsB"
    f.write_text(f"{header}\n{lead}\t{row}\n{lead2}\t{row}\n")
    assert mqs.parse_header(header) == rmqs.parse_header(header)
    a = rmqs.read_beta_summary(str(f))
    b = mqs.read_beta_summary(str(f))
    for name in ("cat", "ni", "weight", "z2"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert (b.rs, b.ni_total, b.ns_total, b.ns_test) == \
        (a.rs, a.ni_total, a.ns_total, a.ns_test)


def test_category_readers_match_reference(data, tmp_path):
    td, f = data
    assert mqs.read_categories(f["cat"]) == rmqs.read_categories(f["cat"])
    # -mcat: a second file re-assigning some SNPs (first occurrence wins)
    cat2 = tmp_path / "cat2.txt"
    with open(cat2, "w") as fh:
        fh.write("rs\tchr\tx0\tx1\tx2\tx3\n")
        for j in range(0, P, 3):
            fh.write(f"rs{j}\t1\t0\t0\t0\t1\n")
    mcat = tmp_path / "mcat.txt"
    mcat.write_text(f"{f['cat']}\n{cat2}\n")
    cfg_a = tpu_parse(["-mcat", str(mcat), "-gq"])
    cfg_b = torch_parse(["-mcat", str(mcat), "-gq"])
    assert read_categories_multi(cfg_b) == tpu.read_categories_multi(cfg_a)


# ---------------------------------------------------------------------------
# host and device pieces

@pytest.mark.parametrize("n_block", [10, 200])
def test_calcq_matches_reference(n_block):
    rng = np.random.default_rng(5)
    m = 400
    cat = rng.integers(0, N_VC, m)
    ni = rng.integers(80, 120, m)
    weight = rng.uniform(0.5, 2.0, m)
    z2 = rng.chisquare(1, m) * 1.3
    a = rmqs.calcq(n_block, cat, ni, weight, z2, N_VC)
    b = mqs.calcq(n_block, cat, ni, weight, z2, N_VC)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_cvt", [1, 3])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_category_kinship_matches_reference(n_cvt, weighted):
    rng = np.random.default_rng(7 + n_cvt)
    n, p = 120, 300
    X = _genotypes(n, p, seed=n_cvt, miss=0.05)
    X[4] = 1.0                                     # monomorphic: dropped
    W = np.column_stack([np.ones(n), rng.normal(size=(n, n_cvt - 1))])
    cats = rng.integers(-1, N_VC, p)
    w = rng.uniform(0.5, 2.0, p) if weighted else None
    Ka, nsa = rmqs.category_kinship(X, W, cats, N_VC, w)
    Kb, nsb = mqs.category_kinship(X, W, cats, N_VC, w, device="cpu")
    np.testing.assert_array_equal(nsb, nsa)
    np.testing.assert_allclose(Kb.numpy(), Ka, rtol=0,
                               atol=1e-10 * np.abs(Ka).max())


@pytest.mark.parametrize("weights_a", [False, True], ids=["A=K", "A!=K"])
def test_calc_s_matches_reference(weights_a):
    """calc_s end to end: the kinship stacks, centring and scaling, S and
    its jackknife Svar (weights_a builds -vc 2's separately weighted A)."""
    rng = np.random.default_rng(11)
    n, p = 100, 240
    X = _genotypes(n, p, seed=11, miss=0.03)
    W = np.column_stack([np.ones(n), rng.normal(size=n)])
    cats = rng.integers(0, N_VC, p)
    w = rng.uniform(0.5, 2.0, p)
    wa = rng.uniform(0.5, 2.0, p) if weights_a else None
    a = rmqs.calc_s(X, W, cats, N_VC, w, wa)
    b = mqs.calc_s(X, W, cats, N_VC, w, wa, device="cpu")
    np.testing.assert_array_equal(b[2], a[2])
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(y, x, rtol=1e-9, atol=1e-12 * abs(x).max())


def _stack(rng, m, n):
    B = rng.normal(size=(m, n, 40))
    K = B @ B.transpose(0, 2, 1) / 40
    return np.stack([np.asarray(r_scale(r_center(jnp.asarray(k))))
                     for k in K])


@pytest.mark.parametrize("n_vc", [1, 3, 9])
@pytest.mark.parametrize("n_cvt", [1, 2])
@pytest.mark.parametrize("same", [True, False], ids=["A=K", "A!=K"])
def test_ak_to_s_matches_reference(n_vc, n_cvt, same):
    """compAKtoS and JackknifeAKtoS from one pass of the pair column
    sums (n_vc 9 makes K15's wrapper take two chunks on the card)."""
    rng = np.random.default_rng(n_vc)
    n = 90
    K = _stack(rng, n_vc, n)
    A = K if same else _stack(rng, n_vc, n)
    S = rmqs.comp_ak_to_s(A, K, n_cvt)
    S_ref, Svar_ref = rmqs.jackknife_ak_to_s(A, K, n_cvt, S)
    Kt = torch.as_tensor(K)
    At = Kt if same else torch.as_tensor(A)
    np.testing.assert_allclose(mqs.comp_ak_to_s(At, Kt, n_cvt), S,
                               rtol=1e-9)
    S_b, Svar_b = mqs.ak_to_s(At, Kt, n_cvt)
    np.testing.assert_allclose(S_b, S_ref, rtol=1e-9)
    np.testing.assert_allclose(Svar_b, Svar_ref, rtol=1e-9)


def test_calc_vc_ss_matches_reference():
    rng = np.random.default_rng(9)
    m = N_VC
    B = rng.normal(size=(m, m))
    S = B @ B.T + m * np.eye(m)
    Svar = np.abs(rng.normal(size=(m, m))) * 1e-2
    Vq = np.cov(rng.normal(size=(m, 20))) * 1e-3
    q = rng.uniform(0.1, 0.3, m)
    s = rng.integers(50, 150, m).astype(float)
    assert_result_close(rmqs.calc_vc_ss(Vq, S, Svar, q, s, 300.0),
                        mqs.calc_vc_ss(Vq, S, Svar, q, s, 300.0))


# ---------------------------------------------------------------------------
# the CLI end to end

_CASES = {
    "gq": ("-beta {beta} -cat {cat} -gq 1", ("Vq.txt", "q.txt",
                                              "size.txt")),
    "gs": ("-g {geno} -p {pheno} -cat {cat} -wsnp {wsnp} -gs 1",
           ("S.txt", "size.txt", "snps.txt.gz")),
    "gs_cov": ("-g {geno} -p {pheno} -c {cov} -gs 1",
               ("S.txt", "size.txt", "snps.txt.gz")),
    "vc1_beta": ("-g {geno} -p {pheno} -beta {beta} -cat {cat} -wsnp {wsnp} "
                 "-vc 1", ("S.txt", "Vq.txt", "q.txt", "size.txt")),
    "vc2_beta": ("-g {geno} -p {pheno} -beta {beta} -cat {cat} -wcat {wcat} "
                 "-c {cov} -vc 2", ("S.txt", "Vq.txt", "q.txt", "size.txt")),
    "vc3_beta": ("-g {geno} -p {pheno} -beta {beta} -vc 3",
                 ("S.txt", "Vq.txt", "q.txt", "size.txt")),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_cli_matches_reference(data, case):
    td, f = data
    flags, suffixes = _CASES[case]
    a, b = run_both(td, flags.format(**f) + f" -o {case}_{{tag}}")
    assert_files_close(td, f"{case}_tpu", f"{case}_torch", suffixes)
    if case.startswith("vc"):
        assert_result_close(a, b)


@pytest.fixture(scope="module")
def study_ref(data):
    """-gq and -gs files of both packages, with -cat."""
    td, f = data
    run_both(td, f"-beta {f['beta']} -cat {f['cat']} -gq 1 -o Q_{{tag}}")
    run_both(td, f"-g {f['geno']} -p {f['pheno']} -cat {f['cat']} -gs 1 "
                 "-o G_{tag}")
    for tag in ("tpu", "torch"):
        with open(f"{td}/mstudy_{tag}.txt", "w") as fh:
            fh.write(f"{td}/Q_{tag}\n{td}/Q_{tag}\n")
        with open(f"{td}/mref_{tag}.txt", "w") as fh:
            fh.write(f"{td}/G_{tag}\n")
    return td


@pytest.mark.parametrize("flags", [
    "-study {td}/Q_{{tag}} -ref {td}/G_{{tag}}",
    "-mstudy {td}/mstudy_{{tag}}.txt -mref {td}/mref_{{tag}}.txt",
], ids=["study_ref", "mstudy_mref"])
def test_vc_study_ref_matches_reference(study_ref, flags):
    td = study_ref
    a, b = run_both(td, flags.format(td=td) + " -vc 1 -o SR_{tag}")
    assert_files_close(td, "SR_tpu", "SR_torch",
                       ("S.txt", "Vq.txt", "q.txt", "size.txt"))
    assert_result_close(a, b)


@pytest.mark.parametrize("writer", ["tpu", "torch"])
def test_study_ref_files_cross_packages(study_ref, writer):
    """Each package's -vc -study/-ref reads the other's -gq/-gs files."""
    td = study_ref
    flags = f"-study {td}/Q_{writer} -ref {td}/G_{writer} -vc 1"
    argv = (flags + f" -outdir {td} -o X_{writer}_tpu").split()
    a = tpu_run(tpu_parse(argv))
    argv = (flags + f" -outdir {td} -o X_{writer}_torch").split()
    b = torch_batch_run(torch_parse(argv), device="cpu")
    assert_result_close(a, b)
    # and the two packages' files give the same estimate
    other = "torch" if writer == "tpu" else "tpu"
    argv = (f"-study {td}/Q_{other} -ref {td}/G_{other} -vc 1 -outdir {td} "
            f"-o Y_{writer}").split()
    c = torch_batch_run(torch_parse(argv), device="cpu")
    assert_result_close(b, c)


def test_float32_within_contract(data):
    """-vc 1 -beta in the speed mode's precision (float32 genotype
    blocks and kinship stacks; float64 from the finished stacks on),
    on the CPU, against float64: pve and se_pve within 1e-3."""
    td, f = data
    base = (f"-g {f['geno']} -p {f['pheno']} -beta {f['beta']} "
            f"-cat {f['cat']} -vc 1 -outdir {td}")
    r64 = torch_batch_run(torch_parse((base + " -o F64").split()),
                          device="cpu")
    r32 = torch_batch_run(torch_parse(
        (base + " -o F32 -precision float32").split()), device="cpu")
    assert np.max(np.abs(r32.pve - r64.pve)) <= 1e-3
    assert np.max(np.abs(r32.se_pve - r64.se_pve)) <= 1e-3
    assert not np.array_equal(r32.pve, r64.pve)    # float32 did run
