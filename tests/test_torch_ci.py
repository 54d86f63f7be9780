"""gemma_torch's -ci 1/2 (MQS confidence intervals) against gemma_tpu on
the same inputs, made from a seed with numpy: the readers and weight
plumbing (equal), K1's standardised genotypes, the genotype passes,
CalcCIss and the CLI end to end (rtol 1e-9, float64; the port on the
CPU), the speed-mode precision (se_pve within 1e-3 of float64) and the
reference's errors.
"""

import numpy as np
import pytest
import torch

from gemma_tpu.cli import parse_args as tpu_parse
from gemma_tpu.models import ci as rci
from gemma_torch.cli import parse_args as torch_parse
from gemma_torch.models import ci
from gemma_torch.run import batch_run as torch_batch_run
from test_torch_mqs import (N, N_VC, P, _genotypes, assert_result_close,
                            run_both, tpu_run, write_mqs_dataset)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The MQS dataset, both packages' -gs reference panels (with -cat)
    and an -mref list of the port's."""
    td = str(tmp_path_factory.mktemp("ci"))
    f = write_mqs_dataset(td, seed=1)
    run_both(td, f"-g {f['geno']} -p {f['pheno']} -cat {f['cat']} -gs 1 "
                 "-o ref_{tag}")
    run_both(td, f"-g {f['geno']} -p {f['pheno']} -gs 1 -o ref1_{{tag}}")
    with open(f"{td}/mref.txt", "w") as fh:
        fh.write(f"{td}/ref_torch\n{td}/ref_tpu\n")
    return td, f


# ---------------------------------------------------------------------------
# readers and weights

def test_weight_readers_match_reference(data):
    td, f = data
    assert ci.read_wsnp(f["wsnp"]) == rci.read_wsnp(f["wsnp"])
    a, b = rci.read_wcat(f["wcat"], N_VC), ci.read_wcat(f["wcat"], N_VC)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
    with pytest.raises(ValueError, match="column count"):
        ci.read_wcat(f["wcat"], N_VC + 1)


@pytest.mark.parametrize("form", ["z", "beta_se"])
def test_signed_beta_readers_match_reference(tmp_path, form):
    rng = np.random.default_rng(2)
    f = tmp_path / "beta.txt"
    with open(f, "w") as fh:
        if form == "z":
            fh.write("rs\ta1\ta0\tz\tn\n")
            for j in range(30):
                fh.write(f"rs{j}\tA\tT\t{rng.normal():.5f}\t100\n")
        else:
            fh.write("chr\tps\tbeta\tse\n")
            for j in range(30):
                fh.write(f"1\t{j}\t{rng.normal():.5f}\t"
                         f"{rng.uniform(0.1, 1):.5f}\n")
    keep = {"rs3", "rs7", "1:3", "1:7"}
    for k in (None, keep):
        assert ci.read_signed_beta(str(f), k) == \
            rci.read_signed_beta(str(f), k)
    assert ci.read_beta_rs_set(str(f)) == rci.read_beta_rs_set(str(f))


def test_missing_z_is_refused(tmp_path):
    f = tmp_path / "beta.txt"
    f.write_text("rs\tn\nrs1\t100\n")
    for mod in (ci, rci):
        with pytest.raises(ValueError, match="missing z"):
            mod.read_signed_beta(str(f))


def test_ref_study_readers_match_reference(data):
    td, f = data
    run_both(td, f"-beta {f['beta']} -cat {f['cat']} -gq 1 -o q_{{tag}}")
    with open(f"{td}/mstudy.txt", "w") as fh:
        fh.write(f"{td}/q_torch\n{td}/q_tpu\n")
    for fn, arg in ((ci.read_ref, f"{td}/ref_torch"),
                    (ci.read_mref, f"{td}/mref.txt"),
                    (ci.read_study, f"{td}/q_torch"),
                    (ci.read_mstudy, f"{td}/mstudy.txt")):
        a, b = getattr(rci, fn.__name__)(arg), fn(arg)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("wsnp,wcat,cat", [
    (False, False, False), (True, False, True), (True, True, True),
    (False, True, False)])
def test_weight_plumbing_matches_reference(data, wsnp, wcat, cat):
    td, f = data
    from gemma_tpu.models.mqs import read_categories
    rs = [f"rs{j}" for j in range(P)]
    rs2cat, n_vc = read_categories(f["cat"]) if cat else (None, 1)
    rs2w = rci.read_wsnp(f["wsnp"]) if wsnp else None
    rs2wc = rci.read_wcat(f["wcat"], N_VC) if wcat else None
    if wcat and not cat:
        rs2wc = {k: v[:1] for k, v in rs2wc.items()}
    beta_set = set(rs[5:])
    wK = ci.obtain_weight(rs, beta_set, rs2cat, rs2w, rs2wc)
    assert wK == pytest.approx(
        rci.obtain_weight(rs, beta_set, rs2cat, rs2w, rs2wc), rel=1e-15)
    ns = np.array([40.0, 70.0, 90.0])[:n_vc]
    pve = np.array([0.2, 1.3, -0.1])[:n_vc]
    for flag in (0, 1):
        wA = ci.update_weight(flag, wK, N, ns, pve, rs2cat, rs2wc)
        assert wA == pytest.approx(rci.update_weight(
            flag, wK, N, ns, pve, rs2cat, rs2wc), rel=1e-14)
    a_minor = np.array(["A" if j % 5 else "T" for j in range(P)], object)
    rs2z = {r: 0.1 * j - 3 for j, r in enumerate(rs)}
    rs2a1 = {r: "A" for r in rs}
    qc = np.arange(P) % 7 != 3
    a = rci.update_snp_z(np.array(rs, object), a_minor, qc, wA, rs2a1,
                         rs2z, rs2cat)
    b = ci.update_snp_z(np.array(rs, object), a_minor, qc, wA, rs2a1,
                        rs2z, rs2cat)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)


# ---------------------------------------------------------------------------
# genotype passes and CalcCIss

def test_standardized_genotypes_match_reference():
    X = _genotypes(90, 120, seed=4, miss=0.05)
    X[3] = 1.0                                  # var 0: not scaled
    a = rci.standardized_genotypes(X)
    b = ci.standardized_genotypes(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def passes():
    rng = np.random.default_rng(6)
    p, n = 150, 100
    X = _genotypes(n, p, seed=6)
    w = rng.uniform(0.2, 2.0, p)
    z = rng.normal(size=p) * 1.5
    cat = rng.integers(0, N_VC, p)
    return X, w, z, cat


def test_xwz_passes_match_reference(passes):
    X, w, z, cat = passes
    p, n = X.shape
    a = rci.xwz_passes(rci.standardized_genotypes(X), w, z, cat, N_VC)
    Xt = torch.as_tensor(X)
    b = ci.xwz_passes(ci.standardized_genotypes(Xt), w, z, cat, N_VC)
    c = ci.xwz_passes_fetch(lambda lo, hi: Xt[lo:hi], p, n, w, z, cat,
                            N_VC, block=64, device="cpu")
    for x, y, yf in zip(a, b, c):
        np.testing.assert_allclose(y, x, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(yf, x, rtol=1e-9, atol=1e-12)


def test_calc_ci_ss_matches_reference(passes):
    X, w, z, cat = passes
    Xz, XWz, XtXWz = rci.xwz_passes(rci.standardized_genotypes(X), w, z,
                                    cat, N_VC)
    rng = np.random.default_rng(8)
    B = rng.normal(size=(N_VC, N_VC))
    S = B @ B.T + N_VC * np.eye(N_VC)
    Svar = np.abs(rng.normal(size=(N_VC, N_VC))) * 1e-2
    s_vec = np.bincount(cat, minlength=N_VC).astype(float)
    pve = np.array([0.1, 0.25, 0.05])
    args = (Xz, XWz, XtXWz, S, Svar, w, z, s_vec, cat, pve)
    assert_result_close(rci.calc_ci_ss(*args), ci.calc_ci_ss(*args))


# ---------------------------------------------------------------------------
# the CLI end to end

@pytest.mark.parametrize("flags", [
    "-ref {td}/ref1_{{tag}} -pve 0.4 -ci 1",
    "-ref {td}/ref_{{tag}} -cat {cat} -pve 0.1 0.2 0.15 -ci 1",
    "-ref {td}/ref_{{tag}} -cat {cat} -wcat {wcat} -pve 0.1 0.2 0.15 -ci 2",
    "-mref {td}/mref.txt -cat {cat} -wsnp {wsnp} -wcat {wcat} "
    "-pve 0.1 0.2 0.15 -ci 2",
], ids=["ci1", "ci1_cat", "ci2_cat_wcat", "ci2_mref_wsnp"])
def test_ci_cli_matches_reference(data, flags):
    td, f = data
    base = f"-g {f['geno']} -p {f['pheno']} -beta {f['beta']} "
    a, b = run_both(td, base + flags.format(td=td, **f) + " -o ci_{tag}")
    assert_result_close(a, b)
    assert np.all(np.isfinite(b.se_pve)) and np.all(b.se_pve > 0)


def test_ci_float32_within_contract(data):
    """-ci 2 in the speed mode's precision on the CPU against float64:
    se_pve within 1e-3."""
    td, f = data
    base = (f"-g {f['geno']} -p {f['pheno']} -beta {f['beta']} "
            f"-ref {td}/ref_torch -cat {f['cat']} -wcat {f['wcat']} "
            f"-pve 0.1 0.2 0.15 -ci 2 -outdir {td}")
    r64 = torch_batch_run(torch_parse((base + " -o C64").split()),
                          device="cpu")
    r32 = torch_batch_run(torch_parse(
        (base + " -o C32 -precision float32").split()), device="cpu")
    assert np.max(np.abs(r32.se_pve - r64.se_pve)) <= 1e-3
    assert not np.array_equal(r32.se_pve, r64.se_pve)


@pytest.mark.parametrize("flags,match", [
    ("-ref {td}/ref1_{{tag}} -pve 0.3 -ci 2", "wcat"),
    ("-ref {td}/ref_{{tag}} -cat {cat} -pve 0.3 0.2 -ci 1", "-pve"),
], ids=["ci2_without_wcat", "pve_of_wrong_length"])
def test_ci_errors_match_reference(data, flags, match):
    td, f = data
    base = f"-g {f['geno']} -p {f['pheno']} -beta {f['beta']} "
    flags = base + flags.format(td=td, **f) + f" -outdir {td} -o bad_{{tag}}"
    with pytest.raises(ValueError, match=match):
        tpu_run(tpu_parse(flags.format(tag="tpu").split()))
    with pytest.raises(ValueError, match=match):
        torch_batch_run(torch_parse(flags.format(tag="torch").split()),
                        device="cpu")
