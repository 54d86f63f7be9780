"""The ten-trait mvLMM lanes of chip_smoke.py phase (k), on the CPU: where
their null fits lie and how far one ulp moves the EM from there.

    python3 scripts/mvlmm_d10_boundary.py [workdir]

It builds phase (f)/(k)'s data (the releases.org protocol shape, n = 757,
10,775 SNPs; ten equicorrelated traits, an intercept and 11 seeded normal
covariates; chip_smoke._synth_mv), the -gk 1 kinship and the port's null
fit of `-lmm 4 -n 1 ... 10 -c` in float64 with -device cpu, and prints
the eigenvalues of the REML and ML nulls' Vg and Ve.  Then, on the first
64 SNPs' lanes from the path's start (the ML null), the plain K9
(mph_em_plain) capped at 1, 2, 3, 10 and 30 iterations (prec 0), REML and
ML, against itself from Y, or from Vg and Ve, moved by one ulp (each entry
times 1 ± 2^-52): max relative gaps in Vg and Ve and in logl.  The data
and kinship are kept in `workdir` (default: a temporary directory).
About 4 minutes on 8 cores.
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from gemma_torch.models import mvlmm_core as mvc  # noqa: E402


def main(td):
    if not os.path.exists(f"{td}/MK.cXX.txt"):
        chip_smoke._synth_mv(td)
        chip_smoke._run(f"-g {td}/mv_geno.txt.gz -outdir {td} -no-check "
                        f"-p {td}/mv_pheno.txt -gk 1 -o MK".split(), "cpu")
    argv = (f"-g {td}/mv_geno.txt.gz -p {td}/mv_pheno10.txt -outdir {td} "
            f"-no-check -k {td}/MK.cXX.txt -c {td}/mv_cov12.txt -snps "
            f"{td}/mv_256.snps -lmm 4 -n").split() + [str(i)
                                                       for i in range(1, 11)]
    f64 = torch.float64
    o = chip_smoke._mv_operands(argv, np.arange(64), torch.device("cpu"),
                                (f64,))[f64]
    nul = o["null"]
    for fit in ("remle", "mle"):
        for m in ("Vg", "Ve"):
            w = torch.linalg.eigvalsh(getattr(nul, f"{m}_{fit}"))
            print(f"{fit} {m} eigenvalues:", np.array2string(
                w.numpy(), precision=3, max_line_width=200))
    V, E, B = nul.Vg_start[None], nul.Ve_start[None], nul.B_start[None]
    ev, X0, Y, R = o["ev"], o["X0"], o["Y"], o["R1"]
    rng = np.random.default_rng(0)

    def ulp(t):
        return t * (1 + torch.finfo(f64).eps * torch.as_tensor(
            rng.choice([-1.0, 1.0], size=t.shape)))

    def gaps(a, b):
        return (max(chip_smoke._mrel(a.Vg, b.Vg), chip_smoke._mrel(a.Ve, b.Ve)),
                chip_smoke._mrel(a.logl, b.logl))

    for reml in (True, False):
        for it in (1, 2, 3, 10, 30):
            a = mvc.mph_em_plain(reml, it, 0.0, ev, X0, Y, R, V, E, B)
            y = gaps(mvc.mph_em_plain(reml, it, 0.0, ev, X0, ulp(Y), R, V,
                                      E, B), a)
            v = gaps(mvc.mph_em_plain(reml, it, 0.0, ev, X0, Y, R, ulp(V),
                                      ulp(E), B), a)
            print({"fit": "reml" if reml else "ml", "iterations": it,
                   "Y_ulp_VgVe_rel": y[0], "Y_ulp_logl_rel": y[1],
                   "VgVe_ulp_VgVe_rel": v[0], "VgVe_ulp_logl_rel": v[1]})


if __name__ == "__main__":
    torch.set_num_threads(os.cpu_count() or 1)
    if len(sys.argv) > 1:
        os.makedirs(sys.argv[1], exist_ok=True)
        main(sys.argv[1])
    else:
        with tempfile.TemporaryDirectory() as d:
            main(d)
