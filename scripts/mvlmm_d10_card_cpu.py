"""The mvLMM at ten traits: the card's float64 run against the CPU's.

    python3 scripts/mvlmm_d10_card_cpu.py [snps]

On a machine with the card.  It builds chip_smoke.py's phase (f)/(k)
data (the releases.org protocol shape, n = 757, 10,775 SNPs; ten traits
made as phase (f)'s two, equicorrelated: genetic 0.5, environmental 0.3;
an intercept and 11 seeded normal covariates), the -gk 1 kinship on the
card, and runs `-lmm 4 -n 1 ... 10 -c` (float64: ROADMAP §C20) on the
first `snps` SNPs (default 16) on the card and with -device cpu.  The two
differ in their eigendecompositions (cuSOLVER, LAPACK) and rounding
only.  It prints the card's name and power limit, max |Δp| of p_wald,
p_lrt and p_score and the share of lanes whose REML and ML EMs left at
the same iteration, and the seconds of each run.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

P_COLS = ("p_wald", "p_lrt", "p_score")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("mvlmm_d10_card_cpu: no CUDA device")
    snps = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as td:
        chip_smoke._synth_mv(td)
        base = f"-g {td}/mv_geno.txt.gz -outdir {td} -no-check".split()
        chip_smoke._run(base + f"-p {td}/mv_pheno.txt -gk 1 -o MK".split(),
                        "cuda")
        with open(f"{td}/first.snps", "w") as fh:
            fh.write("\n".join(f"rs{j}" for j in range(snps)) + "\n")
        argv = base + (f"-p {td}/mv_pheno10.txt -k {td}/MK.cXX.txt -c "
                       f"{td}/mv_cov12.txt -snps {td}/first.snps -lmm 4 "
                       "-n").split() + [str(i) for i in range(1, 11)]
        secs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.time()
            chip_smoke._run(argv + ["-o", dev], dev)
            secs[dev] = time.time() - t0
        a, b = (chip_smoke.RESULTS[t]["stats"] for t in ("cuda", "cpu"))
        out = {c: float(np.max(np.abs(a[c] - b[c]))) for c in P_COLS}
        out["same_iters_ml_reml"] = (a["em_iters"] == b["em_iters"]).mean(
            0).tolist()
        print({"snps": snps, **out, "seconds": secs})


if __name__ == "__main__":
    main()
