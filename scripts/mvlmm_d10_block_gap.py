"""How far the ten-trait mvLMM path's p-values move with rounding alone:
the size of the float64 path's chaos at the boundary (ROADMAP §C20),
next to chip_smoke's 1e-3 limit for that path against the CPU.

    python3 scripts/mvlmm_d10_block_gap.py         # on a machine with the card
    python3 scripts/mvlmm_d10_block_gap.py --cpu   # on the CPU alone

Data: chip_smoke.py's phase (f) and (k) sets (`_synth_mv`), the kinship
from `-gk`, ten traits, 12 covariates, `-lmm 4 -crt -pnr 0.9` as phase
(k) runs it.

On the card: the first 16 SNPs in a block of their own twice (the run's
reproducibility) and inside the first 256 SNPs (a SNP's rotation in
another block), with the null fit unchanged; and, in a spawned process
meanwhile, the CPU's float64 run of the 16 SNPs on the card's kinship
with chip_smoke's thread count (`_cpu_path`), against which chip_smoke's
`check_wide_d10` holds the 256-SNP run.  One JSON line with the largest
p gaps over the 16 SNPs for each pair, whether the EM iteration counts
and the null fits agree, then the card's name and power limit; each
run's p-values and EM iteration counts in build/d10_block_gap/lanes.json.

With --cpu: the 16 SNPs' float64 run on the CPU at 1, 2, 4 and 8 torch
threads (the library splits its sums by thread), one JSON line with
each run's largest p gaps against the 4-thread run's.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.cli import parse_args  # noqa: E402
from gemma_torch.run import batch_run  # noqa: E402

M = cs.WIDE_MV_CHECK


def _gap(x, y):
    """Largest |Δp| over the first M SNPs, per column, and whether the
    EM iteration counts agree."""
    out = {c: float(np.abs(x["stats"][c][:M] - y["stats"][c][:M]).max())
           for c in cs.P_COLS}
    out["em_iters_equal"] = bool(
        (x["stats"]["em_iters"][:M] == y["stats"]["em_iters"][:M]).all())
    return out


def _lanes(r):
    return {**{c: r["stats"][c][:M].tolist() for c in cs.P_COLS},
            "em_iters": r["stats"]["em_iters"][:M].tolist()}


def main():
    cpu = "--cpu" in sys.argv[1:]
    dev = "cpu" if cpu else "cuda"
    td = os.path.join(kernels.REPO_ROOT, "build", "d10_block_gap")
    os.makedirs(td, exist_ok=True)
    cs._synth_mv(td)
    base = f"-g {td}/mv_geno.txt.gz -outdir {td} -no-check".split()
    cs._run(base + f"-p {td}/mv_pheno.txt -gk 1 -o MK".split(), dev)
    argv = (base + f"-k {td}/MK.cXX.txt -p {td}/mv_pheno10.txt -c "
            f"{td}/mv_cov12.txt -crt -pnr 0.9 -lmm 4 -n".split()
            + [str(i) for i in range(1, cs.WIDE_TRAITS + 1)])
    first = ["-snps", f"{td}/mv_wide_first.snps"]

    def run(snps, tag, threads=None):
        a = argv + snps + ["-o", tag, "-silence"]
        if threads:
            torch.set_num_threads(threads)
        t0 = time.time()
        r = batch_run(parse_args(a), argv=["gemma_torch"] + a, device=dev)
        if not cpu:
            torch.cuda.synchronize()
        print(json.dumps({"run": tag, "seconds": time.time() - t0}),
              flush=True)
        return r

    if cpu:
        runs = {t: run(first, f"T{t}", t) for t in (1, 2, 4, 8)}
        print(json.dumps({f"threads_{t}_vs_4": _gap(r, runs[4])
                          for t, r in runs.items() if t != 4}), flush=True)
        return
    pool, w = cs._start_cpu(argv + first + ["-o", "CPU"])
    a = run(first, "A")
    b = run(first, "B")
    c = run(["-snps", f"{td}/mv_256.snps"], "C")
    ref = w.get()
    pool.close()
    pool.join()
    null_eq = bool(torch.equal(a["null"].Vg_mle, c["null"].Vg_mle)
                   and torch.equal(a["null"].Vg_remle, c["null"].Vg_remle))
    print(json.dumps({"same_block_twice": _gap(a, b),
                      "own_block_vs_256": {**_gap(a, c),
                                           "null_equal": null_eq},
                      "256_vs_cpu": _gap(c, ref),
                      "own_block_vs_cpu": _gap(a, ref)}), flush=True)
    with open(os.path.join(td, "lanes.json"), "w") as fh:
        json.dump({"own": _lanes(a), "256": _lanes(c), "cpu": _lanes(ref)},
                  fh)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
