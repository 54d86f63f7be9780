"""The reference's (gemma_tpu's) own mvLMM -crt p-values from float32
against float64, on the CPU: the second reading behind ROADMAP.md §C18,
beside the port's on the card (scripts/crt_f32_gap.py).

    JAX_PLATFORMS=cpu python3 scripts/crt_ref_f32_gap.py [--snps 1024]

It builds chip_smoke.py's phase (f) data (the releases.org protocol
shape: n = 757, two traits) and runs `python -m gemma_tpu` on the first
`--snps` SNPs: the kinship, then `-lmm 4 -n 1 2 -pnr 0.9` with and
without `-crt`, each with `-precision float32` and `-precision float64`,
every run in a process of its own (float64 switches JAX's x64 mode on).
It prints, for p_wald and p_lrt over all the SNPs: how many have p < 0.9
in the float64 run (about those the refit takes), how many part by more
than 1e-3 between the two precisions with and without the correction,
the largest gaps, and the worst SNP.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _ref(argv):
    subprocess.run([sys.executable, "-m", "gemma_tpu", *argv], cwd=HERE,
                   check=True, stdout=subprocess.DEVNULL)


def _cols(path):
    with open(path) as fh:
        head = fh.readline().split()
        rows = np.array([ln.split() for ln in fh])
    return {h: rows[:, i] for i, h in enumerate(head)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snps", type=int, default=1024)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as td:
        geno, pheno, _ = cs._synth_mv(td)
        with open(f"{td}/cut.snps", "w") as fh:
            fh.write("".join(f"rs{j}\n" for j in range(args.snps)))
        base = f"-g {geno} -p {pheno} -outdir {td}".split()
        _ref(base + "-gk 1 -o K".split())
        run = base + (f"-k {td}/K.cXX.txt -snps {td}/cut.snps -n 1 2 "
                      "-lmm 4 -pnr 0.9").split()
        out = {}
        for crt in ("", "-crt"):
            for prec in ("float32", "float64"):
                tag = f"R{crt[1:]}{prec[-2:]}"
                _ref(run + f"{crt} -precision {prec} -o {tag}".split())
                out[tag] = _cols(f"{td}/{tag}.assoc.txt")
    res = {"snps": args.snps, "n": cs.MV_N}
    for col in ("p_wald", "p_lrt"):
        p = {t: v[col].astype(float) for t, v in out.items()}
        gap = np.abs(p["R32"] - p["R64"])
        gap_c = np.abs(p["Rcrt32"] - p["Rcrt64"])
        w = int(np.argmax(gap_c))
        res[col] = {
            "below_0.9_float64": int((p["R64"] < 0.9).sum()),
            "lanes_apart_1e-3_uncorrected": int((gap > 1e-3).sum()),
            "lanes_apart_1e-3_corrected": int((gap_c > 1e-3).sum()),
            "max_abs_uncorrected": float(gap.max()),
            "max_abs_corrected": float(gap_c.max()),
            "worst": {"p": [float(p["R32"][w]), float(p["R64"][w])],
                      "p_corrected": [float(p["Rcrt32"][w]),
                                      float(p["Rcrt64"][w])]}}
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
