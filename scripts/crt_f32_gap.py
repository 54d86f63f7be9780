"""The mvLMM -crt p-values from float32 operands against float64, on the
card: why -crt runs in float64 (ROADMAP.md §C18).

    python3 scripts/crt_f32_gap.py        # on a machine with the card

It builds chip_smoke.py's phase (f) data (the releases.org protocol
shape: n = 757, 10,775 SNPs, two traits) and its kinship, and for each
operand type (float32, the speed mode's, and float64) runs what
`-lmm 4 -n 1 2 -crt -pnr 0.9` runs on the block, kernel by kernel
(K9-K11, then K14 on float64 copies of the same operands): the -pnr 0.9
refit of each lane the float64 -crt run refined (EM, then Newton), its
p-value and the corrected one.  It prints, for p_wald (REML) and p_lrt
(ML): the refined lanes, how many part by more than 1e-3 before and after
the correction, the largest gaps, how many refits end more than 1e-4
apart in logl, and the worst lane.
"""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.config import GemmaConfig  # noqa: E402
from gemma_torch.models import mvlmm_core as mvc  # noqa: E402
from gemma_torch.models.mvlmm import _Iters  # noqa: E402

F64 = torch.float64


def _lanes(o, idx, reml, it):
    """Refit, p before and after the correction, for the lanes idx."""
    ev, X0, Y, R, nul = o["ev"], o["X0"], o["Y"], o["R1"], o["null"]
    Ri = R[idx].contiguous()
    em = mvc.mph_em(reml, it.em_iter, it.em_prec, ev, X0, Y, Ri,
                    nul.Vg_start[None], nul.Ve_start[None],
                    nul.B_start[None])
    Vg, Ve, logl, Hvar = mvc.mph_nr(reml, it.nr_iter, it.nr_prec, ev, X0, Y,
                                    Ri, em.Vg, em.Ve)
    l0 = torch.tensor([nul.logl_mle_H0], dtype=F64, device=ev.device)
    cp = mvc.mph_calc_p(ev, X0, Y, Ri, Vg, Ve,
                        *((None, None) if reml else (logl, l0)))
    p = (cp.p if reml else cp.p_lrt).cpu().numpy()
    abc = mvc.calc_crt(ev.to(F64), X0.to(F64), Ri.to(F64), Vg, Ve, Hvar)
    pc = mvc.pcrt(1 if reml else 2, Y.shape[0], p,
                  *(t.cpu().numpy() for t in abc))
    return logl.cpu().numpy(), p, pc


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card")
    kernels.build_all()
    dev = torch.device("cuda")
    it = _Iters(GemmaConfig())
    with tempfile.TemporaryDirectory() as td:
        geno, pheno, _ = cs._synth_mv(td)
        base = f"-g {geno} -p {pheno} -outdir {td} -no-check".split()
        cs._run(base + "-gk 1 -o MK".split(), "cuda")
        mvk = base + f"-k {td}/MK.cXX.txt -n 1 2 -lmm 1".split()
        cs._run(mvk + ["-o", "M1"], "cuda")
        # the lanes the -crt path refines (its float64 run's first fits)
        cs._run(base + f"-k {td}/MK.cXX.txt -n 1 2 -lmm 4 -crt -pnr 0.9 "
                "-precision float64 -o MRd".split(), "cuda")
        ops = cs._mv_operands(mvk, cs.RESULTS["M1"]["snp_indices"], dev,
                              (torch.float32, F64))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    refined = cs.RESULTS["MRd"]["stats"]["refined"]
    for col, reml in (("p_wald", True), ("p_lrt", False)):
        idx = torch.as_tensor(np.flatnonzero(refined[:, int(reml)]),
                              device=dev)
        r = {dt: _lanes(ops[dt], idx, reml, it) for dt in ops}
        (l32, p32, c32), (l64, p64, c64) = r[torch.float32], r[F64]
        gap, gap_c = np.abs(p32 - p64), np.abs(c32 - c64)
        w = int(np.argmax(gap_c))
        out[col] = {
            "refined_lanes": int(idx.numel()),
            "lanes_apart_1e-3_uncorrected": int((gap > 1e-3).sum()),
            "lanes_apart_1e-3_corrected": int((gap_c > 1e-3).sum()),
            "max_abs_uncorrected": float(gap.max()),
            "max_abs_corrected": float(gap_c.max()),
            "refits_apart_1e-4_logl": int((np.abs(l32 - l64) > 1e-4).sum()),
            "worst": {"logl": [float(l32[w]), float(l64[w])],
                      "p": [float(p32[w]), float(p64[w])],
                      "p_corrected": [float(c32[w]), float(c64[w])]}}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
