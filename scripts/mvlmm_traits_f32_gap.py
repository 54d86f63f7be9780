"""The port's mvLMM p-values from float32 operands against float64, by the
number of traits, on the CPU.

    python scripts/mvlmm_traits_f32_gap.py [d ...]

It builds chip_smoke.py's phase (f)/(k) data at the releases.org
protocol shape (n = 757, 10,775 SNPs, 3% missing; ten traits with h²
0.4, genetic correlation 0.5 and environmental 0.3, effects of 8 causal
SNPs on the first two; an intercept and 11 seeded normal covariates),
its -gk 1 kinship, and for each d (default 3 5 8 9 10) runs the port's
mvlmm_assoc (-lmm 4, default -emi/-nri/-pnr; the kernels' plain
versions, float64 arithmetic) on the first 32 SNPs with the first d
traits, once from float64 operands and once from float32 operands (each
with its own eigendecomposition, rotation and null fit), with and
without the covariates.  It prints max |Δp| of p_wald, p_lrt and p_score
and the largest ML EM iteration count of each.  It calls mvlmm_assoc
directly, so the CLI's own choice of operands (float64 beyond
run._MV_F32_MAX_D traits) does not enter.  About 15 min on 8 cores.
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from gemma_torch.cli import parse_args  # noqa: E402
from gemma_torch.dataset import load_dataset  # noqa: E402
from gemma_torch.models.mvlmm import MvlmmNull, mvlmm_assoc  # noqa: E402
from gemma_torch.ops.pack2 import IMPUTE, prologue  # noqa: E402
from gemma_torch.run import (_load_or_compute_eigen,  # noqa: E402
                             _raw_wire_block, _to_device)
from gemma_torch.utils.log import RunLog  # noqa: E402

P_COLS = ("p_wald", "p_lrt", "p_score")


def assoc(argv, dtype):
    cfg = parse_args(argv)
    ds = load_dataset(cfg)
    dev = torch.device("cpu")
    ev, U, _ = _load_or_compute_eigen(cfg, ds, RunLog(argv=[]), dtype, dev)
    X0 = (U.T @ torch.as_tensor(ds.W, dtype=dtype)).T.contiguous()
    Y = (U.T @ torch.as_tensor(ds.Y, dtype=dtype)).T.contiguous()
    idx = np.flatnonzero(ds.qc.indicator_snp)[:32]
    raw = _raw_wire_block(ds, idx, len(idx), dtype, all_individuals=False)
    x = prologue(_to_device(raw, dev), ds.ni_test, IMPUTE, dtype=dtype)
    null = MvlmmNull(ev, X0, Y, cfg)
    return mvlmm_assoc(ev, X0, Y, (x @ U).contiguous(), null, 4, cfg, dtype)


def main():
    ds_ = [int(a) for a in sys.argv[1:]] or [3, 5, 8, 9, 10]
    torch.set_num_threads(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as td:
        chip_smoke._synth_mv(td)
        base = f"-g {td}/mv_geno.txt.gz -outdir {td} -no-check".split()
        chip_smoke._run(base + f"-p {td}/mv_pheno.txt -gk 1 -o MK".split(),
                        "cpu")
        for d in ds_:
            for cov in (False, True):
                argv = base + (f"-p {td}/mv_pheno10.txt -k {td}/MK.cXX.txt "
                               "-lmm 4 -n").split() + [str(i) for i in
                                                       range(1, d + 1)]
                if cov:
                    argv += f"-c {td}/mv_cov12.txt".split()
                a, b = (assoc(argv, t) for t in (torch.float32,
                                                 torch.float64))
                gap = {c: float(np.abs(a[c] - b[c]).max()) for c in P_COLS}
                print({"d": d, "covariates": 12 if cov else 1, **gap,
                       "ml_em_iters_max_f32": int(a["em_iters"][:, 0].max()),
                       "ml_em_iters_max_f64": int(b["em_iters"][:, 0].max())},
                      flush=True)


if __name__ == "__main__":
    main()
