"""The d = 9 case of tests/test_torch_wide_shapes.py at other settings:
how far the port's -lmm 4 and the reference's part, per p column.

    JAX_PLATFORMS=cpu python3 scripts/mvlmm_d9_ref_gap.py [emp [pnr]]

The test's inputs (`_mv_problem(9, 2, n=400, s=8)`), the port's null fit
at -emp/-nrp `emp` (default 1e-4, the reference's), both packages'
per-SNP drivers from that null with -pnr `pnr` (default 1: Newton on every
lane), float64 on the CPU.  Prints max |Δp| of p_wald, p_lrt and p_score
over the 8 SNPs, the per-SNP gaps, and the seconds of each part.  About
two minutes.
"""

import os
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import test_torch_wide_shapes as T  # noqa: E402


def main():
    torch.set_num_threads(1)
    emp = float(sys.argv[1]) if len(sys.argv) > 1 else 1e-4
    pnr = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0
    ev, X0, Y, R, _, _ = T._mv_problem(9, 2, n=400, s=8)
    cfg = T._cfg(em_prec=emp, nr_prec=emp, p_nr=pnr)
    t0 = time.time()
    qn = T.pmv.MvlmmNull(T._t(ev), T._t(X0), T._t(Y), cfg)
    t1 = time.time()
    rn = types.SimpleNamespace(
        **{f: jnp.asarray(getattr(qn, f).numpy()) for f in (
            "Vg_start", "Ve_start", "B_start")},
        logl_mle_H0=float(qn.logl_mle_H0))
    r = T.rmv.mvlmm_assoc(jnp.asarray(ev), jnp.asarray(X0), jnp.asarray(Y),
                          jnp.asarray(R[:, 0]), rn, 4, cfg, jnp.float64)
    t2 = time.time()
    q = T.pmv.mvlmm_assoc(T._t(ev), T._t(X0), T._t(Y), T._t(R[:, 0]), qn,
                          4, cfg, T.F64)
    t3 = time.time()
    out = {"emp": emp, "pnr": pnr}
    for k in ("p_wald", "p_lrt", "p_score"):
        err = np.abs(np.asarray(r[k]) - q[k])
        out[k] = float(err.max())
        out[k + "_by_snp"] = err.tolist()
    out["seconds"] = {"null": t1 - t0, "reference": t2 - t1,
                      "port": t3 - t2}
    print(out)


if __name__ == "__main__":
    main()
