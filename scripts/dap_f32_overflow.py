"""Float32 DAP Bayes factors against float64, on the CPU: does the
reference package's float32 exp(logm - logm_null) overflow, and where
does the port's float32 (float32 products, float64 epilogue) stand?

    JAX_PLATFORMS=cpu python scripts/dap_f32_overflow.py [n ...]

For each n (default 400 and 1940) it builds a kinship from 2,000 SNPs
(MAF 0.05-0.5, seed 17), 2,048 test SNPs of which the first 10 are
causal with 25% of the phenotype's variance (a polygenic part another
25%, as chip_smoke.py's phase (g)), and -bslmm 4's grid at its
defaults with h up to 0.95 (10 x 10 points); then the same with one
more causal SNP carrying 8% of the variance (a strong QTL).  It runs
gemma_tpu's dap_calc_bf in float64 and in float32 and gemma_torch's in
float32 on the CPU (K13's plain version) and prints, for each float32 run, the
count of infinite and NaN Bayes factors where the float64 one is
finite, and max |Δ log BF| over the entries finite in both.  It imports
both packages, so it is a measurement script, not part of either.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from gemma_tpu.models import bslmmdap as tpu_dap  # noqa: E402
from gemma_tpu.ops.eigh import eigh_zeroed as tpu_eigh  # noqa: E402
from gemma_torch.models import bslmmdap as dap  # noqa: E402


def inputs(n, strong=0.0, p_kin=2000, p=2048, seed=17):
    rng = np.random.default_rng(seed)

    def geno(k):
        maf = rng.uniform(0.05, 0.5, k)
        X = rng.binomial(2, maf[:, None], size=(k, n)).astype(np.float64)
        return X - X.mean(axis=1, keepdims=True)

    Xk, Xt = geno(p_kin), geno(p)
    K = Xk.T @ Xk / p_kin
    Xs = Xt / Xt.std(axis=1, keepdims=True)
    gc = rng.normal(size=10) @ Xs[:10]
    gp = rng.normal(size=p_kin) @ (Xk / Xk.std(axis=1, keepdims=True))
    e = rng.normal(size=n)
    y = sum(v / v.std() * np.sqrt(f) for v, f in ((gc, .25), (gp, .25),
                                                   (e, .5 - strong)))
    y = y + Xs[10] * np.sqrt(strong)
    return K, y - y.mean(), Xt


def main(ns):
    for n, strong in ((n, s) for s in (0.0, 0.08) for n in ns):
        K, y, Xt = inputs(n, strong)
        ev, U, tr = tpu_eigh(jnp.asarray(K))
        UtX = (jnp.asarray(Xt) @ U).T                   # (n, p)
        Uty = U.T @ jnp.asarray(y)
        grid = tpu_dap.hyper_grid(0.0, 0.95, 10, 0.0, 1.0, 10, float(tr))
        ref = tpu_dap.dap_calc_bf(UtX, Uty, ev, grid)
        f32 = jnp.float32
        tpu32 = tpu_dap.dap_calc_bf(UtX.astype(f32), Uty.astype(f32),
                                    ev.astype(f32), grid)
        t32 = torch.float32
        port32 = dap.dap_calc_bf(
            torch.as_tensor(np.asarray(UtX).T.copy(), dtype=t32),
            torch.as_tensor(np.asarray(Uty), dtype=t32),
            torch.as_tensor(np.asarray(ev), dtype=t32), grid)
        fin = np.isfinite(ref)
        out = {"n": n, "strong_snp_share": strong, "snps": Xt.shape[0],
               "grid": len(grid),
               "float64_finite": int(fin.sum()),
               "float64_log_bf_max": float(np.log(ref[fin]).max())}
        for name, bf in (("reference_float32", tpu32),
                         ("port_float32", port32)):
            both = fin & np.isfinite(bf) & (bf > 0)
            out[name] = {
                "inf": int((np.isinf(bf) & fin).sum()),
                "nan": int((np.isnan(bf) & fin).sum()),
                "snps_with_inf": int((np.isinf(bf) & fin).any(1).sum()),
                "log_bf_max_abs_err": float(np.max(np.abs(
                    np.log(bf[both]) - np.log(ref[both]))))}
        print(out)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [400, 1940])
