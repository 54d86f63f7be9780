"""float32 p-values of GxE and gene mode against float64, on the CPU: the
reference package's float32 beside the port's, with K3's float32 sums
and with the float64 sums it runs for per-lane blocks.

    JAX_PLATFORMS=cpu python scripts/lane_f32_gap.py [n ...]

For each n (default 300 and 1940) it builds, from seed 0, a kinship from
400 SNPs, a phenotype of noise, one intercept, a binary environment, 256
test SNPs (the first 3 with an interaction) and 256 genes of noise (the
first 8 tied to the phenotype).  It runs gemma_tpu's assoc_gxe_block and
assoc_gene_block (mode 4) in float64 and float32, and gemma_torch's
assoc_gxe_block_impl / assoc_gene_block_impl in float32 on the CPU (the
kernels' plain versions) twice: with the λ search in float32 sums, as K3
runs it for a block whose lanes share their operands, and as shipped,
with float64 sums from the float32 operands.  It prints max |Δp| against
the reference's float64 for p_wald, p_lrt and p_score, the count of
lanes past the 1e-3 speed-mode contract and the count of NaN p-values.
It imports both packages, so it is a measurement script, not part of
either.
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

from gemma_tpu.models.lmm.engine import (assoc_gene_block,  # noqa: E402
                                         assoc_gxe_block)
from gemma_tpu.models.lmm.engine import fit_null as tpu_fit_null  # noqa
from gemma_torch.models.lmm import engine as te  # noqa: E402
from gemma_torch.models.lmm import optimize as opt  # noqa: E402

P_COLS = ("p_wald", "p_lrt", "p_score")


def inputs(n, s=256, seed=0):
    rng = np.random.default_rng(seed)
    Xk = rng.binomial(2, 0.3, size=(400, n)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / Xk.shape[0]
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    y = rng.normal(size=n)
    env = rng.integers(0, 2, n).astype(np.float64)
    X = rng.binomial(2, rng.uniform(0.05, 0.5, s)[:, None],
                     size=(s, n)).astype(np.float64)
    X[:3] += env * (y > np.median(y)) * 0.8
    E = rng.normal(size=(s, n))
    E[:8] += 0.4 * y
    return dict(eval_=w, UtW=U.T @ np.ones((n, 1)), Uty=U.T @ y,
                Ut_env=U.T @ env, Utx=X @ U, Utxe=(X * env) @ U, UtE=E @ U,
                trace_G=w.mean())


def reference(p, kind, dtype):
    j = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    if kind == "gene":
        return assoc_gene_block(j["eval_"], j["UtW"], j["Uty"], j["UtE"],
                                n_cvt=1, mode=4)
    nf = tpu_fit_null(j["eval_"], j["UtW"], j["Uty"], j["trace_G"], 1)
    return assoc_gxe_block(j["eval_"], j["UtW"], j["Ut_env"], j["Uty"],
                           j["Utx"], j["Utxe"], nf.l_mle, nf.logl_mle,
                           n_cvt=1, mode=4)


def port(p, kind, wide):
    t = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}
    shipped = opt.lambda_solve

    def search(*args, wide=False):
        return shipped(*args, wide=wide and WIDE[0])

    WIDE = [wide]
    opt.lambda_solve = search
    try:
        if kind == "gene":
            return te.assoc_gene_block_impl(t["eval_"], t["UtW"], t["Uty"],
                                            t["UtE"], n_cvt=1, mode=4)
        nf = te.fit_null(t["eval_"], t["UtW"], t["Uty"], t["trace_G"], 1)
        return te.assoc_gxe_block_impl(
            t["eval_"], t["UtW"], t["Ut_env"], t["Uty"], t["Utx"],
            t["Utxe"], nf.l_mle, nf.logl_mle, n_cvt=1, mode=4)
    finally:
        opt.lambda_solve = shipped


def gap(ref64, got):
    out = {}
    for c in P_COLS:
        a = np.asarray(getattr(ref64, c), np.float64)
        b = np.asarray(getattr(got, c), np.float64)
        ok = np.isfinite(a) & np.isfinite(b)
        d = np.abs(a[ok] - b[ok])
        out[c] = (float(d.max()) if d.size else float("nan"),
                  int((d > 1e-3).sum()), int(np.isnan(b).sum()))
    return out


def main(ns):
    for n in ns:
        p = inputs(n)
        for kind in ("gxe", "gene"):
            ref64 = reference(p, kind, np.float64)
            rows = (("gemma_tpu float32", reference(p, kind, np.float32)),
                    ("gemma_torch float32, float32 sums",
                     port(p, kind, False)),
                    ("gemma_torch float32 as shipped", port(p, kind, True)))
            for label, got in rows:
                g = gap(ref64, got)
                cells = "  ".join(f"{c} {g[c][0]:.2e} ({g[c][1]} > 1e-3, "
                                  f"{g[c][2]} NaN)" for c in P_COLS)
                print(f"n={n} {kind:4s} {label:34s} {cells}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [300, 1940])
