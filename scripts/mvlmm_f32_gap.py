"""float32 mvLMM p-values against float64, on the CPU: the reference
package's float32 speed mode beside the port's.

    JAX_PLATFORMS=cpu python scripts/mvlmm_f32_gap.py [n ...]

For each n (default 300 and 757, the releases.org protocol's) it builds,
from seed 0, a kinship from 400 SNPs, two correlated heritable traits
(h² 0.4, genetic correlation 0.5, environmental 0.3), one intercept and
256 test SNPs (the first 4 with effects on both traits).  It fits each
package's null model on its own operands and runs gemma_tpu's
mvlmm_assoc (-lmm 4, default -emi/-nri/-pnr) in float64 and float32, and
gemma_torch's mvlmm_assoc in float32 on the CPU (the kernels' plain
versions: float64 arithmetic from float32 operands, the reference's
staged EM and Newton finisher).  It prints max |Δp| against the
reference's float64 for p_wald, p_lrt and p_score, the count of lanes past
the 1e-3 speed-mode contract and the count of NaN p-values.  It imports
both packages, so it is a measurement script, not part of either.
"""

import os
import sys
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from gemma_tpu.models import mvlmm as tpu_mv  # noqa: E402
from gemma_torch.models import mvlmm as torch_mv  # noqa: E402

P_COLS = ("p_wald", "p_lrt", "p_score")
CFG = types.SimpleNamespace(l_min=1e-5, l_max=1e5, n_region=10,
                            em_iter=10000, nr_iter=100, em_prec=1e-4,
                            nr_prec=1e-4, p_nr=0.001, crt=0)


def inputs(n, s=256, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.binomial(2, 0.3, size=(400, n)).astype(np.float64)
    G -= G.mean(axis=1, keepdims=True)
    K = G.T @ G / G.shape[0]
    Kc = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    w, U = np.linalg.eigh(Kc)
    w = np.where(w < 1e-10, 0.0, w)
    L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
    Cg = np.linalg.cholesky([[1.0, 0.5], [0.5, 1.0]])
    Ce = np.linalg.cholesky([[1.0, 0.3], [0.3, 1.0]])
    g = L @ rng.normal(size=(n, 2)) @ Cg.T
    e = rng.normal(size=(n, 2)) @ Ce.T
    Y = g / g.std(0) * np.sqrt(0.4) + e / e.std(0) * np.sqrt(0.6)
    X = rng.binomial(2, rng.uniform(0.05, 0.5, s)[:, None],
                     size=(s, n)).astype(np.float64)
    Xs = (X - X.mean(1, keepdims=True)) / X.std(1, keepdims=True)
    Y += Xs[:4].T @ np.full((4, 2), 0.2)
    return dict(eval_=w, X0=(U.T @ np.ones((n, 1))).T, Y=(U.T @ Y).T,
                Utx=X @ U)


def reference(p, dtype):
    j = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    null = tpu_mv.MvlmmNull(j["eval_"], j["X0"], j["Y"], CFG)
    return tpu_mv.mvlmm_assoc(j["eval_"], j["X0"], j["Y"], j["Utx"], null, 4,
                              CFG, dtype)


def port(p):
    t = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}
    null = torch_mv.MvlmmNull(t["eval_"], t["X0"], t["Y"], CFG)
    return torch_mv.mvlmm_assoc(t["eval_"], t["X0"], t["Y"], t["Utx"], null,
                                4, CFG, torch.float32)


def gap(ref64, got):
    out = {}
    for c in P_COLS:
        a = np.asarray(ref64[c], np.float64)
        b = np.asarray(got[c], np.float64)
        ok = np.isfinite(a) & np.isfinite(b)
        d = np.abs(a[ok] - b[ok])
        out[c] = (float(d.max()) if d.size else float("nan"),
                  int((d > 1e-3).sum()), int(np.isnan(b).sum()))
    return out


def main(ns):
    for n in ns:
        p = inputs(n)
        ref64 = reference(p, np.float64)
        for label, got in (("gemma_tpu float32", reference(p, np.float32)),
                           ("gemma_torch float32", port(p))):
            g = gap(ref64, got)
            cells = "  ".join(f"{c} {g[c][0]:.2e} ({g[c][1]} > 1e-3, "
                              f"{g[c][2]} NaN)" for c in P_COLS)
            print(f"n={n} {label:20s} {cells}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [300, 757])
