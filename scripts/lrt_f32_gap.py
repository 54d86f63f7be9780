"""float32 p-values against float64, on the CPU: the reference package's
float32 speed mode beside the port's.

    JAX_PLATFORMS=cpu python scripts/lrt_f32_gap.py [n ...]

For each n (default 400 and 1940) it builds the inputs of
tests/test_lmm_core.py:345-378 with 512 test SNPs (seed 61: a kinship
from 600 SNPs, a heritable phenotype, one intercept), runs
gemma_tpu's fit_null + assoc_block_impl(mode=4) in float64 and in
float32, and gemma_torch's in float32 on the CPU (the kernels' plain
versions), and prints max |Δp| against the reference's float64 for
p_wald, p_lrt and p_score with the count of SNPs past the 1e-3
speed-mode contract.  It imports both packages, so it is a measurement
script, not part of either.
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

from gemma_tpu.models.lmm import fit_null as tpu_fit_null  # noqa: E402
from gemma_tpu.models.lmm.engine import assoc_block_impl as tpu_assoc  # noqa
from gemma_tpu.ops.eigh import eigh_zeroed as tpu_eigh  # noqa: E402
from gemma_torch.models.lmm.engine import assoc_block_impl, fit_null  # noqa
from gemma_torch.ops.eigh import eigh_zeroed  # noqa: E402

P_COLS = ("p_wald", "p_lrt", "p_score")


def inputs(n, p=512, seed=61):
    rng = np.random.default_rng(seed)
    Xk = rng.binomial(2, 0.3, size=(600, n)).astype(np.float64)
    Xkc = Xk - Xk.mean(axis=1, keepdims=True)
    K = Xkc.T @ Xkc / 600
    L = np.linalg.cholesky(K + 1e-8 * np.eye(n))
    y = L @ rng.normal(size=n) * 0.6 + rng.normal(size=n)
    Xt = rng.binomial(2, 0.3, size=(p, n)).astype(np.float64)
    Xt[:8] += (y > np.median(y)) * 0.5
    return K, y, Xt


def reference(K, y, Xt, dtype):
    ev, U, tg = tpu_eigh(jnp.asarray(K, dtype))
    W = jnp.ones((len(y), 1), dtype)
    UtW, Uty = U.T @ W, U.T @ jnp.asarray(y, dtype)
    nf = tpu_fit_null(ev, UtW, Uty, tg, 1)
    st = tpu_assoc(ev, UtW, Uty, jnp.asarray(Xt, dtype) @ U, nf.l_mle,
                   nf.logl_mle, n_cvt=1, mode=4)
    return {c: np.asarray(getattr(st, c), np.float64) for c in P_COLS}


def port_f32(K, y, Xt):
    f32 = torch.float32
    ev, U, tg = eigh_zeroed(torch.as_tensor(K, dtype=f32))
    UtW = U.T @ torch.ones((len(y), 1), dtype=f32)
    Uty = U.T @ torch.as_tensor(y, dtype=f32)
    nf = fit_null(ev, UtW, Uty, tg, 1)
    st = assoc_block_impl(ev, UtW, Uty, torch.as_tensor(Xt, dtype=f32) @ U,
                          nf.l_mle, nf.logl_mle, n_cvt=1, mode=4)
    return {c: getattr(st, c).double().numpy() for c in P_COLS}


def main(ns):
    for n in ns:
        K, y, Xt = inputs(n)
        ref = reference(K, y, Xt, jnp.float64)
        for name, got in (("gemma_tpu float32", reference(K, y, Xt,
                                                            jnp.float32)),
                          ("gemma_torch float32", port_f32(K, y, Xt))):
            cells = []
            for c in P_COLS:
                ok = np.isfinite(ref[c]) & np.isfinite(got[c])
                d = np.abs(ref[c][ok] - got[c][ok])
                cells.append(f"{c} {d.max():.2g} ({int((d > 1e-3).sum())} "
                             f"> 1e-3)")
            print(f"n={n} {name}: " + ", ".join(cells), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [400, 1940])
