"""The mvLMM ML null at d >= 3: the reference package's beside the port's,
on the CPU in float64.

    JAX_PLATFORMS=cpu python scripts/mvlmm_null_gap.py

GEMMA's ML EM carries its UltVehiB in the previous iteration's
eigenbasis, so at d >= 3 its path depends on the signs of the d×d
eigenvectors: the reference takes LAPACK's as they come, the port keeps
each column's sign from the previous iteration.  For each problem (d, n,
seed; the generator of tests/test_torch_mvlmm.py: a kinship from 300
SNPs, d heritable traits with random Vg and Ve, an intercept) it fits
both packages' MvlmmNull (default -emi/-nri) and prints the REML and ML
log-likelihoods' gap, reference minus port, and the largest D_l of the
port's ML fit (Ve^-1/2 Vg Ve^-1/2's spectrum: past ~1e6 Ve is near
singular and the EM's rounding grows with it).

For the first problem with a gap past 1e-6 it then starts the port's ML
EM from the REML fit 16 times, 15 of them with Vg perturbed by 1e-13
relative, and prints where each ends after the EM and after Newton: the
spread rounding alone gives.  Last, -lmm 2 at d = 3 (32 SNPs, -pnr 0.5)
with each package testing against its own null: max |Δp_lrt|.  It
imports both packages, so it is a measurement script, not part of either.
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
from gemma_torch.models import mvlmm_core as torch_core  # noqa: E402

CFG = types.SimpleNamespace(l_min=1e-5, l_max=1e5, n_region=10,
                            em_iter=10000, nr_iter=100, em_prec=1e-4,
                            nr_prec=1e-4, p_nr=0.5, crt=0)
PROBLEMS = ((3, 120, 0), (3, 120, 1), (3, 120, 2), (3, 300, 3),
            (4, 150, 4), (5, 120, 0), (5, 120, 5), (5, 300, 6))


def problem(d, n, seed, s=32):
    rng = np.random.default_rng(seed + 10 * d + 1)
    G = rng.binomial(2, 0.3, size=(300, n)).astype(float)
    G -= G.mean(1, keepdims=True)
    K = G.T @ G / 300
    K = K - K.mean(0) - K.mean(1)[:, None] + K.mean()
    ev, U = np.linalg.eigh(K)
    ev = np.where(ev < 1e-10, 0.0, ev)
    L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
    A = rng.normal(size=(d, d))
    Vg = A @ A.T / d + 0.5 * np.eye(d)
    A = rng.normal(size=(d, d))
    Ve = A @ A.T / d + 0.5 * np.eye(d)
    Yr = ((L @ rng.normal(size=(n, d))) @ np.linalg.cholesky(Vg).T
          + rng.normal(size=(n, d)) @ np.linalg.cholesky(Ve).T)
    x = rng.binomial(2, 0.3, size=(s, n)).astype(float)
    x[:4] += 0.4 * Yr[:, 0]
    return dict(ev=ev, X0=(U.T @ np.ones((n, 1))).T, Y=(U.T @ Yr).T,
                Utx=x @ U)


def nulls(p):
    r = tpu_mv.MvlmmNull(jnp.asarray(p["ev"]), jnp.asarray(p["X0"]),
                         jnp.asarray(p["Y"]), CFG)
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    q = torch_mv.MvlmmNull(t["ev"], t["X0"], t["Y"], CFG)
    return r, q, t


def spread(p, q, t, r):
    d, n = p["Y"].shape
    k = 16
    R0 = t["X0"].new_zeros((k, 0, n))
    rng = np.random.default_rng(0)
    eps = torch.as_tensor(rng.normal(size=(k, d, d)) * 1e-13)
    eps = eps + eps.transpose(-1, -2)
    eps[0] = 0.0
    V0 = q.Vg_remle[None] * (1.0 + eps)
    E0 = q.Ve_remle[None].expand(k, d, d).contiguous()
    B0 = q.B_remle[None].expand(k, d, 1).contiguous()
    em = torch_core.mph_em(False, CFG.em_iter, CFG.em_prec, t["ev"],
                           t["X0"], t["Y"], R0, V0, E0, B0)
    nr = torch_core.mph_nr(False, CFG.nr_iter, CFG.nr_prec, t["ev"],
                           t["X0"], t["Y"], R0, em.Vg, em.Ve)
    print(f"  16 starts 1e-13 apart: EM stops after {int(em.iters.min())}-"
          f"{int(em.iters.max())} iterations at logl "
          f"[{float(em.logl.min()):.4f}, {float(em.logl.max()):.4f}], after "
          f"Newton [{float(nr[2].min()):.4f}, {float(nr[2].max()):.4f}]; the "
          f"reference's null {r.logl_mle_H0:.4f}, the port's "
          f"{q.logl_mle_H0:.4f}", flush=True)


def main():
    torch.set_num_threads(1)
    shown = False
    for d, n, seed in PROBLEMS:
        p = problem(d, n, seed)
        r, q, t = nulls(p)
        D = torch_core.eigen_proc(q.Vg_mle, q.Ve_mle)[0]
        gap = r.logl_mle_H0 - q.logl_mle_H0
        gap_r = r.logl_remle_H0 - q.logl_remle_H0
        print(f"d={d} n={n} seed={seed}: ML logl {r.logl_mle_H0:.6f}, "
              f"reference - port {gap:.3e}; REML {gap_r:.3e}; port's "
              f"largest D_l {float(D.max()):.3e}", flush=True)
        if abs(gap) > 1e-6 and not shown:
            spread(p, q, t, r)
            shown = True
    p = problem(3, 120, 0)
    r, q, t = nulls(p)
    a = tpu_mv.mvlmm_assoc(jnp.asarray(p["ev"]), jnp.asarray(p["X0"]),
                           jnp.asarray(p["Y"]), jnp.asarray(p["Utx"]), r, 2,
                           CFG, jnp.float64)
    b = torch_mv.mvlmm_assoc(t["ev"], t["X0"], t["Y"], t["Utx"], q, 2, CFG,
                             torch.float64)
    print(f"-lmm 2, d=3, 32 SNPs, each package's own null: max |dp_lrt| "
          f"{np.max(np.abs(np.asarray(a['p_lrt']) - b['p_lrt'])):.3e}")


if __name__ == "__main__":
    main()
