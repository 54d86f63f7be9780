"""Where the λ searches K3 (lambda_solve) and K7 (lambda_solve_f64) spend
their time, on the card: both built with -DGT_PROFILE, which turns on
the phase marks of csrc/common.cuh (GT_PROF): thread 0 of every block,
which waits at each of the block's barriers, adds the clock64() cycles
since its last mark to the phase it closes: the sums over n, the Pab
recurrences, the Gram's factor and solves, and the control around them
(Newton, Brent, the interval walk, the bracket choice).  Counters give
the lanes, the dev1/dev12 and logf evaluations, and the blocks'
evaluation rounds (where a block steps several lanes together).

    python3 scripts/k3_k7_phase_profile.py     # on a machine with the card

Blocks, REML, on seeded data at the mouse shape (n = 1,940, 12,226 SNPs,
the kinship of the SNPs, a phenotype with a polygenic part): the main
block (c = 1, every SNP), 24 covariates (an intercept and 23 normal
columns) on the first 2,048 SNPs, and the -gxe block with 22 of them
plus env and x (c = 24 a lane, per-lane operands) on the first 1,024;
K3 from K2's fine-grid dev1, K7 alone, each in its precision.  A line a
case: the kernel's ms (CUDA events, one call after a warm-up), each
phase's share of thread 0's cycles and its part of the ms, the cycles a
lane and the evaluations a lane; then the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gemma_torch import kernels  # noqa: E402
from gemma_torch.models.lmm import likelihood as lk  # noqa: E402
from gemma_torch.models.lmm import optimize as opt  # noqa: E402
from gemma_torch.models.lmm.engine import gxe_batch_data  # noqa: E402
from gemma_torch.ops.center import center_matrix  # noqa: E402
from gemma_torch.ops.eigh import eigh_zeroed  # noqa: E402

N, P, C24, LANES24, LANES_GXE, SEED = 1940, 12226, 24, 2048, 1024, 10
PHASES = ("sums over n", "Pab recurrences", "factor and solves", "control")
# counter slots (csrc/common.cuh GT_PC_*)
LANES, DEV, LOGF, STEPS = 8, 9, 10, 11


def _data(dev):
    """(eval, U, y, x rows, W24, env) per dtype, from one seed."""
    rng = np.random.default_rng(SEED)
    maf = rng.uniform(0.05, 0.5, P)
    X = rng.binomial(2, maf[:, None], size=(P, N)).astype(np.float32)
    Xd = torch.as_tensor(X, dtype=torch.float64, device=dev)
    Xc = Xd - Xd.mean(dim=1, keepdim=True)
    K = Xc.T @ Xc / P
    g = Xc.T @ torch.as_tensor(rng.normal(size=P), device=dev)
    g = g / g.std() * np.sqrt(0.5)
    y = g + torch.as_tensor(rng.normal(size=N) * np.sqrt(0.5), device=dev)
    W = np.column_stack([np.ones(N), rng.normal(size=(N, C24 - 1))])
    env = rng.normal(size=N)
    out = {}
    for dt in (torch.float32, torch.float64):
        ev, U, _ = eigh_zeroed(center_matrix(K.to(dt)))
        out[dt] = (ev, U, y.to(dt), Xd.to(dt),
                   torch.as_tensor(W, dtype=dt, device=dev),
                   torch.as_tensor(env, dtype=dt, device=dev))
    return out


def _blocks(d):
    ev, U, y, X, W, env = d
    Uty = U.T @ y
    x24 = X[:LANES24]
    xg = X[:LANES_GXE]
    W22 = W[:, :C24 - 2]
    return (
        ("mouse_c1", 1, lk.build_batch_data(ev, U.T @ W[:, :1], Uty,
                                            (X @ U).contiguous(), 1)),
        ("c24", C24, lk.build_batch_data(ev, U.T @ W, Uty,
                                         (x24 @ U).contiguous(), C24)),
        ("gxe_c24", C24, gxe_batch_data(ev, U.T @ W22, U.T @ env, Uty,
                                        xg @ U, (xg * env) @ U, C24 - 2)))


def main():
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in (kernels.LAMBDA_SOLVE, kernels.LAMBDA_SOLVE_F64):
        k._flags = lambda: kernels.NVCC_FLAGS + ("-DGT_PROFILE",)
        k._load()
    data = _data(dev)
    buf = (ctypes.c_ulonglong * 16)()
    fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    for dt, kern in ((torch.float32, kernels.LAMBDA_SOLVE),
                     (torch.float64, kernels.LAMBDA_SOLVE_F64)):
        read = kern._lib.gt_prof_read
        for case, nc, blk in _blocks(data[dt]):
            if dt == torch.float32:
                d1f = lk.dev1_grid(fine, blk, nc, False, True)

                def call():
                    return opt.lambda_solve_cuda(d1f, fine, blk, nc, False,
                                                 True, 1e-5, 1e5, 10,
                                                 lk.per_lane(blk))
            else:
                def call():
                    return opt.lambda_solve_f64_cuda(blk, nc, False, True,
                                                     1e-5, 1e5, 10)
            call()
            torch.cuda.synchronize()
            read(buf)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            r = call()
            b.record()
            b.synchronize()
            read(buf)
            cnt = list(buf)
            ms = a.elapsed_time(b)
            cyc = cnt[:len(PHASES)]
            lanes = max(cnt[LANES], 1)
            print(json.dumps({
                "kernel": kern.name, "case": case, "c": nc,
                "lanes": cnt[LANES], "ms": ms,
                "finite_lanes": int(torch.isfinite(r.lam).sum()),
                "cycles_per_lane": sum(cyc) / lanes,
                "dev_evals_per_lane": cnt[DEV] / lanes,
                "logf_evals_per_lane": cnt[LOGF] / lanes,
                "block_rounds": cnt[STEPS] or None,
                "phase_share": {nm: c / sum(cyc)
                                for nm, c in zip(PHASES, cyc)},
                "phase_ms": {nm: ms * c / sum(cyc)
                             for nm, c in zip(PHASES, cyc)}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
