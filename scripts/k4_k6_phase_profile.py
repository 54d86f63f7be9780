"""Where the test kernels K4 (wald_tail), K5 (score_tail), their float64
forms and K6 (lrt_tail, speed mode) spend their time, on the card: each
built with -DGT_PROFILE, which turns on the phase marks of
csrc/common.cuh (GT_PROF, the TT_PH_* slots): thread 0 of every block
adds the clock64() cycles since its last mark to the phase it closes:
each lane's weights, the sums over n, the Pab recurrence (K4, K5) or the
Gram's factor and solves (K6), K6's residual pass, and the tail with the
stores.  A phase's share is its part of the blocks' summed cycles (where
a kernel's form makes the weights inside the sums, they count as sums).

    python3 scripts/k4_k6_phase_profile.py     # on a machine with the card

Blocks, on the seeded data of scripts/k3_k7_phase_profile.py (n = 1,940,
12,226 SNPs, the kinship of the SNPs, a phenotype with a polygenic
part): the mouse block (c = 1, every SNP), 24 covariates on the first
2,048 SNPs, 40 (an intercept and 39 seeded normal columns) on the first
128, and the -gxe block with 22 of the 24 plus env and x (c = 24 a lane,
per-lane operands, one ML null per SNP) on the first 1,024, as
chip_smoke.py's phases (i) and (k) hold.  λ: K3's REML and ML fits of each
block; the score at the covariate-only null's ML λ.  K6's null launch
(the covariate-only model, one lane where the lanes share it) and its
SNP launch are profiled apart.

A line a (kernel, block): the median ms of five calls (CUDA events,
after a warm-up; the host's enqueue included, as chip_smoke.py's ms),
the device's ms alone (chip_smoke._time_device_ms), each phase's share
of the marked cycles and its part of that ms, each CUDA kernel's device
ms (torch.profiler), the blocks a call marked and the cycles a block, and the
call's largest differences from its plain version (p; beta over se, or
logl relative); then the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.models.lmm import likelihood as lk  # noqa: E402
from gemma_torch.models.lmm import optimize as opt  # noqa: E402
from gemma_torch.models.lmm.engine import fit_null, gxe_batch_data  # noqa
from k3_k7_phase_profile import C24, LANES24, LANES_GXE, _data  # noqa: E402

PHASES = ("weights", "sums over n", "recurrence or factor", "residual pass",
          "tail and stores")
C40, LANES40, SEED40 = 40, 128, 40
MARKED = 8          # csrc/common.cuh GT_PC_LANES: blocks a call marked
PROFILED = (kernels.WALD_TAIL, kernels.WALD_TAIL_F64, kernels.SCORE_TAIL,
            kernels.SCORE_TAIL_F64, kernels.LRT_TAIL)


def _read(kern):
    """The kernel's profile counters, zeroed as they are read."""
    if kern._lib is None:
        kern._load()
    buf = (ctypes.c_ulonglong * 16)()
    kern._lib.gt_prof_read(buf)
    return list(buf)


def _gap(out, plain):
    """Largest differences of a kernel's outputs from its plain version's:
    p, and beta over se (K4, K5) or logl relative (K6)."""
    ok = torch.isfinite(plain[-1])
    gap = {"p_max_abs": float((out[-1] - plain[-1])[ok].abs().max())}
    if len(out) == 3:
        gap["beta_max_over_se"] = float(((out[0] - plain[0]).abs()
                                         / plain[1])[ok].max())
    else:
        gap["logl_max_rel"] = float(((out[0].double() - plain[0].double())
                                     / plain[0].double()).abs().max())
    gap["nan_differ"] = int((torch.isnan(out[-1])
                             != torch.isnan(plain[-1])).sum())
    return gap


def _stage_ms(fn):
    """Device ms of one call by CUDA kernel (torch.profiler): the main
    kernel and the tails' launch apart."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t > 0:
            out[ev.key.split("(")[0][:60]] = t / 1e3
    return out


def _profile(kern, case, fn, extra):
    fn()
    torch.cuda.synchronize()
    _read(kern)
    fn()
    torch.cuda.synchronize()
    cnt = _read(kern)
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ms = float(np.median(ts))
    device_ms = cs._time_device_ms(fn, 5)[0]
    cyc = cnt[:len(PHASES)]
    tot = max(sum(cyc), 1)
    print(json.dumps({
        "kernel": kern.name, "case": case, "ms": ms, "device_ms": device_ms,
        "blocks_marked": cnt[MARKED],
        "cycles_per_block": tot / max(cnt[MARKED], 1),
        "phase_share": {nm: c / tot for nm, c in zip(PHASES, cyc)},
        "phase_ms": {nm: ms * c / tot for nm, c in zip(PHASES, cyc)},
        "kernel_ms": _stage_ms(fn), **extra}), flush=True)


def _blocks(d, nulls):
    """(case, n_cvt, data, score λ, null λ, null logl) of each block; the
    nulls (fit on the card) only where `nulls`, else None."""
    ev, U, y, X, W, env = d
    Uty = U.T @ y
    out = []
    for case, nc, lanes in (("mouse_c1", 1, X.shape[0]),
                            ("c24", C24, LANES24)):
        UtW = U.T @ W[:, :nc]
        data = lk.build_batch_data(ev, UtW, Uty,
                                   (X[:lanes] @ U).contiguous(), nc)
        nf = fit_null(ev, UtW, Uty, 1.0, nc) if nulls else None
        out.append((case, nc, data) + ((nf.l_mle, nf.l_mle, nf.logl_mle)
                                       if nulls else (None,) * 3))
    # 40 covariates (an intercept and 39 seeded normal columns) on the
    # first LANES40 SNPs, as chip_smoke.py's phase (k) holds
    rng = np.random.default_rng(SEED40)
    W40 = torch.as_tensor(np.column_stack(
        [np.ones(ev.shape[0]), rng.normal(size=(ev.shape[0], C40 - 1))]),
        dtype=ev.dtype, device=ev.device)
    UtW40 = U.T @ W40
    data40 = lk.build_batch_data(ev, UtW40, Uty,
                                 (X[:LANES40] @ U).contiguous(), C40)
    nf = fit_null(ev, UtW40, Uty, 1.0, C40) if nulls else None
    out.append(("c40", C40, data40) + ((nf.l_mle, nf.l_mle, nf.logl_mle)
                                       if nulls else (None,) * 3))
    UtW = U.T @ W[:, :C24 - 2]
    xg = X[:LANES_GXE]
    data = gxe_batch_data(ev, UtW, U.T @ env, Uty, xg @ U, (xg * env) @ U,
                          C24 - 2)
    if nulls:
        nf = fit_null(ev, UtW, Uty, 1.0, C24 - 2)
        null = opt.calc_lambda(data, C24, True, False, 1e-5, 1e5, 10)
        out.append(("gxe_c24", C24, data, nf.l_mle, null.lam, null.logf))
    else:
        out.append(("gxe_c24", C24, data, None, None, None))
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in PROFILED:
        k._flags = (lambda f=k._flags: f() + ("-DGT_PROFILE",))
    libs = {k.lib_stem: k for k in PROFILED + (
        kernels.LAMBDA_GRID, kernels.LAMBDA_SOLVE, kernels.LAMBDA_SOLVE_F64)}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda k: k.build(), libs.values()))
    dev = torch.device("cuda")
    data = _data(dev)
    fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    f32, f64 = torch.float32, torch.float64
    blocks64 = {b[0]: b for b in _blocks(data[f64], False)}
    for case, nc, blk, l_score, l0, logl0 in _blocks(data[f32], True):
        S = lk.n_lanes(blk)
        fits = {}
        for reml in (True, False):
            d1f = lk.dev1_grid(fine, blk, nc, False, reml)
            fits[reml] = opt.lambda_solve_cuda(d1f, fine, blk, nc, False,
                                               reml, 1e-5, 1e5, 10,
                                               lk.per_lane(blk))
        extra = {"S": S, "n": blk.eval.shape[0], "c": nc}
        lam = fits[True].lam
        for kern, fk, fp, lm in (
                (kernels.WALD_TAIL, lk.wald_pvalues_cuda,
                 lk.wald_pvalues_plain, lam),
                (kernels.SCORE_TAIL, lk.score_pvalues_cuda,
                 lk.score_pvalues_plain, l_score)):
            _profile(kern, case, lambda: fk(lm, blk, nc),
                     {**extra, **_gap(fk(lm, blk, nc), fp(lm, blk, nc))})
        ml = fits[False]
        l0_64 = lk.lrt_null_cuda(l0, blk, nc)
        d64 = blk._replace(eval=blk.eval.double(), UtWy=blk.UtWy.double(),
                           Utx=blk.Utx.double())
        l0_p = lk.logf_stable(l0.double().reshape(-1), d64, nc, True, False)
        _profile(kernels.LRT_TAIL, case + "_null",
                 lambda: lk.lrt_null_cuda(l0, blk, nc),
                 {**extra, "S": l0.reshape(-1).numel(), "logl_max_rel": float(
                     ((l0_64 - l0_p) / l0_p).abs().max())})
        _profile(kernels.LRT_TAIL, case + "_snps",
                 lambda: lk.lrt_pvalues_cuda(ml.lam, ml.logf, blk, nc, None,
                                             l0_64),
                 {**extra, **_gap(
                     lk.lrt_pvalues_cuda(ml.lam, ml.logf, blk, nc, l0, None),
                     lk.lrt_pvalues_plain(ml.lam, ml.logf, blk, nc, l0,
                                          None))})
        blk64 = blocks64[case][2]
        for kern, fk, fp, lm in (
                (kernels.WALD_TAIL_F64, lk.wald_pvalues_cuda,
                 lk.wald_pvalues_plain, lam.double()),
                (kernels.SCORE_TAIL_F64, lk.score_pvalues_cuda,
                 lk.score_pvalues_plain, l_score.double())):
            _profile(kern, case, lambda: fk(lm, blk64, nc),
                     {**extra, **_gap(fk(lm, blk64, nc), fp(lm, blk64, nc))})
        del blk, blk64
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
