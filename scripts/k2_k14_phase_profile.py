"""Where K14 (calc_crt) and K2 (lambda_grid) spend their time, on the
card: both built with -DGT_PROFILE, which turns on the phase marks of
csrc/common.cuh (GT_PROF): thread 0 of every block adds the clock64()
cycles since its last mark to the phase it closes.  A phase's share is
its part of the blocks' summed cycles.

    python3 scripts/k2_k14_phase_profile.py     # on a machine with the card

K14 (calc_crt.cu's CRT_PH_* marks): the lane's serial algebra
(EigenProc, the c×c inverses, Z), the set-up on the block (Gram blocks,
Qi, Qs), building each individual's operands (Hi, P, F and the rows
P D_v Hi), the sums over n, C = SS Z and Y = Qi (L'Z), the pair traces
and the final sums over the pairs.  It runs on chip_smoke.py's phase (f)
and (k) data (`_synth_mv`, seed 4) at the lanes chip_smoke holds it on:
those that the paths `-lmm 4 -n 1 2 -crt -pnr 0.9 -precision float64`
(protocol, d = 2), `-n 1 2 3 4 5 -lmm 1 -crt` on 1,024 SNPs (d = 5) and
the ten-trait `-lmm 4 -crt` with 12 covariates on 256 SNPs (d = 10, c =
13, the first WIDE_CRT_HOLD refined lanes) refined, at their Newton
optima (chip_smoke._crt_args).

K2 (lambda_grid.cu's LG_PH_* marks): assembling row 0 of both weight
powers, the recurrence steps, and dev1 with its store.  It runs on the
seeded mouse-shape blocks of scripts/k3_k7_phase_profile.py (n = 1,940):
24 covariates on the first 2,048 SNPs, the -gxe block with 22 of them
plus env and x (c = 24 a lane) on the first 1,024, and 40 covariates (an
intercept and 39 normal columns; -gxe 38 plus env and x) on the first
128 SNPs each, as chip_smoke's phase (i) and (k) holds; REML, the fine
grid of the float32 λ search.

A line a case: the call's ms (CUDA events, one call after a warm-up),
each phase's share of the marked cycles and its part of the ms (a
proportion of thread 0's cycles, summed over blocks: where a kernel
launches stages of different occupancy, `kernel_ms`, each CUDA kernel's
device ms from torch.profiler, is the measure), the cycles a lane (K14)
or a block (K2); then the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.models import mvlmm_core as mvc  # noqa: E402
from gemma_torch.models.lmm import likelihood as lk  # noqa: E402
from gemma_torch.models.lmm import optimize as opt  # noqa: E402
from gemma_torch.models.lmm.engine import gxe_batch_data  # noqa: E402
from k3_k7_phase_profile import _blocks, _data  # noqa: E402

K14_PHASES = ("serial algebra", "set-up on the block", "build operands",
              "sums over n", "C and Y", "pair traces", "final sums")
K2_PHASES = ("row assembly", "recurrence steps", "dev1 and store")
C40, LANES40, SEED40 = 40, 128, 40
# counter slot csrc/common.cuh GT_PC_LANES: K14 counts its lanes, K2 its
# blocks
MARKED = 8


def _read(kern):
    """The kernel's profile counters, zeroed as they are read."""
    if kern._lib is None:
        kern._load()
    buf = (ctypes.c_ulonglong * 16)()
    kern._lib.gt_prof_read(buf)
    return list(buf)


def _stage_ms(fn):
    """Device ms of one call by CUDA kernel (torch.profiler): a kernel
    that launches several (K14's stages) shows each."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t > 0:
            out[ev.key.split("(")[0]] = t / 1e3
    return out


def _profile(kern, phases, case, fn, extra):
    """One line: fn timed once after a warm-up, its phases' shares of the
    marked cycles, and each CUDA kernel's device ms."""
    fn()
    torch.cuda.synchronize()
    _read(kern)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    cnt = _read(kern)
    cyc = cnt[:len(phases)]
    tot = max(sum(cyc), 1)
    print(json.dumps({
        "kernel": kern.name, "case": case, "ms": ms,
        "marked": cnt[MARKED], "cycles_per_marked": tot / max(cnt[MARKED], 1),
        "phase_share": {nm: c / tot for nm, c in zip(phases, cyc)},
        "phase_ms": {nm: ms * c / tot for nm, c in zip(phases, cyc)},
        "kernel_ms": _stage_ms(fn), **extra}), flush=True)


def _k14(dev):
    td = os.path.join(kernels.REPO_ROOT, "build", "k2_k14_profile")
    os.makedirs(td, exist_ok=True)
    cs._synth_mv(td)
    base = f"-g {td}/mv_geno.txt.gz -outdir {td} -no-check".split()
    cs._run(base + f"-p {td}/mv_pheno.txt -gk 1 -o MK".split(), "cuda")
    mvk = base + f"-k {td}/MK.cXX.txt".split()
    crt = "-crt -pnr 0.9".split()
    n5 = "-n 1 2 3 4 5".split()
    n10 = ["-n"] + [str(i) for i in range(1, cs.WIDE_TRAITS + 1)]
    cases = (
        ("protocol", mvk + f"-p {td}/mv_pheno.txt -n 1 2 -precision "
         "float64 -lmm 4".split() + crt, "MRd", None, None),
        ("d5", mvk + f"-p {td}/mv_pheno.txt -snps {td}/mv_1024.snps -lmm "
         "1".split() + n5 + crt, "M5R", None, None),
        ("d10", mvk + f"-p {td}/mv_pheno10.txt -c {td}/mv_cov12.txt -snps "
         f"{td}/mv_256.snps -lmm 4".split() + n10 + crt, "W10",
         cs.WIDE_CRT_HOLD, True))
    for case, argv, tag, lanes, keep in cases:
        cs._run(argv + ["-o", tag], "cuda", keep=bool(keep))
        res = cs.RESULTS[tag]
        null = res.get("null") if keep else None
        o = cs._mv_operands(argv, res["snp_indices"], dev,
                            (torch.float64,), null)[torch.float64]
        a = cs._crt_args(o, tag, lanes)
        _profile(kernels.CALC_CRT, K14_PHASES, case,
                 lambda: mvc.calc_crt_cuda(*a),
                 {"S": a[2].shape[0], "n": a[0].shape[0],
                  "d": a[3].shape[-1], "c": a[1].shape[0] + 1})


def _k2(dev):
    d = _data(dev)[torch.float32]
    ev, U, y, X, W24, env = d
    Uty = U.T @ y
    rng = np.random.default_rng(SEED40)
    W = torch.as_tensor(np.column_stack(
        [np.ones(ev.shape[0]), rng.normal(size=(ev.shape[0], C40 - 1))]),
        dtype=torch.float32, device=dev)
    x = X[:LANES40]
    blocks = [b for b in _blocks(d) if b[0] != "mouse_c1"] + [
        ("c40", C40, lk.build_batch_data(ev, U.T @ W, Uty,
                                         (x @ U).contiguous(), C40)),
        ("gxe_c40", C40, gxe_batch_data(ev, U.T @ W[:, :C40 - 2], U.T @ env,
                                        Uty, x @ U, (x * env) @ U,
                                        C40 - 2))]
    fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    n = ev.shape[0]
    for case, nc, blk in blocks:
        gp = lk.grid_products(fine, blk, nc)
        _profile(kernels.LAMBDA_GRID, K2_PHASES, case,
                 lambda: lk.grid_epilogue_cuda(gp, n, nc, False, True),
                 {"S": lk.n_lanes(blk), "G": len(fine), "n_cvt": nc})


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in (kernels.CALC_CRT, kernels.LAMBDA_GRID):
        k._flags = (lambda f=k._flags: f() + ("-DGT_PROFILE",))
    kernels.build_all()
    _k2(dev)
    _k14(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
