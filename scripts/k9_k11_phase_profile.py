"""Where the mvLMM kernels K9 (mph_em) and K11 (mph_nr) spend their time,
on the card: both built with -DGT_PROFILE, which turns on the phase marks
of csrc/mvlmm_lane.cuh (MvProf): a lane's leader thread adds the
clock64() cycles since its last mark to the phase it closes (staging the
individuals' values, the sums over n, the barriers and the team's
reductions, EigenProc with its Jacobi sweeps and PD tests, GLS and the
logl with the exit tests, K9's M-step or K11's step control, K11's
derivative algebra with the Hessian, and the Hessian's inverse).
Counters give the lanes, the EM or Newton iterations and the passes.

    python3 scripts/k9_k11_phase_profile.py     # on a machine with the card

The data are chip_smoke.py's phase (f) and (k) sets (`_synth_mv`, seed
4): the kinship from `-gk`, then the blocks chip_smoke holds K9 and K11
on: the protocol block (n = 757, two traits, 1 + x, float32, every
SNP), its GxE form (1 + env + x + x∘env), the five-trait block (1,024
SNPs), and at ten traits with 12 covariates (float64) the first 64 lanes
for K9 and 16 for K11; K9 as -lmm 1's REML fit (staged, to the Newton
switch in float32), K11 from K9's optimum (10 iterations), as
chip_smoke's holds call them.  Also the two null fits (MvlmmNull, S = 1
launches of K9 and K11, with `mph_initial`'s 45 two-trait fits at ten
traits), timed apart.  A line a case and kernel: the call's ms (CUDA
events, one call after a warm-up; a null fit's seconds on the host's
clock, one call), each phase's share of the leaders' cycles and its part
of the ms, the cycles, iterations and passes a lane; then the card's
name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.cli import parse_args  # noqa: E402
from gemma_torch.dataset import load_dataset  # noqa: E402
from gemma_torch.models import mvlmm_core as mvc  # noqa: E402
from gemma_torch.models.mvlmm import MvlmmNull  # noqa: E402
from gemma_torch.run import _assoc_snp_indices  # noqa: E402

PHASES = ("staging", "sums over n", "barriers and reductions", "EigenProc",
          "GLS and logl", "step control", "derivatives and Hessian",
          "Hessian inverse")
# counter slots (csrc/mvlmm_lane.cuh MV_PC_*)
LANES, ITERS, LIK, DER = 12, 13, 14, 15
PROFILED = (kernels.MPH_EM, kernels.MPH_EM_F64, kernels.MPH_NR,
            kernels.MPH_NR_F64)


def _read(kern):
    """The kernel's profile counters, zeroed as they are read."""
    if kern._lib is None:
        kern._load()
    buf = (ctypes.c_ulonglong * 16)()
    kern._lib.gt_prof_read(buf)
    return list(buf)


def _line(case, kern, cnt, ms, extra=None):
    cyc = cnt[:len(PHASES)]
    tot = max(sum(cyc), 1)
    lanes = max(cnt[LANES], 1)
    out = {"kernel": kern.name, "case": case, "lanes": cnt[LANES],
           "ms": ms, "cycles_per_lane": sum(cyc) / lanes,
           "iters_per_lane": cnt[ITERS] / lanes,
           "lik_passes_per_lane": cnt[LIK] / lanes,
           "deriv_passes_per_lane": cnt[DER] / lanes,
           "phase_share": {nm: c / tot for nm, c in zip(PHASES, cyc)},
           "phase_ms": ({nm: ms * c / tot for nm, c in zip(PHASES, cyc)}
                        if ms is not None else None)}
    print(json.dumps({**out, **(extra or {})}), flush=True)


def _timed_call(fn):
    """(result, ms) of one call after a warm-up, CUDA events; the
    profile counters hold the timed call alone."""
    fn()
    torch.cuda.synchronize()
    for k in PROFILED:
        _read(k)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    r = fn()
    b.record()
    b.synchronize()
    return r, a.elapsed_time(b)


def _profile_block(case, o, X0, R, nul, B, staged, cap, nr_lanes=None):
    """K9 as chip_smoke's hold calls it on (X0, R), then K11 from its
    optimum; one line each."""
    dt = o["ev"].dtype
    k9, k11 = ((kernels.MPH_EM, kernels.MPH_NR) if dt == torch.float32
               else (kernels.MPH_EM_F64, kernels.MPH_NR_F64))
    a = (True, cap, 1e-3, o["ev"], X0, o["Y"], R, nul.Vg_start[None],
         nul.Ve_start[None], B, staged)
    em, ms = _timed_call(lambda: mvc.mph_em_cuda(*a))
    _line(case, k9, _read(k9), ms,
          {"S": R.shape[0], "d": o["Y"].shape[0],
           "c": X0.shape[0] + R.shape[1],
           "mean_iters_out": float((em.iters.double() + 1).mean())})
    m = nr_lanes or R.shape[0]
    a = (True, 10, 1e-3, o["ev"], X0, o["Y"], R[:m].contiguous(),
         em.Vg[:m], em.Ve[:m])
    _, ms = _timed_call(lambda: mvc.mph_nr_cuda(*a))
    _line(case, k11, _read(k11), ms, {"S": m})


def _null_fit(case, o, X0, cfg, kerns):
    """One MvlmmNull on (X0, o's Y): (its seconds on the host's clock,
    the fit); a line for each of K9 and K11 over all the fit's
    launches."""
    torch.cuda.synchronize()
    for k in PROFILED:
        _read(k)
    before = {k.name: k.launches for k in kerns}
    t0 = time.perf_counter()
    nul = MvlmmNull(o["ev"], X0, o["Y"], cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for k in kerns:
        _line(case, k, _read(k), None, {
            "null_fit_s": secs, "launches": k.launches - before[k.name]})
    return secs, nul


def main():
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    td = os.path.join(kernels.REPO_ROOT, "build", "k9_k11_profile")
    os.makedirs(td, exist_ok=True)
    cs._synth_mv(td)
    for k in PROFILED:
        k._flags = (lambda f=k._flags: f() + ("-DGT_PROFILE",))
    kernels.build_all()
    base = f"-g {td}/mv_geno.txt.gz -outdir {td} -no-check".split()
    cs._run(base + f"-p {td}/mv_pheno.txt -gk 1 -o MK".split(), "cuda")
    mvk = base + f"-k {td}/MK.cXX.txt".split()
    n12, mvx = "-n 1 2".split(), f"-gxe {td}/mv_env.txt".split()
    f32, f64 = torch.float32, torch.float64
    skip = types.SimpleNamespace()      # a null that _mv_operands keeps

    def operands(argv, dt, null=None):
        cfg = parse_args(argv)
        idx = _assoc_snp_indices(load_dataset(cfg))
        return cfg, cs._mv_operands(argv, idx, dev, (dt,), null)[dt]

    # the protocol block and its GxE form (-lmm 1 -gxe's operands)
    p12 = mvk + ["-p", f"{td}/mv_pheno.txt"] + n12
    cfg, o = operands(p12 + mvx + ["-lmm", "1"], f32)
    _profile_block("protocol", o, o["X0"], o["R1"], o["null"],
                   o["null"].B_start[None], True, mvc.nr_switch_point(1000))
    nx = o["null_x"]
    Bx = torch.cat([nx.B_start, nx.B_start.new_zeros((2, 1))], 1)[None]
    _profile_block("gxe", o, o["X0e"], o["R2"], nx, Bx, False, 1000)
    null_d2, _ = _null_fit("null_d2", o, o["X0"], cfg,
                           (kernels.MPH_EM, kernels.MPH_NR))
    # five traits on 1,024 SNPs
    _, o5 = operands(mvk + ["-p", f"{td}/mv_pheno.txt", "-snps",
                            f"{td}/mv_1024.snps", "-n", "1", "2", "3", "4",
                            "5", "-lmm", "1"], f32)
    _profile_block("d5", o5, o5["X0"], o5["R1"], o5["null"],
                   o5["null"].B_start[None], True,
                   mvc.nr_switch_point(1000))
    # ten traits, 12 covariates, float64: the null fit, then its block
    a10 = (mvk + f"-p {td}/mv_pheno10.txt -c {td}/mv_cov12.txt -snps "
           f"{td}/mv_256.snps -lmm 4 -n".split()
           + [str(i) for i in range(1, cs.WIDE_TRAITS + 1)])
    cfg10, o10 = operands(a10, f64, skip)
    null_d10, nul = _null_fit("null_d10", o10, o10["X0"], cfg10,
                              (kernels.MPH_EM_F64, kernels.MPH_NR_F64))
    _profile_block("d10", o10, o10["X0"],
                   o10["R1"][:cs.WIDE_MV_HOLD].contiguous(), nul,
                   nul.B_start[None], True, 1000, cs.WIDE_NR_HOLD)
    print(json.dumps({"null_fit_seconds": {"d2_protocol_float32": null_d2,
                                           "d10_float64": null_d10}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
