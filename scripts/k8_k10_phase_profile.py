"""Where the mvLMM test kernel K10 (mph_calc_p) and the linear model's
kernel K8 (lm_tail) spend their time, on the card: both built with
-DGT_PROFILE, which turns on their phase marks.  K10's are those of
csrc/mvlmm_lane.cuh (MvProf: a lane's leader thread adds the clock64()
cycles since its last mark to the phase it closes): staging the
individuals' values, the sums over n, the barriers and reductions,
EigenProc, the tail's algebra (the eliminations, beta, Vbeta, the
statistic) and the chi-square tails.  K8's are common.cuh's GT_PROF
marks on thread 0 of a block: the tile form's waits for its staged
chunks, the sums over n, the projections and the tests with the
stores.

    python3 scripts/k8_k10_phase_profile.py     # on a machine with the card

K10's blocks are chip_smoke.py's phase (f) and (k) sets (`_synth_mv`,
seed 4): the protocol block (n = 757, two traits, 1 + x, every SNP) and
its GxE form (1 + env + x + x∘env) in float32 and float64, the
five-trait block (1,024 SNPs, float32), ten traits with 12 covariates
(float64, the first 64 lanes) and the two-trait -gxe block with 11
covariates (14 design rows, the first 64 lanes) in both precisions; each
at the (Vg, Ve) that K9's REML fit gives its lanes, as chip_smoke's
holds call it, and the protocol and GxE blocks also at the null's shared
(Vg, Ve), the score test's form.  K8's are chip_smoke's phase (e), (i)
and (k) rows on the seeded mouse-scale data of
scripts/k3_k7_phase_profile.py (n = 1,940): the 12,226 SNP rows with an
intercept, 2,048 seeded gene rows, and the SNP rows with 24 and 40
covariates, both precisions.

A line a (kernel, case): the median ms of chip_smoke's time_ms (CUDA
events, the L2 flushed, the host's enqueue included), the device's ms
alone (chip_smoke._time_device_ms), each CUDA kernel's device ms
(torch.profiler), each phase's share of the marked cycles and its part
of the device ms, and the call's largest differences from its plain
version; then the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys
import types

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.cli import parse_args  # noqa: E402
from gemma_torch.dataset import load_dataset  # noqa: E402
from gemma_torch.models import lm  # noqa: E402
from gemma_torch.models import mvlmm_core as mvc  # noqa: E402
from gemma_torch.models.mvlmm import MvlmmNull  # noqa: E402
from gemma_torch.run import _assoc_snp_indices  # noqa: E402

K10_PHASES = ("staging", "sums over n", "barriers and reductions",
              "EigenProc", "tail algebra", "chi-square tails")
K10_LANES = 12      # csrc/mvlmm_lane.cuh MV_PC_LANES
K8_PHASES = ("waiting for a chunk", "sums over n", "projections", "-",
             "tests")
K8_BLOCKS = 8       # csrc/common.cuh GT_PC_LANES
PROFILED = (kernels.MPH_CALC_P, kernels.MPH_CALC_P_F64, kernels.LM_TAIL,
            kernels.LM_TAIL_F64)
GENES, GENE_SEED = 2048, 14


def _read(kern):
    """The kernel's profile counters, zeroed as they are read."""
    if kern._lib is None:
        kern._load()
    buf = (ctypes.c_ulonglong * 16)()
    kern._lib.gt_prof_read(buf)
    return list(buf)


def _kernel_ms(fn):
    """Device ms of one call by CUDA kernel (torch.profiler)."""
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


def _profile(kern, case, fn, phases, unit_slot, extra):
    fn()
    torch.cuda.synchronize()
    _read(kern)
    fn()
    torch.cuda.synchronize()
    cnt = _read(kern)
    ms = cs.time_ms(fn, 10)
    dev_ms = cs._time_device_ms(fn, 10)[0]
    cyc = cnt[:len(phases)]
    tot = max(sum(cyc), 1)
    base = dev_ms if dev_ms is not None else ms
    print(json.dumps({
        "kernel": kern.name, "case": case, "ms": ms, "device_ms": dev_ms,
        "kernel_ms": _kernel_ms(fn), "marked": cnt[unit_slot],
        "cycles_per_marked": tot / max(cnt[unit_slot], 1),
        "phase_share": {nm: c / tot for nm, c in zip(phases, cyc) if c},
        "phase_device_ms": {nm: base * c / tot
                            for nm, c in zip(phases, cyc) if c},
        **extra}), flush=True)


def _k10(case, o, X0, R, V, E, logl=None):
    """K10 on one block at (V, E): its profile line and its gaps."""
    kern = kernels.variant(kernels.MPH_CALC_P, kernels.MPH_CALC_P_F64,
                           o["ev"].dtype)
    a = (o["ev"], X0, o["Y"], R, V, E)
    if logl is not None:
        a = a + logl
    got, want = mvc.mph_calc_p_cuda(*a), mvc.mph_calc_p_plain(*a)
    se = torch.sqrt(torch.diagonal(want.Vbeta, dim1=-2, dim2=-1))
    ok = torch.isfinite(want.p) & torch.isfinite(got.p)
    _profile(kern, case, lambda: mvc.mph_calc_p_cuda(*a), K10_PHASES,
             K10_LANES, {
                 "S": R.shape[0], "d": o["Y"].shape[0],
                 "c": X0.shape[0] + R.shape[1],
                 "shared_VgVe": V.dim() == 3 and V.shape[0] == 1,
                 "p_max_abs": float((got.p - want.p)[ok].abs().max()),
                 "beta_max_over_se": float(((got.beta - want.beta).abs()
                                            / se).max())})


def _k10_cases(dev, td):
    base = f"-g {td}/mv_geno.txt.gz -outdir {td} -no-check".split()
    cs._run(base + f"-p {td}/mv_pheno.txt -gk 1 -o MK".split(), "cuda")
    mvk = base + f"-k {td}/MK.cXX.txt".split()
    n12, mvx = "-n 1 2".split(), f"-gxe {td}/mv_env.txt".split()
    f32, f64 = torch.float32, torch.float64
    skip = types.SimpleNamespace()

    def operands(argv, dt, null=None):
        cfg = parse_args(argv)
        idx = _assoc_snp_indices(load_dataset(cfg))
        return cfg, cs._mv_operands(argv, idx, dev, (dt,), null)[dt]

    def em(o, X0, R, nul, B, staged):
        a = (True, 1000, 1e-3, o["ev"], X0, o["Y"], R, nul.Vg_start[None],
             nul.Ve_start[None], B, staged)
        r = mvc.mph_em_cuda(*a)
        return r.Vg, r.Ve, r.logl

    p12 = mvk + ["-p", f"{td}/mv_pheno.txt"] + n12 + mvx + ["-lmm", "1"]
    for dt, tag in ((f32, ""), (f64, "_f64")):
        _, o = operands(p12, dt)
        nul, nx = o["null"], o["null_x"]
        V, E, logl = em(o, o["X0"], o["R1"], nul, nul.B_start[None], True)
        _k10("protocol" + tag, o, o["X0"], o["R1"], V, E)
        _k10("protocol_lrt" + tag, o, o["X0"], o["R1"], V, E,
             (logl, logl - 1.0))
        _k10("protocol_shared" + tag, o, o["X0"], o["R1"],
             nul.Vg_start[None], nul.Ve_start[None])
        Bx = torch.cat([nx.B_start, nx.B_start.new_zeros((2, 1))], 1)[None]
        V, E, _ = em(o, o["X0e"], o["R2"], nx, Bx, False)
        _k10("gxe" + tag, o, o["X0e"], o["R2"], V, E)
        _k10("gxe_shared" + tag, o, o["X0e"], o["R2"],
             nx.Vg_start[None], nx.Ve_start[None])
        del o
    _, o5 = operands(mvk + ["-p", f"{td}/mv_pheno.txt", "-snps",
                            f"{td}/mv_1024.snps", "-n", "1", "2", "3", "4",
                            "5", "-lmm", "1"], f32)
    V, E, _ = em(o5, o5["X0"], o5["R1"], o5["null"],
                 o5["null"].B_start[None], True)
    _k10("d5", o5, o5["X0"], o5["R1"], V, E)
    a10 = (mvk + f"-p {td}/mv_pheno10.txt -c {td}/mv_cov12.txt -snps "
           f"{td}/mv_256.snps -lmm 4 -n".split()
           + [str(i) for i in range(1, cs.WIDE_TRAITS + 1)])
    cfg10, o10 = operands(a10, f64, skip)
    nul = MvlmmNull(o10["ev"], o10["X0"], o10["Y"], cfg10)
    R = o10["R1"][:cs.WIDE_MV_HOLD].contiguous()
    V, E, _ = em(o10, o10["X0"], R, nul, nul.B_start[None], True)
    _k10("d10_f64", o10, o10["X0"], R, V, E)
    for dt, tag in ((f32, ""), (f64, "_f64")):
        _, o = operands(mvk + f"-p {td}/mv_pheno10.txt -c {td}/mv_cov11.txt"
                        f" -snps {td}/mv_1024.snps".split() + n12 + mvx
                        + ["-lmm", "1"], dt)
        nx = o["null_x"]
        R = o["R2"][:cs.WIDE_MV_HOLD].contiguous()
        B = torch.cat([nx.B_start, nx.B_start.new_zeros(
            (nx.B_start.shape[0], 1))], 1)[None]
        V, E, _ = em(o, o["X0e"], R, nx, B, False)
        _k10("gxe14" + tag, o, o["X0e"], R, V, E)


def _k8_cases(dev):
    from k3_k7_phase_profile import _data
    data = _data(dev)
    for dt in (torch.float32, torch.float64):
        kern = kernels.variant(kernels.LM_TAIL, kernels.LM_TAIL_F64, dt)
        tag = "" if dt == torch.float32 else "_f64"
        _, _, y, X, W24, _ = data[dt]
        n = y.shape[0]
        W40 = torch.as_tensor(np.column_stack(
            [np.ones(n), np.random.default_rng(cs.CVT40_SEED).normal(
                size=(n, cs.CVT40_N - 1))]), dtype=dt, device=dev)
        genes = torch.as_tensor(np.random.default_rng(GENE_SEED).normal(
            size=(GENES, n)), dtype=dt, device=dev)
        X = X.contiguous()
        for case, rows, gene, W in (
                ("mouse_snps", X, False, W24[:, :1].contiguous()),
                ("genes", genes, True, W24[:, :1].contiguous()),
                ("c24", X, False, W24),
                ("c40", X, False, W40)):
            consts = lm.lm_consts(W, y)
            a = (rows, y, W, consts, gene, False)
            got, want = lm.lm_tail_cuda(*a), lm.lm_tail_plain(*a)
            ok = torch.isfinite(want.p_wald) & torch.isfinite(got.p_wald)
            err = max(float((getattr(got, f) - getattr(want, f))[ok].abs()
                            .max()) for f in ("p_wald", "p_lrt", "p_score"))
            _profile(kern, case + tag, lambda: lm.lm_tail_cuda(*a),
                     K8_PHASES, K8_BLOCKS, {
                         "S": rows.shape[0], "n": n, "c": W.shape[1],
                         "p_max_abs": err, "beta_max_over_se": float(
                             ((got.beta - want.beta).abs() / want.se)[ok]
                             .max())})


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    td = os.path.join(kernels.REPO_ROOT, "build", "k8_k10_profile")
    os.makedirs(td, exist_ok=True)
    cs._synth_mv(td)
    for k in PROFILED:
        k._flags = (lambda f=k._flags: f() + ("-DGT_PROFILE",))
    kernels.build_all()
    _k8_cases(dev)
    _k10_cases(dev, td)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
