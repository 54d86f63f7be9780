#!/usr/bin/env python3
"""Smoke run of gemma_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the kernels from gemma_torch/csrc (one nvcc per source, all at
   once) into build/gemma_torch/.
2. Drives the port's paths through `gemma_torch.run.batch_run` on the
   card, on a mouse_hs1940-scale BIMBAM file (n = 1940, p = 12,226, 3%
   missing, seed 0) and a small PLINK set (n = 400, p = 2,000, three
   covariates):
     main path    `-gk` then `-k K.cXX.txt -lmm 1`;
     PLINK path   `-gk 2`, then `-c` `-lmm 1`;
     (a) lmm4     `-lmm 4` at full width (speed mode, float32);
     (b) lmm4_f64 `-precision float64` `-gk` and `-lmm 4` (parity mode);
     (c) modes    PLINK `-eigen`, `-u/-d -lmm 9` beside `-k -lmm 9`,
                  `-lmm 5`, `-widv -lmm 2`;
     (e) slice 3  on the mouse set: `-gk -loco 1 -a` then `-lmm 1 -loco
                  1 -a` (19 chromosomes, as the PLINK .bim), `-lmm 4
                  -gxe` (a binary environment) and `-lmm 4 -gene` (2,048
                  genes) in float32 and float64, `-lm 4` with and
                  without `-gene` and in float64.
   Every kernel's launch count is set to 0 just before each path and
   read just after; each kernel of the path must have launched.
3. Checks the output against the port's own float64 path on the CPU on
   the same K file, first 1024 SNPs: the main path's p_wald and (a)'s
   p_wald/p_lrt/p_score within 1e-3 (the speed-mode contract), >= 97%
   finite; (b)'s within 1e-6 with the same NaN lanes on >= 99.9% of
   SNPs, and its kinship within 1e-9 (relative to the largest entry) of
   the CPU's float64 `-gk`; (c)'s `-u/-d` p-values within 1e-3 of the
   `-k` run's; (e)'s against the port's float64 CPU run on the same
   files, first 1024 SNPs or genes: within 1e-3 in float32, >= 97%
   finite and no NaN p_lrt in gene mode, within 1e-6 in float64 with
   >= 99.9% the same NaN lanes; its float64 LOCO kinship within 1e-9 of
   the CPU's.
4. Holds each kernel against its plain PyTorch version on the card, on
   the same inputs, at the main path's shapes (n = 1940, S = the run's
   block, c = 1, and c = 3 for K2-K7; the per-lane forms of K2-K7 at the
   GxE shapes, c = 1 plus env and x, and at the gene shapes, 2,048
   genes; K8 on SNP rows and gene rows), with the tolerances below, and
   times both (CUDA events, median after warm-up, L2 flushed between
   runs).
5. Prints the card's name and power limit, the kernels line and, last,
   {"ok": true, "device": {...}}; the whole report is also written to
   build/chip_smoke.out.

Any failed phase raises, and the script exits non-zero without the last
line.  Without a CUDA device it exits non-zero at once.  Imports nothing
of JAX or of the reference package.
"""

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(HERE, "build", "chip_smoke.out")

# memory rate, float32 and float64 (non-tensor) rates of one H100 SXM
# (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
L2_FLUSH_BYTES = 64 << 20        # more than the H100's 50 MB L2

# kernel vs plain version on the same inputs (float32 on the card: the
# two sum in different orders and the kernels contract to FMA; float64:
# the same, at float64 rounding)
TOL = {
    # operand values are O(1); the row mean is a float32 sum of <= 1940
    # integers, exact, divided once
    "geno_prologue": "|x - x_plain| <= 1e-5",
    # dev1 = -(df - trace_p)/(2λ) + ...: df and trace_p cancel, so one
    # float32 rounding of ~n is amplified by 1/λ (λ down to 1e-5)
    "lambda_grid": "|d1 - d1_plain| <= 1e-5 max|d1_plain| + 8 n eps32 / λ_g",
    # Newton stops within 5e-4 relative of the root, and where the
    # likelihood is flat two float32 evaluations may pick different
    # near-tied candidates: compare what λ feeds through the same (plain)
    # tail — p_wald for the REML fit, p_lrt for the ML fit — at the
    # speed-mode contract, and logf tightly
    "lambda_solve": "|p(λ) - p(λ_plain)| <= 1e-3 (p_wald of REML λ, "
                    "p_lrt of ML λ), |logf - logf_plain| <= 1e-4 "
                    "|logf_plain|, same finite lanes",
    "wald_tail": "|p - p_plain| <= 1e-5, |beta - beta_plain| <= 1e-3 se",
    "score_tail": "|p - p_plain| <= 1e-5, |beta - beta_plain| <= 1e-3 se",
    # float64 sums of float32 operands in both: logl agrees to float64
    # rounding of n terms; p = Q(1/2, Δ) has slope ~1/sqrt(πΔ) at small
    # Δ, so a 1e-12 difference in Δ moves p by up to ~1e-6
    "lrt_tail": "|logl - logl_plain| <= 1e-12 |logl_plain|, "
                "|p - p_plain| <= 1e-6 (tail only, parity: <= 1e-12)",
    # float64: λ through the same Wald tail; a Newton exit test at its
    # 1e-5 boundary may keep a neighbouring iterate, and a lane at the
    # NaN-poisoning edge may flip
    "lambda_solve_f64": "|p_wald(λ) - p_wald(λ_plain)| <= 1e-6, "
                        "|logf - logf_plain| <= 1e-9 |logf_plain|, "
                        ">= 99.9% same NaN lanes",
    "geno_prologue_f64": "|x - x_plain| <= 1e-12",
    "wald_tail_f64": "|p - p_plain| <= 1e-10, |beta - beta_plain| <= 1e-8 se",
    "score_tail_f64": "|p - p_plain| <= 1e-10, "
                      "|beta - beta_plain| <= 1e-8 se",
    # both sum in float64 from the same operands, in another order
    "lm_tail": "|p - p_plain| <= 1e-6, |beta - beta_plain| <= 1e-5 se",
    "lm_tail_f64": "|p - p_plain| <= 1e-12, "
                   "|beta - beta_plain| <= 1e-10 se",
}
# the per-lane forms of K2-K7 (GxE, gene mode) are held to their shared
# forms' tolerances, but for the float32 tests: at GxE's 3 covariates
# (1 + env + x) four columns are eliminated in float32, and the shared
# c = 3 form already reached 9.9e-6 (PERF.md)
TOL_LANE = {
    "wald_tail": "|p - p_plain| <= 3e-5, |beta - beta_plain| <= 1e-3 se",
    "score_tail": "|p - p_plain| <= 3e-5, |beta - beta_plain| <= 1e-3 se",
}

GENES, GENE_SIGNAL = 2048, 8

MOUSE_N, MOUSE_P = 1940, 12226
PLINK_N, PLINK_P, PLINK_COV = 400, 2000, 2
CHECK_SNPS = 1024
P_COLS = ("p_wald", "p_lrt", "p_score")


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _synth_mouse(td, n=MOUSE_N, p=MOUSE_P, seed=0):
    """mouse_hs1940-scale BIMBAM gz + pheno (3% missing dosages), the
    same recipe as the reference package's bench."""
    rng = np.random.default_rng(seed)
    geno = os.path.join(td, "geno.txt.gz")
    pheno = os.path.join(td, "pheno.txt")
    block = 1024
    with gzip.open(geno, "wt", compresslevel=1) as fh:
        for s in range(0, p, block):
            k = min(block, p - s)
            maf = rng.uniform(0.05, 0.5, k)
            X = rng.binomial(2, maf[:, None], size=(k, n)).astype(np.int8)
            miss = rng.random((k, n)) < 0.03
            for j in range(k):
                vals = np.char.mod("%d", X[j]).astype(object)
                vals[miss[j]] = "NA"
                fh.write(f"rs{s + j}, A, T, " + ", ".join(vals) + "\n")
    with open(pheno, "w") as fh:
        for v in rng.normal(size=n):
            fh.write(f"{v:.6f}\n")
    return geno, pheno


def _synth_plink(td, n=PLINK_N, p=PLINK_P, n_cov=PLINK_COV, seed=1):
    """PLINK .bed/.bim/.fam (3% missing, heritable phenotype) and a
    covariate file: intercept + n_cov columns."""
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.05, 0.5, p)
    X = rng.binomial(2, maf[:, None], size=(p, n)).astype(np.int8)
    X[rng.random((p, n)) < 0.03] = -1
    codes = np.array([3, 2, 0, 1], np.uint8)[X]
    nb = (n + 3) // 4
    codes = np.concatenate([codes, np.ones((p, 4 * nb - n), np.uint8)], 1)
    codes = codes.reshape(p, nb, 4)
    packed = (codes[:, :, 0] | (codes[:, :, 1] << 2) | (codes[:, :, 2] << 4)
              | (codes[:, :, 3] << 6)).astype(np.uint8)
    prefix = os.path.join(td, "plink")
    with open(prefix + ".bed", "wb") as fh:
        fh.write(bytes([0x6C, 0x1B, 0x01]) + packed.tobytes())
    with open(prefix + ".bim", "w") as fh:
        for j in range(p):
            fh.write(f"{j % 19 + 1}\trs{j}\t0\t{100 * j}\tA\tT\n")
    Xf = np.where(X < 0, 0.0, X.astype(float))
    g = rng.normal(size=p) @ (Xf - Xf.mean(1, keepdims=True))
    y = g / g.std() * 0.7 + rng.normal(size=n) * 0.7
    with open(prefix + ".fam", "w") as fh:
        for i in range(n):
            fh.write(f"F{i}\tI{i}\t0\t0\t0\t{y[i]:.6f}\n")
    cov = os.path.join(td, "cov.txt")
    C = np.column_stack([np.ones(n), rng.normal(size=(n, n_cov))])
    np.savetxt(cov, C, fmt="%.6f", delimiter="\t")
    return prefix, cov


def _synth_slice3(td, pheno, n=MOUSE_N, p=MOUSE_P, seed=3):
    """Annotation (chromosome j % 19 + 1 as in _synth_plink's .bim), a
    binary environment, and GENES expression rows with the first
    GENE_SIGNAL tied to the phenotype (plus the first CHECK_SNPS rows
    alone, for the CPU check)."""
    rng = np.random.default_rng(seed)
    with open(f"{td}/anno.txt", "w") as fh:
        fh.write("".join(f"rs{j}\t{100 * j}\t{j % 19 + 1}\n"
                         for j in range(p)))
    env = rng.integers(0, 2, n)
    np.savetxt(f"{td}/env.txt", env, fmt="%d")
    y = np.loadtxt(pheno)
    E = rng.normal(size=(GENES, n))
    E[:GENE_SIGNAL] += 0.4 * y
    head = "geneID " + " ".join(f"I{i}" for i in range(n)) + "\n"
    for name, rows in (("expr", E), ("expr_check", E[:CHECK_SNPS])):
        with open(f"{td}/{name}.txt", "w") as fh:
            fh.write(head)
            for g, e in enumerate(rows):
                fh.write(f"g{g} " + " ".join(np.char.mod("%.6f", e)) + "\n")
    return env, E


def _read_assoc(path):
    """(rs list, {column: float array}) of an assoc.txt (geneID for the
    gene-mode files)."""
    with open(path) as fh:
        head = fh.readline().split()
        rows = [ln.split() for ln in fh]
    key = "rs" if "rs" in head else "geneID"
    rs = [r[head.index(key)] for r in rows]
    cols = {c: np.array([r[i] for r in rows], float)
            for i, c in enumerate(head) if c in P_COLS}
    return rs, cols


def _aligned(rs, cols, rs_ref):
    pos = {r: i for i, r in enumerate(rs)}
    return {c: v[[pos[r] for r in rs_ref]] for c, v in cols.items()}


def _log_times(path):
    """'time on ...' lines of a .log.txt, in seconds."""
    out = {}
    with open(path) as fh:
        for ln in fh:
            if "time" in ln and "min" in ln:
                key = ln.split("=")[0].strip("# \n")
                out[key] = float(ln.split("=")[1].split()[0]) * 60.0
    return out


def _run(argv, device):
    from gemma_torch.cli import parse_args
    from gemma_torch.run import batch_run
    import torch
    t0 = time.time()
    argv = argv + ["-silence"]
    batch_run(parse_args(argv), argv=["gemma_torch"] + argv, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return time.time() - t0


def _drive(kernels, paths, name, argvs, need):
    """Run one path with every launch count at 0; return the counts.
    Fails unless every kernel named in `need` launched."""
    kernels.reset_launches()
    secs = [(tag, _run(argv, "cuda")) for tag, argv in argvs]
    counts = {k.name: k.launches for k in kernels.ALL}
    paths[name] = {"secs": secs, "launches": counts}
    for k in need:
        if counts[k] == 0:
            raise RuntimeError(f"path {name} never launched {k}")
    return counts


def _profile(argv):
    """Warm run of one path under torch.profiler: device time by kernel
    and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _run(argv, "cuda")
    dev_ms = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if t > 0:
            dev_ms[ev.key[:80]] = t
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_s": wall, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / 1e3 / wall,
            "top_device_ms": top}


def _time_ms(fn, reps):
    """Median ms of `reps` calls after a warm-up.  Before each timed call
    a 64 MiB write, outside the events, evicts the L2, so the call reads
    its inputs from device memory as the main path does."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def _p_errors(got, ref, tol, min_finite, same_nan=None):
    """Max |Δp| per column over lanes finite in both; fails past `tol`,
    below `min_finite` finite lanes, or (float64) past `same_nan` share
    of lanes whose NaN status differs."""
    out = {}
    for c in ref:
        g, r = got[c], ref[c]
        both = np.isfinite(g) & np.isfinite(r)
        err = float(np.max(np.abs(g[both] - r[both]))) if both.any() else 0.
        nan_diff = int((np.isnan(g) != np.isnan(r)).sum())
        out[c] = {"max_abs": err, "finite": float(both.mean()),
                  "nan_lanes_differ": nan_diff}
        if both.mean() < min_finite or err > tol or (
                same_nan is not None and 1 - nan_diff / len(r) < same_nan):
            raise RuntimeError(f"{c} vs the float64 CPU path: {out[c]}")
    return out


def _say(obj):
    """Print one report line (a JSON object, or text) and append it to
    REPORT: standard output may be cut to its end by whoever reads it."""
    line = obj if isinstance(obj, str) else json.dumps(obj)
    print(line, flush=True)
    with open(REPORT, "a") as fh:
        fh.write(line + "\n")


def main():
    t_start = time.time()
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        _fail("no CUDA device: this script runs on the card only")
    sys.path.insert(0, HERE)
    try:
        from gemma_torch import kernels
    except ImportError as e:
        _fail(f"the gemma_torch package is not beside this script ({e})")
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    open(REPORT, "w").close()
    from gemma_torch import precision
    from gemma_torch.models import lm
    from gemma_torch.models.lmm import likelihood as lk
    from gemma_torch.models.lmm import optimize as opt
    from gemma_torch.models.lmm.engine import fit_null
    from gemma_torch.ops import pack2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    precision.apply_matmul_precision()
    _say(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} ({smi})")

    # 1. build
    t0 = time.time()
    kernels.build_all()
    build_s = time.time() - t0
    _say({"phase": "build", "seconds": build_s})

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    os.environ.setdefault("GEMMA_TORCH_GENO_SIDECAR_DIR",
                          os.path.join(work, "geno_cache"))
    f32_kernels = ("geno_prologue", "lambda_grid", "lambda_solve",
                   "wald_tail")
    with tempfile.TemporaryDirectory(dir=work) as td:
        # 2. the paths
        t0 = time.time()
        geno, pheno = _synth_mouse(td)
        prefix, cov = _synth_plink(td)
        np.savetxt(f"{td}/w.txt",
                   np.random.default_rng(2).uniform(0.5, 2.0, PLINK_N))
        _say({"phase": "data", "seconds": time.time() - t0})
        common = f"-g {geno} -p {pheno} -outdir {td} -no-check".split()
        kin = f"-k {td}/K.cXX.txt".split()
        paths = {}
        main_counts = _drive(kernels, paths, "gk+lmm1", [
            ("gk", common + ["-gk", "1", "-o", "K"]),
            ("lmm1", common + kin + "-lmm 1 -o A".split())], f32_kernels)
        lmm_times = _log_times(f"{td}/A.log.txt")
        gk_times = _log_times(f"{td}/K.log.txt")
        # warm repeat of -lmm 1 (kernels loaded, cuBLAS/cuSOLVER up),
        # profiled: device time by kernel and the device's busy share
        prof1 = _profile(common + kin + "-lmm 1 -o W".split())
        _say({"phase": "profile_lmm_warm", **prof1})
        plink_common = f"-bfile {prefix} -outdir {td} -no-check".split()
        pk = f"-c {cov} -k {td}/PK.sXX.txt".split()
        _drive(kernels, paths, "plink_c3", [
            ("gk2", plink_common + ["-gk", "2", "-o", "PK"]),
            ("lmm1_c3", plink_common + pk + "-lmm 1 -o PA".split())],
            f32_kernels)
        # (a) and (b): -lmm 4 at full width, speed then parity mode
        counts_a = _drive(kernels, paths, "lmm4", [
            ("lmm4", common + kin + "-lmm 4 -o A4".split())],
            f32_kernels + ("score_tail", "lrt_tail"))
        counts_b = _drive(kernels, paths, "lmm4_f64", [
            ("gk_f64", common + "-gk 1 -precision float64 -o Kd".split()),
            ("lmm4_f64", common + kin
             + "-lmm 4 -precision float64 -o A4d".split())],
            ("geno_prologue_f64", "lambda_solve_f64", "wald_tail_f64",
             "score_tail_f64", "lrt_tail"))
        prof4 = _profile(common + kin + "-lmm 4 -o W4".split())
        _say({"phase": "profile_lmm4_warm", **prof4})
        # (c) the eigen paths, -lmm 5 and -widv on the PLINK set
        _drive(kernels, paths, "plink_modes", [
            ("eigen", plink_common + pk + "-eigen -o PE".split()),
            ("ud_lmm9", plink_common + f"-c {cov} -u {td}/PE.eigenU.txt "
             f"-d {td}/PE.eigenD.txt -lmm 9 -o PU".split()),
            ("k_lmm9", plink_common + pk + "-lmm 9 -o PK9".split()),
            ("lmm5", plink_common + pk + "-lmm 5 -o P5".split()),
            ("widv_lmm2", plink_common + pk
             + f"-widv {td}/w.txt -lmm 2 -o PW".split())],
            ("geno_prologue", "lambda_grid", "lambda_solve", "score_tail",
             "lrt_tail"))
        # (e) LOCO, GxE, gene mode and -lm at full width
        t0 = time.time()
        env_np, expr_np = _synth_slice3(td, pheno)
        _say({"phase": "data_slice3",
              "seconds": time.time() - t0})
        loco = f"-a {td}/anno.txt -loco 1".split()
        gxe = f"-gxe {td}/env.txt".split()
        gene = f"-gene {td}/expr.txt".split()
        f64 = "-precision float64".split()
        lane32 = ("lambda_grid", "lambda_solve", "wald_tail", "score_tail",
                  "lrt_tail")
        lane64 = ("lambda_solve_f64", "wald_tail_f64", "score_tail_f64",
                  "lrt_tail")
        counts_e = {
            "loco": _drive(kernels, paths, "loco", [
                ("gk_loco", common + loco + "-gk 1 -o KL".split()),
                ("gk_loco_f64", common + loco + f64 + "-gk 1 -o KLd".split()),
                ("lmm1_loco", common + loco
                 + f"-k {td}/KL.cXX.txt -lmm 1 -o AL".split())],
                f32_kernels + ("geno_prologue_f64",)),
            "gxe": _drive(kernels, paths, "gxe", [
                ("gxe_lmm4", common + kin + gxe + "-lmm 4 -o X4".split())],
                ("geno_prologue",) + lane32),
            "gxe_f64": _drive(kernels, paths, "gxe_f64", [
                ("gxe_lmm4_f64", common + kin + gxe + f64
                 + "-lmm 4 -o X4d".split())],
                ("geno_prologue_f64",) + lane64),
            "gene": _drive(kernels, paths, "gene", [
                ("gene_lmm4", common + kin + gene + "-lmm 4 -o G4".split())],
                lane32),
            "gene_f64": _drive(kernels, paths, "gene_f64", [
                ("gene_lmm4_f64", common + kin + gene + f64
                 + "-lmm 4 -o G4d".split())], lane64),
            "lm": _drive(kernels, paths, "lm", [
                ("lm4", common + "-lm 4 -o L4".split()),
                ("lm4_gene", common + gene + "-lm 4 -o LG4".split()),
                ("lm4_f64", common + f64 + "-lm 4 -o L4d".split())],
                ("geno_prologue", "lm_tail", "lm_tail_f64")),
        }
        profx = _profile(common + kin + gxe + "-lmm 4 -o WX".split())
        _say({"phase": "profile_gxe_lmm4_warm", **profx})
        _say({"phase": "e2e", "paths": paths,
              "gk_log_seconds": gk_times,
              "lmm_log_seconds": lmm_times})

        # 3. output checks
        rs, cols = _read_assoc(f"{td}/A.assoc.txt")
        finite = float(np.isfinite(cols["p_wald"]).mean())
        if len(rs) < 0.9 * MOUSE_P or finite < 0.97:
            raise RuntimeError(f"{len(rs)} SNPs, {finite:.4f} finite p_wald")
        with open(f"{td}/first.snps", "w") as fh:
            fh.write("\n".join(f"rs{j}" for j in range(CHECK_SNPS)) + "\n")
        t0 = time.time()
        _run(common + kin + f"-lmm 4 -snps {td}/first.snps -o C".split(),
             "cpu")
        cpu_s = time.time() - t0
        rs_c, ref = _read_assoc(f"{td}/C.assoc.txt")
        main_err = _p_errors(_aligned(rs, cols, rs_c),
                             {"p_wald": ref["p_wald"]}, 1e-3, 0.97)
        _say({"phase": "check", "p_wald_finite": finite,
              "snps": len(rs), "cpu_f64_snps": len(rs_c),
              "cpu_f64_seconds": cpu_s,
              "p_wald_max_abs_vs_cpu_f64":
                  main_err["p_wald"]["max_abs"]})
        rs4, c4 = _read_assoc(f"{td}/A4.assoc.txt")
        err_a = _p_errors(_aligned(rs4, c4, rs_c), ref, 1e-3, 0.97)
        rs4d, c4d = _read_assoc(f"{td}/A4d.assoc.txt")
        err_b = _p_errors(_aligned(rs4d, c4d, rs_c), ref, 1e-6, 0.97,
                          same_nan=0.999)
        # the float64 kinship of the card against the CPU's, to the
        # 10 significant digits of the text
        from gemma_torch.io.readers import read_kinship
        _run(common + "-gk 1 -o Kc".split(), "cpu")
        every = np.ones(MOUSE_N, bool)
        Kd, Kc = (read_kinship(f"{td}/{k}.cXX.txt", every)
                  for k in ("Kd", "Kc"))
        gk_err = float(np.abs(Kd - Kc).max() / np.abs(Kc).max())
        if gk_err > 1e-9:
            raise RuntimeError(f"-gk float64 vs the CPU: rel {gk_err}")
        rs_u, cu = _read_assoc(f"{td}/PU.assoc.txt")
        rs_k, ck = _read_assoc(f"{td}/PK9.assoc.txt")
        err_c = _p_errors(_aligned(rs_u, cu, rs_k), ck, 1e-3, 0.97)
        resid = [np.loadtxt(f"{td}/P5.{f}.txt") for f in ("residU", "residE")]
        if any(r.shape != (PLINK_N,) or not np.isfinite(r).all()
               for r in resid):
            raise RuntimeError("-lmm 5 residuals: wrong length or not finite")
        _, cw = _read_assoc(f"{td}/PW.assoc.txt")
        w_fin = float(np.isfinite(cw["p_lrt"]).mean())
        if w_fin < 0.97 or not (cw["p_lrt"][np.isfinite(cw["p_lrt"])]
                                <= 1.0).all():
            raise RuntimeError(f"-widv -lmm 2: {w_fin:.4f} finite p_lrt")
        _say({"phase": "check_modes",
              "gk_f64_vs_cpu_f64_rel": gk_err,
              "lmm4_f32_vs_cpu_f64": err_a,
              "lmm4_f64_vs_cpu_f64": err_b,
              "ud_lmm9_vs_k_lmm9": err_c,
              "widv_p_lrt_finite": w_fin})

        # (e) against the port's float64 CPU path on the same files
        t0 = time.time()

        def cpu_ref(tag, argv):
            _run(argv + ["-o", tag], "cpu")
            return _read_assoc(f"{td}/{tag}.assoc.txt")

        _run(common + loco + "-gk 1 -o KLc".split(), "cpu")
        KLd, KLc = (read_kinship(f"{td}/{k}.cXX.txt", every)
                    for k in ("KLd", "KLc"))
        loco_k_err = float(np.abs(KLd - KLc).max() / np.abs(KLc).max())
        if loco_k_err > 1e-9:
            raise RuntimeError(f"-gk -loco float64 vs the CPU: rel "
                               f"{loco_k_err}")
        if np.allclose(KLc, Kc):
            raise RuntimeError("-gk -loco 1 left the kinship unchanged")
        chk = {"gk_loco_f64_vs_cpu_f64_rel": loco_k_err}
        rs_l, ref_l = cpu_ref("CL", common + loco
                              + f"-k {td}/KL.cXX.txt -lmm 1".split())
        rs_al, c_al = _read_assoc(f"{td}/AL.assoc.txt")
        if not rs_al or {int(r[2:]) % 19 for r in rs_al} != {0}:
            raise RuntimeError("-lmm 1 -loco 1 tested SNPs off chromosome 1")
        chk["lmm1_loco"] = _p_errors(_aligned(rs_al, c_al, rs_l),
                                     {"p_wald": ref_l["p_wald"]}, 1e-3, 0.97)
        snps1 = f"-snps {td}/first.snps".split()
        gene1 = f"-gene {td}/expr_check.txt".split()
        refs = {"X": cpu_ref("CX", common + kin + gxe + snps1
                             + "-lmm 4".split()),
                "G": cpu_ref("CG", common + kin + gene1 + "-lmm 4".split()),
                "L": cpu_ref("CLM", common + snps1 + "-lm 4".split()),
                "LG": cpu_ref("CLG", common + gene1 + "-lm 4".split())}
        for tag, ref_tag, tol, same_nan in (
                ("X4", "X", 1e-3, None), ("X4d", "X", 1e-6, 0.999),
                ("G4", "G", 1e-3, None), ("G4d", "G", 1e-6, 0.999),
                ("L4", "L", 1e-3, None), ("L4d", "L", 1e-6, 0.999),
                ("LG4", "LG", 1e-3, None)):
            rs_r, ref_r = refs[ref_tag]
            rs_t, c_t = _read_assoc(f"{td}/{tag}.assoc.txt")
            got = _aligned(rs_t, c_t, rs_r)
            if tag == "G4" and np.isnan(got["p_lrt"]).any():
                raise RuntimeError("-lmm 4 -gene float32: NaN p_lrt")
            chk[tag] = _p_errors(got, ref_r, tol, 0.97, same_nan=same_nan)
            chk[tag]["lanes"] = len(rs_t)
        _say({"phase": "check_slice3", **chk,
              "cpu_f64_seconds": time.time() - t0})

        # 4. kernels against their plain versions, main-path shapes
        from gemma_torch.config import GemmaConfig
        from gemma_torch.dataset import load_dataset
        from gemma_torch.ops.center import center_matrix
        from gemma_torch.ops.eigh import eigh_zeroed
        from gemma_torch.run import _block_size, _raw_wire_block, _to_device

        cfg = GemmaConfig(file_geno=geno, file_pheno=pheno, check=False)
        ds = load_dataset(cfg)
        n = ds.ni_test
        idx = np.flatnonzero(ds.qc.indicator_snp)
        S = _block_size(cfg, dev, len(idx), n_axis=n)
        sel = idx[:S]
        raw_a = _to_device(_raw_wire_block(
            ds, sel, S, torch.float32, all_individuals=False), dev)
        K = read_kinship(f"{td}/K.cXX.txt", ds.indicator_idv)
        y_np = ds.Y[:, 0]
    f32, f64 = torch.float32, torch.float64
    fac = {}
    for dt in (f32, f64):
        ev, U, tr = eigh_zeroed(center_matrix(
            torch.as_tensor(K, dtype=dt, device=dev)))
        fac[dt] = (ev, U, tr, torch.as_tensor(y_np, dtype=dt, device=dev))
    rng = np.random.default_rng(7)
    W3 = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])

    results = []
    per_lane = {}         # kernel → {form: record} for the per-lane forms

    def record(name, err, ms, plain_ms, nbytes, nops, peak=PEAK_F32_PER_S,
               launches=None, library_ms=None, note=None, form=None):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / peak * 1e3
        k = getattr(kernels, name.upper())
        entry = {"launches": (main_counts if launches is None
                              else launches)[name],
                 "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": library_ms, "tolerance": TOL[name]}
        if note:
            entry["note"] = note
        if form is not None:
            entry["tolerance"] = TOL_LANE.get(name, TOL[name])
            per_lane.setdefault(name, {})[form] = entry
            return
        results.append({"name": name, "route": "cuda",
                        "source": os.path.relpath(k.source, HERE),
                        "replaces": k.replaces, **entry,
                        "launches_by_path": {p: v["launches"][name]
                                             for p, v in paths.items()}})

    def check(name, passed, line):
        tol = TOL_LANE.get(name) if "block" in line and line["block"] in (
            "gxe", "gene") else None
        line = {"kernel": name, "tolerance": tol or TOL[name], **line}
        _say(line)
        if not passed:
            raise RuntimeError(f"{name} disagrees with its plain version: "
                               f"{line}")

    def amax(a, b):
        ok = torch.isfinite(a) & torch.isfinite(b)
        return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0

    def operand_bytes(data, isz):
        """One read of a block's eval, UtWy, wy_prod and Utx."""
        return isz * sum(t.numel() for t in (data.eval, data.UtWy,
                                             data.wy_prod, data.Utx))

    # K1: the association operand (impute) on the main path's block, and
    # the kinship operand (centre + standardise), float32 and float64
    xs = {}
    for dt, name, tol in ((f32, "geno_prologue", 1e-5),
                          (f64, "geno_prologue_f64", 1e-12)):
        x_k = pack2.prologue_cuda(raw_a, n, pack2.IMPUTE, False, None, dt)
        x_p = pack2.prologue_plain(raw_a, n, pack2.IMPUTE, False, None, dt)
        err = float((x_k - x_p).abs().max())
        ms = _time_ms(lambda: pack2.prologue_cuda(raw_a, n, pack2.IMPUTE,
                                                  False, None, dt), 20)
        pms = _time_ms(lambda: pack2.prologue_plain(
            raw_a, n, pack2.IMPUTE, False, None, dt), 5)
        c_k = pack2.prologue_cuda(raw_a, n, pack2.CENTRE, True, None, dt)
        c_p = pack2.prologue_plain(raw_a, n, pack2.CENTRE, True, None, dt)
        err = max(err, float((c_k - c_p).abs().max()))
        check(name, err <= tol and x_k.dtype == dt,
              {"max_abs_err": err, "S": S, "n": n, "ms": ms,
               "plain_ms": pms})
        isz = torch.finfo(dt).bits // 8
        record(name, err, ms, pms, raw_a.numel() + isz * S * n, 6 * S * n,
               peak=PEAK_F32_PER_S if dt == f32 else PEAK_F64_PER_S,
               launches=main_counts if dt == f32 else counts_b)
        xs[dt] = x_k

    fine_np = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    G = len(fine_np)

    def hold32(label, data, nc, l_score, l0, logl0, counts, form=None,
               rec=True):
        """K2-K6 on one float32 block against their plain versions: the
        score at l_score, the LRT against the null at (l0, logl0) —
        shared by the lanes (0-d) or one per lane."""
        S_ = lk.n_lanes(data)
        C1, M = nc + 1, data.wy_prod.shape[-1]
        ni = (nc + 3) * (nc + 2) // 2
        opb = operand_bytes(data, 4)
        # the shared forms' K2-K4 launch on the main path (-gk + -lmm 1)
        main_path = {k: main_counts if form is None else counts
                     for k in ("lambda_grid", "lambda_solve", "wald_tail")}
        lam_k = {}
        for reml in (True, False):
            tag = "reml" if reml else "ml"
            # K2
            gp = lk.grid_products(fine_np, data, nc)
            d_k = lk.grid_epilogue_cuda(gp, n, nc, False, reml)
            d_p = lk.grid_epilogue_plain(gp, n, nc, False, reml)
            diff = (d_k - d_p).abs()
            lam_g = torch.as_tensor(fine_np, dtype=f32, device=dev)[:, None]
            bound = (1e-5 * d_p.abs().max()
                     + 8 * n * torch.finfo(f32).eps / lam_g)
            worst = float((diff / bound).max())
            err = float(diff.max())
            ms = _time_ms(lambda: lk.grid_epilogue_cuda(gp, n, nc, False,
                                                        reml), 20)
            pms = _time_ms(lambda: lk.grid_epilogue_plain(gp, n, nc, False,
                                                          reml), 3)
            check("lambda_grid", worst <= 1.0,
                  {"max_abs_err": err, "max_err_over_bound": worst,
                   "block": label, "fit": tag, "S": S_, "G": G, "ms": ms,
                   "plain_ms": pms})
            if rec and reml:
                record("lambda_grid", err, ms, pms,
                       4 * (gp.xcross.numel() + gp.xx.numel()
                            + gp.shared.numel() + 2 * G + G * S_),
                       G * S_ * 2 * C1 * ni * 6,
                       launches=main_path["lambda_grid"], form=form)

            # K3, from the kernel's d1f
            args = (d_k, fine_np, data, nc, False, reml, 1e-5, 1e5, 10,
                    lk.per_lane(data))
            r_k = opt.lambda_solve_cuda(*args)
            r_p = opt.lambda_solve_plain(*args)
            lam_k[tag] = r_k
            if reml:
                pk = lk.wald_pvalues_plain(r_k.lam, data, nc)[2]
                pp = lk.wald_pvalues_plain(r_p.lam, data, nc)[2]
            else:
                pk, pp = (lk.lrt_pvalues_plain(r.lam, r.logf, data, nc, l0,
                                               logl0)[1]
                          for r in (r_k, r_p))
            err = amax(pk, pp)
            logf_rel = float(((r_k.logf - r_p.logf).abs()
                              / r_p.logf.abs()).nan_to_num(0.0).max())
            same_finite = not bool(
                (torch.isfinite(pk) != torch.isfinite(pp)).any())
            ms = _time_ms(lambda: opt.lambda_solve_cuda(*args), 5)
            # the plain search takes seconds: timed for REML only
            pms = _time_ms(lambda: opt.lambda_solve_plain(*args),
                           1) if reml else None
            check("lambda_solve",
                  err <= 1e-3 and logf_rel <= 1e-4 and same_finite,
                  {"max_abs_err": err, "logf_max_rel": logf_rel,
                   "same_finite": same_finite, "block": label, "fit": tag,
                   "S": S_, "ms": ms, "plain_ms": pms})
            if rec and reml:
                # work this run's data needs, at least: per lane one dev12
                # at each bracket's start and one Newton step, logf_stable
                # at each candidate and both endpoints
                d1c = d_k[::opt._F32_GRID_REFINE]
                n_br = float((d1c[:-1] * d1c[1:] <= 0).sum())
                q_dev12 = 3 * M + 3 * C1 + 5
                q_logf = C1 * (C1 + 1) // 2 + C1 + 1
                nops = n * (2 * n_br * (2 * q_dev12 + 4)
                            + (n_br + 2 * S_) * (2 * q_logf + 2 * C1 + 8))
                record("lambda_solve", err, ms, pms,
                       opb + 4 * (G * S_ + G + 2 * S_), nops,
                       launches=main_path["lambda_solve"], form=form)

        # K4 (at the kernel's REML λ) and K5 (at l_score)
        tails = (("wald_tail", lk.wald_pvalues_cuda, lk.wald_pvalues_plain,
                  lam_k["reml"].lam),
                 ("score_tail", lk.score_pvalues_cuda,
                  lk.score_pvalues_plain, l_score))
        for name, fk, fp, lam in tails:
            b_k, s_k, p_k = fk(lam, data, nc)
            b_p, s_p, p_p = fp(lam, data, nc)
            ok = torch.isfinite(p_p)
            err = float((p_k[ok] - p_p[ok]).abs().max())
            beta_se = float(((b_k - b_p).abs() / s_p)[ok].max())
            ms = _time_ms(lambda: fk(lam, data, nc), 20)
            pms = _time_ms(lambda: fp(lam, data, nc), 3)
            check(name, err <= (3e-5 if form else 1e-5) and beta_se <= 1e-3,
                  {"max_abs_err": err, "beta_max_err_over_se": beta_se,
                   "block": label, "S": S_, "ms": ms, "plain_ms": pms})
            if rec:
                record(name, err, ms, pms, opb + 4 * (S_ + 3 * S_),
                       2 * S_ * n * (M + C1 + 2), form=form,
                       launches=main_path.get(name, counts))

        # K6, speed mode: at the kernel's ML λ and the null's
        ml = lam_k["ml"]
        l_k, p_k = lk.lrt_pvalues_cuda(ml.lam, ml.logf, data, nc, l0, logl0)
        l_p, p_p = lk.lrt_pvalues_plain(ml.lam, ml.logf, data, nc, l0, logl0)
        logl_rel = float(((l_k.double() - l_p.double()).abs()
                          / l_p.double().abs()).nan_to_num(0.0).max())
        err = amax(p_k, p_p)
        ms = _time_ms(lambda: lk.lrt_pvalues_cuda(
            ml.lam, ml.logf, data, nc, l0, logl0), 20)
        pms = _time_ms(lambda: lk.lrt_pvalues_plain(
            ml.lam, ml.logf, data, nc, l0, logl0), 3)
        # the library's tail alone on the same Δ
        d64 = data._replace(eval=data.eval.double(), UtWy=data.UtWy.double(),
                            Utx=data.Utx.double())
        delta = (lk.logf_stable(ml.lam.double(), d64, nc, False, False)
                 - lk.logf_stable(l0.double().reshape(-1), d64, nc, True,
                                  False))
        lib_ms = _time_ms(lambda: torch.special.gammaincc(
            torch.full_like(delta, 0.5), delta.clamp(min=0.0)), 20)
        check("lrt_tail", err <= 1e-6 and logl_rel <= 1e-12,
              {"mode": "speed", "max_abs_err": err, "logl_max_rel": logl_rel,
               "block": label, "S": S_, "ms": ms, "plain_ms": pms,
               "library_ms_gammaincc": lib_ms})
        if rec:
            nG = C1 * (C1 + 1) // 2
            passes = 1 if l0.numel() == 1 else 2     # per-lane null too
            record("lrt_tail", err, ms, pms,
                   4 * (data.eval.numel() + data.UtWy.numel()
                        + data.Utx.numel() + S_) + 8 * 2 * S_,
                   passes * S_ * n * (3 * (nG + C1) + 8 + 2 * C1),
                   peak=PEAK_F64_PER_S, launches=counts, library_ms=lib_ms,
                   note="library_ms is torch.special.gammaincc(0.5, Δ) on "
                        "the same Δ: the tail alone; the kernel also "
                        "re-evaluates both ML log-likelihoods in float64",
                   form=form)

    def hold64(label, data, nc, l_score, l0, logl0, counts, form=None,
               rec=True):
        """K7, K4_f64/K5_f64 and K6's tail on one float64 block."""
        S_ = lk.n_lanes(data)
        C1, M = nc + 1, data.wy_prod.shape[-1]
        opb = operand_bytes(data, 8)
        fits = {}
        for reml in (True, False):
            tag = "reml" if reml else "ml"
            args = (data, nc, False, reml, 1e-5, 1e5, 10)
            r_k = opt.lambda_solve_f64_cuda(*args)
            r_p = opt.lambda_solve_f64_plain(*args)
            fits[tag] = r_k
            pk = lk.wald_pvalues_plain(r_k.lam, data, nc)[2]
            pp = lk.wald_pvalues_plain(r_p.lam, data, nc)[2]
            err = amax(pk, pp)
            logf_rel = float(((r_k.logf - r_p.logf).abs()
                              / r_p.logf.abs()).nan_to_num(0.0).max())
            nan_diff = int((torch.isnan(r_k.lam)
                            != torch.isnan(r_p.lam)).sum())
            ms = _time_ms(lambda: opt.lambda_solve_f64_cuda(*args), 3)
            pms = _time_ms(lambda: opt.lambda_solve_f64_plain(*args),
                           1) if reml else None
            check("lambda_solve_f64",
                  err <= 1e-6 and logf_rel <= 1e-9
                  and nan_diff <= 1e-3 * S_,
                  {"max_abs_err": err, "logf_max_rel": logf_rel,
                   "nan_lanes": int(torch.isnan(r_p.lam).sum()),
                   "nan_lanes_differ": nan_diff, "block": label, "fit": tag,
                   "S": S_, "ms": ms, "plain_ms": pms})
            if rec and reml:
                # at least: the n_region + 1 scan points, and per bracket
                # one Brent step, two Newton steps and the logf at the
                # candidate, plus both endpoint logfs
                grid = opt.fine_grid(1e-5, 1e5, 10, 1)
                d1g = torch.stack([lk.dev1(torch.full((S_,), float(g),
                                                      dtype=f64, device=dev),
                                           data, nc, False, True)
                                   for g in grid])
                n_br = float((d1g[:-1] * d1g[1:] <= 0).sum())
                q1, q2, q3 = M + C1 + 2, 2 * M + 2 * C1 + 4, 3 * M + 3 * C1 + 5
                nops = 2 * n * (S_ * len(grid) * q2
                                + n_br * (q2 + 2 * q3 + q1) + 2 * S_ * q1)
                record("lambda_solve_f64", err, ms, pms,
                       opb + 8 * (S_ * C1 + 2 * S_), nops,
                       peak=PEAK_F64_PER_S, launches=counts, form=form)
        tails = (("wald_tail_f64", lk.wald_pvalues_cuda,
                  lk.wald_pvalues_plain, fits["reml"].lam),
                 ("score_tail_f64", lk.score_pvalues_cuda,
                  lk.score_pvalues_plain, l_score))
        for name, fk, fp, lam in tails:
            b_k, s_k, p_k = fk(lam, data, nc)
            b_p, s_p, p_p = fp(lam, data, nc)
            ok = torch.isfinite(p_p) & torch.isfinite(s_p)
            err = float((p_k[ok] - p_p[ok]).abs().max())
            beta_se = float(((b_k - b_p).abs() / s_p)[ok].max())
            same_nan = bool((torch.isnan(p_k) == torch.isnan(p_p)).all())
            ms = _time_ms(lambda: fk(lam, data, nc), 20)
            pms = _time_ms(lambda: fp(lam, data, nc), 3)
            check(name, err <= 1e-10 and beta_se <= 1e-8 and same_nan
                  and p_k.dtype == f64,
                  {"max_abs_err": err, "beta_max_err_over_se": beta_se,
                   "block": label, "S": S_, "ms": ms, "plain_ms": pms})
            if rec:
                record(name, err, ms, pms, opb + 8 * (S_ + 3 * S_),
                       2 * S_ * n * (M + C1 + 2), peak=PEAK_F64_PER_S,
                       launches=counts, form=form)
        ml = fits["ml"]
        l_k, p_k = lk.lrt_pvalues_cuda(ml.lam, ml.logf, data, nc, l0, logl0)
        l_p, p_p = lk.lrt_pvalues_plain(ml.lam, ml.logf, data, nc, l0, logl0)
        err = amax(p_k, p_p)
        same = bool((torch.isnan(p_k) == torch.isnan(p_p)).all()
                    and torch.equal(l_k.nan_to_num(0), l_p.nan_to_num(0)))
        ms = _time_ms(lambda: lk.lrt_pvalues_cuda(
            ml.lam, ml.logf, data, nc, l0, logl0), 20)
        check("lrt_tail", err <= 1e-12 and same,
              {"mode": "parity", "max_abs_err": err, "block": label,
               "S": S_, "ms": ms})

    # the shared forms: the main path's block at c = 1, and c = 3
    for c_label, W in (("c1", np.ones((n, 1))), ("c3", W3)):
        nc = W.shape[1]
        main = c_label == "c1"
        for dt, hold in ((f32, hold32), (f64, hold64)):
            ev, U, tr, y = fac[dt]
            Wd = torch.as_tensor(W, dtype=dt, device=dev)
            UtW, Uty = U.T @ Wd, U.T @ y
            data = lk.build_batch_data(ev, UtW, Uty, (xs[dt] @ U).contiguous(),
                                       nc)
            nf = fit_null(ev, UtW, Uty, tr, nc)
            hold(c_label, data, nc, nf.l_mle, nf.l_mle, nf.logl_mle,
                 counts_a if dt == f32 else counts_b, rec=main)

    # the per-lane forms: the GxE block (each SNP's covariates [1, env,
    # x], the interaction as predictor, one ML null per SNP; the score at
    # the covariate-only null) and the gene block (each gene a response,
    # the phenotype the one predictor, one null per gene for the score
    # and the LRT), float32 and float64
    from gemma_torch.models.lmm.engine import gene_batch_data, gxe_batch_data
    from gemma_torch.run import _lane_rows
    S_gxe = _block_size(cfg, dev, len(idx), n_axis=n,
                        per_lane=_lane_rows(4, 4))  # c = 1 plus env, x
    for dt, hold, tag in ((f32, hold32, ""), (f64, hold64, "_f64")):
        ev, U, tr, y = fac[dt]
        Wd = torch.ones((n, 1), dtype=dt, device=dev)
        UtW, Uty = U.T @ Wd, U.T @ y
        nf = fit_null(ev, UtW, Uty, tr, 1)
        env_d = torch.as_tensor(env_np[ds.indicator_idv], dtype=dt,
                                device=dev)
        x = xs[dt][:S_gxe]
        data = gxe_batch_data(ev, UtW, U.T @ env_d, Uty, x @ U,
                              (x * env_d) @ U, 1)
        null = opt.calc_lambda(data, 3, True, False, 1e-5, 1e5, 10)
        hold("gxe", data, 3, nf.l_mle, null.lam, null.logf,
             counts_e["gxe" + tag], form="gxe")
        E = torch.as_tensor(expr_np[:, ds.indicator_idv], dtype=dt,
                            device=dev).contiguous()
        data = gene_batch_data(ev, UtW, Uty, E @ U, 1)
        null = opt.calc_lambda(data, 1, True, False, 1e-5, 1e5, 10)
        hold("gene", data, 1, null.lam, null.lam, null.logf,
             counts_e["gene" + tag], form="gene")
        del data

    # K8 on the -lm path's SNP block and on the gene rows
    for dt, name, tol_p, tol_b in ((f32, "lm_tail", 1e-6, 1e-5),
                                   (f64, "lm_tail_f64", 1e-12, 1e-10)):
        _, _, _, y = fac[dt]
        Wd = torch.ones((n, 1), dtype=dt, device=dev)
        E = torch.as_tensor(expr_np[:, ds.indicator_idv], dtype=dt,
                            device=dev).contiguous()
        for rows, gene in ((xs[dt], False), (E, True)):
            consts = lm.lm_consts(Wd, y)
            args = (rows, y, Wd, consts, gene, False)
            k_out = lm.lm_tail_cuda(*args)
            p_out = lm.lm_tail_plain(*args)
            err = max(amax(getattr(k_out, f), getattr(p_out, f))
                      for f in ("p_wald", "p_lrt", "p_score"))
            beta_se = float(((k_out.beta - p_out.beta).abs()
                             / p_out.se).nan_to_num(0.0).max())
            same_nan = bool((torch.isnan(k_out.p_wald)
                             == torch.isnan(p_out.p_wald)).all())
            ms = _time_ms(lambda: lm.lm_tail_cuda(*args), 20)
            pms = _time_ms(lambda: lm.lm_tail_plain(*args), 3)
            S_ = rows.shape[0]
            check(name, err <= tol_p and beta_se <= tol_b and same_nan,
                  {"max_abs_err": err, "beta_max_err_over_se": beta_se,
                   "rows": "genes" if gene else "snps", "S": S_, "ms": ms,
                   "plain_ms": pms})
            isz = torch.finfo(dt).bits // 8
            record(name, err, ms, pms,
                   isz * (S_ * n + 2 * n + 5 * S_) + 8 * 3,
                   2 * 3 * S_ * n, peak=PEAK_F64_PER_S,
                   launches=counts_e["lm"],
                   form="gene" if gene else None)
    for entry in results:
        if entry["name"] in per_lane:
            entry["per_lane"] = per_lane[entry["name"]]

    _say({"phase": "total", "seconds": time.time() - t_start})
    _say(smi)
    _say({"kernels": results})
    _say({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
