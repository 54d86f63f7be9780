"""Where the genotype prologue K1 (geno_prologue, both precisions) and the
λ-grid epilogue K2 (lambda_grid) spend their time, on the card.  K2 is
also built with -DGT_PROFILE, which turns on its phase marks (csrc/common.cuh
GT_PROF, lambda_grid.cu's LG_PH_*: thread 0 of every block adds the
clock64() cycles since its last mark to the phase it closes: row
assembly, the recurrence steps, dev1 and its store).  K1 has no marks:
its lines give the times and the bound.

    python3 scripts/k1_k2_phase_profile.py     # on a machine with the card

K1 runs on seeded genotypes (chip_smoke.k1_genotypes: hard calls at a
MAF drawn per SNP, 2% missing, an all-missing, a monomorphic and an
all-0 row): the mouse shape
(12,226 SNPs x 1,940 individuals) on every wire the precision takes
(2-bit packed, int8, and float32 or float64 with NaN missing) in every
mode (IMPUTE, CENTRE, CENTRE with scale), the -ci block (4,096 SNPs,
packed, CENTRE with scale over n), and a biobank block (2,048 SNPs x
100,000 individuals) on each wire, IMPUTE.  K2 runs on the seeded mouse
factors of scripts/k3_k7_phase_profile.py, REML and ML, the float32
fine grid: every SNP at c = 1, the null fit's one lane (calc_null),
c = 2, 3 and 4 (an intercept and seeded normal columns) on every SNP,
c = 8, 12, 13 and 16 on the first 2,048, the -gxe block (c = 1 plus env
and x a lane, per-lane operands, REML and the per-lane ML null) on the
first 4,096, and 2,048 seeded gene rows (-gene, per-lane operands).  It
also times the device ms of grid_products' three products and its Utx *
Utx pass at c = 1.  Variants of K2, each a library of its own built from
a copy of lambda_grid.cu with one constant changed (or one nvcc flag),
are timed beside it: LG_REG_MAX 7 (the warp form at c = 8 and 12, where
the register form runs), LG_REG_TPB 128 (blocks of 128 threads at c = 1,
2, 4 and 8) and -prec-div=false (c = 1-4).

A line a case: the median ms of chip_smoke's time_ms (CUDA events, the
L2 flushed, the host's enqueue included), the device ms alone
(chip_smoke._device_ms: torch.profiler, else CUDA events behind a sleep
on the card), the bound (bytes over 3.35 TB/s; K2 also its operations
over 67 TFLOP/s), the largest difference from the plain version, and for
K2 each phase's share of the marked cycles (from a second build with
-DGT_PROFILE: the marks cost time, so the times are the build without
them); then the ptxas report of each library it times
(registers, stack frame, spills; K2's register form also built once with
LG_REG_MAX 13, for its report alone), the register form's SASS
instruction and MUFU.RCP counts (cuobjdump) and the card's name and
power limit.  -prec-div=false divides by an approximate reciprocal, which
is never shipped: it shows what the recurrence's IEEE divisions cost.

Copied with chip_smoke.py into another checkout's root (a parent unpacked
under build/), it times that checkout's kernels (without the variants
where its lambda_grid.cu lacks their constants): put the two in one
call.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gemma_torch import kernels  # noqa: E402
from gemma_torch.models.lmm import likelihood as lk  # noqa: E402
from gemma_torch.models.lmm import optimize as opt  # noqa: E402
from gemma_torch.models.lmm.engine import (gene_batch_data,  # noqa: E402
                                           gxe_batch_data)
from gemma_torch.ops import pack2  # noqa: E402
from k3_k7_phase_profile import _data  # noqa: E402

MOUSE_S, MOUSE_N, CI_S, BIG_S, BIG_N = 12226, 1940, 4096, 2048, 100_000
GENO_SEED = 15
K2_PHASES = ("row assembly", "recurrence steps", "dev1 and store")
MARKED = 8          # csrc/common.cuh GT_PC_LANES: K2 counts its blocks
K2_CVT = (2, 3, 4, 8, 12, 13, 16)
K2_LANES, GXE_LANES, GENES, GENE_SEED = 2048, 4096, 2048, 14
# c up to 4 on every SNP of the mouse block, above on the first K2_LANES
K2_ALL_LANES = 4
PROFILED = None     # K2 built with the phase marks

VARIANT = None      # (K2 built with other flags, its label)


def _read(kern):
    """The kernel's profile counters, zeroed as they are read."""
    if kern._lib is None:
        kern._load()
    buf = (ctypes.c_ulonglong * 16)()
    kern._lib.gt_prof_read(buf)
    return list(buf)


def wires(X, dt, dev):
    """The block on each wire the precision `dt` reads."""
    f = np.float32 if dt == torch.float32 else np.float64
    xf = np.where(X < 0, np.nan, X).astype(f)
    return {"packed": torch.from_numpy(pack2.pack_bed_codes(X)).to(dev),
            "int8": torch.from_numpy(X).to(dev),
            "float": torch.from_numpy(xf).to(dev)}


def _k1_line(case, raw, n, mode, scale, n_total, dt, reps=20):
    args = (raw, n, mode, scale, n_total, dt)
    got = pack2.prologue_cuda(*args)
    want = pack2.prologue_plain(*args)
    err = float((got - want).abs().max())
    equal = bool(torch.equal(got, want))
    del got, want
    ms = cs.time_ms(lambda: pack2.prologue_cuda(*args), reps)
    dms, dfrom = cs._device_ms(lambda: pack2.prologue_cuda(*args),
                               ("void geno_prologue",))
    S = raw.shape[0]
    nbytes = raw.numel() * raw.element_size() + S * n * (
        torch.finfo(dt).bits // 8)
    bound = nbytes / cs.PEAK_BYTES_PER_S * 1e3
    print(json.dumps({
        "kernel": "geno_prologue" + ("" if dt == torch.float32 else "_f64"),
        "case": case, "wire": str(raw.dtype), "mode": (
            "impute" if mode == pack2.IMPUTE else
            "centre_scale" if scale else "centre"), "S": S, "n": n,
        "ms": ms, "device_ms": dms, "device_ms_from": dfrom,
        "bound_ms": bound, "bound_by": "bytes",
        "device_over_bound": dms / bound, "max_abs_err": err,
        "bit_equal": equal}), flush=True)


def _k1(dev):
    X = cs.k1_genotypes(MOUSE_S, MOUSE_N, GENO_SEED)
    modes = ((pack2.IMPUTE, False), (pack2.CENTRE, False),
             (pack2.CENTRE, True))
    for dt in (torch.float32, torch.float64):
        for wire, raw in wires(X, dt, dev).items():
            for mode, scale in modes:
                _k1_line("mouse_" + wire, raw, MOUSE_N, mode, scale, None,
                         dt)
        ci = torch.from_numpy(pack2.pack_bed_codes(X[:CI_S])).to(dev)
        _k1_line("ci", ci, MOUSE_N, pack2.CENTRE, True, MOUSE_N, dt)
        del ci
    del X
    Xb = cs.k1_genotypes(BIG_S, BIG_N, GENO_SEED + 1)
    for dt in (torch.float32, torch.float64):
        for wire, raw in wires(Xb, dt, dev).items():
            _k1_line("n100k_" + wire, raw, BIG_N, pack2.IMPUTE, False,
                     None, dt, reps=5)
            del raw
        torch.cuda.empty_cache()


def _form(nc):
    """K2's form at nc covariates (chip_smoke.grid_form); None where the
    library does not say, as another checkout's may not."""
    try:
        return cs.grid_form(nc)
    except AttributeError:
        return None


def _k2_line(case, gp, n, nc, calc_null, reml):
    _k2_measure(VARIANT[0] if VARIANT else kernels.LAMBDA_GRID, case, gp, n,
                nc, calc_null, reml)


def _k2_measure(kern, case, gp, n, nc, calc_null, reml):
    G, S = gp.xx.shape[1], gp.xx.shape[2]
    a = (gp, n, nc, calc_null, reml)
    d_k = lk.grid_epilogue_cuda(*a)
    d_p = lk.grid_epilogue_plain(*a)
    lam_g = gp.lam[:, None]
    tol = 1e-5 * d_p.abs().max() + 8 * n * torch.finfo(torch.float32).eps \
        / lam_g
    worst = float(((d_k - d_p).abs() / tol).max())
    ms = cs.time_ms(lambda: lk.grid_epilogue_cuda(*a), 20)
    dms, dfrom = cs._device_ms(lambda: lk.grid_epilogue_cuda(*a),
                               ("void lambda_grid", "lambda_grid"))
    # the phase shares from the build with the marks (they cost time:
    # the times above are the build without them)
    kernels.LAMBDA_GRID = PROFILED
    try:
        lk.grid_epilogue_cuda(*a)
        torch.cuda.synchronize()
        _read(PROFILED)
        lk.grid_epilogue_cuda(*a)
        torch.cuda.synchronize()
        cnt = _read(PROFILED)
    finally:
        kernels.LAMBDA_GRID = kern
    steps = nc if calc_null else nc + 1
    live = sum((nc + 2 - p) * (nc + 3 - p) // 2 for p in range(1, steps + 1))
    nbytes = 4 * (gp.xcross.numel() + gp.xx.numel() + gp.shared.numel()
                  + 2 * G + G * S)
    t_b = nbytes / cs.PEAK_BYTES_PER_S * 1e3
    t_o = G * S * 2 * live * 6 / cs.PEAK_F32_PER_S * 1e3
    cyc = cnt[:len(K2_PHASES)]
    tot = max(sum(cyc), 1)
    print(json.dumps({
        "kernel": "lambda_grid" + (VARIANT[1] if VARIANT else ""),
        "case": case,
        "form": _form(nc), "S": S, "G": G,
        "n_cvt": nc,
        "calc_null": calc_null, "fit": "reml" if reml else "ml",
        "per_lane": gp.shared.dim() == 4, "ms": ms, "device_ms": dms,
        "device_ms_from": dfrom, "bound_ms": max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "device_over_bound": dms / max(t_b, t_o),
        "max_err_over_tol": worst, "marked_blocks": cnt[MARKED],
        "phase_share": {nm: c / tot for nm, c in zip(K2_PHASES, cyc)}}),
        flush=True)


def _products(fine, data, nc):
    """Device ms of grid_products' pieces at the main path's shape."""
    n, S = data.eval.shape[0], data.Utx.shape[0]
    lam = torch.as_tensor(np.asarray(fine), dtype=data.eval.dtype,
                          device=data.eval.device)
    hi = 1.0 / (lam[:, None] * data.eval + 1.0)
    HiP = torch.stack([hi, hi * hi]).reshape(2 * len(fine), n)
    Wb = (HiP[:, None, :] * data.UtWy.T[None]).reshape(-1, n)
    sq = data.Utx * data.Utx
    out = {}
    # the whole call: every CUDA kernel it runs, by the profiler
    out["grid_products (all)"] = cs._device_ms(
        lambda: lk.grid_products(fine, data, nc), ("",))[0]
    for name, fn in (
            ("shared = HiP @ wy_prod", lambda: torch.matmul(HiP,
                                                            data.wy_prod)),
            ("xcross = Wb @ Utx^T", lambda: torch.matmul(Wb, data.Utx.T)),
            ("Utx * Utx", lambda: data.Utx * data.Utx),
            ("xx = HiP @ (Utx^2)^T", lambda: torch.matmul(HiP, sq.T))):
        out[name] = cs._time_device_ms(fn, 10)[0]
    print(json.dumps({"case": "grid_products", "S": S, "n": n,
                      "G": len(fine), "device_ms": out}), flush=True)


def _k2(dev, cvt=K2_CVT, extra=True):
    ev, U, y, X, W24, env = _data(dev)[torch.float32]
    n = ev.shape[0]
    fine = opt.fine_grid(1e-5, 1e5, 10, opt._F32_GRID_REFINE)
    Uty = U.T @ y
    UtW1 = U.T @ W24[:, :1]
    Utx = (X @ U).contiguous()
    main = lk.build_batch_data(ev, UtW1, Uty, Utx, 1)
    if extra:
        _products(fine, main, 1)
    gp = lk.grid_products(fine, main, 1)
    for reml in (True, False):
        _k2_line("mouse_c1", gp, n, 1, False, reml)
    del gp
    if extra:
        null = lk.null_batch_data(ev, UtW1, Uty, 1)
        gp = lk.grid_products(fine, null, 1)
        for reml in (True, False):
            _k2_line("null_c1", gp, n, 1, True, reml)
    rng = np.random.default_rng(cs.CVT40_SEED)
    W16 = torch.as_tensor(np.column_stack(
        [np.ones(n), rng.normal(size=(n, max(K2_CVT) - 1))]),
        dtype=torch.float32, device=dev)
    for nc in cvt:
        lanes = Utx if nc <= K2_ALL_LANES else Utx[:K2_LANES].contiguous()
        blk = lk.build_batch_data(ev, U.T @ W16[:, :nc], Uty, lanes, nc)
        gp = lk.grid_products(fine, blk, nc)
        for reml in (True, False):
            _k2_line(f"c{nc}", gp, n, nc, False, reml)
        del blk, gp
    if not extra:
        return
    xg = X[:GXE_LANES]
    blk = gxe_batch_data(ev, UtW1, U.T @ env, Uty, xg @ U, (xg * env) @ U, 1)
    gp = lk.grid_products(fine, blk, 3)
    _k2_line("gxe", gp, n, 3, False, True)
    _k2_line("gxe_null", gp, n, 3, True, False)
    del blk, gp
    E = torch.as_tensor(np.random.default_rng(GENE_SEED).normal(
        size=(GENES, n)), dtype=torch.float32, device=dev)
    blk = gene_batch_data(ev, UtW1, U.T @ y, E @ U, 1)
    gp = lk.grid_products(fine, blk, 1)
    for reml in (True, False):
        _k2_line("gene", gp, n, 1, False, reml)


def _sass():
    """Each register instantiation's SASS (cuobjdump -sass of the K2
    library): its instructions and its MUFU.RCP (each IEEE division's
    fast path has one), counted where they stand in the code (the
    divisions' slow paths, which rarely run, included)."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return
    res = subprocess.run([tool, "-sass", kernels.LAMBDA_GRID.library_path()],
                         capture_output=True, text=True)
    fn, counts = None, {}
    for ln in res.stdout.splitlines():
        m = re.search(r"Function : _Z15lambda_grid_regILi(\d+)E", ln)
        if m:
            fn = int(m.group(1))
            counts[fn] = [0, 0]
        elif "Function :" in ln:
            fn = None
        elif fn is not None and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln):
            counts[fn][0] += 1
            counts[fn][1] += "MUFU.RCP" in ln
    print(json.dumps({"sass": "lambda_grid_reg<C>: [instructions, MUFU.RCP]",
                      "counts": counts}), flush=True)


def _ptxas(kern, label, only=None):
    """ptxas's lines for the library `kern` builds (its own report, beside
    it), those of functions whose name holds `only` where it is given."""
    path = os.path.join(kernels.BUILD_DIR, f"{kern.lib_stem}.ptxas.txt")
    with open(path) as fh:
        lines = [ln.strip() for ln in fh]
    fn, keep = None, []
    for ln in lines:
        m = re.search(r"function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if ("ptxas info" in ln or "bytes stack frame" in ln) and (
                only is None or (fn and only in fn)):
            keep.append(ln)
    print(json.dumps({"ptxas": label, "lines": keep}), flush=True)


class _Variant(kernels.Kernel):
    """K2 built from a copy of its source with constants replaced (`subs`:
    (name, value) of its #define lines) and extra nvcc `flags`, into a
    library, and a ptxas report, of its own."""

    def __init__(self, label, subs=(), flags=()):
        k = kernels.LAMBDA_GRID
        super().__init__(k.name, k.argtypes, k.replaces)
        self.label, self.extra = label, tuple(flags)
        if subs:
            with open(k.source) as fh:
                text = fh.read()
            for name, value in subs:
                text = re.sub(rf"(?m)^#define {name} \S+$",
                              f"#define {name} {value}", text)
            os.makedirs(kernels.BUILD_DIR, exist_ok=True)
            self.source = os.path.join(kernels.BUILD_DIR,
                                       f"lambda_grid{label}.cu")
            with open(self.source, "w") as fh:
                fh.write(text)
            self.extra += (f"-I{kernels.CSRC_DIR}",)

    @property
    def lib_stem(self):
        return "lambda_grid" + self.label

    def _flags(self):
        return super()._flags() + self.extra


def _has_defines(*names):
    """Whether lambda_grid.cu defines each of `names` (another checkout's
    may not)."""
    with open(kernels.LAMBDA_GRID.source) as fh:
        text = fh.read()
    return all(re.search(rf"(?m)^#define {nm} ", text) for nm in names)


def main():
    global PROFILED, VARIANT
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    PROFILED = _Variant("_prof", flags=("-DGT_PROFILE",))
    for k in (kernels.GENO_PROLOGUE, kernels.LAMBDA_GRID):
        k.build()
    _ptxas(kernels.GENO_PROLOGUE, "geno_prologue")
    _ptxas(kernels.LAMBDA_GRID, "lambda_grid")
    variants = _has_defines("LG_REG_MAX", "LG_REG_TPB")
    if variants:
        # the register form one count past LG_REG_MAX, built only for
        # ptxas's report: its rows no longer fit in registers
        reg13 = _Variant("_reg13", subs=(("LG_REG_MAX", 13),))
        reg13.build()
        _ptxas(reg13, "lambda_grid, LG_REG_MAX 13", "lambda_grid_regILi13")
    _sass()
    PROFILED.build()
    _k1(dev)
    _k2(dev)
    # K2's variants: the warp form at 8 and 12 covariates (LG_REG_MAX 7),
    # blocks of 128 threads (LG_REG_TPB), and division by an approximate
    # reciprocal (-prec-div=false, not IEEE: what the IEEE divisions of
    # the recurrence cost; never shipped)
    base = kernels.LAMBDA_GRID
    for label, subs, flags, cvt in (
            ("_warp", (("LG_REG_MAX", 7),), (), (8, 12)),
            ("_tpb128", (("LG_REG_TPB", 128),), (), (2, 4, 8)),
            ("_approx_div", (), ("-prec-div=false",), (2, 3, 4))
    ) if variants else ():
        VARIANT = (_Variant(label, subs, flags), label)
        PROFILED = _Variant(label + "_prof", subs, flags + ("-DGT_PROFILE",))
        kernels.LAMBDA_GRID = VARIANT[0]
        try:
            _k2(dev, cvt=cvt, extra=False)
        finally:
            kernels.LAMBDA_GRID = base
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
