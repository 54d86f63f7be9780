"""Analysis drivers — the BatchRun analogue (gemma.cpp:1641-3144).

The port runs `-gk 1|2` (kinship), `-eigen`, and the univariate LMM
`-lmm 1/2/3/4/5/9` from `-k` or `-u/-d`, with `-widv` residual weights,
on one device, in float32 (speed mode) or float64 (parity mode).  Each
`run_*` wires the dataset through the device code and writes
GEMMA-compatible files; `batch_run` dispatches on a_mode like the
reference's if-chain.

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"`, or `-device cpu` on the command line).  Without a card
and without that request they raise; nothing falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from gemma_torch import precision
from gemma_torch.config import GemmaConfig, check_param
from gemma_torch.dataset import Dataset, load_dataset
from gemma_torch.io.readers import read_eigen_d, read_eigen_u, read_kinship
from gemma_torch.io.writers import (
    write_matrix, write_vector, write_lmm_assoc, snp_rows_from_table,
    ensure_outdir,
)
from gemma_torch.models.lmm.engine import assoc_block_impl, fit_null
from gemma_torch.ops.center import center_matrix
from gemma_torch.ops.eigh import eigh_zeroed, zero_eigenvalues
from gemma_torch.ops.kinship import KinshipAccumulator
from gemma_torch.ops.pack2 import IMPUTE, PAD_BYTE, pack_bed_codes, prologue
from gemma_torch.utils.log import RunLog
from gemma_torch.utils.validate import check_finite, validate_kinship

# analysis modes outside this slice → their ROADMAP.md queue entry
_NOT_PORTED = {
    (51, 52, 53, 54): "queue A, \"-lm\"",
    (11, 12, 13, 14, 15, 41, 42, 43): "queue A, \"BSLMM and prediction\"",
    (25, 26, 27, 28, 61, 62, 63, 66, 67, 71, 72):
        "queue A, \"variance components and summary statistics\"",
}


def _not_ported(what: str, entry: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to gemma_torch yet (ROADMAP.md, {entry}); "
        "the reference package gemma_tpu runs it")


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r}: use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gemma_torch runs on a CUDA device unless asked otherwise and "
            "none is available; pass -device cpu (device='cpu') to run on "
            "the CPU")
    return dev


def _block_size(cfg: GemmaConfig, device: torch.device,
                n_items: int | None = None,
                n_axis: int | None = None) -> int:
    """SNP block size for device batches, clamped to the dataset size.

    Unless -block-size was given, blocks grow to 16384 SNPs, backed off
    so one (S, n) float32 block stays within a sixteenth of the card's
    free memory (the λ search holds a few such blocks at once); on the
    CPU the budget is 1.5 GiB.  Mirrors the reference's
    _mesh_block_size on one device."""
    base = cfg.block_size
    if not cfg.block_size_set:
        cap = 16384
        if n_axis:
            if device.type == "cuda":
                budget = torch.cuda.mem_get_info(device)[0] // 16
            else:
                budget = 3 << 29
            cap = max(1024, min(cap, budget // (4 * n_axis)))
            cap = 1 << (cap.bit_length() - 1)      # floor to pow2
        base = max(base, cap)
    bs = base
    if n_items:
        bs = min(bs, n_items)
    return max(bs, 1)


def _encode_wire(raw: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Smallest exact encoding of a float dosage block: int8 with -1
    missing for hard calls, else float32 (speed mode) / float64."""
    if raw.dtype == np.int8:
        return raw
    m = np.isnan(raw)
    v = np.where(m, -1.0, raw)
    as8 = v.astype(np.int8)
    if ((as8 == v) & ((v >= 0.0) | m)).all():
        return as8
    return raw.astype(np.float32 if dtype == torch.float32 else np.float64)


def _pad_block(block: np.ndarray, size: int, fill) -> np.ndarray:
    if block.shape[0] == size:
        return block
    pad = np.full((size - block.shape[0], block.shape[1]), fill,
                  dtype=block.dtype)
    return np.vstack([block, pad])


def _raw_wire_block(ds: Dataset, sel, size: int, dtype: torch.dtype,
                    all_individuals: bool) -> np.ndarray:
    """Unimputed (size, ·) genotype block in wire format, smallest
    first: 2-bit packed uint8 for hard-call backends (raw .bed bytes
    when every individual is kept), int8 with -1 missing for integral
    dosages, float with NaN otherwise.  Padding rows are all-missing
    (packed) or zeros and are trimmed by the caller."""
    keep = slice(None) if all_individuals else ds.indicator_idv
    if hasattr(ds.geno, "block_i8"):
        if hasattr(ds.geno, "block_bed") and (all_individuals
                                              or ds.indicator_idv.all()):
            raw = ds.geno.block_bed(sel)
        else:
            raw = pack_bed_codes(ds.geno.block_i8(sel)[:, keep])
        return _pad_block(raw, size, PAD_BYTE)
    raw = _encode_wire(ds.geno.block(sel)[:, keep], dtype)
    if raw.dtype == np.int8:
        return _pad_block(raw, size, -1)
    return _pad_block(raw, size, np.nan if all_individuals else 0.0)


def _to_device(raw: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(raw)).to(device)


def _summary(log: RunLog, ds: Dataset, cfg: GemmaConfig, n_cvt: int,
             n_analyzed: int) -> None:
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = ds.ni_test
    log.summary["number of covariates"] = n_cvt
    log.summary["number of phenotypes"] = cfg.n_ph
    log.summary["number of total SNPs/var"] = ds.geno.n_snps
    log.summary["number of analyzed SNPs/var"] = n_analyzed


# ---------------------------------------------------------------------------
# -gk: kinship

def run_gk(cfg: GemmaConfig, log: RunLog | None = None,
           device: str | torch.device = "cuda") -> np.ndarray:
    """Build the relatedness matrix over ALL individuals (ni_total),
    from QC-passing SNPs (gemma.cpp -gk block; BimbamKin)."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    if cfg.loco or cfg.file_ksnps:
        raise _not_ported("-loco / -ksnps", "queue A, \"rest of run_lmm\"")
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    scale = cfg.gk_mode == 2 or cfg.a_mode == 22
    mask = ds.qc.indicator_snp

    with log.timer.phase("kinship"):
        idx = np.flatnonzero(mask)
        bs = _block_size(cfg, device, len(idx), n_axis=ds.ni_total)
        acc = KinshipAccumulator(ds.ni_total, scale=scale, dtype=dtype,
                                 device=device)
        for s in range(0, len(idx), bs):
            sel = idx[s:s + bs]
            raw = _raw_wire_block(ds, sel, bs, dtype, all_individuals=True)
            acc.update(_to_device(raw, device), n_valid=len(sel))
        Kd = acc.finalize()
    with log.timer.phase("readback"):
        K = Kd.cpu().numpy().astype(np.float64)

    if cfg.check:
        validate_kinship(K, strict=cfg.strict)
    ensure_outdir(cfg.path_out)
    suffix = "sXX" if scale else "cXX"
    with log.timer.phase("write"):
        write_matrix(f"{cfg.out_prefix()}.{suffix}.txt", K, sidecar=True)
    _summary(log, ds, cfg, ds.n_cvt, int(mask.sum()))
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return K


# ---------------------------------------------------------------------------
# eigendecomposition: shared by -eigen and -lmm

def _load_or_compute_eigen(cfg: GemmaConfig, ds: Dataset, log: RunLog,
                           dtype: torch.dtype, device: torch.device):
    """Load -u/-d eigen files; or read K (-k), double-centre it, apply
    the -widv residual weights and eigendecompose on the device.

    Returns (eval, U, trace_G) in `dtype` (gemma.cpp:2584-2669)."""
    if cfg.file_ku and cfg.file_kd:
        with log.timer.phase("kread"):
            U = torch.as_tensor(read_eigen_u(cfg.file_ku), dtype=dtype,
                                device=device)
            eval_, trace_G = zero_eigenvalues(torch.as_tensor(
                read_eigen_d(cfg.file_kd), dtype=dtype, device=device))
        return eval_, U, trace_G
    if not cfg.file_kin:
        raise ValueError("LMM requires -k kinship or -u/-d eigen files")
    with log.timer.phase("kread"):
        K = read_kinship(cfg.file_kin, ds.indicator_idv, ids=ds.ids,
                         k_mode=cfg.k_mode)
    if cfg.check:
        check_finite("kinship matrix (-k)", K)
    with log.timer.phase("eigen"):
        Kc = center_matrix(torch.as_tensor(K, dtype=dtype, device=device))
        sw = None
        if ds.weights is not None:
            # residual weights (-widv): K_ij /= sqrt(w_i w_j), then U's
            # rows times sqrt(w_i); zero weights zero their row and
            # column (gemma.cpp:2599-2644)
            w = torch.as_tensor(ds.weights, dtype=dtype, device=device)
            sw = torch.sqrt(w.clamp(min=0.0))
            denom = sw[:, None] * sw[None, :]
            Kc = torch.where(denom > 0, Kc / torch.where(
                denom > 0, denom, torch.ones_like(denom)),
                torch.zeros_like(Kc))
        if cfg.check:
            max_asym = float((Kc - Kc.T).abs().max())
            eval_, U, trace_G, raw_w = eigh_zeroed(Kc, with_raw=True)
            validate_kinship(None, eigenvalues=raw_w.cpu().numpy(),
                             strict=cfg.strict, max_asym=max_asym)
        else:
            eval_, U, trace_G = eigh_zeroed(Kc)
        if sw is not None:
            U = U * sw[:, None]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return eval_, U, trace_G


def run_eigen(cfg: GemmaConfig, log: RunLog | None = None,
              device: str | torch.device = "cuda") -> None:
    """-eigen: write eigenU/eigenD of the centred kinship matrix
    (gemma.cpp:2584-2669 with the write of param.cpp:1886)."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    eval_, U, _ = _load_or_compute_eigen(cfg, ds, log, dtype, device)
    ensure_outdir(cfg.path_out)
    with log.timer.phase("readback"):
        Uh = U.cpu().numpy().astype(np.float64)
        eh = eval_.cpu().numpy().astype(np.float64)
    with log.timer.phase("write"):
        write_matrix(f"{cfg.out_prefix()}.eigenU.txt", Uh, sidecar=True)
        write_vector(f"{cfg.out_prefix()}.eigenD.txt", eh)
    _summary(log, ds, cfg, ds.n_cvt, ds.qc.ns_test)
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)


# ---------------------------------------------------------------------------
# -lmm: univariate association

_STAT_NAMES = ("beta", "se", "lambda_remle", "lambda_mle", "p_wald",
               "p_lrt", "p_score", "logl_H1")


def run_lmm(cfg: GemmaConfig, log: RunLog | None = None,
            device: str | torch.device = "cuda") -> dict:
    """Univariate LMM association (-lmm 1/2/3/4/9), or the residual
    decomposition (-lmm 5), for one phenotype."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    if cfg.a_mode not in (1, 2, 3, 4, 5, 9):
        raise ValueError(f"run_lmm runs -lmm 1-5 and 9, not {cfg.a_mode}")
    for flag, on in (("-loco", cfg.loco), ("-ksnps", cfg.file_ksnps),
                     ("-gwasnps", cfg.file_gwasnps),
                     ("-gxe", cfg.file_gxe), ("-gene", cfg.file_gene)):
        if on:
            raise _not_ported(flag, "queue A, \"rest of run_lmm\"")
    if cfg.n_ph != 1:
        raise _not_ported("more than one -n phenotype (mvLMM)",
                          "queue A, \"mvLMM\"")
    with log.timer.phase("load"):
        ds = load_dataset(cfg)

    eval_, U, trace_G = _load_or_compute_eigen(cfg, ds, log, dtype, device)
    W = torch.as_tensor(ds.W, dtype=dtype, device=device)
    y = torch.as_tensor(ds.Y[:, 0], dtype=dtype, device=device)
    with log.timer.phase("utx"):
        UtW = U.T @ W
        Uty = U.T @ y

    n_cvt = ds.n_cvt
    nf = fit_null(eval_, UtW, Uty, trace_G, n_cvt,
                  l_min=cfg.l_min, l_max=cfg.l_max, n_region=cfg.n_region)
    log.null_model = dict(
        logl_remle_H0=float(nf.logl_remle), logl_mle_H0=float(nf.logl_mle),
        pve_null=float(nf.pve), pve_se_null=float(nf.pve_se),
        vg_remle_null=float(nf.vg_remle), ve_remle_null=float(nf.ve_remle),
        beta_remle_null=nf.beta_remle.cpu().double().numpy().tolist(),
        se_beta_remle_null=nf.se_beta_remle.cpu().double().numpy().tolist(),
    )

    if cfg.a_mode == 5:
        # -lmm 5 writes only the residual decomposition, and runs no
        # association (gemma.cpp:2756-2796)
        y_hat = Uty - UtW @ nf.beta_remle
        lam = nf.l_remle
        u_rot = lam * eval_ / (lam * eval_ + 1.0) * y_hat
        e_rot = 1.0 / (lam * eval_ + 1.0) * y_hat
        ensure_outdir(cfg.path_out)
        with log.timer.phase("write"):
            for name, v in (("residU", U @ u_rot), ("residE", U @ e_rot)):
                write_vector(f"{cfg.out_prefix()}.{name}.txt",
                             v.cpu().numpy().astype(np.float64))
        log.summary["number of total individuals"] = ds.ni_total
        log.summary["number of analyzed individuals"] = ds.ni_test
        log.summary["number of covariates"] = n_cvt
        log.summary["number of phenotypes"] = cfg.n_ph
        log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
        return dict(null=nf, dataset=ds)

    idx = np.flatnonzero(ds.qc.indicator_snp)      # file order
    n = ds.ni_test
    bs = _block_size(cfg, device, len(idx), n_axis=n)
    with log.timer.phase("opt"):
        pending = []
        for s in range(0, len(idx), bs):
            sel = idx[s:s + bs]
            raw = _raw_wire_block(ds, sel, bs, dtype, all_individuals=False)
            x = prologue(_to_device(raw, device), n, IMPUTE, dtype=dtype)
            Utx = x @ U
            st = assoc_block_impl(eval_, UtW, Uty, Utx, nf.l_mle,
                                  nf.logl_mle, n_cvt=n_cvt, mode=cfg.a_mode,
                                  l_min=cfg.l_min, l_max=cfg.l_max,
                                  n_region=cfg.n_region)
            pending.append((st, len(sel)))
        stats = {f: (torch.cat([getattr(st, f)[:k] for st, k in pending])
                     .cpu().numpy().astype(np.float64)) if pending
                 else np.zeros(0) for f in _STAT_NAMES}

    out_stats = dict(beta=stats["beta"], se=stats["se"],
                     logl_H1=stats["logl_H1"],
                     l_remle=stats["lambda_remle"],
                     l_mle=stats["lambda_mle"],
                     p_wald=stats["p_wald"], p_lrt=stats["p_lrt"],
                     p_score=stats["p_score"])
    ensure_outdir(cfg.path_out)
    with log.timer.phase("write"):
        rows = snp_rows_from_table(ds.geno.snps, ds.qc, idx)
        write_lmm_assoc(f"{cfg.out_prefix()}.assoc.txt", cfg.a_mode, rows,
                        out_stats)
    _summary(log, ds, cfg, n_cvt, len(idx))
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return dict(stats=out_stats, null=nf, snp_indices=idx, dataset=ds)


# ---------------------------------------------------------------------------

def batch_run(cfg: GemmaConfig, argv: list | None = None,
              device: str | None = None) -> None:
    """Mode dispatch (GEMMA::BatchRun, gemma.cpp:1641).

    `device` overrides cfg.device ("cuda" unless -device says otherwise)."""
    dev = resolve_device(device if device is not None else cfg.device)
    check_param(cfg)
    if cfg.trace_dir:
        raise _not_ported("-trace", "queue A, \"skeleton\" (profiling)")
    precision.apply_matmul_precision()
    log = RunLog(argv=argv or ["gemma_torch"], quiet=cfg.quiet, device=dev)
    if cfg.a_mode in (21, 22):
        run_gk(cfg, log, dev)
    elif cfg.a_mode == 31:
        run_eigen(cfg, log, dev)
    elif cfg.a_mode in (1, 2, 3, 4, 5, 9):
        run_lmm(cfg, log, dev)
    else:
        for modes, entry in _NOT_PORTED.items():
            if cfg.a_mode in modes:
                raise _not_ported(f"analysis mode {cfg.a_mode}", entry)
        raise NotImplementedError(f"analysis mode {cfg.a_mode} not yet "
                                  "implemented")
