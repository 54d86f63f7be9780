"""Analysis drivers — the BatchRun analogue (gemma.cpp:1641-3144).

The port runs `-gk 1|2` (kinship), `-eigen`, the univariate LMM
`-lmm 1/2/3/4/5/9` from `-k` or `-u/-d` (with `-widv` residual weights,
`-gxe`, `-gene`, LOCO and `-ksnps`/`-gwasnps`) and the linear model
`-lm 1/2/3/4` (with `-gene`), on one device, in float32 (speed mode) or
float64 (parity mode).  Each
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
from gemma_torch import kernels
from gemma_torch.io.readers import (read_eigen_d, read_eigen_u,
                                    read_gene_expression, read_kinship)
from gemma_torch.io.writers import (
    write_matrix, write_vector, write_lmm_assoc, write_lmm_gene_assoc,
    write_lm_assoc, write_lm_gene_assoc, snp_rows_from_table, ensure_outdir,
)
from gemma_torch.models.lm import lm_block, lm_gene_block
from gemma_torch.models.lmm.engine import (
    assoc_block_impl, assoc_gene_block_impl, assoc_gxe_block_impl, fit_null)
from gemma_torch.ops.center import center_matrix
from gemma_torch.ops.eigh import eigh_zeroed, zero_eigenvalues
from gemma_torch.ops.kinship import KinshipAccumulator
from gemma_torch.ops.pack2 import IMPUTE, PAD_BYTE, pack_bed_codes, prologue
from gemma_torch.utils.log import RunLog
from gemma_torch.utils.validate import check_finite, validate_kinship

# analysis modes outside this slice → their ROADMAP.md queue entry
_NOT_PORTED = {
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
                n_axis: int | None = None, per_lane: int = 1) -> int:
    """SNP block size for device batches, clamped to the dataset size.

    Unless -block-size was given, blocks grow to 16384 SNPs, backed off
    so `per_lane` (S, n) float32 blocks stay within a sixteenth of the
    card's free memory (the λ search holds a few such blocks at once;
    per-lane operands add c+1 + m_wy rows per lane); on the CPU the
    budget is 1.5 GiB.  Mirrors the reference's _mesh_block_size on one
    device."""
    base = cfg.block_size
    if not cfg.block_size_set:
        cap = 16384
        if n_axis:
            if device.type == "cuda":
                budget = torch.cuda.mem_get_info(device)[0] // 16
            else:
                budget = 3 << 29
            cap = max(1024, min(cap, budget // (4 * n_axis * per_lane)))
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


def _assoc_snp_indices(ds: Dataset) -> np.ndarray:
    """Indices of SNPs entering association, in file order: QC-passing,
    restricted to gwasnps under LOCO or -gwasnps (lmm.cpp:1586)."""
    idx = np.flatnonzero(ds.qc.indicator_snp)
    if ds.gwasnps is not None:
        keep = np.array([ds.geno.snps.rs[i] in ds.gwasnps for i in idx],
                        dtype=bool)
        idx = idx[keep]
    return idx


def _kinship_snp_mask(ds: Dataset) -> np.ndarray:
    """QC mask further restricted to ksnps under LOCO or -ksnps
    (BimbamKin gemma_io.cpp:1479)."""
    mask = ds.qc.indicator_snp.copy()
    if ds.ksnps is not None:
        mask &= np.array([rs in ds.ksnps for rs in ds.geno.snps.rs],
                         dtype=bool)
    return mask


def _lane_rows(c1: int, rows: int) -> int:
    """(S, n) rows a per-lane block holds per lane: UtWy's c1 columns,
    wy_prod's c1(c1+1)/2 and `rows` more (the operand, its rotations)."""
    return rows + c1 + c1 * (c1 + 1) // 2


def _gather(pending: list, names) -> dict:
    """Per-block device statistics (NamedTuple, valid rows) → one
    float64 numpy array per field."""
    return {f: (torch.cat([getattr(st, f)[:k] for st, k in pending])
                .cpu().numpy().astype(np.float64)) if pending
            else np.zeros(0) for f in names}


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
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    scale = cfg.gk_mode == 2 or cfg.a_mode == 22
    mask = _kinship_snp_mask(ds)

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
    decomposition (-lmm 5), for one phenotype; with -gxe the
    SNP-by-environment test, with -gene one test per gene."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    if cfg.a_mode not in (1, 2, 3, 4, 5, 9):
        raise ValueError(f"run_lmm runs -lmm 1-5 and 9, not {cfg.a_mode}")
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
    if cfg.file_gene:
        return _lmm_gene(cfg, log, ds, eval_, U, UtW, Uty, dtype, device)

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

    idx = _assoc_snp_indices(ds)                   # file order
    n = ds.ni_test
    per_lane = 1
    if ds.gxe is not None:
        # GxE: each lane's covariates are [W, env, x] (lmm.cpp:2283-2431)
        env = torch.as_tensor(ds.gxe, dtype=dtype, device=device)
        Ut_env = U.T @ env
        if device.type == "cuda":
            kernels.check_n_cvt(n_cvt + 2)
        per_lane = _lane_rows(n_cvt + 3, 4)
    bs = _block_size(cfg, device, len(idx), n_axis=n, per_lane=per_lane)
    with log.timer.phase("opt"):
        pending = []
        for s in range(0, len(idx), bs):
            sel = idx[s:s + bs]
            raw = _raw_wire_block(ds, sel, bs, dtype, all_individuals=False)
            x = prologue(_to_device(raw, device), n, IMPUTE, dtype=dtype)
            if ds.gxe is None:
                st = assoc_block_impl(eval_, UtW, Uty, x @ U, nf.l_mle,
                                      nf.logl_mle, n_cvt=n_cvt,
                                      mode=cfg.a_mode, l_min=cfg.l_min,
                                      l_max=cfg.l_max, n_region=cfg.n_region)
            else:
                # minor-allele coding where the imputed mean exceeds 1,
                # and beta's sign restored (lmm.cpp:2362-2370)
                flip = x.sum(dim=1, dtype=torch.float64) / n > 1.0
                x = torch.where(flip[:, None], 2.0 - x, x)
                st = assoc_gxe_block_impl(
                    eval_, UtW, Ut_env, Uty, x @ U, (x * env) @ U, nf.l_mle,
                    nf.logl_mle, n_cvt=n_cvt, mode=cfg.a_mode,
                    l_min=cfg.l_min, l_max=cfg.l_max, n_region=cfg.n_region)
                st = st._replace(beta=torch.where(flip, -st.beta, st.beta))
            pending.append((st, len(sel)))
        stats = _gather(pending, _STAT_NAMES)

    ensure_outdir(cfg.path_out)
    with log.timer.phase("write"):
        rows = snp_rows_from_table(ds.geno.snps, ds.qc, idx)
        write_lmm_assoc(f"{cfg.out_prefix()}.assoc.txt", cfg.a_mode, rows,
                        _out_stats(stats))
    _summary(log, ds, cfg, n_cvt, len(idx))
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return dict(stats=_out_stats(stats), null=nf, snp_indices=idx,
                dataset=ds)


def _out_stats(stats: dict) -> dict:
    """SUMSTAT field names → the assoc.txt column names."""
    return dict(beta=stats["beta"], se=stats["se"], logl_H1=stats["logl_H1"],
                l_remle=stats["lambda_remle"], l_mle=stats["lambda_mle"],
                p_wald=stats["p_wald"], p_lrt=stats["p_lrt"],
                p_score=stats["p_score"])


def _lmm_gene(cfg: GemmaConfig, log: RunLog, ds: Dataset, eval_, U, UtW,
              Uty, dtype: torch.dtype, device: torch.device) -> dict:
    """-lmm with -gene: each gene's expression is the response and the
    phenotype the predictor (gemma.cpp:2675-2692, lmm.cpp:1365-1471)."""
    gene_ids, expr = read_gene_expression(cfg.file_gene)
    expr_test = np.ascontiguousarray(expr[:, ds.indicator_idv])
    n_cvt = ds.n_cvt
    gb = _block_size(cfg, device, len(gene_ids), n_axis=ds.ni_test,
                     per_lane=_lane_rows(n_cvt + 1, 2))
    with log.timer.phase("opt"):
        pending = []
        for s in range(0, len(gene_ids), gb):
            blk = torch.as_tensor(expr_test[s:s + gb], dtype=dtype,
                                  device=device)
            st = assoc_gene_block_impl(eval_, UtW, Uty, blk @ U,
                                       n_cvt=n_cvt, mode=cfg.a_mode,
                                       l_min=cfg.l_min, l_max=cfg.l_max,
                                       n_region=cfg.n_region)
            pending.append((st, blk.shape[0]))
        stats = _out_stats(_gather(pending, _STAT_NAMES))
    ensure_outdir(cfg.path_out)
    with log.timer.phase("write"):
        write_lmm_gene_assoc(f"{cfg.out_prefix()}.assoc.txt", cfg.a_mode,
                             gene_ids, stats)
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = ds.ni_test
    log.summary["number of covariates"] = n_cvt
    log.summary["number of phenotypes"] = cfg.n_ph
    log.summary["number of total genes"] = len(gene_ids)
    log.summary["number of analyzed genes"] = len(gene_ids)
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return dict(stats=stats, gene_ids=gene_ids, dataset=ds)


# ---------------------------------------------------------------------------
# -lm: linear model

_LM_NAMES = ("beta", "se", "p_wald", "p_lrt", "p_score")


def run_lm(cfg: GemmaConfig, log: RunLog | None = None,
           device: str | torch.device = "cuda") -> dict:
    """Linear-model association (-lm 1/2/3/4, lm.cpp), per SNP or, with
    -gene, per gene (the phenotype is then the predictor)."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    W = torch.as_tensor(ds.W, dtype=dtype, device=device)
    y = torch.as_tensor(ds.Y[:, 0], dtype=dtype, device=device)
    n = ds.ni_test

    if cfg.file_gene:
        # LM::AnalyzeGene, lm.cpp:290-384; gemma.cpp:2076-2086
        gene_ids, expr = read_gene_expression(cfg.file_gene)
        expr_test = np.ascontiguousarray(expr[:, ds.indicator_idv])
        gb = _block_size(cfg, device, len(gene_ids), n_axis=n)
        with log.timer.phase("opt"):
            pending = []
            for s in range(0, len(gene_ids), gb):
                blk = torch.as_tensor(expr_test[s:s + gb], dtype=dtype,
                                      device=device)
                pending.append((lm_gene_block(W, y, blk, mode=cfg.a_mode),
                                blk.shape[0]))
            stats = _gather(pending, _LM_NAMES)
        ensure_outdir(cfg.path_out)
        with log.timer.phase("write"):
            write_lm_gene_assoc(f"{cfg.out_prefix()}.assoc.txt", cfg.a_mode,
                                gene_ids, stats)
        log.summary["number of total individuals"] = ds.ni_total
        log.summary["number of analyzed individuals"] = ds.ni_test
        log.summary["number of covariates"] = ds.n_cvt
        log.summary["number of total genes"] = len(gene_ids)
        log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
        return dict(stats=stats, gene_ids=gene_ids, dataset=ds)

    idx = _assoc_snp_indices(ds)
    bs = _block_size(cfg, device, len(idx), n_axis=n)
    with log.timer.phase("opt"):
        pending = []
        for s in range(0, len(idx), bs):
            sel = idx[s:s + bs]
            raw = _raw_wire_block(ds, sel, bs, dtype, all_individuals=False)
            x = prologue(_to_device(raw, device), n, IMPUTE, dtype=dtype)
            pending.append((lm_block(W, y, x, mode=cfg.a_mode), len(sel)))
        stats = _gather(pending, _LM_NAMES)
    ensure_outdir(cfg.path_out)
    with log.timer.phase("write"):
        rows = snp_rows_from_table(ds.geno.snps, ds.qc, idx)
        write_lm_assoc(f"{cfg.out_prefix()}.assoc.txt", cfg.a_mode, rows,
                       stats)
    _summary(log, ds, cfg, ds.n_cvt, len(idx))
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return dict(stats=stats, snp_indices=idx, dataset=ds)


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
    elif cfg.a_mode in (51, 52, 53, 54):
        run_lm(cfg, log, dev)
    else:
        for modes, entry in _NOT_PORTED.items():
            if cfg.a_mode in modes:
                raise _not_ported(f"analysis mode {cfg.a_mode}", entry)
        raise NotImplementedError(f"analysis mode {cfg.a_mode} not yet "
                                  "implemented")
