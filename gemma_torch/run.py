"""Analysis drivers — the BatchRun analogue (gemma.cpp:1641-3144).

The port runs `-gk 1|2` (kinship), `-eigen`, the univariate LMM
`-lmm 1/2/3/4/5/9` from `-k` or `-u/-d` (with `-widv` residual weights,
`-gxe`, `-gene`, LOCO and `-ksnps`/`-gwasnps`), the multivariate LMM
(`-lmm 1/2/3/4/9` with several `-n`, with `-gxe`), the linear model
`-lm 1/2/3/4` (with `-gene`), BSLMM `-bslmm 1-5` and prediction
`-predict 1/2/3`, variance components from kinships `-vc 1/2/3`, the
windowed correlations `-calccor`/`-gw`, and the summary-statistics
variance components (MQS: `-gs`, `-gq`, `-vc 1/2/3` with `-beta` or
`-study/-ref`, `-ci 1/2`), on one device, in float32 (speed mode) or
float64 (parity mode).  Each `run_*` wires the dataset through
the device code and writes GEMMA-compatible files; `batch_run` dispatches
on a_mode like the reference's if-chain.

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
from gemma_torch.io.readers import (read_eigen_d, read_eigen_u,
                                    read_gene_expression, read_kinship,
                                    read_multi_kinship)
from gemma_torch.io.readers import read_gxe
from gemma_torch.io.writers import (
    write_matrix, write_vector, write_lmm_assoc, write_lmm_gene_assoc,
    write_lm_assoc, write_lm_gene_assoc, write_mvlmm_assoc,
    write_bslmm_hyp, write_bslmm_gamma, write_bslmm_param, write_bslmm_bv,
    snp_rows_from_table, ensure_outdir,
)
from gemma_torch.models import bslmm, bslmmdap, ci, mqs, predict, varcov, vc
from gemma_torch.models.lm import lm_block, lm_gene_block
from gemma_torch.models.lmm import likelihood as lk
from gemma_torch.models.lmm.engine import (
    assoc_block_impl, assoc_gene_block_impl, assoc_gxe_block_impl, fit_null)
from gemma_torch.models.lmm.optimize import calc_lambda
from gemma_torch.models.mvlmm import MvlmmNull, mvlmm_assoc, mvlmm_assoc_gxe
from gemma_torch.ops.center import center_matrix
from gemma_torch.ops.eigh import eigh_zeroed, zero_eigenvalues
from gemma_torch.ops.kinship import KinshipAccumulator
from gemma_torch.ops.pack2 import IMPUTE, PAD_BYTE, pack_bed_codes, prologue
from gemma_torch.utils.log import RunLog
from gemma_torch.utils.validate import check_finite, validate_kinship

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
        raise ValueError("run_lmm is single-phenotype; use run_mvlmm")
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
# -lmm with several -n: multivariate LMM

# the most traits the mvLMM reads as float32 operands in the speed mode
# (scripts/mvlmm_traits_f32_gap.py: within 4.8e-6 of float64 up to 8)
_MV_F32_MAX_D = 8


def run_mvlmm(cfg: GemmaConfig, log: RunLog | None = None,
              device: str | torch.device = "cuda") -> dict:
    """Multivariate LMM association (-lmm 1/2/3/4/9 with more than one
    -n), with -gxe the SNP-by-environment test (MVLMM::AnalyzeBimbam and
    AnalyzeBimbamGXE, mvlmm.cpp:2972-4416).  -lmm 9 runs no test and
    writes the zero columns GEMMA writes.  -crt (read without -gxe only,
    as the reference: ROADMAP §C17) runs in float64 whatever -precision
    says: the -pnr refit stops at a 1e-3 logl tolerance and the
    correction amplifies where it stops, so float32 operands part its
    p_lrt from float64 by up to 0.4 (ROADMAP §C18).  So does the mvLMM
    beyond _MV_F32_MAX_D traits: there the EMs from float32 operands
    end elsewhere than from float64, p_lrt up to 0.047 apart at nine
    traits (ROADMAP §C20)."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    if (cfg.crt and not cfg.file_gxe) or cfg.n_ph > _MV_F32_MAX_D:
        dtype = torch.float64
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    d = cfg.n_ph
    eval_, U, _ = _load_or_compute_eigen(cfg, ds, log, dtype, device)
    W = torch.as_tensor(ds.W, dtype=dtype, device=device)
    Ymat = torch.as_tensor(ds.Y, dtype=dtype, device=device)
    with log.timer.phase("utx"):
        X0 = (U.T @ W).T.contiguous()                 # (c, n)
        Y = (U.T @ Ymat).T.contiguous()               # (d, n)
        if ds.gxe is not None:
            # the GxE null covariates are [W, env] (mvlmm.cpp:4049-4052)
            env = torch.as_tensor(ds.gxe, dtype=dtype, device=device)
            X0 = torch.cat([X0, (U.T @ env)[None]]).contiguous()
    rows = X0.shape[0] + (2 if ds.gxe is not None else 1)

    with log.timer.phase("null"):
        null = MvlmmNull(eval_, X0, Y, cfg)
    log.null_model = dict(logl_remle_H0=null.logl_remle_H0,
                          logl_mle_H0=null.logl_mle_H0)
    vg, ve = (t.cpu().numpy() for t in (null.Vg_remle, null.Ve_remle))
    for name, m in (("Vg", vg), ("Ve", ve)):
        log.extra.append(f"REMLE estimate for {name} in the null model: "
                         + " ".join(f"{m[i, j]:.6g}" for i in range(d)
                                    for j in range(i + 1)))
    for name, v in (("Vg", null.VVg_remle), ("Ve", null.VVe_remle)):
        log.extra.append(f"se({name}): " + " ".join(
            f"{s:.6g}" for s in np.sqrt(np.maximum(v, 0.0))))

    idx = _assoc_snp_indices(ds)
    n = ds.ni_test
    bs = _block_size(cfg, device, len(idx), n_axis=n, per_lane=rows)
    outs = dict(p_wald=[], p_lrt=[], p_score=[], beta=[], Vbeta=[],
                em_iters=[], refined=[])
    with log.timer.phase("opt"):
        for s in range(0, len(idx), bs):
            sel = idx[s:s + bs]
            k = len(sel)
            raw = _raw_wire_block(ds, sel, bs, dtype, all_individuals=False)
            x = prologue(_to_device(raw, device), n, IMPUTE, dtype=dtype)[:k]
            if ds.gxe is None:
                res = mvlmm_assoc(eval_, X0, Y, (x @ U).contiguous(), null,
                                  cfg.a_mode, cfg, dtype)
            else:
                # minor-allele coding where the imputed mean exceeds 1,
                # and beta's sign restored (mvlmm.cpp:4254-4258)
                flip = x.sum(dim=1, dtype=torch.float64) / n > 1.0
                x = torch.where(flip[:, None], 2.0 - x, x)
                res = mvlmm_assoc_gxe(eval_, X0, Y, (x @ U).contiguous(),
                                      ((x * env) @ U).contiguous(), null,
                                      cfg.a_mode, cfg, dtype)
                res["beta"] *= np.where(flip.cpu().numpy(), -1.0,
                                        1.0)[:, None]
            for name in outs:
                outs[name].append(res[name])
        outs = {k: np.concatenate(v) if v else np.zeros((0,))
                for k, v in outs.items()}

    ensure_outdir(cfg.path_out)
    with log.timer.phase("write"):
        write_mvlmm_assoc(f"{cfg.out_prefix()}.assoc.txt", cfg.a_mode, d,
                          snp_rows_from_table(ds.geno.snps, ds.qc, idx),
                          outs["beta"], outs["Vbeta"], outs["p_wald"],
                          outs["p_lrt"], outs["p_score"])
    _summary(log, ds, cfg, ds.n_cvt, len(idx))
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode, n_ph=d)
    return dict(stats=outs, null=null, snp_indices=idx, dataset=ds)


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
# -bslmm: BSLMM (modes 11-14) and its DAP EM (mode 15)

def _centred_genotypes(cfg: GemmaConfig, ds: Dataset, idx: np.ndarray,
                       dtype: torch.dtype, device: torch.device):
    """(p, n) mean-imputed genotypes of the SNPs `idx` over the analyzed
    individuals, each row centred (ReadGenotypes' second pass,
    gemma_io.cpp:1742-1838): K1's imputed operand, block by block."""
    n = ds.ni_test
    Xc = torch.empty((len(idx), n), dtype=dtype, device=device)
    bs = _block_size(cfg, device, len(idx), n_axis=n)
    for s in range(0, len(idx), bs):
        sel = idx[s:s + bs]
        raw = _raw_wire_block(ds, sel, bs, dtype, all_individuals=False)
        x = prologue(_to_device(raw, device), n, IMPUTE,
                     dtype=dtype)[:len(sel)]
        Xc[s:s + len(sel)] = x - x.mean(dim=1, keepdim=True)
    return Xc


def _bslmm_ranking(cfg: GemmaConfig, eval_, UtW, Uty, UtXT, dtype,
                   device) -> np.ndarray:
    """Per-SNP ML log-likelihood ratio, the proposal's ranking
    (MatrixCalcLR, lmm.cpp:1905-1943): the λ searches of -lmm (K2/K3 in
    float32, K7 in float64) block by block."""
    n = eval_.shape[0]
    data0 = lk.build_batch_data(eval_, UtW, Uty,
                                torch.zeros((1, n), dtype=dtype,
                                            device=device), 1)
    null_ml = calc_lambda(data0, 1, calc_null=True, reml=False,
                          l_min=cfg.l_min, l_max=cfg.l_max,
                          n_region=cfg.n_region)
    logl_H0 = float(null_ml.logf[0])
    p = UtXT.shape[0]
    loglr = np.zeros(p)
    B = _block_size(cfg, device, p, n_axis=n)
    for s in range(0, p, B):
        data = lk.build_batch_data(eval_, UtW, Uty, UtXT[s:s + B], 1)
        res = calc_lambda(data, 1, calc_null=False, reml=False,
                          l_min=cfg.l_min, l_max=cfg.l_max,
                          n_region=cfg.n_region)
        loglr[s:s + B] = res.logf.cpu().double().numpy() - logl_H0
    return loglr


def run_bslmm(cfg: GemmaConfig, log: RunLog | None = None,
              device: str | torch.device = "cuda") -> dict:
    """-bslmm 1 (MCMC), 2 (ridge/GBLUP), 3 (probit MCMC) and 4 (DAP Bayes
    factors; with -rmin 1 -rmax 1 the MCMC instead) (gemma.cpp:2880-3083,
    bslmm.cpp).  The chain runs on kernel K12, the Bayes factors on K13,
    the proposal's ranking on the -lmm λ searches."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    idx = np.flatnonzero(ds.qc.indicator_snp)
    ns_test, n = len(idx), ds.ni_test
    with log.timer.phase("geno"):
        Xc = _centred_genotypes(cfg, ds, idx, dtype, device)

    y = ds.Y[:, 0].copy()
    pheno_mean = float(y.mean())
    y = y - pheno_mean
    log.extra.append(f"estimated mean = {pheno_mean:.6g}")

    # kinship: from file (-k) or centred X'X/ns (gemma.cpp:2906-2922)
    if cfg.file_kin:
        with log.timer.phase("kread"):
            K = center_matrix(torch.as_tensor(
                read_kinship(cfg.file_kin, ds.indicator_idv, ids=ds.ids,
                             k_mode=cfg.k_mode), dtype=dtype, device=device))
    else:
        K = (Xc.T @ Xc) / ns_test
    with log.timer.phase("eigen"):
        eval_, U, trace_G = eigh_zeroed(K)
    del K
    yd = torch.as_tensor(y, dtype=dtype, device=device)
    UtW = U.T @ torch.ones((n, 1), dtype=dtype, device=device)
    Uty = U.T @ yd
    nf = fit_null(eval_, UtW, Uty, trace_G, 1, l_min=cfg.l_min,
                  l_max=cfg.l_max, n_region=cfg.n_region)
    log.null_model = dict(
        logl_remle_H0=float(nf.logl_remle), logl_mle_H0=float(nf.logl_mle),
        pve_null=float(nf.pve), pve_se_null=float(nf.pve_se),
        vg_remle_null=float(nf.vg_remle), ve_remle_null=float(nf.ve_remle),
        beta_remle_null=nf.beta_remle.cpu().double().numpy().tolist(),
        se_beta_remle_null=nf.se_beta_remle.cpu().double().numpy().tolist())
    with log.timer.phase("utx"):
        UtXT = Xc @ U                                   # (p, n)
    del Xc
    ensure_outdir(cfg.path_out)
    rows = snp_rows_from_table(ds.geno.snps, ds.qc, idx)
    out = dict(dataset=ds, eval=eval_, U=U, Uty=Uty, UtXT=UtXT, null=nf)

    # -bslmm 4 with rho fixed at 1 runs plain BVSR MCMC instead of the DAP
    # grid (gemma.cpp:2997-3010)
    if cfg.a_mode == 14 and not (cfg.rho_min == 1 and cfg.rho_max == 1):
        h_min = 0.0 if cfg.h_min == -1 else cfg.h_min
        h_max = 1.0 if cfg.h_max == -1 else cfg.h_max
        if h_max >= 1.0:
            # the grid's sigma_a2 = h rho / ((1 - h) 10) is undefined at h
            # = 1; the reference raises ZeroDivisionError there (ROADMAP
            # §C13)
            raise ValueError("-bslmm 4 needs -hmax below 1 (the default 1 "
                             "puts h = 1 on the grid, where sigma_a2 and "
                             "sigma_b2 divide by 1 - h = 0)")
        grid = bslmmdap.hyper_grid(h_min, h_max, cfg.h_ngrid, cfg.rho_min,
                                   cfg.rho_max, cfg.rho_ngrid,
                                   float(trace_G))
        with log.timer.phase("opt"):
            BF = bslmmdap.dap_calc_bf(UtXT, Uty, eval_, grid)
        with log.timer.phase("write"):
            bslmmdap.write_hyp_bf(cfg.out_prefix(), grid, BF, rows)
        log.summary["number of analyzed SNPs/var"] = ns_test
        log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
        return dict(out, BF=BF, grid=grid)

    if cfg.a_mode == 12:   # ridge / GBLUP
        alpha, u_rot = bslmm.ridge_gblup(UtXT, Uty, eval_, nf.l_remle)
        bv = (U @ u_rot).cpu().double().numpy()
        alpha = alpha.cpu().double().numpy()
        write_bslmm_param(f"{cfg.out_prefix()}.param.txt", rows, alpha,
                          np.zeros(ns_test), np.zeros(ns_test))
        write_bslmm_bv(f"{cfg.out_prefix()}.bv.txt", bv, ds.indicator_idv)
        log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
        return dict(out, alpha=alpha, bv=bv)

    with log.timer.phase("proposal"):
        loglr = _bslmm_ranking(cfg, eval_, UtW, Uty, UtXT, dtype, device)
    order = np.argsort(-loglr, kind="stable")     # rank → original row
    UtXT_sorted = UtXT[torch.as_tensor(order, device=device)]

    st = bslmm.BslmmSettings(
        ns_test=ns_test, ni_test=n, s_min=cfg.s_min, s_max=cfg.s_max,
        h_min=cfg.h_min, h_max=cfg.h_max, rho_min=cfg.rho_min,
        rho_max=cfg.rho_max, logp_min=cfg.logp_min, logp_max=cfg.logp_max,
        geo_mean=cfg.geo_mean, w_step=cfg.w_step, s_step=cfg.s_step,
        r_pace=cfg.r_pace, w_pace=cfg.w_pace,
        n_mh=1 if cfg.a_mode == 11 else cfg.n_mh, a_mode=cfg.a_mode,
        h_scale=cfg.h_scale, rho_scale=cfg.rho_scale,
        # -pscale input is in log10 units (gemma.cpp:1509)
        logp_scale=(cfg.logp_scale * np.log(10.0)
                    if cfg.logp_scale != -1 else -1.0))

    # initial values (InitialMCMC, bslmm.cpp:367-448)
    # the chi-square(1) quantile of a genome-wide 0.05: (Phi^-1(a/2))^2
    q_genome = float(torch.special.ndtri(torch.tensor(
        0.025 / ns_test, dtype=torch.float64)) ** 2)
    n_gamma0 = int(np.sum(2.0 * loglr > q_genome))
    n_gamma0 = max(n_gamma0, 10)
    n_gamma0 = min(max(n_gamma0, st.s_min), st.s_max)
    logp0 = float(np.log(n_gamma0 / ns_test))
    if logp0 == 0:
        logp0 = -1e-6
    h0 = float(nf.pve) if float(nf.pve) != 0 else 0.1
    tg = float(trace_G)
    sigma_a2 = (h0 / (tg * (1 - h0) * np.exp(logp0) * ns_test) if tg != 0
                else h0 / ((1 - h0) * np.exp(logp0) * ns_test)) or 0.025
    Xg0 = UtXT_sorted[:n_gamma0]
    Om = Xg0 @ Xg0.T + torch.eye(n_gamma0, dtype=dtype,
                                 device=device) / sigma_a2
    Xty0 = Xg0 @ Uty
    pve_lm = float(Xty0 @ torch.linalg.solve(Om, Xty0) / (Uty @ Uty))
    rho0 = min(pve_lm / h0, 1.0)
    h0 = min(max(h0, st.h_min), st.h_max)
    rho0 = min(max(rho0, st.rho_min), st.rho_max)
    logp0 = min(max(logp0, st.logp_min), st.logp_max)
    log.extra.append("MCMC related:")
    log.extra.append(f"initial value of h = {h0:.6g}")
    log.extra.append(f"initial value of rho = {rho0:.6g}")
    log.extra.append(f"initial value of pi = {np.exp(logp0):.6g}")
    log.extra.append(f"initial value of |gamma| = {n_gamma0}")

    def gamma_positions(rec_gamma):
        """Recorded ranks + 1 → 1-based positions among analyzed SNPs."""
        return np.where(rec_gamma > 0, order[rec_gamma - 1] + 1, 0)

    def flush_partial(state):
        if state.w <= 0:
            return
        write_bslmm_hyp(f"{cfg.out_prefix()}.hyp.txt",
                        state.rec_hyp[:state.w].cpu().numpy())
        write_bslmm_gamma(f"{cfg.out_prefix()}.gamma.txt", gamma_positions(
            state.rec_gamma[:state.w].cpu().numpy()), st.s_max)

    probit = cfg.a_mode == 13
    ops = bslmm.chain_operands(UtXT_sorted, Uty, eval_, tg, st.geo_mean,
                               U=U if probit else None,
                               y_labels=yd if probit else None)
    with log.timer.phase("opt"):
        final = bslmm.run_mcmc(
            ops, st, h0, rho0, logp0, n_gamma0,
            seed=cfg.seed if cfg.seed >= 0 else 0,
            checkpoint_path=f"{cfg.out_prefix()}.mcmc.ckpt.npz",
            checkpoint_every=cfg.checkpoint_every, on_segment=flush_partial)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    w = final.w
    with log.timer.phase("write"):
        write_bslmm_hyp(f"{cfg.out_prefix()}.hyp.txt",
                        final.rec_hyp[:w].cpu().numpy())
        write_bslmm_gamma(f"{cfg.out_prefix()}.gamma.txt", gamma_positions(
            final.rec_gamma[:w].cpu().numpy()), st.s_max)
        # posterior means (bslmm.cpp:1170-1183)
        alpha = (UtXT @ (final.acc_alpha / w).to(dtype)).cpu().double(
            ).numpy() / ns_test
        beta_sum = final.acc_beta.cpu().numpy()       # indexed by rank
        beta_cnt = final.acc_betacnt.cpu().numpy()
        beta_mean = np.zeros(ns_test)
        gamma_freq = np.zeros(ns_test)
        beta_mean[order] = np.where(beta_cnt > 0,
                                    beta_sum / np.maximum(beta_cnt, 1), 0.0)
        gamma_freq[order] = beta_cnt / w
        write_bslmm_param(f"{cfg.out_prefix()}.param.txt", rows, alpha,
                          beta_mean, gamma_freq)
        bv = (U @ (final.acc_Utu / w).to(dtype)).cpu().double().numpy()
        write_bslmm_bv(f"{cfg.out_prefix()}.bv.txt", bv, ds.indicator_idv)

    total_mh = (st.w_step + st.s_step) * st.n_mh
    log.extra.append(f"random seed = {cfg.seed}")
    log.extra.append(f"acceptance ratio = {final.n_accept / total_mh:.6g}")
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = ds.ni_test
    log.summary["number of total SNPs/var"] = ds.geno.n_snps
    log.summary["number of analyzed SNPs/var"] = ns_test
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return dict(out, state=final, order=order, loglr=loglr, ops=ops,
                settings=st, alpha=alpha, beta=beta_mean,
                gamma=gamma_freq, bv=bv,
                chain_seconds=log.timer.times.get("opt", 0.0),
                init=dict(h=h0, rho=rho0, logp=logp0, n_gamma=n_gamma0))


def run_bslmmdap_em(cfg: GemmaConfig, log: RunLog | None = None,
                    device: str | torch.device = "cuda") -> tuple:
    """-bslmm 5: the DAP hyper-parameter EM from -hyp/-bf files, with
    -cat annotations (gemma.cpp:3085-3136); host numpy, as the
    reference."""
    log = log or RunLog(argv=["gemma_torch"], device=torch.device(device))
    sa2, sb2, wab = bslmmdap.read_hyp(cfg.file_hyp)
    rs_list, blocks = bslmmdap.read_bf(cfg.file_bf)
    Ac = Ad = n_levels = None
    if cfg.file_cat:
        # annotation-dependent priors via logistic regression
        # (gemma.cpp:3103-3109)
        Ac, Ad, n_levels = bslmmdap.read_dap_annotations(cfg.file_cat,
                                                         rs_list)
        log.summary["number of continuous annotations"] = \
            0 if Ac is None else Ac.shape[1]
        log.summary["number of discrete annotations"] = \
            0 if Ad is None else Ad.shape[1]
    with log.timer.phase("opt"):
        Hyper, pip, coef = bslmmdap.dap_estimate_hyper(
            sa2, sb2, wab, blocks, rs_list, Ac=Ac, Ad=Ad, n_levels=n_levels)
    ensure_outdir(cfg.path_out)
    bslmmdap.write_dap_result(cfg.out_prefix(), rs_list, Hyper, pip, coef)
    log.summary["number of analyzed SNPs/var"] = len(rs_list)
    log.summary["grid size for hyperparameters"] = len(wab)
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return Hyper, pip, coef


# ---------------------------------------------------------------------------
# -predict

def _write_prdt(path: str, keep: np.ndarray, values: np.ndarray,
                rows: bool) -> None:
    """prefix.prdt.txt: NA where `keep` is False, else the next value (a
    row of tab-ended values with `rows`)."""
    with open(path, "w") as fh:
        ci = 0
        for k in keep:
            if not k:
                fh.write("NA\n")
            elif rows:
                fh.write("\t".join(f"{v:.6g}" for v in values[ci]) + "\t\n")
                ci += 1
            else:
                fh.write(f"{values[ci]:.6g}\n")
                ci += 1


def run_predict(cfg: GemmaConfig, log: RunLog | None = None,
                device: str | torch.device = "cuda") -> np.ndarray:
    """-predict 1/2: phenotypes of the individuals without one, from
    -epm effects (and -ebv breeding values with -k), on the probit scale
    in mode 42 (gemma.cpp:1661-1730, prdt.cpp)."""
    device = torch.device(device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg, need_qc=False)
    pheno_mean = cfg.pheno_mean
    if cfg.file_emu:
        # -emu: the estimated mean from a previous run's .log.txt
        # (ReadFile_log, gemma_io.cpp:239-276)
        with open(cfg.file_emu) as fh:
            for line in fh:
                toks = line.replace(",", " ").split()
                if (len(toks) >= 5 and toks[1] == "estimated"
                        and toks[2] == "mean" and toks[3] == "="):
                    pheno_mean = float(toks[4])
                    break

    test = ~ds.indicator_idv
    y_prdt = np.zeros(int(test.sum()))
    with log.timer.phase("opt"):
        if cfg.file_kin and cfg.file_ebv:
            bv, ind_bv = read_gxe(cfg.file_ebv)
            # kinship over ALL individuals (indicator_all,
            # gemma.cpp:1680-1692)
            G = read_kinship(cfg.file_kin, np.ones(ds.ni_total, dtype=bool),
                             ids=ds.ids, k_mode=cfg.k_mode)
            y_prdt += predict.add_breeding_values(G, bv[ind_bv],
                                                  ds.indicator_idv, device)
        if cfg.file_epm:
            # -en overrides the default column layout (param.cpp:671-683)
            if cfg.est_column:
                est_cols = tuple(cfg.est_column)
            else:
                est_cols = (2, 5, 6, 7) if not cfg.file_ebv else (2, 0, 6, 7)
            effects = predict.read_est(cfg.file_epm, est_cols)
            y_add, ns_used = predict.predict_effects_fetch(
                ds.geno.block, list(ds.geno.snps.rs), ds.indicator_idv,
                effects, device=device)
            y_prdt += y_add
            log.summary["number of analyzed SNPs/var"] = ns_used
    y_prdt += pheno_mean
    if cfg.a_mode == 42:
        y_prdt = predict.probit_transform(y_prdt)
    ensure_outdir(cfg.path_out)
    _write_prdt(f"{cfg.out_prefix()}.prdt.txt", ~ds.indicator_idv, y_prdt,
                rows=False)
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = ds.ni_test
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return y_prdt


def run_predict43(cfg: GemmaConfig, log: RunLog | None = None,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """-predict 3: conditional-MVN phenotype imputation from the kinship
    matrix and a null (mv)LMM fit (gemma.cpp:1732-1897)."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg, need_geno=False)
    d = cfg.n_ph
    # analyzed = full phenotypes; "full" set = covariate-valid rows
    ind_cvt = ds.indicator_cvt
    Y_full = ds.pheno[ind_cvt]                      # NaN = to predict
    W_full = ds.cvt_all[ind_cvt]
    G = read_kinship(cfg.file_kin, ds.indicator_idv, ids=ds.ids,
                     k_mode=cfg.k_mode)
    G_full = read_kinship(cfg.file_kin, ind_cvt, ids=ds.ids,
                          k_mode=cfg.k_mode)
    G_full = center_matrix(torch.as_tensor(G_full, dtype=torch.float64))
    with log.timer.phase("eigen"):
        eval_, U, trace_G = eigh_zeroed(center_matrix(
            torch.as_tensor(G, dtype=dtype, device=device)))
    UtW = U.T @ torch.as_tensor(ds.W, dtype=dtype, device=device)
    with log.timer.phase("opt"):
        if d == 1:
            Uty = U.T @ torch.as_tensor(ds.Y[:, 0], dtype=dtype,
                                        device=device)
            nf = fit_null(eval_, UtW, Uty, trace_G, ds.n_cvt,
                          l_min=cfg.l_min, l_max=cfg.l_max,
                          n_region=cfg.n_region)
            vg, ve = float(nf.vg_remle), float(nf.ve_remle)
            beta = nf.beta_remle.cpu().double().numpy()
            out = predict.mvnorm_predict(Y_full, (W_full @ beta)[:, None],
                                         G_full.numpy(), np.asarray(vg),
                                         np.asarray(ve), device)
            log.null_model = dict(vg_remle_null=vg, ve_remle_null=ve)
        else:
            UtY = U.T @ torch.as_tensor(ds.Y, dtype=dtype, device=device)
            null = MvlmmNull(eval_, UtW.T.contiguous(), UtY.T.contiguous(),
                             cfg)
            Vg, Ve, B = (v.cpu().double().numpy() for v in
                         (null.Vg_remle, null.Ve_remle, null.B_remle))
            out = predict.mvnorm_predict(Y_full, W_full @ B.T,
                                         G_full.numpy(), Vg, Ve, device)
    ensure_outdir(cfg.path_out)
    _write_prdt(f"{cfg.out_prefix()}.prdt.txt", ind_cvt, out, rows=True)
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = int(ind_cvt.sum())
    log.summary["number of individuals with full phenotypes"] = ds.ni_test
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode, n_ph=d)
    return out


# ---------------------------------------------------------------------------
# -vc: variance components from kinship matrices (modes 61-63)

def run_vc(cfg: GemmaConfig, log: RunLog | None = None,
           device: str | torch.device = "cuda") -> vc.VcResult:
    """HE (-vc 1), REML-AI (-vc 2) or ACL (-vc 3) estimates of the
    variance components of one phenotype from -k or -mk kinships
    (gemma.cpp:2332-2374, vc.cpp)."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg, need_geno=False)
    if cfg.n_ph != 1:
        raise NotImplementedError("-vc supports one phenotype")
    with log.timer.phase("kread"):
        if cfg.file_mk:
            K = read_multi_kinship(cfg.file_mk, ds.indicator_idv, ids=ds.ids,
                                   k_mode=cfg.k_mode)
        elif cfg.file_kin:
            K = read_kinship(cfg.file_kin, ds.indicator_idv, ids=ds.ids,
                             k_mode=cfg.k_mode)[None]
        else:
            raise ValueError("-vc requires -k or -mk")
    # centre each K and record its trace (the reference's run.py:1380-1389)
    Kd = torch.as_tensor(np.asarray(K, np.float64), dtype=torch.float64,
                         device=device)
    Kd = torch.stack([center_matrix(Ki) for Ki in Kd])
    v_traceG = torch.diagonal(Kd, dim1=-2, dim2=-1).mean(-1).cpu().numpy()
    if cfg.check and cfg.file_kin:
        validate_kinship(Kd[0].cpu().numpy(), strict=cfg.strict)
    Kd = Kd.to(dtype).contiguous()
    W = torch.as_tensor(ds.W, dtype=dtype, device=device)
    y = torch.as_tensor(ds.Y[:, 0], dtype=dtype, device=device)
    with log.timer.phase("opt"):
        if cfg.a_mode == 61:
            res = vc.vc_he(Kd, W, y, v_traceG)
        elif cfg.a_mode == 62:
            res = vc.vc_reml_ai(Kd, W, y, v_traceG,
                                noconstrain=cfg.noconstrain)
        else:
            res = vc.vc_acl(Kd, W, y, v_traceG)

    m = Kd.shape[0]
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = ds.ni_test
    log.summary["number of covariates"] = ds.n_cvt
    log.summary["number of phenotypes"] = cfg.n_ph
    log.summary["number of variance components"] = m
    log.extra.append("pve estimates = " +
                     "".join(f"  {v:.6g}" for v in res.pve))
    log.extra.append("se(pve) = " +
                     "".join(f"  {v:.6g}" for v in res.se_pve))
    if m > 1:
        log.extra.append(f"total pve = {res.pve_total:.6g}")
        log.extra.append(f"se(total pve) = {res.se_pve_total:.6g}")
    log.extra.append("sigma2 estimates = " +
                     "".join(f"  {v:.6g}" for v in res.sigma2))
    log.extra.append("se(sigma2) = " +
                     "".join(f"  {v:.6g}" for v in res.se_sigma2))
    ensure_outdir(cfg.path_out)
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return res


# ---------------------------------------------------------------------------
# -calccor and -gw: windowed SNP correlations (modes 71, 72)

def run_calccor(cfg: GemmaConfig, log: RunLog | None = None,
                device: str | torch.device = "cuda") -> dict:
    """Each kept SNP's variance and its correlations with the following
    SNPs in its window (VARCOV, varcov.cpp); -gw (mode 72) runs the same
    analysis (gemma.cpp:1928-1945).  Writes prefix.cor.txt."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    window_bp = cfg.window_bp
    if cfg.window_cm == 0 and cfg.window_bp == 0 and cfg.window_ns == 0:
        window_bp = 1e6  # param.cpp:629-631
    idx = np.flatnonzero(ds.qc.indicator_snp)
    chr_ = [ds.geno.snps.chr[i] for i in idx]
    n_nb = varcov.calc_neighbours(chr_, ds.geno.snps.pos[idx],
                                  ds.geno.snps.cM[idx], window_bp,
                                  cfg.window_cm, cfg.window_ns)

    def fetch(lo, hi):
        return ds.geno.block(idx[lo:hi])[:, ds.indicator_idv]

    with log.timer.phase("opt"):
        var, cors = varcov.windowed_correlations_fetch(
            fetch, len(idx), ds.ni_test, n_nb, dtype, device)
    rows = snp_rows_from_table(ds.geno.snps, ds.qc, idx)
    for r, i in zip(rows, idx):
        r["n_obs"] = int(ds.qc.n_idv[i])
    ensure_outdir(cfg.path_out)
    with log.timer.phase("write"):
        varcov.write_cor(f"{cfg.out_prefix()}.cor.txt", rows, var, cors)
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = ds.ni_test
    log.summary["number of total SNPs/var"] = ds.geno.n_snps
    log.summary["number of analyzed SNPs/var"] = len(idx)
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return dict(var=var, cors=cors, n_nb=n_nb, snp_indices=idx, dataset=ds)


# ---------------------------------------------------------------------------
# MQS, summary-statistics variance components: -gs (S matrix), -gq (q
# vector), -vc with -beta or -study/-ref, -ci 1/2 (modes 25-28, 61-63,
# 66, 67)

def read_categories_multi(cfg: GemmaConfig):
    """-cat or -mcat (list of cat files, first occurrence wins,
    n_vc = max; ReadFile_mcat gemma_io.cpp)."""
    if cfg.file_cat:
        return mqs.read_categories(cfg.file_cat)
    rs2cat, n_vc = {}, 1
    with open(cfg.file_mcat) as fh:
        for t, line in enumerate(ln.strip() for ln in fh if ln.strip()):
            sub, nv = mqs.read_categories(line)
            for rs, c in sub.items():
                rs2cat.setdefault(rs, c)
            n_vc = nv if t == 0 else max(n_vc, nv)
    return rs2cat, n_vc


def _snp_categories(ds: Dataset, cfg: GemmaConfig):
    """(QC-passing SNP indices in file order, their categories (-1 =
    none), n_vc, rs2cat or None)."""
    idx = np.flatnonzero(ds.qc.indicator_snp)
    if cfg.file_cat or cfg.file_mcat:
        rs2cat, n_vc = read_categories_multi(cfg)
        cats = np.array([rs2cat.get(ds.geno.snps.rs[i], -1) for i in idx],
                        dtype=np.int64)
        return idx, cats, n_vc, rs2cat
    return idx, np.zeros(len(idx), dtype=np.int64), 1, None


def _geno_fetch(ds: Dataset, idx: np.ndarray, dtype: torch.dtype,
                device: torch.device):
    """fetch(lo, hi): the raw rows idx[lo:hi] over the analyzed
    individuals, in the smallest wire K1 reads, on `device`."""
    def fetch(lo, hi):
        sel = idx[lo:hi]
        return _to_device(_raw_wire_block(ds, sel, len(sel), dtype,
                                          all_individuals=False), device)
    return fetch


def _mqs_log_lines(log: RunLog, res) -> None:
    for name, v in (("pve estimates", res.pve), ("se(pve)", res.se_pve),
                    ("sigma2 per snp", res.sigma2persnp),
                    ("se(sigma2 per snp)", res.se_sigma2persnp),
                    ("enrichment", res.enrich),
                    ("se(enrichment)", res.se_enrich)):
        log.extra.append(f"{name} = " + "".join(f"  {x:.6g}" for x in v))


def run_gs(cfg: GemmaConfig, log: RunLog | None = None,
           device: str | torch.device = "cuda"):
    """-gs: the S matrix and its jackknife variance from reference
    genotypes (gemma.cpp:1947-2001).  Writes prefix.S.txt (S over Svar),
    prefix.size.txt (per-category SNP counts, then n) and the analyzed
    SNP ids, prefix.snps.txt.gz."""
    import gzip
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    idx, cats, n_vc, rs2cat = _snp_categories(ds, cfg)

    # -wsnp/-wcat weights via ObtainWeight (gemma.cpp:1972-1975)
    qc_rs = [ds.geno.snps.rs[i] for i in idx]
    rs2wsnp = ci.read_wsnp(cfg.file_wsnp) if cfg.file_wsnp else None
    rs2wcat = ci.read_wcat(cfg.file_wcat, n_vc) if cfg.file_wcat else None
    weights = None
    if rs2wsnp is not None or rs2wcat is not None or rs2cat is not None:
        wK = ci.obtain_weight(qc_rs, set(), rs2cat, rs2wsnp, rs2wcat)
        cats = np.where([rs in wK for rs in qc_rs], cats, -1)
        if rs2wsnp is not None:
            weights = np.array([wK.get(rs, 0.0) for rs in qc_rs])

    with log.timer.phase("kinship"):
        S, Svar, ns = mqs.calc_s_fetch(
            _geno_fetch(ds, idx, dtype, device), len(idx), ds.W, cats, n_vc,
            weights=weights, dtype=dtype, device=device)

    ensure_outdir(cfg.path_out)
    write_matrix(f"{cfg.out_prefix()}.S.txt", np.vstack([S, Svar]))
    write_vector(f"{cfg.out_prefix()}.size.txt",
                 np.concatenate([ns.astype(float), [float(ds.ni_test)]]))
    # analyzed SNP ids (WriteVar "snps", param.cpp:1851-1884)
    with gzip.open(f"{cfg.out_prefix()}.snps.txt.gz", "wt") as fh:
        for rs, c in zip(qc_rs, cats):
            if c >= 0:
                fh.write(f"{rs}\n")
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = ds.ni_test
    log.summary["number of variance components"] = n_vc
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return S, Svar, ns


def run_gq(cfg: GemmaConfig, log: RunLog | None = None,
           device: str | torch.device = "cuda"):
    """-gq: the q vector and its block-jackknife Vq from summary
    statistics (gemma.cpp:2003-2043).  It reads no genotype, and runs on
    the host in numpy as in the reference; `device` only names the run's
    device in the log."""
    log = log or RunLog(argv=["gemma_torch"], device=torch.device(device))
    rs2cat, n_vc = (None, 1)
    if cfg.file_cat:
        rs2cat, n_vc = mqs.read_categories(cfg.file_cat)
    beta = mqs.read_beta_summary(cfg.file_beta, rs2cat=rs2cat)
    Vq, q, s = mqs.calcq(cfg.n_block, beta.cat, beta.ni, beta.weight,
                         beta.z2, n_vc)

    ensure_outdir(cfg.path_out)
    write_matrix(f"{cfg.out_prefix()}.Vq.txt", Vq)
    write_vector(f"{cfg.out_prefix()}.q.txt", q)
    write_vector(f"{cfg.out_prefix()}.size.txt",
                 np.concatenate([s, [float(beta.ni_total)]]))
    log.summary["number of total individuals"] = beta.ni_total
    log.summary["number of total SNPs/var"] = beta.ns_total
    log.summary["number of analyzed SNPs/var"] = beta.ns_test
    log.summary["number of variance components"] = n_vc
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return Vq, q, s


def run_vc_study_ref(cfg: GemmaConfig, log: RunLog | None = None,
                     device: str | torch.device = "cuda") -> mqs.MqsResult:
    """-vc with -study/-ref (or -mstudy/-mref): solve S pve = q from the
    files -gq and -gs wrote (gemma.cpp:2231-2312).  It reads no genotype
    and runs on the host in numpy as in the reference; `device` only
    names the run's device in the log."""
    log = log or RunLog(argv=["gemma_torch"], device=torch.device(device))
    if cfg.file_study:
        Vq, q, s_study, ni_study = ci.read_study(cfg.file_study)
    else:
        Vq, q, s_study, ni_study = ci.read_mstudy(cfg.file_mstudy)
    n_vc = len(s_study)
    if cfg.file_ref:
        S, Svar, s_ref, ni_ref = ci.read_ref(cfg.file_ref)
    else:
        S, Svar, s_ref, ni_ref = ci.read_mref(cfg.file_mref)

    res = mqs.calc_vc_ss(Vq, S, Svar, q, s_study, float(ni_study))

    ensure_outdir(cfg.path_out)
    write_matrix(f"{cfg.out_prefix()}.S.txt", np.vstack([S, Svar]))
    write_matrix(f"{cfg.out_prefix()}.Vq.txt", Vq)
    write_vector(f"{cfg.out_prefix()}.q.txt", q)
    write_vector(f"{cfg.out_prefix()}.size.txt",
                 np.concatenate([s_ref, [float(ni_ref)]]))
    log.summary["number of total individuals in the sample"] = ni_study
    log.summary["number of total individuals in the reference"] = ni_ref
    log.summary["number of variance components"] = n_vc
    _mqs_log_lines(log, res)
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return res


def run_vc_summary(cfg: GemmaConfig, log: RunLog | None = None,
                   device: str | torch.device = "cuda") -> mqs.MqsResult:
    """-vc with -beta: MQS estimation — q from the summary file, S from
    the reference genotypes on the device, then solve S pve = q; -vc 2
    runs a second pass with LDSC weights built from the first-pass pve
    (gemma.cpp:2102-2230)."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg)
    idx, cats, n_vc, rs2cat = _snp_categories(ds, cfg)

    # common SNP set + wK weights (ObtainWeight, gemma.cpp:2110-2117)
    rs2wsnp = ci.read_wsnp(cfg.file_wsnp) if cfg.file_wsnp else None
    rs2wcat = ci.read_wcat(cfg.file_wcat, n_vc) if cfg.file_wcat else None
    setSnps_beta = ci.read_beta_rs_set(cfg.file_beta)
    qc_rs = [ds.geno.snps.rs[i] for i in idx]
    wK = ci.obtain_weight(qc_rs, setSnps_beta, rs2cat, rs2wsnp, rs2wcat)

    beta = mqs.read_beta_summary(cfg.file_beta, rs2cat=rs2cat, rs2w=wK)
    Vq, q, s = mqs.calcq(cfg.n_block, beta.cat, beta.ni, beta.weight,
                         beta.z2, n_vc)

    cats_used = np.where([rs in wK for rs in qc_rs], cats, -1)
    wK_arr = np.array([wK.get(rs, 0.0) for rs in qc_rs]) if rs2wsnp \
        else None
    fetch = _geno_fetch(ds, idx, dtype, device)

    with log.timer.phase("kinship"):
        S, Svar, ns = mqs.calc_s_fetch(fetch, len(idx), ds.W, cats_used,
                                       n_vc, weights=wK_arr, dtype=dtype,
                                       device=device)
    res = mqs.calc_vc_ss(Vq, S, Svar, q, s, float(beta.ni_total))

    if cfg.a_mode == 62:
        # LDSC-weighted second pass (gemma.cpp:2183-2212)
        wA = ci.update_weight(1, wK, beta.ni_total, s, res.pve, rs2cat,
                              rs2wcat)
        beta = mqs.read_beta_summary(cfg.file_beta, rs2cat=rs2cat, rs2w=wA)
        Vq, q, s = mqs.calcq(cfg.n_block, beta.cat, beta.ni, beta.weight,
                             beta.z2, n_vc)
        wA_arr = np.array([wA.get(rs, 0.0) for rs in qc_rs])
        with log.timer.phase("kinship"):
            S, Svar, ns = mqs.calc_s_fetch(
                fetch, len(idx), ds.W, cats_used, n_vc, weights=wK_arr,
                weights_a=wA_arr, dtype=dtype, device=device)
        res = mqs.calc_vc_ss(Vq, S, Svar, q, s, float(beta.ni_total))

    ensure_outdir(cfg.path_out)
    write_matrix(f"{cfg.out_prefix()}.S.txt", np.vstack([S, Svar]))
    write_matrix(f"{cfg.out_prefix()}.Vq.txt", Vq)
    write_vector(f"{cfg.out_prefix()}.q.txt", q)
    write_vector(f"{cfg.out_prefix()}.size.txt",
                 np.concatenate([s, [float(ds.ni_test)]]))
    log.summary["number of total individuals in the sample"] = beta.ni_total
    log.summary["number of total individuals in the reference"] = ds.ni_total
    log.summary["number of total SNPs/var in the sample"] = beta.ns_total
    log.summary["number of analyzed SNPs/var"] = beta.ns_test
    log.summary["number of variance components"] = n_vc
    _mqs_log_lines(log, res)
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return res


def run_ci(cfg: GemmaConfig, log: RunLog | None = None,
           device: str | torch.device = "cuda") -> ci.CiResult:
    """-ci 1/2 (modes 66/67): standard errors for MQS pve estimates from
    a reference panel and study z-scores (gemma.cpp:2400-2560); the
    genotype passes run on the device."""
    device = torch.device(device)
    dtype = precision.resolve_dtype(cfg.precision, device)
    log = log or RunLog(argv=["gemma_torch"], device=device)
    with log.timer.phase("load"):
        ds = load_dataset(cfg)

    rs2cat, n_vc = (None, 1)
    if cfg.file_cat or cfg.file_mcat:
        rs2cat, n_vc = read_categories_multi(cfg)
    if len(cfg.v_pve) != n_vc:
        raise ValueError(f"-ci requires -pve with {n_vc} values "
                         f"(one per variance component)")

    if cfg.file_ref:
        S, Svar, s_ref, ni_ref = ci.read_ref(cfg.file_ref)
    elif cfg.file_mref:
        S, Svar, s_ref, ni_ref = ci.read_mref(cfg.file_mref)
    else:
        raise ValueError("-ci requires -ref or -mref")

    rs2wsnp = ci.read_wsnp(cfg.file_wsnp) if cfg.file_wsnp else None
    rs2wcat = ci.read_wcat(cfg.file_wcat, n_vc) if cfg.file_wcat else None
    if cfg.a_mode == 67 and rs2wcat is None:
        raise ValueError("-ci 2 requires -wcat weights")

    setSnps_beta = ci.read_beta_rs_set(cfg.file_beta)
    qc_rs = ds.geno.snps.rs[ds.qc.indicator_snp]
    wK = ci.obtain_weight(qc_rs, setSnps_beta, rs2cat, rs2wsnp, rs2wcat)

    # per-category SNP counts over the common set (gemma.cpp:2447-2459)
    s_vec = np.zeros(n_vc)
    for rs in wK:
        s_vec[rs2cat[rs] if rs2cat is not None else 0] += 1

    if cfg.a_mode == 66:
        wA = {rs: 1.0 for rs in wK}
    else:
        wA = ci.update_weight(0, wK, ds.ni_test, s_vec, cfg.v_pve, rs2cat,
                              rs2wcat)

    rs2z, rs2a1 = ci.read_signed_beta(cfg.file_beta, keep=set(wA))
    keep_idx, w, z, cat = ci.update_snp_z(
        ds.geno.snps.rs, ds.geno.snps.a_minor, ds.qc.indicator_snp, wA,
        rs2a1, rs2z, rs2cat)

    with log.timer.phase("kinship"):
        # mode 66 uses unit weights for XWz too (gemma.cpp:2497-2498)
        Xz, XWz, XtXWz = ci.xwz_passes_fetch(
            _geno_fetch(ds, keep_idx, dtype, device), len(keep_idx),
            ds.ni_test, np.ones_like(w) if cfg.a_mode == 66 else w, z, cat,
            n_vc, dtype=dtype, device=device)

    res = ci.calc_ci_ss(Xz, XWz, XtXWz, S, Svar, w, z, s_vec, cat,
                        np.asarray(cfg.v_pve))

    ensure_outdir(cfg.path_out)
    log.summary["number of total individuals"] = ds.ni_total
    log.summary["number of analyzed individuals"] = ds.ni_test
    log.summary["number of analyzed SNPs/var"] = len(keep_idx)
    log.summary["number of variance components"] = n_vc
    _mqs_log_lines(log, res)
    log.write(f"{cfg.out_prefix()}.log.txt", cfg.a_mode)
    return res


# ---------------------------------------------------------------------------

def batch_run(cfg: GemmaConfig, argv: list | None = None,
              device: str | None = None):
    """Mode dispatch (GEMMA::BatchRun, gemma.cpp:1641); returns what the
    mode's run_* returns.

    `device` overrides cfg.device ("cuda" unless -device says otherwise)."""
    dev = resolve_device(device if device is not None else cfg.device)
    check_param(cfg)
    if cfg.trace_dir:
        raise _not_ported("-trace", "queue A, \"skeleton\" (profiling)")
    if cfg.debug and cfg.fpe_check:
        # the reference traps the first NaN (jax_debug_nans) under -debug;
        # the port has no such trap yet (ROADMAP §C15)
        raise _not_ported("-debug", "queue A, \"skeleton\" (profiling)")
    precision.apply_matmul_precision()
    log = RunLog(argv=argv or ["gemma_torch"], quiet=cfg.quiet, device=dev)
    if cfg.a_mode in (21, 22):
        return run_gk(cfg, log, dev)
    if cfg.a_mode == 31:
        return run_eigen(cfg, log, dev)
    if cfg.a_mode in (1, 2, 3, 4, 5, 9):
        if cfg.n_ph == 1:
            return run_lmm(cfg, log, dev)
        return run_mvlmm(cfg, log, dev)
    if cfg.a_mode in (51, 52, 53, 54):
        return run_lm(cfg, log, dev)
    if cfg.a_mode in (11, 12, 13, 14):
        return run_bslmm(cfg, log, dev)
    if cfg.a_mode == 15:
        return run_bslmmdap_em(cfg, log, dev)
    if cfg.a_mode in (41, 42):
        return run_predict(cfg, log, dev)
    if cfg.a_mode == 43:
        return run_predict43(cfg, log, dev)
    if cfg.a_mode in (66, 67):
        return run_ci(cfg, log, dev)
    if cfg.a_mode in (61, 62, 63):
        if (cfg.file_study or cfg.file_mstudy) and \
                (cfg.file_ref or cfg.file_mref):
            return run_vc_study_ref(cfg, log, dev)
        if cfg.file_beta:
            return run_vc_summary(cfg, log, dev)
        return run_vc(cfg, log, dev)
    if cfg.a_mode in (25, 26):
        return run_gs(cfg, log, dev)
    if cfg.a_mode in (27, 28):
        return run_gq(cfg, log, dev)
    if cfg.a_mode in (71, 72):
        return run_calccor(cfg, log, dev)
    raise NotImplementedError(f"analysis mode {cfg.a_mode} not yet "
                              "implemented")
