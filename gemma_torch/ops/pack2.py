"""2-bit packed genotype wire format and the genotype prologue (K1).

Hard-call dosages have four states ({0, 1, 2, missing}), so a block
crosses the host→device link at 2 bits/dosage.  The bit layout IS the
PLINK .bed SNP-major encoding (gemma_io.cpp:940-997: byte b, individual
j → code (b >> 2j) & 3; 0→2.0, 1→missing, 2→1.0, 3→0.0), so .bed blocks
ship as their raw bytes; other int8 backends pack into the same layout
(pack_bed_codes).  Rows padded with 0x55 (code 1 everywhere) decode to
all-missing.

`prologue` turns a raw block — packed uint8, int8 with -1 missing, or
float with NaN missing — into the float GEMM operand in one pass: the
mean-imputed rows the association rotation reads, or the centred
(optionally standardised) rows the kinship product reads.  On a CUDA
tensor it launches kernel K1 (csrc/geno_prologue.cu), in float32 (speed
mode) or float64 (parity mode); on a CPU tensor it runs
`prologue_plain`, the same arithmetic in PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from gemma_torch import kernels

# code → dosage (int8, -1 missing)
_CODE_TO_I8 = np.array([2, -1, 1, 0], dtype=np.int8)
# int8 dosage → code (index -1 wraps to the last entry = missing code 1)
_I8_TO_CODE = np.array([3, 2, 0, 1], dtype=np.uint8)   # [0,1,2,-1]

# a byte of code-1 (missing) in every slot — the row/column pad byte
PAD_BYTE = 0x55

IMPUTE, CENTRE = 0, 1


def packed_width(n: int) -> int:
    return (n + 3) // 4


def pack_bed_codes(Xi8: np.ndarray) -> np.ndarray:
    """(S, n) int8 dosages (-1 missing) → (S, ceil(n/4)) uint8 in .bed
    bit order; slack slots in the last byte pack as missing (they are
    sliced off after the device decode)."""
    S, n = Xi8.shape
    nb = packed_width(n)
    codes = _I8_TO_CODE[Xi8]               # -1 indexes the last entry
    if nb * 4 != n:
        pad = np.full((S, nb * 4 - n), 1, np.uint8)   # code 1 = missing
        codes = np.concatenate([codes, pad], axis=1)
    codes = codes.reshape(S, nb, 4)
    return (codes[:, :, 0] | (codes[:, :, 1] << 2)
            | (codes[:, :, 2] << 4) | (codes[:, :, 3] << 6))


def unpack_bed(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(S, nb) uint8 → (S, n) int8 dosages, -1 missing."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    codes = (packed[:, :, None] >> shifts) & 3
    codes = codes.reshape(packed.shape[0], -1)[:, :n].long()
    table = torch.as_tensor(_CODE_TO_I8, device=packed.device)
    return table[codes]


def prologue_plain(raw: torch.Tensor, n: int, mode: int, scale: bool,
                   n_total: int | None, dtype: torch.dtype) -> torch.Tensor:
    """PyTorch version of K1: decode, per-SNP moments, operand."""
    if raw.dtype == torch.uint8:
        raw = unpack_bed(raw, n)
    if raw.dtype.is_floating_point:
        miss = torch.isnan(raw)
    else:
        miss = raw < 0
    xf = raw.to(dtype)
    g0 = torch.where(miss, torch.zeros((), dtype=dtype, device=raw.device),
                     xf)
    n_obs = (~miss).sum(dim=1)
    mean = g0.sum(dim=1) / n_obs.clamp(min=1).to(dtype)
    if mode == IMPUTE:
        return torch.where(miss, mean[:, None], xf)
    x = torch.where(miss, torch.zeros((), dtype=dtype, device=raw.device),
                    xf - mean[:, None])
    if scale:
        n_total = n if n_total is None else n_total
        sumsq = (g0 * g0).sum(dim=1)
        n_miss = (n_total - n_obs).to(dtype)
        var = (sumsq + mean * mean * n_miss) / n_total - mean * mean
        inv = torch.where(var > 0.0, 1.0 / torch.sqrt(var.clamp(min=1e-300)),
                          torch.ones_like(var))
        x = x * inv[:, None]
    return x


_WIRES = {torch.uint8: 0, torch.int8: 1, torch.float32: 2, torch.float64: 3}


def prologue_cuda(raw: torch.Tensor, n: int, mode: int, scale: bool,
                  n_total: int | None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1 on the card: (S, n) operand in `dtype` from a raw CUDA block.
    The float32 kernel reads uint8/int8/float32 wires, the float64
    instantiation uint8/int8/float64."""
    kern = kernels.variant(kernels.GENO_PROLOGUE, kernels.GENO_PROLOGUE_F64,
                           dtype)
    if raw.dtype not in (torch.uint8, torch.int8, dtype):
        raise TypeError(f"{kern.name} takes uint8/int8/{dtype} blocks, got "
                        f"{raw.dtype}")
    S = raw.shape[0]
    width = packed_width(n) if raw.dtype == torch.uint8 else n
    kernels.check_operand(raw, "raw", raw.dtype, (S, width))
    out = torch.empty((S, n), dtype=dtype, device=raw.device)
    kern.launch(
        raw.device, raw.data_ptr(), _WIRES[raw.dtype], S, n, width, mode,
        int(bool(scale)), n if n_total is None else int(n_total),
        out.data_ptr())
    return out


def prologue(raw: torch.Tensor, n: int, mode: int, scale: bool = False,
             n_total: int | None = None,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(S, ·) raw block → (S, n) operand in `dtype`.

    mode IMPUTE: missing → row mean (lmm.cpp:1589-1618).
    mode CENTRE: missing → 0, others g - mean, standardised when
    `scale` with GEMMA's population variance over `n_total` individuals
    (kinship.py:32-61 of the reference).  All-missing rows → zeros."""
    if raw.device.type == "cpu":
        return prologue_plain(raw, n, mode, scale, n_total, dtype)
    return prologue_cuda(raw, n, mode, scale, n_total, dtype)
